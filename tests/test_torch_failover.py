"""Hedged failover: the port's ``Predictor`` against the JAX package's on
one scripted broker.

Each package's ``Predictor`` gets the same script of fake replica queues
(built with that package's ``QueryFuture`` and ``QueueFullError``): a
silent replica, an erroring one, a full one, a healthy but slow one, a
sibling deeper than ``RAFIKI_PREDICT_HEDGE_SUPPRESS_DEPTH``. Both must
give the same answers, the same ``overload_stats()`` and the same shed
errors; a silent replica's trial is answered by its sibling inside the
deadline (the port's earlier ``_gather`` waited the whole deadline on the
silent one and dropped the trial). Then ``tests/test_overload.py``'s
predictor cases (``:193-290``) through the port's own ``InProcessBroker``,
and the draining set.
"""

import threading
import time

import pytest

from rafiki_tpu.cache import queue as jqueue
from rafiki_tpu.predictor.predictor import Predictor as JaxPredictor
from rafiki_tpu_torch.cache import queue as tqueue
from rafiki_tpu_torch.cache.queue import InProcessBroker, QueueFullError
from rafiki_tpu_torch.predictor.predictor import Predictor

PACKAGES = {"jax": (jqueue, JaxPredictor), "torch": (tqueue, Predictor)}


class _FakeQueue:
    """One scripted replica: ``kind`` is live (answers ``answer`` after
    ``delay_s``), silent (never answers), error (fails after
    ``delay_s``) or full (refuses every submit); ``depth`` is what it
    reports."""

    def __init__(self, qmod, kind, answer=None, delay_s=0.0, depth=0):
        self.qmod, self.kind, self.answer = qmod, kind, answer
        self.delay_s, self._depth = delay_s, depth
        self.submits = 0

    def depth(self):
        return self._depth

    def submit_many(self, queries, deadline=None):
        if self.kind == "full":
            raise self.qmod.QueueFullError("scripted: full")
        self.submits += 1
        futs = [self.qmod.QueryFuture() for _ in queries]
        if self.kind == "silent":
            return futs

        def resolve():
            for f in futs:
                if self.kind == "error":
                    f.set_error(RuntimeError("scripted: replica error"))
                else:
                    f.set_result(self.answer)

        threading.Timer(self.delay_s, resolve).start()
        return futs


class _FakeBroker:
    def __init__(self, queues):
        self.queues = queues

    def get_worker_queues(self, job):
        return dict(self.queues)


def _run(package, script, trials, timeout_s, n_requests=1):
    """(answers or the error's type name, overload_stats, seconds, each
    queue's submits) of ``n_requests`` one-query requests."""
    qmod, cls = PACKAGES[package]
    queues = {wid: _FakeQueue(qmod, *spec) for wid, spec in script.items()}
    predictor = cls("job", _FakeBroker(queues), "IMAGE_CLASSIFICATION",
                    worker_trials=trials)
    out = []
    t0 = time.monotonic()
    for _ in range(n_requests):
        try:
            out.append(predictor.predict_batch([[0.5]], timeout_s=timeout_s))
        except Exception as e:
            out.append(type(e).__name__)
    return (out, predictor.overload_stats(), time.monotonic() - t0,
            {w: q.submits for w, q in queues.items()})


A2 = {"w0": "trialA", "w1": "trialA"}
AB = {"w0": "trialA", "w1": "trialA", "w2": "trialB"}
SCENARIOS = {
    # a silent replica: its share of the deadline lapses, the sibling
    # answers (one hedge)
    "silent_then_live": ({"w0": ("silent",), "w1": ("live", [1.0, 0.0])},
                         A2, 2.0),
    # an erroring replica leaves the sweep; the sibling answers
    "error_then_live": ({"w0": ("error", None, 0.05),
                         "w1": ("live", [0.0, 1.0])}, A2, 2.0),
    # a full replica: the first submit walks to its sibling, no hedge
    "full_then_live": ({"w0": ("full",), "w1": ("live", [0.3, 0.7])},
                       A2, 2.0),
    # healthy but slow: the hedge goes to a silent sibling, and the slow
    # replica's late answer still serves the request
    "slow_then_silent": ({"w0": ("live", [0.9, 0.1], 0.7),
                          "w1": ("silent",)}, A2, 1.0),
    # silent, and the sibling above the hedge depth: the hedge is held
    # back, trial A is dropped, trial B answers
    "silent_then_deep": ({"w0": ("silent",),
                          "w1": ("live", [1.0, 0.0], 0.0, 100),
                          "w2": ("live", [0.0, 1.0])}, AB, 0.6),
    # silent and full: the hedge is held back (queue full); B answers
    "silent_then_full": ({"w0": ("silent",), "w1": ("full",),
                          "w2": ("live", [0.25, 0.75])}, AB, 0.6),
    # every replica full: the trial and the request are shed
    "all_full": ({"w0": ("full",), "w1": ("full",)}, A2, 1.0),
    # nobody answers: a timeout, both replicas tried
    "all_silent": ({"w0": ("silent",), "w1": ("silent",)}, A2, 0.4),
    # one trial full, the other answers alone
    "trial_shed": ({"w0": ("full",), "w1": ("full",),
                    "w2": ("live", [0.5, 0.5])}, AB, 1.0),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_failover_matches_jax_on_one_scripted_broker(monkeypatch, name):
    monkeypatch.setenv("RAFIKI_PREDICT_HEDGE_SUPPRESS_DEPTH", "8")
    script, trials, timeout_s = SCENARIOS[name]
    theirs = _run("jax", script, trials, timeout_s)
    ours = _run("torch", script, trials, timeout_s)
    assert ours[0] == theirs[0]
    assert ours[1] == theirs[1]
    assert ours[3] == theirs[3]
    assert ours[2] < timeout_s + 0.5


def test_a_silent_replicas_trial_is_answered_by_its_sibling_in_time():
    """The repair: the sibling answers after the silent replica's share of
    the deadline (half of it with two replicas), not after all of it, and
    the trial stays in the ensemble."""
    script, trials, _ = SCENARIOS["silent_then_live"]
    answers, stats, secs, submits = _run("torch", script, trials, 4.0)
    assert answers == [[[1.0, 0.0]]]
    assert 1.9 < secs < 3.0  # 4.0 / 2 replicas, then the sibling
    assert stats["hedges"] == 1 and submits == {"w0": 1, "w1": 1}


def test_the_round_robin_starts_at_the_accepting_replica():
    """Over several requests the first submit rotates across replicas
    and walks past the full one; both packages submit alike."""
    script = {"w0": ("live", [1.0, 0.0]), "w1": ("full",),
              "w2": ("live", [1.0, 0.0])}
    trials = {w: "trialA" for w in script}
    theirs = _run("jax", script, trials, 1.0, n_requests=6)
    ours = _run("torch", script, trials, 1.0, n_requests=6)
    assert ours[0] == theirs[0] == [[[1.0, 0.0]]] * 6
    assert ours[1] == theirs[1]
    assert ours[3] == theirs[3]


# -- tests/test_overload.py's predictor cases through the port's broker --------


class StallServer:
    """Serves one worker queue from a thread: each batch waits
    ``stall_s`` and answers ``answer`` a query."""

    def __init__(self, queue, answer, stall_s=0.0):
        self.queue, self.answer, self.stall_s = queue, answer, stall_s
        threading.Thread(target=self._run, daemon=True).start()

    def _run(self):
        while True:
            batch = self.queue.take_batch(max_size=16, deadline_s=0.0,
                                          wait_timeout_s=0.05)
            if batch is None:
                return
            if not batch:
                continue
            if self.stall_s:
                time.sleep(self.stall_s)
            for fut, _ in batch:
                fut.set_result(self.answer)


def test_predict_sheds_when_all_queues_are_full(monkeypatch):
    monkeypatch.setenv("RAFIKI_PREDICT_QUEUE_DEPTH", "1")
    broker = InProcessBroker()
    broker.register_worker("job", "w1").submit_many([[0.0]])
    broker.register_worker("job", "w2").submit_many([[0.0]])
    p = Predictor("job", broker, "IMAGE_CLASSIFICATION",
                  worker_trials={"w1": "trialA", "w2": "trialA"})
    t0 = time.monotonic()
    with pytest.raises(QueueFullError):
        p.predict_batch([[1.0]], timeout_s=5.0)
    assert time.monotonic() - t0 < 0.5  # a shed, not a timeout
    stats = p.overload_stats()
    assert stats["requests_shed"] == 1 and stats["trials_shed"] == 1


def test_a_full_first_replica_fails_over_to_its_sibling(monkeypatch):
    monkeypatch.setenv("RAFIKI_PREDICT_QUEUE_DEPTH", "1")
    broker = InProcessBroker()
    broker.register_worker("job", "wfull").submit_many([[0.0]])
    StallServer(broker.register_worker("job", "wlive"), [1.0, 0.0])
    p = Predictor("job", broker, "IMAGE_CLASSIFICATION",
                  worker_trials={"wfull": "trialA", "wlive": "trialA"})
    assert p.predict([0.5], timeout_s=2.0) == [1.0, 0.0]
    assert p.overload_stats()["requests_shed"] == 0
    broker.unregister_worker("job", "wlive")


def test_a_hedge_onto_a_saturated_sibling_is_held_back(monkeypatch):
    monkeypatch.setenv("RAFIKI_PREDICT_HEDGE_SUPPRESS_DEPTH", "2")
    monkeypatch.setenv("RAFIKI_PREDICT_QUEUE_DEPTH", "0")
    broker = InProcessBroker()
    # 0.8 s lies between the first attempt's share (0.5 s) and the
    # deadline (1.0 s), as in the JAX test
    StallServer(broker.register_worker("job", "slow"), [1.0, 0.0],
                stall_s=0.8)
    q_sat = broker.register_worker("job", "sat")
    q_sat.submit_many([[0.0]] * 3)  # depth 3 > 2, nobody serving
    p = Predictor("job", broker, "IMAGE_CLASSIFICATION",
                  worker_trials={"slow": "trialA", "sat": "trialA"})
    assert p.predict([0.5], timeout_s=1.0) == [1.0, 0.0]
    stats = p.overload_stats()
    assert stats["hedges_suppressed"] == 1 and stats["hedges"] == 0
    assert q_sat.depth() == 3  # no hedge landed on the saturated queue
    broker.unregister_worker("job", "slow")


def test_a_hedge_still_fires_below_the_threshold(monkeypatch):
    monkeypatch.setenv("RAFIKI_PREDICT_HEDGE_SUPPRESS_DEPTH", "5")
    broker = InProcessBroker()
    broker.register_worker("job", "dead")  # registered, never serves
    StallServer(broker.register_worker("job", "live"), [1.0, 0.0])
    p = Predictor("job", broker, "IMAGE_CLASSIFICATION",
                  worker_trials={"dead": "trialA", "live": "trialA"})
    assert p.predict([0.5], timeout_s=1.5) == [1.0, 0.0]
    assert p.overload_stats()["hedges"] == 1
    assert p.overload_stats()["hedges_suppressed"] == 0
    broker.unregister_worker("job", "live")


def test_backlog_depth_is_the_max_over_trials_of_the_min_over_replicas():
    broker = InProcessBroker()
    broker.register_worker("job", "a1").submit_many([0] * 4)
    broker.register_worker("job", "a2").submit_many([0] * 2)
    broker.register_worker("job", "b1").submit_many([0] * 3)
    p = Predictor("job", broker, None, worker_trials={
        "a1": "trialA", "a2": "trialA", "b1": "trialB"})
    assert p.backlog_depth() == 3
    assert p.queue_depths() == {"a1": 4, "a2": 2, "b1": 3}
    # a draining replica takes no new request, so it leaves the estimate
    p.retire_worker("a2")
    assert p.backlog_depth() == 4
    p.unretire_worker("a2")
    assert p.backlog_depth() == 3


@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_a_draining_replica_serves_only_when_its_trial_has_no_other(
        package):
    """Retired replicas get no first submit while a sibling is routable;
    a trial whose replicas are all retired still answers; ``drop_worker``
    forgets one. Both packages route alike."""
    qmod, cls = PACKAGES[package]
    queues = {w: _FakeQueue(qmod, "live", [1.0, 0.0])
              for w in ("w0", "w1", "w2")}
    p = cls("job", _FakeBroker(queues), "IMAGE_CLASSIFICATION",
            worker_trials={"w0": "A", "w1": "A", "w2": "B"})
    p.retire_worker("w0")
    p.retire_worker("w2")
    assert p.draining_workers() == {"w0", "w2"}
    for _ in range(4):
        assert p.predict_batch([[0.0]], timeout_s=2.0) == [[1.0, 0.0]]
    assert {w: q.submits for w, q in queues.items()} == {
        "w0": 0, "w1": 4, "w2": 4}
    p.drop_worker("w2")
    assert p.draining_workers() == {"w0"}
