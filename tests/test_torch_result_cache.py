"""The predict result cache: ``rafiki_tpu_torch/predictor/result_cache.py``
and ``cache/wire.canonical_digest`` against the JAX package's.

- digests: equal to ``rafiki_tpu.cache.wire.canonical_digest`` for arrays,
  JSON payloads, nested arrays, and None for payloads with no canonical
  form;
- ``ResultCache``: the same script of fills, lookups, flushes and flights
  through both caches (TTL, byte-cap LRU, an oversized entry, a flush
  keeping a version, the epoch dropping a stale fill, single flight and a
  leader's error) gives the same results and equal ``stats()``;
- the predictor's plumbing, after ``tests/test_result_cache.py:82-360``
  (its rollout and drift cases belong to ROADMAP item 8): a hit never
  reaches a worker, duplicates within a request are one forward, a
  stampede of identical misses is one batch, a leader's error reaches its
  followers at once, the single-flight switch, an incomplete ensemble is
  never stored, excluded tasks never touch the cache, the cache-off
  duplicate probe, the misses-only admission cost, a flush detaching the
  flights in flight, and the admin's teardown flush.
"""

import threading
import time
import uuid

import numpy as np
import pytest

from rafiki_tpu.cache import wire as jwire
from rafiki_tpu.predictor.result_cache import ResultCache as JaxCache
from rafiki_tpu_torch import config
from rafiki_tpu_torch.admin.admin import Admin
from rafiki_tpu_torch.cache import wire
from rafiki_tpu_torch.cache.queue import InProcessBroker
from rafiki_tpu_torch.db.database import Database
from rafiki_tpu_torch.placement.manager import (
    ChipAllocator,
    LocalPlacementManager,
)
from rafiki_tpu_torch.predictor import result_cache
from rafiki_tpu_torch.predictor.predictor import Predictor
from rafiki_tpu_torch.predictor.result_cache import ResultCache, get_cache

from test_torch_stack import FAKE_TEMPLATE


@pytest.fixture(autouse=True)
def _clean_cache():
    get_cache().clear()
    yield
    get_cache().clear()


class _Weird:
    pass


QUERIES = [
    [1.5, 2.5], [2.5, 1.5], {"x": 1, "y": [2, 3]}, {"y": [2, 3], "x": 1},
    np.arange(12, dtype=np.float32), np.arange(12, dtype=np.float64),
    {"q": np.ones((2, 3), np.int32)}, "a sentence", ["tok", "ens"],
    [np.float32(1.5), 2], None, 3, {"f": _Weird()}, _Weird(),
]


def test_digests_equal_jaxs():
    for q in QUERIES:
        assert wire.canonical_digest(q) == jwire.canonical_digest(q), q
    a = np.arange(12, dtype=np.float32)
    assert wire.canonical_digest(a) == wire.canonical_digest(a.copy())
    assert wire.canonical_digest(a) != wire.canonical_digest(a + 1)
    assert wire.canonical_digest({"x": 1, "y": [2, 3]}) == \
        wire.canonical_digest({"y": [2, 3], "x": 1})
    assert wire.canonical_digest({"f": _Weird()}) is None


def _script(cache, job, other):
    """One script of cache operations; every result, in order."""
    out = []
    e = cache.epoch(job)
    # byte-cap LRU: ~336 bytes an entry, a cap of 700 holds two
    out.append(cache.fill(job, 0, "a", [1.0], e))
    out.append(cache.fill(job, 0, "b", [2.0], e))
    out.append(cache.fill(job, 0, "c", [3.0], e))  # evicts a
    out.append(cache.lookup(job, 0, "a"))
    out.append(cache.lookup(job, 0, "b"))  # touches b
    out.append(cache.fill(job, 0, "d", [4.0], e))  # evicts c
    out += [cache.lookup(job, 0, k) for k in "cbd"]
    # an oversized entry is refused and wipes nothing
    out.append(cache.fill(job, 0, "huge", ["x" * 4096], e))
    out.append(cache.lookup(job, 0, "d"))
    out.append(cache.peek_misses(job, 0, ["b", "b", "z", None, "d"]))
    # a flush keeping version 1, then the rest; another job untouched
    out.append(cache.fill(job, 1, "b", [5.0], e))
    out.append(cache.fill(other, 0, "a", [9.0], cache.epoch(other)))
    out.append(cache.flush_job(job, keep_version=1))
    out += [cache.lookup(job, 0, "b"), cache.lookup(job, 1, "b"),
            cache.lookup(other, 0, "a")]
    # the epoch: a fill from before the flush is dropped
    out.append(cache.fill(job, 1, "s", [6.0], e))
    out.append(cache.fill(job, 1, "s", [7.0], cache.epoch(job)))
    out.append(cache.lookup(job, 1, "s"))
    # single flight: leader, follower, a resolved and a failed flight
    lead, flight = cache.join_flight(job, 1, "f")
    follow, same = cache.join_flight(job, 1, "f")
    out += [lead, follow, same is flight]
    cache.resolve_flight(job, 1, "f", flight, [8.0])
    out.append(same.future.result(1.0))
    lead, flight = cache.join_flight(job, 1, "g")
    _, waiter = cache.join_flight(job, 1, "g")
    cache.fail_flight(job, 1, "g", flight, RuntimeError("leader failed"))
    with pytest.raises(RuntimeError, match="leader failed"):
        waiter.future.result(1.0)
    out.append(cache.join_flight(job, 1, "g")[0])  # a fresh leader
    out.append(cache.stats())
    out.append(cache.flush_job(job))
    out.append(cache.stats())
    return out


def test_the_same_script_gives_the_same_cache(monkeypatch):
    monkeypatch.setenv("RAFIKI_PREDICT_CACHE", "1")
    job, other = f"job-{uuid.uuid4().hex}", f"other-{uuid.uuid4().hex}"
    theirs = _script(JaxCache(max_bytes=700, ttl_s=60.0), job, other)
    ours = _script(ResultCache(max_bytes=700, ttl_s=60.0), job, other)
    assert ours == theirs


def test_ttl_expiry_and_a_zero_ttl_match(monkeypatch):
    job = f"job-{uuid.uuid4().hex}"
    for make in (JaxCache, ResultCache):
        c = make(max_bytes=1 << 20, ttl_s=0.05)
        assert c.fill(job, 0, "d1", [1.0], c.epoch(job))
        assert c.lookup(job, 0, "d1") == (True, [1.0])
        time.sleep(0.08)
        assert c.lookup(job, 0, "d1") == (False, None)
        assert c.stats()["entries"] == 0
        z = make(max_bytes=1 << 20, ttl_s=0.0)
        assert not z.fill(job, 0, "d1", [1.0], z.epoch(job))
    c = ResultCache(max_bytes=1 << 20, ttl_s=0.05)
    c.fill(job, 0, "d1", [1.0], c.epoch(job))
    time.sleep(0.08)
    c.lookup(job, 0, "d1")
    assert c.counters()["evictions"]["ttl"] == 1


# -- the predictor's plumbing ---------------------------------------------------


class EchoWorker:
    """Serves its queue with a constant answer, counting what reached it."""

    def __init__(self, broker, job_id, worker_id, answer, delay_s=0.0,
                 fail=False):
        self.queue = broker.register_worker(job_id, worker_id)
        self.answer, self.delay_s, self.fail = answer, delay_s, fail
        self.batches = self.queries = 0
        threading.Thread(target=self._loop, daemon=True).start()

    def _loop(self):
        while True:
            batch = self.queue.take_batch(max_size=64, deadline_s=0.0,
                                          wait_timeout_s=0.05)
            if batch is None:
                return
            if not batch:
                continue
            self.batches += 1
            self.queries += len(batch)
            if self.delay_s:
                time.sleep(self.delay_s)
            for fut, _ in batch:
                if self.fail:
                    fut.set_error(RuntimeError("worker exploded"))
                else:
                    fut.set_result(list(self.answer))


def _predictor(broker, job, workers, task="IMAGE_CLASSIFICATION"):
    return Predictor(job, broker, task, worker_trials=workers)


def test_a_hit_skips_the_worker_and_duplicates_are_one_forward(
        monkeypatch):
    monkeypatch.setenv("RAFIKI_PREDICT_CACHE", "1")
    broker = InProcessBroker()
    w = EchoWorker(broker, "jobA", "w1", [0.7, 0.3])
    p = _predictor(broker, "jobA", {"w1": "t1"})
    assert p.predict([1.0, 2.0], timeout_s=5.0) == [0.7, 0.3]
    assert p.predict([1.0, 2.0], timeout_s=5.0) == [0.7, 0.3]
    assert w.queries == 1
    out = p.predict_batch([[1.0, 2.0], [3.0], [3.0]], timeout_s=5.0)
    assert out == [[0.7, 0.3]] * 3
    assert w.queries == 2
    hits, misses = get_cache().job_totals("jobA")
    assert hits == 2 and misses >= 2


def test_a_stampede_is_one_worker_batch(monkeypatch):
    monkeypatch.setenv("RAFIKI_PREDICT_CACHE", "1")
    broker = InProcessBroker()
    w = EchoWorker(broker, "jobB", "w1", [1.0, 0.0], delay_s=0.2)
    p = _predictor(broker, "jobB", {"w1": "t1"})
    results, errors = [], []
    barrier = threading.Barrier(8)

    def shot():
        try:
            barrier.wait(timeout=5)
            results.append(p.predict([5.0, 5.0], timeout_s=10.0))
        except Exception as e:
            errors.append(repr(e))

    threads = [threading.Thread(target=shot) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=20)
    assert not errors and results == [[1.0, 0.0]] * 8
    assert w.batches == 1 and w.queries == 1
    assert get_cache().counters("jobB")["coalesced"] == 7


def test_a_leaders_error_fails_its_followers_at_once(monkeypatch):
    monkeypatch.setenv("RAFIKI_PREDICT_CACHE", "1")
    broker = InProcessBroker()
    w = EchoWorker(broker, "jobC", "w1", [0.0], delay_s=0.1, fail=True)
    p = _predictor(broker, "jobC", {"w1": "t1"})
    errors = []
    barrier = threading.Barrier(4)

    def shot():
        barrier.wait(timeout=5)
        t0 = time.monotonic()
        with pytest.raises(Exception) as ei:
            p.predict([6.0], timeout_s=30.0)
        errors.append((type(ei.value).__name__, time.monotonic() - t0))

    threads = [threading.Thread(target=shot) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=20)
    assert len(errors) == 4
    assert all(dt < 10.0 for _, dt in errors), errors
    assert w.queries == 1


def test_the_single_flight_switch(monkeypatch):
    monkeypatch.setenv("RAFIKI_PREDICT_CACHE", "1")
    monkeypatch.setenv("RAFIKI_PREDICT_SINGLEFLIGHT", "0")
    broker = InProcessBroker()
    w = EchoWorker(broker, "jobD", "w1", [1.0], delay_s=0.15)
    p = _predictor(broker, "jobD", {"w1": "t1"})
    barrier = threading.Barrier(3)
    results = []

    def shot():
        barrier.wait(timeout=5)
        results.append(p.predict([7.0], timeout_s=10.0))

    threads = [threading.Thread(target=shot) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=20)
    assert len(results) == 3 and w.queries == 3


def test_an_incomplete_ensemble_is_never_stored(monkeypatch):
    monkeypatch.setenv("RAFIKI_PREDICT_CACHE", "1")
    broker = InProcessBroker()
    w1 = EchoWorker(broker, "jobE", "w1", [1.0, 0.0])
    broker.register_worker("jobE", "w2")  # never served
    p = _predictor(broker, "jobE", {"w1": "t1", "w2": "t2"})
    assert p.predict([8.0], timeout_s=1.0) == [1.0, 0.0]
    assert get_cache().stats()["entries"] == 0
    p.predict([8.0], timeout_s=1.0)
    assert w1.queries == 2


def test_excluded_tasks_never_touch_the_cache(monkeypatch):
    monkeypatch.setenv("RAFIKI_PREDICT_CACHE", "1")

    class Boom:
        def __getattr__(self, name):
            raise AssertionError("cache touched for an excluded job")

    monkeypatch.setattr(result_cache, "_CACHE", Boom())
    broker = InProcessBroker()
    EchoWorker(broker, "jobF", "w1", [1.0])
    p = Predictor("jobF", broker, "TEXT_GENERATION",
                  worker_trials={"w1": "t1"})
    assert p.predict([1.0], timeout_s=5.0) == [1.0]
    broker2 = InProcessBroker()
    EchoWorker(broker2, "jobG", "w1", [1.0])
    EchoWorker(broker2, "jobG", "w2", [2.0])
    p2 = Predictor("jobG", broker2, "POS_TAGGING",
                   worker_trials={"w1": "t1", "w2": "t2"})
    assert p2.predict([1.0], timeout_s=5.0) in ([1.0], [2.0])


def test_the_cache_off_duplicate_probe_counts(monkeypatch):
    monkeypatch.delenv("RAFIKI_PREDICT_CACHE", raising=False)
    broker = InProcessBroker()
    EchoWorker(broker, "jobH", "w1", [1.0])
    p = _predictor(broker, "jobH", {"w1": "t1"})
    for _ in range(64):
        p.predict([4.0, 4.0], timeout_s=5.0)
    assert get_cache().counters("jobH")["shareable"] >= 2
    assert get_cache().stats()["entries"] == 0


def test_the_admission_cost_counts_misses_only(monkeypatch):
    monkeypatch.setenv("RAFIKI_PREDICT_CACHE", "1")
    broker = InProcessBroker()
    EchoWorker(broker, "jobI", "w1", [1.0])
    p = _predictor(broker, "jobI", {"w1": "t1"})
    warm, cold = [1.0, 1.0], [2.0, 2.0]
    assert p.admission_cost([warm, cold]) == 2
    p.predict(warm, timeout_s=5.0)
    assert p.admission_cost([warm, cold]) == 1
    assert p.admission_cost([warm]) == 0
    # the digests admission computed serve the request on this thread
    queries = [warm, cold]
    p.admission_cost(queries)
    assert p._tls.digests[0] is queries
    assert p.predict_batch(queries, timeout_s=5.0) == [[1.0], [1.0]]
    assert p._tls.digests is None
    monkeypatch.setenv("RAFIKI_PREDICT_CACHE", "0")
    assert p.admission_cost([warm]) == 1


def test_a_broken_cache_serves_the_miss_path(monkeypatch):
    """Any fault in a cache operation degrades to a forward, counted."""
    monkeypatch.setenv("RAFIKI_PREDICT_CACHE", "1")
    broker = InProcessBroker()
    w = EchoWorker(broker, "jobJ", "w1", [1.0])
    p = _predictor(broker, "jobJ", {"w1": "t1"})

    def broken(*a, **k):
        raise OSError("cache fault")

    monkeypatch.setattr(get_cache(), "lookup", broken)
    assert p.predict([3.0], timeout_s=5.0) == [1.0]
    assert p.predict([3.0], timeout_s=5.0) == [1.0]
    assert w.queries == 2
    assert get_cache().counters()["errors"] >= 2


def test_a_flush_detaches_the_flights_in_flight(monkeypatch):
    monkeypatch.setenv("RAFIKI_PREDICT_CACHE", "1")
    broker = InProcessBroker()
    w = EchoWorker(broker, "jobO", "w1", [1.0], delay_s=0.3)
    p = _predictor(broker, "jobO", {"w1": "t1"})
    results = []
    t1 = threading.Thread(
        target=lambda: results.append(p.predict([5.0], timeout_s=10.0)))
    t1.start()
    time.sleep(0.1)  # the leader's forward is in flight
    get_cache().flush_job("jobO", reason="teardown")
    results.append(p.predict([5.0], timeout_s=10.0))
    t1.join(timeout=10)
    assert results == [[1.0], [1.0]]
    assert w.queries == 2


def test_the_admins_teardown_and_deploy_flush_the_job(tmp_path,
                                                      monkeypatch):
    monkeypatch.setenv("RAFIKI_PREDICT_CACHE", "1")
    admin = Admin(db=Database(":memory:"),
                  placement=LocalPlacementManager(ChipAllocator(["cpu"])),
                  params_dir=str(tmp_path))
    try:
        uid = admin.authenticate_user(config.SUPERADMIN_EMAIL,
                                      config.SUPERADMIN_PASSWORD)["user_id"]
        admin.create_model(uid, "fake", "IMAGE_CLASSIFICATION",
                           FAKE_TEMPLATE, "FakeModel")
        admin.create_train_job(uid, "a", "IMAGE_CLASSIFICATION", "t", "e",
                               budget={"MODEL_TRIAL_COUNT": 1})
        admin.wait_until_train_job_stopped(uid, "a", timeout_s=60)
        inf = admin.create_inference_job(uid, "a")
        admin.predict(uid, "a", [[0.5]])
        assert get_cache().stats()["jobs"][inf["id"]]["entries"] == 1
        epoch = get_cache().epoch(inf["id"])
        admin.stop_inference_job(uid, "a")
        assert inf["id"] not in get_cache().stats()["jobs"]
        assert get_cache().epoch(inf["id"]) == epoch + 1
    finally:
        admin.shutdown()


def test_stats_have_the_jax_shape(monkeypatch):
    monkeypatch.setenv("RAFIKI_PREDICT_CACHE", "1")
    job = f"jobS-{uuid.uuid4().hex}"
    shapes = []
    for c in (JaxCache(), get_cache()):
        c.fill(job, 0, "d", [1.0], c.epoch(job))
        c.lookup(job, 0, "d")
        shapes.append(c.stats())
    assert shapes[0] == shapes[1]
    assert shapes[1]["enabled"] is True
    assert shapes[1]["jobs"][job]["hit_rate"] == 1.0
