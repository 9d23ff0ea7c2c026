"""Live rollouts: ``rafiki_tpu_torch/admin/rollout.py`` and the predictor's
version lanes against ``rafiki_tpu/admin/rollout.py`` and
``tests/test_rollout.py``, on the CPU.

- Lanes: the same counter sequence sends the same requests to the canary
  in both packages' ``Predictor``; a canary failure fails over to the
  incumbents, an incumbent failure never reaches the canary; the lane
  record and the judge's snapshot do not race; a re-weighted lane keeps
  the judge's window.
- The judge: both packages' ``_breach`` on the same lane series give the
  same verdict and signals.
- ``recover_on_boot`` on the same rows resumes as done, rolls back or
  aborts alike in both packages.
- Through the port's ``Admin`` (an allocator over ``["cpu"]``): a good
  rollout of a tiny ViT (JAX ``vit.init`` trees carried across by
  ``convert.py``) under load through ``AdminServer`` + ``Client`` ends
  DONE with zero failed requests and answers equal to JAX's
  ``vit.apply`` of the new trial (probabilities within 5e-3, the bf16
  tolerance of ``tests/test_torch_stack.py``); a chaos deploy failure
  rolls back, a second update is 409, bad targets are typed 400s; the
  autoscaler pauses mid-rollout; the version bump flushes the old
  version's cache entries; a ``TEXT_GENERATION`` job rolls with stream
  lanes.
"""

import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rafiki_tpu.admin import rollout as jrollout
from rafiki_tpu.cache.queue import InProcessBroker as JaxBroker
from rafiki_tpu.db.database import Database as JaxDatabase
from rafiki_tpu.models import vit as jvit
from rafiki_tpu.predictor.predictor import Predictor as JaxPredictor
from rafiki_tpu_torch import config
from rafiki_tpu_torch.admin import rollout as trollout
from rafiki_tpu_torch.admin.admin import Admin, InvalidRequestError
from rafiki_tpu_torch.admin.http import AdminServer
from rafiki_tpu_torch.cache.queue import InProcessBroker
from rafiki_tpu_torch.client.client import (
    Client,
    RolloutInFlightError,
    RolloutRolledBackError,
)
from rafiki_tpu_torch.constants import RolloutPhase
from rafiki_tpu_torch.db.database import Database
from rafiki_tpu_torch.placement.manager import (
    ChipAllocator,
    LocalPlacementManager,
)
from rafiki_tpu_torch.predictor import result_cache
from rafiki_tpu_torch.predictor.predictor import Predictor
from rafiki_tpu_torch.sdk.artifact import write_artifact
from rafiki_tpu_torch.sdk.params import dump_params
from rafiki_tpu_torch.utils import chaos

from test_torch_stack import FAKE_TEMPLATE, PROB_ATOL, _tiny_template


@pytest.fixture(autouse=True)
def _clean_chaos():
    chaos.clear()
    yield
    chaos.clear()


# ---------------------------------------------------------------------------
# helpers shared with test_torch_autoscaler.py and test_torch_warm_pool.py
# ---------------------------------------------------------------------------

def make_admin(tmp_path, devices=("cpu",)):
    return Admin(db=Database(str(tmp_path / "store.sqlite3")),
                 placement=LocalPlacementManager(ChipAllocator(list(devices))),
                 params_dir=str(tmp_path / "params"))


def login(admin):
    return admin.authenticate_user(config.SUPERADMIN_EMAIL,
                                   config.SUPERADMIN_PASSWORD)["user_id"]


def fake_app(admin, app, trials=1):
    """Train ``trials`` instant trials of the fake template and deploy."""
    uid = login(admin)
    if admin.db.get_model_by_name(uid, "fake") is None:
        admin.create_model(uid, "fake", "IMAGE_CLASSIFICATION",
                           FAKE_TEMPLATE, "FakeModel")
    admin.create_train_job(uid, app, "IMAGE_CLASSIFICATION", "t", "e",
                           budget={"MODEL_TRIAL_COUNT": trials,
                                   "CHIP_COUNT": 0})
    job = admin.wait_until_train_job_stopped(uid, app, timeout_s=60)
    assert job["status"] == "STOPPED", job
    admin.create_inference_job(uid, app)
    return uid


def job_id_of(admin, uid, app):
    tj = admin.db.get_train_job_by_app_version(uid, app, -1)
    return admin.db.get_running_inference_job_of_train_job(tj["id"])["id"]


def wait_for(pred, timeout_s, what):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


class Load:
    """Concurrent predict load; every exception is a failed request."""

    def __init__(self, admin, uid, app, query=None, n=3):
        self._call = lambda: admin.predict(uid, app, [query or [0.0]])
        self.errors, self.ok = [], 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads = [threading.Thread(target=self._client)
                         for _ in range(n)]
        for t in self._threads:
            t.start()

    def _client(self):
        while not self._stop.is_set():
            try:
                assert self._call()
                with self._lock:
                    self.ok += 1
            except Exception as e:
                with self._lock:
                    self.errors.append(repr(e))
            time.sleep(0.01)

    def stop(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=30)


def _target_trial(admin, uid, app, job_id):
    """A COMPLETED trial the job does not serve."""
    tj = admin.db.get_train_job_by_app_version(uid, app, -1)
    serving = {w["trial_id"]
               for w in admin.services.live_inference_workers(job_id)}
    return next(t["id"] for t in admin.db.get_best_trials_of_train_job(
        tj["id"], max_count=10) if t["id"] not in serving)


def _wait_terminal(admin, job_id, timeout_s=60):
    st = None
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        st = admin.rollouts.status(job_id)
        if st and st["phase"] in RolloutPhase.TERMINAL:
            return st
        time.sleep(0.05)
    raise AssertionError(f"rollout never terminal: {st}")


@pytest.fixture()
def judge_env(monkeypatch):
    monkeypatch.setenv("RAFIKI_ROLLOUT_JUDGE_WINDOW_S", "1.0")
    monkeypatch.setenv("RAFIKI_ROLLOUT_MIN_REQUESTS", "3")


# ---------------------------------------------------------------------------
# version lanes, both packages
# ---------------------------------------------------------------------------

class _Server:
    """Serves a queue: ``answer``, or an error for every batch."""

    def __init__(self, queue, answer=None, fail=False):
        self.queue, self.answer, self.fail = queue, answer, fail
        self.batches = 0
        threading.Thread(target=self._loop, daemon=True).start()

    def _loop(self):
        while True:
            batch = self.queue.take_batch(max_size=16, deadline_s=0.0,
                                          wait_timeout_s=0.05)
            if batch is None:
                return
            if not batch:
                continue
            self.batches += 1
            for fut, _ in batch:
                if self.fail:
                    fut.set_error(RuntimeError("bad canary"))
                else:
                    fut.set_result(self.answer)


def _lane_predictor(predictor_cls, broker_cls, fail_new=False,
                    fail_old=False):
    broker = broker_cls()
    _Server(broker.register_worker("job", "oldw"), ["old"], fail=fail_old)
    new = _Server(broker.register_worker("job", "neww"), ["new"],
                  fail=fail_new)
    p = predictor_cls("job", broker, None,
                      worker_trials={"oldw": "trialA", "neww": "trialB"})
    return p, new


@pytest.mark.parametrize("fraction", [0.1, 0.25, 0.5, 0.75])
def test_lane_split_follows_fraction_as_in_jax(fraction):
    """The weighted counter: the same request sequence gives the same lane
    choices in both packages, a request is served by one lane, and the
    canary's share is the fraction."""
    answers = {}
    for name, cls, broker in (("jax", JaxPredictor, JaxBroker),
                              ("torch", Predictor, InProcessBroker)):
        p, _ = _lane_predictor(cls, broker)
        p.set_rollout_lane({"neww"}, fraction)
        answers[name] = [p.predict([0.0], timeout_s=5.0) for _ in range(20)]
        stats = p.rollout_stats(60.0)
        assert stats["canary"]["ok"] + stats["incumbent"]["ok"] == 20
    assert answers["torch"] == answers["jax"]
    assert answers["torch"].count(["new"]) == round(20 * fraction)
    p, _ = _lane_predictor(Predictor, InProcessBroker)
    for f, want in ((0.0, ["old"]), (1.0, ["new"])):
        p.set_rollout_lane({"neww"}, f)
        assert all(p.predict([0.0], timeout_s=5.0) == want
                   for _ in range(5))
    p.clear_rollout_lane()
    assert p._lane_snapshot() == (None, 0)


def test_canary_failure_fails_over_to_the_incumbents():
    """A canary whose batches fail costs the client nothing: the
    incumbents answer, and the errors land in the canary's window, as in
    JAX."""
    stats = {}
    for name, cls, broker in (("jax", JaxPredictor, JaxBroker),
                              ("torch", Predictor, InProcessBroker)):
        p, _ = _lane_predictor(cls, broker, fail_new=True)
        p.set_rollout_lane({"neww"}, 1.0)
        for _ in range(5):
            assert p.predict([0.0], timeout_s=5.0) == ["old"]
        stats[name] = p.rollout_stats(60.0)
    for s in stats.values():
        for lane in s.values():
            lane.pop("p95_s")
    assert stats["torch"] == stats["jax"]
    assert stats["torch"]["canary"]["errors"] == 5
    assert stats["torch"]["incumbent"]["requests"] == 0


def test_an_incumbent_failure_never_reaches_the_canary():
    p, new = _lane_predictor(Predictor, InProcessBroker, fail_old=True)
    p.set_rollout_lane({"neww"}, 0.0)
    with pytest.raises(TimeoutError):
        p.predict([0.0], timeout_s=0.5)
    assert new.batches == 0
    assert p.rollout_stats(60.0)["incumbent"]["errors"] == 1


def test_draining_incumbents_send_their_lane_to_the_new_version():
    """A reference fault the port does not keep: once every incumbent is
    draining (the rolling phase retires the last one), the incumbent
    lane's requests go to the new version, where JAX's predictor still
    sends them to the draining replica, whose queue the drain then
    closes under them."""
    answers = {}
    for name, cls, broker in (("jax", JaxPredictor, JaxBroker),
                              ("torch", Predictor, InProcessBroker)):
        p, _ = _lane_predictor(cls, broker)
        p.set_rollout_lane({"neww"}, 0.0)  # every request incumbent
        p.retire_worker("oldw")
        answers[name] = [p.predict([0.0], timeout_s=5.0) for _ in range(4)]
    assert answers["jax"] == [["old"]] * 4
    assert answers["torch"] == [["new"]] * 4


def test_lane_record_and_judge_snapshot_do_not_race():
    """Handler threads append lane outcomes while the judge iterates the
    same deques: both under the route lock."""
    p = Predictor("job", InProcessBroker(), None, worker_trials={})
    p.set_rollout_lane({"neww"}, 0.5)
    for _ in range(4096):
        p._lane_record("canary", "ok", 0.001)
    stop, errors = threading.Event(), []

    def writer():
        try:
            while not stop.is_set():
                p._lane_record("canary", "ok", 0.001)
        except Exception as e:  # pragma: no cover - the race
            errors.append(e)

    t = threading.Thread(target=writer, daemon=True)
    t.start()
    try:
        deadline = time.monotonic() + 1.0
        while time.monotonic() < deadline:
            assert p.rollout_stats(60.0)["canary"]["requests"] >= 0
    finally:
        stop.set()
        t.join(timeout=5.0)
    assert errors == []


def test_a_refreshed_lane_keeps_the_judges_window():
    p, _ = _lane_predictor(Predictor, InProcessBroker)
    p.set_rollout_lane({"neww"}, 1.0)
    p.predict([0.0], timeout_s=5.0)
    assert p.rollout_stats(60.0)["canary"]["ok"] == 1
    p.set_rollout_lane({"neww"}, 0.5)  # a re-weight keeps the history
    assert p.rollout_stats(60.0)["canary"]["ok"] == 1
    p.clear_rollout_lane()
    p.set_rollout_lane({"neww"}, 0.5)  # a new rollout clears it
    assert p.rollout_stats(60.0)["canary"]["ok"] == 0


# ---------------------------------------------------------------------------
# the judge, both packages
# ---------------------------------------------------------------------------

#: (canary outcomes, incumbent outcomes, the canary service's status)
JUDGE_SERIES = {
    "healthy": ([("ok", 0.010)] * 5, [("ok", 0.010)] * 5, "RUNNING"),
    "thin": ([("error", 0.0)] * 2, [("ok", 0.010)] * 5, "RUNNING"),
    "errors": ([("error", 0.0)] * 3 + [("ok", 0.01)] * 2,
               [("ok", 0.010)] * 6, "RUNNING"),
    "sheds": ([("shed", 0.0)] * 4 + [("ok", 0.01)], [("ok", 0.01)] * 4,
              "RUNNING"),
    "slow": ([("ok", 0.200)] * 5, [("ok", 0.010)] * 5, "RUNNING"),
    "crashed": ([("ok", 0.010)] * 5, [("ok", 0.010)] * 5, "ERRORED"),
}


def _judge(mod, predictor_cls, broker_cls, series):
    canary, incumbent, status = series
    p = predictor_cls("job", broker_cls(), None, worker_trials={})
    p.set_rollout_lane({"neww"}, 0.5)
    for lane, outcomes in (("canary", canary), ("incumbent", incumbent)):
        for outcome, duration in outcomes:
            p._lane_record(lane, outcome, duration)
    admin = types.SimpleNamespace(
        services=types.SimpleNamespace(),
        db=types.SimpleNamespace(get_service=lambda sid: {"status": status}))
    ctl = mod.RolloutController(admin)
    run = mod._Run("r", "job", "tA", "tB", 0, 1, 2, 0.5, 1)
    run.new_sids.append("neww")
    return ctl._breach(run, p)


@pytest.mark.parametrize("name", sorted(JUDGE_SERIES))
def test_the_judge_gives_jaxs_verdict_on_the_same_series(name, judge_env):
    ours = _judge(trollout, Predictor, InProcessBroker, JUDGE_SERIES[name])
    theirs = _judge(jrollout, JaxPredictor, JaxBroker, JUDGE_SERIES[name])
    assert ours == theirs
    assert (ours[0] is None) == (name in ("healthy", "thin"))


# ---------------------------------------------------------------------------
# recover_on_boot, both packages on the same rows
# ---------------------------------------------------------------------------

class _FleetStub:
    """The services a boot-time resolution reads and drives, recorded."""

    def __init__(self, live):
        self.live, self.calls = live, []

    def live_inference_workers(self, job_id):
        return [dict(w) for w in self.live]

    def get_predictor(self, job_id):
        return None

    def deploy_version_replica(self, job_id, trial, version):
        self.calls.append(("deploy", trial, version))
        return f"restored-{len(self.calls)}"

    def drain_replicas(self, job_id, sids, drain_timeout_s=None):
        self.calls.append(("drain", sorted(sids)))
        return 0, list(sids)


def _boot(db_cls, mod, case):
    db = db_cls(":memory:")
    user = db.create_user("r@x", "h", "ADMIN")
    tj = db.create_train_job(user["id"], "app", 1, "IMAGE_CLASSIFICATION",
                             "t", "e", {})
    inf = db.create_inference_job(user["id"], tj["id"])
    if case != "stopped":
        db.mark_inference_job_as_running(inf["id"])
    row = db.create_rollout(inf["id"], "tA", "tB", 0, 1, 3,
                            RolloutPhase.ROLLING)
    live = [{"service_id": f"s{i}", "trial_id": t, "group": t,
             "model_version": v, "chips": []}
            for i, (t, v) in enumerate(
                [("tB", 1)] * 3 if case == "all_new"
                else [("tA", 0), ("tB", 1), ("tB", 1)])]
    fleet = _FleetStub(live)
    mod.RolloutController(types.SimpleNamespace(services=fleet, db=db)) \
        .recover_on_boot()
    out = db.get_rollout(row["id"])
    return (out["phase"], out["reason"], [e["event"] for e in out["events"]],
            fleet.calls)


@pytest.mark.parametrize("case", ["all_new", "mixed", "stopped"])
def test_recover_on_boot_resolves_rows_as_jax_does(case):
    ours = _boot(Database, trollout, case)
    assert ours == _boot(JaxDatabase, jrollout, case)
    assert ours[0] == {"all_new": RolloutPhase.DONE,
                       "mixed": RolloutPhase.ROLLED_BACK,
                       "stopped": RolloutPhase.ABORTED}[case]


# ---------------------------------------------------------------------------
# through the port's admin
# ---------------------------------------------------------------------------

def _vit_trials(admin, uid, app, n, tmp_path):
    """``n`` COMPLETED trials of the tiny ViT template whose parameters
    are JAX ``vit.init`` trees (the template's own layout, read through
    ``convert.py``); a STOPPED train job holding them. Returns the trees
    by trial id, the best first."""
    admin.create_model(uid, "tiny", "IMAGE_CLASSIFICATION",
                       _tiny_template(), "TinyViT")
    model = admin.db.get_model_by_name(uid, "tiny")
    tj = admin.db.create_train_job(uid, app, 1, "IMAGE_CLASSIFICATION",
                                   "t", "e", {"MODEL_TRIAL_COUNT": n})
    sub = admin.db.create_sub_train_job(tj["id"], model["id"])
    knobs = {"image_size": 32, "patch_size": 4, "dim": 64, "depth": 2,
             "heads": 4, "num_classes": 10, "batch_size": 8, "epochs": 2,
             "lr": 1e-3}
    trees = {}
    for i in range(n):
        tree = jax.tree.map(np.asarray,
                            jvit.init(jax.random.PRNGKey(i), jvit.tiny()))
        trial = admin.db.create_trial(sub["id"], model["id"], knobs)
        path = str(tmp_path / f"{trial['id']}.params")
        write_artifact(path, dump_params(tree))
        admin.db.mark_trial_as_complete(trial["id"], 0.9 - 0.1 * i, path)
        trees[trial["id"]] = tree
    admin.db.mark_train_job_as_stopped(tj["id"])
    return trees


def _jax_probs(tree, x):
    return np.asarray(jax.nn.softmax(jvit.apply(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x), jvit.tiny()), -1))


def test_a_good_rollout_completes_under_load_through_the_client(
        tmp_path, judge_env):
    """CANARY -> ROLLING -> DONE of a tiny ViT through the REST door
    under continuous load: no failed request, the fleet back at its size
    on the new trial, both lanes served, and the answers JAX's."""
    admin = make_admin(tmp_path)
    server = AdminServer(admin, port=0).start()
    load = None
    try:
        uid = login(admin)
        trees = _vit_trials(admin, uid, "roll", 3, tmp_path)
        admin.create_inference_job(uid, "roll")
        job_id = job_id_of(admin, uid, "roll")
        n_before = len(admin.services.live_inference_workers(job_id))
        assert n_before == 2
        target = _target_trial(admin, uid, "roll", job_id)
        x = np.random.default_rng(0).standard_normal(
            (8, 32, 32, 3)).astype(np.float32)
        client = Client("127.0.0.1", server.port, timeout_s=120)
        client.login(config.SUPERADMIN_EMAIL, config.SUPERADMIN_PASSWORD)
        load = Load(admin, uid, "roll", query=x[0].tolist())
        time.sleep(0.3)  # incumbent samples for the judge
        row = client.update_inference_job("roll", target,
                                          canary_fraction=0.4)
        assert row["phase"] == RolloutPhase.CANARY
        assert row["to_version"] == 1
        done = client.wait_until_rollout_done("roll", timeout_s=120)
        load.stop()
        assert done["phase"] == RolloutPhase.DONE
        assert not load.errors, load.errors[:5]
        assert load.ok > 10
        live = admin.services.live_inference_workers(job_id)
        assert len(live) == n_before
        assert {(w["trial_id"], w["model_version"]) for w in live} == {
            (target, 1)}
        names = [e["event"] for e in done["events"]]
        assert names[0] == "started" and names[-1] == "completed"
        assert "canary_deployed" in names and "rolling" in names
        predictor = admin.services.get_predictor(job_id)
        assert predictor._lane_snapshot() == (None, 0)
        assert predictor.serving_version() == 1
        probs = np.asarray(client.predict("roll", x.tolist()))
        np.testing.assert_allclose(probs, _jax_probs(trees[target], x),
                                   atol=PROB_ATOL, rtol=0)
    finally:
        if load is not None:
            load.stop()
        server.stop()
        admin.shutdown()


def test_a_chaos_deploy_failure_rolls_back_typed(tmp_path, judge_env):
    """``deploy`` chaos fails the canary's placement: ROLLED_BACK with the
    reason, the incumbents untouched, no failed request."""
    admin = make_admin(tmp_path)
    load = None
    try:
        uid = fake_app(admin, "boom", trials=3)
        job_id = job_id_of(admin, uid, "boom")
        target = _target_trial(admin, uid, "boom", job_id)
        before = sorted(w["service_id"] for w in
                        admin.services.live_inference_workers(job_id))
        chaos.install([chaos.ChaosRule(site=chaos.SITE_DEPLOY,
                                       action=chaos.ACTION_ERROR,
                                       match=target)])
        load = Load(admin, uid, "boom")
        admin.update_inference_job(uid, "boom", -1, trial_id=target)
        st = _wait_terminal(admin, job_id)
        load.stop()
        assert st["phase"] == RolloutPhase.ROLLED_BACK
        assert "canary deploy failed" in st["reason"]
        assert "chaos-injected deploy failure" in st["reason"]
        assert not load.errors, load.errors[:5]
        assert sorted(w["service_id"] for w in
                      admin.services.live_inference_workers(job_id)) == before
        assert admin.db.get_inference_job(job_id)["status"] == "RUNNING"
        rollbacks = [e for e in admin.rollouts.report()["events"]
                     if e["event"] == "rollback"]
        assert rollbacks and "deploy" in rollbacks[-1]["reason"]
    finally:
        if load is not None:
            load.stop()
        admin.shutdown()


def test_an_erroring_canary_rolls_back_on_its_error_rate(tmp_path,
                                                         monkeypatch):
    """A canary that deploys but fails its batches: the judge rolls back
    on the error-rate delta while the lane's failover keeps every
    request answered."""
    monkeypatch.setenv("RAFIKI_ROLLOUT_JUDGE_WINDOW_S", "2.0")
    monkeypatch.setenv("RAFIKI_ROLLOUT_MIN_REQUESTS", "3")
    admin = make_admin(tmp_path)
    load = None
    try:
        uid = fake_app(admin, "errc", trials=3)
        job_id = job_id_of(admin, uid, "errc")
        target = _target_trial(admin, uid, "errc", job_id)
        load = Load(admin, uid, "errc")
        admin.update_inference_job(uid, "errc", -1, trial_id=target,
                                   canary_fraction=0.5)
        canary = []
        wait_for(lambda: canary.extend(
            w["service_id"]
            for w in admin.services.live_inference_workers(job_id)
            if w["model_version"] == 1) or canary, 30, "the canary")
        chaos.install([chaos.ChaosRule(site=chaos.SITE_WORKER,
                                       action=chaos.ACTION_ERROR,
                                       match=canary[0])])
        st = _wait_terminal(admin, job_id)
        load.stop()
        assert st["phase"] == RolloutPhase.ROLLED_BACK
        assert "error rate" in st["reason"]
        assert not load.errors, load.errors[:5]
        assert all(w["model_version"] == 0 for w in
                   admin.services.live_inference_workers(job_id))
        (event,) = [e for e in st["events"] if e["event"] == "rollback"]
        assert event["signals"]["canary"]["errors"] > 0
    finally:
        if load is not None:
            load.stop()
        admin.shutdown()


def test_a_second_update_is_409_and_an_abort_rolls_back(tmp_path,
                                                        monkeypatch):
    monkeypatch.setenv("RAFIKI_ROLLOUT_JUDGE_WINDOW_S", "60")
    monkeypatch.setenv("RAFIKI_ROLLOUT_MIN_REQUESTS", "100000")
    admin = make_admin(tmp_path)
    server = AdminServer(admin, port=0).start()
    try:
        uid = fake_app(admin, "api", trials=3)
        job_id = job_id_of(admin, uid, "api")
        target = _target_trial(admin, uid, "api", job_id)
        client = Client("127.0.0.1", server.port, timeout_s=60)
        client.login(config.SUPERADMIN_EMAIL, config.SUPERADMIN_PASSWORD)
        client.update_inference_job("api", target)
        with pytest.raises(RolloutInFlightError) as err:
            client.update_inference_job("api", target)
        assert err.value.status == 409
        st = client.get_rollout("api")
        assert st["phase"] == RolloutPhase.CANARY and "signals" in st
        out = client.abort_rollout("api")
        assert out["phase"] == RolloutPhase.ROLLED_BACK
        assert out["reason"] == "operator abort"
        assert all(w["model_version"] == 0 for w in
                   admin.services.live_inference_workers(job_id))
        with pytest.raises(RolloutRolledBackError) as rb:
            client.wait_until_rollout_done("api", timeout_s=5)
        assert (rb.value.phase, rb.value.reason) == (
            RolloutPhase.ROLLED_BACK, "operator abort")
        assert client.ack_rollout("api")["operator_ack"] is True
        assert client.update_inference_job("api", target)["phase"] == \
            RolloutPhase.CANARY
        client.abort_rollout("api")
    finally:
        server.stop()
        admin.shutdown()


def test_bad_updates_are_typed_400s(tmp_path, judge_env):
    admin = make_admin(tmp_path)
    try:
        uid = fake_app(admin, "val", trials=3)
        job_id = job_id_of(admin, uid, "val")
        serving = admin.services.live_inference_workers(job_id)[0][
            "trial_id"]
        target = _target_trial(admin, uid, "val", job_id)
        for kw in ({"trial_id": "no-such-trial"}, {"trial_id": serving},
                   {"trial_id": target, "canary_fraction": 7.0},
                   {"trial_id": None}):
            with pytest.raises(InvalidRequestError):
                admin.update_inference_job(uid, "val", -1, **kw)
        with pytest.raises(InvalidRequestError):
            admin.abort_rollout(uid, "val")
        with pytest.raises(InvalidRequestError):
            admin.get_rollout_status(uid, "val")
        with pytest.raises(InvalidRequestError):
            admin.ack_rollout(uid, "val")
    finally:
        admin.shutdown()


def test_the_autoscaler_pauses_for_a_job_mid_rollout(tmp_path, monkeypatch):
    for k, v in (("RAFIKI_ROLLOUT_JUDGE_WINDOW_S", "60"),
                 ("RAFIKI_ROLLOUT_MIN_REQUESTS", "100000"),
                 ("RAFIKI_AUTOSCALE_SHED_THRESHOLD", "1"),
                 ("RAFIKI_AUTOSCALE_COOLDOWN_UP_S", "0")):
        monkeypatch.setenv(k, v)
    admin = make_admin(tmp_path)
    try:
        uid = fake_app(admin, "asc", trials=3)
        job_id = job_id_of(admin, uid, "asc")
        target = _target_trial(admin, uid, "asc", job_id)
        predictor = admin.services.get_predictor(job_id)
        scaler = admin.autoscaler
        scaler.tick()
        admin.update_inference_job(uid, "asc", -1, trial_id=target)
        assert admin.rollouts.is_active(job_id)
        wait_for(lambda: any(w["model_version"] == 1 for w in
                             admin.services.live_inference_workers(job_id)),
                 30, "the canary")
        n_live = len(admin.services.live_inference_workers(job_id))
        predictor._bump("requests_shed", 10)
        assert scaler.tick() == []
        assert len(admin.services.live_inference_workers(job_id)) == n_live
        admin.rollouts.abort(job_id)
        assert not admin.rollouts.is_active(job_id)
        scaler.tick()  # a fresh window
        predictor._bump("requests_shed", 10)
        assert [a["action"] for a in scaler.tick()] == ["scale_up"]
    finally:
        admin.shutdown()


def test_the_version_bump_flushes_the_old_versions_cache(tmp_path,
                                                         monkeypatch,
                                                         judge_env):
    """With the result cache on, DONE moves the serving version to 1 and
    no entry of version 0 is left; the canary lane only filled under
    version 1."""
    monkeypatch.setenv("RAFIKI_PREDICT_CACHE", "1")
    admin = make_admin(tmp_path)
    load = None
    try:
        uid = fake_app(admin, "cch", trials=3)
        job_id = job_id_of(admin, uid, "cch")
        cache = result_cache.get_cache()
        admin.predict(uid, "cch", [[1.0]])
        assert any(k[:2] == (job_id, 0) for k in list(cache._entries))
        target = _target_trial(admin, uid, "cch", job_id)
        load = Load(admin, uid, "cch")
        admin.update_inference_job(uid, "cch", -1, trial_id=target,
                                   canary_fraction=0.5)
        st = _wait_terminal(admin, job_id)
        load.stop()
        assert st["phase"] == RolloutPhase.DONE, st["reason"]
        assert not load.errors
        assert admin.services.get_predictor(job_id).serving_version() == 1
        versions = {k[1] for k in list(cache._entries) if k[0] == job_id}
        assert versions <= {1}
        admin.predict(uid, "cch", [[1.0]])
        assert (job_id, 1) in {k[:2] for k in list(cache._entries)}
    finally:
        if load is not None:
            load.stop()
        admin.shutdown()


def test_a_generation_rollout_rolls_with_stream_lanes(tmp_path, monkeypatch,
                                                      judge_env):
    """A TEXT_GENERATION job (``TorchGenLM``, 2 trials, one served) rolls
    to its other trial under concurrent streams: each stream answers from
    one version, DONE, and the job then streams the new trial's greedy
    tokens."""
    from test_torch_generation import TEMPLATE

    monkeypatch.setenv("RAFIKI_PREDICTOR_PORTS", "1")
    # the latency verdict is the judge tests' (a stream's admission time
    # on a loaded CPU says nothing of the version), as in JAX's twin
    monkeypatch.setenv("RAFIKI_ROLLOUT_P95_FACTOR", "1000")
    admin = make_admin(tmp_path)
    try:
        uid = login(admin)
        with open(TEMPLATE, "rb") as f:
            admin.create_model(uid, "gen", "TEXT_GENERATION", f.read(),
                               "TorchGenLM")
        admin.create_train_job(uid, "g", "TEXT_GENERATION", "t", "e",
                               budget={"MODEL_TRIAL_COUNT": 2})
        assert admin.wait_until_train_job_stopped(
            uid, "g", timeout_s=120)["status"] == "STOPPED"
        admin.create_inference_job(uid, "g")
        job_id = job_id_of(admin, uid, "g")
        target = _target_trial(admin, uid, "g", job_id)
        predictor = admin.services.get_predictor(job_id)
        errors, lanes, stop = [], [], threading.Event()

        def streams():
            while not stop.is_set():
                try:
                    s = predictor.generate({"prompt_ids": [2, 3, 4],
                                            "max_tokens": 6})
                    toks = []
                    while True:
                        d = s.next_delta(timeout=30)
                        toks += d.tokens
                        if d.finished:
                            break
                    lanes.append(s._entry.lane)
                    assert len(toks) >= 1
                except Exception as e:
                    errors.append(repr(e))

        threads = [threading.Thread(target=streams) for _ in range(2)]
        for t in threads:
            t.start()
        time.sleep(0.3)
        admin.update_inference_job(uid, "g", -1, trial_id=target,
                                   canary_fraction=0.5)
        st = _wait_terminal(admin, job_id, timeout_s=120)
        stop.set()
        for t in threads:
            t.join(timeout=60)
        assert st["phase"] == RolloutPhase.DONE, st["reason"]
        assert errors == []
        assert {"canary", "incumbent"} <= set(lanes)
        (w,) = admin.services.live_inference_workers(job_id)
        assert (w["trial_id"], w["model_version"]) == (target, 1)
        assert predictor.gen_continuity_stats()["resume_failures"] == 0
    finally:
        admin.shutdown()
