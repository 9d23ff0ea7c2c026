"""The serving autoscaler, the chip arbiter and the metrics registry:
``rafiki_tpu_torch/admin/autoscaler.py``, ``placement/hosts.py`` and
``utils/metrics.py`` against the JAX package's and
``tests/test_autoscaler.py``, on the CPU.

- The registry: the same operations give the same counters, gauges,
  histogram buckets and quantiles and ring series in both packages.
- The arbiter: the same call sequence gives the same loan book, floor
  answers, standby tags and reclaims in both packages.
- The decision table: both packages' ``Autoscaler.tick`` fed the same
  signal sequence (a scripted fleet on a scripted clock) take the same
  decisions with the same reasons and signals.
- Through the port's ``Admin`` on an allocator over four CPU entries
  (``cpu:0`` .. ``cpu:3``, a four-card host): a flood scales a job up
  (borrowing a card above the floor) and idle drains it back with every
  admitted request answered; a drain under load drops nothing, and two
  drains of one replica do the work once; the floor refuses a borrow and
  a train job that cannot allocate reclaims the loan; the cooldowns and
  ``MAX_REPLICAS`` bound the loop; occupancy alone scales a job up; the
  operator's scale API answers over HTTP.
"""

import threading
import time
import types

import pytest

from rafiki_tpu.admin import autoscaler as jautoscaler
from rafiki_tpu.placement import hosts as jhosts
from rafiki_tpu.utils import metrics as jmetrics
from rafiki_tpu_torch import config
from rafiki_tpu_torch.admin import autoscaler as tautoscaler
from rafiki_tpu_torch.admin.http import AdminServer
from rafiki_tpu_torch.admin.services import ServiceDeploymentError
from rafiki_tpu_torch.client.client import Client, RafikiError
from rafiki_tpu_torch.placement import hosts as thosts
from rafiki_tpu_torch.utils import chaos
from rafiki_tpu_torch.utils import metrics as tmetrics

from test_torch_rollout import (
    fake_app,
    job_id_of,
    login,
    make_admin,
    wait_for,
)

CARDS = ("cpu:0", "cpu:1", "cpu:2", "cpu:3")


@pytest.fixture(autouse=True)
def _clean_chaos():
    chaos.clear()
    yield
    chaos.clear()


class _Clock:
    """A scripted clock for both packages' ``time`` module."""

    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t

    def time(self):
        return 1.7e9 + self.t

    def sleep(self, s):
        self.t += s


@pytest.fixture()
def clock(monkeypatch):
    c = _Clock()
    for mod in (jautoscaler, tautoscaler, jmetrics, tmetrics):
        monkeypatch.setattr(mod, "time", c)
    return c


def _replicas(admin, job_id):
    return len(admin.services.live_inference_workers(job_id))


# ---------------------------------------------------------------------------
# the registry, both packages
# ---------------------------------------------------------------------------

def _registry_ops(mod, clock):
    clock.t = 1000.0
    reg = mod.Registry()
    c = reg.counter("c_total", "a counter", ("job",))
    c.labels("a").inc()
    c.labels("a").inc(2.5)
    c.labels("b").inc()
    reg.counter("c_total", "again", ("job",)).labels("b").inc()
    g = reg.gauge("g", "a gauge")
    g.set(3)
    g.labels().inc(0.5)
    h = reg.histogram("h_seconds", "a histogram", ("lane",))
    for v in (0.0001, 0.003, 0.003, 0.02, 0.5, 7.0, 1e9, float("nan")):
        h.labels("x").observe(v)
    r = reg.ring("depth")
    for i in range(5):
        r.record(i)
        r.record(i * 10)
        clock.sleep(1.0)
    s = reg.ring("sheds")
    for i in range(4):
        s.add()
        s.add(2)
        clock.sleep(1.0 if i % 2 else 0.3)
    with pytest.raises(ValueError):
        reg.gauge("c_total", "", ("job",))
    with pytest.raises(ValueError):
        c.labels("a", "b")
    child = h.labels("x")
    return (reg.snapshot(),
            [child.quantile(q) for q in (0.0, 0.5, 0.9, 0.99, 1.0)],
            h.labels("empty").quantile(0.5), c.value("a"), g.value())


def test_the_registry_matches_jaxs_on_the_same_operations(clock):
    ours = _registry_ops(tmetrics, clock)
    theirs = _registry_ops(jmetrics, clock)
    assert ours == theirs
    assert ours[0]["rings"]["depth"][-1][1] == 40.0
    assert tmetrics.REGISTRY is tmetrics.REGISTRY  # one registry a process


def test_a_disabled_registry_writes_nothing(monkeypatch, clock):
    monkeypatch.setenv("RAFIKI_METRICS", "0")
    reg = tmetrics.Registry()
    reg.counter("x").inc()
    reg.histogram("y").observe(1.0)
    reg.ring("z").add()
    snap = reg.snapshot()
    assert snap["metrics"]["x"] == 0.0
    assert snap["metrics"]["y"]["count"] == 0
    assert snap["rings"]["z"] == []


# ---------------------------------------------------------------------------
# the arbiter, both packages
# ---------------------------------------------------------------------------

class _FakeAllocator:
    def __init__(self, total, free):
        self.total_chips = total
        self.free_chips = free


def _arbiter_sequence(mod, monkeypatch):
    monkeypatch.setenv("RAFIKI_AUTOSCALE_TRAIN_FLOOR", "2")
    alloc = _FakeAllocator(total=8, free=4)
    arb = mod.ChipBudgetArbiter(alloc)
    out = [arb.floor(), arb.capacity(), arb.begin_borrow(3) is None,
           arb.begin_borrow(0) is None,
           mod.ChipBudgetArbiter(None).begin_borrow(1) is None]
    t1 = arb.begin_borrow(1)
    t2 = arb.begin_borrow(1)
    out += [t1 is not None, t2 is not None, arb.begin_borrow(1) is None]
    arb.cancel_borrow(t2)
    t3 = arb.begin_borrow(1)
    out.append(t3 is not None)
    arb.cancel_borrow(t3)
    arb.commit_borrow(t1, "svc-a", "job-1", ["cpu:2"])
    alloc.free_chips = 3
    arb.note_borrow("svc-b", "job-1", [4, 5])
    arb.note_borrow("svc-c", "job-2", 1)
    arb.note_borrow("svc-z", "job-2", [])
    arb.mark_standby("svc-b", True)
    arb.mark_standby("svc-ghost", True)
    out += [arb.borrowed(), arb.loan_split(), arb.borrowed_chips()]
    drained = []

    def reclaim(n):
        freed = 0
        for sid in sorted(arb.borrowed()):
            if freed >= n:
                break
            drained.append(sid)
            freed += arb.note_return(sid)
        return freed

    out.append(arb.reclaim_for_training(1))
    arb.set_reclaim_callback(reclaim)
    out += [arb.reclaim_for_training(0), arb.reclaim_for_training(2),
            list(drained), arb.loan_split(), arb.note_return("svc-a"),
            arb.reclaim_for_training(5), arb.borrowed(),
            arb.note_return("svc-c"), arb.reclaim_for_training(5)]
    return out


def test_the_arbiter_matches_jaxs_on_the_same_calls(monkeypatch):
    ours = _arbiter_sequence(thosts, monkeypatch)
    assert ours == _arbiter_sequence(jhosts, monkeypatch)
    # the floor is a hard bound: 4 free less 3 is under 2; two borrows of
    # one reach it, and a third waits for a cancel
    assert ours[2:9] == [True, True, True, True, True, True, True]


# ---------------------------------------------------------------------------
# the decision table, both packages on one script
# ---------------------------------------------------------------------------

class _ScriptedFleet:
    """The services, store and predictor a tick reads, scripted: the
    replicas follow the decisions."""

    def __init__(self, mod):
        self.replicas, self.shed, self.backlog = 1, 0, 0
        self.reg = (tmetrics if mod is tautoscaler else jmetrics).REGISTRY
        predictor = types.SimpleNamespace(
            backlog_depth=lambda: self.backlog,
            overload_stats=lambda: {"requests_shed": self.shed,
                                    "trials_shed": 0})
        self.services = types.SimpleNamespace(
            predictors=lambda: {"job": predictor},
            live_inference_workers=lambda job: [{}] * self.replicas,
            scale_inference_job=self.scale,
            door=lambda job: None, _predict_servers={})
        self.admin = types.SimpleNamespace(
            services=self.services,
            db=types.SimpleNamespace(
                get_inference_job=lambda job: {"status": "RUNNING"}))

    def scale(self, job, delta, min_replicas=1):
        self.replicas += delta
        return {"added": ["r"] * max(delta, 0),
                "removed": ["r"] * max(-delta, 0), "promoted": [],
                "borrowed_chips": 0, "returned_chips": 0}


#: each tick: (sheds since the last, backlog, an occupancy sample or None)
TICKS = ([(0, 0, None)] * 2 + [(3, 0, None), (2, 0, None), (1, 6, None)]
         + [(0, 9, None)] * 3 + [(0, 0, None)] * 8 + [(0, 0, 0.95)] * 4
         + [(0, 0, 0.3)] * 3 + [(0, 0, None)] * 14)


def _decisions(mod, clock, monkeypatch):
    for k, v in (("RAFIKI_AUTOSCALE_WINDOW_S", "6"),
                 ("RAFIKI_AUTOSCALE_SHED_THRESHOLD", "2"),
                 ("RAFIKI_AUTOSCALE_DEPTH_HIGH", "4"),
                 ("RAFIKI_AUTOSCALE_DEPTH_LOW", "1"),
                 ("RAFIKI_AUTOSCALE_MIN_REPLICAS", "1"),
                 ("RAFIKI_AUTOSCALE_MAX_REPLICAS", "6"),
                 ("RAFIKI_AUTOSCALE_COOLDOWN_UP_S", "2"),
                 ("RAFIKI_AUTOSCALE_COOLDOWN_DOWN_S", "3"),
                 ("RAFIKI_GEN_OCCUPANCY_HIGH", "0.8")):
        monkeypatch.setenv(k, v)
    clock.t = 1000.0
    fleet = _ScriptedFleet(mod)
    scaler = mod.Autoscaler(fleet.admin)
    ring = fleet.reg.ring("slot_occupancy:job:job")
    out = []
    for shed, backlog, occ in TICKS:
        fleet.shed += shed
        fleet.backlog = backlog
        if occ is not None:
            ring.record(occ)
        for e in scaler.tick():
            out.append({k: v for k, v in e.items() if k != "ts"})
        out.append(fleet.replicas)
        clock.sleep(1.0)
    report = scaler.report()
    return out, {k: v for k, v in report.items() if k != "jobs"}


def test_the_decisions_match_jaxs_on_the_same_signals(clock, monkeypatch):
    ours = _decisions(tautoscaler, clock, monkeypatch)
    assert ours == _decisions(jautoscaler, clock, monkeypatch)
    events = [e for e in ours[0] if isinstance(e, dict)]
    reasons = [e["reason"] for e in events]
    assert "sustained shed" in reasons and "sustained idle" in reasons
    assert "sustained backlog depth" in reasons
    assert "generation slot occupancy" in reasons
    assert all(set(e["signals"]) >= {"shed_in_window", "mean_backlog",
                                     "max_backlog", "replicas"}
               for e in events)


# ---------------------------------------------------------------------------
# through the port's admin
# ---------------------------------------------------------------------------

def _stall_job(job_id, delay_s):
    """Stall only this job's serving batches (the worker chaos site)."""
    chaos.install([chaos.ChaosRule(site=chaos.SITE_WORKER,
                                   action=chaos.ACTION_DELAY, match=job_id,
                                   delay_s=delay_s)])


def test_a_flood_scales_up_and_idle_drains_back(tmp_path, monkeypatch):
    """The real loop: a flood past the queues sheds, the loop adds a
    replica on a borrowed card; idle drains it back to MIN_REPLICAS with
    the card returned; every admitted request is answered and every shed
    is a typed overload."""
    for k, v in (("RAFIKI_PREDICT_QUEUE_DEPTH", "1"),
                 ("RAFIKI_AUTOSCALE", "1"),
                 ("RAFIKI_AUTOSCALE_INTERVAL_S", "0.2"),
                 ("RAFIKI_AUTOSCALE_WINDOW_S", "3"),
                 ("RAFIKI_AUTOSCALE_SHED_THRESHOLD", "2"),
                 ("RAFIKI_AUTOSCALE_DEPTH_HIGH", "1000"),
                 ("RAFIKI_AUTOSCALE_DEPTH_LOW", "1"),
                 ("RAFIKI_AUTOSCALE_MIN_REPLICAS", "2"),
                 ("RAFIKI_AUTOSCALE_MAX_REPLICAS", "3"),
                 ("RAFIKI_AUTOSCALE_COOLDOWN_UP_S", "0.3"),
                 ("RAFIKI_AUTOSCALE_COOLDOWN_DOWN_S", "1.0")):
        monkeypatch.setenv(k, v)
    admin = make_admin(tmp_path, CARDS)
    try:
        uid = fake_app(admin, "ela")
        job_id = job_id_of(admin, uid, "ela")
        assert admin.autoscaler.running
        assert _replicas(admin, job_id) == 2
        free_before = admin.placement.allocator.free_chips
        _stall_job(job_id, 1.0)
        statuses, lock = [], threading.Lock()

        def fire():
            try:
                admin.predict(uid, "ela", [[0.0]])
                code = 200
            except Exception as e:
                assert type(e).__name__ in (
                    "QueueFullError", "ServerOverloadedError",
                    "DeadlineUnmeetableError"), repr(e)
                code = 429
            with lock:
                statuses.append(code)

        flood = [threading.Thread(target=fire) for _ in range(10)]
        for t in flood:
            t.start()
            time.sleep(0.05)
        wait_for(lambda: any(e["action"] == "scale_up"
                             for e in admin.autoscaler.events), 15,
                 "the scale-up")
        (up,) = [e for e in admin.autoscaler.events
                 if e["action"] == "scale_up"]
        assert up["job_id"] == job_id and up["reason"] == "sustained shed"
        assert up["signals"]["shed_in_window"] >= 2
        assert up["result"]["borrowed_chips"] == 1
        assert _replicas(admin, job_id) == 3
        for t in flood:
            t.join(timeout=30)
        assert statuses.count(200) >= 4
        chaos.clear()
        # requests sent while the replica drains are all answered
        answered = []
        wait_for(lambda: answered.append(
            admin.predict(uid, "ela", [[0.0]])) or any(
                e["action"] == "scale_down"
                for e in admin.autoscaler.events), 30, "the scale-down")
        assert all(answered)
        down = [e for e in admin.autoscaler.events
                if e["action"] == "scale_down"][0]
        assert down["reason"] == "sustained idle"
        assert _replicas(admin, job_id) == 2
        assert admin.chip_arbiter.borrowed_chips() == 0
        assert admin.placement.allocator.free_chips == free_before
        report = admin.autoscaler.report()
        assert report["enabled"] and report["running"]
        assert report["chip_budget"]["train_floor_chips"] == 1
    finally:
        admin.shutdown()


def test_a_drain_under_load_drops_nothing(tmp_path, monkeypatch):
    monkeypatch.setenv("RAFIKI_PREDICT_QUEUE_DEPTH", "8")
    admin = make_admin(tmp_path, CARDS)
    try:
        uid = fake_app(admin, "drn")
        job_id = job_id_of(admin, uid, "drn")
        _stall_job(job_id, 0.25)
        results, lock, stop = [], threading.Lock(), threading.Event()

        def client():
            while not stop.is_set():
                try:
                    preds = admin.predict(uid, "drn", [[0.0]])
                    with lock:
                        results.append(("ok", preds is not None))
                except Exception as e:
                    with lock:
                        results.append(("err", repr(e)))

        clients = [threading.Thread(target=client) for _ in range(4)]
        for t in clients:
            t.start()
        time.sleep(0.4)
        report = admin.services.scale_inference_job(job_id, -1)
        assert len(report["removed"]) == 1
        assert _replicas(admin, job_id) == 1
        # below MIN_REPLICAS (1): a no-op
        assert admin.services.scale_inference_job(job_id, -1)["removed"] \
            == []
        time.sleep(0.3)
        stop.set()
        for t in clients:
            t.join(timeout=30)
        assert [r for r in results if r[0] == "err"] == []
        assert len(results) >= 8
        assert report["removed"][0] not in admin.services.get_predictor(
            job_id).queue_depths()
    finally:
        admin.shutdown()


def test_two_drains_of_one_replica_do_the_work_once(tmp_path):
    admin = make_admin(tmp_path, CARDS)
    try:
        uid = fake_app(admin, "idm")
        job_id = job_id_of(admin, uid, "idm")
        victim = admin.services.live_inference_workers(job_id)[0][
            "service_id"]
        outcomes = []
        threads = [threading.Thread(target=lambda: outcomes.append(
            admin.services.drain_replicas(job_id, [victim])))
            for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert sorted(len(removed) for _, removed in outcomes) == [0, 1]
        assert _replicas(admin, job_id) == 1
        assert admin.predict(uid, "idm", [[0.0]])
    finally:
        admin.shutdown()


def test_scaling_needs_a_running_job(tmp_path):
    admin = make_admin(tmp_path)
    try:
        with pytest.raises(ServiceDeploymentError):
            admin.services.scale_inference_job("no-such-job", 1)
    finally:
        admin.shutdown()


def test_a_borrow_only_above_the_floor_and_training_reclaims(tmp_path,
                                                             monkeypatch):
    """Floor at every free card: the scale-up shares a device, no loan.
    Floor 1: it borrows a card. A train job that then cannot allocate its
    cards reclaims the loan (the borrowed replica drains) and starts."""
    admin = make_admin(tmp_path, CARDS)
    alloc = admin.placement.allocator
    try:
        uid = fake_app(admin, "brw")
        job_id = job_id_of(admin, uid, "brw")
        free0 = alloc.free_chips
        assert free0 == 2
        monkeypatch.setenv("RAFIKI_AUTOSCALE_TRAIN_FLOOR", str(free0))
        r1 = admin.services.scale_inference_job(job_id, 1)
        assert r1["borrowed_chips"] == 0 and alloc.free_chips == free0
        shared = admin.db.get_service(r1["added"][0])["chips"]
        assert shared == ["cpu:0"]  # a shared device, owned by no one
        monkeypatch.setenv("RAFIKI_AUTOSCALE_TRAIN_FLOOR", "1")
        r2 = admin.services.scale_inference_job(job_id, 1)
        assert r2["borrowed_chips"] == 1
        (borrowed_sid,) = admin.chip_arbiter.borrowed()
        assert admin.db.get_inference_job_worker(borrowed_sid)[
            "borrowed_chips"] == 1
        assert alloc.free_chips == free0 - 1
        # two one-card trial executors need both free cards: the second
        # reclaims the loan
        admin.create_train_job(uid, "trn", "IMAGE_CLASSIFICATION", "t", "e",
                               budget={"MODEL_TRIAL_COUNT": 2,
                                       "CHIP_COUNT": 2})
        assert admin.chip_arbiter.borrowed_chips() == 0
        assert borrowed_sid not in [
            w["service_id"]
            for w in admin.services.live_inference_workers(job_id)]
        assert admin.wait_until_train_job_stopped(
            uid, "trn", timeout_s=60)["status"] == "STOPPED"
        assert admin.predict(uid, "brw", [[0.0]])
    finally:
        admin.shutdown()


def test_the_cooldowns_and_max_replicas_bound_the_loop(tmp_path,
                                                       monkeypatch):
    for k, v in (("RAFIKI_AUTOSCALE_WINDOW_S", "30"),
                 ("RAFIKI_AUTOSCALE_DEPTH_HIGH", "1000"),
                 ("RAFIKI_AUTOSCALE_SHED_THRESHOLD", "1"),
                 ("RAFIKI_AUTOSCALE_COOLDOWN_UP_S", "9999"),
                 ("RAFIKI_AUTOSCALE_COOLDOWN_DOWN_S", "0"),
                 ("RAFIKI_AUTOSCALE_MIN_REPLICAS", "1"),
                 ("RAFIKI_AUTOSCALE_MAX_REPLICAS", "2")):
        monkeypatch.setenv(k, v)
    admin = make_admin(tmp_path, CARDS)
    scaler = admin.autoscaler
    try:
        uid = fake_app(admin, "tck")
        job_id = job_id_of(admin, uid, "tck")
        assert not scaler.running
        predictor = admin.services.get_predictor(job_id)
        predictor._bump("requests_shed", 5)
        scaler.tick()
        predictor._bump("requests_shed", 5)
        assert scaler.tick() == []  # at MAX_REPLICAS
        monkeypatch.setenv("RAFIKI_AUTOSCALE_WINDOW_S", "9999")
        assert scaler.tick() == []  # one fresh sample drains no one
        assert _replicas(admin, job_id) == 2
        monkeypatch.setenv("RAFIKI_AUTOSCALE_WINDOW_S", "30")
        monkeypatch.setenv("RAFIKI_AUTOSCALE_MAX_REPLICAS", "4")
        monkeypatch.setenv("RAFIKI_AUTOSCALE_COOLDOWN_UP_S", "0")
        predictor._bump("requests_shed", 5)
        assert [a["action"] for a in scaler.tick()] == ["scale_up"]
        assert _replicas(admin, job_id) == 3
        monkeypatch.setenv("RAFIKI_AUTOSCALE_COOLDOWN_UP_S", "9999")
        predictor._bump("requests_shed", 5)
        assert scaler.tick() == []  # cooling down
        assert _replicas(admin, job_id) == 3
    finally:
        admin.shutdown()


def test_slot_occupancy_alone_scales_a_job_up(tmp_path, monkeypatch):
    for k, v in (("RAFIKI_AUTOSCALE_WINDOW_S", "30"),
                 ("RAFIKI_AUTOSCALE_SHED_THRESHOLD", "1000"),
                 ("RAFIKI_AUTOSCALE_DEPTH_HIGH", "1000"),
                 ("RAFIKI_AUTOSCALE_DEPTH_LOW", "1000"),
                 ("RAFIKI_AUTOSCALE_COOLDOWN_UP_S", "0"),
                 ("RAFIKI_AUTOSCALE_COOLDOWN_DOWN_S", "0"),
                 ("RAFIKI_GEN_OCCUPANCY_HIGH", "0.8")):
        monkeypatch.setenv(k, v)
    admin = make_admin(tmp_path, CARDS)
    try:
        uid = fake_app(admin, "gocc")
        job_id = job_id_of(admin, uid, "gocc")
        ring = tmetrics.REGISTRY.ring(f"slot_occupancy:job:{job_id}")
        before = _replicas(admin, job_id)
        ring.record(0.2)
        admin.autoscaler.tick()
        assert _replicas(admin, job_id) == before
        ring.record(1.0)
        (action,) = admin.autoscaler.tick()
        assert action["action"] == "scale_up"
        assert action["reason"] == "generation slot occupancy"
        assert action["signals"]["slot_occupancy"] >= 0.5
        assert _replicas(admin, job_id) == before + 1
    finally:
        admin.shutdown()


def test_the_operator_scale_api_over_http(tmp_path):
    admin = make_admin(tmp_path, CARDS)
    server = AdminServer(admin, port=0).start()
    try:
        fake_app(admin, "api")
        client = Client("127.0.0.1", server.port, timeout_s=60)
        client.login(config.SUPERADMIN_EMAIL, config.SUPERADMIN_PASSWORD)
        out = client.scale_inference_job("api", delta=1)
        assert len(out["added"]) == 1 and out["replicas"] == 3
        out = client.scale_inference_job("api", delta=-1)
        assert len(out["removed"]) == 1 and out["replicas"] == 2
        for delta in (0, 99):
            with pytest.raises(RafikiError) as err:
                client.scale_inference_job("api", delta=delta)
            assert err.value.status == 400
        client.stop_inference_job("api")
        with pytest.raises(RafikiError) as err:
            client.scale_inference_job("api", delta=1)
        assert err.value.status == 400
        assert login(admin)
    finally:
        server.stop()
        admin.shutdown()
