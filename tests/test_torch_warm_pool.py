"""The warm standby pool: ``rafiki_tpu_torch/admin/warm_pool.py`` and the
services' standby primitives, after the warm-pool cases of
``tests/test_cold_start.py``, on the CPU.

- The standby column round trip and the arbiter's standby tags equal the
  JAX package's on the same calls.
- Through the port's ``Admin`` (an allocator over ``cpu:0`` .. ``cpu:3``):
  a standby is placed and warmed (RUNNING only after its ``warm_up``) and
  never routed; a routed replica that dies under load is replaced by the
  standby with no failed request; a scale-up promotes before it deploys;
  the tick tops up, shrinks and retires a stale version; failed
  placements in a row park the pool DEGRADED until the cooldown, then it
  recovers; training's reclaim destroys standbys first.
"""

import threading
import time

from rafiki_tpu.db.database import Database as JaxDatabase
from rafiki_tpu.placement import hosts as jhosts
from rafiki_tpu_torch.constants import ServiceType
from rafiki_tpu_torch.db.database import Database
from rafiki_tpu_torch.placement import hosts as thosts
from rafiki_tpu_torch.worker.inference import serving_stats

from test_torch_rollout import fake_app, job_id_of, make_admin

CARDS = ("cpu:0", "cpu:1", "cpu:2", "cpu:3")


def _standby_rows(db_cls):
    db = db_cls(":memory:")
    uid = db.create_user("a@b", "x", "ADMIN")["id"]
    tj = db.create_train_job(uid, "app", 1, "T", "u", "e", {})
    model = db.create_model(uid, "m", "T", b"", "M", {}, "PRIVATE")
    sub = db.create_sub_train_job(tj["id"], model["id"])
    trial = db.create_trial(sub["id"], model["id"], {})
    inf = db.create_inference_job(uid, tj["id"])
    svc = db.create_service(ServiceType.INFERENCE)
    out = [db.create_inference_job_worker(svc["id"], inf["id"], trial["id"],
                                          model_version=2, standby=True)]
    out.append(db.get_inference_job_worker(svc["id"]))
    db.set_worker_standby(svc["id"], False)
    db.set_worker_borrowed_chips(svc["id"], 2)
    out.append(db.get_inference_job_worker(svc["id"]))
    db.set_worker_standby(svc["id"], True)
    db.set_worker_borrowed_chips(svc["id"], 0)
    out.append(db.get_workers_of_inference_job(inf["id"]))
    ids = {svc["id"]: "svc", inf["id"]: "inf", trial["id"]: "trial"}
    return [{k: ids.get(v, v) for k, v in dict(r).items()}
            for row in out for r in (row if isinstance(row, list) else [row])]


def test_the_standby_column_round_trips_as_in_jax():
    ours = _standby_rows(Database)
    assert ours == _standby_rows(JaxDatabase)
    assert [int(r["standby"]) for r in ours] == [1, 1, 0, 1]


class _FakeAllocator:
    def __init__(self, total, free):
        self.total_chips = total
        self.free_chips = free


def _tags(mod):
    arb = mod.ChipBudgetArbiter(_FakeAllocator(total=8, free=8))
    arb.note_borrow("svc-serve", "job-1", [0])
    arb.note_borrow("svc-stby", "job-1", [1, 2])
    arb.mark_standby("svc-stby", True)
    arb.mark_standby("svc-ghost", True)
    out = [arb.loan_split()]
    arb.mark_standby("svc-stby", False)
    out.append(arb.loan_split())
    arb.mark_standby("svc-stby", True)
    arb.note_return("svc-stby")
    out.append(arb.loan_split())
    return out


def test_the_arbiters_standby_tags_match_jaxs():
    ours = _tags(thosts)
    assert ours == _tags(jhosts)
    assert ours[0] == {"serving": 1, "standby": 2}


def test_a_standby_is_placed_warm_and_never_routed(tmp_path):
    admin = make_admin(tmp_path, CARDS)
    try:
        uid = fake_app(admin, "wp")
        job_id = job_id_of(admin, uid, "wp")
        live0 = admin.services.live_inference_workers(job_id)
        sid = admin.services.create_standby_replica(job_id)
        # RUNNING: loaded, and ctx.ready() came after its warm_up
        assert admin.db.get_service(sid)["status"] == "RUNNING"
        assert [w["service_id"] for w in
                admin.services.standby_workers(job_id)] == [sid]
        assert admin.services.live_inference_workers(job_id) == live0
        predictor = admin.services.get_predictor(job_id)
        assert sid in predictor.queue_depths()  # its queue is registered
        for _ in range(20):
            assert admin.predict(uid, "wp", [[0.0]])
        assert serving_stats().get(sid, {}).get("queries", 0) == 0
        report = admin.warm_pool.report()
        assert report["enabled"] is False and report["running"] is False
    finally:
        admin.shutdown()


def test_a_killed_replica_is_replaced_by_the_standby_with_no_errors(
        tmp_path):
    admin = make_admin(tmp_path, CARDS)
    try:
        uid = fake_app(admin, "kill")
        job_id = job_id_of(admin, uid, "kill")
        stby = admin.services.create_standby_replica(job_id)
        victim = admin.services.live_inference_workers(job_id)[0][
            "service_id"]
        errors, lock, stop = [], threading.Lock(), threading.Event()

        def client():
            while not stop.is_set():
                try:
                    admin.predict(uid, "kill", [[0.0]])
                except Exception as e:
                    with lock:
                        errors.append(repr(e))

        threads = [threading.Thread(target=client) for _ in range(4)]
        for t in threads:
            t.start()
        time.sleep(0.3)
        # the replica dies: its worker gone, then the ERRORED verdict
        admin.placement.destroy_service(victim)
        admin._on_service_status(victim, "ERRORED")
        time.sleep(0.5)
        stop.set()
        for t in threads:
            t.join(timeout=10)
        assert errors == []
        live = [w["service_id"]
                for w in admin.services.live_inference_workers(job_id)]
        assert stby in live and victim not in live
        assert admin.services.standby_workers(job_id) == []
        assert admin.db.get_inference_job(job_id)["status"] == "RUNNING"
        assert "replace" in [e["action"] for e in admin.warm_pool.events]
        assert serving_stats()[stby]["queries"] > 0
    finally:
        admin.shutdown()


def test_a_scale_up_promotes_before_it_deploys(tmp_path):
    admin = make_admin(tmp_path, CARDS)
    try:
        uid = fake_app(admin, "promo")
        job_id = job_id_of(admin, uid, "promo")
        stby = admin.services.create_standby_replica(job_id)
        n_live = len(admin.services.live_inference_workers(job_id))
        n_services = len(admin.db.get_services())
        report = admin.services.scale_inference_job(job_id, 1)
        assert report["added"] == report["promoted"] == [stby]
        assert report["borrowed_chips"] == 0
        assert len(admin.services.live_inference_workers(job_id)) == \
            n_live + 1
        assert len(admin.db.get_services()) == n_services  # no deploy
        assert admin.db.get_inference_job_worker(stby)["standby"] == 0
        assert admin.chip_arbiter.loan_split()["standby"] == 0
    finally:
        admin.shutdown()


def test_the_tick_tops_up_shrinks_and_retires_a_stale_version(
        tmp_path, monkeypatch):
    admin = make_admin(tmp_path, CARDS)
    try:
        uid = fake_app(admin, "pool")
        job_id = job_id_of(admin, uid, "pool")
        monkeypatch.setenv("RAFIKI_AUTOSCALE_WARM_POOL", "2")
        assert [a["action"] for a in admin.warm_pool.tick()] == [
            "place", "place"]
        assert len(admin.services.standby_workers(job_id)) == 2
        monkeypatch.setenv("RAFIKI_AUTOSCALE_WARM_POOL", "1")
        assert [a["action"] for a in admin.warm_pool.tick()] == ["shrink"]
        (stale,) = admin.services.standby_workers(job_id)
        # a rollout moved the group past the standby's version
        svc = admin.db.create_service(ServiceType.INFERENCE)
        admin.db.create_inference_job_worker(svc["id"], job_id,
                                             stale["trial_id"],
                                             model_version=3)
        admin.db.mark_service_as_running(svc["id"])
        actions = [a["action"] for a in admin.warm_pool.tick()]
        assert actions == ["retire_stale", "place"]
        now = admin.services.standby_workers(job_id)
        assert stale["service_id"] not in [w["service_id"] for w in now]
        assert [w["model_version"] for w in now] == [3]
        assert admin.warm_pool.report()["target_per_job"] == 1
    finally:
        admin.shutdown()


def test_bounded_retries_park_the_pool_degraded_then_it_recovers(
        tmp_path, monkeypatch):
    admin = make_admin(tmp_path, CARDS)
    try:
        uid = fake_app(admin, "deg")
        job_id = job_id_of(admin, uid, "deg")
        monkeypatch.setenv("RAFIKI_AUTOSCALE_WARM_POOL", "1")
        monkeypatch.setenv("RAFIKI_AUTOSCALE_WARM_RETRY_MAX", "2")
        monkeypatch.setenv("RAFIKI_AUTOSCALE_WARM_RETRY_COOLDOWN_S", "0.2")
        real = admin.services.create_standby_replica

        def broken(_job_id):
            raise RuntimeError("no capacity for standbys")

        monkeypatch.setattr(admin.services, "create_standby_replica",
                            broken)
        assert [a["action"] for a in admin.warm_pool.tick()] == [
            "place_failed"]
        assert [a["action"] for a in admin.warm_pool.tick()] == ["degraded"]
        rep = admin.warm_pool.report()["jobs"][job_id]
        assert rep["degraded"] is True
        assert "no capacity" in rep["last_error"]
        assert admin.warm_pool.tick() == []  # cooling down: no placement
        monkeypatch.setattr(admin.services, "create_standby_replica", real)
        time.sleep(0.25)
        assert [a["action"] for a in admin.warm_pool.tick()] == ["place"]
        assert len(admin.services.standby_workers(job_id)) == 1
        assert admin.warm_pool.report()["jobs"][job_id] == {
            "failures": 0, "degraded": False, "last_error": None}
    finally:
        admin.shutdown()


def test_training_reclaim_destroys_standbys_first(tmp_path, monkeypatch):
    monkeypatch.setenv("RAFIKI_AUTOSCALE_TRAIN_FLOOR", "0")
    admin = make_admin(tmp_path, CARDS)
    try:
        uid = fake_app(admin, "rec")
        job_id = job_id_of(admin, uid, "rec")
        r = admin.services.scale_inference_job(job_id, 1)
        assert r["borrowed_chips"] == 1
        routable = r["added"][0]
        stby = admin.services.create_standby_replica(job_id)
        assert admin.chip_arbiter.loan_split() == {"serving": 1,
                                                   "standby": 1}
        assert admin.chip_arbiter.reclaim_for_training(1) == 1
        assert admin.services.standby_workers(job_id) == []
        assert routable in [w["service_id"] for w in
                            admin.services.live_inference_workers(job_id)]
        assert admin.chip_arbiter.loan_split() == {"serving": 1,
                                                   "standby": 0}
        assert admin.predict(uid, "rec", [[0.0]])
    finally:
        admin.shutdown()


def test_the_pool_loop_runs_when_switched_on(tmp_path, monkeypatch):
    monkeypatch.setenv("RAFIKI_AUTOSCALE_WARM_POOL", "1")
    monkeypatch.setenv("RAFIKI_AUTOSCALE_WARM_POOL_INTERVAL_S", "0.1")
    admin = make_admin(tmp_path, CARDS)
    try:
        assert admin.warm_pool.running
        uid = fake_app(admin, "loop")
        job_id = job_id_of(admin, uid, "loop")
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline and not \
                admin.services.standby_workers(job_id):
            time.sleep(0.05)
        assert len(admin.services.standby_workers(job_id)) == 1
    finally:
        admin.shutdown()
    assert not admin.warm_pool.running
