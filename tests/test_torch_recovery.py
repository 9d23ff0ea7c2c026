"""Crash recovery: ``rafiki_tpu_torch/admin/recovery.py`` and process
adoption against ``rafiki_tpu``'s, on the CPU.

- Boot reconciliation on seeded stores: the same store rows are seeded,
  through each package's ``Database``, into each package's store, and
  each package's ``Admin`` boots on its store with one fake placement
  (``FakeHosts`` below) carrying the duck-typed surface recovery reads
  of a host placement (``probe_inventories``, ``adopt_service``,
  ``fence_service``, ``reschedule_service``, ``quarantine_on_rejoin``).
  Compared exactly: the report's counts, its reasons with the ids
  replaced by their labels, the placement's calls, every seeded row's
  status, the rollout rows' phases and the drift rows' phases and event
  names, the chip arbiter's loan book.
- The restart drills of ``tests/test_restart_recovery.py`` over real
  host agents (at the end of this file): each package's admin places a
  fleet on its ``AgentServer``s (thread engines,
  ``test_torch_hosts.ThreadEngine``), is dropped, and a second admin
  reconciles through the agents: adoption without a redeploy, the job's
  door rebound, a dead host's train service placed again, orphans
  fenced (or not, when the fence cannot land, or all of them under
  ``RAFIKI_RECOVER_ADOPT=0``), a rollout resolved, chip loans rebuilt,
  and the drift loop resumed or parked; reports, rows and answers
  compared.
- ``db`` chaos retried through the scan; an aborted reconcile shows in
  the report and in ``recovery.json``; the door's recovering gate
  answers as JAX's does route by route; the drift tick waits while the
  admin recovers; the rebuilt advisor proposes what JAX's rebuilt
  advisor proposes from the same replayed trials (exact knobs: both GPs
  seed 0).
- Real children: an admin process (CPU, process placement) is SIGKILLed
  mid-trial; its train child, carrying ``RAFIKI_ORPHAN_SURVIVE=1``, is
  reparented and trains on, a second admin on the same store and door
  adopts it by pid, and it finishes its trial with the score of the same
  trial run in-process (exact: an accuracy over 16 test images); the
  same under HA with the first admin fenced (stopped past its lease)
  rather than killed (stopped outside a store write), then SIGTERMed:
  its shutdown leaves the adopted child training, and ends within 5 s
  with the store's write lock held elsewhere across the SIGTERM;
  ``_pid_is_worker`` refuses a dead pid, another service's pid and a JAX
  bootstrap; the bootstrap's watchdog stops a child without the flag on
  reparenting and keeps a survivable one until its row is terminal; a
  two-rank gloo trial placed again by ``restart_train_worker`` trains
  over both ranks again.
"""

import json
import os
import re
import signal
import socket
import sqlite3
import subprocess
import sys
import time
import types
import urllib.request
from pathlib import Path

import pytest

from rafiki_tpu import config as jax_config
from rafiki_tpu.admin.admin import Admin as JaxAdmin
from rafiki_tpu.admin.http import AdminServer as JaxAdminServer
from rafiki_tpu.admin.recovery import ControlPlaneRecovery as JaxRecovery
from rafiki_tpu.db.database import Database as JaxDatabase
from rafiki_tpu.placement import manager as jax_manager
from rafiki_tpu.utils import chaos as jax_chaos
from rafiki_tpu_torch import config
from rafiki_tpu_torch.admin.admin import Admin
from rafiki_tpu_torch.admin.http import AdminServer
from rafiki_tpu_torch.admin.recovery import ControlPlaneRecovery
from rafiki_tpu_torch.client.client import Client
from rafiki_tpu_torch.db.database import Database
from rafiki_tpu_torch.device import set_device_grant
from rafiki_tpu_torch.placement import manager
from rafiki_tpu_torch.placement.process import (
    ProcessPlacementManager,
    _pid_is_worker,
)
from rafiki_tpu_torch.sdk.model import load_model_class
from rafiki_tpu_torch.utils import chaos
from test_torch_process import _SLOW_TINY, _dataset, _tiny_template
from test_torch_stack import FAKE_TEMPLATE, JAX_FAKE

PACKAGES = {
    "jax": types.SimpleNamespace(
        Admin=JaxAdmin, AdminServer=JaxAdminServer, Database=JaxDatabase,
        ChipAllocator=jax_manager.ChipAllocator, chaos=jax_chaos,
        config=jax_config, Recovery=JaxRecovery,
        template=JAX_FAKE.read_bytes()),
    "torch": types.SimpleNamespace(
        Admin=Admin, AdminServer=AdminServer, Database=Database,
        ChipAllocator=manager.ChipAllocator, chaos=chaos, config=config,
        Recovery=ControlPlaneRecovery, template=FAKE_TEMPLATE),
}
KNOBS = {"int_knob": 4, "float_knob": 0.01, "cat_knob": "a",
         "fixed_knob": "fixed"}
#: a wait for a state a background thread reaches in well under a
#: second here; generous for a loaded host
WAIT_S = 60.0


@pytest.fixture(autouse=True)
def _clean_chaos():
    for p in PACKAGES.values():
        p.chaos.clear()
    yield
    for p in PACKAGES.values():
        p.chaos.clear()


def wait_for(cond, timeout_s=WAIT_S):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return cond()


def wait_ready(admin, timeout_s=WAIT_S):
    assert wait_for(lambda: admin.recovery_status()["state"] != "recovering",
                    timeout_s), admin.recovery_status()
    return admin.recovery_status()


class FakeHosts:
    """What recovery reads of a host placement: each host's inventory
    (``None`` for a host that does not answer) and the adopt, fence,
    reschedule and quarantine calls, recorded. A destroyed service reports
    STOPPED through ``on_status``, as a placement's monitor does."""

    def __init__(self, allocator, inventories, fence_ok=True,
                 reschedule_ok=True):
        self.allocator = allocator
        self.inventories = inventories
        self.fence_ok = fence_ok
        self.reschedule_ok = reschedule_ok
        self.on_status = None
        self.max_restarts = 0
        self.calls = []

    def probe_inventories(self):
        return {addr: None if sids is None else {"services": [
                    {"service_id": s, "status": "RUNNING"} for s in sids]}
                for addr, sids in self.inventories.items()}

    def adopt_service(self, service_id, addr, service_type, n_chips=0,
                      extra=None, best_effort_chips=False):
        self.calls.append(("adopt", service_id, addr, service_type, n_chips,
                           best_effort_chips))
        return True

    def fence_service(self, service_id, addr, wait=False):
        self.calls.append(("fence", service_id, addr, wait))
        return self.fence_ok

    def reschedule_service(self, service_id, service_type, n_chips=0,
                           extra=None, exclude=()):
        self.calls.append(("reschedule", service_id, service_type, n_chips,
                           sorted(exclude)))
        return self.reschedule_ok

    def quarantine_on_rejoin(self, addrs, service_id):
        self.calls.append(("quarantine", sorted(addrs), service_id))

    def create_service(self, service_id, service_type, run_fn=None,
                       n_chips=0, extra=None, best_effort_chips=False):
        self.calls.append(("create", service_id, service_type, n_chips))
        raise RuntimeError("this drill places nothing")

    def destroy_service(self, service_id, wait=True):
        self.calls.append(("destroy", service_id))
        if self.on_status is not None:
            self.on_status(service_id, "STOPPED")

    def stop_all(self):
        pass


# ---------------------------------------------------------------------------
# the seeded stores
# ---------------------------------------------------------------------------


class Seed:
    """The rows one scenario seeds into a package's store, by label."""

    def __init__(self, p, db):
        self.p, self.db = p, db
        self.ids = {}
        user = db.create_user("u@x", "h", "APP_DEVELOPER")
        model = db.create_model(user["id"], "fake", "IMAGE_CLASSIFICATION",
                                p.template, "FakeModel", {}, "PUBLIC")
        self.ids.update(user=user["id"], model=model["id"])

    def train_job(self, label, app, running=False, trials=(0.3, 0.8),
                  version=1):
        tj = self.db.create_train_job(
            self.ids["user"], app, version, "IMAGE_CLASSIFICATION", "u://t",
            "u://e", {"MODEL_TRIAL_COUNT": 4})
        sub = self.db.create_sub_train_job(tj["id"], self.ids["model"])
        self.ids[label], self.ids[label + ".sub"] = tj["id"], sub["id"]
        for i, score in enumerate(trials):
            t = self.db.create_trial(sub["id"], self.ids["model"],
                                     dict(KNOBS, int_knob=4 + i))
            self.db.mark_trial_as_complete(t["id"], score, None)
            self.ids[f"{label}.t{i + 1}"] = t["id"]
        if running:
            self.db.mark_train_job_as_running(tj["id"])
        else:
            self.db.mark_train_job_as_stopped(tj["id"])
        return tj["id"]

    def service(self, label, stype, chips=(), status="RUNNING"):
        svc = self.db.create_service(stype, chips=list(chips))
        if status == "RUNNING":
            self.db.mark_service_as_running(svc["id"])
        self.ids[label] = svc["id"]
        return svc["id"]

    def train_worker(self, label, job, chips=(0,)):
        sid = self.service(label, "TRAIN", chips)
        self.db.create_train_job_worker(sid, self.ids[job + ".sub"])
        return sid

    def inference_job(self, label, job, status="RUNNING"):
        inf = self.db.create_inference_job(self.ids["user"], self.ids[job])
        if status in ("RUNNING", "STOPPED"):
            self.db.mark_inference_job_as_running(inf["id"])
        if status == "STOPPED":
            self.db.mark_inference_job_as_stopped(inf["id"])
        self.ids[label] = inf["id"]
        psid = self.service(label + ".predictor", "PREDICT")
        self.db.update_inference_job_predictor(inf["id"], psid)
        return inf["id"]

    def replica(self, label, inf, trial, chips, version=0, borrowed=0):
        sid = self.service(label, "INFERENCE", chips)
        self.db.create_inference_job_worker(sid, self.ids[inf],
                                            self.ids[trial],
                                            model_version=version)
        if borrowed:
            self.db.set_worker_borrowed_chips(sid, borrowed)
        return sid


def _serving(s, fleet=(("r1", "a.t2", [0]), ("r2", "a.t1", [1]))):
    s.train_job("a", "app")
    s.inference_job("ij", "a")
    for label, trial, chips in fleet:
        s.replica(label, "ij", trial, chips)


def sc_adopt_serving(s):
    _serving(s)
    return {"h1": ["r1"], "h2": ["r2"]}, {}


def sc_fence_orphans(s):
    _serving(s)
    s.db.mark_inference_job_as_stopped(s.ids["ij"])
    return {"h1": ["r1"], "h2": ["r2"]}, {}


def sc_failed_fence(s):
    inv, _ = sc_fence_orphans(s)
    return inv, {"fence_ok": False}


def sc_adopt_disabled(s):
    _serving(s)
    s.train_job("b", "app2", running=True)
    s.train_worker("tw", "b", chips=[2])
    return {"h1": ["r1", "tw"], "h2": ["r2"]}, {"adopt": "0"}


def sc_dead_host_train(s):
    s.train_job("b", "app2", running=True)
    s.train_worker("tw", "b", chips=[2])
    return {"h1": [], "h2": None}, {}


def sc_dead_host_no_capacity(s):
    inv, _ = sc_dead_host_train(s)
    return inv, {"reschedule_ok": False}


def sc_chip_loan(s):
    _serving(s, fleet=(("r1", "a.t2", [0]), ("r2", "a.t1", [1]),
                       ("r3", "a.t2", [2])))
    s.db.set_worker_borrowed_chips(s.ids["r3"], 1)
    return {"h1": ["r1", "r2"], "h2": ["r3"]}, {}


def sc_mid_canary(s):
    s.train_job("a", "app", trials=(0.3, 0.8, 0.9))
    s.inference_job("ij", "a")
    s.replica("r1", "ij", "a.t2", [0])
    s.replica("r2", "ij", "a.t2", [1])
    s.replica("canary", "ij", "a.t3", [2], version=1)
    s.db.create_rollout(s.ids["ij"], s.ids["a.t2"], s.ids["a.t3"], 0, 1, 2,
                        "CANARY")
    return {"h1": ["r1", "r2", "canary"]}, {}


def sc_after_rolling(s):
    s.train_job("a", "app", trials=(0.3, 0.8, 0.9))
    s.inference_job("ij", "a")
    for label in ("old1", "old2"):  # drained by the rolling replace
        s.db.mark_service_as_stopped(s.replica(label, "ij", "a.t2", [0]))
    s.replica("n1", "ij", "a.t3", [0], version=1)
    s.replica("n2", "ij", "a.t3", [1], version=1)
    s.db.create_rollout(s.ids["ij"], s.ids["a.t2"], s.ids["a.t3"], 0, 1, 2,
                        "ROLLING")
    return {"h1": ["n1", "n2"]}, {}


def sc_drift_resumed(s):
    _serving(s)
    retrain = s.train_job("retrain", "app", version=2)
    s.db.create_drift_state(s.ids["ij"], "RETRAINING")
    s.db.update_drift_state(s.ids["ij"], retrain_job_id=retrain)
    return {"h1": ["r1"], "h2": ["r2"]}, {}


def sc_drift_parked(s):
    _serving(s)
    s.db.create_drift_state(s.ids["ij"], "RETRAINING")
    return {"h1": ["r1"], "h2": ["r2"]}, {}


def sc_orphaned_linkage(s):
    s.train_job("a", "app")
    s.service("lost", "TRAIN")
    return {"h1": []}, {}


SCENARIOS = {
    "adoption_of_serving_replicas": sc_adopt_serving,
    "orphans_of_jobs_stopped_while_down_are_fenced": sc_fence_orphans,
    "a_failed_fence_leaves_the_row_non_terminal": sc_failed_fence,
    "adopt_disabled_fences_instead": sc_adopt_disabled,
    "a_dead_hosts_train_service_is_rescheduled": sc_dead_host_train,
    "no_capacity_to_reschedule_errors_the_job": sc_dead_host_no_capacity,
    "chip_loans_are_rebuilt_for_adopted_borrowed_replicas": sc_chip_loan,
    "mid_canary_rollout_rolls_back": sc_mid_canary,
    "after_rolling_rollout_resumes_as_done": sc_after_rolling,
    "a_drift_retrain_resumes_by_its_id": sc_drift_resumed,
    "a_drift_intent_with_no_retrain_parks": sc_drift_parked,
    "a_service_no_job_references_is_errored": sc_orphaned_linkage,
}


def _relabel(value, ids):
    """``value`` with every seeded id (or its 8-character prefix, as
    the reasons print them) replaced by its label."""
    if isinstance(value, str):
        for label, full in sorted(ids.items(), key=lambda kv: -len(kv[1])):
            value = value.replace(full, f"<{label}>")
            value = value.replace(full[:8], f"<{label}>")
        return value
    if isinstance(value, (list, tuple)):
        return [_relabel(v, ids) for v in value]
    if isinstance(value, dict):
        return {_relabel(k, ids): _relabel(v, ids) for k, v in value.items()}
    return value


def _boot(p, name, scenario, tmp_path, monkeypatch, before_boot=None):
    """Seed the scenario into ``p``'s store, boot its admin on the fake
    placement (``before_boot(p)`` first), and record what recovery
    did."""
    work = tmp_path / name
    (work / "logs").mkdir(parents=True)
    monkeypatch.setenv("RAFIKI_WORKDIR", str(work))
    monkeypatch.setenv("RAFIKI_LOGS_DIR", str(work / "logs"))
    db = p.Database(str(work / "meta.sqlite3"))
    seed = Seed(p, db)
    inventories, opts = SCENARIOS[scenario](seed)
    if opts.get("adopt"):
        monkeypatch.setenv("RAFIKI_RECOVER_ADOPT", opts["adopt"])
    else:
        monkeypatch.delenv("RAFIKI_RECOVER_ADOPT", raising=False)
    hosts = FakeHosts(
        p.ChipAllocator([0, 1, 2, 3]),
        {addr: None if sids is None else [seed.ids[s] for s in sids]
         for addr, sids in inventories.items()},
        fence_ok=opts.get("fence_ok", True),
        reschedule_ok=opts.get("reschedule_ok", True))
    if before_boot is not None:
        before_boot(p)
    admin = p.Admin(db=db, placement=hosts, params_dir=str(work / "params"))
    try:
        report = wait_ready(admin)
        calls = list(hosts.calls)
        ids = seed.ids
        rows = {label: (db.get_service(i) or {}).get("status")
                for label, i in ids.items() if db.get_service(i)}
        jobs = {label: (db.get_train_job(i) or db.get_inference_job(i)
                        )["status"]
                for label, i in ids.items()
                if db.get_train_job(i) or db.get_inference_job(i)}
        rollouts, drift = [], None
        if "ij" in ids:
            rollouts = [(r["phase"], "restart" in (r["reason"] or ""),
                         "recovery" in (r["reason"] or ""))
                        for r in db.get_rollouts_of_inference_job(ids["ij"])]
            st = db.get_drift_state(ids["ij"])
            if st is not None:
                drift = (st["phase"], [e["event"] for e in st["events"]],
                         st["retrain_job_id"] == ids.get("retrain"))
        loans = admin.chip_arbiter.borrowed()
        persisted = json.loads((work / "logs" / "recovery.json").read_text())
    finally:
        admin.shutdown()
    counts = {k: report[k] for k in (
        "state", "scanned", "adopted", "rescheduled", "fenced", "closed",
        "errored", "jobs_closed", "agents_probed", "agents_unreachable",
        "db_retries")}
    return _relabel({
        "counts": counts, "reasons": report["reasons"],
        "failed": report.get("failed", False), "calls": calls,
        "services": rows, "jobs": jobs, "rollouts": rollouts,
        "drift": drift, "loans": {k: list(v) for k, v in loans.items()},
        "persisted": {k: persisted[k] for k in counts}}, ids)


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_boot_reconciliation_matches_jax(scenario, tmp_path, monkeypatch):
    """The same seeded rows, the same fake placement: the same report,
    calls and statuses after each package's recovery (exact)."""
    got = {name: _boot(p, name, scenario, tmp_path, monkeypatch)
           for name, p in PACKAGES.items()}
    assert got["torch"] == got["jax"]
    ours = got["torch"]
    assert ours["counts"]["state"] == "ready" and not ours["failed"]
    assert ours["persisted"] == ours["counts"]
    expect = {
        "adoption_of_serving_replicas": ("adopted", 2),
        "orphans_of_jobs_stopped_while_down_are_fenced": ("fenced", 2),
        "a_failed_fence_leaves_the_row_non_terminal": ("fenced", 0),
        "adopt_disabled_fences_instead": ("fenced", 3),
        "a_dead_hosts_train_service_is_rescheduled": ("rescheduled", 1),
        "no_capacity_to_reschedule_errors_the_job": ("errored", 1),
        "chip_loans_are_rebuilt_for_adopted_borrowed_replicas": (
            "adopted", 3),
        "mid_canary_rollout_rolls_back": ("adopted", 3),
        "after_rolling_rollout_resumes_as_done": ("adopted", 2),
        "a_drift_retrain_resumes_by_its_id": ("adopted", 2),
        "a_drift_intent_with_no_retrain_parks": ("adopted", 2),
        "a_service_no_job_references_is_errored": ("errored", 1),
    }[scenario]
    assert ours["counts"][expect[0]] == expect[1], ours
    if scenario == "a_failed_fence_leaves_the_row_non_terminal":
        assert ours["services"]["r1"] == "RUNNING"
    if scenario == "chip_loans_are_rebuilt_for_adopted_borrowed_replicas":
        assert ours["loans"] == {"<r3>": ["<ij>", 1]}
    if scenario == "mid_canary_rollout_rolls_back":
        assert ours["rollouts"] == [["ROLLED_BACK", True, False]]
        assert ours["services"]["canary"] == "STOPPED"
    if scenario == "after_rolling_rollout_resumes_as_done":
        assert ours["rollouts"] == [["DONE", False, True]]
    if scenario == "a_drift_retrain_resumes_by_its_id":
        assert ours["drift"][0] == "RETRAINING" and ours["drift"][2]
        assert "resumed" in ours["drift"][1]
    if scenario == "a_drift_intent_with_no_retrain_parks":
        assert ours["drift"][0] == "PARKED"


def test_db_chaos_is_retried_through_the_scan(tmp_path, monkeypatch):
    """The first two statements on the service table fail: the scan
    retries with backoff and the reconcile completes, in both packages."""
    monkeypatch.setenv("RAFIKI_RECOVER_RETRY_BACKOFF_S", "0.01")
    got = {}
    for name, p in PACKAGES.items():
        got[name] = _boot(
            p, name, "a_dead_hosts_train_service_is_rescheduled", tmp_path,
            monkeypatch, before_boot=lambda p: p.chaos.install([
                p.chaos.ChaosRule(site="db", action="error",
                                  match="FROM service", times=2)]))
        p.chaos.clear()
    assert got["torch"] == got["jax"]
    assert got["torch"]["counts"]["db_retries"] >= 2
    assert got["torch"]["counts"]["rescheduled"] == 1


def test_an_aborted_reconcile_shows_in_the_report_and_on_disk(
        tmp_path, monkeypatch):
    got = {}
    for name, p in PACKAGES.items():
        monkeypatch.setenv("RAFIKI_LOGS_DIR", str(tmp_path / name))
        os.makedirs(tmp_path / name)
        db = p.Database(":memory:")
        admin = p.Admin(db=db, recover=False,
                        placement=FakeHosts(p.ChipAllocator([0]), {}),
                        params_dir=str(tmp_path / name / "params"))
        try:
            rec = p.Recovery(admin)
            rec._reconcile = lambda snap: (_ for _ in ()).throw(
                RuntimeError("store exploded mid-pass"))
            report = rec.run({"services": [], "train_jobs": [],
                              "inference_jobs": []})
            persisted = json.loads(
                (tmp_path / name / "recovery.json").read_text())
        finally:
            admin.shutdown()
        got[name] = [(r["state"], r["failed"], r["error"], r["reasons"])
                     for r in (report, persisted)]
    assert got["torch"] == got["jax"]
    assert got["torch"][0][:3] == ("ready", True,
                                   "RuntimeError: store exploded mid-pass")


def _door_script(p, name, tmp_path):
    """Routes through the door while the admin is forced recovering, then
    ready: each answer's status and, for a 503, its body's keys."""
    import urllib.request

    admin = p.Admin(db=p.Database(":memory:"), placement=FakeHosts(
        p.ChipAllocator([0]), {}), params_dir=str(tmp_path / name))
    server = p.AdminServer(admin).start()
    base = f"http://127.0.0.1:{server.port}"
    out = []

    def call(method, path, body=None, token=None):
        req = urllib.request.Request(
            base + path, method=method,
            data=json.dumps(body).encode() if body is not None else None,
            headers={"Content-Type": "application/json",
                     **({"Authorization": f"Bearer {token}"} if token
                        else {})})
        try:
            with urllib.request.urlopen(req, timeout=30) as resp:
                return resp.status, json.loads(resp.read()), resp.headers
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read()), e.headers

    try:
        creds = {"email": config.SUPERADMIN_EMAIL,
                 "password": config.SUPERADMIN_PASSWORD}
        token = call("POST", "/tokens", creds)[1]["data"]["token"]
        admin._recovery = {"state": "recovering", "started_at": time.time()}
        for method, path, body in (
                ("GET", "/train_jobs", None), ("GET", "/", None),
                ("POST", "/tokens", creds),
                ("POST", "/event/train_job_worker_stopped",
                 {"train_job_id": "none"}),
                ("POST", "/advisors", {"knob_config": "{}"}),
                ("GET", "/models", None)):
            status, payload, headers = call(method, path, body, token)
            out.append((method, path, status,
                        sorted(payload) if status == 503 else None,
                        headers.get("Retry-After"),
                        (payload.get("data") or {}).get("recovery")
                        if path == "/" else None,
                        payload.get("recovery")))
        admin._recovery = {"state": "ready"}
        out.append(call("GET", "/train_jobs", None, token)[0])
    finally:
        server.stop()
        admin.shutdown()
    return out


def test_the_door_sheds_503_while_recovering_as_jax_does(tmp_path):
    """Route by route, the recovering gate answers as JAX's: 503 with
    ``Retry-After`` and the public state on the gated routes; the root,
    login, worker events and the advisor routes pass."""
    got = {name: _door_script(p, name, tmp_path)
           for name, p in PACKAGES.items()}
    assert got["torch"] == got["jax"]
    assert got["torch"][0][2] == 503 and got["torch"][-1] == 200


def test_the_client_waits_out_a_recovering_admin(tmp_path):
    """The port's client: a gated call raises the typed
    ``AdminRecoveringError``, and ``wait_until_admin_ready`` returns once
    the state is ready."""
    from rafiki_tpu_torch.client.client import AdminRecoveringError

    admin = Admin(db=Database(":memory:"), placement=FakeHosts(
        manager.ChipAllocator([0]), {}), params_dir=str(tmp_path))
    server = AdminServer(admin).start()
    try:
        c = Client("127.0.0.1", server.port, timeout_s=30)
        c.login(config.SUPERADMIN_EMAIL, config.SUPERADMIN_PASSWORD)
        admin._recovery = {"state": "recovering"}
        with pytest.raises(AdminRecoveringError):
            c.get_train_jobs()
        admin._recovery = {"state": "ready"}
        assert c.wait_until_admin_ready(timeout_s=10) == {"state": "ready"}
        assert c.get_train_jobs() == []
    finally:
        server.stop()
        admin.shutdown()


def test_a_drift_tick_waits_while_the_admin_recovers(tmp_path):
    """Both packages' tick does nothing while recovery owns the loop's
    rows, and ticks again once ready."""
    got = {}
    for name, p in PACKAGES.items():
        admin = p.Admin(db=p.Database(":memory:"), placement=FakeHosts(
            p.ChipAllocator([0]), {}), params_dir=str(tmp_path / name))
        try:
            seen = []
            admin.services.predictors = lambda: seen.append(1) or {}
            admin._recovery = {"state": "recovering"}
            waiting = (admin.drift.tick(), len(seen))
            admin._recovery = {"state": "ready"}
            ready = (admin.drift.tick(), len(seen))
        finally:
            admin.shutdown()
        got[name] = (waiting, ready)
    assert got["torch"] == got["jax"] == (([], 0), ([], 1))


def test_the_rebuilt_advisor_proposes_what_jaxs_does(tmp_path):
    """The session a dead admin held is rebuilt from the store's scored
    and infeasible trials: the first proposals after the replay are
    JAX's, knob for knob (both GPs seed 0), and a second restore does not
    feed twice."""
    got = {}
    for name, p in PACKAGES.items():
        db = p.Database(str(tmp_path / f"{name}.sqlite3"))
        seed = Seed(p, db)
        seed.train_job("a", "app", running=True, trials=(0.3, 0.8, 0.5))
        t = db.create_trial(seed.ids["a.sub"], seed.ids["model"],
                            dict(KNOBS, int_knob=30, cat_knob="c"))
        db.mark_trial_as_errored(t["id"])
        db.record_trial_fault(t["id"], "USER", "boom")
        admin = p.Admin(db=db, recover=False, placement=FakeHosts(
            p.ChipAllocator([0]), {}), params_dir=str(tmp_path / name))
        try:
            rec = p.Recovery(admin)
            rec._restore_advisor(seed.ids["a.sub"])
            rec._restored_advisors.clear()
            rec._restore_advisor(seed.ids["a.sub"])  # no double feed
            advisor = admin.advisor_store.get(seed.ids["a.sub"])
            got[name] = (advisor.observation_count,
                         advisor.infeasible_count,
                         [admin.advisor_store.propose(seed.ids["a.sub"])
                          for _ in range(3)])
        finally:
            admin.shutdown()
    assert got["torch"] == got["jax"]
    assert got["torch"][:2] == (3, 1)


# ---------------------------------------------------------------------------
# real children
# ---------------------------------------------------------------------------


def _alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


def _startup_pids(logs):
    out = {}
    for path in Path(logs).glob("service-*.log"):
        for m in re.finditer(r"startup \(pid (\d+)\)", path.read_text()):
            out[path.stem[len("service-"):]] = int(m.group(1))
    return out


_ADMIN1 = """
import signal, sys, time
from rafiki_tpu_torch.admin.admin import Admin
from rafiki_tpu_torch.admin.http import AdminServer
from rafiki_tpu_torch.db.database import Database
from rafiki_tpu_torch.placement.manager import ChipAllocator
from rafiki_tpu_torch.placement.process import ProcessPlacementManager

admin = Admin(db=Database(sys.argv[1]), params_dir=sys.argv[2],
              placement=ProcessPlacementManager(
                  allocator=ChipAllocator(["cpu"]), orphan_survivable=True))
server = AdminServer(admin, port=int(sys.argv[3])).start()
if admin.lease is not None:
    admin.lease.addr = f"127.0.0.1:{server.port}"
print(server.port, flush=True)
# as python -m rafiki_tpu_torch.admin: SIGTERM shuts the admin down
stop = []
signal.signal(signal.SIGTERM, lambda *a: stop.append(a[0]))
while not stop:
    time.sleep(0.2)
server.stop()
admin.shutdown()
print("shut down", flush=True)
"""


_GATED = b"""
import os


class GatedTinyViT(SlowTinyViT):
    def train(self, dataset_uri):
        super().train(dataset_uri)
        deadline = time.monotonic() + 600
        while (not os.path.exists(os.environ["TRAIN_GATE"])
               and time.monotonic() < deadline):
            time.sleep(0.05)
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _proc_state(pid):
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0]
    except OSError:
        return None


def _store_writable(store, wait_s=1.0):
    """Can a write transaction start on the store within ``wait_s``?"""
    con = sqlite3.connect(store, timeout=wait_s)
    try:
        con.execute("BEGIN IMMEDIATE")
        con.execute("ROLLBACK")
        return True
    except sqlite3.OperationalError:
        return False
    finally:
        con.close()


def _stop_outside_a_write(proc, store):
    """SIGSTOP ``proc`` at a moment it holds no write lock on the store.
    A process stopped inside a write transaction keeps SQLite's write
    lock, and no admin takes the lease until it runs again (a fault the
    port keeps, ROADMAP.md C); the drill stops the leader past its TTL,
    not inside a write."""
    for _ in range(40):
        proc.send_signal(signal.SIGSTOP)
        assert wait_for(lambda: _proc_state(proc.pid) == "T", 5.0)
        if _store_writable(store):
            return
        proc.send_signal(signal.SIGCONT)
        time.sleep(0.05)
    raise AssertionError("the leader was inside a store write at every stop")


def _root_role(port):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/",
                                    timeout=5) as resp:
            return json.loads(resp.read())["data"]["ha"]["role"]
    except OSError:
        return None


def test_an_orphan_surviving_child_is_adopted_by_pid_and_finishes(
        tmp_path, monkeypatch):
    """The admin is SIGKILLed mid-trial: see ``_adoption``."""
    _adoption(tmp_path, monkeypatch, "sigkill")


def test_a_fenced_ex_leaders_shutdown_leaves_the_adopted_child(
        tmp_path, monkeypatch):
    """The admin is fenced, then SIGTERMed: see ``_adoption``."""
    _adoption(tmp_path, monkeypatch, "fenced_sigterm")


def test_a_fenced_ex_leaders_shutdown_waits_on_no_store_write(
        tmp_path, monkeypatch):
    """The admin is fenced, then SIGTERMed while the store's write lock
    is held elsewhere (the new leader and the children write in turns):
    it exits within 5 s, for it writes nothing more. Its renewal had
    retried the refused CAS every period, each a write transaction that
    waits out the store's 15 s busy timeout, and the shutdown's lease
    release then waited on that renewal and on its own write: see
    ``_adoption``."""
    _adoption(tmp_path, monkeypatch, "fenced_sigterm_busy_store")


def _adoption(tmp_path, monkeypatch, loss):
    """The admin, a process of its own, loses its train child mid-trial;
    the child (``RAFIKI_ORPHAN_SURVIVE=1``) keeps training; a second
    admin on the same store adopts the child by pid (the report reads
    adopted 1) with its grant and its advisor session, and the child
    finishes the trial with the score the same trial gives run
    in-process; the job STOPs and the grant comes back.

    ``sigkill``: the admin is SIGKILLed and the second one's door takes
    its port. ``fenced_sigterm`` (HA, a lease TTL of 1 s): the admin is
    SIGSTOPped past its TTL, the second admin takes the lease at another
    address and adopts the child, then the first is SIGCONTed (fenced)
    and SIGTERMed: its shutdown lets the adopted child go unsignalled
    (JAX's stops it, ROADMAP.md C), and the child's advisor feedback
    walks past the fenced admin to the new leader.
    ``fenced_sigterm_busy_store``: the same, with the store's write lock
    held by the test across the SIGTERM; the fenced admin exits within
    5 s all the same."""
    import rafiki_tpu_torch

    root = str(Path(rafiki_tpu_torch.__file__).resolve().parents[1])
    logs = tmp_path / "logs"
    monkeypatch.setenv("RAFIKI_WORKDIR", str(tmp_path))
    monkeypatch.setenv("RAFIKI_LOGS_DIR", str(logs))
    store = str(tmp_path / "store.sqlite3")
    params = tmp_path / "params"
    fenced = loss.startswith("fenced_sigterm")
    busy_store = loss == "fenced_sigterm_busy_store"
    source = _tiny_template().replace(b'"epochs": FixedKnob(1)',
                                      b'"epochs": FixedKnob(3)') + _SLOW_TINY
    cls = "SlowTinyViT"
    train_uri, test_uri = _dataset(tmp_path)
    env = {**os.environ, "PYTHONPATH": root}
    p1 = p2 = 0
    gate = tmp_path / "gate"
    if fenced:
        p1, p2 = _free_port(), _free_port()
        env.update(RAFIKI_ADMIN_HA="1", RAFIKI_ADMIN_LEASE_TTL_S="1",
                   RAFIKI_ADMIN_ADDRS=f"127.0.0.1:{p1},127.0.0.1:{p2}",
                   TRAIN_GATE=str(gate))
        # the trial ends only once the handover is done
        source, cls = source + _GATED, "GatedTinyViT"
    admin1 = subprocess.Popen(
        [sys.executable, "-c", _ADMIN1, store, str(params), str(p1)],
        cwd=root, env=env, stdout=subprocess.PIPE, text=True)
    admin2 = srv2 = None
    pid = None
    try:
        port = int(admin1.stdout.readline())
        c = Client("127.0.0.1", port, timeout_s=600)
        c.login(config.SUPERADMIN_EMAIL, config.SUPERADMIN_PASSWORD)
        c.create_model("tiny", "IMAGE_CLASSIFICATION", source, cls)
        c.create_train_job("vit", "IMAGE_CLASSIFICATION", train_uri,
                           test_uri, budget={"MODEL_TRIAL_COUNT": 1,
                                             "CHIP_COUNT": 1})
        db = Database(store)
        job_id = c.get_train_job("vit")["id"]
        assert wait_for(lambda: db.get_trials_of_train_job(job_id), 600)
        (trial,) = db.get_trials_of_train_job(job_id)
        assert wait_for(lambda: _startup_pids(logs), 600)
        ((sid, pid),) = _startup_pids(logs).items()
        assert db.get_service(sid)["pid"] == pid
        log = logs / f"service-{sid}.log"
        if fenced:
            _stop_outside_a_write(admin1, store)  # past its TTL
            assert wait_for(lambda: db.read_lease()["expires_at"]
                            <= time.time(), 5.0)
            monkeypatch.setenv("RAFIKI_ADMIN_HA", "1")
            monkeypatch.setenv("RAFIKI_ADMIN_LEASE_TTL_S", "1")
            port = p2
        else:
            admin1.kill()  # mid-trial: three epochs of a second each
            admin1.wait(timeout=30)
            assert wait_for(lambda: "surviving for the next admin"
                            in log.read_text(), 60), log.read_text()[-2000:]
        assert db.get_trial(trial["id"])["status"] == "RUNNING"
        admin2 = Admin(db=Database(store), params_dir=str(params),
                       placement=ProcessPlacementManager(
                           allocator=manager.ChipAllocator(["cpu"]),
                           orphan_survivable=True),
                       advertise_addr=f"127.0.0.1:{port}")
        srv2 = AdminServer(admin2, port=port).start()
        report = wait_ready(admin2)
        assert report["adopted"] == 1 and report["errored"] == 0, report
        assert admin2.placement.allocator.free_chips == 0  # grant re-held
        if fenced:
            assert admin2.ha_epoch() == 2
            admin1.send_signal(signal.SIGCONT)
            assert wait_for(lambda: _root_role(p1) == "fenced", 5.0)
            if busy_store:
                time.sleep(1.0)  # its renewal finds the CAS refused
                lock = sqlite3.connect(store, timeout=5.0)
                lock.execute("BEGIN IMMEDIATE")
                try:
                    t_term = time.monotonic()
                    admin1.send_signal(signal.SIGTERM)
                    try:
                        rc = admin1.wait(timeout=5.0)
                    except subprocess.TimeoutExpired:
                        rc = None
                    waited = time.monotonic() - t_term
                finally:
                    lock.execute("ROLLBACK")
                    lock.close()
                assert rc == 0, f"fenced shutdown still running {waited:.1f} s"
            else:
                admin1.send_signal(signal.SIGTERM)
            assert admin1.wait(timeout=60) == 0
            assert "shut down" in admin1.stdout.read()
            # the fenced admin let its child go: still training, its row
            # and its trial as they were
            assert _pid_is_worker(pid, service_id=sid)
            assert db.get_service(sid)["status"] == "RUNNING"
            assert db.get_trial(trial["id"])["status"] == "RUNNING"
            gate.touch()
        assert wait_for(lambda: db.get_train_job(job_id)["status"]
                        == "STOPPED", 600)
        assert wait_for(lambda: admin2.placement.allocator.free_chips == 1)
        done = db.get_trial(trial["id"])
    finally:
        if srv2 is not None:
            srv2.stop()
        if admin2 is not None:
            admin2.shutdown()
        if admin1.poll() is None:
            admin1.send_signal(signal.SIGCONT)
            admin1.kill()
        admin1.wait(timeout=30)
        gate.touch()
        if pid is not None and _pid_is_worker(pid):
            os.kill(pid, signal.SIGKILL)
    assert done["status"] == "COMPLETED" and done["worker_id"] == sid
    # gone (or a zombie its new parent has not reaped: no cmdline left)
    assert not _pid_is_worker(pid, service_id=sid)
    text = log.read_text()
    assert "kernel launches (pid" in text
    if fenced:
        # the trial's feedback went past the fenced admin to the new one
        assert (f"answered by 127.0.0.1:{p2}, walked on from "
                f"127.0.0.1:{p1}") in text, text[-3000:]
    # the same trial in-process: the same knobs, data and seed
    model = load_model_class(source, "TinyViT")(**done["knobs"])
    set_device_grant(["cpu"])
    try:
        model.train(train_uri)
        want = model.evaluate(test_uri)
    finally:
        set_device_grant(None)
    assert done["score"] == want


def test_pid_checks_refuse_what_is_not_this_services_worker(tmp_path):
    """``_pid_is_worker``: a live child of this package's bootstrap with
    the service's id passes; another service's id, a dead pid, this
    process, and a child that runs JAX's bootstrap do not."""
    env = {**os.environ, "RAFIKI_SERVICE_ID": "svc-a"}
    script = "import time; time.sleep(60)"
    ours = subprocess.Popen([sys.executable, "-c", script,
                             "rafiki_tpu_torch.worker.bootstrap"], env=env)
    theirs = subprocess.Popen([sys.executable, "-c", script,
                               "rafiki_tpu.worker.bootstrap"], env=env)
    try:
        for child, marker in ((ours, b"rafiki_tpu_torch.worker.bootstrap"),
                              (theirs, b"rafiki_tpu.worker.bootstrap")):
            # the exec must have finished before /proc shows the cmdline
            assert wait_for(lambda: marker in open(
                f"/proc/{child.pid}/cmdline", "rb").read(), 10)
        assert _pid_is_worker(ours.pid)
        assert _pid_is_worker(ours.pid, service_id="svc-a")
        assert not _pid_is_worker(ours.pid, service_id="svc-b")
        assert not _pid_is_worker(theirs.pid)
        assert not _pid_is_worker(theirs.pid, service_id="svc-a")
        assert not _pid_is_worker(os.getpid())
        db = Database(str(tmp_path / "s.sqlite3"))
        pm = ProcessPlacementManager(db=db,
                                     allocator=manager.ChipAllocator(["cpu"]),
                                     stop_grace_s=2.0)
        assert not pm.adopt_pid("svc-a", "TRAIN", theirs.pid, chips=["cpu"])
        assert pm.adopt_pid("svc-a", "TRAIN", ours.pid, chips=["cpu"])
        assert pm.allocator.free_chips == 0
        pm.destroy_service("svc-a")  # SIGTERM, identity checked
        assert ours.wait(timeout=10) == -signal.SIGTERM
        assert pm.allocator.free_chips == 1
        assert not _pid_is_worker(ours.pid, service_id="svc-a")
        assert not pm.adopt_pid("svc-a", "TRAIN", ours.pid, chips=["cpu"])
    finally:
        for child in (ours, theirs):
            if child.poll() is None:
                child.kill()
            child.wait(timeout=10)


class _Rows:
    """A store stand-in for the watchdog: the service row's status."""

    def __init__(self):
        self.status = "RUNNING"

    def get_service(self, service_id):
        return {"id": service_id, "status": self.status}


@pytest.mark.parametrize("survivable", [False, True])
def test_the_watchdog_stops_on_reparenting_unless_survivable(
        monkeypatch, survivable):
    """``worker/bootstrap.py``'s watchdog, its beat shortened: once the
    parent is gone (``getppid`` changes), a child without the flag stops
    at the next beat, as before; a survivable train child works on and
    stops only when its row goes terminal."""
    import threading

    from rafiki_tpu_torch.worker import bootstrap

    stop, snapshot, rows = threading.Event(), threading.Event(), _Rows()
    ppid = [4242]
    monkeypatch.setattr(bootstrap.os, "getppid", lambda: ppid[0])
    t = threading.Thread(target=bootstrap._watch_parent, args=(
        stop, snapshot, rows, "svc", survivable, 4242, 0.02), daemon=True)
    t.start()
    try:
        time.sleep(0.1)
        assert not stop.is_set()  # the parent lives
        ppid[0] = 1  # reparented
        if not survivable:
            assert stop.wait(10)
            return
        time.sleep(0.2)
        assert not stop.is_set()  # works on for the next admin
        rows.status = "STOPPED"  # a fence, or its own end
        assert stop.wait(10)
    finally:
        stop.set()
        t.join(10)


@pytest.mark.parametrize("survivable", [False, True])
def test_a_child_lost_with_its_parent_ends_errored(monkeypatch, survivable):
    """A difference from the original (ROADMAP.md, C): a child that stops
    because its parent (an admin, or a host agent) died marks its row
    ERRORED, a replica lost with its host, where the original's writes
    STOPPED; a clean end is still STOPPED, and a survivable train child,
    which stops only when its row is already terminal, is never marked
    lost."""
    import threading

    from rafiki_tpu_torch.worker import bootstrap

    stop, snapshot, rows, lost = (threading.Event(), threading.Event(),
                                  _Rows(), threading.Event())
    ppid = [4242]
    monkeypatch.setattr(bootstrap.os, "getppid", lambda: ppid[0])
    t = threading.Thread(target=bootstrap._watch_parent, args=(
        stop, snapshot, rows, "svc", survivable, 4242, 0.02, lost),
        daemon=True)
    t.start()
    try:
        ppid[0] = 1
        if survivable:
            time.sleep(0.2)
            rows.status = "STOPPED"
        assert stop.wait(10)
    finally:
        stop.set()
        t.join(10)
    assert lost.is_set() is (not survivable)

    class Marks:
        def __init__(self):
            self.marks = []

        def mark_service_as_errored(self, sid):
            self.marks.append(("ERRORED", sid))

        def mark_service_as_stopped(self, sid):
            self.marks.append(("STOPPED", sid))

    db = Marks()
    codes = [bootstrap._final_status(db, "svc", lost.is_set()),
             bootstrap._final_status(db, "svc", False)]
    assert db.marks == [("STOPPED" if survivable else "ERRORED", "svc"),
                        ("STOPPED", "svc")]
    assert codes == [0 if survivable else 1, 0]


def test_a_two_rank_trial_is_placed_again_with_its_follower(tmp_path,
                                                           monkeypatch):
    """A train service left RUNNING on a grant of two gloo ranks, with no
    executor behind it: recovery places it again under its id through
    ``restart_train_worker``, the executor starts its follower again, and
    the trial trains over both ranks (the probe scores the ranks it
    trained over: 2.0)."""
    from test_torch_parallel import PROBE

    monkeypatch.setenv("RAFIKI_DIST_TIMEOUT_S", "120")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    db = Database(":memory:")
    user = db.create_user("u@x", "h", "APP_DEVELOPER")
    model = db.create_model(user["id"], "probe", "IMAGE_CLASSIFICATION",
                            PROBE, "MeshProbe", {}, "PUBLIC")
    tj = db.create_train_job(user["id"], "mesh", 1, "IMAGE_CLASSIFICATION",
                             "u://t", "u://e", {"MODEL_TRIAL_COUNT": 1})
    db.mark_train_job_as_running(tj["id"])
    sub = db.create_sub_train_job(tj["id"], model["id"])
    svc = db.create_service("TRAIN", chips=["cpu:0", "cpu:1"])
    db.mark_service_as_running(svc["id"])
    db.create_train_job_worker(svc["id"], sub["id"])
    admin = Admin(db=db, params_dir=str(tmp_path),
                  placement=manager.LocalPlacementManager(
                      manager.ChipAllocator(["cpu:0", "cpu:1"])))
    try:
        report = wait_ready(admin)
        assert report["rescheduled"] == 1, report
        assert db.get_service(svc["id"])["chips"] == ["cpu:0", "cpu:1"]
        assert wait_for(lambda: db.get_train_job(tj["id"])["status"]
                        == "STOPPED", 240)
        trials = db.get_trials_of_train_job(tj["id"])
    finally:
        admin.shutdown()
    assert [(t["status"], t["score"], t["worker_id"]) for t in trials] == [
        ("COMPLETED", 2.0, svc["id"])]


# ---------------------------------------------------------------------------
# the restart drills over real host agents: the twins of
# tests/test_restart_recovery.py:160-1115 that need agents. Each drill runs
# through both packages: real AgentServers over thread engines
# (test_torch_hosts.ThreadEngine), so the agents live on when an admin is
# dropped; the reports, rows and answers are compared
# ---------------------------------------------------------------------------

from test_torch_hosts import KEY  # noqa: E402
from test_torch_hosts import PACKAGES as HOSTS  # noqa: E402
from test_torch_hosts import host_placement, seed_app, spawn_host  # noqa: E402
from test_torch_hosts import superadmin  # noqa: E402

_tokens = {"jax": __import__("rafiki_tpu.utils.auth",
                             fromlist=["x"]).generate_token,
           "torch": __import__("rafiki_tpu_torch.utils.auth",
                               fromlist=["x"]).generate_token}
_COUNTS = ("adopted", "rescheduled", "fenced", "errored", "closed",
           "agents_probed", "agents_unreachable")


def crash(admin):
    """An admin process's death: nothing stopped or drained, its pollers
    silenced and its per-job doors closed as a dead process's sockets."""
    admin.placement._closed.set()
    servers = getattr(admin.services, "_predict_servers", None)
    if servers is None:
        servers = admin.services._servers
    for psrv in list(servers.values()):
        psrv.stop(drain_timeout_s=0.0)


class Drill:
    """One package's drill: its store, agents and admins under a
    workdir of its own."""

    def __init__(self, p, tmp_path, monkeypatch, hosts=((0, 1),)):
        self.p = p
        self.work = tmp_path / p.name
        (self.work / "logs").mkdir(parents=True)
        monkeypatch.setenv("RAFIKI_WORKDIR", str(self.work))
        monkeypatch.setenv("RAFIKI_LOGS_DIR", str(self.work / "logs"))
        self.db = p.Database(str(self.work / "meta.sqlite3"))
        self.hosts = [spawn_host(p, self.db, ids) for ids in hosts]
        self.addrs = [h[2] for h in self.hosts]
        self.admins = []

    def admin(self, **kw):
        admin = self.p.Admin(
            db=kw.pop("db", self.db),
            placement=host_placement(self.p, self.addrs, self.db),
            params_dir=str(self.work / "params"), **kw)
        self.admins.append(admin)
        return admin

    def close(self):
        if self.admins:
            self.admins[-1].shutdown()
        for _, srv, _ in self.hosts:
            srv.stop()

    def live_ids(self):
        return {e["service_id"] for h in self.hosts
                for e in h[0].list_services()}


def run_drill(drill_fn, tmp_path, monkeypatch, hosts=((0, 1),)):
    got = {}
    for name, p in HOSTS.items():
        p.chaos.clear()
        p.http.reset_breaker()
        d = Drill(p, tmp_path, monkeypatch, hosts)
        try:
            got[name] = drill_fn(d)
        finally:
            p.chaos.clear()
            d.close()
    return got


def _serving_job(d, app, trials=2):
    admin = d.admin()
    uid = superadmin(d.p, admin)
    assert seed_app(d.p, admin, uid, app, trials=trials)["status"] == \
        "STOPPED"
    admin.create_inference_job(uid, app)
    inf = d.db.get_inference_jobs_by_statuses(["RUNNING"])[0]
    sids = sorted(w["service_id"]
                  for w in d.db.get_workers_of_inference_job(inf["id"]))
    return admin, uid, inf["id"], sids


def test_a_restart_adopts_the_agents_replicas_without_redeploy(
        tmp_path, monkeypatch):
    def drill(d):
        admin1, uid, inf, sids = _serving_job(d, "restartserve")
        assert len(admin1.predict(uid, "restartserve", [[1.0]])) == 1
        inv = d.p.http.call_agent(d.addrs[0], "GET", "/inventory", key=KEY,
                                  timeout_s=5)
        listed = {e["service_id"] for e in inv["services"]}
        crash(admin1)
        admin2 = d.admin()
        report = wait_ready(admin2)
        backed = set(admin2.placement.placements())
        inf_row = d.db.get_inference_job(inf)
        unbacked = [s["id"] for s in d.db.get_services(
            statuses=["STARTED", "DEPLOYING", "RUNNING"])
            if s["id"] not in backed
            and s["id"] != inf_row.get("predictor_service_id")]
        persisted = json.loads((d.work / "logs" / "recovery.json")
                               .read_text())
        out = {
            "counts": {k: report[k] for k in _COUNTS},
            "adopted_all": report["adopted"] == len(sids),
            "listed": listed <= {s["id"] for s in d.db.get_services()},
            "job": inf_row["status"],
            "same_fleet": sorted(
                w["service_id"] for w in d.db.get_workers_of_inference_job(
                    inf)) == sids,
            "predictions": admin2.predict(uid, "restartserve",
                                          [[1.0], [2.0]]),
            "unbacked": unbacked,
            "persisted": persisted["adopted"] == report["adopted"],
        }
        admin2.stop_all_jobs()
        return out

    got = run_drill(drill, tmp_path, monkeypatch, hosts=((0, 1), (2, 3)))
    assert got["torch"] == got["jax"]
    ours = got["torch"]
    assert ours["counts"]["adopted"] == 4 and ours["counts"]["errored"] == 0
    assert ours["adopted_all"] and ours["same_fleet"] and ours["persisted"]
    assert ours["predictions"] == [[0.5, 0.5], [0.5, 0.5]]
    assert ours["unbacked"] == []


def test_a_restart_rebinds_the_jobs_own_door(tmp_path, monkeypatch):
    """``RAFIKI_PREDICTOR_PORTS=1``: the adopted job's door is bound again
    in the new admin, its address republished, and it answers. (On one
    two-card agent the port deploys one replica a trial, JAX two: the
    replica count is clamped to the inventory, ROADMAP.md C.)"""
    monkeypatch.setenv("RAFIKI_PREDICTOR_PORTS", "1")

    def drill(d):
        admin1, uid, inf, sids = _serving_job(d, "portapp")
        assert admin1.get_inference_job(uid, "portapp")["predictor_port"]
        crash(admin1)
        admin2 = d.admin()
        report = wait_ready(admin2)
        job2 = admin2.get_inference_job(uid, "portapp")
        token = _tokens[d.p.name]({"user_id": uid,
                                   "user_type": "SUPERADMIN"})
        req = urllib.request.Request(
            f"http://{job2['predictor_host']}:{job2['predictor_port']}"
            "/predict", data=json.dumps({"queries": [[3.0]]}).encode(),
            headers={"Content-Type": "application/json",
                     "Authorization": f"Bearer {token}"})
        with urllib.request.urlopen(req, timeout=30) as resp:
            answer = (resp.status,
                      json.loads(resp.read())["data"]["predictions"])
        return {"adopted_all": report["adopted"] == len(sids),
                "errored": report["errored"], "answer": answer,
                "republished": bool(job2["predictor_port"])}

    got = run_drill(drill, tmp_path, monkeypatch)
    assert got["torch"] == got["jax"] == {
        "adopted_all": True, "errored": 0,
        "answer": (200, [[0.5, 0.5]]), "republished": True}


def test_a_restart_reschedules_a_dead_hosts_train_service(tmp_path,
                                                          monkeypatch):
    """A train service whose host died while no admin ran is placed again
    under its id on the survivor; its new worker resumes the stale trial,
    and the job ends with exactly its budget of trials."""
    def drill(d):
        db, p = d.db, d.p
        user = db.create_user("u@x", "h", "APP_DEVELOPER")
        model = db.create_model(user["id"], "fake", "IMAGE_CLASSIFICATION",
                                p.template, "FakeModel", {"numpy": None},
                                "PUBLIC")
        tj = db.create_train_job(user["id"], "app", 1,
                                 "IMAGE_CLASSIFICATION", "uri://t",
                                 "uri://e", {"MODEL_TRIAL_COUNT": 2})
        db.mark_train_job_as_running(tj["id"])
        sub = db.create_sub_train_job(tj["id"], model["id"])
        svc = db.create_service("TRAIN", chips=p.chips([0]))
        db.mark_service_as_running(svc["id"])
        db.create_train_job_worker(svc["id"], sub["id"])
        stale = db.create_trial(sub["id"], model["id"], dict(KNOBS),
                                worker_id=svc["id"])
        admin = d.admin()
        report = wait_ready(admin)
        placed = admin.placement.placements().get(svc["id"]) == d.addrs[0]
        assert wait_for(lambda: db.get_train_job(tj["id"])["status"]
                        == "STOPPED")
        resumed = db.get_trial(stale["id"])
        return {"counts": {k: report[k] for k in _COUNTS},
                "placed_on_survivor": placed,
                "resumed": (resumed["status"],
                            resumed["score"] is not None),
                "trials": len(db.get_trials_of_sub_train_job(sub["id"]))}

    got = run_drill(drill, tmp_path, monkeypatch)
    assert got["torch"] == got["jax"]
    assert got["torch"]["counts"]["rescheduled"] == 1
    assert got["torch"]["resumed"] == ("COMPLETED", True)
    assert got["torch"]["trials"] == 2


@pytest.mark.parametrize("case", ["stopped_job", "fence_fails",
                                  "adopt_disabled"])
def test_a_restart_fences_what_it_must_not_adopt(case, tmp_path,
                                                 monkeypatch):
    """The replicas of a job stopped while no admin ran are fenced on
    their agent and their rows closed; a fence that cannot reach the agent
    (every stop dropped) leaves the rows RUNNING and the executors
    untouched; under ``RAFIKI_RECOVER_ADOPT=0`` survivors are fenced and
    the job ends."""
    if case == "adopt_disabled":
        monkeypatch.setenv("RAFIKI_RECOVER_ADOPT", "0")

    def drill(d):
        admin1, uid, inf, sids = _serving_job(d, "fenceapp")
        assert d.live_ids() >= set(sids)
        crash(admin1)
        if case != "adopt_disabled":
            d.db.mark_inference_job_as_stopped(inf)
        if case == "fence_fails":
            d.p.chaos.install([d.p.chaos.ChaosRule(
                site="call_agent", action="drop", match="/stop")])
        admin2 = d.admin()
        report = wait_ready(admin2)
        d.p.chaos.clear()
        if case != "fence_fails":
            assert wait_for(lambda: not d.live_ids())
            assert wait_for(lambda: d.db.get_inference_job(inf)["status"]
                            in ("STOPPED", "ERRORED"))
        return {"fenced_all": report["fenced"] == len(sids),
                "adopted": report["adopted"],
                "reasons": sorted({
                    tag for r in report["reasons"] for tag in (
                        "could not fence", "RAFIKI_RECOVER_ADOPT=0")
                    if tag in r}),
                "rows": sorted({d.db.get_service(s)["status"]
                                for s in sids}),
                "executors_left": bool(d.live_ids()),
                "placements": admin2.placement.placements()}

    got = run_drill(drill, tmp_path, monkeypatch)
    assert got["torch"] == got["jax"]
    ours = got["torch"]
    if case == "stopped_job":
        assert ours["fenced_all"] and ours["rows"] == ["STOPPED"]
    elif case == "fence_fails":
        assert not ours["fenced_all"] and ours["rows"] == ["RUNNING"]
        assert ours["reasons"] == ["could not fence"]
        assert ours["executors_left"]
    else:
        assert ours["adopted"] == 0 and ours["fenced_all"]
        assert ours["reasons"] == ["RAFIKI_RECOVER_ADOPT=0"]


def _rollout_target(db, inf_id):
    inf = db.get_inference_job(inf_id)
    serving = {w["trial_id"]
               for w in db.get_workers_of_inference_job(inf_id)}
    return next(t["id"] for t in db.get_best_trials_of_train_job(
        inf["train_job_id"], max_count=10) if t["id"] not in serving)


@pytest.mark.parametrize("phase", ["CANARY", "ROLLING"])
def test_a_restart_mid_rollout_resolves_it(phase, tmp_path, monkeypatch):
    """The admin dies in the canary (the successor adopts both versions,
    then rolls back: the canary drained, the incumbents serving), or
    after the rolling replace finished but before DONE was written (the
    successor marks it DONE)."""
    def drill(d):
        admin1, uid, inf, _ = _serving_job(d, "midroll", trials=3)
        target = _rollout_target(d.db, inf)
        old = admin1.services.live_inference_workers(inf)
        n = len(old)
        if phase == "CANARY":
            canary = admin1.services.deploy_version_replica(inf, target, 1)
        else:
            for _ in range(n):
                sid = admin1.services.deploy_version_replica(inf, target, 1)
                admin1.services.get_predictor(inf).add_worker(sid, target)
            admin1.services.drain_replicas(
                inf, [w["service_id"] for w in old])
        d.db.create_rollout(inf, old[0]["trial_id"], target, 0, 1, n, phase)
        crash(admin1)
        admin2 = d.admin()
        report = wait_ready(admin2)
        ro = d.db.get_rollouts_of_inference_job(inf)[0]
        out = {"phase": ro["phase"],
               "reason": ("restart" in ro["reason"],
                          "recovery" in ro["reason"]),
               "adopted": report["adopted"] - n}
        if phase == "CANARY":
            assert wait_for(lambda: d.db.get_service(canary)["status"]
                            in ("STOPPED", "ERRORED"))
        live = admin2.services.live_inference_workers(inf)
        out.update(
            live=(len(live) == n,
                  sorted({w["model_version"] for w in live}),
                  all(w["trial_id"] == target for w in live)),
            job=d.db.get_inference_job(inf)["status"],
            predictions=admin2.predict(uid, "midroll", [[1.0]]),
            lane=admin2.services.get_predictor(inf)._lane_snapshot())
        return out

    got = run_drill(drill, tmp_path, monkeypatch)
    assert got["torch"] == got["jax"]
    ours = got["torch"]
    if phase == "CANARY":
        assert ours["phase"] == "ROLLED_BACK" and ours["reason"][0]
        assert ours["adopted"] == 1 and ours["live"] == (True, [0], False)
        assert ours["lane"] == (None, 0)
    else:
        assert ours["phase"] == "DONE" and ours["reason"][1]
        assert ours["live"] == (True, [1], True)


def test_a_restart_rebuilds_the_chip_loans_of_adopted_replicas(
        tmp_path, monkeypatch):
    """A replica that borrowed a card above the training floor is adopted
    with its loan: the successor's loan book has it, and a training
    reclaim drains exactly that replica."""
    monkeypatch.setenv("RAFIKI_AUTOSCALE_TRAIN_FLOOR", "1")

    def drill(d):
        admin1, uid, job, _ = _serving_job(d, "loans")
        report = admin1.services.scale_inference_job(job, 1)
        sid = report["added"][0]
        row = next(w for w in d.db.get_workers_of_inference_job(job)
                   if w["service_id"] == sid)
        before = (report["borrowed_chips"], row["borrowed_chips"],
                  admin1.chip_arbiter.borrowed()[sid] == (job, 1))
        crash(admin1)
        admin2 = d.admin()
        report2 = wait_ready(admin2)
        after = (report2["errored"],
                 admin2.chip_arbiter.borrowed().get(sid) == (job, 1),
                 admin2.chip_arbiter.borrowed_chips())
        freed = admin2.chip_arbiter.reclaim_for_training(1)
        assert wait_for(lambda: next(
            (w for w in d.db.get_workers_of_inference_job(job)
             if w["service_id"] == sid), {}).get("borrowed_chips") == 0)
        live = {w["service_id"]
                for w in admin2.services.live_inference_workers(job)}
        out = (before, after, freed, admin2.chip_arbiter.borrowed_chips(),
               sid in live, admin2.predict(uid, "loans", [[1.0]]))
        admin2.stop_all_jobs()
        return out

    got = run_drill(drill, tmp_path, monkeypatch,
                    hosts=((0, 1, 2), (3, 4, 5)))
    assert got["torch"] == got["jax"] == (
        (1, 1, True), (0, True, 1), 1, 0, False, [[0.5, 0.5]])


def _drift_env(monkeypatch, extra=None):
    env = {"RAFIKI_DRIFT": "1", "RAFIKI_DRIFT_INTERVAL_S": "3600",
           "RAFIKI_DRIFT_WINDOW_S": "2.0",
           "RAFIKI_DRIFT_BASELINE_WINDOW_S": "2.0",
           "RAFIKI_DRIFT_MIN_SAMPLES": "8", "RAFIKI_DRIFT_THRESHOLD": "0.5",
           "RAFIKI_DRIFT_RETRAIN_BUDGET": "2",
           "RAFIKI_DRIFT_COOLDOWN_S": "60",
           "RAFIKI_ROLLOUT_JUDGE_WINDOW_S": "1.0",
           "RAFIKI_ROLLOUT_MIN_REQUESTS": "3", "DRIFT_FIXTURE_SCORE": "0.5"}
    env.update(extra or {})
    for k, v in env.items():
        monkeypatch.setenv(k, v)


def _drift_template(p):
    from test_torch_drift import DRIFT_TEMPLATE, JAX_DRIFT

    return JAX_DRIFT.read_bytes() if p.name == "jax" else DRIFT_TEMPLATE


def _drift_to_retraining(d, admin, uid, app, monkeypatch):
    """Seed a served app, freeze a baseline, shift the traffic and tick
    to the drift verdict (RETRAINING)."""
    admin.create_model(uid, "driftm", "IMAGE_CLASSIFICATION",
                       _drift_template(d.p), "DriftModel")
    admin.create_train_job(uid, app, "IMAGE_CLASSIFICATION", "uri://t",
                           "uri://e", budget={"MODEL_TRIAL_COUNT": 2,
                                              "CHIP_COUNT": 0})
    job = admin.wait_until_train_job_stopped(uid, app, timeout_s=60)
    admin.create_inference_job(uid, app)
    job_id = d.db.get_running_inference_job_of_train_job(job["id"])["id"]
    deadline = time.monotonic() + 30
    st = None
    while time.monotonic() < deadline:
        for _ in range(4):
            admin.predict(uid, app, [[0.0]])
        admin.drift.tick()
        st = admin.drift.status(job_id)
        if st and st.get("baseline"):
            break
        time.sleep(0.05)
    assert st and st.get("baseline"), st
    monkeypatch.setenv("DRIFT_FIXTURE_SCORE", "0.9")
    time.sleep(2.2)  # the old mix ages out of the window
    for i in range(1, 13):
        admin.predict(uid, app, [[float(i) + 0.5]])
    admin.drift.tick()
    st = admin.drift.status(job_id)
    assert st["phase"] == "RETRAINING", st
    return job_id, st


@pytest.mark.parametrize("case", ["resumed", "parked"])
def test_a_restart_mid_drift_loop_never_launches_twice(
        case, tmp_path, monkeypatch):
    """The admin dies after the drift verdict: with the retrain launched
    and its id written, the successor resumes that retrain and carries
    its candidate through the rollout to DONE, with no second launch;
    with only the write-ahead intent (the launch failed), it parks the
    loop, and an operator's ack re-arms it."""
    # the judge's p95 rule is not this drill's subject: on a loaded host
    # a canary's tail can breach it and roll the candidate back
    _drift_env(monkeypatch, {"RAFIKI_DRIFT_LAUNCH_RETRY_MAX": "5"}
               if case == "parked" else {"RAFIKI_ROLLOUT_P95_FACTOR": "1000"})

    def drill(d):
        monkeypatch.setenv("DRIFT_FIXTURE_SCORE", "0.5")
        admin1 = d.admin()
        uid = superadmin(d.p, admin1)
        if case == "parked":
            d.p.chaos.install([d.p.chaos.ChaosRule(
                site="drift", action="error", match="launch/")])
        job_id, st = _drift_to_retraining(d, admin1, uid, "drillapp",
                                          monkeypatch)
        rid = st["retrain_job_id"]
        if case == "resumed":
            assert admin1.wait_until_train_job_stopped(
                uid, "drillapp", timeout_s=60)["id"] == rid
        crash(admin1)
        d.p.chaos.clear()
        admin2 = d.admin()
        wait_ready(admin2)
        st2 = admin2.drift.status(job_id)
        out = {"intent": rid is None, "phase": st2["phase"],
               "same_retrain": st2["retrain_job_id"] == rid,
               "events": [e for e in ("resumed",)
                          if e in [x["event"] for x in st2["events"]]]}
        if case == "parked":
            for _ in range(3):
                admin2.drift.tick()
            out["sticky"] = admin2.drift.status(job_id)["phase"]
            acked = admin2.ack_drift(uid, "drillapp")
            out["acked"] = (acked["phase"], acked["operator_ack"])
        else:
            deadline = time.monotonic() + 60
            n, errors = 100, []
            while time.monotonic() < deadline:
                try:
                    admin2.predict(uid, "drillapp", [[float(n)]])
                except Exception as e:  # any error fails the drill
                    errors.append(repr(e))
                n += 1
                admin2.drift.tick()
                if admin2.drift.status(job_id)["phase"] == "WATCHING":
                    break
                time.sleep(0.02)
            out["after"] = (admin2.drift.status(job_id)["phase"],
                            admin2.rollouts.status(job_id)["phase"], errors)
        out["train_jobs"] = len(d.db.get_train_jobs_of_app(uid, "drillapp"))
        admin2.stop_all_jobs()
        return out

    got = run_drill(drill, tmp_path, monkeypatch)
    assert got["torch"] == got["jax"]
    ours = got["torch"]
    if case == "resumed":
        assert not ours["intent"] and ours["phase"] == "RETRAINING"
        assert ours["events"] == ["resumed"]
        assert ours["after"] == ("WATCHING", "DONE", [])
        assert ours["train_jobs"] == 2
    else:
        assert ours["intent"] and ours["phase"] == "PARKED"
        assert ours["sticky"] == "PARKED"
        assert ours["acked"] == ("WATCHING", True)
        assert ours["train_jobs"] == 1
