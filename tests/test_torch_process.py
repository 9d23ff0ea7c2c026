"""Process placement of the port (``RAFIKI_PLACEMENT=process``) on the CPU.

- A tiny ViT-B/16 (the ``TorchViT`` template at test width) through the
  port's ``Client``, every worker a child process
  (``python -m rafiki_tpu_torch.worker.bootstrap``) on a ``["cpu"]``
  grant: the train child reaches the GP advisor through the admin's REST
  door and writes its 2 trials to the shared SQLite file; two serving
  children answer over the shm rings. The answers equal those of the same
  trials served by thread placement from the same store within 1e-6 (the
  same forward on the same inputs; only the BLAS threads' summation
  order may differ), and the children's relayed serving counters reach
  the job's stats.
- The monitor: a child that crashes is started again, then marked
  ERRORED; ``stop_all`` kills a child that ignores SIGTERM.
- The grant: ``_child_env`` maps the parent's grant through its own
  ``CUDA_VISIBLE_DEVICES``.
- ``RemoteAdvisorStore`` over the port's door proposes what the
  in-process ``AdvisorStore`` proposes, at the same seed and feedback.

Every child is reaped by the fixtures, and every wait has a time limit.
"""

import json
import os
import re
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

import rafiki_tpu_torch
from rafiki_tpu_torch import config
from rafiki_tpu_torch.admin.admin import Admin
from rafiki_tpu_torch.admin.http import AdminServer
from rafiki_tpu_torch.advisor.advisor import AdvisorStore
from rafiki_tpu_torch.advisor.remote import RemoteAdvisorStore
from rafiki_tpu_torch.cache.shm_broker import ShmBroker
from rafiki_tpu_torch.client.client import Client
from rafiki_tpu_torch.constants import ServiceType
from rafiki_tpu_torch.db.database import Database
from rafiki_tpu_torch.device import ServiceContext
from rafiki_tpu_torch.placement import process
from rafiki_tpu_torch.placement.manager import (
    ChipAllocator,
    LocalPlacementManager,
)
from rafiki_tpu_torch.placement.process import ProcessPlacementManager
from rafiki_tpu_torch.sdk.dataset import write_numpy_dataset
from rafiki_tpu_torch.sdk.knob import (
    CategoricalKnob,
    FixedKnob,
    FloatKnob,
    IntegerKnob,
)

ROOT = Path(rafiki_tpu_torch.__file__).resolve().parents[1]
#: the same forward on the same inputs in two processes
PROB_ATOL = 1e-6
#: the cycle test's wall-clock budgets (every wait, the deploy, each
#: request's deadline). The cycle took 21.7 s alone and 59.5 to 67.3 s
#: under the whole suite's load (xdist, 6 workers) or beside six busy
#: processes: ~10x that, so load cannot turn a wait into a failure, where
#: the port's defaults (deploy 60 s, a request 30 s) could be crossed by
#: two children importing torch on a loaded host.
BUDGET_S = 600

#: the TorchViT template at test width (vit.tiny())
_TINY_EDITS = [
    ("class TorchViT(BaseModel):", "class TinyViT(BaseModel):"),
    ('"image_size": FixedKnob(224)', '"image_size": FixedKnob(32)'),
    ('"patch_size": FixedKnob(16)', '"patch_size": FixedKnob(4)'),
    ('"dim": FixedKnob(768)', '"dim": FixedKnob(64)'),
    ('"depth": FixedKnob(12)', '"depth": FixedKnob(2)'),
    ('"heads": FixedKnob(12)', '"heads": FixedKnob(4)'),
    ('"num_classes": FixedKnob(1000)', '"num_classes": FixedKnob(10)'),
    ('"batch_size": CategoricalKnob([64, 128])',
     '"batch_size": CategoricalKnob([8, 16])'),
]


def _tiny_template():
    source = (ROOT / "rafiki_tpu_torch" / "templates"
              / "torch_vit.py").read_text()
    for old, new in _TINY_EDITS:
        assert source.count(old) == 1, old
        source = source.replace(old, new)
    return source.encode()


def _dataset(tmp_path):
    rng = np.random.default_rng(0)
    patterns = rng.standard_normal((10, 32, 32, 3)).astype(np.float32)

    def split(n, name):
        y = rng.integers(0, 10, n)
        x = patterns[y] + 0.5 * rng.standard_normal(
            (n, 32, 32, 3)).astype(np.float32)
        return write_numpy_dataset(x, y.astype(np.int32),
                                   str(tmp_path / f"{name}.npz"))

    return split(48, "train"), split(16, "test")


def _log_records(logs_dir, kind):
    """{pid: JSON} of every child's ``kind`` log line."""
    out = {}
    for path in Path(logs_dir).glob("service-*.log"):
        for m in re.finditer(kind + r" \(pid (\d+)\): (\{.*\})",
                             path.read_text()):
            out[int(m.group(1))] = json.loads(m.group(2))
    return out


def _alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


@pytest.fixture()
def workdir(tmp_path, monkeypatch):
    monkeypatch.setenv("RAFIKI_WORKDIR", str(tmp_path))
    monkeypatch.setenv("RAFIKI_LOGS_DIR", str(tmp_path / "logs"))
    monkeypatch.delenv("RAFIKI_SHM_RING_BYTES", raising=False)
    return tmp_path


def test_tiny_vit_cycle_with_every_worker_a_process(workdir, monkeypatch):
    monkeypatch.setenv("RAFIKI_PLACEMENT", "process")
    # read at each use, by this process and by the children (they inherit
    # the environment)
    monkeypatch.setenv("SERVICE_DEPLOY_TIMEOUT_S", str(BUDGET_S))
    monkeypatch.setenv("PREDICT_TIMEOUT_S", str(BUDGET_S))
    store = str(workdir / "store.sqlite3")
    admin = Admin(db=Database(store), params_dir=str(workdir / "params"),
                  placement=ProcessPlacementManager(
                      allocator=ChipAllocator(["cpu"])))
    assert isinstance(admin.broker, ShmBroker)
    assert admin.placement.broker is admin.broker
    srv = AdminServer(admin).start()
    assert admin.placement.admin_addr == ("127.0.0.1", srv.port)
    try:
        c = Client("127.0.0.1", srv.port, timeout_s=BUDGET_S)
        c.login(config.SUPERADMIN_EMAIL, config.SUPERADMIN_PASSWORD)
        c.create_model("tiny", "IMAGE_CLASSIFICATION", _tiny_template(),
                       "TinyViT")
        train_uri, test_uri = _dataset(workdir)
        c.create_train_job("vit", "IMAGE_CLASSIFICATION", train_uri,
                           test_uri, budget={"MODEL_TRIAL_COUNT": 2,
                                             "CHIP_COUNT": 1})
        job = c.wait_until_train_job_stopped("vit", timeout_s=BUDGET_S)
        assert job["status"] == "STOPPED"
        (train_sid,) = [w["service_id"] for w in job["workers"]]
        assert job["workers"][0]["chips"] == ["cpu"]
        trials = c.get_trials_of_train_job("vit")
        assert [t["status"] for t in trials] == ["COMPLETED"] * 2, trials
        # the child's rows, in the shared file
        assert {admin.db.get_trial(t["id"])["worker_id"]
                for t in trials} == {train_sid}

        inf = c.create_inference_job("vit")
        assert inf["status"] == "RUNNING" and len(inf["workers"]) == 2
        assert [w["chips"] for w in inf["workers"]] == [["cpu"], ["cpu"]]
        with np.load(test_uri) as z:
            x = z["x"]
        probs = [np.asarray(c.predict("vit", x[:n].tolist()))
                 for n in (1, 8)]
        deadline = time.monotonic() + BUDGET_S
        while c.get_inference_job_stats("vit")["queries"] < 2 * 9:
            assert time.monotonic() < deadline, "serving counters not relayed"
            time.sleep(0.2)
        stats = c.get_inference_job_stats("vit")
        assert stats["queries"] == 2 * 9 and stats["batches"] == 2 * 2
        assert all(w["queries"] == 9 for w in stats["workers"])
        c.stop_inference_job("vit")
    finally:
        srv.stop()
        admin.shutdown()
    assert not list(Path("/dev/shm").glob(f"{admin.broker.prefix}-*"))
    started = _log_records(workdir / "logs", "startup")
    launches = _log_records(workdir / "logs", "kernel launches")
    assert len(started) == 3 and set(launches) == set(started)
    assert os.getpid() not in started
    assert not any(_alive(pid) for pid in started)
    # on the CPU the wrappers take their plain versions: nothing launched
    assert all(sum(v.values()) == 0 for v in launches.values())
    for s in started.values():
        assert (s["t_start"] <= s["t_main"] + 0.05 and s["t_main"]
                <= s["t_torch"] <= s["t_cuda"] <= s["t_kernels"]
                <= s["t_ready"])

    # the same trials served by thread placement, from the same store
    monkeypatch.delenv("RAFIKI_PLACEMENT")
    threads = Admin(db=Database(store), params_dir=str(workdir / "params"),
                    placement=LocalPlacementManager(ChipAllocator(["cpu"])))
    try:
        uid = threads.authenticate_user(config.SUPERADMIN_EMAIL,
                                        config.SUPERADMIN_PASSWORD)["user_id"]
        threads.create_inference_job(uid, "vit")
        ref = [np.asarray(threads.predict(uid, "vit", x[:n].tolist()))
               for n in (1, 8)]
    finally:
        threads.shutdown()
    for p, r in zip(probs, ref):
        assert p.shape == r.shape and p.shape[1] == 10
        np.testing.assert_allclose(p, r, atol=PROB_ATOL, rtol=0)


def test_wall_clock_budgets_are_read_at_each_use(monkeypatch):
    """The deploy wait and the request deadline follow the environment
    after import (the cycle test above gives itself longer ones); with
    nothing set they are the JAX package's defaults."""
    for name in ("SERVICE_DEPLOY_TIMEOUT_S", "PREDICT_TIMEOUT_S"):
        monkeypatch.delenv(name, raising=False)
    assert (config.SERVICE_DEPLOY_TIMEOUT_S, config.PREDICT_TIMEOUT_S) == (
        60.0, 30.0)
    monkeypatch.setenv("SERVICE_DEPLOY_TIMEOUT_S", "600")
    monkeypatch.setenv("PREDICT_TIMEOUT_S", "450.5")
    assert (config.SERVICE_DEPLOY_TIMEOUT_S, config.PREDICT_TIMEOUT_S) == (
        600.0, 450.5)


@pytest.fixture()
def placement(workdir):
    db = Database(str(workdir / "store.sqlite3"))
    statuses = []
    mgr = ProcessPlacementManager(
        db=db, broker=ShmBroker(), allocator=ChipAllocator(["cpu"]),
        on_status=lambda sid, st: statuses.append((sid, st)),
        max_restarts=1, stop_grace_s=1.0)
    mgr.statuses = statuses
    yield mgr
    mgr.stop_all()
    mgr.broker.close()


def _wait(cond, timeout_s, what):
    deadline = time.monotonic() + timeout_s
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.05)


def test_a_crashing_child_is_restarted_then_errored(placement, workdir):
    """A serving child whose trial does not exist crashes at start (rc 1);
    it is started once more (max_restarts=1), then the service is
    ERRORED, and its device comes back."""
    svc = placement.db.create_service(ServiceType.INFERENCE)
    placement.create_service(
        svc["id"], ServiceType.INFERENCE, None, n_chips=1,
        extra={"inference_job_id": "job", "trial_id": "no-such-trial"})
    assert placement.allocator.free_chips == 0
    _wait(lambda: placement.statuses, 90, "the crashing child never ended")
    assert placement.statuses == [(svc["id"], "ERRORED")]
    assert placement.db.get_service(svc["id"])["status"] == "ERRORED"
    log = (workdir / "logs" / f"service-{svc['id']}.log").read_text()
    assert log.count("service crashed") == 2
    assert "no trained trial no-such-trial" in log
    _wait(lambda: placement.allocator.free_chips == 1, 10,
          "the device did not come back")


_IGNORES_SIGTERM = ("import signal, sys, time; "
                    "signal.signal(signal.SIGTERM, signal.SIG_IGN); "
                    "print('ready', flush=True); time.sleep(600)")


def test_stop_all_kills_a_child_that_ignores_sigterm(placement, workdir,
                                                     monkeypatch):
    spawned = []

    def spawn(runner):
        proc = subprocess.Popen([sys.executable, "-c", _IGNORES_SIGTERM],
                                stdout=subprocess.PIPE, text=True,
                                start_new_session=True)
        spawned.append(proc)
        return proc

    monkeypatch.setattr(process._ProcRunner, "_spawn", spawn)
    svc = placement.db.create_service(ServiceType.INFERENCE)
    placement.create_service(
        svc["id"], ServiceType.INFERENCE, None,
        extra={"inference_job_id": "job", "trial_id": "t"})
    _wait(lambda: spawned, 10, "no child spawned")
    assert spawned[0].stdout.readline().strip() == "ready"
    t0 = time.monotonic()
    placement.stop_all()
    assert spawned[0].poll() == -signal.SIGKILL
    assert 1.0 <= time.monotonic() - t0 < 30
    assert not _alive(spawned[0].pid)
    assert placement.statuses == [(svc["id"], "ERRORED")]


@pytest.mark.parametrize("parent,chips,child", [
    ("3,5", [1], ("5", "0")),
    ("3,5", [0, 1], ("3,5", "0,1")),
    (None, [2], ("2", "0")),
    ("", [0], ("0", "0")),
    ("GPU-aa,GPU-bb", [1], ("GPU-bb", "0")),
    ("3,5", ["cpu"], ("", "cpu")),
])
def test_the_grant_maps_through_the_parents_visible_devices(
        placement, monkeypatch, parent, chips, child):
    if parent is None:
        monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    else:
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", parent)
    monkeypatch.setenv("RAFIKI_VISIBLE_DEVICES", "1")
    ctx = ServiceContext("svc", chips=chips,
                         service_type=ServiceType.INFERENCE,
                         extra={"inference_job_id": "j", "trial_id": "t"})
    env = placement._child_env(ctx)
    assert (env["CUDA_VISIBLE_DEVICES"], env["RAFIKI_CHIP_GRANT"]) == child
    assert "RAFIKI_VISIBLE_DEVICES" not in env
    assert env["RAFIKI_BROKER_PREFIX"] == placement.broker.prefix


def test_a_grant_outside_the_visible_devices_and_a_train_child_without_the_door_are_refused(  # noqa: E501
        placement, monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3,5")
    with pytest.raises(ValueError, match="outside"):
        placement._child_env(ServiceContext(
            "svc", chips=[2], service_type=ServiceType.INFERENCE,
            extra={"inference_job_id": "j", "trial_id": "t"}))
    with pytest.raises(RuntimeError, match="AdminServer"):
        placement.create_service("svc", ServiceType.TRAIN, None,
                                 extra={"sub_train_job_id": "s"})
    assert placement.allocator.free_chips == 1


KNOBS = {
    "lr": FloatKnob(1e-4, 1e-1, is_exp=True),
    "width": IntegerKnob(8, 64),
    "act": CategoricalKnob(["relu", "gelu"]),
    "fixed": FixedKnob(3),
}


def _score(knobs):
    return -(np.log10(knobs["lr"]) + 2.5) ** 2 - knobs["width"] / 100 + (
        0.1 if knobs["act"] == "gelu" else 0.0)


def _drive(store):
    """What a TrainWorker asks of its advisor, then a batch round."""
    aid = store.create_advisor(KNOBS, advisor_id="sub-job")
    seen = []
    for _ in range(4):
        knobs = store.propose(aid)
        store.get(aid).feedback(knobs, _score(knobs))
        seen.append(knobs)
    batch = store.propose_batch(aid, 3)
    assert store.feedback_batch(aid, [(k, _score(k)) for k in batch]) == 3
    seen += batch + [store.propose(aid)]
    store.delete_advisor(aid)
    return seen


def test_the_remote_advisor_proposes_what_the_local_one_does(tmp_path):
    admin = Admin(db=Database(":memory:"), params_dir=str(tmp_path),
                  placement=LocalPlacementManager(ChipAllocator(["cpu"])))
    srv = AdminServer(admin).start()
    try:
        client = Client("127.0.0.1", srv.port, timeout_s=60)
        client.login(config.SUPERADMIN_EMAIL, config.SUPERADMIN_PASSWORD)
        remote = _drive(RemoteAdvisorStore(client))
        with pytest.raises(KeyError):
            admin.advisor_store.get("sub-job")  # deleted through the door
    finally:
        srv.stop()
        admin.shutdown()
    local = _drive(AdvisorStore())
    assert remote == local
    assert len({json.dumps(k, sort_keys=True) for k in local}) > 4
