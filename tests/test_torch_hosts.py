"""Host placement: ``rafiki_tpu_torch/placement/hosts.py`` and
``placement/agent.py`` against ``rafiki_tpu``'s, on the CPU.

Twins of ``tests/test_fleet_serving.py``'s placement tests,
``tests/test_chaos_failover.py``'s heartbeat and failover drills and
``tests/test_hosts_placement.py``: each script runs through both
packages' ``HostAgentPlacementManager`` (fake agent handles where the
original uses them, real ``AgentServer``s over thread engines elsewhere)
and the outcomes are compared: the next agent on a refusal, an ambiguous
create undone or raised, the down threshold's bookkeeping, a train
service placed again on the survivor under its id, terminal statuses for
what cannot move, the fence on a false DOWN's rejoin, a circuit-open
agent skipped, predict past a dead host, the real heartbeat monitor, a
train job spread over two agents, the keyless agent's refusal at start
(a subprocess of each package), a job that ends without the agents'
forwarded events, and the admin booted in hosts mode from its settings.

``ThreadEngine`` (an agent's engine with its workers on threads of this
process, as ``tests/test_restart_recovery.py``'s) and the helpers below
serve ``test_torch_recovery.py`` and ``test_torch_ha.py`` too.
"""

import os
import socket
import subprocess
import sys
import time
import types

import pytest

from rafiki_tpu import config as jax_config
from rafiki_tpu.admin.admin import Admin as JaxAdmin
from rafiki_tpu.admin.http import AdminServer as JaxAdminServer
from rafiki_tpu.advisor.advisor import AdvisorStore as JaxAdvisorStore
from rafiki_tpu.cache import fleet as jax_fleet
from rafiki_tpu.cache import queue as jax_queue
from rafiki_tpu.db.database import Database as JaxDatabase
from rafiki_tpu.placement import agent as jax_agent
from rafiki_tpu.placement import hosts as jax_hosts
from rafiki_tpu.placement import manager as jax_manager
from rafiki_tpu.predictor.predictor import Predictor as JaxPredictor
from rafiki_tpu.utils import agent_http as jax_http
from rafiki_tpu.utils import chaos as jax_chaos
from rafiki_tpu.worker.inference import InferenceWorker as JaxInference
from rafiki_tpu.worker.train import TrainWorker as JaxTrain
from rafiki_tpu_torch import config
from rafiki_tpu_torch.admin.admin import Admin
from rafiki_tpu_torch.admin.http import AdminServer
from rafiki_tpu_torch.advisor.advisor import AdvisorStore
from rafiki_tpu_torch.cache import fleet
from rafiki_tpu_torch.cache import queue
from rafiki_tpu_torch.db.database import Database
from rafiki_tpu_torch.placement import agent
from rafiki_tpu_torch.placement import hosts
from rafiki_tpu_torch.placement import manager
from rafiki_tpu_torch.predictor.predictor import Predictor
from rafiki_tpu_torch.utils import agent_http
from rafiki_tpu_torch.utils import chaos
from rafiki_tpu_torch.worker.inference import InferenceWorker
from rafiki_tpu_torch.worker.train import TrainWorker
from test_torch_stack import FAKE_TEMPLATE, JAX_FAKE, ROOT

KEY = "test-fleet-key"

PACKAGES = {
    "jax": types.SimpleNamespace(
        name="jax", Admin=JaxAdmin, AdminServer=JaxAdminServer,
        Database=JaxDatabase, AdvisorStore=JaxAdvisorStore, fleet=jax_fleet,
        queue=jax_queue, agent=jax_agent, hosts=jax_hosts,
        manager=jax_manager, Predictor=JaxPredictor, http=jax_http,
        chaos=jax_chaos, config=jax_config,
        TrainWorker=JaxTrain, InferenceWorker=JaxInference,
        template=JAX_FAKE.read_bytes(), module="rafiki_tpu.placement.agent",
        chips=lambda ids: list(ids)),
    "torch": types.SimpleNamespace(
        name="torch", Admin=Admin, AdminServer=AdminServer,
        Database=Database, AdvisorStore=AdvisorStore, fleet=fleet,
        queue=queue, agent=agent, hosts=hosts, manager=manager,
        Predictor=Predictor, http=agent_http, chaos=chaos, config=config,
        TrainWorker=TrainWorker,
        InferenceWorker=InferenceWorker, template=FAKE_TEMPLATE,
        module="rafiki_tpu_torch.placement.agent",
        chips=lambda ids: [f"cpu:{i}" for i in ids]),
}


@pytest.fixture(autouse=True)
def _clean_fault_state():
    for p in PACKAGES.values():
        p.chaos.clear()
        p.http.reset_breaker()
    yield
    for p in PACKAGES.values():
        p.chaos.clear()
        p.http.reset_breaker()


def both(script):
    return {name: script(p) for name, p in PACKAGES.items()}


def wait_for(cond, timeout_s=30.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return cond()


# ---------------------------------------------------------------------------
# agents over thread engines (shared with the recovery and HA drills)
# ---------------------------------------------------------------------------


class ThreadEngine:
    """A host agent's engine with its workers on threads of this process,
    built from the declarative payloads a worker child reads, so an agent
    keeps serving when the admin object is dropped."""

    def __init__(self, p, db, chips):
        self.db = db
        self.broker = p.queue.InProcessBroker()
        self.advisors = p.AdvisorStore()
        self.p = p
        self._local = p.manager.LocalPlacementManager(
            allocator=p.manager.ChipAllocator(p.chips(chips)),
            on_status=self._on_status)
        self.allocator = self._local.allocator

    def _on_status(self, sid, status):
        # the agent's own store writes: terminal rows land with no admin
        if status == "RUNNING":
            self.db.mark_service_as_running(sid)
        elif status == "STOPPED":
            self.db.mark_service_as_stopped(sid)
        elif status == "ERRORED":
            self.db.mark_service_as_errored(sid)

    @property
    def _runners(self):
        return self._local._runners

    def list_services(self):
        return self._local.list_services()

    def create_service(self, service_id, service_type, n_chips=0,
                       best_effort_chips=False, extra=None):
        extra = dict(extra or {})
        if service_type == "TRAIN":
            worker = self.p.TrainWorker(extra["sub_train_job_id"], self.db,
                                        self.advisors)
        else:
            worker = self.p.InferenceWorker(
                extra["inference_job_id"], extra["trial_id"], self.db,
                self.broker, trial_ids=extra.get("trial_ids"))
        return self._local.create_service(
            service_id, service_type, worker.start, n_chips=n_chips,
            extra=extra, best_effort_chips=best_effort_chips)

    def destroy_service(self, service_id, wait=True):
        self._local.destroy_service(service_id, wait=wait)

    def stop_all(self):
        self._local.stop_all()


def spawn_host(p, db, chips, key=KEY):
    engine = ThreadEngine(p, db, chips)
    server = p.agent.AgentServer(engine, key=key).start()
    return engine, server, f"127.0.0.1:{server.port}"


def host_placement(p, agents, db, **kw):
    kw.setdefault("heartbeat_interval_s", 0)
    return p.hosts.HostAgentPlacementManager(agents, db=db, key=KEY, **kw)


def superadmin(p, admin):
    return admin.authenticate_user(p.config.SUPERADMIN_EMAIL,
                                   p.config.SUPERADMIN_PASSWORD)["user_id"]


def seed_app(p, admin, uid, app, trials=2, chips=2):
    admin.create_model(uid, "fake", "IMAGE_CLASSIFICATION", p.template,
                       "FakeModel")
    admin.create_train_job(
        uid, app, "IMAGE_CLASSIFICATION", "uri://t", "uri://e",
        budget={"MODEL_TRIAL_COUNT": trials, "CHIP_COUNT": chips})
    return admin.wait_until_train_job_stopped(uid, app, timeout_s=60)


# ---------------------------------------------------------------------------
# placement choice with fake agent handles
# ---------------------------------------------------------------------------


class Accepts:
    key = None

    def __init__(self):
        self.created, self.stopped = [], []

    def create_service(self, sid, stype, n, best, extra):
        self.created.append(sid)
        return [0]

    def stop_service(self, sid, wait):
        self.stopped.append(sid)


def _two_agents(p, a_cls):
    placement = p.hosts.HostAgentPlacementManager(["a:1", "b:2"],
                                                  heartbeat_interval_s=0)
    placement.set_broker(p.fleet.FleetBroker(p.queue.InProcessBroker()))
    placement._inventories = lambda: [
        ("a:1", {"free_chips": 1, "n_services": 0, "total_chips": 1}),
        ("b:2", {"free_chips": 1, "n_services": 1, "total_chips": 1})]
    ok = Accepts()
    placement.agents = {"a:1": a_cls(p), "b:2": ok}
    return placement, ok


def _refuses(p):
    class Refuses:
        key = None

        def create_service(self, *a, **k):
            raise p.manager.InsufficientChipsError("no serving data plane")
    return Refuses()


def _vanishes(undo_ok):
    def make(p):
        class Vanishes:
            key = None
            stops = 0

            def create_service(self, *a, **k):
                raise p.hosts.AgentUnreachableError("timed out mid-create")

            def stop_service(self, sid, wait):
                self.stops += 1
                if not undo_ok:
                    raise p.hosts.AgentUnreachableError("still unreachable")
        return Vanishes()
    return make


def _circuit_open(p):
    class OpenCircuit:
        key = None

        def create_service(self, *a, **k):
            raise p.hosts.AgentCircuitOpenUnreachable("circuit open")

        def stop_service(self, sid, wait):
            raise AssertionError("undo of a call that never left")
    return OpenCircuit()


@pytest.mark.parametrize("first", ["refuses", "undone", "circuit_open"])
def test_serving_goes_to_the_next_agent(first):
    """The least-loaded agent refuses (503), fails ambiguously but its
    undo is confirmed, or has its circuit open: the replica lands on the
    other agent, and its relay queue points there."""
    make = {"refuses": _refuses, "undone": _vanishes(True),
            "circuit_open": _circuit_open}[first]

    def script(p):
        placement, ok = _two_agents(p, make)
        try:
            ctx = placement.create_service(
                "svc-1", "INFERENCE", n_chips=1, best_effort_chips=True,
                extra={"inference_job_id": "job-1"})
            return (placement.placements(), ctx.chips, ok.created,
                    sorted(placement.broker.get_worker_queues("job-1")),
                    getattr(placement.agents["a:1"], "stops", None))
        finally:
            placement.broker.close()

    got = both(script)
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == {"svc-1": "b:2"}


def test_an_ambiguous_create_whose_undo_fails_raises():
    def script(p):
        placement = p.hosts.HostAgentPlacementManager(
            ["a:1"], heartbeat_interval_s=0)
        placement.set_broker(p.fleet.FleetBroker(p.queue.InProcessBroker()))
        placement._inventories = lambda: [
            ("a:1", {"free_chips": 1, "n_services": 0, "total_chips": 1})]
        placement.agents = {"a:1": _vanishes(False)(p)}
        try:
            with pytest.raises(p.hosts.AgentUnreachableError) as err:
                placement.create_service(
                    "svc-2", "INFERENCE", n_chips=1, best_effort_chips=True,
                    extra={"inference_job_id": "job-2"})
            return "ambiguous" in str(err.value), placement.placements()
        finally:
            placement.broker.close()

    got = both(script)
    assert got["torch"] == got["jax"] == (True, {})


def test_the_down_threshold_and_recovery_bookkeeping():
    def script(p):
        placement = p.hosts.HostAgentPlacementManager(
            ["a:1", "b:2"], heartbeat_interval_s=0, down_threshold=2)
        out = []
        placement._note_heartbeat("a:1", False, "boom")
        out.append(placement.agent_health()["a:1"]["state"])
        placement._note_heartbeat("a:1", False, "boom")
        h = placement.agent_health()["a:1"]
        out += [h["state"], h["consecutive_misses"], h["last_error"]]
        p.http.get_breaker("a:1").record_failure()
        placement._note_heartbeat("a:1", True, None)
        h = placement.agent_health()["a:1"]
        out += [h["state"], h["consecutive_misses"], h["breaker"],
                placement.agent_health()["b:2"]["state"]]
        return out

    got = both(script)
    assert got["torch"] == got["jax"] == [
        "UNKNOWN", "DOWN", 2, "boom", "UP", 0, "CLOSED", "UNKNOWN"]


def test_a_dead_agents_train_service_moves_under_its_id():
    def script(p):
        placement = p.hosts.HostAgentPlacementManager(
            ["dead:1", "live:2"], heartbeat_interval_s=0, down_threshold=1)
        statuses = []
        placement.on_status = lambda sid, st: statuses.append((sid, st))
        live = Accepts()
        placement.agents = {"dead:1": Accepts(), "live:2": live}
        placement._inventories = lambda: [
            ("live:2", {"free_chips": 2, "n_services": 0,
                        "total_chips": 2})]
        placement.adopt_service("svc-t", "dead:1", "TRAIN", n_chips=1,
                                extra={"sub_train_job_id": "sub-1"})
        placement._note_heartbeat("dead:1", False, "no route to host")
        assert wait_for(
            lambda: placement.placements().get("svc-t") == "live:2")
        return live.created, statuses

    got = both(script)
    assert got["torch"] == got["jax"] == (["svc-t"], [])


def test_what_cannot_move_is_errored():
    """No surviving capacity: the dead agent's train and serving services
    are ERRORED (the job's refresh runs), and its relay queue leaves the
    fan-out."""
    def script(p):
        placement = p.hosts.HostAgentPlacementManager(
            ["dead:1"], heartbeat_interval_s=0, down_threshold=1)
        statuses = []
        placement.on_status = lambda sid, st: statuses.append((sid, st))
        broker = p.fleet.FleetBroker(p.queue.InProcessBroker())
        placement.set_broker(broker)
        placement.agents = {"dead:1": Accepts()}
        placement._inventories = lambda: []
        placement.adopt_service("svc-t", "dead:1", "TRAIN", n_chips=1)
        placement.adopt_service("svc-i", "dead:1", "INFERENCE", n_chips=1,
                                extra={"inference_job_id": "job-i"},
                                best_effort_chips=True)
        placement._note_heartbeat("dead:1", False, "gone")
        assert wait_for(lambda: len(statuses) == 2)
        out = (sorted(statuses), placement.placements(),
               broker.get_worker_queues("job-i"))
        broker.close()
        return out

    got = both(script)
    assert got["torch"] == got["jax"] == (
        [("svc-i", "ERRORED"), ("svc-t", "ERRORED")], {}, {})


def test_a_false_downs_rejoin_fences_its_orphans():
    def script(p):
        placement = p.hosts.HostAgentPlacementManager(
            ["part:1"], heartbeat_interval_s=0, down_threshold=1)
        agent_ = Accepts()
        placement.agents = {"part:1": agent_}
        placement._inventories = lambda: []  # nowhere to move it
        placement.adopt_service("svc-p", "part:1", "TRAIN")
        placement._note_heartbeat("part:1", False, "partition")
        assert wait_for(lambda: placement.placements() == {})
        placement._note_heartbeat("part:1", True, None)  # it heals
        assert wait_for(lambda: agent_.stopped == ["svc-p"])
        return agent_.stopped, placement.agent_health()["part:1"]["state"]

    got = both(script)
    assert got["torch"] == got["jax"] == (["svc-p"], "UP")


# ---------------------------------------------------------------------------
# real agents: serving past a dead host, the heartbeat monitor
# ---------------------------------------------------------------------------


class Serving:
    """An agent over a thread engine whose one worker answers
    ``["served", query]``."""

    def __init__(self, p, job="job", wid="w"):
        import threading

        self.broker = p.queue.InProcessBroker()
        self.allocator = p.manager.ChipAllocator(p.chips([0]))
        self._runners = {}
        q = self.broker.register_worker(job, wid)
        self.batches = 0

        def serve():
            while True:
                batch = q.take_batch(64, 0.0, 0.1)
                if batch is None:
                    return
                self.batches += bool(batch)
                for entry in batch:
                    entry[0].set_result(["served", entry[1]])

        threading.Thread(target=serve, daemon=True).start()
        self.q = q
        self.srv = p.agent.AgentServer(self, key=KEY).start()
        self.addr = f"127.0.0.1:{self.srv.port}"

    def list_services(self):
        return []

    def stop_all(self):
        self.q.close()

    def close(self):
        self.srv.stop()


def test_predict_survives_a_dead_host_within_its_slo():
    """Two replicas of one trial on two agents, one of them dead on the
    wire (chaos): a predict answers from the live one, inside the SLO."""
    def script(p):
        live, dead = Serving(p, wid="w-live"), Serving(p, wid="w-dead")
        broker = p.fleet.FleetBroker(p.queue.InProcessBroker())
        try:
            broker.register_remote_worker("job", "w-live", live.addr,
                                          key=KEY)
            broker.register_remote_worker("job", "w-dead", dead.addr,
                                          key=KEY)
            p.chaos.install([p.chaos.ChaosRule(
                site="call_agent", action="drop", match=dead.addr)])
            predictor = p.Predictor(
                "job", broker, task=None,
                worker_trials={"w-live": "t1", "w-dead": "t1"})
            t0 = time.monotonic()
            preds = predictor.predict_batch([[1.0], [2.0]], timeout_s=10.0)
            fast = time.monotonic() - t0 < 5.0
            return preds, fast, live.batches >= 1, dead.batches
        finally:
            broker.close()
            live.close()
            dead.close()

    got = both(script)
    assert got["torch"] == got["jax"] == (
        [["served", [1.0]], ["served", [2.0]]], True, True, 0)


def test_the_heartbeat_monitor_takes_a_dead_host_out(tmp_path):
    """A real monitor over two agents; chaos kills one on the wire. It is
    marked DOWN, its relay queue evicted, its service ERRORED in the
    store, the other stays RUNNING, and predict answers fast."""
    def script(p):
        db = p.Database(str(tmp_path / f"{p.name}.sqlite3"))
        sids = {}
        for name in ("live", "dead"):
            sids[name] = db.create_service("INFERENCE")["id"]
            db.mark_service_as_running(sids[name])
        live = Serving(p, wid=sids["live"])
        dead = Serving(p, wid=sids["dead"])
        broker = p.fleet.FleetBroker(p.queue.InProcessBroker())
        placement = host_placement(p, [live.addr, dead.addr], db,
                                   heartbeat_interval_s=0.05,
                                   down_threshold=2)
        placement.set_broker(broker)
        try:
            for name, srv in (("live", live), ("dead", dead)):
                placement.adopt_service(sids[name], srv.addr, "INFERENCE",
                                        n_chips=1, best_effort_chips=True,
                                        extra={"inference_job_id": "job"})
            assert wait_for(lambda: all(
                v["state"] == "UP"
                for v in placement.agent_health().values()), 10)
            p.chaos.install([p.chaos.ChaosRule(
                site="call_agent", action="drop", match=dead.addr)])
            assert wait_for(lambda: placement.agent_health()[dead.addr][
                "state"] == "DOWN", 10)
            assert wait_for(lambda: db.get_service(sids["dead"])[
                "status"] == "ERRORED", 10)
            predictor = p.Predictor(
                "job", broker, task=None,
                worker_trials={sids["live"]: "t", sids["dead"]: "t"})
            t0 = time.monotonic()
            preds = predictor.predict_batch([[7.0]], timeout_s=10.0)
            quick = time.monotonic() - t0 < 2.0
            return (sorted(broker.get_worker_queues("job")) == [sids["live"]],
                    db.get_service(sids["live"])["status"],
                    placement.agent_health()[dead.addr]["breaker"] in (
                        "CLOSED", "OPEN", "HALF_OPEN"), preds, quick)
        finally:
            placement.stop_all()
            broker.close()
            live.close()
            dead.close()

    got = both(script)
    assert got["torch"] == got["jax"] == (
        True, "RUNNING", True, [["served", [7.0]]], True)


# ---------------------------------------------------------------------------
# whole jobs over agents
# ---------------------------------------------------------------------------


def test_a_train_job_spreads_over_two_agents(tmp_path, monkeypatch):
    """The least-loaded choice spreads four one-card executors 2 + 2 over
    two agents, and the budget holds across them: four trials, each
    COMPLETED."""
    def script(p):
        work = tmp_path / p.name
        work.mkdir()
        monkeypatch.setenv("RAFIKI_WORKDIR", str(work))
        monkeypatch.setenv("RAFIKI_LOGS_DIR", str(work / "logs"))
        db = p.Database(str(work / "meta.sqlite3"))
        hosts_ = [spawn_host(p, db, ids) for ids in ([0, 1], [2, 3])]
        placement = host_placement(p, [h[2] for h in hosts_], db)
        admin = p.Admin(db=db, placement=placement,
                        params_dir=str(work / "params"))
        try:
            uid = superadmin(p, admin)
            admin.create_model(uid, "fake", "IMAGE_CLASSIFICATION",
                               p.template, "FakeModel")
            job = admin.create_train_job(
                uid, "fleetapp", "IMAGE_CLASSIFICATION", "uri://t",
                "uri://e", budget={"MODEL_TRIAL_COUNT": 4, "CHIP_COUNT": 4})
            by_agent = {}
            for sid, addr in placement.placements().items():
                by_agent.setdefault(addr, []).append(sid)
            spread = sorted(len(v) for v in by_agent.values())
            grants = sorted(len(w["chips"]) for w in job["workers"])
            job = admin.wait_until_train_job_stopped(uid, "fleetapp",
                                                     timeout_s=60)
            done = [t for t in admin.get_trials_of_train_job(uid, "fleetapp")
                    if t["status"] == "COMPLETED"]
            return (set(by_agent) == {h[2] for h in hosts_}, spread,
                    grants, job["status"], len(done))
        finally:
            admin.shutdown()
            for _, srv, _ in hosts_:
                srv.stop()

    got = both(script)
    assert got["torch"] == got["jax"] == (True, [2, 2], [1, 1, 1, 1],
                                          "STOPPED", 4)


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_a_keyless_agent_refuses_to_start(tmp_path, package):
    """A keyless agent process exits 2 with the same advice in both
    packages; and the port's without a store, and without a card to
    count, exits 2 too (never on the CPU unless told)."""
    p = PACKAGES[package]
    env = {**os.environ, "RAFIKI_DB_PATH": str(tmp_path / "db.sqlite3"),
           "RAFIKI_WORKDIR": str(tmp_path),
           "PYTHONPATH": str(ROOT) + os.pathsep + os.environ.get(
               "PYTHONPATH", "")}
    env.pop("RAFIKI_AGENT_KEY", None)
    env.pop("RAFIKI_AGENT_INSECURE", None)
    run = subprocess.run([sys.executable, "-m", p.module], env=env,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert run.returncode == 2
    assert "RAFIKI_AGENT_KEY required" in run.stderr
    if package == "torch":
        env["RAFIKI_AGENT_KEY"] = KEY
        env["CUDA_VISIBLE_DEVICES"] = ""
        run = subprocess.run([sys.executable, "-m", p.module], env=env,
                             cwd=ROOT, capture_output=True, text=True,
                             timeout=120)
        assert run.returncode == 2
        assert "could not discover this host's chips" in run.stderr
        assert "no CUDA device visible" in run.stderr
        assert agent.READY_PREFIX not in run.stdout


def _spawn_port_agent(tmp_path, db_path, admin_port):
    env = {**os.environ, "RAFIKI_AGENT_CHIPS": "cpu",
           "RAFIKI_AGENT_PORT": "0", "RAFIKI_AGENT_KEY": KEY,
           "RAFIKI_DB_PATH": str(db_path), "RAFIKI_WORKDIR": str(tmp_path),
           "RAFIKI_LOGS_DIR": str(tmp_path / "logs"),
           "RAFIKI_ADMIN_ADDR": f"127.0.0.1:{admin_port}",
           "PYTHONPATH": str(ROOT) + os.pathsep + os.environ.get(
               "PYTHONPATH", "")}
    proc = subprocess.Popen(
        [sys.executable, "-m", "rafiki_tpu_torch.placement.agent"], env=env,
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    deadline = time.monotonic() + 60
    line = ""
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if agent.READY_PREFIX in line:
            return proc, line.split(agent.READY_PREFIX)[1].split()[0]
        if proc.poll() is not None:
            break
    proc.kill()
    raise RuntimeError(f"agent did not start: {line!r}")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_a_job_ends_without_the_agents_forwarded_events(tmp_path,
                                                        monkeypatch):
    """An agent process (the port's, on ``RAFIKI_AGENT_CHIPS=cpu``) places
    a train child; the admin drops every ``service_status`` event the
    agent forwards, and the host placement's store monitor alone ends
    the job, as in the original's drill (there an agent with no admin
    address)."""
    db_path = tmp_path / "meta.sqlite3"
    monkeypatch.setenv("RAFIKI_WORKDIR", str(tmp_path))
    monkeypatch.setenv("RAFIKI_LOGS_DIR", str(tmp_path / "logs"))
    port = _free_port()
    proc, addr = _spawn_port_agent(tmp_path, db_path, port)
    db = Database(str(db_path))
    placement = hosts.HostAgentPlacementManager(
        [addr], db=db, key=KEY, monitor_interval_s=0.2,
        heartbeat_interval_s=0)
    admin = Admin(db=db, placement=placement,
                  params_dir=str(tmp_path / "params"))
    dropped = []
    handle = admin.handle_event

    def handle_event(name, payload):
        if name == "service_status":
            dropped.append(payload["status"])
            return
        handle(name, payload)

    admin.handle_event = handle_event
    server = AdminServer(admin, port=port).start()
    try:
        uid = superadmin(PACKAGES["torch"], admin)
        admin.create_model(uid, "fake", "IMAGE_CLASSIFICATION",
                           FAKE_TEMPLATE, "FakeModel")
        admin.create_train_job(
            uid, "quietapp", "IMAGE_CLASSIFICATION", "uri://t", "uri://e",
            budget={"MODEL_TRIAL_COUNT": 2, "CHIP_COUNT": 1})
        inv = agent_http.call_agent(addr, "GET", "/inventory", key=KEY,
                                    timeout_s=10)
        assert [s["service_type"] for s in inv["services"]] == ["TRAIN"]
        assert inv["services"][0]["pid"] and inv["services"][0][
            "chips"] == ["cpu"]
        job = admin.wait_until_train_job_stopped(uid, "quietapp",
                                                 timeout_s=120)
        assert job["status"] == "STOPPED"
        done = [t for t in admin.get_trials_of_train_job(uid, "quietapp")
                if t["status"] == "COMPLETED"]
        assert len(done) == 2
    finally:
        server.stop()
        admin.shutdown()
        proc.terminate()
        try:
            proc.wait(timeout=20)
        except subprocess.TimeoutExpired:
            proc.kill()
    assert proc.returncode == 0  # SIGTERM: the agent stops its children


def test_the_admin_boots_in_hosts_mode_from_its_settings(tmp_path,
                                                         monkeypatch):
    """``RAFIKI_PLACEMENT=hosts`` and ``RAFIKI_AGENTS`` build the host
    placement behind a ``FleetBroker`` in both packages. With no CUDA
    device the port's admin has no local engine: a serving executor no
    agent can take raises instead of running here on the CPU."""
    monkeypatch.setenv("RAFIKI_PLACEMENT", "hosts")
    monkeypatch.setenv("RAFIKI_AGENTS", "127.0.0.1:9,127.0.0.1:10")
    monkeypatch.setenv("RAFIKI_AGENT_KEY", KEY)
    monkeypatch.setenv("RAFIKI_AGENT_HEARTBEAT_S", "0")
    monkeypatch.setenv("RAFIKI_WORKDIR", str(tmp_path))

    def script(p):
        admin = p.Admin(db=p.Database(str(tmp_path / f"{p.name}.sqlite3")),
                        params_dir=str(tmp_path / "params"))
        try:
            pl = admin.placement
            return (type(pl).__name__, sorted(pl.agents),
                    type(admin.broker).__name__,
                    {h.key for h in pl.agents.values()},
                    pl.allocator.total_chips)
        finally:
            admin.shutdown()

    got = both(script)
    assert got["torch"] == got["jax"] == (
        "HostAgentPlacementManager", ["127.0.0.1:10", "127.0.0.1:9"],
        "FleetBroker", {KEY}, 0)
    admin = Admin(db=Database(str(tmp_path / "again.sqlite3")))
    try:
        assert admin.placement.local is None
        with pytest.raises(RuntimeError, match="no `local` engine"):
            admin.placement.create_service("s", "INFERENCE", n_chips=1,
                                           best_effort_chips=True,
                                           extra={"inference_job_id": "j"})
    finally:
        admin.shutdown()


def test_generation_is_refused_under_host_placement(tmp_path):
    """A difference from the original (ROADMAP.md, C): an agent's relay
    carries no token stream, so a ``TEXT_GENERATION`` inference job under
    host placement is refused typed at deploy and ERRORED, as under
    process placement, instead of being placed on an agent."""
    from rafiki_tpu_torch.admin.services import ServiceDeploymentError

    db = Database(str(tmp_path / "meta.sqlite3"))
    placement = hosts.HostAgentPlacementManager(
        ["127.0.0.1:9"], key=KEY, db=db, heartbeat_interval_s=0)
    admin = Admin(db=db, placement=placement,
                  params_dir=str(tmp_path / "params"))
    try:
        user = db.create_user("u@x", "h", "APP_DEVELOPER")
        model = db.create_model(user["id"], "lm", "TEXT_GENERATION",
                                FAKE_TEMPLATE, "FakeModel", {}, "PUBLIC")
        tj = db.create_train_job(user["id"], "gen", 1, "TEXT_GENERATION",
                                 "u://t", "u://e", {"MODEL_TRIAL_COUNT": 1})
        sub = db.create_sub_train_job(tj["id"], model["id"])
        trial = db.create_trial(sub["id"], model["id"], {})
        db.mark_trial_as_complete(trial["id"], 0.5, None)
        db.mark_train_job_as_stopped(tj["id"])
        inf = db.create_inference_job(user["id"], tj["id"])
        with pytest.raises(ServiceDeploymentError, match="TEXT_GENERATION"):
            admin.services.create_inference_services(inf["id"])
        assert db.get_inference_job(inf["id"])["status"] == "ERRORED"
        assert placement.placements() == {}
    finally:
        admin.shutdown()
