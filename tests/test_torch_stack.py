"""The port's control plane against the JAX package's, on the CPU.

- REST surface: the port's ``AdminServer`` route table (method, path
  pattern, user types) equals the JAX door's for every route the port
  carries; the routes left for later are named.
- Quickstart, both stacks: the same cycle (login, upload, train job,
  trials, logs, inference job, predict, stop) through each package's
  ``Admin`` + ``AdminServer`` + ``Client``, JAX with
  ``tests/fixtures/fake_model.py`` and the port with a fake template of
  the same four knobs. The JSON key sets of the answers, the job and
  trial statuses, the trial count, the best-trial order and the HTTP
  status of the same bad requests must match. The port's placement is an
  allocator over ``["cpu"]``: one device, as a one-card host.
- A tiny ViT-B/16 (the ``TorchViT`` template at test width) through the
  port's ``Client``: 2 trials, then serving; ``/predict/<app>`` answers
  are held against JAX's ``vit.apply`` softmax on the downloaded trees.
- No fallback: without CUDA the default allocator, ``Admin`` and
  ``python -m rafiki_tpu_torch.admin`` refuse to start, and each setting
  for a subsystem the port lacks raises its typed error;
  ``RAFIKI_PLACEMENT=process`` and ``RAFIKI_BROKER=shm`` select the
  process placement and the shm broker.
"""

import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rafiki_tpu_torch
from rafiki_tpu.admin.admin import Admin as JaxAdmin
from rafiki_tpu.admin.http import AdminServer as JaxAdminServer
from rafiki_tpu.client.client import Client as JaxClient
from rafiki_tpu.client.client import RafikiError as JaxRafikiError
from rafiki_tpu.db.database import Database as JaxDatabase
from rafiki_tpu.models import vit as jvit
from rafiki_tpu.placement import manager as jax_manager
from rafiki_tpu_torch import config
from rafiki_tpu_torch.admin.admin import Admin, InvalidRequestError
from rafiki_tpu_torch.admin.http import AdminServer
from rafiki_tpu_torch.client.client import Client, RafikiError
from rafiki_tpu_torch.config import NotPortedError
from rafiki_tpu_torch.db.database import Database
from rafiki_tpu_torch.device import set_device_grant
from rafiki_tpu_torch.cache.shm_broker import ShmBroker
from rafiki_tpu_torch.placement.manager import (
    ChipAllocator,
    LocalPlacementManager,
)
from rafiki_tpu_torch.placement.process import ProcessPlacementManager
from rafiki_tpu_torch.sdk.dataset import write_numpy_dataset
from rafiki_tpu_torch.sdk.model import InvalidModelClassError
from rafiki_tpu_torch.sdk.params import load_params

ROOT = Path(rafiki_tpu_torch.__file__).resolve().parents[1]
JAX_FAKE = ROOT / "tests" / "fixtures" / "fake_model.py"

# the port's twin of tests/fixtures/fake_model.py: the same four knobs,
# the same logs, predictions and parameters
FAKE_TEMPLATE = b'''
import random

from rafiki_tpu_torch.sdk.knob import (CategoricalKnob, FixedKnob, FloatKnob,
                                       IntegerKnob)
from rafiki_tpu_torch.sdk.model import BaseModel


class FakeModel(BaseModel):
    dependencies = {"numpy": None}

    @staticmethod
    def get_knob_config():
        return {
            "int_knob": IntegerKnob(1, 32),
            "float_knob": FloatKnob(1e-4, 1e-1, is_exp=True),
            "cat_knob": CategoricalKnob(["a", "b", "c"]),
            "fixed_knob": FixedKnob("fixed"),
        }

    def __init__(self, **knobs):
        super().__init__(**knobs)
        self._params = None

    def train(self, dataset_uri):
        self.logger.define_plot("fake metric", ["metric"], x_axis="step")
        for i in range(3):
            self.logger.log(metric=float(i), step=float(i))
        self.logger.log("train done")
        self._params = {"weight": [1.0, 2.0],
                        "knob_echo": self._knobs["int_knob"]}

    def evaluate(self, dataset_uri):
        return random.random()

    def predict(self, queries):
        return [[0.5, 0.5] for _ in queries]

    def dump_parameters(self):
        return self._params

    def load_parameters(self, params):
        self._params = params
'''

#: JAX routes whose Admin method is not ported yet (ROADMAP.md, queue A):
#: none since the trial trace and fleet health landed
LATER: set = set()


def _route_table(server_cls):
    srv = server_cls.__new__(server_cls)
    srv.admin = None  # the lambdas read it only when called
    return {(m, p.pattern[1:-1]): allowed
            for m, p, allowed, _ in srv._build_routes()}


#: the advisor routes a process-placed train worker uses
ADVISOR_ROUTES = {
    ("POST", "/advisors"),
    ("POST", r"/advisors/(?P<aid>[^/]+)/propose"),
    ("POST", r"/advisors/(?P<aid>[^/]+)/propose_batch"),
    ("POST", r"/advisors/(?P<aid>[^/]+)/feedback"),
    ("POST", r"/advisors/(?P<aid>[^/]+)/feedback_batch"),
    ("POST", r"/advisors/(?P<aid>[^/]+)/infeasible"),
    ("POST", r"/advisors/(?P<aid>[^/]+)/replay"),
    ("POST", r"/advisors/(?P<aid>[^/]+)/report_rung"),
    ("DELETE", r"/advisors/(?P<aid>[^/]+)"),
}


def test_route_table_matches_the_jax_door():
    theirs, ours = _route_table(JaxAdminServer), _route_table(AdminServer)
    assert set(ours) | LATER == set(theirs)
    assert not set(ours) & LATER
    assert ADVISOR_ROUTES <= set(ours)
    for key, allowed in ours.items():
        assert allowed == theirs[key], key


# ---------------------------------------------------------------------------
# quickstart through both stacks
# ---------------------------------------------------------------------------

def _shape(value):
    """The key structure of a JSON answer (values set aside)."""
    if isinstance(value, dict):
        return {k: _shape(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_shape(value[0])] if value else []
    return None


def _status_of(call):
    try:
        call()
    except (RafikiError, JaxRafikiError) as e:
        return e.status
    return 200


def _quickstart(client_cls, port, template, tmp_path):
    """One cycle through a live door; returns (answers' key structures,
    statuses and counts, the HTTP status of each bad request)."""
    c = client_cls("127.0.0.1", port)
    shapes, facts = {}, {}
    shapes["login"] = c.login(config.SUPERADMIN_EMAIL,
                              config.SUPERADMIN_PASSWORD)
    shapes["create_user"] = c.create_user("app@x", "pw", "APP_DEVELOPER")
    shapes["get_users"] = c.get_users()
    path = tmp_path / "template.py"
    path.write_bytes(template)
    shapes["create_model"] = c.create_model(
        "fake", "IMAGE_CLASSIFICATION", str(path), "FakeModel",
        access_right="PUBLIC")
    shapes["verify_model"] = c.verify_model(str(path), "FakeModel")
    shapes["get_models"] = c.get_models()
    shapes["get_model"] = c.get_model("fake")
    facts["model_file"] = c.download_model_file("fake") == template
    job = c.create_train_job("app", "IMAGE_CLASSIFICATION", "u://t", "u://e",
                             budget={"MODEL_TRIAL_COUNT": 3, "CHIP_COUNT": 1})
    shapes["create_train_job"] = job
    first = job["status"]
    deadline = time.monotonic() + 60
    while job["status"] not in ("STOPPED", "ERRORED"):
        assert time.monotonic() < deadline, job
        time.sleep(0.05)
        job = c.get_train_job("app")
    # the job may finish before its creation answers
    assert first in ("RUNNING", "STOPPED")
    facts["train_job_status"] = job["status"]
    shapes["get_train_job"] = job
    shapes["get_train_jobs"] = c.get_train_jobs()
    shapes["get_train_jobs_of_app"] = c.get_train_jobs_of_app("app")
    trials = c.get_trials_of_train_job("app")
    shapes["get_trials"] = trials
    facts["trial_statuses"] = sorted(t["status"] for t in trials)
    best = c.get_best_trials_of_train_job("app", max_count=2)
    shapes["get_best_trials"] = best
    facts["best_order"] = [b["score"] for b in best] == sorted(
        (t["score"] for t in trials), reverse=True)[:2]
    shapes["get_trial"] = c.get_trial(best[0]["id"])
    logs = c.get_trial_logs(best[0]["id"])
    shapes["get_trial_logs"] = logs
    # the template's own records; each worker's tracer adds a "trial
    # phase breakdown" message and a metrics record of spans
    facts["logs"] = ([m["message"] for m in logs["messages"]
                      if m["message"] != "trial phase breakdown"],
                     [p["title"] for p in logs["plots"]],
                     [m["metric"] for m in logs["metrics"] if "metric" in m])
    facts["params"] = len(c.download_trial_params(best[0]["id"])) > 0
    inf = c.create_inference_job("app")
    shapes["create_inference_job"] = inf
    facts["inference_workers"] = len(inf["workers"])
    facts["predict"] = c.predict("app", [[0.1], [0.2], [0.3]])
    shapes["get_inference_job"] = c.get_inference_job("app")
    shapes["get_inference_job_stats"] = c.get_inference_job_stats("app")
    stopped = c.stop_inference_job("app")
    shapes["stop_inference_job"] = stopped
    facts["inference_statuses"] = [inf["status"], stopped["status"]]

    app_dev = client_cls("127.0.0.1", port)
    app_dev.login("app@x", "pw")
    anonymous = client_cls("127.0.0.1", port)
    bad = {
        "unknown class": lambda: c.create_model(
            "x1", "IMAGE_CLASSIFICATION", str(path), "NoSuchModel"),
        "generative task": lambda: c.create_model(
            "x2", "TEXT_GENERATION", str(path), "FakeModel"),
        "task without models": lambda: c.create_train_job(
            "app2", "POS_TAGGING", "u://t", "u://e"),
        "budget below 1": lambda: c.create_train_job(
            "app3", "IMAGE_CLASSIFICATION", "u://t", "u://e",
            budget={"MODEL_TRIAL_COUNT": 0}),
        "budget not a number": lambda: c.create_train_job(
            "app4", "IMAGE_CLASSIFICATION", "u://t", "u://e",
            budget={"TIME_HOURS": "soon"}),
        "no token": lambda: anonymous.get_models(),
        "wrong user type": lambda: app_dev.create_user(
            "x@x", "pw", "ADMIN"),
        "no such trial": lambda: c.get_trial("nope"),
        "stopped job's predict": lambda: c.predict("app", [[0.1]]),
        "bad login": lambda: anonymous.login(config.SUPERADMIN_EMAIL, "no"),
    }
    codes = {name: _status_of(call) for name, call in bad.items()}
    facts["existing model kept"] = c.get_model("fake")["name"] == "fake"
    return _shape(shapes), facts, codes


@pytest.fixture(scope="module")
def both_cycles(tmp_path_factory):
    out = {}
    tmp = tmp_path_factory.mktemp("jax")
    jadmin = JaxAdmin(db=JaxDatabase(":memory:"),
                      placement=jax_manager.LocalPlacementManager(
                          allocator=jax_manager.ChipAllocator([0])),
                      params_dir=str(tmp / "params"))
    jsrv = JaxAdminServer(jadmin, port=0).start()
    try:
        out["jax"] = _quickstart(JaxClient, jsrv.port, JAX_FAKE.read_bytes(),
                                 tmp)
    finally:
        jsrv.stop()
        jadmin.shutdown()
    tmp = tmp_path_factory.mktemp("torch")
    admin = Admin(db=Database(":memory:"),
                  placement=LocalPlacementManager(ChipAllocator(["cpu"])),
                  params_dir=str(tmp / "params"))
    srv = AdminServer(admin, port=0).start()
    try:
        out["torch"] = _quickstart(Client, srv.port, FAKE_TEMPLATE, tmp)
    finally:
        srv.stop()
        admin.shutdown()
    return out


def test_answers_have_the_same_keys(both_cycles):
    (jax_shapes, _, _), (shapes, _, _) = both_cycles["jax"], \
        both_cycles["torch"]
    assert set(shapes) == set(jax_shapes)
    for call in jax_shapes:
        assert shapes[call] == jax_shapes[call], call


def test_statuses_counts_and_order_match(both_cycles):
    _, jax_facts, _ = both_cycles["jax"]
    _, facts, _ = both_cycles["torch"]
    assert facts == jax_facts
    assert facts["trial_statuses"] == ["COMPLETED"] * 3
    assert facts["train_job_status"] == "STOPPED"
    assert facts["logs"] == (["train done"], ["fake metric"], [0.0, 1.0, 2.0])
    assert facts["inference_statuses"] == ["RUNNING", "STOPPED"]
    # two best trials on one device: a worker each, the second sharing
    assert facts["inference_workers"] == 2
    assert facts["predict"] == [[0.5, 0.5]] * 3


def test_bad_requests_get_the_same_status(both_cycles):
    _, _, jax_codes = both_cycles["jax"]
    _, _, codes = both_cycles["torch"]
    assert codes == jax_codes
    assert codes["no token"] == 401 and codes["wrong user type"] == 401
    assert codes["unknown class"] == 400 and codes["budget below 1"] == 400


def test_one_device_serves_both_trials(tmp_path):
    """On a one-device allocator the replica clamp gives 1 replica a
    trial; the second trial's worker shares the device, and releasing
    the workers gives the device back."""
    alloc = ChipAllocator(["cpu"])
    admin = Admin(db=Database(":memory:"),
                  placement=LocalPlacementManager(alloc),
                  params_dir=str(tmp_path))
    try:
        uid = admin.authenticate_user(config.SUPERADMIN_EMAIL,
                                      config.SUPERADMIN_PASSWORD)["user_id"]
        admin.create_model(uid, "fake", "IMAGE_CLASSIFICATION",
                           FAKE_TEMPLATE, "FakeModel")
        admin.create_train_job(uid, "a", "IMAGE_CLASSIFICATION", "t", "e",
                               budget={"MODEL_TRIAL_COUNT": 2,
                                       "CHIP_COUNT": 1})
        job = admin.wait_until_train_job_stopped(uid, "a", timeout_s=60)
        assert job["workers"][0]["chips"] == ["cpu"]
        inf = admin.create_inference_job(uid, "a")
        assert [w["chips"] for w in inf["workers"]] == [["cpu"], ["cpu"]]
        live = admin.services.live_inference_workers(inf["id"])
        assert sorted(w["trial_id"] for w in live) == sorted(
            w["trial_id"] for w in inf["workers"])
        assert alloc.free_chips == 0
        admin.stop_inference_job(uid, "a")
        deadline = time.monotonic() + 15
        while alloc.free_chips != 1:
            assert time.monotonic() < deadline
            time.sleep(0.05)
        assert admin.services.live_inference_workers(inf["id"]) == []
        with pytest.raises(InvalidRequestError):
            admin.predict(uid, "a", [[0.0]])
    finally:
        admin.shutdown()


# ---------------------------------------------------------------------------
# a tiny ViT-B/16 through the port's Client
# ---------------------------------------------------------------------------

#: the TorchViT template at test width (vit.tiny()), the flash op forced
#: so training runs its plain forward-with-LSE and backward
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
    ('"epochs": FixedKnob(1)', '"epochs": FixedKnob(2)'),
    ('heads=k["heads"]))', 'heads=k["heads"], use_flash=True))'),
]
# bf16 logits of the two packages differ by a few bf16 ulps
# (tests/test_torch_vit.py); through a softmax over 10 classes that moves
# each probability by at most ~p * 2.5e-2
PROB_ATOL = 5e-3


def _tiny_template():
    source = (ROOT / "rafiki_tpu_torch" / "templates"
              / "torch_vit.py").read_text()
    for old, new in _TINY_EDITS:
        assert source.count(old) == 1, old
        source = source.replace(old, new)
    return source.encode()


def _dataset(tmp_path):
    """10 classes, each a fixed random pattern plus noise: learnable."""
    rng = np.random.default_rng(0)
    patterns = rng.standard_normal((10, 32, 32, 3)).astype(np.float32)

    def split(n, name):
        y = rng.integers(0, 10, n)
        x = patterns[y] + 0.5 * rng.standard_normal(
            (n, 32, 32, 3)).astype(np.float32)
        return write_numpy_dataset(x, y.astype(np.int32),
                                   str(tmp_path / f"{name}.npz"))

    return split(64, "train"), split(32, "test")


def test_tiny_vit_cycle_through_the_client(tmp_path):
    admin = Admin(db=Database(str(tmp_path / "store.sqlite3")),
                  placement=LocalPlacementManager(ChipAllocator(["cpu"])),
                  params_dir=str(tmp_path / "params"))
    srv = AdminServer(admin, port=0).start()
    try:
        c = Client("127.0.0.1", srv.port, timeout_s=300)
        c.login(config.SUPERADMIN_EMAIL, config.SUPERADMIN_PASSWORD)
        model = c.create_model("tiny", "IMAGE_CLASSIFICATION",
                               _tiny_template(), "TinyViT")
        assert model["verification"]["ok"]
        train_uri, test_uri = _dataset(tmp_path)
        c.create_train_job("vit", "IMAGE_CLASSIFICATION", train_uri,
                           test_uri, budget={"MODEL_TRIAL_COUNT": 2,
                                             "CHIP_COUNT": 1})
        job = c.wait_until_train_job_stopped("vit", timeout_s=300)
        assert job["status"] == "STOPPED"
        trials = c.get_trials_of_train_job("vit")
        assert [t["status"] for t in trials] == ["COMPLETED"] * 2, trials
        assert all(0.0 <= t["score"] <= 1.0 for t in trials)
        assert all(t["knobs"]["batch_size"] in (8, 16) for t in trials)
        epochs = [m["epoch"] for m in c.get_trial_logs(trials[0]["id"])[
            "metrics"] if "loss" in m]
        assert epochs == [0.0, 1.0]
        trees = [load_params(c.download_trial_params(t["id"]))
                 for t in trials]

        inf = c.create_inference_job("vit")
        assert inf["status"] == "RUNNING" and len(inf["workers"]) == 2
        with np.load(test_uri) as z:
            x = z["x"]
        probs = [np.asarray(c.predict("vit", x[:n].tolist()))
                 for n in (1, 8)]
        stats = c.get_inference_job_stats("vit")
        assert stats["queries"] == 2 * 9 and stats["batches"] >= 4
        c.stop_inference_job("vit")

        set_device_grant(["cpu"])
        try:
            local = c.load_trial_model(trials[0]["id"], "tiny")
            local_probs = np.asarray(local.predict(x[:8]))
        finally:
            set_device_grant(None)
    finally:
        srv.stop()
        admin.shutdown()
    ref = [np.asarray(jax.nn.softmax(jvit.apply(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x[:8]), jvit.tiny()),
        -1)) for tree in trees]
    ensemble = (ref[0] + ref[1]) / 2
    for p in probs:
        assert p.shape == (len(p), 10)
        np.testing.assert_allclose(p, ensemble[:len(p)], atol=PROB_ATOL,
                                   rtol=0)
    np.testing.assert_allclose(local_probs, ref[0], atol=PROB_ATOL, rtol=0)


# ---------------------------------------------------------------------------
# no fallback
# ---------------------------------------------------------------------------

@pytest.fixture()
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)


def test_default_placement_refuses_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ChipAllocator()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Admin(db=Database(":memory:"))


def test_default_allocator_lists_the_visible_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.delenv("RAFIKI_VISIBLE_DEVICES", raising=False)
    assert ChipAllocator().allocate(4) == [0, 1, 2, 3]
    monkeypatch.setenv("RAFIKI_VISIBLE_DEVICES", "2,3")
    alloc = ChipAllocator()
    assert alloc.total_chips == 2 and alloc.allocate(1) == [2]
    assert alloc.shared(0) == [2]


def test_the_admin_process_refuses_without_cuda(tmp_path):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "",
           "RAFIKI_WORKDIR": str(tmp_path), "RAFIKI_ADMIN_PORT": "0"}
    proc = subprocess.run(
        [sys.executable, "-m", "rafiki_tpu_torch.admin"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert "admin on http" not in proc.stdout


@pytest.mark.parametrize("name,value,subsystem", [
    ("RAFIKI_ADMIN_HA", "1", "HA"),
    ("RAFIKI_PLACEMENT", "hosts", "placement"),
    ("RAFIKI_SANDBOX", "1", "sandbox"),
    ("RAFIKI_INSTALL_DEPS", "1", "dependency provisioning"),
    ("RAFIKI_GEN_SPEC", "1", "speculative decoding"),
    ("RAFIKI_GEN_RESUME_MAX", "3", "stream resume"),
    ("RAFIKI_AUTOSCALE", "1", "autoscaler"),
    ("RAFIKI_AUTOSCALE_FAIR", "1", "fair admission"),
    ("RAFIKI_AUTOSCALE_WARM_POOL", "2", "warm pool"),
    ("RAFIKI_DRIFT", "1", "drift"),
    ("RAFIKI_SERVE_INT8", "1", "int8 serving"),
    ("RAFIKI_AGENTS", "10.0.0.2:7000", "host placement"),
    ("RAFIKI_RECOVER_PROBE_TIMEOUT_S", "5", "host placement"),
    ("RAFIKI_ADMIN_ADDRS", "127.0.0.1:3000,127.0.0.1:3001", "failover"),
    ("RAFIKI_ORPHAN_SURVIVE", "1", "crash recovery"),
    ("RAFIKI_TRACE_SAMPLE", "0.5", "request tracing"),
    ("RAFIKI_PROFILE", "1", "device profiling"),
])
def test_unported_settings_raise(monkeypatch, tmp_path, name, value,
                                 subsystem):
    """A setting that selects a subsystem the port lacks refuses the
    admin's start, typed: only ``RAFIKI_INSTALL_DEPS`` now. Speculative
    decoding, stream resume, int8 serving, the autoscaler, fair
    admission, the warm pool, the drift loop, the sandbox, control-plane
    HA, admin failover, crash recovery, host placement, request tracing
    and device profiling are ported: their settings are read, with the
    JAX package's defaults."""
    if name in ("RAFIKI_PLACEMENT", "RAFIKI_AGENTS",
                "RAFIKI_RECOVER_PROBE_TIMEOUT_S"):
        from rafiki_tpu import config as jax_config
        from rafiki_tpu_torch.placement.hosts import (
            HostAgentPlacementManager,
        )

        knobs = ("RECOVER_PROBE_TIMEOUT_S", "AGENT_HEARTBEAT_INTERVAL_S",
                 "AGENT_DOWN_THRESHOLD", "AGENT_HEARTBEAT_TIMEOUT_S",
                 "AGENT_RETRY_MAX", "AGENT_RETRY_BACKOFF_S",
                 "AGENT_BREAKER_THRESHOLD", "AGENT_BREAKER_COOLDOWN_S")
        monkeypatch.delenv(name, raising=False)
        for knob in knobs:
            assert getattr(config, knob) == getattr(jax_config, knob), knob
        monkeypatch.setenv(name, value)
        if name == "RAFIKI_PLACEMENT":
            # hosts mode needs its agents' addresses; none answers here
            monkeypatch.setenv("RAFIKI_AGENTS", "127.0.0.1:9")
            monkeypatch.setenv("RAFIKI_AGENT_HEARTBEAT_S", "0")
            admin = Admin(db=Database(str(tmp_path / "s.sqlite3")))
        else:
            admin = Admin(db=Database(str(tmp_path / "s.sqlite3")),
                          placement=LocalPlacementManager(
                              ChipAllocator(["cpu"])))
        try:
            assert isinstance(admin.placement, HostAgentPlacementManager) \
                is (name == "RAFIKI_PLACEMENT")
        finally:
            admin.shutdown()
        if name == "RAFIKI_RECOVER_PROBE_TIMEOUT_S":
            assert config.RECOVER_PROBE_TIMEOUT_S == \
                jax_config.RECOVER_PROBE_TIMEOUT_S == 5.0
        return
    if name in ("RAFIKI_ADMIN_HA", "RAFIKI_ADMIN_ADDRS",
                "RAFIKI_ORPHAN_SURVIVE"):
        from rafiki_tpu import config as jax_config

        knobs = ("ADMIN_HA", "ADMIN_LEASE_TTL_S", "ADMIN_LEASE_RENEW_S",
                 "ADMIN_LEASE_ACQUIRE_TIMEOUT_S", "ADMIN_ADDRS",
                 "ADMIN_FAILOVER_TIMEOUT_S", "ADMIN_STANDBY_POLL_S",
                 "RECOVERY_REPORT_KEEP", "RECOVER_ADOPT",
                 "RECOVER_RETRY_MAX", "RECOVER_RETRY_BACKOFF_S")
        monkeypatch.delenv(name, raising=False)
        for knob in knobs:
            assert getattr(config, knob) == getattr(jax_config, knob), knob
        monkeypatch.setenv(name, value)
        if name == "RAFIKI_ADMIN_ADDRS":
            from rafiki_tpu.client.client import Client as JaxClient

            # a client built without a host and port walks the list
            assert Client()._addrs == JaxClient()._addrs == value.split(",")
            assert Client("10.0.0.9", 4000)._addrs == ["10.0.0.9:4000"]
        admin = Admin(db=Database(str(tmp_path / "s.sqlite3")),
                      placement=LocalPlacementManager(ChipAllocator(["cpu"])))
        try:
            if name == "RAFIKI_ADMIN_HA":
                # the admin took the lease before its first write
                assert admin.ha_role() == "leader"
                assert admin.db.read_lease()["epoch"] == 1
            else:
                assert admin.lease is None and admin.ha_role() == "leader"
        finally:
            admin.shutdown()
        if name == "RAFIKI_ADMIN_HA":
            # the shutdown released it: expired now, its epoch kept
            row = admin.db.read_lease()
            assert row["epoch"] == 1 and row["expires_at"] <= time.time()
        if name == "RAFIKI_ORPHAN_SURVIVE":
            # read by the train child (worker/bootstrap.py); an admin's
            # engine sets it on its train children, as JAX's does
            from rafiki_tpu.placement.process import (
                ProcessPlacementManager as JaxProcess,
            )
            from rafiki_tpu_torch.device import ServiceContext

            monkeypatch.delenv(name)
            pm = ProcessPlacementManager(
                db=Database(str(tmp_path / "s.sqlite3")),
                allocator=ChipAllocator(["cpu"]), orphan_survivable=True)
            pm.admin_addr = ("127.0.0.1", 1)
            jpm = JaxProcess(db=JaxDatabase(str(tmp_path / "j.sqlite3")),
                             allocator=jax_manager.ChipAllocator([0]),
                             admin_addr=("127.0.0.1", 1),
                             orphan_survivable=True)
            extra = {"sub_train_job_id": "sub"}
            ours = pm._child_env(ServiceContext(
                service_id="s", chips=["cpu"], service_type="TRAIN",
                extra=extra))
            theirs = jpm._child_env(jax_manager.ServiceContext(
                service_id="s", service_type="TRAIN", chips=[0],
                stop_event=None, extra=extra))
            assert ours[name] == theirs[name] == value
            pm.orphan_survivable = False
            assert name not in pm._child_env(ServiceContext(
                service_id="s", chips=["cpu"], service_type="TRAIN",
                extra=extra))
        return
    if name == "RAFIKI_DRIFT":
        from rafiki_tpu import config as jax_config

        knobs = ("DRIFT", "DRIFT_INTERVAL_S", "DRIFT_WINDOW_S",
                 "DRIFT_BASELINE_WINDOW_S", "DRIFT_MIN_SAMPLES",
                 "DRIFT_THRESHOLD", "DRIFT_CONF_DROP", "DRIFT_SKEW_DELTA",
                 "DRIFT_RETRAIN_BUDGET", "DRIFT_COOLDOWN_S",
                 "DRIFT_LAUNCH_RETRY_MAX")
        monkeypatch.delenv(name, raising=False)
        for knob in knobs:
            assert getattr(config, knob) == getattr(jax_config, knob), knob
        monkeypatch.setenv(name, value)
        admin = Admin(db=Database(":memory:"),
                      placement=LocalPlacementManager(ChipAllocator(["cpu"])))
        running = admin.drift.running  # the loop runs, and stops with it
        admin.shutdown()
        assert running and not admin.drift.running
        assert config.DRIFT is jax_config.DRIFT is True
        return
    if name == "RAFIKI_SANDBOX":
        from rafiki_tpu.sdk import sandbox as jax_sandbox
        from rafiki_tpu_torch.sdk import sandbox

        monkeypatch.delenv(name, raising=False)
        assert sandbox.sandbox_enabled() is jax_sandbox.sandbox_enabled() \
            is False
        assert sandbox.stall_deadline_s() == jax_sandbox.stall_deadline_s()
        monkeypatch.setenv(name, value)
        Admin(db=Database(":memory:"),
              placement=LocalPlacementManager(
                  ChipAllocator(["cpu"]))).shutdown()
        assert sandbox.sandbox_enabled() is jax_sandbox.sandbox_enabled() \
            is True
        return
    if name in ("RAFIKI_TRACE_SAMPLE", "RAFIKI_PROFILE"):
        from rafiki_tpu.utils import trace as jax_trace
        from rafiki_tpu_torch.utils import trace

        monkeypatch.delenv(name, raising=False)
        assert trace.sample_rate() == jax_trace.sample_rate() == 0.0
        assert trace.profiling_enabled() is \
            jax_trace.profiling_enabled() is False
        monkeypatch.setenv(name, value)
        Admin(db=Database(":memory:"),
              placement=LocalPlacementManager(
                  ChipAllocator(["cpu"]))).shutdown()
        assert trace.sample_rate() == jax_trace.sample_rate()
        assert trace.profiling_enabled() is jax_trace.profiling_enabled()
        assert (trace.sample_rate() == 0.5 if name == "RAFIKI_TRACE_SAMPLE"
                else trace.profiling_enabled())
        return
    if name == "RAFIKI_SERVE_INT8":
        from rafiki_tpu.sdk import quant as jax_quant
        from rafiki_tpu_torch.sdk import quant, torch_backend

        monkeypatch.delenv(name, raising=False)
        assert quant.serve_int8_enabled() is jax_quant.serve_int8_enabled() \
            is False
        monkeypatch.setenv(name, value)
        admin = Admin(db=Database(":memory:"),
                      placement=LocalPlacementManager(ChipAllocator(["cpu"])))
        admin.shutdown()
        assert quant.serve_int8_enabled() is jax_quant.serve_int8_enabled() \
            is True
        assert torch_backend.DataParallelTrainer(device="cpu").serve_int8
        return
    fleet = {
        "RAFIKI_AUTOSCALE": (
            "AUTOSCALE", "AUTOSCALE_INTERVAL_S", "AUTOSCALE_WINDOW_S",
            "AUTOSCALE_SHED_THRESHOLD", "AUTOSCALE_DEPTH_HIGH",
            "AUTOSCALE_DEPTH_LOW", "AUTOSCALE_MIN_REPLICAS",
            "AUTOSCALE_MAX_REPLICAS", "AUTOSCALE_STEP",
            "AUTOSCALE_COOLDOWN_UP_S", "AUTOSCALE_COOLDOWN_DOWN_S",
            "AUTOSCALE_DRAIN_S", "AUTOSCALE_TRAIN_FLOOR",
            "GEN_OCCUPANCY_HIGH", "ROLLOUT_CANARY_FRACTION",
            "ROLLOUT_JUDGE_WINDOW_S", "ROLLOUT_MIN_REQUESTS",
            "ROLLOUT_ERR_DELTA", "ROLLOUT_P95_FACTOR", "ROLLOUT_BATCH"),
        "RAFIKI_AUTOSCALE_FAIR": (
            "AUTOSCALE_FAIR", "AUTOSCALE_FAIR_WINDOW_S",
            "AUTOSCALE_FAIR_BURST", "AUTOSCALE_FAIR_WEIGHTS"),
        "RAFIKI_AUTOSCALE_WARM_POOL": (
            "AUTOSCALE_WARM_POOL", "AUTOSCALE_WARM_POOL_INTERVAL_S",
            "AUTOSCALE_WARM_RETRY_MAX", "AUTOSCALE_WARM_RETRY_COOLDOWN_S"),
    }
    if name in ("RAFIKI_GEN_SPEC", "RAFIKI_GEN_RESUME_MAX") or name in fleet:
        from rafiki_tpu import config as jax_config

        knobs = {"RAFIKI_GEN_SPEC": ("GEN_SPEC", "GEN_SPEC_K"),
                 "RAFIKI_GEN_RESUME_MAX": (
                     "GEN_RESUME_MAX", "GEN_RESUME_BACKOFF_S",
                     "GEN_JOURNAL_MAX_KB", "GEN_JOURNAL_TTL_S"),
                 **fleet}[name]
        monkeypatch.delenv(name, raising=False)
        for knob in knobs:
            assert getattr(config, knob) == getattr(jax_config, knob), knob
        monkeypatch.setenv(name, value)
        admin = Admin(db=Database(":memory:"),
                      placement=LocalPlacementManager(ChipAllocator(["cpu"])))
        # the loops a setting switches on run, and stop with the admin
        running = (admin.autoscaler.running, admin.warm_pool.running)
        admin.shutdown()
        assert running == (name == "RAFIKI_AUTOSCALE",
                           name == "RAFIKI_AUTOSCALE_WARM_POOL")
        assert not admin.autoscaler.running and not admin.warm_pool.running
        assert getattr(config, knobs[0]) == getattr(jax_config, knobs[0]) \
            == (int(value) if name in ("RAFIKI_GEN_RESUME_MAX",
                                       "RAFIKI_AUTOSCALE_WARM_POOL")
                else True)
        monkeypatch.setenv(name, "0")
        assert not getattr(config, knobs[0])
        return
    monkeypatch.setenv(name, value)
    with pytest.raises(NotPortedError, match=subsystem) as err:
        Admin(db=Database(":memory:"),
              placement=LocalPlacementManager(ChipAllocator(["cpu"])))
    assert err.value.setting == f"{name}={value}"


def test_predict_cache_setting_is_accepted_and_caches(tmp_path,
                                                      monkeypatch):
    """RAFIKI_PREDICT_CACHE=1 is ported (it was refused): the admin starts,
    and a repeated request through ``/predict/<app>`` is answered from the
    cache, with the first answer."""
    from rafiki_tpu_torch.predictor import result_cache

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
        first = admin.predict(uid, "a", [[0.5], [1.5]])
        second = admin.predict(uid, "a", [[0.5], [1.5]])
        assert second == first
        hits, misses = result_cache.get_cache().job_totals(inf["id"])
        assert (hits, misses) == (2, 2)
    finally:
        admin.shutdown()


@pytest.mark.parametrize("name,value", [("RAFIKI_PLACEMENT", "process"),
                                        ("RAFIKI_BROKER", "shm")])
def test_process_and_shm_settings_select_their_subsystems(
        monkeypatch, tmp_path, name, value):
    """RAFIKI_PLACEMENT=process makes every service a child process over
    the shm broker (forced); RAFIKI_BROKER=shm alone selects the shm
    broker under thread placement. Both were refused before they were
    ported."""
    monkeypatch.setenv(name, value)
    if value == "process":
        # the default allocator lists the visible cards: one, here
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        monkeypatch.delenv("RAFIKI_VISIBLE_DEVICES", raising=False)
        admin = Admin(db=Database(str(tmp_path / "store.sqlite3")))
    else:
        admin = Admin(db=Database(":memory:"),
                      placement=LocalPlacementManager(ChipAllocator(["cpu"])))
    try:
        assert isinstance(admin.broker, ShmBroker)
        if value == "process":
            assert isinstance(admin.placement, ProcessPlacementManager)
            assert admin.placement.broker is admin.broker
            assert admin.placement.db is admin.db
            assert admin.placement.allocator.total_chips == 1
        else:
            assert type(admin.placement) is LocalPlacementManager
    finally:
        admin.shutdown()
    assert not list(Path("/dev/shm").glob(f"{admin.broker.prefix}-*"))


def test_spent_time_budget_stops_the_job_before_any_trial(tmp_path):
    """TIME_HOURS=0: the deadline has passed when the worker starts, so the
    job STOPs with no trial, as in the JAX package."""
    admin = Admin(db=Database(":memory:"),
                  placement=LocalPlacementManager(ChipAllocator(["cpu"])),
                  params_dir=str(tmp_path))
    try:
        uid = admin.authenticate_user(config.SUPERADMIN_EMAIL,
                                      config.SUPERADMIN_PASSWORD)["user_id"]
        admin.create_model(uid, "fake", "IMAGE_CLASSIFICATION",
                           FAKE_TEMPLATE, "FakeModel")
        admin.create_train_job(uid, "a", "IMAGE_CLASSIFICATION", "t", "e",
                               budget={"MODEL_TRIAL_COUNT": 3,
                                       "TIME_HOURS": 0})
        job = admin.wait_until_train_job_stopped(uid, "a", timeout_s=60)
        assert job["status"] == "STOPPED"
        assert admin.get_trials_of_train_job(uid, "a") == []
    finally:
        admin.shutdown()


@pytest.mark.parametrize("call,budget", [
    ("train", {"CHIPS_PER_TRIAL": 2}), ("train", {"EARLY_STOP": 1}),
    ("train", {"TRIAL_TIMEOUT_S": 60}), ("train", {"TRIAL_VMAP_K": 4}),
    ("serve", {"CHIPS_PER_WORKER": 2}), ("serve", {"ENSEMBLE_FUSED": 1}),
    ("serve", {"GEN_DRAFT_TRIAL": "t1"}),
])
def test_unported_budget_keys_are_refused(tmp_path, call, budget):
    """Each of these budget keys was once refused with a 400 and is
    ported now: ``EARLY_STOP``, ``TRIAL_TIMEOUT_S``, ``CHIPS_PER_TRIAL``,
    ``TRIAL_VMAP_K``, ``CHIPS_PER_WORKER``, ``ENSEMBLE_FUSED`` and
    ``GEN_DRAFT_TRIAL``: their budgets are accepted or, for the draft,
    checked at deploy (a several-card ask clamps to this one-entry host),
    and a malformed value gets the JAX package's 400 word for word."""
    admin = Admin(db=Database(":memory:"),
                  placement=LocalPlacementManager(ChipAllocator(["cpu"])),
                  params_dir=str(tmp_path))
    try:
        uid = admin.authenticate_user(config.SUPERADMIN_EMAIL,
                                      config.SUPERADMIN_PASSWORD)["user_id"]
        admin.create_model(uid, "fake", "IMAGE_CLASSIFICATION",
                           FAKE_TEMPLATE, "FakeModel")
        (key,) = budget
        if call == "train":
            run = lambda b: admin.create_train_job(  # noqa: E731
                uid, "a", "IMAGE_CLASSIFICATION", "t", "e",
                budget={"MODEL_TRIAL_COUNT": 1, **b})
        else:
            admin.create_train_job(uid, "a", "IMAGE_CLASSIFICATION", "t",
                                   "e", budget={"MODEL_TRIAL_COUNT": 1})
            admin.wait_until_train_job_stopped(uid, "a", timeout_s=60)
            run = lambda b: admin.create_inference_job(  # noqa: E731
                uid, "a", budget=b)
        if key == "ENSEMBLE_FUSED":
            # ported: one fused worker holds the trial group
            for b in ({key: -1}, {key: "yes"}):
                with pytest.raises(InvalidRequestError) as ours:
                    run(b)
                assert str(ours.value) == _jax_budget_refusal(tmp_path, b)
            job = run(budget)
            assert job["budget"][key] == budget[key]
            assert len(job["workers"]) == 1
            assert admin.predict(uid, "a", [[0.0]])
            return
        if key == "GEN_DRAFT_TRIAL":
            # ported: checked at deploy, as in the JAX package; a draft
            # for a job that is not generative is a typed deploy error
            from rafiki_tpu_torch.admin.services import (
                ServiceDeploymentError,
            )

            with pytest.raises(ServiceDeploymentError,
                               match="GEN_DRAFT_TRIAL is only meaningful"):
                run(budget)
            jobs = admin.db.get_inference_jobs_by_statuses(
                ["STARTED", "RUNNING", "ERRORED"])
            assert [j["status"] for j in jobs] == ["ERRORED"]
            assert run({})["status"] == "RUNNING"
            return
        if key == "CHIPS_PER_WORKER":
            for b in ({key: 0}, {key: "two"}):
                with pytest.raises(InvalidRequestError) as ours:
                    run(b)
                assert str(ours.value) == _jax_budget_refusal(tmp_path, b)
            job = run(budget)
            assert job["budget"][key] == budget[key]
            assert [len(w["chips"]) for w in job["workers"]] == [1]
            return
        if key == "TRIAL_VMAP_K":
            # ported: read by the train worker (as in the JAX package, no
            # value is refused); a template with no population_spec runs
            # its trials scalar
            job = run(budget)
            assert job["budget"][key] == budget[key]
            admin.wait_until_train_job_stopped(uid, "a", timeout_s=60)
            (trial,) = admin.get_trials_of_train_job(uid, "a")
            assert trial["status"] == "COMPLETED"
            return
        if key in ("EARLY_STOP", "TRIAL_TIMEOUT_S", "CHIPS_PER_TRIAL"):
            bad = {"EARLY_STOP": [{"ASHA_ETA": 1}, {"ASHA_MIN_EPOCHS": 0}],
                   "TRIAL_TIMEOUT_S": [{"TRIAL_TIMEOUT_S": 0},
                                       {"TRIAL_TIMEOUT_S": "soon"}],
                   "CHIPS_PER_TRIAL": [{"CHIPS_PER_TRIAL": 0},
                                       {"CHIPS_PER_TRIAL": "two"}]}[key]
            for b in bad:
                with pytest.raises(InvalidRequestError) as ours:
                    run({**budget, **b})
                assert str(ours.value) == _jax_budget_refusal(
                    tmp_path, {**budget, **b})
            assert admin.db.get_train_jobs_of_user(uid) == []
            job = run(budget)
            assert job["budget"][key] == budget[key]
            admin.wait_until_train_job_stopped(uid, "a", timeout_s=60)
            (trial,) = admin.get_trials_of_train_job(uid, "a")
            assert trial["status"] == "COMPLETED"
            return
        raise AssertionError(f"no case for {key}")
    finally:
        admin.shutdown()


def _jax_budget_refusal(tmp_path, budget) -> str:
    """The JAX admin's 400 for a train job with ``budget``."""
    from rafiki_tpu.admin.admin import InvalidRequestError as JaxInvalid

    jax_admin = JaxAdmin(
        db=JaxDatabase(":memory:"),
        placement=jax_manager.LocalPlacementManager(
            allocator=jax_manager.ChipAllocator([0])),
        params_dir=str(tmp_path / "jax"))
    try:
        uid = jax_admin.authenticate_user(
            config.SUPERADMIN_EMAIL, config.SUPERADMIN_PASSWORD)["user_id"]
        jax_admin.create_model(uid, "fake", "IMAGE_CLASSIFICATION",
                               JAX_FAKE.read_bytes(), "FakeModel")
        with pytest.raises(JaxInvalid) as theirs:
            jax_admin.create_train_job(
                uid, "a", "IMAGE_CLASSIFICATION", "t", "e",
                budget={"MODEL_TRIAL_COUNT": 1, **budget})
        return str(theirs.value)
    finally:
        jax_admin.shutdown()


def test_chaos_rule_at_an_unhooked_site_is_refused(tmp_path, monkeypatch):
    """Every site but compile has its chaos hook (the trial, worker,
    generate, deploy, drift, db, lease, agent, call_agent, wire and cache
    sites): a rule naming compile, which stays with the JAX compile
    cache, raises NotPortedError when it is made, and a RAFIKI_CHAOS
    holding one refuses the admin's start, never silently inert; a rule
    at a hooked site passes."""
    from rafiki_tpu_torch.utils import chaos

    try:
        for site in ("trial", "worker", "generate", "deploy", "drift", "db",
                     "lease", "agent", "call_agent", "wire", "cache"):
            (rule,) = chaos.parse_rules(f"site={site};action=delay")
            assert rule.site == site
        assert set(chaos.SITES) - set(chaos.HOOKED_SITES) == {"compile"}
        for site in ("compile",):
            with pytest.raises(NotPortedError, match=f"site={site}"):
                chaos.parse_rules(f"site={site};action=delay")
            with pytest.raises(NotPortedError):
                chaos.install([chaos.ChaosRule(site=site, action="delay")])
        monkeypatch.setenv("RAFIKI_CHAOS",
                           "site=trial;action=error|site=compile;action=error")
        with pytest.raises(NotPortedError, match="site=compile"):
            chaos.hit(chaos.SITE_TRIAL, "sub trial")
        with pytest.raises(NotPortedError, match="site=compile"):
            Admin(db=Database(":memory:"),
                  placement=LocalPlacementManager(ChipAllocator(["cpu"])),
                  params_dir=str(tmp_path))
        monkeypatch.setenv("RAFIKI_CHAOS", "site=trial;action=error;times=1")
        assert chaos.hit(chaos.SITE_TRIAL, "sub trial").action == "error"
        assert chaos.hit(chaos.SITE_TRIAL, "sub trial") is None
    finally:
        chaos.clear()


def test_generation_is_refused_typed(tmp_path):
    """TEXT_GENERATION takes generation-capable templates only: a
    classification template uploaded under it is refused typed, and so
    is a generation train job with no capable model."""
    admin = Admin(db=Database(":memory:"),
                  placement=LocalPlacementManager(ChipAllocator(["cpu"])),
                  params_dir=str(tmp_path))
    try:
        uid = admin.authenticate_user(config.SUPERADMIN_EMAIL,
                                      config.SUPERADMIN_PASSWORD)["user_id"]
        with pytest.raises(InvalidModelClassError, match="TEXT_GENERATION"):
            admin.create_model(uid, "g", "TEXT_GENERATION", FAKE_TEMPLATE,
                               "FakeModel")
        with pytest.raises(InvalidRequestError, match="TEXT_GENERATION"):
            admin.create_train_job(uid, "g", "TEXT_GENERATION", "t", "e")
    finally:
        admin.shutdown()
