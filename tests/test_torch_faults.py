"""The port's trial fault taxonomy against the JAX package's, on the CPU.

- Pure functions: ``classify_failure`` (a ``torch.cuda.OutOfMemoryError``
  on the port's side against XLA's ``RESOURCE_EXHAUSTED`` ``RuntimeError``
  on JAX's: both USER), ``knob_signature`` and
  ``poison_signature_counts`` give the same kinds, details, strings and
  counts.
- The advisor: ``BayesOpt`` and ``Advisor`` with infeasible points give
  identical proposals (exact knob values; unit-cube points within
  1e-12); ``AdvisorStore``'s ``replay_feedback``, ``feedback_infeasible``
  and ``report_rung`` give the same returns and states; the remote round
  trip through the port's ``AdminServer``.
- The drills of ``tests/test_trial_faults.py`` (less the sandbox and the
  doctor) through both packages' ``TrainWorker`` on the JAX fake
  template and its port twin, or on one small template written for both:
  equal trial rows (status, ``fault_kind``, ``attempt``, count) and
  events.
"""

import re
import sqlite3
import threading
import time

import numpy as np
import pytest
import torch

from rafiki_tpu.admin.admin import Admin as JaxAdmin
from rafiki_tpu.advisor.advisor import Advisor as JaxAdvisor
from rafiki_tpu.advisor.advisor import AdvisorStore as JaxStore
from rafiki_tpu.advisor.advisor import RandomAdvisor as JaxRandomAdvisor
from rafiki_tpu.advisor.gp import BayesOpt as JaxBayesOpt
from rafiki_tpu.db.database import Database as JaxDatabase
from rafiki_tpu.placement import manager as jax_manager
from rafiki_tpu.sdk import knob as jax_knob
from rafiki_tpu.utils import chaos as jax_chaos
from rafiki_tpu.worker import faults as jax_faults
from rafiki_tpu.worker import train as jax_train
from rafiki_tpu_torch import config
from rafiki_tpu_torch.admin.admin import Admin
from rafiki_tpu_torch.admin.http import AdminServer
from rafiki_tpu_torch.advisor.advisor import (
    Advisor,
    AdvisorStore,
    RandomAdvisor,
)
from rafiki_tpu_torch.advisor.gp import BayesOpt
from rafiki_tpu_torch.advisor.remote import RemoteAdvisorStore
from rafiki_tpu_torch.client.client import Client, RafikiError
from rafiki_tpu_torch.db.database import Database
from rafiki_tpu_torch.device import ServiceContext
from rafiki_tpu_torch.placement.manager import (
    ChipAllocator,
    LocalPlacementManager,
)
from rafiki_tpu_torch.sdk import knob
from rafiki_tpu_torch.utils import chaos
from rafiki_tpu_torch.worker import faults, train
from rafiki_tpu_torch.worker.faults import FaultKind

pytestmark = pytest.mark.chaos

PORT_IMPORTS = ("from rafiki_tpu_torch.sdk.knob import (CategoricalKnob, "
                "FixedKnob, FloatKnob,\n    IntegerKnob)\n"
                "from rafiki_tpu_torch.sdk.model import BaseModel")
JAX_IMPORTS = ("from rafiki_tpu.sdk import (BaseModel, CategoricalKnob, "
               "FixedKnob, FloatKnob,\n    IntegerKnob)")

# tests/fixtures/fake_model.py, the four knobs of every type
FAKE = '''
import random

{imports}


class FakeModel(BaseModel):
    dependencies = {{"numpy": None}}

    @staticmethod
    def get_knob_config():
        return {{
            "int_knob": IntegerKnob(1, 32),
            "float_knob": FloatKnob(1e-4, 1e-1, is_exp=True),
            "cat_knob": CategoricalKnob(["a", "b", "c"]),
            "fixed_knob": FixedKnob("fixed"),
        }}

    def __init__(self, **knobs):
        super().__init__(**knobs)
        self._params = None

    def train(self, dataset_uri):
        self.logger.log(metric=1.0, step=0.0)
        self._params = {{"weight": [1.0, 2.0]}}

    def evaluate(self, dataset_uri):
        return random.random()

    def predict(self, queries):
        return [[0.5, 0.5] for _ in queries]

    def dump_parameters(self):
        return self._params

    def load_parameters(self, params):
        self._params = params
'''


def _template(cls: str, knobs: str, train: str, evaluate: str) -> str:
    return f'''
{{imports}}


class {cls}(BaseModel):
    @staticmethod
    def get_knob_config():
        return {knobs}

    def __init__(self, **knobs):
        super().__init__(**knobs)

    def train(self, uri):
        {train}

    def evaluate(self, uri):
        return {evaluate}

    def predict(self, queries):
        return queries

    def dump_parameters(self):
        return {{{{}}}}

    def load_parameters(self, p):
        pass
'''


ALWAYS_RAISES = _template("Broken", '{{"lr": FloatKnob(1e-4, 1e-1)}}',
                          'raise RuntimeError("poison template: always '
                          'crashes")', "0.0")
NAN_SCORE = _template("NanModel", '{{"lr": FloatKnob(1e-4, 1e-1)}}', "pass",
                      'float("nan")')
FIXED_ONLY = _template("Fixed", '{{"k": FixedKnob(1)}}', "pass", "0.5")


class _Pkg:
    """One package's pieces the drills need."""

    def __init__(self, port: bool):
        self.port = port
        self.Database = Database if port else JaxDatabase
        self.AdvisorStore = AdvisorStore if port else JaxStore
        self.train = train if port else jax_train
        self.faults = faults if port else jax_faults
        self.imports = PORT_IMPORTS if port else JAX_IMPORTS

    def ctx(self, service_id: str):
        if self.port:
            return ServiceContext(service_id=service_id, chips=["cpu"],
                                  service_type="TRAIN",
                                  stop_event=threading.Event())
        return jax_manager.ServiceContext(
            service_id=service_id, service_type="TRAIN", chips=[],
            stop_event=threading.Event())


PKGS = (_Pkg(True), _Pkg(False))


@pytest.fixture(autouse=True)
def _clean_state():
    for mod in (faults, jax_faults):
        mod.reset_stats()
    for mod in (chaos, jax_chaos):
        mod.clear()
    yield
    for mod in (faults, jax_faults):
        mod.reset_stats()
    for mod in (chaos, jax_chaos):
        mod.clear()


def _seed_job(pkg: _Pkg, db, source=FAKE, cls="FakeModel", budget=None):
    user = db.create_user("u@x", "h", "APP_DEVELOPER")
    model = db.create_model(user["id"], "m", "IMAGE_CLASSIFICATION",
                            source.format(imports=pkg.imports).encode(), cls,
                            {"numpy": None}, "PUBLIC")
    job = db.create_train_job(user["id"], "app", 1, "IMAGE_CLASSIFICATION",
                              "uri://t", "uri://e",
                              budget or {"MODEL_TRIAL_COUNT": 3})
    sub = db.create_sub_train_job(job["id"], model["id"])
    return job, sub, model


def _rows(db, sub_id):
    trials = sorted(db.get_trials_of_sub_train_job(sub_id),
                    key=lambda t: t["datetime_started"])
    return [(t["status"], t["fault_kind"], t["attempt"]) for t in trials]


def _drill(pkg: _Pkg, tmp_path, source=FAKE, cls="FakeModel", budget=None,
           before=None, service_id="svc-1"):
    """Run one worker to its end; (rows, event names, the job, the
    advisor store, the sub-train-job id, the stats, the fault details)."""
    db = pkg.Database(":memory:")
    job, sub, model = _seed_job(pkg, db, source, cls, budget)
    if before is not None:
        before(db, sub, model)
    events, store = [], pkg.AdvisorStore()
    worker = pkg.train.TrainWorker(
        sub["id"], db, store,
        send_event=lambda name, payload: events.append((name, payload)),
        params_dir=str(tmp_path / ("port" if pkg.port else "jax")))
    worker.start(pkg.ctx(service_id))
    details = [t["fault_detail"] for t in db.get_trials_of_sub_train_job(
        sub["id"])]
    out = (_rows(db, sub["id"]), events, db.get_train_job(job["id"]),
           store, sub["id"], pkg.faults.training_stats().get(sub["id"]),
           details)
    db.close()
    return out


def _both(tmp_path, **kw):
    return [_drill(pkg, tmp_path, **kw) for pkg in PKGS]


# -- the pure functions -------------------------------------------------------

def _caught(exc):
    """Classify ``exc`` where the worker does, inside its except block."""
    try:
        raise exc
    except BaseException as e:  # noqa: BLE001
        return e


def _exceptions(port: bool):
    f = faults if port else jax_faults
    return [
        ValueError("bad shape"), RuntimeError("boom"), KeyError("x"),
        MemoryError("host"), sqlite3.OperationalError("database is locked"),
        f.TrialChaosError("chaos"), f.InvalidScoreError("nan"),
        *[f.TrialFault("typed", kind=k) for k in FaultKind.ALL],
        f.TrialFault("untyped kind", kind="NOT_A_KIND"),
        # a device OOM: PyTorch's on the port, XLA's on JAX
        (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate "
                                     "238.00 GiB") if port else
         RuntimeError("RESOURCE_EXHAUSTED: Out of memory while trying to "
                      "allocate 238.00G")),
    ]


def test_classify_failure_gives_the_same_kinds_and_details():
    ours = [faults.classify_failure(_caught(e)) for e in _exceptions(True)]
    theirs = [jax_faults.classify_failure(_caught(e))
              for e in _exceptions(False)]
    assert [k for k, _ in ours] == [k for k, _ in theirs]
    assert [k for k, _ in ours] == [
        "USER", "USER", "USER", "MEM", "INFRA", "INFRA", "INVALID_SCORE",
        *FaultKind.ALL, "USER", "USER"]
    for (_, a), (_, b), e in zip(ours[:-1], theirs[:-1], _exceptions(True)):
        # the same first line, and the same traceback of _caught
        assert a.splitlines()[0] == b.splitlines()[0]
        assert len(a) <= faults.FAULT_DETAIL_MAX
    assert ours[-1][1].startswith("OutOfMemoryError: CUDA out of memory")
    assert isinstance(_exceptions(True)[-1], RuntimeError)
    assert not isinstance(_exceptions(True)[-1], MemoryError)


def test_validate_score_is_the_same_gate():
    for raw in (0.5, 1, "0.25", np.float32(0.75)):
        assert faults.validate_score(raw) == jax_faults.validate_score(raw)
    for raw in (float("nan"), float("inf"), "x", None, [1.0]):
        with pytest.raises(faults.InvalidScoreError) as ours:
            faults.validate_score(raw)
        with pytest.raises(jax_faults.InvalidScoreError) as theirs:
            jax_faults.validate_score(raw)
        assert str(ours.value) == str(theirs.value)
        assert ours.value.kind == FaultKind.INVALID_SCORE


def _configs():
    ours = {"i": knob.IntegerKnob(1, 32),
            "f": knob.FloatKnob(1e-4, 1e-1, is_exp=True),
            "g": knob.FloatKnob(0.0, 1.0),
            "c": knob.CategoricalKnob(["a", "b", "c"]),
            "x": knob.FixedKnob("fixed")}
    theirs = {"i": jax_knob.IntegerKnob(1, 32),
              "f": jax_knob.FloatKnob(1e-4, 1e-1, is_exp=True),
              "g": jax_knob.FloatKnob(0.0, 1.0),
              "c": jax_knob.CategoricalKnob(["a", "b", "c"]),
              "x": jax_knob.FixedKnob("fixed")}
    return ours, theirs


def _seeded_rows(seed: int, n: int):
    rng = np.random.default_rng(seed)
    statuses = ["ERRORED", "COMPLETED", "RUNNING", "TERMINATED"]
    kinds = [None, *FaultKind.ALL]
    rows = []
    for _ in range(n):
        knobs = {"i": int(rng.integers(1, 33)),
                 "f": float(10 ** rng.uniform(-4, -1)),
                 "g": float(rng.choice([0.1, 0.12, 0.5, rng.random()])),
                 "c": str(rng.choice(["a", "b", "c"])), "x": "fixed"}
        rows.append({"status": statuses[int(rng.integers(0, 2))
                                        if rng.random() < 0.8
                                        else int(rng.integers(0, 4))],
                     "fault_kind": kinds[int(rng.integers(0, len(kinds)))],
                     "knobs": knobs})
    return rows


@pytest.mark.parametrize("seed", range(4))
def test_signatures_and_poison_counts_match(seed):
    ours_cfg, theirs_cfg = _configs()
    rows = _seeded_rows(seed, 200)
    for r in rows:
        assert faults.knob_signature(ours_cfg, r["knobs"]) == \
            jax_faults.knob_signature(theirs_cfg, r["knobs"])
        assert faults.is_infeasible_row(r) == jax_faults.is_infeasible_row(r)
    ours = faults.poison_signature_counts(rows, ours_cfg)
    theirs = jax_faults.poison_signature_counts(rows, theirs_cfg)
    assert ours == theirs and sum(ours.values()) > 10
    assert faults.quarantined_signatures(rows, ours_cfg, 2) == \
        jax_faults.quarantined_signatures(rows, theirs_cfg, 2)
    # no config, and a knob shape the config cannot encode: the JSON form
    odd = {"i": "not-an-int"}
    assert faults.knob_signature(None, rows[0]["knobs"]) == \
        jax_faults.knob_signature(None, rows[0]["knobs"])
    assert faults.knob_signature(ours_cfg, odd) == \
        jax_faults.knob_signature(theirs_cfg, odd)


def test_training_stats_keep_the_same_keys():
    for f in (faults, jax_faults):
        f.record_fault("s", "USER")
        f.record_fault("s", "INFRA", retried=True)
        f.record_quarantine("s", ["u:1", "u:0"])
        f.record_counter("s", "reproposals")
        f.record_counter("s", "consecutive_user_faults", 4, absolute=True)
    assert faults.training_stats() == jax_faults.training_stats()
    for i in range(faults._STATS_CAP + 3):
        faults.record_counter(f"sub{i}", "reproposals")
    assert len(faults.training_stats()) == faults._STATS_CAP
    assert "s" not in faults.training_stats()  # least recently updated


# -- the advisor ----------------------------------------------------------------

@pytest.mark.parametrize("dims", [1, 3])
def test_bayes_opt_with_infeasible_points_proposes_the_same(dims):
    rng = np.random.default_rng(dims)
    opts = [BayesOpt(dims, seed=7), JaxBayesOpt(dims, seed=7)]
    for step in range(14):
        for opt in opts:
            opt.rng = np.random.default_rng([7, step])
        xs = [opt.suggest() for opt in opts]
        np.testing.assert_allclose(xs[0], xs[1], rtol=0, atol=1e-12)
        x = xs[0]
        if step % 3 == 2:
            for opt in opts:
                opt.mark_infeasible(x)
        else:
            y = float(-((x - 0.3) ** 2).sum() + 0.01 * rng.standard_normal())
            for opt in opts:
                opt.observe(x, y)
    for _ in range(600):  # the cap drops the oldest
        u = rng.random(dims)
        for opt in opts:
            opt.mark_infeasible(u)
    assert len(opts[0].infeasible_X) == len(opts[1].infeasible_X) <= 512
    np.testing.assert_array_equal(np.array(opts[0].infeasible_X),
                                  np.array(opts[1].infeasible_X))
    assert opts[0]._infeasible_cells == opts[1]._infeasible_cells


def test_gp_steers_away_from_infeasible_regions():
    opt = BayesOpt(dims=1, seed=7)
    for x, y in [(0.1, 0.2), (0.2, 0.4), (0.3, 0.6), (0.4, 0.7), (0.5, 0.8)]:
        opt.observe(np.array([x]), y)
    for _ in range(3):
        opt.mark_infeasible(np.array([0.9]))
    assert len(opt.infeasible_X) == 1  # one grid cell
    for _ in range(10):
        assert abs(float(opt.suggest(register_pending=False)[0]) - 0.9) > 0.05
    warm = BayesOpt(dims=1, seed=3)
    for _ in range(3):
        warm.mark_infeasible(np.array([0.5]))
    for _ in range(10):
        assert abs(float(warm.suggest(register_pending=False)[0]) - 0.5) > 0.2


def test_advisor_with_infeasible_feedback_proposes_the_same_knobs():
    ours_cfg, theirs_cfg = _configs()
    advisors = [Advisor(ours_cfg, seed=3), JaxAdvisor(theirs_cfg, seed=3)]
    for step in range(12):
        proposals = [a.propose() for a in advisors]
        assert proposals[0] == proposals[1]
        for a in advisors:
            if step % 4 == 1:
                a.feedback_infeasible(proposals[0], "USER")
            else:
                a.feedback(proposals[0], float(proposals[0]["g"]))
    assert [a.infeasible_count for a in advisors] == [3, 3]
    assert [a.observation_count for a in advisors] == [9, 9]
    randoms = [RandomAdvisor(ours_cfg), JaxRandomAdvisor(theirs_cfg)]
    for a in randoms:
        a.feedback_infeasible({"i": 1}, "USER")
        a.feedback_infeasible({"i": 1}, "MEM")
    assert [a.infeasible_count for a in randoms] == [2, 2]


def _store_script(store, cfg, behind=None, missing=KeyError):
    """One seeded sequence of the store's new calls; its returns and the
    sessions' states, read from ``behind`` (the store behind a door)."""
    behind = behind or store
    out = []
    a = store.create_advisor(cfg, advisor_id="a")
    b = store.create_advisor(cfg, advisor_id="b")
    out.append(store.replay_feedback(
        a, [({"i": 4, "f": 1e-2, "g": 0.5, "c": "a", "x": "fixed"}, 0.5)],
        infeasible=[({"i": 9, "f": 5e-2, "g": 0.9, "c": "b", "x": "fixed"},
                     "TIMEOUT")]))
    out.append(store.replay_feedback(a, [], infeasible=[]))
    out.append(store.feedback_infeasible(
        b, {"i": 2, "f": 1e-3, "g": 0.1, "c": "c", "x": "fixed"}))
    out.append(store.replay_feedback(
        b, [], infeasible=[({"i": 2, "f": 1e-3, "g": 0.1, "c": "c",
                             "x": "fixed"}, "USER")]))
    out.append([store.report_rung(a, t, r, v, eta=2) for t, r, v in (
        ("t1", 1, 0.3), ("dead", 1, 0.01), ("t2", 1, 0.2), ("t3", 1, 0.5))])
    out.append(store.feedback_infeasible(
        a, {"i": 30, "f": 9e-2, "g": 0.99, "c": "a", "x": "fixed"},
        kind="INVALID_SCORE", trial_id="dead"))
    out.append([store.report_rung(a, t, r, v, eta=2) for t, r, v in (
        ("t4", 1, 0.25), ("t5", 1, 0.29), ("t1", 2, 0.2))])
    out.append([store.propose(a) for _ in range(4)])
    for aid in (a, b):
        adv = behind.get(aid)
        out.append((adv.observation_count, adv.infeasible_count,
                    [x.tolist() for x in adv._opt.infeasible_X]))
    out.append({r: dict(v) for r, v in behind._schedulers[a]._rungs.items()})
    store.delete_advisor(a)
    out.append(sorted(behind._schedulers))
    with pytest.raises(missing):
        store.replay_feedback(a, [])
    return out


def test_advisor_store_calls_give_the_same_returns_and_states():
    ours_cfg, theirs_cfg = _configs()
    ours = _store_script(AdvisorStore(), ours_cfg)
    theirs = _store_script(JaxStore(), theirs_cfg)
    assert ours == theirs
    assert ours[:4] == [True, False, 1, False]
    assert "dead" not in ours[-2][1]


def test_remote_advisor_round_trip(tmp_path, monkeypatch):
    """Infeasible feedback, replay and rung reports through the port's
    door give what the in-process store gives."""
    # a deleted session answers 500, as in the JAX package: not ridden out
    monkeypatch.setenv("RAFIKI_ADVISOR_RETRY_S", "0")
    admin = Admin(db=Database(":memory:"),
                  placement=LocalPlacementManager(ChipAllocator(["cpu"])),
                  params_dir=str(tmp_path))
    srv = AdminServer(admin, port=0).start()
    try:
        c = Client("127.0.0.1", srv.port)
        c.login(config.SUPERADMIN_EMAIL, config.SUPERADMIN_PASSWORD)
        remote = RemoteAdvisorStore(c)
        cfg, _ = _configs()
        assert _store_script(remote, cfg, behind=admin.advisor_store,
                             missing=RafikiError) == \
            _store_script(AdvisorStore(), cfg)
        aid = remote.create_advisor(cfg, advisor_id="c")
        remote.get(aid).feedback_infeasible(
            {"i": 2, "f": 1e-3, "g": 0.1, "c": "c", "x": "fixed"})
        assert admin.advisor_store.get(aid).infeasible_count == 1
        # the fault-limit event a process-placed worker relays
        job, sub, _ = _seed_job(PKGS[0], admin.db)
        admin.db.mark_train_job_as_running(job["id"])
        c.send_event(train.EVENT_TRIAL_FAULT_LIMIT,
                     train_job_id=job["id"], sub_train_job_id=sub["id"],
                     fault_kind="USER", reason="drill: broken template")
        row = admin.db.get_train_job(job["id"])
        assert (row["status"], row["fault_kind"], row["error_reason"]) == (
            "ERRORED", "USER", "drill: broken template")
    finally:
        srv.stop()
        admin.shutdown()


# -- the drills -----------------------------------------------------------------

def test_infra_chaos_retry_preserves_budget(tmp_path, monkeypatch):
    monkeypatch.setenv("RAFIKI_CHAOS", "site=trial;action=error;times=1")
    monkeypatch.setenv("RAFIKI_TRIAL_RETRY_BACKOFF_S", "0.01")
    ours, theirs = _both(tmp_path)
    assert ours[0] == theirs[0] == [("COMPLETED", "INFRA", 1),
                                    ("COMPLETED", None, 0),
                                    ("COMPLETED", None, 0)]
    assert [n for n, _ in ours[1]] == [n for n, _ in theirs[1]] == [
        train.EVENT_BUDGET_REACHED]
    assert ours[5]["retries"] == theirs[5]["retries"] == 1


def test_chaos_oom_is_mem_and_errors_when_retry_disabled(tmp_path,
                                                          monkeypatch):
    monkeypatch.setenv("RAFIKI_CHAOS", "site=trial;action=oom;times=1")
    monkeypatch.setenv("RAFIKI_TRIAL_RETRY_MAX", "0")
    ours, theirs = _both(tmp_path, budget={"MODEL_TRIAL_COUNT": 2})
    assert ours[0] == theirs[0] == [("ERRORED", "MEM", 0),
                                    ("COMPLETED", None, 0)]
    assert all("MemoryError" in d for d in ours[6] if d)


def test_retry_bound_exhausts_then_errors(tmp_path, monkeypatch):
    monkeypatch.setenv("RAFIKI_CHAOS", "site=trial;action=error")
    monkeypatch.setenv("RAFIKI_TRIAL_RETRY_MAX", "2")
    monkeypatch.setenv("RAFIKI_TRIAL_RETRY_BACKOFF_S", "0.01")
    ours, theirs = _both(tmp_path, budget={"MODEL_TRIAL_COUNT": 1})
    assert ours[0] == theirs[0] == [("ERRORED", "INFRA", 2)]


def test_poison_template_fails_the_job_fast_with_its_reason(tmp_path,
                                                            monkeypatch):
    monkeypatch.setenv("RAFIKI_TRIAL_FAULT_LIMIT", "4")
    ours, theirs = _both(tmp_path, source=ALWAYS_RAISES, cls="Broken",
                         budget={"MODEL_TRIAL_COUNT": 50})
    assert ours[0] == theirs[0] == [("ERRORED", "USER", 0)] * 4
    assert "poison template: always crashes" in ours[6][0]
    for out in (ours, theirs):
        assert (out[2]["status"], out[2]["fault_kind"]) == ("ERRORED",
                                                           "USER")
        assert "RAFIKI_TRIAL_FAULT_LIMIT=4" in out[2]["error_reason"]
    assert [re.sub("[0-9a-f]{32}", "<id>", out[2]["error_reason"])
            for out in (ours, theirs)] == [
        re.sub("[0-9a-f]{32}", "<id>", theirs[2]["error_reason"])] * 2
    assert [n for n, _ in ours[1]] == [n for n, _ in theirs[1]] == [
        train.EVENT_TRIAL_FAULT_LIMIT]
    assert train.EVENT_TRIAL_FAULT_LIMIT == jax_train.EVENT_TRIAL_FAULT_LIMIT
    assert set(ours[1][0][1]) == set(theirs[1][0][1])
    assert ours[1][0][1]["fault_kind"] == "USER"


def test_nan_score_is_invalid_and_fed_as_infeasible(tmp_path, monkeypatch):
    monkeypatch.setenv("RAFIKI_TRIAL_FAULT_LIMIT", "0")
    ours, theirs = _both(tmp_path, source=NAN_SCORE, cls="NanModel",
                         budget={"MODEL_TRIAL_COUNT": 2})
    assert ours[0] == theirs[0] == [("ERRORED", "INVALID_SCORE", 0)] * 2
    assert ours[3].get(ours[4]).infeasible_count == \
        theirs[3].get(theirs[4]).infeasible_count >= 1


def test_quarantine_reproposes_and_survives_a_restart(tmp_path,
                                                      monkeypatch):
    """Two recorded USER faults quarantine the one signature of a
    FixedKnob-only space at startup; every proposal matches it, so the
    bounded re-proposal loop runs out and accepts."""
    monkeypatch.setenv("RAFIKI_TRIAL_QUARANTINE_K", "2")
    monkeypatch.setenv("RAFIKI_TRIAL_REPROPOSE_MAX", "3")
    monkeypatch.setenv("RAFIKI_TRIAL_FAULT_LIMIT", "0")

    def before(db, sub, model):
        for _ in range(2):
            t = db.create_trial(sub["id"], model["id"], {"k": 1},
                                worker_id="dead-worker")
            db.mark_trial_as_errored(t["id"], "USER", "boom")

    ours, theirs = _both(tmp_path, source=FIXED_ONLY, cls="Fixed",
                         budget={"MODEL_TRIAL_COUNT": 3}, before=before)
    assert ours[0] == theirs[0] == [("ERRORED", "USER", 0)] * 2 + [
        ("COMPLETED", None, 0)]
    assert ours[5]["quarantined"] == theirs[5]["quarantined"] == ["u:"]
    # 3 re-proposals for each of two slots: the completed trial's and the
    # proposal the spent budget then refuses
    assert ours[5]["reproposals"] == theirs[5]["reproposals"] == 6


def test_terminal_mem_feeds_infeasible_without_the_streak(tmp_path,
                                                          monkeypatch):
    monkeypatch.setenv("RAFIKI_CHAOS", "site=trial;action=oom")
    monkeypatch.setenv("RAFIKI_TRIAL_RETRY_MAX", "0")
    monkeypatch.setenv("RAFIKI_TRIAL_FAULT_LIMIT", "2")
    ours, theirs = _both(tmp_path)
    assert ours[0] == theirs[0] == [("ERRORED", "MEM", 0)] * 3
    assert ours[2]["status"] == theirs[2]["status"] != "ERRORED"
    assert ours[3].get(ours[4]).infeasible_count == \
        theirs[3].get(theirs[4]).infeasible_count >= 1
    assert ours[5]["consecutive_user_faults"] == 0


class _DeadAdvisorStore:
    """Every call fails: an unreachable admin, forever."""

    def get(self, advisor_id):
        raise ConnectionError("advisor unreachable")


def test_pending_feedback_is_bounded_dropping_the_oldest(tmp_path,
                                                         monkeypatch):
    monkeypatch.setenv("RAFIKI_PENDING_FEEDBACK_MAX", "5")
    kept = []
    for pkg in PKGS:
        worker = pkg.train.TrainWorker("sub-x", pkg.Database(":memory:"),
                                       _DeadAdvisorStore(),
                                       params_dir=str(tmp_path))
        for i in range(12):
            worker._feedback_best_effort("aid", {"lr": i}, float(i))
        kept.append(([k["lr"] for k, _ in worker._pending_feedback],
                     pkg.faults.training_stats()["sub-x"]["feedback_dropped"]))
    assert kept[0] == kept[1] == ([7, 8, 9, 10, 11], 7)


def test_admin_handles_the_fault_limit_event(tmp_path):
    admins = [
        Admin(db=Database(":memory:"),
              placement=LocalPlacementManager(ChipAllocator(["cpu"])),
              params_dir=str(tmp_path / "port")),
        JaxAdmin(db=JaxDatabase(":memory:"),
                 placement=jax_manager.LocalPlacementManager(
                     allocator=jax_manager.ChipAllocator([0])),
                 params_dir=str(tmp_path / "jax"))]
    rows = []
    try:
        for pkg, admin in zip(PKGS, admins):
            job, sub, _ = _seed_job(pkg, admin.db)
            admin.db.mark_train_job_as_running(job["id"])
            admin.handle_event(pkg.train.EVENT_TRIAL_FAULT_LIMIT, {
                "train_job_id": job["id"], "sub_train_job_id": sub["id"],
                "fault_kind": "USER", "reason": "drill: broken template"})
            row = admin.db.get_train_job(job["id"])
            rows.append((row["status"], row["fault_kind"],
                         row["error_reason"]))
    finally:
        for admin in admins:
            admin.shutdown()
    assert rows[0] == rows[1] == ("ERRORED", "USER",
                                  "drill: broken template")


OOM_PROBE = """
import weakref

import torch

{imports}


class Oom(BaseModel):
    HELD = []  # weak references to each trial's big tensor

    @staticmethod
    def get_knob_config():
        return {{"k": FixedKnob(1)}}

    def train(self, uri):
        big = torch.ones(1 << 20)
        cycle = {{"big": big}}
        cycle["self"] = cycle  # a cycle only the collector frees
        type(self).HELD.append(weakref.ref(big))
        raise torch.cuda.OutOfMemoryError("CUDA out of memory (drill)")

    def evaluate(self, uri):
        return 0.0

    def predict(self, queries):
        return queries

    def dump_parameters(self):
        return {{}}

    def load_parameters(self, p):
        pass
"""


def test_a_device_oom_trial_frees_its_memory_before_the_next(tmp_path,
                                                             monkeypatch):
    """A template whose train() raises PyTorch's OutOfMemoryError while
    its frames hold a tensor in a reference cycle: the trial is USER, and
    the worker has dropped the failing frames and collected the cycle
    before the next trial starts, as it must on the card."""
    classes = []
    load = train.load_model_class

    def load_and_keep(*args, **kw):
        classes.append(load(*args, **kw))
        return classes[-1]

    seen = []
    real = train.TrainWorker._run_trial

    def run_trial(self, *args, **kw):
        seen.append([r() is None for r in classes[0].HELD])
        return real(self, *args, **kw)

    monkeypatch.setattr(train, "load_model_class", load_and_keep)
    monkeypatch.setattr(train.TrainWorker, "_run_trial", run_trial)
    monkeypatch.setenv("RAFIKI_TRIAL_FAULT_LIMIT", "0")
    db = Database(":memory:")
    job, sub, model = _seed_job(PKGS[0], db, OOM_PROBE, "Oom",
                                {"MODEL_TRIAL_COUNT": 3})
    train.TrainWorker(sub["id"], db, AdvisorStore(),
                      params_dir=str(tmp_path)).start(PKGS[0].ctx("svc"))
    assert _rows(db, sub["id"]) == [("ERRORED", "USER", 0)] * 3
    assert "OutOfMemoryError: CUDA out of memory" in \
        db.get_trials_of_sub_train_job(sub["id"])[0]["fault_detail"]
    assert seen == [[], [True], [True, True]]
    db.close()


def test_stop_mid_backoff_terminates_the_trial(tmp_path, monkeypatch):
    """A stop that lands while a retry waits ends the trial TERMINATED,
    without another attempt, in both packages."""
    monkeypatch.setenv("RAFIKI_CHAOS", "site=trial;action=error")
    monkeypatch.setenv("RAFIKI_TRIAL_RETRY_BACKOFF_S", "30")
    # the jitter's draw at its ceiling: the wait is the full 30 s
    monkeypatch.setattr(train.random, "uniform", lambda lo, hi: hi)
    rows = []
    for pkg in PKGS:
        db = pkg.Database(":memory:")
        job, sub, _ = _seed_job(pkg, db)
        ctx = pkg.ctx("svc")
        worker = pkg.train.TrainWorker(sub["id"], db, pkg.AdvisorStore(),
                                       params_dir=str(tmp_path))
        t = threading.Thread(target=worker.start, args=(ctx,))
        t.start()
        deadline = time.time() + 30
        while time.time() < deadline and not any(
                r["attempt"] for r in db.get_trials_of_sub_train_job(
                    sub["id"])):
            time.sleep(0.02)
        ctx.stop_event.set()
        t.join(30)
        assert not t.is_alive()
        rows.append(_rows(db, sub["id"]))
        chaos.clear()
        jax_chaos.clear()
    assert rows[0] == rows[1] == [("TERMINATED", "INFRA", 1)]
