"""The port's ASHA early stopping against the JAX package's, on the CPU.

- ``AshaScheduler``: the same report sequences, drawn from numpy seeds
  and by hypothesis over the mode, eta, the minimum resource, sparse
  reporters and ``forget``, give identical verdicts and rung populations
  in both packages.
- ``AdvisorStore.report_rung``: one scheduler a session (a caller with
  other parameters keeps the live ladder), dropped with the session.
- The stack: an ``EARLY_STOP`` job truncates bad trials, and a
  ``TRIAL_TIMEOUT_S`` job a runaway one, through both packages' ``Admin``
  on the same probe templates, with equal trial rows.
"""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from rafiki_tpu.admin.admin import Admin as JaxAdmin
from rafiki_tpu.advisor.advisor import AdvisorStore as JaxStore
from rafiki_tpu.advisor.asha import AshaScheduler as JaxAsha
from rafiki_tpu.db.database import Database as JaxDatabase
from rafiki_tpu.placement import manager as jax_manager
from rafiki_tpu.sdk.knob import FloatKnob as JaxFloatKnob
from rafiki_tpu_torch import config
from rafiki_tpu_torch.admin.admin import Admin
from rafiki_tpu_torch.advisor.advisor import AdvisorStore
from rafiki_tpu_torch.advisor.asha import AshaScheduler
from rafiki_tpu_torch.db.database import Database
from rafiki_tpu_torch.placement.manager import (
    ChipAllocator,
    LocalPlacementManager,
)
from rafiki_tpu_torch.sdk.knob import FloatKnob

# an op: ("report", trial, resource, value) or ("forget", trial)


def _replay(sched, ops):
    out = []
    for op in ops:
        if op[0] == "forget":
            sched.forget(op[1])
            out.append(None)
        else:
            out.append(sched.report(op[1], op[2], op[3]))
    return out, {r: dict(v) for r, v in sched._rungs.items()}


def _both(ops, **kw):
    ours = _replay(AshaScheduler(**kw), ops)
    theirs = _replay(JaxAsha(**kw), ops)
    assert ours == theirs
    return ours[0]


def _numpy_ops(seed: int, n_trials: int, epochs: int, sparse: bool):
    """Trials reporting in interleaved order, each its per-epoch losses
    (some NaN, some every other epoch), with forgets between."""
    rng = np.random.default_rng(seed)
    cursors = {f"t{i}": 0 for i in range(n_trials)}
    step = {t: (2 if sparse and rng.random() < 0.5 else 1) for t in cursors}
    ops = []
    while cursors:
        t = rng.choice(sorted(cursors))
        cursors[t] += step[t]
        if cursors[t] > epochs:
            del cursors[t]
            continue
        value = float(rng.lognormal())
        if rng.random() < 0.03:
            value = float("nan")
        ops.append(("report", t, cursors[t], value))
        if rng.random() < 0.05:
            ops.append(("forget", t))
    return ops


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("mode", ["min", "max"])
def test_numpy_sequences_give_identical_verdicts(seed, mode):
    ops = _numpy_ops(seed, n_trials=8, epochs=12, sparse=seed % 2 == 1)
    verdicts = _both(ops, min_resource=1 + seed % 2, eta=2 + seed % 3,
                     mode=mode)
    assert False in verdicts and True in verdicts


@settings(max_examples=60, deadline=None)
@given(mode=st.sampled_from(["min", "max"]),
       eta=st.integers(2, 4), min_resource=st.integers(1, 3),
       ops=st.lists(st.one_of(
           st.tuples(st.just("report"), st.sampled_from("abcdef"),
                     st.integers(1, 20),
                     st.one_of(st.floats(-5, 5),
                               st.sampled_from([float("nan"),
                                                float("inf")]))),
           st.tuples(st.just("forget"), st.sampled_from("abcdef"))),
           max_size=60))
def test_hypothesis_sequences_give_identical_verdicts(mode, eta,
                                                      min_resource, ops):
    _both(ops, min_resource=min_resource, eta=eta, mode=mode)


def test_the_jax_unit_cases_hold_in_the_port():
    s = AshaScheduler(min_resource=1, eta=3)
    assert s._rungs_reached(9) == [1, 3, 9]
    assert s.report("t1", 1, 0.1) and s.report("t2", 1, 0.2)
    assert not s.report("t3", 1, 9.0)
    assert s.report("t1", 3, 0.05)
    m = AshaScheduler(min_resource=1, eta=2, mode="max")
    assert m.report("a", 1, 0.9) and m.report("b", 1, 0.95)
    assert not m.report("c", 1, 0.1)
    assert not m.report("d", 1, float("nan"))
    late = AshaScheduler(min_resource=1, eta=3)
    assert late.report("resumed", 9, 0.001)  # records only at rung 9
    assert not late._rungs.get(1)
    with pytest.raises(ValueError):
        AshaScheduler(eta=1)
    with pytest.raises(ValueError):
        AshaScheduler(mode="median")


def test_store_report_rung_matches_and_keeps_its_ladder(caplog):
    cfg, jcfg = {"lr": FloatKnob(0.1, 1.0)}, {"lr": JaxFloatKnob(0.1, 1.0)}
    stores = [(AdvisorStore(), cfg), (JaxStore(), jcfg)]
    calls = [("t1", 1, 0.3, 2), ("t2", 1, 0.2, 2), ("t3", 1, 5.0, 2),
             ("t4", 1, 0.1, 3), ("t4", 2, 0.05, 3), ("t1", 2, 0.4, 2)]
    results = []
    for store, c in stores:
        aid = store.create_advisor(c, advisor_id="sub1")
        results.append([store.report_rung(aid, t, r, v, eta=eta)
                        for t, r, v, eta in calls])
        sched = store._schedulers[aid]
        assert (sched.min_resource, sched.eta, sched.mode) == (1, 2, "min")
        store.delete_advisor(aid)
        with pytest.raises(KeyError):
            store.report_rung(aid, "t5", 1, 0.1)
        assert aid not in store._schedulers
    assert results[0] == results[1] == [True, True, False, True, True,
                                        False]
    assert "differ from session sub1's live scheduler" in caplog.text


# -- the stack --------------------------------------------------------------

ASHA_PROBE = '''
{imports}

_TRIAL_COUNTER = [0]


class AshaProbe(BaseModel):
    """Each successive trial logs a strictly worse per-epoch loss."""

    dependencies = {{"numpy": None}}

    @staticmethod
    def get_knob_config():
        return {{"epochs": FixedKnob(4), "lr": FloatKnob(0.001, 0.1)}}

    def __init__(self, **knobs):
        super().__init__(**knobs)
        self._params = None

    def train(self, dataset_uri):
        _TRIAL_COUNTER[0] += 1
        loss = float(_TRIAL_COUNTER[0])
        for epoch in range(4):
            self._params = {{"w": [loss], "epochs_done": epoch + 1}}
            self.logger.log(loss=loss, epoch=float(epoch))

    def evaluate(self, dataset_uri):
        return 1.0 / self._params["w"][0]

    def predict(self, queries):
        return [[1.0] for _ in queries]

    def dump_parameters(self):
        return self._params

    def load_parameters(self, params):
        self._params = params
'''

SLOW_PROBE = '''
import time

{imports}


class SlowModel(BaseModel):
    """Logs a metric every 0.2 s for up to 50 epochs."""

    dependencies = {{"numpy": None}}

    @staticmethod
    def get_knob_config():
        return {{"epochs": FixedKnob(50), "lr": FloatKnob(0.001, 0.1)}}

    def __init__(self, **knobs):
        super().__init__(**knobs)
        self._params = {{"epochs_done": 0}}

    def train(self, dataset_uri):
        for epoch in range(50):
            time.sleep(0.2)
            self._params = {{"epochs_done": epoch + 1}}
            self.logger.log(loss=1.0, epoch=float(epoch))

    def evaluate(self, dataset_uri):
        return float(self._params["epochs_done"])

    def predict(self, queries):
        return [[1.0] for _ in queries]

    def dump_parameters(self):
        return self._params

    def load_parameters(self, params):
        self._params = params
'''

PORT_IMPORTS = ("from rafiki_tpu_torch.sdk.knob import FixedKnob, FloatKnob\n"
                "from rafiki_tpu_torch.sdk.model import BaseModel")
JAX_IMPORTS = "from rafiki_tpu.sdk import BaseModel, FixedKnob, FloatKnob"


def _run_job(port: bool, tmp_path, source: str, cls: str, budget: dict):
    if port:
        admin = Admin(db=Database(":memory:"),
                      placement=LocalPlacementManager(ChipAllocator(["cpu"])),
                      params_dir=str(tmp_path / "port"))
        body = source.format(imports=PORT_IMPORTS)
    else:
        admin = JaxAdmin(db=JaxDatabase(":memory:"),
                         placement=jax_manager.LocalPlacementManager(
                             allocator=jax_manager.ChipAllocator([0])),
                         params_dir=str(tmp_path / "jax"))
        body = source.format(imports=JAX_IMPORTS)
    try:
        uid = admin.authenticate_user(config.SUPERADMIN_EMAIL,
                                      config.SUPERADMIN_PASSWORD)["user_id"]
        admin.create_model(uid, "probe", "IMAGE_CLASSIFICATION",
                           body.encode(), cls)
        admin.create_train_job(uid, "app", "IMAGE_CLASSIFICATION", "uri://t",
                               "uri://e", budget={"CHIP_COUNT": 1, **budget})
        admin.wait_until_train_job_stopped(uid, "app", timeout_s=60)
        trials = sorted(admin.get_trials_of_train_job(uid, "app"),
                        key=lambda t: t["datetime_started"])
        epochs = [sum(1 for m in admin.get_trial_logs(t["id"])["metrics"]
                      if "loss" in m) for t in trials]
        return [(t["status"], t["score"]) for t in trials], epochs
    finally:
        admin.shutdown()


def test_stack_early_stop_truncates_bad_trials(tmp_path):
    """Trial 1 sets the rung bar and runs 4 epochs; trials 2-3 log
    strictly worse losses and stop at the first rung, in both stacks."""
    budget = {"MODEL_TRIAL_COUNT": 3, "EARLY_STOP": 1, "ASHA_ETA": 2}
    ours = _run_job(True, tmp_path, ASHA_PROBE, "AshaProbe", budget)
    theirs = _run_job(False, tmp_path, ASHA_PROBE, "AshaProbe", budget)
    assert ours == theirs
    assert ours[1] == [4, 1, 1]
    assert [s for s, _ in ours[0]] == ["COMPLETED"] * 3


def test_trial_timeout_truncates_a_runaway_trial(tmp_path):
    """TRIAL_TIMEOUT_S=1 stops a 50-epoch, 10 s trial after ~5 epochs: it
    completes with its partial score, in both stacks."""
    budget = {"MODEL_TRIAL_COUNT": 1, "TRIAL_TIMEOUT_S": 1.0}
    for port in (True, False):
        (row,), (epochs,) = _run_job(port, tmp_path, SLOW_PROBE,
                                     "SlowModel", budget)
        assert row[0] == "COMPLETED"
        assert 1 <= row[1] <= 15 and row[1] == epochs
