"""Vectorized population trials in the port, held against the JAX package.

- ``sdk/population.PopulationTrainer`` against ``rafiki_tpu.sdk.
  population.PopulationTrainer``: the same stacked weights, data and
  seed through both, with SGD and with AdamW (torch.optim with one
  parameter group a member), K=3 with a member at lr 0: each member's loss
  each epoch and each member's leaves after two epochs within
  ``F32_RTOL``; the lr-0 member bit for bit its init; ``member_scores``
  equal; a population of one logs ``loss`` and ``member0_loss``; a
  resumed fit ends where the uninterrupted one does; each member equals
  its own scalar ``DataParallelTrainer`` fit, with AdamW and with an
  optimizer optax's tests do not cover (RMSprop); a checkpoint of
  another member count is typed corruption and the fit starts fresh.
- ``worker/vmap_partition.py`` against JAX's on hypothesis-drawn knob
  lists.
- ``TorchCnn.train_population`` / ``evaluate_population`` /
  ``dump_member_parameters`` against ``JaxCnn``'s, and
  ``TorchCnnPopulation``'s winner and served answers against
  ``JaxCnnPopulation``'s, with both packages' compute type switched to
  f32 (``cast_for_compute``) inside the test.
- A train job of ``PopFixtureModel``'s twin (``POP_TEMPLATE`` below)
  through the port's admin against the JAX fixture's job through the JAX
  admin: ``MODEL_TRIAL_COUNT`` 5 at ``TRIAL_VMAP_K`` 2 fits members
  ``[2, 2, 1]`` in both; and the drills of ``tests/test_vmap_trials.py``:
  one member faulting alone, the kill switch, a scalar template
  unchanged, the per-member stop check.
"""

import importlib.util
import json
import logging
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from rafiki_tpu.admin.admin import Admin as JaxAdmin
from rafiki_tpu.db.database import Database as JaxDatabase
from rafiki_tpu.models import core as jcore
from rafiki_tpu.placement.manager import (
    ChipAllocator as JaxChipAllocator,
    LocalPlacementManager as JaxLocalPlacementManager,
)
from rafiki_tpu.sdk import jax_backend
from rafiki_tpu.sdk import population as jpopulation
from rafiki_tpu.sdk.log import ModelLogger as JaxModelLogger
from rafiki_tpu.worker import vmap_partition as jvmap
from rafiki_tpu_torch import config, convert
from rafiki_tpu_torch.admin.admin import Admin
from rafiki_tpu_torch.constants import TrialStatus
from rafiki_tpu_torch.db.database import Database
from rafiki_tpu_torch.device import set_device_grant
from rafiki_tpu_torch.models import core
from rafiki_tpu_torch.placement.manager import (
    ChipAllocator,
    LocalPlacementManager,
)
from rafiki_tpu_torch.sdk import population, torch_backend
from rafiki_tpu_torch.sdk.artifact import ArtifactCorruptError
from rafiki_tpu_torch.sdk.dataset import write_numpy_dataset
from rafiki_tpu_torch.sdk.log import ModelLogger
from rafiki_tpu_torch.sdk.model import (
    BaseModel,
    PopulationSpec,
    population_capability,
)
from rafiki_tpu_torch.worker import vmap_partition
from rafiki_tpu_torch.worker.train import TrainWorker

from test_torch_stack import FAKE_TEMPLATE

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples" / "models" / "image_classification"
TEMPLATES = ROOT / "rafiki_tpu_torch" / "templates"
POP_FIXTURE = ROOT / "tests" / "fixtures" / "pop_model.py"

#: f32 on both sides: the same products in another order (measured
#: 5.1e-7 absolute on the linear model's leaves, 1.1e-6 relative on its
#: losses)
F32_RTOL = 1e-5
F32_ATOL = 1e-6
#: the CNN's losses and leaves after two AdamW epochs in f32: a weight
#: with a gradient near 0 moves by about lr a step whatever its sign, so
#: rounding can move it a little more (measured 3.4e-6 relative L2)
CNN_RTOL = 1e-4
#: served probabilities of each package's own winner, f32: the two
#: winners' weights differ within CNN_RTOL (measured 1.2e-5)
PROB_ATOL = 1e-4

# the JAX trainers round a batch down to a multiple of the 8-device CPU
# mesh (tests/conftest.py): every batch here is such a multiple
N, DIM, CLASSES, BATCH = 96, 8, 3, 32


# -- the trainer ---------------------------------------------------------------

def _data(n=N, seed=0):
    rng = np.random.RandomState(seed)
    w = rng.randn(DIM, CLASSES)
    x = rng.randn(n, DIM).astype(np.float32)
    y = np.argmax(x @ w + 0.1 * rng.randn(n, CLASSES), axis=1).astype(
        np.int32)
    return x, y


def _member_trees(k, seed=5):
    rng = np.random.default_rng(seed)
    return [{"w": (0.3 * rng.standard_normal((DIM, CLASSES))).astype(
        np.float32), "b": (0.1 * rng.standard_normal(CLASSES)).astype(
            np.float32)} for _ in range(k)]


class Linear(torch.nn.Module):
    def __init__(self, tree, device="cpu"):
        super().__init__()
        self.w = torch.nn.Parameter(torch.tensor(tree["w"], device=device))
        self.b = torch.nn.Parameter(torch.tensor(tree["b"], device=device))

    def forward(self, x):
        return x @ self.w + self.b


def _jax_apply(params, x):
    return x @ params["w"] + params["b"]


OPTIMIZERS = {
    "sgd": (lambda: torch_backend.tunable_optimizer(torch.optim.SGD,
                                                    lr=0.01),
            lambda: jax_backend.tunable_optimizer(optax.sgd,
                                                  learning_rate=0.01)),
    "adamw": (lambda: torch_backend.tunable_optimizer(
        torch.optim.AdamW, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
        weight_decay=1e-4),
        lambda: jax_backend.tunable_optimizer(optax.adamw,
                                              learning_rate=1e-3)),
}
LRS = {"sgd": [0.0, 0.05, 0.2], "adamw": [0.0, 1e-2, 5e-2]}
#: optimizers held only against the port's own scalar trainer
PORT_ONLY = {"rmsprop": lambda: torch_backend.tunable_optimizer(
    torch.optim.RMSprop, lr=1e-3, momentum=0.5)}


def _port_trainer(kind):
    make = PORT_ONLY.get(kind) or OPTIMIZERS[kind][0]
    return population.PopulationTrainer(
        torch_backend.softmax_classifier_loss(lambda m, x: m(x)), make(),
        predict_fn=lambda m, x: torch.softmax(m(x), -1), device="cpu")


def _jax_trainer(kind):
    return jpopulation.PopulationTrainer(
        jax_backend.softmax_classifier_loss(_jax_apply), OPTIMIZERS[kind][1](),
        predict_fn=lambda p, x: jax.nn.softmax(_jax_apply(p, x), -1))


def _port_fit(kind, trees, lrs, epochs=2, **kw):
    t = _port_trainer(kind)
    params, opt = t.stack([Linear(tree) for tree in trees], {"lr": lrs})
    logs = []
    x, y = _data()
    t.fit(params, opt, (x, y), epochs=epochs, batch_size=BATCH, seed=7,
          log=lambda **m: logs.append(m), **kw)
    return t, params, logs


def _jax_fit(kind, trees, lrs, epochs=2):
    t = _jax_trainer(kind)
    it = iter(trees)
    params, opt = t.init(lambda key: jax.tree.map(jnp.asarray, next(it)),
                         {"learning_rate": lrs})
    logs = []
    x, y = _data()
    params, _ = t.fit(params, opt, (x, y), epochs=epochs, batch_size=BATCH,
                      seed=7, log=lambda **m: logs.append(m))
    return t, params, logs


def _stacked_tree(params):
    return {k[len("model."):]: v.detach().numpy()
            for k, v in params.params.items()}


@pytest.mark.parametrize("kind", ["sgd", "adamw"])
def test_population_fit_matches_jax(kind):
    trees = _member_trees(3)
    lrs = LRS[kind]
    t, params, logs = _port_fit(kind, trees, lrs)
    jt, jparams, jlogs = _jax_fit(kind, trees, lrs)
    assert [m["epoch"] for m in logs] == [0.0, 1.0]
    for ours, theirs in zip(logs, jlogs):
        for key in ["loss"] + [f"member{k}_loss" for k in range(3)]:
            np.testing.assert_allclose(ours[key], theirs[key],
                                       rtol=F32_RTOL, err_msg=key)
    ours = _stacked_tree(params)
    for name in ("w", "b"):
        np.testing.assert_allclose(ours[name], np.asarray(jparams[name]),
                                   rtol=F32_RTOL, atol=F32_ATOL,
                                   err_msg=name)
        # the lr-0 member is exactly its init; the others moved
        np.testing.assert_array_equal(ours[name][0], trees[0][name])
        assert not np.allclose(ours[name][2], trees[2][name])
    x, y = _data(seed=1)
    np.testing.assert_array_equal(
        t.member_scores(params, x, y, batch_size=40),
        jt.member_scores(jparams, x, y, batch_size=40))


@pytest.mark.parametrize("kind", ["adamw", "rmsprop"])
def test_each_member_is_its_own_scalar_fit(kind):
    """vmapping changes no member's arithmetic: each member equals a
    DataParallelTrainer fit of that member alone, through the same
    torch.optim update (one parameter group a member), whatever the
    optimizer."""
    trees = _member_trees(3)
    lrs = LRS["adamw"]
    _, params, _ = _port_fit(kind, trees, lrs)
    ours = _stacked_tree(params)
    x, y = _data()
    for k, tree in enumerate(trees):
        trainer = torch_backend.DataParallelTrainer(
            torch_backend.softmax_classifier_loss(lambda m, xb: m(xb)),
            PORT_ONLY.get(kind, OPTIMIZERS.get(kind, (None,))[0])(),
            device="cpu")
        model, opt = trainer.init(lambda rng: Linear(tree),
                                  hyperparams={"lr": lrs[k]})
        trainer.fit(model, opt, (x, y), epochs=2, batch_size=BATCH, seed=7)
        for name, p in model.named_parameters():
            np.testing.assert_allclose(ours[name][k], p.detach().numpy(),
                                       rtol=F32_RTOL, atol=F32_ATOL)


def test_a_population_of_one_logs_its_member():
    _, params, logs = _port_fit("sgd", _member_trees(1), [0.05], epochs=1)
    assert params.n_models == 1
    assert len(logs) == 1 and "loss" in logs[0] and "member0_loss" in logs[0]
    assert logs[0]["loss"] == logs[0]["member0_loss"]


def test_hyperparameter_lengths_and_names_are_checked():
    t = _port_trainer("sgd")
    with pytest.raises(ValueError, match="lengths differ"):
        t.init(lambda rng: Linear(_member_trees(1)[0]),
               {"lr": [0.1, 0.2], "momentum": [0.9]})
    with pytest.raises(ValueError, match="at least one"):
        t.init(lambda rng: Linear(_member_trees(1)[0]), {})
    with pytest.raises(KeyError, match="no hyperparam"):
        t.init(lambda rng: Linear(_member_trees(1)[0]), {"learning": [1.0]})
    # each member's group holds its own values, the rest the factory's
    _, opt = t.init(lambda rng: Linear(_member_trees(1)[0]),
                    {"lr": [0.1, 0.2], "momentum": [0.9, 0.0]})
    assert [(g["lr"], g["momentum"]) for g in opt.param_groups] == \
        [(0.1, 0.9), (0.2, 0.0)]


def test_stacked_trees_round_trip_in_the_jax_layout():
    """``convert.stacked_{from,to}_jax_tree``: a member-stacked JAX tree
    (HWIO kernels, the member axis leading every leaf) carried into a
    population's stacked parameters (OIHW) and back, exactly; member k's
    slice is ``to_jax_tree`` of member k's module."""
    twin = _load(TEMPLATES / "torch_cnn.py", "stack_torch_cnn")
    trees = [twin.init_params(np.random.default_rng([4, k]), 2, 8, 3, 5)
             for k in range(3)]
    stacked = jax.tree.map(lambda *xs: np.stack(xs), *trees)
    with torch.device("meta"):
        structure = twin.Cnn(2, 8, 3, 5)
    ours = convert.stacked_from_jax_tree(structure, stacked, "cpu")
    assert ours["stem.kernel"].shape == (3, 8, 3, 3, 3)
    back = convert.stacked_to_jax_tree(structure, ours)
    jax.tree.map(np.testing.assert_array_equal, back, stacked)
    for k, tree in enumerate(trees):
        with torch.device("meta"):
            member = twin.Cnn(2, 8, 3, 5)
        member = convert.from_jax_tree(member, tree, None, "cpu")
        for name, p in member.named_parameters():
            assert torch.equal(ours[name][k], p.detach()), name
    with pytest.raises(ValueError, match="does not fit"):
        convert.stacked_from_jax_tree(structure, {**stacked, "head": {
            "kernel": np.zeros((3, 4, 5), np.float32),
            "bias": np.zeros((3, 5), np.float32)}}, "cpu")


def test_members_draw_their_own_inits():
    t = _port_trainer("sgd")
    params, _ = t.init(lambda rng: Linear(
        {"w": rng.standard_normal((DIM, CLASSES)).astype(np.float32),
         "b": np.zeros(CLASSES, np.float32)}), {"lr": [0.1, 0.1]}, seed=3)
    w = params.params["model.w"]
    assert not torch.equal(w[0], w[1])
    np.testing.assert_array_equal(
        w[1].numpy(), np.random.default_rng([3, 1]).standard_normal(
            (DIM, CLASSES)).astype(np.float32))
    member = t.member_params(params, 1)
    assert isinstance(member, Linear) and torch.equal(member.w, w[1])


def test_checkpoint_resume_ends_where_the_fit_ends(tmp_path):
    trees = _member_trees(2)
    ckpt = str(tmp_path / "pop.ckpt")
    _, ref, _ = _port_fit("adamw", trees, [1e-2, 5e-2], epochs=4)
    _port_fit("adamw", trees, [1e-2, 5e-2], epochs=2, checkpoint_path=ckpt)
    _, resumed, logs = _port_fit("adamw", trees, [1e-2, 5e-2], epochs=4,
                                 checkpoint_path=ckpt)
    assert [m["epoch"] for m in logs] == [2.0, 3.0]
    for name, want in _stacked_tree(ref).items():
        np.testing.assert_array_equal(_stacked_tree(resumed)[name], want)


def test_a_checkpoint_of_another_member_count_is_typed_corruption(
        tmp_path, caplog):
    ckpt = str(tmp_path / "pop.ckpt")
    _port_fit("sgd", _member_trees(3), [0.01, 0.02, 0.03], epochs=1,
              checkpoint_path=ckpt)
    assert os.path.exists(ckpt)
    t = _port_trainer("sgd")
    params, opt = t.stack([Linear(tree) for tree in _member_trees(2)],
                          {"lr": [0.01, 0.02]})
    with pytest.raises(ArtifactCorruptError, match="3 member"):
        t._restore_checkpoint(ckpt, params, opt)
    with caplog.at_level(logging.WARNING,
                         logger="rafiki_tpu_torch.sdk.population"):
        t.fit(params, opt, _data(), epochs=1, batch_size=BATCH,
              checkpoint_path=ckpt)
    assert t.n_members(params) == 2
    assert any("corrupt" in r.message for r in caplog.records)


def test_fit_stats_count_the_members():
    population.reset_fit_stats()
    _port_fit("sgd", _member_trees(2), [0.1, 0.2], epochs=1)
    _port_fit("sgd", _member_trees(1), [0.1], epochs=1)
    assert population.FIT_STATS == {"fit_calls": 2, "member_counts": [2, 1],
                                    "completed_member_counts": [2, 1]}


def test_fit_stats_tell_a_fit_that_raised(monkeypatch):
    """A fit that raises counts as begun, not as completed: what a
    caller that re-runs the members scalar reads to tell the two apart."""
    population.reset_fit_stats()

    def broken(self, *args, **kw):
        raise RuntimeError("the step failed")

    monkeypatch.setattr(population.PopulationTrainer, "step", broken)
    with pytest.raises(RuntimeError, match="step failed"):
        _port_fit("sgd", _member_trees(2), [0.1, 0.2], epochs=1)
    assert population.FIT_STATS["member_counts"] == [2]
    assert population.FIT_STATS["completed_member_counts"] == []


# -- the partitioner ----------------------------------------------------------

_KNOB = st.fixed_dictionaries({
    "width": st.sampled_from([8, 16]), "act": st.sampled_from(["a", "b"]),
    "lr": st.floats(1e-4, 1e-1), "mom": st.sampled_from([0.0, 0.9])})


@settings(max_examples=60, deadline=None)
@given(knobs=st.lists(_KNOB, max_size=12),
       dynamic=st.sampled_from([("lr",), ("lr", "mom"), ("width", "lr")]),
       cap=st.integers(0, 4))
def test_partition_matches_jax(knobs, dynamic, cap):
    assert vmap_partition.partition_for_vmap(knobs, dynamic, cap) == \
        jvmap.partition_for_vmap(knobs, dynamic, cap)
    for k in knobs:
        assert vmap_partition.static_signature(k, dynamic) == \
            jvmap.static_signature(k, dynamic)


def test_population_capability_needs_the_three_methods():
    class Half(BaseModel):
        population_spec = PopulationSpec(dynamic_knobs=("lr",))
        get_knob_config = train = evaluate = predict = None
        dump_parameters = load_parameters = None

        def train_population(self, uri, knobs):
            pass

    class Whole(Half):
        def evaluate_population(self, uri):
            return []

        def dump_member_parameters(self, member):
            return {}

    assert population_capability(Half) is None
    assert population_capability(Whole) is Whole.population_spec
    with pytest.raises(ValueError):
        PopulationSpec(dynamic_knobs=())


# -- the templates --------------------------------------------------------------

def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture()
def f32(monkeypatch):
    """Both packages compute in f32, their trainer caches cleared before
    and after (a cached JAX trainer keeps its traced compute type)."""
    monkeypatch.setattr(jcore, "cast_for_compute",
                        lambda x, dtype=None: x.astype(jnp.float32))
    monkeypatch.setattr(core, "cast_for_compute",
                        lambda x, dtype=None: x.to(torch.float32))
    jax_backend.trainer_cache_clear()
    torch_backend.trainer_cache_clear()
    set_device_grant(["cpu"])
    yield
    set_device_grant(None)
    jax_backend.trainer_cache_clear()
    torch_backend.trainer_cache_clear()


def _images(tmp_path, n, size, classes=3, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, classes, size=n).astype(np.int32)
    x = (rng.normal(size=(n, size, size, 3)) + y[:, None, None, None]
         ).astype(np.float32)
    return (write_numpy_dataset(x, y, str(tmp_path / "train.npz")),
            write_numpy_dataset(x[: n // 4], y[: n // 4],
                                str(tmp_path / "test.npz")), x)


def _recording(logger_cls):
    """A logger of ``logger_cls`` and the metrics records it emits."""
    logger, records = logger_cls(), []
    logger.set_sink(lambda line: records.append(
        json.loads(line).get("metrics", {})))
    return logger, records


def _feed_inits(jax_model, trees):
    """The JAX template's init draws replaced by the port's trees, in
    member order."""
    it = iter(trees)
    jax_model._make_init = lambda cin, nc: (
        lambda key: jax.tree.map(jnp.asarray, next(it)))


CNN_KNOBS = {"epochs": 2, "num_stages": 2, "base_channels": 16,
             "batch_size": 64, "image_size": 8}


def _close_trees(ours, theirs, rtol):
    flat = jax.tree_util.tree_leaves_with_path(theirs)
    for path, leaf in flat:
        mine = ours
        for key in path:
            mine = mine[key.key]
        leaf = np.asarray(leaf)
        err = np.linalg.norm(np.asarray(mine) - leaf) / max(
            np.linalg.norm(leaf), 1e-12)
        assert err <= rtol, (jax.tree_util.keystr(path), err)


def test_torch_cnn_population_matches_jax_cnn(tmp_path, f32):
    twin = _load(TEMPLATES / "torch_cnn.py", "pop_torch_cnn")
    jmod = _load(EXAMPLES / "JaxCnn.py", "pop_jax_cnn")
    train, test, _ = _images(tmp_path, 192, 8)
    lrs = [1e-3, 3e-3, 1e-2]
    members = [dict(CNN_KNOBS, learning_rate=lr) for lr in lrs]
    trees = [twin.init_params(np.random.default_rng([0, k]), 2, 16, 3, 3)
             for k in range(3)]
    ours = twin.TorchCnn(**members[0])
    ours.logger, logs = _recording(ModelLogger)
    ours.train_population(train, members)
    theirs = jmod.JaxCnn(**members[0])
    _feed_inits(theirs, trees)
    theirs.logger, jlogs = _recording(JaxModelLogger)
    theirs.train_population(train, members)
    epochs = [m for m in jlogs if "member0_loss" in m]
    ours_epochs = [m for m in logs if "member0_loss" in m]
    assert len(epochs) == len(ours_epochs) == 2
    for a, b in zip(ours_epochs, epochs):
        for key in ["loss"] + [f"member{k}_loss" for k in range(3)]:
            np.testing.assert_allclose(a[key], b[key], rtol=CNN_RTOL)
    np.testing.assert_array_equal(ours.evaluate_population(test),
                                  theirs.evaluate_population(test))
    for k in range(3):
        mine = ours.dump_member_parameters(k)
        want = theirs.dump_member_parameters(k)
        assert mine["num_classes"] == want["num_classes"] == 3
        _close_trees(mine["params"], want["params"], CNN_RTOL)
    # a member serves through the unchanged load_parameters
    served = twin.TorchCnn(**members[1])
    served.load_parameters(ours.dump_member_parameters(1))
    jserved = jmod.JaxCnn(**members[1])
    jserved.load_parameters(theirs.dump_member_parameters(1))
    q = np.random.default_rng(3).normal(size=(5, 8, 8, 3)).tolist()
    np.testing.assert_allclose(served.predict(q), jserved.predict(q),
                               atol=1e-4)


def test_torch_cnn_population_template_matches_jax(tmp_path, f32):
    twin = _load(TEMPLATES / "torch_cnn_population.py", "pop_twin")
    jmod = _load(EXAMPLES / "JaxCnnPopulation.py", "pop_jax_twin")
    train, test, x = _images(tmp_path, 240, 32)
    knobs = {"epochs": 2, "base_channels": 16, "lr_min": 1e-3,
             "lr_max": 5e-2, "population_size": 4, "batch_size": 128,
             "image_size": 32}
    trees = [twin.init_params(np.random.default_rng([0, k]), 16, 3, 3)
             for k in range(4)]
    ours = twin.TorchCnnPopulation(**knobs)
    ours.logger, logs = _recording(ModelLogger)
    ours.train(train)
    theirs = jmod.JaxCnnPopulation(**knobs)
    _feed_inits(theirs, trees)
    theirs.logger, jlogs = _recording(JaxModelLogger)
    theirs.train(train)
    best = [m["best_member"] for m in jlogs if "best_member" in m]
    ours_best = [m["best_member"] for m in logs if "best_member" in m]
    assert ours_best == best and len(best) == 1
    assert ours._best_lr == pytest.approx(theirs._best_lr, rel=1e-12)
    assert ours.evaluate(test) == theirs.evaluate(test)
    dumped = ours.dump_parameters()
    _close_trees(dumped["params"], jax.tree.map(np.asarray,
                                                theirs._params), CNN_RTOL)
    served = twin.TorchCnnPopulation(**knobs)
    served.load_parameters(dumped)
    np.testing.assert_allclose(served.predict(x[:6].tolist()),
                               theirs.predict(x[:6].tolist()),
                               atol=PROB_ATOL)


# -- train jobs through the admin --------------------------------------------------

#: the twin of tests/fixtures/pop_model.py (PopFixtureModel): a linear
#: softmax classifier trained through PopulationTrainer on both paths
#: (a scalar trial is a population of one), so FIT_STATS records how the
#: worker batched a job. When the file named by RAFIKI_POPFIX_NAN_FILE
#: exists, evaluate_population consumes it and reports NaN for member 0
POP_TEMPLATE = b'''
import os

import numpy as np
import torch

from rafiki_tpu_torch.sdk.knob import FixedKnob, FloatKnob
from rafiki_tpu_torch.sdk.model import BaseModel, PopulationSpec
from rafiki_tpu_torch.sdk.population import PopulationTrainer
from rafiki_tpu_torch.sdk.torch_backend import (cached_trainer,
                                                softmax_classifier_loss,
                                                tunable_optimizer)

_DIM, _CLASSES = 8, 3


def _load(uri):
    with np.load(uri) as z:
        return z["x"].astype(np.float32), z["y"].astype(np.int32)


class _Linear(torch.nn.Module):
    def __init__(self, rng, device):
        super().__init__()
        w = 0.01 * rng.standard_normal((_DIM, _CLASSES))
        self.w = torch.nn.Parameter(torch.tensor(w, dtype=torch.float32,
                                                 device=device))
        self.b = torch.nn.Parameter(torch.zeros(_CLASSES, device=device))

    def forward(self, x):
        return x @ self.w + self.b


class PopFixtureModel(BaseModel):
    dependencies = {"numpy": None}

    population_spec = PopulationSpec(dynamic_knobs=("lr",), max_members=8)

    @staticmethod
    def get_knob_config():
        return {
            "lr": FloatKnob(1e-3, 1e-1, is_exp=True),
            "width": FixedKnob(_DIM),
            "fixed_knob": FixedKnob("fixed"),
        }

    def __init__(self, **knobs):
        super().__init__(**knobs)
        self._trainer = None
        self._pop_params = None
        self._params = None

    def _pop_trainer(self, n_members):
        return cached_trainer(("PopFixtureModel", n_members),
                              lambda: PopulationTrainer(
            softmax_classifier_loss(lambda m, x: m(x)),
            tunable_optimizer(torch.optim.SGD, lr=0.05),
            predict_fn=lambda m, x: torch.softmax(m(x), -1)))

    def _fit(self, dataset_uri, member_knobs):
        x, y = _load(dataset_uri)
        lrs = [float(k["lr"]) for k in member_knobs]
        self._trainer = self._pop_trainer(len(lrs))
        params, opt_state = self._trainer.init(
            lambda rng: _Linear(rng, self._trainer.device), {"lr": lrs},
            seed=0)
        params, _ = self._trainer.fit(
            params, opt_state, (x, y), epochs=1, batch_size=32,
            log=self.logger.log, checkpoint_path=self.checkpoint_path)
        self._pop_params = params

    def _member_scores(self, dataset_uri):
        x, y = _load(dataset_uri)
        return [float(s) for s in self._trainer.member_scores(
            self._pop_params, x, y)]

    def train(self, dataset_uri):
        self._fit(dataset_uri, [self._knobs])

    def evaluate(self, dataset_uri):
        return self._member_scores(dataset_uri)[0]

    def train_population(self, dataset_uri, member_knobs):
        self._fit(dataset_uri, member_knobs)

    def evaluate_population(self, dataset_uri):
        scores = self._member_scores(dataset_uri)
        sentinel = os.environ.get("RAFIKI_POPFIX_NAN_FILE")
        if sentinel and os.path.exists(sentinel):
            os.unlink(sentinel)  # consumed: one member ever faults
            scores[0] = float("nan")
        return scores

    def dump_member_parameters(self, member):
        return {k[len("model."):]: v[member].cpu().numpy()
                for k, v in self._pop_params.params.items()}

    def dump_parameters(self):
        return self.dump_member_parameters(0)

    def load_parameters(self, params):
        self._params = {k: np.asarray(v) for k, v in params.items()}

    def predict(self, queries):
        x = np.asarray(queries, np.float32)
        logits = x @ self._params["w"] + self._params["b"]
        e = np.exp(logits - logits.max(axis=-1, keepdims=True))
        return (e / e.sum(axis=-1, keepdims=True)).tolist()
'''


def write_pop_datasets(tmp_path):
    rng = np.random.default_rng(0)
    y = rng.integers(0, 3, size=96).astype(np.int32)
    x = (0.5 * rng.normal(size=(96, 8)) + y[:, None]).astype(np.float32)
    return (write_numpy_dataset(x, y, str(tmp_path / "train.npz")),
            write_numpy_dataset(x[:32], y[:32], str(tmp_path / "test.npz")))


@pytest.fixture()
def admin(tmp_path):
    a = Admin(db=Database(":memory:"),
              placement=LocalPlacementManager(ChipAllocator(["cpu"])),
              params_dir=str(tmp_path / "params"))
    yield a
    a.shutdown()


def _uid(a):
    return a.authenticate_user(config.SUPERADMIN_EMAIL,
                               config.SUPERADMIN_PASSWORD)["user_id"]


def _port_job(a, tmp_path, app, budget, template=POP_TEMPLATE,
              cls="PopFixtureModel"):
    uid = _uid(a)
    a.create_model(uid, app, "IMAGE_CLASSIFICATION", template, cls)
    train, test = write_pop_datasets(tmp_path)
    population.reset_fit_stats()
    a.create_train_job(uid, app, "IMAGE_CLASSIFICATION", train, test,
                       budget=budget)
    job = a.wait_until_train_job_stopped(uid, app, timeout_s=120)
    trials = a.get_trials_of_train_job(uid, app)
    job_id = a.db.get_train_job_by_app_version(uid, app, -1)["id"]
    (sub,) = a.db.get_sub_train_jobs_of_train_job(job_id)
    return job, trials, a.advisor_store.get(sub["id"]), uid


def test_a_job_batches_its_members_as_the_jax_job_does(admin, tmp_path,
                                                       monkeypatch):
    """MODEL_TRIAL_COUNT=5 at K=2: exactly 5 scored trials in both
    packages, fitted as batches [2, 2, 1], each member's score fed back
    alone and each member's parameters an artifact that serves."""
    monkeypatch.delenv("RAFIKI_TRIAL_VMAP", raising=False)
    budget = {"MODEL_TRIAL_COUNT": 5, "CHIP_COUNT": 1, "TRIAL_VMAP_K": 2}
    job, trials, advisor, uid = _port_job(admin, tmp_path, "vmapapp",
                                          budget)
    ours = dict(population.FIT_STATS)
    jadmin = JaxAdmin(db=JaxDatabase(":memory:"),
                      placement=JaxLocalPlacementManager(
                          allocator=JaxChipAllocator([0])),
                      params_dir=str(tmp_path / "jax_params"))
    try:
        jauth = jadmin.authenticate_user(config.SUPERADMIN_EMAIL,
                                         config.SUPERADMIN_PASSWORD)
        jadmin.create_model(jauth["user_id"], "popfix",
                            "IMAGE_CLASSIFICATION", POP_FIXTURE.read_bytes(),
                            "PopFixtureModel")
        jpopulation.reset_fit_stats()
        train, test = write_pop_datasets(tmp_path / "..")
        jadmin.create_train_job(jauth["user_id"], "vmapapp",
                                "IMAGE_CLASSIFICATION", train, test,
                                budget=budget)
        jjob = jadmin.wait_until_train_job_stopped(jauth["user_id"],
                                                   "vmapapp", timeout_s=120)
        jtrials = jadmin.get_trials_of_train_job(jauth["user_id"], "vmapapp")
    finally:
        jadmin.shutdown()
    assert job["status"] == jjob["status"] == "STOPPED"
    assert ours["member_counts"] == \
        jpopulation.FIT_STATS["member_counts"] == [2, 2, 1]
    assert ours["fit_calls"] == jpopulation.FIT_STATS["fit_calls"] == 3
    for rows in (trials, jtrials):
        assert len(rows) == 5
        assert all(t["status"] == TrialStatus.COMPLETED
                   and np.isfinite(t["score"]) for t in rows)
    assert len({round(float(t["knobs"]["lr"]), 12) for t in trials}) == 5
    assert advisor.observation_count == 5
    inf = admin.create_inference_job(uid, "vmapapp")
    assert inf["status"] == "RUNNING"
    (probs,) = admin.predict(uid, "vmapapp", [[0.5] * 8])
    assert len(probs) == 3 and abs(sum(probs) - 1) < 1e-5


def test_one_member_fault_is_isolated(admin, tmp_path, monkeypatch):
    monkeypatch.delenv("RAFIKI_TRIAL_VMAP", raising=False)
    sentinel = tmp_path / "nan_once"
    sentinel.write_text("poison member 0 of the first batch")
    monkeypatch.setenv("RAFIKI_POPFIX_NAN_FILE", str(sentinel))
    _, trials, advisor, _ = _port_job(
        admin, tmp_path, "nanapp",
        {"MODEL_TRIAL_COUNT": 4, "CHIP_COUNT": 1, "TRIAL_VMAP_K": 2})
    assert not sentinel.exists()  # the drill fired
    errored = [t for t in trials if t["status"] == TrialStatus.ERRORED]
    assert len(trials) == 4 and len(errored) == 1
    assert sum(t["status"] == TrialStatus.COMPLETED for t in trials) == 3
    assert errored[0]["fault_kind"] == "INVALID_SCORE"
    assert population.FIT_STATS["member_counts"] == [2, 2]
    assert advisor.observation_count == 3
    assert advisor.infeasible_count == 1


def test_the_kill_switch_forces_scalar_trials(admin, tmp_path, monkeypatch):
    monkeypatch.setenv("RAFIKI_TRIAL_VMAP", "0")
    _, trials, _, _ = _port_job(
        admin, tmp_path, "killapp",
        {"MODEL_TRIAL_COUNT": 2, "CHIP_COUNT": 1, "TRIAL_VMAP_K": 2})
    assert [t["status"] for t in trials] == [TrialStatus.COMPLETED] * 2
    assert population.FIT_STATS["member_counts"] == [1, 1]


def test_a_scalar_template_is_unchanged(admin, tmp_path, monkeypatch):
    monkeypatch.delenv("RAFIKI_TRIAL_VMAP", raising=False)
    _, trials, _, _ = _port_job(
        admin, tmp_path, "scalarapp", {"MODEL_TRIAL_COUNT": 3,
                                       "CHIP_COUNT": 1},
        template=FAKE_TEMPLATE, cls="FakeModel")
    assert [t["status"] for t in trials] == [TrialStatus.COMPLETED] * 3
    assert population.FIT_STATS["fit_calls"] == 0


def test_the_budgets_k_below_two_runs_scalar(admin, tmp_path, monkeypatch):
    monkeypatch.delenv("RAFIKI_TRIAL_VMAP", raising=False)
    _, trials, _, _ = _port_job(
        admin, tmp_path, "k1app",
        {"MODEL_TRIAL_COUNT": 2, "CHIP_COUNT": 1, "TRIAL_VMAP_K": 1})
    assert len(trials) == 2
    assert population.FIT_STATS["member_counts"] == [1, 1]


def test_the_population_stop_check_reports_each_member():
    """The drill of tests/test_vmap_trials.py through both packages'
    workers: one rung report a member under its own id, the batch stops
    only when every member's verdict says stop, a mean-only log reports
    the mean under each."""
    from rafiki_tpu.worker.train import TrainWorker as JaxTrainWorker

    class RungStore:
        def __init__(self, keep):
            self.keep = keep
            self.calls = []

        def report_rung(self, advisor_id, trial_id, resource, value,
                        min_resource=1, eta=3, mode="min"):
            self.calls.append((trial_id, resource, value))
            return trial_id in self.keep

    def build(worker_cls, logger_cls, keep):
        store = RungStore(keep)
        w = worker_cls("sub", db=None, advisor_store=store)
        w._early_stop = True
        w._asha_min, w._asha_eta = 1, 3
        w._job_deadline = w._trial_timeout_s = None
        tl = logger_cls()
        w._install_population_stop_check(tl, "aid", ["m0", "m1"])
        return store, tl._stop_check

    metrics = {"epoch": 0.0, "loss": 1.5,
               "member0_loss": 1.0, "member1_loss": 2.0}
    for keep, m in [({"m1"}, metrics), (set(), metrics),
                    ({"m0"}, {"epoch": 1.0, "loss": 0.7})]:
        ours, check = build(TrainWorker, ModelLogger, keep)
        theirs, jcheck = build(JaxTrainWorker, JaxModelLogger, keep)
        assert check(m) == jcheck(m)
        assert ours.calls == theirs.calls


def test_the_batch_drain_falls_back_for_a_store_without_it():
    class LegacyStore:
        def __init__(self):
            self.proposals = 0

        def propose(self, advisor_id):
            self.proposals += 1
            return {"lr": 0.01 * self.proposals}

    stub = LegacyStore()
    worker = TrainWorker("sub", db=None, advisor_store=stub)
    assert len(worker._propose_batch_clear_of_quarantine("aid", 3)) == 3
    assert stub.proposals == 3


# -- over ranks -----------------------------------------------------------------

def pop_rank_fit(trees, lrs, x, y):
    """Rank side: a two-epoch population fit on this rank's device; (the
    stacked tree, the logs, the member scores)."""
    t = population.PopulationTrainer(
        torch_backend.softmax_classifier_loss(lambda m, xb: m(xb)),
        OPTIMIZERS["adamw"][0](),
        predict_fn=lambda m, xb: torch.softmax(m(xb), -1))
    params, opt = t.stack([Linear(tree, t.device) for tree in trees],
                          {"lr": lrs})
    logs = []
    t.fit(params, opt, (x, y), epochs=2, batch_size=BATCH, seed=7,
          log=lambda **m: logs.append(m))
    tree = {k[len("model."):]: v.detach().cpu().numpy()
            for k, v in params.params.items()}
    return tree, logs, t.member_scores(params, x[:45], y[:45], batch_size=20)


def test_two_gloo_ranks_equal_one(monkeypatch):
    """Each rank holds every member, the batch is split over the ranks in
    order and each member's gradients are averaged over them: two ranks
    equal one rank's fit over the global batch (f32, F32_RTOL); the
    member scores pad each chunk to a multiple of the ranks."""
    from rafiki_tpu_torch.parallel import ranks

    monkeypatch.setenv("RAFIKI_DIST_TIMEOUT_S", "120")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    trees, lrs = _member_trees(3), LRS["adamw"]
    x, y = _data()
    with ranks.Ranks(["cpu:0", "cpu:1"]) as r:
        set_device_grant(r.devices)
        ranks.set_group(r.group)
        try:
            two = r.run(pop_rank_fit, trees, lrs, x, y)
        finally:
            ranks.set_group(None)
            set_device_grant(None)
    set_device_grant(["cpu:0"])
    try:
        one = pop_rank_fit(trees, lrs, x, y)
    finally:
        set_device_grant(None)
    (tree0, logs0, scores0), (tree1, _, scores1) = two
    for name, want in one[0].items():
        np.testing.assert_array_equal(tree0[name], tree1[name])
        np.testing.assert_allclose(tree0[name], want, rtol=F32_RTOL,
                                   atol=F32_ATOL)
    assert len(logs0) == len(one[1]) == 2
    for ours, theirs in zip(logs0, one[1]):
        for key in ["loss"] + [f"member{k}_loss" for k in range(3)]:
            np.testing.assert_allclose(ours[key], theirs[key],
                                       rtol=F32_RTOL)
    np.testing.assert_array_equal(scores0, one[2])
    np.testing.assert_array_equal(scores1, one[2])
