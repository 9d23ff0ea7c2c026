"""Fused ensembles (budget ``ENSEMBLE_FUSED``): the port against the JAX
package, after ``tests/test_fused_ensemble.py``.

- K1's vmap rule on CPU tensors: ``vmap(flash_attention)`` over T
  stacked trials equals a loop over them, folds the trials into one call
  (one call of the plain version a layer in a stacked BERT forward with
  the flash path on) and copies nothing where the stacked projection's
  strides merge;
- ``trainer_ensemble_stack``: a 2-trial tiny ``TorchBert`` (two layers,
  width 64, two heads) and a tiny ``TorchCnn``, each given the same
  weights as their JAX twins, answer per trial as JAX's
  ``trainer_ensemble_stack(...).predict_all`` does (tolerances below), and
  as each model alone; it is None for a stateful group (``TorchResNet``)
  and for different architectures;
- ``_FusedEnsembleModel``: a raising hook falls back to serving the
  models one after another, as JAX's does;
- the admin: the fused deploy shape (one unit of the whole group,
  ``fused_dispatch`` in the stats row), fused answers equal to the
  unfused deploy's on the same trials, and ``TEXT_GENERATION`` with
  ``ENSEMBLE_FUSED`` a typed ``ServiceDeploymentError``.
"""

import importlib
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import rafiki_tpu_torch
from rafiki_tpu.worker.inference import _FusedEnsembleModel as JaxFused
from rafiki_tpu_torch import config
from rafiki_tpu_torch.admin.admin import Admin
from rafiki_tpu_torch.admin.services import ServiceDeploymentError
from rafiki_tpu_torch.db.database import Database
from rafiki_tpu_torch.device import set_device_grant
from rafiki_tpu_torch.models import bert
from rafiki_tpu_torch.placement.manager import (
    ChipAllocator,
    LocalPlacementManager,
)
from rafiki_tpu_torch.sdk import torch_backend
from rafiki_tpu_torch.sdk.dataset import write_numpy_dataset
from rafiki_tpu_torch.templates import torch_cnn
from rafiki_tpu_torch.templates.torch_bert import TorchBert
from rafiki_tpu_torch.templates.torch_cnn import TorchCnn
from rafiki_tpu_torch.worker.inference import (
    _FusedEnsembleModel,
    serving_stats,
)

from test_torch_stack import FAKE_TEMPLATE

ROOT = Path(rafiki_tpu_torch.__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples" / "models"
fa = importlib.import_module("rafiki_tpu_torch.ops.flash_attention")

#: probabilities of the bf16 BERT forwards of the two packages (as
#: tests/test_torch_text.py holds them)
BERT_PROB_ATOL = 2.5e-2
#: probabilities of the CNN: its activations are bf16 (its logits are
#: held at 2e-2 in tests/test_torch_zoo.py), and the stacked forward runs
#: the convolutions batched over the trials, so rounded in another order
#: than each trial's own (measured 4.1e-4 at most)
CNN_PROB_ATOL = 2e-3
#: the port's stacked forward against its own models one by one
SELF_ATOL = 1e-5

BERT_KNOBS = {"depth": 2, "heads": 2, "dim": 64, "learning_rate": 1e-3,
              "epochs": 1, "batch_size": 16, "max_len": 16, "vocab": 256}
CNN_KNOBS = dict(epochs=1, num_stages=2, base_channels=16,
                 learning_rate=1e-3, batch_size=64, image_size=8)


@pytest.fixture(autouse=True)
def _cpu_grant():
    set_device_grant(["cpu"])
    yield
    set_device_grant(None)


def _load(path: Path):
    spec = importlib.util.spec_from_file_location(
        f"fused_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# -- K1 under vmap ---------------------------------------------------------------


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_vmapped_flash_attention_equals_a_loop_over_the_trials(causal,
                                                               dtype):
    t, b, h, s, dh = 3, 2, 2, 40, 16
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(t, b, s, h * dh, generator=gen).to(dtype)
    ws = [torch.randn(t, h * dh, h, dh, generator=gen).to(dtype) * 0.2
          for _ in range(3)]

    def project(xt, wq, wk, wv):
        return [torch.einsum("bsd,dhk->bhsk", xt, w) for w in (wq, wk, wv)]

    with torch.inference_mode():
        q, k, v = torch.func.vmap(project)(x, *ws)
        copies = fa.flash_attention.vmap_copies
        out = torch.func.vmap(
            lambda a, bb, c: fa.flash_attention(a, bb, c, causal))(q, k, v)
        assert fa.flash_attention.vmap_copies == copies  # folded as views
        for i in range(t):
            ref = fa.flash_attention(q[i], k[i], v[i], causal)
            assert torch.equal(out[i], ref)
        # a layout that cannot fold is copied, and still right
        qt = q.transpose(0, 1).contiguous().transpose(0, 1)
        out2 = torch.func.vmap(
            lambda a, bb, c: fa.flash_attention(a, bb, c, causal))(qt, k, v)
        assert fa.flash_attention.vmap_copies == copies + 1
        assert torch.equal(out2, out)


def test_a_stacked_bert_forward_calls_k1_once_a_layer(monkeypatch):
    """With the flash path on (as on the card), the stacked forward of T
    BERTs reaches K1's plain version once a layer over all T·B rows."""
    cfg = bert.tiny(vocab=256, max_len=16, dim=64, depth=2, heads=2)
    cfg = type(cfg)(vocab=cfg.vocab, max_len=cfg.max_len,
                    num_classes=2, encoder=type(cfg.encoder)(
                        dim=64, depth=2, heads=2, use_flash=True))
    models = [rafiki_tpu_torch.convert.from_jax_params(
        bert.init(np.random.default_rng(s), cfg), cfg, "cpu")
        for s in (0, 1)]
    calls = []
    plain = fa.flash_attention_plain

    def counted(q, *a, **k):
        calls.append(q.shape[0])
        return plain(q, *a, **k)

    monkeypatch.setattr(fa, "flash_attention_plain", counted)
    ids = torch.randint(0, 256, (5, 16))
    stacked = torch_backend.StackedModels(models, "cpu")
    with torch.inference_mode():
        out = stacked.forward(lambda m, x: torch.softmax(m(x), -1), ids)
    assert calls == [2 * 5] * 2  # one call a layer, both trials' rows
    calls.clear()
    with torch.inference_mode():
        for i, m in enumerate(models):
            ref = torch.softmax(m(ids), -1)
            np.testing.assert_allclose(out[i].numpy(), ref.numpy(),
                                       atol=SELF_ATOL)
    assert calls == [5] * 4


# -- trainer_ensemble_stack against JAX's ----------------------------------------


def _bert_pair(seeds):
    jax_bert = _load(EXAMPLES / "text_classification" / "JaxBert.py")
    jax_models, models = [], []
    for seed in seeds:
        cfg = TorchBert(**BERT_KNOBS)._make_cfg(2)
        params = {"params": bert.init(np.random.default_rng(seed), cfg),
                  "label_vocab": ["neg", "pos"],
                  "arch": {k: BERT_KNOBS[k] for k in
                           ("depth", "heads", "dim", "max_len", "vocab")}}
        jm = jax_bert.JaxBert(**BERT_KNOBS)
        jm.load_parameters(params)
        tm = TorchBert(**BERT_KNOBS)
        tm.load_parameters(params)
        jax_models.append(jm)
        models.append(tm)
    queries = ["alpha beta gamma", "omega", "sigma lambda kappa delta",
               "beta beta beta beta beta beta beta"] * 3
    return jax_models, models, queries


def _cnn_pair(seeds, base=16):
    jax_cnn = _load(EXAMPLES / "image_classification" / "JaxCnn.py")
    knobs = dict(CNN_KNOBS, base_channels=base)
    jax_models, models = [], []
    for seed in seeds:
        params = {"params": torch_cnn.init_params(
            np.random.default_rng(seed), 2, base, 3, 4), "num_classes": 4}
        jm = jax_cnn.JaxCnn(**knobs)
        jm.load_parameters(params)
        tm = TorchCnn(**knobs)
        tm.load_parameters(params)
        jax_models.append(jm)
        models.append(tm)
    x = np.random.default_rng(9).standard_normal((11, 8, 8, 3)).astype(
        np.float32)
    return jax_models, models, [q.tolist() for q in x]


@pytest.mark.parametrize("kind,atol", [("bert", BERT_PROB_ATOL),
                                       ("cnn", CNN_PROB_ATOL)])
def test_the_stacked_predict_matches_jaxs(kind, atol):
    jax_models, models, queries = (_bert_pair if kind == "bert"
                                   else _cnn_pair)((0, 1))
    solo = [np.asarray(m.predict(queries)) for m in models]
    theirs = jax_models[0].ensemble_stack(jax_models)
    ours = models[0].ensemble_stack(models)
    assert theirs is not None and ours is not None
    ours.warm_up()
    got = np.asarray(ours.predict_all(queries))
    ref = np.asarray(theirs.predict_all(queries))
    assert got.shape == ref.shape == (2, len(queries), solo[0].shape[1])
    np.testing.assert_allclose(got, ref, atol=atol)
    np.testing.assert_allclose(got, np.stack(solo),
                               atol=SELF_ATOL if kind == "bert"
                               else CNN_PROB_ATOL)
    # each model's own parameters went to the host with the stack
    assert all(next(m._model.parameters()).device.type == "cpu"
               for m in models)


def test_the_fused_ensemble_equals_the_unfused_one():
    _, models, queries = _cnn_pair((2, 3))
    unfused = [np.asarray(m.predict(queries)) for m in models]
    fused = _FusedEnsembleModel(models, "IMAGE_CLASSIFICATION")
    assert fused.fused_dispatch
    np.testing.assert_allclose(np.asarray(fused.predict(queries)),
                               np.mean(unfused, axis=0), atol=CNN_PROB_ATOL)


def test_no_stack_for_another_architecture():
    _, a, _ = _cnn_pair((0,), base=16)
    _, b, _ = _cnn_pair((1,), base=8)
    jax_a, _, _ = _cnn_pair((0,), base=16)
    jax_b, _, _ = _cnn_pair((1,), base=8)
    assert a[0].ensemble_stack(a + b) is None
    assert jax_a[0].ensemble_stack(jax_a + jax_b) is None


def test_no_stack_for_a_stateful_group():
    """A BatchNorm trainer is stateful: ``TorchResNet`` opts out, and the
    SDK function refuses such a group as JAX's does."""
    from rafiki_tpu_torch.templates.torch_resnet import TorchResNet

    knobs = {"depth": "resnet18", "learning_rate": 1e-3, "epochs": 1,
             "batch_size": 64, "image_size": 32}
    models = [TorchResNet(**knobs) for _ in range(2)]
    for m in models:
        m._cfg = m._make_cfg(10)
        m._trainer = m._build_trainer()
        m._model = torch.nn.Linear(1, 1)
    assert models[0]._trainer.stateful
    assert models[1]._trainer is models[0]._trainer
    assert models[0].ensemble_stack(models) is None
    assert torch_backend.trainer_ensemble_stack(
        models, np.zeros((32, 32, 3), np.float32)) is None


class _RaisingHookModel:
    def ensemble_stack(self, models):
        raise MemoryError("stacking the parameters blew the host")

    def predict(self, queries):
        return [[1.0, 0.0] for _ in queries]

    def warm_up(self):
        pass

    def destroy(self):
        pass


def test_a_raising_hook_falls_back_as_jaxs_does():
    models = [_RaisingHookModel(), _RaisingHookModel()]
    ours = _FusedEnsembleModel(models, "IMAGE_CLASSIFICATION")
    theirs = JaxFused(models, "IMAGE_CLASSIFICATION")
    assert ours.fused_dispatch is False and theirs.fused_dispatch is False
    assert ours.predict([[0.0], [2.0]]) == theirs.predict([[0.0], [2.0]])


# -- through the admin ------------------------------------------------------------


@pytest.fixture
def admin(tmp_path):
    a = Admin(db=Database(":memory:"),
              placement=LocalPlacementManager(ChipAllocator(["cpu"])),
              params_dir=str(tmp_path / "params"))
    yield a
    a.shutdown()


def _uid(admin):
    return admin.authenticate_user(config.SUPERADMIN_EMAIL,
                                   config.SUPERADMIN_PASSWORD)["user_id"]


def test_the_fused_deploy_shape_and_its_fallback(admin):
    """With ENSEMBLE_FUSED the fleet is one unit of the whole group, not a
    worker a trial; a template without ``ensemble_stack`` serves it one
    model after another, and the stats row says so."""
    uid = _uid(admin)
    admin.create_model(uid, "fake", "IMAGE_CLASSIFICATION", FAKE_TEMPLATE,
                       "FakeModel")
    admin.create_train_job(uid, "fusedapp", "IMAGE_CLASSIFICATION", "t", "e",
                           budget={"MODEL_TRIAL_COUNT": 3})
    admin.wait_until_train_job_stopped(uid, "fusedapp", timeout_s=60)
    inf = admin.create_inference_job(uid, "fusedapp",
                                     budget={"ENSEMBLE_FUSED": 1})
    (worker,) = inf["workers"]
    best = admin.get_best_trials_of_train_job(uid, "fusedapp")
    assert worker["trial_id"] == best[0]["id"]
    assert admin.predict(uid, "fusedapp", [[0.0], [1.0]]) == \
        [[0.5, 0.5], [0.5, 0.5]]
    assert serving_stats()[worker["service_id"]]["fused_dispatch"] is False
    stats = admin.get_inference_job_stats(uid, "fusedapp")
    assert stats["workers"][0]["fused_dispatch"] is False


FUSED_CNN = (Path(torch_cnn.__file__).read_text() + '''

class FusedCnn(TorchCnn):
    @staticmethod
    def get_knob_config():
        cfg = dict(TorchCnn.get_knob_config())
        cfg["epochs"] = FixedKnob(1)
        cfg["num_stages"] = FixedKnob(1)
        cfg["base_channels"] = FixedKnob(16)
        cfg["batch_size"] = FixedKnob(64)
        cfg["image_size"] = FixedKnob(8)
        return cfg
''').encode()


def test_fused_answers_equal_the_unfused_deploys(admin, tmp_path):
    uid = _uid(admin)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(128, 8, 8, 3)).astype(np.float32)
    y = rng.integers(0, 4, size=128).astype(np.int32)
    train = write_numpy_dataset(x, y, str(tmp_path / "train.npz"))
    test = write_numpy_dataset(x[:32], y[:32], str(tmp_path / "test.npz"))
    admin.create_model(uid, "cnn", "IMAGE_CLASSIFICATION", FUSED_CNN,
                       "FusedCnn")
    admin.create_train_job(uid, "cnnapp", "IMAGE_CLASSIFICATION", train,
                           test, budget={"MODEL_TRIAL_COUNT": 2})
    job = admin.wait_until_train_job_stopped(uid, "cnnapp", timeout_s=120)
    assert job["status"] == "STOPPED"
    queries = [x[0].tolist(), x[1].tolist(), x[2].tolist()]
    plain_inf = admin.create_inference_job(uid, "cnnapp")
    assert len(plain_inf["workers"]) == 2
    plain = admin.predict(uid, "cnnapp", queries)
    admin.stop_inference_job(uid, "cnnapp")
    inf = admin.create_inference_job(uid, "cnnapp",
                                     budget={"ENSEMBLE_FUSED": 1})
    assert len(inf["workers"]) == 1
    fused = admin.predict(uid, "cnnapp", queries)
    stats = admin.get_inference_job_stats(uid, "cnnapp")
    admin.stop_inference_job(uid, "cnnapp")
    assert stats["workers"][0]["fused_dispatch"] is True
    np.testing.assert_allclose(np.asarray(fused), np.asarray(plain),
                               atol=CNN_PROB_ATOL)


def test_text_generation_cannot_fuse(admin, monkeypatch):
    """A token stream answers from one model: ENSEMBLE_FUSED on a
    TEXT_GENERATION job is a typed deploy error, and the job errors."""
    uid = _uid(admin)
    admin.create_model(uid, "fake", "IMAGE_CLASSIFICATION", FAKE_TEMPLATE,
                       "FakeModel")
    admin.create_train_job(uid, "gen", "IMAGE_CLASSIFICATION", "t", "e",
                           budget={"MODEL_TRIAL_COUNT": 1})
    admin.wait_until_train_job_stopped(uid, "gen", timeout_s=60)
    real = admin.db.get_train_job

    def as_generation(job_id):
        row = real(job_id)
        return row and {**row, "task": "TEXT_GENERATION"}

    monkeypatch.setattr(admin.db, "get_train_job", as_generation)
    with pytest.raises(ServiceDeploymentError, match="ENSEMBLE_FUSED"):
        admin.create_inference_job(uid, "gen", budget={"ENSEMBLE_FUSED": 1})
    (inf,) = admin.db.get_inference_jobs_of_train_job(
        admin.get_train_job(uid, "gen")["id"])
    assert inf["status"] == "ERRORED"
    assert admin.db.get_workers_of_inference_job(inf["id"]) == []
