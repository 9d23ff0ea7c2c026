"""The port's training stack against the JAX package's: the own copies of
knobs, advisor, artifact and dataset I/O, the database's trial reservation,
and ``DataParallelTrainer.fit`` on a tiny ViT.

Inputs are made with numpy from a seed and handed to both packages. The
JAX trainer runs on the 8-device CPU mesh of ``tests/conftest.py`` with
its flash kernels interpreted; the port's runs on the CPU with the plain
versions of its kernels.
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rafiki_tpu.advisor import advisor as jax_advisor
from rafiki_tpu.models import vit as jvit
from rafiki_tpu.sdk import artifact as jax_artifact
from rafiki_tpu.sdk import dataset as jax_dataset
from rafiki_tpu.sdk import jax_backend
from rafiki_tpu.sdk import knob as jax_knob
from rafiki_tpu_torch import convert
from rafiki_tpu_torch.advisor import advisor
from rafiki_tpu_torch.constants import TrialStatus
from rafiki_tpu_torch.db.database import Database
from rafiki_tpu_torch.models import vit
from rafiki_tpu_torch.sdk import artifact, dataset, knob, torch_backend
from rafiki_tpu_torch.sdk.log import ModelLogger, StopTrialEarly


def _knob_config(mod):
    return {
        "lr": mod.FloatKnob(1e-5, 1e-2, is_exp=True),
        "momentum": mod.FloatKnob(0.5, 0.99),
        "depth": mod.IntegerKnob(2, 12),
        "width": mod.IntegerKnob(16, 1024, is_exp=True),
        "batch_size": mod.CategoricalKnob([32, 64, 128]),
        "act": mod.CategoricalKnob(["relu", "gelu"]),
        "epochs": mod.FixedKnob(3),
    }


# ---------------------------------------------------------------------------
# the copies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_knobs_encode_and_decode_as_jax(seed):
    ours, theirs = _knob_config(knob), _knob_config(jax_knob)
    assert knob.knob_config_dims(ours) == jax_knob.knob_config_dims(theirs)
    u = np.random.default_rng(seed).random(knob.knob_config_dims(ours))
    decoded = knob.knobs_from_unit(ours, u)
    assert decoded == jax_knob.knobs_from_unit(theirs, u)
    np.testing.assert_array_equal(knob.knobs_to_unit(ours, decoded),
                                  jax_knob.knobs_to_unit(theirs, decoded))
    knob.validate_knobs(ours, decoded)
    jax_knob.validate_knobs(theirs, decoded)


def test_knob_serialization_matches_jax():
    ours, theirs = _knob_config(knob), _knob_config(jax_knob)
    as_json = knob.serialize_knob_config(ours)
    assert as_json == jax_knob.serialize_knob_config(theirs)
    assert knob.deserialize_knob_config(as_json) == ours
    with pytest.raises(ValueError):
        knob.deserialize_knob_config({"x": {"type": "nope"}})
    with pytest.raises(ValueError):
        knob.validate_knobs(ours, {"lr": 1e-3})


@pytest.mark.parametrize("kind", ["GP", "RANDOM"])
def test_advisor_proposes_as_jax(kind):
    """Same knob config, same seed, same feedback: the same proposals, past
    the GP's random warm-up."""
    ours = advisor.AdvisorStore()
    theirs = jax_advisor.AdvisorStore()
    aid = ours.create_advisor(_knob_config(knob), "s", kind)
    jid = theirs.create_advisor(_knob_config(jax_knob), "s", kind)
    for i in range(9):
        proposal = ours.propose(aid)
        assert proposal == theirs.propose(jid), i
        score = float(np.sin(3 * np.log(proposal["lr"])) + proposal["depth"]
                      / 12)
        ours.get(aid).feedback(proposal, score)
        theirs.get(jid).feedback(proposal, score)
    assert ours.get(aid).observation_count == 9
    # the store's feedback records the score and returns the next proposal
    assert ours.feedback(aid, proposal, 0.5) == theirs.feedback(jid, proposal,
                                                                0.5)
    with pytest.raises(KeyError):
        ours.propose("nope")


def test_artifact_round_trip_and_corruption(tmp_path):
    payload = np.random.default_rng(0).bytes(4096)
    assert artifact.wrap(payload) == jax_artifact.wrap(payload)
    path = str(tmp_path / "a.params")
    artifact.write_artifact(path, payload)
    assert artifact.read_artifact(path) == payload
    assert jax_artifact.read_artifact(path) == payload
    framed = open(path, "rb").read()
    for damaged in (framed[:-1], framed[:10], framed[:2],
                    framed[:-5] + bytes([framed[-5] ^ 1]) + framed[-4:]):
        open(path, "wb").write(damaged)
        with pytest.raises(artifact.ArtifactCorruptError):
            artifact.read_artifact(path)
    open(path, "wb").write(b"PK legacy")  # unframed: passes through
    assert artifact.read_artifact(path) == b"PK legacy"


def test_numpy_dataset_as_jax(tmp_path):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((10, 4, 4, 3)).astype(np.float32)
    y = rng.integers(0, 3, 10)
    uri = dataset.write_numpy_dataset(x, y, str(tmp_path / "d.npz"))
    utils = dataset.DatasetUtils()
    ours = utils.load_image_arrays(uri)
    theirs = jax_dataset.DatasetUtils().load_image_arrays(uri)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # cached per file: a file:// URI of the same file hits the same entry
    assert utils.load_image_arrays("file://" + uri)[0] is ours[0]
    assert dataset.NumpyDataset(uri).label_num_classes == 3
    for bad in (str(tmp_path / "images.zip"), str(tmp_path / "none.npz"),
                "https://example.invalid/d.npz"):
        with pytest.raises(dataset.InvalidDatasetError):
            utils.load_image_arrays(bad)


def test_shuffled_batches_as_jax():
    for n, bs in ((64, 16), (70, 16), (5, 8)):
        ours = list(torch_backend.shuffled_batches(
            n, bs, np.random.default_rng([3, 1])))
        theirs = list(jax_backend.shuffled_batches(
            n, bs, np.random.default_rng([3, 1])))
        assert len(ours) == len(theirs) == n // bs
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a, b)


def test_set_opt_hyperparams():
    opt = torch_backend.tunable_optimizer(torch.optim.AdamW, lr=1e-3)(
        [torch.nn.Parameter(torch.zeros(2))])
    torch_backend.set_opt_hyperparams(opt, {"lr": 5e-4})
    assert opt.param_groups[0]["lr"] == 5e-4
    with pytest.raises(KeyError):
        torch_backend.set_opt_hyperparams(opt, {"learning_rat": 1.0})


def test_reserve_trial_never_overshoots():
    """Count and insert in one transaction: 16 threads racing for 5 slots
    reserve exactly 5; a TERMINATED trial frees its slot."""
    store = Database(":memory:")
    user = store.create_user("dev@x", "-", "MODEL_DEVELOPER")
    model = store.create_model(user["id"], "m", "IMAGE_CLASSIFICATION", b"",
                               "M", {}, "PRIVATE")
    job = store.create_train_job(user["id"], "app", 1, "IMAGE_CLASSIFICATION",
                                 "a", "b", {"MODEL_TRIAL_COUNT": 5})
    sub = store.create_sub_train_job(job["id"], model["id"])
    got, barrier = [], threading.Barrier(16)

    def reserve():
        barrier.wait(timeout=10)
        got.append(store.reserve_trial(sub["id"], model["id"], {"i": 1},
                                       max_trials=5))

    threads = [threading.Thread(target=reserve) for _ in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    reserved = [t for t in got if t is not None]
    assert len(reserved) == 5
    assert all(t["status"] == TrialStatus.RUNNING for t in reserved)
    store.mark_trial_as_terminated(reserved[0]["id"])
    assert store.reserve_trial(sub["id"], model["id"], {}, max_trials=5)
    assert store.reserve_trial(sub["id"], model["id"], {},
                               max_trials=5) is None
    assert len(store.get_trials_of_sub_train_job(sub["id"])) == 6


# ---------------------------------------------------------------------------
# fit
# ---------------------------------------------------------------------------

LR = 1e-3
EPOCHS = 2
# a multiple of the 8-device CPU mesh, so JAX's trainer takes the same
# batches (it rounds the batch up to a multiple of the mesh)
BATCH = 16
N = 64
STEPS = EPOCHS * (N // BATCH)


def _flash_cfg(cfg, use_flash=True):
    return dataclasses.replace(
        cfg, encoder=dataclasses.replace(cfg.encoder, use_flash=use_flash))


@pytest.fixture(scope="module")
def problem():
    cfg = _flash_cfg(vit.tiny())
    tree = vit.init(np.random.default_rng(0), cfg)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((N, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, cfg.num_classes, N).astype(np.int32)
    return cfg, tree, x, y


def _torch_trainer():
    return torch_backend.DataParallelTrainer(
        torch_backend.softmax_classifier_loss(lambda m, x: m(x)),
        torch_backend.tunable_optimizer(
            torch.optim.AdamW, lr=LR, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=1e-4),
        predict_fn=lambda m, x: torch.softmax(m(x), -1), device="cpu")


def _torch_fit(problem, epochs=EPOCHS, log=None, checkpoint_path=None):
    cfg, tree, x, y = problem
    trainer = _torch_trainer()
    model, opt = trainer.init(
        lambda rng: convert.from_jax_params(tree, cfg, "cpu", train=True))
    trainer.fit(model, opt, (x, y), epochs=epochs, batch_size=BATCH,
                seed=3, log=log, checkpoint_path=checkpoint_path)
    return trainer, model


@pytest.fixture(scope="module")
def fitted(problem):
    """Both packages' fit from the same tree, data, seed and AdamW."""
    cfg, tree, x, y = problem
    jcfg = _flash_cfg(jvit.tiny())
    apply_fn = lambda p, xb: jvit.apply(p, xb, jcfg)  # noqa: E731
    jtrainer = jax_backend.DataParallelTrainer(
        jax_backend.softmax_classifier_loss(apply_fn),
        jax_backend.tunable_optimizer(optax.adamw, learning_rate=LR),
        predict_fn=lambda p, xb: jax.nn.softmax(apply_fn(p, xb), -1))
    params, opt_state = jtrainer.init(
        lambda rng: jax.tree.map(jnp.asarray, tree),
        hyperparams={"learning_rate": LR})
    jlosses = []
    params, _ = jtrainer.fit(params, opt_state, (x, y), epochs=EPOCHS,
                             batch_size=BATCH, seed=3,
                             log=lambda **m: jlosses.append(m))
    jacc = jax_backend.classification_accuracy(jtrainer, params, x, y)

    losses = []
    trainer, model = _torch_fit(problem, log=lambda **m: losses.append(m))
    acc = torch_backend.classification_accuracy(trainer, model, x, y)
    return (dict(losses=losses, acc=acc, tree=convert.to_jax_params(model)),
            dict(losses=jlosses, acc=jacc,
                 tree=jax.tree.map(np.asarray, params)))


def test_fit_losses_match_jax(fitted):
    """Epoch losses: the two runs differ only by bf16 rounding in the
    forward and backward (measured ~1e-4 on an O(2) loss)."""
    ours, theirs = fitted
    assert [m["epoch"] for m in ours["losses"]] == [0.0, 1.0]
    assert all(m["epoch_time"] >= 0 for m in ours["losses"])
    np.testing.assert_allclose([m["loss"] for m in ours["losses"]],
                               [m["loss"] for m in theirs["losses"]],
                               rtol=1e-3)
    assert ours["losses"][1]["loss"] < ours["losses"][0]["loss"]


def test_fit_params_match_jax(fitted, problem):
    """Final parameters, per leaf, as updates from the common start. An
    AdamW step moves each weight by about lr whatever its gradient's size,
    so a gradient near zero that bf16 rounding turns around moves the two
    runs apart by up to ~lr per step: each weight within lr x steps. The
    bulk of each update must agree: its difference within 20% of its norm
    (measured at most 9%, on the attention output bias)."""
    ours, theirs = fitted
    init = problem[1]
    flat = jax.tree_util.tree_leaves_with_path(theirs["tree"])
    for path, final_jax in flat:
        final_ours, start = ours["tree"], init
        for key in path:
            final_ours, start = final_ours[key.key], start[key.key]
        d_ours, d_jax = final_ours - start, final_jax - start
        name = jax.tree_util.keystr(path)
        assert np.abs(d_ours - d_jax).max() <= LR * STEPS, name
        assert np.linalg.norm(d_ours - d_jax) <= 0.2 * np.linalg.norm(
            d_jax), name
        assert np.abs(d_jax).max() > 0.5 * LR, name  # the leaf did train


def test_fit_accuracy_matches_jax(fitted):
    """classification_accuracy over the 64 training images: the same
    within 2 images (a bf16-close logit pair may swap its argmax)."""
    ours, theirs = fitted
    assert abs(ours["acc"] - theirs["acc"]) <= 2 / N


def test_checkpoint_resume_ends_where_the_fit_ends(problem, tmp_path):
    """A fit stopped after epoch 1 of 2 (StopTrialEarly from the logger,
    absorbed by fit, checkpoint written) and resumed in a fresh model and
    optimizer from its checkpoint ends where the uninterrupted fit ends;
    a damaged checkpoint restarts the fit from scratch."""
    _, whole = _torch_fit(problem)
    path = str(tmp_path / "trial.ckpt")
    stopper = ModelLogger()
    stopper.set_sink(lambda line: None)
    stopper.set_stop_check(lambda metrics: True)
    _, stopped = _torch_fit(problem, log=stopper.log, checkpoint_path=path)
    logged = []
    _, resumed = _torch_fit(problem, log=lambda **m: logged.append(m),
                            checkpoint_path=path)
    assert [m["epoch"] for m in logged] == [1.0]  # epoch 0 was not rerun
    for (name, a), b, c in zip(whole.state_dict().items(),
                               resumed.state_dict().values(),
                               stopped.state_dict().values()):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-6, rtol=0,
                                   err_msg=name)
    assert any(not torch.equal(a, c) for a, c in zip(
        whole.state_dict().values(), stopped.state_dict().values()))

    raw = open(path, "rb").read()
    open(path, "wb").write(raw[:-7] + b"garbage")
    logged.clear()
    _, fresh = _torch_fit(problem, log=lambda **m: logged.append(m),
                          checkpoint_path=path)
    assert [m["epoch"] for m in logged] == [0.0, 1.0]
    for a, b in zip(whole.state_dict().values(), fresh.state_dict().values()):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-6, rtol=0)


def test_stop_trial_early_is_absorbed(problem):
    stopper = ModelLogger()
    stopper.set_sink(lambda line: None)
    stopper.set_stop_check(lambda metrics: metrics["epoch"] >= 0)
    with pytest.raises(StopTrialEarly):
        stopper.log(loss=1.0, epoch=0.0)
    _torch_fit(problem, log=stopper.log)  # returns, does not raise
