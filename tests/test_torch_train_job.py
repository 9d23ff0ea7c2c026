"""The port's train slice end to end on the CPU.

A tiny-ViT variant of the ``TorchViT`` template, handed over as bytes as
a user's upload is, runs a 2-trial train job through the port's
``TrainWorker`` on a ``["cpu"]`` grant: the GP advisor proposes, the
database reserves, the template trains (``fit``, through the flash op's plain
forward and backward), evaluates and dumps its parameters. The best trial
is then served by an ``InferenceWorker`` behind a ``Predictor``, and its
answers are held against JAX's ``vit.apply`` softmax on the same dumped
tree.
"""

import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rafiki_tpu.models import vit as jvit
from rafiki_tpu_torch.advisor.advisor import AdvisorStore
from rafiki_tpu_torch.cache.queue import InProcessBroker
from rafiki_tpu_torch.constants import TrialStatus
from rafiki_tpu_torch.db.database import Database
from rafiki_tpu_torch.device import ServiceContext
from rafiki_tpu_torch.predictor.predictor import Predictor
from rafiki_tpu_torch.sdk.dataset import write_numpy_dataset
from rafiki_tpu_torch.sdk.log import LogType
from rafiki_tpu_torch.sdk.artifact import read_artifact
from rafiki_tpu_torch.sdk.params import load_params
from rafiki_tpu_torch.worker.inference import InferenceWorker
from rafiki_tpu_torch.worker.train import TrainWorker

# the template at test scale: the tiny ViT of vit.tiny(), with the flash
# op forced so training runs its forward-with-LSE and backward
TINY_TEMPLATE = b'''
import dataclasses

from rafiki_tpu_torch.sdk.knob import CategoricalKnob, FixedKnob, FloatKnob
from rafiki_tpu_torch.templates.torch_vit import TorchViT


class TinyViT(TorchViT):
    @staticmethod
    def get_knob_config():
        return {"image_size": FixedKnob(32), "patch_size": FixedKnob(4),
                "dim": FixedKnob(64), "depth": FixedKnob(2),
                "heads": FixedKnob(4), "num_classes": FixedKnob(10),
                "learning_rate": FloatKnob(1e-4, 3e-3, is_exp=True),
                "batch_size": CategoricalKnob([8, 16]),
                "epochs": FixedKnob(2)}

    def _cfg(self):
        cfg = super()._cfg()
        return dataclasses.replace(cfg, encoder=dataclasses.replace(
            cfg.encoder, use_flash=True))
'''

BROKEN_TEMPLATE = TINY_TEMPLATE + b'''

class BrokenViT(TinyViT):
    def train(self, dataset_uri):
        raise RuntimeError("this template cannot train")


class NanViT(TinyViT):
    def evaluate(self, dataset_uri):
        return float("nan")
'''

# bf16 logits of the two packages differ by a few bf16 ulps
# (tests/test_torch_vit.py); through a softmax over 10 classes that moves
# each probability by at most ~p * 2.5e-2
PROB_ATOL = 5e-3


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


def _sub_train_job(db, template, model_class, budget, train_uri, test_uri):
    """The rows a train worker reads: a user's model, a train job with
    ``budget``, and its sub-train-job."""
    user = db.create_user("dev@x", "-", "MODEL_DEVELOPER")
    model = db.create_model(user["id"], model_class, "IMAGE_CLASSIFICATION",
                            template, model_class, {}, "PRIVATE")
    job = db.create_train_job(user["id"], "app", 1, "IMAGE_CLASSIFICATION",
                              train_uri, test_uri, budget)
    return db.create_sub_train_job(job["id"], model["id"])


def _run_job(tmp_path, template, model_class, trials=2):
    db, advisors = Database(":memory:"), AdvisorStore()
    train_uri, test_uri = _dataset(tmp_path)
    sub = _sub_train_job(db, template, model_class,
                         {"MODEL_TRIAL_COUNT": trials}, train_uri, test_uri)
    ready = threading.Event()
    ctx = ServiceContext("train-worker-0", chips=["cpu"], on_ready=ready.set)
    worker = TrainWorker(sub["id"], db, advisors,
                         params_dir=str(tmp_path / "params"))
    errors = []

    def run():
        try:
            worker.start(ctx)
        except Exception as e:  # reported below
            errors.append(e)

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    thread.join(timeout=600)
    assert not thread.is_alive() and not errors, errors
    assert ready.is_set()
    assert db.get_sub_train_job(sub["id"])["advisor_id"] == sub["id"]
    return db, advisors, sub, test_uri


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    return _run_job(tmp_path_factory.mktemp("job"), TINY_TEMPLATE, "TinyViT")


def test_trials_complete_with_finite_scores(job):
    db, advisors, sub, _ = job
    trials = db.get_trials_of_sub_train_job(sub["id"])
    assert len(trials) == 2
    for t in trials:
        assert t["status"] == TrialStatus.COMPLETED, t["fault_detail"]
        assert 0.0 <= t["score"] <= 1.0
        assert t["knobs"]["batch_size"] in (8, 16)
        assert 1e-4 <= t["knobs"]["learning_rate"] <= 3e-3
    assert advisors.get(sub["id"]).observation_count == 2


def test_trial_logs_carry_epoch_losses(job):
    """The template's epoch losses, then the worker's phase breakdown (the
    tracer's summary, as JAX's: propose, train, evaluate,
    persist_params)."""
    db, _, sub, _ = job
    for t in db.get_trials_of_sub_train_job(sub["id"]):
        records = [json.loads(line) for line in db.get_trial_logs(t["id"])]
        metrics = [r["metrics"] for r in records
                   if r["type"] == LogType.METRICS]
        *losses, phases = metrics
        assert [m["epoch"] for m in losses] == [0.0, 1.0]
        assert all(np.isfinite(m["loss"]) for m in losses)
        assert any(r["type"] == LogType.PLOT for r in records)
        assert set(phases) == {"trace_propose_s", "trace_train_s",
                               "trace_evaluate_s", "trace_persist_params_s"}
        assert all(v >= 0 for v in phases.values())
        assert records[-1] == {"type": LogType.METRICS, "metrics": phases,
                               "time": records[-1]["time"]}
        assert {"type": LogType.MESSAGE, "message": "trial phase breakdown",
                "time": records[-2]["time"]} == records[-2]


def test_checkpoints_are_cleaned_up(job):
    db, _, sub, _ = job
    for t in db.get_trials_of_sub_train_job(sub["id"]):
        path = t["params_file_path"]
        assert path.endswith(".params") and os.path.exists(path)
        assert not os.path.exists(path[:-len(".params")] + ".ckpt")


def test_best_trial_serves_jax_answers(job):
    """The best trial behind InferenceWorker -> Predictor answers as JAX's
    forward on the same dumped tree; its score is that forward's accuracy
    on the test set."""
    db, _, sub, test_uri = job
    best = max(db.get_trials_of_sub_train_job(sub["id"]),
               key=lambda t: t["score"])
    tree = load_params(read_artifact(best["params_file_path"]))
    broker = InProcessBroker()
    ready = threading.Event()
    ctx = ServiceContext("inference-worker-0", chips=["cpu"],
                         on_ready=ready.set)
    thread = threading.Thread(
        target=InferenceWorker("inf-job", best["id"], db, broker).start,
        args=(ctx,), daemon=True)
    thread.start()
    try:
        assert ready.wait(60)
        predictor = Predictor("inf-job", broker, "IMAGE_CLASSIFICATION",
                              {ctx.service_id: best["id"]})
        with np.load(test_uri) as z:
            x, y = z["x"], z["y"]
        probs = np.asarray(predictor.predict_batch(list(x[:12]),
                                                   timeout_s=60))
    finally:
        ctx.stop_event.set()
        broker.unregister_worker("inf-job", ctx.service_id)
        thread.join(timeout=10)
    assert not thread.is_alive()
    ref = np.asarray(jax.nn.softmax(jvit.apply(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x), jvit.tiny()), -1))
    assert probs.shape == (12, 10)
    np.testing.assert_allclose(probs, ref[:12], atol=PROB_ATOL, rtol=0)
    jax_acc = float((ref.argmax(-1) == y).mean())
    assert abs(best["score"] - jax_acc) <= 1 / len(y)


@pytest.mark.parametrize("model_class,kind,detail", [
    ("BrokenViT", "USER", "cannot train"),
    ("NanViT", "INVALID_SCORE", "non-finite"),
])
def test_errored_trials_do_not_stop_the_loop(tmp_path, model_class, kind,
                                             detail):
    """A template whose train raises, or whose evaluate returns NaN: each
    trial is ERRORED with its kind and traceback, the NaN never reaches
    the advisor, and the loop goes on until the budget is spent."""
    db, advisors, sub, _ = _run_job(tmp_path, BROKEN_TEMPLATE,
                                       model_class, trials=3)
    trials = db.get_trials_of_sub_train_job(sub["id"])
    assert [t["status"] for t in trials] == [TrialStatus.ERRORED] * 3
    for t in trials:
        assert t["fault_kind"] == kind
        assert detail in t["fault_detail"]
        assert t["params_file_path"] is None
    assert advisors.get(sub["id"]).observation_count == 0


def test_stop_event_ends_the_loop(tmp_path):
    """A worker whose context is already stopping reserves no trial."""
    db, advisors = Database(":memory:"), AdvisorStore()
    sub = _sub_train_job(db, TINY_TEMPLATE, "TinyViT",
                         {"MODEL_TRIAL_COUNT": 2}, "a.npz", "b.npz")
    ctx = ServiceContext("w", chips=["cpu"])
    ctx.stop_event.set()
    TrainWorker(sub["id"], db, advisors,
                params_dir=str(tmp_path)).start(ctx)
    assert db.get_trials_of_sub_train_job(sub["id"]) == []
