"""The port's serving slice end to end on the CPU.

Two trials of the tiny ``TorchViT`` template (seeded numpy weights in the
JAX layout, npz artifacts, template bytes and knobs as COMPLETED trial rows
of the port's database) are served by two ``InferenceWorker`` threads behind one
``Predictor`` and its ``PredictorServer``. Answers over ``POST /predict``
are held against the JAX package: the mean over the two trials of
``softmax(vit.apply(tree))``.
"""

import io
import json
import threading
import time
import types
import urllib.error
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import rafiki_tpu_torch
from rafiki_tpu import config as jax_config
from rafiki_tpu.models import vit as jvit
from rafiki_tpu.sdk.jax_backend import (
    DataParallelTrainer as JaxDataParallelTrainer,
)
from rafiki_tpu_torch import config
from rafiki_tpu_torch.cache.queue import (
    InProcessBroker,
    QueueFullError,
    WorkerQueue,
)
from rafiki_tpu_torch.db.database import Database
from rafiki_tpu_torch.device import ServiceContext
from rafiki_tpu_torch.models import vit
from rafiki_tpu_torch.predictor.ensemble import ensemble_predictions
from rafiki_tpu_torch.predictor.predictor import Predictor
from rafiki_tpu_torch.predictor.server import PredictorServer
from rafiki_tpu_torch.sdk.artifact import write_artifact
from rafiki_tpu_torch.sdk.params import dump_params
from rafiki_tpu_torch.sdk.torch_backend import DataParallelTrainer
from rafiki_tpu_torch.worker.inference import InferenceWorker, _resolve_batch

TEMPLATE = (Path(rafiki_tpu_torch.__file__).parent / "templates"
            / "torch_vit.py")
KNOBS = dict(image_size=32, patch_size=4, dim=64, depth=2, heads=4,
             num_classes=10)
JOB = "job-vit"
# bf16 logits of the two packages differ by a few bf16 ulps (see
# test_torch_vit.py); through a softmax over 10 classes that moves each
# probability by at most ~p * 2.5e-2
PROB_ATOL = 5e-3


def _post(url, body, headers):
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.headers, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


def post_npy(url, images):
    buf = io.BytesIO()
    np.save(buf, images, allow_pickle=False)
    code, headers, body = _post(url, buf.getvalue(), {
        "Content-Type": "application/x-npy", "Accept": "application/x-npy"})
    assert code == 200, body
    assert headers["Content-Type"] == "application/x-npy"
    return np.load(io.BytesIO(body), allow_pickle=False)


def post_json(url, payload):
    return _post(url, json.dumps(payload).encode(),
                 {"Content-Type": "application/json"})


def add_trained_trials(db, params_dir, template, model_class, knobs,
                       trees):
    """A COMPLETED trial row for each params tree of ``trees`` (its
    artifact written under ``params_dir``); returns {trial_id: tree}."""
    user = db.create_user("dev@x", "-", "MODEL_DEVELOPER")
    model = db.create_model(user["id"], model_class, "IMAGE_CLASSIFICATION",
                            template, model_class, {}, "PRIVATE")
    job = db.create_train_job(user["id"], "app", 1, "IMAGE_CLASSIFICATION",
                              "-", "-", {})
    sub = db.create_sub_train_job(job["id"], model["id"])
    out = {}
    for tree in trees:
        tid = db.create_trial(sub["id"], model["id"], knobs)["id"]
        path = str(params_dir / f"{tid}.params")
        write_artifact(path, dump_params(tree))
        db.mark_trial_as_complete(tid, 0.5, path)
        out[tid] = tree
    return out


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    cfg = vit.tiny()
    store = Database(":memory:")
    trees = add_trained_trials(
        store, tmp_path_factory.mktemp("params"), TEMPLATE.read_bytes(),
        "TorchViT", KNOBS,
        [vit.init(np.random.default_rng(20 + i), cfg) for i in range(2)])
    broker = InProcessBroker()
    workers = []
    for i, tid in enumerate(trees):
        ready = threading.Event()
        ctx = ServiceContext(f"worker-{i}", chips=["cpu"], on_ready=ready.set)
        thread = threading.Thread(
            target=InferenceWorker(JOB, tid, store, broker).start,
            args=(ctx,), daemon=True)
        thread.start()
        workers.append((ctx, thread, ready))
    for ctx, thread, ready in workers:
        assert ready.wait(60), f"{ctx.service_id} not ready"
    predictor = Predictor(JOB, broker, "IMAGE_CLASSIFICATION",
                          {ctx.service_id: tid for (ctx, _, _), tid
                           in zip(workers, trees)})
    # a trusted-network door: the tests post without tokens
    server = PredictorServer(predictor, app="vit", auth=False).start()
    try:
        yield (f"http://127.0.0.1:{server.port}", trees, cfg)
    finally:
        server.stop()
        for ctx, _, _ in workers:
            ctx.stop_event.set()
            broker.unregister_worker(JOB, ctx.service_id)
        for ctx, thread, _ in workers:
            thread.join(timeout=10)
            assert not thread.is_alive(), ctx.service_id


def _jax_ensemble(trees, images):
    probs = [np.asarray(jax.nn.softmax(jvit.apply(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(images),
        jvit.tiny()), axis=-1)) for tree in trees.values()]
    return np.mean(probs, axis=0)


def _images(seed, n):
    return np.random.default_rng(seed).standard_normal(
        (n, 32, 32, 3)).astype(np.float32)


def test_answers_equal_jax_ensemble(stack):
    url, trees, cfg = stack
    images = _images(1, 5)
    probs = post_npy(url + "/predict", images)
    assert probs.shape == (5, cfg.num_classes)
    np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(probs, _jax_ensemble(trees, images),
                               atol=PROB_ATOL, rtol=0)


def test_padding_to_bucket_does_not_change_answers(stack):
    """3 queries are padded (by repeating the last) to bucket 8; an
    8-query request is not padded. Both run the same bucket shape on the
    same deterministic CPU kernels, so the first 3 rows agree to the last
    bits."""
    url, _, _ = stack
    images = _images(2, 8)
    padded = post_npy(url + "/predict", images[:3])
    full = post_npy(url + "/predict", images)
    np.testing.assert_allclose(padded, full[:3], atol=1e-6, rtol=0)


def test_npy_and_json_bodies_agree(stack):
    url, _, cfg = stack
    images = _images(3, 2)
    code, _, body = post_json(url + "/predict",
                              {"queries": images.tolist(), "timeout_s": 30})
    assert code == 200, body
    as_json = np.asarray(json.loads(body)["data"]["predictions"])
    as_npy = post_npy(url + "/predict", images)
    assert as_json.shape == (2, cfg.num_classes)
    np.testing.assert_allclose(as_json, as_npy, atol=1e-7, rtol=0)


def test_healthz(stack):
    url, _, _ = stack
    with urllib.request.urlopen(url + "/healthz", timeout=10) as resp:
        health = json.loads(resp.read())
    assert health["status"] == "ok" and health["workers"] == 2
    assert set(health["queue_depths"]) == {"worker-0", "worker-1"}


@pytest.mark.parametrize("label,path,body,ctype,code", [
    ("bad json", "/predict", b"{nope", "application/json", 400),
    ("not an object", "/predict", b"[1, 2]", "application/json", 400),
    ("no queries", "/predict", b'{"queries": []}', "application/json", 400),
    ("bad timeout", "/predict", b'{"queries": [1], "timeout_s": -1}',
     "application/json", 400),
    ("bad npy", "/predict", b"\x93NUMPY garbage", "application/x-npy", 400),
    ("wrong route", "/nowhere", b'{"queries": [1]}', "application/json",
     404),
])
def test_malformed_requests_are_refused(stack, label, path, body, ctype,
                                        code):
    url, _, _ = stack
    got, _, payload = _post(url + path, body, {"Content-Type": ctype})
    assert got == code, (label, payload)
    assert "error" in json.loads(payload)


def test_request_limits(stack, monkeypatch):
    url, _, _ = stack
    monkeypatch.setenv("RAFIKI_PREDICT_QUEUE_DEPTH", "2")
    got, _, _ = post_json(url + "/predict", {"queries": [1, 2, 3]})
    assert got == 400  # more queries than any queue can hold
    monkeypatch.setattr(config, "PREDICT_MAX_BODY_MB", 1e-4)
    got, _, _ = post_json(url + "/predict", {"queries": list(range(100))})
    assert got == 413


@pytest.mark.parametrize("cap", [1, 8, 20, 48, 64, 256])
def test_bucket_ladder_matches_jax(cap):
    """The JAX trainer's ladder on one device (``round_batch`` is then the
    identity), called on a stand-in for its ``self``."""
    fake = types.SimpleNamespace(MIN_PREDICT_BUCKET=8,
                                 round_batch=lambda b: b)
    trainer = DataParallelTrainer(device="cpu")
    assert trainer.predict_buckets(cap) == \
        JaxDataParallelTrainer.predict_buckets(fake, cap)


def test_serving_settings_match_jax():
    for name in ("PREDICT_MAX_BATCH_SIZE", "PREDICT_BATCH_DEADLINE_MS",
                 "PREDICT_TIMEOUT_S", "PREDICT_MAX_BODY_MB",
                 "PREDICT_QUEUE_DEPTH"):
        assert getattr(config, name) == getattr(jax_config, name), name


def test_bucket_ladder():
    trainer = DataParallelTrainer(predict_fn=lambda model, x: x * 2,
                                  device="cpu")
    assert trainer.predict_buckets(64) == [8, 16, 32, 64]
    assert trainer.predict_buckets(48) == [8, 16, 32, 48]
    assert [trainer._bucket_for(n, 64) for n in (1, 8, 9, 33, 64)] == [
        8, 8, 16, 64, 64]
    x = np.arange(70, dtype=np.float32)[:, None]
    chunks = list(trainer._bucket_chunks(x, 64))
    assert [(len(c), pad) for c, pad in chunks] == [(64, 0), (8, 2)]
    assert (chunks[1][0][-3:] == 69).all()  # padded by repeating the last
    np.testing.assert_array_equal(trainer.predict_batched(None, x, 64), x * 2)
    assert trainer.warm_predict(None, np.zeros(1, np.float32), 64) == 4


def test_worker_queue_bounds_and_expiry():
    q = WorkerQueue(max_depth=3)
    q.submit_many([1, 2])
    with pytest.raises(QueueFullError):
        q.submit_many([3, 4])  # refused whole, never split
    stale = q.submit_many([5], deadline=time.monotonic() - 1)
    batch = q.take_batch(max_size=8, deadline_s=0.0)
    assert [query for _, query in batch] == [1, 2]
    with pytest.raises(TimeoutError):
        stale[0].result(0)
    assert q.stats() == {"depth": 0, "expired": 1, "rejected": 2}
    q.close()
    assert q.take_batch(max_size=8, deadline_s=0.0) is None


def test_predictor_fails_over_within_a_trial_and_ensembles():
    """Replicas a and b serve trial t1, c serves t2. The replica asked
    first for t1 fails; its twin answers; the two trials are averaged."""
    broker = InProcessBroker()
    queues = {w: broker.register_worker("j", w) for w in "abc"}
    predictor = Predictor("j", broker, "IMAGE_CLASSIFICATION",
                          {"a": "t1", "b": "t1", "c": "t2"})
    answers = {"b": [0.2, 0.8], "c": [0.6, 0.4]}
    stop = threading.Event()

    def serve(wid):
        while not stop.is_set():
            batch = queues[wid].take_batch(8, 0.0, wait_timeout_s=0.05)
            for fut, _ in batch or []:
                if wid == "a":
                    fut.set_error(RuntimeError("replica a is broken"))
                else:
                    fut.set_result(answers[wid])

    threads = [threading.Thread(target=serve, args=(w,), daemon=True)
               for w in "abc"]
    for t in threads:
        t.start()
    try:
        for _ in range(2):  # round robin starts once at a, once at b
            preds = predictor.predict_batch(["x"], timeout_s=10)
            np.testing.assert_allclose(preds[0], [0.4, 0.6])
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=5)
    assert not any(t.is_alive() for t in threads)


def test_ensemble_and_short_batches():
    assert ensemble_predictions([[0.0, 1.0], [1.0, 0.0]],
                                "IMAGE_CLASSIFICATION") == [0.5, 0.5]
    assert ensemble_predictions(["cat", "dog"], "POS_TAGGING") == "cat"
    futs = WorkerQueue().submit_many([0, 1])
    _resolve_batch(futs, [7], "w")
    assert futs[0].result(0) == 7
    with pytest.raises(RuntimeError):
        futs[1].result(0)
