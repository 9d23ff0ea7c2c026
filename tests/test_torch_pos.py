"""The port's part-of-speech taggers against the JAX package's.

- ``models/bilstm.py`` against ``rafiki_tpu.models.bilstm``: logits on a
  padded batch (trailing and leading padding, a one-token sentence) at
  every position, padding included (1e-5), and the masked per-token
  loss's gradients per leaf (1e-4 relative L2; embed 16, hidden 24, T 12);
- ``TorchBiLstm``'s loss over 2 gloo ranks is the global batch's masked
  mean (the rank-side function lives here, at module level: a follower
  imports this module by name to run it);
- ``TorchBiLstm`` against ``JaxBiLstm``: both learn the toy grammar of
  ``tests/test_examples.py``, and the port serves the JAX template's
  trained parameters with the same tags;
- ``NpBigramHmm`` against ``BigramHmm``: identical tables, Viterbi tags
  and scores, through the port's artifact;
- ``POS_TAGGING`` through the port's admin on the CPU: a job of both
  templates under thread placement, and the HMM under process placement
  (every worker a child process), deployed and answering ``/predict``.
"""

import importlib.util
import random
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rafiki_tpu.models import bilstm as jbilstm
from rafiki_tpu_torch import config
from rafiki_tpu_torch.admin.admin import Admin
from rafiki_tpu_torch.admin.http import AdminServer
from rafiki_tpu_torch.client.client import Client
from rafiki_tpu_torch.convert import from_jax_tree
from rafiki_tpu_torch.db.database import Database
from rafiki_tpu_torch.device import set_device_grant
from rafiki_tpu_torch.models import bilstm
from rafiki_tpu_torch.parallel import ranks
from rafiki_tpu_torch.placement.manager import (
    ChipAllocator,
    LocalPlacementManager,
)
from rafiki_tpu_torch.placement.process import ProcessPlacementManager
from rafiki_tpu_torch.sdk import params as sdk_params
from rafiki_tpu_torch.sdk import torch_backend
from rafiki_tpu_torch.sdk.dataset import write_corpus_dataset
from rafiki_tpu_torch.templates import torch_bilstm
from rafiki_tpu_torch.templates.np_bigram_hmm import NpBigramHmm

ROOT = Path(__file__).resolve().parents[1]
CFG = dict(vocab=50, n_tags=7, embed_dim=16, hidden=24, max_len=12)
FWD_ATOL = 1e-5
GRAD_RTOL = 1e-4
#: pinned knobs for the learning checks (the JAX twin's knob names)
KNOBS = {"epochs": 10, "word_embed_dims": 16, "word_rnn_hidden_size": 24,
         "word_dropout": 1e-3, "learning_rate": 5e-2, "batch_size": 16}
BUDGET_S = 300


def _load(rel: str, name: str):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / "models" / rel)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _batch(seed=1):
    """Ids and a mask over T=12: full, short, one token, leading
    padding, empty."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, CFG["vocab"], (5, 12)).astype(np.int32)
    lens = np.array([12, 5, 1, 8, 0])
    mask = (np.arange(12)[None] < lens[:, None]).astype(np.float32)
    mask[3, :2] = 0.0
    tags = rng.integers(0, CFG["n_tags"], (5, 12)).astype(np.int32)
    return ids, mask, tags


def _port_model(tree):
    with torch.device("meta"):
        model = bilstm.BiLstm(bilstm.BiLstmConfig(**CFG))
    return from_jax_tree(model, tree, device="cpu", train=True)


def test_bilstm_apply_matches_jax_at_every_position():
    tree = bilstm.init(np.random.default_rng(0), bilstm.BiLstmConfig(**CFG))
    ids, mask, _ = _batch()
    got = _port_model(tree)(torch.from_numpy(ids), torch.from_numpy(mask))
    ref = jbilstm.apply(jax.tree.map(jnp.asarray, tree), jnp.asarray(ids),
                        jnp.asarray(mask), jbilstm.BiLstmConfig(**CFG))
    assert got.shape == (5, 12, CFG["n_tags"]) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=FWD_ATOL, rtol=0)


def test_bilstm_masked_loss_gradients_match_jax():
    """``TorchBiLstm``'s loss against ``JaxBiLstm``'s, written out."""
    cfg = bilstm.BiLstmConfig(**CFG)
    tree = bilstm.init(np.random.default_rng(2), cfg)
    ids, mask, tags = _batch(3)
    model = _port_model(tree)
    loss, _ = torch_bilstm._loss(model, tuple(
        torch.from_numpy(a) for a in (ids, mask, tags)))
    loss.backward()

    def jloss(params):
        logits = jbilstm.apply(params, jnp.asarray(ids), jnp.asarray(mask),
                               jbilstm.BiLstmConfig(**CFG))
        logp = jax.nn.log_softmax(logits, axis=-1)
        nll = -jnp.take_along_axis(logp, jnp.asarray(tags)[..., None],
                                   axis=-1)[..., 0]
        return jnp.sum(nll * mask) / jnp.maximum(jnp.sum(mask), 1.0)

    ref_loss, ref_grads = jax.value_and_grad(jloss)(
        jax.tree.map(jnp.asarray, tree))
    assert float(loss) == pytest.approx(float(ref_loss), rel=GRAD_RTOL)
    ref = sdk_params.flatten(jax.tree.map(np.asarray, ref_grads))
    for name, p in model.named_parameters():
        r = ref[name.replace(".", "/")]
        err = np.linalg.norm(p.grad.numpy() - r) / np.linalg.norm(r)
        assert err <= GRAD_RTOL, (name, err)


@pytest.fixture(scope="module")
def world2():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAFIKI_DIST_TIMEOUT_S", "120")
        mp.setenv("OMP_NUM_THREADS", "1")
        with ranks.Ranks(["cpu:0", "cpu:1"]) as r:
            yield r


def rank_masked_loss(tree: dict, ids, mask, tags) -> dict:
    """``TorchBiLstm``'s loss and averaged gradients on this rank's half
    of the batch (the whole batch alone), as ``DataParallelTrainer``
    takes a step."""
    group = ranks.current_group()
    model = _port_model(tree)
    part = slice(None)
    if group is not None:
        half = len(ids) // group.size
        part = slice(group.rank * half, (group.rank + 1) * half)
    loss, _ = torch_bilstm._loss(model, tuple(
        torch.from_numpy(a[part]) for a in (ids, mask, tags)))
    loss.backward()
    loss = loss.detach().reshape(1)
    if group is not None:
        torch_backend.DataParallelTrainer._average_grads(model, group)
        loss = group.all_reduce_(loss) / group.size
    return {"loss": float(loss),
            "grads": {n: p.grad.numpy() for n, p in model.named_parameters()}}


def test_masked_loss_over_two_ranks_is_the_global_batchs(world2):
    """Over ranks the loss stays the global batch's masked mean: the two
    halves hold 24 and 15 tokens, so a mean of the halves' own means
    would differ (1e-6 relative)."""
    tree = bilstm.init(np.random.default_rng(4), bilstm.BiLstmConfig(**CFG))
    ids, mask, tags = _batch(5)
    ids, mask, tags = (np.concatenate([a, a[:1], a[1:2], a[2:3]])
                       for a in (ids, mask, tags))
    assert mask[:4].sum() != mask[4:].sum()
    alone = rank_masked_loss(tree, ids, mask, tags)
    set_device_grant(world2.devices)
    ranks.set_group(world2.group)
    try:
        out = world2.run(rank_masked_loss, tree, ids, mask, tags)
    finally:
        ranks.set_group(None)
        set_device_grant(None)
    for r in out:
        assert r["loss"] == pytest.approx(alone["loss"], rel=1e-6)
        for k, g in alone["grads"].items():
            np.testing.assert_allclose(r["grads"][k], g, rtol=1e-5,
                                       atol=1e-7, err_msg=k)


def _toy_corpus(tmp_path):
    """``tests/test_examples.py``'s toy grammar."""
    random.seed(0)
    nouns, verbs, dets = ["cat", "dog", "tree"], ["runs", "sees"], ["the", "a"]
    sents = []
    for _ in range(60):
        toks = [random.choice(dets), random.choice(nouns),
                random.choice(verbs)]
        sents.append((toks, [["DT"], ["NN"], ["VB"]]))
    train = write_corpus_dataset(sents, str(tmp_path / "train.zip"))
    test = write_corpus_dataset(sents[:20], str(tmp_path / "test.zip"))
    return train, test


QUERIES = [["the", "cat", "runs"], ["a", "dog"], ["The", "unseen", "sees"],
           ["tree"] * 5]


def test_torch_bilstm_learns_and_serves_the_jax_parameters(tmp_path):
    """Both twins learn the toy grammar (score 1.0 with pinned knobs); the
    port loaded with ``JaxBiLstm``'s dump (its word dictionary as the
    port's word list) tags as the JAX template does."""
    train, test = _toy_corpus(tmp_path)
    jm = _load("pos_tagging/JaxBiLstm.py", "_jax_bilstm").JaxBiLstm(**KNOBS)
    jm.train(train)
    assert jm.evaluate(test) == 1.0
    dump = jm.dump_parameters()
    words = sorted(dump["word_vocab"], key=dump["word_vocab"].get)
    blob = {"params": jax.tree.map(np.asarray, dump["params"]),
            "words": words, "tag_vocab": dump["tag_vocab"],
            "max_len": dump["max_len"], "embed_dim": dump["embed_dim"],
            "hidden": dump["hidden"]}
    set_device_grant(["cpu"])
    try:
        served = torch_bilstm.TorchBiLstm(**KNOBS)
        served.load_parameters(sdk_params.load_params(
            sdk_params.dump_params(blob)))
        assert served.predict(QUERIES) == jm.predict(QUERIES)
        assert served.evaluate(test) == 1.0
        own = torch_bilstm.TorchBiLstm(**KNOBS)
        own.train(train)
        assert own.evaluate(test) == 1.0
        assert own.predict(QUERIES[:1]) == [["DT", "NN", "VB"]]
        assert [len(p) for p in own.predict(QUERIES)] == [3, 2, 3, 3]
    finally:
        set_device_grant(None)


def test_np_bigram_hmm_equals_bigram_hmm(tmp_path):
    """Identical tables, tags and scores on a random corpus (tags drawn
    at random: many near ties) and on the toy grammar, the port's tables
    through its artifact."""
    Hmm = _load("pos_tagging/BigramHmm.py", "_bigram_hmm").BigramHmm
    rng = random.Random(1)
    words = [f"w{i}" for i in range(200)] + ["a/b", "<unk>"]
    tags = [f"T{i}" for i in range(9)]
    sents = []
    for _ in range(200):
        n = rng.randint(1, 15)
        sents.append(([rng.choice(words) for _ in range(n)],
                      [[rng.choice(tags)] for _ in range(n)]))
    for train, test in [(write_corpus_dataset(
            sents, str(tmp_path / "random.zip")), None), _toy_corpus(tmp_path)]:
        ref, ours = Hmm(), NpBigramHmm()
        ref.train(train)
        ours.train(train)
        assert (ours._trans, ours._emiss, ours._tags) == (
            ref._trans, ref._emiss, ref._tags)
        loaded = NpBigramHmm()
        loaded.load_parameters(sdk_params.load_params(
            sdk_params.dump_params(ours.dump_parameters())))
        queries = [s for s, _ in sents[:60]] + QUERIES + [[], ["W3", "zz"]]
        assert loaded.predict(queries) == ref.predict(queries)
        assert loaded.evaluate(test or train) == ref.evaluate(test or train)
    assert ref.evaluate(test) == 1.0


#: TorchBiLstm with its knobs pinned small for the CPU
TINY_BILSTM = """

class TinyBiLstm(TorchBiLstm):
    @staticmethod
    def get_knob_config():
        knobs = TorchBiLstm.get_knob_config()
        knobs.update(epochs=FixedKnob(3), word_embed_dims=FixedKnob(16),
                     word_rnn_hidden_size=FixedKnob(16),
                     batch_size=FixedKnob(16))
        return knobs
"""
#: 8 queries, none longer than the toy corpus's sentences (the BiLSTM
#: tags at most its training ``max_len`` tokens, as the JAX twin does)
SENTENCES = [["the", "cat", "runs"], ["a", "dog", "sees"], ["tree"],
             ["the", "tree"], ["a"], ["dog", "runs"],
             ["the", "unseen", "word"], ["cat", "cat", "cat"]]


def _template(name: str) -> bytes:
    return (ROOT / "rafiki_tpu_torch" / "templates" / name).read_bytes()


def _tag_cycle(c: Client, app: str, train: str, test: str, models,
               trials: int) -> list:
    c.create_train_job(app, "POS_TAGGING", train, test,
                       budget={"MODEL_TRIAL_COUNT": trials, "CHIP_COUNT": 1},
                       models=models)
    job = c.wait_until_train_job_stopped(app, timeout_s=BUDGET_S)
    assert job["status"] == "STOPPED", job
    done = c.get_trials_of_train_job(app)
    assert [t["status"] for t in done] == ["COMPLETED"] * (
        trials * len(models)), done
    assert all(0.0 <= t["score"] <= 1.0 for t in done)
    inf = c.create_inference_job(app)
    assert inf["status"] == "RUNNING"
    tags = c.predict(app, SENTENCES)
    c.stop_inference_job(app)
    assert [len(t) for t in tags] == [len(s) for s in SENTENCES]
    assert all(isinstance(t, str) for row in tags for t in row)
    return done


def test_pos_tagging_through_the_admin_under_thread_placement(tmp_path):
    train, test = _toy_corpus(tmp_path)
    admin = Admin(db=Database(str(tmp_path / "store.sqlite3")),
                  placement=LocalPlacementManager(ChipAllocator(["cpu"])),
                  params_dir=str(tmp_path / "params"))
    srv = AdminServer(admin, port=0).start()
    try:
        c = Client("127.0.0.1", srv.port, timeout_s=BUDGET_S)
        c.login(config.SUPERADMIN_EMAIL, config.SUPERADMIN_PASSWORD)
        for name, source, cls in [
                ("bilstm", _template("torch_bilstm.py") + TINY_BILSTM.encode(),
                 "TinyBiLstm"),
                ("hmm", _template("np_bigram_hmm.py"), "NpBigramHmm")]:
            assert c.create_model(name, "POS_TAGGING", source,
                                  cls)["verification"]["ok"]
        trials = _tag_cycle(c, "pos", train, test, ["bilstm", "hmm"], 1)
    finally:
        srv.stop()
        admin.shutdown()
    hmm, = [t for t in trials if t["knobs"] == {}]  # the knob-less HMM
    assert hmm["score"] == 1.0


def test_pos_tagging_through_the_admin_under_process_placement(
        tmp_path, monkeypatch):
    """The HMM's job with every worker a child process."""
    monkeypatch.setenv("RAFIKI_WORKDIR", str(tmp_path))
    monkeypatch.setenv("RAFIKI_LOGS_DIR", str(tmp_path / "logs"))
    monkeypatch.setenv("SERVICE_DEPLOY_TIMEOUT_S", str(BUDGET_S))
    monkeypatch.setenv("PREDICT_TIMEOUT_S", str(BUDGET_S))
    train, test = _toy_corpus(tmp_path)
    admin = Admin(db=Database(str(tmp_path / "store.sqlite3")),
                  params_dir=str(tmp_path / "params"),
                  placement=ProcessPlacementManager(
                      allocator=ChipAllocator(["cpu"])))
    srv = AdminServer(admin).start()
    try:
        c = Client("127.0.0.1", srv.port, timeout_s=BUDGET_S)
        c.login(config.SUPERADMIN_EMAIL, config.SUPERADMIN_PASSWORD)
        c.create_model("hmm", "POS_TAGGING", _template("np_bigram_hmm.py"),
                       "NpBigramHmm")
        trials = _tag_cycle(c, "pos", train, test, ["hmm"], 1)
    finally:
        srv.stop()
        admin.shutdown()
    assert trials[0]["score"] == 1.0
