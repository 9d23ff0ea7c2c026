"""Text classification in the port: the corpus zip, BERT and ``TorchBert``,
held against the JAX package.

- The corpus zip (``sdk/dataset.py``) round trips both ways across the
  packages, and a zip without ``corpus.tsv`` is refused typed.
- ``models/bert.py`` against ``rafiki_tpu/models/bert.py`` on one seeded
  tree carried by ``convert.py``: in bf16, as both packages compute it,
  within ``LOGIT_ATOL`` (the ViT's); with the embedding's compute type
  switched to f32 on both sides, within ``F32_ATOL``.
- ``templates/torch_bert.py`` against
  ``examples/models/text_classification/JaxBert.py``: the same hashed ids;
  each trained on the same corpus with the same knobs scores within
  ``SCORE_ATOL`` of the other; each one's trained parameters served by the
  other answer within ``PROB_ATOL`` (bf16 forwards) of its own answers.
- A 2-trial ``TorchBert`` job through the port's admin on the CPU, served.
"""

import importlib.util
import os
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rafiki_tpu.models import bert as jbert
from rafiki_tpu.models import core as jcore
from rafiki_tpu.sdk import dataset as jdataset
from rafiki_tpu_torch import config, convert
from rafiki_tpu_torch.admin.admin import Admin
from rafiki_tpu_torch.db.database import Database
from rafiki_tpu_torch.device import set_device_grant
from rafiki_tpu_torch.models import bert, core
from rafiki_tpu_torch.placement.manager import (
    ChipAllocator,
    LocalPlacementManager,
)
from rafiki_tpu_torch.sdk import dataset
from rafiki_tpu_torch.sdk import model as sdk_model
from rafiki_tpu_torch.sdk.params import dump_params, load_params
from rafiki_tpu_torch.sdk.torch_backend import trainer_cache_clear
from rafiki_tpu_torch.templates import torch_bert
from rafiki_tpu_torch.templates.torch_bert import TorchBert

LOGIT_ATOL = 2.5e-2
F32_ATOL = 1e-5
# two separable classes: either package's training reaches the same
# accuracy on them
SCORE_ATOL = 0.1
PROB_ATOL = 2.5e-2
HERE = os.path.dirname(__file__)
JAX_BERT = os.path.join(HERE, "..", "examples", "models",
                        "text_classification", "JaxBert.py")
KNOBS = {"depth": 2, "heads": 2, "dim": 64, "learning_rate": 3e-3,
         "epochs": 2, "batch_size": 16, "max_len": 64, "vocab": 4096}
POOLS = (["alpha", "beta", "gamma", "delta"],
         ["omega", "sigma", "lambda", "kappa"])


def _jax_bert_module():
    spec = importlib.util.spec_from_file_location("jax_bert_example",
                                                  JAX_BERT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _sentences(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        cls = i % 2
        toks = [str(t) for t in rng.choice(POOLS[cls],
                                           size=rng.integers(3, 10))]
        out.append((toks, [[f"class{cls}"]] * len(toks)))
    return out


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    return (dataset.write_corpus_dataset(_sentences(160, 0),
                                         str(d / "train.zip")),
            dataset.write_corpus_dataset(_sentences(40, 1),
                                         str(d / "test.zip")))


# -- the corpus zip ---------------------------------------------------------------

def test_corpus_round_trips_across_the_packages(tmp_path):
    sentences = _sentences(12, 2) + [(["x", "y"], [["c", "t1"], ["d", "t2"]])]
    ours = dataset.write_corpus_dataset(sentences, str(tmp_path / "a.zip"))
    theirs = jdataset.write_corpus_dataset(sentences,
                                           str(tmp_path / "b.zip"))
    for path in (ours, theirs):
        for ds in (dataset.CorpusDataset(path),
                   jdataset.CorpusDataset(path)):
            assert [(list(t), [list(r) for r in g]) for t, g in ds] == [
                (list(t), [list(r) for r in g]) for t, g in sentences]
    a, b = dataset.CorpusDataset(ours), jdataset.CorpusDataset(theirs)
    assert (a.size, a.max_len, a.tag_num_classes, a.tag_vocabs) == (
        b.size, b.max_len, b.tag_num_classes, b.tag_vocabs)
    with zipfile.ZipFile(ours) as za, zipfile.ZipFile(theirs) as zb:
        assert za.read("corpus.tsv") == zb.read("corpus.tsv")
    assert dataset.dataset_utils.load_dataset_of_corpus(ours).size == 13


def test_corpus_without_its_table_is_refused_typed(tmp_path):
    path = tmp_path / "bad.zip"
    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr("other.tsv", "a\tb\n")
    with pytest.raises(dataset.InvalidDatasetError, match="corpus.tsv"):
        dataset.CorpusDataset(str(path))
    (tmp_path / "junk.zip").write_bytes(b"not a zip")
    with pytest.raises(dataset.InvalidDatasetError, match="zip"):
        dataset.CorpusDataset(str(tmp_path / "junk.zip"))


# -- the model ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def tree():
    cfg = bert.tiny(vocab=100, max_len=16, dim=32, depth=2, heads=2)
    return cfg, bert.init(np.random.default_rng(0), cfg)


def _jcfg():
    return jbert.tiny(vocab=100, max_len=16, dim=32, depth=2, heads=2)


def test_init_matches_jax_layout_and_round_trips(tree):
    cfg, t = tree
    jtree = jbert.init(jax.random.key(0), _jcfg())
    shapes = lambda x: {  # noqa: E731
        jax.tree_util.keystr(p): v.shape
        for p, v in jax.tree_util.tree_flatten_with_path(x)[0]}
    assert shapes(t) == shapes(jtree)
    back = convert.to_jax_params(convert.from_jax_params(t, cfg, "cpu"))
    assert shapes(back) == shapes(t)
    for (_, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(back)[0],
                              jax.tree_util.tree_flatten_with_path(t)[0]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("f32", [False, True])
def test_apply_matches_jax(tree, monkeypatch, f32):
    cfg, t = tree
    if f32:
        jemb, emb = jcore.embedding, core.embedding
        monkeypatch.setattr(
            jcore, "embedding",
            lambda p, ids, dtype=None: jemb(p, ids, jnp.float32))
        monkeypatch.setattr(
            core, "embedding",
            lambda p, ids, dtype=None: emb(p, ids, torch.float32))
    ids = np.random.default_rng(1).integers(0, 100, (4, 16)).astype(
        np.int32)
    ids[:, 10:] = 0  # padding is attended like any token, in both
    want = np.asarray(jbert.apply(jax.tree.map(jnp.asarray, t),
                                  jnp.asarray(ids), _jcfg()))
    model = convert.from_jax_params(t, cfg, "cpu")
    with torch.inference_mode():
        got = model(torch.from_numpy(ids))
    assert got.dtype == torch.float32 and got.shape == (4, 2)
    np.testing.assert_allclose(got.numpy(), want,
                               atol=F32_ATOL if f32 else LOGIT_ATOL, rtol=0)


# -- the template ---------------------------------------------------------------------

def test_hash_ids_match_jax_bert():
    jb = _jax_bert_module()
    for tokens in (["Alpha", "beta", "ÜBER"], [], ["x"] * 80):
        np.testing.assert_array_equal(torch_bert._hash_ids(tokens, 4096, 64),
                                      jb._hash_ids(tokens, 4096, 64))


@pytest.fixture(scope="module")
def trained(corpus):
    """(JaxBert, TorchBert), each trained on the corpus with KNOBS."""
    train, _ = corpus
    jax_model = _jax_bert_module().JaxBert(**KNOBS)
    jax_model.train(train)
    set_device_grant(["cpu"])
    try:
        torch_model = TorchBert(**KNOBS)
        torch_model.train(train)
    finally:
        set_device_grant(None)
    return jax_model, torch_model


def test_scores_match_jax_bert(corpus, trained):
    _, test = corpus
    jax_model, torch_model = trained
    js, ts = float(jax_model.evaluate(test)), float(torch_model.evaluate(test))
    assert ts > 0.9 and abs(ts - js) <= SCORE_ATOL, (ts, js)


def test_each_package_serves_the_other_ones_parameters(trained):
    jax_model, torch_model = trained
    queries = ["alpha beta gamma", "omega sigma kappa", ["delta", "kappa"]]
    jb = _jax_bert_module()
    # JAX-trained parameters in the port
    ported = TorchBert(**KNOBS)
    set_device_grant(["cpu"])
    try:
        ported.load_parameters(load_params(dump_params(
            jax_model.dump_parameters())))
    finally:
        set_device_grant(None)
    np.testing.assert_allclose(ported.predict(queries),
                               jax_model.predict(queries),
                               atol=PROB_ATOL, rtol=0)
    # the port's parameters in JAX
    back = jb.JaxBert(**KNOBS)
    back.load_parameters(torch_model.dump_parameters())
    mine = np.asarray(torch_model.predict(queries))
    np.testing.assert_allclose(back.predict(queries), mine, atol=PROB_ATOL,
                               rtol=0)
    assert (mine.argmax(-1)[:2] == [0, 1]).all()


def test_model_class_contract(corpus):
    train, test = corpus
    set_device_grant(["cpu"])
    try:
        preds = sdk_model.test_model_class(
            clazz=TorchBert, task="TEXT_CLASSIFICATION",
            train_dataset_uri=train, test_dataset_uri=test,
            queries=["alpha beta", "omega sigma"], knobs=dict(KNOBS))
    finally:
        set_device_grant(None)
    assert np.allclose(np.sum(preds, -1), 1.0, atol=1e-5)


def test_two_trial_job_through_the_admin(corpus, tmp_path):
    train, test = corpus
    trainer_cache_clear()
    with open(torch_bert.__file__, "rb") as f:
        source = f.read()
    admin = Admin(db=Database(":memory:"),
                  placement=LocalPlacementManager(ChipAllocator(["cpu"])),
                  params_dir=str(tmp_path))
    try:
        uid = admin.authenticate_user(config.SUPERADMIN_EMAIL,
                                      config.SUPERADMIN_PASSWORD)["user_id"]
        model = admin.create_model(uid, "bert", "TEXT_CLASSIFICATION",
                                   source, "TorchBert")
        assert model["verification"]["ok"]
        admin.create_train_job(uid, "txt", "TEXT_CLASSIFICATION", train,
                               test, budget={"MODEL_TRIAL_COUNT": 2})
        job = admin.wait_until_train_job_stopped(uid, "txt", timeout_s=300)
        assert job["status"] == "STOPPED"
        trials = admin.get_trials_of_train_job(uid, "txt")
        assert [t["status"] for t in trials] == ["COMPLETED"] * 2
        assert all(0.0 <= t["score"] <= 1.0 for t in trials), trials
        inf = admin.create_inference_job(uid, "txt")
        assert inf["status"] == "RUNNING" and len(inf["workers"]) == 2
        queries = ["alpha gamma", "sigma lambda kappa"]
        served = np.asarray(admin.predict(uid, "txt", queries))
        # the ensemble is the mean of the trials' own answers
        own = []
        set_device_grant(["cpu"])
        try:
            for t in trials:
                m = TorchBert(**t["knobs"])
                m.load_parameters(load_params(
                    admin.get_trial_params(t["id"])))
                own.append(np.asarray(m.predict(queries)))
        finally:
            set_device_grant(None)
        np.testing.assert_allclose(served, np.mean(own, 0), atol=1e-5,
                                   rtol=0)
        admin.stop_inference_job(uid, "txt")
    finally:
        admin.shutdown()
