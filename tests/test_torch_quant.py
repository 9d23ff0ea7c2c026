"""Weight-only int8 serving in the port (``sdk/quant.py`` and the int8 seams
of ``sdk/torch_backend.py``), held against ``rafiki_tpu/sdk/quant.py`` and
the JAX ``DataParallelTrainer``.

- ``quantize_pytree`` on JAX-layout trees: the int8 values and the scales
  equal JAX's bit for bit, for f32 and bf16 kernels (a bf16 kernel's
  scale and its dequantized weights stay bf16); small, integer and 1-D
  leaves pass through; ``quantized_bytes`` equals JAX's.
- ``quantize_jax_layout`` / ``quantize_module`` on a tiny BERT (stacked
  blocks) and a tiny CNN (OIHW kernels): the JAX tree's int8 values and
  scales exactly, and the module's dequantized weights are the JAX
  dequantized tree's, in the port's layout.
- ``DataParallelTrainer(serve_int8=True)`` against the JAX trainer on the
  same BERT weights (attention on the path), with both packages'
  embeddings computing in f32 inside the test: logits within
  ``F32_ATOL``; against its own float forward by JAX's own rule
  (``tests/test_quant.py``: argmax agreement >= 0.99, logits within
  0.15); the ``_qcache`` identity rule (one copy a module, dropped by a
  train step and with the module); the ``RAFIKI_SERVE_INT8`` switch;
  the fused int8 forward of two trials equal to each trial's solo int8
  forward (within ``FUSED_ATOL``).
"""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rafiki_tpu.models import bert as jbert
from rafiki_tpu.models import core as jcore
from rafiki_tpu.sdk import jax_backend
from rafiki_tpu.sdk import quant as jquant
from rafiki_tpu_torch import convert
from rafiki_tpu_torch.models import bert, core
from rafiki_tpu_torch.sdk import quant, torch_backend
from rafiki_tpu_torch.templates import torch_cnn

#: f32 forwards of the same int8 weights in both packages (measured
#: 1.2e-6)
F32_ATOL = 1e-5
#: the stacked (vmapped) forward against one trial's, f32: batched
#: products may reduce in another order (measured 0 on the CPU)
FUSED_ATOL = 1e-5
#: JAX's rule for int8 against float serving (tests/test_quant.py)
INT8_AGREE = 0.99
INT8_ATOL = 0.15

BERT = dict(vocab=200, max_len=16, dim=64, depth=2, heads=2)


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def _flat(tree, prefix=""):
    if isinstance(tree, dict) and not jquant.is_quantized_leaf(tree) \
            and not quant.is_quantized_leaf(tree):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix.rstrip("/"): tree}


def _same_qleaf(ours, theirs):
    assert quant.is_quantized_leaf(ours) and jquant.is_quantized_leaf(theirs)
    np.testing.assert_array_equal(ours["q"].cpu().numpy(),
                                  np.asarray(theirs["q"]))
    assert str(ours["scale"].dtype).split(".")[-1] == str(
        theirs["scale"].dtype)
    np.testing.assert_array_equal(
        ours["scale"].float().cpu().numpy(),
        np.asarray(theirs["scale"]).astype(np.float32))


# -- the tree functions ----------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_pytree_equals_jax(dtype):
    rng = np.random.default_rng(0)
    tree = {
        # wildly different per-channel ranges
        "w": (rng.normal(size=(256, 64)) * np.geomspace(0.01, 10.0, 64)
              ).astype(np.float32),
        "conv": rng.normal(size=(3, 3, 16, 32)).astype(np.float32),
        "stacked": rng.normal(size=(4, 64, 2, 32)).astype(np.float32),
        "b": np.ones(64, np.float32),
        "tiny": np.ones((4, 4), np.float32),
        "ints": np.ones((128, 128), np.int32),
    }
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jtree = {k: (jnp.asarray(v, jdt) if v.dtype == np.float32
                 else jnp.asarray(v)) for k, v in tree.items()}
    ttree = {k: (torch.from_numpy(v).to(tdt) if v.dtype == np.float32
                 else torch.from_numpy(v)) for k, v in tree.items()}
    theirs = jquant.quantize_pytree(jtree)
    ours = quant.quantize_pytree(ttree)
    for k in ("w", "conv", "stacked"):
        _same_qleaf(ours[k], theirs[k])
        deq = quant.dequantize_pytree(ours)[k]
        assert deq.dtype == tdt  # no silent f32 promotion at serve
        np.testing.assert_array_equal(
            deq.float().numpy(),
            np.asarray(jquant.dequantize_pytree(theirs)[k]).astype(
                np.float32))
    for k in ("b", "tiny", "ints"):
        assert ours[k] is ttree[k]
    assert quant.quantized_bytes(ours) == jquant.quantized_bytes(theirs)
    # numpy leaves quantize as well
    _same_qleaf(quant.quantize_pytree({"w": tree["w"]})["w"],
                jquant.quantize_pytree({"w": tree["w"]})["w"])


def test_roundtrip_error_is_half_a_scale_per_channel():
    rng = np.random.default_rng(1)
    w = torch.from_numpy((rng.normal(size=(256, 64))
                          * np.geomspace(0.01, 10.0, 64)).astype(np.float32))
    q = quant.quantize_pytree({"w": w})["w"]
    assert q["q"].dtype == torch.int8 and q["scale"].shape == (1, 64)
    deq = quant.dequantize_pytree(q)
    assert bool(((deq - w).abs() <= q["scale"] / 2 + 1e-9).all())


def _bert_tree():
    cfg = bert.tiny(**BERT)
    return cfg, bert.init(np.random.default_rng(0), cfg)


def _cnn_tree():
    return torch_cnn.init_params(np.random.default_rng(2), 2, 16, 3, 10)


def _cnn_model(tree):
    with torch.device("meta"):
        model = torch_cnn.Cnn(2, 16, 3, 10)
    return convert.from_jax_tree(model, tree, None, "cpu")


@pytest.mark.parametrize("family", ["bert", "cnn"])
@pytest.mark.parametrize("min_elems", [quant.MIN_ELEMS, 64])
def test_modules_quantize_in_the_jax_layout(family, min_elems):
    """A transformer's block leaves quantize stacked over the layers (one
    scale a column for every layer), a conv kernel over HWIO's O: the
    JAX tree's int8 values and scales exactly, and the module's
    dequantized weights equal JAX's dequantized tree in the port's
    layout. At 64 elements the blocks' LayerNorm leaves quantize too."""
    if family == "bert":
        cfg, tree = _bert_tree()
        model = convert.from_jax_params(tree, cfg, "cpu")
    else:
        tree = _cnn_tree()
        model = _cnn_model(tree)
    theirs = jquant.quantize_pytree(_jnp(tree), min_elems=min_elems)
    ours = quant.quantize_jax_layout(model, min_elems=min_elems)
    jflat = _flat(theirs)
    assert set(ours) == set(jflat)
    n_q = 0
    for path, leaf in jflat.items():
        if jquant.is_quantized_leaf(leaf):
            _same_qleaf(ours[path], leaf)
            n_q += 1
        else:
            assert not quant.is_quantized_leaf(ours[path]), path
    # the leaves past the gates: BERT's table, its four attention and two
    # MLP kernels (and at 64 its stacked biases and norms); the CNN's two
    # widest kernels (and at 64 every kernel)
    assert n_q >= {("bert", quant.MIN_ELEMS): 7, ("bert", 64): 12,
                   ("cnn", quant.MIN_ELEMS): 2, ("cnn", 64): 5}[
        family, min_elems]
    deq = quant.dequantize_pytree(quant.quantize_module(model, min_elems))
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(deq[name])
    back = (convert.to_jax_params(model) if family == "bert"
            else convert.to_jax_tree(model)[0])
    want = _flat(jax.tree.map(np.asarray,
                              jquant.dequantize_pytree(theirs)))
    for path, value in _flat(back).items():
        np.testing.assert_array_equal(value, want[path], err_msg=path)


# -- the trainer -------------------------------------------------------------------

@pytest.fixture()
def f32_embeddings(monkeypatch):
    jemb, emb = jcore.embedding, core.embedding
    monkeypatch.setattr(jcore, "embedding",
                        lambda p, ids, dtype=None: jemb(p, ids, jnp.float32))
    monkeypatch.setattr(core, "embedding",
                        lambda p, ids, dtype=None: emb(p, ids, torch.float32))


def _ids(n=8, seed=1):
    ids = np.random.default_rng(seed).integers(
        2, BERT["vocab"], (n, BERT["max_len"])).astype(np.int32)
    ids[:, 0] = 1
    ids[:, 12:] = 0
    return ids


def _port_trainer(serve_int8=None):
    return torch_backend.DataParallelTrainer(
        torch_backend.softmax_classifier_loss(lambda m, x: m(x)),
        torch_backend.tunable_optimizer(torch.optim.AdamW, lr=1e-3),
        predict_fn=lambda m, ids: m(ids), device="cpu",
        serve_int8=serve_int8)


def test_int8_serving_matches_the_jax_trainer(f32_embeddings):
    cfg, tree = _bert_tree()
    jcfg = jbert.tiny(**BERT)
    jt = jax_backend.DataParallelTrainer(
        jax_backend.softmax_classifier_loss(
            lambda p, x: jbert.apply(p, x, jcfg)),
        optax.adamw(1e-3), predict_fn=lambda p, x: jbert.apply(p, x, jcfg),
        serve_int8=True)
    ids = _ids()
    want = np.asarray(jt.predict_batched(_jnp(tree), ids, batch_size=8))
    model = convert.from_jax_params(tree, cfg, "cpu")
    t8 = _port_trainer(serve_int8=True)
    got = t8.predict_batched(model, ids, batch_size=8)
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)
    # against the float forward, by JAX's rule
    ref = _port_trainer(serve_int8=False).predict_batched(model, ids,
                                                          batch_size=8)
    assert (got.argmax(-1) == ref.argmax(-1)).mean() >= INT8_AGREE
    np.testing.assert_allclose(got, ref, atol=INT8_ATOL, rtol=0)
    assert not np.array_equal(got, ref)  # the int8 weights were used


def test_the_int8_copy_tracks_the_params_identity():
    cfg, tree = _bert_tree()
    model = convert.from_jax_params(tree, cfg, "cpu")
    t8 = _port_trainer(serve_int8=True)
    ids = _ids()
    out1 = t8.predict_batched(model, ids, batch_size=8)
    q1 = t8._qcache[model]
    t8.predict_batched(model, ids, batch_size=8)
    assert t8._qcache[model] is q1  # the same object: no re-quantization
    # a new module (the next trial, or another worker's on the same
    # cached trainer): its own copy, beside the first one's
    model2 = convert.from_jax_params(
        jax.tree.map(lambda a: a * 2.0, tree), cfg, "cpu")
    out2 = t8.predict_batched(model2, ids, batch_size=8)
    assert t8._qcache[model] is q1 and t8._qcache[model2] is not q1
    assert not np.allclose(out1, out2)
    # training the module in place drops its copy of the old weights
    opt = t8.optimizer(model.parameters())
    labels = torch.zeros(len(ids), dtype=torch.long)
    t8.train_step(model, opt, (torch.from_numpy(ids), labels))
    assert model not in t8._qcache
    out3 = t8.predict_batched(model, ids, batch_size=8)
    assert t8._qcache[model] is not q1 and not np.array_equal(out1, out3)
    # a module that is gone takes its copy with it
    del model2
    gc.collect()
    assert len(t8._qcache) == 1


def test_the_env_switch_turns_int8_on(monkeypatch):
    monkeypatch.setenv("RAFIKI_SERVE_INT8", "1")
    assert _port_trainer().serve_int8 is True
    assert _port_trainer(serve_int8=False).serve_int8 is False
    monkeypatch.delenv("RAFIKI_SERVE_INT8")
    assert _port_trainer().serve_int8 is False
    assert quant.serve_int8_enabled() is jquant.serve_int8_enabled() is False


def test_fused_int8_equals_each_trials_solo_int8(f32_embeddings):
    """Each trial is quantized on its own and the int8 values and scales
    stacked: the vmapped forward (K1 folded over both trials' rows on
    the card) answers as each trial alone."""
    cfg, tree = _bert_tree()
    other = bert.init(np.random.default_rng(9), cfg)
    models = [convert.from_jax_params(t, cfg, "cpu") for t in (tree, other)]
    t8 = _port_trainer(serve_int8=True)
    stacked = t8.stack_ensemble_params(models)
    wq = stacked.params["model.blocks.0.attn.wq"]
    assert quant.is_quantized_leaf(wq) and wq["q"].shape[0] == 2
    ids = _ids(12)
    fused = t8.predict_batched_stacked(stacked, ids, batch_size=8)
    assert fused.shape == (2, 12, 2)
    for i, m in enumerate(models):
        np.testing.assert_allclose(fused[i],
                                   t8.predict_batched(m, ids, batch_size=8),
                                   atol=FUSED_ATOL, rtol=0)
