"""The port's ViT against ``rafiki_tpu/models/vit.py`` on one parameter tree.

The tree is made with numpy from a seed in the JAX layout (blocks stacked
on a leading depth axis) and carried into the port by ``convert.py``. Both
forwards run in bf16, as the JAX package computes them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rafiki_tpu.models import vit as jvit
from rafiki_tpu_torch import convert
from rafiki_tpu_torch.models import vit
from rafiki_tpu_torch.models.transformer import TransformerConfig
from rafiki_tpu_torch.sdk.params import dump_params, load_params
from rafiki_tpu_torch.utils import jrandom

# bf16 activations through 2 blocks: the frameworks round at different
# places (matmul accumulation order, where casts fall), which moves O(1)
# logits by a few bf16 ulps (2^-8 relative each)
LOGIT_ATOL = 2.5e-2


def _flash(cfg, use_flash):
    return dataclasses.replace(
        cfg, encoder=dataclasses.replace(cfg.encoder, use_flash=use_flash))


@pytest.fixture(scope="module")
def tree_and_images():
    cfg = vit.tiny()
    tree = vit.init(np.random.default_rng(0), cfg)
    images = np.random.default_rng(1).standard_normal(
        (6, 32, 32, 3)).astype(np.float32)
    return cfg, tree, images


def test_init_matches_jax_layout(tree_and_images):
    cfg, tree, _ = tree_and_images
    jtree = jvit.init(jax.random.key(0), jvit.tiny())
    flat = {"/".join(str(k.key) for k in path): v.shape for path, v in
            jax.tree_util.tree_flatten_with_path(jtree)[0]}
    ours = {"/".join(str(k.key) for k in path): v.shape for path, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert ours == flat
    assert tree["blocks"]["attn"]["wq"].shape[0] == cfg.encoder.depth


@pytest.mark.parametrize("use_flash", [None, True])
def test_logits_match_jax(tree_and_images, use_flash):
    cfg, tree, images = tree_and_images
    jcfg = jvit.tiny()
    jcfg = dataclasses.replace(
        jcfg, encoder=dataclasses.replace(jcfg.encoder, use_flash=use_flash))
    ref = np.asarray(jvit.apply(jax.tree.map(jnp.asarray, tree),
                                jnp.asarray(images), jcfg))
    model = convert.from_jax_params(tree, _flash(cfg, use_flash), "cpu")
    with torch.inference_mode():
        out = model(torch.from_numpy(images))
    assert out.dtype == torch.float32 and out.shape == (6, cfg.num_classes)
    np.testing.assert_allclose(out.numpy(), ref, atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_array_equal(out.numpy().argmax(-1), ref.argmax(-1))


def test_convert_round_trip(tree_and_images):
    cfg, tree, _ = tree_and_images
    model = convert.from_jax_params(tree, cfg, "cpu")
    assert next(model.parameters()).dtype == torch.float32
    # the stacked depth axis is split: one Block per layer
    assert len(model.blocks) == cfg.encoder.depth
    np.testing.assert_array_equal(
        model.blocks[1].attn.wq.detach().numpy(),
        tree["blocks"]["attn"]["wq"][1])
    back = convert.to_jax_params(model)
    flat = jax.tree_util.tree_leaves_with_path(tree)
    back_flat = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat) == len(back_flat)
    for path, value in flat:
        np.testing.assert_array_equal(back_flat[path], value)


def test_convert_rejects_a_wrong_tree(tree_and_images):
    cfg, tree, _ = tree_and_images
    bad = dict(tree, head={"kernel": tree["head"]["kernel"]})  # no bias
    with pytest.raises(RuntimeError):
        convert.from_jax_params(bad, cfg, "cpu")


def test_params_npz_round_trip(tree_and_images):
    _, tree, _ = tree_and_images
    data = dump_params(tree)
    assert data[:2] == b"PK"  # an npz (zip) archive, no pickle
    back = load_params(data)
    for path, value in jax.tree_util.tree_leaves_with_path(tree):
        got = back
        for key in path:
            got = got[key.key]
        np.testing.assert_array_equal(got, value)


def test_params_refuse_pickled_arrays():
    with pytest.raises(ValueError):
        load_params(dump_params({"a": np.array([{"x": 1}], dtype=object)}))


@pytest.mark.parametrize("option", [
    dict(moe_experts=4), dict(seq_parallel="ring"), dict(pipeline="gpipe"),
    dict(remat="dots"), dict(dropout=0.1)])
def test_unported_transformer_options_raise(option):
    """Each option the port once refused now builds and runs: the module
    with it (its own MoE tree when it asks for experts) gives JAX's
    logits on one device (ring and GPipe without a mesh are the plain
    stack; dropout from the same key: the same masks), at the bf16 bound
    of the forward test above."""
    cfg = vit.tiny()
    cfg = dataclasses.replace(cfg, encoder=TransformerConfig(
        dim=cfg.encoder.dim, depth=cfg.encoder.depth,
        heads=cfg.encoder.heads, **option))
    jcfg = jvit.tiny()
    jcfg = dataclasses.replace(jcfg, encoder=dataclasses.replace(
        jcfg.encoder, **option))
    tree = vit.init(np.random.default_rng(0), cfg)
    images = np.random.default_rng(1).standard_normal(
        (2, 32, 32, 3)).astype(np.float32)
    train = "dropout" in option
    key = jax.random.key(3) if train else None
    ref = np.asarray(jvit.apply(jax.tree.map(jnp.asarray, tree),
                                jnp.asarray(images), jcfg, key,
                                deterministic=not train))
    model = convert.from_jax_params(tree, cfg, "cpu", train=train)
    logits = model(torch.from_numpy(images),
                   jrandom.PRNGKey(3) if train else None,
                   deterministic=not train)
    logits.sum().backward()
    np.testing.assert_allclose(logits.detach().numpy(), ref,
                               atol=LOGIT_ATOL, rtol=0)
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())
