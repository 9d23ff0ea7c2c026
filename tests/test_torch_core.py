"""The port's model building blocks against ``rafiki_tpu/models/core.py``.

Same numpy inputs and weights, made from a seed, through both packages.
In f32 the two agree to float rounding; in bf16 both compute the same
operations in the same type, and may differ by a bf16 rounding where the
frameworks round at different places.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rafiki_tpu.models import core as jcore
from rafiki_tpu_torch.models import core

# f32 sums over up to 64 terms of O(1) values, taken in another order
F32_ATOL = 1e-5
# one bf16 rounding (2^-8 relative) of O(1) outputs
BF16_ATOL = 2e-2


def _rng(seed):
    return np.random.default_rng(seed)


def _to(a, dtype):
    if dtype == "bfloat16":
        return torch.from_numpy(a).to(torch.bfloat16), jnp.asarray(
            a, jnp.bfloat16)
    return torch.from_numpy(a), jnp.asarray(a)


def _close(t, j, dtype):
    atol = BF16_ATOL if dtype == "bfloat16" else F32_ATOL
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=atol, rtol=0)


def _params(tree):
    return ({k: torch.from_numpy(v) for k, v in tree.items()},
            {k: jnp.asarray(v) for k, v in tree.items()})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm(dtype):
    rng = _rng(0)
    # a large mean makes biased vs unbiased variance (and f32 statistics)
    # matter
    x = (rng.standard_normal((3, 5, 64)) * 3 + 2).astype(np.float32)
    tree = {"scale": rng.standard_normal(64).astype(np.float32),
            "bias": rng.standard_normal(64).astype(np.float32)}
    tp, jp = _params(tree)
    tx, jx = _to(x, dtype)
    out = core.layernorm(tp, tx)
    assert out.dtype == tx.dtype
    _close(out, jcore.layernorm(jp, jx), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense(dtype):
    rng = _rng(1)
    tree = core.dense_init(rng, 64, 48)
    tree["bias"] = rng.standard_normal(48).astype(np.float32)
    tp, jp = _params(tree)
    tx, jx = _to(rng.standard_normal((4, 7, 64)).astype(np.float32), dtype)
    out = core.dense(tp, tx)
    assert out.shape == (4, 7, 48) and out.dtype == tx.dtype
    _close(out, jcore.dense(jp, jx), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_is_jax_default_tanh_form(dtype):
    x = np.linspace(-6, 6, 1001, dtype=np.float32)
    tx, jx = _to(x, dtype)
    _close(core.gelu(tx), jax.nn.gelu(jx), dtype)
    if dtype == "float32":
        # the exact (erf) form differs by up to ~5e-4 here: not the same op
        exact = torch.nn.functional.gelu(tx)
        assert float((exact - core.gelu(tx)).abs().max()) > 1e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_patch_projection_matches_jax_conv(dtype):
    """The NHWC/HWIO stride-p VALID convolution of the ViT stem, done as a
    reshape and one product, against ``core.conv2d``."""
    rng = _rng(2)
    p, c, dim = 4, 3, 32
    tree = core.conv2d_init(rng, p, p, c, dim)
    tree["bias"] = rng.standard_normal(dim).astype(np.float32)
    tp, jp = _params(tree)
    tx, jx = _to(rng.standard_normal((2, 16, 12, c)).astype(np.float32), dtype)
    out = core.patch_project(tp, tx)
    ref = jcore.conv2d(jp, jx, stride=p, padding="VALID")
    assert out.shape == (2, 4 * 3, dim)
    _close(out, np.asarray(ref, np.float32).reshape(2, 12, dim), dtype)


def test_embedding_and_cast():
    rng = _rng(3)
    table = rng.standard_normal((50, 16)).astype(np.float32)
    ids = rng.integers(0, 50, (3, 7))
    out = core.embedding({"table": torch.from_numpy(table)},
                         torch.from_numpy(ids))
    ref = jcore.embedding({"table": jnp.asarray(table)}, jnp.asarray(ids))
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(ref, np.float32))
    x = rng.standard_normal(10).astype(np.float32)
    np.testing.assert_array_equal(
        core.cast_for_compute(torch.from_numpy(x)).float().numpy(),
        np.asarray(jcore.cast_for_compute(jnp.asarray(x)), np.float32))


def test_initializer_scales_match_jax():
    """The port draws its own numbers from numpy, at the JAX package's
    fan scalings: compare the spread, not the values."""
    rng = _rng(4)
    shape = (256, 512)
    limit = np.sqrt(6.0 / sum(shape))
    w = core.xavier_uniform(rng, shape, *shape)
    jw = np.asarray(jcore.xavier_uniform(jax.random.key(0), shape))
    assert w.dtype == np.float32
    assert abs(w).max() <= limit and abs(jw).max() <= limit
    np.testing.assert_allclose(w.std(), jw.std(), rtol=0.02)
    conv = core.conv2d_init(rng, 4, 4, 3, 64)["kernel"]
    jconv = np.asarray(jcore.conv2d_init(jax.random.key(1), 4, 4, 3,
                                         64)["kernel"])
    np.testing.assert_allclose(conv.std(), jconv.std(), rtol=0.1)
