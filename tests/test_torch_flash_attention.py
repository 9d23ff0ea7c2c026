"""The port's flash-attention forward against the JAX package's.

The JAX side runs its Pallas kernel interpreted on the CPU, as
``tests/test_ops.py`` does; the port's wrapper takes its plain PyTorch
version for CPU tensors. Inputs are made with numpy from a seed and handed
to both. The CUDA kernel itself is compared with the plain version on the
card by ``tests/test_torch_cuda.py`` (and by ``chip_smoke.py``).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rafiki_tpu.ops import flash_attention as jax_flash
from rafiki_tpu.ops import mha_reference as jax_mha_reference
from rafiki_tpu_torch.ops.attention import mha_reference
from rafiki_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_plain,
)

# the module (ops/__init__ re-exports the function under the same name)
flash_mod = importlib.import_module("rafiki_tpu_torch.ops.flash_attention")

# f32 in both packages with f32 statistics: only the summation order of
# the two online softmaxes differs, a few ulps of O(1) outputs
F32_ATOL = 2e-5


def _qkv(seed, b=2, h=2, sq=48, skv=None, dh=16, dtype=np.float32):
    rng = np.random.default_rng(seed)
    skv = sq if skv is None else skv
    return tuple(rng.standard_normal(shape).astype(dtype) for shape in
                 ((b, h, sq, dh), (b, h, skv, dh), (b, h, skv, dh)))


def _torch(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _jax(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


# (label, seed, qkv shape kwargs, causal, block_q, block_k)
CASES = [
    ("non-causal", 0, dict(), False, 16, 16),
    ("causal", 0, dict(), True, 16, 16),
    ("S=40, 16-tiles", 1, dict(sq=40), False, 16, 16),
    ("S=40 causal", 1, dict(sq=40), True, 16, 16),
    ("Sq<Skv causal", 3, dict(b=1, sq=4, skv=32), True, 16, 16),
    ("Sq>Skv non-causal", 4, dict(b=1, sq=40, skv=24), False, 16, 16),
    ("dead rows", 5, dict(b=1, sq=32, skv=16), True, 32, 16),
]


@pytest.mark.parametrize("label,seed,shape,causal,block_q,block_k", CASES,
                         ids=[c[0] for c in CASES])
def test_plain_matches_jax_flash_f32(label, seed, shape, causal, block_q,
                                     block_k):
    q, k, v = _qkv(seed, **shape)
    before = flash_attention.launches
    out = flash_attention(*_torch(q, k, v), causal, None, block_q, block_k)
    # a CPU tensor takes the plain version and launches nothing
    assert flash_attention.launches == before
    ref = jax_flash(*_jax(q, k, v), causal, None, block_q, block_k)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=F32_ATOL,
                               rtol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_matches_mha_reference(causal):
    """Both packages' dense reference agree with the blockwise plain
    version wherever every row sees a key."""
    q, k, v = _qkv(6, sq=40)
    out = flash_attention_plain(*_torch(q, k, v), causal, None, 16)
    ref_t = mha_reference(*_torch(q, k, v), causal=causal)
    ref_j = jax_mha_reference(*_jax(q, k, v), causal=causal)
    np.testing.assert_allclose(out.numpy(), ref_t.numpy(), atol=F32_ATOL,
                               rtol=0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_j), atol=F32_ATOL,
                               rtol=0)


def test_dead_rows_are_exactly_zero():
    """Causal with Skv < Sq: the first Sq - Skv rows see no key and give 0
    (mha_reference would average every value there instead)."""
    q, k, v = _qkv(7, b=1, sq=32, skv=16)
    out = flash_attention(*_torch(q, k, v), True, None, 32, 16).numpy()
    assert np.abs(out[:, :, :16]).max() == 0.0
    ref = np.asarray(jax_flash(*_jax(q, k, v), True, None, 32, 16))
    assert np.abs(ref[:, :, :16]).max() == 0.0
    np.testing.assert_allclose(out[:, :, 16:], ref[:, :, 16:],
                               atol=F32_ATOL, rtol=0)


def test_plain_matches_jax_flash_bf16():
    """bf16 in, bf16 out, f32 inside in both: the outputs differ by at most
    one bf16 rounding of O(1) values (2^-8 relative, < 1e-2 absolute)."""
    q, k, v = _qkv(8, sq=40)
    tq, tk, tv = (t.to(torch.bfloat16) for t in _torch(q, k, v))
    out = flash_attention(tq, tk, tv, False, None, 16, 16)
    assert out.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    ref = jax_flash(jq, jk, jv, False, None, 16, 16)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), atol=1e-2, rtol=0)


def test_plain_is_independent_of_block_k():
    q, k, v = _qkv(9, sq=40)
    a = flash_attention_plain(*_torch(q, k, v), True, None, 16)
    b = flash_attention_plain(*_torch(q, k, v), True, None, 32)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=F32_ATOL, rtol=0)


def _misaligned(t):
    """A contiguous copy of ``t`` that starts 8 bytes past a 16-byte
    boundary."""
    return torch.cat([t.new_zeros(2), t.flatten()])[2:].view(t.shape)


# label -> (q, k, v) -> (q, k, v, block_q, block_k) that the kernel refuses
BQ, BK = flash_mod.DEFAULT_BLOCK_Q, flash_mod.DEFAULT_BLOCK_K
BAD_ARGS = {
    "f16": lambda q, k, v: (q.half(), k.half(), v.half(), BQ, BK),
    "mixed dtypes": lambda q, k, v: (q, k.to(torch.bfloat16), v, BQ, BK),
    "not contiguous": lambda q, k, v: (q.transpose(1, 2), k.transpose(1, 2),
                                       v.transpose(1, 2), BQ, BK),
    "head dim 24": lambda q, k, v: (q[..., :24].contiguous(),
                                    k[..., :24].contiguous(),
                                    v[..., :24].contiguous(), BQ, BK),
    "3-d": lambda q, k, v: (q[0], k[0], v[0], BQ, BK),
    "k/v lengths differ": lambda q, k, v: (q, k, v[:, :, :8], BQ, BK),
    "block_q 128": lambda q, k, v: (q, k, v, 128, BK),
    "block_k 128": lambda q, k, v: (q, k, v, BQ, 128),
    "misaligned": lambda q, k, v: (_misaligned(q), k, v, BQ, BK),
    # a bf16 layout TMA could walk, from a base 4 bytes past a boundary
    "bf16 misaligned": lambda q, k, v: (
        _misaligned(q.to(torch.bfloat16)), k.to(torch.bfloat16),
        v.to(torch.bfloat16), BQ, BK),
    # bf16 views that TMA cannot read: a strided last dim, and rows whose
    # pitch (Dh + 4 elements, 136 bytes) is no multiple of 16 bytes
    "bf16 last dim strided": lambda q, k, v: (
        *(torch.cat([t, t], -1).to(torch.bfloat16)[..., ::2]
          for t in (q, k, v)), BQ, BK),
    "bf16 row pitch not a multiple of 16 bytes": lambda q, k, v: (
        *(torch.nn.functional.pad(t, (0, 4)).to(torch.bfloat16)[..., :64]
          for t in (q, k, v)), BQ, BK),
}


@pytest.mark.parametrize("label", sorted(BAD_ARGS))
def test_kernel_arguments_are_checked(label):
    """What the CUDA kernels do not take raises before any launch, for K1
    (q, k, v) and for K2/K3 (with dO): f32 views, bf16 layouts TMA cannot
    walk, misaligned bases, and the rest; the checks are plain Python, so
    they run here on CPU tensors."""
    q, k, v = _torch(*_qkv(10, sq=16, dh=64))
    flash_mod._check_kernel_args(q, k, v, BQ, BK)  # well formed: passes
    flash_mod._check_kernel_args(q, k, v, BQ, BK, dout=q)
    bad = BAD_ARGS[label](q, k, v)
    for dout in (None, bad[0]):
        with pytest.raises(ValueError):
            flash_mod._check_kernel_args(*bad, dout=dout)


def _projection_views(seed, fused, b=2, s=9, heads=4, dh=64):
    """q, k, v in bf16 as ``multi_head_attention`` hands them to K1: views
    of the projection einsum's output, not copies."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, s, heads * dh)).astype(
        np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal((3, heads * dh, heads, dh))
                         .astype(np.float32)).to(torch.bfloat16)
    if fused:
        return tuple(torch.einsum("bsd,tdhk->tbhsk", x, w))
    return tuple(torch.einsum("bsd,dhk->bhsk", x, w[i]) for i in range(3))


@pytest.mark.parametrize("fused", [False, True])
def test_bf16_projection_views_go_to_k1_without_a_copy(fused):
    """The einsum's (B, H, S, Dh) views are strided (the heads interleave
    in memory); K1, and K2/K3 with a dO view, take them as they are and get
    their strides; the same views in f32 must be contiguous."""
    q, k, v = _projection_views(12, fused)
    assert not q.is_contiguous() and q.stride(3) == 1
    assert flash_mod._check_kernel_args(q, k, v, BQ, BK) == [
        t.stride()[:3] for t in (q, k, v)]
    assert flash_mod._check_kernel_args(q, k, v, BQ, BK, dout=q) == [
        t.stride()[:3] for t in (q, k, v, q)]
    assert all(flash_mod._tma_readable(t) for t in (q, k, v))
    with pytest.raises(ValueError, match="contiguous"):
        flash_mod._check_kernel_args(q.float(), k.float(), v.float(), BQ, BK)
    with pytest.raises(ValueError, match="contiguous"):
        flash_mod._check_kernel_args(q.float(), k.float(), v.float(), BQ, BK,
                                     dout=q.float())
    # the strides the kernel's tensor maps get, in elements
    b, h, s, dh = q.shape
    assert flash_mod._view_strides(q) == q.stride()[:3]
    assert flash_mod._view_strides(q.contiguous()) == (h * s * dh, s * dh, dh)
    # a dim of size 1 is never stepped: its stride is taken as contiguous
    assert flash_mod._view_strides(q[:1, :1]) == (s * dh, s * dh,
                                                  q.stride(2))


def test_non_cpu_non_cuda_tensor_raises():
    q, k, v = (t.to("meta") for t in _torch(*_qkv(11, sq=16)))
    with pytest.raises(ValueError):
        flash_attention(q, k, v)
