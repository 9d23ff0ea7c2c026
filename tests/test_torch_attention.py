"""The port's multi-head attention against ``rafiki_tpu/ops/attention.py``.

Weights in the JAX layouts (``wq/wk/wv`` (dim, heads, dh), ``wo`` (heads,
dh, dim)) and inputs come from numpy with a seed. On CPU tensors the port's
``use_flash=None`` runs ``mha_reference`` as the JAX package does off the
TPU, and ``use_flash=True`` the flash kernel's plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rafiki_tpu.ops import attention as jattn
from rafiki_tpu_torch.ops import attention as attn
from rafiki_tpu_torch.ops import flash_attention

# f32 in both: sums of 32-64 O(1) terms taken in another order
F32_ATOL = 2e-5
# bf16 projections and attention: a bf16 rounding of O(1) outputs, plus
# mha_reference casting p to bf16 before PV where flash keeps PV in f32
BF16_ATOL = 3e-2


def _setup(seed, dim=32, heads=4, b=2, s=9):
    rng = np.random.default_rng(seed)
    tree = attn.attention_init(rng, dim, heads)
    tree["bo"] = rng.standard_normal(dim).astype(np.float32)
    x = rng.standard_normal((b, s, dim)).astype(np.float32)
    return tree, x


@pytest.mark.parametrize("fused_qkv", [False, True])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("use_flash", [None, False, True])
def test_multi_head_attention_f32(fused_qkv, causal, use_flash):
    tree, x = _setup(0, s=40)
    tp = {k: torch.from_numpy(v) for k, v in tree.items()}
    jp = {k: jnp.asarray(v) for k, v in tree.items()}
    before = flash_attention.launches
    out = attn.multi_head_attention(tp, torch.from_numpy(x), causal,
                                    use_flash, fused_qkv)
    assert flash_attention.launches == before  # CPU: nothing launched
    ref = jattn.multi_head_attention(jp, jnp.asarray(x), causal=causal,
                                     use_flash=use_flash, fused_qkv=fused_qkv)
    assert out.shape == x.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=F32_ATOL,
                               rtol=0)


@pytest.mark.parametrize("fused_qkv", [False, True])
def test_multi_head_attention_bf16_module(fused_qkv):
    """The ``MultiHeadAttention`` module in bf16 (as the ViT runs it),
    with the flash path, against JAX's flash path."""
    tree, x = _setup(1, dim=64, heads=4, s=17)
    module = attn.MultiHeadAttention(64, 4)
    module.load_state_dict({k: torch.from_numpy(v) for k, v in tree.items()})
    with torch.inference_mode():
        out = module(torch.from_numpy(x).to(torch.bfloat16), use_flash=True,
                     fused_qkv=fused_qkv)
    assert out.dtype == torch.bfloat16
    jp = {k: jnp.asarray(v) for k, v in tree.items()}
    ref = jattn.multi_head_attention(jp, jnp.asarray(x, jnp.bfloat16),
                                     use_flash=True, fused_qkv=fused_qkv)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), atol=BF16_ATOL,
                               rtol=0)


@pytest.mark.parametrize("fused_qkv", [False, True])
def test_flash_path_reads_projection_views(fused_qkv, monkeypatch):
    """bf16 with ``use_flash=True``: the flash op gets the projection
    einsum's views (as K1 reads them on the card), and the layer's output
    equals, bit for bit, the same call with q, k, v copied to contiguous
    tensors first, and JAX's flash path within the bf16 tolerance."""
    tree, x = _setup(4, dim=64, heads=4, s=40)
    tp = {k: torch.from_numpy(v) for k, v in tree.items()}
    xb = torch.from_numpy(x).to(torch.bfloat16)
    real = attn.flash_attention
    seen = []

    def spy(q, k, v, **kw):
        seen.append(all(t.is_contiguous() for t in (q, k, v)))
        return real(q, k, v, **kw)

    monkeypatch.setattr(attn, "flash_attention", spy)
    out = attn.multi_head_attention(tp, xb, use_flash=True,
                                    fused_qkv=fused_qkv)
    assert seen == [False]  # views, not copies
    monkeypatch.setattr(attn, "flash_attention", lambda q, k, v, **kw: real(
        q.contiguous(), k.contiguous(), v.contiguous(), **kw))
    copied = attn.multi_head_attention(tp, xb, use_flash=True,
                                       fused_qkv=fused_qkv)
    assert torch.equal(out, copied)
    jp = {k: jnp.asarray(v) for k, v in tree.items()}
    ref = jattn.multi_head_attention(jp, jnp.asarray(x, jnp.bfloat16),
                                     use_flash=True, fused_qkv=fused_qkv)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), atol=BF16_ATOL,
                               rtol=0)


def test_mha_reference_matches_jax_bf16():
    """Both references cast p to v's type before the PV product."""
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((2, 3, 12, 16)).astype(np.float32)
               for _ in range(3))
    out = attn.mha_reference(*(torch.from_numpy(a).to(torch.bfloat16)
                               for a in (q, k, v)), causal=True)
    ref = jattn.mha_reference(*(jnp.asarray(a, jnp.bfloat16)
                                for a in (q, k, v)), causal=True)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), atol=1e-2, rtol=0)


def test_attention_init_layouts_and_scales():
    tree = attn.attention_init(np.random.default_rng(3), 64, 4)
    jtree = jattn.attention_init(jax.random.key(0), 64, 4)
    for name, value in tree.items():
        assert value.shape == jtree[name].shape, name
        assert value.dtype == np.float32
    np.testing.assert_allclose(tree["wq"].std(), np.asarray(jtree["wq"]).std(),
                               rtol=0.1)
