"""Multi-head attention: the reference semantics and the flash-kernel
dispatch.

Counterpart of ``rafiki_tpu/ops/attention.py``. Parameters keep the JAX
layouts: ``wq/wk/wv`` are (dim, heads, dh), ``wo`` is (heads, dh, dim).

Dispatch: on a CUDA tensor, ``use_flash=None`` or ``True`` runs the flash
kernel (the JAX package's 1 GB auto-threshold was measured on and for a
TPU and does not carry over); ``use_flash=False`` runs
:func:`mha_reference`. On a CPU tensor ``None`` runs :func:`mha_reference`,
as the JAX package does off the TPU, and ``True`` runs the flash kernel's
plain version.

Under a train mesh (``parallel/sharding.py``'s ``activation_mesh``) the
layer works on this rank's shards, the collectives written out
(``parallel/collectives.py``):

- tensor-parallel heads: ``wq/wk/wv`` hold this rank's heads and ``wo``
  their rows; the input enters the split region (its gradient summed
  over ``model``), and the output projection's partial sums are summed
  over ``model`` before ``bo``;
- a sequence shard (``seq`` > 1, no ``attn_fn``): the local queries
  attend to the keys and values gathered over ``seq`` (their gradients
  reduce-scattered back), through the same kernels. Causal attention
  gathers only the keys up to the shard's end: the kernels' end-aligned
  mask then puts each query at its global position.

``attn_fn(q, k, v, causal)`` replaces the inner attention (ring
attention's seam, ``models/transformer.py``).
"""

from __future__ import annotations

import math
from typing import Mapping, Optional

import numpy as np
import torch

from rafiki_tpu_torch.models.core import own_params, xavier_uniform
from rafiki_tpu_torch.ops.flash_attention import flash_attention
from rafiki_tpu_torch.parallel import collectives as C
from rafiki_tpu_torch.parallel.sharding import current_mesh


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = False,
                  sm_scale: Optional[float] = None) -> torch.Tensor:
    """Plain attention over (B, H, S, Dh); softmax statistics in f32. Unlike
    the flash kernel, a row that sees no key averages every value."""
    dh = q.shape[-1]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(dh)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        sq, skv = s.shape[-2], s.shape[-1]
        mask = torch.ones(sq, skv, dtype=torch.bool,
                          device=s.device).tril(skv - sq)
        s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


def attention_init(rng: np.random.Generator, dim: int, heads: int) -> dict:
    """QKV and output projection weights (numpy, JAX layout); fans of the
    logical (dim, heads * dh) product, as in the JAX package."""
    dh = dim // heads
    shape = (dim, heads, dh)
    return {
        "wq": xavier_uniform(rng, shape, dim, heads * dh),
        "wk": xavier_uniform(rng, shape, dim, heads * dh),
        "wv": xavier_uniform(rng, shape, dim, heads * dh),
        "wo": xavier_uniform(rng, (heads, dh, dim), heads * dh, dim),
        "bo": np.zeros((dim,), np.float32),
    }


def multi_head_attention(params: Mapping[str, torch.Tensor],
                         x: torch.Tensor, causal: bool = False,
                         use_flash: Optional[bool] = None,
                         fused_qkv: bool = False,
                         attn_fn=None) -> torch.Tensor:
    """Self-attention over (B, S, D). ``fused_qkv`` computes the three
    projections as one (BS, D) x (D, 3HDh) product over weights stacked at
    run time; the parameter layout is unchanged."""
    mesh = current_mesh()
    tp = mesh.group("model") if mesh is not None else None
    sp = mesh.group("seq") if mesh is not None else None
    x = C.copy_to(x, tp)
    dt = x.dtype
    wq, wk, wv = params["wq"], params["wk"], params["wv"]
    if fused_qkv:
        wqkv = torch.stack([wq, wk, wv]).to(dt)
        q, k, v = torch.einsum("bsd,tdhk->tbhsk", x, wqkv)
    else:
        q = torch.einsum("bsd,dhk->bhsk", x, wq.to(dt))
        k = torch.einsum("bsd,dhk->bhsk", x, wk.to(dt))
        v = torch.einsum("bsd,dhk->bhsk", x, wv.to(dt))
    if sp is not None and attn_fn is None:
        k, v = (C.all_gather(t, sp, 2) for t in (k, v))
        if causal:
            end = (sp.rank + 1) * q.shape[2]
            k, v = k[:, :, :end], v[:, :, :end]
    if attn_fn is not None:
        o = attn_fn(q, k, v, causal)
    elif use_flash or (use_flash is None and x.is_cuda):
        if dt == torch.float32:
            # the f32 kernel takes contiguous tensors; bf16 K1 reads the
            # einsum's (B, H, S, Dh) views as they are
            q, k, v = (t.contiguous() for t in (q, k, v))
        o = flash_attention(q, k, v, causal=causal)
    else:
        o = mha_reference(q, k, v, causal=causal)
    out = C.reduce_from(torch.einsum("bhsk,hkd->bsd", o, params["wo"].to(dt)),
                        tp)
    return out + params["bo"].to(dt)


class MultiHeadAttention(torch.nn.Module):
    """Holds the attention parameters in the JAX layouts."""

    def __init__(self, dim: int, heads: int, device=None):
        super().__init__()
        dh = dim // heads
        f32 = dict(dtype=torch.float32, device=device)
        self.wq = torch.nn.Parameter(torch.empty(dim, heads, dh, **f32))
        self.wk = torch.nn.Parameter(torch.empty(dim, heads, dh, **f32))
        self.wv = torch.nn.Parameter(torch.empty(dim, heads, dh, **f32))
        self.wo = torch.nn.Parameter(torch.empty(heads, dh, dim, **f32))
        self.bo = torch.nn.Parameter(torch.empty(dim, **f32))

    def forward(self, x: torch.Tensor, causal: bool = False,
                use_flash: Optional[bool] = None,
                fused_qkv: bool = False) -> torch.Tensor:
        return multi_head_attention(own_params(self), x, causal, use_flash,
                                    fused_qkv)
