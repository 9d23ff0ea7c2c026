"""Mixture-of-Experts FFN with expert parallelism.

Counterpart of ``rafiki_tpu/parallel/moe.py``: Switch-style top-1
routing with a static capacity (tokens past their expert's capacity are
dropped; the residual carries them) and the load-balancing auxiliary
loss (Switch Transformer eq. 4).

The JAX package dispatches through dense one-hot einsums over the global
(token, expert, slot) cube and lets GSPMD place them. Here each expert's
``capacity`` slots are filled by an index scatter and read back by an
index gather: each slot holds at most one token, so the sums of the
einsums are exact. A token's slot is its place in its expert's queue
over the global batch in row-major (row, position) order, so every rank
sums the expert counts of the tokens before its shard
(:func:`_queue_offsets`: the per-row counts gathered over ``seq`` and
``data``). Under a train mesh:

- experts are split over ``expert`` (this rank holds ``E / ep`` of
  them) and their hidden units over ``model``; tokens are replicated
  over ``expert`` (the batch is split over ``data`` and ``seq``), so
  the router runs alike on every expert rank, the tokens and their gates
  enter the experts' split region through ``copy_to`` and the combined
  output leaves it through one ``reduce_from`` over ``expert``;
- the capacity is the global one, ``ceil(N / E * capacity_factor)`` of
  the global token count N; the aux loss uses the global means, its
  router term a ``psum`` over the batch axes (the rank's share, as every
  loss term here, ``parallel/sharding.py``).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from rafiki_tpu_torch.models import core
from rafiki_tpu_torch.parallel import collectives as C
from rafiki_tpu_torch.parallel.sharding import GRAD_AXES, P, current_mesh

Params = Dict[str, torch.Tensor]


def moe_init(rng: np.random.Generator, dim: int, hidden: int,
             n_experts: int) -> dict:
    """numpy f32 in the JAX layout, the JAX package's scalings."""
    std1 = math.sqrt(2.0 / dim)
    std2 = math.sqrt(2.0 / hidden)
    return {
        "router": core.normal_init(rng, (dim, n_experts), std=0.02),
        "w1": core.normal_init(rng, (n_experts, dim, hidden), std=std1),
        "b1": np.zeros((n_experts, hidden), np.float32),
        "w2": core.normal_init(rng, (n_experts, hidden, dim), std=std2),
        "b2": np.zeros((n_experts, dim), np.float32),
    }


def moe_partition_specs() -> dict:
    return {
        "router": P(None, None),
        "w1": P("expert", None, "model"),
        "b1": P("expert", "model"),
        "w2": P("expert", "model", None),
        "b2": P("expert", None),
    }


def _queue_offsets(counts: torch.Tensor, mesh) -> torch.Tensor:
    """(rows, E): for each of this rank's rows, how many tokens of the
    global batch before its shard of the row went to each expert.
    ``counts`` (rows, E) are this shard's per-row counts."""
    if mesh is None:
        cum = counts.cumsum(0) - counts
        return cum
    # (dp, sp, rows, E): every shard's per-row counts
    every = C.gather_over(C.gather_over(counts, mesh, "seq"), mesh, "data")
    dp, sp, rows, n_exp = every.shape
    # the global order of the shards: data rank, row, seq rank
    order = every.permute(0, 2, 1, 3).reshape(-1, n_exp)
    before = (order.cumsum(0) - order).view(dp, rows, sp, n_exp)
    return before[mesh.index("data"), :, mesh.index("seq")]


def moe_apply(params: Params, x: torch.Tensor,
              capacity_factor: float = 1.25) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """x: (B, S, D) -> (y, aux loss share). Products in f32, as in JAX."""
    mesh = current_mesh()
    b, s, d = x.shape
    xt = x.reshape(b * s, d).float()
    n_exp = params["router"].shape[-1]
    replicas = 1
    if mesh is not None:
        replicas = math.prod(mesh.size(a) for a in GRAD_AXES)
    n_tok = b * s * replicas
    capacity = int(math.ceil(n_tok / n_exp * capacity_factor))

    logits = xt @ params["router"]
    gates = torch.softmax(logits, dim=-1)                 # (N, E)
    expert = gates.argmax(-1)                             # (N,)
    gate = gates.gather(-1, expert[:, None])[:, 0]

    with torch.no_grad():
        onehot = F.one_hot(expert, n_exp).float()         # (N, E)
        rows = onehot.view(b, s, n_exp)
        before = _queue_offsets(rows.sum(1), mesh)        # (B, E)
        pos = (before[:, None, :] + rows.cumsum(1)).view(b * s, n_exp)
        pos = (pos * onehot).sum(-1) - 1.0                # (N,)
        keep = pos < capacity
        ep, at = (1, 0) if mesh is None else (mesh.size("expert"),
                                             mesh.index("expert"))
        n_local = n_exp // ep
        local = expert - at * n_local
        here = keep & (local >= 0) & (local < n_local)
        dump = n_local * capacity
        slot = torch.where(here, local * capacity + pos.long(),
                           torch.full_like(local, dump))

    ep_group = mesh.group("expert") if mesh is not None else None
    tp_group = mesh.group("model") if mesh is not None else None
    xin = C.copy_to(C.copy_to(xt, ep_group), tp_group)
    buf = torch.zeros(dump + 1, d, device=x.device).index_add(0, slot, xin)
    xe = buf[:dump].view(n_local, capacity, d)
    he = core.gelu(torch.bmm(xe, params["w1"]) + params["b1"][:, None, :])
    ye = C.reduce_from(torch.bmm(he, params["w2"]), tp_group) \
        + params["b2"][:, None, :]
    ye = torch.cat([ye.reshape(dump, d), ye.new_zeros(1, d)])
    y = ye[slot] * C.copy_to(gate, ep_group)[:, None]
    y = C.reduce_from(y, ep_group)

    # Switch load-balancing loss, E * sum_e f_e * p_e, over the global batch
    groups = [mesh.group(a) for a in GRAD_AXES] if mesh is not None else []
    frac_tokens = onehot.sum(0)
    frac_router = gates.sum(0)
    for g in groups:
        if g is not None:
            frac_tokens = g.all_reduce_(frac_tokens.clone())
            frac_router = C.psum(frac_router, g)
    aux = n_exp * torch.sum(frac_tokens / n_tok * frac_router / n_tok)
    return y.reshape(b, s, d).to(x.dtype), aux / replicas


class MoE(torch.nn.Module):
    """The MoE parameters in the JAX layout: router (D, E), w1 (E, D, H),
    b1 (E, H), w2 (E, H, D), b2 (E, D)."""

    def __init__(self, dim: int, hidden: int, n_experts: int, device=None):
        super().__init__()
        f32 = dict(dtype=torch.float32, device=device)
        self.router = torch.nn.Parameter(torch.empty(dim, n_experts, **f32))
        self.w1 = torch.nn.Parameter(torch.empty(n_experts, dim, hidden,
                                                 **f32))
        self.b1 = torch.nn.Parameter(torch.empty(n_experts, hidden, **f32))
        self.w2 = torch.nn.Parameter(torch.empty(n_experts, hidden, dim,
                                                 **f32))
        self.b2 = torch.nn.Parameter(torch.empty(n_experts, dim, **f32))
