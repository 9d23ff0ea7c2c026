"""GPipe pipelining over the ``pipe`` axis of a train mesh.

Counterpart of ``rafiki_tpu/parallel/pipeline.py``: the layer stack's
depth axis is split over ``pipe`` (stage s holds depth / n contiguous
layers) and the batch into M microbatches that run the fill-drain
schedule of M + n - 1 ticks, stage s working on microbatch t - s at tick
t and handing its output to stage s + 1 (bubble (n - 1) / (M + n - 1)).

The JAX package shards the input queue over the stages and rotates it
(O(B / n) input memory a stage), pads it to a multiple of n, and gets
the backward from ``jax.grad`` of the scan. Here every stage holds the
rank's whole batch already (the activations are replicated over
``pipe``), so stage 0 feeds the microbatches straight from it, for any
M: there is no queue to pad or rotate. The backward is written out:
:class:`_GPipe` keeps each microbatch's graph on its stage, and its
backward runs the mirror schedule, the last stage first, each tick's
cotangents handed to the stage before. Every hand-off is one all-to-all
of the stage pairs that talk at that tick (``DataGroup.exchange``), the
same on every rank, so no pair of sends can deadlock.

The input enters the stages' split region through ``copy_to`` (stage 0
alone reads it, every stage gets its gradient) and the last stage's
output leaves it through ``reduce_from`` (the others add zeros).
"""

from __future__ import annotations

from typing import Any, Callable, List, Sequence

import torch

from rafiki_tpu_torch.parallel import collectives as C
from rafiki_tpu_torch.parallel.collectives import MeshGroups


class _Run:
    """What the autograd function needs besides tensors."""

    def __init__(self, block_fn, structure, group, n, stage, m):
        self.block_fn = block_fn
        self.structure = structure
        self.group = group
        self.n, self.stage, self.m = n, stage, m

    def layers(self, leaves: List[torch.Tensor]) -> List[Any]:
        return [self.structure(leaves, j)
                for j in range(leaves[0].shape[0])] if leaves else []

    def active(self, stage: int, tick: int) -> bool:
        return 0 <= tick - stage < self.m

    def bwd_active(self, stage: int, tick: int) -> bool:
        return 0 <= tick - (self.n - 1 - stage) < self.m


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, run: _Run, xs: torch.Tensor, *leaves: torch.Tensor):
        n, s, m, group = run.n, run.stage, run.m, run.group
        own = [t.detach().requires_grad_(t.requires_grad) for t in leaves]
        with torch.enable_grad():
            layers = run.layers(own)
        last = s == n - 1
        outs = torch.zeros_like(xs)
        records = {}
        buf = None
        for t in range(m + n - 1):
            out = None
            if run.active(s, t):
                i = t - s
                inp = (xs[i] if s == 0 else buf).detach().requires_grad_()
                with torch.enable_grad():
                    out = inp
                    for layer in layers:
                        out = run.block_fn(layer, out)
                records[i] = (inp, out)
                if last:
                    outs[i] = out.detach()
            if not any(run.active(r, t) for r in range(n - 1)):
                continue
            send = out.detach() if out is not None and not last else None
            recv = s > 0 and run.active(s - 1, t)
            buf = group.exchange(send, s + 1 if send is not None else None,
                                 s - 1 if recv else None, xs.shape[1:],
                                 xs.dtype)
        ctx.run, ctx.records, ctx.own = run, records, own
        return outs

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        run, records, own = ctx.run, ctx.records, ctx.own
        n, s, m, group = run.n, run.stage, run.m, run.group
        wants = [t for t in own if t.requires_grad]
        sums: List[Any] = [None] * len(wants)
        dxs = torch.zeros_like(dy) if s == 0 else None
        buf = None
        for u in range(m + n - 1):
            gin = None
            if run.bwd_active(s, u):
                i = m - 1 - (u - (n - 1 - s))
                inp, out = records.pop(i)
                cot = dy[i] if s == n - 1 else buf
                grads = torch.autograd.grad(out, [inp] + wants, cot,
                                            allow_unused=True)
                gin = grads[0]
                for k, g in enumerate(grads[1:]):
                    if g is not None:
                        sums[k] = g if sums[k] is None else sums[k] + g
                if s == 0:
                    dxs[i] = gin
            if not any(run.bwd_active(r, u) for r in range(1, n)):
                continue
            send = gin if gin is not None and s > 0 else None
            recv = s < n - 1 and run.bwd_active(s + 1, u)
            buf = group.exchange(send, s - 1 if send is not None else None,
                                 s + 1 if recv else None, dy.shape[1:],
                                 dy.dtype)
        it = iter(sums)
        leaf_grads = [next(it) if t.requires_grad else None for t in own]
        return (None, dxs) + tuple(leaf_grads)


def gpipe_apply(block_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                leaves: Sequence[torch.Tensor],
                structure: Callable[[List[torch.Tensor], int], Any],
                x: torch.Tensor, mesh: MeshGroups,
                n_microbatches: int) -> torch.Tensor:
    """Run ``block_fn(layer, h)`` over this stage's layers, microbatched
    over the stages of the ``pipe`` axis. ``leaves`` are this stage's
    stacked layer leaves (depth leading) and ``structure(leaves, j)``
    builds layer j's parameters from them; ``x`` (B, ...) is the rank's
    batch (the same on every stage), B divisible by ``n_microbatches``.
    Returns the last stage's output on every stage."""
    group = mesh.group("pipe")
    b = x.shape[0]
    if b % n_microbatches:
        raise ValueError(f"this rank's batch {b} does not divide into "
                         f"{n_microbatches} microbatches")
    run = _Run(block_fn, structure, group, mesh.size("pipe"),
               mesh.index("pipe"), n_microbatches)
    xs = C.copy_to(x, group).reshape(n_microbatches, b // n_microbatches,
                                     *x.shape[1:])
    y = C.reduce_from(_GPipe.apply(run, xs, *leaves), group)
    return y.reshape(b, *x.shape[1:])
