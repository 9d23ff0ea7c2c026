"""Where the bf16 flash-attention kernels round, and what it costs the
gradients: BERT-base's attention at initialization, on the CPU.

    python scripts/torch_attention_rounding.py [--batch 8] [--seed 0]

One bf16 cross-entropy step of BERT-base (768 wide, 12 blocks, 12 heads,
S=128, seeded weights in the JAX layout, SST-2-like rows: a first token,
5-40 word ids, then pad id 0, which BERT attends like any token) records
each block's bf16 q, k, v and the gradient dO of its attention output.
Each block's dq, dk and dv are then computed five ways and held against
the exact ones (f64 attention of the same bf16 inputs):

- ``P rounded, dS rounded``: the arithmetic of the bf16 kernels as PR 4
  left them: the training forward's f32 output o32 from P rounded to
  bf16 (P V on bf16 tensor cores), delta = rowsum(dO o o32), P
  recomputed in f32 from the LSE, dS = P o (dP - delta) rounded to bf16
  before dS K and dS^T Q, P rounded before P^T dO;
- ``P rounded, dS split`` and ``P split, dS rounded``: one of the two
  roundings replaced by a split into bf16 rounded plus its rounded
  remainder (two products into one f32 accumulator);
- ``P split, dS split``: both split (the kernels' arithmetic now);
- ``plain``: bf16 ``mha_reference`` under autograd (the plain path).

It prints each block's relative L2 errors and the worst over the blocks,
and exits 0. It emulates the kernels' rounding in PyTorch; it runs no
kernel and is a measurement, not part of the package.
"""

from __future__ import annotations

import argparse
import importlib
import math
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from rafiki_tpu_torch import convert  # noqa: E402
from rafiki_tpu_torch.models import bert  # noqa: E402

attention = importlib.import_module("rafiki_tpu_torch.ops.attention")

S = 128


def record(batch: int, seed: int) -> list:
    """Each block's bf16 (q, k, v, dO) from one bf16 step of BERT-base."""
    base = bert.bert_base()
    cfg = bert.BertConfig(max_len=S, encoder=base.encoder)
    model = convert.from_jax_params(bert.init(np.random.default_rng(seed),
                                              cfg), cfg, "cpu", train=True)
    rng = np.random.default_rng(seed + 1)
    ids = np.zeros((batch, S), np.int64)
    for row in ids:
        n = rng.integers(5, 41)
        row[0] = 1
        row[1:n + 1] = rng.integers(2, cfg.vocab, n)
    y = torch.from_numpy(rng.integers(0, 2, batch))
    calls, plain = [], attention.mha_reference

    def recording(q, k, v, causal=False, sm_scale=None):
        o = plain(q, k, v, causal, sm_scale)
        calls.append([t.detach() for t in (q, k, v)])
        o.register_hook(lambda g, c=calls[-1]: c.append(g.detach()))
        return o

    attention.mha_reference = recording
    try:
        loss = torch.nn.functional.cross_entropy(
            model(torch.from_numpy(ids), torch.bfloat16), y)
        loss.backward()
    finally:
        attention.mha_reference = plain
    return calls


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def as_operand(x: torch.Tensor, split: bool) -> torch.Tensor:
    """``x`` as a bf16 A operand reaches an f32 accumulator: rounded, or
    rounded plus its rounded remainder."""
    hi = bf16(x)
    return hi + bf16(x - hi) if split else hi


def kernel_grads(q, k, v, do, split_p: bool, split_ds: bool):
    """dq, dk, dv with the bf16 kernels' rounding (f32 elsewhere)."""
    q, k, v, do = (t.float() for t in (q, k, v, do))
    scale = 1 / math.sqrt(q.shape[-1])
    s = q @ k.transpose(-1, -2) * scale
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o32 = as_operand(p, split_p) @ v / l
    p = torch.exp(s - (m + torch.log(l)))
    delta = (do * o32).sum(-1, keepdim=True)
    ds = as_operand(p * (do @ v.transpose(-1, -2) - delta), split_ds)
    return (ds @ k * scale, ds.transpose(-1, -2) @ q * scale,
            bf16(p).transpose(-1, -2) @ do)


def exact_grads(q, k, v, do):
    q, k, v, do = (t.double() for t in (q, k, v, do))
    scale = 1 / math.sqrt(q.shape[-1])
    p = torch.softmax(q @ k.transpose(-1, -2) * scale, -1)
    dp = do @ v.transpose(-1, -2)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    return (ds @ k * scale, ds.transpose(-1, -2) @ q * scale,
            p.transpose(-1, -2) @ do)


def plain_grads(q, k, v, do):
    q, k, v = (t.clone().requires_grad_() for t in (q, k, v))
    attention.mha_reference(q, k, v).backward(do)
    return q.grad, k.grad, v.grad


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    ways = {
        "P rounded, dS rounded": lambda *t: kernel_grads(*t, False, False),
        "P rounded, dS split": lambda *t: kernel_grads(*t, False, True),
        "P split, dS rounded": lambda *t: kernel_grads(*t, True, False),
        "P split, dS split": lambda *t: kernel_grads(*t, True, True),
        "plain": plain_grads,
    }
    worst = {name: [0.0, 0.0, 0.0] for name in ways}
    print(f"BERT-base at initialization, batch {args.batch}, S={S}, CPU: "
          "relative L2 error of dq, dk, dv against exact attention of the "
          "same bf16 inputs", flush=True)
    for block, (q, k, v, do) in enumerate(record(args.batch, args.seed)):
        exact = exact_grads(q, k, v, do)
        cells = []
        for name, way in ways.items():
            errs = [float((g.double() - e).norm() / e.norm())
                    for g, e in zip(way(q, k, v, do), exact)]
            worst[name] = [max(a, b) for a, b in zip(worst[name], errs)]
            cells.append(name + " " + "/".join(f"{e:.2e}" for e in errs))
        print(f"block {block}: " + "; ".join(cells), flush=True)
    for name, errs in worst.items():
        print(f"worst over blocks, {name}: dq {errs[0]:.2e}, dk "
              f"{errs[1]:.2e}, dv {errs[2]:.2e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
