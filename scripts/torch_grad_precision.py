"""How far the bf16 gradients of rafiki_tpu_torch's ViT land from an f32 run.

Runs on the CPU (plain versions of the kernels; the arithmetic of the
flash backward is the kernels'), with seeded weights in the JAX layout:

    python scripts/torch_grad_precision.py [--depth 12] [--batch 4]

One cross-entropy step of ViT-B/16 width (224/16, 768 wide, 12 heads) at
initialization, its gradients taken four ways:

- ``f32``: the whole forward and backward in f32 (the reference);
- ``flash``: bf16, flash attention, delta = rowsum(dO o O) from K1's f32
  output (the port's choice);
- ``flash, delta from bf16 O``: as ``flash``, with delta from the output
  rounded to bf16 (the JAX package's formulation);
- ``plain``: bf16, dense attention (``mha_reference``) under autograd.

It prints each bf16 way's relative L2 error against ``f32``, per
parameter (the worst layer of each), and exits 0. The script patches the
model's compute dtype for the reference and the flash backward's delta
for the third way; it is a measurement, not part of the package.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import re
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from rafiki_tpu_torch import convert  # noqa: E402
from rafiki_tpu_torch.models import core, vit  # noqa: E402

fa = importlib.import_module("rafiki_tpu_torch.ops.flash_attention")


def gradients(tree, cfg, x, y, use_flash, dtype, delta=None):
    cfg = dataclasses.replace(
        cfg, encoder=dataclasses.replace(cfg.encoder, use_flash=use_flash))
    cast, delta_fn = core.cast_for_compute, fa._delta
    core.cast_for_compute = lambda t, d=torch.bfloat16: t.to(dtype)
    if delta is not None:
        fa._delta = delta
    try:
        model = convert.from_jax_params(tree, cfg, "cpu", train=True)
        loss = torch.nn.functional.cross_entropy(model(x).float(), y)
        loss.backward()
    finally:
        core.cast_for_compute, fa._delta = cast, delta_fn
    return {k: p.grad.double() for k, p in model.named_parameters()}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--depth", type=int, default=12)
    parser.add_argument("--batch", type=int, default=4)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    cfg = vit.vit_b16()
    cfg = dataclasses.replace(
        cfg, encoder=dataclasses.replace(cfg.encoder, depth=args.depth))
    tree = vit.init(np.random.default_rng(args.seed), cfg)
    rng = np.random.default_rng(args.seed + 1)
    x = torch.from_numpy(rng.random((args.batch, 224, 224, 3),
                                    dtype=np.float32))
    y = torch.from_numpy(rng.integers(0, 10, args.batch))

    def delta_from_bf16_out(out, dout, delta=fa._delta):
        return delta(out.to(torch.bfloat16), dout)

    ref = gradients(tree, cfg, x, y, False, torch.float32)
    ways = {
        "flash": gradients(tree, cfg, x, y, True, torch.bfloat16),
        "flash, delta from bf16 O": gradients(tree, cfg, x, y, True,
                                              torch.bfloat16,
                                              delta_from_bf16_out),
        "plain": gradients(tree, cfg, x, y, False, torch.bfloat16),
    }
    print(f"ViT-B/16 width, depth {args.depth}, batch {args.batch}, CPU: "
          "gradient relative L2 error against f32, worst layer per leaf")
    for name, grads in ways.items():
        worst = {}
        for k, g in ref.items():
            leaf = re.sub(r"^blocks\.\d+\.", "blocks.*.", k)
            err = float((grads[k] - g).norm() / g.norm())
            worst[leaf] = max(worst.get(leaf, 0.0), err)
        print(f"{name}: " + ", ".join(
            f"{k} {e:.3g}" for k, e in sorted(worst.items())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
