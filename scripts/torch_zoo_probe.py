"""Time the zoo's ResNet-50 train step and serving forward on one CUDA
card with two BatchNorms, in turns.

    python3 scripts/torch_zoo_probe.py [--batches 64,128]

A is the port's ``models.resnet.batchnorm`` (ATen's fused batch-norm
kernel over the ``channels_last`` view); B is the same function written
out as the JAX package's ``_batchnorm`` is (``rafiki_tpu/models/
resnet.py:51-67``: an f32 cast, ``var_mean``, elementwise passes, the
cast back). For each batch, in the order A B B A, on ResNet-50 with the
CIFAR stem (10 classes, 32x32x3 bf16, seeded weights and images, AdamW
through the stateful ``DataParallelTrainer.train_step``):

- the step per call (host clock, median of 10 ending in a synchronise)
  and on the card (CUDA events around 3 queued steps while the card is
  held busy: ``chip_smoke.device_ms``);
- the step's kernels by the profiler: their sum and the launches;
- the evaluation forward at the 64 bucket, per call and on the card.

It first checks A and B against an f32 run of the same training
forward (activations in f32, where the two BatchNorms compute the same
numbers to f32 rounding): the logits' and each running statistic's
error, relative to max(1, max |f32|), is printed for each, and A's may
be at most 1.5x B's (or 1e-3). Prints the card's name and power limit.
Exits non-zero without CUDA or if the check fails.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402  (the timing helpers)
from rafiki_tpu_torch.convert import from_jax_tree  # noqa: E402
from rafiki_tpu_torch.models import core, resnet  # noqa: E402
from rafiki_tpu_torch.sdk.torch_backend import (  # noqa: E402
    DataParallelTrainer,
    tunable_optimizer,
)
from rafiki_tpu_torch.templates import torch_resnet  # noqa: E402

FUSED = resnet.batchnorm


def written_out(p, stats, x, train, momentum=0.9, eps=1e-5):
    """The JAX package's ``_batchnorm``, pass for pass."""
    xf = x.float()
    if train:
        var, mean = torch.var_mean(xf, dim=(0, 1, 2), correction=0)
        new = {"mean": momentum * stats["mean"] + (1 - momentum)
               * mean.detach(),
               "var": momentum * stats["var"] + (1 - momentum)
               * var.detach()}
    else:
        mean, var, new = stats["mean"], stats["var"], dict(stats)
    y = (xf - mean) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return y.to(x.dtype), new


VARIANTS = {"A fused": FUSED, "B written out": written_out}


def build(cfg, tree):
    with torch.device("meta"):
        model = resnet.ResNet(cfg)
    return from_jax_tree(model, *tree, "cuda:0", train=True)


def profile(fn):
    """(kernel ms, launches) of one call, from torch.profiler."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as prof_ctx

    fn()
    torch.cuda.synchronize()
    with prof_ctx(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    return (sum(e.self_device_time_total for e in rows) / 1e3,
            sum(e.count for e in rows))


def _forward(cfg, tree, x, bn, dtype):
    resnet.batchnorm = bn
    cast = core.cast_for_compute
    core.cast_for_compute = lambda t, d=dtype: t.to(d)
    try:
        model = build(cfg, tree)
        with torch.no_grad():
            logits, new = model(x, train=True)
    finally:
        core.cast_for_compute = cast
        resnet.batchnorm = FUSED
    return logits.float(), new


def check(cfg, tree, x) -> bool:
    """A and B (bf16) against the f32 forward."""
    ref_logits, ref_stats = _forward(cfg, tree, x, written_out,
                                     torch.float32)

    def rel(got, ref):
        return float((got - ref).abs().max()) / max(
            1.0, float(ref.abs().max()))

    errs = {}
    for name, fn in VARIANTS.items():
        logits, stats = _forward(cfg, tree, x, fn, torch.bfloat16)
        errs[name] = (rel(logits, ref_logits),
                      max(rel(stats[k], ref_stats[k]) for k in ref_stats))
        print(f"check: {name} (bf16) against the f32 forward: logits "
              f"{errs[name][0]:.3g}, running statistics {errs[name][1]:.3g}"
              f" (relative to max(1, max |f32|))", flush=True)
    (la, sa), (lb, sb) = errs["A fused"], errs["B written out"]
    ok = la <= max(1.5 * lb, 1e-3) and sa <= max(1.5 * sb, 1e-3)
    print(f"check: A within 1.5x of B's error (or 1e-3): "
          f"{'ok' if ok else 'FAILED'}", flush=True)
    return ok


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", default="64,128")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_zoo_probe: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    cfg = resnet.resnet50(num_classes=10, small_inputs=True)
    tree = resnet.init(np.random.default_rng(0), cfg)
    rng = np.random.default_rng(1)
    batches = [int(b) for b in args.batches.split(",")]
    x = torch.from_numpy(rng.random((max(batches + [64]), 32, 32, 3),
                                    dtype=np.float32)).cuda()
    y = torch.from_numpy(rng.integers(0, 10, len(x))).cuda()
    if not check(cfg, tree, x[:64]):
        return 1
    order = ["A fused", "B written out", "B written out", "A fused"]
    for batch in batches:
        data = (x[:batch], y[:batch])
        for name in order:
            resnet.batchnorm = VARIANTS[name]
            model = build(cfg, tree)
            state = model.state()
            trainer = DataParallelTrainer(
                torch_resnet._loss, tunable_optimizer(
                    torch.optim.AdamW, lr=1e-4, weight_decay=1e-4),
                device="cuda:0", stateful=True)
            opt = trainer.optimizer(model.parameters())

            def step():
                return trainer.train_step(model, opt, data, state)

            call = chip_smoke.median_ms(step, reps=10)
            dev = chip_smoke.device_ms(step, reps=3, inner=3,
                                       hold_cycles=400_000_000)
            kernels, launches = profile(step)
            print(f"step batch {batch} {name}: {call:.2f} ms per call, "
                  f"{dev:.2f} ms on the card, {kernels:.2f} ms of kernels "
                  f"in {launches} launches; card {card}", flush=True)
            del model, opt, state, trainer
    for name in order:
        resnet.batchnorm = VARIANTS[name]
        model = build(cfg, tree).eval()
        state = model.state()

        def forward():
            with torch.inference_mode():
                return torch_resnet._probs(model, state, x[:64])

        call = chip_smoke.median_ms(forward, reps=20)
        dev = chip_smoke.device_ms(forward)
        kernels, launches = profile(forward)
        print(f"eval forward bucket 64 {name}: {call:.2f} ms per call, "
              f"{dev:.2f} ms on the card, {kernels:.2f} ms of kernels in "
              f"{launches} launches; card {card}", flush=True)
        del model, state
    resnet.batchnorm = FUSED
    return 0


if __name__ == "__main__":
    sys.exit(main())
