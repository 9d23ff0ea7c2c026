"""Check and time K2 and K3 (the bf16 flash-attention backward) of one or
more checkouts on one CUDA card, in the order given.

    python3 scripts/torch_bwd_probe.py DIR [DIR ...]

Each DIR is the root of a checkout of this repository (the current one is
``.``; an older commit can be unpacked with ``git archive`` into a directory
that ``.gitignore`` lists, e.g. ``build/parent``). Every checkout's kernels
are first built at once, one process each, into its own ``build/``; then,
for each DIR in turn, a fresh process imports that checkout's
``rafiki_tpu_torch`` and reports:

- K2 and K3 against their plain versions (relative to max(1, |ref|)) for
  every head dim, at B=2 and B=16, H=3-or-12, non-causal and causal
  (Sq<Skv, dead rows, Sq=Skv), each with the plain forward's lse and delta;
- device times (``chip_smoke.device_ms``) at ViT-B/16's attention shape
  (H=12, S=196, Dh=64) for B=8 and B=64: K1-LSE, K2 with delta as the
  checkout's backward takes them (K2 taking delta itself, or PyTorch's
  delta and then K2), K3, K2 and K3 on the projection's strided views
  (where the checkout takes them; an older one is timed on contiguous
  copies instead, as its backward made them), delta = rowsum(dO o O) in
  PyTorch alone, SDPA's backward (dq, dk and dv together), and at B=64 K2
  and K3 at S=192 (no ragged last tile);
- with ``--step``, the device time of one ViT-B/16 train step at batch 64
  and 128 (seeded weights and images, AdamW) and the kernels' shares of the
  batch-64 step.

Give a DIR twice to see the spread: A B B A compares two commits on one
card. Exits non-zero without CUDA or if a check fails.
"""

from __future__ import annotations

import inspect
import os
import re
import subprocess
import sys

BUILD = ("from rafiki_tpu_torch.ops import _build; _build.build(); "
         "print(_build.build_logs.get('flash_bwd', ''))")


def dq_call(fa, q, k, v, dout, lse, out32, causal=False):
    """K2 as the checkout's backward runs it: ``(dq, delta)``, with K2
    taking delta from the f32 output itself where its wrapper takes
    ``out``, else PyTorch's delta and then K2."""
    if "out" in inspect.signature(fa.flash_attention_dq).parameters:
        return fa.flash_attention_dq(q, k, v, dout, lse, out32, causal)
    delta = fa._delta(out32, dout)
    return fa.flash_attention_dq(q, k, v, dout, lse, delta, causal), delta


def check(fa, randn) -> int:
    """K2 and K3 against their plain versions; returns the failures."""
    failed = 0
    for dh in fa.HEAD_DIMS:
        for b, h in ((2, 3), (16, 12)):
            for sq, skv, causal in ((196, 196, False), (40, 196, True),
                                    (196, 40, True), (196, 196, True)):
                q, dout = randn(b, h, sq, dh), randn(b, h, sq, dh)
                k, v = randn(b, h, skv, dh), randn(b, h, skv, dh)
                _, lse, out32 = fa.flash_attention_plain(q, k, v, causal,
                                                         return_lse=True)
                args = (q, k, v, dout, lse, fa._delta(out32, dout), causal)
                got = (dq_call(fa, *args[:5], out32, causal)[0],
                       *fa.flash_attention_dkv(*args))
                ref = (fa.flash_attention_dq_plain(*args),
                       *fa.flash_attention_dkv_plain(*args))
                rel = [float((a.float() - r.float()).abs().max())
                       / max(1.0, float(r.float().abs().max()))
                       for a, r in zip(got, ref)]
                ok = max(rel) <= 1e-2 and all(
                    bool(a.isfinite().all()) for a in got)
                if causal and sq > skv:
                    ok = ok and float(got[0][:, :, :sq - skv].abs().max()) == 0
                failed += not ok
                print(f"{'ok' if ok else 'FAIL'} Dh={dh} B={b} H={h} Sq={sq} "
                      f"Skv={skv} causal={causal}: relative dq {rel[0]:.3g}, "
                      f"dk {rel[1]:.3g}, dv {rel[2]:.3g}", flush=True)
    return failed


def kernel_times(fa, cs, randn) -> None:
    import torch

    for b in (8, 64):
        q, k, v, dout = (randn(b, 12, 196, 64) for _ in range(4))
        x = randn(b, 196, 768)
        views = [torch.einsum("bsd,dhk->bhsk", x, randn(768, 12, 64) / 28)
                 for _ in range(4)]
        _, lse, out32 = fa.flash_attention_lse(q, k, v)
        args = (q, k, v, dout, lse, fa._delta(out32, dout))
        _, view_lse, view_out32 = fa.flash_attention_lse(*views[:3])
        view_args = (*views, view_lse, fa._delta(view_out32, views[3]))
        try:
            fa.flash_attention_dkv(*view_args)
        except ValueError:  # an older checkout: its backward copied them
            views = [t.contiguous() for t in views]
            view_args = (*views, *view_args[4:])
            print("  (views not taken: K2/K3 'views' timed on copies, the "
                  "copies not counted)", flush=True)
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        sdpa_out = torch.nn.functional.scaled_dot_product_attention(qg, kg,
                                                                    vg)
        times = {
            "K1-LSE": lambda: fa.flash_attention_lse(q, k, v),
            "K2": lambda: dq_call(fa, q, k, v, dout, lse, out32),
            "K3": lambda: fa.flash_attention_dkv(*args),
            "K2 views": lambda: dq_call(fa, *views, view_lse, view_out32),
            "K3 views": lambda: fa.flash_attention_dkv(*view_args),
            "delta": lambda: fa._delta(out32, dout),
            "SDPA bwd": lambda: torch.autograd.grad(
                sdpa_out, (qg, kg, vg), dout, retain_graph=True),
        }
        if b == 64:
            # S=192: three whole 64-row tiles, no ragged last tile (196 has
            # a fourth of 4 rows or keys): what the ragged edge costs
            q2, k2, v2, do2 = (t[:, :, :192].contiguous()
                               for t in (q, k, v, dout))
            _, lse2, out2 = fa.flash_attention_lse(q2, k2, v2)
            args2 = (q2, k2, v2, do2, lse2, fa._delta(out2, do2))
            times["K2 S=192"] = lambda: dq_call(fa, *args2[:5], out2)
            times["K3 S=192"] = lambda: fa.flash_attention_dkv(*args2)
        ms = {name: cs.device_ms(fn) for name, fn in times.items()}
        print(f"B={b}: device ms: " + ", ".join(
            f"{name} {t:.4f}" for name, t in ms.items())
            + f"; K2 + K3 {ms['K2'] + ms['K3']:.4f}", flush=True)


def step_times(cs) -> None:
    """One full-width ViT-B/16 train step (AdamW, bf16 model as the
    template trains it) on seeded weights and images."""
    import numpy as np
    import torch

    from rafiki_tpu_torch import convert
    from rafiki_tpu_torch.models import vit
    from rafiki_tpu_torch.sdk.torch_backend import (
        DataParallelTrainer,
        softmax_classifier_loss,
        tunable_optimizer,
    )

    cfg = vit.vit_b16()
    tree = vit.init(np.random.default_rng(0), cfg)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.random((128, 224, 224, 3), dtype=np.float32))
    y = torch.from_numpy(rng.integers(0, 10, 128).astype(np.int32))
    loss_fn = softmax_classifier_loss(lambda m, xb: m(xb))
    trainer = DataParallelTrainer(
        loss_fn, tunable_optimizer(torch.optim.AdamW, lr=1e-4,
                                   weight_decay=1e-4))
    model, opt = trainer.init(lambda r: convert.from_jax_params(
        tree, cfg, "cuda:0", train=True))
    for n in (64, 128):
        batch = (x[:n].cuda(), y[:n].cuda())
        step = lambda: trainer.train_step(model, opt, batch)  # noqa: E731
        card_ms = cs.device_ms(step, reps=3, inner=3,
                               hold_cycles=400_000_000)
        print(f"step at batch {n}: {card_ms:.2f} ms on the card "
              f"({n / card_ms * 1e3:.1f} images/s)", flush=True)
        if n == 64:
            cs.print_device_profile(step, "batch-64 train step", shares=(
                ("K1-LSE", "flash_fwd_wgmma_kernel"),
                ("K2", "flash_bwd_dq_"), ("K3", "flash_bwd_dkv_"),
                ("copies and casts", "copy_kernel")))


def probe(with_step: bool) -> None:
    """The checks and times of the checkout in the working directory."""
    import importlib

    import torch

    sys.path.insert(0, os.getcwd())
    fa = importlib.import_module("rafiki_tpu_torch.ops.flash_attention")
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    failed = check(fa, randn)
    kernel_times(fa, cs, randn)
    if with_step:
        step_times(cs)
    print(f"checks failed: {failed}", flush=True)
    sys.exit(1 if failed else 0)


def ptxas_report(log: str) -> str:
    """One line per kernel instantiation of a ``-Xptxas -v`` build log:
    its (mangled) name, registers, shared memory and spills; the log's
    error lines where it has any."""
    entries = re.findall(r"Compiling entry function "
                         r"'_Z\w*?(flash_\w+?_kernelI\w+?EE)\w*'.*?\n"
                         r".*?\n\s*(.*?spill loads)\n.*?(Used .*?)\n",
                         log, re.S)
    return "\n".join(f"  {name}: {used}; {spills}"
                     for name, spills, used in entries) or "\n".join(
        line for line in log.splitlines() if "error" in line)


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_bwd_probe: CUDA is not available", file=sys.stderr)
        return 2
    with_step = "--step" in argv
    dirs = [a for a in argv if a != "--step"]
    builds = {d: subprocess.Popen([sys.executable, "-c", BUILD], cwd=d,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
              for d in dict.fromkeys(dirs)}
    rc = 0
    for d, proc in builds.items():
        log, _ = proc.communicate()
        print(f"== {d}: build exit {proc.returncode}; ptxas (flash_bwd):\n"
              + ptxas_report(log), flush=True)
        rc |= proc.returncode
    if rc:
        return rc
    for d in dirs:
        run = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--probe",
             *(["--step"] if with_step else [])], cwd=d,
            capture_output=True, text=True)
        print(f"== {d}: exit {run.returncode}\n{run.stdout}{run.stderr}",
              flush=True)
        rc |= run.returncode
    return rc


if __name__ == "__main__":
    if sys.argv[1:2] == ["--probe"]:
        probe("--step" in sys.argv[2:])
    sys.exit(main(sys.argv[1:]))
