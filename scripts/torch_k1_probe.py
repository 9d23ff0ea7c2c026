"""Check and time K1 (the bf16 flash-attention forward) of one or more
checkouts on one CUDA card, in the order given.

    python3 scripts/torch_k1_probe.py DIR [DIR ...]

Each DIR is the root of a checkout of this repository (the current one is
``.``; an older commit can be unpacked with ``git archive`` into a directory
that ``.gitignore`` lists, e.g. ``build/parent``). Every checkout's kernels
are first built at once, one process each, into its own ``build/``; then,
for each DIR in turn, a fresh process imports that checkout's
``rafiki_tpu_torch`` and reports:

- K1 with the LSE against its plain version (bf16 output relative to
  max(1, |ref|), f32 output, LSE) for every head dim, at B=2 and B=64,
  H=12-or-3, non-causal and causal (Sq<Skv, dead rows, Sq=Skv);
- device times (``chip_smoke.device_ms``) at ViT-B/16's attention shape
  (H=12, S=196, Dh=64) for B=8 and B=64: K1, K1 on the projection's
  strided views (where the checkout takes them), K1-LSE and SDPA;
- the host time of one call of the wrapper, of SDPA, and of the C entry
  alone.

Give a DIR twice to see the spread: A B B A compares two commits on one
card. Exits non-zero without CUDA.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

BUILD = ("from rafiki_tpu_torch.ops import _build; _build.build(); "
         "print(_build.build_logs.get('flash_fwd', ''))")


def probe() -> None:
    """The checks and times of the checkout in the working directory."""
    import importlib

    import torch

    sys.path.insert(0, os.getcwd())
    fa = importlib.import_module("rafiki_tpu_torch.ops.flash_attention")
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    failed = 0
    for dh in fa.HEAD_DIMS:
        for b, h in ((2, 3), (64, 12)):
            for sq, skv, causal in ((196, 196, False), (40, 196, True),
                                    (196, 40, True), (196, 196, True)):
                q, k, v = randn(b, h, sq, dh), randn(b, h, skv, dh), randn(
                    b, h, skv, dh)
                out, lse, out32 = fa.flash_attention_lse(q, k, v, causal)
                ref, ref_lse, ref32 = fa.flash_attention_plain(
                    q, k, v, causal, return_lse=True)
                live = torch.isfinite(ref_lse)
                rel = float(((out.float() - ref.float()).abs()
                             / ref.float().abs().clamp(min=1.0)).max())
                e32 = float((out32 - ref32).abs().max())
                e_lse = float((lse[live] - ref_lse[live]).abs().max()
                              ) if bool(live.any()) else 0.0
                ok = (rel <= 1e-2 and e32 <= 1e-2 and e_lse <= 1e-3
                      and torch.equal(torch.isfinite(lse), live))
                if causal and sq > skv:
                    ok = ok and float(out[:, :, :sq - skv].abs().max()) == 0
                failed += not ok
                print(f"{'ok' if ok else 'FAIL'} Dh={dh} B={b} H={h} Sq={sq} "
                      f"Skv={skv} causal={causal}: bf16 rel {rel:.3g}, f32 "
                      f"{e32:.3g}, lse {e_lse:.3g}", flush=True)
    for b in (8, 64):
        q, k, v = (randn(b, 12, 196, 64) for _ in range(3))
        x = randn(b, 196, 768)
        views = [torch.einsum("bsd,dhk->bhsk", x, randn(768, 12, 64) / 28)
                 for _ in range(3)]
        times = {
            "K1": lambda: fa.flash_attention(q, k, v),
            "K1 strided": lambda: fa.flash_attention(*views),
            "K1-LSE": lambda: fa.flash_attention_lse(q, k, v),
            "SDPA": lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v),
        }
        line = []
        for name, fn in times.items():
            try:
                line.append(f"{name} {cs.device_ms(fn):.4f}")
            except ValueError as exc:  # an older checkout: contiguous only
                line.append(f"{name} not taken ({exc})")
        print(f"B={b}: device ms: " + ", ".join(line), flush=True)
    q, k, v = (randn(8, 12, 196, 64) for _ in range(3))
    calls = {"wrapper": lambda: fa.flash_attention(q, k, v),
             "SDPA": lambda: torch.nn.functional.scaled_dot_product_attention(
                 q, k, v)}
    if hasattr(fa, "_view_strides"):
        fn, _ = fa._fwd_kernel()
        out = torch.empty_like(q)
        strides = fa._Strides(*(s for t in (q, k, v, out)
                                for s in fa._view_strides(t)))
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None, None, 8, 12, 196, 196, 64, 0.125, 0, 1, 64, 64,
                strides, torch.cuda.current_stream().cuda_stream)
        calls["C entry"] = lambda: fn(*args)
    for name, call in calls.items():
        for _ in range(20):
            call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(500):
            call()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        print(f"host time of one call, {name}: "
              f"{(t1 - t0) / 500 * 1e6:.1f} us (B=8)", flush=True)
    print(f"checks failed: {failed}", flush=True)
    sys.exit(1 if failed else 0)


def main(dirs) -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_k1_probe: CUDA is not available", file=sys.stderr)
        return 2
    builds = {d: subprocess.Popen([sys.executable, "-c", BUILD], cwd=d,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
              for d in dict.fromkeys(dirs)}
    rc = 0
    for d, proc in builds.items():
        log, _ = proc.communicate()
        print(f"== {d}: build exit {proc.returncode}; ptxas:\n"
              + "\n".join(line for line in log.splitlines()
                          if "Used" in line or "spill" in line
                          or "error" in line), flush=True)
        rc |= proc.returncode
    if rc:
        return rc
    for d in dirs:
        run = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--probe"], cwd=d, capture_output=True,
                             text=True)
        print(f"== {d}: exit {run.returncode}\n{run.stdout}{run.stderr}",
              flush=True)
        rc |= run.returncode
    return rc


if __name__ == "__main__":
    if sys.argv[1:] == ["--probe"]:
        probe()
    sys.exit(main(sys.argv[1:]))
