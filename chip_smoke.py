"""Chip smoke test of the rafiki_tpu_torch port on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):

1. header: the card (nvidia-smi name and power limit), the torch and CUDA
   versions, the kernel build (one nvcc per source, started together,
   sm_90a, from ``rafiki_tpu_torch/ops/csrc/``, into
   ``build/rafiki_tpu_torch/``) and the ptxas register/shared-memory report
   of each kernel's main-path instantiation;
2. kernels: each kernel against its plain PyTorch version on the same
   seeded inputs, at the main paths' shapes and at edge cases, with
   device times (CUDA events around queued back-to-back calls) beside the
   bound and PyTorch's own call for the same function: K1 (flash_fwd) at
   the serving shapes, contiguous and on the projection's strided views,
   K1 with the LSE (flash_fwd_lse), K2 (flash_bwd_dq) and K3
   (flash_bwd_dkv) at the training shape, contiguous and on the
   projection's strided views; K2 and K3 at every head dim, at the ragged,
   causal (Sq<Skv) and dead-row cases and on strided views (the same bits
   as contiguous copies); each kernel's achieved TB/s and share of its
   bound;
3. train: a seeded synthetic 10-class image dataset written as ``.npz``,
   and a 2-trial ViT-B/16 train job through ``TrainWorker`` (GP advisor,
   database, ``TorchViT.train`` -> ``DataParallelTrainer.fit`` with AdamW,
   ``evaluate``, params artifact); every trial COMPLETED with a finite
   score, parameters moved, and the kernels' launches counted against 12
   per train step (K1 with the LSE, K2, K3) and 12 per evaluate forward
   (K1); one train step through the kernels against one through plain
   attention, loss and every parameter's gradient; the step's time at
   batch 64 and 128, and a kernel profile of one step;
4. serve: the two trials the train job produced, served through
   ``InferenceWorker`` -> ``Predictor`` -> ``PredictorServer``; ``POST
   /predict`` answers are checked against the two models' plain-attention
   forward on the card, and every kernel's launch count against the
   number of bucketed forwards (K1 12 a forward, the others none); then
   where a request's time goes (one forward per
   call and on the card, and a kernel profile of the bucket-64 forward,
   beside the same forward with q, k, v copied before K1);
5. stack: the same cycle through the entry points a user calls. The
   ``AdminServer`` starts in this process (SQLite store under
   ``build/chip_smoke/``); the ``Client`` logs in as the superadmin,
   uploads ``templates/torch_vit.py`` as bytes (enforce verification),
   runs a 2-trial train job (``CHIP_COUNT=1``) on phase 3's dataset and
   waits for STOPPED: 2 COMPLETED trials with finite scores, the train
   service granted cuda:0, K1-LSE, K2 and K3 launched 12 times a step and
   K1 12 times an evaluate. Then an inference job of the two trials (both
   workers on cuda:0), ``Client.predict`` on ``/predict/<app>`` with 1
   and 8 images (JSON) against the plain-attention ensemble of the
   trials' parameters as ``Client.download_trial_params`` returns them,
   and K1 launched 12 times a bucketed forward. Printed: the job's wall
   time and each trial's set-up, beside phase 3's direct job (which ran
   first, on a cold process), the p50 of ``/predict/<app>`` on the admin
   door beside a ``PredictorServer`` on the same job's ``Predictor``,
   the two doors taking the same JSON bodies in turns, and the parameter
   download's time and bytes with the verified read's share. Last,
   ``python -m rafiki_tpu_torch.admin`` boots on port 0, answers ``GET /``
   and a login, and exits 0 on SIGTERM;
6. process: the cycle of phase 5 under ``RAFIKI_PLACEMENT=process``
   (store ``build/chip_smoke/process.sqlite3``, the children's logs in
   ``build/chip_smoke/process_logs/``). The shm ring is chosen from
   ``df -B1 /dev/shm`` (16 MiB when its 3 rings fit in 80% of the free
   space) and printed. The 2-trial job runs in a train child granted the
   card through ``CUDA_VISIBLE_DEVICES``, whose advisor is the admin's
   REST door; both trials COMPLETED with finite scores, their rows
   written by the child, and none of this process's kernel counts moved.
   Then both trials are served by two children over the rings, and a
   second admin (thread placement) serves the same trials' artifacts:
   ``Client.predict`` of 1 and 8 images held within 0.05 p + 1e-5 of the
   plain-attention ensemble, and the same JSON bodies timed on both
   admin doors in turns. Printed: the job's wall time beside phase 5's
   and where it went (child start-up, each trial's set-up and epochs),
   each child's spawn to RUNNING split into interpreter and package
   import, torch import, CUDA init, kernel library load and the rest,
   the deploy time, and the p50 of each door. Each child's launches come
   from its exit line: the train child K1-LSE, K2 and K3 12 a step and K1
   12 an evaluate, each serving child K1 12 a bucketed forward. After the
   stop no child is alive and no ring of the broker is left in /dev/shm.

The line before the last is ``{"kernels": [...]}``, each kernel's
``launches`` from phase 5 and ``launches_by_path`` from every path; the
last is ``{"ok": true, "device": {...}}``. Exits non-zero without CUDA.
"""

from __future__ import annotations

import dataclasses
import importlib
import io
import json
import os
import re
import signal
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
WORK = REPO / "build" / "chip_smoke"  # dataset and params (ignored by git)
TEMPLATE = REPO / "rafiki_tpu_torch" / "templates" / "torch_vit.py"
SEED = 0
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# kernel vs its plain version: bf16 outputs are rounded to bf16 (2^-8
# relative of O(1) values) and the backward kernels also round P and dS to
# bf16 before their second products; f32 differs by summation order only.
# Gradients are not O(1): their error is taken relative to max(1, max|ref|)
TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}
LSE_TOL = {torch.bfloat16: 1e-3, torch.float32: 1e-5}
# K2's delta = rowsum(dO o O) against PyTorch's: f32 sums of Dh products
# in another order, relative to max(1, max |delta|)
DELTA_TOL = 1e-5
DEPTH = 12  # ViT-B/16 blocks: one launch of each attention kernel per block
# served probabilities vs the plain-attention forward: both run bf16
# through 12 blocks and differ where bf16 rounds (the kernel keeps PV in
# f32, mha_reference rounds p to bf16), so the logits differ by O(1e-2)
# and each p by that share of itself: |dp| <= PROB_RTOL * p + PROB_ATOL.
# Over 1000 classes a p is ~1e-3, so an absolute bound alone would pass a
# wrong answer
PROB_RTOL = 5e-2
PROB_ATOL = 1e-5
# one train step through the kernels vs through plain attention, from the
# same weights and batch: the two bf16 paths round at different places in
# 12 blocks forward and backward (2^-8 relative per rounding). The loss
# within 1e-2; each parameter's gradient within 1e-2 of its L2 norm, but
# the q/k projections': at initialization their gradient is a small
# difference (dP - delta over nearly uniform attention), and each bf16
# path lands ~5% of its norm from an f32 run there (CPU measurement at
# ViT-B/16 width), so within 1e-1
LOSS_ATOL = 1e-2
GRAD_RTOL = 1e-2
QK_GRAD_RTOL = 1e-1
QK_LEAVES = ("attn.wq", "attn.wk")
TRAIN_IMAGES, TEST_IMAGES, CLASSES = 512, 128, 10
TRIALS = 2


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def prob_check(label: str, probs: np.ndarray, ref: np.ndarray) -> str:
    """Holds served probabilities against the plain-attention ones
    within ``PROB_RTOL * p + PROB_ATOL``; returns what was measured."""
    err = np.abs(probs - ref)
    used = float((err / (PROB_RTOL * ref + PROB_ATOL)).max())
    rel = float((err / ref).max())
    require(used <= 1, f"{label}: |p - p_plain| up to {err.max():.3g} and "
            f"{rel:.3g} of p: over {PROB_RTOL:g} p + {PROB_ATOL:g} "
            f"({used:.3g} of the bound)")
    return (f"max |p - p_plain| {err.max():.3g}, {rel:.3g} of p at most, "
            f"{used:.3g} of the bound {PROB_RTOL:g} p + {PROB_ATOL:g} "
            f"(max p {ref.max():.3g}, min p {ref.min():.3g})")


def median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median over ``reps`` calls of the CUDA-event time around one call,
    host dispatch included: what a caller waits for one call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int = 7, inner: int = 20, warmup: int = 3,
              hold_cycles: int = 50_000_000) -> float:
    """Device time of one call: the median over ``reps`` of the CUDA-event
    time around ``inner`` back-to-back calls, divided by ``inner``. The card
    is first held busy (``torch.cuda._sleep``) while the host queues the
    calls, so host dispatch does not show in the time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(hold_cycles)  # 5e7 cycles: ~25 ms
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def print_device_profile(fn, label: str, top: int = 8,
                         shares: tuple = ()) -> None:
    """Device time of one call of ``fn`` by kernel, from torch.profiler
    (CUPTI): the ``top`` kernels and their share of the call's total, then
    the share of each ``(label, name fragment)`` in ``shares``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.self_device_time_total > 0]
    total = sum(ms for _, ms, _ in rows)
    if not total:
        print(f"profile of one {label}: the profiler saw no device time")
        return
    print(f"profile of one {label}: {total:.3f} ms of kernels in "
          f"{sum(c for _, _, c in rows)} launches")
    for name, ms, count in sorted(rows, key=lambda r: -r[1])[:top]:
        print(f"  {ms:8.3f} ms {100 * ms / total:5.1f}% x{count:<4d} "
              f"{name[:110]}")
    for what, fragment in shares:
        ms = sum(m for name, m, _ in rows if fragment in name)
        count = sum(c for name, _, c in rows if fragment in name)
        print(f"  {what}: {ms:.3f} ms, {100 * ms / total:.1f}% of the "
              f"{label}, x{count}")


def attention_bound(kind, b, h, sq, skv, dh, causal, dtype):
    """(bound_ms, bound_by, bytes) of one call of an attention kernel: the
    bytes it must move and the larger
    of its bytes over HBM bandwidth (each input read once, each output
    written once) and its FLOPs over the type's peak, both counted from
    the visible (query, key) pairs of this call.

    - fwd: reads q, k, v; writes o; 4 Dh FLOPs a pair (QK^T, PV);
    - fwd_lse: fwd, and writes the (B*H, Sq) f32 LSE and, for bf16, the
      f32 output the backward's delta is taken from;
    - dq: reads q, k, v, dO, lse and the f32 output; writes dq and delta
      = rowsum(dO o O); 6 Dh FLOPs a pair (QK^T, dO V^T, dS K) and 2 Dh a
      row (delta);
    - dkv: reads as dq; writes dk, dv; 8 Dh a pair (K Q^T, V dO^T, P^T dO,
      dS^T Q)."""
    size = torch.tensor([], dtype=dtype).element_size()
    q_el, kv_el, rows = b * h * sq * dh, b * h * skv * dh, b * h * sq
    nbytes, per_pair = {
        "fwd": ((2 * q_el + 2 * kv_el) * size, 4),
        "fwd_lse": ((2 * q_el + 2 * kv_el) * size + 4 * rows
                    + (4 * q_el if size < 4 else 0), 4),
        "dq": ((3 * q_el + 2 * kv_el) * size + 4 * q_el + 8 * rows, 6),
        "dkv": ((2 * q_el + 4 * kv_el) * size + 8 * rows, 8),
    }[kind]
    if causal:
        i = np.arange(sq)[:, None]
        j = np.arange(skv)[None, :]
        pairs = int((j <= i + (skv - sq)).sum())
    else:
        pairs = sq * skv
    flops = per_pair * b * h * pairs * dh + (2 * q_el if kind == "dq" else 0)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations"), nbytes


def rate(bound, ms) -> str:
    """Achieved device-memory rate and share of the bound of a call that
    took ``ms``."""
    return (f"{bound[2] / ms / 1e9:.2f} TB/s, {100 * bound[0] / ms:.0f}% of "
            f"the bound")


# ---------------------------------------------------------------------------
# phase 1: header and build
# ---------------------------------------------------------------------------

# each kernel's main-path instantiation: bf16, Dh = 64
PTXAS = (("K1", "flash_fwd", "flash_fwd_wgmma_kernelILi64EE"),
         ("K2", "flash_bwd", "flash_bwd_dq_wgmma_kernelILi64EE"),
         ("K3", "flash_bwd", "flash_bwd_dkv_wgmma_kernelILi64EE"))


def header() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, python "
          f"{sys.version.split()[0]}")
    from rafiki_tpu_torch.ops import _build

    t0 = time.perf_counter()
    seconds = _build.build()
    print(f"kernel build: {json.dumps(seconds)} "
          f"({time.perf_counter() - t0:.1f} s wall, one nvcc per source, "
          f"sm_90a, sources {_build.CSRC.relative_to(REPO)}, "
          f"libraries {_build.BUILD_DIR.relative_to(REPO)})")
    for label, source, symbol in PTXAS:
        log = _build.build_logs.get(source)
        m = re.search(symbol + r".*?\n.*?\n\s*(.*?spill loads)\n.*?(Used .*?)\n",
                      log or "", re.S)
        print(f"ptxas {label} (bf16, Dh=64, {symbol}): "
              + (f"{m.group(2)}; {m.group(1)}" if m else
                 "library was already built (no report)" if log is None
                 else "symbol not found in the build log"))
    return card


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _rel_err(out, ref) -> float:
    ref = ref.float()
    return float((out.float() - ref).abs().max()) / max(
        1.0, float(ref.abs().max()))


def _entry(name, source, replaces, err, tol, shape, kernel_ms, plain_ms,
           library_ms, bound, **extra):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "shape": shape, "dtype": "bf16",
            "max_abs_err": err, "tolerance": tol, "ms": kernel_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound[0], "bound_by": bound[1], **extra}


def kernel_phase():
    """Every kernel against its plain version; returns the kernels'
    entries for the ``{"kernels": [...]}`` line (launches are filled in
    from the main paths) and K1's serving times by batch."""
    # the module (ops/__init__ re-exports the function under its name)
    fa = importlib.import_module("rafiki_tpu_torch.ops.flash_attention")

    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    def qkv(b, h, sq, skv, dh, dtype):
        return [randn(b, h, s, dh, dtype=dtype) for s in (sq, skv, skv)]

    # (label, b, h, sq, skv, dh, causal, dtype, block_q, block_k)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        ("vit B=8", 8, 12, 196, 196, 64, False, bf16, 64, 64),
        ("vit B=64", 64, 12, 196, 196, 64, False, bf16, 64, 64),
        ("S=40, 16-tiles", 2, 4, 40, 40, 64, False, bf16, 16, 16),
        ("Sq<Skv causal", 2, 4, 64, 196, 64, True, bf16, 64, 64),
        ("dead rows: causal Skv<Sq", 2, 4, 196, 64, 64, True, bf16, 32, 16),
        ("f32", 4, 12, 196, 196, 64, False, f32, 64, 32),
    ]
    entries, times = {}, {}
    for label, b, h, sq, skv, dh, causal, dtype, bq, bk in cases:
        q, k, v = qkv(b, h, sq, skv, dh, dtype)
        out = fa.flash_attention(q, k, v, causal, None, bq, bk)
        torch.cuda.synchronize()
        ref = fa.flash_attention_plain(q, k, v, causal, None, bk)
        err = float((out.float() - ref.float()).abs().max())
        tol = TOL[dtype]
        line = (f"K1 {label}: B={b} H={h} Sq={sq} Skv={skv} Dh={dh} "
                f"causal={causal} {str(dtype).split('.')[-1]} "
                f"tiles {bq}x{bk}: max_abs_err {err:.3g} (tol {tol:g})")
        require(bool(torch.isfinite(out).all()), f"{line}: non-finite")
        require(err <= tol, line)
        if label.startswith("dead rows"):
            dead = sq - skv  # rows i < Sq - Skv see no key
            dead_max = float(out[:, :, :dead].abs().max())
            require(dead_max == 0.0, f"{line}: dead rows not 0 ({dead_max})")
            line += f"; dead rows exactly 0 ({dead} rows)"
        if label.startswith("vit"):
            fn_kernel = lambda: fa.flash_attention(q, k, v, causal, None, bq,
                                                   bk)
            kernel_ms = times[b] = device_ms(fn_kernel)
            plain_ms = device_ms(
                lambda: fa.flash_attention_plain(q, k, v, causal, None, bk))
            library_ms = device_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, is_causal=causal))
            bound = attention_bound("fwd", b, h, sq, skv, dh, causal, dtype)
            line += (f"; kernel_ms {kernel_ms:.4f} ({rate(bound, kernel_ms)})"
                     f", plain_ms {plain_ms:.4f}, library_ms (SDPA) "
                     f"{library_ms:.4f}, bound_ms {bound[0]:.4f} "
                     f"({bound[1]})")
            entries["flash_fwd"] = _entry(
                "flash_fwd", "rafiki_tpu_torch/ops/csrc/flash_fwd.cu",
                "rafiki_tpu/ops/flash_attention.py:143", err, tol,
                [b, h, sq, dh], kernel_ms, plain_ms, library_ms, bound)
        print(line, flush=True)
    entries["flash_fwd"]["strided_ms"] = strided_serving_case(fa, randn)
    entries.update(training_kernels(fa, qkv, randn))
    backward_head_dims(fa, randn)
    return entries, times


def projection_views(randn, b, h, s, dh, n=3):
    """``n`` bf16 (B, H, S, Dh) views of (B, S, H, Dh) memory, as the
    projection einsum hands q, k, v (and its backward dO) over, unit
    variance."""
    bf16 = torch.bfloat16
    x = randn(b, s, h * dh, dtype=bf16)
    views = [torch.einsum("bsd,dhk->bhsk", x, (randn(
        h * dh, h, dh, dtype=torch.float32) / (h * dh) ** 0.5).to(bf16))
        for _ in range(n)]
    require(not views[0].is_contiguous(),
            f"einsum gave a contiguous view {views[0].stride()}")
    return views


def strided_serving_case(fa, randn) -> float:
    """K1 at B=64 on the serving layout: q, k, v as the projection einsum
    hands them over, (B, H, S, Dh) views of (B, S, H, Dh) memory, which the
    kernel reads through its tensor maps without a copy. Returns its device
    time."""
    bf16 = torch.bfloat16
    b, h, sq, dh = 64, 12, 196, 64
    q, k, v = projection_views(randn, b, h, sq, dh)
    out = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    ref = fa.flash_attention_plain(q, k, v)
    err = float((out.float() - ref.float()).abs().max())
    line = (f"K1 vit B=64, strided views {tuple(q.stride())}: max_abs_err "
            f"{err:.3g} (tol {TOL[bf16]:g})")
    require(bool(torch.isfinite(out).all()), f"{line}: non-finite")
    require(err <= TOL[bf16], line)
    kernel_ms = device_ms(lambda: fa.flash_attention(q, k, v))
    plain_ms = device_ms(lambda: fa.flash_attention_plain(q, k, v))
    library_ms = device_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v))
    bound = attention_bound("fwd", b, h, sq, sq, dh, False, bf16)
    print(f"{line}; kernel_ms {kernel_ms:.4f} ({rate(bound, kernel_ms)}), "
          f"plain_ms {plain_ms:.4f}, library_ms (SDPA on the same views) "
          f"{library_ms:.4f}", flush=True)
    return kernel_ms


def training_kernels(fa, qkv, randn):
    """K1 with the LSE, K2 and K3 against their plain versions at the
    training shape (timed) and at K1's edge cases."""
    bf16, f32 = torch.bfloat16, torch.float32
    # (label, b, h, sq, skv, dh, causal, dtype, block_q, block_k)
    cases = [
        ("train B=64", 64, 12, 196, 196, 64, False, bf16, 64, 64),
        ("S=40, 16-tiles", 2, 4, 40, 40, 64, False, bf16, 16, 16),
        ("Sq<Skv causal", 2, 4, 64, 196, 64, True, bf16, 64, 64),
        ("dead rows: causal Skv<Sq", 2, 4, 196, 64, 64, True, bf16, 32, 16),
        ("f32", 4, 12, 196, 196, 64, False, f32, 64, 32),
    ]
    entries = {}
    for label, b, h, sq, skv, dh, causal, dtype, bq, bk in cases:
        q, k, v = qkv(b, h, sq, skv, dh, dtype)
        dout = randn(b, h, sq, dh, dtype=dtype)
        out, lse, out32 = fa.flash_attention_lse(q, k, v, causal, None, bq,
                                                 bk)
        torch.cuda.synchronize()
        ref_out, ref_lse, ref_out32 = fa.flash_attention_plain(
            q, k, v, causal, None, bk, return_lse=True)
        # K2 and K3 get the plain forward's out and lse, K3 PyTorch's
        # delta: each kernel alone
        delta = fa._delta(ref_out32, dout)
        args = (q, k, v, dout, ref_lse, delta, causal, None, bq, bk)
        dq, dq_delta = fa.flash_attention_dq(q, k, v, dout, ref_lse,
                                             ref_out32, *args[6:])
        dk, dv = fa.flash_attention_dkv(*args)
        torch.cuda.synchronize()
        ref_dq = fa.flash_attention_dq_plain(*args[:-2], bk)
        ref_dk, ref_dv = fa.flash_attention_dkv_plain(*args[:-2], bq)
        live = torch.isfinite(ref_lse)
        errs = {
            "out": max(float((out.float() - ref_out.float()).abs().max()),
                       float((out32 - ref_out32).abs().max())),
            "lse": float((lse[live] - ref_lse[live]).abs().max()),
            "dq": float((dq.float() - ref_dq.float()).abs().max()),
            "dk": float((dk.float() - ref_dk.float()).abs().max()),
            "dv": float((dv.float() - ref_dv.float()).abs().max()),
            "delta": _rel_err(dq_delta, delta),
        }
        rel = {"dq": _rel_err(dq, ref_dq), "dk": _rel_err(dk, ref_dk),
               "dv": _rel_err(dv, ref_dv)}
        where = (f"B={b} H={h} Sq={sq} Skv={skv} Dh={dh} causal={causal} "
                 f"{str(dtype).split('.')[-1]} tiles {bq}x{bk}")
        line = (f"K1-LSE/K2/K3 {label}: {where}: max_abs_err out "
                f"{errs['out']:.3g}, lse {errs['lse']:.3g} (tol "
                f"{LSE_TOL[dtype]:g}), dq {errs['dq']:.3g}, dk "
                f"{errs['dk']:.3g}, dv {errs['dv']:.3g}; relative "
                + ", ".join(f"{n} {e:.3g}" for n, e in rel.items())
                + f" (tol {TOL[dtype]:g}), K2's delta {errs['delta']:.3g} "
                f"(tol {DELTA_TOL:g})")
        require(all(bool(torch.isfinite(t).all())
                    for t in (out, dq, dk, dv, dq_delta)),
                f"{line}: non-finite")
        require(errs["delta"] <= DELTA_TOL, line)
        require(torch.equal(torch.isfinite(lse), live),
                f"{line}: LSE finite on other rows than the plain one")
        require(errs["out"] <= TOL[dtype], line)
        require(errs["lse"] <= LSE_TOL[dtype], line)
        require(all(e <= TOL[dtype] for e in rel.values()), line)
        if label.startswith("dead rows"):
            dead = sq - skv
            dq_dead = float(dq[:, :, :dead].abs().max())
            lse_dead = lse.view(b, h, sq)[:, :, :dead]
            require(dq_dead == 0.0 and bool(torch.isinf(lse_dead).all())
                    and float(out[:, :, :dead].abs().max()) == 0.0,
                    f"{line}: dead rows: dq {dq_dead}, lse not all +inf, "
                    "or out not 0")
            line += (f"; dead rows: out and dq exactly 0, lse +inf "
                     f"({dead} rows)")
        if label.startswith("train"):
            line += "\n" + timed_training_kernels(fa, randn, entries, args,
                                                   ref_out32, errs, rel)
        print(line, flush=True)
    return entries


def backward_head_dims(fa, randn) -> None:
    """K2 and K3 against their plain versions at every head dim: S=196,
    causal with Sq<Skv, and dead rows (contiguous inputs), then on the
    projection's strided views of q, k, v and dO, which must give the same
    bits as contiguous copies. Each kernel gets the plain forward's lse and
    f32 output (K3 PyTorch's delta), so it is held alone; K2's delta is
    checked against PyTorch's."""
    tol = TOL[torch.bfloat16]
    for dh in fa.HEAD_DIMS:
        # (label, b, h, sq, skv, causal)
        cases = [("S=196", 2, 4, 196, 196, False),
                 ("Sq<Skv causal", 2, 4, 64, 196, True),
                 ("dead rows", 2, 4, 196, 64, True),
                 ("views", 2, 4, 196, 196, False)]
        parts = []
        for label, b, h, sq, skv, causal in cases:
            if label == "views":
                q, k, v, dout = projection_views(randn, b, h, sq, dh, n=4)
            else:
                q, k, v, dout = (randn(b, h, s, dh, dtype=torch.bfloat16)
                                 for s in (sq, skv, skv, sq))
            copies = [t.contiguous() for t in (q, k, v, dout)]
            _, lse, out32 = fa.flash_attention_plain(*copies[:3], causal,
                                                     return_lse=True)
            delta = fa._delta(out32, copies[3])
            args = (lse, delta, causal)
            dq, dq_delta = fa.flash_attention_dq(q, k, v, dout, lse, out32,
                                                 causal)
            got = (dq, *fa.flash_attention_dkv(q, k, v, dout, *args))
            torch.cuda.synchronize()
            ref = (fa.flash_attention_dq_plain(*copies, *args),
                   *fa.flash_attention_dkv_plain(*copies, *args))
            rel = max(_rel_err(a, r) for a, r in zip(got, ref))
            delta_err = _rel_err(dq_delta, delta)
            where = (f"K2/K3 Dh={dh} {label} (B={b} H={h} Sq={sq} Skv={skv} "
                     f"causal={causal})")
            require(all(bool(torch.isfinite(t).all())
                        for t in (*got, dq_delta)), f"{where}: non-finite")
            require(rel <= tol, f"{where}: relative error {rel:.3g} > {tol}")
            require(delta_err <= DELTA_TOL,
                    f"{where}: K2's delta off by {delta_err:.3g}")
            part = f"{label} {rel:.3g} (delta {delta_err:.2g})"
            if label == "dead rows":
                dq_dead = float(got[0][:, :, :sq - skv].abs().max())
                require(dq_dead == 0.0, f"{where}: dead rows' dq {dq_dead}")
                part += " (dead rows' dq 0)"
            if label == "views":
                same = (*fa.flash_attention_dq(*copies, lse, out32, causal),
                        *fa.flash_attention_dkv(*copies, *args))
                require(all(torch.equal(a, c) for a, c in zip(
                    (dq, dq_delta, *got[1:]), same)),
                        f"{where}: views and contiguous copies differ")
                part += " (bits of contiguous copies)"
            parts.append(part)
        print(f"K2/K3 at Dh={dh}, max relative error of dq, dk, dv (tol "
              f"{tol:g}): " + ", ".join(parts), flush=True)


def timed_training_kernels(fa, randn, entries, args, out32, errs,
                           rel) -> str:
    """Device times of K1 with the LSE, K2 and K3 at the training shape,
    beside their plain versions, their bounds and PyTorch's SDPA: its
    forward with inputs that require grad (it then keeps the LSE too) for
    K1, its backward for K2 and K3 together; and K2, K3 on the
    projection's strided views, as the train step hands them over. K2
    takes delta from the f32 output (``out32``); its plain version
    includes PyTorch's delta, which is also timed alone."""
    q, k, v, dout, lse, delta, causal, _, bq, bk = args
    b, h, sq, dh = q.shape
    skv = k.shape[2]
    shape = [b, h, sq, dh]
    t = {
        "fwd_lse": device_ms(
            lambda: fa.flash_attention_lse(q, k, v, causal, None, bq, bk)),
        "fwd_lse_plain": device_ms(
            lambda: fa.flash_attention_plain(q, k, v, causal, None, bk,
                                             return_lse=True), reps=3),
        "dq": device_ms(lambda: fa.flash_attention_dq(
            q, k, v, dout, lse, out32, causal, None, bq, bk)),
        "dq_plain": device_ms(lambda: fa.flash_attention_dq_plain(
            q, k, v, dout, lse, fa._delta(out32, dout), causal, None, bk),
            reps=3),
        "delta_torch": device_ms(lambda: fa._delta(out32, dout)),
        "dkv": device_ms(lambda: fa.flash_attention_dkv(*args)),
        "dkv_plain": device_ms(
            lambda: fa.flash_attention_dkv_plain(*args[:-2], bq), reps=3),
    }
    views = projection_views(randn, *q.shape, n=4)
    _, view_lse, view_out32 = fa.flash_attention_lse(*views[:3], causal)
    view_args = (*views, view_lse, fa._delta(view_out32, views[3]), causal)
    t["dq_views"] = device_ms(lambda: fa.flash_attention_dq(
        *views, view_lse, view_out32, causal))
    t["dkv_views"] = device_ms(lambda: fa.flash_attention_dkv(*view_args))
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    t["sdpa_fwd"] = device_ms(lambda: sdpa(qg, kg, vg, is_causal=causal))
    sdpa_out = sdpa(qg, kg, vg, is_causal=causal)
    t["sdpa_bwd"] = device_ms(lambda: torch.autograd.grad(
        sdpa_out, (qg, kg, vg), dout, retain_graph=True))
    bounds = {kind: attention_bound(kind, b, h, sq, skv, dh, causal,
                                    q.dtype)
              for kind in ("fwd_lse", "dq", "dkv")}
    fwd, bwd = "rafiki_tpu_torch/ops/csrc/flash_fwd.cu", \
        "rafiki_tpu_torch/ops/csrc/flash_bwd.cu"
    entries["flash_fwd_lse"] = _entry(
        "flash_fwd_lse", fwd, "rafiki_tpu/ops/flash_attention.py:143",
        errs["out"], TOL[q.dtype], shape, t["fwd_lse"], t["fwd_lse_plain"],
        t["sdpa_fwd"], bounds["fwd_lse"], lse_max_abs_err=errs["lse"],
        library="scaled_dot_product_attention forward, inputs requiring "
                "grad")
    # the gradients' tolerance is on max|err| / max(1, max|ref|)
    entries["flash_bwd_dq"] = _entry(
        "flash_bwd_dq", bwd, "rafiki_tpu/ops/flash_attention.py:207",
        errs["dq"], TOL[q.dtype], shape, t["dq"], t["dq_plain"],
        t["sdpa_bwd"], bounds["dq"], max_rel_err=rel["dq"],
        tolerance_on="max_rel_err", strided_ms=t["dq_views"],
        delta_max_rel_err=errs["delta"], pytorch_delta_ms=t["delta_torch"],
        library="scaled_dot_product_attention backward (dq, dk and dv "
                "together)")
    entries["flash_bwd_dkv"] = _entry(
        "flash_bwd_dkv", bwd, "rafiki_tpu/ops/flash_attention.py:239",
        max(errs["dk"], errs["dv"]), TOL[q.dtype], shape, t["dkv"],
        t["dkv_plain"], t["sdpa_bwd"], bounds["dkv"],
        max_rel_err=max(rel["dk"], rel["dv"]), tolerance_on="max_rel_err",
        strided_ms=t["dkv_views"],
        library="scaled_dot_product_attention backward (dq, dk and dv "
                "together)")
    return "\n".join(
        f"  {name}: kernel_ms {t[key]:.4f} ({rate(bounds[key], t[key])}), "
        f"plain_ms {t[key + '_plain']:.4f}, bound_ms {bounds[key][0]:.4f} "
        f"({bounds[key][1]})"
        for name, key in (("K1-LSE", "fwd_lse"), ("K2", "dq"),
                          ("K3", "dkv"))) + (
        f"\n  PyTorch's delta alone (which K2 takes itself): "
        f"{t['delta_torch']:.4f} ms"
        f"\n  on the projection's strided views: K2 {t['dq_views']:.4f} ms, "
        f"K3 {t['dkv_views']:.4f} ms"
        f"\n  library: SDPA forward (grad) {t['sdpa_fwd']:.4f} ms, SDPA "
        f"backward {t['sdpa_bwd']:.4f} ms; K2 + K3 {t['dq'] + t['dkv']:.4f}"
        f" ms")


# ---------------------------------------------------------------------------
# phase 3: the train job
# ---------------------------------------------------------------------------

KERNEL_NAMES = ("flash_fwd", "flash_fwd_lse", "flash_bwd_dq", "flash_bwd_dkv")


def _kernels():
    """The four kernel wrappers, in KERNEL_NAMES order."""
    fa = importlib.import_module("rafiki_tpu_torch.ops.flash_attention")
    return (fa.flash_attention, fa.flash_attention_lse,
            fa.flash_attention_dq, fa.flash_attention_dkv)


def make_dataset(rng: np.random.Generator, n: int, patterns: np.ndarray):
    """``n`` images of 224x224x3 in [0, 1] at 8-bit levels, as decoded
    image files are, each its class's fixed pattern plus noise: a signal
    that can be learnt."""
    y = rng.integers(0, len(patterns), n).astype(np.int32)
    x = 0.6 * patterns[y] + 0.4 * rng.random(
        (n,) + patterns.shape[1:], dtype=np.float32)
    return np.round(x * 255) / np.float32(255), y


def train_phase(card: str):
    """A 2-trial ViT-B/16 train job through ``TrainWorker`` on cuda:0.
    Returns (the store, the dataset's URIs, trial rows, the job's seconds,
    each kernel's launches in ``KERNEL_NAMES`` order)."""
    from rafiki_tpu_torch import convert
    from rafiki_tpu_torch.constants import TrialStatus
    from rafiki_tpu_torch.models import vit
    from rafiki_tpu_torch.sdk.artifact import read_artifact
    from rafiki_tpu_torch.sdk.dataset import write_numpy_dataset
    from rafiki_tpu_torch.sdk.log import LogType
    from rafiki_tpu_torch.sdk.params import flatten, load_params

    WORK.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(SEED + 20)
    t0 = time.perf_counter()
    patterns = rng.random((CLASSES, 224, 224, 3), dtype=np.float32)
    uris = {}
    for split, n in (("train", TRAIN_IMAGES), ("test", TEST_IMAGES)):
        x, y = make_dataset(rng, n, patterns)
        uris[split] = write_numpy_dataset(x, y, str(WORK / f"{split}.npz"))
    print(f"train: dataset of {TRAIN_IMAGES} + {TEST_IMAGES} images "
          f"(224x224x3, {CLASSES} classes) made and written as .npz in "
          f"{time.perf_counter() - t0:.1f} s "
          f"({sum(Path(u).stat().st_size for u in uris.values()) / 1e6:.0f}"
          f" MB)", flush=True)

    # ---- the main path's run: counts from zero (inside) ----
    db, trials, job_s, counts = direct_train_job(uris, WORK / "params")
    # ---------------------------------------------------------------

    require(len(trials) == TRIALS, f"{len(trials)} trials, not {TRIALS}")
    cfg = vit.vit_b16()
    init = flatten(vit.init(np.random.default_rng(0), cfg))
    steps = 0
    for t in trials:
        require(t["status"] == TrialStatus.COMPLETED,
                f"trial {t['id']} {t['status']}: {t['fault_detail']}")
        require(np.isfinite(t["score"]), f"trial score {t['score']}")
        records = [json.loads(line) for line in db.get_trial_logs(t["id"])]
        epochs = [r["metrics"] for r in records
                  if r["type"] == LogType.METRICS and "loss" in r["metrics"]]
        require(epochs and all(np.isfinite(m["loss"]) for m in epochs),
                f"trial {t['id']} losses {epochs}")
        trained = flatten(load_params(read_artifact(t["params_file_path"])))
        still = [k for k in init if np.array_equal(init[k], trained[k])]
        require(not still, f"trial {t['id']}: {still} did not move")
        moved = max(float(np.abs(trained[k] - init[k]).max()) for k in init)
        batch = t["knobs"]["batch_size"]
        steps += (TRAIN_IMAGES // batch) * t["knobs"]["epochs"]
        print(f"train: trial {t['id'][:8]} COMPLETED: learning_rate "
              f"{t['knobs']['learning_rate']:.3g}, batch_size {batch}, "
              f"epoch loss {epochs[-1]['loss']:.4f} in "
              f"{epochs[-1]['epoch_time']:.2f} s, test accuracy "
              f"{t['score']:.4f}; every one of {len(init)} parameter "
              f"arrays moved (max |change| {moved:.3g})", flush=True)
    expect = [DEPTH * TRIALS, DEPTH * steps, DEPTH * steps, DEPTH * steps]
    print(f"train: job of {TRIALS} trials in {job_s:.1f} s; {steps} train "
          f"steps, {TRIALS} evaluate forwards; launches K1 {counts[0]}, "
          f"K1-LSE {counts[1]}, K2 {counts[2]}, K3 {counts[3]} (expected "
          f"{expect})", flush=True)
    require(counts == expect, f"launches {counts}, expected {expect}")
    train_step_checks(card, cfg, convert, uris["train"])
    return db, uris, trials, job_s, counts


def direct_train_job(uris: dict, params_dir: Path):
    """A ``TRIALS``-trial ViT-B/16 train job through ``TrainWorker`` on
    cuda:0, its rows in an in-memory ``Database``. Returns (the store, the
    trial rows, the job's seconds, each kernel's launches in the job, in
    ``KERNEL_NAMES`` order); the counts start from zero here."""
    from rafiki_tpu_torch.advisor.advisor import AdvisorStore
    from rafiki_tpu_torch.db.database import Database
    from rafiki_tpu_torch.device import ServiceContext
    from rafiki_tpu_torch.worker.train import TrainWorker

    db, advisors = Database(":memory:"), AdvisorStore()
    user = db.create_user("smoke@rafiki", "-", "MODEL_DEVELOPER")
    model = db.create_model(user["id"], "vit", "IMAGE_CLASSIFICATION",
                            TEMPLATE.read_bytes(), "TorchViT", {}, "PRIVATE")
    job = db.create_train_job(user["id"], "vit", 1, "IMAGE_CLASSIFICATION",
                              uris["train"], uris["test"],
                              {"MODEL_TRIAL_COUNT": TRIALS})
    sub = db.create_sub_train_job(job["id"], model["id"])
    ctx = ServiceContext("train-worker-0", chips=[0])
    worker = TrainWorker(sub["id"], db, advisors, params_dir=str(params_dir))
    kernels = _kernels()
    for kernel in kernels:
        kernel.launches = 0
    t0 = time.perf_counter()
    worker.start(ctx)
    torch.cuda.synchronize()
    job_s = time.perf_counter() - t0
    return (db, db.get_trials_of_sub_train_job(sub["id"]), job_s,
            [kernel.launches for kernel in kernels])


def train_step_checks(card, cfg, convert, train_uri):
    """One train step through the kernels against one through plain
    attention, from the same weights and batch; then the step's time and a
    kernel profile."""
    from rafiki_tpu_torch.models import vit
    from rafiki_tpu_torch.sdk.dataset import dataset_utils
    from rafiki_tpu_torch.sdk.torch_backend import (
        DataParallelTrainer,
        softmax_classifier_loss,
        tunable_optimizer,
    )

    x, y = dataset_utils.load_image_arrays(train_uri)
    tree = vit.init(np.random.default_rng(0), cfg)
    plain_cfg = dataclasses.replace(
        cfg, encoder=dataclasses.replace(cfg.encoder, use_flash=False))
    loss_fn = softmax_classifier_loss(lambda m, xb: m(xb))
    batch = (torch.from_numpy(x[:64]).cuda(), torch.from_numpy(y[:64]).cuda())
    grads = {}
    for name, c in (("kernel", cfg), ("plain", plain_cfg)):
        model = convert.from_jax_params(tree, c, "cuda:0", train=True)
        loss, _ = loss_fn(model, batch)
        loss.backward()
        grads[name] = (float(loss.detach()), {k: p.grad.double() for k, p in
                                     model.named_parameters()})
        del model
    (loss_k, g_k), (loss_p, g_p) = grads["kernel"], grads["plain"]
    rel = {k: float((g_k[k] - g_p[k]).norm() / g_p[k].norm().clamp_min(
        1e-30)) for k in g_p}
    by_leaf = {}
    for k, e in rel.items():  # the worst layer of each leaf
        leaf = re.sub(r"^blocks\.\d+\.", "blocks.*.", k)
        by_leaf[leaf] = max(by_leaf.get(leaf, 0.0), e)
    print(f"train: one step at batch 64, kernels vs plain attention: loss "
          f"{loss_k:.6f} vs {loss_p:.6f} (|diff| {abs(loss_k - loss_p):.3g}, "
          f"tol {LOSS_ATOL:g}); gradient relative L2 error per leaf (worst "
          f"layer; tol {GRAD_RTOL:g}, {QK_GRAD_RTOL:g} for "
          f"{'/'.join(QK_LEAVES)}): "
          + ", ".join(f"{k} {e:.2e}" for k, e in sorted(by_leaf.items())),
          flush=True)
    require(abs(loss_k - loss_p) <= LOSS_ATOL, "train step loss differs")
    for k, e in rel.items():
        tol = QK_GRAD_RTOL if k.endswith(QK_LEAVES) else GRAD_RTOL
        require(e <= tol, f"gradient of {k} off by {e:.3g} (tol {tol:g})")

    trainer = DataParallelTrainer(
        loss_fn, tunable_optimizer(torch.optim.AdamW, lr=1e-4,
                                   weight_decay=1e-4))
    model, opt = trainer.init(lambda rng: convert.from_jax_params(
        tree, cfg, "cuda:0", train=True))
    for n in (64, 128):
        batch = (torch.from_numpy(x[:n]).cuda(),
                 torch.from_numpy(y[:n]).cuda())
        step = lambda: trainer.train_step(model, opt, batch)  # noqa: E731
        call_ms = median_ms(step, reps=10)
        card_ms = device_ms(step, reps=3, inner=3, hold_cycles=400_000_000)
        print(f"train: step at batch {n}: {call_ms:.2f} ms per call, "
              f"{card_ms:.2f} ms on the card; {n / call_ms * 1e3:.1f} "
              f"images/s per call ({n / card_ms * 1e3:.1f} on the card); "
              f"card {card}", flush=True)
        if n == 64:
            print_device_profile(step, "batch-64 train step", shares=(
                ("K1-LSE", "flash_fwd_wgmma_kernel"),
                ("K2", "flash_bwd_dq_wgmma_kernel"),
                ("K3", "flash_bwd_dkv_wgmma_kernel"),
                ("copies and casts", "copy_kernel")))
    del model, opt


# ---------------------------------------------------------------------------
# phase 4: serving the trained trials
# ---------------------------------------------------------------------------

NPY = "application/x-npy"


def request_body(kind: str, images: np.ndarray):
    """(body, headers) of a ``POST /predict`` carrying ``images``: an
    ``.npy`` body asking for an ``.npy`` answer, or a JSON body."""
    if kind == "npy":
        buf = io.BytesIO()
        np.save(buf, images, allow_pickle=False)
        return buf.getvalue(), {"Content-Type": NPY, "Accept": NPY}
    return (json.dumps({"queries": images.tolist()}).encode(),
            {"Content-Type": "application/json"})


def post(url: str, body: bytes, headers: dict,
         token: str = None) -> np.ndarray:
    if token is not None:
        headers = {**headers, "Authorization": f"Bearer {token}"}
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers=headers)
    with urllib.request.urlopen(req, timeout=120) as resp:
        require(resp.status == 200, f"POST /predict answered {resp.status}")
        data = resp.read()
        if resp.headers["Content-Type"] == NPY:
            return np.load(io.BytesIO(data), allow_pickle=False)
        return np.asarray(json.loads(data)["data"]["predictions"])


#: the JSON requests both doors are timed on in turns (phase 5)
JSON_TIMED = [("json", 1)] * 10 + [("json", 8)] * 10


def p50_ms(lat: dict) -> dict:
    """{(kind, n): median ms} of {(kind, n): [seconds]}."""
    return {k: statistics.median(v) * 1e3 for k, v in lat.items()}


def serve_phase(card: str, kernel_ms: dict, db, trials):
    """The trained trials behind ``POST /predict``; returns each kernel's
    launches on the main path, in ``KERNEL_NAMES`` order."""
    from rafiki_tpu_torch import config, convert
    from rafiki_tpu_torch.cache.queue import InProcessBroker
    from rafiki_tpu_torch.device import ServiceContext
    from rafiki_tpu_torch.models import vit
    from rafiki_tpu_torch.ops.flash_attention import flash_attention
    from rafiki_tpu_torch.predictor.predictor import Predictor
    from rafiki_tpu_torch.predictor.server import PredictorServer
    from rafiki_tpu_torch.sdk.artifact import read_artifact
    from rafiki_tpu_torch.sdk.params import load_params
    from rafiki_tpu_torch.sdk.torch_backend import DataParallelTrainer
    from rafiki_tpu_torch.worker.inference import InferenceWorker

    cfg = vit.vit_b16()
    trees = {t["id"]: load_params(read_artifact(t["params_file_path"]))
             for t in trials}
    print(f"serve: the {len(trees)} trained ViT-B/16 trials (224/16, 1000 "
          f"classes, {_count(next(iter(trees.values()))) / 1e6:.1f} M "
          f"params each), scores "
          f"{[round(t['score'], 4) for t in trials]}", flush=True)

    broker = InProcessBroker()
    job = "vit-b16-job"
    workers = {}
    launches_before_warm = flash_attention.launches
    t0 = time.perf_counter()
    for i, tid in enumerate(trees):
        ready, errors = threading.Event(), []
        ctx = ServiceContext(service_id=f"worker-{i}", chips=[0],
                             on_ready=ready.set)

        def run(w=InferenceWorker(job, tid, db, broker), c=ctx, e=errors):
            try:
                w.start(c)
            except BaseException as exc:  # reported by the main thread
                e.append(exc)
                raise

        thread = threading.Thread(target=run, name=ctx.service_id,
                                  daemon=True)
        thread.start()
        workers[ctx.service_id] = (tid, ctx, thread, ready, errors)
    predictor = Predictor(job, broker, "IMAGE_CLASSIFICATION",
                          {wid: w[0] for wid, w in workers.items()})
    server = None
    try:
        for wid, (_, _, thread, ready, errors) in workers.items():
            while not ready.wait(0.5):
                require(thread.is_alive(), f"{wid} died before ready: "
                        f"{errors[0] if errors else 'unknown'}")
                require(time.perf_counter() - t0 < 600,
                        f"{wid} not ready after 600 s")
        cap = config.PREDICT_MAX_BATCH_SIZE
        buckets = DataParallelTrainer(device="cpu").predict_buckets(cap)
        warm_launches = flash_attention.launches - launches_before_warm
        print(f"serve: 2 workers ready in {time.perf_counter() - t0:.1f} s; "
              f"warm-up ran buckets {buckets} per worker "
              f"({warm_launches} K1 launches)", flush=True)
        require(warm_launches == DEPTH * len(buckets) * len(workers),
                f"warm-up made {warm_launches} K1 launches")
        server = PredictorServer(predictor, app="vit").start()
        url = f"http://127.0.0.1:{server.port}/predict"

        rng = np.random.default_rng(SEED + 10)
        images = rng.standard_normal((cap, 224, 224, 3)).astype(np.float32)
        checked = [("json", 1), ("npy", 3), ("npy", 8), ("npy", cap)]
        timed = [("npy", 1)] * 8 + [("npy", cap)] * 8

        # request bodies are encoded before the clock starts: that is the
        # client's work, not the server's
        bodies = {(kind, n): request_body(kind, images[:n])
                  for kind, n in checked + timed}

        # ---- the main path's run: counts from zero ----
        kernels = _kernels()
        for kernel in kernels:
            kernel.launches = 0
        answers, lat = [], {}
        for kind, n in checked + timed:
            t = time.perf_counter()
            probs = post(url, *bodies[kind, n])
            dt = time.perf_counter() - t
            if len(answers) < len(checked):
                answers.append((kind, n, probs, dt))
            else:
                lat.setdefault((kind, n), []).append(dt)
        launches = [kernel.launches for kernel in kernels]
        # ---------------------------------------------------------------
        chunks = sum(-(-n // cap) for _, n in checked + timed)
        forwards = chunks * len(workers)
        expect = [DEPTH * forwards, 0, 0, 0]
        print(f"serve: {len(checked) + len(timed)} POST /predict requests, "
              f"{forwards} bucketed forwards; launches K1 {launches[0]}, "
              f"K1-LSE {launches[1]}, K2 {launches[2]}, K3 {launches[3]} "
              f"(expected {expect})", flush=True)
        require(launches == expect,
                f"serving launches {launches}, expected {expect}")

        # reference: the two models' forward through plain attention
        plain_cfg = dataclasses.replace(
            cfg, encoder=dataclasses.replace(cfg.encoder, use_flash=False))
        refs = []
        with torch.inference_mode():
            x = torch.from_numpy(images).cuda()
            for tree in trees.values():
                model = convert.from_jax_params(tree, plain_cfg, "cuda:0")
                refs.append(torch.softmax(model(x), -1).double().cpu().numpy())
                del model
        ref = (refs[0] + refs[1]) / 2
        for kind, n, probs, dt in answers:
            require(probs.shape == (n, cfg.num_classes),
                    f"{kind} {n}: shape {probs.shape}")
            require(bool(np.isfinite(probs).all()), f"{kind} {n}: non-finite")
            sums = np.abs(probs.sum(-1) - 1).max()
            require(sums < 1e-4, f"{kind} {n}: rows sum off by {sums}")
            held = prob_check(f"{kind} {n}", probs, ref[:n])
            print(f"serve: {kind} request of {n}: shape {probs.shape}, rows "
                  f"sum to 1 within {sums:.2g}, {held}, {dt * 1e3:.1f} ms",
                  flush=True)
        p50 = p50_ms(lat)
        big = lat["npy", cap]
        print(f"serve: p50 latency {p50['npy', 1]:.2f} ms (1 image), "
              f"{p50['npy', cap]:.2f} ms ({cap} images, npy); "
              f"{cap * len(big) / sum(big):.1f} images/s at "
              f"{cap} per request, sequential; two trials ensembled; card "
              f"{card}", flush=True)

        # where a request's time goes: one trial's forward through the
        # served (kernel) path at each timed bucket; these launches come
        # after the main path's count was read
        model = convert.from_jax_params(next(iter(trees.values())), cfg,
                                        "cuda:0")
        with torch.inference_mode():
            for n, bucket in ((1, 8), (cap, cap)):
                x = torch.from_numpy(images[:bucket]).cuda()
                call_ms = median_ms(lambda: model(x), reps=10)
                card_ms = device_ms(lambda: model(x), reps=3, inner=3,
                                    hold_cycles=400_000_000)
                attn_ms = DEPTH * kernel_ms.get(bucket, float("nan"))
                print(f"serve: {n}-image request (bucket {bucket}): p50 "
                      f"{p50['npy', n]:.2f} ms; one trial's forward "
                      f"{call_ms:.3f} ms per call, {card_ms:.3f} ms of it "
                      f"on the card, of which K1 {attn_ms:.3f} ms ({DEPTH} "
                      f"x kernel_ms); the request less 2 forwards "
                      f"{p50['npy', n] - 2 * call_ms:.2f} ms (host and "
                      f"transport)", flush=True)
            shares = (("K1", "flash_fwd_wgmma_kernel"),
                      ("copies and casts", "copy_kernel"))
            print_device_profile(lambda: model(x), f"bucket-{cap} forward",
                                 shares=shares)
            copied_ms = forward_with_copies(model, x, cap, shares)
            print(f"serve: bucket-{cap} forward on the card: {card_ms:.3f} ms "
                  f"with K1 reading the projection's views, {copied_ms:.3f} "
                  f"ms with q, k, v made contiguous before K1 (as before "
                  f"it read views); card {card}", flush=True)
        del model
        return launches
    finally:
        if server is not None:
            server.stop()
        for wid, (_, ctx, thread, _, _) in workers.items():
            ctx.stop_event.set()
            broker.unregister_worker(job, wid)
        for wid, (_, _, thread, _, _) in workers.items():
            thread.join(timeout=30)
            require(not thread.is_alive(), f"{wid} did not stop")


def forward_with_copies(model, x, cap, shares) -> float:
    """The bucket forward's device time and profile with q, k, v copied to
    contiguous tensors before K1, the serving path before K1 read views:
    the same model and input, one call apart."""
    attention = importlib.import_module("rafiki_tpu_torch.ops.attention")
    real = attention.flash_attention

    def copied(q, k, v, **kw):
        return real(q.contiguous(), k.contiguous(), v.contiguous(), **kw)

    attention.flash_attention = copied
    try:
        ms = device_ms(lambda: model(x), reps=3, inner=3,
                       hold_cycles=400_000_000)
        print_device_profile(lambda: model(x), f"bucket-{cap} forward, q/k/v "
                             "copied before K1", shares=shares)
    finally:
        attention.flash_attention = real
    return ms


# ---------------------------------------------------------------------------
# phase 5: the cycle through Client -> AdminServer -> Admin
# ---------------------------------------------------------------------------

def stack_phase(card: str, uris: dict, direct_job_s: float):
    """A 2-trial train job and an inference job of its trials through the
    port's Client and admin; returns each kernel's launches on this path
    (the train job's and the inference job's together)."""
    from rafiki_tpu_torch import config, convert
    from rafiki_tpu_torch.admin.admin import Admin
    from rafiki_tpu_torch.admin.http import AdminServer
    from rafiki_tpu_torch.client.client import Client
    from rafiki_tpu_torch.db.database import Database
    from rafiki_tpu_torch.models import vit
    from rafiki_tpu_torch.predictor.server import PredictorServer
    from rafiki_tpu_torch.sdk.params import load_params
    from rafiki_tpu_torch.sdk.torch_backend import DataParallelTrainer

    store = WORK / "stack.sqlite3"
    for path in WORK.glob("stack.sqlite3*"):
        path.unlink()
    admin = Admin(db=Database(str(store)),
                  params_dir=str(WORK / "stack_params"))
    server = AdminServer(admin).start()
    direct = None
    kernels = _kernels()
    try:
        c = Client("127.0.0.1", server.port, timeout_s=900)
        c.login(config.SUPERADMIN_EMAIL, config.SUPERADMIN_PASSWORD)
        model = c.create_model("vit-b16", "IMAGE_CLASSIFICATION",
                               TEMPLATE.read_bytes(), "TorchViT")
        require(model["verification"] is not None
                and model["verification"]["ok"],
                f"TorchViT upload not verified: {model['verification']}")
        print(f"stack: admin on 127.0.0.1:{server.port} (store {store.name}),"
              f" TorchViT uploaded and verified "
              f"({os.environ.get('RAFIKI_VERIFY_TEMPLATES', 'enforce')}), "
              f"{len(model['verification']['findings'])} findings",
              flush=True)

        # ---- the main path's run (train job): counts from zero ----
        for kernel in kernels:
            kernel.launches = 0
        t0 = time.perf_counter()
        c.create_train_job("vit", "IMAGE_CLASSIFICATION", uris["train"],
                           uris["test"], budget={"MODEL_TRIAL_COUNT": TRIALS,
                                                 "CHIP_COUNT": 1})
        job = c.wait_until_train_job_stopped("vit", timeout_s=900,
                                             poll_s=0.05)
        torch.cuda.synchronize()
        job_s = time.perf_counter() - t0
        train_counts = [k.launches for k in kernels]
        # ---------------------------------------------------------------
        require(job["status"] == "STOPPED", f"train job {job['status']}: "
                f"{job.get('error_reason')}")
        grants = [w["chips"] for w in job["workers"]]
        require(grants == [[0]], f"train services granted {grants}")
        trials = c.get_trials_of_train_job("vit")
        require([t["status"] for t in trials] == ["COMPLETED"] * TRIALS,
                f"trials {[(t['status'], t['fault_detail']) for t in trials]}")
        steps = 0
        for t in trials:
            require(np.isfinite(t["score"]), f"trial score {t['score']}")
            epochs = [m for m in c.get_trial_logs(t["id"])["metrics"]
                      if "epoch_time" in m]
            batch = t["knobs"]["batch_size"]
            steps += (TRAIN_IMAGES // batch) * t["knobs"]["epochs"]
            wall = t["datetime_stopped"] - t["datetime_started"]
            fit = sum(m["epoch_time"] for m in epochs)
            print(f"stack: trial {t['id'][:8]} COMPLETED: batch_size {batch},"
                  f" test accuracy {t['score']:.4f}; {wall:.2f} s in the "
                  f"trial, {fit:.2f} s of it in epochs, set-up and the rest "
                  f"{wall - fit:.2f} s", flush=True)
        expect = [DEPTH * TRIALS] + [DEPTH * steps] * 3
        print(f"stack: train job of {TRIALS} trials STOPPED in {job_s:.1f} s "
              f"through the admin (Client.create_train_job to STOPPED), "
              f"{direct_job_s:.1f} s for phase 3's direct job (TrainWorker "
              f"alone, the first job of the process), granted {grants}; "
              f"{steps} steps; launches K1 "
              f"{train_counts[0]}, K1-LSE {train_counts[1]}, K2 "
              f"{train_counts[2]}, K3 {train_counts[3]} (expected {expect}); "
              f"card {card}", flush=True)
        require(train_counts == expect,
                f"launches {train_counts}, expected {expect}")

        t0 = time.perf_counter()
        raw = admin.get_trial_params(trials[0]["id"])
        read_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        trees, nbytes = [], 0
        for t in trials:
            data = c.download_trial_params(t["id"])
            nbytes += len(data)
            trees.append(load_params(data))
        dl_s = time.perf_counter() - t0
        print(f"stack: Client.download_trial_params of {TRIALS} trials: "
              f"{nbytes / 1e6:.1f} MB of artifacts in {dl_s:.2f} s "
              f"({nbytes / 1e6 / dl_s:.0f} MB/s; base64 inside JSON on the "
              f"wire, {nbytes * 4 / 3 / 1e6:.1f} MB); of one trial's "
              f"{dl_s / TRIALS:.2f} s, the verified read of its "
              f"{len(raw) / 1e6:.1f} MB artifact (Admin.get_trial_params) "
              f"takes {read_s:.2f} s", flush=True)
        del raw

        cap = config.PREDICT_MAX_BATCH_SIZE
        buckets = DataParallelTrainer(device="cpu").predict_buckets(cap)
        rng = np.random.default_rng(SEED + 10)
        images = rng.standard_normal((8, 224, 224, 3)).astype(np.float32)
        bodies = {(kind, n): request_body(kind, images[:n])
                  for kind, n in JSON_TIMED}
        token = admin.authenticate_user(config.SUPERADMIN_EMAIL,
                                        config.SUPERADMIN_PASSWORD)["token"]

        # ---- the main path's run (inference job): counts from zero ----
        for kernel in kernels:
            kernel.launches = 0
        t0 = time.perf_counter()
        inf = c.create_inference_job("vit")
        deploy_s = time.perf_counter() - t0
        warm = kernels[0].launches
        answers = [(n, np.asarray(c.predict("vit", images[:n].tolist())))
                   for n in (1, 8)]
        # the admin door and a PredictorServer on the job's own Predictor
        # (phase 4's direct door) take each body in turns, the first door
        # alternating, so both see the same process, job and card
        predictor = admin.services.get_predictor(inf["id"])
        require(predictor is not None, "no Predictor for the inference job")
        direct = PredictorServer(predictor, app="vit").start()
        doors = {"admin": (f"http://127.0.0.1:{server.port}/predict/vit",
                           token),
                 "direct": (f"http://127.0.0.1:{direct.port}/predict", None)}
        lat = {door: {} for door in doors}
        for i, (kind, n) in enumerate(JSON_TIMED):
            for door in sorted(doors, reverse=bool(i % 2)):
                url, auth = doors[door]
                t = time.perf_counter()
                post(url, *bodies[kind, n], token=auth)
                lat[door].setdefault((kind, n), []).append(
                    time.perf_counter() - t)
        serve_counts = [k.launches for k in kernels]
        # ---------------------------------------------------------------
        stats = c.get_inference_job_stats("vit")
        c.stop_inference_job("vit")
        workers = inf["workers"]
        require(inf["status"] == "RUNNING" and len(workers) == TRIALS,
                f"inference job {inf['status']} with {len(workers)} workers")
        require([w["chips"] for w in workers] == [[0]] * TRIALS,
                f"serving grants {[w['chips'] for w in workers]}")
        forwards = TRIALS * (len(buckets) + 2
                             + len(doors) * len(JSON_TIMED))
        print(f"stack: inference job RUNNING in {deploy_s:.1f} s "
              f"(deploy and warm-up of {TRIALS} workers, grants "
              f"{[w['chips'] for w in workers]}); {warm} K1 launches in "
              f"warm-up; {serve_counts[0]} K1 launches for {forwards} "
              f"bucketed forwards (expected {DEPTH * forwards}); serving "
              f"stats: {stats['batches']} batches, {stats['queries']} "
              f"queries", flush=True)
        require(serve_counts == [DEPTH * forwards, 0, 0, 0],
                f"serving launches {serve_counts}")

        cfg = vit.vit_b16()
        plain_cfg = dataclasses.replace(
            cfg, encoder=dataclasses.replace(cfg.encoder, use_flash=False))
        refs = []
        with torch.inference_mode():
            x = torch.from_numpy(images).cuda()
            for tree in trees:
                m = convert.from_jax_params(tree, plain_cfg, "cuda:0")
                refs.append(torch.softmax(m(x), -1).double().cpu().numpy())
                del m
        ref = sum(refs) / len(refs)
        for n, probs in answers:
            require(probs.shape == (n, cfg.num_classes),
                    f"/predict/vit {n}: shape {probs.shape}")
            require(bool(np.isfinite(probs).all()),
                    f"/predict/vit {n}: non-finite")
            held = prob_check(f"/predict/vit {n}", probs, ref[:n])
            print(f"stack: Client.predict of {n} (JSON) on /predict/vit: "
                  f"shape {probs.shape}, {held}; against the plain-attention "
                  f"ensemble of the downloaded trials", flush=True)
        p50 = {door: p50_ms(v) for door, v in lat.items()}
        print("stack: p50 of the same JSON bodies in turns, /predict/vit on "
              "the admin door vs POST /predict on a PredictorServer over "
              "the job's Predictor: "
              + ", ".join(f"{n} image{'s' if n > 1 else ''} "
                          f"{p50['admin']['json', n]:.2f} vs "
                          f"{p50['direct']['json', n]:.2f} ms"
                          for n in (1, 8))
              + f" ({len(JSON_TIMED) // 2} requests each a door, "
              f"sequential); card {card}", flush=True)
    finally:
        if direct is not None:
            direct.stop()
        server.stop()
        admin.shutdown()
    admin_process(card)
    return [a + b for a, b in zip(train_counts, serve_counts)], job_s


def admin_process(card: str) -> None:
    """``python -m rafiki_tpu_torch.admin`` on port 0: its banner, ``GET /``,
    a login, then SIGTERM and exit code 0."""
    from rafiki_tpu_torch import config
    from rafiki_tpu_torch.client.client import Client

    workdir = WORK / "admin_process"
    workdir.mkdir(parents=True, exist_ok=True)
    for path in workdir.glob("rafiki_torch.sqlite3*"):
        path.unlink()
    env = {**os.environ, "RAFIKI_WORKDIR": str(workdir),
           "RAFIKI_ADMIN_PORT": "0", "PYTHONPATH": str(REPO)}
    log = workdir / "admin.log"
    t0 = time.perf_counter()
    with open(log, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "rafiki_tpu_torch.admin"], cwd=REPO,
            env=env, stdout=subprocess.PIPE, stderr=err, text=True)
    try:
        # the banner, read off-thread so a hung boot cannot hang the smoke
        lines = []
        reader = threading.Thread(
            target=lambda: lines.append(proc.stdout.readline()), daemon=True)
        reader.start()
        reader.join(timeout=120)
        banner = lines[0].strip() if lines else ""
        m = re.search(r"admin on http://([\d.]+):(\d+)", banner)
        require(m is not None, f"no banner from the admin process in "
                f"{time.perf_counter() - t0:.0f} s: {banner!r}; "
                f"{log.read_text()[-2000:]}")
        boot_s = time.perf_counter() - t0
        with urllib.request.urlopen(f"http://{m.group(1)}:{m.group(2)}/",
                                    timeout=30) as resp:
            root = json.loads(resp.read())["data"]
        require(root["status"] == "ok", f"GET / answered {root}")
        user = Client(m.group(1), int(m.group(2)), timeout_s=30).login(
            config.SUPERADMIN_EMAIL, config.SUPERADMIN_PASSWORD)
        require(user["user_type"] == "SUPERADMIN", f"login gave {user}")
        proc.send_signal(signal.SIGTERM)
        code = proc.wait(timeout=60)
        require(code == 0, f"admin process exited {code}: "
                f"{log.read_text()[-2000:]}")
        print(f"stack: python -m rafiki_tpu_torch.admin: {banner!r} after "
              f"{boot_s:.1f} s; GET / {root['status']}; login as "
              f"{user['user_type']}; exit {code} on SIGTERM; card {card}",
              flush=True)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


# ---------------------------------------------------------------------------
# phase 6: process placement
# ---------------------------------------------------------------------------

IMAGE_BYTES_JSON = 224 * 224 * 3 * 8  # a JSON image crosses the ring as f64
RING_SEGMENTS = 3  # a query ring per serving child, one response ring


def choose_ring() -> tuple:
    """(ring bytes, the request sizes whose frame fits it): the largest of
    16, 8, 4, 2 MiB whose segments take at most 80% of /dev/shm's free
    space, after printing ``df -B1 /dev/shm``."""
    import shutil

    df = subprocess.run(["df", "-B1", "/dev/shm"], capture_output=True,
                        text=True, check=True).stdout.strip()
    print("process: df -B1 /dev/shm:\n  " + df.replace("\n", "\n  "),
          flush=True)
    free = shutil.disk_usage("/dev/shm").free
    ring = next((mib << 20 for mib in (16, 8, 4, 2)
                 if RING_SEGMENTS * (mib << 20) <= 0.8 * free), 0)
    sizes = [n for n in (1, 8) if n * IMAGE_BYTES_JSON + 4096 <= ring]
    require(1 in sizes, f"/dev/shm has {free} bytes free: no ring of 2 MiB "
            f"or more fits {RING_SEGMENTS} segments")
    return ring, sizes


def child_records(logs: Path, kind: str) -> dict:
    """{service id: [JSON of each ``kind`` line]} from the children's logs
    (a restarted child appends a line)."""
    out = {}
    for path in logs.glob("service-*.log"):
        out[path.stem[len("service-"):]] = [
            json.loads(m.group(2)) | {"pid": int(m.group(1))}
            for m in re.finditer(kind + r" \(pid (\d+)\): (\{.*\})",
                                 path.read_text())]
    return out


def train_timeline(c, trials: list, t0: float, job_s: float,
                   started: dict) -> None:
    """Where the process-placed train job's wall time went, on the wall
    clock (the child's stamps and the trial rows are ``time.time()``):
    create to the child's start, the child's start-up, then each trial's
    set-up and epochs, and the tail to STOPPED."""
    trials = sorted(trials, key=lambda t: t["datetime_started"])
    parts = [("create to child start", started["t_start"] - t0),
             ("child start to RUNNING",
              started["t_ready"] - started["t_start"]),
             ("RUNNING to the first trial",
              trials[0]["datetime_started"] - started["t_ready"])]
    for i, t in enumerate(trials):
        if i:
            parts.append((f"between trials {i} and {i + 1}",
                          t["datetime_started"]
                          - trials[i - 1]["datetime_stopped"]))
        wall = t["datetime_stopped"] - t["datetime_started"]
        fit = sum(m["epoch_time"] for m in c.get_trial_logs(t["id"])[
            "metrics"] if "epoch_time" in m)
        parts += [(f"trial {i + 1} set-up and evaluate", wall - fit),
                  (f"trial {i + 1} epochs", fit)]
    parts.append(("last trial to STOPPED seen",
                  t0 + job_s - trials[-1]["datetime_stopped"]))
    print("process: the train job's time: " + ", ".join(
        f"{label} {sec:.2f} s" for label, sec in parts), flush=True)


def thread_twin(uris: dict, trials: list, store: Path):
    """An admin over thread placement (cuda:0, in-process broker) whose
    store holds the same model and the same two trials (their artifacts),
    with an inference job of them RUNNING; (admin, door, token)."""
    from rafiki_tpu_torch import config
    from rafiki_tpu_torch.admin.admin import Admin
    from rafiki_tpu_torch.admin.http import AdminServer
    from rafiki_tpu_torch.db.database import Database
    from rafiki_tpu_torch.placement.manager import LocalPlacementManager

    for path in store.parent.glob(store.name + "*"):
        path.unlink()
    db = Database(str(store))
    admin = Admin(db=db, placement=LocalPlacementManager(),
                  params_dir=str(WORK / "process_params"))
    auth = admin.authenticate_user(config.SUPERADMIN_EMAIL,
                                   config.SUPERADMIN_PASSWORD)
    model = db.create_model(auth["user_id"], "vit-b16",
                            "IMAGE_CLASSIFICATION", TEMPLATE.read_bytes(),
                            "TorchViT", {}, "PRIVATE")
    job = db.create_train_job(auth["user_id"], "vit", 1,
                              "IMAGE_CLASSIFICATION", uris["train"],
                              uris["test"], {"MODEL_TRIAL_COUNT": TRIALS})
    sub = db.create_sub_train_job(job["id"], model["id"])
    for t in trials:
        row = db.create_trial(sub["id"], model["id"], t["knobs"])
        db.mark_trial_as_complete(row["id"], t["score"],
                                  t["params_file_path"])
    db.mark_train_job_as_stopped(job["id"])
    admin.create_inference_job(auth["user_id"], "vit")
    return admin, AdminServer(admin).start(), auth["token"]


def process_phase(card: str, uris: dict, thread_job_s: float):
    """The cycle of phase 5 with every worker a child process
    (``RAFIKI_PLACEMENT=process``): a 2-trial train job in a train child
    whose advisor is the admin's (REST), then the two trials served by two
    children over the shm rings, timed in turns against a thread-placed
    inference job of the same trials. Returns each kernel's launches in
    the children, from their exit lines, in ``KERNEL_NAMES`` order."""
    from rafiki_tpu_torch import config, convert
    from rafiki_tpu_torch.admin.admin import Admin
    from rafiki_tpu_torch.admin.http import AdminServer
    from rafiki_tpu_torch.client.client import Client
    from rafiki_tpu_torch.db.database import Database
    from rafiki_tpu_torch.models import vit
    from rafiki_tpu_torch.placement.process import ProcessPlacementManager
    from rafiki_tpu_torch.sdk.artifact import read_artifact
    from rafiki_tpu_torch.sdk.params import load_params
    from rafiki_tpu_torch.sdk.torch_backend import DataParallelTrainer

    ring, sizes = choose_ring()
    logs = WORK / "process_logs"
    store = WORK / "process.sqlite3"
    for path in [*logs.glob("*"), *WORK.glob("process*.sqlite3*")]:
        path.unlink()
    settings = {"RAFIKI_PLACEMENT": "process", "RAFIKI_LOGS_DIR": str(logs),
                "RAFIKI_SHM_RING_BYTES": str(ring)}
    saved = {k: os.environ.get(k) for k in settings}
    os.environ.update(settings)
    print(f"process: RAFIKI_SHM_RING_BYTES={ring} ({ring >> 20} MiB; "
          f"{RING_SEGMENTS} rings); JSON requests of {sizes} images fit "
          f"(a 224x224x3 JSON image is {IMAGE_BYTES_JSON} bytes of f64 in "
          f"the frame)", flush=True)
    kernels = _kernels()
    admin = Admin(db=Database(str(store)),
                  params_dir=str(WORK / "process_params"))
    server = twin = twin_server = None
    try:
        require(isinstance(admin.placement, ProcessPlacementManager),
                f"placement {type(admin.placement).__name__}")
        server = AdminServer(admin).start()
        c = Client("127.0.0.1", server.port, timeout_s=900)
        c.login(config.SUPERADMIN_EMAIL, config.SUPERADMIN_PASSWORD)
        c.create_model("vit-b16", "IMAGE_CLASSIFICATION",
                       TEMPLATE.read_bytes(), "TorchViT")
        for kernel in kernels:
            kernel.launches = 0

        # ---- the main path's run (train job in a child) ----
        t0, t0_wall = time.perf_counter(), time.time()
        c.create_train_job("vit", "IMAGE_CLASSIFICATION", uris["train"],
                           uris["test"], budget={"MODEL_TRIAL_COUNT": TRIALS,
                                                 "CHIP_COUNT": 1})
        job = c.wait_until_train_job_stopped("vit", timeout_s=900,
                                             poll_s=0.05)
        job_s = time.perf_counter() - t0
        # ----------------------------------------------------
        require([k.launches for k in kernels] == [0] * 4,
                f"this process launched {[k.launches for k in kernels]} "
                "while the train child trained")
        require(job["status"] == "STOPPED", f"train job {job['status']}")
        (train_sid,) = [w["service_id"] for w in job["workers"]]
        require(job["workers"][0]["chips"] == [0],
                f"train grant {job['workers'][0]['chips']}")
        trials = [admin.db.get_trial(t["id"])
                  for t in c.get_trials_of_train_job("vit")]
        require([t["status"] for t in trials] == ["COMPLETED"] * TRIALS,
                f"trials {[(t['status'], t['fault_detail']) for t in trials]}")
        require(all(np.isfinite(t["score"]) for t in trials),
                f"scores {[t['score'] for t in trials]}")
        require({t["worker_id"] for t in trials} == {train_sid},
                "trial rows not written by the train child")
        steps = sum((TRAIN_IMAGES // t["knobs"]["batch_size"])
                    * t["knobs"]["epochs"] for t in trials)
        print(f"process: train job of {TRIALS} trials STOPPED in {job_s:.1f}"
              f" s in a child process (Client.create_train_job to STOPPED), "
              f"{thread_job_s:.1f} s for phase 5's thread-placed job; scores "
              f"{[round(t['score'], 4) for t in trials]}; {steps} steps; "
              f"card {card}", flush=True)
        train_timeline(c, trials, t0_wall, job_s,
                       child_records(logs, "startup")[train_sid][0])

        twin, twin_server, twin_token = thread_twin(
            uris, trials, WORK / "process_threads.sqlite3")
        cap = config.PREDICT_MAX_BATCH_SIZE
        buckets = DataParallelTrainer(device="cpu").predict_buckets(cap)
        rng = np.random.default_rng(SEED + 10)
        images = rng.standard_normal((8, 224, 224, 3)).astype(np.float32)
        timed = [(kind, n) for kind, n in JSON_TIMED if n in sizes]
        bodies = {(kind, n): request_body(kind, images[:n])
                  for kind, n in timed}
        token = admin.authenticate_user(config.SUPERADMIN_EMAIL,
                                        config.SUPERADMIN_PASSWORD)["token"]
        for kernel in kernels:
            kernel.launches = 0

        # ---- the main path's run (inference job in children) ----
        t0 = time.perf_counter()
        inf = c.create_inference_job("vit")
        deploy_s = time.perf_counter() - t0
        answers = [(n, np.asarray(c.predict("vit", images[:n].tolist())))
                   for n in sizes]
        doors = {"process": (f"http://127.0.0.1:{server.port}/predict/vit",
                             token),
                 "thread": (f"http://127.0.0.1:{twin_server.port}/predict/"
                            "vit", twin_token)}
        lat = {door: {} for door in doors}
        for i, (kind, n) in enumerate(timed):
            for door in sorted(doors, reverse=bool(i % 2)):
                url, auth = doors[door]
                t = time.perf_counter()
                post(url, *bodies[kind, n], token=auth)
                lat[door].setdefault((kind, n), []).append(
                    time.perf_counter() - t)
        c.stop_inference_job("vit")
        # ----------------------------------------------------------
        twin_launches = [k.launches for k in kernels]
        require(inf["status"] == "RUNNING" and len(inf["workers"]) == TRIALS,
                f"inference job {inf['status']}, {len(inf['workers'])} "
                "workers")
        require([w["chips"] for w in inf["workers"]] == [[0]] * TRIALS,
                f"serving grants {[w['chips'] for w in inf['workers']]}")
    finally:
        if twin_server is not None:
            twin_server.stop()
        if twin is not None:
            twin.shutdown()
        if server is not None:
            server.stop()
        admin.shutdown()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    # every child gone, every ring unlinked
    started = child_records(logs, "startup")
    counted = child_records(logs, "kernel launches")
    serving = [w["service_id"] for w in inf["workers"]]
    require(sorted(started) == sorted([train_sid] + serving)
            and all(len(v) == 1 for v in started.values()),
            f"startup lines {started}")
    pids = [r["pid"] for v in started.values() for r in v]
    alive = [pid for pid in pids if _alive(pid)]
    segments = list(Path("/dev/shm").glob(f"{admin.broker.prefix}-*"))
    require(not alive and not segments and os.getpid() not in pids,
            f"after stop: children alive {alive}, segments {segments}")
    print(f"process: after stop_all: children {pids} all exited, no "
          f"/dev/shm/{admin.broker.prefix}-* segment left", flush=True)
    # the grant, cuda:0 here, is the first card this process sees
    parent = os.environ.get("CUDA_VISIBLE_DEVICES", "").strip()
    card0 = parent.split(",")[0].strip() if parent else "0"
    for sid, (rec,) in started.items():
        role = "train" if sid == train_sid else "serving"
        require(rec["cuda_visible_devices"] == card0 and rec["grant"] == [0],
                f"{role} child {sid[:8]} saw CUDA_VISIBLE_DEVICES="
                f"{rec['cuda_visible_devices']!r}, grant {rec['grant']}")
        parts = (("interpreter and package import", "t_start", "t_main"),
                 ("torch import", "t_main", "t_torch"),
                 ("CUDA init", "t_torch", "t_cuda"),
                 ("kernel library load", "t_cuda", "t_kernels"),
                 ("job read and advisor session" if role == "train" else
                  "model load and bucket warm-up", "t_kernels", "t_ready"))
        print(f"process: {role} child {sid[:8]} (pid {rec['pid']}, "
              f"CUDA_VISIBLE_DEVICES={card0}): spawn to RUNNING "
              f"{rec['t_ready'] - rec['t_start']:.2f} s = "
              + " + ".join(f"{label} {rec[b] - rec[a]:.2f}"
                           for label, a, b in parts), flush=True)

    # launches, from the children's exit lines
    sums = {name: 0 for name in KERNEL_NAMES}
    for sid, records in counted.items():
        require(len(records) == 1, f"{sid[:8]}: {len(records)} exit lines")
        got = [records[0][attr] for attr in (
            "flash_attention", "flash_attention_lse", "flash_attention_dq",
            "flash_attention_dkv")]
        forwards = len(buckets) + len(sizes) + len(timed)
        expect = ([DEPTH * TRIALS] + [DEPTH * steps] * 3 if sid == train_sid
                  else [DEPTH * forwards, 0, 0, 0])
        require(got == expect, f"child {sid[:8]} launches {got}, expected "
                f"{expect}")
        for name, n in zip(KERNEL_NAMES, got):
            sums[name] += n
    # the twin warmed up before the counts were zeroed
    twin_expect = [DEPTH * TRIALS * len(timed), 0, 0, 0]
    require(twin_launches == twin_expect,
            f"thread twin launches {twin_launches}, expected {twin_expect}")
    print(f"process: launches in the children (exit lines): train child "
          f"K1 {DEPTH * TRIALS} ({TRIALS} evaluates), K1-LSE = K2 = K3 = "
          f"{DEPTH * steps} ({steps} steps); each serving child K1 "
          f"{DEPTH * (len(buckets) + len(sizes) + len(timed))} "
          f"({len(buckets)} warm-up buckets + {len(sizes) + len(timed)} "
          f"requests); none in this process but the thread twin's "
          f"{twin_launches[0]}", flush=True)

    cfg = vit.vit_b16()
    plain_cfg = dataclasses.replace(
        cfg, encoder=dataclasses.replace(cfg.encoder, use_flash=False))
    refs = []
    with torch.inference_mode():
        x = torch.from_numpy(images).cuda()
        for t in trials:
            tree = load_params(read_artifact(t["params_file_path"]))
            m = convert.from_jax_params(tree, plain_cfg, "cuda:0")
            refs.append(torch.softmax(m(x), -1).double().cpu().numpy())
            del m
    ref = sum(refs) / len(refs)
    for n, probs in answers:
        require(probs.shape == (n, cfg.num_classes),
                f"process /predict/vit {n}: shape {probs.shape}")
        require(bool(np.isfinite(probs).all()),
                f"process /predict/vit {n}: non-finite")
        held = prob_check(f"process /predict/vit {n}", probs, ref[:n])
        print(f"process: Client.predict of {n} (JSON) answered by the "
              f"serving children: {held}; against the plain-attention "
              f"ensemble of the trials", flush=True)
    p50 = {door: p50_ms(v) for door, v in lat.items()}
    print(f"process: inference job RUNNING in {deploy_s:.1f} s (2 serving "
          f"children spawned, loaded and warmed); /predict/vit p50 of the "
          f"same JSON bodies in turns, process vs thread placement: "
          + ", ".join(f"{n} image{'s' if n > 1 else ''} "
                      f"{p50['process']['json', n]:.2f} vs "
                      f"{p50['thread']['json', n]:.2f} ms"
                      for n in sizes)
          + f" ({len(timed) // len(sizes)} requests of each size a door, "
          f"sequential); card {card}", flush=True)
    return [sums[name] for name in KERNEL_NAMES]


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


def _count(tree) -> int:
    return sum(_count(v) if isinstance(v, dict) else v.size
               for v in tree.values())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    import rafiki_tpu_torch  # noqa: F401  (fails outside a checkout)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    card = header()
    entries, kernel_ms = kernel_phase()
    db, uris, trials, job_s, train_launches = train_phase(card)
    serve_launches = serve_phase(card, kernel_ms, db, trials)
    stack_launches, stack_job_s = stack_phase(card, uris, job_s)
    process_launches = process_phase(card, uris, stack_job_s)
    for i, name in enumerate(KERNEL_NAMES):
        by_path = {"train (phase 3)": train_launches[i],
                   "serve (phase 4)": serve_launches[i],
                   "stack (phase 5)": stack_launches[i],
                   "process (phase 6)": process_launches[i]}
        require(by_path["stack (phase 5)"] > 0,
                f"{name} was not launched through the admin")
        require(by_path["process (phase 6)"] > 0,
                f"{name} was not launched in a child process")
        entries[name]["launches"] = stack_launches[i]
        entries[name]["launches_by_path"] = by_path
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.0f} s",
          flush=True)
    print(json.dumps({"kernels": [entries[name] for name in KERNEL_NAMES]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
