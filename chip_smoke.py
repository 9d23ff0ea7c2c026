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
7. zoo: the image-classification twins. 7a: ``test_model_class`` of each
   of the six (``TorchFeedForward``, ``TorchCnn``, ``TorchVgg16``,
   ``TorchResNet``, ``NpDecisionTree``, ``NpLinearSvm``) on cuda:0, knobs
   from the port's advisor, on a seeded synthetic set of 512 train and
   128 test images (32x32x3) written as image zips. 7b: a synthetic set
   at CIFAR-10's own size (50,000 + 10,000 images, 32x32x3, 10 classes, a
   prototype a class plus noise) written as image zips by the port's PNG
   writer; ``TorchResNet`` with ``depth`` fixed to ResNet-50 and one
   epoch uploaded through ``Client`` (enforce), a 2-trial job
   (``CHIP_COUNT=1``, the GP over the learning rate and the batch size),
   both trials COMPLETED above chance; an inference job of both,
   ``Client.predict`` of 8 images within 1e-3 of the mean of the two
   trials' own ``predict`` on the card, each image alone within 2e-2 of
   its row in the batch; then 10 timed JSON requests of 1 and of 64
   images. Printed: the job's wall time, each trial's split (dataset read
   and decode, parameter init, upload, epochs, evaluate, artifact write),
   the deploy time, the p50s, and the train step at the best trial's
   batch, per call, on the card and by kernel. No attention kernel is on
   this path: every count must read 0.
8. text. 8a: an SST-2-sized synthetic corpus (6,920 + 1,821 sentences of
   5-40 words, two disjoint pools) written as corpus zips; ``TorchBert``
   at BERT-base's widths (12 x 768, 12 heads, vocabulary 30,522, 128
   tokens, one epoch) uploaded through ``Client`` (enforce), a 2-trial job
   (GP over the learning rate and the batch size), both trials above
   chance, K1-LSE, K2 and K3 launched 12 times a step and K1 12 times an
   evaluate forward; an inference job of both, ``Client.predict`` of 8
   sentences within 1e-3 of the trials' mean and within 0.05 p + 1e-5 of
   the plain-attention forward, K1 12 times a bucketed forward; p50 of
   ``/predict/sst2`` for 1 and 64 sentences; one train step through the
   kernels against plain attention (phase 3's tolerances) and the step's
   time and profile. 8b: ``TorchGenLM`` at ``LMConfig``'s defaults
   (vocabulary 32,000, 2,048 positions, 12 x 768, 12 heads, causal)
   uploaded under ``TEXT_GENERATION``, trained 4 Adam steps on (8, 512)
   through ``Client`` (the causal K1-LSE, K2, K3 12 times a step), one
   step held against plain attention; served on its own door
   (``RAFIKI_PREDICTOR_PORTS=1``) to 8 concurrent ``Client.generate``
   streams of 64 tokens (prompts of 128-512 tokens, half sharing a
   256-token prefix): greedy as JSON and as v3 frames, sampled twice with
   fixed seeds, greedy on the ring layout, sampled with a pool too small
   for the streams (preemption). Greedy streams equal the argmax of the
   f32 plain-attention forward on the card, and sampled ones its draws
   under the same keys, up to each stream's first near tie; the other
   passes equal them as far; prefix-cache hits > 0; no slot or page
   left; no attention kernel launched while serving. Printed: time to
   first token p50/p95, tokens/s, the decode step per call and its
   kernels, the KV pool's bytes.

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
# relative of O(1) values), serving's K1 rounds P to bf16 before P V and K3
# before P^T dO (the training K1's P V and the dS products are split into
# two bf16 products, f32 to ~2^-17); f32 differs by summation order only.
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
# one bf16 step of BERT-base or the LM through the kernels, held against an
# f32 step through plain attention: at BERT-base's initialization bf16
# rounding alone moves every gradient ~10% from f32 whichever attention
# runs (each sentence's first token pools to nearly the same vector, so a
# gradient is a small difference of per-sentence terms), so the kernels
# are held to plain bf16 attention's own distance: each leaf's (its worst
# layer's) within BF16_GRAD_RATIO times plain bf16's
BF16_GRAD_RATIO = 1.5

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
      f32 output the backward's delta is taken from; for bf16 6 Dh FLOPs a
      pair (PV is two bf16 products, of P rounded and of its remainder);
    - dq: reads q, k, v, dO, lse and the f32 output; writes dq and delta
      = rowsum(dO o O); 6 Dh FLOPs a pair (QK^T, dO V^T, dS K), for bf16
      8 (dS K as two products), and 2 Dh a row (delta);
    - dkv: reads as dq; writes dk, dv; 8 Dh a pair (K Q^T, V dO^T, P^T dO,
      dS^T Q), for bf16 10 (dS^T Q as two products)."""
    size = torch.tensor([], dtype=dtype).element_size()
    split = 2 if size < 4 else 0  # bf16: the split product's FLOPs a Dh
    q_el, kv_el, rows = b * h * sq * dh, b * h * skv * dh, b * h * sq
    nbytes, per_pair = {
        "fwd": ((2 * q_el + 2 * kv_el) * size, 4),
        "fwd_lse": ((2 * q_el + 2 * kv_el) * size + 4 * rows
                    + (4 * q_el if size < 4 else 0), 4 + split),
        "dq": ((3 * q_el + 2 * kv_el) * size + 4 * q_el + 8 * rows,
               6 + split),
        "dkv": ((2 * q_el + 4 * kv_el) * size + 8 * rows, 8 + split),
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
PTXAS = (("K1", "flash_fwd", "flash_fwd_wgmma_kernelILi64ELb0EE"),
         ("K1-LSE", "flash_fwd", "flash_fwd_wgmma_kernelILi64ELb1EE"),
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


def _out_err(out, ref, per_element: bool) -> tuple:
    """(error, what it is) of an attention output against its plain
    version: the largest absolute error, or where ``per_element`` the
    largest over max(1, |ref|) element by element (the case of a large
    causal batch: its first rows see a key or two and output values of
    ~|v|, up to ~4.5 at B=8, H=12, where one bf16 ulp is 2^-6), as
    tests/test_torch_cuda.py's large-batch causal test holds them."""
    err = (out.float() - ref.float()).abs()
    if not per_element:
        return float(err.max()), "max_abs_err"
    return (float((err / ref.float().abs().clamp(min=1.0)).max()),
            "max error over max(1, |ref|)")


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

    # (label, b, h, sq, skv, dh, causal, dtype, block_q, block_k, the
    # output's error per element)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        ("vit B=8", 8, 12, 196, 196, 64, False, bf16, 64, 64, False),
        ("vit B=64", 64, 12, 196, 196, 64, False, bf16, 64, 64, False),
        # phase 8's shapes: BERT-base serving, the LM's causal evaluate
        ("bert B=64", 64, 12, 128, 128, 64, False, bf16, 64, 64, False),
        ("lm causal B=8", 8, 12, 512, 512, 64, True, bf16, 64, 64, True),
        ("S=40, 16-tiles", 2, 4, 40, 40, 64, False, bf16, 16, 16, False),
        ("Sq<Skv causal", 2, 4, 64, 196, 64, True, bf16, 64, 64, False),
        ("dead rows: causal Skv<Sq", 2, 4, 196, 64, 64, True, bf16, 32, 16,
         False),
        ("f32", 4, 12, 196, 196, 64, False, f32, 64, 32, False),
    ]
    entries, times = {}, {}
    for label, b, h, sq, skv, dh, causal, dtype, bq, bk, per_el in cases:
        q, k, v = qkv(b, h, sq, skv, dh, dtype)
        out = fa.flash_attention(q, k, v, causal, None, bq, bk)
        torch.cuda.synchronize()
        ref = fa.flash_attention_plain(q, k, v, causal, None, bk)
        err, measure = _out_err(out, ref, per_el)
        tol = TOL[dtype]
        line = (f"K1 {label}: B={b} H={h} Sq={sq} Skv={skv} Dh={dh} "
                f"causal={causal} {str(dtype).split('.')[-1]} "
                f"tiles {bq}x{bk}: {measure} {err:.3g} (tol {tol:g})")
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
    # (label, b, h, sq, skv, dh, causal, dtype, block_q, block_k, the
    # output's error per element)
    cases = [
        ("train B=64", 64, 12, 196, 196, 64, False, bf16, 64, 64, False),
        # phase 8's training shapes: BERT-base, and the LM causal
        ("bert B=32", 32, 12, 128, 128, 64, False, bf16, 64, 64, False),
        ("lm causal B=8", 8, 12, 512, 512, 64, True, bf16, 64, 64, True),
        ("S=40, 16-tiles", 2, 4, 40, 40, 64, False, bf16, 16, 16, False),
        ("Sq<Skv causal", 2, 4, 64, 196, 64, True, bf16, 64, 64, False),
        ("dead rows: causal Skv<Sq", 2, 4, 196, 64, 64, True, bf16, 32, 16,
         False),
        ("f32", 4, 12, 196, 196, 64, False, f32, 64, 32, False),
    ]
    entries = {}
    for label, b, h, sq, skv, dh, causal, dtype, bq, bk, per_el in cases:
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
        out_err, measure = _out_err(out, ref_out, per_el)
        errs = {
            "out": max(out_err, _out_err(out32, ref_out32, per_el)[0]),
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
        line = (f"K1-LSE/K2/K3 {label}: {where}: out {measure} "
                f"{errs['out']:.3g}, max_abs_err lse {errs['lse']:.3g} (tol "
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


def _step_grads(cfg, tree: dict, loss_of, dtype) -> tuple:
    """(loss, {name: gradient in f64}) of one step from ``tree`` (built by
    ``convert.from_jax_params`` on cuda:0 under ``cfg``) computing in
    ``dtype``: ``loss_of(model, dtype)``."""
    from rafiki_tpu_torch import convert

    model = convert.from_jax_params(tree, cfg, "cuda:0", train=True)
    loss = loss_of(model, dtype)
    loss.backward()
    return float(loss.detach()), {k: p.grad.double() for k, p in
                                  model.named_parameters()}


def _rel_l2(a: dict, b: dict) -> dict:
    return {k: float((a[k] - b[k]).norm() / b[k].norm().clamp_min(1e-30))
            for k in b}


def _worst_by_leaf(errs: dict) -> dict:
    """The worst layer's error of each leaf."""
    by_leaf = {}
    for k, e in errs.items():
        leaf = re.sub(r"^blocks\.\d+\.", "blocks.*.", k)
        by_leaf[leaf] = max(by_leaf.get(leaf, 0.0), e)
    return by_leaf


def _leaves(errs: dict) -> str:
    return ", ".join(f"{k} {e:.2e}" for k, e in
                     sorted(_worst_by_leaf(errs).items()))


def _plain(cfg):
    return dataclasses.replace(
        cfg, encoder=dataclasses.replace(cfg.encoder, use_flash=False))


def step_vs_plain(label: str, cfg, tree: dict, loss_of,
                  dtype=torch.bfloat16, plain=None) -> None:
    """One train step's loss and gradients through the kernels against
    those through plain attention, from the same weights and batch
    (``loss_of(model, dtype)``), computing in ``dtype``: the loss within
    LOSS_ATOL, each parameter's gradient within GRAD_RTOL of its L2 norm
    (the q/k projections' within QK_GRAD_RTOL). ``plain``: the plain
    step's (loss, gradients), where already taken."""
    loss_k, g_k = _step_grads(cfg, tree, loss_of, dtype)
    loss_p, g_p = plain or _step_grads(_plain(cfg), tree, loss_of, dtype)
    rel = _rel_l2(g_k, g_p)
    print(f"{label}, kernels vs plain attention ({str(dtype)[6:]}): loss "
          f"{loss_k:.6f} vs {loss_p:.6f} (|diff| {abs(loss_k - loss_p):.3g}, "
          f"tol {LOSS_ATOL:g}); gradient relative L2 error per leaf (worst "
          f"layer; tol {GRAD_RTOL:g}, {QK_GRAD_RTOL:g} for "
          f"{'/'.join(QK_LEAVES)}): {_leaves(rel)}", flush=True)
    require(abs(loss_k - loss_p) <= LOSS_ATOL, f"{label}: loss differs")
    for k, e in rel.items():
        tol = QK_GRAD_RTOL if k.endswith(QK_LEAVES) else GRAD_RTOL
        require(e <= tol, f"{label}: gradient of {k} off by {e:.3g} (tol "
                f"{tol:g})")


def text_step_gates(label: str, cfg, tree: dict, loss_of) -> None:
    """One train step from ``tree`` four ways, f32 and bf16, each through
    the kernels and through plain attention. The f32 kernels are held to
    the f32 plain step by :func:`step_vs_plain`. The bf16 kernels, which
    the main path runs, are held to the f32 plain step against plain bf16
    attention: their loss within LOSS_ATOL of plain bf16's, and each
    leaf's gradient (its worst layer) within BF16_GRAD_RATIO times plain
    bf16's distance from f32."""
    f32 = _step_grads(_plain(cfg), tree, loss_of, torch.float32)
    step_vs_plain(label, cfg, tree, loss_of, torch.float32, plain=f32)
    loss_k, g_k = _step_grads(cfg, tree, loss_of, torch.bfloat16)
    loss_p, g_p = _step_grads(_plain(cfg), tree, loss_of, torch.bfloat16)
    worst_k, worst_p = (_worst_by_leaf(_rel_l2(g, f32[1]))
                        for g in (g_k, g_p))
    ratio = {k: worst_k[k] / max(worst_p[k], 1e-30) for k in worst_k}
    direct = _worst_by_leaf(_rel_l2(g_k, g_p))
    far = max(direct, key=direct.get)
    print(f"{label}, bf16 against f32 plain attention: loss through the "
          f"kernels {loss_k:.6f}, plain {loss_p:.6f} (|diff| "
          f"{abs(loss_k - loss_p):.3g}, tol {LOSS_ATOL:g}); gradient "
          f"relative L2 error per leaf (worst layer), the kernels / plain "
          f"bf16 (ratio; tol {BF16_GRAD_RATIO:g}): " + ", ".join(
              f"{k} {worst_k[k]:.2e}/{worst_p[k]:.2e} ({ratio[k]:.2f})"
              for k in sorted(worst_k)) + "; the kernels against plain "
          f"bf16 directly, worst leaf: {far} {direct[far]:.2e}", flush=True)
    require(abs(loss_k - loss_p) <= LOSS_ATOL, f"{label}: bf16 loss differs")
    for k, r in ratio.items():
        require(r <= BF16_GRAD_RATIO, f"{label}: bf16 gradient of {k} "
                f"{worst_k[k]:.3g} from f32, {r:.3g} times plain bf16's "
                f"{worst_p[k]:.3g} (tol {BF16_GRAD_RATIO:g})")


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
    loss_fn = softmax_classifier_loss(lambda m, xb: m(xb))
    batch = (torch.from_numpy(x[:64]).cuda(), torch.from_numpy(y[:64]).cuda())
    step_vs_plain("train: one step at batch 64", cfg, tree,
                  lambda model, dtype: loss_fn(model, batch)[0])

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
        server = PredictorServer(predictor, app="vit", auth=False).start()
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
        direct = PredictorServer(predictor, app="vit", auth=False).start()
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


# ---------------------------------------------------------------------------
# phase 7: the image-classification zoo
# ---------------------------------------------------------------------------

TEMPLATES = REPO / "rafiki_tpu_torch" / "templates"
#: the six twins of the JAX package's image-classification templates
ZOO_TWINS = (("torch_feedforward", "TorchFeedForward"),
             ("torch_cnn", "TorchCnn"), ("torch_vgg16", "TorchVgg16"),
             ("torch_resnet", "TorchResNet"),
             ("np_decision_tree", "NpDecisionTree"),
             ("np_linear_svm", "NpLinearSvm"))
ZOO_SMALL = (512, 128)         # 7a: train and test images
CIFAR_SIZES = (50_000, 10_000)  # 7b: CIFAR-10's own train and test sizes
#: TorchResNet with the plan and the epochs fixed: the GP tunes the
#: learning rate and the batch size
RESNET50 = """

class TorchResNet50(TorchResNet):
    @staticmethod
    def get_knob_config():
        knobs = TorchResNet.get_knob_config()
        knobs.update(depth=FixedKnob("resnet50"), epochs=FixedKnob(1))
        return knobs
"""
# the served ensemble against the mean of its trials' own predict on the
# card: the same forward at the same bucket (8), the mean taken in f64 by
# both; and one image alone (padded to the 8-bucket with copies of
# itself) against its row in a batch of 8: in evaluation mode BatchNorm
# uses the running statistics, so only cuDNN's choice of algorithm for
# another batch's contents may move a bf16 logit
ENSEMBLE_ATOL = 1e-3
ALONE_ATOL = 2e-2
ZOO_TIMED = [1] * 10 + [64] * 10  # JSON requests on /predict/<app>


def synthetic_cifar(rng: np.random.Generator, protos: np.ndarray, n: int):
    """``n`` CIFAR-10-shaped images (32x32x3 uint8) and labels: each
    class's 8x8x3 prototype blown up 4x, x 55 + 128, plus N(0, 14) noise
    (the synthetic set of ``examples/datasets/image_classification/
    load_cifar10.py``)."""
    y = rng.integers(0, len(protos), n)
    x = np.kron(protos[y], np.ones((1, 4, 4, 1), np.float32))
    x = x * 55.0 + 128.0 + rng.normal(scale=14.0, size=x.shape)
    return np.clip(x, 0, 255).astype(np.uint8), y


def zoo_datasets(name: str, sizes: tuple, seed: int) -> tuple:
    """Image-zip train and test sets under ``build/chip_smoke/zoo/``, and
    the test images as [0, 1] floats."""
    from rafiki_tpu_torch.sdk.dataset import write_image_files_dataset

    rng = np.random.default_rng(seed)
    protos = rng.normal(size=(CLASSES, 8, 8, 3)).astype(np.float32)
    out = WORK / "zoo"
    out.mkdir(parents=True, exist_ok=True)
    uris = []
    for split, n in zip(("train", "test"), sizes):
        x, y = synthetic_cifar(rng, protos, n)
        uris.append(write_image_files_dataset(
            x, y, str(out / f"{name}_{split}.zip")))
    return uris[0], uris[1], x.astype(np.float32) / 255


def zoo_contract(card: str) -> None:
    """7a: ``test_model_class`` of each twin on cuda:0, its knobs proposed
    by the port's advisor."""
    from rafiki_tpu_torch.sdk import model as sdk_model

    t0 = time.perf_counter()
    train, test, x = zoo_datasets("small", ZOO_SMALL, SEED + 70)
    print(f"zoo: image-zip sets of {ZOO_SMALL[0]} + {ZOO_SMALL[1]} images "
          f"(32x32x3) written in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for module, class_name in ZOO_TWINS:
        t0 = time.perf_counter()
        preds = np.asarray(sdk_model.test_model_class(
            model_file_path=str(TEMPLATES / f"{module}.py"),
            model_class=class_name, task="IMAGE_CLASSIFICATION",
            train_dataset_uri=train, test_dataset_uri=test,
            queries=x[:2].tolist()))
        require(preds.shape == (2, CLASSES) and np.isfinite(preds).all()
                and np.allclose(preds.sum(-1), 1, atol=1e-4),
                f"{class_name} predictions {preds}")
        print(f"zoo: test_model_class {class_name} OK on "
              f"{torch.cuda.get_device_name(0)} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    print(f"zoo: the six twins passed test_model_class; card {card}",
          flush=True)


def trial_split(logs: list, wall: float) -> str:
    """Where a trial's wall time went, from its logged metrics: the
    template's ``read_time`` and ``init_time``, ``fit``'s ``upload_time``
    and ``epoch_time``, and the worker's phase breakdown
    (``trace_{train,evaluate,persist_params}_s``)."""
    m = {}
    for record in logs:
        for key, value in record.items():
            if key.endswith(("_time", "_s")):
                m[key] = m.get(key, 0.0) + value
    inside = [("dataset read and decode", "read_time"),
              ("parameter init", "init_time"), ("upload", "upload_time"),
              ("epochs", "epoch_time")]
    parts = inside + [
        ("the rest of train()", m.get("trace_train_s", 0.0)
         - sum(m.get(key, 0.0) for _, key in inside)),
        ("evaluate", "trace_evaluate_s"),
        ("artifact write", "trace_persist_params_s")]
    seconds = [(label, m.get(key, 0.0) if isinstance(key, str) else key)
               for label, key in parts]
    rest = wall - sum(v for _, v in seconds)
    return ", ".join(f"{label} {v:.2f} s" for label, v in seconds) + (
        f", outside the phases {rest:.2f} s")


def zoo_step_time(card: str, batch: int, train_uri: str) -> None:
    """The ResNet-50 train step at ``batch``, per call and on the card,
    and a kernel profile of one step."""
    from rafiki_tpu_torch.convert import from_jax_tree
    from rafiki_tpu_torch.models import resnet
    from rafiki_tpu_torch.sdk.dataset import dataset_utils
    from rafiki_tpu_torch.sdk.torch_backend import (
        DataParallelTrainer,
        tunable_optimizer,
    )
    from rafiki_tpu_torch.templates import torch_resnet

    x, y = dataset_utils.load_image_arrays(train_uri, image_size=(32, 32))
    cfg = resnet.resnet50(num_classes=CLASSES, small_inputs=True)
    with torch.device("meta"):
        model = resnet.ResNet(cfg)
    model = from_jax_tree(model, *resnet.init(np.random.default_rng(0), cfg),
                          "cuda:0", train=True)
    state = model.state()
    trainer = DataParallelTrainer(
        torch_resnet._loss, tunable_optimizer(
            torch.optim.AdamW, lr=1e-4, weight_decay=1e-4),
        device="cuda:0", stateful=True)
    opt = trainer.optimizer(model.parameters())
    data = (torch.from_numpy(x[:batch]).cuda(),
            torch.from_numpy(y[:batch]).cuda())
    step = lambda: trainer.train_step(model, opt, data, state)  # noqa: E731
    call_ms = median_ms(step, reps=10)
    card_ms = device_ms(step, reps=3, inner=3, hold_cycles=400_000_000)
    print(f"zoo: ResNet-50 train step at batch {batch} (32x32x3, bf16): "
          f"{call_ms:.2f} ms per call, {card_ms:.2f} ms on the card; "
          f"{batch / call_ms * 1e3:.0f} images/s per call "
          f"({batch / card_ms * 1e3:.0f} on the card); card {card}",
          flush=True)
    print_device_profile(step, f"batch-{batch} ResNet-50 train step")
    del model, opt, state, data


def zoo_phase(card: str) -> list:
    """7a, then 7b: a 2-trial ResNet-50 job on a CIFAR-10-sized image-zip
    set through ``Client`` (GP over the learning rate and the batch
    size), served. Returns each kernel's launches on this path, in
    ``KERNEL_NAMES`` order (none is on it)."""
    from rafiki_tpu_torch import config
    from rafiki_tpu_torch.admin.admin import Admin
    from rafiki_tpu_torch.admin.http import AdminServer
    from rafiki_tpu_torch.client.client import Client
    from rafiki_tpu_torch.db.database import Database
    from rafiki_tpu_torch.sdk.model import load_model_class
    from rafiki_tpu_torch.sdk.params import load_params

    t_phase = time.perf_counter()
    zoo_contract(card)
    t0 = time.perf_counter()
    train_uri, test_uri, x = zoo_datasets("cifar", CIFAR_SIZES, SEED + 71)
    mb = sum(Path(u).stat().st_size for u in (train_uri, test_uri)) / 1e6
    print(f"zoo: CIFAR-10-sized synthetic set ({CIFAR_SIZES[0]} + "
          f"{CIFAR_SIZES[1]} images, 32x32x3, {CLASSES} classes) made and "
          f"written as image zips (PNG, filter 0) in "
          f"{time.perf_counter() - t0:.1f} s ({mb:.0f} MB)", flush=True)

    store = WORK / "zoo.sqlite3"
    for path in WORK.glob("zoo.sqlite3*"):
        path.unlink()
    source = (TEMPLATES / "torch_resnet.py").read_text() + RESNET50
    admin = Admin(db=Database(str(store)),
                  params_dir=str(WORK / "zoo_params"))
    server = AdminServer(admin).start()
    kernels = _kernels()
    try:
        c = Client("127.0.0.1", server.port, timeout_s=900)
        c.login(config.SUPERADMIN_EMAIL, config.SUPERADMIN_PASSWORD)
        model = c.create_model("resnet50", "IMAGE_CLASSIFICATION",
                               source.encode(), "TorchResNet50")
        require(model["verification"] is not None
                and model["verification"]["ok"],
                f"TorchResNet50 upload not verified: "
                f"{model['verification']}")

        # ---- the main path's run (train job): counts from zero ----
        for kernel in kernels:
            kernel.launches = 0
        t0 = time.perf_counter()
        c.create_train_job("cifar", "IMAGE_CLASSIFICATION", train_uri,
                           test_uri, budget={"MODEL_TRIAL_COUNT": TRIALS,
                                             "CHIP_COUNT": 1})
        job = c.wait_until_train_job_stopped("cifar", timeout_s=900,
                                             poll_s=0.05)
        torch.cuda.synchronize()
        job_s = time.perf_counter() - t0
        train_counts = [k.launches for k in kernels]
        # ---------------------------------------------------------------
        require(job["status"] == "STOPPED", f"train job {job['status']}: "
                f"{job.get('error_reason')}")
        trials = c.get_trials_of_train_job("cifar")
        require([t["status"] for t in trials] == ["COMPLETED"] * TRIALS,
                f"trials {[(t['status'], t['fault_detail']) for t in trials]}")
        for t in trials:
            require(np.isfinite(t["score"]) and t["score"] > 1 / CLASSES,
                    f"trial score {t['score']} not above chance")
            wall = t["datetime_stopped"] - t["datetime_started"]
            print(f"zoo: trial {t['id'][:8]} COMPLETED: learning_rate "
                  f"{t['knobs']['learning_rate']:.3g}, batch_size "
                  f"{t['knobs']['batch_size']}, test accuracy "
                  f"{t['score']:.4f}; {wall:.2f} s in the trial: "
                  f"{trial_split(c.get_trial_logs(t['id'])['metrics'], wall)}",
                  flush=True)
        print(f"zoo: train job of {TRIALS} ResNet-50 trials (1 epoch of "
              f"{CIFAR_SIZES[0]} images each, GP) STOPPED in {job_s:.1f} s "
              f"(Client.create_train_job to STOPPED); card {card}",
              flush=True)
        best = max(trials, key=lambda t: t["score"])
        blobs = [load_params(c.download_trial_params(t["id"]))
                 for t in trials]

        token = admin.authenticate_user(config.SUPERADMIN_EMAIL,
                                        config.SUPERADMIN_PASSWORD)["token"]
        url = f"http://127.0.0.1:{server.port}/predict/cifar"
        bodies = {n: request_body("json", x[:n]) for n in set(ZOO_TIMED)}
        # ---- the main path's run (inference job): counts from zero ----
        for kernel in kernels:
            kernel.launches = 0
        t0 = time.perf_counter()
        inf = c.create_inference_job("cifar")
        deploy_s = time.perf_counter() - t0
        batch8 = np.asarray(c.predict("cifar", x[:8].tolist()))
        alone = np.concatenate([np.asarray(c.predict(
            "cifar", x[i:i + 1].tolist())) for i in range(8)])
        lat = {}
        for n in ZOO_TIMED:
            t = time.perf_counter()
            post(url, *bodies[n], token=token)
            lat.setdefault(("json", n), []).append(time.perf_counter() - t)
        serve_counts = [k.launches for k in kernels]
        # ---------------------------------------------------------------
        stats = c.get_inference_job_stats("cifar")
        c.stop_inference_job("cifar")
        require(inf["status"] == "RUNNING"
                and len(inf["workers"]) == TRIALS,
                f"inference job {inf['status']} with "
                f"{len(inf['workers'])} workers")
        p50 = p50_ms(lat)
        print(f"zoo: inference job RUNNING in {deploy_s:.1f} s (deploy and "
              f"warm-up of {TRIALS} ResNet-50 workers on "
              f"{[w['chips'] for w in inf['workers']]}); p50 of "
              f"/predict/cifar (JSON, admin door, sequential): "
              + ", ".join(f"{n} image{'s' if n > 1 else ''} "
                          f"{p50['json', n]:.2f} ms" for n in (1, 64))
              + f" ({ZOO_TIMED.count(1)} requests each); serving stats "
              f"{stats['batches']} batches, {stats['queries']} queries; "
              f"card {card}", flush=True)
    finally:
        server.stop()
        admin.shutdown()

    clazz = load_model_class(source.encode(), "TorchResNet50")
    refs = []
    for t, blob in zip(trials, blobs):
        m = clazz(**t["knobs"])
        m.load_parameters(blob)
        refs.append(np.asarray(m.predict(x[:8]), np.float64))
        del m
    mean = sum(refs) / len(refs)
    for label, got in (("batch of 8", batch8), ("one at a time", alone)):
        require(got.shape == (8, CLASSES) and np.isfinite(got).all(),
                f"/predict/cifar {label}: {got.shape}")
    err = float(np.abs(batch8 - mean).max())
    require(err <= ENSEMBLE_ATOL, f"ensemble off its trials' mean by "
            f"{err:.3g} (tol {ENSEMBLE_ATOL:g})")
    err_alone = float(np.abs(alone - batch8).max())
    require(err_alone <= ALONE_ATOL, f"one image alone off its row in the "
            f"batch by {err_alone:.3g} (tol {ALONE_ATOL:g})")
    agree = float((batch8.argmax(-1) == mean.argmax(-1)).mean())
    print(f"zoo: Client.predict of 8 images: the ensemble within "
          f"{err:.3g} of the mean of its {TRIALS} trials' predict on the "
          f"card (tol {ENSEMBLE_ATOL:g}; argmax agreement {agree:.2f}); each "
          f"image alone within {err_alone:.3g} of its row in the batch "
          f"(tol {ALONE_ATOL:g})", flush=True)
    zoo_step_time(card, best["knobs"]["batch_size"], train_uri)
    counts = [a + b for a, b in zip(train_counts, serve_counts)]
    require(counts == [0] * len(KERNEL_NAMES),
            f"the zoo path launched attention kernels: {counts}")
    print(f"zoo: phase 7 took {time.perf_counter() - t_phase:.0f} s",
          flush=True)
    return counts


# ---------------------------------------------------------------------------
# phase 8: text
# ---------------------------------------------------------------------------

SST2_SIZES = (6920, 1821)  # SST-2's train and test sentences
SENTENCE_TOKENS = (5, 40)
POOL_WORDS = 1000          # each class's words; the pools are disjoint
#: TorchBert at BERT-base's published widths (12 x 768, 12 heads, the
#: uncased vocabulary of 30,522) on 128-token sequences, one epoch; the GP
#: tunes the learning rate (the fine-tuning decade) and the batch size
BERT_BASE = """

class TorchBertBase(TorchBert):
    @staticmethod
    def get_knob_config():
        cfg = dict(TorchBert.get_knob_config())
        cfg["depth"] = FixedKnob(12)
        cfg["heads"] = FixedKnob(12)
        cfg["dim"] = FixedKnob(768)
        cfg["max_len"] = FixedKnob(128)
        cfg["vocab"] = FixedKnob(30522)
        cfg["epochs"] = FixedKnob(1)
        cfg["learning_rate"] = FloatKnob(5e-5, 5e-4, is_exp=True)
        return cfg
"""
#: Adam steps on the (8, 512) pattern rows: after 4 the loss was still
#: ~ln(32,000) (10.30), and a sampled stream's distribution spread over
#: thousands of tokens, whose cumulative boundaries lie closer together
#: than two f32 computations of it may differ; a few dozen steps make it
#: peaked on the learnt sequence, so its draws can be held token by token
LM_STEPS = 40
#: TorchGenLM at LMConfig's defaults (vocab 32,000, 2,048 positions,
#: 12 x 768, 12 heads, causal), trained LM_STEPS Adam steps on (8, 512)
LM_FULL = f"""

class TorchGenLMFull(TorchGenLM):
    generation_spec = GenerationSpec(eos_token_id=None, max_context=2048)
    arch = {{"vocab": 32000, "depth": 12, "heads": 12}}
    training = (8, 512, {LM_STEPS})

    @staticmethod
    def get_knob_config():
        cfg = dict(TorchGenLM.get_knob_config())
        cfg["lr"] = FixedKnob(1e-3)
        cfg["dim"] = FixedKnob(768)
        return cfg
"""
TEXT_TIMED = [1] * 10 + [64] * 10  # JSON requests on /predict/<app>
PREDICT_BUCKETS = 4                # a worker's warm-up: 8, 16, 32, 64
EVAL_BATCH = 256                   # predict_batched's default chunk
# generation traffic: 8 concurrent streams, prompts of 128-512 tokens of
# the training sequence, half of them sharing a 256-token prefix, 64
# tokens each
STREAMS, SHARED_PREFIX, PROMPT_TOKENS, GEN_TOKENS = 8, 256, (128, 512), 64
SAMPLING = {"temperature": 0.8, "top_p": 0.95}
# a pool too small for the 8 streams at once (each holds up to 36 pages
# of 16 tokens): the scheduler must preempt
SMALL_POOL_BLOCKS = 144
# a greedy token is compared where the f32 reference's top two logits
# differ by at least this; a sampled one where its uniform lies at least
# this far from every cumulative boundary of the reference distribution.
# Past the first position under either margin, two f32 computations in
# other orders may rightly differ, and the stream is compared no further
TIE_GAP = 1e-4
DRAW_MARGIN = 1e-5


def text_corpus():
    """SST-2-sized synthetic corpus zips under ``build/chip_smoke/text/``:
    two classes, each sentence 5-40 words of its class's pool (the pools
    disjoint), the label in the first tag column. Returns the train and
    test URIs and the test sentences as strings."""
    from rafiki_tpu_torch.sdk.dataset import write_corpus_dataset

    rng = np.random.default_rng(SEED + 80)
    pools = [[f"{c}{i}" for i in range(POOL_WORDS)] for c in "np"]
    out = WORK / "text"
    out.mkdir(parents=True, exist_ok=True)
    uris = []
    for split, n in zip(("train", "test"), SST2_SIZES):
        sentences = []
        for y in rng.integers(0, 2, n):
            k = int(rng.integers(SENTENCE_TOKENS[0], SENTENCE_TOKENS[1] + 1))
            words = [str(w) for w in rng.choice(pools[y], k)]
            sentences.append((words, [[("negative", "positive")[y]]] * k))
        uris.append(write_corpus_dataset(
            sentences, str(out / f"sst2_{split}.zip")))
    return uris[0], uris[1], [" ".join(w) for w, _ in sentences]


def _stack(name: str, port_store: str):
    """An admin (thread placement over the visible card), its REST door and
    a function that makes a logged-in Client, on a fresh store under
    ``build/chip_smoke/``."""
    from rafiki_tpu_torch import config
    from rafiki_tpu_torch.admin.admin import Admin
    from rafiki_tpu_torch.admin.http import AdminServer
    from rafiki_tpu_torch.client.client import Client
    from rafiki_tpu_torch.db.database import Database

    for path in WORK.glob(f"{port_store}*"):
        path.unlink()
    admin = Admin(db=Database(str(WORK / port_store)),
                  params_dir=str(WORK / f"{name}_params"))
    server = AdminServer(admin).start()

    def new_client():
        c = Client("127.0.0.1", server.port, timeout_s=900)
        c.login(config.SUPERADMIN_EMAIL, config.SUPERADMIN_PASSWORD)
        return c

    return admin, server, new_client


def bert_phase(card: str) -> list:
    """8a: a 2-trial BERT-base job on the SST-2-sized corpus through
    ``Client``, served; returns each kernel's launches on this path."""
    from rafiki_tpu_torch import config, convert
    from rafiki_tpu_torch.models import bert
    from rafiki_tpu_torch.sdk.model import load_model_class
    from rafiki_tpu_torch.sdk.params import load_params
    from rafiki_tpu_torch.sdk.torch_backend import (
        DataParallelTrainer,
        softmax_classifier_loss,
        tunable_optimizer,
    )

    t0 = time.perf_counter()
    train_uri, test_uri, queries = text_corpus()
    print(f"bert: SST-2-sized synthetic corpus ({SST2_SIZES[0]} + "
          f"{SST2_SIZES[1]} sentences of {SENTENCE_TOKENS[0]}-"
          f"{SENTENCE_TOKENS[1]} words, two disjoint pools of {POOL_WORDS}) "
          f"written as corpus zips in {time.perf_counter() - t0:.1f} s",
          flush=True)
    source = (TEMPLATES / "torch_bert.py").read_text() + BERT_BASE
    admin, server, new_client = _stack("text", "text.sqlite3")
    kernels = _kernels()
    try:
        c = new_client()
        model = c.create_model("bert-base", "TEXT_CLASSIFICATION",
                               source.encode(), "TorchBertBase")
        require(model["verification"] is not None
                and model["verification"]["ok"],
                f"TorchBertBase upload not verified: "
                f"{model['verification']}")
        # ---- the main path's run (train job): counts from zero ----
        for kernel in kernels:
            kernel.launches = 0
        t0 = time.perf_counter()
        c.create_train_job("sst2", "TEXT_CLASSIFICATION", train_uri,
                           test_uri, budget={"MODEL_TRIAL_COUNT": TRIALS,
                                             "CHIP_COUNT": 1})
        job = c.wait_until_train_job_stopped("sst2", timeout_s=900,
                                             poll_s=0.05)
        torch.cuda.synchronize()
        job_s = time.perf_counter() - t0
        train_counts = [k.launches for k in kernels]
        # ---------------------------------------------------------------
        require(job["status"] == "STOPPED", f"train job {job['status']}: "
                f"{job.get('error_reason')}")
        trials = c.get_trials_of_train_job("sst2")
        require([t["status"] for t in trials] == ["COMPLETED"] * TRIALS,
                f"trials {[(t['status'], t['fault_detail']) for t in trials]}")
        steps = 0
        for t in trials:
            require(np.isfinite(t["score"]) and t["score"] > 0.5,
                    f"trial score {t['score']} not above chance")
            batch = t["knobs"]["batch_size"]
            steps += SST2_SIZES[0] // batch
            wall = t["datetime_stopped"] - t["datetime_started"]
            epochs = [m for m in c.get_trial_logs(t["id"])["metrics"]
                      if "epoch_time" in m]
            print(f"bert: trial {t['id'][:8]} COMPLETED: learning_rate "
                  f"{t['knobs']['learning_rate']:.3g}, batch_size {batch}, "
                  f"epoch loss {epochs[-1]['loss']:.4f} in "
                  f"{epochs[-1]['epoch_time']:.2f} s "
                  f"({SST2_SIZES[0] // batch} steps), test accuracy "
                  f"{t['score']:.4f}; {wall:.2f} s in the trial", flush=True)
        forwards = TRIALS * -(-SST2_SIZES[1] // EVAL_BATCH)
        expect = [DEPTH * forwards] + [DEPTH * steps] * 3
        print(f"bert: train job of {TRIALS} BERT-base trials (1 epoch, GP) "
              f"STOPPED in {job_s:.1f} s (Client.create_train_job to "
              f"STOPPED); {steps} steps, {forwards} evaluate forwards; "
              f"launches K1 {train_counts[0]}, K1-LSE {train_counts[1]}, "
              f"K2 {train_counts[2]}, K3 {train_counts[3]} (expected "
              f"{expect}); card {card}", flush=True)
        require(train_counts == expect,
                f"launches {train_counts}, expected {expect}")
        blobs = [load_params(c.download_trial_params(t["id"]))
                 for t in trials]
        token = admin.authenticate_user(config.SUPERADMIN_EMAIL,
                                        config.SUPERADMIN_PASSWORD)["token"]
        url = f"http://127.0.0.1:{server.port}/predict/sst2"
        bodies = {n: (json.dumps({"queries": queries[:n]}).encode(),
                      {"Content-Type": "application/json"})
                  for n in set(TEXT_TIMED)}
        # ---- the main path's run (inference job): counts from zero ----
        for kernel in kernels:
            kernel.launches = 0
        t0 = time.perf_counter()
        inf = c.create_inference_job("sst2")
        deploy_s = time.perf_counter() - t0
        batch8 = np.asarray(c.predict("sst2", queries[:8]))
        lat = {}
        for n in TEXT_TIMED:
            t = time.perf_counter()
            post(url, *bodies[n], token=token)
            lat.setdefault(("json", n), []).append(time.perf_counter() - t)
        serve_counts = [k.launches for k in kernels]
        # ---------------------------------------------------------------
        stats = c.get_inference_job_stats("sst2")
        c.stop_inference_job("sst2")
    finally:
        server.stop()
        admin.shutdown()
    require(inf["status"] == "RUNNING" and len(inf["workers"]) == TRIALS,
            f"inference job {inf['status']} with {len(inf['workers'])} "
            "workers")
    forwards = stats["batches"] + PREDICT_BUCKETS * TRIALS
    expect = [DEPTH * forwards, 0, 0, 0]
    require(serve_counts == expect,
            f"serving launches {serve_counts}, expected {expect}")
    p50 = p50_ms(lat)
    print(f"bert: inference job RUNNING in {deploy_s:.1f} s ({TRIALS} "
          f"workers on {[w['chips'] for w in inf['workers']]}); p50 of "
          f"/predict/sst2 (JSON, admin door, sequential): "
          + ", ".join(f"{n} sentence{'s' if n > 1 else ''} "
                      f"{p50['json', n]:.2f} ms" for n in (1, 64))
          + f"; K1 launched {serve_counts[0]} times in {forwards} bucketed "
          f"forwards ({DEPTH} a forward); card {card}", flush=True)

    # the served answers against each trial's own predict on the card and
    # against the plain-attention forward of the same parameters
    clazz = load_model_class(source.encode(), "TorchBertBase")
    own, plain = [], []
    for t, blob in zip(trials, blobs):
        m = clazz(**t["knobs"])
        m.load_parameters(blob)
        own.append(np.asarray(m.predict(queries[:8]), np.float64))
        plain_cfg = dataclasses.replace(m._cfg, encoder=dataclasses.replace(
            m._cfg.encoder, use_flash=False))
        m._model = convert.from_jax_params(blob["params"], plain_cfg,
                                           "cuda:0")
        plain.append(np.asarray(m.predict(queries[:8]), np.float64))
        del m
    require(batch8.shape == (8, 2) and np.isfinite(batch8).all(),
            f"/predict/sst2 answered {batch8.shape}")
    err = float(np.abs(batch8 - sum(own) / TRIALS).max())
    require(err <= ENSEMBLE_ATOL, f"ensemble off its trials' mean by "
            f"{err:.3g} (tol {ENSEMBLE_ATOL:g})")
    print(f"bert: Client.predict of 8 sentences: the ensemble within "
          f"{err:.3g} of its trials' mean (tol {ENSEMBLE_ATOL:g}); against "
          f"the plain-attention forward: "
          + prob_check("bert /predict/sst2", batch8, sum(plain) / TRIALS),
          flush=True)

    # one train step through the kernels against plain attention from the
    # initial weights, in f32 and in bf16 (text_step_gates); then the
    # step's time at batch 32
    cfg = clazz(**trials[0]["knobs"])._make_cfg(2)
    x, y = clazz(**trials[0]["knobs"])._load(train_uri)
    tree = bert.init(np.random.default_rng(0), cfg)
    loss_fn = softmax_classifier_loss(lambda m, ids: m(ids))
    batch = (torch.from_numpy(x[:32]).cuda(), torch.from_numpy(y[:32]).cuda())

    def loss_of(model, dtype):
        return torch.nn.functional.cross_entropy(
            model(batch[0], dtype), batch[1].long())

    text_step_gates("bert: one step at batch 32 (S=128)", cfg, tree, loss_of)
    trainer = DataParallelTrainer(loss_fn, tunable_optimizer(
        torch.optim.AdamW, lr=1e-4, weight_decay=1e-4))
    model, opt = trainer.init(lambda rng: convert.from_jax_params(
        tree, cfg, "cuda:0", train=True))
    step = lambda: trainer.train_step(model, opt, batch)  # noqa: E731
    call_ms = median_ms(step, reps=10)
    card_ms = device_ms(step, reps=3, inner=3, hold_cycles=400_000_000)
    print(f"bert: BERT-base train step at batch 32 x 128 tokens: "
          f"{call_ms:.2f} ms per call, {card_ms:.2f} ms on the card "
          f"({32 * 128 / card_ms * 1e3:.0f} tokens/s); card {card}",
          flush=True)
    print_device_profile(step, "batch-32 BERT-base train step", shares=(
        ("K1-LSE", "flash_fwd_wgmma_kernel"),
        ("K2", "flash_bwd_dq_wgmma_kernel"),
        ("K3", "flash_bwd_dkv_wgmma_kernel")))
    del model, opt
    return [a + b for a, b in zip(train_counts, serve_counts)]


def lm_prompts(rng: np.random.Generator, vocab: int) -> list:
    """STREAMS prompts of PROMPT_TOKENS tokens from the sequence the LM
    was trained on (``_pattern_batch``: token (3 b + 2) mod vocab at
    position b); the first half start at its beginning, so they share a
    SHARED_PREFIX-token prefix, the others at random offsets."""
    out = []
    for i in range(STREAMS):
        n = int(rng.integers(PROMPT_TOKENS[0], PROMPT_TOKENS[1] + 1))
        if i < STREAMS // 2:
            start, n = 0, max(n, SHARED_PREFIX + 1)
        else:
            start = int(rng.integers(SHARED_PREFIX, 4096 - n - GEN_TOKENS))
        out.append(((3 * np.arange(start, start + n) + 2) % vocab).tolist())
    return out


def generate_pass(c, app: str, prompts: list, **kw) -> dict:
    """STREAMS concurrent ``Client.generate`` streams of GEN_TOKENS
    tokens; returns the streams, each one's time to first token, and the
    pass's seconds. ``kw`` rides every request; a ``seeds`` list gives
    each stream its own seed."""
    seeds = kw.pop("seeds", None)
    out = {"tokens": [None] * len(prompts), "ttft": [None] * len(prompts)}
    errors = []

    def run(i):
        try:
            extra = dict(kw, seed=seeds[i]) if seeds else kw
            t0 = time.perf_counter()
            toks = []
            for d in c.generate(app, prompts[i], max_tokens=GEN_TOKENS,
                                timeout_s=300, **extra):
                if not toks and d["tokens"]:
                    out["ttft"][i] = time.perf_counter() - t0
                toks += d["tokens"]
            out["tokens"][i] = toks
        except Exception as e:  # noqa: BLE001 - reported by the caller
            errors.append(f"stream {i}: {e!r}")

    t0 = time.perf_counter()
    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(prompts))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(600)
    out["seconds"] = time.perf_counter() - t0
    require(not errors and not any(th.is_alive() for th in threads),
            f"generation pass failed: {errors}")
    require(all(len(t) == GEN_TOKENS for t in out["tokens"]),
            f"streams of {[len(t) for t in out['tokens']]} tokens")
    return out


def serve_lm(new_client, app: str, env: dict, passes):
    """Deploy ``app`` with ``env`` set, run ``passes(c)`` on a fresh
    client (a client caches the door it resolved, and each deployment has
    its own), read the worker's stats once its slots are empty, stop the
    job. Returns (passes' result, stats, deploy seconds)."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    c = new_client()
    try:
        t0 = time.perf_counter()
        inf = c.create_inference_job(app)
        deploy_s = time.perf_counter() - t0
        require(inf["status"] == "RUNNING" and len(inf["workers"]) == 1
                and inf["predictor_port"], f"inference job {inf}")
        result = passes(c)
        deadline = time.monotonic() + 30
        while True:
            stats = c.get_inference_job_stats(app)["workers"][0]
            if stats.get("gen_resident_streams", 1) == 0 \
                    or time.monotonic() > deadline:
                break
            time.sleep(0.1)
        c.stop_inference_job(app)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return result, stats, deploy_s


def lm_reference(model, prompts: list, streams: list):
    """Each stream's f32 plain-attention reference, teacher-forced on the
    stream itself: (the logits that predict each generated token, the gap
    between their top two)."""
    out = []
    with torch.inference_mode():
        for p, s in zip(prompts, streams):
            ids = torch.tensor([p + s[:-1]], device=model.pos.device)
            logits = model(ids, dtype=torch.float32)[0, len(p) - 1:]
            top2 = logits.topk(2, dim=-1).values
            out.append((logits, (top2[:, 0] - top2[:, 1]).cpu().numpy()))
    return out


def compared_greedy(stream: list, ref) -> int:
    """Positions at which a greedy stream was held against its reference
    (up to the first whose top-2 gap is under TIE_GAP); raises at a
    mismatch before it."""
    logits, gaps = ref
    want = logits.argmax(-1).tolist()
    for i, (got, w) in enumerate(zip(stream, want)):
        if gaps[i] < TIE_GAP:
            return i
        require(got == w, f"greedy token {i} is {got}, the f32 reference's "
                f"argmax {w} (top-2 gap {gaps[i]:.3g})")
    return len(stream)


def compared_sampled(stream: list, ref, prompt: list, seed: int) -> int:
    """Positions at which a sampled stream was held against the draw from
    its f32 reference distribution under the same key (up to the first
    whose uniform lies within DRAW_MARGIN of a cumulative boundary)."""
    from rafiki_tpu_torch.models import lm

    logits, _ = ref
    n = len(stream)
    probs = lm.modified_dist(logits, np.full(n, SAMPLING["temperature"]),
                             np.zeros(n, np.int64),
                             np.full(n, SAMPLING["top_p"]))
    positions = len(prompt) + np.arange(n)
    u = lm._uniform_at(np.full(n, seed, np.uint32), positions,
                       lm.ROLE_TARGET)
    u = torch.from_numpy(u).to(probs.device)
    want = lm.sample_from(probs, u).tolist()
    margin = (probs.cumsum(-1) - u[:, None]).abs()
    margin = margin.min(-1).values.cpu().numpy()
    for i, (got, w) in enumerate(zip(stream, want)):
        if margin[i] < DRAW_MARGIN:
            return i
        require(got == w, f"sampled token {i} is {got}, the reference's "
                f"draw {w} (margin {margin[i]:.3g})")
    return n


def same_until(a: list, b: list, upto: int, what: str) -> None:
    require(a[:upto] == b[:upto], f"{what} differ in their first {upto} "
            "tokens")


def lm_phase(card: str) -> list:
    """8b: the LM at full width trained through ``Client`` under
    ``TEXT_GENERATION``, then served on its own door: greedy, binary,
    sampled, ring and preempted passes of 8 concurrent streams. Returns
    each kernel's launches on this path."""
    from rafiki_tpu_torch import convert
    from rafiki_tpu_torch.models import lm
    from rafiki_tpu_torch.sdk.model import load_model_class
    from rafiki_tpu_torch.sdk.params import load_params
    from rafiki_tpu_torch.templates.torch_gen_lm import _pattern_batch

    source = (TEMPLATES / "torch_gen_lm.py").read_text() + LM_FULL
    admin, server, new_client = _stack("lm", "text_lm.sqlite3")
    kernels = _kernels()
    try:
        c = new_client()
        model = c.create_model("lm", "TEXT_GENERATION", source.encode(),
                               "TorchGenLMFull")
        require(model["verification"] is not None
                and model["verification"]["ok"]
                and model["verification"]["capabilities"]["generation"],
                f"TorchGenLMFull upload: {model['verification']}")
        # ---- the main path's run (train job): counts from zero ----
        for kernel in kernels:
            kernel.launches = 0
        t0 = time.perf_counter()
        c.create_train_job("lm", "TEXT_GENERATION", "pattern://train",
                           "pattern://test",
                           budget={"MODEL_TRIAL_COUNT": 1, "CHIP_COUNT": 1})
        job = c.wait_until_train_job_stopped("lm", timeout_s=900,
                                             poll_s=0.05)
        torch.cuda.synchronize()
        job_s = time.perf_counter() - t0
        train_counts = [k.launches for k in kernels]
        # ---------------------------------------------------------------
        require(job["status"] == "STOPPED", f"train job {job['status']}: "
                f"{job.get('error_reason')}")
        (trial,) = c.get_trials_of_train_job("lm")
        require(trial["status"] == "COMPLETED"
                and np.isfinite(trial["score"]),
                f"trial {trial['status']} {trial['score']}")
        expect = [DEPTH] + [DEPTH * LM_STEPS] * 3
        print(f"lm: train job (1 trial, {LM_STEPS} Adam steps on (8, 512), "
              f"causal) STOPPED in {job_s:.1f} s; loss after training "
              f"{-trial['score']:.4f}; launches K1 {train_counts[0]}, "
              f"K1-LSE {train_counts[1]}, K2 {train_counts[2]}, K3 "
              f"{train_counts[3]} (expected {expect}); card {card}",
              flush=True)
        require(train_counts == expect,
                f"launches {train_counts}, expected {expect}")
        blob = load_params(c.download_trial_params(trial["id"]))
        clazz = load_model_class(source.encode(), "TorchGenLMFull")
        cfg = clazz(**trial["knobs"])._cfg
        batch = tuple(torch.from_numpy(a).cuda() for a in _pattern_batch(
            *clazz.training[:2], cfg.vocab))
        tree = lm.init(np.random.default_rng(0), cfg)

        def loss_of(model, dtype):
            return torch.nn.functional.cross_entropy(
                model(batch[0], dtype)[:, :-1].flatten(0, 1),
                batch[0][:, 1:].flatten().long())

        text_step_gates("lm: one step at (8, 512), causal", cfg, tree,
                        loss_of)
        del tree
        prompts = lm_prompts(np.random.default_rng(SEED + 81), cfg.vocab)
        seeds = list(range(1, STREAMS + 1))

        # ---- the main path's run (serving): counts from zero ----
        for kernel in kernels:
            kernel.launches = 0
        door = {"RAFIKI_PREDICTOR_PORTS": "1"}

        def paged_passes(c):
            return {"greedy": generate_pass(c, "lm", prompts),
                    "binary": generate_pass(c, "lm", prompts, binary=True),
                    "sampled": generate_pass(c, "lm", prompts, seeds=seeds,
                                             **SAMPLING),
                    "sampled again": generate_pass(c, "lm", prompts,
                                                   seeds=seeds, **SAMPLING)}

        paged, paged_stats, deploy_s = serve_lm(new_client, "lm", door,
                                                paged_passes)
        ring, ring_stats, _ = serve_lm(
            new_client, "lm", {**door, "RAFIKI_GEN_KV_PAGED": "0"},
            lambda c: generate_pass(c, "lm", prompts))
        small, small_stats, _ = serve_lm(
            new_client, "lm", {**door, "RAFIKI_GEN_KV_POOL_BLOCKS":
                      str(SMALL_POOL_BLOCKS)},
            lambda c: generate_pass(c, "lm", prompts, seeds=seeds,
                                    **SAMPLING))
        serve_counts = [k.launches for k in kernels]
        # ---------------------------------------------------------------
    finally:
        server.stop()
        admin.shutdown()
    require(serve_counts == [0, 0, 0, 0], f"attention kernels launched "
            f"while serving generation: {serve_counts}")

    greedy = paged["greedy"]
    ttft = sorted(greedy["ttft"])
    print(f"lm: {STREAMS} concurrent Client.generate streams of "
          f"{GEN_TOKENS} tokens, prompts {sorted(len(p) for p in prompts)} "
          f"tokens ({STREAMS // 2} sharing a {SHARED_PREFIX}-token prefix), "
          f"paged KV (deploy {deploy_s:.1f} s): time to first token p50 "
          f"{statistics.median(ttft) * 1e3:.1f} ms, p95 "
          f"{np.percentile(ttft, 95) * 1e3:.1f} ms; "
          f"{STREAMS * GEN_TOKENS / greedy['seconds']:.0f} tokens/s in all "
          f"({greedy['seconds']:.2f} s the pass; sampled "
          f"{STREAMS * GEN_TOKENS / paged['sampled']['seconds']:.0f}, ring "
          f"{STREAMS * GEN_TOKENS / ring['seconds']:.0f}, small pool "
          f"{STREAMS * GEN_TOKENS / small['seconds']:.0f}); card {card}",
          flush=True)
    for name, stats in (("paged", paged_stats), ("ring", ring_stats),
                        ("small pool", small_stats)):
        print(f"lm: {name} worker stats: " + ", ".join(
            f"{k[4:]} {v}" for k, v in sorted(stats.items())
            if k.startswith("gen_") and k != "gen_job"), flush=True)
        require(stats["gen_slots_busy"] == 0
                and stats["gen_resident_streams"] == 0,
                f"{name}: slots left after the streams: {stats}")
        if name != "ring":
            require(stats["gen_kv_blocks_used"]
                    == stats["gen_kv_blocks_cached"],
                    f"{name}: pages left after the streams (only the prefix "
                    f"cache may hold any): {stats}")
    require(paged_stats["gen_prefix_hits"] > 0, "no prefix-cache hit")
    require(small_stats["gen_preemptions"] > 0,
            f"a pool of {SMALL_POOL_BLOCKS} blocks preempted no stream")

    # the streams against the f32 plain-attention forward on the card
    ref_cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
        cfg.encoder, use_flash=False))
    ref_model = convert.from_jax_params(blob, ref_cfg, "cuda:0")
    refs = lm_reference(ref_model, prompts, greedy["tokens"])
    held = [compared_greedy(s, r) for s, r in zip(greedy["tokens"], refs)]
    for other, label in ((paged["binary"]["tokens"], "binary (v3) and JSON"),
                         (ring["tokens"], "ring and paged")):
        for a, b, n in zip(greedy["tokens"], other, held):
            same_until(a, b, n, f"{label} greedy streams")
    srefs = lm_reference(ref_model, prompts, paged["sampled"]["tokens"])
    sheld = [compared_sampled(s, r, p, seed) for s, r, p, seed in zip(
        paged["sampled"]["tokens"], srefs, prompts, seeds)]
    for other, label in ((paged["sampled again"]["tokens"], "two runs'"),
                         (small["tokens"], "preempted and uncontended")):
        for a, b, n in zip(paged["sampled"]["tokens"], other, sheld):
            same_until(a, b, n, f"{label} sampled streams")
    print(f"lm: greedy streams equal the f32 plain-attention argmax for "
          f"{sum(held)} of {STREAMS * GEN_TOKENS} tokens (each stream up to "
          f"its first top-2 gap under {TIE_GAP:g}: {held}), and so do the "
          f"binary and ring streams; sampled streams (temperature "
          f"{SAMPLING['temperature']}, top_p {SAMPLING['top_p']}, seeds "
          f"{seeds}) equal the reference's draws for {sum(sheld)} tokens "
          f"({sheld}), twice and under preemption "
          f"({small_stats['gen_preemptions']} preemptions)", flush=True)
    del ref_model

    # the decode step alone: per call, its kernels, the pool's bytes
    m = clazz(**trial["knobs"])
    m.load_parameters(blob)
    bt, pos = 16, 575
    per_slot = -(-cfg.max_len // bt)
    cache = m.init_paged_kv_cache(STREAMS * per_slot, bt)
    tables = np.arange(STREAMS * per_slot, dtype=np.int32).reshape(
        STREAMS, per_slot)
    ids = np.arange(STREAMS, dtype=np.int32)
    positions = np.full(STREAMS, pos, np.int32)
    step = lambda: m.paged_decode_step(cache, ids, positions,  # noqa: E731
                                       tables)
    call_ms = median_ms(step, reps=20)
    ring_cache = m.init_kv_cache(STREAMS)
    ring_step = lambda: m.decode_step(ring_cache, ids,  # noqa: E731
                                      positions)
    ring_ms = median_ms(ring_step, reps=20)
    weights = sum(p.numel() * p.element_size()
                  for p in m._model.parameters())
    print(f"lm: decode step of {STREAMS} slots at position {pos}: paged "
          f"{call_ms:.2f} ms per call (argmax to the host included), ring "
          f"{ring_ms:.2f} ms; KV pool {lm.paged_pool_bytes(cache) / 1e9:.3f}"
          f" GB ({STREAMS * per_slot} blocks x {bt} tokens), ring "
          f"{lm.paged_pool_bytes(ring_cache) / 1e9:.3f} GB; weights "
          f"{weights / 1e9:.3f} GB f32 (bound "
          f"{weights / HBM_BYTES_PER_S * 1e3:.3f} ms a step); card {card}",
          flush=True)
    print_device_profile(step, "paged decode step (8 slots)", top=6)
    print_device_profile(ring_step, "ring decode step (8 slots)", top=4)
    del m, cache, ring_cache
    return [a + b for a, b in zip(train_counts, serve_counts)]


def text_phase(card: str) -> tuple:
    t0 = time.perf_counter()
    bert_counts = bert_phase(card)
    lm_counts = lm_phase(card)
    print(f"text: phase 8 took {time.perf_counter() - t0:.0f} s", flush=True)
    return bert_counts, lm_counts


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
    zoo_launches = zoo_phase(card)
    bert_launches, lm_launches = text_phase(card)
    for i, name in enumerate(KERNEL_NAMES):
        by_path = {"train (phase 3)": train_launches[i],
                   "serve (phase 4)": serve_launches[i],
                   "stack (phase 5)": stack_launches[i],
                   "process (phase 6)": process_launches[i],
                   "zoo (phase 7)": zoo_launches[i],
                   "bert (phase 8a)": bert_launches[i],
                   "lm (phase 8b)": lm_launches[i]}
        require(by_path["stack (phase 5)"] > 0,
                f"{name} was not launched through the admin")
        require(by_path["process (phase 6)"] > 0,
                f"{name} was not launched in a child process")
        require(by_path["bert (phase 8a)"] > 0,
                f"{name} was not launched on the BERT path")
        require(by_path["lm (phase 8b)"] > 0,
                f"{name} was not launched on the LM path")
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
