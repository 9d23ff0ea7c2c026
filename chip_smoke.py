"""Chip smoke test of the rafiki_tpu_torch port on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):

1. header: the card (nvidia-smi name and power limit), the torch and CUDA
   versions, the kernel build (nvcc, sm_90a, from
   ``rafiki_tpu_torch/ops/csrc/``, into ``build/rafiki_tpu_torch/``) and
   its ptxas register/shared-memory report;
2. kernels: each kernel against its plain PyTorch version on the same
   seeded inputs, at the serving path's shapes and at edge cases, with
   device times (CUDA events around queued back-to-back calls) beside the
   bound and PyTorch's own call for the same function;
3. slice: two full-width ViT-B/16 trials (seeded random weights in the
   JAX layout, carried across by ``convert.py``) served through
   ``InferenceWorker`` -> ``Predictor`` -> ``PredictorServer``; ``POST
   /predict`` answers are checked against the two models' plain-attention
   forward on the card, and the kernel's launch count against the number
   of bucketed forwards; then where a request's time goes (one forward
   per call and on the card, and a kernel profile of the bucket-64
   forward).

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``. Exits non-zero without CUDA.
"""

from __future__ import annotations

import dataclasses
import io
import json
import re
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
SEED = 0
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}
DEPTH = 12  # ViT-B/16 blocks: one flash launch each per forward
# served probabilities vs the plain-attention forward: both run bf16
# through 12 blocks and differ where bf16 rounds (the kernel keeps PV in
# f32, mha_reference rounds p to bf16); stated as a bound on |dp|
PROB_ATOL = 1e-3


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


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


def print_device_profile(fn, label: str, top: int = 8) -> None:
    """Device time of one call of ``fn`` by kernel, from torch.profiler
    (CUPTI): the ``top`` kernels and their share of the call's total."""
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


def attention_bound(b, h, sq, skv, dh, causal, dtype):
    """(bound_ms, bound_by) for one flash forward: q, k, v read once and
    o written once over HBM bandwidth, against 4*Dh flops per visible
    (query, key) pair over the type's peak."""
    size = torch.tensor([], dtype=dtype).element_size()
    nbytes = (2 * b * h * sq * dh + 2 * b * h * skv * dh) * size
    if causal:
        i = np.arange(sq)[:, None]
        j = np.arange(skv)[None, :]
        pairs = int((j <= i + (skv - sq)).sum())
    else:
        pairs = sq * skv
    flops = 4 * b * h * pairs * dh
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


# ---------------------------------------------------------------------------
# phase 1: header and build
# ---------------------------------------------------------------------------

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
          f"({time.perf_counter() - t0:.1f} s wall, nvcc sm_90a, "
          f"sources {_build.CSRC.relative_to(REPO)}, "
          f"libraries {_build.BUILD_DIR.relative_to(REPO)})")
    log = _build.build_logs.get("flash_fwd", "")
    # the serving path's instantiation: bf16, Dh = 64, block_k = 64
    m = re.search(r"flash_fwd_bf16_kernelILi64ELi64EE.*?\n"
                  r".*?\n\s*(.*?spill loads)\n.*?(Used .*?)\n", log, re.S)
    print("ptxas K1 (bf16, Dh=64, block_k=64): "
          + (f"{m.group(2)}; {m.group(1)}" if m else
             "library was already built (no report)"))
    return card


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def kernel_phase():
    from rafiki_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def qkv(b, h, sq, skv, dh, dtype):
        return [torch.randn(b, h, s, dh, generator=gen, device="cuda")
                .to(dtype) for s in (sq, skv, skv)]

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
    entry, times = None, {}
    for label, b, h, sq, skv, dh, causal, dtype, bq, bk in cases:
        q, k, v = qkv(b, h, sq, skv, dh, dtype)
        out = flash_attention(q, k, v, causal, None, bq, bk)
        torch.cuda.synchronize()
        ref = flash_attention_plain(q, k, v, causal, None, bk)
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
            fn_kernel = lambda: flash_attention(q, k, v, causal, None, bq, bk)
            kernel_ms = times[b] = device_ms(fn_kernel)
            plain_ms = device_ms(
                lambda: flash_attention_plain(q, k, v, causal, None, bk))
            library_ms = device_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, is_causal=causal))
            bound_ms, bound_by = attention_bound(b, h, sq, skv, dh, causal,
                                                 dtype)
            line += (f"; kernel_ms {kernel_ms:.4f}, plain_ms {plain_ms:.4f}, "
                     f"library_ms (SDPA) {library_ms:.4f}, bound_ms "
                     f"{bound_ms:.4f} ({bound_by})")
            entry = {
                "name": "flash_fwd", "route": "cuda",
                "source": "rafiki_tpu_torch/ops/csrc/flash_fwd.cu",
                "replaces": "rafiki_tpu/ops/flash_attention.py:143",
                "shape": [b, h, sq, dh], "dtype": "bf16",
                "max_abs_err": err, "tolerance": tol,
                "ms": kernel_ms, "kernel_ms": kernel_ms,
                "plain_ms": plain_ms, "library_ms": library_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
            }
        print(line, flush=True)
    return entry, times


# ---------------------------------------------------------------------------
# phase 3: the serving slice
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


def post(url: str, body: bytes, headers: dict) -> np.ndarray:
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers=headers)
    with urllib.request.urlopen(req, timeout=120) as resp:
        require(resp.status == 200, f"POST /predict answered {resp.status}")
        data = resp.read()
        if resp.headers["Content-Type"] == NPY:
            return np.load(io.BytesIO(data), allow_pickle=False)
        return np.asarray(json.loads(data)["data"]["predictions"])


def slice_phase(card: str, kernel_ms: dict):
    from rafiki_tpu_torch import config, convert
    from rafiki_tpu_torch.cache.queue import InProcessBroker
    from rafiki_tpu_torch.db.store import TrialStore
    from rafiki_tpu_torch.device import ServiceContext
    from rafiki_tpu_torch.models import vit
    from rafiki_tpu_torch.ops.flash_attention import flash_attention
    from rafiki_tpu_torch.predictor.predictor import Predictor
    from rafiki_tpu_torch.predictor.server import PredictorServer
    from rafiki_tpu_torch.sdk.params import dump_params
    from rafiki_tpu_torch.sdk.torch_backend import DataParallelTrainer
    from rafiki_tpu_torch.templates.torch_vit import TorchViT
    from rafiki_tpu_torch.worker.inference import InferenceWorker

    cfg = vit.vit_b16()
    knobs = TorchViT.get_knob_config()
    template = (REPO / "rafiki_tpu_torch/templates/torch_vit.py").read_bytes()
    t0 = time.perf_counter()
    trees = {f"trial-{i}": vit.init(np.random.default_rng(SEED + 1 + i), cfg)
             for i in range(2)}
    store = TrialStore()
    for tid, tree in trees.items():
        store.add_trial(tid, template, "TorchViT", knobs, dump_params(tree))
    print(f"slice: 2 ViT-B/16 trials (224/16, 1000 classes, "
          f"{_count(trees['trial-0']) / 1e6:.1f} M params each) "
          f"made and stored in {time.perf_counter() - t0:.1f} s", flush=True)

    broker = InProcessBroker()
    job = "vit-b16-job"
    workers = {}
    launches_before_warm = flash_attention.launches
    t0 = time.perf_counter()
    for i, tid in enumerate(trees):
        ready, errors = threading.Event(), []
        ctx = ServiceContext(service_id=f"worker-{i}", chips=[0],
                             on_ready=ready.set)

        def run(w=InferenceWorker(job, tid, store, broker), c=ctx, e=errors):
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
        buckets = DataParallelTrainer(lambda x: x, "cpu").predict_buckets(cap)
        warm_launches = flash_attention.launches - launches_before_warm
        print(f"slice: 2 workers ready in {time.perf_counter() - t0:.1f} s; "
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
        flash_attention.launches = 0
        answers, lat = [], {1: [], cap: []}
        for kind, n in checked + timed:
            t = time.perf_counter()
            probs = post(url, *bodies[kind, n])
            dt = time.perf_counter() - t
            if len(answers) < len(checked):
                answers.append((kind, n, probs, dt))
            else:
                lat[n].append(dt)
        launches = flash_attention.launches
        # ---------------------------------------------------------------
        chunks = sum(-(-n // cap) for _, n in checked + timed)
        forwards = chunks * len(workers)
        print(f"slice: {len(checked) + len(timed)} POST /predict requests, "
              f"{forwards} bucketed forwards, {launches} K1 launches "
              f"(expected {DEPTH * forwards})", flush=True)
        require(launches == DEPTH * forwards,
                f"K1 launched {launches} times for {forwards} forwards")

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
        max_err = 0.0
        for kind, n, probs, dt in answers:
            require(probs.shape == (n, cfg.num_classes),
                    f"{kind} {n}: shape {probs.shape}")
            require(bool(np.isfinite(probs).all()), f"{kind} {n}: non-finite")
            sums = np.abs(probs.sum(-1) - 1).max()
            require(sums < 1e-4, f"{kind} {n}: rows sum off by {sums}")
            err = float(np.abs(probs - ref[:n]).max())
            max_err = max(max_err, err)
            require(err <= PROB_ATOL,
                    f"{kind} {n}: |p - p_plain| = {err} > {PROB_ATOL}")
            print(f"slice: {kind} request of {n}: shape {probs.shape}, rows "
                  f"sum to 1 within {sums:.2g}, max |p - p_plain| {err:.3g} "
                  f"(tol {PROB_ATOL:g}, max p {ref[:n].max():.3g}), "
                  f"{dt * 1e3:.1f} ms", flush=True)
        p50 = {n: statistics.median(v) for n, v in lat.items()}
        print(f"slice: p50 latency {p50[1] * 1e3:.2f} ms (1 image), "
              f"{p50[cap] * 1e3:.2f} ms ({cap} images, npy); "
              f"{cap * len(lat[cap]) / sum(lat[cap]):.1f} images/s at "
              f"{cap} per request, sequential; two trials ensembled; "
              f"card {card}", flush=True)

        # where a request's time goes: one trial's forward through the
        # served (kernel) path at each timed bucket; these launches come
        # after the main path's count was read
        model = convert.from_jax_params(trees["trial-0"], cfg, "cuda:0")
        with torch.inference_mode():
            for n, bucket in ((1, 8), (cap, cap)):
                x = torch.from_numpy(images[:bucket]).cuda()
                call_ms = median_ms(lambda: model(x), reps=10)
                card_ms = device_ms(lambda: model(x), reps=3, inner=3,
                                    hold_cycles=400_000_000)
                attn_ms = DEPTH * kernel_ms.get(bucket, float("nan"))
                print(f"slice: {n}-image request (bucket {bucket}): p50 "
                      f"{p50[n] * 1e3:.2f} ms; one trial's forward "
                      f"{call_ms:.3f} ms per call, {card_ms:.3f} ms of it "
                      f"on the card, of which K1 {attn_ms:.3f} ms ({DEPTH} "
                      f"x kernel_ms); the request less 2 forwards "
                      f"{p50[n] * 1e3 - 2 * call_ms:.2f} ms (host and "
                      f"transport)", flush=True)
            print_device_profile(lambda: model(x), f"bucket-{cap} forward")
        del model
        return launches, max_err
    finally:
        if server is not None:
            server.stop()
        for wid, (_, ctx, thread, _, _) in workers.items():
            ctx.stop_event.set()
            broker.unregister_worker(job, wid)
        for wid, (_, _, thread, _, _) in workers.items():
            thread.join(timeout=30)
            require(not thread.is_alive(), f"{wid} did not stop")


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
    card = header()
    entry, kernel_ms = kernel_phase()
    launches, _ = slice_phase(card, kernel_ms)
    entry["launches"] = launches
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
