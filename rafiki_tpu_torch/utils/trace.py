"""Tracing and profiling: spans for the control plane, torch.profiler
captures for the card.

Own copy of ``rafiki_tpu/utils/trace.py``:

- **Spans**: wall-clock spans with nesting (a depth per tracer and
  thread), collected per trial by a :class:`Tracer` and saved as JSON
  lines under ``LOGS_DIR``. The train worker wraps each trial phase
  (``propose``, ``train``, ``evaluate``, ``persist_params``); the admin
  serves the trace back (``GET /trials/<id>/trace``).
- **Request traces**: a :class:`TraceContext` (trace id and sampling bit,
  rate ``RAFIKI_TRACE_SAMPLE``) enters at the predictor door as the
  ``X-Rafiki-Trace`` header and rides queue entries, the wire frame's
  version-2 header (``cache/wire.py``) and the fleet relay into the
  inference worker and back, so one sampled predict yields one span tree:
  admission wait, queue wait, codec decode, batch assembly, model
  forward, codec encode, respond. :class:`RequestTrace` records on the
  monotonic clock, which the workers of one host share, and imports and
  exports spans that crossed a hop. Sampled requests at least
  ``RAFIKI_TRACE_SLOW_MS`` slow are appended as JSON-lines exemplars to a
  size-rotated file under ``LOGS_DIR`` (:func:`record_exemplar`).
- **Device profiles**: :func:`torch_profile` wraps ``torch.profiler`` and
  writes a Chrome trace under ``LOGS_DIR/profiles`` (with the CUDA
  activity when the calling thread's grant is a card, so the hand-written
  kernels appear by name with their device times). It is a no-op unless
  ``RAFIKI_PROFILE`` is set. JAX's ``jax_profile`` writes an xplane
  directory instead.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional

from rafiki_tpu_torch import config

logger = logging.getLogger(__name__)


@dataclass
class Span:
    name: str
    start: float
    end: float = 0.0
    depth: int = 0
    attrs: Dict[str, Any] = field(default_factory=dict)

    @property
    def duration_s(self) -> float:
        return max(self.end - self.start, 0.0)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "start": self.start,
            "end": self.end,
            "duration_s": round(self.duration_s, 6),
            "depth": self.depth,
            **({"attrs": self.attrs} if self.attrs else {}),
        }


class Tracer:
    """Collects spans for one unit of work (a trial, a predict call...).

    Thread-safe for concurrent span entry from worker threads; nesting depth
    is tracked per thread.
    """

    def __init__(self, trace_id: str):
        self.trace_id = trace_id
        self.spans: List[Span] = []
        self._lock = threading.Lock()
        # depth per (tracer, thread) — a module-global thread-local would
        # interleave depths of two tracers active on one thread (e.g. a
        # predict-call tracer inside a trial tracer)
        self._depth: Dict[int, int] = {}

    @contextlib.contextmanager
    def span(self, name: str, **attrs: Any) -> Iterator[Span]:
        tid = threading.get_ident()
        with self._lock:
            depth = self._depth.get(tid, 0)
            self._depth[tid] = depth + 1
        s = Span(name=name, start=time.time(), depth=depth, attrs=attrs)
        try:
            yield s
        finally:
            s.end = time.time()
            with self._lock:
                if depth == 0:
                    self._depth.pop(tid, None)
                else:
                    self._depth[tid] = depth
                self.spans.append(s)

    def summary(self) -> Dict[str, float]:
        """name -> total seconds (top-level occurrences summed)."""
        out: Dict[str, float] = {}
        with self._lock:
            for s in self.spans:
                out[s.name] = out.get(s.name, 0.0) + s.duration_s
        return out

    def save(self, path: Optional[str] = None) -> str:
        path = path or trace_path(self.trace_id)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with self._lock:
            ordered = sorted(self.spans, key=lambda s: s.start)
            with open(path, "w") as f:
                for s in ordered:
                    f.write(json.dumps(s.to_dict()) + "\n")
        return path


def trace_path(trace_id: str) -> str:
    return os.path.join(config.LOGS_DIR, f"trace-{trace_id}.jsonl")


def load_trace(trace_id: str) -> List[Dict[str, Any]]:
    """Read back a saved trace; [] if none was recorded."""
    path = trace_path(trace_id)
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


# ---------------------------------------------------------------------------
# Request tracing (serving plane)

#: HTTP header carrying the trace context across doors/hops:
#: ``<hex trace id>;s=<0|1>`` (s is the sampling bit — a front door that
#: already decided to sample forces every hop behind it to record)
TRACE_HEADER = "X-Rafiki-Trace"


def sample_rate() -> float:
    """RAFIKI_TRACE_SAMPLE in [0, 1]; 0 (default) disables door-side
    sampling entirely. Malformed values read as 0."""
    raw = os.environ.get("RAFIKI_TRACE_SAMPLE", "")
    if not raw:
        return 0.0
    try:
        return min(max(float(raw), 0.0), 1.0)
    except ValueError:
        return 0.0


def slow_threshold_s() -> float:
    """RAFIKI_TRACE_SLOW_MS: sampled requests at least this slow are
    dumped as JSON-lines exemplars (0 = every sampled request)."""
    try:
        return max(
            float(os.environ.get("RAFIKI_TRACE_SLOW_MS", "0")), 0.0) / 1000.0
    except ValueError:
        return 0.0


def exemplar_max_mb() -> float:
    try:
        return max(
            float(os.environ.get("RAFIKI_TRACE_EXEMPLAR_MAX_MB", "64")), 1.0)
    except ValueError:
        return 64.0


def exemplar_path() -> str:
    return os.path.join(config.LOGS_DIR, "predict_exemplars.jsonl")


class TraceContext:
    """The propagated part of a trace: id + sampling decision. Small and
    serializable — this is what crosses HTTP headers, queue entries, and
    wire frame metadata; the span collection stays in :class:`RequestTrace`
    at whichever hop records."""

    __slots__ = ("trace_id", "sampled")

    def __init__(self, trace_id: str, sampled: bool = True) -> None:
        self.trace_id = trace_id
        self.sampled = bool(sampled)

    def to_header(self) -> str:
        return f"{self.trace_id};s={1 if self.sampled else 0}"

    @classmethod
    def from_header(cls, value: Optional[str]) -> Optional["TraceContext"]:
        """Parse the X-Rafiki-Trace header; None for absent/garbled input
        (a malformed header from an untrusted client must never 500 a
        predict)."""
        if not value:
            return None
        parts = value.strip().split(";")
        tid = parts[0].strip()
        if not tid or len(tid) > 64 or not tid.isalnum():
            return None
        sampled = True
        for p in parts[1:]:
            k, _, v = p.strip().partition("=")
            if k == "s":
                sampled = v.strip() == "1"
        return cls(tid, sampled)

    def to_wire(self) -> Dict[str, Any]:
        return {"id": self.trace_id, "s": 1 if self.sampled else 0}

    @classmethod
    def from_wire(cls, meta: Any) -> Optional["TraceContext"]:
        if not isinstance(meta, dict) or not isinstance(meta.get("id"), str):
            return None
        return cls(meta["id"], bool(meta.get("s", 1)))


class RequestTrace(Tracer):
    """Span collector for ONE predict request, rooted at the serving
    door. Extends :class:`Tracer` (same Span/save machinery the trial
    path uses) with direct interval recording on the MONOTONIC clock —
    worker processes on the same host share CLOCK_MONOTONIC, so spans
    recorded worker-side line up with the door's without clock math —
    and with wire import/export for spans that crossed a hop as
    ``[name, offset_s, duration_s]`` triples."""

    def __init__(self, ctx: TraceContext) -> None:
        super().__init__(ctx.trace_id)
        self.ctx = ctx
        self.t0 = time.monotonic()
        #: set by the queue layer at submit time; the anchor worker-side
        #: queue_wait spans and returned wire spans are measured against
        self.t_submit: Optional[float] = None
        self._dequeued = False

    def add_span(self, name: str, start: float, end: float,
                 depth: int = 0, **attrs: Any) -> None:
        s = Span(name=name, start=start, end=max(end, start), depth=depth,
                 attrs=attrs)
        with self._lock:
            self.spans.append(s)

    def mark_submitted(self) -> None:
        if self.t_submit is None:
            self.t_submit = time.monotonic()

    def mark_dequeued(self, now: Optional[float] = None) -> None:
        """Record the queue_wait span once (a request's entries share one
        trace; the first dequeued entry closes the wait)."""
        with self._lock:
            if self._dequeued:
                return
            self._dequeued = True
        start = self.t_submit if self.t_submit is not None else self.t0
        self.add_span("queue_wait", start, now or time.monotonic(), depth=1)

    def add_wire_spans(self, spans: Any,
                       anchor: Optional[float] = None) -> None:
        """Import spans that crossed a hop as [name, offset_s, duration_s]
        triples, re-anchored at this trace's submit time. Garbled input is
        dropped silently — trace metadata is best-effort decoration, never
        worth failing a served request over."""
        if anchor is None:
            anchor = self.t_submit if self.t_submit is not None else self.t0
        if not isinstance(spans, list):
            return
        for entry in spans:
            try:
                name, off, dur = entry
                self.add_span(str(name)[:64], anchor + float(off),
                              anchor + float(off) + float(dur), depth=1)
            except (TypeError, ValueError):
                continue

    def wire_spans(self, anchor: float) -> List[List[Any]]:
        """Export spans as [name, offset_s, duration_s] relative to
        ``anchor`` — the hop-crossing format of :meth:`add_wire_spans`."""
        with self._lock:
            return [[s.name, round(s.start - anchor, 6),
                     round(s.duration_s, 6)] for s in self.spans]

    def phase_durations(self) -> Dict[str, float]:
        """name -> seconds for the latency histograms. Per name this is
        the MAX single span, not the sum: a multi-trial ensemble records
        one same-named span set per trial and the trials run in
        PARALLEL — summing would report a 3-trial 10 ms forward as one
        30 ms sample, exceeding the request's own wall time. Max is the
        per-phase critical path; for single-trial requests max == sum.
        The exemplar keeps every span, so per-trial detail is not lost."""
        out: Dict[str, float] = {}
        with self._lock:
            for s in self.spans:
                out[s.name] = max(out.get(s.name, 0.0), s.duration_s)
        return out


def start_trace(header_value: Optional[str] = None
                ) -> Optional[RequestTrace]:
    """Door-side entry point: honor an incoming header's sampling bit, or
    make the sampling decision locally at RAFIKI_TRACE_SAMPLE. Returns a
    RequestTrace only when this request is sampled — the unsampled path
    costs one header read and (without a header) one random draw."""
    ctx = TraceContext.from_header(header_value)
    if ctx is None:
        rate = sample_rate()
        if rate <= 0.0:
            return None
        import random
        import uuid

        if random.random() >= rate:
            return None
        ctx = TraceContext(uuid.uuid4().hex, True)
    if not ctx.sampled:
        return None
    return RequestTrace(ctx)


_exemplar_lock = threading.Lock()


def record_exemplar(trace: RequestTrace, e2e_s: float, door: str) -> None:
    """Append one request's span tree as a JSON line to the exemplar
    file, size-rotating at RAFIKI_TRACE_EXEMPLAR_MAX_MB (one ``.1``
    generation: bounded growth). Best-effort: disk
    trouble must never fail a served request."""
    try:
        path = exemplar_path()
        os.makedirs(os.path.dirname(path), exist_ok=True)
        anchor = trace.t0
        line = json.dumps({
            "trace_id": trace.trace_id,
            "ts": round(time.time(), 3),
            "door": door,
            "e2e_s": round(e2e_s, 6),
            "spans": [
                {"name": s.name, "offset_s": round(s.start - anchor, 6),
                 "duration_s": round(s.duration_s, 6),
                 **({"attrs": s.attrs} if s.attrs else {})}
                for s in sorted(trace.spans, key=lambda s: s.start)
            ],
        })
        cap_bytes = int(exemplar_max_mb() * (1 << 20))
        with _exemplar_lock:
            try:
                if os.path.getsize(path) >= cap_bytes:
                    os.replace(path, path + ".1")
            except OSError:
                pass
            with open(path, "a") as f:
                f.write(line + "\n")
    except Exception:
        logger.debug("exemplar write failed", exc_info=True)


# ---------------------------------------------------------------------------
# Device profiling

def profiling_enabled() -> bool:
    return os.environ.get("RAFIKI_PROFILE", "") not in ("", "0", "false")


def profile_dir() -> str:
    return os.path.join(config.LOGS_DIR, "profiles")


def _grant_is_a_card() -> bool:
    import torch

    from rafiki_tpu_torch.device import visible_devices

    return (torch.cuda.is_available()
            and any(d.type == "cuda" for d in visible_devices()))


@contextlib.contextmanager
def torch_profile(name: str = "profile", out_dir: Optional[str] = None,
                  force: bool = False) -> Iterator[Optional[str]]:
    """Capture a ``torch.profiler`` trace of the body and write it as a
    Chrome trace, ``<out_dir>/<name>-<pid>.json`` (``out_dir`` defaults
    to ``LOGS_DIR/profiles``); yields that path, or None when off. CPU
    activity always, CUDA activity when the calling thread's grant is a
    card. No-op unless ``RAFIKI_PROFILE`` is set (or ``force``): a
    capture costs time and its file is large. A profiler that fails to
    start or to write is logged, never raised into the body's work."""
    if not (force or profiling_enabled()):
        yield None
        return
    out_dir = out_dir or profile_dir()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{name}-{os.getpid()}.json")
    prof = None
    try:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if _grant_is_a_card():
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.__enter__()
    except Exception:  # another capture running, or no profiler support
        logger.exception("torch profiler failed to start")
        prof = None
    try:
        yield path if prof is not None else None
    finally:
        if prof is not None:
            try:
                prof.__exit__(None, None, None)
                prof.export_chrome_trace(path)
                logger.info("profile written: %s", path)
            except Exception:
                logger.exception("torch profiler failed to stop or write")
