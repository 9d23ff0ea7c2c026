"""The process-local metrics registry.

Own copy of the in-process part of ``rafiki_tpu/utils/metrics.py``:

- ``Counter``, ``Gauge`` and ``Histogram`` with labels, each child under
  a lock of its own (an increment on the serving path takes one small
  lock, never the registry's);
- fixed log-ladder histogram buckets (100 us to ~200 s, factor 2) and a
  bucket-resolution ``quantile``;
- ``Ring``: a bounded time series of about one slot a wall-clock second
  over ``ring_window_s()`` seconds (``RAFIKI_METRICS_RING_S``, 300), for
  the signals a control loop reads as a short series;
- ``REGISTRY``, the process's one registry, its JSON ``snapshot`` and its
  Prometheus text exposition (format 0.0.4, ``render``);
- ``serve_http``, the one ``GET /metrics`` answer of the three doors (the
  admin's, the host agent's and each inference job's), and
  ``parse_prometheus``, enough of a reader to check the text.

``RAFIKI_METRICS=0`` makes every write a no-op. Metric names are a
contract: they are JAX's, and ``tests/test_torch_observability.py`` holds
the published set.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

# the default buckets: 100 us to ~200 s, a factor of 2 apart
_DEFAULT_BUCKETS = tuple(1e-4 * (2.0 ** i) for i in range(22))


def metrics_enabled() -> bool:
    """``RAFIKI_METRICS=0`` turns every write into a no-op (read at each
    write, so a test may flip it)."""
    return os.environ.get("RAFIKI_METRICS", "1") not in ("0", "false")


def ring_window_s() -> int:
    try:
        return max(int(os.environ.get("RAFIKI_METRICS_RING_S", "300")), 10)
    except ValueError:
        return 300


def _escape_label(value: str) -> str:
    return (str(value).replace("\\", r"\\").replace('"', r"\"")
            .replace("\n", r"\n"))


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class _Child:
    """One (metric, label values) cell, under its own lock."""

    __slots__ = ("_lock", "_value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0  # guarded-by: _lock

    def value(self) -> float:
        with self._lock:
            return self._value


class _CounterChild(_Child):
    __slots__ = ()

    def inc(self, amount: float = 1.0) -> None:
        if not metrics_enabled():
            return
        with self._lock:
            self._value += amount


class _GaugeChild(_Child):
    __slots__ = ()

    def set(self, value: float) -> None:
        if not metrics_enabled():
            return
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        if not metrics_enabled():
            return
        with self._lock:
            self._value += amount


class _HistogramChild:
    __slots__ = ("_lock", "_buckets", "_counts", "_sum", "_count")

    def __init__(self, buckets: Tuple[float, ...]) -> None:
        self._lock = threading.Lock()
        self._buckets = buckets
        self._counts = [0] * (len(buckets) + 1)  # the last: +Inf
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        if not metrics_enabled():
            return
        v = float(value)
        if not math.isfinite(v):
            return
        idx = len(self._buckets)
        for i, b in enumerate(self._buckets):
            if v <= b:
                idx = i
                break
        with self._lock:
            self._counts[idx] += 1
            self._sum += v
            self._count += 1

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            counts = list(self._counts)
            total, s = self._count, self._sum
        cum, cum_counts = 0, []
        for c in counts:
            cum += c
            cum_counts.append(cum)
        return {
            "count": total,
            "sum": round(s, 9),
            "buckets": [[_fmt(b), cum_counts[i]]
                        for i, b in enumerate(self._buckets)]
                       + [["+Inf", cum_counts[-1]]],
        }

    def quantile(self, q: float) -> Optional[float]:
        """The upper bound of the bucket whose cumulative count first
        reaches rank ``q``; None before the first observation."""
        with self._lock:
            counts = list(self._counts)
            total = self._count
        if total <= 0:
            return None
        rank = q * total
        cum = 0.0
        for i, c in enumerate(counts):
            cum += c
            if cum >= rank:
                return (self._buckets[i] if i < len(self._buckets)
                        else self._buckets[-1] * 2)
        return self._buckets[-1] * 2

    def value(self) -> float:
        with self._lock:
            return float(self._count)


class _Metric:
    """A named family of children keyed by label values."""

    kind = "untyped"

    def __init__(self, name: str, help_text: str,
                 label_names: Sequence[str] = ()) -> None:
        self.name = name
        self.help = help_text
        self.label_names = tuple(label_names)
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], Any] = {}  # guarded-by: _lock

    def _make_child(self):
        raise NotImplementedError

    def labels(self, *values: Any):
        key = tuple(str(v) for v in values)
        if len(key) != len(self.label_names):
            raise ValueError(
                f"{self.name}: expected {len(self.label_names)} label "
                f"value(s) {self.label_names}, got {len(key)}")
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._make_child()
        return child

    def children(self) -> Dict[Tuple[str, ...], Any]:
        with self._lock:
            return dict(self._children)

    def _label_str(self, key: Tuple[str, ...]) -> str:
        if not key:
            return ""
        pairs = ",".join(f'{n}="{_escape_label(v)}"'
                         for n, v in zip(self.label_names, key))
        return "{" + pairs + "}"

    def render(self) -> List[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} {self.kind}"]
        for key, child in sorted(self.children().items()):
            lines.append(f"{self.name}{self._label_str(key)} "
                         f"{_fmt(child.value())}")
        return lines


class Counter(_Metric):
    kind = "counter"

    def _make_child(self) -> _CounterChild:
        return _CounterChild()

    def inc(self, amount: float = 1.0) -> None:
        self.labels().inc(amount)

    def value(self, *label_values: Any) -> float:
        return self.labels(*label_values).value()


class Gauge(_Metric):
    kind = "gauge"

    def _make_child(self) -> _GaugeChild:
        return _GaugeChild()

    def set(self, value: float) -> None:
        self.labels().set(value)

    def value(self, *label_values: Any) -> float:
        return self.labels(*label_values).value()


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, help_text: str,
                 label_names: Sequence[str] = (),
                 buckets: Optional[Sequence[float]] = None) -> None:
        super().__init__(name, help_text, label_names)
        self.buckets = tuple(sorted(buckets)) if buckets else _DEFAULT_BUCKETS

    def _make_child(self) -> _HistogramChild:
        return _HistogramChild(self.buckets)

    def observe(self, value: float) -> None:
        self.labels().observe(value)

    def render(self) -> List[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} histogram"]
        for key, child in sorted(self.children().items()):
            snap = child.snapshot()
            base = self._label_str(key)
            for le, cum in snap["buckets"]:
                lbl = (base[:-1] + f',le="{le}"' + "}" if base
                       else '{le="' + le + '"}')
                lines.append(f"{self.name}_bucket{lbl} {cum}")
            lines.append(f"{self.name}_sum{base} {_fmt(snap['sum'])}")
            lines.append(f"{self.name}_count{base} {snap['count']}")
        return lines


class Ring:
    """A bounded series of one slot a wall-clock second over
    ``ring_window_s()`` seconds: ``record`` keeps the last write of a
    second (levels, such as a depth), ``add`` sums a second's writes
    (rates, such as sheds)."""

    __slots__ = ("_lock", "_slots", "_t", "_v")

    def __init__(self, slots: Optional[int] = None) -> None:
        self._lock = threading.Lock()
        self._slots = slots or ring_window_s()
        self._t = [0] * self._slots  # guarded-by: _lock
        self._v = [0.0] * self._slots  # guarded-by: _lock

    def record(self, value: float) -> None:
        if not metrics_enabled():
            return
        s = int(time.time())
        i = s % self._slots
        with self._lock:
            self._t[i] = s
            self._v[i] = float(value)

    def add(self, value: float = 1.0) -> None:
        if not metrics_enabled():
            return
        s = int(time.time())
        i = s % self._slots
        with self._lock:
            if self._t[i] != s:
                self._t[i] = s
                self._v[i] = 0.0
            self._v[i] += float(value)

    def series(self) -> List[List[float]]:
        """The (epoch second, value) samples inside the window, oldest
        first."""
        now = int(time.time())
        with self._lock:
            pairs = [(t, v) for t, v in zip(self._t, self._v)
                     if t and now - t < self._slots]
        return [[t, v] for t, v in sorted(pairs)]


class Registry:
    """Get-or-create store of metrics and rings. Creating a name twice
    returns the first; re-declaring it with another type or label set
    raises (names are a contract)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}  # guarded-by: _lock
        self._rings: Dict[str, Ring] = {}  # guarded-by: _lock

    def _get_or_create(self, cls, name: str, help_text: str,
                       label_names: Sequence[str], **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls) \
                        or m.label_names != tuple(label_names):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{type(m).__name__}{m.label_names}")
                return m
            m = self._metrics[name] = cls(name, help_text, label_names, **kw)
            return m

    def counter(self, name: str, help_text: str = "",
                label_names: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help_text, label_names)

    def gauge(self, name: str, help_text: str = "",
              label_names: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help_text, label_names)

    def histogram(self, name: str, help_text: str = "",
                  label_names: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self._get_or_create(Histogram, name, help_text, label_names,
                                   buckets=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def render(self) -> str:
        """The Prometheus text exposition (format 0.0.4) of every
        metric."""
        with self._lock:
            metrics = [self._metrics[n] for n in sorted(self._metrics)]
        lines: List[str] = []
        for m in metrics:
            lines.extend(m.render())
        return "\n".join(lines) + "\n"

    def ring(self, name: str) -> Ring:
        with self._lock:
            r = self._rings.get(name)
            if r is None:
                r = self._rings[name] = Ring()
            return r

    def snapshot(self) -> Dict[str, Any]:
        """Every scalar as ``{"name{labels}": value}``, every histogram as
        its buckets, and every ring's series."""
        out: Dict[str, Any] = {"metrics": {}, "rings": {}}
        with self._lock:
            metrics = dict(self._metrics)
            rings = dict(self._rings)
        for name, m in sorted(metrics.items()):
            for key, child in sorted(m.children().items()):
                label = name + m._label_str(key)
                out["metrics"][label] = (child.snapshot()
                                         if isinstance(m, Histogram)
                                         else child.value())
        for name, r in sorted(rings.items()):
            out["rings"][name] = r.series()
        return out

    def reset(self) -> None:
        """Drop every metric and ring (test isolation: a child a caller
        still holds keeps counting, but no longer renders)."""
        with self._lock:
            self._metrics.clear()
            self._rings.clear()


#: the process's registry
REGISTRY = Registry()


def http_payload(fmt: str = "text") -> Tuple[bytes, str]:
    """Body and Content-Type of a ``GET /metrics`` answer: the text
    exposition, or with ``fmt="json"`` the snapshot with the rings."""
    if fmt == "json":
        return (json.dumps(REGISTRY.snapshot()).encode(),
                "application/json")
    return REGISTRY.render().encode(), PROMETHEUS_CONTENT_TYPE


def serve_http(handler, query: str = "") -> None:
    """Answer one ``GET /metrics`` on a ``BaseHTTPRequestHandler``
    (``?format=json`` selects the snapshot)."""
    data, ctype = http_payload(
        "json" if "format=json" in (query or "") else "text")
    handler.send_response(200)
    handler.send_header("Content-Type", ctype)
    handler.send_header("Content-Length", str(len(data)))
    handler.end_headers()
    handler.wfile.write(data)


def parse_prometheus(text: str) -> Dict[str, float]:
    """``{"name{labels}": value}`` of an exposition; raises ValueError on
    a line that is not a sample or a comment."""
    out: Dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        try:
            key, value = line.rsplit(" ", 1)
            out[key] = float(value)
        except ValueError as e:
            raise ValueError(f"unparseable exposition line {line!r}") from e
    return out
