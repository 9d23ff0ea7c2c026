"""Deadline-aware admission at the serving doors.

Own copy of ``rafiki_tpu/predictor/admission.py``. Both doors (the per-job
``PredictorServer`` and the admin's ``/predict/<app>``) run on a
threading HTTP server, which starts a thread a connection without bound;
this gate sheds what the fleet cannot answer in time instead:

- a cap on requests in flight (``RAFIKI_PREDICT_MAX_INFLIGHT``, 64): past
  it a request is shed at once with 503 (:class:`ServerOverloadedError`);
- an estimated wait: the backlog a new request faces times the EWMA of a
  query's service time; past the request's own deadline it is shed with
  429 and ``Retry-After`` (:class:`DeadlineUnmeetableError`);
- weighted fair admission at a door several tenants enter
  (``RAFIKI_AUTOSCALE_FAIR=1``): each tenant carries a decaying charge of
  the queries it was admitted (half-life
  ``RAFIKI_AUTOSCALE_FAIR_WINDOW_S``); under pressure (the door half
  full, or a shed in the last 2 s) a tenant past its weighted share
  (``RAFIKI_AUTOSCALE_FAIR_WEIGHTS``) plus ``RAFIKI_AUTOSCALE_FAIR_BURST``
  is shed with 429 (:class:`TenantOverShareError`), and no tenant may
  hold every in-flight slot but one;
- counters, in :meth:`AdmissionController.stats`, which ``/healthz``
  carries, mirrored into the metrics registry under JAX's names
  (``rafiki_admission_{admitted_total,shed_total,inflight,
  ewma_query_seconds}`` and the door's ``rafiki_request_seconds``
  histogram), and the door's shed and EWMA-wait rings
  (``shed_rate:<door>``, ``ewma_wait_s:<door>``).

429 means retry later (``Retry-After`` says when); 503 means no capacity
now. Neither is sent after work started, and a shed costs microseconds.

The JAX controller seeds a new door's EWMA from the door's latency
histogram in its registry; here a small record a door label, the recent
request latencies of that door in this process, gives the same seed: its
median (ROADMAP.md, queue C).
"""

from __future__ import annotations

import collections
import math
import statistics
import threading
import time
from typing import Deque, Dict, Optional, Tuple

from rafiki_tpu_torch import config
from rafiki_tpu_torch.utils.metrics import REGISTRY

#: request latencies a door label keeps for a new controller's seed
DOOR_RECORD_LEN = 256

_records_lock = threading.Lock()
_door_latencies: Dict[str, Deque[float]] = {}  # guarded-by: _records_lock

# the parsed RAFIKI_AUTOSCALE_FAIR_WEIGHTS: (raw value, {tenant: weight})
_weights_cache: Tuple[Optional[str], Dict[str, float]] = (None, {})
_weights_lock = threading.Lock()


def _fair_weights() -> Dict[str, float]:
    """{tenant: weight} from ``RAFIKI_AUTOSCALE_FAIR_WEIGHTS``
    ("appA=3,appB=1"; unlisted tenants weigh 1), parsed once a value."""
    global _weights_cache
    raw = str(config.AUTOSCALE_FAIR_WEIGHTS)
    cached_raw, cached = _weights_cache
    if raw == cached_raw:
        return cached
    weights: Dict[str, float] = {}
    for part in raw.split(","):
        part = part.strip()
        if not part or "=" not in part:
            continue
        name, _, val = part.partition("=")
        try:
            w = float(val)
        except ValueError:
            continue
        if w > 0:
            weights[name.strip()] = w
    with _weights_lock:
        _weights_cache = (raw, weights)
    return weights


def _note_latency(door: str, latency_s: float) -> None:
    with _records_lock:
        record = _door_latencies.get(door)
        if record is None:
            record = _door_latencies[door] = collections.deque(
                maxlen=DOOR_RECORD_LEN)
        record.append(latency_s)


def door_median_latency(door: str) -> Optional[float]:
    """The median of the door's recent request latencies in this process,
    or None before its first served request."""
    with _records_lock:
        record = list(_door_latencies.get(door, ()))
    return statistics.median(record) if record else None


class ServerOverloadedError(RuntimeError):
    """The door's in-flight cap is reached (HTTP 503)."""

    def __init__(self, message: str, retry_after_s: float = 1.0) -> None:
        super().__init__(message)
        self.retry_after_s = max(float(retry_after_s), 0.0)


class DeadlineUnmeetableError(RuntimeError):
    """The estimated wait is longer than the request's deadline (HTTP 429
    and ``Retry-After``)."""

    def __init__(self, message: str, retry_after_s: float = 1.0) -> None:
        super().__init__(message)
        self.retry_after_s = max(float(retry_after_s), 0.0)


class TenantOverShareError(DeadlineUnmeetableError):
    """A tenant past its weighted fair share, or holding every in-flight
    slot but one, while the door is contended (HTTP 429): the shed is the
    tenant's, not the door's."""


def retry_after_headers(e: Exception) -> Dict[str, str]:
    """``Retry-After`` in whole seconds, at least 1, from a shed error's
    estimate: the one copy of the contract every door uses."""
    return {"Retry-After": str(max(
        1, math.ceil(getattr(e, "retry_after_s", 1.0))))}


class AdmissionController:
    """One a door; thread-safe, every operation O(1) under one lock.
    ``max_inflight`` of None reads ``RAFIKI_PREDICT_MAX_INFLIGHT`` at each
    admit. ``door`` names the door's latency record (a fresh controller
    for a door that has served before starts from its median, erring to
    shed early, never to admit blind). ``shared_tenants`` marks a door
    several jobs enter (the admin's): only there does fair admission
    shed."""

    def __init__(self, max_inflight: Optional[int] = None,
                 door: str = "predictor",
                 shared_tenants: bool = False) -> None:
        self._max_inflight = max_inflight
        self._shared_tenants = shared_tenants
        self.door = door
        self._lock = threading.Lock()
        self._inflight = 0  # guarded-by: _lock
        self._admitted = 0  # guarded-by: _lock
        self._shed_capacity = 0  # guarded-by: _lock
        self._shed_deadline = 0  # guarded-by: _lock
        self._shed_fairness = 0  # guarded-by: _lock
        self._last_shed_mono = 0.0  # guarded-by: _lock
        # {tenant: [decayed charge, monotonic time of the last decay]}
        self._fair: Dict[str, list] = {}  # guarded-by: _lock
        # {tenant: in-flight slots held}
        self._fair_inflight: Dict[str, int] = {}  # guarded-by: _lock
        # seconds a query; 0 until the first observation (no estimate:
        # never shed on a guess)
        self._ewma_query_s = 0.0  # guarded-by: _lock
        # registry mirrors under JAX's names, bumped with the counters
        self._m_admitted = REGISTRY.counter(
            "rafiki_admission_admitted_total",
            "requests admitted through a serving door", ("door",)
        ).labels(door)
        shed = REGISTRY.counter(
            "rafiki_admission_shed_total",
            "requests shed at a serving door (reason: capacity=503, "
            "deadline=429)", ("door", "reason"))
        self._m_shed = {r: shed.labels(door, r)
                        for r in ("capacity", "deadline", "fairness")}
        self._g_inflight = REGISTRY.gauge(
            "rafiki_admission_inflight",
            "requests currently in flight behind a serving door",
            ("door",)).labels(door)
        self._g_ewma = REGISTRY.gauge(
            "rafiki_admission_ewma_query_seconds",
            "EWMA of per-query service seconds (the wait-estimation "
            "unit)", ("door",)).labels(door)
        self._h_request = REGISTRY.histogram(
            "rafiki_request_seconds",
            "end-to-end served-request latency at a serving door",
            ("door",)).labels(door)
        self._ring_shed = REGISTRY.ring(f"shed_rate:{door}")
        self._ring_wait = REGISTRY.ring(f"ewma_wait_s:{door}")
        seed = door_median_latency(door)
        if seed is not None and seed > 0:
            self._ewma_query_s = float(seed)

    def _cap(self) -> int:
        if self._max_inflight is not None:
            return self._max_inflight
        return int(config.PREDICT_MAX_INFLIGHT)

    def admit(self, timeout_s: float, backlog_depth: Optional[int] = None,
              tenant: Optional[str] = None, cost: int = 1) -> None:
        """Take an in-flight slot or raise a shed error; pair a
        successful admit with :meth:`release` (try/finally).
        ``backlog_depth`` is the queue depth a new request faces
        (``Predictor.backlog_depth``). ``tenant`` names the requester for
        the fair gate (None skips it); ``cost`` is the queries it is
        charged when admitted (0 for a request the cache answers)."""
        with self._lock:
            cap = self._cap()
            if tenant is not None:
                # before the capacity shed: the hot tenant is turned away
                # while a slot remains for everyone else
                self._fair_ceiling_locked(tenant, cap)
            if cap > 0 and self._inflight >= cap:
                self._shed_capacity += 1
                self._m_shed["capacity"].inc()
                self._ring_shed.add()
                self._last_shed_mono = time.monotonic()
                raise ServerOverloadedError(
                    f"serving door at capacity ({self._inflight}/{cap} "
                    "in flight)",
                    retry_after_s=max(self._ewma_query_s, 1.0))
            if tenant is not None:
                self._fair_gate_locked(tenant, max(int(cost), 0), cap)
            est_wait = (backlog_depth * self._ewma_query_s
                        if backlog_depth and self._ewma_query_s > 0 else 0.0)
            if est_wait > timeout_s > 0:
                self._shed_deadline += 1
                self._m_shed["deadline"].inc()
                self._ring_shed.add()
                self._last_shed_mono = time.monotonic()
                raise DeadlineUnmeetableError(
                    f"estimated queue wait {est_wait:.2f}s exceeds the "
                    f"request deadline {timeout_s:.2f}s",
                    retry_after_s=math.ceil(est_wait))
            self._inflight += 1
            self._admitted += 1
            self._m_admitted.inc()
            self._g_inflight.set(self._inflight)
            if tenant is not None:
                self._fair_inflight[tenant] = (
                    self._fair_inflight.get(tenant, 0) + 1)
                # charged only once admitted
                self._fair_charge_locked(tenant, max(int(cost), 0))

    # -- weighted fair admission -------------------------------------------

    def _fair_ceiling_locked(self, tenant: str,  # guarded-by: _lock
                             cap: int) -> None:
        """At a shared door no tenant may hold every in-flight slot: one
        holding ``cap - 1`` is shed 429, so a slot stays winnable by
        someone else (a flood of slow requests would otherwise keep a
        cold tenant out before the charge gate ever saw it)."""
        if cap < 2 or not self._shared_tenants or not config.AUTOSCALE_FAIR:
            return
        held = self._fair_inflight.get(tenant, 0)
        if held >= cap - 1:
            # a fairness shed does not renew the pressure window: it is
            # pressure's consequence, and would keep a quiet door shedding
            self._shed_fairness += 1
            self._m_shed["fairness"].inc()
            self._ring_shed.add()
            raise TenantOverShareError(
                f"tenant {tenant!r} already holds {held} of the door's "
                f"{cap} in-flight slots",
                retry_after_s=max(self._ewma_query_s, 1.0))

    def _fair_gate_locked(self, tenant: str, cost: int,  # guarded-by: _lock
                          cap: int) -> None:
        """The share check (the charge lands once admitted). Charges
        decay with a half-life of ``RAFIKI_AUTOSCALE_FAIR_WINDOW_S``. It
        sheds only under pressure (the door half full, or a shed within
        2 s) and only when another tenant was recently active; a door of
        one tenant (``shared_tenants=False``) is never rationed."""
        if not self._shared_tenants or not config.AUTOSCALE_FAIR:
            return
        now = time.monotonic()
        half_life = max(float(config.AUTOSCALE_FAIR_WINDOW_S), 0.5)
        total = 0.0
        for state in self._fair.values():
            dt = now - state[1]
            if dt > 0:
                state[0] *= 0.5 ** (dt / half_life)
                state[1] = now
            total += state[0]
        charge = self._fair.get(tenant, (0.0, now))[0]
        others_active = any(
            t != tenant and st[0] > 0.5 for t, st in self._fair.items())
        pressure = ((cap > 0 and self._inflight >= max(cap // 2, 1))
                    or now - self._last_shed_mono < 2.0)
        if pressure and others_active:
            weights = _fair_weights()
            w = weights.get(tenant, 1.0)
            sum_w = sum(weights.get(t, 1.0) for t, st in self._fair.items()
                        if st[0] > 0.5 or t == tenant)
            if tenant not in self._fair:
                sum_w += w
            fair_share = total * w / max(sum_w, w)
            burst = float(config.AUTOSCALE_FAIR_BURST)
            if charge + cost > fair_share + burst:
                self._shed_fairness += 1
                self._m_shed["fairness"].inc()
                self._ring_shed.add()
                raise TenantOverShareError(
                    f"tenant {tenant!r} is past its weighted fair share "
                    f"({charge:.0f} recent queries vs share "
                    f"{fair_share:.0f} + burst {burst:.0f}) while the "
                    "door is contended",
                    retry_after_s=max(self._ewma_query_s * cost, 1.0))

    def _fair_charge_locked(self, tenant: str,  # guarded-by: _lock
                            cost: int) -> None:
        """Book ``cost`` admitted queries against ``tenant``, its earlier
        charge decayed to now first."""
        if not config.AUTOSCALE_FAIR:
            return
        now = time.monotonic()
        state = self._fair.setdefault(tenant, [0.0, now])
        dt = now - state[1]
        if dt > 0:
            half_life = max(float(config.AUTOSCALE_FAIR_WINDOW_S), 0.5)
            state[0] *= 0.5 ** (dt / half_life)
        state[0] += cost
        state[1] = now

    def fair_shares(self) -> Dict[str, float]:
        """Each tenant's decayed charge of admitted queries."""
        with self._lock:
            return {t: round(st[0], 3) for t, st in self._fair.items()}

    def note_backend_shed(self) -> None:
        """Count a request admitted here that every replica's queue then
        refused: the client saw the same 429 as a deadline shed."""
        with self._lock:
            self._shed_deadline += 1
            self._m_shed["deadline"].inc()
            self._ring_shed.add()
            self._last_shed_mono = time.monotonic()

    def release(self, tenant: Optional[str] = None) -> None:
        """The pair of :meth:`admit`, with the same ``tenant``."""
        with self._lock:
            self._inflight = max(self._inflight - 1, 0)
            if tenant is not None:
                held = self._fair_inflight.get(tenant, 0) - 1
                if held > 0:
                    self._fair_inflight[tenant] = held
                else:
                    self._fair_inflight.pop(tenant, None)
            self._g_inflight.set(self._inflight)

    def observe(self, latency_s: float, n_queries: int) -> None:
        """Feed one served request's latency into the wait model (an EWMA
        of seconds a query, weight 0.2) and the door's record."""
        if n_queries <= 0 or latency_s < 0:
            return
        per_query = latency_s / n_queries
        with self._lock:
            if self._ewma_query_s <= 0.0:
                self._ewma_query_s = per_query
            else:
                self._ewma_query_s += 0.2 * (per_query - self._ewma_query_s)
            ewma = self._ewma_query_s
        _note_latency(self.door, latency_s)
        self._h_request.observe(latency_s)
        self._g_ewma.set(ewma)
        self._ring_wait.record(ewma)

    @property
    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    def stats(self) -> Dict[str, float]:
        with self._lock:
            return {
                "inflight": self._inflight,
                "max_inflight": self._cap(),
                "admitted": self._admitted,
                "shed_capacity": self._shed_capacity,
                "shed_deadline": self._shed_deadline,
                "shed_fairness": self._shed_fairness,
                "ewma_query_s": round(self._ewma_query_s, 6),
            }
