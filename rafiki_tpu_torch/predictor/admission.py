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
- counters, in :meth:`AdmissionController.stats`, which ``/healthz``
  carries.

429 means retry later (``Retry-After`` says when); 503 means no capacity
now. Neither is sent after work started, and a shed costs microseconds.

Weighted fair admission (``RAFIKI_AUTOSCALE_FAIR``) comes with the
autoscaler (ROADMAP.md, item 8): the setting is refused, a ``tenant``
charges nothing, and ``stats()`` keeps the ``shed_fairness`` key at 0 so
``/healthz`` has the JAX package's shape. The JAX controller seeds a new
door's EWMA from the door's latency histogram in the metrics registry,
which is not ported (item 12); here a small record a door label, the
recent request latencies of that door in this process, gives the same
seed: its median.
"""

from __future__ import annotations

import collections
import math
import statistics
import threading
from typing import Deque, Dict, Optional

from rafiki_tpu_torch import config

#: request latencies a door label keeps for a new controller's seed
DOOR_RECORD_LEN = 256

_records_lock = threading.Lock()
_door_latencies: Dict[str, Deque[float]] = {}  # guarded-by: _records_lock


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
    """A tenant past its weighted fair share (HTTP 429). Kept for the JAX
    package's type tree; nothing raises it until fair admission is ported
    (item 8)."""


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
    several jobs enter (the admin's), for the fair admission to come."""

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
        # seconds a query; 0 until the first observation (no estimate:
        # never shed on a guess)
        self._ewma_query_s = 0.0  # guarded-by: _lock
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
        (``Predictor.backlog_depth``). ``tenant`` and ``cost`` are the
        fair gate's, which is not ported: they charge nothing."""
        with self._lock:
            cap = self._cap()
            if cap > 0 and self._inflight >= cap:
                self._shed_capacity += 1
                raise ServerOverloadedError(
                    f"serving door at capacity ({self._inflight}/{cap} "
                    "in flight)",
                    retry_after_s=max(self._ewma_query_s, 1.0))
            est_wait = (backlog_depth * self._ewma_query_s
                        if backlog_depth and self._ewma_query_s > 0 else 0.0)
            if est_wait > timeout_s > 0:
                self._shed_deadline += 1
                raise DeadlineUnmeetableError(
                    f"estimated queue wait {est_wait:.2f}s exceeds the "
                    f"request deadline {timeout_s:.2f}s",
                    retry_after_s=math.ceil(est_wait))
            self._inflight += 1
            self._admitted += 1

    def note_backend_shed(self) -> None:
        """Count a request admitted here that every replica's queue then
        refused: the client saw the same 429 as a deadline shed."""
        with self._lock:
            self._shed_deadline += 1

    def release(self, tenant: Optional[str] = None) -> None:
        """The pair of :meth:`admit`."""
        with self._lock:
            self._inflight = max(self._inflight - 1, 0)

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
        _note_latency(self.door, latency_s)

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
                "shed_fairness": 0,
                "ewma_query_s": round(self._ewma_query_s, 6),
            }
