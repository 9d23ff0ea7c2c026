"""A bounded, versioned cache of predictions with single-flight
coalescing (``RAFIKI_PREDICT_CACHE=1``; off by default).

Own copy of ``rafiki_tpu/predictor/result_cache.py``. The predictor asks
it before any worker queue is touched:

- **Keys.** ``(inference_job_id, serving version, digest)``, the digest
  from ``cache/wire.canonical_digest`` (the same as the JAX package's).
  The version is 0 until rollouts land (ROADMAP.md, item 8).
- **Bounds.** A TTL (``RAFIKI_PREDICT_CACHE_TTL_S``) and a byte cap
  (``RAFIKI_PREDICT_CACHE_MAX_BYTES``), evicted least recently used; an
  entry larger than the cap is never stored.
- **Single flight.** Concurrent identical misses share one
  :class:`~rafiki_tpu_torch.cache.queue.QueryFuture`: the first (the
  leader) runs the forward and resolves it, the others wait on it and
  count as ``coalesced``; a leader's error reaches them as theirs.
- **Invalidation.** ``flush_job`` drops a job's entries and bumps its
  fill epoch; a fill carries the epoch it saw at its miss and is dropped
  when the epoch moved, so a forward against a torn-down fleet never
  fills the cache after a teardown or a deploy.

The counters are this object's own (:meth:`ResultCache.counters`;
:meth:`ResultCache.stats` reads them with the JAX package's keys), and
each one is mirrored into the metrics registry under JAX's names
(``rafiki_cache_hits_total``, ``_misses_total``, ``_coalesced_total``,
``_evictions_total``, ``_bytes``, ``_shareable_total``,
``_errors_total``). Every lookup, fill and flight join first asks
``RAFIKI_CHAOS`` at site ``cache`` (target ``"{job}/{op}"``): ``delay``
sleeps, anything else raises :class:`CacheChaosError`, which the
predictor absorbs into the miss path. One lock guards all shared state;
no method calls out or blocks while holding it (waiters block on a
flight's future; the registry's counters take only their own leaf
locks).
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from typing import Any, Dict, Iterable, Optional, Tuple

from rafiki_tpu_torch import config
from rafiki_tpu_torch.cache.queue import QueryFuture
from rafiki_tpu_torch.utils import chaos
from rafiki_tpu_torch.utils.metrics import REGISTRY

logger = logging.getLogger(__name__)

#: bytes counted for an entry beyond its value: the key, the map's slot
_ENTRY_OVERHEAD = 256


class CacheChaosError(RuntimeError):
    """A ``RAFIKI_CHAOS site=cache`` rule fired on a cache operation;
    raised only into the predictor's absorb-and-degrade guard."""


class _Flight:
    """One in-flight miss: the leader's pending answer. The leader holds
    the object and completes it whether or not a flush has detached it
    from the registry (its waiters are answered either way)."""

    __slots__ = ("future",)

    def __init__(self) -> None:
        self.future = QueryFuture()


def _estimate_bytes(value: Any, depth: int = 0) -> int:
    """A cheap size estimate of a JSON-native prediction (over-counts
    past a nesting depth of 6)."""
    if depth > 6:
        return 64
    if value is None or isinstance(value, bool):
        return 8
    if isinstance(value, (int, float)):
        return 16
    if isinstance(value, (str, bytes)):
        return 48 + len(value)
    if isinstance(value, dict):
        return 64 + sum(_estimate_bytes(k, depth + 1)
                        + _estimate_bytes(v, depth + 1)
                        for k, v in value.items())
    if isinstance(value, (list, tuple)):
        return 64 + sum(_estimate_bytes(v, depth + 1) for v in value)
    nbytes = getattr(value, "nbytes", None)  # a stray ndarray
    if isinstance(nbytes, int):
        return 64 + nbytes
    return 128


class ResultCache:
    """One a process, shared by every job's doors (the job in the key
    keeps them apart). ``max_bytes`` and ``ttl_s`` of None read the
    settings at each use."""

    def __init__(self, max_bytes: Optional[int] = None,
                 ttl_s: Optional[float] = None) -> None:
        self._max_bytes = max_bytes
        self._ttl_s = ttl_s
        self._lock = threading.Lock()
        # (job, version, digest) -> [value, nbytes, expires (monotonic)]
        self._entries: "collections.OrderedDict[Tuple[str, int, str], list]" \
            = collections.OrderedDict()  # guarded-by: _lock
        self._bytes = 0  # guarded-by: _lock
        self._job_entries: Dict[str, int] = {}  # guarded-by: _lock
        # job -> fill epoch, bumped by flush_job
        self._epochs: Dict[str, int] = {}  # guarded-by: _lock
        self._flights: Dict[Tuple[str, int, str], _Flight] = {}  # guarded-by: _lock
        # recent digests a job, for the cache-off duplicate probe
        self._share_seen: Dict[str, "collections.OrderedDict[str, None]"] \
            = {}  # guarded-by: _lock
        # the counters: per job {hits, misses, coalesced, shareable};
        # evictions by reason (ttl, bytes, flush); absorbed faults
        self._job_counts: Dict[str, Dict[str, int]] = {}  # guarded-by: _lock
        self._evictions = {"ttl": 0, "bytes": 0, "flush": 0}  # guarded-by: _lock
        self._errors = 0  # guarded-by: _lock
        self._m = {
            "hits": REGISTRY.counter(
                "rafiki_cache_hits_total",
                "prediction cache hits (per tenant job)", ("job",)),
            "misses": REGISTRY.counter(
                "rafiki_cache_misses_total",
                "prediction cache misses (per tenant job)", ("job",)),
            "coalesced": REGISTRY.counter(
                "rafiki_cache_coalesced_total",
                "identical in-flight queries answered by a shared "
                "single-flight forward instead of their own", ("job",)),
            "shareable": REGISTRY.counter(
                "rafiki_cache_shareable_total",
                "sampled duplicate-query observations while the "
                "prediction cache is OFF", ("job",)),
        }
        self._m_evictions = REGISTRY.counter(
            "rafiki_cache_evictions_total",
            "prediction cache entries evicted (reason: ttl|bytes|flush)",
            ("reason",))
        self._m_bytes = REGISTRY.gauge(
            "rafiki_cache_bytes",
            "estimated bytes held by the prediction result cache")
        self._m_errors = REGISTRY.counter(
            "rafiki_cache_errors_total",
            "cache operations absorbed into the miss path (chaos or "
            "internal faults; serving degraded, never failed)")

    def _cap_bytes(self) -> int:
        if self._max_bytes is not None:
            return int(self._max_bytes)
        return int(config.PREDICT_CACHE_MAX_BYTES)

    def _ttl(self) -> float:
        if self._ttl_s is not None:
            return float(self._ttl_s)
        return float(config.PREDICT_CACHE_TTL_S)

    def _bump_locked(self, job: str, key: str,  # guarded-by: _lock
                     n: int = 1) -> None:
        counts = self._job_counts.setdefault(
            job, {"hits": 0, "misses": 0, "coalesced": 0, "shareable": 0})
        counts[key] += n
        self._m[key].labels(job).inc(n)

    def _evict_locked(self, reason: str,  # guarded-by: _lock
                      n: int = 1) -> None:
        self._evictions[reason] += n
        if n:
            self._m_evictions.labels(reason).inc(n)
        self._m_bytes.set(self._bytes)

    @staticmethod
    def _chaos(job: str, op: str) -> None:
        rule = chaos.hit(chaos.SITE_CACHE, f"{job}/{op}")
        if rule is None:
            return
        if rule.action == chaos.ACTION_DELAY:
            chaos.sleep_for(rule)
            return
        raise CacheChaosError(
            f"chaos-injected cache {op} failure for job {job}")

    # -- epochs ------------------------------------------------------------

    def epoch(self, job: str) -> int:
        """The job's fill epoch: read before serving a miss, handed back
        to :meth:`fill`."""
        with self._lock:
            return self._epochs.get(job, 0)

    # -- lookup and fill ---------------------------------------------------

    def lookup(self, job: str, version: int, digest: str
               ) -> Tuple[bool, Any]:
        """``(hit, value)``; an expired entry is evicted (``ttl``) and
        reads as a miss."""
        self._chaos(job, "lookup")
        key = (job, int(version), digest)
        now = time.monotonic()
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None and entry[2] <= now:
                self._drop_locked(key, entry)
                self._evict_locked("ttl")
                entry = None
            if entry is None:
                self._bump_locked(job, "misses")
                return False, None
            self._entries.move_to_end(key)
            self._bump_locked(job, "hits")
            return True, entry[0]

    def peek_misses(self, job: str, version: int,
                    digests: Iterable[Optional[str]]) -> int:
        """How many of ``digests`` would miss now, a request's duplicates
        counted once (they share one forward): the doors' admission cost.
        Read-only: no counters, no LRU touch."""
        now = time.monotonic()
        misses = 0
        seen = set()
        with self._lock:
            for d in digests:
                if d is None:
                    misses += 1
                    continue
                if d in seen:
                    continue
                seen.add(d)
                entry = self._entries.get((job, int(version), d))
                if entry is None or entry[2] <= now:
                    misses += 1
        return misses

    def fill(self, job: str, version: int, digest: str, value: Any,
             epoch: int) -> bool:
        """Store one served prediction unless the job's epoch moved past
        ``epoch``, the TTL or the cap is 0, or the entry alone is larger
        than the cap; the oldest entries make room. True when stored."""
        self._chaos(job, "fill")
        ttl = self._ttl()
        cap = self._cap_bytes()
        if ttl <= 0 or cap <= 0:
            return False
        nbytes = _ENTRY_OVERHEAD + _estimate_bytes(value)
        if nbytes > cap:
            return False  # one giant answer must not wipe the cache
        key = (job, int(version), digest)
        expires = time.monotonic() + ttl
        with self._lock:
            if self._epochs.get(job, 0) != epoch:
                return False
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old[1]
            else:
                self._job_entries[job] = self._job_entries.get(job, 0) + 1
            self._entries[key] = [value, nbytes, expires]
            self._bytes += nbytes
            while self._bytes > cap and self._entries:
                k, e = self._entries.popitem(last=False)
                self._bytes -= e[1]
                self._dec_job_entries_locked(k[0])
                self._evict_locked("bytes")
            self._m_bytes.set(self._bytes)
        return True

    def _drop_locked(self, key, entry) -> None:  # guarded-by: _lock
        self._entries.pop(key, None)
        self._bytes -= entry[1]
        self._dec_job_entries_locked(key[0])

    def _dec_job_entries_locked(self, job: str) -> None:  # guarded-by: _lock
        n = self._job_entries.get(job, 0) - 1
        if n > 0:
            self._job_entries[job] = n
        else:
            self._job_entries.pop(job, None)

    # -- single flight -----------------------------------------------------

    def join_flight(self, job: str, version: int, digest: str
                    ) -> Tuple[bool, _Flight]:
        """``(is_leader, flight)``. The leader must end the flight with
        :meth:`resolve_flight` or :meth:`fail_flight`; followers wait on
        ``flight.future``."""
        self._chaos(job, "join")
        key = (job, int(version), digest)
        with self._lock:
            flight = self._flights.get(key)
            if flight is None:
                flight = self._flights[key] = _Flight()
                return True, flight
            self._bump_locked(job, "coalesced")
            return False, flight

    def _retire_locked(self, job: str, version: int,  # guarded-by: _lock
                       digest: str, flight: _Flight) -> None:
        # only this very flight: a newer leader's under the same key stays
        key = (job, int(version), digest)
        if self._flights.get(key) is flight:
            del self._flights[key]

    def resolve_flight(self, job: str, version: int, digest: str,
                       flight: _Flight, value: Any) -> None:
        with self._lock:
            self._retire_locked(job, version, digest, flight)
        flight.future.set_result(value)

    def fail_flight(self, job: str, version: int, digest: str,
                    flight: _Flight, error: BaseException) -> None:
        """The followers re-raise the leader's error at once."""
        with self._lock:
            self._retire_locked(job, version, digest, flight)
        flight.future.set_error(error)

    # -- invalidation ------------------------------------------------------

    def flush_job(self, job: str, keep_version: Optional[int] = None,
                  reason: str = "flush") -> int:
        """Drop the job's entries (every version but ``keep_version``),
        bump its fill epoch and detach its flights (their leaders still
        answer the waiters). Returns the entries dropped."""
        keep = None if keep_version is None else int(keep_version)
        with self._lock:
            self._epochs[job] = self._epochs.get(job, 0) + 1
            victims = [k for k in self._entries
                       if k[0] == job and (keep is None or k[1] != keep)]
            for k in victims:
                self._bytes -= self._entries.pop(k)[1]
                self._dec_job_entries_locked(job)
            for k in [k for k in self._flights if k[0] == job]:
                del self._flights[k]
            self._share_seen.pop(job, None)
            self._evict_locked("flush", len(victims))
        logger.info("predict cache: flushed %d entries of job %s (%s%s)",
                    len(victims), job[:8], reason,
                    f", kept v{keep}" if keep is not None else "")
        return len(victims)

    # -- the cache-off probe and faults ------------------------------------

    def note_shareable(self, job: str, digest: Optional[str]) -> None:
        """A sampled digest while the cache is off: one already in the
        job's window of 128 counts as ``shareable``."""
        if digest is None:
            return
        with self._lock:
            seen = self._share_seen.setdefault(
                job, collections.OrderedDict())
            if digest in seen:
                self._bump_locked(job, "shareable")
            seen[digest] = None
            seen.move_to_end(digest)
            while len(seen) > 128:
                seen.popitem(last=False)

    def note_degraded(self) -> None:
        """One cache fault absorbed into the miss path."""
        with self._lock:
            self._errors += 1
        self._m_errors.inc()

    # -- observability -----------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        """The JAX package's ``prediction_cache`` section: bounds,
        occupancy, and per job its entries, hits, misses and hit rate."""
        with self._lock:
            entries = len(self._entries)
            total = self._bytes
            flights = len(self._flights)
            per_job = dict(self._job_entries)
        jobs: Dict[str, Any] = {}
        for job, n in per_job.items():
            hits, misses = self.job_totals(job)
            served = hits + misses
            jobs[job] = {"entries": n, "hits": hits, "misses": misses,
                         "hit_rate": (round(hits / served, 3)
                                      if served else None)}
        return {"enabled": bool(config.PREDICT_CACHE), "entries": entries,
                "bytes": total, "max_bytes": self._cap_bytes(),
                "ttl_s": self._ttl(), "inflight_flights": flights,
                "jobs": jobs}

    def job_totals(self, job: str) -> Tuple[int, int]:
        """(hits, misses) of one job."""
        with self._lock:
            counts = self._job_counts.get(job, {})
            return counts.get("hits", 0), counts.get("misses", 0)

    def counters(self, job: Optional[str] = None) -> Dict[str, Any]:
        """The counters the JAX package keeps in its registry: per job
        (``job``) or evictions by reason and absorbed faults."""
        with self._lock:
            if job is not None:
                return dict(self._job_counts.get(
                    job, {"hits": 0, "misses": 0, "coalesced": 0,
                          "shareable": 0}))
            return {"evictions": dict(self._evictions),
                    "errors": self._errors}

    def clear(self) -> None:
        """Drop every entry, epoch, flight and counter (tests); waiters
        of a dropped flight get an error."""
        with self._lock:
            self._entries.clear()
            self._bytes = 0
            self._job_entries.clear()
            self._epochs.clear()
            flights = list(self._flights.values())
            self._flights.clear()
            self._share_seen.clear()
            self._job_counts.clear()
            self._evictions = {"ttl": 0, "bytes": 0, "flush": 0}
            self._errors = 0
            self._m_bytes.set(0)
        for f in flights:
            f.future.set_error(RuntimeError("predict cache cleared"))


_CACHE = ResultCache()


def get_cache() -> ResultCache:
    """The process's cache."""
    return _CACHE
