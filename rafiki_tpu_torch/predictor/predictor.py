"""The predictor: fans a request out to the best trials and ensembles.

Own copy of the serving core of ``rafiki_tpu/predictor/predictor.py``:

- the replicas are grouped by trial; a request is ensembled across
  trials and load-balanced (round-robin) within a trial's replicas;
- the first submit walks a trial's replicas past full queues, and the
  order then starts at the one that accepted; a trial whose every replica
  is full is shed from the request (``trials_shed``), and a request whose
  every trial is shed is refused (``requests_shed``, the doors' 429);
- hedged failover: a trial's deadline is split across its replicas
  (remaining / attempts left), so a silent replica leaves time to try a
  sibling; a silent replica's batch stays in the sweep (it may still
  answer first), one that errors leaves it; a hedge to a sibling deeper
  than ``RAFIKI_PREDICT_HEDGE_SUPPRESS_DEPTH`` or with a full queue is
  held back (``hedges_suppressed``), the others count as ``hedges``
  (:meth:`Predictor.overload_stats`, on ``/healthz``);
- the draining set (``retire_worker``): a retired replica takes no new
  request unless its trial has no other;
- ``backlog_depth``, what a new request waits behind, for admission;
- the predict result cache (``RAFIKI_PREDICT_CACHE=1``,
  ``predictor/result_cache.py``): hits answered before any queue is
  touched, identical misses coalesced behind one forward, only the
  misses forwarded, and no answer of an incomplete ensemble stored;
- ``generate`` routes one generation request to ONE replica and answers
  with a resumable stream: the door journals the prompt, the sampling
  seed it pinned and every delivered token, and when the stream's
  replica dies (its queue gone at the door's stall window) or hands the
  stream back ``migrating`` it resumes the stream on a sibling of the
  same model version; the keyed draws make the continuation the same
  tokens (``gen_continuity_stats``);
- version lanes while a rollout is in flight (``admin/rollout.py``): a
  deterministic weighted counter sends each request to ONE lane, the
  incumbents or the new-version replicas, never an ensemble across
  versions; a canary-lane failure fails over to the incumbents, an
  incumbent failure never reaches the canary; each lane's outcomes and
  latencies feed the judge (``rollout_stats``); a generation stream draws
  its lane once and a resume stays on its version; the serving version
  (the cache's key) moves with :meth:`Predictor.set_serving_version`.
- the drift tap (``RAFIKI_DRIFT=1``): one (wall time, canonical digest,
  top probability) sample a served query, from the uncached and the
  cached path alike, bounded; :meth:`Predictor.drift_window` is the
  drift controller's snapshot (``admin/drift.py``).
"""

from __future__ import annotations

import collections
import itertools
import logging
import random
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

from rafiki_tpu_torch import config
from rafiki_tpu_torch.cache.queue import (
    Broker,
    GenerationError,
    QueryFuture,
    QueueFullError,
    StreamMigratingError,
)
from rafiki_tpu_torch.constants import TaskType
from rafiki_tpu_torch.predictor.ensemble import (
    _PROB_TASKS,
    ensemble_predictions,
)
from rafiki_tpu_torch.utils.metrics import REGISTRY

logger = logging.getLogger(__name__)

#: the version lanes of a rollout: every request is served by exactly one
LANE_INCUMBENT = "incumbent"
LANE_CANARY = "canary"


def _top_prob(pred: Any) -> Optional[float]:
    """The top class probability of a served answer, the drift monitor's
    confidence signal; None for anything but a non-empty numeric list."""
    try:
        if isinstance(pred, (list, tuple)) and pred:
            return float(max(pred))
    except (TypeError, ValueError):
        return None
    return None


class CrossVersionResumeError(GenerationError):
    """No routable sibling serves the model version a journaled stream
    started on: resuming on another version would splice two models'
    distributions into one stream, so the resume is refused, typed."""


class _JournalEntry:
    """One stream's resume record at the door: the query (its seed
    pinned), the tokens delivered so far, the version it is pinned to and
    the replica serving it. ``tokens``, ``worker_id`` and ``attempts``
    belong to the one thread pumping the stream; the byte books and the
    ``resumable``/``cancelled``/``closed`` flags are shared with the
    predictor, under its ``_journal_lock``."""

    __slots__ = ("query", "tokens", "deadline", "lane", "version",
                 "worker_id", "t0", "bytes", "resumable", "attempts",
                 "cancelled", "closed")

    def __init__(self, query: Dict[str, Any], worker_id: str,
                 lane: Optional[str], version: int,
                 deadline: float) -> None:
        self.query = query
        self.tokens: List[int] = []
        self.deadline = deadline
        # the rollout lane the stream drew (None: no rollout)
        self.lane = lane
        self.version = version
        self.worker_id = worker_id
        self.t0 = time.monotonic()
        self.bytes = 0
        self.resumable = True
        self.attempts = 0
        self.cancelled = False
        self.closed = False


class Predictor:
    def __init__(self, inference_job_id: str, broker: Broker,
                 task: Optional[str],
                 worker_trials: Optional[Dict[str, str]] = None,
                 serving_version: int = 0):
        """``worker_trials`` maps a worker's service id to its trial id
        (a fused ensemble's replicas to one group). A worker not in the
        map stands alone as its own trial, unless a map exists: then an
        unmapped queue is a replica still warming up, and it joins the
        fan-out when :meth:`add_worker` maps it. ``serving_version`` is
        the fleet's model version, the cache's key (0 for a first deploy;
        a finished rollout moves it, :meth:`set_serving_version`)."""
        self._job_id = inference_job_id
        self._broker = broker
        self._task = task
        self._route_lock = threading.Lock()
        self._worker_trials = dict(worker_trials or {})  # guarded-by: _route_lock
        # replicas being drained: no new submit or hedge goes to them
        self._draining: set = set()  # guarded-by: _route_lock
        self._serving_version = int(serving_version)  # guarded-by: _route_lock
        self._rr = itertools.count()
        self._ol_lock = threading.Lock()
        self._overload = {  # guarded-by: _ol_lock
            "hedges": 0,             # failover batches issued
            "hedges_suppressed": 0,  # held back: the sibling saturated
            "trials_shed": 0,        # trials dropped: every replica full
            "requests_shed": 0,      # requests refused: every trial shed
        }
        # registry mirrors, by job, bumped with the counters above
        self._m_overload = {
            key: REGISTRY.counter(
                f"rafiki_predictor_{key}_total",
                f"predictor overload counter: {key}", ("job",)
            ).labels(inference_job_id)
            for key in self._overload}
        # the job's shed series, which the autoscaler reads
        self._ring_shed = REGISTRY.ring(f"shed_rate:job:{inference_job_id}")
        # -- rollout lanes: the new-version replicas, their share of the
        # traffic in permille, the weighted counter, the lane's version
        self._lane_new: Optional[set] = None  # guarded-by: _route_lock
        self._lane_permille = 0  # guarded-by: _route_lock
        self._lane_counter = itertools.count()
        self._lane_version: Optional[int] = None  # guarded-by: _route_lock
        # (monotonic ts, duration s, outcome) a lane, the judge's input
        self._lane_stats: Dict[str, collections.deque] = {  # guarded-by: _route_lock
            LANE_INCUMBENT: collections.deque(maxlen=4096),
            LANE_CANARY: collections.deque(maxlen=4096),
        }
        self._m_lane_req = REGISTRY.counter(
            "rafiki_rollout_requests_total",
            "requests served per rollout version lane",
            ("job", "lane", "outcome"))
        self._m_lane_lat = REGISTRY.histogram(
            "rafiki_rollout_request_seconds",
            "request latency per rollout version lane", ("job", "lane"))
        # sampled duplicate-query probe while the cache is off
        self._share_rr = itertools.count()
        self._cache_degraded_logged = False
        # the digests admission_cost computed, handed to the serve path
        # on the same thread (one hash pass a request)
        self._tls = threading.local()
        # the drift tap (admin/drift.py, RAFIKI_DRIFT=1): one (wall time,
        # digest, top probability) a served query, bounded
        self._drift_lock = threading.Lock()
        self._drift_samples: collections.deque = collections.deque(
            maxlen=4096)  # guarded-by: _drift_lock
        # the streams' resume journal: each entry lives in its stream's
        # wrapper; the predictor keeps the byte books and the counters
        self._journal_lock = threading.Lock()
        self._journal_bytes = 0    # guarded-by: _journal_lock
        self._journal_streams = 0  # guarded-by: _journal_lock
        self._continuity = {       # guarded-by: _journal_lock
            "resumes_migrating": 0,     # hand-backs resumed
            "resumes_worker_death": 0,  # dead replicas' streams resumed
            "resume_failures": 0,       # streams the client lost
            "journal_overflows": 0,     # past RAFIKI_GEN_JOURNAL_MAX_KB
            "cross_version_refusals": 0,
        }

    def _bump(self, key: str, n: int = 1) -> None:
        with self._ol_lock:
            self._overload[key] += n
        self._m_overload[key].inc(n)
        if key in ("trials_shed", "requests_shed"):
            self._ring_shed.add(n)

    # -- membership --------------------------------------------------------

    def add_worker(self, worker_id: str, trial_id: str) -> None:
        """Route requests to a worker from now on."""
        with self._route_lock:
            self._worker_trials[worker_id] = trial_id
            self._draining.discard(worker_id)

    def retire_worker(self, worker_id: str) -> None:
        """Begin a graceful leave: no new submit or hedge goes to the
        replica while its queue drains. Idempotent."""
        with self._route_lock:
            self._draining.add(worker_id)

    def unretire_worker(self, worker_id: str) -> None:
        """Abort a leave (a drain that failed): route to it again."""
        with self._route_lock:
            self._draining.discard(worker_id)

    def drop_worker(self, worker_id: str) -> None:
        """Forget a worker (the end of a leave)."""
        with self._route_lock:
            self._worker_trials.pop(worker_id, None)
            self._draining.discard(worker_id)

    def draining_workers(self) -> set:
        with self._route_lock:
            return set(self._draining)

    def serving_version(self) -> int:
        with self._route_lock:
            return self._serving_version

    # -- rollout lanes -----------------------------------------------------

    def set_rollout_lane(self, new_workers, fraction: float,
                         new_version: Optional[int] = None) -> None:
        """Start (or re-weight) lane routing: ``fraction`` of requests go
        to ``new_workers``, by the weighted counter. A lane started from
        none clears both lanes' outcomes, so the judge never reads an
        earlier rollout's window; a re-weight keeps them.
        ``new_version`` keys the canary lane's cache traffic (None keeps
        the lane's version)."""
        permille = max(0, min(int(round(float(fraction) * 1000)), 1000))
        with self._route_lock:
            fresh = self._lane_new is None
            self._lane_new = set(new_workers)
            self._lane_permille = permille
            if new_version is not None:
                self._lane_version = int(new_version)
            if fresh:
                for dq in self._lane_stats.values():
                    dq.clear()

    def clear_rollout_lane(self) -> None:
        """End lane routing: every routable replica serves again."""
        with self._route_lock:
            self._lane_new = None
            self._lane_permille = 0
            self._lane_version = None

    def set_serving_version(self, version: int) -> None:
        """The incumbents' version moved (a rollout's DONE, or a
        rollback's restore): the cache keys on it from now on."""
        with self._route_lock:
            self._serving_version = int(version)

    def _lane_snapshot(self):
        with self._route_lock:
            return (set(self._lane_new) if self._lane_new is not None
                    else None), self._lane_permille

    def _lane_take_new(self, permille: int) -> bool:
        """The weighted counter, error-diffusion style: the canary's picks
        spread evenly through the stream (``n % 1000 < permille`` would
        send them in one burst)."""
        n = next(self._lane_counter)
        return (n + 1) * permille // 1000 > n * permille // 1000

    def _lane_record(self, lane: str, outcome: str,
                     duration_s: float) -> None:
        # under the route lock: the judge iterates these deques
        with self._route_lock:
            self._lane_stats[lane].append(
                (time.monotonic(), duration_s, outcome))
        self._m_lane_req.labels(self._job_id, lane, outcome).inc()
        if outcome == "ok":
            self._m_lane_lat.labels(self._job_id, lane).observe(duration_s)

    def rollout_stats(self, window_s: float) -> Dict[str, Dict[str, Any]]:
        """Each lane over the trailing ``window_s``: requests, oks, errors,
        sheds and the p95 of the oks' latency (the judge's input)."""
        cutoff = time.monotonic() - max(window_s, 0.0)
        with self._route_lock:
            snapshots = {lane: list(dq)
                         for lane, dq in self._lane_stats.items()}
        out: Dict[str, Dict[str, Any]] = {}
        for lane, entries_all in snapshots.items():
            entries = [e for e in entries_all if e[0] >= cutoff]
            oks = sorted(d for _, d, o in entries if o == "ok")
            errors = sum(1 for e in entries if e[2] == "error")
            shed = sum(1 for e in entries if e[2] == "shed")
            p95 = oks[min(int(len(oks) * 0.95), len(oks) - 1)] if oks \
                else None
            out[lane] = {"requests": len(entries), "ok": len(oks),
                         "errors": errors, "shed": shed, "p95_s": p95}
        return out

    def _route_snapshot(self):
        with self._route_lock:
            return dict(self._worker_trials), set(self._draining)

    # -- load --------------------------------------------------------------

    def overload_stats(self) -> Dict[str, int]:
        with self._ol_lock:
            return dict(self._overload)

    def queue_depths(self) -> Dict[str, int]:
        """Each worker's inbox depth (-1 for a queue with no depth)."""
        out: Dict[str, int] = {}
        for wid, q in self._broker.get_worker_queues(self._job_id).items():
            depth = getattr(q, "depth", None)
            out[wid] = depth() if callable(depth) else -1
        return out

    def backlog_depth(self) -> int:
        """The depth a new request waits behind: each trial answers
        through its least loaded replica and the request waits for every
        trial, so the maximum over trials of the minimum over their
        routable replicas (draining and warming ones left out unless
        nothing else is left)."""
        depths = self.queue_depths()
        if not depths:
            return 0
        trials, draining = self._route_snapshot()
        groups: Dict[str, List[int]] = {}
        for wid, d in depths.items():
            if d >= 0 and wid not in draining and (
                    not trials or wid in trials):
                groups.setdefault(trials.get(wid, wid), []).append(d)
        if not groups:
            for wid, d in depths.items():
                if d >= 0:
                    groups.setdefault(trials.get(wid, wid), []).append(d)
        return max((min(ds) for ds in groups.values()), default=0)

    # -- predict -----------------------------------------------------------

    def predict(self, query: Any, timeout_s: Optional[float] = None) -> Any:
        return self.predict_batch([query], timeout_s)[0]

    def predict_batch(self, queries: List[Any],
                      timeout_s: Optional[float] = None,
                      trace=None) -> List[Any]:
        """One prediction per query, ensembled across trials. Raises
        :class:`QueueFullError` when every trial's replicas refuse,
        ``TimeoutError`` when no trial answers in time, ``RuntimeError``
        when no worker is registered. With the cache on, hits are
        answered from it and only the misses are forwarded. ``trace`` (a
        sampled request's ``RequestTrace``) rides each trial's first
        submit, so the worker's spans join the door's tree."""
        if timeout_s is None:
            timeout_s = config.PREDICT_TIMEOUT_S
        deadline = time.monotonic() + timeout_s
        queues = self._broker.get_worker_queues(self._job_id)
        if not queues:
            raise RuntimeError(
                f"No inference workers registered for job {self._job_id}")
        trials, draining = self._route_snapshot()
        routable = [w for w in queues
                    if not trials or w in trials] or list(queues)
        # one lane draw a request, and one split that both the cache plan
        # and the serving path use: the cache keys on the lane that serves
        lane_new, permille = self._lane_snapshot()
        take_new = (self._lane_take_new(permille)
                    if lane_new is not None else False)
        split = self._lane_split(routable, lane_new, take_new, draining)
        plan = self._cache_plan(split)
        if plan is None:
            # the drift tap reuses the digests admission left, if any
            digests = self._take_digest_stash(queries)
            self._maybe_note_shareable(queries)
            preds = self._serve_lanes(queries, queues, routable, trials,
                                      draining, deadline, split, trace)[0]
            self._drift_note(queries, digests, preds)
            return preds
        return self._serve_cached(plan, queries, queues, routable,
                                  trials, draining, deadline, split, trace)

    @staticmethod
    def _lane_split(routable: List[str], lane_new: Optional[set],
                    take_new: bool, draining: "frozenset[str]" = frozenset()):
        """None with no lane set, else ``(primary, fallback, lane,
        pure)``; ``pure`` is False when the canary label serves a set
        that may hold incumbents (no new-version replica is left). When
        every incumbent is draining (the rolling phase retires them), the
        new version serves: a request sent to the last incumbent while
        its drain closes the queue would be lost (the JAX package routes
        it there; ROADMAP.md, queue C)."""
        if lane_new is None:
            return None
        new_r = [w for w in routable if w in lane_new]
        old_r = [w for w in routable if w not in lane_new]
        retired = bool(old_r) and all(w in draining for w in old_r)
        if new_r and (take_new or retired):
            return new_r, old_r, LANE_CANARY, True
        if old_r:
            return old_r, [], LANE_INCUMBENT, True
        # only new-version replicas are left (the end of the rolling
        # phase): they serve everything
        return new_r or routable, [], LANE_CANARY, bool(new_r)

    def _serve_lanes(self, queries: List[Any], queues, routable: List[str],
                     trials: Dict[str, str], draining: set,
                     deadline: float, split,
                     trace=None) -> "tuple[List[Any], bool]":
        """Serve over one lane (or the whole fan-out with no lane) and
        record the lane's outcome. Returns ``(predictions, fillable)``:
        not fillable when the ensemble was incomplete or a canary failure
        was served by the incumbents (their answer must never be kept
        under the new version)."""
        if split is None:
            return self._predict_on(queries, queues, routable, trials,
                                    draining, deadline, trace)
        primary, fallback, lane, _pure = split
        t0 = time.monotonic()
        try:
            preds, fillable = self._predict_on(queries, queues, primary,
                                               trials, draining, deadline,
                                               trace)
        except Exception as e:
            self._lane_record(
                lane, "shed" if isinstance(e, QueueFullError) else "error",
                time.monotonic() - t0)
            if lane == LANE_CANARY and fallback \
                    and time.monotonic() < deadline:
                preds, _ = self._predict_on(queries, queues, fallback,
                                            trials, draining, deadline)
                return preds, False
            raise
        self._lane_record(lane, "ok", time.monotonic() - t0)
        return preds, fillable

    def _predict_on(self, queries: List[Any], queues, routable: List[str],
                    trials: Dict[str, str], draining: set,
                    deadline: float,
                    trace=None) -> "tuple[List[Any], bool]":
        """Serve one request over ``routable``: ``(predictions,
        complete)``, ``complete`` False when a trial was shed or dropped
        (the cache must not keep a degraded answer)."""
        # a draining replica serves its trial only when it has no other
        groups: Dict[str, List[str]] = {}
        for wid in routable:
            if wid not in draining:
                groups.setdefault(trials.get(wid, wid), []).append(wid)
        for wid in routable:
            if wid in draining and trials.get(wid, wid) not in groups:
                groups.setdefault(trials.get(wid, wid), []).append(wid)
        rr = next(self._rr)
        orders = {t: w[rr % len(w):] + w[:rr % len(w)]
                  for t, w in groups.items()}
        # the first submit of every trial up front, so the trials' workers
        # run at once; a full replica sends it on to a sibling, and the
        # order then starts at the one that accepted
        inflight: Dict[str, List[QueryFuture]] = {}
        for trial, order in list(orders.items()):
            for k, wid in enumerate(order):
                try:
                    # the trace keyword only when sampled: an unsampled
                    # request keeps the call shape queue fakes take
                    inflight[trial] = queues[wid].submit_many(
                        queries, deadline=deadline,
                        **({"trace": trace} if trace is not None else {}))
                except QueueFullError:
                    continue
                orders[trial] = order[k:] + order[:k]
                break
            else:
                self._bump("trials_shed")
                logger.info("trial %s shed from this request: every "
                            "replica queue of %s is full", trial, order)
        if not inflight:
            self._bump("requests_shed")
            raise QueueFullError(
                f"all serving queues for job {self._job_id} are full")
        answered = []
        for trial, futs in inflight.items():
            preds = self._gather_with_failover(
                trial, orders[trial], queues, queries, futs, deadline)
            if preds is not None:
                answered.append(preds)
        if not answered:
            raise TimeoutError("No inference worker answered within the SLO")
        return [ensemble_predictions([p[i] for p in answered], self._task)
                for i in range(len(queries))], len(answered) == len(groups)

    def _gather_with_failover(self, trial: str, order: List[str], queues,
                              queries: List[Any],
                              first_futs: List[QueryFuture],
                              deadline: float) -> Optional[List[Any]]:
        """One trial's predictions, hedged across its replicas: each
        attempt gets the remaining time over the attempts left; a replica
        that misses its share keeps its batch in the sweep, one that
        errors leaves it; None when nothing answers by the deadline."""
        issued: List[List[QueryFuture]] = [list(first_futs)]
        attempt = 0
        while True:
            attempts_left = len(order) - attempt
            if attempts_left <= 0:
                break
            attempt_deadline = min(
                deadline, time.monotonic()
                + max(deadline - time.monotonic(), 0.0) / attempts_left)
            if len(issued) == 1:
                # one batch in flight: block on it, no polling
                try:
                    return [f.result(max(attempt_deadline - time.monotonic(),
                                         0.0)) for f in issued[0]]
                except TimeoutError:
                    logger.info("replica %s silent past its share of the "
                                "deadline; hedging", order[attempt])
                except Exception as e:
                    logger.info("replica %s failed (%r); failing over",
                                order[attempt], e)
                    issued.pop()
            else:
                preds = self._sweep(issued, attempt_deadline)
                if preds is not None:
                    return preds
            attempt += 1
            if attempt < len(order) and time.monotonic() < deadline:
                hedge = self._try_hedge(queues[order[attempt]],
                                        order[attempt], queries, deadline)
                if hedge is not None:
                    issued.append(hedge)
        # a batch in flight may still land before the deadline
        preds = self._sweep(issued, deadline) if issued else None
        if preds is None:
            logger.warning("trial %s dropped from ensemble: no replica of %s "
                           "answered within the SLO", trial, order)
        return preds

    def _try_hedge(self, queue, worker_id: str, queries: List[Any],
                   deadline: float) -> Optional[List[QueryFuture]]:
        """Submit one failover batch unless the replica is saturated (its
        depth over the threshold, or its queue full); None when held."""
        threshold = int(config.PREDICT_HEDGE_SUPPRESS_DEPTH)
        depth_fn = getattr(queue, "depth", None)
        if threshold > 0 and callable(depth_fn) and depth_fn() > threshold:
            self._bump("hedges_suppressed")
            logger.info("hedge to replica %s held back: queue depth over "
                        "%d", worker_id, threshold)
            return None
        try:
            futs = queue.submit_many(queries, deadline=deadline)
        except QueueFullError:
            self._bump("hedges_suppressed")
            logger.info("hedge to replica %s held back: queue full",
                        worker_id)
            return None
        self._bump("hedges")
        return futs

    @staticmethod
    def _sweep(issued: List[List[QueryFuture]],
               until: float) -> Optional[List[Any]]:
        """Poll every batch in flight until one completes or ``until``
        (every 20 ms: only the failover path gets here)."""
        while True:
            for futs in list(issued):
                try:
                    return [f.result(0.0) for f in futs]
                except TimeoutError:
                    continue  # not yet: it stays in the sweep
                except Exception:
                    issued.remove(futs)  # an error: the replica leaves
            if not issued or time.monotonic() >= until:
                return None
            time.sleep(min(0.02, max(until - time.monotonic(), 0.0)))

    # -- the result cache --------------------------------------------------

    def _cacheable_task(self) -> bool:
        """An answer is cacheable when it is a function of the query and
        the version: never a token stream, always an averaged probability
        task, and another task only from a single trial (several answer
        with whichever responded)."""
        if self._task == TaskType.TEXT_GENERATION:
            return False
        if self._task in _PROB_TASKS:
            return True
        with self._route_lock:
            return len(set(self._worker_trials.values())) <= 1

    def _cache_plan(self, split) -> "Optional[tuple[int, bool]]":
        """None to bypass the cache, else ``(version, read_ok)``: the
        version to key on and whether hits may be served. The canary lane
        only fills (the judge needs real forwards), under its own version;
        an impure canary split bypasses the cache."""
        if not config.PREDICT_CACHE or not self._cacheable_task():
            return None
        if split is not None and split[2] == LANE_CANARY:
            if not split[3]:
                return None
            with self._route_lock:
                lane_version = self._lane_version
                serving = self._serving_version
            return (lane_version if lane_version is not None
                    else serving), False
        return self.serving_version(), True

    def _cache_op(self, fn, fallback):
        """Run one cache operation; a fault in it serves the miss path,
        never a failed request."""
        try:
            return fn()
        except Exception:
            from rafiki_tpu_torch.predictor import result_cache

            if not self._cache_degraded_logged:
                self._cache_degraded_logged = True
                logger.warning("predict cache degraded for job %s; serving "
                               "the miss path (logged once)", self._job_id,
                               exc_info=True)
            result_cache.get_cache().note_degraded()
            return fallback

    def _serve_cached(self, plan: "tuple[int, bool]", queries: List[Any],
                      queues, routable: List[str], trials: Dict[str, str],
                      draining: set, deadline: float,
                      split, trace=None) -> List[Any]:
        """Hits from the cache, identical misses behind one leader's
        forward, the rest forwarded as one sub-batch, then a fill for
        each resolved query (unless the answer is not fillable)."""
        from rafiki_tpu_torch.predictor import result_cache

        version, read_ok = plan
        cache = result_cache.get_cache()
        job = self._job_id
        epoch = self._cache_op(lambda: cache.epoch(job), 0)
        digests = self._request_digests(queries)
        results: List[Any] = [None] * len(queries)
        single_flight = read_ok and bool(config.PREDICT_SINGLEFLIGHT)
        followers: Dict[int, QueryFuture] = {}
        lead: Dict[str, List[int]] = {}  # digest -> this request's indices
        flights: Dict[str, Any] = {}     # digest -> a flight this leads
        miss_idx: List[int] = []
        for i, d in enumerate(digests):
            if d is None:
                miss_idx.append(i)  # no canonical form: always forwarded
                continue
            if d in lead:
                lead[d].append(i)  # a duplicate within the request
                continue
            if read_ok:
                hit, value = self._cache_op(
                    lambda d=d: cache.lookup(job, version, d),
                    (False, None))
                if hit:
                    results[i] = value
                    continue
            if single_flight:
                role = self._cache_op(
                    lambda d=d: cache.join_flight(job, version, d), None)
                if role is not None:
                    leader, flight = role
                    if not leader:
                        followers[i] = flight.future
                        continue
                    flights[d] = flight
            lead[d] = [i]
            miss_idx.append(i)
        complete = False
        if miss_idx:
            try:
                miss_preds, complete = self._serve_lanes(
                    [queries[i] for i in miss_idx], queues, routable,
                    trials, draining, deadline, split, trace)
            except BaseException as e:
                # this leader's followers fail now, not at their deadline
                for d, flight in flights.items():
                    cache.fail_flight(job, version, d, flight, e)
                raise
            for i, pred in zip(miss_idx, miss_preds):
                results[i] = pred
        for d, idxs in lead.items():
            value = results[idxs[0]]
            for j in idxs[1:]:
                results[j] = value
            if d in flights:
                cache.resolve_flight(job, version, d, flights[d], value)
            if complete:
                self._cache_op(
                    lambda d=d, v=value: cache.fill(job, version, d, v,
                                                    epoch), False)
        # followers last: every flight this request leads is resolved
        # above, so two requests leading each other's digests cannot
        # deadlock
        for i, fut in followers.items():
            results[i] = fut.result(max(deadline - time.monotonic(), 0.0))
        self._drift_note(queries, digests, results)
        return results

    # -- the drift tap (admin/drift.py) -------------------------------------

    def _drift_note(self, queries: List[Any],
                    digests: Optional[List[Optional[str]]],
                    preds: Optional[List[Any]]) -> None:
        """Feed the drift monitor's window one sample a served query,
        cached or not. Only with RAFIKI_DRIFT=1, and observational: a
        failure here never fails the request."""
        if not config.DRIFT or not queries:
            return
        try:
            if digests is None:
                from rafiki_tpu_torch.cache import wire

                digests = [
                    self._cache_op(lambda q=q: wire.canonical_digest(q),
                                   None)
                    for q in queries]
            now = time.time()
            prob_task = self._task in _PROB_TASKS
            with self._drift_lock:
                for i, digest in enumerate(digests):
                    conf = None
                    if prob_task and preds is not None and i < len(preds):
                        conf = _top_prob(preds[i])
                    self._drift_samples.append((now, digest, conf))
        except Exception:
            logger.debug("drift tap failed for job %s", self._job_id,
                         exc_info=True)

    def drift_window(self, window_s: float) -> List[tuple]:
        """The samples of the trailing ``window_s`` seconds, oldest
        first: the drift controller's snapshot a tick."""
        cut = time.time() - float(window_s)
        with self._drift_lock:
            return [s for s in self._drift_samples if s[0] >= cut]

    def _take_digest_stash(self, queries: List[Any]):
        """The digests :meth:`admission_cost` left on this thread for
        this very list, cleared whether or not they match."""
        stash = getattr(self._tls, "digests", None)
        if stash is not None:
            self._tls.digests = None
            if stash[0] is queries:
                return stash[1]
        return None

    def _request_digests(self, queries: List[Any]) -> List[Optional[str]]:
        """Each query's canonical digest, computed once a request."""
        stashed = self._take_digest_stash(queries)
        if stashed is not None:
            return stashed
        from rafiki_tpu_torch.cache import wire

        return [self._cache_op(lambda q=q: wire.canonical_digest(q), None)
                for q in queries]

    def admission_cost(self, queries: List[Any]) -> int:
        """The queries that will reach a worker (the cache's misses):
        the doors' admission cost. All of them with the cache off or
        while a rollout lane is set (the lane is drawn later)."""
        lane_new, _permille = self._lane_snapshot()
        if lane_new is not None:
            return len(queries)
        plan = self._cache_plan(None)
        if plan is None:
            return len(queries)
        version = plan[0]

        def peek() -> int:
            from rafiki_tpu_torch.predictor import result_cache

            digests = self._request_digests(queries)
            # handed to predict_batch, the door's next call on this thread
            self._tls.digests = (queries, digests)
            return result_cache.get_cache().peek_misses(
                self._job_id, version, digests)

        return self._cache_op(peek, len(queries))

    def _maybe_note_shareable(self, queries: List[Any]) -> None:
        """While the cache is off, one request in 16 hands its first
        query's digest to the cache's duplicate probe."""
        if config.PREDICT_CACHE or not queries:
            return
        if next(self._share_rr) % 16 or not self._cacheable_task():
            return

        def probe() -> None:
            from rafiki_tpu_torch.cache import wire
            from rafiki_tpu_torch.predictor import result_cache

            result_cache.get_cache().note_shareable(
                self._job_id, wire.canonical_digest(queries[0]))

        self._cache_op(probe, None)

    # -- generate ----------------------------------------------------------

    def generate(self, query: Dict[str, Any],
                 timeout_s: Optional[float] = None) -> "_ResumableStream":
        """Route one generation request to a replica's slot scheduler and
        return its stream, resumable, once a slot admits it. Round-robin
        over the job's routable, non-draining replicas, past bounded
        queues that refuse. The request's deadline rides as
        ``max_duration_s``: the worker ends the stream with reason
        ``deadline`` past it. A sampled request without a seed gets one
        here, before its first submit: a seed the worker chose would die
        with the worker, and a resume must replay the same draws. Raises
        :class:`QueueFullError` when every queue refuses, ``TimeoutError``
        when no slot admits the request in time, and the worker's typed
        error for a malformed request."""
        if timeout_s is None:
            timeout_s = config.PREDICT_TIMEOUT_S
        deadline = time.monotonic() + timeout_s
        query = dict(query)
        try:
            sampled = float(query.get("temperature") or 0.0) > 0.0
        except (TypeError, ValueError):
            sampled = False
        if sampled and query.get("seed") is None:
            query["seed"] = uuid.uuid4().int & 0x7FFF_FFFF
        stream, wid, lane, version = self._generate_submit(
            query, deadline, frozenset())
        entry = self._journal_open(query, wid, lane, version, deadline)
        return _ResumableStream(self, entry, stream)

    def _generate_submit(self, query: Dict[str, Any], deadline: float,
                         exclude: "frozenset[str]"):
        """One admission pass: draw the lane, walk the routable replicas
        (less ``exclude``) past full queues and wait for a slot. Returns
        ``(stream, worker_id, lane, model_version)``."""
        queues = self._broker.get_worker_queues(self._job_id)
        if not queues:
            raise RuntimeError(
                f"No inference workers registered for job {self._job_id}")
        trials, draining = self._route_snapshot()
        routable = [w for w in queues
                    if (not trials or w in trials) and w not in draining
                    and w not in exclude]
        if not routable:
            routable = [w for w in queues
                        if (not trials or w in trials) and w not in exclude] \
                or [w for w in queues if w not in exclude] or list(queues)
        # a stream answers from ONE version: a canary-lane stream goes to
        # the new-version replicas only
        lane_new, permille = self._lane_snapshot()
        lane = None
        if lane_new is not None:
            take_new = self._lane_take_new(permille)
            picked = [w for w in routable if (w in lane_new) == take_new]
            if picked:
                routable = picked
                lane = LANE_CANARY if take_new else LANE_INCUMBENT
            else:
                lane = (LANE_CANARY if all(w in lane_new for w in routable)
                        else LANE_INCUMBENT)
        rr = next(self._rr) % len(routable)
        timeout_s = max(deadline - time.monotonic(), 0.0)
        fut = wid = None
        for wid in routable[rr:] + routable[:rr]:
            try:
                fut = queues[wid].submit_many(
                    [dict(query, max_duration_s=timeout_s)],
                    deadline=deadline)[0]
            except QueueFullError:
                continue
            break
        if fut is None:
            self._bump("requests_shed")
            if lane is not None:
                self._lane_record(lane, "shed", 0.0)
            raise QueueFullError(
                f"all serving queues for job {self._job_id} are full")
        t0 = time.monotonic()
        try:
            stream = fut.result(max(deadline - time.monotonic(), 0.0))
        except Exception:
            if lane is not None:
                self._lane_record(lane, "error", time.monotonic() - t0)
            raise
        if lane is not None:
            self._lane_record(lane, "ok", time.monotonic() - t0)
        # the version the stream is pinned to: a resume stays on it
        with self._route_lock:
            if (self._lane_new is not None and wid in self._lane_new
                    and self._lane_version is not None):
                version = self._lane_version
            else:
                version = self._serving_version
        return stream, wid, lane, version

    # -- stream continuity: the journal and the resume -----------------------

    def _journal_open(self, query: Dict[str, Any], worker_id: str,
                      lane: Optional[str], version: int,
                      deadline: float) -> _JournalEntry:
        entry = _JournalEntry(query, worker_id, lane, version, deadline)
        prompt = query.get("prompt_ids")
        n_prompt = len(prompt) if isinstance(prompt, (list, tuple)) else 0
        cost = 8 * n_prompt + 96  # ~8 B a token id and the record
        with self._journal_lock:
            entry.bytes = cost
            self._journal_streams += 1
            self._journal_bytes += cost
        return entry

    def _journal_note(self, entry: _JournalEntry, delta) -> None:
        """Journal one delivered delta. Past ``RAFIKI_GEN_JOURNAL_MAX_KB``
        the stream streams on but can no longer be resumed (its bytes go
        back): a bounded journal cannot prefill what it did not keep."""
        n = len(delta.tokens)
        if n == 0:
            return
        with self._journal_lock:
            if entry.closed or not entry.resumable:
                return
            entry.tokens.extend(delta.tokens)
            entry.bytes += 8 * n
            self._journal_bytes += 8 * n
            cap = int(config.GEN_JOURNAL_MAX_KB) * 1024
            if cap > 0 and entry.bytes > cap:
                entry.resumable = False
                entry.tokens = []
                self._journal_bytes -= entry.bytes
                entry.bytes = 0
                self._continuity["journal_overflows"] += 1

    def _journal_close(self, entry: _JournalEntry,
                       cancelled: bool = False) -> None:
        """Retire an entry (the stream ended, or its client left: then a
        resume in flight gives up instead of prefilling for no one)."""
        with self._journal_lock:
            if cancelled:
                entry.cancelled = True
            if entry.closed:
                return
            entry.closed = True
            entry.tokens = []
            self._journal_streams -= 1
            self._journal_bytes -= entry.bytes
            entry.bytes = 0

    def _journal_fail(self, entry: _JournalEntry) -> None:
        """The client lost the stream (a typed fault, or no resume
        left): retire the entry, count the loss and charge it to the
        stream's lane, so the judge sees deaths mid-stream."""
        with self._journal_lock:
            already = entry.closed
        self._journal_close(entry)
        if not already:
            with self._journal_lock:
                self._continuity["resume_failures"] += 1
            if entry.lane is not None:
                self._lane_record(entry.lane, "error", 0.0)

    def _resume_candidates(self, entry: _JournalEntry):
        """The replicas a stream may resume on: routable, not draining,
        not the one it left, and serving its version (during a rollout
        the lanes are separate resume domains). Raises
        :class:`CrossVersionResumeError` when there is none."""
        queues = self._broker.get_worker_queues(self._job_id)
        trials, draining = self._route_snapshot()
        with self._route_lock:
            lane_new = (set(self._lane_new)
                        if self._lane_new is not None else None)
            lane_version = self._lane_version
            serving = self._serving_version
        routable = [w for w in queues
                    if (not trials or w in trials) and w not in draining
                    and w != entry.worker_id]
        if lane_new is not None:
            if lane_version is not None and entry.version == lane_version \
                    and lane_version != serving:
                cands = [w for w in routable if w in lane_new]
            elif entry.version == serving:
                cands = [w for w in routable if w not in lane_new]
            else:
                cands = []
        else:
            cands = routable if entry.version == serving else []
        if not cands:
            with self._journal_lock:
                self._continuity["cross_version_refusals"] += 1
            raise CrossVersionResumeError(
                f"stream cannot resume: no routable sibling serves its "
                f"model_version {entry.version} (fleet serves "
                f"{serving}" + (f", canary lane {lane_version}"
                                if lane_version is not None else "") + ")")
        return cands, queues

    def _resume_stream(self, entry: _JournalEntry, reason: str):
        """Resume a journaled stream on a sibling: a submit of the prompt
        and the committed tokens at the pinned seed, at most
        ``RAFIKI_GEN_RESUME_MAX`` attempts in the stream's life, with
        jittered backoff (base ``RAFIKI_GEN_RESUME_BACKOFF_S``), within
        the request's deadline and the journal's TTL. Returns the new
        inner stream; raises :class:`GenerationError` (typed) when the
        stream cannot be resumed."""
        max_attempts = int(config.GEN_RESUME_MAX)
        base = max(float(config.GEN_RESUME_BACKOFF_S), 0.0)
        with self._journal_lock:
            ok = entry.resumable and not entry.cancelled and not entry.closed
        if not ok:
            raise GenerationError(
                "stream is not resumable (journal overflowed "
                "RAFIKI_GEN_JOURNAL_MAX_KB, or the client is gone)")
        if max_attempts <= 0:
            raise GenerationError(
                "stream resume is disabled (RAFIKI_GEN_RESUME_MAX=0)")
        if time.monotonic() - entry.t0 > float(config.GEN_JOURNAL_TTL_S):
            raise GenerationError(
                "resume journal entry expired (RAFIKI_GEN_JOURNAL_TTL_S)")
        last_err: Optional[Exception] = None
        while entry.attempts < max_attempts:
            entry.attempts += 1
            if entry.attempts > 1:
                delay = base * (2 ** (entry.attempts - 2)) \
                    * random.uniform(0.5, 1.0)
                delay = min(delay, entry.deadline - time.monotonic())
                if delay > 0:
                    time.sleep(delay)
            with self._journal_lock:
                if entry.cancelled or entry.closed:
                    raise GenerationError(
                        "stream resume abandoned: client disconnected")
                resume_tokens = list(entry.tokens)
            remaining = entry.deadline - time.monotonic()
            if remaining <= 0:
                raise GenerationError(
                    "request deadline passed before the stream could be "
                    "resumed")
            cands, queues = self._resume_candidates(entry)
            rr = next(self._rr) % len(cands)
            for wid in cands[rr:] + cands[:rr]:
                q = dict(entry.query, resume_tokens=resume_tokens,
                         max_duration_s=remaining)
                try:
                    fut = queues[wid].submit_many(
                        [q], deadline=entry.deadline)[0]
                    stream = fut.result(
                        max(entry.deadline - time.monotonic(), 0.0))
                except Exception as e:
                    # a sibling that refuses or fails the resume is walked
                    # past; the bounded attempts own giving up
                    last_err = e
                    continue
                entry.worker_id = wid
                with self._journal_lock:
                    self._continuity[f"resumes_{reason}"] += 1
                logger.info("stream resumed on sibling %s (reason %s, "
                            "attempt %d/%d, %d committed tokens)", wid,
                            reason, entry.attempts, max_attempts,
                            len(resume_tokens))
                return stream
        detail = f": {last_err!r}" if last_err is not None else ""
        raise GenerationError(
            f"stream resume exhausted after {entry.attempts} attempt(s) "
            f"(RAFIKI_GEN_RESUME_MAX={max_attempts}){detail}")

    def gen_continuity_stats(self) -> Dict[str, int]:
        """Resumes by trigger, streams the client lost, journal
        overflows, cross-version refusals, and the journal's streams and
        bytes."""
        with self._journal_lock:
            out = dict(self._continuity)
            out["journal_streams"] = self._journal_streams
            out["journal_bytes"] = self._journal_bytes
        return out


class _ResumableStream:
    """The stream :meth:`Predictor.generate` returns: the worker's
    :class:`~rafiki_tpu_torch.cache.queue.TokenStream` surface
    (``next_delta``, ``cancel``, ``seq_id``), journalling each delta it
    delivers and resuming the stream on a sibling when it dies of an
    infrastructure fault:

    - a ``migrating`` hand-back (:class:`StreamMigratingError`: the
      replica is retiring), or
    - the replica's death: ``next_delta`` timed out and the worker's
      queue is gone from the broker (a killed worker unregisters on its
      way down).

    A time-out while the worker is still registered is a stalled decode
    and goes to the door's stall handling; a plain
    :class:`GenerationError` is the model's fault and is never retried
    (resuming it would replay it)."""

    def __init__(self, predictor: Predictor, entry: _JournalEntry,
                 inner) -> None:
        self._p = predictor
        self._entry = entry
        self._inner = inner

    @property
    def seq_id(self):
        return self._inner.seq_id

    def cancel(self) -> None:
        """The client left: retire the journal entry first, so a resume
        backoff in flight gives up, then cancel the worker's slot."""
        self._p._journal_close(self._entry, cancelled=True)
        self._inner.cancel()

    def next_delta(self, timeout: Optional[float] = None):
        while True:
            try:
                delta = self._inner.next_delta(timeout=timeout)
            except StopIteration:
                self._p._journal_close(self._entry)
                raise
            except StreamMigratingError:
                self._resume_or_raise("migrating")
                continue
            except TimeoutError:
                if self._worker_alive():
                    raise  # a stall: the door's typed frame
                self._resume_or_raise("worker_death")
                continue
            except GenerationError:
                self._p._journal_fail(self._entry)
                raise
            self._p._journal_note(self._entry, delta)
            if delta.finished:
                self._p._journal_close(self._entry)
            return delta

    def _worker_alive(self) -> bool:
        queues = self._p._broker.get_worker_queues(self._p._job_id)
        return self._entry.worker_id in queues

    def _resume_or_raise(self, reason: str) -> None:
        """Swap in a sibling's resumed stream, or retire the journal entry
        and raise typed (a cross-version refusal keeps its type; a
        hand-back never reaches the client as such)."""
        try:
            self._inner = self._p._resume_stream(self._entry, reason)
        except GenerationError as e:
            self._p._journal_fail(self._entry)
            if isinstance(e, StreamMigratingError):
                raise GenerationError(str(e)) from e
            raise
        except Exception as e:
            self._p._journal_fail(self._entry)
            raise GenerationError(
                f"stream died ({reason}) and could not be resumed: "
                f"{e!r}") from e
