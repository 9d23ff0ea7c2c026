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
  with its token stream.

Rollout lanes, drift and the streams' resume journal are not ported yet
(ROADMAP.md, items 8 and 15): a stream whose worker fails ends with its
typed error, and the serving version the cache keys on stays 0.
"""

from __future__ import annotations

import itertools
import logging
import threading
import time
from typing import Any, Dict, List, Optional

from rafiki_tpu_torch import config
from rafiki_tpu_torch.cache.queue import (
    Broker,
    QueryFuture,
    QueueFullError,
    TokenStream,
)
from rafiki_tpu_torch.constants import TaskType
from rafiki_tpu_torch.predictor.ensemble import (
    _PROB_TASKS,
    ensemble_predictions,
)

logger = logging.getLogger(__name__)


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
        the fleet's model version, the cache's key (0 until rollouts)."""
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
        # sampled duplicate-query probe while the cache is off
        self._share_rr = itertools.count()
        self._cache_degraded_logged = False
        # the digests admission_cost computed, handed to the serve path
        # on the same thread (one hash pass a request)
        self._tls = threading.local()

    def _bump(self, key: str, n: int = 1) -> None:
        with self._ol_lock:
            self._overload[key] += n

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
                      timeout_s: Optional[float] = None) -> List[Any]:
        """One prediction per query, ensembled across trials. Raises
        :class:`QueueFullError` when every trial's replicas refuse,
        ``TimeoutError`` when no trial answers in time, ``RuntimeError``
        when no worker is registered. With the cache on, hits are
        answered from it and only the misses are forwarded."""
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
        version = self._cache_plan()
        if version is None:
            self._take_digest_stash(queries)
            self._maybe_note_shareable(queries)
            return self._predict_on(queries, queues, routable, trials,
                                    draining, deadline)[0]
        return self._serve_cached(version, queries, queues, routable,
                                  trials, draining, deadline)

    def _predict_on(self, queries: List[Any], queues, routable: List[str],
                    trials: Dict[str, str], draining: set,
                    deadline: float) -> "tuple[List[Any], bool]":
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
                    inflight[trial] = queues[wid].submit_many(
                        queries, deadline=deadline)
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

    def _cache_plan(self) -> Optional[int]:
        """The version to key on, or None to bypass the cache."""
        if not config.PREDICT_CACHE or not self._cacheable_task():
            return None
        return self.serving_version()

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

    def _serve_cached(self, version: int, queries: List[Any], queues,
                      routable: List[str], trials: Dict[str, str],
                      draining: set, deadline: float) -> List[Any]:
        """Hits from the cache, identical misses behind one leader's
        forward, the rest forwarded as one sub-batch, then a fill for
        each resolved query (unless the ensemble was incomplete)."""
        from rafiki_tpu_torch.predictor import result_cache

        cache = result_cache.get_cache()
        job = self._job_id
        epoch = self._cache_op(lambda: cache.epoch(job), 0)
        digests = self._request_digests(queries)
        results: List[Any] = [None] * len(queries)
        single_flight = bool(config.PREDICT_SINGLEFLIGHT)
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
            hit, value = self._cache_op(
                lambda d=d: cache.lookup(job, version, d), (False, None))
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
                miss_preds, complete = self._predict_on(
                    [queries[i] for i in miss_idx], queues, routable,
                    trials, draining, deadline)
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
        return results

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
        the doors' admission cost. All of them with the cache off."""
        version = self._cache_plan()
        if version is None:
            return len(queries)

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
                 timeout_s: Optional[float] = None) -> TokenStream:
        """Route one generation request to a replica's slot scheduler and
        return its :class:`TokenStream` once a slot admits it.
        Round-robin over the job's routable, non-draining replicas, past
        bounded queues that refuse. The request's deadline rides as
        ``max_duration_s``: the worker ends the stream with reason
        ``deadline`` past it. Raises :class:`QueueFullError` when every
        queue refuses, ``TimeoutError`` when no slot admits the request in
        time, and the worker's typed error for a malformed request."""
        if timeout_s is None:
            timeout_s = config.PREDICT_TIMEOUT_S
        deadline = time.monotonic() + timeout_s
        queues = self._broker.get_worker_queues(self._job_id)
        if not queues:
            raise RuntimeError(
                f"No inference workers registered for job {self._job_id}")
        trials, draining = self._route_snapshot()
        routable = [w for w in queues
                    if (not trials or w in trials) and w not in draining]
        if not routable:
            routable = [w for w in queues
                        if not trials or w in trials] or list(queues)
        rr = next(self._rr) % len(routable)
        for wid in routable[rr:] + routable[:rr]:
            try:
                fut = queues[wid].submit_many(
                    [dict(query, max_duration_s=timeout_s)],
                    deadline=deadline)[0]
            except QueueFullError:
                continue
            return fut.result(max(deadline - time.monotonic(), 0.0))
        self._bump("requests_shed")
        raise QueueFullError(
            f"all serving queues for job {self._job_id} are full")
