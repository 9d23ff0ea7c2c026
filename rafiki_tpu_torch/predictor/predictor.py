"""The predictor: fans a request out to the best trials and ensembles.

Counterpart of the core of ``rafiki_tpu/predictor/predictor.py``
(``add_worker``, ``drop_worker``, ``predict_batch`` and the fan-out and
gather of ``_predict_on``, and ``generate``). One replica per trial
answers each request, round-robin over the trial's replicas; a replica
that refuses (full queue) or fails passes the request to the next replica
of its trial; the answers are ensembled across trials. A generation
request goes to ONE replica and answers with its token stream. Rollout
lanes, the result cache, drift, hedging and the streams' resume journal
are not ported yet (ROADMAP.md): a stream whose worker fails ends with
its typed error.
"""

from __future__ import annotations

import itertools
import logging
import threading
import time
from typing import Any, Dict, List, Optional

from rafiki_tpu_torch import config
from rafiki_tpu_torch.cache.queue import Broker, QueueFullError, TokenStream
from rafiki_tpu_torch.predictor.ensemble import ensemble_predictions

logger = logging.getLogger(__name__)


class Predictor:
    def __init__(self, inference_job_id: str, broker: Broker,
                 task: Optional[str],
                 worker_trials: Optional[Dict[str, str]] = None):
        """``worker_trials`` maps a worker's service id to its trial id. A
        worker not in the map stands alone as its own trial, unless a map
        exists: then an unmapped queue is a replica still warming up, and
        it joins the fan-out when :meth:`add_worker` maps it."""
        self._job_id = inference_job_id
        self._broker = broker
        self._task = task
        self._lock = threading.Lock()
        self._worker_trials = dict(worker_trials or {})  # guarded-by: _lock
        self._rr = itertools.count()

    def add_worker(self, worker_id: str, trial_id: str) -> None:
        """Route requests to a worker from now on."""
        with self._lock:
            self._worker_trials[worker_id] = trial_id

    def drop_worker(self, worker_id: str) -> None:
        """Forget a worker."""
        with self._lock:
            self._worker_trials.pop(worker_id, None)

    def queue_depths(self) -> Dict[str, int]:
        return {wid: q.depth() for wid, q in
                self._broker.get_worker_queues(self._job_id).items()}

    def predict_batch(self, queries: List[Any],
                      timeout_s: Optional[float] = None) -> List[Any]:
        """One prediction per query, ensembled across trials. Raises
        :class:`QueueFullError` when every trial's replicas refuse,
        ``TimeoutError`` when no trial answers in time, ``RuntimeError``
        when no worker is registered."""
        if timeout_s is None:
            timeout_s = config.PREDICT_TIMEOUT_S
        deadline = time.monotonic() + timeout_s
        queues = self._broker.get_worker_queues(self._job_id)
        with self._lock:
            trials = dict(self._worker_trials)
        groups: Dict[str, List[str]] = {}
        for wid in queues:
            if wid in trials or not trials:
                groups.setdefault(trials.get(wid, wid), []).append(wid)
        if not groups:
            raise RuntimeError(
                f"No inference workers registered for job {self._job_id}")
        rr = next(self._rr)
        orders = {t: w[rr % len(w):] + w[:rr % len(w)]
                  for t, w in groups.items()}
        # submit to every trial first, so the trials' workers run at once
        inflight = {}
        for trial, order in orders.items():
            submitted = self._submit(order, queues, queries, deadline)
            if submitted is None:
                logger.info("trial %s shed from this request: every replica "
                            "queue of %s is full", trial, order)
            else:
                inflight[trial] = submitted
        if not inflight:
            raise QueueFullError(
                f"all serving queues for job {self._job_id} are full")
        answered = []
        for trial, (k, futs) in inflight.items():
            preds = self._gather(orders[trial], k, queues, queries, futs,
                                 deadline)
            if preds is not None:
                answered.append(preds)
        if not answered:
            raise TimeoutError("No inference worker answered within the SLO")
        return [ensemble_predictions([preds[i] for preds in answered],
                                     self._task)
                for i in range(len(queries))]

    def generate(self, query: Dict[str, Any],
                 timeout_s: Optional[float] = None) -> TokenStream:
        """Route one generation request to a replica's slot scheduler and
        return its :class:`TokenStream` once a slot admits it. Round-robin
        over the job's replicas, past bounded queues that refuse. The
        request's deadline rides as ``max_duration_s``: the worker ends
        the stream with reason ``deadline`` past it. Raises
        :class:`QueueFullError` when every queue refuses,
        ``TimeoutError`` when no slot admits the request in time, and the
        worker's typed error for a malformed request."""
        if timeout_s is None:
            timeout_s = config.PREDICT_TIMEOUT_S
        deadline = time.monotonic() + timeout_s
        queues = self._broker.get_worker_queues(self._job_id)
        if not queues:
            raise RuntimeError(
                f"No inference workers registered for job {self._job_id}")
        with self._lock:
            trials = dict(self._worker_trials)
        routable = [w for w in queues if not trials or w in trials] \
            or list(queues)
        rr = next(self._rr) % len(routable)
        submitted = self._submit(routable[rr:] + routable[:rr], queues,
                                 [dict(query, max_duration_s=timeout_s)],
                                 deadline)
        if submitted is None:
            raise QueueFullError(
                f"all serving queues for job {self._job_id} are full")
        return submitted[1][0].result(max(deadline - time.monotonic(), 0.0))

    @staticmethod
    def _submit(order: List[str], queues, queries: List[Any],
                deadline: float, start: int = 0):
        """Submit to the first replica from ``order[start:]`` that accepts:
        ``(its index, futures)``, or None when all refuse."""
        for k in range(start, len(order)):
            try:
                return k, queues[order[k]].submit_many(queries,
                                                       deadline=deadline)
            except QueueFullError:
                continue
        return None

    def _gather(self, order: List[str], k: int, queues, queries: List[Any],
                futs, deadline: float) -> Optional[List[Any]]:
        """One trial's predictions; a replica that fails passes the request
        to the next one in ``order``. None when the deadline passes or no
        replica is left."""
        while True:
            try:
                return [f.result(max(deadline - time.monotonic(), 0.0))
                        for f in futs]
            except TimeoutError:
                logger.warning("replica %s did not answer within the SLO",
                               order[k])
                return None
            except Exception as e:
                logger.info("replica %s failed (%r); failing over",
                            order[k], e)
            submitted = self._submit(order, queues, queries, deadline, k + 1)
            if submitted is None:
                return None
            k, futs = submitted
