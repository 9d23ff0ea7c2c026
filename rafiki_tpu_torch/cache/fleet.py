"""The serving data plane across hosts: remote worker queues over agents.

Own copy of ``rafiki_tpu/cache/fleet.py``. A serving worker placed on a
host agent attaches to that agent's shm rings; what crosses hosts is one
HTTP hop::

    predictor (admin)
        HttpWorkerQueue.submit_many(queries) -> QueryFutures
            the sender thread coalesces what is pending into ONE
            POST /predict_relay/<job>/<worker> on the worker's agent
            (placement/agent.py), which submits the batch to its shm
            queue and answers once the worker has resolved it.

A burst of submits becomes one relay request, so the hop costs one round
trip a batch. :class:`FleetBroker` merges these remote queues with a
host-local broker behind the ``Broker`` seam, so the predictor's
trial-grouped, hedged fan-out works across hosts unchanged.

Binary frames (``cache/wire.py``) are used once the agent's ``/healthz``
advertised a codec version this package speaks (one probe a queue); a
peer that advertises none gets JSON. Differences from the original: JSON
rows that form one float array (what the admin door's JSON body decodes
to) cross a binary relay as that array, float64, as the shm rings carry
them (the original stacks ndarray rows only).

A sampled request's trace context rides the relay body as ``trace`` (the
first sampled entry's, when a relay coalesces several requests); the
agent answers its half of the span tree as ``trace_spans``, which are
grafted onto the door's tree, re-anchored at this side's submit time.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from rafiki_tpu_torch import config
from rafiki_tpu_torch.cache import wire
from rafiki_tpu_torch.cache.queue import Broker, QueryFuture, QueueFullError
from rafiki_tpu_torch.utils.agent_http import (
    AgentHTTPError,
    AgentTransportError,
    call_agent,
)
from rafiki_tpu_torch.utils.metrics import REGISTRY

logger = logging.getLogger(__name__)

#: most queries one relay request carries
RELAY_MAX_BATCH = 4 * config.PREDICT_MAX_BATCH_SIZE


class HttpWorkerQueue:
    """A worker queue whose worker runs on another host's agent.

    ``submit_many`` never blocks: the queries wait in a pending list that
    a sender thread drains, everything pending at a drain in one relay
    POST. One relay at a time a worker, as the worker serves one batch at
    a time; replicas run in parallel through the predictor's fan-out."""

    def __init__(self, agent_addr: str, inference_job_id: str,
                 worker_id: str, key: Optional[str] = None,
                 timeout_s: Optional[float] = None):
        self.agent_addr = agent_addr  # eviction goes by host
        self._job_id = inference_job_id
        self._worker_id = worker_id
        self._key = key
        # the worker-side deadline travels with each relay; the transport
        # waits 5 s longer, so the worker's answer or error wins the race
        self._worker_timeout_s = (timeout_s if timeout_s is not None
                                  else float(config.PREDICT_TIMEOUT_S))
        self._timeout_s = self._worker_timeout_s + 5.0
        # None: the agent's codec versions not probed yet
        self._wire_ok: Optional[bool] = None
        self._cond = threading.Condition()
        self._pending: List[Tuple[QueryFuture, Any, Optional[float]]] = []
        self._inflight = 0  # queries of the relay under way
        self._expired = 0
        self._rejected = 0
        self._m_expired = REGISTRY.counter(
            "rafiki_queue_expired_total",
            "queries dropped past their deadline in a worker queue")
        self._m_rejected = REGISTRY.counter(
            "rafiki_queue_rejected_total",
            "queries refused by a bounded worker queue's depth cap")
        self._closed = False
        self._thread = threading.Thread(
            target=self._sender, daemon=True,
            name=f"relay-{worker_id[:8]}@{agent_addr}")
        self._thread.start()

    def depth(self) -> int:
        """Pending queries and those riding the relay under way (the
        remote worker is busy with them)."""
        with self._cond:
            return len(self._pending) + self._inflight

    def stats(self) -> Dict[str, int]:
        with self._cond:
            return {"depth": len(self._pending) + self._inflight,
                    "expired": self._expired, "rejected": self._rejected}

    def submit(self, query: Any,
               deadline: Optional[float] = None) -> QueryFuture:
        return self.submit_many([query], deadline=deadline)[0]

    def submit_many(self, queries: List[Any],
                    deadline: Optional[float] = None,
                    trace=None) -> List[QueryFuture]:
        """Enqueue one request's queries at once (one lock, one wake-up),
        so they travel in one relay. Bounded as a local queue is
        (``RAFIKI_PREDICT_QUEUE_DEPTH`` counts pending and in-flight): a
        stalled host sheds here, never grows a relay backlog. A sampled
        request's ``trace`` rides its futures to the sender."""
        with self._cond:
            if self._closed:
                futs = [QueryFuture() for _ in queries]
                for fut in futs:
                    fut.set_error(RuntimeError("remote worker queue closed"))
                return futs
            cap = int(config.PREDICT_QUEUE_DEPTH)
            queued = len(self._pending) + self._inflight
            if cap > 0 and queued + len(queries) > cap:
                self._rejected += len(queries)
                self._m_rejected.inc(len(queries))
                raise QueueFullError(
                    f"relay queue to {self.agent_addr} full "
                    f"({queued}/{cap})")
            futs = [QueryFuture() for _ in queries]
            if trace is not None:
                trace.mark_submitted()
                for fut in futs:
                    fut.trace = trace
            self._pending.extend(
                (fut, q, deadline) for fut, q in zip(futs, queries))
            self._cond.notify()
        return futs

    def _sender(self) -> None:
        while True:
            with self._cond:
                while not self._pending and not self._closed:
                    self._cond.wait()
                if self._closed:
                    # close() failed every pending future already
                    return
                now = time.monotonic()
                batch = []
                while len(batch) < RELAY_MAX_BATCH and self._pending:
                    fut, q, dl = self._pending.pop(0)
                    if dl is not None and now >= dl:
                        # expired while pending: not worth a relay slot
                        self._expired += 1
                        self._m_expired.inc()
                        fut.set_error(TimeoutError(
                            "query expired in the relay queue before send"))
                        continue
                    batch.append((fut, q))
                self._inflight = len(batch)
            if not batch:
                continue
            futures = [f for f, _ in batch]
            # one context a relay: the first sampled entry's
            trace = next((f.trace for f in futures if f.trace is not None),
                         None)
            try:
                preds = self._relay([q for _, q in batch], trace=trace)
                if len(preds) != len(futures):
                    raise RuntimeError(
                        f"relay returned {len(preds)} predictions for "
                        f"{len(futures)} queries")
                for fut, pred in zip(futures, preds):
                    fut.set_result(pred)
            # lint: absorb(the error reaches every waiter via fut.set_error)
            except Exception as e:
                for fut in futures:
                    fut.set_error(e)
            finally:
                with self._cond:
                    self._inflight = 0

    def _wire_supported(self) -> bool:
        """One lazy ``/healthz`` probe decides whether this relay sends
        binary frames; an unreachable peer stays on JSON and is probed
        again at a later relay (only an answer is cached)."""
        if self._wire_ok is None:
            try:
                h = call_agent(self.agent_addr, "GET", "/healthz",
                               timeout_s=min(self._timeout_s, 5.0))
                advertised = set(h.get("wire_versions") or [])
                self._wire_ok = bool(advertised & wire.SUPPORTED_VERSIONS)
            # lint: absorb(an unprobeable peer gets JSON until the next probe)
            except Exception:
                return False
        return bool(self._wire_ok)

    def _relay(self, queries: List[Any], trace=None) -> List[Any]:
        binary = self._wire_supported()
        payload: Any = queries
        if binary:
            # same-shaped rows travel as ONE stacked array (JSON rows of
            # one float array too, as the shm rings carry them)
            stacked = wire.stack_rows(queries)
            if stacked is not None:
                payload = stacked
        body = {"queries": payload, "timeout_s": self._worker_timeout_s}
        if trace is not None:
            # in the body, not a frame header: an agent that knows no
            # trace ignores the key and serves the relay
            body["trace"] = trace.ctx.to_wire()
        try:
            out = call_agent(
                self.agent_addr, "POST",
                f"/predict_relay/{self._job_id}/{self._worker_id}",
                body=body, key=self._key, timeout_s=self._timeout_s,
                wire_frames=binary)
            if trace is not None and isinstance(out, dict) \
                    and out.get("trace_spans") is not None:
                # the agent's offsets are against its own submit: at ours,
                # the relay's transit folds into the first span's offset
                trace.add_wire_spans(out["trace_spans"],
                                     anchor=trace.t_submit)
            return list(out["predictions"])
        except AgentHTTPError as e:
            raise RuntimeError(
                f"relay {self.agent_addr}: {e.message}") from None
        except AgentTransportError as e:
            raise RuntimeError(f"relay unreachable: {e}") from None

    def close(self, join_timeout_s: float = 1.0) -> None:
        """Fail everything pending and stop the sender. A relay under way
        may hold the (daemon) thread up to its transport timeout; the join
        is bounded and never waits that out."""
        with self._cond:
            self._closed = True
            for fut, _, _ in self._pending:
                fut.set_error(RuntimeError("remote worker queue closed"))
            self._pending.clear()
            self._cond.notify_all()
        if self._thread is not threading.current_thread():
            self._thread.join(timeout=join_timeout_s)


class FleetBroker(Broker):
    """A host-local broker plus the remote queues of agent-placed workers.

    Local workers register through the wrapped broker as before; the host
    placement registers a remote worker here when it places a serving
    executor on an agent (``placement/hosts.py``). ``get_worker_queues``
    merges both, so the predictor does not know where a worker runs."""

    def __init__(self, base: Broker):
        self._base = base
        self._lock = threading.Lock()
        # job id -> worker id -> its relay queue
        self._remote: Dict[str, Dict[str, HttpWorkerQueue]] = {}  # guarded-by: _lock

    def register_worker(self, inference_job_id: str, worker_id: str):
        return self._base.register_worker(inference_job_id, worker_id)

    def unregister_worker(self, inference_job_id: str,
                          worker_id: str) -> None:
        with self._lock:
            q = self._remote.get(inference_job_id, {}).pop(worker_id, None)
        if q is not None:
            q.close()
            return
        self._base.unregister_worker(inference_job_id, worker_id)

    def get_worker_queues(self, inference_job_id: str) -> Dict[str, Any]:
        out: Dict[str, Any] = dict(
            self._base.get_worker_queues(inference_job_id))
        with self._lock:
            out.update(self._remote.get(inference_job_id, {}))
        return out

    def register_remote_worker(self, inference_job_id: str, worker_id: str,
                               agent_addr: str,
                               key: Optional[str] = None) -> HttpWorkerQueue:
        q = HttpWorkerQueue(agent_addr, inference_job_id, worker_id, key=key)
        with self._lock:
            jobs = self._remote.setdefault(inference_job_id, {})
            old = jobs.get(worker_id)
            jobs[worker_id] = q
        if old is not None:
            old.close()
        return q

    def evict_agent(self, agent_addr: str) -> List[Tuple[str, str]]:
        """Drop and close every relay queue of ``agent_addr`` (a host
        marked DOWN), so the fan-out stops spending deadline on replicas
        that cannot answer. Returns the (job id, worker id) pairs."""
        evicted: List[Tuple[Tuple[str, str], HttpWorkerQueue]] = []
        with self._lock:
            for job_id, queues in self._remote.items():
                for wid, q in list(queues.items()):
                    if q.agent_addr == agent_addr:
                        queues.pop(wid)
                        evicted.append(((job_id, wid), q))
        for _, q in evicted:
            q.close(join_timeout_s=0.0)  # a dead host: never wait on it
        return [pair for pair, _ in evicted]

    @property
    def prefix(self):
        """The wrapped broker's shm namespace, None without one."""
        return getattr(self._base, "prefix", None)

    def close(self) -> None:
        with self._lock:
            remote, self._remote = self._remote, {}
        for queues in remote.values():
            for q in queues.values():
                q.close()
        if hasattr(self._base, "close"):
            self._base.close()
