"""Cross-process serving broker over the native shared-memory queue.

Own copy of ``rafiki_tpu/cache/shm_broker.py``. ``InProcessBroker``
(``cache/queue.py``) hands queries between threads of one process; this
broker carries the same traffic between processes on one host through
:mod:`rafiki_tpu_torch.native.shm_queue`. Ring names are deterministic in
(prefix, job, worker), so a worker process attaches knowing only its ids.

Wire format (``cache/wire.py``): one binary frame per request each way,
``{"ids": [...], "qarr": <stacked ndarray> | "queries": [...],
"deadline": ...}`` on the worker's query ring and ``{"ids": [...],
"results": [...], "errors": {...}}`` on the job's response ring, so a
request lands in a worker as one batch. Receivers sniff every message
(binary frame or JSON), so legacy per-query JSON peers interoperate, and
responses echo the format their query frame came in. A listener thread on
the predictor side resolves the :class:`QueryFuture`\\ s by id.

Differences from the original:

- No fallback: :func:`make_broker` under ``RAFIKI_BROKER=shm`` returns a
  ``ShmBroker`` or raises (a library that cannot be built raises
  ``NativeBuildError``, a ring that cannot be created ``OSError``).
- A request of JSON rows (what the admin door's JSON body decodes to)
  that form one float array travels as that array (float64, which holds
  every JSON number exactly) instead of as JSON text inside the frame's
  header: a 224x224x3 image is 1.2 MB of array instead of ~3 MB of text
  parsed again by the worker. The worker's model gets ndarray rows; the
  port's templates take either.
- Not ported: the chaos hooks (ROADMAP.md A.12), the metrics registry
  (A.12; the same counters are in :meth:`ShmWorkerQueue.stats` and
  :meth:`ShmBroker.stats`) and the trace spans (the tracer is not
  ported).
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from rafiki_tpu_torch import config
from rafiki_tpu_torch.cache import wire
from rafiki_tpu_torch.cache.queue import (
    Broker,
    FrameTooLargeError,
    InProcessBroker,
    QueryFuture,
    QueueFullError,
)
from rafiki_tpu_torch.native.shm_queue import (
    ShmMessageQueue,
    ShmQueueClosed,
    library,
)
from rafiki_tpu_torch.utils.jsonutil import json_default

logger = logging.getLogger(__name__)


def _qname(prefix: str, *parts: str) -> str:
    digest = hashlib.sha256("|".join(parts).encode()).hexdigest()[:24]
    return f"/{prefix}-{digest}"


def _encode_query_frame(ids: List[str], queries: List[Any],
                        deadline: Optional[float]) -> bytes:
    """One binary frame for a whole request, its rows stacked into one
    array where they form one."""
    msg: Dict[str, Any] = {"ids": ids}
    if deadline is not None:
        msg["deadline"] = deadline
    stacked = wire.stack_rows(queries)
    if stacked is not None:
        msg["qarr"] = stacked
    else:
        msg["queries"] = queries
    return wire.encode(msg)


def _decode_query_frame(raw: bytes) -> Tuple[
        List[Tuple[str, Any, Optional[float]]], bool]:
    """One popped query message -> ([(qid, query, deadline), ...],
    arrived_binary). Takes the batched binary frame, the batched JSON
    message (a JAX-package submitter under ``RAFIKI_WIRE_BINARY=0``) and
    the legacy per-query ``{"id", "query"}`` message. Raises
    WireFormatError on garbage."""
    binary = wire.is_frame(raw)
    msg = wire.decode_any(raw)
    if not isinstance(msg, dict):
        raise wire.WireFormatError("query frame is not an object")
    try:
        # the frame decoded, but each field is still untrusted: ids must be
        # strings and the deadline a number, or the frame is malformed
        deadline = msg.get("deadline")
        if deadline is not None:
            deadline = float(deadline)
        if "id" in msg:  # legacy single-query message
            if not isinstance(msg["id"], str):
                raise wire.WireFormatError("query id is not a string")
            return [(msg["id"], msg["query"], deadline)], binary
        ids = msg["ids"]
        if (not isinstance(ids, list)
                or not all(isinstance(i, str) for i in ids)):
            raise wire.WireFormatError("ids must be a list of strings")
        if "qarr" in msg:
            qarr = msg["qarr"]
            if isinstance(qarr, np.ndarray) and qarr.ndim >= 1:
                queries: List[Any] = list(qarr)  # zero-copy row views
            elif isinstance(qarr, list):
                queries = qarr  # a JSON-framed qarr: rows stay rows
            else:
                raise wire.WireFormatError("qarr is not a batch")
        else:
            queries = msg["queries"]
        if not isinstance(queries, (list, np.ndarray)) \
                or len(queries) != len(ids):
            raise wire.WireFormatError("queries/ids length mismatch")
        return [(qid, q, deadline) for qid, q in zip(ids, queries)], binary
    except (KeyError, TypeError, ValueError) as e:
        if isinstance(e, wire.WireFormatError):
            raise
        raise wire.WireFormatError(f"malformed query frame: {e}") from e


class _FrameResponder:
    """Collects one query frame's answers and pushes them as one message in
    the format the frame came in (a binary frame gets one batched binary
    response; a legacy JSON message per-id JSON messages), once every id
    is resolved. A push that fails (full ring, broker closing) is logged,
    never raised into the worker loop: the predictor's deadline covers a
    lost response."""

    __slots__ = ("_rq", "_ids", "_binary", "_lock", "_out")

    def __init__(self, rq: ShmMessageQueue, ids: List[str], binary: bool):
        self._rq = rq
        self._ids = ids
        self._binary = binary
        self._lock = threading.Lock()
        self._out: Dict[str, Tuple[str, Any]] = {}

    def resolve(self, qid: str, kind: str, value: Any) -> None:
        with self._lock:
            if qid in self._out:
                return  # the first resolution wins
            self._out[qid] = (kind, value)
            if len(self._out) < len(self._ids):
                return
        self._flush()

    def _flush(self) -> None:
        try:
            if self._binary:
                results: List[Any] = []
                errors: Dict[str, str] = {}
                for i, qid in enumerate(self._ids):
                    kind, value = self._out[qid]
                    if kind == "error":
                        errors[str(i)] = value
                        results.append(None)
                    else:
                        results.append(value)
                msg: Dict[str, Any] = {"ids": self._ids, "results": results}
                if errors:
                    msg["errors"] = errors
                self._rq.push(wire.encode(msg))
            else:
                for qid in self._ids:
                    kind, value = self._out[qid]
                    payload = ({"id": qid, "error": value} if kind == "error"
                               else {"id": qid, "result": value})
                    self._rq.push(json.dumps(
                        payload, default=json_default).encode())
        except Exception:
            logger.exception("dropping response frame for %d queries",
                             len(self._ids))


class ShmWorkerQueue:
    """The worker's side: takes query batches, pushes responses.

    Duck-types :class:`~rafiki_tpu_torch.cache.queue.WorkerQueue`'s
    ``take_batch``, yielding (ResponseHandle, query) pairs: a handle
    writes into its frame's shared responder instead of resolving a
    future of this process."""

    class ResponseHandle:
        __slots__ = ("_responder", "_id")

        def __init__(self, responder: _FrameResponder, qid: str):
            self._responder = responder
            self._id = qid

        def set_result(self, value: Any) -> None:
            self._responder.resolve(self._id, "result", value)

        def set_error(self, error: BaseException) -> None:
            self._responder.resolve(self._id, "error", str(error))

    def __init__(self, query_q: ShmMessageQueue, response_q: ShmMessageQueue):
        self._qq = query_q
        self._rq = response_q
        self._wire_errors = 0  # undecodable frames dropped
        self._expired = 0  # queries past their deadline when taken

    @classmethod
    def attach(cls, prefix: str, inference_job_id: str,
               worker_id: str) -> "ShmWorkerQueue":
        """Open the rings from another process by their names."""
        qq = ShmMessageQueue(
            _qname(prefix, "q", inference_job_id, worker_id), create=False)
        try:
            rq = ShmMessageQueue(_qname(prefix, "r", inference_job_id),
                                 create=False)
        except Exception:
            qq.destroy()
            raise
        return cls(qq, rq)

    def stats(self) -> Dict[str, int]:
        """Frames dropped as undecodable, queries expired before serving,
        bytes in the query ring and the ring high-water mark of this
        handle's pushes (a worker process pushes only responses)."""
        qr, rr = self._qq.stats(), self._rq.stats()
        return {"wire_errors": self._wire_errors, "expired": self._expired,
                "ring_used_bytes": qr["used_bytes"],
                "ring_used_bytes_hw": max(qr["used_bytes_hw"],
                                          rr["used_bytes_hw"])}

    def _pop_decoded(self, timeout_s: float) -> Optional[Tuple[
            List[Tuple[str, Any, Optional[float]]], bool]]:
        """Pop and decode one query frame; None on timeout. A frame that
        fails to decode is counted and comes back empty: its submitter's
        deadline covers its queries, and the worker loop goes on."""
        raw = self._qq.pop(timeout_s=timeout_s)
        if raw is None:
            return None
        try:
            return _decode_query_frame(raw)
        except wire.WireFormatError as e:
            self._wire_errors += 1
            logger.error("dropping undecodable query frame on %s: %s",
                         self._qq.name, e)
            return [], False

    def take_batch(self, max_size: int, deadline_s: float,
                   wait_timeout_s: float = 0.5
                   ) -> Optional[List[Tuple["ShmWorkerQueue.ResponseHandle",
                                            Any]]]:
        """[] on timeout, None once the ring is closed and drained (the
        contract of ``WorkerQueue.take_batch``). One frame carries a whole
        request; frames already in the ring are drained until ``max_size``
        queries (a frame larger than ``max_size`` is served whole:
        requests are admitted as units), waiting up to ``deadline_s`` for
        more."""
        try:
            first = self._pop_decoded(timeout_s=wait_timeout_s)
        except ShmQueueClosed:
            return None
        if first is None:
            return []
        groups = [first]
        n_entries = len(first[0])
        t0 = time.monotonic()
        while n_entries < max_size:
            # what is already in the ring comes out without a wait; the
            # deadline is only an optional coalescing wait
            try:
                nxt = self._pop_decoded(timeout_s=0)
                if nxt is None:
                    remaining = deadline_s - (time.monotonic() - t0)
                    if remaining <= 0:
                        break
                    nxt = self._pop_decoded(timeout_s=remaining)
            except ShmQueueClosed:
                break
            if nxt is None:
                break
            groups.append(nxt)
            n_entries += len(nxt[0])
        out: List[Tuple[ShmWorkerQueue.ResponseHandle, Any]] = []
        now = time.monotonic()
        for entries, binary in groups:
            if not entries:
                continue  # a corrupt frame, already counted
            responder = _FrameResponder(
                self._rq, [qid for qid, _, _ in entries], binary)
            for qid, query, deadline in entries:
                handle = self.ResponseHandle(responder, qid)
                # CLOCK_MONOTONIC is system-wide on one host, so the
                # submitter's absolute deadline compares here directly
                if deadline is not None and now >= deadline:
                    self._expired += 1
                    handle.set_error(TimeoutError(
                        "query expired in the shm queue before dispatch"))
                    continue
                out.append((handle, query))
        return out


class _SubmitProxy:
    """The predictor's view of one worker's query ring. The broker counts
    each worker's outstanding queries (submitted, not yet answered):
    ``depth()`` reads it, and ``submit_many`` enforces
    ``RAFIKI_PREDICT_QUEUE_DEPTH`` on it with the in-process queue's
    :class:`QueueFullError` contract (a ring cannot be asked its message
    count)."""

    def __init__(self, broker: "ShmBroker", job_id: str, worker_id: str,
                 query_q: ShmMessageQueue):
        self._broker = broker
        self._job_id = job_id
        self._worker_id = worker_id
        self._qq = query_q

    def depth(self) -> int:
        return self._broker._outstanding_count(self._job_id, self._worker_id)

    def submit_many(self, queries: List[Any],
                    deadline: Optional[float] = None) -> List[QueryFuture]:
        """One frame per request, so it lands as one worker batch. The
        depth cap admits or refuses the request whole, and the reservation
        is taken with the check (released on response, push failure or
        expiry). A ring full past the push timeout raises the retryable
        :class:`QueueFullError`; a frame larger than the ring
        :class:`FrameTooLargeError` (413 at the door)."""
        self._broker._reserve_capacity(self._job_id, self._worker_id,
                                       len(queries))
        ids = [uuid.uuid4().hex for _ in queries]
        futs = [QueryFuture() for _ in queries]
        for qid, fut in zip(ids, futs):
            # an absolute monotonic deadline, comparable in the worker
            self._broker._register_pending(self._job_id, self._worker_id,
                                           qid, fut, deadline)
        try:
            self._qq.push(_encode_query_frame(ids, queries, deadline))
        except BaseException as e:
            for qid in ids:
                self._broker._pop_pending(self._job_id, qid)
            if isinstance(e, TimeoutError):
                raise QueueFullError(
                    f"shm ring to worker {self._worker_id} full "
                    f"({self._qq.stats()['used_bytes']}B used)") from e
            if isinstance(e, ValueError):
                raise FrameTooLargeError(
                    f"request frame for {len(queries)} queries exceeds the "
                    f"shm ring capacity (RAFIKI_SHM_RING_BYTES): split the "
                    f"request or raise the ring size: {e}") from e
            for fut in futs:
                fut.set_error(e)
            if not isinstance(e, Exception):
                raise
        return futs


class ShmBroker(Broker):
    """The owner's (predictor process's) side of the shm data plane: it
    creates the rings, and unlinks them at :meth:`close`."""

    def __init__(self):
        #: the namespace of this broker's rings in /dev/shm
        self.prefix = f"rafiki{uuid.uuid4().hex[:8]}"
        self._lock = threading.Lock()
        self._query_qs: Dict[str, Dict[str, ShmMessageQueue]] = {}
        self._response_qs: Dict[str, ShmMessageQueue] = {}
        # qid -> (future, worker_id, expiry): worker_id feeds the per-worker
        # outstanding count, expiry lets a query no one answers (its worker
        # died mid-batch) stop counting against the cap
        self._pending: Dict[str, Dict[str, Tuple[QueryFuture, str,
                                                 float]]] = {}
        self._outstanding: Dict[Tuple[str, str], int] = {}
        self._listeners: Dict[str, threading.Thread] = {}
        self._graveyard: List[ShmMessageQueue] = []
        self._wire_errors = 0  # undecodable response frames dropped
        self._rejected = 0  # queries refused by the depth cap
        self._expired = 0  # outstanding queries pruned unanswered
        self._closed = False
        library()  # fails here, not at the first deploy, if it cannot build

    # -- Broker interface --------------------------------------------------

    def register_worker(self, inference_job_id: str,
                        worker_id: str) -> ShmWorkerQueue:
        with self._lock:
            rq = self._ensure_response_queue(inference_job_id)
            qq = ShmMessageQueue(
                _qname(self.prefix, "q", inference_job_id, worker_id))
            self._query_qs.setdefault(inference_job_id, {})[worker_id] = qq
        # a worker thread of this process shares the owner's handles; a
        # worker process attaches (ShmBrokerClient)
        return ShmWorkerQueue(qq, rq)

    def unregister_worker(self, inference_job_id: str,
                          worker_id: str) -> None:
        with self._lock:
            qq = self._query_qs.get(inference_job_id, {}).pop(worker_id, None)
            if qq is not None:
                # close only: a _SubmitProxy taken before this call may still
                # hold the handle, and destroy() unmaps under it (a closed
                # push fails cleanly, an unmapped one segfaults); the
                # segment goes at close()
                qq.close()
                self._graveyard.append(qq)

    def get_worker_queues(self, inference_job_id: str) -> Dict[str, Any]:
        with self._lock:
            return {wid: _SubmitProxy(self, inference_job_id, wid, qq)
                    for wid, qq in self._query_qs.get(
                        inference_job_id, {}).items()}

    def stats(self) -> Dict[str, int]:
        """The owner's counters: queries refused by the depth cap, queries
        pruned unanswered, undecodable response frames."""
        with self._lock:
            return {"rejected": self._rejected, "expired": self._expired,
                    "wire_errors": self._wire_errors}

    # -- response plumbing -------------------------------------------------

    def _ensure_response_queue(  # guarded-by: _lock
            self, job_id: str) -> ShmMessageQueue:
        if job_id not in self._response_qs:
            rq = ShmMessageQueue(_qname(self.prefix, "r", job_id))
            self._response_qs[job_id] = rq
            self._pending[job_id] = {}
            t = threading.Thread(target=self._listen, args=(job_id, rq),
                                 name=f"shm-listener-{job_id[:8]}",
                                 daemon=True)
            self._listeners[job_id] = t
            t.start()
        return self._response_qs[job_id]

    def _register_pending(self, job_id: str, worker_id: str, qid: str,
                          fut: QueryFuture,
                          deadline: Optional[float]) -> None:
        """Record one reserved query's future (its outstanding slot was
        taken by _reserve_capacity). It expires 30 s past the request's
        deadline (or the default SLO): a query never answered must stop
        counting against the cap, or one crash pins the replica full."""
        expiry = (deadline if deadline is not None
                  else time.monotonic() + config.PREDICT_TIMEOUT_S) + 30.0
        with self._lock:
            self._pending.setdefault(job_id, {})[qid] = (fut, worker_id,
                                                         expiry)

    def _pop_pending(self, job_id: str, qid: str) -> Optional[QueryFuture]:
        with self._lock:
            entry = self._pending.get(job_id, {}).pop(qid, None)
            if entry is None:
                return None
            fut, worker_id, _ = entry
            self._dec_outstanding_locked(job_id, worker_id)
            return fut

    def _dec_outstanding_locked(self, job_id: str,  # guarded-by: _lock
                                worker_id: str) -> None:
        key = (job_id, worker_id)
        n = self._outstanding.get(key, 0) - 1
        if n <= 0:
            self._outstanding.pop(key, None)
        else:
            self._outstanding[key] = n

    def _prune_expired_locked(self, job_id: str,  # guarded-by: _lock
                              worker_id: str) -> None:
        """Drop unanswered entries past their expiry. Runs on every read
        of the count, not only at submits, so a replica whose phantom
        queries fill its cap frees itself."""
        now = time.monotonic()
        job_pending = self._pending.get(job_id, {})
        for qid, (_, wid, expiry) in list(job_pending.items()):
            if wid == worker_id and now >= expiry:
                job_pending.pop(qid)
                self._dec_outstanding_locked(job_id, wid)
                self._expired += 1

    def _outstanding_count(self, job_id: str, worker_id: str) -> int:
        with self._lock:
            if self._outstanding.get((job_id, worker_id), 0) > 0:
                self._prune_expired_locked(job_id, worker_id)
            return self._outstanding.get((job_id, worker_id), 0)

    def _reserve_capacity(self, job_id: str, worker_id: str, n: int) -> None:
        """Check RAFIKI_PREDICT_QUEUE_DEPTH and claim ``n`` outstanding
        slots under one lock hold (a check-then-claim split would let
        concurrent submitters overshoot the cap together)."""
        cap = int(config.PREDICT_QUEUE_DEPTH)
        key = (job_id, worker_id)
        with self._lock:
            if self._outstanding.get(key, 0) > 0:
                self._prune_expired_locked(job_id, worker_id)
            queued = self._outstanding.get(key, 0)
            if cap > 0 and queued + n > cap:
                self._rejected += n
                raise QueueFullError(f"shm worker {worker_id} full "
                                     f"({queued}/{cap} outstanding)")
            self._outstanding[key] = queued + n

    def _resolve_response(self, job_id: str, msg: Any) -> None:
        """Resolve the futures of one decoded response: a batched frame
        ({"ids", "results", "errors"}) or a legacy per-id JSON message.
        Every field is checked before pending state is touched: a frame
        that decodes but is malformed raises the one typed error
        ``_listen`` absorbs."""
        if not isinstance(msg, dict):
            raise wire.WireFormatError("response frame is not an object")
        if "id" in msg:  # legacy single-response message
            if not isinstance(msg["id"], str):
                raise wire.WireFormatError("response id is not a string")
            fut = self._pop_pending(job_id, msg["id"])
            if fut is None:
                return
            if "error" in msg:
                fut.set_error(RuntimeError(msg["error"]))
            else:
                fut.set_result(msg.get("result"))
            return
        try:
            ids = msg["ids"]
            results = msg["results"]
            errors = msg.get("errors") or {}
            if (not isinstance(ids, list)
                    or not all(isinstance(i, str) for i in ids)
                    or not isinstance(results, list)
                    or not isinstance(errors, dict)
                    or len(results) != len(ids)):
                raise wire.WireFormatError("malformed response frame")
        except (KeyError, TypeError) as e:
            raise wire.WireFormatError(
                f"malformed response frame: {e}") from e
        for i, qid in enumerate(ids):
            fut = self._pop_pending(job_id, qid)
            if fut is None:
                continue
            err = errors.get(str(i))
            if err is not None:
                fut.set_error(RuntimeError(err))
            else:
                fut.set_result(results[i])

    def _listen(self, job_id: str, rq: ShmMessageQueue) -> None:
        while not self._closed:
            try:
                raw = rq.pop(timeout_s=0.5)
            except ShmQueueClosed:
                break
            except Exception:
                logger.exception("response listener %s died", job_id)
                break
            if raw is None:
                continue
            try:
                self._resolve_response(job_id, wire.decode_any(raw))
            except wire.WireFormatError as e:
                # its futures keep waiting and end with the request's own
                # TimeoutError; the listener outlives any bad message
                with self._lock:
                    self._wire_errors += 1
                logger.error("dropping undecodable response frame on %s: "
                             "%s", job_id, e)

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        """Close and unlink every ring; pending futures fail."""
        self._closed = True
        with self._lock:
            for queues in self._query_qs.values():
                for qq in queues.values():
                    qq.close()
                    qq.destroy()
            self._query_qs.clear()
            for qq in self._graveyard:
                qq.destroy()
            self._graveyard.clear()
            for rq in self._response_qs.values():
                rq.close()
        for t in self._listeners.values():
            t.join(timeout=2.0)
        with self._lock:
            for rq in self._response_qs.values():
                rq.destroy()
            self._response_qs.clear()
            for pend in self._pending.values():
                for fut, _, _ in pend.values():
                    fut.set_error(RuntimeError("broker closed"))
            self._pending.clear()
            self._outstanding.clear()


class ShmBrokerClient:
    """The worker process's side of the shm data plane.

    The owner (:class:`ShmBroker`, in the admin process) creates the rings
    when a serving service is placed; a worker process attaches to them by
    name. ``register_worker`` therefore attaches (retrying while the owner
    may still be creating them) and ``unregister_worker`` detaches without
    closing: the rings belong to the owner, so a restarted worker can
    attach again."""

    def __init__(self, prefix: str, attach_timeout_s: float = 10.0):
        self.prefix = prefix
        self._attach_timeout_s = attach_timeout_s
        self._queues: Dict[Tuple[str, str], ShmWorkerQueue] = {}

    def register_worker(self, inference_job_id: str,
                        worker_id: str) -> ShmWorkerQueue:
        deadline = time.monotonic() + self._attach_timeout_s
        while True:
            try:
                wq = ShmWorkerQueue.attach(self.prefix, inference_job_id,
                                           worker_id)
                break
            except OSError:
                if time.monotonic() >= deadline:
                    raise
                time.sleep(0.05)
        self._queues[(inference_job_id, worker_id)] = wq
        return wq

    def unregister_worker(self, inference_job_id: str,
                          worker_id: str) -> None:
        wq = self._queues.pop((inference_job_id, worker_id), None)
        if wq is not None:
            # unmap only (no unlink, no close: the shared closed flag would
            # end the ring for the owner and for a restarted worker)
            wq._qq.destroy()
            wq._rq.destroy()


def make_broker() -> Broker:
    """``RAFIKI_BROKER=shm``: a :class:`ShmBroker` (it raises when the
    native library cannot be built; there is no fallback); otherwise the
    in-process broker."""
    if os.environ.get("RAFIKI_BROKER", "").strip() == "shm":
        return ShmBroker()
    return InProcessBroker()
