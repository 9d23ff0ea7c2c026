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

A sampled request's trace (``utils/trace.py``) crosses the ring in the
query frame's version-2 header (its id, sampling bit and the submitter's
monotonic submit time ``ts``); the worker side records ``queue_wait``
(submit to pop, on the host's shared monotonic clock) and
``codec_decode`` at the pop, the worker's loop adds ``batch_assembly``
and ``model_forward`` through ``ResponseHandle.trace``, the responder
``codec_encode`` (the answer's arrays into frame bytes; JAX records no
such span), and the spans travel home in the response frame's header,
where the listener grafts them onto the door's tree. The counters of
:meth:`ShmWorkerQueue.stats` and :meth:`ShmBroker.stats` are mirrored
into the metrics registry (``rafiki_wire_errors_total``,
``rafiki_queue_expired_total``, ``rafiki_queue_rejected_total``). The
``wire`` chaos site (``RAFIKI_CHAOS``) is asked for each frame popped off
a ring, before it is decoded.
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
from rafiki_tpu_torch.utils import chaos
from rafiki_tpu_torch.utils.jsonutil import json_default
from rafiki_tpu_torch.utils.metrics import REGISTRY

logger = logging.getLogger(__name__)


def _qname(prefix: str, *parts: str) -> str:
    digest = hashlib.sha256("|".join(parts).encode()).hexdigest()[:24]
    return f"/{prefix}-{digest}"


def _m_wire_errors():
    return REGISTRY.counter(
        "rafiki_wire_errors_total",
        "undecodable wire frames dropped (query + response sides)")


def _m_expired():
    return REGISTRY.counter(
        "rafiki_queue_expired_total",
        "queries dropped past their deadline in a worker queue")


def _m_rejected():
    return REGISTRY.counter(
        "rafiki_queue_rejected_total",
        "queries refused by a bounded worker queue's depth cap")


def _popped(ring: ShmMessageQueue, raw: bytes) -> bytes:
    """A frame popped off ``ring``, through the ``wire`` chaos site."""
    rule = chaos.hit(chaos.SITE_WIRE, ring.name)
    if rule is not None and rule.action == chaos.ACTION_CORRUPT:
        return chaos.corrupt_bytes(raw, rule)
    return raw


def _encode_query_frame(ids: List[str], queries: List[Any],
                        deadline: Optional[float],
                        trace_meta: Optional[Dict[str, Any]] = None
                        ) -> bytes:
    """One binary frame for a whole request, its rows stacked into one
    array where they form one; ``trace_meta`` (a sampled request's wire
    context and submit time) rides the version-2 header."""
    msg: Dict[str, Any] = {"ids": ids}
    if deadline is not None:
        msg["deadline"] = deadline
    stacked = wire.stack_rows(queries)
    if stacked is not None:
        msg["qarr"] = stacked
    else:
        msg["queries"] = queries
    return wire.encode(msg, trace=trace_meta)


def _decode_query_frame(raw: bytes) -> Tuple[
        List[Tuple[str, Any, Optional[float]]], bool,
        Optional[Dict[str, Any]]]:
    """One popped query message -> ([(qid, query, deadline), ...],
    arrived_binary, trace_meta or None). Takes the batched binary frame
    (version 1, or 2 with trace metadata), the batched JSON message (a
    JAX-package submitter under ``RAFIKI_WIRE_BINARY=0``, its trace in a
    ``_trace`` key) and the legacy per-query ``{"id", "query"}`` message.
    Raises WireFormatError on garbage."""
    binary = wire.is_frame(raw)
    msg, meta = wire.decode_any_meta(raw)
    if not isinstance(msg, dict):
        raise wire.WireFormatError("query frame is not an object")
    trace_meta = meta.get("trace") or msg.get("_trace")
    if not isinstance(trace_meta, dict):
        trace_meta = None
    try:
        # the frame decoded, but each field is still untrusted: ids must be
        # strings and the deadline a number, or the frame is malformed
        deadline = msg.get("deadline")
        if deadline is not None:
            deadline = float(deadline)
        if "id" in msg:  # legacy single-query message
            if not isinstance(msg["id"], str):
                raise wire.WireFormatError("query id is not a string")
            return [(msg["id"], msg["query"], deadline)], binary, trace_meta
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
        return ([(qid, q, deadline) for qid, q in zip(ids, queries)],
                binary, trace_meta)
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
    lost response.

    For a sampled frame (its query frame carried trace metadata) it also
    collects the worker's spans as ``[name, offset_s, duration_s]``
    against the submitter's ``ts`` and sends them home in the response
    frame's header; a legacy JSON response drops them."""

    __slots__ = ("_rq", "_ids", "_binary", "_lock", "_out", "trace_meta",
                 "_spans")

    def __init__(self, rq: ShmMessageQueue, ids: List[str], binary: bool,
                 trace_meta: Optional[Dict[str, Any]] = None):
        self._rq = rq
        self._ids = ids
        self._binary = binary
        self._lock = threading.Lock()
        self._out: Dict[str, Tuple[str, Any]] = {}
        self.trace_meta = trace_meta if (
            isinstance(trace_meta, dict) and trace_meta.get("s")) else None
        self._spans: List[List[Any]] = []

    @property
    def anchor(self) -> Optional[float]:
        """The submitter's monotonic submit time (one host, one
        CLOCK_MONOTONIC): the worker's span offsets are against it."""
        if self.trace_meta is None:
            return None
        try:
            return float(self.trace_meta.get("ts"))
        except (TypeError, ValueError):
            return None

    def add_span(self, name: str, start: float, end: float) -> None:
        """Record one worker-side span (a monotonic interval); a no-op
        for an unsampled frame."""
        anchor = self.anchor
        if anchor is None:
            return
        with self._lock:
            self._spans.append([name, round(start - anchor, 6),
                                round(max(end - start, 0.0), 6)])

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
                t_enc = time.monotonic()
                parts = wire.prepare_frame(msg)
                trace_out = None
                if self.trace_meta is not None:
                    self.add_span("codec_encode", t_enc, time.monotonic())
                    with self._lock:
                        trace_out = {"id": self.trace_meta.get("id"),
                                     "spans": list(self._spans)}
                self._rq.push(wire.finish_frame(parts, trace=trace_out))
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

        @property
        def trace(self):
            """The worker loop's span sink (``QueryFuture.trace``'s
            counterpart): the frame's responder when the request is
            sampled, else None."""
            r = self._responder
            return r if r.trace_meta is not None else None

        def set_result(self, value: Any) -> None:
            self._responder.resolve(self._id, "result", value)

        def set_error(self, error: BaseException) -> None:
            self._responder.resolve(self._id, "error", str(error))

    def __init__(self, query_q: ShmMessageQueue, response_q: ShmMessageQueue):
        self._qq = query_q
        self._rq = response_q
        self._wire_errors = 0  # undecodable frames dropped
        self._expired = 0  # queries past their deadline when taken
        self._m_wire_errors, self._m_expired = _m_wire_errors(), _m_expired()

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

    def _pop_decoded(self, timeout_s: float) -> Optional[tuple]:
        """Pop and decode one query frame: ``(entries, binary,
        trace_meta, t_pop, decode_s)``, or None on timeout; ``t_pop`` and
        ``decode_s`` are the sampled frame's ``codec_decode`` span. A
        frame that fails to decode is counted and comes back empty: its
        submitter's deadline covers its queries, and the worker loop goes
        on."""
        raw = self._qq.pop(timeout_s=timeout_s)
        if raw is None:
            return None
        raw = _popped(self._qq, raw)
        t_pop = time.monotonic()
        try:
            entries, binary, trace_meta = _decode_query_frame(raw)
            return (entries, binary, trace_meta, t_pop,
                    time.monotonic() - t_pop)
        except wire.WireFormatError as e:
            self._wire_errors += 1
            self._m_wire_errors.inc()
            logger.error("dropping undecodable query frame on %s: %s",
                         self._qq.name, e)
            return [], False, None, t_pop, 0.0

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
        for entries, binary, trace_meta, t_pop, decode_s in groups:
            if not entries:
                continue  # a corrupt frame, already counted
            responder = _FrameResponder(
                self._rq, [qid for qid, _, _ in entries], binary,
                trace_meta=trace_meta)
            anchor = responder.anchor
            if anchor is not None:
                # the worker's half of the tree: the wait in the ring,
                # then the decode at its own interval (they tile)
                responder.add_span("queue_wait", anchor, t_pop)
                responder.add_span("codec_decode", t_pop, t_pop + decode_s)
            for qid, query, deadline in entries:
                handle = self.ResponseHandle(responder, qid)
                # CLOCK_MONOTONIC is system-wide on one host, so the
                # submitter's absolute deadline compares here directly
                if deadline is not None and now >= deadline:
                    self._expired += 1
                    self._m_expired.inc()
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
                    deadline: Optional[float] = None,
                    trace=None) -> List[QueryFuture]:
        """One frame per request, so it lands as one worker batch. The
        depth cap admits or refuses the request whole, and the reservation
        is taken with the check (released on response, push failure or
        expiry). A ring full past the push timeout raises the retryable
        :class:`QueueFullError`; a frame larger than the ring
        :class:`FrameTooLargeError` (413 at the door). A sampled
        request's ``trace`` crosses in the frame; the worker's spans come
        home in the response and are grafted onto it."""
        self._broker._reserve_capacity(self._job_id, self._worker_id,
                                       len(queries))
        ids = [uuid.uuid4().hex for _ in queries]
        futs = [QueryFuture() for _ in queries]
        trace_meta = None
        if trace is not None:
            trace.mark_submitted()
            trace_meta = {**trace.ctx.to_wire(), "ts": trace.t_submit}
        for qid, fut in zip(ids, futs):
            # an absolute monotonic deadline, comparable in the worker
            self._broker._register_pending(self._job_id, self._worker_id,
                                           qid, fut, deadline, trace=trace)
        try:
            self._qq.push(_encode_query_frame(ids, queries, deadline,
                                              trace_meta=trace_meta))
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
        # qid -> (future, worker_id, expiry, trace): worker_id feeds the
        # per-worker outstanding count, expiry lets a query no one answers
        # (its worker died mid-batch) stop counting against the cap, trace
        # takes the worker's spans of a sampled request
        self._pending: Dict[str, Dict[str, Tuple[QueryFuture, str,
                                                 float, Any]]] = {}
        self._outstanding: Dict[Tuple[str, str], int] = {}
        self._listeners: Dict[str, threading.Thread] = {}
        self._graveyard: List[ShmMessageQueue] = []
        self._wire_errors = 0  # undecodable response frames dropped
        self._rejected = 0  # queries refused by the depth cap
        self._expired = 0  # outstanding queries pruned unanswered
        self._m_wire_errors, self._m_expired, self._m_rejected = (
            _m_wire_errors(), _m_expired(), _m_rejected())
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
                          fut: QueryFuture, deadline: Optional[float],
                          trace=None) -> None:
        """Record one reserved query's future (its outstanding slot was
        taken by _reserve_capacity). It expires 30 s past the request's
        deadline (or the default SLO): a query never answered must stop
        counting against the cap, or one crash pins the replica full."""
        expiry = (deadline if deadline is not None
                  else time.monotonic() + config.PREDICT_TIMEOUT_S) + 30.0
        with self._lock:
            self._pending.setdefault(job_id, {})[qid] = (fut, worker_id,
                                                         expiry, trace)

    def _pop_pending(self, job_id: str, qid: str) -> Optional[QueryFuture]:
        return self._pop_pending_traced(job_id, qid)[0]

    def _pop_pending_traced(self, job_id: str, qid: str) -> tuple:
        """(future, trace) of one pending id; (None, None) if unknown."""
        with self._lock:
            entry = self._pending.get(job_id, {}).pop(qid, None)
            if entry is None:
                return None, None
            fut, worker_id, _, trace = entry
            self._dec_outstanding_locked(job_id, worker_id)
            return fut, trace

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
        for qid, (_, wid, expiry, _trace) in list(job_pending.items()):
            if wid == worker_id and now >= expiry:
                job_pending.pop(qid)
                self._dec_outstanding_locked(job_id, wid)
                self._expired += 1
                self._m_expired.inc()

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
                self._m_rejected.inc(n)
                raise QueueFullError(f"shm worker {worker_id} full "
                                     f"({queued}/{cap} outstanding)")
            self._outstanding[key] = queued + n

    def _resolve_response(self, job_id: str, msg: Any,
                          meta: Optional[Dict[str, Any]] = None) -> None:
        """Resolve the futures of one decoded response: a batched frame
        ({"ids", "results", "errors"}) or a legacy per-id JSON message.
        Every field is checked before pending state is touched: a frame
        that decodes but is malformed raises the one typed error
        ``_listen`` absorbs. ``meta``'s trace spans (a sampled request's)
        are grafted onto its trace before its futures resolve."""
        if not isinstance(msg, dict):
            raise wire.WireFormatError("response frame is not an object")
        trace_meta = (meta or {}).get("trace")
        wire_spans = (trace_meta.get("spans")
                      if isinstance(trace_meta, dict) else None)
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
            fut, trace = self._pop_pending_traced(job_id, qid)
            if fut is None:
                continue
            if wire_spans is not None and trace is not None:
                # once a frame: a request's futures share its trace
                trace.add_wire_spans(wire_spans, anchor=trace.t_submit)
                wire_spans = None
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
            raw = _popped(rq, raw)
            try:
                self._resolve_response(job_id, *wire.decode_any_meta(raw))
            except wire.WireFormatError as e:
                # its futures keep waiting and end with the request's own
                # TimeoutError; the listener outlives any bad message
                with self._lock:
                    self._wire_errors += 1
                self._m_wire_errors.inc()
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
                for fut, _, _, _ in pend.values():
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
