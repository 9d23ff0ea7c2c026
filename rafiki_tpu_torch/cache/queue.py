"""Continuous-batching query transport.

Counterpart of ``rafiki_tpu/cache/queue.py``: the predictor submits a
request's queries atomically (``submit_many``) and gets futures back;
each inference worker blocks on its bounded queue, wakes the moment work
arrives, drains what has queued (``take_batch``) and resolves the futures
itself. ``Broker`` is the transport seam: ``InProcessBroker`` serves
workers that are threads of this process, ``ShmBroker``
(``cache/shm_broker.py``) worker processes.

A generation request's future resolves to a :class:`TokenStream`, the
channel the generation worker pushes :class:`TokenDelta` s into and the
streaming door pulls from. The hand-back of a stream to the door for a
resume on a sibling (``MIGRATING``) is not ported (ROADMAP.md).
"""

from __future__ import annotations

import abc
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from rafiki_tpu_torch import config


class QueueFullError(RuntimeError):
    """A bounded worker queue refused a submit (overload shed signal);
    ``retry_after_s`` tells the door what to answer with its 429."""

    def __init__(self, message: str, retry_after_s: float = 1.0) -> None:
        super().__init__(message)
        self.retry_after_s = max(float(retry_after_s), 0.0)


class FrameTooLargeError(ValueError):
    """A request's wire frame is larger than the shm ring: permanent for
    this request (retrying the same payload never succeeds), unlike the
    retryable :class:`QueueFullError`. The door answers 413: split the
    request or raise ``RAFIKI_SHM_RING_BYTES``."""


class QueryFuture:
    """A pending prediction for one query."""

    __slots__ = ("_event", "_value", "_error")

    def __init__(self) -> None:
        self._event = threading.Event()
        self._value: Any = None
        self._error: Optional[BaseException] = None

    def set_result(self, value: Any) -> None:
        self._value = value
        self._event.set()

    def set_error(self, error: BaseException) -> None:
        self._error = error
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> Any:
        if not self._event.wait(timeout):
            raise TimeoutError("prediction timed out")
        if self._error is not None:
            raise self._error
        return self._value


class GenerationError(RuntimeError):
    """A generation stream ended with a typed terminal fault (a worker
    error mid-stream, a stalled decode, a malformed request). The
    streaming door ends the response with a terminal error frame, and
    :meth:`TokenStream.next_delta` raises it."""


class TokenDelta:
    """One increment of a generation stream: the token ids emitted since
    the previous delta, and on the last one ``finished`` with its
    ``reason`` (``eos`` | ``max_tokens`` | ``context`` | ``deadline`` |
    ``error`` | ``cancelled``) and, for ``error``, the fault's text."""

    __slots__ = ("tokens", "finished", "reason", "error")

    def __init__(self, tokens: List[int], finished: bool = False,
                 reason: Optional[str] = None,
                 error: Optional[str] = None) -> None:
        self.tokens = list(tokens)
        self.finished = bool(finished)
        self.reason = reason
        self.error = error

    def to_json(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"tokens": self.tokens,
                               "finished": self.finished}
        if self.reason is not None:
            out["reason"] = self.reason
        if self.error is not None:
            out["error"] = self.error
        return out


class TokenStream:
    """The channel of one sequence between the generation worker's slot
    scheduler and the streaming door. The worker pushes deltas and exactly
    one terminal delta (``finished`` or a typed failure); the door pulls
    with :meth:`next_delta`. ``cancel`` is the door's back-signal (client
    gone, stalled stream): the scheduler evicts the slot at its next
    step."""

    __slots__ = ("seq_id", "_cond", "_deltas", "_finished", "_cancelled")

    def __init__(self, seq_id: str) -> None:
        self.seq_id = seq_id
        self._cond = threading.Condition()
        self._deltas: List[TokenDelta] = []  # guarded-by: _cond
        self._finished = False  # guarded-by: _cond
        self._cancelled = False  # guarded-by: _cond

    def push(self, tokens: List[int], finished: bool = False,
             reason: Optional[str] = None) -> None:
        """Worker side: one increment (terminal when ``finished``). Pushes
        after the terminal delta are dropped."""
        with self._cond:
            if self._finished:
                return
            self._deltas.append(TokenDelta(tokens, finished, reason))
            self._finished = finished
            self._cond.notify_all()

    def fail(self, message: str) -> None:
        """Worker side: the terminal typed fault (reason ``error``)."""
        with self._cond:
            if self._finished:
                return
            self._deltas.append(
                TokenDelta([], finished=True, reason="error", error=message))
            self._finished = True
            self._cond.notify_all()

    def cancel(self) -> None:
        """Consumer side: stop decoding this sequence."""
        with self._cond:
            self._cancelled = True
            self._cond.notify_all()

    @property
    def cancelled(self) -> bool:
        with self._cond:
            return self._cancelled

    @property
    def finished(self) -> bool:
        """True once the terminal delta has been pushed and consumed."""
        with self._cond:
            return self._finished and not self._deltas

    def next_delta(self, timeout: Optional[float] = None) -> TokenDelta:
        """Block for the next increment. Raises ``TimeoutError`` when none
        lands inside ``timeout`` (the door's stall detector),
        :class:`GenerationError` for the terminal error delta, and
        ``StopIteration`` once the terminal delta has been consumed."""
        with self._cond:
            if not self._deltas and self._finished:
                raise StopIteration
            if not self._deltas and not self._cond.wait_for(
                    lambda: bool(self._deltas), timeout):
                raise TimeoutError(
                    f"no token for sequence {self.seq_id} within "
                    f"{(timeout or 0.0):.1f}s")
            delta = self._deltas.pop(0)
            if delta.error is not None:
                raise GenerationError(delta.error)
            return delta


class WorkerQueue:
    """One inference worker's bounded inbox of (future, query, deadline).

    A submit beyond ``max_depth`` (default ``RAFIKI_PREDICT_QUEUE_DEPTH``,
    read at each submit; <= 0 uncapped) raises :class:`QueueFullError`.
    ``take_batch`` drops entries whose request deadline has passed."""

    def __init__(self, max_depth: Optional[int] = None) -> None:
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._items: List[Tuple[QueryFuture, Any, Optional[float]]] = []
        self._closed = False
        self._max_depth = max_depth
        self._expired = 0
        self._rejected = 0

    def _cap(self) -> int:
        if self._max_depth is not None:
            return self._max_depth
        return int(config.PREDICT_QUEUE_DEPTH)

    def depth(self) -> int:
        with self._lock:
            return len(self._items)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"depth": len(self._items), "expired": self._expired,
                    "rejected": self._rejected}

    def submit_many(self, queries: List[Any],
                    deadline: Optional[float] = None) -> List[QueryFuture]:
        """Enqueue a request's queries atomically (one lock, one wake-up),
        so one request stays one batch and the depth cap admits or refuses
        it whole. ``deadline`` is an absolute ``time.monotonic()``."""
        with self._cond:
            futs = [QueryFuture() for _ in queries]
            if self._closed:
                for fut in futs:
                    fut.set_error(RuntimeError("worker queue closed"))
                return futs
            cap = self._cap()
            if cap > 0 and len(self._items) + len(queries) > cap:
                self._rejected += len(queries)
                raise QueueFullError(
                    f"worker queue full ({len(self._items)}/{cap} queued; "
                    f"refusing {len(queries)} more)")
            self._items.extend(
                (fut, q, deadline) for fut, q in zip(futs, queries))
            self._cond.notify()
        return futs

    def _drain_fresh(  # guarded-by: _lock
            self, n: int, now: float,
            batch: List[Tuple[QueryFuture, Any]]) -> None:
        while n > 0 and self._items:
            fut, query, deadline = self._items.pop(0)
            if deadline is not None and now >= deadline:
                self._expired += 1
                fut.set_error(TimeoutError(
                    "query expired in the worker queue before dispatch"))
                continue
            batch.append((fut, query))
            n -= 1

    def take_batch(self, max_size: int, deadline_s: float,
                   wait_timeout_s: float = 0.5,
                   ) -> Optional[List[Tuple[QueryFuture, Any]]]:
        """Block until work arrives (or ``wait_timeout_s``), then drain until
        the batch fills or ``deadline_s`` passes since the first item.
        Returns [] on timeout, and None once the queue is closed and
        drained."""
        with self._cond:
            if not self._items and not self._closed:
                self._cond.wait(wait_timeout_s)
            if not self._items:
                return None if self._closed else []
            first_t = time.monotonic()
            batch: List[Tuple[QueryFuture, Any]] = []
            self._drain_fresh(max_size, first_t, batch)
            while len(batch) < max_size and not self._closed:
                remaining = deadline_s - (time.monotonic() - first_t)
                if remaining <= 0:
                    break
                if not self._items:
                    self._cond.wait(remaining)
                self._drain_fresh(max_size - len(batch), time.monotonic(),
                                  batch)
            return batch

    def close(self) -> None:
        with self._cond:
            self._closed = True
            for fut, _, _ in self._items:
                fut.set_error(RuntimeError("worker queue closed"))
            self._items.clear()
            self._cond.notify_all()


class Broker(abc.ABC):
    """Transport seam between predictors and inference workers."""

    @abc.abstractmethod
    def register_worker(self, inference_job_id: str,
                        worker_id: str) -> WorkerQueue:
        ...

    @abc.abstractmethod
    def unregister_worker(self, inference_job_id: str,
                          worker_id: str) -> None:
        ...

    @abc.abstractmethod
    def get_worker_queues(self,
                          inference_job_id: str) -> Dict[str, WorkerQueue]:
        ...


class InProcessBroker(Broker):
    """Single-host broker: queues live in process memory."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._queues: Dict[str, Dict[str, WorkerQueue]] = {}

    def register_worker(self, inference_job_id: str,
                        worker_id: str) -> WorkerQueue:
        with self._lock:
            q = WorkerQueue()
            self._queues.setdefault(inference_job_id, {})[worker_id] = q
            return q

    def unregister_worker(self, inference_job_id: str,
                          worker_id: str) -> None:
        with self._lock:
            q = self._queues.get(inference_job_id, {}).pop(worker_id, None)
        if q is not None:
            q.close()

    def get_worker_queues(self,
                          inference_job_id: str) -> Dict[str, WorkerQueue]:
        with self._lock:
            return dict(self._queues.get(inference_job_id, {}))
