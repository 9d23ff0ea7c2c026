"""The per-inference-job HTTP door: ``POST /predict``, ``POST /generate``,
``GET /healthz`` and ``GET /metrics``.

Counterpart of ``PredictorServer`` in ``rafiki_tpu/predictor/server.py``,
with the same request and response shapes:

- ``POST /predict`` with a JSON body ``{"queries": [...], "timeout_s": T}``,
  or an ``application/x-npy`` body whose first axis is the batch (the
  timeout then rides the ``X-Rafiki-Timeout-S`` header);
- the answer is ``{"data": {"predictions": [...]}}``, or one ``.npy`` body
  when the client sends ``Accept: application/x-npy``;
- 400 for a malformed request, 413 for a body over ``PREDICT_MAX_BODY_MB``,
  429 + ``Retry-After`` when every queue is full or the estimated wait is
  past the request's deadline, 503 (+ ``Retry-After``) when the door's
  in-flight cap is reached, 503 with no worker, 504 when no worker
  answers in time;
- ``POST /generate`` with ``{"prompt_ids": [...], "max_tokens": N,
  "timeout_s": T}`` and the optional ``temperature``, ``top_k``, ``top_p``
  and ``seed``: a chunked response, one delta a chunk, as JSON lines, or
  as length-prefixed version-3 wire frames when the request's ``Accept``
  names ``wire.CONTENT_TYPE``. Refusals before the stream starts are
  status codes; once it streams, a fault (a worker's error, no token for
  ``RAFIKI_GEN_STREAM_TIMEOUT_S``) ends it with a typed terminal error
  delta, never a silent hang;
- with ``auth`` (the default) both POST routes take the admin's bearer
  tokens (401 without one), so one login works on both doors;
- every request passes the door's
  :class:`~rafiki_tpu_torch.predictor.admission.AdmissionController`
  first (fed the predictor's ``backlog_depth``; ``/generate`` costs its
  KV blocks, :func:`_generate_cost`), and ``GET /healthz`` carries its
  ``stats()``, the predictor's ``overload_stats()`` and ``queue_depths``;
- ``stop()`` drains: it stops accepting and waits for the requests in
  flight, up to ``RAFIKI_PREDICT_DRAIN_S``; a second call does nothing;
- ``GET /metrics`` answers the process registry's Prometheus text
  (``?format=json``: the snapshot with the rings), without a token, as
  ``/healthz``;
- request tracing (``utils/trace.py``): a ``/predict`` carrying an
  ``X-Rafiki-Trace`` header with its sampling bit set, or drawn at
  ``RAFIKI_TRACE_SAMPLE``, gets a ``RequestTrace``: the door records
  ``admission_wait`` and ``respond``, the context rides the queue entries
  to the worker (whose spans come back into the tree), the header is
  echoed on the answer, each phase lands in ``rafiki_phase_seconds``,
  and a request at least ``RAFIKI_TRACE_SLOW_MS`` slow is written as an
  exemplar under ``LOGS_DIR``.

Standard library ``http.server`` only.
"""

from __future__ import annotations

import io
import json
import logging
import math
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

import numpy as np

from rafiki_tpu_torch import config
from rafiki_tpu_torch.cache import wire
from rafiki_tpu_torch.cache.queue import (
    GenerationError,
    QueueFullError,
    TokenDelta,
)
from rafiki_tpu_torch.predictor.admission import (
    AdmissionController,
    DeadlineUnmeetableError,
    ServerOverloadedError,
    retry_after_headers,
)
from rafiki_tpu_torch.utils import trace as rtrace
from rafiki_tpu_torch.utils.auth import UnauthorizedError, decode_token
from rafiki_tpu_torch.utils.metrics import REGISTRY, serve_http
from rafiki_tpu_torch.worker.generation import GenerationRequestError

logger = logging.getLogger(__name__)

NPY = "application/x-npy"
MAX_TIMEOUT_S = 300.0


def _parse_timeout_s(value: object):
    """``(timeout_s, None)`` or ``(None, error)``: a client timeout must be
    a positive finite number, and is clamped to MAX_TIMEOUT_S."""
    if value is None:
        return float(config.PREDICT_TIMEOUT_S), None
    try:
        t = float(value)
    except (TypeError, ValueError):
        return None, "timeout must be a number"
    if not math.isfinite(t) or t <= 0:
        return None, "timeout must be a positive finite number"
    return min(t, MAX_TIMEOUT_S), None


class DoorHTTPServer(ThreadingHTTPServer):
    """The doors' threading server with a listen backlog for a burst: at
    the standard library's 5, the connections of a burst past it are
    reset before admission could answer them 503."""

    daemon_threads = True
    request_queue_size = 128


def _generate_cost(prompt_len: int, max_tokens: int) -> int:
    """A ``/generate`` request's admission cost in the unit that gates the
    generation worker: KV pool blocks under the paged allocator
    (ceil((prompt + budget) / block tokens)), or the decode budget under
    the contiguous ring (every slot holds a whole context there)."""
    if bool(config.GEN_KV_PAGED):
        bt = max(int(config.GEN_KV_BLOCK_TOKENS), 1)
        return max(-(-(prompt_len + max_tokens) // bt), 1)
    return max(max_tokens, 1)


class PredictorServer:
    def __init__(self, predictor, app: str, host: str = "127.0.0.1",
                 port: int = 0, auth: bool = True):
        """``auth=False`` serves a trusted network without tokens."""
        self.predictor = predictor
        self.app = app
        self.host = host
        self.port = port
        self.auth = auth
        self.admission = AdmissionController(door=f"predictor:{app}")
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._stop_lock = threading.Lock()
        self._stopped = False  # guarded-by: _stop_lock
        self._draining = False

    def start(self) -> "PredictorServer":
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            disable_nagle_algorithm = True
            timeout = 300

            def log_message(self, fmt, *args):
                logger.debug("%s " + fmt, self.address_string(), *args)

            def do_GET(self):
                path, _, query = self.path.partition("?")
                if path.rstrip("/") == "/healthz":
                    server._healthz(self)
                elif path.rstrip("/") == "/metrics":
                    serve_http(self, query)
                else:
                    server._respond(self, 404, {"error": "no such route"})

            def do_POST(self):
                if self.path.split("?", 1)[0].rstrip("/") == "/generate":
                    server._generate(self)
                else:
                    server._predict(self)

        self._httpd = DoorHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name=f"predictor-{self.app}",
                                        daemon=True)
        self._thread.start()
        logger.info("predictor for %s listening on %s:%d", self.app,
                    self.host, self.port)
        return self

    def stop(self, drain_timeout_s: Optional[float] = None) -> None:
        """Stop accepting, wait for the requests in flight (at most
        ``drain_timeout_s``, default ``RAFIKI_PREDICT_DRAIN_S``), then
        close. Idempotent: teardown paths may race to a second stop."""
        with self._stop_lock:
            if self._stopped or self._httpd is None:
                self._stopped = True
                return
            self._stopped = True
            self._draining = True
        if drain_timeout_s is None:
            drain_timeout_s = float(config.PREDICT_DRAIN_S)
        self._httpd.shutdown()  # the accept loop ends; handlers live on
        deadline = time.monotonic() + max(drain_timeout_s, 0.0)
        while self.admission.inflight > 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        if self.admission.inflight:
            logger.warning("predictor %s closed with %d request(s) still in "
                           "flight after the %.1f s drain", self.app,
                           self.admission.inflight, drain_timeout_s)
        self._httpd.server_close()
        self._thread.join(timeout=5.0)
        self._draining = False

    # -- handling ------------------------------------------------------------

    def _backlog(self) -> Optional[int]:
        fn = getattr(self.predictor, "backlog_depth", None)
        return fn() if callable(fn) else None

    def _cost(self, queries) -> int:
        fn = getattr(self.predictor, "admission_cost", None)
        return fn(queries) if callable(fn) else len(queries)

    def _healthz(self, handler) -> None:
        """Liveness and load: ``degraded`` with no worker queue,
        ``draining`` while ``stop()`` drains; the queue depths, the
        admission counters and the predictor's overload counters."""
        depths = self.predictor.queue_depths()
        status = ("draining" if self._draining
                  else "ok" if depths else "degraded")
        overload = getattr(self.predictor, "overload_stats", None)
        self._respond(handler, 200, {
            "app": self.app, "status": status, "workers": len(depths),
            "queue_depths": depths, "admission": self.admission.stats(),
            **({"overload": overload()} if callable(overload) else {})})

    def _read_body(self, handler) -> Optional[bytes]:
        """The request body, or None after answering 400/413. A refusal
        closes the connection: the unread body would desync keep-alive."""
        try:
            length = int(handler.headers.get("Content-Length") or 0)
        except ValueError:
            length = -1
        if length < 0:
            handler.close_connection = True
            self._respond(handler, 400, {"error": "bad Content-Length"})
            return None
        if length > config.PREDICT_MAX_BODY_MB * (1 << 20):
            handler.close_connection = True
            self._respond(handler, 413, {
                "error": f"request body exceeds "
                         f"{config.PREDICT_MAX_BODY_MB:g} MB "
                         "(PREDICT_MAX_BODY_MB)"})
            return None
        return handler.rfile.read(length) if length else b""

    def _parse(self, handler, raw: bytes):
        """``(queries, timeout_s, None)`` or ``(None, None, error)``."""
        ctype = ((handler.headers.get("Content-Type") or "")
                 .split(";")[0].strip().lower())
        if ctype == NPY:
            try:
                arr = np.load(io.BytesIO(raw), allow_pickle=False)
            except (ValueError, OSError, EOFError):
                return None, None, ("bad npy body (expected a valid, "
                                    "non-pickled .npy array)")
            if arr.ndim < 1 or arr.shape[0] == 0:
                return None, None, "npy body must have a leading batch axis"
            queries = list(arr)
            timeout_value = handler.headers.get("X-Rafiki-Timeout-S")
        else:
            try:
                body = json.loads(raw or b"{}")
            except (json.JSONDecodeError, UnicodeDecodeError) as e:
                return None, None, f"bad JSON body: {e}"
            if not isinstance(body, dict):
                return None, None, ('body must be a JSON object like '
                                    '{"queries": [...]}')
            queries = body.get("queries")
            timeout_value = body.get("timeout_s")
        if not isinstance(queries, list) or not queries:
            return None, None, "body must carry a non-empty 'queries' list"
        cap = int(config.PREDICT_QUEUE_DEPTH)
        if cap > 0 and len(queries) > cap:
            # bigger than any queue can hold: permanent, so 400, not 429
            return None, None, (
                f"request carries {len(queries)} queries but the per-worker "
                f"queue cap is {cap} (RAFIKI_PREDICT_QUEUE_DEPTH); split it")
        timeout_s, err = _parse_timeout_s(timeout_value)
        return queries, timeout_s, err

    def _predict(self, handler) -> None:
        raw = self._read_body(handler)
        if raw is None:
            return
        if handler.path.split("?", 1)[0].rstrip("/") != "/predict":
            return self._respond(handler, 404, {"error": "no such route"})
        if not self._authorized(handler):
            return
        queries, timeout_s, err = self._parse(handler, raw)
        if err:
            return self._respond(handler, 400, {"error": err})
        # a sampled request (the header's bit, or a draw at
        # RAFIKI_TRACE_SAMPLE) gets its span tree; an unsampled one costs
        # a header read
        rt = rtrace.start_trace(handler.headers.get(rtrace.TRACE_HEADER))
        try:
            # shed here costs microseconds; a doomed admit costs the fleet
            t_adm = time.monotonic()
            self.admission.admit(
                timeout_s, backlog_depth=self._backlog(), tenant=self.app,
                cost=self._cost(queries))
            t0 = time.monotonic()
            if rt is not None:
                rt.add_span("admission_wait", t_adm, t0)
            try:
                # the trace keyword only when sampled: an unsampled
                # request keeps the call shape predictor fakes take
                preds = self.predictor.predict_batch(
                    queries, timeout_s=timeout_s,
                    **({"trace": rt} if rt is not None else {}))
            finally:
                self.admission.release(tenant=self.app)
            self.admission.observe(time.monotonic() - t0, len(queries))
        except (QueueFullError, DeadlineUnmeetableError) as e:
            return self._respond(handler, 429, {"error": str(e)},
                                 retry_after_headers(e))
        except ServerOverloadedError as e:
            return self._respond(handler, 503, {"error": str(e)},
                                 retry_after_headers(e))
        except TimeoutError as e:
            return self._respond(handler, 504, {"error": str(e)})
        except RuntimeError as e:  # no workers registered
            return self._respond(handler, 503, {"error": str(e)})
        except Exception:
            logger.exception("predict failed for %s", self.app)
            return self._respond(handler, 500,
                                 {"error": "internal server error"})
        headers = ({rtrace.TRACE_HEADER: rt.ctx.to_header()}
                   if rt is not None else None)
        if self._accepts_npy(handler):
            try:
                arr = np.asarray(preds)
            except ValueError:  # ragged predictions: answer in JSON
                arr = None
            if arr is not None and arr.dtype.kind in "biuf":
                buf = io.BytesIO()
                np.save(buf, arr, allow_pickle=False)
                t_resp = time.monotonic()
                self._respond_bytes(handler, 200, buf.getvalue(), NPY,
                                    headers)
                return self._finish_trace(rt, t0, t_resp)
        t_resp = time.monotonic()
        self._respond(handler, 200, {"data": {"predictions": preds}},
                      headers)
        self._finish_trace(rt, t0, t_resp)

    def _finish_trace(self, rt, t0: float, t_resp: float) -> None:
        """Close a sampled request: its ``respond`` span, each phase into
        ``rafiki_phase_seconds``, and past ``RAFIKI_TRACE_SLOW_MS`` an
        exemplar. Never raises: the request is already answered."""
        if rt is None:
            return
        try:
            now = time.monotonic()
            rt.add_span("respond", t_resp, now)
            phase_h = REGISTRY.histogram(
                "rafiki_phase_seconds",
                "per-phase latency of sampled predict requests",
                ("phase",))
            for name, secs in rt.phase_durations().items():
                phase_h.labels(name).observe(secs)
            e2e_s = now - t0
            if e2e_s >= rtrace.slow_threshold_s():
                rtrace.record_exemplar(rt, e2e_s,
                                       door=f"predictor:{self.app}")
        except Exception:
            logger.debug("trace finish failed", exc_info=True)

    def _authorized(self, handler) -> bool:
        """True when auth is off or the request carries a valid token;
        else answers 401."""
        if not self.auth:
            return True
        token = (handler.headers.get("Authorization")
                 or "").removeprefix("Bearer ")
        try:
            decode_token(token)  # any authenticated user may serve
        except UnauthorizedError as e:
            self._respond(handler, 401, {"error": str(e)})
            return False
        return True

    def _generate(self, handler) -> None:
        """``POST /generate``: parse, route to one replica, then stream."""
        raw = self._read_body(handler)
        if raw is None or not self._authorized(handler):
            return
        try:
            body = json.loads(raw or b"{}")
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            return self._respond(handler, 400, {"error": f"bad JSON body: {e}"})
        if not isinstance(body, dict):
            return self._respond(handler, 400, {
                "error": 'body must be a JSON object like {"prompt_ids": '
                         '[...]}'})
        timeout_s, err = _parse_timeout_s(body.get("timeout_s"))
        if err:
            return self._respond(handler, 400, {"error": err})
        try:
            max_tokens = int(body.get("max_tokens", config.GEN_MAX_TOKENS))
        except (TypeError, ValueError):
            return self._respond(handler, 400, {
                "error": "max_tokens must be an integer"})
        query = {"prompt_ids": body.get("prompt_ids"),
                 "max_tokens": max_tokens}
        # the worker validates these in full (typed, 400 below); junk that
        # is not a number is refused here
        for key, cast in (("temperature", float), ("top_k", int),
                          ("top_p", float), ("seed", int)):
            if body.get(key) is not None:
                try:
                    query[key] = cast(body[key])
                except (TypeError, ValueError):
                    return self._respond(handler, 400, {
                        "error": f"{key} must be a number"})
        prompt = query["prompt_ids"]
        cost = _generate_cost(
            len(prompt) if isinstance(prompt, (list, tuple)) else 0,
            max_tokens)
        try:
            self.admission.admit(
                timeout_s, backlog_depth=self._backlog(), tenant=self.app,
                cost=cost)
        except DeadlineUnmeetableError as e:
            return self._respond(handler, 429, {"error": str(e)},
                                 retry_after_headers(e))
        except ServerOverloadedError as e:
            return self._respond(handler, 503, {"error": str(e)},
                                 retry_after_headers(e))
        # the slot is held until the stream ends
        try:
            t0 = time.monotonic()
            try:
                stream = self.predictor.generate(query, timeout_s=timeout_s)
            except GenerationRequestError as e:
                return self._respond(handler, 400, {"error": str(e)})
            except QueueFullError as e:
                # admitted here, refused by every replica: a shed too
                self.admission.note_backend_shed()
                return self._respond(handler, 429, {"error": str(e)},
                                     retry_after_headers(e))
            except TimeoutError as e:  # no slot admitted it in time
                return self._respond(handler, 504, {"error": str(e)})
            except RuntimeError as e:  # no workers, a failed prefill
                return self._respond(handler, 503, {"error": str(e)})
            except Exception:
                logger.exception("generate failed for %s", self.app)
                return self._respond(handler, 500,
                                     {"error": "internal server error"})
            served = self._stream_deltas(handler, stream,
                                         self._accepts_wire(handler))
            self.admission.observe(time.monotonic() - t0, max(served, 1))
        finally:
            self.admission.release(tenant=self.app)

    @staticmethod
    def _stream_deltas(handler, stream, binary: bool) -> int:
        """Pump one stream into a chunked response; returns the tokens
        served. Past the 200 every fault ends the response with a terminal
        delta (and cancels the slot), never an exception."""
        handler.send_response(200)
        handler.send_header(
            "Content-Type", wire.CONTENT_TYPE if binary
            else "application/x-ndjson")
        handler.send_header("Transfer-Encoding", "chunked")
        handler.send_header("Cache-Control", "no-store")
        # one stream a connection: the client drops it after the last delta
        handler.send_header("Connection", "close")
        handler.close_connection = True
        handler.end_headers()

        def chunk(payload: bytes) -> bool:
            try:
                handler.wfile.write(
                    b"%x\r\n" % len(payload) + payload + b"\r\n")
                handler.wfile.flush()
                return True
            except OSError:  # client gone: cancelling frees the slot
                stream.cancel()
                return False

        def emit(delta: TokenDelta) -> bool:
            if binary:
                frame = wire.encode_token_delta(
                    stream.seq_id, delta.tokens, finished=delta.finished,
                    reason=delta.reason, error=delta.error)
                return chunk(len(frame).to_bytes(4, "little") + frame)
            return chunk(json.dumps(delta.to_json()).encode() + b"\n")

        # one stall window a delta; the request's own deadline is the
        # worker's (max_duration_s -> reason "deadline"). The stream is the
        # predictor's resumable one: a window that ends with the worker's
        # queue gone is its replica's death, and the stream resumes on a
        # sibling inside next_delta, as a hand-back does; so the window is
        # also how long a death takes to notice
        stall_s = max(float(config.GEN_STREAM_TIMEOUT_S), 0.1)
        served = 0
        while True:
            try:
                delta = stream.next_delta(timeout=stall_s)
            except StopIteration:
                break
            except TimeoutError:
                emit(TokenDelta([], finished=True, reason="error",
                                error=f"decode stalled (no token within "
                                      f"{stall_s:.1f}s)"))
                stream.cancel()
                break
            except GenerationError as e:
                emit(TokenDelta([], finished=True, reason="error",
                                error=str(e)))
                break
            served += len(delta.tokens)
            if not emit(delta):
                return served
            if delta.finished:
                break
        try:
            handler.wfile.write(b"0\r\n\r\n")
            handler.wfile.flush()
        except OSError:
            stream.cancel()
        return served

    @staticmethod
    def _accepts_wire(handler) -> bool:
        accept = handler.headers.get("Accept") or ""
        return any(part.split(";")[0].strip().lower() == wire.CONTENT_TYPE
                   for part in accept.split(","))

    @staticmethod
    def _accepts_npy(handler) -> bool:
        accept = handler.headers.get("Accept") or ""
        return any(part.split(";")[0].strip().lower() == NPY
                   for part in accept.split(","))

    @staticmethod
    def _respond(handler, code: int, payload: Dict[str, Any],
                 headers: Optional[Dict[str, str]] = None) -> None:
        PredictorServer._respond_bytes(handler, code,
                                       json.dumps(payload).encode(),
                                       "application/json", headers)

    @staticmethod
    def _respond_bytes(handler, code: int, data: bytes, content_type: str,
                       headers: Optional[Dict[str, str]] = None) -> None:
        handler.send_response(code)
        handler.send_header("Content-Type", content_type)
        handler.send_header("Content-Length", str(len(data)))
        for k, v in (headers or {}).items():
            handler.send_header(k, v)
        handler.end_headers()
        handler.wfile.write(data)

