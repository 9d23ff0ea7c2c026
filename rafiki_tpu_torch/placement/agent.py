"""A host's placement agent: ``python -m rafiki_tpu_torch.placement.agent``.

Own copy of ``rafiki_tpu/placement/agent.py``. Each host runs one agent,
which owns the host's cards and starts worker processes on their grants
through the host-local :class:`~rafiki_tpu_torch.placement.process.
ProcessPlacementManager`, behind a small HTTP API that the admin's
``HostAgentPlacementManager`` (``placement/hosts.py``) drives::

    GET  /healthz              liveness, the newest admin epoch seen and
                               the wire codec versions this agent decodes
    GET  /inventory            {host, total_chips, free_chips, n_services,
                                admin_epoch, services: [{service_id,
                                service_type, status, chips, pid}],
                                relays: {json, binary}}: what a restarted
                                admin reconciles against
    POST /services             {service_id, service_type, n_chips,
                                best_effort_chips, extra} -> {chips}
    POST /services/<id>/stop   {wait} -> {}
    POST /predict_relay/<job>/<worker>   {queries, timeout_s}
                                         -> {predictions}

Every request's body is read before any refusal (an early answer with
the body unread would desync a keep-alive connection). Every route but
``/healthz`` needs the fleet's key (``X-Rafiki-Agent-Key``; 401); an
agent without a key refuses them all (403) unless ``allow_insecure``.
The epoch fence: the highest admin epoch an authenticated call carried
is remembered, and a placement mutation from a lower epoch, or with none
once one was seen, is refused ``412``; the relay is never fenced.

Serving: the agent process owns the shm rings its serving children
attach to, and the relay hands a batch to the worker's ring
(``ShmBroker.get_worker_queues(job)[worker]``), answering a binary frame
with a frame and JSON with JSON; its errors are JSON 400/404/429/502/504
without a traceback.

Settings (environment): ``RAFIKI_AGENT_HOST``/``RAFIKI_AGENT_PORT`` (bind
address, default ``127.0.0.1:0``), ``RAFIKI_AGENT_CHIPS`` (the device
indices this host contributes, ``cpu`` entries for a CPU-only drill;
unset: the host's CUDA cards, counted by a bounded probe, and no card is
an error), ``RAFIKI_AGENT_KEY`` (required, or ``RAFIKI_AGENT_INSECURE=1``),
``RAFIKI_DB_PATH`` (the shared store, required), ``RAFIKI_WORKDIR`` and
``RAFIKI_ADMIN_ADDR`` (the admin's door: the train children's advisor,
and where terminal statuses are forwarded).

A relay body carrying a sampled request's ``trace`` context makes the
agent collect its half of the span tree (the wait in its shm queue and
the worker's phases over its own ring) and answer it as ``trace_spans``,
offsets against its own submit time; a body without one answers the
plain shape. ``GET /metrics`` answers the agent process's registry
without a key, as ``/healthz`` does.
"""

from __future__ import annotations

import hmac
import json
import logging
import os
import re
import signal
import socket
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler
from typing import Any, Dict, List, Optional

import numpy as np

from rafiki_tpu_torch import config
from rafiki_tpu_torch.cache import wire
from rafiki_tpu_torch.cache.queue import QueueFullError
from rafiki_tpu_torch.constants import ServiceStatus, ServiceType
from rafiki_tpu_torch.placement.manager import (
    ChipAllocator,
    InsufficientChipsError,
)
from rafiki_tpu_torch.placement.process import ProcessPlacementManager
from rafiki_tpu_torch.utils import chaos
from rafiki_tpu_torch.utils import trace as rtrace
from rafiki_tpu_torch.utils.agent_http import (
    ADMIN_EPOCH_HEADER,
    AGENT_KEY_HEADER,
    STALE_EPOCH_STATUS,
)
from rafiki_tpu_torch.utils.jsonutil import json_default
from rafiki_tpu_torch.utils.metrics import serve_http
from rafiki_tpu_torch.utils.reqfields import (
    LowLatencyHandler,
    SeveringHTTPServer,
    parse_timeout_s,
    read_bounded_body,
)

logger = logging.getLogger(__name__)

_SERVICE_STOP = re.compile(r"^/services/(?P<sid>[^/]+)/stop$")
_PREDICT_RELAY = re.compile(
    r"^/predict_relay/(?P<job>[^/]+)/(?P<wid>[^/]+)$")
#: the line an agent prints once it listens (the address after ``http://``)
READY_PREFIX = "rafiki_tpu_torch agent on http://"


class AgentServer:
    """HTTP front of a host-local ``ProcessPlacementManager`` (or any
    engine with its ``create_service``, ``destroy_service``,
    ``list_services``, ``_runners``, ``allocator``, ``broker`` and
    ``stop_all``)."""

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 0,
                 key: Optional[str] = None, allow_insecure: bool = False):
        self.engine = engine
        self.host = host
        self.port = port
        self.key = key
        self.allow_insecure = allow_insecure
        self.hostname = socket.gethostname()
        self._httpd: Optional[SeveringHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        # the epoch fence: the highest admin epoch an authenticated call
        # carried
        self._epoch_lock = threading.Lock()
        self._admin_epoch = 0  # guarded-by: _epoch_lock
        # relays answered, and of them as binary frames
        self._relays_lock = threading.Lock()
        self._relays = {"json": 0, "binary": 0}  # guarded-by: _relays_lock

    def start(self) -> "AgentServer":
        server = self

        class Handler(LowLatencyHandler):
            def do_GET(self):
                server._dispatch(self, "GET")

            def do_POST(self):
                server._dispatch(self, "POST")

        self._httpd = SeveringHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="agent-http")
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
            # a stopped agent goes dark as a killed host does
            self._httpd.sever()
        self.engine.stop_all()

    # -- requests ----------------------------------------------------------

    def _dispatch(self, handler: BaseHTTPRequestHandler, method: str) -> None:
        try:
            path = handler.path.split("?", 1)[0].rstrip("/")
            rule = chaos.hit(chaos.SITE_AGENT, path)
            if rule is not None:
                if rule.action == chaos.ACTION_DROP:
                    handler.close_connection = True
                    return  # no answer: the caller sees a dead host
                if rule.action == chaos.ACTION_ERROR:
                    # the body is unread: the connection ends with it
                    handler.close_connection = True
                    return self._respond(handler, rule.code,
                                         {"error": "chaos-injected error"})
                chaos.sleep_for(rule)
            raw, berr = read_bounded_body(handler, config.PREDICT_MAX_BODY_MB)
            if berr:
                return self._respond(handler, berr[0], {"error": berr[1]})
            if method == "GET" and path == "/healthz":
                with self._epoch_lock:
                    seen = self._admin_epoch
                return self._respond(handler, 200, {
                    "host": self.hostname, "status": "ok",
                    "admin_epoch": seen,
                    "wire_versions": sorted(wire.SUPPORTED_VERSIONS)})
            if method == "GET" and path == "/metrics":
                # open, as /healthz is: counters and gauges only
                return serve_http(handler,
                                  handler.path.partition("?")[2])
            if self.key:
                provided = handler.headers.get(AGENT_KEY_HEADER) or ""
                if not hmac.compare_digest(provided, self.key):
                    return self._respond(handler, 401,
                                         {"error": "bad agent key"})
            elif not self.allow_insecure:
                return self._respond(handler, 403, {
                    "error": "agent has no key configured and "
                             "RAFIKI_AGENT_INSECURE=1 was not set — "
                             "refusing all placement/relay requests"})
            # the epoch fence, after the key: only keyed admins ratchet it
            call_epoch: Optional[int] = None
            epoch_hdr = handler.headers.get(ADMIN_EPOCH_HEADER)
            if epoch_hdr is not None:
                try:
                    call_epoch = int(epoch_hdr)
                except ValueError:
                    return self._respond(handler, 400, {
                        "error": "malformed admin epoch header"})
            with self._epoch_lock:
                if call_epoch is not None and call_epoch > self._admin_epoch:
                    self._admin_epoch = call_epoch
                seen = self._admin_epoch
            mutating = method == "POST" and (
                path == "/services" or _SERVICE_STOP.match(path) is not None)
            if (mutating and seen > 0
                    and (call_epoch is None or call_epoch < seen)):
                return self._respond(handler, STALE_EPOCH_STATUS, {
                    "error": f"stale admin epoch "
                             f"{call_epoch if call_epoch is not None else 0}"
                             f" < {seen}: a newer admin holds the "
                             "leadership lease; refusing mutation",
                    "admin_epoch": seen})
            body: Dict[str, Any] = {}
            binary_req = False
            if raw:
                ctype = ((handler.headers.get("Content-Type") or "")
                         .split(";")[0].strip().lower())
                if ctype == wire.CONTENT_TYPE or wire.is_frame(raw):
                    try:
                        body = wire.decode(raw)
                    except wire.WireFormatError as e:
                        return self._respond(handler, 400, {
                            "error": f"bad wire frame: {e}"})
                    if not isinstance(body, dict):
                        return self._respond(handler, 400, {
                            "error": "wire frame body must be an object"})
                    binary_req = True
                else:
                    try:
                        body = json.loads(raw)
                    except ValueError:
                        return self._respond(handler, 400, {
                            "error": "body is not JSON"})
            if method == "GET" and path == "/inventory":
                alloc = self.engine.allocator
                return self._respond(handler, 200, {
                    "host": self.hostname,
                    "total_chips": alloc.total_chips,
                    "free_chips": alloc.free_chips,
                    # placed and not yet stopped, as the original counts
                    "n_services": len(self.engine._runners),
                    "admin_epoch": seen,
                    "services": self.engine.list_services(),
                    # the port's own: relays answered, in JSON and frames
                    "relays": self.relay_counts(),
                })
            if method == "POST" and path == "/services":
                return self._create(handler, body)
            m = _SERVICE_STOP.match(path) if method == "POST" else None
            if m:
                self.engine.destroy_service(
                    m.group("sid"), wait=bool(body.get("wait", False)))
                return self._respond(handler, 200, {})
            m = _PREDICT_RELAY.match(path) if method == "POST" else None
            if m:
                return self._predict_relay(
                    handler, m.group("job"), m.group("wid"), body,
                    binary=binary_req)
            self._respond(handler, 404, {"error": f"no route {method} {path}"})
        except Exception:
            # the traceback stays in the agent's log, never on the wire
            logger.exception("agent request failed")
            self._respond(handler, 500, {"error": "internal agent error"})

    def _create(self, handler, body: Dict[str, Any]) -> None:
        stype = body.get("service_type")
        if stype not in (ServiceType.TRAIN, ServiceType.INFERENCE):
            return self._respond(handler, 400, {
                "error": f"agents place TRAIN/INFERENCE services, not "
                         f"{stype!r} (PREDICT runs in the admin process)"})
        if stype == ServiceType.INFERENCE and self.engine.broker is None:
            return self._respond(handler, 503, {
                "error": "this agent has no serving data plane (native shm "
                         "broker unavailable)"})
        try:
            ctx = self.engine.create_service(
                body["service_id"], stype,
                n_chips=int(body.get("n_chips", 0)),
                best_effort_chips=bool(body.get("best_effort_chips")),
                extra=body.get("extra") or {})
        except InsufficientChipsError as e:
            return self._respond(handler, 503, {"error": str(e)})
        return self._respond(handler, 200, {"chips": list(ctx.chips)})

    def _predict_relay(self, handler, job_id: str, worker_id: str,
                       body: Dict[str, Any], binary: bool = False) -> None:
        """Submit the relayed batch to the worker's host-local queue and
        answer once the worker resolved it, all or nothing: a worker
        error fails the relay, and the predictor's failover takes it from
        there. A sampled ``trace`` context gets this host's spans back as
        ``trace_spans``."""
        if self.engine.broker is None:
            return self._respond(handler, 503, {
                "error": "no serving data plane on this agent"})
        queries = body.get("queries")
        if isinstance(queries, np.ndarray):
            if queries.ndim < 1:
                return self._respond(handler, 400, {
                    "error": "stacked queries need a leading batch axis"})
            queries = list(queries)  # row views
        if not isinstance(queries, list) or not queries:
            return self._respond(handler, 400, {
                "error": "body must carry a non-empty 'queries' list"})
        queue = self.engine.broker.get_worker_queues(job_id).get(worker_id)
        if queue is None:
            return self._respond(handler, 404, {
                "error": f"no worker {worker_id} for job {job_id} on this "
                         "host"})
        # no cap: the sender holds the fleet key and forwards the admin's
        # own resolved timeout
        timeout_s, terr = parse_timeout_s(
            body.get("timeout_s"), default=config.PREDICT_TIMEOUT_S,
            cap=None)
        if terr:
            return self._respond(handler, 400, {"error": terr})
        deadline = time.monotonic() + timeout_s
        ctx = rtrace.TraceContext.from_wire(body.get("trace"))
        rt = (rtrace.RequestTrace(ctx)
              if ctx is not None and ctx.sampled else None)
        try:
            futures = queue.submit_many(
                queries, deadline=deadline,
                **({"trace": rt} if rt is not None else {}))
        except QueueFullError as e:
            return self._respond(handler, 429, {"error": str(e)})
        try:
            preds = [f.result(max(deadline - time.monotonic(), 0.0))
                     for f in futures]
        except TimeoutError:
            return self._respond(handler, 504, {
                "error": f"worker {worker_id} missed the {timeout_s:.0f}s "
                         "relay deadline"})
        except Exception:
            logger.exception("relay to worker %s failed", worker_id)
            return self._respond(handler, 502, {
                "error": f"worker {worker_id}: relay failed (see agent "
                         "log)"})
        with self._relays_lock:
            self._relays["binary" if binary else "json"] += 1
        payload: Dict[str, Any] = {"predictions": preds}
        if rt is not None:
            # against this agent's submit; the relay re-anchors at its own
            anchor = rt.t_submit if rt.t_submit is not None else rt.t0
            payload["trace_spans"] = rt.wire_spans(anchor)
        if binary:
            return self._respond_frame(handler, payload)
        self._respond(handler, 200, payload)

    def relay_counts(self) -> Dict[str, int]:
        with self._relays_lock:
            return dict(self._relays)

    @staticmethod
    def _respond(handler, code: int, payload: Dict[str, Any]) -> None:
        data = json.dumps(payload, default=json_default).encode()
        handler.send_response(code)
        handler.send_header("Content-Type", "application/json")
        handler.send_header("Content-Length", str(len(data)))
        handler.end_headers()
        handler.wfile.write(data)

    @staticmethod
    def _respond_frame(handler, payload: Dict[str, Any]) -> None:
        """A binary relay's success: one wire frame back. Errors answer
        JSON, whose decode the control plane shares."""
        data = wire.encode(payload)
        handler.send_response(200)
        handler.send_header("Content-Type", wire.CONTENT_TYPE)
        handler.send_header("Content-Length", str(len(data)))
        handler.end_headers()
        handler.wfile.write(data)


def _admin_status_forwarder(db, admin_addr: Optional[str]):
    """A child's status: written to the shared store here, then forwarded
    best effort as the admin's ``service_status`` event (the job's
    refresh hangs off the admin's status callback)."""
    client_box: Dict[str, Any] = {}

    def on_status(service_id: str, status: str) -> None:
        try:
            if status == ServiceStatus.RUNNING:
                db.mark_service_as_running(service_id)
            elif status == ServiceStatus.STOPPED:
                db.mark_service_as_stopped(service_id)
            elif status == ServiceStatus.ERRORED:
                db.mark_service_as_errored(service_id)
        except Exception:
            logger.exception("status write failed for %s", service_id)
        if not admin_addr:
            return
        try:
            if "client" not in client_box:
                from rafiki_tpu_torch.client.client import Client

                host, port = admin_addr.rsplit(":", 1)
                c = Client(admin_host=host, admin_port=int(port))
                c.login(config.SUPERADMIN_EMAIL, config.SUPERADMIN_PASSWORD)
                client_box["client"] = c
            client_box["client"].send_event(
                "service_status", service_id=service_id, status=status)
        except Exception:
            client_box.pop("client", None)  # log in again next time
            logger.warning("could not forward status of %s to admin",
                           service_id)

    return on_status


def probe_cuda_count(timeout_s: float = 120.0):
    """(cards, error) as CUDA counts them, waited for at most
    ``timeout_s``: a driver that hangs costs the agent a bounded wait (the
    count runs on a daemon thread, abandoned past the deadline)."""
    out: Dict[str, Any] = {}

    def count():
        try:
            import torch

            out["n"] = torch.cuda.device_count()
        except Exception as e:  # reported as the probe's error
            out["err"] = f"the CUDA probe failed: {e}"

    t = threading.Thread(target=count, name="cuda-probe", daemon=True)
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        return 0, f"the CUDA probe did not answer within {timeout_s:.0f}s"
    if "err" in out:
        return 0, out["err"]
    n = int(out["n"])
    return n, (None if n else "no CUDA device visible")


def _parse_chips(spec: str) -> List[Any]:
    return [c.strip() if c.strip().startswith("cpu") else int(c)
            for c in spec.split(",") if c.strip()]


def main() -> int:
    logging.basicConfig(
        level=os.environ.get("RAFIKI_LOG_LEVEL", "INFO"),
        format="%(levelname)s:%(asctime)s:agent:%(name)s: %(message)s")
    if chaos.enabled():
        logger.warning("RAFIKI_CHAOS set: fault injection is ACTIVE on this "
                       "agent (unset it outside failover drills)")
    key = os.environ.get("RAFIKI_AGENT_KEY")
    insecure = os.environ.get("RAFIKI_AGENT_INSECURE") == "1"
    if not key and not insecure:
        print("RAFIKI_AGENT_KEY required: the agent API places services "
              "and relays predictions, so it is auth-gated by default. Set "
              "RAFIKI_AGENT_INSECURE=1 to run keyless on a trusted "
              "network.", file=sys.stderr)
        return 2
    db_path = os.environ.get("RAFIKI_DB_PATH")
    if not db_path:
        print("RAFIKI_DB_PATH required (the shared metadata store)",
              file=sys.stderr)
        return 2
    chips = _parse_chips(os.environ.get("RAFIKI_AGENT_CHIPS", ""))
    cuda = [c for c in chips if not isinstance(c, str)]
    if not chips or cuda:
        # never an in-process count: a hung driver must not hang the agent
        n, err = probe_cuda_count()
        if not n or (cuda and max(cuda) >= n):
            why = err or (f"RAFIKI_AGENT_CHIPS lists card {max(cuda)}, "
                          f"{n} visible")
            print(f"could not discover this host's chips ({why}); set "
                  "RAFIKI_AGENT_CHIPS to the device indices this host "
                  "should contribute", file=sys.stderr)
            return 2
        chips = chips or list(range(n))
    from rafiki_tpu_torch.db.database import Database

    db = Database(db_path)
    admin_addr = os.environ.get("RAFIKI_ADMIN_ADDR")
    broker = None
    try:
        # the host's serving data plane: this process owns the rings its
        # serving children attach to
        from rafiki_tpu_torch.cache.shm_broker import ShmBroker

        broker = ShmBroker()
    except Exception as e:
        logger.warning("no serving data plane on this host (%s); the agent "
                       "places TRAIN services only", e)
    engine = ProcessPlacementManager(
        db=db, allocator=ChipAllocator(chips), broker=broker,
        on_status=_admin_status_forwarder(db, admin_addr))
    if admin_addr:
        host, _, port = admin_addr.rpartition(":")
        engine.admin_addr = (host, int(port))
    server = AgentServer(
        engine, host=os.environ.get("RAFIKI_AGENT_HOST", "127.0.0.1"),
        port=int(os.environ.get("RAFIKI_AGENT_PORT", "0")),
        key=key, allow_insecure=insecure).start()
    print(f"{READY_PREFIX}{server.host}:{server.port} (chips={chips}, "
          f"db={db_path})", flush=True)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    try:
        stop.wait()
    finally:
        server.stop()
        if broker is not None:
            broker.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
