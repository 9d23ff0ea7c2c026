"""The REST door over ``Admin``.

Own copy of ``rafiki_tpu/admin/http.py`` for the routes whose ``Admin``
method this package has: the same paths, methods, user-type gates,
``{"data": ...}`` envelope and error-to-status mapping. Built on the
standard library's threading HTTP server; every route body is one
``Admin`` call. A model upload is JSON with the template base64-encoded.

The advisor routes a process-placed train worker uses (create, propose,
propose_batch, feedback, feedback_batch, infeasible, replay, report_rung,
delete) are carried; ``start`` tells a process placement the door's
address (``admin_addr``). The live fleet's routes are carried: ``scale``,
``update`` (a rollout; a second while one is live answers 409),
``rollout``, ``rollout/abort`` and ``rollout/ack``, and the drift
loop's ``drift`` and ``drift/ack``.

The public root carries the admin's recovery state and its HA role and
leader hint. ``GET /metrics`` answers the process registry's Prometheus
text (``?format=json``: the snapshot with the rings) before any gate and
without a token, as JAX's does. ``GET /trials/<id>/trace`` serves a
trial's spans and ``GET /fleet/health`` (admins) the fleet's health. Two
gates answer before a route runs (after the body is read, so a
keep-alive connection stays framed): a standby (``admin/standby.py``)
answers only the root, ``/tokens`` and ``/fleet/health`` (its snapshot),
and sheds the rest with a 503 carrying ``standby`` and the ``leader``
hint; an admin whose boot reconciliation runs (``admin/recovery.py``)
sheds with a 503 carrying its public ``recovery`` state, letting through
the root, ``/tokens``, ``/fleet/health``, worker events and the advisor
routes (a surviving train worker keeps proposing while it is adopted). A
fenced ex-leader (its
lease lapsed or taken over) sheds as a standby does, its answer typed as
the fence's (``StaleEpochError``), and so does a write the fence refuses
mid-request: a client walks to the leader. JAX's door sheds only as a
standby, so its fenced ex-leader goes on answering the routes that write
nothing to the store, the advisor sessions among them, from its stale
memory (ROADMAP.md, C). Not carried (ROADMAP.md, item 13): the web UI.
"""

from __future__ import annotations

import base64
import json
import logging
import re
import threading
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from rafiki_tpu_torch import config
from rafiki_tpu_torch.admin.admin import Admin, InvalidRequestError
from rafiki_tpu_torch.admin.rollout import RolloutInFlightError
from rafiki_tpu_torch.cache.queue import FrameTooLargeError, QueueFullError
from rafiki_tpu_torch.constants import UserType
from rafiki_tpu_torch.db.database import StaleEpochError
from rafiki_tpu_torch.placement.hosts import StaleAdminEpochError
from rafiki_tpu_torch.placement.manager import InsufficientChipsError
from rafiki_tpu_torch.predictor.admission import (
    DeadlineUnmeetableError,
    ServerOverloadedError,
    retry_after_headers,
)
from rafiki_tpu_torch.predictor.server import DoorHTTPServer
from rafiki_tpu_torch.sdk.artifact import ArtifactCorruptError
from rafiki_tpu_torch.sdk.knob import deserialize_knob_config
from rafiki_tpu_torch.sdk.model import InvalidModelClassError
from rafiki_tpu_torch.utils.auth import (
    UnauthorizedError,
    auth_check,
    decode_token,
)
from rafiki_tpu_torch.utils.metrics import serve_http
from rafiki_tpu_torch.utils.reqfields import (
    LowLatencyHandler,
    read_bounded_body,
)

logger = logging.getLogger(__name__)

_ANY = None  # any authenticated user
_ADMINS = [UserType.ADMIN, UserType.SUPERADMIN]
_MODEL_DEVS = [UserType.MODEL_DEVELOPER] + _ADMINS
_APP_DEVS = [UserType.APP_DEVELOPER] + _ADMINS
#: what a fenced ex-leader answers, before a route runs or when the fence
#: refuses a write mid-request
_FENCED = "StaleEpochError: admin lost leadership; retry against the leader"

Route = Tuple[str, re.Pattern, Optional[List[str]], Callable]


def _field(body: Dict[str, Any], name: str) -> Any:
    """A required body field; missing is a 400 at the route boundary, so a
    KeyError from inside Admin stays a genuine 500."""
    try:
        return body[name]
    except (KeyError, TypeError):
        raise InvalidRequestError(f"missing body field '{name}'")


def _b64_field(body: Dict[str, Any], name: str) -> bytes:
    try:
        return base64.b64decode(_field(body, name))
    except (ValueError, TypeError) as e:
        raise InvalidRequestError(f"field '{name}' is not valid base64: {e}")


def _num_field(body: Dict[str, Any], name: str, cast, default=None):
    """A numeric body field coerced with ``cast``; a malformed value is a
    400. ``default=None`` makes the field required."""
    if name not in body:
        if default is None:
            raise InvalidRequestError(f"missing body field '{name}'")
        return default
    try:
        return cast(body[name])
    except (ValueError, TypeError) as e:
        raise InvalidRequestError(
            f"field '{name}' must be {cast.__name__}: {e}")


def _list_field(body: Dict[str, Any], name: str) -> list:
    """A required body field that must be a JSON array."""
    value = _field(body, name)
    if not isinstance(value, list):
        raise InvalidRequestError(
            f"field '{name}' must be a list, got {type(value).__name__}")
    return value


#: the door's cap on one batch of proposals: each draw is a GP fit and an
#: EI search under the session's lock
PROPOSE_BATCH_MAX = 64


def _knob_config_field(body: Dict[str, Any]):
    """A client's serialized knob config; a malformed one is a 400."""
    try:
        return deserialize_knob_config(_field(body, "knob_config"))
    except (ValueError, TypeError, KeyError, AttributeError) as e:
        raise InvalidRequestError(f"invalid knob_config: {e}")


def _int_param(query: Dict[str, str], name: str, default: int) -> int:
    try:
        return int(query.get(name, default))
    except (ValueError, TypeError) as e:
        raise InvalidRequestError(f"query param '{name}' must be an int: {e}")


class AdminServer:
    """The HTTP door; ``start()`` binds and serves on a daemon thread."""

    def __init__(self, admin: Admin, host: str = "127.0.0.1", port: int = 0):
        self.admin = admin
        self.host = host
        self.port = port
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self.routes: List[Route] = self._build_routes()

    def start(self) -> "AdminServer":
        server = self

        class Handler(LowLatencyHandler):
            # keep-alive: every response sends Content-Length; the idle
            # timeout reaps the thread of a client that died silently
            protocol_version = "HTTP/1.1"
            timeout = 300

            def do_GET(self):
                server._dispatch(self, "GET")

            def do_POST(self):
                server._dispatch(self, "POST")

            def do_DELETE(self):
                server._dispatch(self, "DELETE")

        self._httpd = DoorHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]
        # worker processes reach the advisor and send events through this
        # door: tell a process placement where it is (a standby has no
        # placement until it promotes)
        placement = getattr(self.admin, "placement", None)
        if placement is not None and hasattr(placement, "admin_addr"):
            placement.admin_addr = (self.host, self.port)
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="admin-door", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._httpd is None:
            return
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)
        self._httpd = None

    # -- routing -----------------------------------------------------------

    def _build_routes(self) -> List[Route]:
        A = self.admin

        def r(method: str, pattern: str, allowed, fn) -> Route:
            return (method, re.compile(f"^{pattern}$"), allowed, fn)

        return [
            # the recovery state and the HA role are public: a client
            # without credentials waits out a restart, and walks the
            # addresses, on them
            r("GET", "/", "public", lambda au, m, b, q: {
                "name": "rafiki_tpu_torch admin", "status": "ok",
                "recovery": A.recovery_public(), "ha": A.ha_public()}),
            r("POST", "/tokens", "public", lambda au, m, b, q:
                A.authenticate_user(_field(b, "email"),
                                    _field(b, "password"))),
            # users
            r("POST", "/users", _ADMINS, lambda au, m, b, q: A.create_user(
                _field(b, "email"), _field(b, "password"),
                _field(b, "user_type"))),
            r("GET", "/users", _ADMINS, lambda au, m, b, q: A.get_users()),
            r("DELETE", "/users", _ADMINS, lambda au, m, b, q: A.ban_user(
                _field(b, "email"))),
            # models
            r("POST", "/models", _MODEL_DEVS, lambda au, m, b, q:
                A.create_model(
                    au["user_id"], _field(b, "name"), _field(b, "task"),
                    _b64_field(b, "model_file_base64"),
                    _field(b, "model_class"), b.get("dependencies"),
                    b.get("access_right", "PRIVATE"))),
            r("POST", "/models/verify", _MODEL_DEVS, lambda au, m, b, q:
                A.verify_model(_b64_field(b, "model_file_base64"),
                               _field(b, "model_class"),
                               b.get("dependencies"))),
            r("GET", "/models", _ANY, lambda au, m, b, q: A.get_models(
                au["user_id"], q.get("task"))),
            r("GET", r"/models/(?P<name>[^/]+)", _ANY, lambda au, m, b, q:
                A.get_model(au["user_id"], m["name"], q.get("owner_id"))),
            r("GET", r"/models/(?P<name>[^/]+)/file", _ANY,
                lambda au, m, b, q: {"model_file_base64": base64.b64encode(
                    A.get_model_file(au["user_id"], m["name"],
                                     q.get("owner_id"))).decode()}),
            r("DELETE", r"/models/(?P<name>[^/]+)", _MODEL_DEVS,
                lambda au, m, b, q: A.delete_model(au["user_id"],
                                                   m["name"]) or {}),
            # train jobs
            r("POST", "/train_jobs", _APP_DEVS, lambda au, m, b, q:
                A.create_train_job(
                    au["user_id"], _field(b, "app"), _field(b, "task"),
                    _field(b, "train_dataset_uri"),
                    _field(b, "test_dataset_uri"), b.get("budget"),
                    b.get("models"))),
            r("GET", "/train_jobs", _ANY, lambda au, m, b, q:
                A.get_train_jobs_of_user(au["user_id"])),
            r("GET", r"/train_jobs/(?P<app>[^/]+)", _ANY, lambda au, m, b, q:
                A.get_train_jobs_of_app(au["user_id"], m["app"])),
            r("GET", r"/train_jobs/(?P<app>[^/]+)/(?P<v>-?\d+)", _ANY,
                lambda au, m, b, q: A.get_train_job(
                    au["user_id"], m["app"], int(m["v"]))),
            r("POST", r"/train_jobs/(?P<app>[^/]+)/(?P<v>-?\d+)/stop",
                _APP_DEVS, lambda au, m, b, q: A.stop_train_job(
                    au["user_id"], m["app"], int(m["v"]))),
            r("GET", r"/train_jobs/(?P<app>[^/]+)/(?P<v>-?\d+)/trials", _ANY,
                lambda au, m, b, q: A.get_trials_of_train_job(
                    au["user_id"], m["app"], int(m["v"]))),
            r("GET", r"/train_jobs/(?P<app>[^/]+)/(?P<v>-?\d+)/best_trials",
                _ANY, lambda au, m, b, q: A.get_best_trials_of_train_job(
                    au["user_id"], m["app"], int(m["v"]),
                    _int_param(q, "max_count", 2))),
            # trials
            r("GET", r"/trials/(?P<tid>[^/]+)/logs", _ANY, lambda au, m, b, q:
                A.get_trial_logs(m["tid"])),
            r("GET", r"/trials/(?P<tid>[^/]+)/trace", _ANY, lambda au, m, b, q:
                A.get_trial_trace(m["tid"])),
            r("GET", r"/trials/(?P<tid>[^/]+)/parameters", _ANY,
                lambda au, m, b, q: {"params_base64": base64.b64encode(
                    A.get_trial_params(m["tid"])).decode()}),
            r("GET", r"/trials/(?P<tid>[^/]+)", _ANY, lambda au, m, b, q:
                A.get_trial(m["tid"])),
            # inference jobs
            r("POST", "/inference_jobs", _APP_DEVS, lambda au, m, b, q:
                A.create_inference_job(
                    au["user_id"], _field(b, "app"), b.get("app_version", -1),
                    budget=b.get("budget"))),
            r("GET", r"/inference_jobs/(?P<app>[^/]+)/(?P<v>-?\d+)", _ANY,
                lambda au, m, b, q: A.get_inference_job(
                    au["user_id"], m["app"], int(m["v"]))),
            r("GET", r"/inference_jobs/(?P<app>[^/]+)/(?P<v>-?\d+)/stats",
                _ANY, lambda au, m, b, q: A.get_inference_job_stats(
                    au["user_id"], m["app"], int(m["v"]))),
            r("POST", r"/inference_jobs/(?P<app>[^/]+)/(?P<v>-?\d+)/stop",
                _APP_DEVS, lambda au, m, b, q: A.stop_inference_job(
                    au["user_id"], m["app"], int(m["v"]))),
            # the live fleet: add or drain replicas; move the job to
            # another trial under traffic (admin/rollout.py)
            r("POST", r"/inference_jobs/(?P<app>[^/]+)/(?P<v>-?\d+)/scale",
                _APP_DEVS, lambda au, m, b, q: A.scale_inference_job(
                    au["user_id"], m["app"], int(m["v"]),
                    delta=_num_field(b, "delta", int))),
            r("POST", r"/inference_jobs/(?P<app>[^/]+)/(?P<v>-?\d+)/update",
                _APP_DEVS, lambda au, m, b, q: A.update_inference_job(
                    au["user_id"], m["app"], int(m["v"]),
                    trial_id=_field(b, "trial_id"),
                    canary_fraction=(
                        _num_field(b, "canary_fraction", float, -1.0)
                        if "canary_fraction" in b else None),
                    batch=(_num_field(b, "batch", int, 1)
                           if "batch" in b else None))),
            r("GET", r"/inference_jobs/(?P<app>[^/]+)/(?P<v>-?\d+)/rollout",
                _ANY, lambda au, m, b, q: A.get_rollout_status(
                    au["user_id"], m["app"], int(m["v"]))),
            r("POST",
                r"/inference_jobs/(?P<app>[^/]+)/(?P<v>-?\d+)/rollout/abort",
                _APP_DEVS, lambda au, m, b, q: A.abort_rollout(
                    au["user_id"], m["app"], int(m["v"]))),
            r("POST",
                r"/inference_jobs/(?P<app>[^/]+)/(?P<v>-?\d+)/rollout/ack",
                _APP_DEVS, lambda au, m, b, q: A.ack_rollout(
                    au["user_id"], m["app"], int(m["v"]))),
            # the drift loop: its state and live signals; the ack re-arms
            # a parked loop or clears a rollback streak
            r("GET", r"/inference_jobs/(?P<app>[^/]+)/(?P<v>-?\d+)/drift",
                _ANY, lambda au, m, b, q: A.get_drift_status(
                    au["user_id"], m["app"], int(m["v"]))),
            r("POST",
                r"/inference_jobs/(?P<app>[^/]+)/(?P<v>-?\d+)/drift/ack",
                _APP_DEVS, lambda au, m, b, q: A.ack_drift(
                    au["user_id"], m["app"], int(m["v"]))),
            # serving
            r("POST", r"/predict/(?P<app>[^/]+)", _ANY, lambda au, m, b, q:
                {"predictions": A.predict(
                    au["user_id"], m["app"], _field(b, "queries"),
                    b.get("app_version", -1))}),
            # advisor sessions: process-placed train workers propose and
            # feed back through these (advisor/remote.py)
            r("POST", "/advisors", _ANY, lambda au, m, b, q: {
                "advisor_id": A.advisor_store.create_advisor(
                    _knob_config_field(b),
                    advisor_id=b.get("advisor_id"))}),
            r("POST", r"/advisors/(?P<aid>[^/]+)/propose", _ANY,
                lambda au, m, b, q: {
                    "knobs": A.advisor_store.propose(m["aid"])}),
            r("POST", r"/advisors/(?P<aid>[^/]+)/propose_batch", _ANY,
                lambda au, m, b, q: {
                    "knobs_list": A.advisor_store.propose_batch(
                        m["aid"], max(1, min(_num_field(b, "k", int, 1),
                                             PROPOSE_BATCH_MAX)))}),
            r("POST", r"/advisors/(?P<aid>[^/]+)/feedback", _ANY,
                lambda au, m, b, q: {"knobs": A.advisor_store.feedback(
                    m["aid"], _field(b, "knobs"), _field(b, "score"))}),
            r("POST", r"/advisors/(?P<aid>[^/]+)/feedback_batch", _ANY,
                lambda au, m, b, q: {
                    "count": A.advisor_store.feedback_batch(
                        m["aid"],
                        [(_field(i, "knobs"), _field(i, "score"))
                         for i in _list_field(b, "items")])}),
            # scoreless-failure signal (the trial fault taxonomy): the GP
            # steers away; trial_id makes the session's ASHA scheduler
            # forget the dead trial's rung records
            r("POST", r"/advisors/(?P<aid>[^/]+)/infeasible", _ANY,
                lambda au, m, b, q: {
                    "infeasible": A.advisor_store.feedback_infeasible(
                        m["aid"], _field(b, "knobs"),
                        kind=b.get("kind", "USER"),
                        trial_id=b.get("trial_id"))}),
            r("POST", r"/advisors/(?P<aid>[^/]+)/replay", _ANY,
                lambda au, m, b, q: {
                    "replayed": A.advisor_store.replay_feedback(
                        m["aid"],
                        [(_field(i, "knobs"), _field(i, "score"))
                         for i in _list_field(b, "items")],
                        infeasible=[
                            (_field(i, "knobs"), i.get("kind", "USER"))
                            for i in b.get("infeasible") or []])}),
            # ASHA rung report (early stopping, advisor/asha.py)
            r("POST", r"/advisors/(?P<aid>[^/]+)/report_rung", _ANY,
                lambda au, m, b, q: {"keep": A.advisor_store.report_rung(
                    m["aid"], _field(b, "trial_id"),
                    _num_field(b, "resource", int),
                    _num_field(b, "value", float),
                    min_resource=_num_field(b, "min_resource", int, 1),
                    eta=_num_field(b, "eta", int, 3),
                    mode=b.get("mode", "min"))}),
            r("DELETE", r"/advisors/(?P<aid>[^/]+)", _ANY, lambda au, m, b, q:
                A.advisor_store.delete_advisor(m["aid"]) or {}),
            # admin actions
            r("POST", "/actions/stop_all_jobs", _ADMINS,
                lambda au, m, b, q: A.stop_all_jobs() or {}),
            # the fleet's health (a standby answers its snapshot)
            r("GET", "/fleet/health", _ADMINS,
                lambda au, m, b, q: A.get_fleet_health()),
            # worker events: workers authenticate as superadmin; plain users
            # must not stop other tenants' services through this
            r("POST", r"/event/(?P<name>[^/]+)", _ADMINS, lambda au, m, b, q:
                A.handle_event(m["name"], b) or {}),
        ]

    def _dispatch(self, handler: BaseHTTPRequestHandler, method: str) -> None:
        try:
            parsed = urlparse(handler.path)
            path = parsed.path.rstrip("/") or "/"
            if method == "GET" and path == "/metrics":
                # open, and before the gates: a recovering or standby
                # admin's counters are what an operator wants to watch
                serve_http(handler, parsed.query)
                return
            # the body is read before any answer: an early answer that
            # leaves it unread desyncs keep-alive framing
            raw, berr = read_bounded_body(handler, config.ADMIN_MAX_BODY_MB)
            if berr:
                raise InvalidRequestError(f"{berr[1]} (ADMIN_MAX_BODY_MB)")
            role = self.admin.ha_role()
            if role in ("standby", "fenced") and not (
                    path in ("/", "/tokens")
                    or (role == "standby" and path == "/fleet/health")):
                self._shed_to_leader(handler, (
                    "admin is a hot standby; mutations go to the leader"
                    if role == "standby" else _FENCED))
                return
            if (self.admin.recovery_status().get("state") == "recovering"
                    and not (path in ("/", "/tokens", "/fleet/health")
                             or path.startswith("/event/")
                             or path.startswith("/advisors"))):
                self._respond(
                    handler, 503,
                    {"error": "admin is recovering (boot reconciliation "
                              "in progress); retry shortly",
                     "recovery": self.admin.recovery_public()},
                    headers={"Retry-After": "1"})
                return
            query = {k: v[0] for k, v in parse_qs(parsed.query).items()}
            body: Dict[str, Any] = {}
            try:
                if raw:
                    body = json.loads(raw)
            except (ValueError, UnicodeDecodeError) as e:
                raise InvalidRequestError(f"malformed request body: {e}")
            if raw and not isinstance(body, dict):
                raise InvalidRequestError("request body must be a JSON object")
            for m, pattern, allowed, fn in self.routes:
                if m != method:
                    continue
                match = pattern.match(path)
                if not match:
                    continue
                auth: Dict[str, Any] = {}
                if allowed != "public":
                    token = (handler.headers.get("Authorization")
                             or "").removeprefix("Bearer ")
                    auth = decode_token(token)
                    if allowed is not _ANY:
                        auth_check(auth, allowed)
                result = fn(auth, match.groupdict(), body, query)
                self._respond(handler, 200, {"data": result})
                return
            self._respond(handler, 404, {"error": f"No route {method} {path}"})
        except UnauthorizedError as e:
            self._respond(handler, 401, {"error": str(e)})
        except (InvalidRequestError, InvalidModelClassError) as e:
            self._respond(handler, 400, {"error": f"{type(e).__name__}: {e}"})
        except RolloutInFlightError as e:
            # one live rollout a job: retry once it ends, or abort it
            self._respond(handler, 409, {"error": f"{type(e).__name__}: {e}"})
        except FrameTooLargeError as e:
            # permanent for this payload: 413, never the retryable 429
            self._respond(handler, 413, {"error": f"{type(e).__name__}: {e}"})
        except ArtifactCorruptError as e:
            self._respond(handler, 500, {"error": f"{type(e).__name__}: {e}"})
        except (QueueFullError, DeadlineUnmeetableError) as e:
            # overload, retryable: 429 + Retry-After, as the job's own door
            self._respond(handler, 429, {"error": f"{type(e).__name__}: {e}"},
                          headers=retry_after_headers(e))
        except ServerOverloadedError as e:
            # the door's in-flight slots are gone
            self._respond(handler, 503, {"error": f"{type(e).__name__}: {e}"},
                          headers=retry_after_headers(e))
        except TimeoutError as e:
            self._respond(handler, 504, {"error": f"{type(e).__name__}: {e}"})
        except InsufficientChipsError as e:
            self._respond(handler, 503, {"error": f"{type(e).__name__}: {e}"})
        except (StaleEpochError, StaleAdminEpochError):
            # the fence fired (the store's, or an agent's 412): this admin
            # lost the leadership mid-request
            self._shed_to_leader(handler, _FENCED)
        except Exception:
            # the traceback stays in the server's log, never in an answer
            logger.error("unhandled error on %s %s:\n%s", method,
                         handler.path, traceback.format_exc())
            self._respond(handler, 500, {"error": "internal server error"})

    def _shed_to_leader(self, handler, error: str) -> None:
        """A 503 the client walks on from: ``standby`` and the leader's
        address."""
        self._respond(handler, 503, {"error": error, "standby": True,
                                     "leader": self.admin.leader_hint()},
                      headers={"Retry-After": "1"})

    @staticmethod
    def _respond(handler, code: int, payload: Dict[str, Any],
                 headers: Optional[Dict[str, str]] = None) -> None:
        data = json.dumps(payload).encode()
        handler.send_response(code)
        handler.send_header("Content-Type", "application/json")
        handler.send_header("Content-Length", str(len(data)))
        for k, v in (headers or {}).items():
            handler.send_header(k, v)
        handler.end_headers()
        handler.wfile.write(data)
