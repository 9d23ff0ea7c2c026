"""The Python client of the admin's REST door.

Own copy of ``rafiki_tpu/client/client.py`` for the routes this package
serves, with the same method names, arguments and return values: login,
users, models (upload from a file path or bytes, download, dry-run
verification), train jobs, trials (logs, params, ``load_trial_model``),
inference jobs and ``predict``, ``predict_direct`` and ``generate``
(through the job's own door), and the advisor sessions a process-placed
train worker uses (``advisor/remote.py``), and the live fleet: scaling a
running job, and rollouts (``update_inference_job``, ``get_rollout``,
``abort_rollout``, ``ack_rollout``, ``wait_until_rollout_done``) and
the drift loop (``get_drift_status``, ``ack_drift``). It
speaks HTTP with the standard library's ``urllib.request``, and
``http.client`` for the chunked streams; a non-200 answer raises
:class:`RafikiError` with the status (409 as
:class:`RolloutInFlightError`, a recovering admin's 503 as
:class:`AdminRecoveringError`), and an admin that cannot be reached
raises :class:`AdminUnavailableError`.

Control-plane HA: a client given several addresses (``admin_addrs``, or
``RAFIKI_ADMIN_ADDRS`` for a client built without a host and port) walks
them on a refused connection and on a standby's 503, whose leader hint
it tries first, and (with several addresses) on a promoted leader's
recovering 503: in each case the request provably did not run. With
several addresses it also walks past one that gives no answer within
``timeout_s`` (a hung leader): that request may have run there. It logs
each call that an address other than the last one answered. It
raises :class:`AdminUnavailableError` once no address answered within
``RAFIKI_ADMIN_FAILOVER_TIMEOUT_S``. :meth:`Client.wait_until_admin_ready`
polls the public root, without credentials, until no recovery runs.
"""

from __future__ import annotations

import base64
import http.client
import io
import json
import logging
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

from rafiki_tpu_torch import config
from rafiki_tpu_torch.cache import wire
from rafiki_tpu_torch.sdk.model import load_model_class
from rafiki_tpu_torch.sdk.params import load_params

logger = logging.getLogger(__name__)

class RafikiError(Exception):
    """An admin API error; ``status`` is the HTTP status when the admin
    answered (None for transport or parse failures)."""

    def __init__(self, message: str, status: Optional[int] = None):
        super().__init__(message)
        self.status = status


class AdminRecoveringError(RafikiError):
    """The admin answered 503 because its boot reconciliation (crash
    recovery) is still running: retry, or wait with
    :meth:`Client.wait_until_admin_ready`."""


class AdminUnavailableError(RafikiError):
    """No admin address answered: each refused the connection (or was
    reset) or shed as a standby, within the failover window."""


class GenerationStreamError(RafikiError):
    """A generation stream ended with a typed terminal error delta (a
    worker's fault mid-stream, a decode stalled past the door's timeout).
    The tokens yielded before it stand: the stream failed, not the
    transport."""


class RolloutInFlightError(RafikiError):
    """The admin answered 409: a rollout of this inference job is already
    live. Wait it out (:meth:`Client.wait_until_rollout_done`) or abort it
    (:meth:`Client.abort_rollout`), then retry."""


class RolloutRolledBackError(RafikiError):
    """The rollout ended short of DONE: ``phase`` is ``ROLLED_BACK`` (the
    judge fired, or the canary's deploy failed: ``reason`` says which) or
    ``ABORTED``. The job serves the incumbent version."""

    def __init__(self, message: str, phase: str, reason: Optional[str]):
        super().__init__(message)
        self.phase = phase
        self.reason = reason


class Client:
    def __init__(self, admin_host: str = "127.0.0.1", admin_port: int = 3000,
                 timeout_s: Optional[float] = None,
                 admin_addrs: Optional[List[str]] = None):
        """``timeout_s`` bounds each call's socket waits (None: no bound;
        deploying an inference job waits for its workers' warm-up).
        ``admin_addrs`` (``host:port`` each), or ``RAFIKI_ADMIN_ADDRS`` when
        neither host nor port is given, are the admins a call walks."""
        explicit = (admin_host != "127.0.0.1" or admin_port != 3000)
        if admin_addrs:
            addrs = list(admin_addrs)
        elif not explicit and config.ADMIN_ADDRS:
            addrs = [a.strip() for a in config.ADMIN_ADDRS.split(",")
                     if a.strip()]
        else:
            addrs = []
        self._addrs: List[str] = addrs or [f"{admin_host}:{admin_port}"]
        self._active = 0  # the address that answered last
        self._base = f"http://{self._addrs[0]}"
        self._timeout_s = timeout_s
        self._token: Optional[str] = None
        self.user: Optional[Dict[str, Any]] = None
        # (app, version) -> (host, port, expiry) of the job's own door
        self._predictor_ports: Dict[Any, Any] = {}

    # -- plumbing ----------------------------------------------------------

    def _call(self, method: str, path: str,
              body: Optional[Dict[str, Any]] = None,
              params: Optional[Dict[str, Any]] = None) -> Any:
        """One call, walking the admin addresses: the last one that
        answered first, then the rest in order; a standby's leader hint
        jumps the queue."""
        suffix = path + ("?" + urllib.parse.urlencode(params)
                         if params else "")
        headers = {"Content-Type": "application/json"}
        if self._token:
            headers["Authorization"] = f"Bearer {self._token}"
        data = json.dumps(body).encode() if body is not None else None
        multi = len(self._addrs) > 1
        deadline = time.monotonic() + float(config.ADMIN_FAILOVER_TIMEOUT_S)
        last_refusal: Optional[str] = None
        first = self._addrs[self._active]
        while True:
            order = [self._addrs[(self._active + i) % len(self._addrs)]
                     for i in range(len(self._addrs))]
            for addr in order:
                req = urllib.request.Request(
                    f"http://{addr}{suffix}", data=data, method=method,
                    headers=headers)
                try:
                    with urllib.request.urlopen(
                            req, timeout=self._timeout_s) as resp:
                        status, raw = resp.status, resp.read()
                except urllib.error.HTTPError as e:
                    status, raw = e.code, e.read()
                except (urllib.error.URLError, ConnectionError) as e:
                    # refused or reset before an answer: walk on
                    last_refusal = f"{addr}: {e}"
                    continue
                except TimeoutError as e:
                    if not multi:
                        raise
                    # no answer in timeout_s: a hung admin is walked past
                    last_refusal = f"{addr}: {e!r}"
                    continue
                try:
                    payload = json.loads(raw)
                except ValueError:
                    raise RafikiError(
                        f"Bad response ({status}): {raw[:200]!r}",
                        status=status)
                if (status == 503 and isinstance(payload, dict)
                        and payload.get("standby")):
                    # a standby, or a fenced ex-leader, shed the call
                    # before running it: its hint goes first
                    last_refusal = f"{addr}: {payload.get('error')}"
                    hint = payload.get("leader")
                    if hint:
                        if hint not in self._addrs:
                            self._addrs.append(hint)
                        self._active = self._addrs.index(hint)
                    continue
                if (multi and status == 503 and isinstance(payload, dict)
                        and "recovery" in payload):
                    # a promoted leader still reconciling shed the call
                    # before running it (one address: the typed error)
                    last_refusal = f"{addr}: {payload.get('error')}"
                    continue
                if addr != first:
                    logger.info("admin call %s %s answered by %s, walked on "
                                "from %s", method, path, addr, first)
                self._active = self._addrs.index(addr)
                self._base = f"http://{addr}"
                return self._finish_call(status, payload)
            if not multi and len(self._addrs) == 1:
                raise AdminUnavailableError(
                    f"admin unreachable: {last_refusal}")
            if time.monotonic() >= deadline:
                raise AdminUnavailableError(
                    "no admin address answered within "
                    f"{float(config.ADMIN_FAILOVER_TIMEOUT_S):.0f} s (last: "
                    f"{last_refusal}); tried {self._addrs}")
            time.sleep(0.1)

    @staticmethod
    def _finish_call(status: int, payload: Any) -> Any:
        if (status == 503 and isinstance(payload, dict)
                and "recovery" in payload):
            raise AdminRecoveringError(
                payload.get("error", "admin is recovering"))
        if status == 409:
            raise RolloutInFlightError(
                payload.get("error", "rollout already in flight"),
                status=409)
        if status != 200:
            raise RafikiError(payload.get("error", f"HTTP {status}"),
                              status=status)
        return payload.get("data")

    # -- auth --------------------------------------------------------------

    def login(self, email: str, password: str) -> Dict[str, Any]:
        data = self._call("POST", "/tokens",
                          {"email": email, "password": password})
        self._token = data["token"]
        self.user = {"user_id": data["user_id"],
                     "user_type": data["user_type"]}
        return self.user

    def logout(self) -> None:
        self._token = None
        self.user = None

    # -- users -------------------------------------------------------------

    def create_user(self, email: str, password: str, user_type: str) -> Dict:
        return self._call("POST", "/users", {
            "email": email, "password": password, "user_type": user_type})

    def get_users(self) -> List[Dict]:
        return self._call("GET", "/users")

    def ban_user(self, email: str) -> Dict:
        return self._call("DELETE", "/users", {"email": email})

    # -- models ------------------------------------------------------------

    @staticmethod
    def _template_b64(model_file: Union[str, bytes]) -> str:
        """A template given as a file path or as its bytes, base64."""
        if isinstance(model_file, bytes):
            data = model_file
        else:
            with open(model_file, "rb") as f:
                data = f.read()
        return base64.b64encode(data).decode()

    def create_model(self, name: str, task: str,
                     model_file_path: Union[str, bytes], model_class: str,
                     dependencies: Optional[Dict[str, Optional[str]]] = None,
                     access_right: str = "PRIVATE") -> Dict:
        return self._call("POST", "/models", {
            "name": name, "task": task,
            "model_file_base64": self._template_b64(model_file_path),
            "model_class": model_class, "dependencies": dependencies,
            "access_right": access_right})

    def verify_model(self, model_file_path: Union[str, bytes],
                     model_class: str,
                     dependencies: Optional[Dict[str, Optional[str]]] = None
                     ) -> Dict:
        """The admin's verifier report for a template; no model is made."""
        return self._call("POST", "/models/verify", {
            "model_file_base64": self._template_b64(model_file_path),
            "model_class": model_class, "dependencies": dependencies})

    def get_models(self, task: Optional[str] = None) -> List[Dict]:
        return self._call("GET", "/models",
                          params={"task": task} if task else None)

    def get_model(self, name: str) -> Dict:
        return self._call("GET", f"/models/{name}")

    def download_model_file(self, name: str) -> bytes:
        data = self._call("GET", f"/models/{name}/file")
        return base64.b64decode(data["model_file_base64"])

    def delete_model(self, name: str) -> None:
        self._call("DELETE", f"/models/{name}")

    # -- train jobs ----------------------------------------------------------

    def create_train_job(self, app: str, task: str, train_dataset_uri: str,
                         test_dataset_uri: str,
                         budget: Optional[Dict[str, Any]] = None,
                         models: Optional[List[str]] = None) -> Dict:
        return self._call("POST", "/train_jobs", {
            "app": app, "task": task, "train_dataset_uri": train_dataset_uri,
            "test_dataset_uri": test_dataset_uri, "budget": budget,
            "models": models})

    def get_train_jobs(self) -> List[Dict]:
        """This user's train jobs, newest first."""
        return self._call("GET", "/train_jobs")

    def get_train_jobs_of_app(self, app: str) -> List[Dict]:
        return self._call("GET", f"/train_jobs/{app}")

    def get_train_job(self, app: str, app_version: int = -1) -> Dict:
        return self._call("GET", f"/train_jobs/{app}/{app_version}")

    def stop_train_job(self, app: str, app_version: int = -1) -> Dict:
        return self._call("POST", f"/train_jobs/{app}/{app_version}/stop")

    def wait_until_train_job_stopped(self, app: str, app_version: int = -1,
                                     timeout_s: float = 600.0,
                                     poll_s: float = 0.1) -> Dict:
        """Poll until the job is STOPPED or ERRORED; TimeoutError after
        ``timeout_s``."""
        deadline = time.monotonic() + timeout_s
        while True:
            job = self.get_train_job(app, app_version)
            if job["status"] in ("STOPPED", "ERRORED"):
                return job
            if time.monotonic() > deadline:
                raise TimeoutError(f"train job {app} still {job['status']} "
                                   f"after {timeout_s:g} s")
            time.sleep(poll_s)

    def get_trials_of_train_job(self, app: str,
                                app_version: int = -1) -> List[Dict]:
        return self._call("GET", f"/train_jobs/{app}/{app_version}/trials")

    def get_best_trials_of_train_job(self, app: str, app_version: int = -1,
                                     max_count: int = 2) -> List[Dict]:
        return self._call("GET", f"/train_jobs/{app}/{app_version}/"
                          "best_trials", params={"max_count": max_count})

    # -- trials ----------------------------------------------------------------

    def get_trial(self, trial_id: str) -> Dict:
        return self._call("GET", f"/trials/{trial_id}")

    def get_trial_logs(self, trial_id: str) -> Dict:
        return self._call("GET", f"/trials/{trial_id}/logs")

    def get_trial_trace(self, trial_id: str) -> List[Dict]:
        """The trial's spans (``propose``, ``train``, ``evaluate``,
        ``persist_params``: wall-clock start, end and duration)."""
        return self._call("GET", f"/trials/{trial_id}/trace")

    def download_trial_params(self, trial_id: str) -> bytes:
        data = self._call("GET", f"/trials/{trial_id}/parameters")
        return base64.b64decode(data["params_base64"])

    def load_trial_model(self, trial_id: str, model_name: str):
        """A trained model, rebuilt here: the template, the trial's knobs
        and its params."""
        trial = self.get_trial(trial_id)
        clazz = load_model_class(self.download_model_file(model_name),
                                 self.get_model(model_name)["model_class"])
        model = clazz(**trial["knobs"])
        model.load_parameters(load_params(self.download_trial_params(
            trial_id)))
        return model

    # -- inference jobs ----------------------------------------------------------

    def create_inference_job(self, app: str, app_version: int = -1,
                             budget: Optional[Dict] = None) -> Dict:
        body: Dict[str, Any] = {"app": app, "app_version": app_version}
        if budget is not None:
            body["budget"] = budget
        return self._call("POST", "/inference_jobs", body)

    def get_inference_job(self, app: str, app_version: int = -1) -> Dict:
        return self._call("GET", f"/inference_jobs/{app}/{app_version}")

    def get_inference_job_stats(self, app: str, app_version: int = -1) -> Dict:
        """Per-worker batches and queries, and the batch occupancy."""
        return self._call("GET", f"/inference_jobs/{app}/{app_version}/stats")

    def scale_inference_job(self, app: str, delta: int,
                            app_version: int = -1) -> Dict:
        """Add (``delta`` > 0) or drain (``delta`` < 0) replicas of the
        app's running inference job, without a redeploy. The answer: the
        replicas added and removed, those promoted from the warm pool, the
        cards borrowed and returned, and the live replica count."""
        return self._call(
            "POST", f"/inference_jobs/{app}/{app_version}/scale",
            {"delta": int(delta)})

    def update_inference_job(self, app: str, trial_id: str,
                             app_version: int = -1,
                             canary_fraction: Optional[float] = None,
                             batch: Optional[int] = None) -> Dict:
        """Move the app's running inference job to ``trial_id`` under
        traffic: a canary takes ``canary_fraction`` of it while the judge
        compares, then a rolling replace in ``batch``-sized steps, or a
        rollback. Returns the rollout row (phase ``CANARY``) at once;
        raises :class:`RolloutInFlightError` while another is live."""
        body: Dict[str, Any] = {"trial_id": trial_id}
        if canary_fraction is not None:
            body["canary_fraction"] = float(canary_fraction)
        if batch is not None:
            body["batch"] = int(batch)
        return self._call(
            "POST", f"/inference_jobs/{app}/{app_version}/update", body)

    def get_rollout(self, app: str, app_version: int = -1) -> Dict:
        """The app's newest rollout (a live one carries the judge's
        signals)."""
        return self._call(
            "GET", f"/inference_jobs/{app}/{app_version}/rollout")

    def abort_rollout(self, app: str, app_version: int = -1) -> Dict:
        """Abort the live rollout: the new version drained, the incumbents
        restored (``ROLLED_BACK``, "operator abort")."""
        return self._call(
            "POST", f"/inference_jobs/{app}/{app_version}/rollout/abort")

    def ack_rollout(self, app: str, app_version: int = -1) -> Dict:
        """Acknowledge the newest rolled-back rollout."""
        return self._call(
            "POST", f"/inference_jobs/{app}/{app_version}/rollout/ack")

    def get_drift_status(self, app: str, app_version: int = -1) -> Dict:
        """The app's drift loop: phase, baseline, live signals, events."""
        return self._call(
            "GET", f"/inference_jobs/{app}/{app_version}/drift")

    def ack_drift(self, app: str, app_version: int = -1) -> Dict:
        """Re-arm a ``PARKED`` drift loop or clear its rollback streak."""
        return self._call(
            "POST", f"/inference_jobs/{app}/{app_version}/drift/ack")

    def wait_until_rollout_done(self, app: str, app_version: int = -1,
                                timeout_s: float = 300.0) -> Dict:
        """Poll until the rollout ends: its row on ``DONE``;
        :class:`RolloutRolledBackError` (with the reason) on
        ``ROLLED_BACK`` or ``ABORTED``; ``TimeoutError`` past
        ``timeout_s``."""
        deadline = time.monotonic() + timeout_s
        while True:
            rollout = self.get_rollout(app, app_version)
            phase = rollout.get("phase")
            if phase == "DONE":
                return rollout
            if phase in ("ROLLED_BACK", "ABORTED"):
                raise RolloutRolledBackError(
                    f"rollout {rollout.get('id', '?')[:8]} ended "
                    f"{phase}: {rollout.get('reason')}",
                    phase=phase, reason=rollout.get("reason"))
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"rollout still {phase} after {timeout_s:.0f}s")
            time.sleep(0.1)

    def stop_inference_job(self, app: str, app_version: int = -1) -> Dict:
        return self._call("POST",
                          f"/inference_jobs/{app}/{app_version}/stop")

    def predict(self, app: str, queries: List[Any],
                app_version: int = -1) -> List[Any]:
        data = self._call("POST", f"/predict/{app}",
                          {"queries": queries, "app_version": app_version})
        return data["predictions"]

    def _dedicated_door(self, app: str, app_version: int):
        """``(host, port, expiry)`` of the app's own door, cached for
        ``PREDICT_ROUTE_TTL_S``; a failed request drops the entry."""
        key = (app, app_version)
        cached = self._predictor_ports.get(key)
        now = time.monotonic()
        if cached is None or cached[2] < now:
            inf = self.get_inference_job(app, app_version)
            host, port = inf.get("predictor_host"), inf.get("predictor_port")
            if not host or not port:
                raise RafikiError(
                    f"inference job for {app} has no dedicated predictor "
                    "port (deployment runs without RAFIKI_PREDICTOR_PORTS)")
            cached = (host, port, now + config.PREDICT_ROUTE_TTL_S)
            self._predictor_ports[key] = cached
        return cached

    def predict_direct(self, app: str, queries: Any,
                       app_version: int = -1) -> List[Any]:
        """Predict through the job's own door (``RAFIKI_PREDICTOR_PORTS=1``),
        past the admin. ``queries`` is a JSON list, or a numpy array (a
        leading batch axis), which goes as one ``.npy`` body and asks for
        the answer the same way (``Accept``; the door answers JSON for
        ragged predictions, and the reply's type decides). The door's
        address is cached as :meth:`generate` caches it and dropped on
        any failure, so a redeploy re-resolves."""
        key = (app, app_version)
        host, port, _ = self._dedicated_door(app, app_version)
        headers = {}
        if self._token:
            headers["Authorization"] = f"Bearer {self._token}"
        if isinstance(queries, np.ndarray):
            buf = io.BytesIO()
            try:
                np.save(buf, queries, allow_pickle=False)
            except ValueError as e:  # the caller's array, not the route
                raise RafikiError(f"queries array not npy-encodable: {e}")
            headers["Content-Type"] = "application/x-npy"
            headers["Accept"] = "application/x-npy, application/json"
            body = buf.getvalue()
        else:
            headers["Content-Type"] = "application/json"
            body = json.dumps({"queries": queries}).encode()
        conn = http.client.HTTPConnection(host, port, timeout=self._timeout_s)
        try:
            conn.request("POST", "/predict", body=body, headers=headers)
            resp = conn.getresponse()
            raw = resp.read()
            rtype = (resp.getheader("Content-Type") or "").split(";")[0]
            if resp.status == 200 and rtype == "application/x-npy":
                return list(np.load(io.BytesIO(raw), allow_pickle=False))
            payload = json.loads(raw)
        except (OSError, http.client.HTTPException, ValueError) as e:
            # unreachable, or not the door (the port reclaimed)
            self._predictor_ports.pop(key, None)
            raise RafikiError(f"dedicated predictor unreachable: {e}")
        finally:
            conn.close()
        if resp.status != 200:
            self._predictor_ports.pop(key, None)
            raise RafikiError(payload.get("error", f"HTTP {resp.status}"),
                              status=resp.status)
        return payload["data"]["predictions"]

    def generate(self, app: str, prompt_ids: List[int],
                 max_tokens: Optional[int] = None, app_version: int = -1,
                 timeout_s: Optional[float] = None, binary: bool = False,
                 temperature: Optional[float] = None,
                 top_k: Optional[int] = None, top_p: Optional[float] = None,
                 seed: Optional[int] = None):
        """Stream a ``TEXT_GENERATION`` completion through the app's own
        door (``POST /generate``): a generator of one delta dict an
        increment, ``{"tokens": [...], "finished": bool, "reason": ...}``,
        each as it arrives. ``binary`` asks for version-3 wire frames
        instead of JSON lines. A typed terminal error delta raises
        :class:`GenerationStreamError` after the tokens before it were
        yielded. ``temperature``/``top_k``/``top_p`` sample (unset or 0:
        greedy); a fixed ``seed`` makes a sampled stream reproducible,
        through preemption too."""
        key = (app, app_version)
        host, port, _ = self._dedicated_door(app, app_version)
        headers = {"Content-Type": "application/json"}
        if self._token:
            headers["Authorization"] = f"Bearer {self._token}"
        if binary:
            headers["Accept"] = wire.CONTENT_TYPE
        body: Dict[str, Any] = {"prompt_ids": list(prompt_ids)}
        for name, value, cast in (
                ("max_tokens", max_tokens, int),
                ("timeout_s", timeout_s, float),
                ("temperature", temperature, float), ("top_k", top_k, int),
                ("top_p", top_p, float), ("seed", seed, int)):
            if value is not None:
                body[name] = cast(value)
        conn = http.client.HTTPConnection(host, port, timeout=self._timeout_s)
        try:
            try:
                conn.request("POST", "/generate",
                             body=json.dumps(body).encode(), headers=headers)
                resp = conn.getresponse()
            except (OSError, http.client.HTTPException) as e:
                self._predictor_ports.pop(key, None)
                raise RafikiError(f"dedicated predictor unreachable: {e}")
            if resp.status != 200:
                self._predictor_ports.pop(key, None)
                raw = resp.read()
                try:
                    error = json.loads(raw).get("error")
                except (ValueError, AttributeError):
                    error = None
                raise RafikiError(error or f"HTTP {resp.status}",
                                  status=resp.status)
            ctype = (resp.getheader("Content-Type") or "").split(";")[0]
            deltas = (self._iter_wire_deltas(resp)
                      if ctype == wire.CONTENT_TYPE
                      else self._iter_json_deltas(resp))
            try:
                yield from deltas
            except (OSError, http.client.HTTPException) as e:
                # the transport cut the stream before a terminal delta
                self._predictor_ports.pop(key, None)
                raise RafikiError(f"generation stream cut mid-transfer: {e}")
        finally:
            conn.close()

    @staticmethod
    def _chunks(resp):
        """The decoded body as it arrives (``http.client`` undoes the
        chunked transfer coding)."""
        while True:
            data = resp.read1(65536)
            if not data:
                return
            yield data

    @classmethod
    def _iter_json_deltas(cls, resp):
        buf = b""
        for data in cls._chunks(resp):
            buf += data
            while b"\n" in buf:
                line, buf = buf.split(b"\n", 1)
                if not line.strip():
                    continue
                try:
                    delta = json.loads(line)
                except ValueError as e:
                    raise RafikiError(f"garbled stream delta: {e}")
                if delta.get("error"):
                    raise GenerationStreamError(delta["error"])
                yield delta
                if delta.get("finished"):
                    return

    @classmethod
    def _iter_wire_deltas(cls, resp):
        """Length-prefixed (u32 little-endian) token-delta frames."""
        buf = b""
        for data in cls._chunks(resp):
            buf += data
            while len(buf) >= 4:
                n = int.from_bytes(buf[:4], "little")
                if len(buf) < 4 + n:
                    break
                frame, buf = buf[4:4 + n], buf[4 + n:]
                try:
                    _, delta = wire.decode_token_delta(frame)
                except wire.WireFormatError as e:
                    raise RafikiError(f"garbled token-delta frame: {e}")
                if delta.error is not None:
                    raise GenerationStreamError(delta.error)
                yield delta.to_json()
                if delta.finished:
                    return

    # -- advisor sessions ----------------------------------------------------

    def create_advisor(self, knob_config_json: Dict[str, Any],
                       advisor_id: Optional[str] = None) -> str:
        """A GP advisor session over a serialized knob config
        (``serialize_knob_config``); its id."""
        return self._call("POST", "/advisors", {
            "knob_config": knob_config_json,
            "advisor_id": advisor_id})["advisor_id"]

    def propose_knobs(self, advisor_id: str) -> Dict[str, Any]:
        return self._call("POST", f"/advisors/{advisor_id}/propose")["knobs"]

    def propose_knobs_batch(self, advisor_id: str,
                            k: int) -> List[Dict[str, Any]]:
        """``k`` proposals in one call, spread by the GP's pending-point
        fantasies."""
        return self._call("POST", f"/advisors/{advisor_id}/propose_batch",
                          {"k": int(k)})["knobs_list"]

    def feedback_knobs(self, advisor_id: str, knobs: Dict[str, Any],
                       score: float) -> Dict[str, Any]:
        """Record a score; returns the next proposal."""
        return self._call("POST", f"/advisors/{advisor_id}/feedback",
                          {"knobs": knobs, "score": score})["knobs"]

    def feedback_knobs_batch(self, advisor_id: str,
                             items: List[Tuple[Dict[str, Any], float]]
                             ) -> int:
        """Record (knobs, score) observations; how many were applied."""
        return int(self._call(
            "POST", f"/advisors/{advisor_id}/feedback_batch",
            {"items": [{"knobs": kn, "score": float(sc)}
                       for kn, sc in items]})["count"])

    def replay_advisor_feedback(self, advisor_id: str, items,
                                infeasible=None) -> bool:
        """Seed a fresh advisor session with already-scored (knobs, score)
        pairs and (knobs, fault kind) infeasible ones; False (a no-op)
        when the session already holds any."""
        return bool(self._call(
            "POST", f"/advisors/{advisor_id}/replay",
            {"items": [{"knobs": k, "score": s} for k, s in items],
             "infeasible": [{"knobs": k, "kind": kind}
                            for k, kind in infeasible or []]})["replayed"])

    def feedback_infeasible_knobs(self, advisor_id: str,
                                  knobs: Dict[str, Any], kind: str = "USER",
                                  trial_id: Optional[str] = None) -> int:
        """The trial at ``knobs`` failed without a usable score (fault
        kind USER, TIMEOUT, INVALID_SCORE or MEM); returns the session's
        infeasible count."""
        return int(self._call(
            "POST", f"/advisors/{advisor_id}/infeasible",
            {"knobs": knobs, "kind": kind,
             "trial_id": trial_id})["infeasible"])

    def report_rung(self, advisor_id: str, trial_id: str, resource: int,
                    value: float, min_resource: int = 1, eta: int = 3,
                    mode: str = "min") -> bool:
        """ASHA's rung report; whether the trial should continue."""
        return bool(self._call(
            "POST", f"/advisors/{advisor_id}/report_rung",
            {"trial_id": trial_id, "resource": int(resource),
             "value": float(value), "min_resource": int(min_resource),
             "eta": int(eta), "mode": mode})["keep"])

    def delete_advisor(self, advisor_id: str) -> None:
        self._call("DELETE", f"/advisors/{advisor_id}")

    # -- admin ---------------------------------------------------------------

    def wait_until_admin_ready(self, timeout_s: float = 60.0
                               ) -> Dict[str, Any]:
        """Poll the public root (no credentials) until the admin's boot
        reconciliation is over, walking the addresses, so a failover is
        waited out too; returns the public recovery state."""
        deadline = time.monotonic() + timeout_s
        while True:
            try:
                data = self._call("GET", "/")
                rec = (data or {}).get("recovery") or {"state": "ready"}
                if rec.get("state") != "recovering":
                    return rec
            except (RafikiError, OSError):
                pass  # not up yet (the socket rebinds), or transient
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"admin still recovering after {timeout_s:.0f}s")
            time.sleep(0.1)

    def send_event(self, name: str, **payload: Any) -> None:
        self._call("POST", f"/event/{name}", payload)

    def stop_all_jobs(self) -> None:
        """Stop every running train and inference job (admins only)."""
        self._call("POST", "/actions/stop_all_jobs")

    def get_fleet_health(self) -> Dict[str, Any]:
        """The fleet's health (admins only; ``GET /fleet/health``): the
        agents, recovery, HA, the fleet controllers, serving and
        training."""
        return self._call("GET", "/fleet/health")
