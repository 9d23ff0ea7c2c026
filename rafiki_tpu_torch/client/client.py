"""The Python client of the admin's REST door.

Own copy of ``rafiki_tpu/client/client.py`` for the routes this package
serves, with the same method names, arguments and return values: login,
users, models (upload from a file path or bytes, download, dry-run
verification), train jobs, trials (logs, params, ``load_trial_model``),
inference jobs and ``predict``, ``generate`` (token streaming through the
job's own door), and the advisor sessions a process-placed train worker
uses (``advisor/remote.py``). It speaks HTTP with the standard library's
``urllib.request``, and ``http.client`` for the chunked streams; a
non-200 answer raises :class:`RafikiError` with the status, and an admin
that cannot be reached raises :class:`AdminUnavailableError`.
Multi-address failover, ``predict_direct``, rollout, drift and the
advisor's infeasible, replay and rung calls are not ported (ROADMAP.md).
"""

from __future__ import annotations

import base64
import http.client
import json
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Any, Dict, List, Optional, Tuple, Union

from rafiki_tpu_torch import config
from rafiki_tpu_torch.cache import wire
from rafiki_tpu_torch.sdk.model import load_model_class
from rafiki_tpu_torch.sdk.params import load_params


class RafikiError(Exception):
    """An admin API error; ``status`` is the HTTP status when the admin
    answered (None for transport or parse failures)."""

    def __init__(self, message: str, status: Optional[int] = None):
        super().__init__(message)
        self.status = status


class AdminUnavailableError(RafikiError):
    """The admin could not be reached (connection refused or reset)."""


class GenerationStreamError(RafikiError):
    """A generation stream ended with a typed terminal error delta (a
    worker's fault mid-stream, a decode stalled past the door's timeout).
    The tokens yielded before it stand: the stream failed, not the
    transport."""


class Client:
    def __init__(self, admin_host: str = "127.0.0.1", admin_port: int = 3000,
                 timeout_s: Optional[float] = None):
        """``timeout_s`` bounds each call's socket waits (None: no bound;
        deploying an inference job waits for its workers' warm-up)."""
        self._base = f"http://{admin_host}:{admin_port}"
        self._timeout_s = timeout_s
        self._token: Optional[str] = None
        self.user: Optional[Dict[str, Any]] = None
        # (app, version) -> (host, port, expiry) of the job's own door
        self._predictor_ports: Dict[Any, Any] = {}

    # -- plumbing ----------------------------------------------------------

    def _call(self, method: str, path: str,
              body: Optional[Dict[str, Any]] = None,
              params: Optional[Dict[str, Any]] = None) -> Any:
        url = self._base + path
        if params:
            url += "?" + urllib.parse.urlencode(params)
        headers = {"Content-Type": "application/json"}
        if self._token:
            headers["Authorization"] = f"Bearer {self._token}"
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(url, data=data, method=method,
                                     headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=self._timeout_s) as resp:
                status, raw = resp.status, resp.read()
        except urllib.error.HTTPError as e:
            status, raw = e.code, e.read()
        except (urllib.error.URLError, ConnectionError) as e:
            raise AdminUnavailableError(f"admin unreachable at {self._base}: "
                                        f"{e}") from e
        try:
            payload = json.loads(raw)
        except ValueError:
            raise RafikiError(f"Bad response ({status}): {raw[:200]!r}",
                              status=status)
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

    def delete_advisor(self, advisor_id: str) -> None:
        self._call("DELETE", f"/advisors/{advisor_id}")

    # -- admin ---------------------------------------------------------------

    def send_event(self, name: str, **payload: Any) -> None:
        self._call("POST", f"/event/{name}", payload)

    def stop_all_jobs(self) -> None:
        """Stop every running train and inference job (admins only)."""
        self._call("POST", "/actions/stop_all_jobs")
