"""Admin: the orchestration logic behind the REST door.

Own copy of the core of ``rafiki_tpu/admin/admin.py``: users with
per-route user types and a seeded superadmin; models (template bytes
verified statically at upload, then loaded and checked); train jobs with
app versions and budget validation; trials, their logs and params;
inference jobs (the train job must be STOPPED, one running inference job
per train job); predict, routed to the job's predictor with a short-lived
route cache; and worker events driving job status. ``AdminServer``
(``admin/http.py``) is a thin shell over this class, so library and REST
use run the same code.

The admin composes its stack: the SQLite ``Database``, an
``AdvisorStore``, and a placement with its broker, chosen as the JAX
package chooses them. By default services are threads of this process
(``LocalPlacementManager`` over the visible CUDA devices; it raises
without CUDA, and tests pass a placement over ``["cpu"]``) and the broker
is in-process, or the ``ShmBroker`` under ``RAFIKI_BROKER=shm``.
``RAFIKI_PLACEMENT=process`` makes every service a child process
(``ProcessPlacementManager``), which forces the ``ShmBroker``: the serving
children attach to its rings, and the predictor stays here. A process
placement passed in gets this store, and the shm broker when it has none.
HA leases, admission control, host placement and the fleet broker,
recovery, rollout, drift, the autoscaler and warm pool are not ported;
the settings that would turn them on raise
:class:`~rafiki_tpu_torch.config.NotPortedError`. ``TEXT_GENERATION``
takes generation-capable templates only (a ``GenerationSpec`` and the
decode methods; checked at upload and again, statically, at a train
job), and its inference job streams from the per-job door's
``/generate`` (``RAFIKI_PREDICTOR_PORTS=1``), whose host and port
``get_inference_job`` reports.
"""

from __future__ import annotations

import json
import logging
import math
import os
import threading
import time
from typing import Any, Dict, List, Optional

from rafiki_tpu_torch import analysis, config
from rafiki_tpu_torch.admin.services import ServicesManager
from rafiki_tpu_torch.advisor.advisor import AdvisorStore
from rafiki_tpu_torch.cache.queue import QueueFullError
from rafiki_tpu_torch.cache.shm_broker import ShmBroker, make_broker
from rafiki_tpu_torch.constants import (
    BudgetType,
    InferenceJobStatus,
    ModelAccessRight,
    ServiceStatus,
    TaskType,
    TrainJobStatus,
    UserType,
)
from rafiki_tpu_torch.db.database import Database
from rafiki_tpu_torch.placement.manager import (
    LocalPlacementManager,
    PlacementManager,
)
from rafiki_tpu_torch.placement.process import ProcessPlacementManager
from rafiki_tpu_torch.sdk.artifact import read_artifact
from rafiki_tpu_torch.sdk.knob import serialize_knob_config
from rafiki_tpu_torch.sdk.log import parse_logs
from rafiki_tpu_torch.sdk.model import (
    InvalidModelClassError,
    generation_capability,
    load_model_class,
    validate_model_dependencies,
)
from rafiki_tpu_torch.utils.auth import (
    UnauthorizedError,
    generate_token,
    hash_password,
    verify_password,
)
from rafiki_tpu_torch.worker.inference import (
    EVENT_INFERENCE_WORKER_STATS,
    serving_stats,
)
from rafiki_tpu_torch.worker.train import EVENT_BUDGET_REACHED

logger = logging.getLogger(__name__)


class InvalidRequestError(Exception):
    pass


class Admin:
    def __init__(self, db: Optional[Database] = None,
                 placement: Optional[PlacementManager] = None,
                 params_dir: Optional[str] = None):
        config.refuse_unported()
        self.db = db or Database()
        self.advisor_store = AdvisorStore()
        if placement is None and os.environ.get(
                "RAFIKI_PLACEMENT", "").strip() == "process":
            placement = ProcessPlacementManager()
        if isinstance(placement, ProcessPlacementManager):
            # the children open this store and attach to the shm rings
            placement.db = placement.db or self.db
            placement.broker = placement.broker or ShmBroker()
            self.broker = placement.broker
        else:
            self.broker = make_broker()
        # serving counters relayed by worker processes (the
        # inference_worker_stats event), by service id
        self._remote_stats_lock = threading.Lock()
        self._remote_serving_stats: Dict[str, Dict[str, int]] = {}
        # predict hot path: (user, app, version) -> (time, Predictor); the
        # epoch lets a stop's invalidation win over in-flight resolutions
        self._predict_route_lock = threading.Lock()
        self._predict_route_cache: Dict[Any, Any] = {}  # guarded-by: lock
        self._predict_route_epoch = 0  # guarded-by: _predict_route_lock
        self.placement = placement or LocalPlacementManager()
        if self.placement.on_status is None:
            self.placement.on_status = self._on_service_status
        self.services = ServicesManager(
            self.db, self.placement, self.advisor_store, self.broker,
            send_event=self.handle_event, params_dir=params_dir)
        self._seed_superadmin()

    # -- users ---------------------------------------------------------------

    def _seed_superadmin(self) -> None:
        if self.db.get_user_by_email(config.SUPERADMIN_EMAIL) is None:
            self.db.create_user(config.SUPERADMIN_EMAIL,
                                hash_password(config.SUPERADMIN_PASSWORD),
                                UserType.SUPERADMIN)

    def authenticate_user(self, email: str, password: str) -> Dict[str, Any]:
        user = self.db.get_user_by_email(email)
        if user is None or not verify_password(password,
                                               user["password_hash"]):
            raise UnauthorizedError("Invalid email or password")
        if user["banned"]:
            raise UnauthorizedError("User is banned")
        token = generate_token({"user_id": user["id"],
                                "user_type": user["user_type"]})
        return {"user_id": user["id"], "user_type": user["user_type"],
                "token": token}

    def create_user(self, email: str, password: str, user_type: str) -> Dict:
        if self.db.get_user_by_email(email) is not None:
            raise InvalidRequestError(f"User {email} already exists")
        user = self.db.create_user(email, hash_password(password), user_type)
        return self._user_view(user)

    def get_users(self) -> List[Dict]:
        return [self._user_view(u) for u in self.db.get_users()]

    def ban_user(self, email: str) -> Dict:
        user = self.db.get_user_by_email(email)
        if user is None:
            raise InvalidRequestError(f"No such user {email}")
        self.db.ban_user(user["id"])
        return self._user_view({**user, "banned": 1})

    @staticmethod
    def _user_view(user: Dict) -> Dict:
        return {"id": user["id"], "email": user["email"],
                "user_type": user["user_type"],
                "banned": bool(user["banned"])}

    # -- models --------------------------------------------------------------

    def create_model(self, user_id: str, name: str, task: str,
                     model_file_bytes: bytes, model_class: str,
                     dependencies: Optional[Dict[str, Optional[str]]] = None,
                     access_right: str = ModelAccessRight.PRIVATE) -> Dict:
        # static verification first: at enforce a bad or hostile template
        # is refused before load_model_class runs its module top level
        report = self._verify_template(model_file_bytes, model_class,
                                       dependencies, enforce=True)
        clazz = load_model_class(model_file_bytes, model_class)
        self._validate_task_capability(task, clazz, report)
        missing = validate_model_dependencies(clazz)
        if missing:
            raise InvalidModelClassError(
                f"Dependencies not available in this environment: {missing}")
        serialize_knob_config(clazz.get_knob_config())
        effective_deps = dependencies or dict(
            getattr(clazz, "dependencies", {}) or {})
        if self.db.get_model_by_name(user_id, name) is not None:
            raise InvalidRequestError(f"Model {name} already exists for user")
        model = self.db.create_model(
            user_id, name, task, model_file_bytes, model_class,
            effective_deps, access_right,
            verification=json.dumps(report.to_dict()) if report else None)
        return self._model_view(model)

    @staticmethod
    def _model_generation_capable(model_row: Dict) -> bool:
        """Generation capability of a stored model row: its persisted
        verification report, else a static pass over the stored bytes
        (the template never runs)."""
        verification = model_row.get("verification")
        if isinstance(verification, str):
            try:
                verification = json.loads(verification)
            except ValueError:
                verification = None
        caps = (verification or {}).get("capabilities") or {}
        if "generation" in caps:
            return bool(caps["generation"])
        report = analysis.verify_template_bytes(
            model_row["model_file_bytes"], model_row.get("model_class"))
        return bool(report.capabilities.get("generation"))

    @staticmethod
    def _validate_task_capability(task: str, clazz: type, report) -> None:
        """The template's generation capability (static when verification
        ran, else the runtime oracle) must match the task, both ways: a
        typed 400."""
        if report is not None and "generation" in report.capabilities:
            capable = bool(report.capabilities["generation"])
        else:
            capable = generation_capability(clazz) is not None
        if task == TaskType.TEXT_GENERATION and not capable:
            raise InvalidModelClassError(
                f"task {task} requires a generation-capable template: "
                "declare a GenerationSpec class attribute and override "
                "init_kv_cache, prefill and decode_step (sdk/model.py; a "
                "half-wired spec does not count, see finding GEN001)")
        if capable and task != TaskType.TEXT_GENERATION:
            raise InvalidModelClassError(
                f"template advertises a GenerationSpec but was uploaded "
                f"under task {task}: generative templates belong to task "
                f"{TaskType.TEXT_GENERATION}")

    @staticmethod
    def _verify_template(model_file_bytes: bytes, model_class: str,
                         dependencies: Optional[Dict[str, Optional[str]]],
                         enforce: bool):
        """The verifier's report under ``RAFIKI_VERIFY_TEMPLATES`` (None
        when off); at enforce, error findings raise."""
        mode = analysis.verify_mode()
        if mode == "off":
            return None
        report = analysis.verify_template_bytes(model_file_bytes,
                                                model_class, dependencies)
        if report.findings:
            logger.warning("template %s static verification: %s",
                           model_class,
                           "; ".join(str(f) for f in report.findings[:10]))
        if enforce and mode == "enforce" and not report.ok:
            raise analysis.ModelVerificationError(report)
        return report

    def verify_model(self, model_file_bytes: bytes, model_class: str,
                     dependencies: Optional[Dict[str, Optional[str]]] = None
                     ) -> Dict:
        """Dry run of the verifier (``POST /models/verify``): the report,
        no model row, nothing refused, whatever the mode."""
        report = analysis.verify_template_bytes(model_file_bytes,
                                                model_class, dependencies)
        return {"mode": analysis.verify_mode(), **report.to_dict()}

    def get_models(self, user_id: str,
                   task: Optional[str] = None) -> List[Dict]:
        """Models visible to ``user_id``: their own and PUBLIC ones."""
        return [self._model_view(m) for m in self.db.get_models(task)
                if m["user_id"] == user_id
                or m["access_right"] == ModelAccessRight.PUBLIC]

    def _resolve_model(self, user_id: str, name: str,
                       owner_id: Optional[str]) -> Dict:
        """A model by name: the given owner's, else the caller's own, else
        a PUBLIC one of that name."""
        model = self.db.get_model_by_name(owner_id or user_id, name)
        if model is None and owner_id is None:
            model = next((m for m in self.db.get_models()
                          if m["name"] == name
                          and m["access_right"] == ModelAccessRight.PUBLIC),
                         None)
        if model is None:
            raise InvalidRequestError(f"No such model {name}")
        if (model["user_id"] != user_id
                and model["access_right"] != ModelAccessRight.PUBLIC):
            raise UnauthorizedError("Model is private")
        return model

    def get_model(self, user_id: str, name: str,
                  owner_id: Optional[str] = None) -> Dict:
        return self._model_view(self._resolve_model(user_id, name, owner_id))

    def get_model_file(self, user_id: str, name: str,
                       owner_id: Optional[str] = None) -> bytes:
        return self._resolve_model(user_id, name,
                                   owner_id)["model_file_bytes"]

    def delete_model(self, user_id: str, name: str) -> None:
        model = self.db.get_model_by_name(user_id, name)
        if model is None:
            raise InvalidRequestError(f"No such model {name}")
        self.db.delete_model(model["id"])

    @staticmethod
    def _model_view(model: Dict) -> Dict:
        verification = model.get("verification")
        return {"id": model["id"], "user_id": model["user_id"],
                "name": model["name"], "task": model["task"],
                "model_class": model["model_class"],
                "dependencies": model["dependencies"],
                "access_right": model["access_right"],
                "verification": (json.loads(verification)
                                 if verification else None)}

    # -- train jobs ----------------------------------------------------------

    def create_train_job(self, user_id: str, app: str, task: str,
                         train_dataset_uri: str, test_dataset_uri: str,
                         budget: Optional[Dict[str, Any]] = None,
                         model_names: Optional[List[str]] = None) -> Dict:
        budget = {} if budget is None else budget
        self._validate_budget(budget)
        _refuse_unported_budget(budget, _UNPORTED_TRAIN_BUDGET)
        # the task's PUBLIC models of others first, then the caller's own:
        # another user's same-named public model never shadows one's own
        all_models = self.db.get_models(task)
        visible = {m["name"]: m for m in all_models
                   if m["access_right"] == ModelAccessRight.PUBLIC
                   and m["user_id"] != user_id}
        visible.update({m["name"]: m for m in all_models
                        if m["user_id"] == user_id})
        if model_names is not None:
            missing = [n for n in model_names if n not in visible]
            if missing:
                raise InvalidRequestError(
                    f"Models not found (or private): {missing}")
            models = [visible[n] for n in model_names]
        else:
            models = list(visible.values())
        if not models:
            raise InvalidRequestError(f"No usable models for task {task}")
        if task == TaskType.TEXT_GENERATION:
            # rows uploaded under verification "off" are checked here,
            # statically
            incapable = [m["name"] for m in models
                         if not self._model_generation_capable(m)]
            if incapable:
                raise InvalidRequestError(
                    f"task {task} needs generation-capable templates, but "
                    f"{incapable} advertise no fully wired GenerationSpec "
                    "(init_kv_cache, prefill, decode_step; sdk/model.py)")
        version = self.db.get_next_app_version(user_id, app)
        job = self.db.create_train_job(user_id, app, version, task,
                                       train_dataset_uri, test_dataset_uri,
                                       budget)
        for m in models:
            self.db.create_sub_train_job(job["id"], m["id"])
        self.services.create_train_services(job["id"])
        return self.get_train_job(user_id, app, version)

    @staticmethod
    def _validate_budget(budget: Dict[str, Any]) -> None:
        """Refuse a malformed budget at job creation, not later."""
        if not isinstance(budget, dict):
            raise InvalidRequestError(
                f"budget must be a JSON object, got {type(budget).__name__}")

        def as_int(key, minimum):
            raw = budget.get(key)
            if raw is None:
                return
            try:
                v = int(raw)
            except (TypeError, ValueError):
                raise InvalidRequestError(
                    f"budget {key}={raw!r} is not an integer")
            if v < minimum:
                raise InvalidRequestError(
                    f"budget {key}={v} must be >= {minimum}")

        def as_float(key, minimum, exclusive=False):
            raw = budget.get(key)
            if raw is None:
                return
            try:
                v = float(raw)
            except (TypeError, ValueError):
                raise InvalidRequestError(
                    f"budget {key}={raw!r} is not a number")
            # NaN passes every comparison and would disable the limit
            if not math.isfinite(v):
                raise InvalidRequestError(f"budget {key}={v} is not finite")
            if v < minimum or (exclusive and v == minimum):
                op = ">" if exclusive else ">="
                raise InvalidRequestError(
                    f"budget {key}={v} must be {op} {minimum}")

        as_int(BudgetType.MODEL_TRIAL_COUNT, 1)
        as_int(BudgetType.CHIP_COUNT, 0)
        as_int(BudgetType.GPU_COUNT, 0)
        as_int(BudgetType.CHIPS_PER_TRIAL, 1)
        as_int(BudgetType.ASHA_MIN_EPOCHS, 1)
        as_int(BudgetType.ASHA_ETA, 2)
        # TIME_HOURS=0 is legal: the job stops before its first trial
        as_float(BudgetType.TIME_HOURS, 0)
        as_float(BudgetType.TRIAL_TIMEOUT_S, 0, exclusive=True)
        as_int(BudgetType.CHIPS_PER_WORKER, 1)
        as_int(BudgetType.ENSEMBLE_FUSED, 0)

    def _train_job(self, user_id: str, app: str, app_version: int) -> Dict:
        job = self.db.get_train_job_by_app_version(user_id, app, app_version)
        if job is None:
            raise InvalidRequestError(
                f"No such train job {app} v{app_version}")
        return job

    def get_train_job(self, user_id: str, app: str,
                      app_version: int = -1) -> Dict:
        job = self._train_job(user_id, app, app_version)
        services = [self.db.get_service(w["service_id"])
                    for w in self.db.get_workers_of_train_job(job["id"])]
        return {
            "id": job["id"], "app": job["app"],
            "app_version": job["app_version"], "task": job["task"],
            "status": job["status"], "fault_kind": job.get("fault_kind"),
            "error_reason": job.get("error_reason"), "budget": job["budget"],
            "train_dataset_uri": job["train_dataset_uri"],
            "test_dataset_uri": job["test_dataset_uri"],
            "datetime_started": job["datetime_started"],
            "datetime_stopped": job["datetime_stopped"],
            "workers": [{"service_id": s["id"], "status": s["status"],
                         "chips": s["chips"]} for s in services if s],
        }

    def get_train_jobs_of_user(self, user_id: str) -> List[Dict]:
        """One light row per train job, newest first."""
        return [{"id": j["id"], "app": j["app"],
                 "app_version": j["app_version"], "task": j["task"],
                 "status": j["status"], "budget": j["budget"],
                 "datetime_started": j["datetime_started"],
                 "datetime_stopped": j["datetime_stopped"]}
                for j in self.db.get_train_jobs_of_user(user_id)]

    def get_train_jobs_of_app(self, user_id: str, app: str) -> List[Dict]:
        return [self.get_train_job(user_id, app, j["app_version"])
                for j in self.db.get_train_jobs_of_app(user_id, app)]

    def stop_train_job(self, user_id: str, app: str,
                       app_version: int = -1) -> Dict:
        job = self._train_job(user_id, app, app_version)
        self.services.stop_train_services(job["id"])
        self.db.mark_train_job_as_stopped(job["id"])
        return self.get_train_job(user_id, app, job["app_version"])

    def wait_until_train_job_stopped(self, user_id: str, app: str,
                                     app_version: int = -1,
                                     timeout_s: float = 600) -> Dict:
        """Poll until the job is STOPPED or ERRORED."""
        deadline = time.time() + timeout_s
        while True:
            job = self.get_train_job(user_id, app, app_version)
            if job["status"] in (TrainJobStatus.STOPPED,
                                 TrainJobStatus.ERRORED):
                return job
            if time.time() > deadline:
                raise TimeoutError(f"Train job still {job['status']}")
            time.sleep(0.1)

    # -- trials --------------------------------------------------------------

    def get_trials_of_train_job(self, user_id: str, app: str,
                                app_version: int = -1) -> List[Dict]:
        job = self._train_job(user_id, app, app_version)
        return [self._trial_view(t)
                for t in self.db.get_trials_of_train_job(job["id"])]

    def get_best_trials_of_train_job(self, user_id: str, app: str,
                                     app_version: int = -1,
                                     max_count: int = 2) -> List[Dict]:
        job = self._train_job(user_id, app, app_version)
        return [self._trial_view(t) for t in
                self.db.get_best_trials_of_train_job(job["id"], max_count)]

    def _trial(self, trial_id: str) -> Dict:
        trial = self.db.get_trial(trial_id)
        if trial is None:
            raise InvalidRequestError(f"No such trial {trial_id}")
        return trial

    def get_trial(self, trial_id: str) -> Dict:
        return self._trial_view(self._trial(trial_id))

    def get_trial_logs(self, trial_id: str) -> Dict:
        self._trial(trial_id)
        return parse_logs(self.db.get_trial_logs(trial_id))

    def get_trial_params(self, trial_id: str) -> bytes:
        """The trial's params artifact, verified (a damaged file raises
        ArtifactCorruptError)."""
        trial = self.db.get_trial(trial_id)
        if trial is None or not trial.get("params_file_path"):
            raise InvalidRequestError(f"No params for trial {trial_id}")
        return read_artifact(trial["params_file_path"])

    @staticmethod
    def _trial_view(trial: Dict) -> Dict:
        return {"id": trial["id"],
                "sub_train_job_id": trial["sub_train_job_id"],
                "model_id": trial["model_id"], "knobs": trial["knobs"],
                "score": trial["score"], "status": trial["status"],
                "attempt": trial.get("attempt", 0),
                "fault_kind": trial.get("fault_kind"),
                "fault_detail": trial.get("fault_detail"),
                "datetime_started": trial["datetime_started"],
                "datetime_stopped": trial["datetime_stopped"]}

    # -- inference jobs ------------------------------------------------------

    def create_inference_job(self, user_id: str, app: str,
                             app_version: int = -1,
                             budget: Optional[Dict[str, Any]] = None) -> Dict:
        self._validate_budget(budget or {})
        _refuse_unported_budget(budget or {}, _UNPORTED_SERVING_BUDGET)
        job = self._train_job(user_id, app, app_version)
        if job["status"] != TrainJobStatus.STOPPED:
            raise InvalidRequestError(
                f"Train job must be STOPPED, is {job['status']}")
        if self.db.get_running_inference_job_of_train_job(job["id"]):
            raise InvalidRequestError(
                "An inference job is already running for this train job")
        inf = self.db.create_inference_job(user_id, job["id"], budget=budget)
        self.services.create_inference_services(inf["id"])
        return self.get_inference_job(user_id, app, job["app_version"])

    def get_inference_job(self, user_id: str, app: str,
                          app_version: int = -1) -> Dict:
        job = self._train_job(user_id, app, app_version)
        infs = self.db.get_inference_jobs_of_train_job(job["id"])
        if not infs:
            raise InvalidRequestError("No inference job for this train job")
        inf = infs[0]

        def chips(service_id: str) -> list:
            return (self.db.get_service(service_id) or {}).get("chips") or []

        # the job's own door, when RAFIKI_PREDICTOR_PORTS bound one
        door = (self.db.get_service(inf["predictor_service_id"])
                if inf.get("predictor_service_id") else None) or {}
        return {
            "id": inf["id"], "train_job_id": job["id"], "app": app,
            "app_version": job["app_version"],
            "predictor_host": door.get("host"),
            "predictor_port": door.get("port"),
            "status": inf["status"], "budget": inf.get("budget") or {},
            "datetime_started": inf["datetime_started"],
            "datetime_stopped": inf["datetime_stopped"],
            "workers": [{"service_id": w["service_id"],
                         "trial_id": w["trial_id"],
                         "chips": chips(w["service_id"])}
                        for w in self.db.get_workers_of_inference_job(
                            inf["id"])],
        }

    def get_inference_job_stats(self, user_id: str, app: str,
                                app_version: int = -1) -> Dict:
        """Per-worker batch and query counters and the batch occupancy
        (mean queries a batch)."""
        inf = self.get_inference_job(user_id, app, app_version)
        # workers that are threads of this process count here directly;
        # worker processes relay the same counters (handle_event)
        local = serving_stats()
        with self._remote_stats_lock:
            for sid, s in self._remote_serving_stats.items():
                local.setdefault(sid, {}).update(s)
        workers = []
        total_b = total_q = 0
        for w in inf["workers"]:
            s = local.get(w["service_id"]) or {"batches": 0, "queries": 0}
            total_b += s["batches"]
            total_q += s["queries"]
            workers.append({**w, **s})
        return {"inference_job_id": inf["id"], "status": inf["status"],
                "workers": workers, "batches": total_b, "queries": total_q,
                "batch_occupancy": (round(total_q / total_b, 2)
                                    if total_b else None)}

    def stop_inference_job(self, user_id: str, app: str,
                           app_version: int = -1) -> Dict:
        job = self._train_job(user_id, app, app_version)
        inf = self.db.get_running_inference_job_of_train_job(job["id"])
        if inf is None:
            raise InvalidRequestError("No running inference job")
        self.services.stop_inference_services(inf["id"])
        self._drop_predict_routes(inf["id"])
        return self.get_inference_job(user_id, app, job["app_version"])

    def _drop_predict_routes(self, inference_job_id: str) -> None:
        """Forget cached routes to a stopped job's predictor; the epoch
        bump keeps an in-flight resolution from re-inserting one."""
        with self._predict_route_lock:
            self._predict_route_epoch += 1
            for key, (_, predictor) in list(
                    self._predict_route_cache.items()):
                if predictor._job_id == inference_job_id:
                    self._predict_route_cache.pop(key, None)

    def predict(self, user_id: str, app: str, queries: List[Any],
                app_version: int = -1) -> List[Any]:
        """Route queries to the app's running predictor. The resolution
        (control-plane reads) is cached for ``PREDICT_ROUTE_TTL_S``; a
        dead route re-resolves at once. ``QueueFullError`` (429 at the
        door) and ``TimeoutError`` (504) pass through."""
        key = (user_id, app, app_version)
        now = time.monotonic()
        with self._predict_route_lock:
            cached = self._predict_route_cache.get(key)
        if cached is not None and now - cached[0] < config.PREDICT_ROUTE_TTL_S:
            try:
                return self._predict_on(cached[1], queries)
            except QueueFullError:
                raise  # overload, not a dead route
            except TimeoutError:
                # the route may be stale, but a timeout is not retried: the
                # retry policy belongs to the client, which gets a 504
                with self._predict_route_lock:
                    self._predict_route_cache.pop(key, None)
                raise
            except RuntimeError:
                # workers gone (job stopped or replaced): re-resolve
                with self._predict_route_lock:
                    self._predict_route_cache.pop(key, None)
        with self._predict_route_lock:
            epoch = self._predict_route_epoch
        if app_version == -1:
            # the serving version: the newest one with a running job
            jobs = self.db.get_train_jobs_of_app(user_id, app)
            if not jobs:
                raise InvalidRequestError(f"No such app {app}")
            inf = next((i for i in (
                self.db.get_running_inference_job_of_train_job(j["id"])
                for j in jobs) if i is not None), None)
        else:
            job = self.db.get_train_job_by_app_version(user_id, app,
                                                       app_version)
            if job is None:
                raise InvalidRequestError(f"No such app {app}")
            inf = self.db.get_running_inference_job_of_train_job(job["id"])
        if inf is None:
            raise InvalidRequestError("No running inference job for this app")
        predictor = self.services.get_predictor(inf["id"])
        if predictor is None:
            raise InvalidRequestError("Predictor not available")
        with self._predict_route_lock:
            if self._predict_route_epoch == epoch:
                self._predict_route_cache[key] = (now, predictor)
        return self._predict_on(predictor, queries)

    @staticmethod
    def _predict_on(predictor, queries: List[Any]) -> List[Any]:
        cap = int(config.PREDICT_QUEUE_DEPTH)
        if cap > 0 and len(queries) > cap:
            # can never fit a worker queue: a client error, not a 429
            raise InvalidRequestError(
                f"request carries {len(queries)} queries but the per-worker "
                f"queue cap is {cap} (RAFIKI_PREDICT_QUEUE_DEPTH); split it")
        return predictor.predict_batch(queries)

    # -- jobs and events -----------------------------------------------------

    def stop_all_jobs(self) -> None:
        """Stop every running train and inference job, marking the job
        rows too, then any service still live."""
        for inf in self.db.get_inference_jobs_by_statuses(
                [InferenceJobStatus.STARTED, InferenceJobStatus.RUNNING]):
            self.services.stop_inference_services(inf["id"])
            self._drop_predict_routes(inf["id"])
        for job in self.db.get_train_jobs_by_statuses(
                [TrainJobStatus.STARTED, TrainJobStatus.RUNNING]):
            self.services.stop_train_services(job["id"])
            self.db.mark_train_job_as_stopped(job["id"])
        for svc in self.db.get_services(statuses=[
                ServiceStatus.STARTED, ServiceStatus.DEPLOYING,
                ServiceStatus.RUNNING]):
            self.services._destroy_service(svc["id"], wait=False)

    def handle_event(self, name: str, payload: Dict[str, Any]) -> None:
        """Worker events drive job status, and carry the serving counters
        of worker processes. (The JAX package's fail-fast and agent events
        wait for those ports.)"""
        try:
            if name == EVENT_BUDGET_REACHED:
                # the workers exit on their own once the shared budget is
                # spent: fold that into the job's status
                self.services.refresh_train_job_status(
                    payload["train_job_id"])
            elif name == EVENT_INFERENCE_WORKER_STATS:
                with self._remote_stats_lock:
                    self._remote_serving_stats[payload["service_id"]] = {
                        k: int(payload[k]) for k in _RELAYED_STATS
                        if k in payload}
        except Exception:
            logger.exception("event %s failed", name)

    def _on_service_status(self, service_id: str, status: str) -> None:
        if status == ServiceStatus.RUNNING:
            self.db.mark_service_as_running(service_id)
        elif status == ServiceStatus.STOPPED:
            self.db.mark_service_as_stopped(service_id)
        elif status == ServiceStatus.ERRORED:
            self.db.mark_service_as_errored(service_id)
        if status not in (ServiceStatus.STOPPED, ServiceStatus.ERRORED):
            return
        # a train worker ending may end its job; the last serving replica
        # ending ends its inference job
        worker = self.db.get_train_job_worker(service_id)
        if worker is not None:
            sub = self.db.get_sub_train_job(worker["sub_train_job_id"])
            if sub is not None:
                self.services.refresh_train_job_status(sub["train_job_id"])
            return
        iworker = self.db.get_inference_job_worker(service_id)
        if iworker is not None and self.services.refresh_inference_job_status(
                iworker["inference_job_id"]) is not None:
            self._drop_predict_routes(iworker["inference_job_id"])

    def shutdown(self) -> None:
        self.stop_all_jobs()
        self.placement.stop_all()
        if isinstance(self.broker, ShmBroker):
            self.broker.close()  # unlinks every ring


#: the serving counters a worker process relays
_RELAYED_STATS = ("batches", "queries", "queue_depth", "expired", "shed")

#: budget keys, and the values of them, that ask for what is not ported:
#: multi-card trials, ASHA, trial deadlines and population trials; multi-
#: card workers, fused ensembles and speculative decoding's draft trial
#: (ROADMAP.md)
_UNPORTED_TRAIN_BUDGET = {
    BudgetType.CHIPS_PER_TRIAL: lambda v: int(v) > 1,
    BudgetType.EARLY_STOP: bool,
    BudgetType.TRIAL_TIMEOUT_S: lambda v: True,
    BudgetType.TRIAL_VMAP_K: lambda v: v not in (0, 1),
}
_UNPORTED_SERVING_BUDGET = {
    BudgetType.CHIPS_PER_WORKER: lambda v: int(v) > 1,
    BudgetType.ENSEMBLE_FUSED: lambda v: int(v) != 0,
    BudgetType.GEN_DRAFT_TRIAL: bool,
}


def _refuse_unported_budget(budget: Dict[str, Any], unported) -> None:
    """A 400 naming each budget key that asks for what the port lacks: it
    is never ignored. Runs after ``_validate_budget`` has typed them."""
    asked = sorted(k for k, asks in unported.items()
                   if budget.get(k) is not None and asks(budget[k]))
    if asked:
        raise InvalidRequestError(
            f"budget {asked} asks for what rafiki_tpu_torch does not have "
            "yet (ROADMAP.md); drop it")
