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
The ``/predict/<app>`` door admits every request through one
:class:`~rafiki_tpu_torch.predictor.admission.AdmissionController` for
the whole door (503 at its in-flight cap, 429 when the estimated wait is
past ``PREDICT_TIMEOUT_S``). An inference job's budget may ask for a
fused ensemble (``ENSEMBLE_FUSED``: every best trial in each serving
worker, ``admin/services.py``), and ``RAFIKI_PREDICT_CACHE=1`` puts the
predict result cache in front of the workers.
A train job's budget may ask for vectorized population trials
(``TRIAL_VMAP_K``, proposals drained a round, over ``RAFIKI_TRIAL_VMAP_K``;
``RAFIKI_TRIAL_VMAP=0`` forces scalar trials; ``worker/train.py``), and
``RAFIKI_SERVE_INT8=1`` serves every SDK-trainer template from weight-only
int8 copies (``sdk/quant.py``).

The live fleet: the admin builds the chip arbiter
(``placement/hosts.py``), the autoscaler (its loop runs with
``RAFIKI_AUTOSCALE=1``), the warm pool (``RAFIKI_AUTOSCALE_WARM_POOL=K``)
and the rollout controller, as the JAX admin does. An operator scales a
running job (``scale_inference_job``) and moves it to another trial under
traffic (``update_inference_job``: canary, judge, rolling replace or
rollback; ``get_rollout_status``, ``abort_rollout``, ``ack_rollout``). A
job's stop aborts its rollout first; a dead routed replica is replaced
from the warm pool; shutdown stops the loops before the teardown.
``RAFIKI_AUTOSCALE_FAIR=1`` turns on weighted fair admission at the
``/predict/<app>`` door.

The drift loop (``admin/drift.py``): the admin builds its controller
after the rollout controller (its loop runs with ``RAFIKI_DRIFT=1``);
a drift retrain is a train job made with ``warm_start_from`` (its
advisors seeded with the source job's scored and infeasible trials
before its services start); ``get_drift_status`` and ``ack_drift``
read and re-arm a job's loop. Under ``RAFIKI_SANDBOX=1`` trials and
serving replicas run the template in a locked-down child
(``sdk/sandbox.py``), and a fused ensemble is refused typed.

Crash recovery and control-plane HA: an admin's boot is idempotent on an
existing store (``recover=True``, the default): the non-terminal jobs
and services a dead admin left are scanned in the constructor and
reconciled off-thread (``admin/recovery.py``: adopt, fence, reschedule,
error, sweep) behind a ``recovering → ready`` state the door gates on
(``recovery_status``, ``recovery_public``). Under ``RAFIKI_ADMIN_HA=1``
the admin takes the leadership lease before its first store write
(``admin/lease.py``; ``LeaseNotAcquiredError`` while another admin holds
a live one) and every write is fenced by its epoch; a standby
(``admin/standby.py``) builds its admin with the lease it promoted with
(``lease=``). ``ha_role``, ``leader_hint`` and ``ha_public`` are what the
door serves; ``shutdown`` releases the lease last. Under
``RAFIKI_PLACEMENT=process`` the admin's engine lets train children
outlive it (``orphan_survivable``), for the next admin to adopt by pid.

Host placement: under ``RAFIKI_PLACEMENT=hosts`` (agents in
``RAFIKI_AGENTS``, their key in ``RAFIKI_AGENT_KEY``) train and serving
executors go to the per-host agents (``placement/hosts.py``,
``placement/agent.py``); the broker is wrapped in a ``FleetBroker``
(``cache/fleet.py``) whose relay queues reach the agents' serving
workers, every agent call carries the lease's epoch, and an agent's
forwarded ``service_status`` event reaches the status callback. This
host's process engine is the serving fallback the original keeps (its
children never outlive the admin: recovery adopts through the agents),
and there is none without a CUDA device. A host placement passed in
gets the same wiring.

Observability: ``get_trial_trace`` reads back a trial's spans
(``utils/trace.py``), and ``get_fleet_health`` is the operator's view of
the whole deployment, section by section as JAX's: placement, agents,
chaos, recovery, HA, the autoscaler, warm pool, rollouts and drift loop,
serving (per job, the door's admission, per-worker counters,
generation, the prediction cache) and training. Dependency provisioning
is not ported: ``RAFIKI_INSTALL_DEPS=1`` raises
:class:`~rafiki_tpu_torch.config.NotPortedError`. No budget key is
refused: a ``TEXT_GENERATION`` job under ``CHIPS_PER_WORKER`` > 1 is
served from its grant's first card, as in the JAX package. A ``TEXT_GENERATION`` inference job's budget may
name a draft trial (``GEN_DRAFT_TRIAL``) for speculative decoding,
checked at deploy (``admin/services.py``).
``TEXT_GENERATION`` takes generation-capable templates only (a
``GenerationSpec`` and the decode methods; checked at upload and again,
statically, at a train job), and its inference job streams from the
per-job door's
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
from rafiki_tpu_torch.admin.autoscaler import Autoscaler
from rafiki_tpu_torch.admin.lease import LeaseManager, LeaseNotAcquiredError
from rafiki_tpu_torch.admin.recovery import ControlPlaneRecovery
from rafiki_tpu_torch.admin.services import (
    ServiceDeploymentError,
    ServicesManager,
)
from rafiki_tpu_torch.admin.warm_pool import WarmPool
from rafiki_tpu_torch.advisor.advisor import AdvisorStore
from rafiki_tpu_torch.cache.fleet import FleetBroker
from rafiki_tpu_torch.cache.queue import QueueFullError
from rafiki_tpu_torch.cache.shm_broker import ShmBroker, make_broker
from rafiki_tpu_torch.constants import (
    BudgetType,
    InferenceJobStatus,
    ModelAccessRight,
    ServiceStatus,
    TaskType,
    TrainJobStatus,
    TrialStatus,
    UserType,
)
from rafiki_tpu_torch.db.database import Database, StaleEpochError
from rafiki_tpu_torch.placement.hosts import (
    ChipBudgetArbiter,
    HostAgentPlacementManager,
    StaleAdminEpochError,
)
from rafiki_tpu_torch.placement.manager import (
    LocalPlacementManager,
    PlacementManager,
)
from rafiki_tpu_torch.placement.process import ProcessPlacementManager
from rafiki_tpu_torch.predictor.admission import (
    AdmissionController,
    DeadlineUnmeetableError,
    ServerOverloadedError,
)
from rafiki_tpu_torch.sdk.artifact import read_artifact
from rafiki_tpu_torch.sdk.knob import serialize_knob_config
from rafiki_tpu_torch.sdk.log import parse_logs
from rafiki_tpu_torch.sdk.model import (
    InvalidModelClassError,
    generation_capability,
    load_model_class,
    validate_model_dependencies,
)
from rafiki_tpu_torch.utils import chaos
from rafiki_tpu_torch.utils.auth import (
    UnauthorizedError,
    generate_token,
    hash_password,
    verify_password,
)
from rafiki_tpu_torch.utils.trace import load_trace
from rafiki_tpu_torch.worker import faults
from rafiki_tpu_torch.worker.faults import is_infeasible_row
from rafiki_tpu_torch.worker.inference import (
    EVENT_INFERENCE_WORKER_STATS,
    serving_stats,
)
from rafiki_tpu_torch.worker.train import (
    EVENT_BUDGET_REACHED,
    EVENT_TRIAL_FAULT_LIMIT,
)

logger = logging.getLogger(__name__)


class InvalidRequestError(Exception):
    pass


class Admin:
    def __init__(self, db: Optional[Database] = None,
                 placement: Optional[PlacementManager] = None,
                 params_dir: Optional[str] = None,
                 recover: bool = True, lease=None,
                 advertise_addr: Optional[str] = None):
        """``recover``: reconcile what a dead admin left in the store
        (the scan here, the reconcile off-thread). ``lease``: a
        ``LeaseManager`` that already holds the leadership (a standby's
        promotion); without one, ``RAFIKI_ADMIN_HA=1`` takes the lease
        here, waiting up to ``RAFIKI_ADMIN_LEASE_ACQUIRE_TIMEOUT_S``.
        ``advertise_addr`` (``host:port``) rides the lease row as the
        leader hint."""
        config.refuse_unported()
        self.db = db or Database()
        # the lease before the first store write: a leader's writes carry
        # its epoch from the first one on
        self._lease: Optional[LeaseManager] = lease
        if self._lease is None and config.ADMIN_HA:
            self._lease = LeaseManager(self.db, addr=advertise_addr)
            if not self._lease.acquire(
                    block=True,
                    timeout_s=config.ADMIN_LEASE_ACQUIRE_TIMEOUT_S):
                raise LeaseNotAcquiredError(
                    "another admin holds a live leadership lease (row: "
                    f"{self._lease.leader_row()}); boot this one as a "
                    "standby (admin/standby.py) instead")
        if self._lease is not None:
            # a promoted standby's lease is bound to its watcher's handle:
            # arm this admin's too (the renewal thread starts at the end
            # of the constructor; the take armed a whole TTL)
            self._lease.bind(self.db)
        self.advisor_store = AdvisorStore()
        mode = os.environ.get("RAFIKI_PLACEMENT", "").strip()
        if placement is None and mode == "process":
            # train children outlive this admin, to be adopted by pid
            placement = ProcessPlacementManager(orphan_survivable=True)
        elif placement is None and mode == "hosts":
            placement = self._host_placement()
        engine = (placement.local
                  if isinstance(placement, HostAgentPlacementManager)
                  else placement)
        if isinstance(engine, ProcessPlacementManager):
            # the children open this store and attach to the shm rings
            engine.db = engine.db or self.db
            engine.broker = engine.broker or ShmBroker()
            self.broker = engine.broker
        else:
            self.broker = make_broker()
        if isinstance(placement, HostAgentPlacementManager):
            # agent-placed serving workers are reached through relay
            # queues merged over the local data plane
            self.broker = FleetBroker(self.broker)
            placement.set_broker(self.broker)
            placement.db = placement.db or self.db
            if engine is not None and engine.on_status is None:
                engine.on_status = self._on_service_status
        # serving counters relayed by worker processes (the
        # inference_worker_stats event), by service id
        self._remote_stats_lock = threading.Lock()
        self._remote_serving_stats: Dict[str, Dict[str, int]] = {}
        # predict hot path: (user, app, version) -> (time, Predictor); the
        # epoch lets a stop's invalidation win over in-flight resolutions
        self._predict_route_lock = threading.Lock()
        self._predict_route_cache: Dict[Any, Any] = {}  # guarded-by: lock
        self._predict_route_epoch = 0  # guarded-by: _predict_route_lock
        # one gate for the whole /predict/<app> door: it protects this
        # process, whatever job a request is for
        self._predict_admission = AdmissionController(
            door="admin", shared_tenants=True)
        self.placement = placement or LocalPlacementManager()
        if self.placement.on_status is None:
            self.placement.on_status = self._on_service_status
        if self._lease is not None and hasattr(self.placement,
                                               "set_epoch_provider"):
            # agent calls carry the epoch; last_epoch, so a fenced
            # ex-leader still gets the agents' typed 412
            self.placement.set_epoch_provider(self._lease.last_epoch)
        # serving may borrow idle cards above RAFIKI_AUTOSCALE_TRAIN_FLOOR;
        # a train executor that cannot allocate reclaims them
        self.chip_arbiter = ChipBudgetArbiter(self.placement.allocator)
        self.services = ServicesManager(
            self.db, self.placement, self.advisor_store, self.broker,
            send_event=self.handle_event, params_dir=params_dir,
            arbiter=self.chip_arbiter)
        # the fleet's controllers always exist (the scale API and their
        # reports go through them); their loops run when switched on
        from rafiki_tpu_torch.admin.rollout import RolloutController

        self.autoscaler = Autoscaler(self)
        if config.AUTOSCALE:
            self.autoscaler.start()
        self.warm_pool = WarmPool(self)
        if int(config.AUTOSCALE_WARM_POOL) > 0:
            self.warm_pool.start()
        self.rollouts = RolloutController(self)
        # the drift loop drives rollouts, so it is built after them
        from rafiki_tpu_torch.admin.drift import DriftController

        self.drift = DriftController(self)
        if config.DRIFT:
            self.drift.start()
        self._seed_superadmin()
        # -- crash recovery: the scan here, so nothing made after this
        # constructor is reconciled; the reconcile off-thread
        self._recovery: Dict[str, Any] = {"state": "ready"}
        self._recovery_thread: Optional[threading.Thread] = None
        self._recovery_runner = None
        if recover:
            rec = ControlPlaneRecovery(self)
            snapshot = rec.snapshot()
            if rec.needed(snapshot):
                self._recovery = {"state": "recovering",
                                  "started_at": time.time()}
                self._recovery_runner = rec
                self._recovery_thread = threading.Thread(
                    target=self._run_recovery, args=(rec, snapshot),
                    name="admin-recovery", daemon=True)
                self._recovery_thread.start()
            else:
                self._recovery = rec.empty_report()
        if self._lease is not None:
            self._lease.start()  # a no-op for a promoted standby's

    def _host_placement(self) -> HostAgentPlacementManager:
        """``RAFIKI_PLACEMENT=hosts``: train and serving executors go to
        the agents of ``RAFIKI_AGENTS`` (``host:port,...``). This host's
        own process engine is the serving fallback the original keeps; its
        children never outlive the admin (recovery adopts through the
        agents, never by a local pid), and an admin without a CUDA device
        has none."""
        agents = [a.strip() for a in
                  os.environ.get("RAFIKI_AGENTS", "").split(",") if a.strip()]
        try:
            local: Optional[ProcessPlacementManager] = \
                ProcessPlacementManager(orphan_survivable=False)
        except RuntimeError as e:
            logger.info("hosts mode with no local engine: %s", e)
            local = None
        return HostAgentPlacementManager(
            agents, local=local, key=os.environ.get("RAFIKI_AGENT_KEY"),
            on_status=self._on_service_status, db=self.db)

    def _run_recovery(self, rec, snapshot) -> None:
        try:
            # run() folds a failed reconcile into its report: the doors
            # open either way
            self._recovery = rec.run(snapshot)
        except Exception:
            logger.exception("control-plane recovery failed")
            self._recovery = {**rec.report, "state": "ready",
                              "failed": True}

    def recovery_status(self) -> Dict[str, Any]:
        """The boot reconciliation's state and report (``recovering``
        while it runs; the door answers 503 until ``ready``)."""
        return dict(self._recovery)

    def recovery_public(self) -> Dict[str, Any]:
        """The state alone, for callers without credentials (the report
        carries ids and reasons)."""
        return {"state": self._recovery.get("state", "ready")}

    # -- control-plane HA (admin/lease.py, admin/standby.py) ---------------

    @property
    def lease(self):
        """This admin's ``LeaseManager`` (None with HA off)."""
        return self._lease

    def ha_role(self) -> str:
        """``leader`` (with HA off there is no one else), or ``fenced``
        once the lease lapsed or was taken over."""
        return "leader" if self._lease is None else self._lease.role()

    def ha_epoch(self) -> Optional[int]:
        return self._lease.last_epoch() if self._lease is not None else None

    def leader_hint(self) -> Optional[str]:
        """The lease holder's advertised address."""
        if self._lease is None:
            return None
        row = self._lease.leader_row()
        return row.get("addr") if row else None

    def ha_public(self) -> Dict[str, Any]:
        """The role and the leader hint, for the public root."""
        if self._lease is None:
            return {"role": "leader"}
        return {"role": self._lease.role(), "leader": self.leader_hint()}

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
                         model_names: Optional[List[str]] = None,
                         warm_start_from: Optional[str] = None) -> Dict:
        """``warm_start_from``, a prior train job's id, seeds each new
        sub-job's advisor with that job's scored and infeasible trials of
        the same model before the services start (the drift loop's
        retrain); the train worker's own replay then finds the session
        fed and does nothing."""
        budget = {} if budget is None else budget
        self._validate_budget(budget)
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
        if warm_start_from:
            self._seed_advisors_from(job["id"], warm_start_from)
        self.services.create_train_services(job["id"])
        return self.get_train_job(user_id, app, version)

    def _seed_advisors_from(self, train_job_id: str,
                            source_job_id: str) -> None:
        """Replay a prior job's scored and infeasible trials into the new
        job's advisors, matched by model. Best effort: a failed seed
        leaves a cold search, never a failed job creation."""
        source_subs = {
            s["model_id"]: s
            for s in self.db.get_sub_train_jobs_of_train_job(source_job_id)}
        for sub in self.db.get_sub_train_jobs_of_train_job(train_job_id):
            src = source_subs.get(sub["model_id"])
            if src is None:
                continue
            try:
                trials = self.db.get_trials_of_sub_train_job(src["id"])
                scored = [(t["knobs"], t["score"]) for t in trials
                          if t["status"] == TrialStatus.COMPLETED
                          and t["score"] is not None]
                infeasible = [(t["knobs"], t["fault_kind"]) for t in trials
                              if is_infeasible_row(t)]
                if not (scored or infeasible):
                    continue
                model = self.db.get_model(sub["model_id"])
                clazz = load_model_class(model["model_file_bytes"],
                                         model["model_class"])
                self.advisor_store.create_advisor(
                    clazz.get_knob_config(), advisor_id=sub["id"])
                if self.advisor_store.replay_feedback(
                        sub["id"], scored, infeasible=infeasible):
                    logger.info(
                        "advisor %s warm-started with %d scored + %d "
                        "infeasible trials from job %s", sub["id"][:8],
                        len(scored), len(infeasible), source_job_id[:8])
            except Exception:
                logger.exception("advisor warm start failed for sub %s",
                                 sub["id"][:8])

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

    def get_trial_trace(self, trial_id: str) -> List[Dict]:
        """The trial's spans as its worker saved them (``propose``,
        ``train``, ``evaluate``, ``persist_params``), [] before any."""
        self._trial(trial_id)
        return load_trace(trial_id)

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
        # a rollout in flight ends first (ABORTED, no rollback pass), so
        # its thread never races the teardown placing replicas
        self.rollouts.abort_for_job(inf["id"], "inference job stopped")
        self.services.stop_inference_services(inf["id"])
        self._drop_predict_routes(inf["id"])
        return self.get_inference_job(user_id, app, job["app_version"])

    # -- the live fleet ------------------------------------------------------

    def scale_inference_job(self, user_id: str, app: str,
                            app_version: int = -1, delta: int = 1) -> Dict:
        """Add (``delta`` > 0) or drain (``delta`` < 0) replicas of the
        app's RUNNING inference job without a redeploy: the primitive the
        autoscaler drives (``admin/services.py``)."""
        if not delta:
            raise InvalidRequestError("delta must be a non-zero integer")
        # each added replica is a placement and a deploy wait on this
        # request's thread
        limit = max(int(config.AUTOSCALE_MAX_REPLICAS), 8)
        if abs(int(delta)) > limit:
            raise InvalidRequestError(
                f"delta {delta} out of range (|delta| <= {limit}; raise "
                "RAFIKI_AUTOSCALE_MAX_REPLICAS to scale further)")
        job = self._train_job(user_id, app, app_version)
        inf = self.db.get_running_inference_job_of_train_job(job["id"])
        if inf is None:
            raise InvalidRequestError("No running inference job")
        try:
            report = self.services.scale_inference_job(inf["id"], int(delta))
        except ServiceDeploymentError as e:
            raise InvalidRequestError(str(e))
        return {"inference_job_id": inf["id"], **report,
                "replicas": len(self.services.live_inference_workers(
                    inf["id"]))}

    def _running_inference_job(self, user_id: str, app: str,
                               app_version: int) -> Dict:
        """The app's serving job; version -1 is the newest version that
        serves."""
        if app_version == -1:
            for job in self.db.get_train_jobs_of_app(user_id, app):
                inf = self.db.get_running_inference_job_of_train_job(
                    job["id"])
                if inf is not None:
                    return inf
            raise InvalidRequestError("No running inference job")
        job = self._train_job(user_id, app, app_version)
        inf = self.db.get_running_inference_job_of_train_job(job["id"])
        if inf is None:
            raise InvalidRequestError("No running inference job")
        return inf

    def update_inference_job(self, user_id: str, app: str,
                             app_version: int = -1,
                             trial_id: Optional[str] = None,
                             canary_fraction: Optional[float] = None,
                             batch: Optional[int] = None) -> Dict:
        """Move the app's RUNNING inference job to ``trial_id`` in place
        (``admin/rollout.py``). Answers at once with the rollout row (phase
        CANARY); a second update while one is live raises
        :class:`~rafiki_tpu_torch.admin.rollout.RolloutInFlightError`
        (409)."""
        if not trial_id:
            raise InvalidRequestError("missing rollout target trial_id")
        inf = self._running_inference_job(user_id, app, app_version)
        return self.rollouts.start(inf["id"], trial_id,
                                   canary_fraction=canary_fraction,
                                   batch=batch)

    def get_rollout_status(self, user_id: str, app: str,
                           app_version: int = -1) -> Dict:
        """The newest rollout of the app version's inference jobs (a live
        one carries the judge's signals)."""
        job = self._train_job(user_id, app, app_version)
        for inf in self.db.get_inference_jobs_of_train_job(job["id"]):
            status = self.rollouts.status(inf["id"])
            if status is not None:
                return status
        raise InvalidRequestError(
            f"no rollout recorded for {app} v{job['app_version']}")

    def abort_rollout(self, user_id: str, app: str,
                      app_version: int = -1) -> Dict:
        inf = self._running_inference_job(user_id, app, app_version)
        return self.rollouts.abort(inf["id"])

    def ack_rollout(self, user_id: str, app: str,
                    app_version: int = -1) -> Dict:
        """Acknowledge the newest rolled-back rollout."""
        job = self._train_job(user_id, app, app_version)
        for inf in self.db.get_inference_jobs_of_train_job(job["id"]):
            try:
                return self.rollouts.ack(inf["id"])
            except InvalidRequestError:
                continue
        raise InvalidRequestError(f"no unacknowledged rollback for {app}")

    # -- the drift loop -----------------------------------------------------

    def get_drift_status(self, user_id: str, app: str,
                         app_version: int = -1) -> Dict:
        """The drift loop's row for the app's serving inference job: its
        phase, baseline, live signals and events. With ``app_version``
        -1 every version is searched, newest first (a drift retrain's own
        train job has no row)."""
        if app_version == -1:
            jobs = self.db.get_train_jobs_of_app(user_id, app)
            if not jobs:
                raise InvalidRequestError(f"No such app {app}")
        else:
            job = self.db.get_train_job_by_app_version(user_id, app,
                                                       app_version)
            if job is None:
                raise InvalidRequestError(
                    f"No such train job {app} v{app_version}")
            jobs = [job]
        for job in jobs:
            for inf in self.db.get_inference_jobs_of_train_job(job["id"]):
                status = self.drift.status(inf["id"])
                if status is not None:
                    return status
        raise InvalidRequestError(
            f"no drift state recorded for {app}"
            + (f" v{app_version}" if app_version != -1 else ""))

    def ack_drift(self, user_id: str, app: str,
                  app_version: int = -1) -> Dict:
        """An operator's ack: re-arms a PARKED loop or clears a rollback
        streak."""
        inf = self._running_inference_job(user_id, app, app_version)
        return self.drift.ack(inf["id"])

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
        dead route re-resolves at once. The door's admission sheds first
        (``ServerOverloadedError``, 503; ``DeadlineUnmeetableError``,
        429); ``QueueFullError`` (429) and ``TimeoutError`` (504) pass
        through."""
        key = (user_id, app, app_version)
        now = time.monotonic()
        with self._predict_route_lock:
            cached = self._predict_route_cache.get(key)
        if cached is not None and now - cached[0] < config.PREDICT_ROUTE_TTL_S:
            try:
                return self._predict_on(cached[1], queries, app)
            except (QueueFullError, ServerOverloadedError,
                    DeadlineUnmeetableError):
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
        return self._predict_on(predictor, queries, app)

    def _predict_on(self, predictor, queries: List[Any],
                    tenant: str) -> List[Any]:
        """Admit, predict, release, and feed the latency back."""
        cap = int(config.PREDICT_QUEUE_DEPTH)
        if cap > 0 and len(queries) > cap:
            # can never fit a worker queue: a client error, not a 429
            raise InvalidRequestError(
                f"request carries {len(queries)} queries but the per-worker "
                f"queue cap is {cap} (RAFIKI_PREDICT_QUEUE_DEPTH); split it")
        self._predict_admission.admit(
            config.PREDICT_TIMEOUT_S, backlog_depth=predictor.backlog_depth(),
            tenant=tenant, cost=predictor.admission_cost(queries))
        t0 = time.monotonic()
        try:
            preds = predictor.predict_batch(queries)
        finally:
            self._predict_admission.release(tenant=tenant)
        self._predict_admission.observe(time.monotonic() - t0, len(queries))
        return preds

    # -- fleet health --------------------------------------------------------

    def get_fleet_health(self) -> Dict[str, Any]:
        """The operator's view, JAX's sections: the agents' heartbeats and
        breakers (empty for a single-host placement), chaos, recovery, HA,
        the fleet controllers' reports, serving (each job's queues and
        overload counters, a job with no worker queue ``degraded``; the
        door's admission and fair shares; every worker's counters, local
        and relayed; generation per job; the prediction cache) and
        training (fault counts of the live jobs from the store, and this
        process's worker counters)."""
        agents: Dict[str, Any] = {}
        if hasattr(self.placement, "agent_health"):
            agents = self.placement.agent_health()
        jobs: Dict[str, Any] = {}
        predictors = self.services.predictors()
        for job_id, predictor in predictors.items():
            try:
                depths = predictor.queue_depths()
                jobs[job_id] = {"status": "ok" if depths else "degraded",
                                "workers": len(depths),
                                "queue_depths": depths,
                                "overload": predictor.overload_stats()}
            except Exception:
                logger.exception("fleet-health probe of job %s failed",
                                 job_id)
        workers = serving_stats()
        with self._predict_route_lock:
            for sid, st in self._remote_serving_stats.items():
                workers.setdefault(sid, {}).update(st)
        train_jobs: Dict[str, Any] = {}
        try:
            summary = self.db.get_trial_fault_summary_of_live_jobs()
            for j in self.db.get_train_jobs_by_statuses(
                    [TrainJobStatus.STARTED, TrainJobStatus.RUNNING]):
                entry = summary.get(j["id"], {"faults": {}, "retries": 0})
                train_jobs[j["id"]] = {"status": j["status"], **entry}
        except Exception:
            logger.exception("fleet-health training scan failed")
        return {
            "placement": type(self.placement).__name__,
            "agents": agents,
            "agents_down": [a for a, h in agents.items()
                            if h["state"] == "DOWN"],
            "chaos_active": chaos.enabled(),
            "recovery": self.recovery_status(),
            "ha": ({"enabled": True, **self._lease.status()}
                   if self._lease is not None else {"enabled": False}),
            "autoscaler": self.autoscaler.report(),
            "warm_pool": self.warm_pool.report(),
            "rollouts": self.rollouts.report(),
            "drift": self.drift.report(),
            "serving": {
                "jobs": jobs,
                "admission": self._predict_admission.stats(),
                "fair_shares": self._predict_admission.fair_shares(),
                "workers": workers,
                "generation": _generation_health(workers, predictors),
                "prediction_cache": _prediction_cache_stats(),
            },
            "training": {"jobs": train_jobs,
                         "workers": faults.training_stats()},
        }

    # -- jobs and events -----------------------------------------------------

    def stop_all_jobs(self) -> None:
        """Stop every running train and inference job, marking the job
        rows too, then any service still live."""
        for inf in self.db.get_inference_jobs_by_statuses(
                [InferenceJobStatus.STARTED, InferenceJobStatus.RUNNING]):
            self.rollouts.abort_for_job(inf["id"], "stop_all_jobs")
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
        """Worker events drive job status and carry the serving counters
        of worker processes; a host agent forwards its children's
        statuses (``service_status``)."""
        try:
            if name == EVENT_BUDGET_REACHED:
                # the workers exit on their own once the shared budget is
                # spent: fold that into the job's status
                self.services.refresh_train_job_status(
                    payload["train_job_id"])
            elif name == EVENT_TRIAL_FAULT_LIMIT:
                # job fail-fast: a worker hit RAFIKI_TRIAL_FAULT_LIMIT
                # consecutive user-class faults, so the template is broken.
                # The worker marked the row already (the guarded transition
                # makes this a no-op then); its siblings fail the same way
                self.db.mark_train_job_as_errored(
                    payload["train_job_id"], payload.get("fault_kind"),
                    payload.get("reason"))
                self.services.stop_train_services(payload["train_job_id"])
            elif name == "service_status":
                # forwarded by the host agents, so the job's refresh runs
                # for a remotely placed worker too
                self._on_service_status(payload["service_id"],
                                        payload["status"])
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
        # a dead replica's loan comes home however it died (getattr: a
        # status may come before the arbiter is built)
        arbiter = getattr(self, "chip_arbiter", None)
        if arbiter is not None:
            arbiter.note_return(service_id)
        # a train worker ending may end its job; the last serving replica
        # ending ends its inference job
        worker = self.db.get_train_job_worker(service_id)
        if worker is not None:
            sub = self.db.get_sub_train_job(worker["sub_train_job_id"])
            if sub is not None:
                self.services.refresh_train_job_status(sub["train_job_id"])
            return
        iworker = self.db.get_inference_job_worker(service_id)
        if iworker is None:
            return
        pool = getattr(self, "warm_pool", None)
        if status == ServiceStatus.ERRORED and pool is not None:
            # a dead routed replica is replaced by a standby at once
            try:
                pool.on_replica_errored(service_id,
                                        iworker["inference_job_id"])
            except Exception:
                logger.exception("warm-pool replacement for %s failed",
                                 service_id[:8])
        if self.services.refresh_inference_job_status(
                iworker["inference_job_id"]) is not None:
            self._drop_predict_routes(iworker["inference_job_id"])

    def shutdown(self) -> None:
        # the loops stop deciding first: a tick or a rollout racing the
        # teardown would place replicas nothing stops
        self.autoscaler.stop()
        self.warm_pool.stop()
        # the drift loop before the rollouts it starts
        self.drift.stop()
        self.rollouts.stop()
        # a reconcile racing the teardown would place services again: it
        # aborts at its next check, and is waited out
        if self._recovery_runner is not None:
            self._recovery_runner.abort()
        if self._recovery_thread is not None:
            self._recovery_thread.join(timeout=30)
        # a fenced ex-leader has nothing to tear down: the new leader owns
        # the fleet
        fenced = self.ha_role() == "fenced"
        if not fenced:
            try:
                self.stop_all_jobs()
            except (StaleEpochError, StaleAdminEpochError) as e:
                fenced = True
                logger.warning("shutdown teardown cut short (fenced): %s", e)
        if fenced and hasattr(self.placement, "detach_all"):
            # a fenced ex-leader's children are the new leader's (a train
            # child is adopted by pid): let go of them unsignalled. JAX
            # stops them here (ROADMAP.md, C)
            self.placement.detach_all()
        else:
            self.placement.stop_all()
        if isinstance(self.broker, (ShmBroker, FleetBroker)):
            self.broker.close()  # unlinks every ring
        # last: the release clears the fences, so every write above ran
        # under the epoch
        if self._lease is not None:
            self._lease.stop(release=True)


#: the serving counters a worker process relays
_RELAYED_STATS = ("batches", "queries", "queue_depth", "expired", "shed",
                  "fused_dispatch")


def _generation_health(workers: Dict[str, Dict[str, Any]],
                       predictors: Dict[str, Any]) -> Dict[str, Any]:
    """``/fleet/health``'s generation section: the generation workers'
    rows summed per job (the paged pool, prefix-cache and speculation
    counters, their rates), and each job's stream-continuity counters
    from its predictor."""
    generation: Dict[str, Any] = {}
    summed = ("slots_busy", "resident_streams", "tokens", "kv_blocks_used",
              "kv_pool_blocks", "prefix_hits", "prefix_misses",
              "prefix_hit_tokens", "spec_proposed", "spec_accepted",
              "spec_rounds")
    for row in workers.values():
        job = row.get("gen_job")
        if not job:
            continue
        g = generation.setdefault(job, {
            "workers": 0, **{k: 0 for k in summed}, "spec_workers": 0,
            "spec_degraded": []})
        g["workers"] += 1
        for k in summed:
            g[k] += int(row.get(f"gen_{k}", 0))
        g["spec_workers"] += 1 if row.get("gen_spec_on") else 0
        if row.get("gen_spec_degraded"):
            g["spec_degraded"].append(str(row["gen_spec_degraded"]))
    for job_id, g in generation.items():
        admitted = g["prefix_hits"] + g["prefix_misses"]
        g["prefix_hit_rate"] = (round(g["prefix_hits"] / admitted, 3)
                                if admitted else None)
        g["spec_acceptance_rate"] = (
            round(g["spec_accepted"] / g["spec_proposed"], 3)
            if g["spec_proposed"] else None)
        cont = getattr(predictors.get(job_id), "gen_continuity_stats", None)
        if callable(cont):
            try:
                g["continuity"] = cont()
            except Exception:
                logger.exception("continuity probe of job %s failed",
                                 job_id)
    return generation


def _prediction_cache_stats() -> Dict[str, Any]:
    """The prediction cache's section; {} when its probe faults (fleet
    health answers either way)."""
    from rafiki_tpu_torch.predictor.result_cache import get_cache

    try:
        return get_cache().stats()
    except Exception:
        logger.exception("prediction-cache stats probe failed")
        return {}
