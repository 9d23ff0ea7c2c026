"""Deployment engine: turns job rows into running services.

Own copy of the core of ``rafiki_tpu/admin/services.py``:

- train jobs: the chip budget (``CHIP_COUNT``, clamped to the host's
  inventory) is split evenly across sub-train-jobs, one executor for
  every ``CHIPS_PER_TRIAL`` cards (clamped to the largest host; a share
  smaller than that is one smaller executor, and leftover cards are
  logged as idle), or one executor sharing a device when the budget is
  0; an executor granted several cards trains each trial over all of
  them (``parallel/ranks.py``);
- inference jobs: for each of the best ``INFERENCE_MAX_BEST_TRIALS``
  trials, ``INFERENCE_WORKER_REPLICAS_PER_TRIAL`` serving executors of
  ``CHIPS_PER_WORKER`` cards each (clamped to the largest host, and the
  replicas clamped so each gets cards of its own) and one predictor. A
  worker whose exclusive device is taken shares one (placement/manager.py),
  so on a one-card host both best trials are served on ``cuda:0``. A
  ``TEXT_GENERATION`` job serves its one best trial with
  ``GenerationWorker`` s (a token stream answers from one model);
- a fused ensemble (budget ``ENSEMBLE_FUSED``): ``n_replicas`` serving
  executors, each holding every best trial (its row names the group's top
  trial and carries ``trial_ids``) and answering with the final
  ensemble, one vmapped forward when the template's ``ensemble_stack``
  fuses them (``worker/inference.py``); a ``TEXT_GENERATION`` job cannot
  fuse, nor can any job under ``RAFIKI_SANDBOX=1`` (each a typed
  ``ServiceDeploymentError``);
- speculative decoding (budget ``GEN_DRAFT_TRIAL``): the draft trial is
  checked at deploy (a generative job, a known trial, COMPLETED, a
  generation-capable template; each a typed ``ServiceDeploymentError``)
  and every ``GenerationWorker`` of the job loads it;
- a serving teardown and a deploy flush the job's predict result cache
  (``predictor/result_cache.py``), so a redeploy never answers from the
  old fleet's entries;
- with ``RAFIKI_PREDICTOR_PORTS=1`` each inference job gets its own door
  (``PredictorServer``: ``/predict``, ``/generate``) on
  ``RAFIKI_PREDICTOR_HOST``, its host and port on the predictor's service
  row;
- a deploy waits until its services report RUNNING and rolls back on
  failure; a train job's status is derived from its workers' services;
- the live fleet (``admin/autoscaler.py``, ``warm_pool.py``,
  ``rollout.py`` and the operator's scale API drive it): a replica added
  to a RUNNING job (``scale_inference_job``; an exclusive grant only when
  the chip arbiter lends a card above the training floor, else a shared
  device; a warm standby promoted first when the pool holds one);
  graceful drains (``drain_replicas``: retired from the fan-out, its queue
  and, for generation, its resident streams waited out within
  ``RAFIKI_AUTOSCALE_DRAIN_S``, then destroyed); scale-down victims
  (borrowed first, never a trial's last replica while siblings keep
  several, never below the floor); standbys (placed and warmed like a
  replica, never routed until promoted); a replica of a given trial and
  rollout version (``deploy_version_replica``); and training's reclaim of
  borrowed cards (standbys first), called when a train executor cannot
  allocate;
- every placement of a serving replica asks the ``deploy`` chaos site
  (``utils/chaos.py``), whose ``error`` is a typed deploy failure.

A ``TEXT_GENERATION`` job under ``CHIPS_PER_WORKER`` > 1 takes the same
sizing as a classification job (the clamp to the largest host, and
``min(replicas, cards // (trials x cards a worker))`` replicas); its
worker serves from the grant's first card, as the JAX worker does.
Generation in worker processes is refused, typed (ROADMAP.md).

Crash recovery (``admin/recovery.py``) calls two methods here:
``adopt_inference_job`` rebuilds the serving head (a ``Predictor`` over
the adopted replicas, warm standbys left out of the fan-out; the job's
door again under ``RAFIKI_PREDICTOR_PORTS=1``) of a job whose replicas
survived the admin, and ``restart_train_worker`` places a lost train
executor again under its own service id (the stale-trial resume
continues its work; a grant of several cards starts its followers again,
``parallel/ranks.py``).
"""

from __future__ import annotations

import functools
import logging
import threading
import time
from typing import Any, Dict, List, Optional

from rafiki_tpu_torch import config
from rafiki_tpu_torch.advisor.advisor import AdvisorStore
from rafiki_tpu_torch.cache.queue import Broker
from rafiki_tpu_torch.constants import (
    BudgetType,
    InferenceJobStatus,
    ServiceStatus,
    ServiceType,
    TaskType,
    TrainJobStatus,
    TrialStatus,
)
from rafiki_tpu_torch.db.database import Database
from rafiki_tpu_torch.placement.manager import (
    InsufficientChipsError,
    PlacementManager,
)
from rafiki_tpu_torch.placement.hosts import HostAgentPlacementManager
from rafiki_tpu_torch.placement.process import ProcessPlacementManager
from rafiki_tpu_torch.predictor.predictor import Predictor
from rafiki_tpu_torch.predictor.result_cache import get_cache
from rafiki_tpu_torch.predictor.server import PredictorServer
from rafiki_tpu_torch.utils import chaos
from rafiki_tpu_torch.utils.metrics import REGISTRY
from rafiki_tpu_torch.worker.generation import GenerationWorker
from rafiki_tpu_torch.worker.inference import (
    SERVING_STATS,
    InferenceWorker,
    _stats_lock,
)
from rafiki_tpu_torch.worker.train import EventFn, TrainWorker

logger = logging.getLogger(__name__)


class ServiceDeploymentError(Exception):
    pass


def _chaos_deploy(inference_job_id: str, trial_id: str) -> None:
    """The ``deploy`` chaos site, asked wherever a serving replica is
    placed: ``delay`` is a slow deploy, ``error`` and ``drop`` a typed
    deploy failure (the canary rollback drill)."""
    rule = chaos.hit(chaos.SITE_DEPLOY, f"{inference_job_id}/{trial_id}")
    if rule is None:
        return
    if rule.action == chaos.ACTION_DELAY:
        chaos.sleep_for(rule)
        return
    raise ServiceDeploymentError(
        f"chaos-injected deploy failure placing a replica of trial "
        f"{trial_id} for job {inference_job_id}")


class ServicesManager:
    def __init__(self, db: Database, placement: PlacementManager,
                 advisor_store: AdvisorStore, broker: Broker,
                 send_event: EventFn, params_dir: Optional[str] = None,
                 arbiter=None):
        """``arbiter`` (``placement/hosts.py``) lends idle cards to
        scale-ups and takes them back for training: its reclaim callback
        is installed here, so a train executor that cannot allocate
        reclaims whether or not the autoscaler runs."""
        self._db = db
        self._placement = placement
        self._advisors = advisor_store
        self._broker = broker
        self._send_event = send_event
        self._params_dir = params_dir or config.PARAMS_DIR
        self._lock = threading.Lock()
        self._predictors: Dict[str, Predictor] = {}  # guarded-by: _lock
        # the per-job doors (RAFIKI_PREDICTOR_PORTS=1)
        self._servers: Dict[str, PredictorServer] = {}  # guarded-by: _lock
        self._arbiter = arbiter
        if arbiter is not None:
            arbiter.set_reclaim_callback(self.reclaim_borrowed)
        # replicas mid-drain: a second scale-down picks others, never
        # drains one twice
        self._scale_lock = threading.Lock()
        self._scale_draining: set = set()  # guarded-by: _scale_lock

    # -- train -------------------------------------------------------------

    def create_train_services(self, train_job_id: str) -> None:
        job = self._db.get_train_job(train_job_id)
        sub_jobs = self._db.get_sub_train_jobs_of_train_job(train_job_id)
        budget = job["budget"]
        total_chips = int(budget.get(BudgetType.CHIP_COUNT,
                                     budget.get(BudgetType.GPU_COUNT, 0)))
        alloc = self._placement.allocator
        # asking for more chips than the host has downsizes the job; chips
        # merely busy are not clamped away: allocating them raises and the
        # deploy rolls back, never silently sharing with a running job
        total_chips = min(total_chips, alloc.total_chips)
        chips_per_sub = total_chips // len(sub_jobs) if sub_jobs else 0
        chips_per_trial = max(
            int(budget.get(BudgetType.CHIPS_PER_TRIAL, 1)), 1)
        # one executor's grant never spans hosts: downsize, don't fail
        if chips_per_trial > alloc.max_chips_per_service > 0:
            logger.info("CHIPS_PER_TRIAL=%d exceeds the largest host (%d "
                        "chips); downsizing the per-trial mesh",
                        chips_per_trial, alloc.max_chips_per_service)
            chips_per_trial = alloc.max_chips_per_service
        created: List[str] = []
        try:
            for sub in sub_jobs:
                if chips_per_sub == 0:
                    workers = [0]  # one executor on a shared device
                elif chips_per_sub < chips_per_trial:
                    # a downsized grant: still one several-card executor
                    workers = [chips_per_sub]
                else:
                    workers = [chips_per_trial] * (
                        chips_per_sub // chips_per_trial)
                    stranded = chips_per_sub % chips_per_trial
                    if stranded:
                        # uniform grants on purpose, but say so
                        logger.info(
                            "sub_train_job %s: %d of %d chips idle "
                            "(CHIPS_PER_TRIAL=%d does not divide the "
                            "per-model share)", sub["id"], stranded,
                            chips_per_sub, chips_per_trial)
                for n_chips in workers:
                    created.append(self._create_train_worker(sub["id"],
                                                             n_chips))
            self._wait_until_services_running(created)
            self._db.mark_train_job_as_running(train_job_id)
        except Exception:
            for sid in created:
                self._destroy_service(sid, wait=False)
            self._db.mark_train_job_as_errored(train_job_id)
            raise

    def _create_train_worker(self, sub_train_job_id: str,
                             n_chips: int) -> str:
        service = self._db.create_service(ServiceType.TRAIN, replicas=1)
        self._db.create_train_job_worker(service["id"], sub_train_job_id)
        worker = TrainWorker(sub_train_job_id, self._db, self._advisors,
                             send_event=self._send_event,
                             params_dir=self._params_dir)

        def place():
            return self._placement.create_service(
                service["id"], ServiceType.TRAIN, worker.start,
                n_chips=n_chips,
                extra={"sub_train_job_id": sub_train_job_id})

        try:
            try:
                ctx = place()
            except InsufficientChipsError:
                # the cards may be on loan to serving: training outranks
                # borrowed capacity, so reclaim and try once more
                if (self._arbiter is None
                        or self._arbiter.reclaim_for_training(n_chips) <= 0):
                    raise
                logger.info("retrying train worker %s after reclaiming "
                            "borrowed serving chips", service["id"][:8])
                ctx = place()
        except Exception:
            # the rows exist but nothing runs: close the service row
            self._db.mark_service_as_stopped(service["id"])
            raise
        try:
            self._db.update_service_chips(service["id"], ctx.chips)
        except Exception:
            self._destroy_service(service["id"], wait=False)
            raise
        return service["id"]

    def stop_train_services(self, train_job_id: str) -> None:
        for w in self._db.get_workers_of_train_job(train_job_id):
            self._destroy_service(w["service_id"], wait=False)
        for sub in self._db.get_sub_train_jobs_of_train_job(train_job_id):
            self._advisors.delete_advisor(sub["id"])
        self.refresh_train_job_status(train_job_id)

    def refresh_train_job_status(self, train_job_id: str) -> None:
        """A train job stops (or errors) once all its workers have."""
        job = self._db.get_train_job(train_job_id)
        if job is None or job["status"] in (TrainJobStatus.STOPPED,
                                            TrainJobStatus.ERRORED):
            return
        statuses = [s["status"] for s in (
            self._db.get_service(w["service_id"])
            for w in self._db.get_workers_of_train_job(train_job_id)) if s]
        terminal = (ServiceStatus.STOPPED, ServiceStatus.ERRORED)
        if not statuses or not all(s in terminal for s in statuses):
            return
        if ServiceStatus.ERRORED in statuses:
            self._db.mark_train_job_as_errored(train_job_id)
        else:
            self._db.mark_train_job_as_stopped(train_job_id)

    def refresh_inference_job_status(
            self, inference_job_id: str) -> Optional[str]:
        """When every serving replica of an inference job is terminal, the
        job is too. Returns the new status when it changed, else None."""
        inf = self._db.get_inference_job(inference_job_id)
        if inf is None or inf["status"] in (InferenceJobStatus.STOPPED,
                                            InferenceJobStatus.ERRORED):
            return None
        statuses = [s["status"] for s in (
            self._db.get_service(w["service_id"])
            for w in self._db.get_workers_of_inference_job(inference_job_id))
            if s]
        terminal = (ServiceStatus.STOPPED, ServiceStatus.ERRORED)
        if not statuses or not all(s in terminal for s in statuses):
            return None
        return self._teardown_serving(
            inference_job_id, errored=ServiceStatus.ERRORED in statuses)

    def _teardown_serving(self, inference_job_id: str, errored: bool) -> str:
        """Drop the predictor, close its service row and end the job."""
        inf = self._db.get_inference_job(inference_job_id)
        with self._lock:
            self._predictors.pop(inference_job_id, None)
            server = self._servers.pop(inference_job_id, None)
        if server is not None:
            server.stop()
        # the job's cached answers go with its fleet (the epoch bump also
        # drops fills racing this teardown)
        get_cache().flush_job(inference_job_id, reason="teardown")
        if inf and inf.get("predictor_service_id"):
            self._db.mark_service_as_stopped(inf["predictor_service_id"])
        if errored:
            self._db.mark_inference_job_as_errored(inference_job_id)
            return InferenceJobStatus.ERRORED
        self._db.mark_inference_job_as_stopped(inference_job_id)
        return InferenceJobStatus.STOPPED

    # -- inference -----------------------------------------------------------

    def create_inference_services(self, inference_job_id: str) -> Predictor:
        inf_job = self._db.get_inference_job(inference_job_id)
        train_job = self._db.get_train_job(inf_job["train_job_id"])
        best_trials = self._db.get_best_trials_of_train_job(
            train_job["id"], max_count=config.INFERENCE_MAX_BEST_TRIALS)
        if not best_trials:
            self._db.mark_inference_job_as_errored(inference_job_id)
            raise ServiceDeploymentError(
                f"Train job {train_job['id']} has no completed trials")
        generative = train_job["task"] == TaskType.TEXT_GENERATION
        if generative:
            if isinstance(self._placement, (ProcessPlacementManager,
                                            HostAgentPlacementManager)):
                # an agent's relay carries no token stream either
                self._db.mark_inference_job_as_errored(inference_job_id)
                raise ServiceDeploymentError(
                    "TEXT_GENERATION serving in worker processes is not "
                    "ported to rafiki_tpu_torch (ROADMAP.md): token streams "
                    "do not cross the shm rings; deploy under thread "
                    "placement")
            # a token stream answers from one model: one best trial
            best_trials = best_trials[:1]
        alloc = self._placement.allocator
        chips_per_worker = self._chips_per_worker(inf_job)
        # replicas buy capacity only on devices of their own: same-device
        # replicas in one process just split batches
        n_replicas = max(1, min(
            config.INFERENCE_WORKER_REPLICAS_PER_TRIAL,
            alloc.total_chips // max(len(best_trials) * chips_per_worker,
                                     1)))
        fused = bool((inf_job.get("budget") or {}).get(
            BudgetType.ENSEMBLE_FUSED, 0))
        if fused and generative:
            # a token stream answers from one model, not a fused ensemble
            self._db.mark_inference_job_as_errored(inference_job_id)
            raise ServiceDeploymentError(
                "budget ENSEMBLE_FUSED is unsupported for TEXT_GENERATION "
                "jobs: a token stream answers from one model, not a fused "
                "cross-trial ensemble; drop ENSEMBLE_FUSED")
        self._check_draft(inference_job_id, inf_job, generative)
        if fused:
            from rafiki_tpu_torch.sdk.sandbox import sandbox_enabled

            if sandbox_enabled():
                # a fused worker holds every best trial in one process; a
                # sandboxed model is a child process of its own, so N
                # children would contend for one worker's grant
                self._db.mark_inference_job_as_errored(inference_job_id)
                raise ServiceDeploymentError(
                    "budget ENSEMBLE_FUSED is unsupported with "
                    "RAFIKI_SANDBOX=1: fused serving co-locates every "
                    "best trial in one worker process, but sandboxed "
                    "models run as separate child processes that would "
                    "contend for the worker's chip grant — drop "
                    "ENSEMBLE_FUSED (per-trial fleet) or disable the "
                    "sandbox for this deployment")
            # a unit serves the whole group: replicas of the unit alone
            n_replicas = max(1, min(
                config.INFERENCE_WORKER_REPLICAS_PER_TRIAL,
                alloc.total_chips // chips_per_worker))
            units = [(best_trials[0]["id"], f"fused:{inference_job_id}",
                      [t["id"] for t in best_trials])] * n_replicas
        else:
            units = [(t["id"], t["id"], None) for t in best_trials
                     for _ in range(n_replicas)]
        # a redeploy never answers from an earlier fleet's cache entries
        get_cache().flush_job(inference_job_id, reason="deploy")
        created: List[str] = []
        worker_trials: Dict[str, str] = {}
        try:
            for trial_id, group, trial_ids in units:
                _chaos_deploy(inference_job_id, trial_id)
                sid = self._create_inference_worker(
                    inference_job_id, trial_id,
                    GenerationWorker if generative else InferenceWorker,
                    n_chips=chips_per_worker, trial_ids=trial_ids)
                created.append(sid)
                worker_trials[sid] = group
            predictor_service = self._db.create_service(ServiceType.PREDICT)
            self._db.update_inference_job_predictor(inference_job_id,
                                                    predictor_service["id"])
            predictor = Predictor(inference_job_id, self._broker,
                                  train_job["task"],
                                  worker_trials=worker_trials)
            with self._lock:
                self._predictors[inference_job_id] = predictor
            if config.PREDICTOR_PORTS:
                server = PredictorServer(predictor, train_job["app"],
                                         host=config.PREDICTOR_HOST).start()
                with self._lock:
                    self._servers[inference_job_id] = server
                self._db.update_service_host_port(
                    predictor_service["id"], server.host, server.port)
            self._wait_until_services_running(created)
            self._db.mark_service_as_running(predictor_service["id"])
            self._db.mark_inference_job_as_running(inference_job_id)
            return predictor
        except Exception:
            with self._lock:
                self._predictors.pop(inference_job_id, None)
                server = self._servers.pop(inference_job_id, None)
            if server is not None:
                server.stop()
            for sid in created:
                self._destroy_service(sid, wait=False)
            self._db.mark_inference_job_as_errored(inference_job_id)
            raise

    def _check_draft(self, inference_job_id: str, inf_job: Dict,
                     generative: bool) -> None:
        """The draft trial a budget names for speculative decoding
        (``GEN_DRAFT_TRIAL``) must exist, be COMPLETED and have a
        generation-capable template, and the job must be generative: each
        a typed deploy error here, never a worker that fails to start."""
        draft_tid = (inf_job.get("budget") or {}).get(
            BudgetType.GEN_DRAFT_TRIAL)
        if not draft_tid:
            return
        reason = None
        if not generative:
            reason = ("budget GEN_DRAFT_TRIAL is only meaningful for "
                      "TEXT_GENERATION jobs — drop it, or deploy a "
                      "generative train job")
        else:
            draft = self._db.get_trial(str(draft_tid))
            if draft is None:
                reason = (f"budget GEN_DRAFT_TRIAL names unknown trial "
                          f"{draft_tid!r}")
            elif draft.get("status") != TrialStatus.COMPLETED:
                reason = (f"budget GEN_DRAFT_TRIAL trial {draft_tid!r} is "
                          f"{draft.get('status')}, not COMPLETED — a draft "
                          "model needs trained params to propose tokens")
            else:
                from rafiki_tpu_torch.admin.admin import Admin

                model = self._db.get_model(draft["model_id"])
                if model is None \
                        or not Admin._model_generation_capable(model):
                    reason = (
                        f"budget GEN_DRAFT_TRIAL trial {draft_tid!r} is not "
                        "generation-capable — the draft must implement the "
                        "generation contract (init_kv_cache/prefill/"
                        "decode_step) plus decode_step_sampled")
        if reason is not None:
            self._db.mark_inference_job_as_errored(inference_job_id)
            raise ServiceDeploymentError(reason)

    def _create_inference_worker(self, inference_job_id: str,
                                 trial_id: str, worker_cls=InferenceWorker,
                                 n_chips: int = 1,
                                 trial_ids: Optional[List[str]] = None,
                                 model_version: int = 0,
                                 standby: bool = False,
                                 best_effort: bool = True) -> str:
        service = self._db.create_service(ServiceType.INFERENCE)
        self._db.create_inference_job_worker(
            service["id"], inference_job_id, trial_id,
            model_version=model_version, standby=standby)
        fused = {"trial_ids": trial_ids} if trial_ids else {}
        worker = worker_cls(inference_job_id, trial_id, self._db,
                            self._broker, **fused)
        try:
            # a serving executor prefers a device of its own, and shares
            # one when training or its siblings hold them all
            ctx = self._placement.create_service(
                service["id"], ServiceType.INFERENCE, worker.start,
                n_chips=n_chips, best_effort_chips=best_effort,
                extra={"inference_job_id": inference_job_id,
                       "trial_id": trial_id, **fused})
        except Exception:
            self._db.mark_service_as_stopped(service["id"])
            raise
        try:
            self._db.update_service_chips(service["id"], ctx.chips)
            # STARTED -> DEPLOYING (guarded) while the deploy wait runs
            self._db.mark_service_as_deploying(service["id"])
        except Exception:
            self._destroy_service(service["id"], wait=False)
            raise
        return service["id"]

    # -- crash recovery (admin/recovery.py) -----------------------------------

    def adopt_inference_job(self, inference_job_id: str
                            ) -> Optional[Predictor]:
        """Rebuild the serving head of a job whose replicas survived an
        admin restart: a fresh ``Predictor`` over the queues the recovery
        pass registered again, at the adopted fleet's model version, and
        the job's door under ``RAFIKI_PREDICTOR_PORTS=1``, so ``predict``
        answers with no redeploy. Idempotent (recovery retries it)."""
        inf = self._db.get_inference_job(inference_job_id)
        if inf is None:
            return None
        train_job = self._db.get_train_job(inf["train_job_id"])
        if train_job is None:
            return None
        group = self._group_of(inference_job_id)
        workers = self._db.get_workers_of_inference_job(inference_job_id)
        # a standby is adopted as a replica is, but it takes traffic only
        # once promoted
        worker_trials = {w["service_id"]: group(w["trial_id"])
                         for w in workers if not int(w.get("standby") or 0)}
        # the adopted fleet may differ from what the dead admin served
        get_cache().flush_job(inference_job_id, reason="adoption")
        version = max((int(w.get("model_version") or 0) for w in workers),
                      default=0)
        predictor = Predictor(inference_job_id, self._broker,
                              train_job["task"], worker_trials=worker_trials,
                              serving_version=version)
        with self._lock:
            self._predictors[inference_job_id] = predictor
            stale = self._servers.pop(inference_job_id, None)
        if stale is not None:
            stale.stop(drain_timeout_s=0.0)  # an earlier attempt's door
        psid = inf.get("predictor_service_id")
        if config.PREDICTOR_PORTS:
            server = PredictorServer(predictor, train_job["app"],
                                     host=config.PREDICTOR_HOST).start()
            with self._lock:
                self._servers[inference_job_id] = server
            if psid:
                # the door moved with the admin: publish its address
                self._db.update_service_host_port(psid, server.host,
                                                  server.port)
        if psid:
            self._db.mark_service_as_running(psid)
        self._db.mark_inference_job_as_running(inference_job_id)
        return predictor

    def restart_train_worker(self, service_id: str, sub_train_job_id: str,
                             n_chips: int = 0) -> bool:
        """Place a train executor again under its existing service id
        after an admin restart (its executor died with the old admin): the
        stale-RUNNING-trial resume re-runs what it left. The cards are
        best effort: a busy grant downsizes the executor rather than
        erroring its job a second time."""
        worker = TrainWorker(sub_train_job_id, self._db, self._advisors,
                             send_event=self._send_event,
                             params_dir=self._params_dir)
        try:
            ctx = self._placement.create_service(
                service_id, ServiceType.TRAIN, worker.start,
                n_chips=n_chips, best_effort_chips=True,
                extra={"sub_train_job_id": sub_train_job_id})
        except Exception:
            logger.exception("restarting train worker %s failed",
                             service_id[:8])
            return False
        try:
            self._db.update_service_chips(service_id, ctx.chips)
        except Exception:
            logger.exception("chip bookkeeping failed for restarted %s",
                             service_id[:8])
        return True

    def get_predictor(self, inference_job_id: str) -> Optional[Predictor]:
        with self._lock:
            return self._predictors.get(inference_job_id)

    def predictors(self) -> Dict[str, Predictor]:
        """The live {inference_job_id: Predictor} map, a snapshot."""
        with self._lock:
            return dict(self._predictors)

    def door(self, inference_job_id: str) -> Optional[PredictorServer]:
        """The job's own door (``RAFIKI_PREDICTOR_PORTS=1``), or None."""
        with self._lock:
            return self._servers.get(inference_job_id)

    def stop_inference_services(self, inference_job_id: str) -> None:
        for w in self._db.get_workers_of_inference_job(inference_job_id):
            self._destroy_service(w["service_id"], wait=False)
        self._teardown_serving(inference_job_id, errored=False)

    # -- the live fleet ------------------------------------------------------

    def _group_of(self, inference_job_id: str):
        """A worker row's replica group: its trial, or the fused group."""
        inf = self._db.get_inference_job(inference_job_id)
        if ((inf or {}).get("budget") or {}).get(BudgetType.ENSEMBLE_FUSED,
                                                  0):
            return lambda t: f"fused:{inference_job_id}"
        return lambda t: t

    def _worker_views(self, inference_job_id: str, statuses: List[str],
                      standby: bool) -> List[Dict]:
        group_of = self._group_of(inference_job_id)
        alive = {s["id"]: s for s in self._db.get_services(statuses=statuses)}
        with self._scale_lock:
            draining = set(self._scale_draining)
        out: List[Dict] = []
        for w in self._db.get_workers_of_inference_job(inference_job_id):
            if bool(int(w.get("standby") or 0)) != standby \
                    or (not standby and w["service_id"] in draining):
                continue
            svc = alive.get(w["service_id"])
            if svc is not None:
                out.append({"service_id": w["service_id"],
                            "trial_id": w["trial_id"],
                            "group": group_of(w["trial_id"]),
                            "model_version": int(
                                w.get("model_version") or 0),
                            "chips": svc.get("chips") or []})
        return out

    def live_inference_workers(self, inference_job_id: str) -> List[Dict]:
        """The job's routable replicas: non-standby rows whose service is
        not terminal and that are not draining, each with its group,
        rollout version and cards."""
        return self._worker_views(
            inference_job_id, [ServiceStatus.STARTED, ServiceStatus.DEPLOYING,
                               ServiceStatus.RUNNING], standby=False)

    def standby_workers(self, inference_job_id: str) -> List[Dict]:
        """The job's warm standbys: RUNNING (loaded and warmed) standby
        rows. A DEPLOYING standby is still warming: not promotable."""
        return self._worker_views(inference_job_id, [ServiceStatus.RUNNING],
                                  standby=True)

    def _chips_per_worker(self, inf: Dict) -> int:
        """The job's ``CHIPS_PER_WORKER``, never more than one host has."""
        n = max(int((inf.get("budget") or {}).get(
            BudgetType.CHIPS_PER_WORKER, 1)), 1)
        most = self._placement.allocator.max_chips_per_service
        if n > most > 0:
            logger.warning("CHIPS_PER_WORKER=%d exceeds the largest host "
                           "(%d chips); downsizing the serving mesh", n,
                           most)
            return most
        return n

    def _worker_cls(self, inf: Dict):
        train_job = self._db.get_train_job(inf["train_job_id"])
        return (GenerationWorker
                if train_job["task"] == TaskType.TEXT_GENERATION
                else InferenceWorker)

    def scale_inference_job(self, inference_job_id: str, delta: int,
                            borrow: bool = True,
                            drain_timeout_s: Optional[float] = None,
                            min_replicas: int = 1) -> Dict[str, Any]:
        """Add (``delta`` > 0) or drain (``delta`` < 0) replicas of a
        RUNNING job without a redeploy. Returns ``{added, removed,
        promoted, borrowed_chips, returned_chips}`` (and ``error`` when a
        scale-up stopped after some replicas landed)."""
        inf = self._db.get_inference_job(inference_job_id)
        if inf is None or inf["status"] != InferenceJobStatus.RUNNING:
            raise ServiceDeploymentError(
                f"inference job {inference_job_id} is not RUNNING")
        predictor = self.get_predictor(inference_job_id)
        if predictor is None:
            raise ServiceDeploymentError(
                f"inference job {inference_job_id} has no live predictor")
        report: Dict[str, Any] = {"added": [], "removed": [], "promoted": [],
                                  "borrowed_chips": 0, "returned_chips": 0}
        if delta > 0:
            for _ in range(delta):
                try:
                    sid, borrowed, promoted = self._scale_up_one(
                        inference_job_id, inf, predictor, borrow)
                except Exception as e:
                    if not report["added"]:
                        raise
                    logger.exception("scale-up of job %s stopped after %d "
                                     "replica(s)", inference_job_id[:8],
                                     len(report["added"]))
                    report["error"] = str(e)
                    break
                report["added"].append(sid)
                if promoted:
                    report["promoted"].append(sid)
                report["borrowed_chips"] += borrowed
        elif delta < 0:
            victims = self._pick_scale_down_victims(
                inference_job_id, -delta, min_replicas)
            freed, removed = self.drain_replicas(
                inference_job_id, victims, drain_timeout_s=drain_timeout_s)
            report["removed"] = removed
            report["returned_chips"] = freed
        return report

    def _scale_up_one(self, inference_job_id: str, inf: Dict, predictor,
                      borrow: bool):
        """One more replica: a warm standby promoted when the pool holds
        one, else a replica placed for the group with the fewest. Returns
        ``(service_id, borrowed cards, by promotion)``."""
        promoted = self.promote_standby(inference_job_id)
        if promoted is not None:
            return promoted, 0, True
        sid, borrowed, group, chips = self._place_replica(
            inference_job_id, inf, borrow=borrow, standby=False)
        predictor.add_worker(sid, group)
        logger.info("scaled UP job %s: replica %s for group %s (chips=%s)",
                    inference_job_id[:8], sid[:8], group[:16], chips)
        return sid, borrowed, False

    def _place_replica(self, inference_job_id: str, inf: Dict,
                       borrow: bool, standby: bool):
        """Deploy one replica for the group with the fewest live ones, at
        that group's rollout version, and wait until it runs (warmed). A
        standby's row says so, and the predictor is not told of it.
        Returns ``(service_id, borrowed cards, group, cards)``."""
        live = self.live_inference_workers(inference_job_id)
        budget = inf.get("budget") or {}
        if budget.get(BudgetType.ENSEMBLE_FUSED, 0):
            train_job = self._db.get_train_job(inf["train_job_id"])
            best = self._db.get_best_trials_of_train_job(
                train_job["id"], max_count=config.INFERENCE_MAX_BEST_TRIALS)
            group = f"fused:{inference_job_id}"
            trial_id = (best[0]["id"] if best
                        else (live[0]["trial_id"] if live else None))
            trial_ids = [t["id"] for t in best] or None
        else:
            by_group: Dict[str, int] = {}
            for w in live:
                by_group[w["group"]] = by_group.get(w["group"], 0) + 1
            if not by_group:
                raise ServiceDeploymentError(
                    f"inference job {inference_job_id} has no live "
                    "replicas to model the new one on")
            group = trial_id = min(sorted(by_group),
                                   key=lambda g: by_group[g])
            trial_ids = None
        if trial_id is None:
            raise ServiceDeploymentError(
                f"no trial to serve for job {inference_job_id}")
        version = max((w["model_version"] for w in live
                       if w["group"] == group), default=0)
        _chaos_deploy(inference_job_id, trial_id)
        # an exclusive grant only when the arbiter lends above the floor
        # (check and reserve in one step); else a shared device
        chips_per_worker = self._chips_per_worker(inf)
        want_chips, reservation = 0, None
        if borrow and self._arbiter is not None:
            reservation = self._arbiter.begin_borrow(chips_per_worker)
            if reservation is not None:
                want_chips = chips_per_worker
        place = functools.partial(
            self._create_inference_worker, inference_job_id, trial_id,
            self._worker_cls(inf), trial_ids=trial_ids,
            model_version=version, standby=standby)
        try:
            try:
                # a loan is an exclusive grant or nothing
                sid = place(n_chips=want_chips, best_effort=not want_chips)
            except InsufficientChipsError:
                if reservation is None:
                    raise
                self._arbiter.cancel_borrow(reservation)
                reservation = None
                sid = place(n_chips=0)
            try:
                self._wait_until_services_running([sid])
            except Exception:
                self._destroy_service(sid, wait=False)
                raise
        except Exception:
            if reservation is not None:
                self._arbiter.cancel_borrow(reservation)
            raise
        chips = (self._db.get_service(sid) or {}).get("chips") or []
        borrowed = 0
        if reservation is not None:
            self._arbiter.commit_borrow(reservation, sid, inference_job_id,
                                        chips)
            borrowed = len(chips)
            try:
                self._db.set_worker_borrowed_chips(sid, borrowed)
            except Exception:
                logger.exception("could not persist the %d-chip loan "
                                 "marker for replica %s", borrowed, sid[:8])
        return sid, borrowed, group, chips

    def create_standby_replica(self, inference_job_id: str) -> str:
        """Place one warm standby of a RUNNING job: loaded and warmed,
        its cards (when borrowed) tagged for reclaim first, never routed
        until promoted. Returns its service id."""
        inf = self._db.get_inference_job(inference_job_id)
        if inf is None or inf["status"] != InferenceJobStatus.RUNNING:
            raise ServiceDeploymentError(
                f"inference job {inference_job_id} is not RUNNING")
        sid, borrowed, group, chips = self._place_replica(
            inference_job_id, inf, borrow=True, standby=True)
        if borrowed and self._arbiter is not None:
            self._arbiter.mark_standby(sid, True)
        logger.info("warm pool: standby %s ready for job %s group %s "
                    "(chips=%s, borrowed=%d)", sid[:8], inference_job_id[:8],
                    group[:16], chips, borrowed)
        return sid

    def promote_standby(self, inference_job_id: str,
                        group: Optional[str] = None) -> Optional[str]:
        """Make one warm standby routable: its flag cleared first, then
        the predictor's ``add_worker``. A standby older than what its
        group serves is skipped. Returns its service id, or None when
        the pool has none."""
        predictor = self.get_predictor(inference_job_id)
        if predictor is None:
            return None
        candidates = self.standby_workers(inference_job_id)
        if group is not None:
            candidates = [w for w in candidates if w["group"] == group]
        cur: Dict[str, int] = {}
        for w in self.live_inference_workers(inference_job_id):
            cur[w["group"]] = max(cur.get(w["group"], 0), w["model_version"])
        for w in candidates:
            if w["model_version"] < cur.get(w["group"], 0):
                continue
            sid = w["service_id"]
            try:
                self._db.set_worker_standby(sid, False)
                predictor.add_worker(sid, w["group"])
            except Exception:
                logger.exception("promoting standby %s failed; trying "
                                 "siblings", sid[:8])
                continue
            if self._arbiter is not None:
                self._arbiter.mark_standby(sid, False)
            REGISTRY.counter("rafiki_warm_pool_promotions_total",
                             "warm standbys promoted into serving").inc()
            logger.info("warm pool: promoted standby %s into job %s group "
                        "%s", sid[:8], inference_job_id[:8], w["group"][:16])
            return sid
        return None

    def drop_standby(self, service_id: str) -> None:
        """Destroy a standby (a stale version, a shrunk pool): it serves
        nothing, so there is nothing to drain."""
        self._destroy_service(service_id, wait=False)

    def deploy_version_replica(self, inference_job_id: str, trial_id: str,
                               model_version: int) -> str:
        """Place one replica of ``trial_id`` at ``model_version`` and wait
        until it runs (warmed): the rollout's canary, rolling and restore
        placement. No loan: a rollout replaces capacity. Raises
        :class:`ServiceDeploymentError` on a failed placement, a deploy
        time-out or the ``deploy`` chaos site, with the replica torn down
        first."""
        inf = self._db.get_inference_job(inference_job_id)
        if inf is None:
            raise ServiceDeploymentError(
                f"no inference job {inference_job_id}")
        _chaos_deploy(inference_job_id, trial_id)
        try:
            sid = self._create_inference_worker(
                inference_job_id, trial_id, self._worker_cls(inf),
                n_chips=self._chips_per_worker(inf),
                model_version=model_version)
        except Exception as e:
            raise ServiceDeploymentError(
                f"placing replica of trial {trial_id} failed: "
                f"{type(e).__name__}: {e}") from e
        try:
            self._wait_until_services_running([sid])
        except Exception as e:
            self._destroy_service(sid, wait=False)
            if isinstance(e, ServiceDeploymentError):
                raise
            raise ServiceDeploymentError(
                f"replica of trial {trial_id} never reached RUNNING: "
                f"{type(e).__name__}: {e}") from e
        logger.info("rollout: placed replica %s (trial %s, version %d) for "
                    "job %s", sid[:8], trial_id[:8], model_version,
                    inference_job_id[:8])
        return sid

    def _pick_scale_down_victims(self, inference_job_id: str, n: int,
                                 min_replicas: int) -> List[str]:
        """Up to ``n`` replicas to drain: borrowed ones first, then the
        youngest; a trial's last replica only when every other trial is
        down to one too; never below ``min_replicas``."""
        live = self.live_inference_workers(inference_job_id)
        headroom = len(live) - max(min_replicas, 1)
        if headroom <= 0:
            return []
        n = min(n, headroom)
        by_group: Dict[str, int] = {}
        for w in live:
            by_group[w["group"]] = by_group.get(w["group"], 0) + 1
        borrowed = set(self._arbiter.borrowed()) if self._arbiter else set()
        ordered = sorted(
            reversed(live),
            key=lambda w: 0 if w["service_id"] in borrowed else 1)
        victims: List[str] = []
        for w in ordered:
            if len(victims) >= n:
                break
            spare_groups = any(c > 1 for g, c in by_group.items()
                               if g != w["group"])
            if by_group[w["group"]] <= 1 and spare_groups:
                continue
            victims.append(w["service_id"])
            by_group[w["group"]] -= 1
        return victims

    def drain_replicas(self, inference_job_id: str, service_ids: List[str],
                       drain_timeout_s: Optional[float] = None
                       ) -> "tuple[int, List[str]]":
        """Remove replicas gracefully: retired from the fan-out, their
        queues (and resident streams) waited out within the drain window,
        then destroyed. Replicas already draining are skipped. Returns
        ``(borrowed cards returned, service ids removed)``; a victim whose
        drain failed is routed again and not counted."""
        if drain_timeout_s is None:
            drain_timeout_s = float(config.AUTOSCALE_DRAIN_S)
        with self._scale_lock:
            mine = [s for s in service_ids if s not in self._scale_draining]
            self._scale_draining.update(mine)
        predictor = self.get_predictor(inference_job_id)
        freed = 0
        removed: List[str] = []
        try:
            for sid in mine:
                if predictor is not None:
                    predictor.retire_worker(sid)
            for sid in mine:
                loan = (self._arbiter.borrowed().get(sid, ("", 0))[1]
                        if self._arbiter is not None else 0)
                try:
                    self._drain_one(inference_job_id, sid, predictor,
                                    drain_timeout_s)
                except Exception:
                    logger.exception("drain of replica %s failed; restoring "
                                     "it to the fan-out", sid[:8])
                    if predictor is not None:
                        predictor.unretire_worker(sid)
                    continue
                removed.append(sid)
                freed += loan
        finally:
            with self._scale_lock:
                self._scale_draining.difference_update(mine)
        return freed, removed

    @staticmethod
    def _resident_streams(sid: str) -> int:
        """Generation streams still resident on a replica (busy slots and
        stashed ones): what a drain waits out past an empty queue; 0 for
        a classification replica."""
        with _stats_lock:
            row = SERVING_STATS.get(sid)
            return int(row.get("gen_resident_streams", 0)) if row else 0

    def _drain_one(self, inference_job_id: str, sid: str, predictor,
                   drain_timeout_s: float) -> None:
        queue = self._broker.get_worker_queues(inference_job_id).get(sid)
        depth_fn = getattr(queue, "depth", None)
        deadline = time.monotonic() + max(drain_timeout_s, 0.0)
        zero_reads = 0
        while callable(depth_fn) and time.monotonic() < deadline:
            try:
                depth = depth_fn()
            except Exception:
                break  # a dead queue ends the wait
            if depth <= 0 and self._resident_streams(sid) <= 0:
                # three empty reads in a row: a request that took its
                # routes before the retire may still land a submit
                zero_reads += 1
                if zero_reads >= 3:
                    break
            else:
                zero_reads = 0
            time.sleep(0.03)
        else:
            if callable(depth_fn):
                try:
                    leftover = depth_fn()
                except Exception:
                    leftover = -1
                if leftover:
                    logger.warning(
                        "replica %s still has %d queued queries after the "
                        "%.1fs drain window; destroying anyway (stragglers "
                        "fail over to siblings)", sid[:8], leftover,
                        drain_timeout_s)
        # wait=True: the worker answers its batch in flight and releases
        # its model before the replica is forgotten
        self._destroy_service(sid, wait=True)
        if predictor is not None:
            predictor.drop_worker(sid)
        logger.info("scaled DOWN job %s: replica %s drained and destroyed",
                    inference_job_id[:8], sid[:8])

    def reclaim_borrowed(self, n_chips: int) -> int:
        """The arbiter's reclaim: standbys on loan destroyed first (they
        serve nothing), then borrowed replicas drained under the
        scale-down rules, until ``n_chips`` came home. Returns the cards
        freed."""
        if self._arbiter is None:
            return 0
        freed = 0
        for sid, (_, n) in list(self._arbiter.borrowed().items()):
            if freed >= n_chips:
                break
            row = self._db.get_inference_job_worker(sid)
            if row is not None and int(row.get("standby") or 0):
                self._destroy_service(sid, wait=False)
                freed += n
                REGISTRY.counter(
                    "rafiki_warm_pool_reclaims_total",
                    "warm standbys destroyed to return chips to "
                    "training").inc()
                logger.info("reclaim: standby %s destroyed, %d chip(s) "
                            "home", sid[:8], n)
        if freed >= n_chips:
            return freed
        loans = self._arbiter.borrowed()
        by_job: Dict[str, List[str]] = {}
        for sid, (job_id, _) in loans.items():
            by_job.setdefault(job_id, []).append(sid)
        min_r = max(int(config.AUTOSCALE_MIN_REPLICAS), 1)
        for job_id, sids in by_job.items():
            if freed >= n_chips:
                break
            try:
                eligible = [s for s in self._pick_scale_down_victims(
                    job_id, len(sids), min_r) if s in loans]
            except Exception:
                logger.exception("reclaim victim pick for job %s failed",
                                 job_id[:8])
                continue
            for sid in eligible:
                if freed >= n_chips:
                    break
                try:
                    freed += self.drain_replicas(job_id, [sid])[0]
                except Exception:
                    logger.exception("reclaim drain of %s failed", sid[:8])
        return freed

    # -- shared --------------------------------------------------------------

    def _destroy_service(self, service_id: str, wait: bool = True) -> None:
        try:
            self._placement.destroy_service(service_id, wait=wait)
        except Exception:
            logger.exception("destroying service %s failed", service_id)
        self._db.mark_service_as_stopped(service_id)
        # every teardown ends here: a replica's loan comes home however
        # it went, and its durable marker with it
        if self._arbiter is not None \
                and self._arbiter.note_return(service_id) > 0:
            try:
                self._db.set_worker_borrowed_chips(service_id, 0)
            except Exception:
                logger.exception("could not clear the loan marker for "
                                 "replica %s", service_id[:8])

    def _wait_until_services_running(self, service_ids: List[str]) -> None:
        """Poll the store until every service is RUNNING (or already
        STOPPED: a fast worker may have finished)."""
        deadline = time.time() + config.SERVICE_DEPLOY_TIMEOUT_S
        pending = set(service_ids)
        while pending:
            for sid in list(pending):
                svc = self._db.get_service(sid)
                if svc is None or svc["status"] == ServiceStatus.ERRORED:
                    raise ServiceDeploymentError(
                        f"Service {sid} errored on deploy")
                if svc["status"] in (ServiceStatus.RUNNING,
                                     ServiceStatus.STOPPED):
                    pending.discard(sid)
            if pending:
                if time.time() > deadline:
                    raise ServiceDeploymentError(
                        f"Services not running after "
                        f"{config.SERVICE_DEPLOY_TIMEOUT_S}s: {pending}")
                time.sleep(0.05)
