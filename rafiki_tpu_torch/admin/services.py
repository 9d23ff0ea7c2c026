"""Deployment engine: turns job rows into running services.

Own copy of the core of ``rafiki_tpu/admin/services.py``:

- train jobs: the chip budget (``CHIP_COUNT``, clamped to the host's
  inventory) is split evenly across sub-train-jobs, one executor a card,
  or one executor sharing a device when the budget is 0;
- inference jobs: for each of the best ``INFERENCE_MAX_BEST_TRIALS``
  trials, ``INFERENCE_WORKER_REPLICAS_PER_TRIAL`` serving executors
  (clamped so replicas get a device of their own) and one predictor. A
  worker whose exclusive device is taken shares one (placement/manager.py),
  so on a one-card host both best trials are served on ``cuda:0``. A
  ``TEXT_GENERATION`` job serves its one best trial with
  ``GenerationWorker`` s (a token stream answers from one model);
- with ``RAFIKI_PREDICTOR_PORTS=1`` each inference job gets its own door
  (``PredictorServer``: ``/predict``, ``/generate``) on
  ``RAFIKI_PREDICTOR_HOST``, its host and port on the predictor's service
  row;
- a deploy waits until its services report RUNNING and rolls back on
  failure; a train job's status is derived from its workers' services.

Not ported (ROADMAP.md; ``Admin`` refuses the budget keys that ask for
them): multi-card trials and workers, fused ensembles, speculative
decoding's draft, generation in worker processes (refused typed), standby
replicas, rollout, drain, scaling, chip loans and reclaim, and recovery's
adoption of running services.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional

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
)
from rafiki_tpu_torch.db.database import Database
from rafiki_tpu_torch.placement.manager import PlacementManager
from rafiki_tpu_torch.placement.process import ProcessPlacementManager
from rafiki_tpu_torch.predictor.predictor import Predictor
from rafiki_tpu_torch.predictor.server import PredictorServer
from rafiki_tpu_torch.worker.generation import GenerationWorker
from rafiki_tpu_torch.worker.inference import InferenceWorker
from rafiki_tpu_torch.worker.train import EventFn, TrainWorker

logger = logging.getLogger(__name__)


class ServiceDeploymentError(Exception):
    pass


class ServicesManager:
    def __init__(self, db: Database, placement: PlacementManager,
                 advisor_store: AdvisorStore, broker: Broker,
                 send_event: EventFn, params_dir: Optional[str] = None):
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
        created: List[str] = []
        try:
            for sub in sub_jobs:
                # one executor a card; with none, one on a shared device
                workers = [1] * chips_per_sub if chips_per_sub else [0]
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
        try:
            ctx = self._placement.create_service(
                service["id"], ServiceType.TRAIN, worker.start,
                n_chips=n_chips,
                extra={"sub_train_job_id": sub_train_job_id})
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
            if isinstance(self._placement, ProcessPlacementManager):
                self._db.mark_inference_job_as_errored(inference_job_id)
                raise ServiceDeploymentError(
                    "TEXT_GENERATION serving in worker processes is not "
                    "ported to rafiki_tpu_torch (ROADMAP.md): token streams "
                    "do not cross the shm rings; deploy under thread "
                    "placement")
            # a token stream answers from one model: one best trial
            best_trials = best_trials[:1]
        # replicas buy capacity only on devices of their own: same-device
        # replicas in one process just split batches
        n_replicas = max(1, min(
            config.INFERENCE_WORKER_REPLICAS_PER_TRIAL,
            self._placement.allocator.total_chips // len(best_trials)))
        created: List[str] = []
        worker_trials: Dict[str, str] = {}
        try:
            for trial in best_trials:
                for _ in range(n_replicas):
                    sid = self._create_inference_worker(
                        inference_job_id, trial["id"],
                        GenerationWorker if generative else InferenceWorker)
                    created.append(sid)
                    worker_trials[sid] = trial["id"]
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

    def _create_inference_worker(self, inference_job_id: str,
                                 trial_id: str, worker_cls=InferenceWorker
                                 ) -> str:
        service = self._db.create_service(ServiceType.INFERENCE)
        self._db.create_inference_job_worker(service["id"], inference_job_id,
                                             trial_id)
        worker = worker_cls(inference_job_id, trial_id, self._db,
                            self._broker)
        try:
            # a serving executor prefers a device of its own, and shares
            # one when training or its siblings hold them all
            ctx = self._placement.create_service(
                service["id"], ServiceType.INFERENCE, worker.start,
                n_chips=1, best_effort_chips=True,
                extra={"inference_job_id": inference_job_id,
                       "trial_id": trial_id})
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

    def get_predictor(self, inference_job_id: str) -> Optional[Predictor]:
        with self._lock:
            return self._predictors.get(inference_job_id)

    def stop_inference_services(self, inference_job_id: str) -> None:
        for w in self._db.get_workers_of_inference_job(inference_job_id):
            self._destroy_service(w["service_id"], wait=False)
        self._teardown_serving(inference_job_id, errored=False)

    def live_inference_workers(self, inference_job_id: str) -> List[Dict]:
        """The job's serving replicas whose service is not terminal."""
        alive = {s["id"]: s for s in self._db.get_services(statuses=[
            ServiceStatus.STARTED, ServiceStatus.DEPLOYING,
            ServiceStatus.RUNNING])}
        return [{"service_id": w["service_id"], "trial_id": w["trial_id"],
                 "group": w["trial_id"],
                 "model_version": int(w.get("model_version") or 0),
                 "chips": alive[w["service_id"]].get("chips") or []}
                for w in self._db.get_workers_of_inference_job(
                    inference_job_id)
                if w["service_id"] in alive]

    # -- shared --------------------------------------------------------------

    def _destroy_service(self, service_id: str, wait: bool = True) -> None:
        try:
            self._placement.destroy_service(service_id, wait=wait)
        except Exception:
            logger.exception("destroying service %s failed", service_id)
        self._db.mark_service_as_stopped(service_id)

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
