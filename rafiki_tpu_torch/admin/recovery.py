"""Control-plane crash recovery: an admin's boot reconciles the store.

Own copy of ``rafiki_tpu/admin/recovery.py``. ``ServicesManager`` keeps
predictors, doors and placement state in memory, so a dead admin leaves
its jobs RUNNING in the store over workers that may still run. A fresh
:class:`~rafiki_tpu_torch.admin.admin.Admin` on that store boots
idempotently:

1. **Scan** (in the constructor, so nothing made after the boot is
   touched): every non-terminal service joined to its job linkage
   (``Database.get_non_terminal_services``), the non-terminal jobs, and
   the rollouts left live.
2. **Probe**: a placement with ``probe_inventories`` (host agents) says
   what each host runs.
3. **Reconcile**, off-thread behind a ``recovering → ready`` state the
   doors gate on:
   - the advisor sessions of non-terminal train services are rebuilt
     first (same id, the store's scored and infeasible trials replayed),
     before a surviving worker's next proposal;
   - **fence** an orphan: a service still running whose row or job went
     terminal while the admin was down;
   - **adopt** a survivor: through the placement's ``adopt_service``, or
     for a process placement a train child by its recorded pid
     (``adopt_pid``); a surviving serving child is fenced (SIGTERM), its
     data plane died with the old admin. ``RAFIKI_RECOVER_ADOPT=0``
     fences what would be adopted;
   - **reschedule** a train service whose executor is gone, under the
     same id (the stale-trial resume continues its work), through the
     placement's ``reschedule_service`` or ``restart_train_worker``;
   - **error** the rest, with a reason, through the admin's status
     callback, so the job's refresh runs as for a live failure;
   - the serving heads of jobs with adopted replicas are rebuilt
     (``adopt_inference_job``), an adopted replica's card loan is
     re-entered in the chip arbiter, and the rollout and drift
     controllers resolve their live rows (``recover_on_boot``).
4. **Sweep**: every non-terminal job is refreshed, and one left with no
   live service is closed.

The probe, fence, adopt and reschedule passes are duck-typed on the
placement, as in the JAX package: under host placement
(``placement/hosts.py``) they go through the agents' ``/inventory`` and
``/services`` routes, and a local pid is never adopted there. A store step retries with bounded jittered backoff (the ``db`` chaos site
drills it); a reconcile that fails anyway still opens the doors, marked
``failed`` in its report. The report is ``recovery_status()`` and
``<LOGS_DIR>/recovery.json``, and under a lease also
``recovery-e<epoch>.json``, of which the newest
``RAFIKI_RECOVERY_REPORT_KEEP`` are kept.
"""

from __future__ import annotations

import json
import logging
import os
import random
import re
import threading
import time
from typing import Any, Dict, List, Optional

from rafiki_tpu_torch import config
from rafiki_tpu_torch.constants import (
    InferenceJobStatus,
    RolloutPhase,
    ServiceStatus,
    ServiceType,
    TrainJobStatus,
    TrialStatus,
)

logger = logging.getLogger(__name__)

_TERMINAL = (ServiceStatus.STOPPED, ServiceStatus.ERRORED)
_JOB_TERMINAL = (TrainJobStatus.STOPPED, TrainJobStatus.ERRORED)
_MAX_REASONS = 64  # an operator's view, not a log

REPORT_FILENAME = "recovery.json"


class RecoveryAborted(Exception):
    """The admin is shutting down: a service placed after its teardown
    would have nothing left to stop it."""


def report_path() -> str:
    return os.path.join(config.LOGS_DIR, REPORT_FILENAME)


def _job_status_of(row: Dict[str, Any]) -> Optional[str]:
    """The status of the job a scanned service row belongs to (None: no
    job links to it)."""
    if row["service_type"] == ServiceType.TRAIN:
        return row.get("train_job_status")
    if row["service_type"] == ServiceType.INFERENCE:
        return row.get("inference_job_status")
    if row["service_type"] == ServiceType.PREDICT:
        return row.get("predictor_job_status")
    return None


def _extra_of(row: Dict[str, Any]) -> Dict[str, Any]:
    """The placement payload, from the row, to relaunch or adopt it."""
    if row["service_type"] == ServiceType.TRAIN:
        return {"sub_train_job_id": row.get("sub_train_job_id")}
    if row["service_type"] == ServiceType.INFERENCE:
        return {"inference_job_id": row.get("inference_job_id"),
                "trial_id": row.get("trial_id")}
    return {}


class ControlPlaneRecovery:
    """One boot's reconciliation for an Admin."""

    def __init__(self, admin):
        self.admin = admin
        self.db = admin.db
        self.report: Dict[str, Any] = {
            "state": "recovering", "started_at": time.time(),
            "scanned": 0, "adopted": 0, "rescheduled": 0, "fenced": 0,
            "closed": 0, "errored": 0, "jobs_closed": 0,
            "agents_probed": 0, "agents_unreachable": 0, "db_retries": 0,
            "reasons": []}
        self._restored_advisors: set = set()
        #: set by Admin.shutdown(); checked at each loop's top and in the
        #: retries' backoff
        self._abort = threading.Event()

    def abort(self) -> None:
        self._abort.set()

    def _check_abort(self) -> None:
        if self._abort.is_set():
            raise RecoveryAborted("admin is shutting down")

    def _retry(self, fn, what: str):
        """A store step with bounded jittered backoff: a transient store
        fault must not leave the fleet unreconciled."""
        attempts = max(int(config.RECOVER_RETRY_MAX), 0) + 1
        for attempt in range(attempts):
            self._check_abort()
            try:
                return fn()
            except RecoveryAborted:
                raise
            except Exception as e:
                if attempt + 1 >= attempts:
                    raise
                self.report["db_retries"] += 1
                delay = (float(config.RECOVER_RETRY_BACKOFF_S)
                         * (2 ** attempt) * random.uniform(0.5, 1.5))
                logger.warning(
                    "recovery: %s failed (%s); retry %d/%d in %.2fs",
                    what, e, attempt + 1, attempts - 1, delay)
                if self._abort.wait(delay):
                    raise RecoveryAborted("admin is shutting down")

    def _reason(self, text: str) -> None:
        if len(self.report["reasons"]) < _MAX_REASONS:
            self.report["reasons"].append(text)

    # -- the scan (synchronous, in the Admin constructor) ------------------

    def snapshot(self) -> Dict[str, Any]:
        services = self._retry(self.db.get_non_terminal_services,
                               "service scan")
        train_jobs = self._retry(
            lambda: self.db.get_train_jobs_by_statuses(
                [TrainJobStatus.STARTED, TrainJobStatus.RUNNING]),
            "train-job scan")
        inference_jobs = self._retry(
            lambda: self.db.get_inference_jobs_by_statuses(
                [InferenceJobStatus.STARTED, InferenceJobStatus.RUNNING]),
            "inference-job scan")
        # a live rollout row is always resolved, even when every job row
        # is terminal
        rollouts = self._retry(
            lambda: self.db.get_rollouts_by_phases(list(RolloutPhase.LIVE)),
            "rollout scan")
        return {"services": services, "train_jobs": train_jobs,
                "inference_jobs": inference_jobs, "rollouts": rollouts}

    @staticmethod
    def needed(snapshot: Dict[str, Any]) -> bool:
        return any(snapshot.get(k) for k in
                   ("services", "train_jobs", "inference_jobs", "rollouts"))

    def empty_report(self) -> Dict[str, Any]:
        return {**self.report, "state": "ready", "duration_s": 0.0}

    # -- the reconcile (off-thread) ----------------------------------------

    def run(self, snapshot: Dict[str, Any]) -> Dict[str, Any]:
        t0 = time.monotonic()
        try:
            self._reconcile(snapshot)
        except Exception as e:
            # visible in memory and on disk, never a clean pass with
            # partial counts; the doors open either way
            self.report["failed"] = True
            self.report["error"] = f"{type(e).__name__}: {e}"
            self._reason(f"reconciliation ABORTED: {type(e).__name__}: {e}")
            logger.exception("control-plane reconciliation aborted")
        self.report["state"] = "ready"
        self.report["duration_s"] = round(time.monotonic() - t0, 3)
        self._persist_report()
        logger.info(
            "control-plane recovery done in %.2fs: %d scanned, %d adopted, "
            "%d rescheduled, %d fenced, %d errored%s",
            self.report["duration_s"], self.report["scanned"],
            self.report["adopted"], self.report["rescheduled"],
            self.report["fenced"], self.report["errored"],
            " (ABORTED)" if self.report.get("failed") else "")
        return dict(self.report)

    def _reconcile(self, snapshot: Dict[str, Any]) -> None:
        admin = self.admin
        placement = admin.placement
        services: List[Dict[str, Any]] = snapshot["services"]
        self.report["scanned"] = len(services)
        by_id = {s["id"]: s for s in services}
        adopt_enabled = bool(config.RECOVER_ADOPT)
        if not adopt_enabled:
            self._reason("RAFIKI_RECOVER_ADOPT=0: surviving workers are "
                         "fenced, not adopted")

        # the advisor sessions first: a surviving train worker may propose
        # at any moment (the advisor routes pass the recovering gate)
        for row in services:
            if (row["service_type"] == ServiceType.TRAIN
                    and row.get("train_job_status") not in _JOB_TERMINAL
                    and row.get("sub_train_job_id")):
                self._restore_advisor(row["sub_train_job_id"])

        # -- the hosts' own account -------------------------------------
        running_on: Dict[str, str] = {}  # service id -> agent address
        inventories: Dict[str, Optional[Dict[str, Any]]] = {}
        if hasattr(placement, "probe_inventories"):  # host agents
            inventories = placement.probe_inventories()
            self.report["agents_probed"] = len(inventories)
            self.report["agents_unreachable"] = sum(
                1 for v in inventories.values() if v is None)
            for addr, inv in inventories.items():
                for entry in (inv or {}).get("services", []):
                    running_on[entry["service_id"]] = addr

        # -- fence the running orphans: a terminal row or job, or none,
        # over the agents' inventories
        for addr, inv in inventories.items():
            for entry in (inv or {}).get("services", []):
                sid = entry["service_id"]
                row = by_id.get(sid)
                jstatus = _job_status_of(row) if row else None
                if row is not None and jstatus is not None \
                        and jstatus not in _JOB_TERMINAL:
                    continue  # live and owned
                if row is None:
                    # terminal, missing, or placed by this admin after its
                    # scan: the live row tells
                    try:
                        fresh = self._retry(
                            lambda s=sid: self.db.get_service(s),
                            f"live re-check of {sid[:8]}")
                    except RecoveryAborted:
                        raise
                    except Exception:
                        continue  # orphanhood unproven: leave it
                    if fresh is not None and fresh["status"] not in _TERMINAL:
                        running_on.pop(sid, None)
                        continue
                why = ("no (or terminal) store row" if row is None
                       else "no job row references it"
                       if jstatus is None else f"its job is {jstatus}")
                fenced = (hasattr(placement, "fence_service")
                          and placement.fence_service(sid, addr))
                running_on.pop(sid, None)
                # never adopted or rescheduled below; its row is closed
                # only when the fence landed (a row closed over a running
                # executor would hide it from every later reconcile)
                by_id.pop(sid, None)
                if fenced:
                    self.report["fenced"] += 1
                    self._reason(f"{sid[:8]}: fenced on {addr} ({why})")
                    if row is not None:
                        self._retry(
                            lambda s=sid: self.db.mark_service_as_stopped(s),
                            f"close fenced row {sid[:8]}")
                elif row is not None:
                    self._reason(
                        f"{sid[:8]}: could not fence on {addr} ({why}); "
                        "row left non-terminal for the next reconcile")

        if not adopt_enabled:
            # every survivor fenced (and waited out: a TRAIN service may be
            # placed again under its id below); a failed fence leaves it
            # alone, since acting on a maybe-running executor could run it
            # twice
            for sid, addr in list(running_on.items()):
                if hasattr(placement, "fence_service") and \
                        placement.fence_service(sid, addr, wait=True):
                    self.report["fenced"] += 1
                else:
                    by_id.pop(sid, None)
                    self._reason(f"{sid[:8]}: could not fence on {addr} "
                                 "(adoption disabled); left untouched")
            running_on.clear()

        # -- adopt, reschedule or error every non-terminal service --------
        adopted_serving_jobs = set()
        unreachable = [a for a, inv in inventories.items() if inv is None]
        for row in services:
            self._check_abort()
            sid = row["id"]
            if sid not in by_id:
                continue  # the fence pass took it
            stype = row["service_type"]
            jstatus = _job_status_of(row)
            if jstatus in _JOB_TERMINAL:
                # the job ended while the admin was down, and nothing runs
                # for it: close the stale row
                self._retry(
                    lambda s=sid: self.db.mark_service_as_stopped(s),
                    f"close stale row {sid[:8]}")
                self.report["closed"] += 1
                continue
            if stype == ServiceType.PREDICT:
                continue  # serving heads are rebuilt a job, below
            if jstatus is None:
                self._error_service(
                    sid, "no job row references this service "
                         "(orphaned linkage)")
                continue
            extra = _extra_of(row)
            n_chips = len(row.get("chips") or [])
            addr = running_on.get(sid)
            # a host agent's survivor
            if addr is not None and hasattr(placement, "adopt_service"):
                if placement.adopt_service(
                        sid, addr, stype, n_chips=n_chips, extra=extra,
                        best_effort_chips=(stype == ServiceType.INFERENCE)):
                    self.report["adopted"] += 1
                    if stype == ServiceType.INFERENCE:
                        adopted_serving_jobs.add(extra["inference_job_id"])
                        self._readopt_chip_loan(row, extra)
                    continue
            if adopt_enabled and self._adopt_local_pid(row, extra):
                self.report["adopted"] += 1
                if stype == ServiceType.INFERENCE:
                    adopted_serving_jobs.add(extra["inference_job_id"])
                    self._readopt_chip_loan(row, extra)
                continue
            if not adopt_enabled:
                # a surviving local child goes before anything is placed
                # under its id
                self._fence_local_survivor(row)
            # nothing runs this service any more
            if stype == ServiceType.TRAIN:
                if unreachable and hasattr(placement,
                                           "quarantine_on_rejoin"):
                    # the old executor may live on a host whose probe only
                    # timed out: fence it there when the host is back
                    placement.quarantine_on_rejoin(unreachable, sid)
                if self._restart_train(row, extra, n_chips,
                                       exclude=unreachable):
                    self.report["rescheduled"] += 1
                else:
                    self._error_service(
                        sid, "train executor lost (host died while the "
                             "control plane was down; no capacity to "
                             "reschedule)")
            else:
                if unreachable and hasattr(placement,
                                           "quarantine_on_rejoin"):
                    placement.quarantine_on_rejoin(unreachable, sid)
                self._error_service(
                    sid, "serving replica lost with its host while the "
                         "control plane was down")

        # -- the serving heads of jobs with adopted replicas ---------------
        for job_id in sorted(adopted_serving_jobs):
            self._check_abort()
            try:
                self._retry(
                    lambda j=job_id: admin.services.adopt_inference_job(j),
                    f"serving adoption for job {job_id[:8]}")
            except RecoveryAborted:
                raise
            except Exception as e:
                logger.exception("serving adoption failed for %s", job_id)
                self._reason(f"job {job_id[:8]}: serving adoption failed "
                             f"({type(e).__name__}: {e})")

        # -- the controllers' live rows: a rollout the dead admin left in
        # CANARY or ROLLING is done or rolled back; a drift row resumes or
        # parks, never launching its retrain twice
        for name, what in (("rollouts", "rollout resolution"),
                           ("drift", "drift resumption")):
            controller = getattr(admin, name, None)
            if controller is None:
                continue
            self._check_abort()
            try:
                controller.recover_on_boot()
            except RecoveryAborted:
                raise
            except Exception as e:
                logger.exception("boot-time %s failed", what)
                self._reason(f"{what} failed ({type(e).__name__}: {e})")

        self._sweep_jobs(snapshot)

    def _readopt_chip_loan(self, row: Dict[str, Any],
                           extra: Dict[str, Any]) -> None:
        """An adopted serving replica that held borrowed cards (the
        durable ``borrowed_chips`` column) goes back on the chip arbiter's
        loan book, a warm standby tagged as one, so training can reclaim
        it."""
        n = int(row.get("borrowed_chips") or 0)
        if n <= 0:
            return
        arbiter = getattr(self.admin, "chip_arbiter", None)
        if arbiter is None:
            return
        try:
            arbiter.note_borrow(row["id"], extra["inference_job_id"], n)
            worker = self.db.get_inference_job_worker(row["id"])
            if worker is not None and int(worker.get("standby") or 0):
                arbiter.mark_standby(row["id"], True)
            logger.info("re-adopted a %d-chip serving loan on replica %s",
                        n, row["id"][:8])
        except Exception:  # advisory accounting: the adoption stands
            logger.exception("chip-loan re-adoption failed for %s",
                             row["id"][:8])

    def _adopt_local_pid(self, row: Dict[str, Any],
                         extra: Dict[str, Any]) -> bool:
        """Process placement on one host: a TRAIN child that outlived the
        admin is adopted by its recorded pid; a surviving INFERENCE child
        is fenced (its shm data plane died with the old admin) and then
        handled as lost."""
        placement = self.admin.placement
        if hasattr(placement, "agents"):
            # host placement: a local pid may be an agent's child, which
            # the probe reconciles
            return False
        if not hasattr(placement, "adopt_pid"):
            return False
        pid = row.get("pid")
        if not pid:
            return False
        if row["service_type"] == ServiceType.INFERENCE:
            self._fence_local_pid(row["id"], int(pid),
                                  why="its data plane died with the old "
                                      "admin")
            return False
        return bool(placement.adopt_pid(
            row["id"], row["service_type"], int(pid), extra=extra,
            chips=row.get("chips") or []))

    def _fence_local_survivor(self, row: Dict[str, Any]) -> None:
        """Adoption off: SIGTERM a surviving local child (and wait it out)
        before its id is placed again."""
        if hasattr(self.admin.placement, "agents"):
            return
        pid = row.get("pid")
        if not pid:
            return
        if self._fence_local_pid(row["id"], int(pid),
                                 why="RAFIKI_RECOVER_ADOPT=0",
                                 wait_s=10.0):
            self.report["fenced"] += 1
            self._reason(f"{row['id'][:8]}: fenced local child pid {pid} "
                         "(adoption disabled)")

    @staticmethod
    def _fence_local_pid(service_id: str, pid: int, why: str,
                         wait_s: float = 0.0) -> bool:
        from rafiki_tpu_torch.placement.process import (
            _pid_is_worker,
            terminate_worker_pid,
        )

        # a recycled pid of another service's worker is never signalled
        if not _pid_is_worker(pid, service_id=service_id):
            return False
        logger.warning("fencing surviving child %s (pid %d): %s",
                       service_id[:8], pid, why)
        terminate_worker_pid(pid, service_id, grace_s=wait_s)
        return True

    def _restore_advisor(self, sub_train_job_id: Optional[str]) -> None:
        """A surviving train worker's advisor session (id: its
        sub-train-job) lived in the dead admin: rebuild it here, seeded
        with the store's scored and infeasible trials, before its next
        proposal errors the executor just adopted."""
        if not sub_train_job_id or sub_train_job_id in self._restored_advisors:
            return
        self._restored_advisors.add(sub_train_job_id)
        try:
            sub = self.db.get_sub_train_job(sub_train_job_id)
            model = self.db.get_model(sub["model_id"]) if sub else None
            if model is None:
                return
            from rafiki_tpu_torch.sdk.model import load_model_class
            from rafiki_tpu_torch.worker.faults import is_infeasible_row

            clazz = load_model_class(model["model_file_bytes"],
                                     model["model_class"])
            store = self.admin.advisor_store
            store.create_advisor(clazz.get_knob_config(),
                                 advisor_id=sub_train_job_id)
            trials = self.db.get_trials_of_sub_train_job(sub_train_job_id)
            scored = [(t["knobs"], t["score"]) for t in trials
                      if t["status"] == TrialStatus.COMPLETED
                      and t["score"] is not None]
            infeasible = [(t["knobs"], t["fault_kind"]) for t in trials
                          if is_infeasible_row(t)]
            if (scored or infeasible) and store.replay_feedback(
                    sub_train_job_id, scored, infeasible=infeasible):
                logger.info("advisor %s rebuilt with %d replayed + %d "
                            "infeasible trials", sub_train_job_id[:8],
                            len(scored), len(infeasible))
        except Exception as e:
            logger.exception("advisor restore failed for %s",
                             sub_train_job_id)
            self._reason(f"sub {sub_train_job_id[:8]}: advisor restore "
                         f"failed ({type(e).__name__}: {e})")

    def _restart_train(self, row: Dict[str, Any], extra: Dict[str, Any],
                       n_chips: int, exclude=()) -> bool:
        """Place a lost train executor again under its id: through the
        placement's ``reschedule_service`` (never on an ``exclude``d
        host), else ``restart_train_worker`` here."""
        placement = self.admin.placement
        if hasattr(placement, "reschedule_service"):  # host agents
            try:
                return bool(placement.reschedule_service(
                    row["id"], row["service_type"], n_chips=n_chips,
                    extra=extra, exclude=exclude))
            except Exception:
                logger.exception("reschedule of %s failed", row["id"][:8])
                return False
        return self.admin.services.restart_train_worker(
            row["id"], extra["sub_train_job_id"], n_chips=n_chips)

    def _error_service(self, service_id: str, reason: str) -> None:
        """ERRORED through the admin's status callback, so the job's
        refresh (its end, the serving teardown, the routes' drop) runs as
        for a live failure."""
        self.report["errored"] += 1
        self._reason(f"{service_id[:8]}: ERRORED — {reason}")
        logger.warning("recovery: service %s ERRORED (%s)",
                       service_id[:8], reason)
        try:
            self._retry(
                lambda: self.admin._on_service_status(service_id, "ERRORED"),
                f"error service {service_id[:8]}")
        except Exception:
            logger.exception("could not error service %s", service_id)

    def _sweep_jobs(self, snapshot: Dict[str, Any]) -> None:
        """No job left non-terminal with no live (or rescheduled) service:
        each job's sweep retries whole (its steps are guarded transitions
        and reads)."""
        try:
            live = self._retry(
                lambda: {s["id"] for s in self.db.get_services(
                    statuses=[ServiceStatus.STARTED,
                              ServiceStatus.DEPLOYING,
                              ServiceStatus.RUNNING])},
                "live-set scan")
        except Exception:
            logger.exception("live-set scan failed; skipping the job sweep")
            return
        for kind, jobs, sweep in (
                ("train", snapshot["train_jobs"], self._sweep_one_train),
                ("inference", snapshot["inference_jobs"],
                 self._sweep_one_inference)):
            for job in jobs:
                try:
                    self._retry(lambda j=job: sweep(j, live),
                                f"sweep {kind} job {job['id'][:8]}")
                except RecoveryAborted:
                    raise
                except Exception:
                    logger.exception("%s-job sweep failed for %s", kind,
                                     job["id"])

    def _sweep_one_train(self, job: Dict[str, Any], live: set) -> None:
        self.admin.services.refresh_train_job_status(job["id"])
        fresh = self.db.get_train_job(job["id"])
        if fresh is None or fresh["status"] in _JOB_TERMINAL:
            return
        workers = self.db.get_workers_of_train_job(job["id"])
        if any(w["service_id"] in live for w in workers):
            return
        self.db.mark_train_job_as_errored(job["id"])
        self.report["jobs_closed"] += 1
        self._reason(f"train job {job['id'][:8]}: ERRORED — "
                     "orphaned by a dead admin (no live services)")

    def _sweep_one_inference(self, job: Dict[str, Any], live: set) -> None:
        self.admin.services.refresh_inference_job_status(job["id"])
        fresh = self.db.get_inference_job(job["id"])
        if fresh is None or fresh["status"] in (
                InferenceJobStatus.STOPPED, InferenceJobStatus.ERRORED):
            return
        workers = self.db.get_workers_of_inference_job(job["id"])
        if any(w["service_id"] in live for w in workers):
            return
        self.admin.services._teardown_serving(job["id"], errored=True)
        self.report["jobs_closed"] += 1
        self._reason(f"inference job {job['id'][:8]}: ERRORED — "
                     "orphaned by a dead admin (no live replicas)")

    def _persist_report(self) -> None:
        """Best effort: ``recovery.json`` (the latest) and, under a lease,
        ``recovery-e<epoch>.json``, so a promoted leader's report does not
        overwrite its predecessor's; the epoch reports are pruned."""
        try:
            from rafiki_tpu_torch.sdk.artifact import atomic_write_bytes

            path = report_path()
            os.makedirs(os.path.dirname(path), exist_ok=True)
            payload = {**self.report, "finished_at": time.time()}
            epoch = None
            lease = getattr(self.admin, "lease", None)
            if lease is not None:
                epoch = lease.last_epoch()
                payload["epoch"] = epoch
            blob = json.dumps(payload, indent=2).encode()
            atomic_write_bytes(path, blob)
            if epoch is not None:
                atomic_write_bytes(
                    os.path.join(os.path.dirname(path),
                                 f"recovery-e{int(epoch)}.json"), blob)
                self._prune_epoch_reports(os.path.dirname(path))
        except Exception:
            logger.exception("could not persist the recovery report")

    @staticmethod
    def _prune_epoch_reports(logs_dir: str) -> None:
        """Keep the newest ``RAFIKI_RECOVERY_REPORT_KEEP`` epoch reports
        (by epoch, which only grows across failovers)."""
        keep = max(int(config.RECOVERY_REPORT_KEEP), 1)
        found = []
        for name in os.listdir(logs_dir):
            m = re.fullmatch(r"recovery-e(\d+)\.json", name)
            if m:
                found.append((int(m.group(1)), name))
        for _, name in sorted(found)[:-keep]:
            try:
                os.unlink(os.path.join(logs_dir, name))
            except OSError as e:  # housekeeping: a leftover costs bytes
                logger.warning("could not prune %s: %s", name, e)
