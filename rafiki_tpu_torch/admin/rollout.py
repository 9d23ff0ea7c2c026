"""Live rollouts: a canary, an SLO judge, a rolling replace and an
automatic rollback.

Own copy of ``rafiki_tpu/admin/rollout.py``. ``Admin.update_inference_job``
moves a RUNNING inference job to another trained trial in place, under
traffic, with no outage::

    CANARY --healthy--> ROLLING --all replaced--> DONE
      |                    |
      +--SLO breach / canary crash / deploy failure or timeout--> ROLLED_BACK
    (job stopped / admin shutdown / stale row swept --> ABORTED)

- **Canary**: one new-version replica is placed beside the incumbents
  (ready only after its ``warm_up``), joins its lane before it becomes
  routable, and takes ``RAFIKI_ROLLOUT_CANARY_FRACTION`` of the requests
  (the predictor's version lanes: a request is served by one version; a
  canary failure fails over to the incumbents).
- **Judge**: over the trailing ``RAFIKI_ROLLOUT_JUDGE_WINDOW_S`` the
  canary's error rate (errors and sheds) may exceed the incumbents' by at
  most ``RAFIKI_ROLLOUT_ERR_DELTA``, and its ok p95 may be at most
  ``RAFIKI_ROLLOUT_P95_FACTOR`` times theirs (plus 5 ms). A verdict needs
  ``RAFIKI_ROLLOUT_MIN_REQUESTS`` canary requests; an idle job goes on
  after three windows with a low-traffic note.
- **Rolling**: ``RAFIKI_ROLLOUT_BATCH`` new replicas placed, as many old
  ones drained gracefully, judged again between batches; the lane's share
  follows the replica split.
- **Rollback**: the lane's share to 0, the job's cache flushed, the
  incumbents' lost capacity restored, every new-version replica drained,
  and the reason with the judge's signals on the rollout row.
- **Done**: the serving version moves to the new one, the lane is
  cleared, and every older version's cache entries are flushed.

At most one rollout a job is live; a second answers
:class:`RolloutInFlightError` (the door's 409). The autoscaler pauses on
a job mid-rollout. ``TEXT_GENERATION`` jobs roll with stream lanes (a
stream draws its lane once; a drain waits out resident streams and hands
the rest back ``MIGRATING``). :meth:`RolloutController.recover_on_boot`
resolves a dead admin's live rows (DONE when the fleet is all new, else a
rollback); crash recovery calls it (``admin/recovery.py``). The events go to the row and to :meth:`RolloutController.report`.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from typing import Any, Dict, List, Optional

from rafiki_tpu_torch import config
from rafiki_tpu_torch.constants import (
    BudgetType,
    InferenceJobStatus,
    RolloutPhase,
    ServiceStatus,
    TrialStatus,
)
from rafiki_tpu_torch.utils.metrics import REGISTRY

logger = logging.getLogger(__name__)

_TERMINAL_SVC = (ServiceStatus.STOPPED, ServiceStatus.ERRORED)
_MAX_ROW_EVENTS = 50


class RolloutError(Exception):
    """Base class for rollout control errors."""


class RolloutInFlightError(RolloutError):
    """A rollout is already in flight for this job — the HTTP door
    answers a typed 409; retry after it reaches a terminal phase (or
    abort it)."""


class _Aborted(Exception):
    """Internal: the run was told to stop (operator abort, job stopped,
    admin shutdown). ``rollback`` says whether a rollback pass should
    still run (an admin mid-shutdown tears everything down anyway)."""

    def __init__(self, reason: str, rollback: bool = True):
        super().__init__(reason)
        self.reason = reason
        self.rollback = rollback


class _Run:
    """One in-flight rollout (one background thread)."""

    def __init__(self, rollout_id: str, job_id: str, from_trial: str,
                 to_trial: str, from_version: int, to_version: int,
                 n_before: int, fraction: float, batch: int):
        self.rollout_id = rollout_id
        self.job_id = job_id
        self.from_trial = from_trial
        self.to_trial = to_trial
        self.from_version = from_version
        self.to_version = to_version
        self.n_before = n_before
        self.fraction = fraction
        self.batch = max(int(batch), 1)
        self.new_sids: List[str] = []
        self.events: List[Dict[str, Any]] = []
        self.thread: Optional[threading.Thread] = None
        self._abort_evt = threading.Event()
        self._abort_reason: Optional[str] = None
        self._abort_rollback = True

    def abort(self, reason: str, rollback: bool = True) -> None:
        self._abort_reason = reason
        self._abort_rollback = rollback
        self._abort_evt.set()

    def check_abort(self) -> None:
        if self._abort_evt.is_set():
            raise _Aborted(self._abort_reason or "aborted",
                           self._abort_rollback)

    def wait(self, timeout_s: float) -> None:
        if self._abort_evt.wait(timeout_s):
            self.check_abort()


class RolloutController:
    """One per Admin: owns every in-flight rollout run, the bounded
    event log, and the boot-time resolution of half-finished rollouts."""

    def __init__(self, admin) -> None:
        self._admin = admin
        self._services = admin.services
        self._db = admin.db
        self._lock = threading.Lock()
        self._runs: Dict[str, _Run] = {}  # guarded-by: _lock
        #: the decision log, newest last; append and snapshot race
        #: across threads
        self.events: collections.deque = (  # guarded-by: _lock
            collections.deque(maxlen=100))
        self._closed = threading.Event()
        self._m_started = REGISTRY.counter(
            "rafiki_rollout_started_total",
            "rollouts started", ("job",))
        self._m_completed = REGISTRY.counter(
            "rafiki_rollout_completed_total",
            "rollouts that reached DONE", ("job",))
        self._m_rollbacks = REGISTRY.counter(
            "rafiki_rollout_rollbacks_total",
            "rollouts automatically rolled back", ("job",))

    # -- lifecycle ----------------------------------------------------------

    def is_active(self, inference_job_id: str) -> bool:
        """True while a rollout run is in flight for the job — the
        autoscaler pauses its decisions on this (and re-windows after).
        Registration IS the in-flight signal: a run sits in ``_runs``
        from the moment :meth:`start` reserves the job until its
        thread's finally-block removes it, so a not-yet-started thread
        (the start/registration window) already counts as in flight —
        two concurrent starts can never both pass the guard."""
        with self._lock:
            return inference_job_id in self._runs

    def stop(self) -> None:
        """Admin shutdown: every run exits NOW (marked ABORTED — the
        teardown that follows destroys the fleet either way, so a
        rollback pass would only fight it)."""
        self._closed.set()
        with self._lock:
            runs = list(self._runs.values())
        for run in runs:
            run.abort("admin shutdown", rollback=False)
        for run in runs:
            if run.thread is not None:
                run.thread.join(timeout=10)

    def abort_for_job(self, inference_job_id: str, reason: str) -> None:
        """The job is being stopped: end its rollout without a rollback
        pass (the stop tears the whole fleet down) and wait it out so the
        teardown never races a mid-flight placement."""
        with self._lock:
            run = self._runs.get(inference_job_id)
        if run is None:
            return
        run.abort(reason, rollback=False)
        if run.thread is not None:
            run.thread.join(
                timeout=float(config.SERVICE_DEPLOY_TIMEOUT_S) + 10)

    # -- operator API -------------------------------------------------------

    def start(self, inference_job_id: str, to_trial_id: str,
              canary_fraction: Optional[float] = None,
              batch: Optional[int] = None) -> Dict[str, Any]:
        """Begin a rollout of ``to_trial_id`` for a RUNNING inference
        job. Raises :class:`RolloutInFlightError` (→ 409) when one is
        already live, InvalidRequestError (→ 400) on a bad target."""
        from rafiki_tpu_torch.admin.admin import InvalidRequestError

        with self._lock:
            run = self._runs.get(inference_job_id)
            if run is not None:
                raise RolloutInFlightError(
                    f"a rollout is already in flight for job "
                    f"{inference_job_id} (phase "
                    f"{self._phase_of(run)}); abort it or wait")
        # a LIVE row with no controller run is a dead admin's leftover
        # the boot pass missed (e.g. created between snapshot and crash):
        # sweep it so one stale row can never wedge the job forever
        for row in self._db.get_rollouts_by_phases(list(RolloutPhase.LIVE)):
            if row["inference_job_id"] == inference_job_id:
                self._db.mark_rollout_phase(
                    row["id"], RolloutPhase.ABORTED,
                    "stale rollout row with no controller run "
                    "(superseded)")
        inf = self._db.get_inference_job(inference_job_id)
        if inf is None or inf["status"] != InferenceJobStatus.RUNNING:
            raise InvalidRequestError(
                f"inference job {inference_job_id} is not RUNNING")
        if (inf.get("budget") or {}).get(BudgetType.ENSEMBLE_FUSED, 0):
            raise InvalidRequestError(
                "live rollouts are unsupported for ENSEMBLE_FUSED jobs: "
                "a fused worker co-locates every best trial, so there is "
                "no per-replica version to canary — redeploy instead")
        predictor = self._services.get_predictor(inference_job_id)
        if predictor is None:
            raise InvalidRequestError(
                f"inference job {inference_job_id} has no live predictor")
        live = self._services.live_inference_workers(inference_job_id)
        if not live:
            raise InvalidRequestError(
                f"inference job {inference_job_id} has no live replicas")
        trial = self._db.get_trial(to_trial_id)
        if trial is None or trial["status"] != TrialStatus.COMPLETED \
                or not trial.get("params_file_path"):
            raise InvalidRequestError(
                f"rollout target {to_trial_id} is not a COMPLETED trial "
                "with persisted params")
        sub = self._db.get_sub_train_job(trial["sub_train_job_id"])
        target_job = self._db.get_train_job(sub["train_job_id"]) \
            if sub else None
        serving_job = self._db.get_train_job(inf["train_job_id"])
        if target_job is None or serving_job is None \
                or target_job["task"] != serving_job["task"] \
                or target_job["user_id"] != serving_job["user_id"]:
            raise InvalidRequestError(
                f"rollout target {to_trial_id} does not serve this "
                "job's task (it must be a completed trial of the same "
                "task, owned by the same user)")
        if any(w["trial_id"] == to_trial_id for w in live):
            raise InvalidRequestError(
                f"job {inference_job_id} already serves trial "
                f"{to_trial_id}")
        fraction = (float(canary_fraction) if canary_fraction is not None
                    else float(config.ROLLOUT_CANARY_FRACTION))
        if not 0.0 < fraction <= 1.0:
            raise InvalidRequestError(
                f"canary_fraction {fraction} outside (0, 1]")
        from_version = max((w["model_version"] for w in live), default=0)
        to_version = from_version + 1
        # the most-replicated incumbent trial is the restore template
        by_trial: Dict[str, int] = {}
        for w in live:
            by_trial[w["trial_id"]] = by_trial.get(w["trial_id"], 0) + 1
        from_trial = max(sorted(by_trial), key=lambda t: by_trial[t])
        row = self._db.create_rollout(
            inference_job_id, from_trial, to_trial_id, from_version,
            to_version, len(live), RolloutPhase.CANARY)
        run = _Run(row["id"], inference_job_id, from_trial, to_trial_id,
                   from_version, to_version, len(live), fraction,
                   batch if batch is not None
                   else int(config.ROLLOUT_BATCH))
        with self._lock:
            if inference_job_id in self._runs:
                # a concurrent start won the race: this row never ran
                self._db.mark_rollout_phase(
                    row["id"], RolloutPhase.ABORTED,
                    "lost the start race to a concurrent rollout")
                raise RolloutInFlightError(
                    f"a rollout is already in flight for job "
                    f"{inference_job_id}")
            self._runs[inference_job_id] = run
        self._m_started.labels(inference_job_id).inc()
        self._event(run, "started",
                    detail=f"trial {from_trial[:8]} (v{from_version}) -> "
                           f"{to_trial_id[:8]} (v{to_version}), canary "
                           f"fraction {fraction:g}")
        run.thread = threading.Thread(
            target=self._run, args=(run,),
            name=f"rollout-{inference_job_id[:8]}", daemon=True)
        try:
            run.thread.start()
        except BaseException:
            # a thread that never starts would hold the in-flight
            # reservation (and its CANARY row) forever
            with self._lock:
                if self._runs.get(inference_job_id) is run:
                    del self._runs[inference_job_id]
            self._db.mark_rollout_phase(
                row["id"], RolloutPhase.ABORTED,
                "rollout thread could not start")
            raise
        return self._view(self._db.get_rollout(row["id"]))

    def status(self, inference_job_id: str) -> Optional[Dict[str, Any]]:
        """The job's newest rollout (live or terminal), with the live
        per-lane signal snapshot while one is in flight."""
        rows = self._db.get_rollouts_of_inference_job(inference_job_id)
        if not rows:
            return None
        view = self._view(rows[0])
        if view["phase"] in RolloutPhase.LIVE:
            predictor = self._services.get_predictor(inference_job_id)
            if predictor is not None:
                view["signals"] = predictor.rollout_stats(
                    float(config.ROLLOUT_JUDGE_WINDOW_S))
        return view

    def abort(self, inference_job_id: str) -> Dict[str, Any]:
        """Operator abort: a LIVE rollout rolls back (reason "operator
        abort"); a stale LIVE row with no run is marked ABORTED."""
        from rafiki_tpu_torch.admin.admin import InvalidRequestError

        with self._lock:
            run = self._runs.get(inference_job_id)
        if run is not None:
            run.abort("operator abort", rollback=True)
            thread = run.thread
            if thread is not None:
                thread.join(
                    timeout=float(config.SERVICE_DEPLOY_TIMEOUT_S)
                    + float(config.AUTOSCALE_DRAIN_S) + 10)
            return self.status(inference_job_id) or {}
        for row in self._db.get_rollouts_by_phases(list(RolloutPhase.LIVE)):
            if row["inference_job_id"] == inference_job_id:
                self._db.mark_rollout_phase(
                    row["id"], RolloutPhase.ABORTED,
                    "operator abort (no live controller run)")
                return self._view(self._db.get_rollout(row["id"]))
        raise InvalidRequestError(
            f"no rollout in flight for job {inference_job_id}")

    def ack(self, inference_job_id: str) -> Dict[str, Any]:
        """Operator acknowledgment of the newest unacked rollback —
        marks it seen."""
        from rafiki_tpu_torch.admin.admin import InvalidRequestError

        # ROLLED_BACK only: an ack landing on an unacked ABORTED row
        # would "succeed" while the rollback it was meant for stayed
        # unseen
        for row in self._db.get_rollouts_of_inference_job(
                inference_job_id):
            if row["phase"] == RolloutPhase.ROLLED_BACK \
                    and not row["operator_ack"]:
                self._db.ack_rollout(row["id"])
                return self._view(self._db.get_rollout(row["id"]))
        raise InvalidRequestError(
            f"no unacknowledged rollback for job {inference_job_id}")

    # -- the run ------------------------------------------------------------

    def _run(self, run: _Run) -> None:
        try:
            if not self._phase_canary(run):
                return  # rolled back
            if not self._phase_rolling(run):
                return
            self._finish(run)
        except _Aborted as a:
            if a.rollback:
                self._rollback(run, a.reason)
            else:
                self._event(run, "aborted", reason=a.reason)
                self._db.mark_rollout_phase(
                    run.rollout_id, RolloutPhase.ABORTED, a.reason)
        except Exception as e:
            logger.exception("rollout %s failed; rolling back",
                             run.rollout_id[:8])
            self._rollback(run, f"{type(e).__name__}: {e}")
        finally:
            with self._lock:
                if self._runs.get(run.job_id) is run:
                    del self._runs[run.job_id]

    def _check_job(self, run: _Run) -> None:
        run.check_abort()
        if self._closed.is_set():
            raise _Aborted("admin shutdown", rollback=False)
        inf = self._db.get_inference_job(run.job_id)
        if inf is None or inf["status"] != InferenceJobStatus.RUNNING:
            raise _Aborted("inference job left RUNNING mid-rollout",
                           rollback=False)

    def _phase_canary(self, run: _Run) -> bool:
        """Deploy one new-version replica, route it ``fraction`` of
        traffic, judge it over the trailing window. Returns False after
        a rollback."""
        predictor = self._services.get_predictor(run.job_id)
        deploy_deadline = time.monotonic() \
            + float(config.SERVICE_DEPLOY_TIMEOUT_S) + 5.0
        self._check_job(run)
        try:
            sid = self._services.deploy_version_replica(
                run.job_id, run.to_trial, run.to_version)
        except Exception as e:
            self._rollback(run, f"canary deploy failed: {e}")
            return False
        run.new_sids.append(sid)
        if time.monotonic() > deploy_deadline:
            self._rollback(run, "canary deploy timeout")
            return False
        # lane membership BEFORE the replica becomes routable: a request
        # landing between add_worker and the lane update would ensemble
        # the unjudged canary with the incumbents (and book its outcome
        # against the incumbent baseline). new_version keys the canary
        # lane's prediction-cache traffic apart from the incumbents'
        # (predictor/result_cache.py: a cached canary answer can never
        # leak into the incumbent lane)
        predictor.set_rollout_lane(set(run.new_sids), run.fraction,
                                   new_version=run.to_version)
        predictor.add_worker(sid, run.to_trial)
        self._event(run, "canary_deployed",
                    detail=f"replica {sid[:8]} at fraction "
                           f"{run.fraction:g}")
        window = max(float(config.ROLLOUT_JUDGE_WINDOW_S), 0.5)
        min_req = max(int(config.ROLLOUT_MIN_REQUESTS), 0)
        start = time.monotonic()
        while True:
            self._check_job(run)
            breach, signals = self._breach(run, predictor)
            if breach is not None:
                self._rollback(run, breach, signals)
                return False
            elapsed = time.monotonic() - start
            if elapsed >= window:
                stats = predictor.rollout_stats(window)
                if stats["canary"]["requests"] >= min_req:
                    self._event(run, "canary_healthy", signals=stats)
                    return True
                if elapsed >= window * 3:
                    # an idle job must still be updatable: proceed, but
                    # say the verdict rests on thin traffic
                    self._event(
                        run, "canary_low_traffic",
                        detail=f"only {stats['canary']['requests']} "
                               f"canary request(s) in {elapsed:.1f}s; "
                               "proceeding without a latency verdict",
                        signals=stats)
                    return True
            run.wait(0.1)

    def _phase_rolling(self, run: _Run) -> bool:
        """Replace the incumbents in bounded batches: place new, drain
        old, re-judge between batches. Returns False after a rollback."""
        predictor = self._services.get_predictor(run.job_id)
        self._db.mark_rollout_phase(run.rollout_id, RolloutPhase.ROLLING)
        self._event(run, "rolling", detail=f"batch size {run.batch}")
        stalls = 0
        while True:
            self._check_job(run)
            live = self._services.live_inference_workers(run.job_id)
            old = [w for w in live
                   if w["model_version"] != run.to_version]
            new = [w for w in live
                   if w["model_version"] == run.to_version]
            if not old:
                break
            # traffic share tracks the replica split through the whole
            # phase (the canary fraction only governed the CANARY phase)
            predictor.set_rollout_lane(
                set(run.new_sids),
                len(new) / max(len(old) + len(new), 1),
                new_version=run.to_version)
            # keep total capacity >= n_before: place first, then drain.
            # The canary already counts toward the n_before target, so
            # the final fleet converges to exactly the pre-rollout size
            # (and a stuck drain can never mint replicas past it)
            to_place = min(run.batch, max(0, run.n_before - len(new)))
            placed = 0
            for _ in range(to_place):
                try:
                    sid = self._services.deploy_version_replica(
                        run.job_id, run.to_trial, run.to_version)
                except Exception as e:
                    self._rollback(
                        run, f"deploy failure during rolling replace: "
                             f"{e}")
                    return False
                run.new_sids.append(sid)
                placed += 1
                # same ordering rule as the canary: the replica joins
                # the lane set before add_worker makes it routable, so
                # it can never serve (or be judged as) incumbent traffic
                predictor.set_rollout_lane(
                    set(run.new_sids),
                    (len(new) + placed)
                    / max(len(old) + len(new) + placed, 1),
                    new_version=run.to_version)
                predictor.add_worker(sid, run.to_trial)
            victims = [w["service_id"] for w in old[:run.batch]]
            _, removed = self._services.drain_replicas(
                run.job_id, victims)
            if removed or placed:
                stalls = 0
            else:
                # a drain can transiently fail under exactly the load a
                # live rollout exists for (the victim is restored to the
                # fan-out) — retry a bounded number of times before
                # declaring the replace stalled and rolling back a
                # version the judge still considers healthy
                stalls += 1
                if stalls >= 3:
                    self._rollback(
                        run, "rolling replace stalled: victims could "
                             "not be drained in 3 consecutive attempts "
                             "and the fleet is at target size")
                    return False
                run.wait(0.5)
            breach, signals = self._breach(run, predictor)
            if breach is not None:
                self._rollback(run, breach, signals)
                return False
            self._event(
                run, "batch_replaced",
                detail=f"+{placed} new / -{len(removed)} old "
                       f"({len(new) + placed} of {run.n_before} on "
                       f"v{run.to_version})")
        return True

    def _finish(self, run: _Run) -> None:
        predictor = self._services.get_predictor(run.job_id)
        if predictor is not None:
            # promote BEFORE clearing the lane: a request racing the
            # promotion either keys on the (still-set) canary lane or on
            # the already-bumped serving version — never on the replaced
            # version. The flush then drops every older version's
            # entries (the canary's own fills stay: they are the new
            # incumbent's warm start) and bumps the fill epoch so a
            # forward resolved against the replaced fleet can't land.
            predictor.set_serving_version(run.to_version)
            predictor.clear_rollout_lane()
        from rafiki_tpu_torch.predictor.result_cache import get_cache

        get_cache().flush_job(run.job_id, keep_version=run.to_version,
                              reason="rollout done")
        self._db.mark_rollout_phase(run.rollout_id, RolloutPhase.DONE)
        self._m_completed.labels(run.job_id).inc()
        self._event(run, "completed",
                    detail=f"job serves trial {run.to_trial[:8]} "
                           f"(v{run.to_version}) on "
                           f"{len(run.new_sids)} replica(s)")
        logger.warning("rollout %s DONE: job %s now serves trial %s",
                       run.rollout_id[:8], run.job_id[:8],
                       run.to_trial[:8])

    # -- the SLO judge ------------------------------------------------------

    def _breach(self, run: _Run, predictor):
        """One judge pass: (breach_reason | None, signal snapshot).
        Canary crash is a breach regardless of traffic; error-rate and
        latency verdicts need ``RAFIKI_ROLLOUT_MIN_REQUESTS`` canary
        samples in the window."""
        for sid in run.new_sids:
            svc = self._db.get_service(sid)
            if svc is None or svc["status"] in _TERMINAL_SVC:
                return (f"new-version replica {sid[:8]} "
                        f"{'vanished' if svc is None else svc['status']}",
                        None)
        window = max(float(config.ROLLOUT_JUDGE_WINDOW_S), 0.5)
        stats = predictor.rollout_stats(window)
        can, inc = stats["canary"], stats["incumbent"]
        if can["requests"] < max(int(config.ROLLOUT_MIN_REQUESTS), 1):
            return None, stats
        can_rate = (can["errors"] + can["shed"]) / can["requests"]
        inc_rate = ((inc["errors"] + inc["shed"]) / inc["requests"]
                    if inc["requests"] else 0.0)
        delta = float(config.ROLLOUT_ERR_DELTA)
        if can_rate - inc_rate > delta:
            return (f"canary error rate {can_rate:.0%} exceeds incumbent "
                    f"{inc_rate:.0%} by more than {delta:.0%}", stats)
        factor = float(config.ROLLOUT_P95_FACTOR)
        if can["p95_s"] is not None and inc["p95_s"] is not None \
                and can["p95_s"] > inc["p95_s"] * factor + 0.005:
            return (f"canary p95 {can['p95_s'] * 1000:.0f}ms exceeds "
                    f"{factor:g}x incumbent p95 "
                    f"{inc['p95_s'] * 1000:.0f}ms", stats)
        return None, stats

    # -- rollback -----------------------------------------------------------

    def _rollback(self, run: _Run, reason: str,
                  signals: Optional[Dict[str, Any]] = None) -> None:
        logger.warning("rollout %s ROLLING BACK job %s: %s",
                       run.rollout_id[:8], run.job_id[:8], reason)
        self._event(run, "rollback", reason=reason, signals=signals)
        self._rollback_fleet(run.job_id, run.to_version, run.from_trial,
                             run.from_version, run.n_before, run.new_sids)
        self._db.mark_rollout_phase(
            run.rollout_id, RolloutPhase.ROLLED_BACK, reason)
        self._m_rollbacks.labels(run.job_id).inc()

    def _rollback_fleet(self, job_id: str, to_version: int,
                        from_trial: str, from_version: int,
                        n_before: int, new_sids: List[str]) -> None:
        """Restore the incumbent fleet: traffic off the new version
        first, incumbent capacity restored, then every new-version
        replica gracefully drained. Shared by live rollbacks and the
        boot-time resolution of a crashed admin's half-finished rollout."""
        predictor = self._services.get_predictor(job_id)
        if predictor is not None and new_sids:
            predictor.set_rollout_lane(set(new_sids), 0.0)
        # every cached answer of the aborted version dies NOW — before
        # the restore places replicas — and the epoch bump drops fills
        # from forwards still in flight against it. Full flush (not
        # keep_version): rollbacks are rare, and a cold cache is cheaper
        # than reasoning about which incumbent entries survived the
        # churn. A later rollout REUSES this to_version number, so its
        # entries must be provably gone (predictor/result_cache.py).
        from rafiki_tpu_torch.predictor.result_cache import get_cache

        get_cache().flush_job(job_id, reason="rollback")
        live = self._services.live_inference_workers(job_id)
        old_live = [w for w in live if w["model_version"] != to_version]
        deficit = n_before - len(old_live)
        by_trial: Dict[str, int] = {}
        for w in old_live:
            by_trial[w["trial_id"]] = by_trial.get(w["trial_id"], 0) + 1
        for _ in range(max(deficit, 0)):
            trial = (min(sorted(by_trial), key=lambda t: by_trial[t])
                     if by_trial else from_trial)
            try:
                sid = self._services.deploy_version_replica(
                    job_id, trial, from_version)
            except Exception:
                # incumbents still serve, just thinner — the autoscaler
                # (resumed after this rollout ends) can regrow them
                logger.exception(
                    "rollback: could not restore an incumbent replica "
                    "of %s for job %s", trial[:8], job_id[:8])
                break
            by_trial[trial] = by_trial.get(trial, 0) + 1
            if predictor is not None:
                predictor.add_worker(sid, trial)
        still_live = {w["service_id"]
                      for w in self._services.live_inference_workers(
                          job_id)}
        victims = [s for s in new_sids if s in still_live]
        if victims:
            try:
                self._services.drain_replicas(job_id, victims)
            except Exception:
                logger.exception(
                    "rollback: draining new-version replicas of job %s "
                    "failed", job_id[:8])
        if predictor is not None:
            # pin the cache key back to the restored generation: a
            # predictor ADOPTED over a mixed mid-rollout fleet read its
            # serving version off the worker rows' max — which is the
            # version this rollback just retired (live rollbacks no-op:
            # only _finish ever bumps the serving version)
            predictor.set_serving_version(from_version)
            predictor.clear_rollout_lane()

    # -- boot-time resolution ----------------------------------------------

    def recover_on_boot(self) -> None:
        """Resolve every rollout a dead admin left in a LIVE phase —
        never strand one. The adopted fleet's worker rows carry each
        replica's model_version, so the verdict is mechanical: all
        replicas already new-version → the rolling phase had finished,
        mark DONE; any incumbents left → roll back (the judge's window
        died with the old admin, and a half-judged version must not keep
        taking traffic on a restarted control plane's watch)."""
        for row in self._db.get_rollouts_by_phases(list(RolloutPhase.LIVE)):
            job_id = row["inference_job_id"]
            try:
                inf = self._db.get_inference_job(job_id)
                if inf is None \
                        or inf["status"] != InferenceJobStatus.RUNNING:
                    self._db.mark_rollout_phase(
                        row["id"], RolloutPhase.ABORTED,
                        "inference job not RUNNING after control-plane "
                        "restart")
                    continue
                live = self._services.live_inference_workers(job_id)
                old = [w for w in live
                       if w["model_version"] != row["to_version"]]
                new = [w for w in live
                       if w["model_version"] == row["to_version"]]
                if new and not old:
                    self._db.mark_rollout_phase(
                        row["id"], RolloutPhase.DONE,
                        "completed by recovery: the fleet was already "
                        "fully on the new version")
                    self._log_event(
                        job_id, row["id"], "completed",
                        reason="resumed as done by recovery")
                    continue
                reason = ("control-plane restart mid-rollout: rolled "
                          "back to the incumbent version")
                self._log_event(job_id, row["id"], "rollback",
                                reason=reason)
                self._rollback_fleet(
                    job_id, row["to_version"], row["from_trial_id"],
                    row["from_version"], int(row["n_replicas_before"]),
                    [w["service_id"] for w in new])
                self._db.mark_rollout_phase(
                    row["id"], RolloutPhase.ROLLED_BACK, reason)
                self._m_rollbacks.labels(job_id).inc()
            except Exception:
                logger.exception(
                    "boot-time rollout resolution failed for %s "
                    "(job %s)", row["id"][:8], job_id[:8])

    # -- observability ------------------------------------------------------

    def _phase_of(self, run: _Run) -> str:
        row = self._db.get_rollout(run.rollout_id)
        return row["phase"] if row else "?"

    def _event(self, run: _Run, name: str, detail: Optional[str] = None,
               reason: Optional[str] = None,
               signals: Optional[Dict[str, Any]] = None) -> None:
        event = {"ts": time.time(), "job_id": run.job_id,
                 "rollout_id": run.rollout_id, "event": name}
        if detail:
            event["detail"] = detail
        if reason:
            event["reason"] = reason
        if signals:
            event["signals"] = signals
        run.events.append(event)
        with self._lock:
            self.events.append(event)
        try:
            self._db.update_rollout_events(
                run.rollout_id, run.events[-_MAX_ROW_EVENTS:])
        except Exception:
            logger.exception("persisting rollout event failed")

    def _log_event(self, job_id: str, rollout_id: str, name: str,
                   reason: Optional[str] = None) -> None:
        event = {"ts": time.time(), "job_id": job_id,
                 "rollout_id": rollout_id, "event": name}
        if reason:
            event["reason"] = reason
        with self._lock:
            self.events.append(event)
        try:
            row = self._db.get_rollout(rollout_id)
            events = (row["events"] if row else []) + [event]
            self._db.update_rollout_events(
                rollout_id, events[-_MAX_ROW_EVENTS:])
        except Exception:
            logger.exception("persisting rollout event failed")

    @staticmethod
    def _view(row: Optional[Dict[str, Any]]) -> Dict[str, Any]:
        if row is None:
            return {}
        return {
            "id": row["id"],
            "inference_job_id": row["inference_job_id"],
            "from_trial_id": row["from_trial_id"],
            "to_trial_id": row["to_trial_id"],
            "from_version": row["from_version"],
            "to_version": row["to_version"],
            "n_replicas_before": row["n_replicas_before"],
            "phase": row["phase"],
            "reason": row["reason"],
            "operator_ack": row["operator_ack"],
            "events": row["events"],
            "datetime_started": row["datetime_started"],
            "datetime_stopped": row["datetime_stopped"],
        }

    def report(self) -> Dict[str, Any]:
        """Every in-flight rollout with its live lane signals, and the
        recent events (rollback reasons and signal snapshots ride
        here)."""
        with self._lock:
            active_jobs = dict(self._runs)
            recent = list(self.events)[-20:]
        active: Dict[str, Any] = {}
        for job_id, run in active_jobs.items():
            entry = {
                "rollout_id": run.rollout_id,
                "phase": self._phase_of(run),
                "to_trial_id": run.to_trial,
                "to_version": run.to_version,
                "canary_fraction": run.fraction,
            }
            predictor = self._services.get_predictor(job_id)
            if predictor is not None:
                entry["signals"] = predictor.rollout_stats(
                    float(config.ROLLOUT_JUDGE_WINDOW_S))
            active[job_id] = entry
        return {"active": active, "events": recent}
