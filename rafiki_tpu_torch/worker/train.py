"""Train worker: the AutoML trial loop.

Own copy of ``rafiki_tpu/worker/train.py``'s scalar trial loop. Read the
sub-train-job, its job and model, load the template class, open the
sub-train-job's advisor session; rebuild the poison-knob quarantine from
the trial rows, replay the scored and infeasible rows into a fresh
advisor, and re-run the trials a killed predecessor of this service left
RUNNING (same id, knobs and attempt; a template that hands
``checkpoint_path`` to ``fit`` resumes from its last epoch), or terminate
them once the job's deadline has passed. Then, until the stop event, the
trial budget (``MODEL_TRIAL_COUNT``) or the job's ``TIME_HOURS``
deadline: propose knobs clear of the quarantine, reserve a trial row
atomically, ``Model(**knobs).train(train_uri)``, ``evaluate(test_uri)``
through the score gate, write the params artifact (atomic, checksummed),
log the "trial phase breakdown" (train, evaluate and persist_params
seconds), feed the score back and only then mark the trial COMPLETED.

In flight, each metrics report is a stop check: the trial's wall cap
(budget ``TRIAL_TIMEOUT_S``), the job's ``TIME_HOURS`` deadline, and with
``EARLY_STOP`` ASHA's rung verdict on the per-epoch ``loss``
(``ASHA_MIN_EPOCHS``, default 1; ``ASHA_ETA``, default 3); a stopped
trial is evaluated and completes with its truncated training.

Failures run through the fault taxonomy (``worker/faults.py``):
infra-class kinds re-run under the same trial id with jittered backoff
(``RAFIKI_TRIAL_RETRY_MAX``), no budget slot consumed; terminal kinds
ERROR the trial with its kind and traceback, and the infeasible ones
(and terminal MEM) feed the advisor an infeasible observation and count
toward the quarantine (``RAFIKI_TRIAL_QUARANTINE_K``); consecutive
user-class faults (``RAFIKI_TRIAL_FAULT_LIMIT``) error the job and send
:data:`EVENT_TRIAL_FAULT_LIMIT`. After a fault the failing frames (which
hold the trial's device tensors) are dropped and the allocator's cache
emptied before the next attempt or trial. A stop that lands mid-trial
marks it TERMINATED. When the budget is spent the worker sends
:data:`EVENT_BUDGET_REACHED` to the admin and returns.

A worker granted several devices (budget ``CHIPS_PER_TRIAL``) trains each
trial over all of them: it is rank 0 of a data group
(``parallel/ranks.py``) whose followers, one process a device, run the
same template calls on their own devices while rank 0 alone talks to the
store and the advisor. It starts its ranks once, keeps them for all its
trials, and starts them again after a fault broke them (a follower's
exception comes back here and is classified as rank 0's own would be; a
dead or silent follower is an INFRA fault).

Vectorized trials: when the template declares a fully wired
``PopulationSpec`` (``sdk/model.population_capability``), populations are
on (``RAFIKI_TRIAL_VMAP``, default 1), K >= 2 (the budget's
``TRIAL_VMAP_K``, else ``RAFIKI_TRIAL_VMAP_K``, default 4) and the spec's
dynamic knobs are all in the knob config, each round drains up to K
proposals in one advisor call (clamped by the budget left and the spec's
``max_members``), buckets them by their other knobs
(``worker/vmap_partition.py``), reserves a trial row a member
(``reserve_trial`` stays the only authority over the budget) and trains
each bucket of two or more as one ``train_population`` call, then
settles every member's row on its own: its score, its params artifact,
its feedback; a member whose score is not finite is an INVALID_SCORE
fault with infeasible feedback for it alone. A failure of the batch
re-runs every member as a scalar trial under its id. ASHA's rungs are
reported a member (``member{k}_loss``), the batch stops when every
member's verdict says stop, and ``TRIAL_TIMEOUT_S`` and the job's
deadline stop the batch. Over several devices the batch runs on the
ranks as a scalar trial does.

The sandbox (``RAFIKI_SANDBOX=1``, read at each trial): the template
runs in a locked-down child (``sdk/sandbox.py``) on this worker's
devices (over its own ranks on a grant of several), and this side
forwards its log lines, applies the same stop checks, sends STOP, writes
the params it returns and maps its failures to their kinds (the
watchdogs' STALL and TIMEOUT among them). The trial's jail holds its
checkpoint. Populations run scalar under the sandbox (one child a
trial). A template's declared dependencies are checked before it loads
(``sdk/deps.py``).

A drift retrain's warm start happens before its services start
(``Admin.create_train_job(warm_start_from=)``): the replay below finds
the session fed and does nothing.

Tracing (``utils/trace.py``): each trial's ``propose``, ``train``,
``evaluate`` and ``persist_params`` spans are saved under its id
(``GET /trials/<id>/trace``) and summed into the "trial phase breakdown"
log line; under ``RAFIKI_PROFILE`` the ``train`` span runs inside a
``torch.profiler`` capture, written as
``LOGS_DIR/profiles/trial-<id>-<pid>.json`` (on several devices, rank
0's).

Not ported (ROADMAP.md): the compile cache and dependency installs.
"""

from __future__ import annotations

import glob
import logging
import os
import random
import shutil
import time
import traceback
from typing import Any, Callable, Dict, Optional

from rafiki_tpu_torch import config
from rafiki_tpu_torch.advisor.advisor import AdvisorStore
from rafiki_tpu_torch.constants import BudgetType, TrialStatus
from rafiki_tpu_torch.db.database import Database
from rafiki_tpu_torch.device import ServiceContext, set_device_grant
from rafiki_tpu_torch.parallel.ranks import (
    Ranks,
    in_step,
    release_device_memory,
    set_group,
)
from rafiki_tpu_torch.sdk import sandbox
from rafiki_tpu_torch.sdk.artifact import write_artifact
from rafiki_tpu_torch.sdk.deps import activate_prefix, ensure_dependencies
from rafiki_tpu_torch.sdk.log import ModelLogger, StopTrialEarly
from rafiki_tpu_torch.sdk.model import (
    load_model_class,
    population_capability,
)
from rafiki_tpu_torch.sdk.params import dump_params
from rafiki_tpu_torch.utils import chaos
from rafiki_tpu_torch.utils.trace import Tracer, torch_profile
from rafiki_tpu_torch.worker import faults
from rafiki_tpu_torch.worker.faults import (
    FaultKind,
    TrialChaosError,
    validate_score,
)
from rafiki_tpu_torch.worker.vmap_partition import partition_for_vmap

logger = logging.getLogger(__name__)

#: sent when the sub-train-job's budget is spent; payload: train_job_id,
#: sub_train_job_id
EVENT_BUDGET_REACHED = "sub_train_job_budget_reached"

#: sent when RAFIKI_TRIAL_FAULT_LIMIT consecutive user-class faults tripped
#: the job's fail-fast; payload: train_job_id, sub_train_job_id,
#: fault_kind, reason. The admin errors the job and stops its services.
EVENT_TRIAL_FAULT_LIMIT = "sub_train_job_fault_limit"

EventFn = Callable[[str, Dict[str, Any]], None]


def _save_trace(tracer: Tracer, trial_logger: ModelLogger, message: str,
                **fields: Any) -> None:
    """Save the trial's spans and log their sums by name. Diagnostics
    only: a failure here never fails the trial or hides its fault."""
    try:
        tracer.save()
        trial_logger.log(message, **fields, **{
            f"trace_{k}_s": round(v, 4)
            for k, v in tracer.summary().items()})
    except Exception:
        logger.exception("failed to persist trial trace %s",
                         tracer.trace_id)


class TrainWorker:
    """One trial executor for a sub-train-job."""

    def __init__(self, sub_train_job_id: str, db: Database,
                 advisor_store: AdvisorStore,
                 send_event: Optional[EventFn] = None,
                 params_dir: Optional[str] = None):
        self._sub_id = sub_train_job_id
        self._db = db
        self._advisors = advisor_store
        self._send_event = send_event or (lambda name, payload: None)
        self._params_dir = params_dir or config.PARAMS_DIR
        # observations whose feedback failed, awaiting retry; bounded
        # (RAFIKI_PENDING_FEEDBACK_MAX, the oldest drop)
        self._pending_feedback: list = []
        self._feedback_drop_warned = False
        # poison-knob quarantine, rebuilt from the rows at startup (so it
        # survives a restart), and the consecutive user-fault streak, in
        # memory on purpose: a restart gathers fresh evidence
        self._knob_config = None
        self._quarantine: set = set()
        self._user_fault_sigs: Dict[str, int] = {}
        self._fault_streak = 0
        # in-flight stop conditions, set from the job's budget in _loop
        self._early_stop = False
        self._asha_min = 1
        self._asha_eta = 3
        self._job_deadline: Optional[float] = None
        self._trial_timeout_s: Optional[float] = None
        # the template, for the followers of a several-device grant
        self._model_row: Optional[Dict[str, Any]] = None
        self._ranks: Optional[Ranks] = None
        self._devices: list = []
        # vectorized trials: the template's spec when they are on, and K
        self._pop_spec = None
        self._vmap_k = 0
        # the template's dependency prefix, for a sandbox child's path
        self._deps_prefix: Optional[str] = None

    def start(self, ctx: ServiceContext) -> None:
        """The trial loop, in the calling thread, on the devices ``ctx``
        grants; returns when the budget is spent or ``ctx`` stops."""
        set_device_grant(ctx.chips)
        self._devices = list(ctx.chips)
        try:
            self._loop(ctx)
        finally:
            self._close_ranks()
            set_device_grant(None)

    def _ensure_ranks(self) -> Optional[Ranks]:
        """The ranks of a several-device grant, started (again, when a
        fault broke them) before a trial's attempt; None on one device.
        A start that fails is the platform's fault (INFRA). Under the
        sandbox the trial's child starts its own ranks."""
        if len(self._devices) < 2 or sandbox.sandbox_enabled():
            return None
        if self._ranks is not None and not self._ranks.broken:
            return self._ranks
        self._close_ranks()
        try:
            self._ranks = Ranks(self._devices)
        except Exception as e:
            raise faults.TrialFault(
                f"the ranks on {self._devices} did not start: "
                f"{type(e).__name__}: {e}", kind=FaultKind.INFRA) from e
        set_group(self._ranks.group)
        return self._ranks

    def _close_ranks(self) -> None:
        if self._ranks is not None:
            set_group(None)
            self._ranks.close()
            self._ranks = None

    def _loop(self, ctx: ServiceContext) -> None:
        sub = self._db.get_sub_train_job(self._sub_id)
        if sub is None:
            raise KeyError(f"no sub_train_job {self._sub_id}")
        job = self._db.get_train_job(sub["train_job_id"])
        model = self._db.get_model(sub["model_id"])
        budget = job["budget"]
        max_trials = int(budget.get(BudgetType.MODEL_TRIAL_COUNT,
                                    config.DEFAULT_TRIAL_COUNT))
        hours = budget.get(BudgetType.TIME_HOURS)
        deadline = (job["datetime_started"] + float(hours) * 3600
                    if hours is not None else None)
        self._early_stop = bool(budget.get(BudgetType.EARLY_STOP, False))
        self._asha_min = int(budget.get(BudgetType.ASHA_MIN_EPOCHS, 1))
        self._asha_eta = int(budget.get(BudgetType.ASHA_ETA, 3))
        self._job_deadline = deadline
        tt = budget.get(BudgetType.TRIAL_TIMEOUT_S)
        self._trial_timeout_s = float(tt) if tt is not None else None
        chaos.enabled()  # a rule at an unhooked site refuses the start
        # a missing dependency fails the executor before the template loads
        self._deps_prefix = ensure_dependencies(model.get("dependencies"))
        activate_prefix(self._deps_prefix)
        clazz = load_model_class(model["model_file_bytes"],
                                 model["model_class"])
        self._model_row = model
        knob_config = clazz.get_knob_config()
        # vectorized trials: every gate below leaves the scalar path as is
        self._pop_spec = population_capability(clazz)
        vk = budget.get(BudgetType.TRIAL_VMAP_K)
        self._vmap_k = int(vk) if vk is not None else int(config.TRIAL_VMAP_K)
        if self._pop_spec is not None:
            if not config.TRIAL_VMAP:
                self._pop_spec = None  # the operator's kill switch
            elif self._vmap_k < 2:
                self._pop_spec = None  # a population of one is a trial
            elif sandbox.sandbox_enabled():
                # one sandbox child a trial; a population shares one process
                logger.info("RAFIKI_SANDBOX=1: vectorized trial execution "
                            "disabled; trials run scalar in children")
                self._pop_spec = None
            elif not set(self._pop_spec.dynamic_knobs) <= set(knob_config):
                logger.warning(
                    "population_spec dynamic knobs %s are not all in the "
                    "knob config %s; trials run scalar",
                    self._pop_spec.dynamic_knobs, sorted(knob_config))
                self._pop_spec = None
        # one advisor session per sub-train-job, shared by its workers
        advisor_id = self._advisors.create_advisor(
            knob_config, advisor_id=self._sub_id)
        self._db.update_sub_train_job_advisor(self._sub_id, advisor_id)
        self._ensure_ranks()  # once, for all the trials
        ctx.ready()  # job read and template loaded: startup succeeded

        all_trials = self._db.get_trials_of_sub_train_job(self._sub_id)
        # the quarantine, from the recorded poison faults: a restart must
        # not spend fresh budget re-learning which region crashes
        self._knob_config = knob_config
        self._user_fault_sigs = faults.poison_signature_counts(
            all_trials, knob_config)
        k = max(int(config.TRIAL_QUARANTINE_K), 1)
        self._quarantine = {s for s, n in self._user_fault_sigs.items()
                            if n >= k}
        if self._quarantine:
            faults.record_quarantine(self._sub_id, self._quarantine)
            logger.warning("%d poison-knob signature(s) quarantined from "
                           "recorded trial faults", len(self._quarantine))

        # a fresh advisor session (its process died too) is rebuilt from
        # the rows; atomic and empty-only on the store's side, so restarted
        # siblings cannot feed it twice
        scored = [(t["knobs"], t["score"]) for t in all_trials
                  if t["status"] == TrialStatus.COMPLETED
                  and t["score"] is not None]
        infeasible = [(t["knobs"], t["fault_kind"]) for t in all_trials
                      if faults.is_infeasible_row(t)]
        if scored or infeasible:
            try:
                if self._advisors.replay_feedback(advisor_id, scored,
                                                  infeasible=infeasible):
                    logger.info("replayed %d completed + %d infeasible "
                                "trials into advisor %s", len(scored),
                                len(infeasible), advisor_id)
            except Exception:
                logger.warning("advisor replay failed; proposals start from "
                               "the prior", exc_info=True)

        # trials a killed predecessor of this service left RUNNING (a
        # restarted worker keeps its service id) re-run under the same id
        # and knobs, resuming from their checkpoints
        for stale in all_trials:
            if ctx.stopping:
                return
            if (stale["status"] != TrialStatus.RUNNING
                    or stale["worker_id"] != ctx.service_id):
                continue
            if deadline is not None and time.time() >= deadline:
                # the time budget ran out while it was down: it will never
                # run, so its slot is released
                logger.info("time budget spent; terminating stale trial %s",
                            stale["id"])
                self._db.mark_trial_as_terminated(stale["id"])
                self._cleanup_ckpt(stale["id"])
                continue
            logger.info("resuming stale trial %s after worker restart",
                        stale["id"])
            if not self._execute_trial(
                    ctx, clazz, job, advisor_id, stale["id"], stale["knobs"],
                    start_attempt=int(stale.get("attempt") or 0)):
                return

        while not ctx.stopping:
            over_time = deadline is not None and time.time() >= deadline
            if self._pop_spec is not None and not over_time:
                verdict = self._population_round(ctx, clazz, job, model,
                                                 advisor_id, max_trials)
                if verdict == "stop":
                    return
                if verdict == "budget":
                    logger.info("sub-train-job %s: budget spent",
                                self._sub_id)
                    self._send_event(EVENT_BUDGET_REACHED, {
                        "sub_train_job_id": self._sub_id,
                        "train_job_id": job["id"]})
                    return
                continue
            trial = None
            tracer = Tracer("pending")
            if not over_time:
                with tracer.span("propose"):
                    try:
                        self._retry_pending_feedback(advisor_id)
                    except Exception:
                        logger.warning("pending feedback retry failed; "
                                       "proposing without it",
                                       exc_info=True)
                    knobs = self._propose_clear_of_quarantine(advisor_id)
                trial = self._db.reserve_trial(
                    self._sub_id, model["id"], knobs,
                    worker_id=ctx.service_id, max_trials=max_trials)
            if trial is None:
                logger.info("sub-train-job %s: budget spent", self._sub_id)
                self._send_event(EVENT_BUDGET_REACHED, {
                    "sub_train_job_id": self._sub_id,
                    "train_job_id": job["id"]})
                return
            tracer.trace_id = trial["id"]
            if not self._execute_trial(ctx, clazz, job, advisor_id,
                                       trial["id"], knobs, tracer=tracer):
                return

    def _execute_trial(self, ctx: ServiceContext, clazz: type,
                       job: Dict[str, Any], advisor_id: str, trial_id: str,
                       knobs: Dict[str, Any], start_attempt: int = 0,
                       tracer: Optional[Tracer] = None) -> bool:
        """Run one trial and record its outcome, retrying infra-class
        faults under the same id. Returns False when the worker leaves its
        loop: stopping (the trial is then TERMINATED) or the job's
        fail-fast."""
        trial_logger = ModelLogger()
        trial_logger.set_sink(
            lambda line: self._db.add_trial_log(trial_id, line))
        # one tracer over the attempts: a retried trial's spans add up
        tracer = tracer or Tracer(trial_id)
        retry_max = max(int(config.TRIAL_RETRY_MAX), 0)
        attempt = max(int(start_attempt), 0)
        while True:
            # a fresh stop check per attempt: TRIAL_TIMEOUT_S measures this
            # run of the template, not the sum of the retries
            self._install_stop_check(trial_logger, advisor_id, trial_id)
            try:
                self._chaos_trial(trial_id)
                ranks = self._ensure_ranks()
                score, params_path = self._run_trial(
                    clazz, knobs, job, trial_id, trial_logger, ranks,
                    tracer=tracer)
                # feedback BEFORE mark-complete: a trial visible as
                # COMPLETED has its observation in the advisor, so a
                # restarted sibling's empty-only replay cannot feed it
                # twice; a stop that lands after the work finished keeps
                # the result and only ends the loop
                self._feedback_best_effort(advisor_id, knobs, score)
                self._db.mark_trial_as_complete(trial_id, score, params_path)
                self._fault_streak = 0
                faults.record_counter(self._sub_id,
                                      "consecutive_user_faults", 0,
                                      absolute=True)
                return not ctx.stopping
            except Exception as e:
                if ctx.stopping:
                    self._db.mark_trial_as_terminated(trial_id)
                    self._cleanup_ckpt(trial_id)
                    return False
                kind, detail = faults.classify_failure(e)
            # out of the except block, the exception and its frames (the
            # trial's tensors, a device OOM's activations) are unreachable;
            # broken ranks go (their processes take their memory with them)
            # and start again before the next attempt
            if self._ranks is not None and self._ranks.broken:
                self._close_ranks()
            release_device_memory()
            logger.error("trial %s fault %s (attempt %d):\n%s",
                         trial_id, kind, attempt, detail)
            if kind in faults.RETRYABLE_KINDS and attempt < retry_max:
                # the attempt counter lives on the row, so the bound holds
                # across worker restarts too
                attempt = self._db.record_trial_fault(trial_id, kind, detail)
                faults.record_fault(self._sub_id, kind, retried=True)
                trial_logger.set_stop_check(None)
                self._retry_backoff(ctx, attempt)
                if ctx.stopping:
                    self._db.mark_trial_as_terminated(trial_id)
                    self._cleanup_ckpt(trial_id)
                    return False
                logger.info("retrying trial %s (attempt %d/%d) after %s "
                            "fault", trial_id, attempt, retry_max, kind)
                continue
            self._db.mark_trial_as_errored(trial_id, kind, detail)
            self._cleanup_ckpt(trial_id)
            faults.record_fault(self._sub_id, kind)
            if kind in faults.INFEASIBLE_KINDS or kind == FaultKind.MEM:
                # terminal MEM is knob-driven too: it steers the advisor
                # and counts toward the quarantine, but only user-class
                # kinds march the fail-fast streak (MEM on distinct knobs
                # reads as host pressure, not a broken template)
                self._feedback_infeasible_best_effort(
                    advisor_id, knobs, kind, trial_id=trial_id)
                if not self._note_user_fault(
                        job, trial_id, knobs, kind,
                        streak=kind in faults.INFEASIBLE_KINDS):
                    return False
            return True

    def _chaos_trial(self, trial_id: str) -> None:
        """``RAFIKI_CHAOS`` site=trial: the drillable fault chokepoint,
        one ask per attempt."""
        rule = chaos.hit(chaos.SITE_TRIAL, f"{self._sub_id} {trial_id}")
        if rule is None:
            return
        if rule.action == chaos.ACTION_DELAY:
            chaos.sleep_for(rule)
            return
        if rule.action == chaos.ACTION_OOM:
            raise MemoryError("chaos-injected trial OOM (site=trial)")
        raise TrialChaosError(
            "chaos-injected transient trial fault (site=trial)")

    def _retry_backoff(self, ctx: ServiceContext, attempt: int) -> None:
        """Exponential backoff with full jitter (uniform in [0, min(base *
        2^(n-1), 30 s)]), waiting on the stop event."""
        base = max(float(config.TRIAL_RETRY_BACKOFF_S), 0.0)
        ceiling = min(base * (2 ** max(attempt - 1, 0)), 30.0)
        if ceiling > 0:
            ctx.stop_event.wait(random.uniform(0, ceiling))

    def _note_user_fault(self, job: Dict[str, Any], trial_id: str,
                         knobs: Dict[str, Any], kind: str,
                         streak: bool = True) -> bool:
        """Quarantine and fail-fast bookkeeping after a terminal poison
        fault; ``streak=False`` (terminal MEM) counts toward the quarantine
        only. Returns False when the fault limit tripped and the job was
        errored."""
        sig = faults.knob_signature(self._knob_config, knobs)
        self._user_fault_sigs[sig] = self._user_fault_sigs.get(sig, 0) + 1
        k = max(int(config.TRIAL_QUARANTINE_K), 1)
        if self._user_fault_sigs[sig] >= k and sig not in self._quarantine:
            self._quarantine.add(sig)
            faults.record_quarantine(self._sub_id, [sig])
            logger.warning(
                "knob signature %s quarantined after %d poison faults "
                "(RAFIKI_TRIAL_QUARANTINE_K=%d); matching proposals will be "
                "re-proposed", sig, self._user_fault_sigs[sig], k)
        if not streak:
            return True
        self._fault_streak += 1
        faults.record_counter(self._sub_id, "consecutive_user_faults",
                              self._fault_streak, absolute=True)
        limit = int(config.TRIAL_FAULT_LIMIT)
        if limit <= 0 or self._fault_streak < limit:
            return True
        reason = (
            f"{self._fault_streak} consecutive user-class trial faults "
            f"(RAFIKI_TRIAL_FAULT_LIMIT={limit}); last: {kind} on trial "
            f"{trial_id} — template broken at every proposed knob "
            f"combination, failing the job early instead of burning the "
            f"remaining budget")
        logger.error("train job %s fail-fast: %s", job["id"], reason)
        # the typed reason goes on the row here (it works headless), then
        # the admin is told so it stops sibling workers; the guarded
        # transition makes the second mark harmless
        self._db.mark_train_job_as_errored(job["id"], FaultKind.USER, reason)
        self._send_event(EVENT_TRIAL_FAULT_LIMIT, {
            "train_job_id": job["id"],
            "sub_train_job_id": self._sub_id,
            "fault_kind": FaultKind.USER,
            "reason": reason,
        })
        return False

    def _propose_clear_of_quarantine(self, advisor_id: str,
                                     knobs: Optional[Dict[str, Any]] = None
                                     ) -> Dict[str, Any]:
        """Propose knobs, re-proposing (at most RAFIKI_TRIAL_REPROPOSE_MAX
        times) while the draw matches a quarantined signature. Each
        rejection feeds the advisor an infeasible point there, so the
        GP's penalty grows until it stops proposing the region; past the
        bound the last draw is accepted, so a mostly quarantined space
        degrades to slow progress, never to a spinning worker."""
        if knobs is None:
            knobs = self._advisors.propose(advisor_id)
        if not self._quarantine:
            return knobs
        limit = max(int(config.TRIAL_REPROPOSE_MAX), 0)
        for rejections in range(limit + 1):
            sig = faults.knob_signature(self._knob_config, knobs)
            if sig not in self._quarantine:
                return knobs
            if rejections == limit:
                break
            faults.record_counter(self._sub_id, "reproposals")
            logger.info("proposal matches quarantined signature %s; "
                        "re-proposing", sig)
            self._feedback_infeasible_best_effort(advisor_id, knobs,
                                                  FaultKind.USER)
            knobs = self._advisors.propose(advisor_id)
        logger.warning(
            "proposal still quarantined after %d re-proposals "
            "(RAFIKI_TRIAL_REPROPOSE_MAX); accepting it — most of the "
            "search space may be poisoned", limit)
        return knobs

    def _feedback_best_effort(self, advisor_id: str, knobs: Dict[str, Any],
                              score: float) -> None:
        """Feed a score to the advisor; a failure never costs the finished
        trial its result: the observation is queued and retried before
        later proposals (replay seeds only empty sessions, so it cannot
        recover it), in a bounded queue."""
        try:
            self._retry_pending_feedback(advisor_id)
            self._advisors.get(advisor_id).feedback(knobs, score)
        except Exception:
            self._pending_feedback.append((knobs, score))
            logger.warning(
                "advisor feedback failed for %s (queued for retry):\n%s",
                advisor_id, traceback.format_exc())
            cap = max(int(config.PENDING_FEEDBACK_MAX), 1)
            if len(self._pending_feedback) > cap:
                dropped = len(self._pending_feedback) - cap
                del self._pending_feedback[:dropped]
                faults.record_counter(self._sub_id, "feedback_dropped",
                                      dropped)
                if not self._feedback_drop_warned:
                    self._feedback_drop_warned = True
                    logger.warning(
                        "pending advisor feedback exceeded "
                        "RAFIKI_PENDING_FEEDBACK_MAX=%d; dropping oldest "
                        "observations (warning once; drops counted in "
                        "training stats)", cap)

    def _feedback_infeasible_best_effort(self, advisor_id: str,
                                         knobs: Dict[str, Any], kind: str,
                                         trial_id: Optional[str] = None
                                         ) -> None:
        """A penalty point is advisory: one that cannot be delivered is
        logged and dropped, never queued."""
        try:
            self._advisors.feedback_infeasible(advisor_id, knobs, kind=kind,
                                               trial_id=trial_id)
        except Exception:
            logger.warning("infeasible feedback for %s dropped",
                           advisor_id, exc_info=True)

    def _install_stop_check(self, trial_logger: ModelLogger,
                            advisor_id: str, trial_id: str) -> None:
        """Wire the trial's logger to its in-flight stop conditions, each
        metrics report a decision point (a verdict makes that ``log()``
        raise ``StopTrialEarly``, which ``fit`` takes as a normal,
        truncated end): the trial's wall cap, the job's deadline, and
        ASHA's rung check on the per-epoch ``loss`` at resource
        ``epoch + 1``. Over several ranks a verdict is taken only at a
        fit's per-epoch report, where the trainer hands it to every rank
        (``parallel/ranks.py``, ``in_step``): raised from another log on
        rank 0, it would leave the followers waiting in the fit's
        collectives, so the next epoch's report takes it."""
        early_stop = self._early_stop
        job_deadline = self._job_deadline
        trial_timeout = self._trial_timeout_s
        if not (early_stop or job_deadline is not None
                or trial_timeout is not None):
            return
        trial_start = time.time()

        def check(metrics: Dict[str, Any]) -> bool:
            if not in_step():
                return False
            now = time.time()
            if trial_timeout is not None and now - trial_start > trial_timeout:
                logger.info("trial %s hit TRIAL_TIMEOUT_S=%.0f; stopping",
                            trial_id, trial_timeout)
                return True
            if job_deadline is not None and now >= job_deadline:
                logger.info("trial %s crossed the job TIME_HOURS deadline; "
                            "stopping", trial_id)
                return True
            if early_stop and "loss" in metrics and "epoch" in metrics:
                try:
                    return not self._advisors.report_rung(
                        advisor_id, trial_id, int(metrics["epoch"]) + 1,
                        metrics["loss"], min_resource=self._asha_min,
                        eta=self._asha_eta)
                except Exception:
                    logger.warning("ASHA rung report failed; continuing "
                                   "trial", exc_info=True)
            return False

        trial_logger.set_stop_check(check)

    def _retry_pending_feedback(self, advisor_id: str) -> None:
        """Flush observations whose feedback failed, in order, before a
        proposal and before new feedback."""
        while self._pending_feedback:
            knobs, score = self._pending_feedback[0]
            self._advisors.get(advisor_id).feedback(knobs, score)
            self._pending_feedback.pop(0)

    def _run_trial(self, clazz: type, knobs: Dict[str, Any],
                   job: Dict[str, Any], trial_id: str,
                   trial_logger: ModelLogger,
                   ranks: Optional[Ranks] = None,
                   tracer: Optional[Tracer] = None) -> tuple:
        tracer = tracer or Tracer(trial_id)
        if sandbox.sandbox_enabled():
            return self._run_trial_sandboxed(knobs, job, trial_id,
                                             trial_logger, tracer)
        model = clazz(**knobs)
        model.logger = trial_logger
        # per-trial checkpoint slot, handed by templates to fit()
        os.makedirs(self._params_dir, exist_ok=True)
        model.checkpoint_path = os.path.join(self._params_dir,
                                             f"{trial_id}.ckpt")
        if ranks is not None:
            ranks.new_model(self._model_row["model_file_bytes"],
                            self._model_row["model_class"], knobs,
                            checkpoint_path=model.checkpoint_path)

        def call(method: str, *args: Any) -> Any:
            # the followers make the same call on their own instances
            if ranks is None:
                return getattr(model, method)(*args)
            return ranks.call(model, method, *args)

        try:
            try:
                with torch_profile(f"trial-{trial_id}"), \
                        tracer.span("train"):
                    call("train", job["train_dataset_uri"])
            except StopTrialEarly:
                # templates with hand-rolled loops surface the verdict here
                # (fit() absorbs it); the truncated model is still evaluated
                trial_logger.log("trial stopped early by scheduler")
            # the verdict is delivered: later logs must not raise it again
            trial_logger.set_stop_check(None)
            with tracer.span("evaluate"):
                score = validate_score(
                    call("evaluate", job["test_dataset_uri"]))
            with tracer.span("persist_params"):
                params_path = os.path.join(self._params_dir,
                                           f"{trial_id}.params")
                params_bytes = dump_params(model.dump_parameters())
                try:
                    write_artifact(params_path, params_bytes)
                except OSError as e:
                    # the trusted side's I/O (a full disk): the platform's
                    # fault, never the template's knobs
                    raise faults.TrialFault(f"params persist failed: {e}",
                                            kind=FaultKind.INFRA) from e
            # the trial is complete: its mid-trial checkpoint is dead weight
            self._cleanup_ckpt(trial_id)
            return score, params_path
        finally:
            trial_logger.set_stop_check(None)
            _save_trace(tracer, trial_logger, "trial phase breakdown")
            if ranks is None or ranks.broken:
                model.destroy()
            else:
                try:
                    ranks.drop_model(model)
                except Exception:
                    # the ranks are broken now, and start again before
                    # the next trial
                    logger.warning("a rank failed to drop trial %s's model",
                                   trial_id, exc_info=True)

    def _run_trial_sandboxed(self, knobs: Dict[str, Any],
                             job: Dict[str, Any], trial_id: str,
                             trial_logger: ModelLogger,
                             tracer: Tracer) -> tuple:
        """The sandbox path: the template's train, evaluate and dump run
        in a locked-down child on this worker's devices; this side
        forwards its log lines to the trial's log, applies the stop
        checks to its METRICS records and writes the params it returns.
        The child never sees the store, other trials' files or the
        admin's credentials."""
        os.makedirs(self._params_dir, exist_ok=True)
        os.chmod(self._params_dir, 0o700)  # owner-only: jailed uids locked out
        jail = sandbox.make_jail(config.WORKDIR, trial_id)
        stop_check = trial_logger._stop_check
        sink = trial_logger._sink or (lambda line: None)
        try:
            # the child's train, evaluate and dump are one span here
            with tracer.span("train"):
                score, params_bytes = sandbox.run_trial_sandboxed(
                    self._model_row["model_file_bytes"],
                    self._model_row["model_class"], knobs,
                    job["train_dataset_uri"], job["test_dataset_uri"], jail,
                    on_log_line=sink, stop_check=stop_check,
                    timeout_s=self._trial_timeout_s,
                    extra_pythonpath=self._deps_prefix,
                    devices=self._devices or None)
            # NaN survives the child's float() and the JSON pipe: the gate
            # makes it a typed INVALID_SCORE fault here
            score = validate_score(score)
            with tracer.span("persist_params"):
                params_path = os.path.join(self._params_dir,
                                           f"{trial_id}.params")
                try:
                    write_artifact(params_path, params_bytes, mode=0o600)
                except OSError as e:
                    raise faults.TrialFault(f"params persist failed: {e}",
                                            kind=FaultKind.INFRA) from e
            shutil.rmtree(jail, ignore_errors=True)
            return score, params_path
        finally:
            trial_logger.set_stop_check(None)
            _save_trace(tracer, trial_logger, "trial phase breakdown")

    # -- vectorized trial execution ----------------------------------------

    def _propose_batch_clear_of_quarantine(self, advisor_id: str,
                                           k: int) -> list:
        """K proposals in one advisor call (the GP spreads them with
        pending fantasies), each through the scalar path's quarantine
        filter. An advisor store without ``propose_batch`` gives K single
        proposals."""
        draws = None
        fn = getattr(self._advisors, "propose_batch", None)
        if fn is not None:
            try:
                draws = fn(advisor_id, k)
            except Exception:
                logger.warning("propose_batch failed; falling back to "
                               "single proposals", exc_info=True)
        if draws is None:
            draws = [self._advisors.propose(advisor_id) for _ in range(k)]
        if not self._quarantine:
            return draws
        return [self._propose_clear_of_quarantine(advisor_id, knobs=d)
                for d in draws]

    def _population_round(self, ctx: ServiceContext, clazz: type,
                          job: Dict[str, Any], model: Dict[str, Any],
                          advisor_id: str, max_trials: int) -> str:
        """One vectorized round: drain up to K proposals, bucket them,
        reserve a trial row a member and train each bucket of two or more
        as one population (a bucket of one runs the scalar path).
        Returns "stop" (the worker leaves its loop), "budget" (the caller
        reports the budget spent) or "ok" (next round)."""
        try:
            self._retry_pending_feedback(advisor_id)
        except Exception:
            logger.warning("pending feedback retry failed; proposing "
                           "without it", exc_info=True)
        # the drain is clamped by what the budget has left (a best-effort
        # count; each reserve below stays the authority), so a nearly spent
        # job strands no never-scored fantasies in the shared GP
        live = sum(1 for t in self._db.get_trials_of_sub_train_job(
            self._sub_id) if t["status"] != TrialStatus.TERMINATED)
        remaining = max_trials - live
        if remaining <= 0:
            return "budget"
        k = min(self._vmap_k, remaining,
                max(int(self._pop_spec.max_members), 1))
        draws = self._propose_batch_clear_of_quarantine(advisor_id,
                                                        max(k, 1))
        buckets = partition_for_vmap(draws, self._pop_spec.dynamic_knobs,
                                     self._pop_spec.max_members)
        budget_out = False
        for bucket in buckets:
            if ctx.stopping:
                return "stop"
            members = []
            for knobs in bucket:
                trial = self._db.reserve_trial(
                    self._sub_id, model["id"], knobs,
                    worker_id=ctx.service_id, max_trials=max_trials)
                if trial is None:
                    budget_out = True
                    break
                members.append((trial["id"], knobs))
            if members:
                if len(members) == 1:
                    ok = self._execute_trial(ctx, clazz, job, advisor_id,
                                             members[0][0], members[0][1])
                else:
                    ok = self._execute_population_trial(
                        ctx, clazz, job, advisor_id, members)
                if not ok:
                    return "stop"
            if budget_out:
                return "budget"
        return "ok"

    def _execute_population_trial(self, ctx: ServiceContext, clazz: type,
                                  job: Dict[str, Any], advisor_id: str,
                                  members: list) -> bool:
        """Train a bucket as one population, then settle each member's
        row on its own. A failure of the batch re-runs every member as a
        scalar trial under its id (the whole fault taxonomy then applies);
        a member's own fault (its score, its artifact) is that member's.
        Returns False when the worker leaves its loop."""
        lead_id = members[0][0]
        trial_logger = ModelLogger()
        # the batch's training log lands on the lead member's row
        trial_logger.set_sink(
            lambda line: self._db.add_trial_log(lead_id, line))
        self._install_population_stop_check(trial_logger, advisor_id,
                                            [tid for tid, _ in members])
        try:
            self._chaos_trial(lead_id)
            ranks = self._ensure_ranks()
            results = self._run_population_trial(clazz, members, job,
                                                 trial_logger, ranks)
        except Exception:
            if ctx.stopping:
                self._terminate_members(members)
                return False
            logger.warning(
                "population batch %s failed; re-running its %d members "
                "as scalar trials (same ids, full fault taxonomy):\n%s",
                lead_id, len(members), traceback.format_exc())
            self._cleanup_ckpt(lead_id)
            if self._ranks is not None and self._ranks.broken:
                self._close_ranks()
            release_device_memory()
            for idx, (tid, knobs) in enumerate(members):
                if ctx.stopping:
                    # never-started siblings must not stay RUNNING
                    self._terminate_members(members[idx:])
                    return False
                if not self._execute_trial(ctx, clazz, job, advisor_id,
                                           tid, knobs):
                    self._terminate_members(members[idx + 1:])
                    return False
            return not ctx.stopping
        # the completed members first (writes to the store only): a scalar
        # re-run or a fail-fast verdict below never costs a sibling its
        # finished, persisted work
        for tid, knobs, score, params_path, err in results:
            if err is None:
                # feedback BEFORE mark-complete, as on the scalar path
                self._feedback_best_effort(advisor_id, knobs, score)
                self._db.mark_trial_as_complete(tid, score, params_path)
                self._fault_streak = 0
                faults.record_counter(self._sub_id,
                                      "consecutive_user_faults", 0,
                                      absolute=True)
        faulted = [r for r in results if r[4] is not None]
        for idx, (tid, knobs, _, _, err) in enumerate(faulted):
            kind, detail = faults.classify_failure(err)
            if kind in faults.RETRYABLE_KINDS:
                # a platform fault on one member is no verdict on its
                # knobs or its siblings': that member alone re-runs scalar
                # under its id (retries, no budget burnt)
                logger.warning("population member %s hit retryable %s "
                               "fault; re-running it as a scalar trial:\n%s",
                               tid, kind, detail)
                if not self._execute_trial(ctx, clazz, job, advisor_id,
                                           tid, knobs):
                    self._terminate_members(
                        [(t, k) for t, k, _, _, _ in faulted[idx + 1:]])
                    return False
                continue
            logger.error("population member %s fault %s:\n%s", tid, kind,
                         detail)
            self._db.mark_trial_as_errored(tid, kind, detail)
            faults.record_fault(self._sub_id, kind)
            self._feedback_infeasible_best_effort(advisor_id, knobs, kind,
                                                  trial_id=tid)
            if not self._note_user_fault(job, tid, knobs, kind):
                self._terminate_members(
                    [(t, k) for t, k, _, _, _ in faulted[idx + 1:]])
                return False  # the job's fail-fast tripped
        return not ctx.stopping

    def _terminate_members(self, members: list) -> None:
        """TERMINATE a batch's members not settled yet when the worker
        leaves mid-settle: a reserved row must never stay RUNNING."""
        for tid, _ in members:
            try:
                self._db.mark_trial_as_terminated(tid)
                self._cleanup_ckpt(tid)
            except Exception:
                logger.warning("failed to terminate batch member %s", tid,
                               exc_info=True)

    def _run_population_trial(self, clazz: type, members: list,
                              job: Dict[str, Any],
                              trial_logger: ModelLogger,
                              ranks: Optional[Ranks] = None) -> list:
        """The population's ``_run_trial``: one instance built with the
        lead member's knobs (every member shares the others by
        bucketing), one ``train_population`` and one
        ``evaluate_population`` call, then each member's score checked
        and its parameters written. ``[(trial_id, knobs, score,
        params_path, error)]``, one a member; ``error`` is the member's
        own fault. The stacked checkpoint takes the lead member's
        ``.ckpt`` slot (a resume with another K starts fresh)."""
        lead_id = members[0][0]
        tracer = Tracer(lead_id)
        member_knobs = [dict(knobs) for _, knobs in members]
        model = clazz(**member_knobs[0])
        model.logger = trial_logger
        os.makedirs(self._params_dir, exist_ok=True)
        model.checkpoint_path = os.path.join(self._params_dir,
                                             f"{lead_id}.ckpt")
        if ranks is not None:
            ranks.new_model(self._model_row["model_file_bytes"],
                            self._model_row["model_class"], member_knobs[0],
                            checkpoint_path=model.checkpoint_path)

        def call(method: str, *args: Any) -> Any:
            if ranks is None:
                return getattr(model, method)(*args)
            return ranks.call(model, method, *args)

        try:
            try:
                with torch_profile(f"trial-{lead_id}"), \
                        tracer.span("train"):
                    call("train_population", job["train_dataset_uri"],
                         member_knobs)
            except StopTrialEarly:
                trial_logger.log("population batch stopped early by "
                                 "scheduler")
            trial_logger.set_stop_check(None)
            with tracer.span("evaluate"):
                raw_scores = call("evaluate_population",
                                  job["test_dataset_uri"])
            if raw_scores is None or len(raw_scores) != len(members):
                # the population contract is broken: the batch fails, and
                # the scalar re-run judges each member alone
                raise faults.TrialFault(
                    f"evaluate_population returned "
                    f"{0 if raw_scores is None else len(raw_scores)} "
                    f"score(s) for {len(members)} members",
                    kind=FaultKind.USER)
            results = []
            with tracer.span("persist_params"):
                for i, (tid, knobs) in enumerate(members):
                    try:
                        score = validate_score(raw_scores[i])
                    except faults.TrialFault as e:
                        # this member is infeasible; its siblings'
                        # scores stand
                        results.append((tid, knobs, None, None, e))
                        continue
                    params_path = os.path.join(self._params_dir,
                                               f"{tid}.params")
                    try:
                        # a member's dump and write are its own: one
                        # that fails (the template's code, or the disk)
                        # fails that member alone
                        write_artifact(params_path, dump_params(
                            model.dump_member_parameters(i)))
                    except OSError as e:
                        results.append((tid, knobs, None, None,
                                        faults.TrialFault(
                                            f"params persist failed: {e}",
                                            kind=FaultKind.INFRA)))
                        continue
                    except Exception as e:  # classified by the caller
                        results.append((tid, knobs, None, None, e))
                        continue
                    results.append((tid, knobs, score, params_path, None))
            self._cleanup_ckpt(lead_id)
            return results
        finally:
            trial_logger.set_stop_check(None)
            _save_trace(tracer, trial_logger,
                        "population batch phase breakdown",
                        members=float(len(members)))
            if ranks is None or ranks.broken:
                model.destroy()
            else:
                try:
                    ranks.drop_model(model)
                except Exception:
                    logger.warning("a rank failed to drop batch %s's model",
                                   lead_id, exc_info=True)

    def _install_population_stop_check(self, trial_logger: ModelLogger,
                                       advisor_id: str,
                                       member_ids: list) -> None:
        """``_install_stop_check`` for a batch. The wall caps
        (``TRIAL_TIMEOUT_S``, the job's deadline) act on the whole batch:
        one program, one clock. ASHA's rungs are a member's: each
        ``member{k}_loss`` is reported under that member's trial id (a
        template logging only the mean ``loss`` reports it under each),
        and the batch stops only when every member's verdict says stop:
        a population is competitive while any member is."""
        early_stop = self._early_stop
        job_deadline = self._job_deadline
        trial_timeout = self._trial_timeout_s
        if not (early_stop or job_deadline is not None
                or trial_timeout is not None):
            return
        batch_start = time.time()

        def check(metrics: Dict[str, Any]) -> bool:
            if not in_step():
                return False
            now = time.time()
            if trial_timeout is not None \
                    and now - batch_start > trial_timeout:
                logger.info("population batch %s hit TRIAL_TIMEOUT_S=%.0f; "
                            "stopping", member_ids[0], trial_timeout)
                return True
            if job_deadline is not None and now >= job_deadline:
                logger.info("population batch %s crossed the job "
                            "TIME_HOURS deadline; stopping", member_ids[0])
                return True
            if not (early_stop and "epoch" in metrics):
                return False
            rung = int(metrics["epoch"]) + 1
            keep_any, reported = False, False
            for i, tid in enumerate(member_ids):
                value = metrics.get(f"member{i}_loss", metrics.get("loss"))
                if value is None:
                    continue
                reported = True
                try:
                    if self._advisors.report_rung(
                            advisor_id, tid, rung, value,
                            min_resource=self._asha_min,
                            eta=self._asha_eta):
                        keep_any = True
                except Exception:
                    logger.warning("ASHA rung report failed for member "
                                   "%s; keeping it", tid, exc_info=True)
                    keep_any = True
            return reported and not keep_any

        trial_logger.set_stop_check(check)

    def _cleanup_ckpt(self, trial_id: str) -> None:
        """Drop a trial's mid-trial checkpoint once it reached a state it
        never resumes from, with the temporary file of a write a kill
        interrupted."""
        base = os.path.join(self._params_dir, f"{trial_id}.ckpt")
        for path in [base, base + ".tmp", *glob.glob(
                glob.escape(base) + ".*.tmp")]:
            try:
                os.remove(path)
            except OSError:
                pass
        # a sandboxed trial keeps its checkpoint in its jail
        jail = sandbox.jail_path(config.WORKDIR, trial_id)
        if os.path.isdir(jail):
            shutil.rmtree(jail, ignore_errors=True)
