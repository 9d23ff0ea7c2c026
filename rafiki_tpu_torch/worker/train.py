"""Train worker: the AutoML trial loop.

Counterpart of the core loop of ``rafiki_tpu/worker/train.py``
(``TrainWorker._loop``, ``_execute_trial``, ``_run_trial``): read the
sub-train-job, its job and model from the database, load the template
class, open the sub-train-job's advisor session; then, until the stop
event, the trial budget (``MODEL_TRIAL_COUNT``) or the job's
``TIME_HOURS`` deadline (checked between trials): propose knobs, reserve
a trial row atomically, ``Model(**knobs).train(train_uri)``,
``evaluate(test_uri)`` through the score gate, write the params artifact
(atomic, checksummed), log the "trial phase breakdown" (train, evaluate
and persist_params seconds, the JAX worker's tracer summary), feed the
score back to the advisor and only then mark the trial COMPLETED. A
trial that raises is marked ERRORED with its kind and traceback, and the
loop goes on; a stop that lands mid-trial marks it TERMINATED. When the budget is spent the worker sends
:data:`EVENT_BUDGET_REACHED` to the admin and returns.

Waiting (ROADMAP.md): vectorized population trials, the sandbox, ASHA and
mid-trial deadlines, poison-knob quarantine and fail-fast, infra retries,
chaos injection, the compile cache, dependency provisioning, stale-trial
resume after a worker restart, and the tracer (its spans; the phase
breakdown it logs is kept).
"""

from __future__ import annotations

import logging
import math
import os
import time
import traceback
from typing import Any, Callable, Dict, Optional

from rafiki_tpu_torch import config
from rafiki_tpu_torch.advisor.advisor import AdvisorStore
from rafiki_tpu_torch.constants import BudgetType
from rafiki_tpu_torch.db.database import Database
from rafiki_tpu_torch.device import ServiceContext, set_device_grant
from rafiki_tpu_torch.sdk.artifact import write_artifact
from rafiki_tpu_torch.sdk.log import ModelLogger, StopTrialEarly
from rafiki_tpu_torch.sdk.model import load_model_class
from rafiki_tpu_torch.sdk.params import dump_params

logger = logging.getLogger(__name__)

#: sent when the sub-train-job's budget is spent; payload: train_job_id,
#: sub_train_job_id
EVENT_BUDGET_REACHED = "sub_train_job_budget_reached"

EventFn = Callable[[str, Dict[str, Any]], None]

#: the fault kinds this slice records (``rafiki_tpu/worker/faults.py``)
FAULT_USER = "USER"
FAULT_INVALID_SCORE = "INVALID_SCORE"
FAULT_DETAIL_MAX = 4000


class InvalidScoreError(Exception):
    """evaluate() produced NaN/inf/non-numeric: unusable as a score."""

    kind = FAULT_INVALID_SCORE


def validate_score(raw: Any) -> float:
    """The score gate: a finite float, else :class:`InvalidScoreError`
    (a NaN must never reach the advisor)."""
    try:
        score = float(raw)
    except (TypeError, ValueError) as e:
        raise InvalidScoreError(
            f"evaluate() returned non-numeric {type(raw).__name__}: "
            f"{e}") from e
    if not math.isfinite(score):
        raise InvalidScoreError(f"evaluate() returned non-finite {score!r}")
    return score


def _phase(phases: Dict[str, float], name: str, t0: float) -> float:
    """Record the phase that began at ``t0``; the next one begins now."""
    now = time.time()
    phases[name] = now - t0
    return now


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

    def start(self, ctx: ServiceContext) -> None:
        """The trial loop, in the calling thread, on the devices ``ctx``
        grants; returns when the budget is spent or ``ctx`` stops."""
        set_device_grant(ctx.chips)
        try:
            self._loop(ctx)
        finally:
            set_device_grant(None)

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
        clazz = load_model_class(model["model_file_bytes"],
                                 model["model_class"])
        # one advisor session per sub-train-job, shared by its workers
        advisor_id = self._advisors.create_advisor(
            clazz.get_knob_config(), advisor_id=self._sub_id)
        self._db.update_sub_train_job_advisor(self._sub_id, advisor_id)
        ctx.ready()  # job read and template loaded: startup succeeded

        while not ctx.stopping:
            trial = None
            if deadline is None or time.time() < deadline:
                knobs = self._advisors.propose(advisor_id)
                trial = self._db.reserve_trial(
                    self._sub_id, model["id"], knobs,
                    worker_id=ctx.service_id, max_trials=max_trials)
            if trial is None:
                logger.info("sub-train-job %s: budget spent", self._sub_id)
                self._send_event(EVENT_BUDGET_REACHED, {
                    "sub_train_job_id": self._sub_id,
                    "train_job_id": job["id"]})
                return
            if not self._execute_trial(ctx, clazz, job, advisor_id,
                                       trial["id"], knobs):
                return

    def _execute_trial(self, ctx: ServiceContext, clazz: type,
                       job: Dict[str, Any], advisor_id: str, trial_id: str,
                       knobs: Dict[str, Any]) -> bool:
        """Run one trial and record its outcome. Returns False when the
        worker is stopping (the trial is then TERMINATED)."""
        trial_logger = ModelLogger()
        trial_logger.set_sink(
            lambda line: self._db.add_trial_log(trial_id, line))
        try:
            score, params_path = self._run_trial(clazz, knobs, job,
                                                 trial_id, trial_logger)
        except Exception as e:
            if ctx.stopping:
                self._db.mark_trial_as_terminated(trial_id)
                self._cleanup_ckpt(trial_id)
                return False
            kind = getattr(e, "kind", FAULT_USER)
            detail = traceback.format_exc()[-FAULT_DETAIL_MAX:]
            logger.error("trial %s fault %s:\n%s", trial_id, kind, detail)
            self._db.mark_trial_as_errored(trial_id, kind, detail)
            self._cleanup_ckpt(trial_id)
            return True
        # feedback BEFORE mark-complete: a trial visible as COMPLETED has
        # its observation in the advisor; a stop that lands after the work
        # finished keeps the result and only ends the loop
        self._advisors.get(advisor_id).feedback(knobs, score)
        self._db.mark_trial_as_complete(trial_id, score, params_path)
        return not ctx.stopping

    def _run_trial(self, clazz: type, knobs: Dict[str, Any],
                   job: Dict[str, Any], trial_id: str,
                   trial_logger: ModelLogger) -> tuple:
        model = clazz(**knobs)
        model.logger = trial_logger
        # per-trial checkpoint slot, handed by templates to fit()
        os.makedirs(self._params_dir, exist_ok=True)
        model.checkpoint_path = os.path.join(self._params_dir,
                                             f"{trial_id}.ckpt")
        # seconds per phase, logged as the JAX worker's tracer summary is
        phases: Dict[str, float] = {}
        t0 = time.time()
        try:
            try:
                model.train(job["train_dataset_uri"])
            except StopTrialEarly:
                # templates with hand-rolled loops surface the verdict here
                # (fit() absorbs it); the truncated model is still evaluated
                trial_logger.log("trial stopped early by scheduler")
            t0 = _phase(phases, "train", t0)
            trial_logger.set_stop_check(None)
            score = validate_score(model.evaluate(job["test_dataset_uri"]))
            t0 = _phase(phases, "evaluate", t0)
            params_path = os.path.join(self._params_dir,
                                       f"{trial_id}.params")
            write_artifact(params_path, dump_params(model.dump_parameters()))
            _phase(phases, "persist_params", t0)
            # the trial is complete: its mid-trial checkpoint is dead weight
            self._cleanup_ckpt(trial_id)
            return score, params_path
        finally:
            trial_logger.set_stop_check(None)
            trial_logger.log("trial phase breakdown", **{
                f"trace_{k}_s": round(v, 4) for k, v in phases.items()})
            model.destroy()

    def _cleanup_ckpt(self, trial_id: str) -> None:
        try:
            os.remove(os.path.join(self._params_dir, f"{trial_id}.ckpt"))
        except FileNotFoundError:
            pass
