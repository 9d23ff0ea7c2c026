"""The drift closed loop: detection, one bounded warm-started retrain,
and an SLO-judged auto-rollout.

Own copy of ``rafiki_tpu/admin/drift.py``. The controller watches each
RUNNING inference job through its predictor's drift tap (one (wall time,
canonical digest, top probability) sample a served query), compares a
trailing window with a baseline frozen after the last rollout, and on a
verdict (``novelty``, ``conf_drop`` or ``skew`` over its threshold)
launches exactly one retrain of ``RAFIKI_DRIFT_RETRAIN_BUDGET`` trials,
its advisors seeded with the incumbent's scored and infeasible trials
(``Admin.create_train_job(warm_start_from=)``). A candidate that scores
better than the incumbent rolls out through the rollout controller
(``admin/rollout.py``: canary, judge, rolling replace, rollback); a
worse one starts no rollout. Every other outcome puts the loop in a
cooldown that doubles with each consecutive rollback (up to x16).

The instance always exists (the drift status and ack routes go through
it); its loop thread runs with ``RAFIKI_DRIFT=1``. The loop's state is
one ``drift_state`` row a job, written before the launch (the retrain's
id is the idempotency key): :meth:`DriftController.recover_on_boot`
resumes a dead admin's live rows, adopting or parking a launch of
unknown fate, never launching twice; crash recovery calls it
(``admin/recovery.py``), and a tick does nothing while the admin's
recovery runs. :meth:`DriftController.report` is the ``drift`` section
of ``GET /fleet/health``.

Chaos (``RAFIKI_CHAOS``, site ``drift``): a failed tick (target
``tick/<job>``) is absorbed for that job and never touches serving; a
failed launch (``launch/<job>``) retries once a tick, up to
``RAFIKI_DRIFT_LAUNCH_RETRY_MAX``, then the loop parks until
``ack``.
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
    DriftPhase,
    InferenceJobStatus,
    RolloutPhase,
    TrainJobStatus,
)
from rafiki_tpu_torch.utils import chaos
from rafiki_tpu_torch.utils.metrics import REGISTRY

logger = logging.getLogger(__name__)

#: exponential rollback backoff cap: cooldown * 2**min(streak-1, CAP)
_BACKOFF_CAP = 4
#: distinct digests kept in a frozen baseline population
_BASELINE_DIGESTS = 2048
#: events kept on each persisted drift row (the global deque keeps 100)
_ROW_EVENTS = 40


class DriftMonitorError(RuntimeError):
    """Chaos-injected monitor failure (RAFIKI_CHAOS site=drift, target
    ``tick/<job>``) — absorbed per job; serving is never touched."""


class DriftLaunchError(RuntimeError):
    """Chaos-injected retrain-launch failure (site=drift, target
    ``launch/<job>``) — retried bounded, then the loop parks."""


class DriftController:
    """The closed loop. Public entry points: :meth:`tick` (synchronous,
    also what the loop thread calls), :meth:`status`/:meth:`ack` (the
    HTTP drift routes), :meth:`report` (GET /fleet/health "drift"), and
    :meth:`recover_on_boot` (ControlPlaneRecovery)."""

    def __init__(self, admin) -> None:
        self._admin = admin
        self._services = admin.services
        self._db = admin.db
        self._rollouts = admin.rollouts
        self._closed = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        # per-job mirror of the drift_state row plus volatile bits
        # (launch_attempts, the live signal snapshot)
        self._jobs: Dict[str, Dict[str, Any]] = {}  # guarded-by: _lock
        self.events: collections.deque = collections.deque(
            maxlen=100)  # guarded-by: _lock
        self._m_ticks = REGISTRY.counter(
            "rafiki_drift_ticks_total", "drift monitor ticks")
        self._m_events = REGISTRY.counter(
            "rafiki_drift_events_total",
            "drift verdicts raised by the monitor", ("job",))
        self._m_retrains = REGISTRY.counter(
            "rafiki_drift_retrains_total",
            "auto-retrains launched by the drift loop", ("job",))
        self._m_rollouts = REGISTRY.counter(
            "rafiki_drift_rollouts_total",
            "auto-rollouts completed (candidate serving)", ("job",))
        self._m_rollbacks = REGISTRY.counter(
            "rafiki_drift_rollbacks_total",
            "auto-rollout candidates rolled back by the SLO judge",
            ("job",))
        self._m_parked = REGISTRY.counter(
            "rafiki_drift_parked_total",
            "drift loops parked pending operator ack", ("job",))

    # -- lifecycle (autoscaler-shaped) --------------------------------------

    @property
    def running(self) -> bool:
        t = self._thread
        return bool(t and t.is_alive())

    def start(self) -> "DriftController":
        if self.running:
            return self
        self._closed.clear()
        self._thread = threading.Thread(
            target=self._loop, name="drift", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._closed.set()
        t = self._thread
        if t is not None:
            # the join must outlast a tick's chaos delays + store retries
            t.join(timeout=float(config.DRIFT_INTERVAL_S) + 30)
        self._thread = None

    def _loop(self) -> None:
        while not self._closed.wait(float(config.DRIFT_INTERVAL_S)):
            try:
                self.tick()
            except Exception:
                logger.exception("drift tick failed")

    # -- the tick -----------------------------------------------------------

    def tick(self) -> List[Dict[str, Any]]:
        """One monitor pass over every live predictor. Synchronous and
        side-effect-complete, so tests (and operators via the loop
        thread) drive the whole state machine through repeated calls."""
        self._m_ticks.inc()
        if self._admin.recovery_status().get("state") == "recovering":
            # recovery owns the loop's live rows until it is done (its
            # recover_on_boot settles a launch of unknown fate; a tick
            # before that could launch the retrain twice)
            return []
        actions: List[Dict[str, Any]] = []
        predictors = self._services.predictors()
        with self._lock:
            # drop in-memory state for jobs that stopped serving (their
            # durable row stays for forensics)
            for job_id in list(self._jobs):
                if job_id not in predictors:
                    del self._jobs[job_id]
        for job_id, predictor in predictors.items():
            if self._closed.is_set():
                break
            try:
                self._chaos_tick(job_id)
                action = self._tick_job(job_id, predictor)
            except Exception:
                logger.exception("drift tick failed for job %s", job_id)
                continue
            if action is not None:
                actions.append(action)
        return actions

    @staticmethod
    def _chaos_tick(job_id: str) -> None:
        rule = chaos.hit(chaos.SITE_DRIFT, f"tick/{job_id}")
        if rule is None:
            return
        if rule.action == chaos.ACTION_DELAY:
            chaos.sleep_for(rule)
            return
        raise DriftMonitorError(
            f"chaos-injected monitor failure for job {job_id}")

    def _tick_job(self, job_id: str, predictor) -> Optional[Dict[str, Any]]:
        inf = self._db.get_inference_job(job_id)
        if inf is None or inf["status"] != InferenceJobStatus.RUNNING:
            with self._lock:
                self._jobs.pop(job_id, None)
            return None
        st = self._job_state(job_id)
        phase = st["phase"]
        if phase == DriftPhase.PARKED:
            return None
        if phase == DriftPhase.COOLDOWN:
            if time.time() < float(st.get("cooldown_until") or 0.0):
                return None
            st["phase"] = DriftPhase.WATCHING
            st["baseline"] = None  # refreeze against current traffic
            st["reason"] = None
            self._event(job_id, st, "cooldown_over",
                        detail="cooldown elapsed; watching resumes with "
                               "a fresh baseline")
            self._save(job_id, st)
            return {"job_id": job_id, "action": "watch"}
        if phase == DriftPhase.RETRAINING:
            return self._poll_retrain(job_id, st, inf)
        if phase == DriftPhase.ROLLING_OUT:
            return self._poll_rollout(job_id, st)
        # WATCHING
        if self._rollouts.is_active(job_id):
            return None  # an in-flight rollout owns the serving plane
        min_n = int(config.DRIFT_MIN_SAMPLES)
        if st.get("baseline") is None:
            base = predictor.drift_window(
                float(config.DRIFT_BASELINE_WINDOW_S))
            if len(base) < min_n:
                return None
            st["baseline"] = self._freeze_baseline(base)
            self._event(
                job_id, st, "baseline_frozen",
                detail=f"{st['baseline']['count']} samples, "
                       f"{len(st['baseline']['digests'])} distinct "
                       "digests")
            self._save(job_id, st)
            return {"job_id": job_id, "action": "baseline"}
        samples = predictor.drift_window(float(config.DRIFT_WINDOW_S))
        if len(samples) < min_n:
            return None
        signals = self._signals(st["baseline"], samples)
        st["signals"] = signals  # live snapshot; persisted on verdicts
        reason = self._verdict(signals)
        if reason is None:
            return None
        self._m_events.labels(job_id).inc()
        self._event(job_id, st, "drift", detail=reason, signals=signals)
        budget = int(config.DRIFT_RETRAIN_BUDGET)
        if budget <= 0:
            # monitor-only mode: events fire, the training plane is
            # never touched (doctor WARNs about the 0 budget)
            self._cooldown(
                job_id, st,
                f"monitor-only (retrain budget 0): {reason}")
            return {"job_id": job_id, "action": "drift", "reason": reason}
        st["phase"] = DriftPhase.RETRAINING
        st["reason"] = reason
        st["retrain_job_id"] = None  # write-ahead intent; launch follows
        st["launch_attempts"] = 0
        self._save(job_id, st)
        self._launch_retrain(job_id, st, inf)
        return {"job_id": job_id, "action": "drift", "reason": reason,
                "signals": signals}

    # -- signals ------------------------------------------------------------

    @staticmethod
    def _freeze_baseline(samples: List[tuple]) -> Dict[str, Any]:
        """Sketch the window into the frozen reference population: the
        distinct-digest set (bounded), the mean top probability, and the
        busiest digest's traffic share."""
        digests: List[str] = []
        seen: set = set()
        confs: List[float] = []
        counts: Dict[str, int] = {}
        for _ts, digest, conf in samples:
            if digest is not None:
                counts[digest] = counts.get(digest, 0) + 1
                if digest not in seen and len(seen) < _BASELINE_DIGESTS:
                    seen.add(digest)
                    digests.append(digest)
            if conf is not None:
                confs.append(float(conf))
        total = sum(counts.values())
        return {
            "digests": digests,
            "mean_conf": (sum(confs) / len(confs)) if confs else None,
            "top_share": (max(counts.values()) / total) if total else 0.0,
            "count": len(samples),
            "frozen_at": time.time(),
        }

    @staticmethod
    def _signals(baseline: Dict[str, Any],
                 samples: List[tuple]) -> Dict[str, Any]:
        """The divergence statistics for one window vs the baseline:
        ``novelty`` — fraction of the window's digest draws absent from
        the baseline population (input-distribution shift); ``conf_drop``
        — baseline mean top probability minus the window's (score decay,
        probability tasks only); ``skew`` — growth of the single
        busiest digest's traffic share (one caller dominating the
        door)."""
        base_set = set(baseline.get("digests") or [])
        counts: Dict[str, int] = {}
        confs: List[float] = []
        novel = 0
        total = 0
        for _ts, digest, conf in samples:
            if digest is not None:
                total += 1
                counts[digest] = counts.get(digest, 0) + 1
                if digest not in base_set:
                    novel += 1
            if conf is not None:
                confs.append(float(conf))
        novelty = (novel / total) if total else 0.0
        mean_conf = (sum(confs) / len(confs)) if confs else None
        base_conf = baseline.get("mean_conf")
        conf_drop = ((float(base_conf) - mean_conf)
                     if base_conf is not None and mean_conf is not None
                     else 0.0)
        top_share = (max(counts.values()) / total) if total else 0.0
        skew = top_share - float(baseline.get("top_share") or 0.0)
        return {
            "samples": len(samples),
            "distinct": len(counts),
            "novelty": round(novelty, 4),
            "mean_conf": (round(mean_conf, 4)
                          if mean_conf is not None else None),
            "baseline_conf": (round(float(base_conf), 4)
                              if base_conf is not None else None),
            "conf_drop": round(conf_drop, 4),
            "top_share": round(top_share, 4),
            "skew": round(skew, 4),
        }

    @staticmethod
    def _verdict(signals: Dict[str, Any]) -> Optional[str]:
        if signals["novelty"] >= float(config.DRIFT_THRESHOLD):
            return (f"input distribution shift: novelty "
                    f"{signals['novelty']:.0%} >= "
                    f"{float(config.DRIFT_THRESHOLD):.0%} of the window "
                    "is outside the baseline population")
        if signals["conf_drop"] >= float(config.DRIFT_CONF_DROP):
            return (f"confidence decay: mean top probability fell "
                    f"{signals['conf_drop']:.3f} below the baseline "
                    f"(>= {float(config.DRIFT_CONF_DROP):.3f})")
        if signals["skew"] >= float(config.DRIFT_SKEW_DELTA):
            return (f"traffic skew: the busiest digest's share grew "
                    f"{signals['skew']:.0%} over the baseline "
                    f"(>= {float(config.DRIFT_SKEW_DELTA):.0%})")
        return None

    # -- retrain ------------------------------------------------------------

    def _launch_retrain(self, job_id: str, st: Dict[str, Any],
                        inf: Dict[str, Any]) -> None:
        """One launch attempt per tick (the chaos chokepoint), bounded
        by DRIFT_LAUNCH_RETRY_MAX retries before the loop parks."""
        try:
            self._chaos_launch(job_id)
            retrain = self._create_retrain(inf)
        except Exception as e:
            st["launch_attempts"] = int(st.get("launch_attempts") or 0) + 1
            retry_max = int(config.DRIFT_LAUNCH_RETRY_MAX)
            if st["launch_attempts"] > retry_max:
                self._park(
                    job_id, st,
                    f"retrain launch failed {st['launch_attempts']}x "
                    f"(bounded at {retry_max} retries): "
                    f"{type(e).__name__}: {e}")
            else:
                self._event(
                    job_id, st, "retrain_launch_retry",
                    detail=f"attempt {st['launch_attempts']} failed "
                           f"({type(e).__name__}: {e}); retrying next "
                           "tick")
                self._save(job_id, st)
            logger.warning("drift retrain launch failed for job %s",
                           job_id, exc_info=True)
            return
        st["retrain_job_id"] = retrain["id"]
        self._m_retrains.labels(job_id).inc()
        self._event(
            job_id, st, "retrain_launched",
            detail=f"train job {retrain['id'][:8]} (budget "
                   f"{int(config.DRIFT_RETRAIN_BUDGET)} trials, "
                   "warm-started from the incumbent's history)")
        self._save(job_id, st)

    @staticmethod
    def _chaos_launch(job_id: str) -> None:
        rule = chaos.hit(chaos.SITE_DRIFT, f"launch/{job_id}")
        if rule is None:
            return
        if rule.action == chaos.ACTION_DELAY:
            chaos.sleep_for(rule)
            return
        raise DriftLaunchError(
            f"chaos-injected retrain-launch failure for job {job_id}")

    def _create_retrain(self, inf: Dict[str, Any]) -> Dict[str, Any]:
        """Launch the bounded warm-started retrain: same app/task/data
        and model set as the incumbent's train job, MODEL_TRIAL_COUNT
        capped by the drift budget, advisors seeded from the incumbent's
        scored + infeasible trials before the services start."""
        tj = self._db.get_train_job(inf["train_job_id"])
        if tj is None:
            raise DriftLaunchError(
                f"incumbent train job {inf['train_job_id']} not found")
        names = []
        for sub in self._db.get_sub_train_jobs_of_train_job(tj["id"]):
            model = self._db.get_model(sub["model_id"])
            if model is not None:
                names.append(model["name"])
        budget = dict(tj.get("budget") or {})
        budget[BudgetType.MODEL_TRIAL_COUNT] = int(
            config.DRIFT_RETRAIN_BUDGET)
        return self._admin.create_train_job(
            tj["user_id"], tj["app"], tj["task"],
            tj["train_dataset_uri"], tj["test_dataset_uri"],
            budget=budget, model_names=names or None,
            warm_start_from=tj["id"])

    def _poll_retrain(self, job_id: str, st: Dict[str, Any],
                      inf: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        from rafiki_tpu_torch.admin.rollout import RolloutInFlightError

        rid = st.get("retrain_job_id")
        if not rid:
            # a previous launch attempt failed; retry this tick
            self._launch_retrain(job_id, st, inf)
            return None
        tj = self._db.get_train_job(rid)
        if tj is None:
            self._park(job_id, st,
                       f"retrain job {rid[:8]} vanished from the store")
            return {"job_id": job_id, "action": "parked"}
        if tj["status"] == TrainJobStatus.ERRORED:
            self._cooldown(
                job_id, st,
                f"retrain job {rid[:8]} ERRORED"
                + (f": {tj['error_reason']}" if tj.get("error_reason")
                   else ""))
            return {"job_id": job_id, "action": "retrain_errored"}
        if tj["status"] != TrainJobStatus.STOPPED:
            return None  # still training
        best = self._db.get_best_trials_of_train_job(rid, max_count=1)
        cand = best[0] if best else None
        if cand is None or cand.get("score") is None:
            self._cooldown(
                job_id, st,
                f"retrain {rid[:8]} produced no scored candidate")
            return {"job_id": job_id, "action": "no_candidate"}
        incumbent = self._db.get_best_trials_of_train_job(
            inf["train_job_id"], max_count=1)
        inc_score = (incumbent[0]["score"]
                     if incumbent and incumbent[0].get("score") is not None
                     else None)
        if inc_score is not None \
                and float(cand["score"]) <= float(inc_score):
            # a worse candidate costs the serving plane NOTHING: no
            # rollout starts, the loop backs off
            self._cooldown(
                job_id, st,
                f"candidate {cand['id'][:8]} scored "
                f"{float(cand['score']):.4f} <= incumbent "
                f"{float(inc_score):.4f}: keeping the incumbent")
            return {"job_id": job_id, "action": "candidate_worse"}
        try:
            self._rollouts.start(job_id, cand["id"])
        except RolloutInFlightError:
            return None  # a foreign rollout is live; re-check next tick
        except Exception as e:
            self._cooldown(job_id, st, f"auto-rollout refused: {e}")
            return {"job_id": job_id, "action": "rollout_refused"}
        st["phase"] = DriftPhase.ROLLING_OUT
        st["candidate_trial_id"] = cand["id"]
        self._event(
            job_id, st, "rollout_started",
            detail=f"candidate {cand['id'][:8]} (score "
                   f"{float(cand['score']):.4f} > incumbent "
                   f"{float(inc_score):.4f})" if inc_score is not None
            else f"candidate {cand['id'][:8]} (score "
                 f"{float(cand['score']):.4f})")
        self._save(job_id, st)
        return {"job_id": job_id, "action": "rollout_started",
                "trial_id": cand["id"]}

    # -- rollout outcome ----------------------------------------------------

    def _poll_rollout(self, job_id: str,
                      st: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        view = self._rollouts.status(job_id)
        cand = st.get("candidate_trial_id")
        if view is None or (cand is not None
                            and view.get("to_trial_id") != cand):
            self._cooldown(job_id, st,
                           "auto-rollout row missing or superseded by an "
                           "operator rollout")
            return {"job_id": job_id, "action": "rollout_lost"}
        phase = view["phase"]
        if phase in RolloutPhase.LIVE:
            return None
        if phase == RolloutPhase.DONE:
            st["consecutive_rollbacks"] = 0
            st["retrain_job_id"] = None
            st["candidate_trial_id"] = None
            st["baseline"] = None  # refreeze against the new model
            st["phase"] = DriftPhase.WATCHING
            st["reason"] = None
            self._m_rollouts.labels(job_id).inc()
            self._event(
                job_id, st, "rollout_done",
                detail=f"candidate {cand[:8] if cand else '?'} is "
                       "serving; the baseline refreezes on its traffic")
            self._save(job_id, st)
            return {"job_id": job_id, "action": "rollout_done"}
        if phase == RolloutPhase.ROLLED_BACK:
            st["consecutive_rollbacks"] = int(
                st.get("consecutive_rollbacks") or 0) + 1
            self._m_rollbacks.labels(job_id).inc()
            acked = ""
            try:
                # the loop acks its own rollback: the drift row carries
                # the flap signal for the doctor, so leaving the rollout
                # row unacked would just add a second, noisier WARN
                if not view.get("operator_ack"):
                    self._rollouts.ack(job_id)
                    acked = "; rollback acked by the drift loop"
            except Exception:
                pass
            streak = st["consecutive_rollbacks"]
            self._cooldown(
                job_id, st,
                f"candidate {cand[:8] if cand else '?'} rolled back "
                f"({view.get('reason')}); consecutive rollbacks "
                f"{streak}{acked}",
                backoff=streak)
            return {"job_id": job_id, "action": "rollback"}
        # ABORTED (job stopped mid-rollout, stale row swept, ...)
        self._cooldown(job_id, st,
                       f"auto-rollout aborted ({view.get('reason')})")
        return {"job_id": job_id, "action": "rollout_aborted"}

    # -- transitions --------------------------------------------------------

    def _cooldown(self, job_id: str, st: Dict[str, Any], reason: str,
                  backoff: int = 0) -> None:
        """Enter COOLDOWN for the base cooldown, doubled per consecutive
        rollback (capped at x16) so a flapping candidate backs the loop
        off exponentially instead of storming the training plane."""
        base = float(config.DRIFT_COOLDOWN_S)
        mult = 2 ** min(max(backoff - 1, 0), _BACKOFF_CAP) if backoff \
            else 1
        st["phase"] = DriftPhase.COOLDOWN
        st["cooldown_until"] = time.time() + base * mult
        st["reason"] = reason
        st["retrain_job_id"] = None
        st["candidate_trial_id"] = None
        self._event(job_id, st, "cooldown",
                    detail=f"{reason} (backing off {base * mult:g}s)")
        self._save(job_id, st)

    def _park(self, job_id: str, st: Dict[str, Any], reason: str) -> None:
        st["phase"] = DriftPhase.PARKED
        st["reason"] = reason
        st["operator_ack"] = False
        st["retrain_job_id"] = None
        st["candidate_trial_id"] = None
        self._m_parked.labels(job_id).inc()
        self._event(job_id, st, "parked",
                    detail=f"{reason} — POST .../drift/ack re-arms the "
                           "loop")
        self._save(job_id, st)

    # -- state plumbing -----------------------------------------------------

    def _job_state(self, job_id: str) -> Dict[str, Any]:
        with self._lock:
            st = self._jobs.get(job_id)
        if st is not None:
            return st
        row = self._db.get_drift_state(job_id)
        if row is None:
            row = self._db.create_drift_state(job_id, DriftPhase.WATCHING)
        st = self._state_from_row(row)
        with self._lock:
            # setdefault: a racing tick/ack that loaded first wins
            return self._jobs.setdefault(job_id, st)

    @staticmethod
    def _state_from_row(row: Dict[str, Any]) -> Dict[str, Any]:
        return {
            "phase": row["phase"],
            "reason": row.get("reason"),
            "baseline": row.get("baseline"),
            "signals": row.get("signals"),
            "retrain_job_id": row.get("retrain_job_id"),
            "candidate_trial_id": row.get("candidate_trial_id"),
            "cooldown_until": float(row.get("cooldown_until") or 0.0),
            "consecutive_rollbacks": int(
                row.get("consecutive_rollbacks") or 0),
            "events": list(row.get("events") or []),
            "operator_ack": bool(row.get("operator_ack")),
            "launch_attempts": 0,
        }

    def _save(self, job_id: str, st: Dict[str, Any]) -> None:
        self._db.update_drift_state(
            job_id,
            phase=st["phase"],
            reason=st.get("reason"),
            baseline=st.get("baseline"),
            signals=st.get("signals"),
            retrain_job_id=st.get("retrain_job_id"),
            candidate_trial_id=st.get("candidate_trial_id"),
            cooldown_until=float(st.get("cooldown_until") or 0.0),
            consecutive_rollbacks=int(
                st.get("consecutive_rollbacks") or 0),
            events=st.get("events") or [],
            operator_ack=bool(st.get("operator_ack")),
        )

    def _event(self, job_id: str, st: Dict[str, Any], name: str,
               detail: Optional[str] = None,
               signals: Optional[Dict[str, Any]] = None) -> None:
        evt: Dict[str, Any] = {"ts": time.time(), "job_id": job_id,
                               "event": name, "detail": detail}
        if signals is not None:
            evt["signals"] = signals
        with self._lock:
            self.events.append(evt)
        row_events = list(st.get("events") or [])[-(_ROW_EVENTS - 1):]
        row_events.append({k: v for k, v in evt.items()
                           if k != "job_id"})
        st["events"] = row_events
        logger.info("drift %s for job %s: %s", name, job_id[:8],
                    detail or "")

    # -- operator surface ---------------------------------------------------

    def status(self, inference_job_id: str) -> Optional[Dict[str, Any]]:
        """The job's durable drift row plus the live signal snapshot —
        the GET .../drift view."""
        row = self._db.get_drift_state(inference_job_id)
        if row is None:
            return None
        view = dict(row)
        view["enabled"] = bool(config.DRIFT)
        with self._lock:
            st = self._jobs.get(inference_job_id)
            if st is not None and st.get("signals") is not None:
                view["signals"] = st["signals"]
        return view

    def ack(self, inference_job_id: str) -> Dict[str, Any]:
        """Operator acknowledgment: re-arms a PARKED loop (fresh
        baseline, cleared rollback streak) or clears a standing flap
        counter — both clear the doctor WARNs."""
        from rafiki_tpu_torch.admin.admin import InvalidRequestError

        row = self._db.get_drift_state(inference_job_id)
        if row is None:
            raise InvalidRequestError(
                f"no drift state recorded for job {inference_job_id}")
        with self._lock:
            st = self._jobs.get(inference_job_id)
        if st is None:
            st = self._state_from_row(row)
            with self._lock:
                st = self._jobs.setdefault(inference_job_id, st)
        if st["phase"] == DriftPhase.PARKED:
            st["phase"] = DriftPhase.WATCHING
            st["baseline"] = None
            st["consecutive_rollbacks"] = 0
            st["launch_attempts"] = 0
            st["operator_ack"] = True
            st["reason"] = None
            self._event(inference_job_id, st, "acked",
                        detail="operator ack: loop re-armed")
            self._save(inference_job_id, st)
        elif int(st.get("consecutive_rollbacks") or 0) > 0:
            st["consecutive_rollbacks"] = 0
            st["operator_ack"] = True
            self._event(inference_job_id, st, "acked",
                        detail="operator ack: rollback flap counter "
                               "cleared")
            self._save(inference_job_id, st)
        else:
            raise InvalidRequestError(
                f"nothing to acknowledge for job {inference_job_id} "
                f"(phase {st['phase']}, no rollback streak)")
        return self.status(  # type: ignore[return-value]
            inference_job_id)

    def report(self) -> Dict[str, Any]:
        """The GET /fleet/health "drift" section."""
        with self._lock:
            jobs = {
                job_id: {
                    "phase": st["phase"],
                    "reason": st.get("reason"),
                    "cooldown_until": float(
                        st.get("cooldown_until") or 0.0),
                    "consecutive_rollbacks": int(
                        st.get("consecutive_rollbacks") or 0),
                    "retrain_job_id": st.get("retrain_job_id"),
                    "candidate_trial_id": st.get("candidate_trial_id"),
                    "baseline_frozen": st.get("baseline") is not None,
                    "signals": st.get("signals"),
                }
                for job_id, st in self._jobs.items()
            }
            events = list(self.events)[-20:]
        return {
            "enabled": bool(config.DRIFT),
            "running": self.running,
            "interval_s": float(config.DRIFT_INTERVAL_S),
            "window_s": float(config.DRIFT_WINDOW_S),
            "jobs": jobs,
            "events": events,
        }

    # -- crash recovery (admin/recovery.py) ---------------------------------

    def recover_on_boot(self) -> None:
        """Resume mid-loop state after an admin crash — called by
        ControlPlaneRecovery after the rollout controller's own boot
        pass. RETRAINING with a persisted retrain_job_id just resumes
        polling (the id is the idempotency key: the recovered loop can
        never double-launch). RETRAINING with a NULL id is a write-ahead
        intent whose launch fate is unknowable — the dead admin crashed
        either side of the create — so it is resolved by adopting the
        one train job that matches the intent, else by parking; NEVER by
        relaunching. ROLLING_OUT re-attaches to whatever the rollout
        boot pass decided via the normal outcome poll."""
        for row in self._db.get_drift_states():
            if row["phase"] not in DriftPhase.LIVE:
                continue
            job_id = row["inference_job_id"]
            st = self._state_from_row(row)
            with self._lock:
                st = self._jobs.setdefault(job_id, st)
            if row["phase"] == DriftPhase.RETRAINING \
                    and not row.get("retrain_job_id"):
                adopted = self._adopt_orphan_retrain(job_id, row)
                if adopted:
                    st["retrain_job_id"] = adopted
                    self._event(
                        job_id, st, "retrain_adopted",
                        detail=f"crash mid-launch: adopted train job "
                               f"{adopted[:8]} as the in-flight retrain")
                    self._save(job_id, st)
                else:
                    self._park(
                        job_id, st,
                        "admin crashed mid retrain launch and no "
                        "matching train job was found to adopt — parked "
                        "instead of risking a double launch")
            else:
                self._event(job_id, st, "resumed",
                            detail=f"recovered mid-loop in phase "
                                   f"{row['phase']}")
                self._save(job_id, st)

    def _adopt_orphan_retrain(self, job_id: str,
                              row: Dict[str, Any]) -> Optional[str]:
        """Find the train job a crashed launch may have created: same
        user/app as the incumbent, started no earlier than shortly
        before the intent row was written, and not the incumbent
        itself. Newest wins; None means nothing plausible exists."""
        inf = self._db.get_inference_job(job_id)
        tj = (self._db.get_train_job(inf["train_job_id"])
              if inf else None)
        if tj is None:
            return None
        cutoff = float(row.get("datetime_updated") or 0.0) - 60.0
        for job in self._db.get_train_jobs_of_app(tj["user_id"],
                                                  tj["app"]):
            if job["id"] == tj["id"]:
                continue
            if float(job["datetime_started"]) >= cutoff:
                return job["id"]
        return None
