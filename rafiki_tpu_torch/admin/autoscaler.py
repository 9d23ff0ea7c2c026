"""The serving autoscaler: the closed loop over the serving signals.

Own copy of ``rafiki_tpu/admin/autoscaler.py``. With ``RAFIKI_AUTOSCALE=1``
a thread of the admin ticks every ``RAFIKI_AUTOSCALE_INTERVAL_S``: for
each RUNNING inference job it samples the backlog into the job's
``backlog:job:<id>`` ring, reads the job's shed count (the predictor's
and its door's) and, for generation, the ``slot_occupancy:job:<id>``
ring the workers write, and decides over the trailing
``RAFIKI_AUTOSCALE_WINDOW_S``:

- scale up on sustained overload (sheds past
  ``RAFIKI_AUTOSCALE_SHED_THRESHOLD``, a mean backlog past
  ``RAFIKI_AUTOSCALE_DEPTH_HIGH``, or occupancy past
  ``RAFIKI_GEN_OCCUPANCY_HIGH``), by at most ``RAFIKI_AUTOSCALE_STEP`` up
  to ``RAFIKI_AUTOSCALE_MAX_REPLICAS``;
- scale down on sustained idle (no shed, the backlog never above
  ``RAFIKI_AUTOSCALE_DEPTH_LOW``, occupancy under half the high mark,
  over a window that covers 60% of its span) to
  ``RAFIKI_AUTOSCALE_MIN_REPLICAS``, as a graceful drain;
- separate cooldowns after an action (``..._COOLDOWN_UP_S``,
  ``..._COOLDOWN_DOWN_S``), a fresh window after each, and a pause while
  a rollout owns the job's replicas.

Each decision is an event (the action, its reason, the signals, the
result) in a bounded log that :meth:`Autoscaler.report` returns, the
``autoscaler`` section of ``GET /fleet/health``. A scale-up borrows an
idle card through the chip arbiter (``placement/hosts.py``) when the
training floor allows, else shares a device.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from typing import Any, Deque, Dict, List, Optional

from rafiki_tpu_torch import config
from rafiki_tpu_torch.constants import InferenceJobStatus
from rafiki_tpu_torch.predictor.result_cache import get_cache
from rafiki_tpu_torch.utils.metrics import REGISTRY

logger = logging.getLogger(__name__)


class Autoscaler:
    """One an admin. The loop runs only with ``RAFIKI_AUTOSCALE=1`` (or an
    explicit :meth:`start`); :meth:`tick` is public and synchronous, and
    a stopped instance still answers :meth:`report`."""

    def __init__(self, admin) -> None:
        self._admin = admin
        self._services = admin.services
        self._db = admin.db
        self._arbiter = getattr(admin, "chip_arbiter", None)
        self._closed = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        # {job_id: {"history": deque[(ts, shed_delta, backlog)],
        #  "last_shed_total", "last_action_ts", "last_action"}}
        self._jobs: Dict[str, Dict[str, Any]] = {}  # guarded-by: _lock
        #: the decision log, newest last
        self.events: Deque[Dict[str, Any]] = (  # guarded-by: _lock
            collections.deque(maxlen=100))
        self._m_up = REGISTRY.counter(
            "rafiki_autoscale_up_total", "autoscaler scale-up actions",
            ("job",))
        self._m_down = REGISTRY.counter(
            "rafiki_autoscale_down_total", "autoscaler scale-down actions",
            ("job",))
        self._m_ticks = REGISTRY.counter(
            "rafiki_autoscale_ticks_total", "autoscaler control-loop ticks")

    # -- lifecycle ---------------------------------------------------------

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> "Autoscaler":
        if self.running:
            return self
        self._closed.clear()
        self._thread = threading.Thread(target=self._loop, name="autoscaler",
                                        daemon=True)
        self._thread.start()
        logger.info("autoscaler loop started (interval %.1fs, window %.1fs)",
                    float(config.AUTOSCALE_INTERVAL_S),
                    float(config.AUTOSCALE_WINDOW_S))
        return self

    def stop(self) -> None:
        self._closed.set()
        t = self._thread
        if t is not None:
            # a tick may sit in a drain or a scale-up's deploy wait
            t.join(timeout=float(config.AUTOSCALE_DRAIN_S)
                   + float(config.SERVICE_DEPLOY_TIMEOUT_S) + 10)
        self._thread = None

    def _loop(self) -> None:
        while not self._closed.wait(float(config.AUTOSCALE_INTERVAL_S)):
            try:
                self.tick()
            except Exception:
                logger.exception("autoscaler tick failed")

    # -- the loop ----------------------------------------------------------

    def tick(self) -> List[Dict[str, Any]]:
        """One decision pass over every serving job; the decisions
        taken."""
        self._m_ticks.inc()
        now = time.monotonic()
        actions: List[Dict[str, Any]] = []
        predictors = self._services.predictors()
        with self._lock:
            for job_id in list(self._jobs):
                if job_id not in predictors:
                    del self._jobs[job_id]
        for job_id, predictor in predictors.items():
            if self._closed.is_set():
                break
            try:
                action = self._tick_job(job_id, predictor, now)
            except Exception:
                logger.exception("autoscaler decision for job %s failed",
                                 job_id[:8])
                continue
            if action is not None:
                actions.append(action)
        return actions

    def _job_state(self, job_id: str) -> Dict[str, Any]:
        with self._lock:
            st = self._jobs.get(job_id)
            if st is None:
                st = self._jobs[job_id] = {
                    "history": collections.deque(maxlen=512),
                    "last_shed_total": None,
                    "last_action_ts": 0.0,
                    "last_action": None,
                }
            return st

    def _shed_total(self, job_id: str, predictor) -> int:
        """The job's sheds so far: the predictor's, and its own door's."""
        ov = predictor.overload_stats()
        total = int(ov.get("requests_shed", 0)) + int(
            ov.get("trials_shed", 0))
        door = self._services.door(job_id)
        if door is not None:
            s = door.admission.stats()
            total += int(s.get("shed_capacity", 0))
            total += int(s.get("shed_deadline", 0))
            total += int(s.get("shed_fairness", 0))
        return total

    @staticmethod
    def _cache_hit_rate(job_id: str, st: Dict[str, Any]) -> Optional[float]:
        """The job's cache hit rate since the last tick (None while the
        cache serves nothing): a note on the decision, not a signal."""
        try:
            hits, misses = get_cache().job_totals(job_id)
        except Exception:
            return None
        last = st.get("last_cache_totals")
        st["last_cache_totals"] = (hits, misses)
        if last is None:
            return None
        dh, dm = hits - last[0], misses - last[1]
        if dh + dm <= 0:
            return None
        return round(dh / (dh + dm), 3)

    def _tick_job(self, job_id: str, predictor,
                  now: float) -> Optional[Dict[str, Any]]:
        inf = self._db.get_inference_job(job_id)
        if inf is None or inf["status"] != InferenceJobStatus.RUNNING:
            return None
        st = self._job_state(job_id)
        # a rollout owns the replicas mid-flight: no decision, and the
        # first one after it sees a fresh window over the new fleet
        rollouts = getattr(self._admin, "rollouts", None)
        if rollouts is not None and rollouts.is_active(job_id):
            st["history"].clear()
            st["last_shed_total"] = None
            return None
        try:
            backlog = int(predictor.backlog_depth())
        except Exception:
            backlog = 0
        REGISTRY.ring(f"backlog:job:{job_id}").record(backlog)
        shed_total = self._shed_total(job_id, predictor)
        last = st["last_shed_total"]
        shed_delta = max(shed_total - last, 0) if last is not None else 0
        st["last_shed_total"] = shed_total
        st["history"].append((now, shed_delta, backlog))
        window_s = max(float(config.AUTOSCALE_WINDOW_S), 1.0)
        window = [(t, s, b) for t, s, b in st["history"]
                  if now - t <= window_s]
        if not window:
            return None
        shed_in_window = sum(s for _, s, _ in window)
        depths = [b for _, _, b in window]
        mean_depth = sum(depths) / len(depths)
        max_depth = max(depths)
        span_s = now - window[0][0]
        n_live = len(self._services.live_inference_workers(job_id))
        # generation's load is its resident streams, not its queue: the
        # workers' occupancy series
        wall_now = time.time()
        occ = [v for t, v in
               REGISTRY.ring(f"slot_occupancy:job:{job_id}").series()
               if wall_now - t <= window_s]
        mean_occ = (sum(occ) / len(occ)) if occ else 0.0
        max_occ = max(occ) if occ else 0.0
        signals = {
            "shed_in_window": shed_in_window,
            "mean_backlog": round(mean_depth, 2),
            "max_backlog": max_depth,
            "window_span_s": round(span_s, 2),
            "replicas": n_live,
        }
        if occ:
            signals["slot_occupancy"] = round(mean_occ, 2)
        hit_rate = self._cache_hit_rate(job_id, st)
        if hit_rate is not None:
            signals["cache_hit_rate"] = hit_rate
        step = max(int(config.AUTOSCALE_STEP), 1)
        since_action = now - st["last_action_ts"]
        occ_high = float(config.GEN_OCCUPANCY_HIGH)
        overloaded = (
            shed_in_window >= max(int(config.AUTOSCALE_SHED_THRESHOLD), 1)
            or mean_depth >= float(config.AUTOSCALE_DEPTH_HIGH)
            or (bool(occ) and mean_occ >= occ_high))
        idle = (shed_in_window == 0
                and max_depth <= float(config.AUTOSCALE_DEPTH_LOW)
                and max_occ <= occ_high / 2)
        if overloaded and n_live < int(config.AUTOSCALE_MAX_REPLICAS):
            if since_action < float(config.AUTOSCALE_COOLDOWN_UP_S):
                return None
            step = min(step, int(config.AUTOSCALE_MAX_REPLICAS) - n_live)
            if shed_in_window >= int(config.AUTOSCALE_SHED_THRESHOLD):
                reason = "sustained shed"
            elif mean_depth >= float(config.AUTOSCALE_DEPTH_HIGH):
                reason = "sustained backlog depth"
            else:
                reason = "generation slot occupancy"
            return self._act(job_id, st, "scale_up", step, reason, signals)
        if idle and n_live > int(config.AUTOSCALE_MIN_REPLICAS):
            # the window must cover idle time: one fresh sample after a
            # restart drains no one
            if span_s < window_s * 0.6:
                return None
            if since_action < float(config.AUTOSCALE_COOLDOWN_DOWN_S):
                return None
            step = min(step, n_live - int(config.AUTOSCALE_MIN_REPLICAS))
            return self._act(job_id, st, "scale_down", step,
                             "sustained idle", signals)
        return None

    def _act(self, job_id: str, st: Dict[str, Any], action: str, step: int,
             reason: str,
             signals: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        if self._closed.is_set():
            return None
        delta = step if action == "scale_up" else -step
        try:
            report = self._services.scale_inference_job(
                job_id, delta,
                min_replicas=int(config.AUTOSCALE_MIN_REPLICAS))
        except Exception as e:
            logger.warning("autoscaler %s of job %s failed: %s", action,
                           job_id[:8], e)
            report = {"error": str(e)}
        st["last_action_ts"] = time.monotonic()
        st["last_action"] = action
        if report.get("added") or report.get("removed"):
            if report.get("promoted"):
                reason += " (served by warm-pool promotion)"
            (self._m_up if action == "scale_up"
             else self._m_down).labels(job_id).inc()
            # a new capacity level gets a fresh window: the burst that
            # justified this action is not counted again
            st["history"].clear()
        event = {"ts": time.time(), "job_id": job_id, "action": action,
                 "delta": delta, "reason": reason, "signals": signals,
                 "result": report}
        with self._lock:
            self.events.append(event)
        logger.warning("autoscaler %s job %s by %d (%s; signals=%s)", action,
                       job_id[:8], abs(delta), reason, signals)
        return event

    # -- observability -----------------------------------------------------

    def report(self) -> Dict[str, Any]:
        """The loop's state, its settings, the loan book and the recent
        decisions (the JAX package's fleet-health section)."""
        with self._lock:
            jobs = {job_id: {"last_action": st["last_action"],
                             "samples": len(st["history"])}
                    for job_id, st in self._jobs.items()}
            recent_events = list(self.events)[-20:]
        arbiter = {}
        if self._arbiter is not None:
            total, free = self._arbiter.capacity()
            arbiter = {
                "borrowed_chips": self._arbiter.borrowed_chips(),
                "borrowed_by_service": {
                    sid[:8]: n
                    for sid, (_, n) in self._arbiter.borrowed().items()},
                "train_floor_chips": self._arbiter.floor(),
                "total_chips": total,
                "free_chips": free,
            }
        return {
            "enabled": bool(config.AUTOSCALE),
            "running": self.running,
            "fair_admission": bool(config.AUTOSCALE_FAIR),
            "interval_s": float(config.AUTOSCALE_INTERVAL_S),
            "window_s": float(config.AUTOSCALE_WINDOW_S),
            "bounds": {
                "min_replicas": int(config.AUTOSCALE_MIN_REPLICAS),
                "max_replicas": int(config.AUTOSCALE_MAX_REPLICAS),
                "step": int(config.AUTOSCALE_STEP),
            },
            "jobs": jobs,
            "chip_budget": arbiter,
            "events": recent_events,
        }
