"""The warm standby pool.

Own copy of ``rafiki_tpu/admin/warm_pool.py``.
``RAFIKI_AUTOSCALE_WARM_POOL=K`` (off by default) keeps K standby replicas
a RUNNING inference job: placed like a scale-up replica (their cards on
the chip arbiter's loan book, tagged so training reclaims them first),
loaded and warmed, but never handed to the predictor. A scale-up or the
replacement of a dead replica is then a route (``add_worker``), not a
deploy.

The loop, every ``RAFIKI_AUTOSCALE_WARM_POOL_INTERVAL_S``:

- retires a standby whose version fell behind what its group serves (a
  rollout moved past it), so a promotion never brings an old version back;
- shrinks the pool when K was lowered;
- tops each job up to K, with bounded retries:
  ``RAFIKI_AUTOSCALE_WARM_RETRY_MAX`` failures in a row park the job's
  pool DEGRADED for ``RAFIKI_AUTOSCALE_WARM_RETRY_COOLDOWN_S``.

The admin calls :meth:`WarmPool.on_replica_errored` when a routed replica
dies: a standby is promoted at once, and the next tick tops the pool up.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from typing import Any, Deque, Dict, List, Optional

from rafiki_tpu_torch import config
from rafiki_tpu_torch.constants import InferenceJobStatus
from rafiki_tpu_torch.utils.metrics import REGISTRY

logger = logging.getLogger(__name__)


class WarmPool:
    """One an admin. The loop runs only while ``RAFIKI_AUTOSCALE_WARM_POOL``
    > 0 (or after an explicit :meth:`start`); :meth:`tick` is public and
    synchronous, and a stopped instance still answers :meth:`report`."""

    def __init__(self, admin) -> None:
        self._admin = admin
        self._services = admin.services
        self._db = admin.db
        self._arbiter = getattr(admin, "chip_arbiter", None)
        self._closed = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        # {job_id: {"failures", "degraded_until", "last_error"}}
        self._jobs: Dict[str, Dict[str, Any]] = {}  # guarded-by: _lock
        #: the event log, newest last
        self.events: Deque[Dict[str, Any]] = (  # guarded-by: _lock
            collections.deque(maxlen=100))
        self._g_standbys = REGISTRY.gauge(
            "rafiki_warm_pool_standbys",
            "warm standby replicas currently held, per job", ("job",))
        self._m_ticks = REGISTRY.counter(
            "rafiki_warm_pool_ticks_total", "warm-pool maintenance ticks")

    # -- lifecycle ---------------------------------------------------------

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> "WarmPool":
        if self.running:
            return self
        self._closed.clear()
        self._thread = threading.Thread(target=self._loop, name="warm-pool",
                                        daemon=True)
        self._thread.start()
        logger.info("warm pool loop started (K=%d, interval %.1fs)",
                    int(config.AUTOSCALE_WARM_POOL),
                    float(config.AUTOSCALE_WARM_POOL_INTERVAL_S))
        return self

    def stop(self) -> None:
        self._closed.set()
        t = self._thread
        if t is not None:
            # a tick may sit in a standby's deploy wait
            t.join(timeout=float(config.SERVICE_DEPLOY_TIMEOUT_S) + 10)
        self._thread = None

    def _loop(self) -> None:
        while not self._closed.wait(
                float(config.AUTOSCALE_WARM_POOL_INTERVAL_S)):
            try:
                self.tick()
            except Exception:
                logger.exception("warm pool tick failed")

    # -- the loop ----------------------------------------------------------

    def tick(self) -> List[Dict[str, Any]]:
        """One pass over every RUNNING inference job; the actions
        taken."""
        self._m_ticks.inc()
        want = max(int(config.AUTOSCALE_WARM_POOL), 0)
        actions: List[Dict[str, Any]] = []
        seen = set()
        for job in self._db.get_inference_jobs_by_statuses(
                [InferenceJobStatus.RUNNING]):
            seen.add(job["id"])
            try:
                actions.extend(self._tick_job(job["id"], want))
            except Exception:
                logger.exception("warm pool tick for job %s failed",
                                 job["id"][:8])
        with self._lock:
            for job_id in [j for j in self._jobs if j not in seen]:
                del self._jobs[job_id]
                self._g_standbys.labels(job_id).set(0)
        return actions

    def _tick_job(self, job_id: str, want: int) -> List[Dict[str, Any]]:
        actions: List[Dict[str, Any]] = []
        standbys = self._services.standby_workers(job_id)
        cur: Dict[str, int] = {}
        for w in self._services.live_inference_workers(job_id):
            cur[w["group"]] = max(cur.get(w["group"], 0), w["model_version"])
        fresh = []
        for w in standbys:
            if w["model_version"] < cur.get(w["group"], 0):
                self._services.drop_standby(w["service_id"])
                actions.append(self._event(
                    job_id, "retire_stale", service_id=w["service_id"],
                    version=w["model_version"],
                    serving_version=cur.get(w["group"], 0)))
            else:
                fresh.append(w)
        standbys = fresh
        self._g_standbys.labels(job_id).set(len(standbys))
        while len(standbys) > want:
            w = standbys.pop()
            self._services.drop_standby(w["service_id"])
            actions.append(self._event(job_id, "shrink",
                                       service_id=w["service_id"]))
        state = self._state(job_id)
        now = time.monotonic()
        if state["degraded_until"] > now:
            return actions
        retry_max = max(int(config.AUTOSCALE_WARM_RETRY_MAX), 1)
        while len(standbys) < want:
            try:
                sid = self._services.create_standby_replica(job_id)
            except Exception as e:
                with self._lock:
                    state["failures"] += 1
                    state["last_error"] = f"{type(e).__name__}: {e}"
                    failures = state["failures"]
                logger.warning("warm pool: placing a standby for job %s "
                               "failed (%d consecutive): %s", job_id[:8],
                               failures, e)
                if failures >= retry_max:
                    cooldown = float(config.AUTOSCALE_WARM_RETRY_COOLDOWN_S)
                    with self._lock:
                        state["degraded_until"] = now + cooldown
                        state["failures"] = 0
                    actions.append(self._event(job_id, "degraded",
                                               error=str(e),
                                               cooldown_s=cooldown))
                else:
                    actions.append(self._event(job_id, "place_failed",
                                               error=str(e)))
                break
            with self._lock:
                state["failures"] = 0
                state["last_error"] = None
            standbys.append({"service_id": sid})
            self._g_standbys.labels(job_id).set(len(standbys))
            actions.append(self._event(job_id, "place", service_id=sid))
        return actions

    # -- replacing a dead replica ------------------------------------------

    def on_replica_errored(self, service_id: str,
                           inference_job_id: str) -> Optional[str]:
        """A routed replica died: promote a standby now and leave the top-up
        to the next tick. Returns the promoted id, or None (the pool is
        empty, or the dead replica was itself a standby)."""
        try:
            row = self._db.get_inference_job_worker(service_id)
        except Exception:
            return None
        if row is None or int(row.get("standby") or 0):
            return None
        promoted = self._services.promote_standby(inference_job_id)
        if promoted is not None:
            self._event(inference_job_id, "replace", failed=service_id,
                        promoted=promoted)
            logger.info("warm pool: replaced failed replica %s of job %s "
                        "with standby %s", service_id[:8],
                        inference_job_id[:8], promoted[:8])
        return promoted

    # -- reporting ---------------------------------------------------------

    def _state(self, job_id: str) -> Dict[str, Any]:
        with self._lock:
            return self._jobs.setdefault(
                job_id, {"failures": 0, "degraded_until": 0.0,
                         "last_error": None})

    def _event(self, job_id: str, action: str,
               **detail: Any) -> Dict[str, Any]:
        ev = {"ts": time.time(), "job_id": job_id, "action": action,
              **detail}
        with self._lock:
            self.events.append(ev)
        return ev

    def report(self) -> Dict[str, Any]:
        """Each job's failures and DEGRADED flag, the recent events and the
        loan split (the JAX package's fleet-health section)."""
        now = time.monotonic()
        with self._lock:
            jobs = {job_id: {"failures": st["failures"],
                             "degraded": st["degraded_until"] > now,
                             "last_error": st["last_error"]}
                    for job_id, st in self._jobs.items()}
            events = list(self.events)[-20:]
        out: Dict[str, Any] = {
            "enabled": int(config.AUTOSCALE_WARM_POOL) > 0,
            "running": self.running,
            "target_per_job": int(config.AUTOSCALE_WARM_POOL),
            "jobs": jobs,
            "events": events,
        }
        if self._arbiter is not None:
            out["loans"] = self._arbiter.loan_split()
        return out
