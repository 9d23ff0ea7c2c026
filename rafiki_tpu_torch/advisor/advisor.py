"""Advisor sessions: propose/feedback over knob configs.

Own copy of ``rafiki_tpu/advisor/advisor.py``: the ``BaseAdvisor``
contract, the GP-backed default ``Advisor``, ``RandomAdvisor``, and the
thread-safe ``AdvisorStore`` keyed by advisor id (one session per
sub-train-job, shared by its workers, and served on the admin's REST door
to worker processes), with batch proposals and feedback, infeasible
feedback (a trial that failed without a score), the replay that rebuilds
a fresh session after a restart, and each session's ASHA scheduler
(``report_rung``, ``advisor/asha.py``).
"""

from __future__ import annotations

import logging
import threading
import uuid
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from rafiki_tpu_torch.advisor.asha import AshaScheduler
from rafiki_tpu_torch.advisor.gp import BayesOpt
from rafiki_tpu_torch.sdk.knob import (
    KnobConfig,
    knob_config_dims,
    knobs_from_unit,
    knobs_to_unit,
)


def _jsonify(value: Any) -> Any:
    """Simplify numpy scalars into JSON-native types."""
    if isinstance(value, np.integer):
        return int(value)
    if isinstance(value, np.floating):
        return float(value)
    if isinstance(value, np.bool_):
        return bool(value)
    if isinstance(value, dict):
        return {k: _jsonify(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_jsonify(v) for v in value]
    return value


logger = logging.getLogger(__name__)


class BaseAdvisor:
    """Contract: propose a knob assignment; feed back its achieved score.
    ``observation_count`` is part of it: the store's empty-only replay
    reads it."""

    def __init__(self, knob_config: KnobConfig):
        self.knob_config = knob_config

    def propose(self) -> Dict[str, Any]:
        raise NotImplementedError

    def propose_batch(self, k: int) -> List[Dict[str, Any]]:
        """``k`` assignments to evaluate together; each advisor keeps its
        sequential proposals apart, so the default loops ``propose``."""
        return [self.propose() for _ in range(max(int(k), 1))]

    def feedback(self, knobs: Dict[str, Any], score: float) -> None:
        raise NotImplementedError

    def feedback_batch(self,
                       items: List[Tuple[Dict[str, Any], float]]) -> int:
        """Record (knobs, score) observations one by one; how many."""
        for knobs, score in items:
            self.feedback(knobs, float(score))
        return len(items)

    def feedback_infeasible(self, knobs: Dict[str, Any],
                            kind: str = "USER") -> None:
        """The trial at ``knobs`` failed without a usable score. Optional:
        ignored here; the GP steers its proposals away."""

    @property
    def observation_count(self) -> int:
        raise NotImplementedError

    @property
    def infeasible_count(self) -> int:
        return 0


class Advisor(BaseAdvisor):
    """GP Bayesian-optimization advisor (the default).

    Thread-safe: one instance is shared by all parallel workers of a
    sub-train-job, with in-flight proposals fantasized (constant liar) so
    concurrent trials explore different regions.
    """

    def __init__(self, knob_config: KnobConfig, seed: int = 0):
        super().__init__(knob_config)
        self._opt = BayesOpt(knob_config_dims(knob_config), seed=seed)
        self._lock = threading.Lock()

    def propose(self) -> Dict[str, Any]:
        with self._lock:
            return self._propose_locked()

    def _propose_locked(self) -> Dict[str, Any]:  # guarded-by: _lock
        u = self._opt.suggest(register_pending=False)
        knobs = knobs_from_unit(self.knob_config, u)
        # register the *quantized* point (integer/categorical knobs round
        # to a grid) so feedback's re-encoding retires it by value
        self._opt.mark_pending(knobs_to_unit(self.knob_config, knobs))
        return _jsonify(knobs)

    def propose_batch(self, k: int) -> List[Dict[str, Any]]:
        """``k`` proposals under one lock hold, each registered as pending
        before the next is drawn, so a sibling worker cannot interleave
        and the batch spreads."""
        with self._lock:
            return [self._propose_locked() for _ in range(max(int(k), 1))]

    def feedback(self, knobs: Dict[str, Any], score: float) -> None:
        u = knobs_to_unit(self.knob_config, knobs)
        with self._lock:
            self._opt.observe(u, float(score))

    def feedback_infeasible(self, knobs: Dict[str, Any],
                            kind: str = "USER") -> None:
        u = knobs_to_unit(self.knob_config, knobs)
        with self._lock:
            self._opt.mark_infeasible(u)

    @property
    def history(self) -> List[Tuple[np.ndarray, float]]:
        return list(zip(self._opt.observed_X, self._opt.observed_y))

    @property
    def observation_count(self) -> int:
        return len(self._opt.observed_y)

    @property
    def infeasible_count(self) -> int:
        return len(self._opt.infeasible_X)


class RandomAdvisor(BaseAdvisor):
    """Uniform random search baseline."""

    def __init__(self, knob_config: KnobConfig, seed: int = 0):
        super().__init__(knob_config)
        self._rng = np.random.default_rng(seed)
        self._dims = knob_config_dims(knob_config)
        self._n_observed = 0
        self._n_infeasible = 0

    def propose(self) -> Dict[str, Any]:
        return _jsonify(knobs_from_unit(self.knob_config,
                                        self._rng.random(self._dims)))

    def propose_batch(self, k: int) -> List[Dict[str, Any]]:
        # one draw for the batch: uniform draws need no spreading
        u = self._rng.random((max(int(k), 1), self._dims))
        return [_jsonify(knobs_from_unit(self.knob_config, row)) for row in u]

    def feedback(self, knobs: Dict[str, Any], score: float) -> None:
        self._n_observed += 1

    def feedback_infeasible(self, knobs: Dict[str, Any],
                            kind: str = "USER") -> None:
        # no model to steer: counted for observability
        self._n_infeasible += 1

    @property
    def observation_count(self) -> int:
        return self._n_observed

    @property
    def infeasible_count(self) -> int:
        return self._n_infeasible


class AdvisorStore:
    """Sessionized, thread-safe advisor registry."""

    _TYPES = {"GP": Advisor, "RANDOM": RandomAdvisor}

    def __init__(self) -> None:
        self._advisors: Dict[str, BaseAdvisor] = {}
        self._schedulers: Dict[str, AshaScheduler] = {}
        self._lock = threading.Lock()

    def create_advisor(
        self,
        knob_config: KnobConfig,
        advisor_id: Optional[str] = None,
        advisor_type: str = "GP",
    ) -> str:
        advisor_id = advisor_id or uuid.uuid4().hex
        with self._lock:
            if advisor_id not in self._advisors:
                self._advisors[advisor_id] = self._TYPES[advisor_type](
                    knob_config)
        return advisor_id

    def get(self, advisor_id: str) -> BaseAdvisor:
        with self._lock:
            if advisor_id not in self._advisors:
                raise KeyError(f"No such advisor: {advisor_id}")
            return self._advisors[advisor_id]

    def propose(self, advisor_id: str) -> Dict[str, Any]:
        return self.get(advisor_id).propose()

    def propose_batch(self, advisor_id: str, k: int) -> List[Dict[str, Any]]:
        return self.get(advisor_id).propose_batch(k)

    def feedback_batch(self, advisor_id: str,
                       items: List[Tuple[Dict[str, Any], float]]) -> int:
        return int(self.get(advisor_id).feedback_batch(items))

    def delete_advisor(self, advisor_id: str) -> None:
        with self._lock:
            self._advisors.pop(advisor_id, None)
            self._schedulers.pop(advisor_id, None)

    def feedback(self, advisor_id: str, knobs: Dict[str, Any],
                 score: float) -> Dict[str, Any]:
        """Record a score; returns the next proposal (the reference's
        feedback-returns-next-proposal API)."""
        advisor = self.get(advisor_id)
        advisor.feedback(knobs, score)
        return advisor.propose()

    def feedback_infeasible(self, advisor_id: str, knobs: Dict[str, Any],
                            kind: str = "USER",
                            trial_id: Optional[str] = None) -> int:
        """Record a scoreless failure at ``knobs``; with ``trial_id``, the
        session's ASHA scheduler forgets the trial's rung records. Returns
        the session's infeasible count."""
        advisor = self.get(advisor_id)
        advisor.feedback_infeasible(knobs, kind)
        if trial_id is not None:
            with self._lock:
                sched = self._schedulers.get(advisor_id)
            if sched is not None:
                sched.forget(trial_id)
        return advisor.infeasible_count

    def replay_feedback(
            self, advisor_id: str, items: List[Tuple[Dict[str, Any], float]],
            infeasible: Optional[List[Tuple[Dict[str, Any], str]]] = None,
    ) -> bool:
        """Seed a FRESH session with already-scored (knobs, score) pairs
        and (knobs, fault kind) infeasible ones: how a restarted worker
        rebuilds the GP from the store. Atomic and empty-only: a session
        holding any observation or infeasible point (it survived, or a
        sibling replayed first) is left as it is, and False returned."""
        with self._lock:
            advisor = self._advisors.get(advisor_id)
            if advisor is None:
                raise KeyError(f"No such advisor: {advisor_id}")
            if advisor.observation_count > 0 or advisor.infeasible_count > 0:
                return False
            for knobs, score in items:
                advisor.feedback(knobs, float(score))
            for knobs, kind in infeasible or []:
                advisor.feedback_infeasible(knobs, str(kind))
            return True

    def report_rung(self, advisor_id: str, trial_id: str, resource: int,
                    value: float, min_resource: int = 1, eta: int = 3,
                    mode: str = "min") -> bool:
        """ASHA's check: record a trial's intermediate metric; whether it
        should continue. One scheduler a session, made by the first
        report: a caller asking for another ladder is warned and competes
        under the existing one."""
        with self._lock:
            if advisor_id not in self._advisors:
                raise KeyError(f"No such advisor: {advisor_id}")
            sched = self._schedulers.get(advisor_id)
            if sched is None:
                sched = self._schedulers[advisor_id] = AshaScheduler(
                    min_resource=min_resource, eta=eta, mode=mode)
            elif (sched.min_resource, sched.eta, sched.mode) != (
                    max(int(min_resource), 1), int(eta), mode):
                logger.warning(
                    "ASHA params (%s,%s,%s) differ from session %s's "
                    "live scheduler (%s,%s,%s); using the existing one",
                    min_resource, eta, mode, advisor_id,
                    sched.min_resource, sched.eta, sched.mode)
        return sched.report(trial_id, resource, value)
