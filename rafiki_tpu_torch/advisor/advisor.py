"""Advisor sessions: propose/feedback over knob configs.

Own copy of ``rafiki_tpu/advisor/advisor.py``: the ``BaseAdvisor``
contract, the GP-backed default ``Advisor``, ``RandomAdvisor``, and the
thread-safe ``AdvisorStore`` keyed by advisor id (one session per
sub-train-job, shared by its workers, and served on the admin's REST door
to worker processes), with batch proposals and feedback. Infeasible
feedback, replay after a restart and the ASHA scheduler wait
(ROADMAP.md).
"""

from __future__ import annotations

import threading
import uuid
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

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


class BaseAdvisor:
    """Contract: propose a knob assignment; feed back its achieved score."""

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

    @property
    def observation_count(self) -> int:
        raise NotImplementedError


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

    @property
    def observation_count(self) -> int:
        return len(self._opt.observed_y)


class RandomAdvisor(BaseAdvisor):
    """Uniform random search baseline."""

    def __init__(self, knob_config: KnobConfig, seed: int = 0):
        super().__init__(knob_config)
        self._rng = np.random.default_rng(seed)
        self._dims = knob_config_dims(knob_config)
        self._n_observed = 0

    def propose(self) -> Dict[str, Any]:
        return _jsonify(knobs_from_unit(self.knob_config,
                                        self._rng.random(self._dims)))

    def propose_batch(self, k: int) -> List[Dict[str, Any]]:
        # one draw for the batch: uniform draws need no spreading
        u = self._rng.random((max(int(k), 1), self._dims))
        return [_jsonify(knobs_from_unit(self.knob_config, row)) for row in u]

    def feedback(self, knobs: Dict[str, Any], score: float) -> None:
        self._n_observed += 1

    @property
    def observation_count(self) -> int:
        return self._n_observed


class AdvisorStore:
    """Sessionized, thread-safe advisor registry."""

    _TYPES = {"GP": Advisor, "RANDOM": RandomAdvisor}

    def __init__(self) -> None:
        self._advisors: Dict[str, BaseAdvisor] = {}
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

    def feedback(self, advisor_id: str, knobs: Dict[str, Any],
                 score: float) -> Dict[str, Any]:
        """Record a score; returns the next proposal (the reference's
        feedback-returns-next-proposal API)."""
        advisor = self.get(advisor_id)
        advisor.feedback(knobs, score)
        return advisor.propose()
