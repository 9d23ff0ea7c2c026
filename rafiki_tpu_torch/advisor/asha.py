"""Asynchronous successive halving (ASHA) for early-stopping trials.

Own copy of ``rafiki_tpu/advisor/asha.py``. A template that reports a
per-epoch ``loss`` through its ``ModelLogger`` (``fit(log=...)`` does)
gets rung-based early stopping: at resource levels ``min_resource *
eta^k`` epochs, a trial continues only while its value sits in the top
``1/eta`` of the values recorded at that rung so far by the trials of
its sub-train-job. Decisions are made per report, with no bracket
barrier (Li et al., "A System for Massively Parallel Hyperparameter
Tuning", MLSys 2020). While a rung holds fewer than ``eta`` values every
report passes, so the second trial of a job is not killed merely for
being worse than the first.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List


class AshaScheduler:
    """Shared per sub-train-job; thread-safe."""

    def __init__(self, min_resource: int = 1, eta: int = 3,
                 mode: str = "min"):
        if eta < 2:
            raise ValueError(f"eta must be >= 2, got {eta}")
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
        self.min_resource = max(int(min_resource), 1)
        self.eta = int(eta)
        self.mode = mode
        self._lock = threading.Lock()
        # rung resource -> {trial_id: value}; keyed by trial so a trial
        # that later errors can be forgotten
        self._rungs: Dict[int, Dict[str, float]] = {}
        self._recorded: Dict[str, set] = {}  # trial -> rungs seen

    def _rungs_reached(self, resource: int) -> List[int]:
        out, r = [], self.min_resource
        while r <= resource:
            out.append(r)
            r *= self.eta
        return out

    def report(self, trial_id: str, resource: int, value: float) -> bool:
        """Record ``value`` of ``trial_id`` at ``resource`` (epochs done);
        True to continue training, False to stop. A non-finite value stops.

        The value is recorded only at the highest rung this report newly
        reaches, and only when it was measured AT that rung's resource:
        skipped lower rungs (a resume past them, a sparse reporter) are
        marked seen without a record, so a later, better value never sets
        an unbeatable bar for fresh trials."""
        value = float(value)
        if not math.isfinite(value):
            return False
        with self._lock:
            seen = self._recorded.setdefault(trial_id, set())
            new_rungs = [r for r in self._rungs_reached(int(resource))
                         if r not in seen]
            seen.update(new_rungs)
            if not new_rungs:
                return True  # between rungs: no decision point
            rung = new_rungs[-1]
            if int(resource) != rung:
                return True  # measured past the rung's resource
            values = self._rungs.setdefault(rung, {})
            values[trial_id] = value
            if len(values) < self.eta:
                return True  # not enough evidence at this rung yet
            ranked = sorted(values.values(), reverse=(self.mode == "max"))
            top_k = max(int(math.ceil(len(ranked) / self.eta)), 1)
            threshold = ranked[top_k - 1]
            return (value <= threshold if self.mode == "min"
                    else value >= threshold)

    def forget(self, trial_id: str) -> None:
        """Erase a trial's rung records: it errored after reporting, and a
        dead trial must not hold top-1/eta slots against healthy ones."""
        with self._lock:
            for values in self._rungs.values():
                values.pop(trial_id, None)
            self._recorded.pop(trial_id, None)
