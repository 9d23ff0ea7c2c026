"""An in-memory trial store.

Stands in for ``rafiki_tpu/db/database.py`` until the control-plane slice
(ROADMAP.md): it holds what an inference worker reads to serve one trial,
namely the template's source bytes, its class name, the trial's knobs and
its parameter artifact (``sdk/params.py`` bytes).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional


class TrialStore:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._trials: Dict[str, Dict[str, Any]] = {}

    def add_trial(self, trial_id: str, model_file_bytes: bytes,
                  model_class: str, knobs: Dict[str, Any],
                  params_bytes: bytes) -> None:
        with self._lock:
            self._trials[trial_id] = {
                "id": trial_id, "model_file_bytes": model_file_bytes,
                "model_class": model_class, "knobs": dict(knobs),
                "params_bytes": params_bytes}

    def get_trial(self, trial_id: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            trial = self._trials.get(trial_id)
            return dict(trial) if trial is not None else None
