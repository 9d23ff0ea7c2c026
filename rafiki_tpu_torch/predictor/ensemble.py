"""Prediction ensembling across the best trials of a train job.

Counterpart of ``rafiki_tpu/predictor/ensemble.py``: for classification
tasks the per-trial probability vectors are averaged elementwise; other
tasks take the first trial's answer. Outputs are JSON-native.
"""

from __future__ import annotations

from typing import Any, List, Optional

import numpy as np

_PROB_TASKS = {"IMAGE_CLASSIFICATION", "TEXT_CLASSIFICATION"}


def _to_json_native(value: Any) -> Any:
    if isinstance(value, np.ndarray):
        return value.tolist()
    if isinstance(value, np.integer):
        return int(value)
    if isinstance(value, np.floating):
        return float(value)
    if isinstance(value, dict):
        return {k: _to_json_native(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_to_json_native(v) for v in value]
    return value


def ensemble_predictions(worker_predictions: List[Any],
                         task: Optional[str]) -> Any:
    """Combine one query's predictions, one per trial, into one."""
    worker_predictions = [p for p in worker_predictions if p is not None]
    if not worker_predictions:
        return []
    if task in _PROB_TASKS:
        try:
            stacked = np.asarray(worker_predictions, dtype=np.float64)
            return _to_json_native(stacked.mean(axis=0))
        except (ValueError, TypeError):
            pass  # ragged or non-numeric predictions: take the first
    return _to_json_native(worker_predictions[0])
