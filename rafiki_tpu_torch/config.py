"""Serving and training settings, read from the same environment names
with the same defaults as ``rafiki_tpu/config.py``.

``PREDICT_QUEUE_DEPTH`` and ``PARAMS_DIR`` are read at each use (module
``__getattr__``), as in the JAX package, so a test or an operator can
retune them without re-importing.
"""

from __future__ import annotations

import os


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def _env_float(name: str, default: float) -> float:
    return float(os.environ.get(name, default))


#: most queries an inference worker serves in one batch
PREDICT_MAX_BATCH_SIZE = _env_int("PREDICT_MAX_BATCH_SIZE", 64)
#: coalescing wait after the first query of a batch (0 = serve at once)
PREDICT_BATCH_DEADLINE_MS = _env_float("PREDICT_BATCH_DEADLINE_MS", 0.0)
#: default request deadline at the predictor
PREDICT_TIMEOUT_S = _env_float("PREDICT_TIMEOUT_S", 30.0)
#: request-body ceiling on the /predict door (413 above it)
PREDICT_MAX_BODY_MB = _env_float("PREDICT_MAX_BODY_MB", 64.0)
#: trials per train job when its budget names no MODEL_TRIAL_COUNT
DEFAULT_TRIAL_COUNT = _env_int("DEFAULT_TRIAL_COUNT", 5)


def __getattr__(name: str):
    if name == "PREDICT_QUEUE_DEPTH":
        # per-worker inbox cap; submits beyond it raise QueueFullError
        # (0 = uncapped)
        return _env_int("RAFIKI_PREDICT_QUEUE_DEPTH", 256)
    if name == "PARAMS_DIR":
        # where train workers write trial params and checkpoints
        return os.environ.get("RAFIKI_PARAMS_DIR", os.path.join(
            os.environ.get("RAFIKI_WORKDIR", os.path.abspath(".")),
            "params"))
    raise AttributeError(name)
