"""In-model structured logging.

Own copy of ``ModelLogger`` and ``StopTrialEarly`` from
``rafiki_tpu/sdk/log.py``: model code logs messages, metrics and plot
definitions as typed JSON lines; the train worker installs a sink that
appends each line to the trial's log in the store. ``parse_logs`` (the
admin's reader) comes with the control-plane slice (ROADMAP.md).
"""

from __future__ import annotations

import json
import time
from typing import Any, Callable, Dict, List, Optional

LogLine = str
Sink = Callable[[LogLine], None]


class LogType:
    MESSAGE = "MESSAGE"
    METRICS = "METRICS"
    PLOT = "PLOT"


class StopTrialEarly(Exception):
    """Raised out of ``ModelLogger.log`` when the trial's stop check says
    stop (in the JAX package, ASHA's verdict; the port's ASHA waits,
    ROADMAP.md). The SDK trainer's fit() catches it and returns the current
    params; the train worker also catches it around ``model.train`` for
    templates with hand-rolled loops — either way the trial proceeds to
    evaluate() and completes with the score its truncated training
    earned."""


class ModelLogger:
    """Structured logger injected into models as ``self.logger`` / the module
    singleton ``logger``. Thread-safe enough for one trial per logger instance
    (the worker swaps sinks per trial, mirroring reference set_logger at
    rafiki/model/log.py:104)."""

    def __init__(self) -> None:
        self._sink: Optional[Sink] = None
        self._echo = True
        self._stop_check: Optional[Callable[[Dict[str, float]], bool]] = None

    def set_sink(self, sink: Optional[Sink], echo: bool = False) -> None:
        self._sink = sink
        self._echo = echo or sink is None

    def set_stop_check(
        self, check: Optional[Callable[[Dict[str, float]], bool]]
    ) -> None:
        """Install a per-metrics-report early-stop predicate.
        ``check(metrics) -> True`` makes the next ``log(**metrics)`` raise
        StopTrialEarly."""
        self._stop_check = check

    def log(self, msg: str = "", **metrics: float) -> None:
        """Log a free-form message and/or named numeric metrics."""
        if msg:
            self._emit({"type": LogType.MESSAGE, "message": str(msg)})
        if metrics:
            clean = {k: float(v) for k, v in metrics.items()}
            self._emit({"type": LogType.METRICS, "metrics": clean})
            if self._stop_check is not None and self._stop_check(clean):
                raise StopTrialEarly(
                    f"scheduler stopped this trial at {clean}")

    def define_plot(
        self, title: str, metrics: List[str], x_axis: Optional[str] = None
    ) -> None:
        """Declare that `metrics` should be plotted against `x_axis`
        (default: log time)."""
        self._emit(
            {"type": LogType.PLOT, "title": title, "metrics": list(metrics), "x_axis": x_axis}
        )

    def _emit(self, record: Dict[str, Any]) -> None:
        record["time"] = time.time()
        line = json.dumps(record)
        if self._sink is not None:
            self._sink(line)
        if self._echo:
            print(f"[model] {line}")


#: module singleton used by model code outside a worker
#: (``from rafiki_tpu_torch.sdk.log import logger``)
logger = ModelLogger()
