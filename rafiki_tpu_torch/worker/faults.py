"""Trial fault taxonomy for the training plane.

Own copy of ``rafiki_tpu/worker/faults.py``. Kinds and their contracts:

``INFRA``
    The platform failed the trial, not the template (chaos injection, a
    transient store error, a failed params write). Retried under the
    SAME trial id with jittered backoff (``RAFIKI_TRIAL_RETRY_MAX``),
    resuming from the trial's checkpoint; no extra budget slot.
``MEM``
    A host ``MemoryError``. Retried like INFRA; terminal MEM is fed to the
    advisor as infeasible and counts toward quarantine, not fail-fast.
``USER``
    The template's own code raised: any exception not provably the
    platform's. Terminal: consumes the budget slot, feeds the advisor an
    infeasible observation, counts toward quarantine and fail-fast.
``TIMEOUT``
    Terminal and infeasible like USER: a sandboxed trial past its
    ``TRIAL_TIMEOUT_S`` that ignored STOP, killed by the watchdog
    (``sdk/sandbox.py``).
``STALL``
    Retried like INFRA: a sandbox child that produced no frame within
    ``RAFIKI_TRIAL_STALL_S`` of its spawn, killed by the watchdog.
``INVALID_SCORE``
    ``evaluate()`` returned NaN/inf/non-numeric. Terminal and infeasible.

A device OOM is ``USER``, as in the JAX package: PyTorch's
``torch.cuda.OutOfMemoryError`` subclasses ``RuntimeError``, not
``MemoryError`` (as XLA's ``RESOURCE_EXHAUSTED`` is a ``RuntimeError``
there), so it falls to the conservative default. A knob draw that does
not fit the card is a verdict on its knobs, so the infeasible feedback
and the quarantine steer away from it.

Left out of ``classify_failure``: the ``psycopg2`` branch (the PostgreSQL
store is not ported). The in-process ``TRAINING_STATS`` keep JAX's keys,
and the metrics registry mirrors them under JAX's names
(``rafiki_training_{faults,retries,counter}_total``,
``rafiki_training_quarantined_signatures``).
"""

from __future__ import annotations

import json
import math
import sqlite3
import threading
import traceback
from typing import Any, Dict, Iterable, Optional, Tuple

from rafiki_tpu_torch.utils.metrics import REGISTRY


class FaultKind:
    INFRA = "INFRA"
    MEM = "MEM"
    USER = "USER"
    TIMEOUT = "TIMEOUT"
    STALL = "STALL"
    INVALID_SCORE = "INVALID_SCORE"

    ALL = (INFRA, MEM, USER, TIMEOUT, STALL, INVALID_SCORE)


#: re-run under the same trial id (no budget consumed)
RETRYABLE_KINDS = (FaultKind.INFRA, FaultKind.MEM, FaultKind.STALL)

#: the template's doing at these knobs: terminal, and fed to the advisor
#: as an infeasible observation
INFEASIBLE_KINDS = (FaultKind.USER, FaultKind.TIMEOUT,
                    FaultKind.INVALID_SCORE)


def is_infeasible_row(trial: Dict[str, Any]) -> bool:
    """Should this trial row feed the advisor as infeasible (replay,
    quarantine rebuild)? ERRORED user-class kinds, and ERRORED MEM. A
    COMPLETED or RUNNING row's kind is that of an absorbed transient
    fault, not a verdict on its knobs."""
    if trial.get("status") != "ERRORED":
        return False
    kind = trial.get("fault_kind")
    return kind in INFEASIBLE_KINDS or kind == FaultKind.MEM


#: how much of the traceback survives onto the trial row
FAULT_DETAIL_MAX = 2000


class TrialFault(Exception):
    """Base for typed trial failures; carries its taxonomy kind."""

    kind = FaultKind.INFRA

    def __init__(self, detail: str, kind: Optional[str] = None):
        super().__init__(detail)
        if kind is not None:
            self.kind = kind


class TrialChaosError(TrialFault):
    """``RAFIKI_CHAOS`` site=trial action=error: the drillable stand-in
    for a transient platform fault."""

    kind = FaultKind.INFRA


class InvalidScoreError(TrialFault):
    """evaluate() produced NaN/inf/non-numeric: unusable as a score."""

    kind = FaultKind.INVALID_SCORE


def validate_score(raw: Any) -> float:
    """The score gate: a finite float, else :class:`InvalidScoreError`
    (a NaN must never reach the advisor)."""
    try:
        score = float(raw)
    except (TypeError, ValueError) as e:
        raise InvalidScoreError(
            f"evaluate() returned non-numeric {type(raw).__name__}: "
            f"{e}") from e
    if not math.isfinite(score):
        raise InvalidScoreError(f"evaluate() returned non-finite {score!r}")
    return score


def classify_failure(exc: BaseException) -> Tuple[str, str]:
    """Map a trial-execution exception to ``(fault_kind, detail)``. Typed
    faults carry their kind; otherwise only a ``MemoryError`` (MEM) and a
    SQLite operational error (INFRA: a locked store under concurrent
    workers) and a chaos-injected store fault (the ``db`` site) are the
    platform's, and everything else is USER, because a template bug taken
    for INFRA would retry forever at no budget cost."""
    detail = f"{type(exc).__name__}: {exc}"
    tb = traceback.format_exc()
    if tb and tb != "NoneType: None\n":
        detail = f"{detail}\n{tb}"
    detail = detail[-FAULT_DETAIL_MAX:]
    kind = getattr(exc, "kind", None)
    if kind in FaultKind.ALL:
        return kind, detail
    if isinstance(exc, MemoryError):
        return FaultKind.MEM, detail
    if isinstance(exc, sqlite3.OperationalError):
        return FaultKind.INFRA, detail
    from rafiki_tpu_torch.db.database import MetadataStoreChaosError

    if isinstance(exc, MetadataStoreChaosError):
        return FaultKind.INFRA, detail
    # torch.cuda.OutOfMemoryError lands here (module docstring)
    return FaultKind.USER, detail


# -- poison-knob signatures --------------------------------------------------

#: each unit-cube coordinate rounds to 1/SIGNATURE_GRID: close draws share
#: a signature, distant ones never do
SIGNATURE_GRID = 8


def knob_signature(knob_config, knobs: Dict[str, Any]) -> str:
    """Stable signature of a knob assignment for quarantine matching,
    measured in the knobs' own unit cube (``sdk/knob.py``) and quantized;
    the sorted JSON of the raw knobs when no config is given."""
    if knob_config is not None:
        try:
            from rafiki_tpu_torch.sdk.knob import knobs_to_unit

            u = knobs_to_unit(knob_config, knobs)
            cells = [int(round(float(x) * SIGNATURE_GRID)) for x in u]
            return "u:" + ",".join(str(c) for c in cells)
        except Exception:  # unexpected knob shape: the JSON signature
            pass
    return "j:" + json.dumps(knobs, sort_keys=True, default=str)


def poison_signature_counts(trials: Iterable[Dict[str, Any]],
                            knob_config) -> Dict[str, int]:
    """Signature -> poison-fault count over ``trials``
    (:func:`is_infeasible_row` rows)."""
    counts: Dict[str, int] = {}
    for t in trials:
        if not is_infeasible_row(t):
            continue
        sig = knob_signature(knob_config, t.get("knobs") or {})
        counts[sig] = counts.get(sig, 0) + 1
    return counts


def quarantined_signatures(trials: Iterable[Dict[str, Any]], knob_config,
                           threshold: int) -> Dict[str, int]:
    """Signatures with >= ``threshold`` poison faults among ``trials``."""
    counts = poison_signature_counts(trials, knob_config)
    return {s: n for s, n in counts.items() if n >= max(int(threshold), 1)}


# -- per-worker training-plane counters --------------------------------------

#: sub_train_job_id -> counters of the workers in this process; bounded
#: (least recently updated entries drop past the cap: the trial rows keep
#: the durable record)
TRAINING_STATS: Dict[str, Dict[str, Any]] = {}
_STATS_CAP = 256
_STATS_LOCK = threading.Lock()


def training_stats() -> Dict[str, Dict[str, Any]]:
    """A snapshot (a copy: callers may mutate it)."""
    with _STATS_LOCK:
        return {
            k: {**v, "faults": dict(v.get("faults", {})),
                "quarantined": list(v.get("quarantined", []))}
            for k, v in TRAINING_STATS.items()
        }


def _stats_entry(sub_id: str) -> Dict[str, Any]:  # guarded-by: _STATS_LOCK
    entry = TRAINING_STATS.pop(sub_id, None)
    if entry is None:
        entry = {
            "faults": {},            # fault kind -> count
            "retries": 0,            # infra-class re-runs (no budget burned)
            "quarantined": [],       # live poison-knob signatures
            "reproposals": 0,        # proposals rejected for quarantine
            "feedback_dropped": 0,   # pending-feedback overflow drops
            "consecutive_user_faults": 0,
        }
    # re-inserted at the end: insertion order is the LRU order
    TRAINING_STATS[sub_id] = entry
    while len(TRAINING_STATS) > _STATS_CAP:
        TRAINING_STATS.pop(next(iter(TRAINING_STATS)))
    return entry


def record_fault(sub_id: str, kind: str, retried: bool = False) -> None:
    """Terminal faults count by kind; absorbed (retried) ones only as
    retries. The registry's process-wide mirrors keep the same split."""
    with _STATS_LOCK:
        s = _stats_entry(sub_id)
        if retried:
            s["retries"] += 1
        else:
            s["faults"][kind] = s["faults"].get(kind, 0) + 1
    if retried:
        REGISTRY.counter(
            "rafiki_training_retries_total",
            "infra-class trial faults absorbed by same-id retry").inc()
    else:
        REGISTRY.counter(
            "rafiki_training_faults_total",
            "terminal trial faults by taxonomy kind", ("kind",)
        ).labels(kind).inc()


def record_quarantine(sub_id: str, signatures: Iterable[str]) -> None:
    with _STATS_LOCK:
        s = _stats_entry(sub_id)
        s["quarantined"] = sorted(set(s["quarantined"]) | set(signatures))
        total = sum(len(v.get("quarantined", ()))
                    for v in TRAINING_STATS.values())
    REGISTRY.gauge(
        "rafiki_training_quarantined_signatures",
        "poison-knob signatures currently quarantined in this process"
    ).set(total)


def record_counter(sub_id: str, counter: str, value: int = 1,
                   absolute: bool = False) -> None:
    with _STATS_LOCK:
        s = _stats_entry(sub_id)
        s[counter] = value if absolute else s.get(counter, 0) + value
    if not absolute:
        REGISTRY.counter(
            "rafiki_training_counter_total",
            "training-plane worker counters", ("counter",)
        ).labels(counter).inc(value)


def reset_stats(sub_id: Optional[str] = None) -> None:
    with _STATS_LOCK:
        if sub_id is None:
            TRAINING_STATS.clear()
        else:
            TRAINING_STATS.pop(sub_id, None)
