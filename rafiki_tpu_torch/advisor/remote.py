"""Advisor sessions over the admin's REST door: a worker process's view.

Own copy of ``rafiki_tpu/advisor/remote.py``. The advisor store lives in
the admin process and is served on its door (``/advisors/*``,
``admin/http.py``); :class:`RemoteAdvisorStore` gives a process-placed
``TrainWorker`` the in-process ``AdvisorStore``'s interface over it, so
the train workers of one sub-train-job, each its own process, still share
one GP.

An advisor call rides out an admin that cannot be reached for a while
(a transport failure: connection refused or reset, or no address of the
list answering) or that is still recovering (the recovering 503,
:class:`~rafiki_tpu_torch.client.client.AdminRecoveringError`): it
retries with jittered backoff for ``RAFIKI_ADVISOR_RETRY_S`` seconds
(default 60; 0 retries never), then raises the last error. Any other
answer, a 500 among them, raises at once, as in the JAX package (the
port retried every 5xx before crash recovery landed). A retried call whose first
answer was lost after the admin applied it is applied twice; a duplicate
observation is noise the GP tolerates.

Differences from the original: it speaks through the port's ``urllib``
``Client`` (``requests`` is not on the card's machine); and the worker's
per-trial feedback goes through the batch route, which returns no
proposal. The original's ``/feedback`` answers with a next proposal that
the GP registers as pending and no trial ever takes, so a process-placed
worker would leave the GP in another state than a thread-placed one.
Infeasible feedback, replay and rung reports ride out an unreachable
admin the same way; a re-applied infeasible point lands in an already
penalized cell of the GP.
"""

from __future__ import annotations

import http.client
import logging
import os
import random
import time
from typing import Any, Callable, Dict, List, Optional, Tuple, TypeVar

from rafiki_tpu_torch.client.client import (
    AdminRecoveringError,
    AdminUnavailableError,
    Client,
)
from rafiki_tpu_torch.sdk.knob import serialize_knob_config

logger = logging.getLogger(__name__)

T = TypeVar("T")


def _retry_window_s() -> float:
    return float(os.environ.get("RAFIKI_ADVISOR_RETRY_S", "60"))


#: what an advisor call rides out: transport failures and the recovering
#: 503
RETRYABLE = (AdminUnavailableError, AdminRecoveringError, OSError,
             http.client.HTTPException)


def _ride_out(fn: Callable[[], T], what: str) -> T:
    """Run one advisor call, retrying an unreachable or recovering admin
    until the window closes; then the last error propagates."""
    deadline = time.monotonic() + _retry_window_s()
    delay = 0.2
    while True:
        try:
            return fn()
        except RETRYABLE as e:
            if time.monotonic() >= deadline:
                raise
            logger.warning("advisor call %s failed (%s: %s); retrying for "
                           "up to RAFIKI_ADVISOR_RETRY_S", what,
                           type(e).__name__, e)
            time.sleep(delay * random.uniform(0.5, 1.5))
            delay = min(delay * 2, 5.0)


class _RemoteAdvisor:
    """Duck-types ``BaseAdvisor`` for the call ``TrainWorker`` makes."""

    def __init__(self, client: Client, advisor_id: str):
        self._client = client
        self._id = advisor_id

    def feedback(self, knobs: Dict[str, Any], score: float) -> None:
        # the batch route: no next proposal is drawn (module docstring)
        _ride_out(lambda: self._client.feedback_knobs_batch(
            self._id, [(knobs, float(score))]), "feedback")

    def feedback_infeasible(self, knobs: Dict[str, Any],
                            kind: str = "USER") -> None:
        _ride_out(lambda: self._client.feedback_infeasible_knobs(
            self._id, knobs, kind=kind), "feedback_infeasible")


class RemoteAdvisorStore:
    """``AdvisorStore``'s interface over the admin's REST door."""

    def __init__(self, client: Client):
        self._client = client

    def create_advisor(self, knob_config: Dict[str, Any],
                       advisor_id: Optional[str] = None) -> str:
        return _ride_out(lambda: self._client.create_advisor(
            serialize_knob_config(knob_config), advisor_id=advisor_id),
            "create_advisor")

    def get(self, advisor_id: str) -> _RemoteAdvisor:
        return _RemoteAdvisor(self._client, advisor_id)

    def propose(self, advisor_id: str) -> Dict[str, Any]:
        return _ride_out(lambda: self._client.propose_knobs(advisor_id),
                         "propose")

    def propose_batch(self, advisor_id: str, k: int) -> List[Dict[str, Any]]:
        return _ride_out(
            lambda: self._client.propose_knobs_batch(advisor_id, k),
            "propose_batch")

    def feedback(self, advisor_id: str, knobs: Dict[str, Any],
                 score: float) -> Dict[str, Any]:
        """Record a score; returns the next proposal."""
        return _ride_out(lambda: self._client.feedback_knobs(
            advisor_id, knobs, float(score)), "feedback")

    def feedback_batch(self, advisor_id: str,
                       items: List[Tuple[Dict[str, Any], float]]) -> int:
        return _ride_out(
            lambda: self._client.feedback_knobs_batch(advisor_id, items),
            "feedback_batch")

    def feedback_infeasible(self, advisor_id: str, knobs: Dict[str, Any],
                            kind: str = "USER",
                            trial_id: Optional[str] = None) -> int:
        return _ride_out(lambda: self._client.feedback_infeasible_knobs(
            advisor_id, knobs, kind=kind, trial_id=trial_id),
            "feedback_infeasible")

    def replay_feedback(self, advisor_id: str,
                        items: List[Tuple[Dict[str, Any], float]],
                        infeasible: Optional[List[Tuple[Dict[str, Any],
                                                        str]]] = None
                        ) -> bool:
        return _ride_out(lambda: self._client.replay_advisor_feedback(
            advisor_id, items, infeasible=infeasible), "replay_feedback")

    def report_rung(self, advisor_id: str, trial_id: str, resource: int,
                    value: float, min_resource: int = 1, eta: int = 3,
                    mode: str = "min") -> bool:
        return _ride_out(lambda: self._client.report_rung(
            advisor_id, trial_id, resource, value,
            min_resource=min_resource, eta=eta, mode=mode), "report_rung")

    def delete_advisor(self, advisor_id: str) -> None:
        # teardown is best-effort: never worth stalling a stop on
        self._client.delete_advisor(advisor_id)
