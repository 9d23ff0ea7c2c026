"""The chip arbiter between the serving and training planes.

Own copy of ``ChipBudgetArbiter`` of ``rafiki_tpu/placement/hosts.py``.
The host placement and its agents, the rest of that file, are not ported
(ROADMAP.md, item 11).
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, Optional, Tuple

from rafiki_tpu_torch import config
from rafiki_tpu_torch.utils.metrics import REGISTRY

logger = logging.getLogger(__name__)


class ChipBudgetArbiter:
    """Arbitrates the cards between serving and training.

    A serving surge may borrow cards that trials are not using: a
    scale-up places a replica with an exclusive grant only while at least
    ``RAFIKI_AUTOSCALE_TRAIN_FLOOR`` cards stay free, the floor that keeps
    training from being starved. When a train executor cannot allocate,
    :meth:`reclaim_for_training` drains borrowed replicas: every borrow is
    a loan. Loans held by warm standbys are tagged, and reclaim takes them
    first. Works over any allocator with ``total_chips`` and
    ``free_chips`` (the port's ``ChipAllocator``). The loan book is in
    memory; each committed borrow also writes ``borrowed_chips`` on the
    replica's worker row (``admin/services.py``)."""

    def __init__(self, allocator=None):
        self._alloc = allocator
        self._lock = threading.Lock()
        # service_id -> (inference_job_id, n_chips) on loan
        self._borrowed: Dict[str, Tuple[str, int]] = {}  # guarded-by: _lock
        # loans held by warm standbys: reclaim's first victims
        self._standby: set = set()  # guarded-by: _lock
        # token -> n_chips of borrows decided but not yet granted, counted
        # against the floor so two scale-ups cannot both pass the check
        self._pending: Dict[object, int] = {}  # guarded-by: _lock
        # callable(n_chips) -> cards returned (admin/services.py)
        self._reclaim_cb = None
        self._g_borrowed = REGISTRY.gauge(
            "rafiki_autoscale_borrowed_chips",
            "chips the serving plane currently borrows from idle "
            "training capacity")

    def set_reclaim_callback(self, cb) -> None:
        self._reclaim_cb = cb

    def floor(self) -> int:
        return max(int(config.AUTOSCALE_TRAIN_FLOOR), 0)

    def capacity(self) -> Tuple[int, int]:
        """(total, free) cards of the allocator; (0, 0) without one."""
        if self._alloc is None:
            return 0, 0
        try:
            return int(self._alloc.total_chips), int(self._alloc.free_chips)
        except Exception:
            logger.exception("chip arbiter capacity probe failed")
            return 0, 0

    def begin_borrow(self, n_chips: int) -> Optional[object]:
        """Check the floor and reserve ``n_chips`` in one step: a token
        for :meth:`commit_borrow` or :meth:`cancel_borrow`, or None when
        the floor refuses."""
        if n_chips <= 0 or self._alloc is None:
            return None
        total, free = self.capacity()
        if total <= 0:
            return None
        with self._lock:
            if free - sum(self._pending.values()) - n_chips < self.floor():
                return None
            token = object()
            self._pending[token] = n_chips
            return token

    def commit_borrow(self, token: object, service_id: str,
                      inference_job_id: str, chips) -> None:
        """The reserved borrow was granted: it goes on the loan book."""
        with self._lock:
            self._pending.pop(token, None)
        self.note_borrow(service_id, inference_job_id, chips)

    def cancel_borrow(self, token: object) -> None:
        """The reserved borrow never happened."""
        with self._lock:
            self._pending.pop(token, None)

    def note_borrow(self, service_id: str, inference_job_id: str,
                    chips) -> None:
        n = len(chips) if hasattr(chips, "__len__") else int(chips)
        if n <= 0:
            return
        with self._lock:
            self._borrowed[service_id] = (inference_job_id, n)
            self._g_borrowed.set(sum(c for _, c in self._borrowed.values()))
        logger.info("serving borrowed %d chip(s) for replica %s (job %s)",
                    n, service_id[:8], inference_job_id[:8])

    def note_return(self, service_id: str) -> int:
        """The replica is gone: its loan comes home (an idempotent pop);
        returns the cards returned."""
        with self._lock:
            _, n = self._borrowed.pop(service_id, (None, 0))
            self._standby.discard(service_id)
            self._g_borrowed.set(sum(c for _, c in self._borrowed.values()))
        if n:
            logger.info("serving returned %d borrowed chip(s) with replica "
                        "%s", n, service_id[:8])
        return n

    def mark_standby(self, service_id: str, standby: bool = True) -> None:
        """Tag a loan as a warm standby's (or clear the tag on
        promotion)."""
        with self._lock:
            if standby and service_id in self._borrowed:
                self._standby.add(service_id)
            else:
                self._standby.discard(service_id)

    def borrowed(self) -> Dict[str, Tuple[str, int]]:
        with self._lock:
            return dict(self._borrowed)

    def borrowed_chips(self) -> int:
        with self._lock:
            return sum(n for _, n in self._borrowed.values())

    def loan_split(self) -> Dict[str, int]:
        """Cards on loan to routed replicas and to standbys."""
        with self._lock:
            standby = sum(n for sid, (_, n) in self._borrowed.items()
                          if sid in self._standby)
            total = sum(n for _, n in self._borrowed.values())
        return {"serving": total - standby, "standby": standby}

    def reclaim_for_training(self, n_chips: int) -> int:
        """Training wants ``n_chips`` it cannot allocate: drain borrowed
        replicas until that many came home or the book is empty. Returns
        the cards freed; the caller retries its allocation."""
        if n_chips <= 0 or self._reclaim_cb is None:
            return 0
        if not self.borrowed():
            return 0
        try:
            freed = int(self._reclaim_cb(n_chips) or 0)
        except Exception:
            logger.exception("chip reclaim callback failed")
            return 0
        if freed:
            logger.warning("training reclaimed %d chip(s) from the serving "
                           "plane (%d requested)", freed, n_chips)
        return freed
