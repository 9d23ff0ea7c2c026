"""Leased control-plane leadership.

Own copy of ``rafiki_tpu/admin/lease.py``. One :class:`LeaseManager` an
admin process drives the one ``control_lease`` row (``db/database.py``):

- **acquire**: a compare-and-set take of an absent, expired or own lease;
  every take bumps the monotonic **epoch**, so exactly one admin at a
  time is the leader;
- **renew**: a thread extends the lease every ``RAFIKI_ADMIN_LEASE_RENEW_S``
  (default TTL/3), compare-and-set on (holder, epoch): a standby that
  promoted makes the renewal fail, and this manager fences at once;
- **self-fence**: each renewal arms the epoch write-fence on every bound
  :class:`~rafiki_tpu_torch.db.database.Database` with a
  ``time.monotonic()`` validity of one TTL. A leader that cannot renew
  (paused, cut off, store down) stops extending it, so its own writes
  raise ``StaleEpochError`` once the TTL lapses, before a standby can
  take over (the standby waits out the TTL on the lease row's wall
  clock).

A renewal *error* (the ``lease`` chaos site, a flaky store) never drops
leadership by itself: only the TTL or a failed compare-and-set demotes.
"""

from __future__ import annotations

import logging
import os
import socket
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

from rafiki_tpu_torch import config
from rafiki_tpu_torch.db.database import Database

logger = logging.getLogger(__name__)

ROLE_LEADER = "leader"
ROLE_FENCED = "fenced"
ROLE_STANDBY = "standby"


class LeaseNotAcquiredError(RuntimeError):
    """Another admin holds a live lease past the boot's wait: boot this
    one as a standby (``admin/standby.py``) instead."""


def default_holder() -> str:
    """Host, pid and a random tail: two admins on one host never
    collide."""
    return f"{socket.gethostname()}:{os.getpid()}:{uuid.uuid4().hex[:6]}"


class LeaseManager:
    """One admin's side of the lease: acquisition, the renewal thread, and
    the fence on every bound store handle."""

    def __init__(self, db: Database, holder: Optional[str] = None,
                 addr: Optional[str] = None,
                 ttl_s: Optional[float] = None,
                 renew_s: Optional[float] = None):
        self._db = db
        self.holder = holder or default_holder()
        #: the advertised ``host:port``: it rides the lease row as the
        #: leader hint of standby 503s
        self.addr = addr
        self.ttl_s = float(ttl_s if ttl_s is not None
                           else config.ADMIN_LEASE_TTL_S)
        r = renew_s if renew_s is not None else config.ADMIN_LEASE_RENEW_S
        self.renew_s = float(r) if r else self.ttl_s / 3.0
        self._lock = threading.Lock()
        self._epoch: Optional[int] = None  # guarded-by: _lock
        self._valid_until = 0.0  # guarded-by: _lock (monotonic)
        self._suspended = False  # guarded-by: _lock
        self._dbs: List[Database] = [db]  # guarded-by: _lock
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def acquire(self, block: bool = False,
                timeout_s: Optional[float] = None) -> bool:
        """Try to take the lease (bumping the epoch); with ``block``, try
        again every renewal period (at most 0.5 s) until ``timeout_s``:
        a booting leader waits out a dying predecessor's TTL."""
        deadline = time.monotonic() + (timeout_s or 0.0)
        while True:
            try:
                row = self._db.acquire_lease(self.holder, self.ttl_s,
                                             addr=self.addr)
            except Exception as e:  # a store fault: not taken this round
                logger.warning("lease acquisition failed: %s", e)
                row = None
            if row is not None:
                valid_until = time.monotonic() + self.ttl_s
                with self._lock:
                    self._epoch = row["epoch"]
                    self._valid_until = valid_until
                    self._arm_fences_locked()
                logger.info("leadership acquired: holder=%s epoch=%d "
                            "ttl=%.1fs", self.holder, row["epoch"],
                            self.ttl_s)
                return True
            if not block or time.monotonic() >= deadline:
                return False
            time.sleep(min(self.renew_s, 0.5))

    def bind(self, db: Database) -> None:
        """Arm the fence on another handle too (a promoted admin's own)."""
        with self._lock:
            if db not in self._dbs:
                self._dbs.append(db)
            if self._epoch is not None:
                self._arm_fences_locked()

    def _arm_fences_locked(self) -> None:  # guarded-by: _lock
        # lock order: LeaseManager._lock, then Database._lock
        for db in self._dbs:
            db.set_fence(self._epoch, self._valid_until)

    def start(self) -> "LeaseManager":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._renew_loop, name="admin-lease-renew",
                daemon=True)
            self._thread.start()
        return self

    def _renew_loop(self) -> None:
        while not self._stop_evt.wait(self.renew_s):
            with self._lock:
                suspended = self._suspended
                epoch = self._epoch
            if suspended or epoch is None:
                continue
            try:
                ok = self._db.renew_lease(self.holder, epoch, self.ttl_s,
                                          addr=self.addr)
            except Exception as e:
                # a renewal error never demotes: the fence is just not
                # extended, so failures that last fence at the TTL
                logger.warning("lease renewal failed (epoch %d), "
                               "self-fence in %.1fs: %s", epoch,
                               self.valid_for_s(), e)
                continue
            if not ok:
                # a newer epoch holds the row: fence now, not at the TTL,
                # and stop: the leadership is gone for good, and a renewal
                # is a store write (the write lock, up to the busy
                # timeout) that can never land again. JAX's loop retries
                # it every period until shutdown (ROADMAP.md, C)
                logger.error("leadership lost at epoch %d (lease CAS "
                             "refused); fencing all writes", epoch)
                with self._lock:
                    self._valid_until = 0.0
                    self._arm_fences_locked()
                return
            valid_until = time.monotonic() + self.ttl_s
            with self._lock:
                self._valid_until = valid_until
                self._arm_fences_locked()

    def epoch(self) -> Optional[int]:
        """The epoch held *validly*: None once the lease lapsed or was
        never taken."""
        with self._lock:
            if self._epoch is None or time.monotonic() >= self._valid_until:
                return None
            return self._epoch

    def last_epoch(self) -> Optional[int]:
        """The epoch last held, also after a self-fence."""
        with self._lock:
            return self._epoch

    def role(self) -> str:
        return ROLE_LEADER if self.epoch() is not None else ROLE_FENCED

    def valid_for_s(self) -> float:
        with self._lock:
            return max(0.0, self._valid_until - time.monotonic())

    def leader_row(self) -> Optional[Dict[str, Any]]:
        """The lease row as stored; a store fault reads as None (the
        doors call this)."""
        try:
            return self._db.read_lease()
        except Exception as e:
            logger.warning("lease read failed: %s", e)
            return None

    def status(self) -> Dict[str, Any]:
        with self._lock:
            epoch = self._epoch
            valid_for = max(0.0, self._valid_until - time.monotonic())
        return {"holder": self.holder, "addr": self.addr, "epoch": epoch,
                "role": (ROLE_LEADER if epoch is not None and valid_for > 0
                         else ROLE_FENCED),
                "ttl_s": self.ttl_s, "renew_s": self.renew_s,
                "valid_for_s": round(valid_for, 3)}

    def suspend(self) -> None:
        """Freeze renewal: a SIGSTOP of the leader in one process (the
        fence lapses on the monotonic clock as it would)."""
        with self._lock:
            self._suspended = True

    def resume(self) -> None:
        with self._lock:
            self._suspended = False

    def stop(self, release: bool = True) -> None:
        """Stop renewing; with ``release`` (a graceful shutdown) expire
        the lease now, so a standby promotes without waiting out the TTL.
        The fences are cleared last.

        A fenced manager (its TTL lapsed, or a newer epoch took the row)
        holds nothing: it neither releases nor clears its fences, and
        does not wait on a renewal still in the store. It writes nothing
        more, so a fenced ex-leader's shutdown never waits on the store's
        write lock, which the new leader and its children hold in turns."""
        self._stop_evt.set()
        fenced = self.role() == ROLE_FENCED
        if self._thread is not None and not fenced:
            self._thread.join(timeout=5.0)
        if fenced:
            logger.info("lease manager stopped fenced (epoch %s): nothing "
                        "to release", self.last_epoch())
            return
        with self._lock:
            epoch = self._epoch
        if release and epoch is not None:
            try:
                self._db.release_lease(self.holder, epoch)
            except Exception as e:  # the TTL expires it anyway
                logger.warning("lease release failed: %s", e)
        with self._lock:
            for db in self._dbs:
                db.clear_fence()
