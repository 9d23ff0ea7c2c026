"""The hot-standby admin.

Own copy of ``rafiki_tpu/admin/standby.py``. A second admin process is
built as a :class:`StandbyAdmin`, not an ``Admin``: it holds no lease,
runs no placement and writes nothing. ``AdminServer`` serves it as it
serves an admin (the door gates on ``ha_role()``): login and the public
root are answered, and every other route sheds with a 503 that carries
``standby`` and the leader's advertised address.

A watch thread reads the ``control_lease`` row every
``RAFIKI_ADMIN_STANDBY_POLL_S`` (default: the renewal period) and keeps a
read-only snapshot of the store fresh. Once the leader's lease has
expired (a crash, a SIGSTOP past the TTL, a cut-off), the standby
promotes:

1. ``LeaseManager.acquire()``: a compare-and-set take that bumps the
   epoch; of several standbys, one wins and the rest keep watching;
2. the factory builds a full ``Admin`` under the held lease, whose boot
   runs crash recovery (``admin/recovery.py``): surviving train children
   are adopted by pid, the controllers' rows resolved;
3. the facade forwards every attribute to that admin from then on
   (``__getattr__``), so the same door serves the new leader from its
   next request.

The old leader, should it come back, is fenced by the epoch: its store
writes raise ``StaleEpochError``. ``GET /fleet/health`` on a standby
answers its lease status and that snapshot (:meth:`get_fleet_health`).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable, Dict, Optional

from rafiki_tpu_torch import config
from rafiki_tpu_torch.admin.lease import (
    ROLE_STANDBY,
    LeaseManager,
    default_holder,
)
from rafiki_tpu_torch.db.database import Database
from rafiki_tpu_torch.utils.auth import (
    UnauthorizedError,
    generate_token,
    verify_password,
)

logger = logging.getLogger(__name__)


class StandbyAdmin:
    """A read-only standby before its promotion, a full ``Admin`` after.
    ``factory`` builds that admin from the lease it already holds::

        standby = StandbyAdmin(
            db, factory=lambda lease: Admin(db=Database(path), lease=lease),
            addr="127.0.0.1:3001")
    """

    def __init__(self, db: Database,
                 factory: Callable[[LeaseManager], Any],
                 addr: Optional[str] = None,
                 holder: Optional[str] = None,
                 poll_s: Optional[float] = None):
        # first: __getattr__ reads _admin, and nothing set before it may
        # recurse
        self._lock = threading.Lock()
        self._admin: Optional[Any] = None  # guarded-by: _lock
        self.db = db
        self._factory = factory
        self._lease = LeaseManager(db, holder=holder or default_holder(),
                                   addr=addr)
        p = poll_s if poll_s is not None else config.ADMIN_STANDBY_POLL_S
        self._poll_s = float(p) if p else self._lease.renew_s
        self._snapshot: Dict[str, Any] = {}  # guarded-by: _lock
        self._stop_evt = threading.Event()
        self._thread = threading.Thread(
            target=self._watch_loop, name="admin-standby-watch", daemon=True)
        self._thread.start()

    def __getattr__(self, name: str) -> Any:
        # reached only for what the facade lacks: before the promotion an
        # AttributeError (the door's getattr probes rely on it), after it
        # the promoted admin's attribute
        admin = object.__getattribute__(self, "__dict__").get("_admin")
        if admin is None:
            raise AttributeError(
                f"standby admin has no attribute {name!r} (not promoted)")
        return getattr(admin, name)

    def _promoted(self) -> Optional[Any]:
        with self._lock:
            return self._admin

    # -- what the standby serves ----------------------------------------------

    def ha_role(self) -> str:
        admin = self._promoted()
        return admin.ha_role() if admin is not None else ROLE_STANDBY

    def leader_hint(self) -> Optional[str]:
        admin = self._promoted()
        if admin is not None:
            return admin.leader_hint()
        row = self._lease.leader_row()
        return row.get("addr") if row else None

    def ha_public(self) -> Dict[str, Any]:
        admin = self._promoted()
        if admin is not None:
            return admin.ha_public()
        return {"role": ROLE_STANDBY, "leader": self.leader_hint()}

    def recovery_status(self) -> Dict[str, Any]:
        admin = self._promoted()
        return (admin.recovery_status() if admin is not None
                else {"state": "ready"})

    def recovery_public(self) -> Dict[str, Any]:
        admin = self._promoted()
        return (admin.recovery_public() if admin is not None
                else {"state": "ready"})

    def authenticate_user(self, email: str, password: str) -> Dict[str, Any]:
        """As ``Admin.authenticate_user``, read from the shared store: a
        token minted here works against the leader (one signing secret)."""
        admin = self._promoted()
        if admin is not None:
            return admin.authenticate_user(email, password)
        user = self.db.get_user_by_email(email)
        if user is None or not verify_password(password,
                                               user["password_hash"]):
            raise UnauthorizedError("Invalid email or password")
        if user["banned"]:
            raise UnauthorizedError("User is banned")
        token = generate_token(
            {"user_id": user["id"], "user_type": user["user_type"]})
        return {"user_id": user["id"], "user_type": user["user_type"],
                "token": token}

    def snapshot(self) -> Dict[str, Any]:
        """The warm read-only view of the leader's world, refreshed every
        poll from the shared store."""
        with self._lock:
            return dict(self._snapshot)

    def get_fleet_health(self) -> Dict[str, Any]:
        """The promoted admin's fleet health; before the promotion, the
        standby's lease status and its snapshot."""
        admin = self._promoted()
        if admin is not None:
            return admin.get_fleet_health()
        return {
            "placement": None,
            "standby": True,
            "ha": {"enabled": True, **self._lease.status(),
                   "role": ROLE_STANDBY, "leader": self.leader_hint()},
            "snapshot": self.snapshot(),
        }

    # -- the watch -------------------------------------------------------------

    def _watch_loop(self) -> None:
        while not self._stop_evt.wait(self._poll_s):
            if self._promoted() is not None:
                return  # the promoted admin's lease thread takes over
            try:
                row = self.db.read_lease()
            except Exception as e:  # a flaky store: the next poll retries
                logger.warning("standby lease watch failed: %s", e)
                continue
            if row is not None and row["expires_at"] > time.time():
                self._refresh_snapshot()
                continue
            try:
                self._promote()
            except Exception:
                # a failed boot is retried: a standby that gave up after
                # one would leave the fleet without a leader for good
                logger.exception("standby promotion attempt failed; "
                                 "will retry")
            if self._promoted() is not None:
                return

    def _refresh_snapshot(self) -> None:
        try:
            snap = {"inference_jobs_running": len(
                        self.db.get_inference_jobs_by_statuses(["RUNNING"])),
                    "refreshed_at": time.time()}
        except Exception as e:  # best effort: the next poll tries again
            logger.warning("standby snapshot refresh failed: %s", e)
            return
        with self._lock:
            self._snapshot = snap

    def _promote(self) -> None:
        """Take the lease, then boot the admin under it. A standby that
        loses the take keeps watching."""
        if not self._lease.acquire(block=False):
            logger.info("standby %s lost the promotion race; resuming "
                        "watch", self._lease.holder)
            return
        epoch = self._lease.last_epoch()
        logger.warning("standby %s promoting to leader at epoch %s",
                       self._lease.holder, epoch)
        admin = self._factory(self._lease)
        with self._lock:
            self._admin = admin
        logger.warning("standby promotion complete: leader at epoch %s",
                       epoch)

    # -- lifecycle -------------------------------------------------------------

    def wait_promoted(self, timeout_s: float) -> bool:
        """Block until this standby has promoted, or ``timeout_s``."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self._promoted() is not None:
                return True
            time.sleep(0.05)
        return self._promoted() is not None

    def shutdown(self) -> None:
        self._stop_evt.set()
        self._thread.join(timeout=5.0)
        admin = self._promoted()
        if admin is not None:
            admin.shutdown()
        else:
            self._lease.stop(release=False)  # never held: leave the row
