"""The metadata store: SQLite in WAL mode, shared by every thread.

Own copy of ``rafiki_tpu/db/database.py`` for the tables this slice uses
(``user``, ``model``, ``train_job``, ``sub_train_job``, ``service``,
``trial``, ``train_job_worker``, ``inference_job``,
``inference_job_worker``, ``rollout``, ``drift_state``, ``trial_log``,
``control_lease``), with the same columns, types, method names and row
shapes. JSON columns (``budget``, ``knobs``,
``dependencies``, ``chips``) come back decoded. Job status changes are
guarded transitions (``WHERE status IN ...``): a late write that would
move a job backwards loses. :meth:`Database.reserve_trial` counts and
inserts in one IMMEDIATE transaction, so parallel workers never overshoot
a trial budget.

Control-plane HA (``admin/lease.py``): the ``control_lease`` row is taken
and renewed by compare-and-set in an IMMEDIATE transaction, and every
take bumps its epoch. :meth:`Database.set_fence` arms the epoch
write-fence on a handle: from then on each INSERT, UPDATE or DELETE (and
``reserve_trial``, inside its transaction) first checks that the fence's
``time.monotonic()`` validity has not lapsed and that the lease row still
holds the fence's epoch, else raises :class:`StaleEpochError`; reads are
never fenced. The ``db`` chaos site (``RAFIKI_CHAOS``, target the SQL
text) and the ``lease`` site (target ``acquire`` or ``renew``) raise
:class:`MetadataStoreChaosError` or sleep before the statement runs.
``get_non_terminal_services`` is crash recovery's one scan, and
``update_service_pid`` records a process-placed service's child.

Not ported (ROADMAP.md): the PostgreSQL backend and the migrations for
stores written by older versions.
"""

from __future__ import annotations

import json
import os
import sqlite3
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

from rafiki_tpu_torch import config
from rafiki_tpu_torch.config import NotPortedError
from rafiki_tpu_torch.constants import (
    InferenceJobStatus,
    RolloutPhase,
    ServiceStatus,
    TrainJobStatus,
    TrialStatus,
)
from rafiki_tpu_torch.utils import chaos


class MetadataStoreChaosError(RuntimeError):
    """A chaos-injected transient store failure (``RAFIKI_CHAOS`` site
    ``db`` or ``lease``): the drillable stand-in for a flaky store."""


class StaleEpochError(RuntimeError):
    """The epoch fence refused a mutating write: a newer admin holds the
    leadership lease, or this writer could not renew its own within the
    TTL and fenced itself. Terminal for the caller: a fenced ex-leader
    stops mutating, it does not retry."""

    def __init__(self, message: str, expected: Optional[int] = None,
                 current: Optional[int] = None):
        super().__init__(message)
        self.expected = expected
        self.current = current


#: the one row of ``control_lease``
LEASE_ID = "admin"

_SCHEMA = """
CREATE TABLE IF NOT EXISTS "user" (
    id TEXT PRIMARY KEY,
    email TEXT NOT NULL UNIQUE,
    password_hash TEXT NOT NULL,
    user_type TEXT NOT NULL,
    banned INTEGER NOT NULL DEFAULT 0,
    datetime_created REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS model (
    id TEXT PRIMARY KEY,
    user_id TEXT NOT NULL REFERENCES "user"(id),
    name TEXT NOT NULL,
    task TEXT NOT NULL,
    model_file_bytes BLOB NOT NULL,
    model_class TEXT NOT NULL,
    dependencies TEXT NOT NULL,
    access_right TEXT NOT NULL,
    verification TEXT,
    datetime_created REAL NOT NULL,
    UNIQUE (name, user_id)
);
CREATE TABLE IF NOT EXISTS train_job (
    id TEXT PRIMARY KEY,
    user_id TEXT NOT NULL REFERENCES "user"(id),
    app TEXT NOT NULL,
    app_version INTEGER NOT NULL,
    task TEXT NOT NULL,
    train_dataset_uri TEXT NOT NULL,
    test_dataset_uri TEXT NOT NULL,
    budget TEXT NOT NULL,
    status TEXT NOT NULL,
    fault_kind TEXT,
    error_reason TEXT,
    datetime_started REAL NOT NULL,
    datetime_stopped REAL,
    UNIQUE (app, app_version, user_id)
);
CREATE TABLE IF NOT EXISTS sub_train_job (
    id TEXT PRIMARY KEY,
    train_job_id TEXT NOT NULL REFERENCES train_job(id),
    model_id TEXT NOT NULL REFERENCES model(id),
    advisor_id TEXT
);
CREATE TABLE IF NOT EXISTS service (
    id TEXT PRIMARY KEY,
    service_type TEXT NOT NULL,
    status TEXT NOT NULL,
    replicas INTEGER NOT NULL DEFAULT 1,
    chips TEXT NOT NULL DEFAULT '[]',
    host TEXT,
    port INTEGER,
    pid INTEGER,
    datetime_started REAL NOT NULL,
    datetime_stopped REAL
);
CREATE INDEX IF NOT EXISTS idx_service_status ON service(status);
CREATE TABLE IF NOT EXISTS trial (
    id TEXT PRIMARY KEY,
    sub_train_job_id TEXT NOT NULL REFERENCES sub_train_job(id),
    model_id TEXT NOT NULL REFERENCES model(id),
    worker_id TEXT,
    knobs TEXT NOT NULL,
    score REAL,
    status TEXT NOT NULL,
    params_file_path TEXT,
    attempt INTEGER NOT NULL DEFAULT 0,
    fault_kind TEXT,
    fault_detail TEXT,
    datetime_started REAL NOT NULL,
    datetime_stopped REAL
);
CREATE TABLE IF NOT EXISTS train_job_worker (
    service_id TEXT PRIMARY KEY REFERENCES service(id),
    sub_train_job_id TEXT NOT NULL REFERENCES sub_train_job(id)
);
CREATE TABLE IF NOT EXISTS inference_job (
    id TEXT PRIMARY KEY,
    user_id TEXT NOT NULL REFERENCES "user"(id),
    train_job_id TEXT NOT NULL REFERENCES train_job(id),
    status TEXT NOT NULL,
    predictor_service_id TEXT,
    budget TEXT,
    datetime_started REAL NOT NULL,
    datetime_stopped REAL
);
CREATE TABLE IF NOT EXISTS inference_job_worker (
    service_id TEXT PRIMARY KEY REFERENCES service(id),
    inference_job_id TEXT NOT NULL REFERENCES inference_job(id),
    trial_id TEXT NOT NULL REFERENCES trial(id),
    model_version INTEGER NOT NULL DEFAULT 0,
    borrowed_chips INTEGER NOT NULL DEFAULT 0,
    standby INTEGER NOT NULL DEFAULT 0
);
CREATE TABLE IF NOT EXISTS rollout (
    id TEXT PRIMARY KEY,
    inference_job_id TEXT NOT NULL REFERENCES inference_job(id),
    from_trial_id TEXT,
    to_trial_id TEXT NOT NULL,
    from_version INTEGER NOT NULL,
    to_version INTEGER NOT NULL,
    n_replicas_before INTEGER NOT NULL DEFAULT 0,
    phase TEXT NOT NULL,
    reason TEXT,
    events TEXT NOT NULL DEFAULT '[]',
    operator_ack INTEGER NOT NULL DEFAULT 0,
    datetime_started REAL NOT NULL,
    datetime_stopped REAL
);
CREATE TABLE IF NOT EXISTS drift_state (
    inference_job_id TEXT PRIMARY KEY REFERENCES inference_job(id),
    phase TEXT NOT NULL,
    reason TEXT,
    baseline TEXT,
    signals TEXT,
    retrain_job_id TEXT,
    candidate_trial_id TEXT,
    cooldown_until REAL NOT NULL DEFAULT 0,
    consecutive_rollbacks INTEGER NOT NULL DEFAULT 0,
    events TEXT NOT NULL DEFAULT '[]',
    operator_ack INTEGER NOT NULL DEFAULT 0,
    datetime_updated REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS trial_log (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    trial_id TEXT NOT NULL REFERENCES trial(id),
    line TEXT NOT NULL,
    datetime REAL NOT NULL
);
CREATE INDEX IF NOT EXISTS idx_trial_log_trial ON trial_log(trial_id);
CREATE TABLE IF NOT EXISTS control_lease (
    id TEXT PRIMARY KEY,
    holder TEXT NOT NULL,
    addr TEXT,
    epoch INTEGER NOT NULL,
    expires_at REAL NOT NULL,
    datetime_updated REAL NOT NULL
);
"""

#: the tables of :data:`_SCHEMA`, in creation order
TABLES = ("user", "model", "train_job", "sub_train_job", "service", "trial",
          "train_job_worker", "inference_job", "inference_job_worker",
          "rollout", "drift_state", "trial_log", "control_lease")


def _decode(row: Optional[Dict[str, Any]], *columns: str,
            empty: str = "null") -> Optional[Dict[str, Any]]:
    """Decode the JSON ``columns`` of ``row`` in place (NULL as ``empty``)."""
    if row is not None:
        for c in columns:
            row[c] = json.loads(row[c] or empty)
    return row


class Database:
    """The store. One instance may be shared across threads: every
    statement runs on one connection under one lock.

    ``db_path`` is a file path or ``:memory:``; default ``config.DB_PATH``.
    A ``postgresql://`` URL raises :class:`NotPortedError`."""

    def __init__(self, db_path: Optional[str] = None):
        path = db_path or config.DB_PATH
        if path.startswith(("postgresql://", "postgres://")):
            raise NotPortedError("the PostgreSQL store", "a postgresql:// URL")
        if path != ":memory:":
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.path = path
        self._lock = threading.RLock()
        self._conn = sqlite3.connect(path, check_same_thread=False,
                                     isolation_level=None)
        self._conn.row_factory = sqlite3.Row
        self._conn.execute("PRAGMA journal_mode=WAL")
        self._conn.execute("PRAGMA foreign_keys=ON")
        self._conn.execute("PRAGMA busy_timeout=15000")
        self._conn.executescript(_SCHEMA)
        # the epoch write-fence (set_fence); None: not armed
        self._fence_epoch: Optional[int] = None  # guarded-by: _lock
        self._fence_valid_until = 0.0  # guarded-by: _lock (monotonic)
        if path != ":memory:":
            # owner-only: the store holds password hashes and uploads
            os.chmod(path, 0o600)

    def close(self) -> None:
        with self._lock:
            self._conn.close()

    # -- low-level helpers -------------------------------------------------

    @staticmethod
    def _chaos(sql: str) -> None:
        """The ``db`` chaos site, asked before every statement (target
        the SQL text): ``delay`` is a slow store, anything else a typed
        transient failure the callers retry on."""
        rule = chaos.hit(chaos.SITE_DB, sql)
        if rule is None:
            return
        if rule.action == chaos.ACTION_DELAY:
            chaos.sleep_for(rule)
            return
        raise MetadataStoreChaosError(
            f"chaos-injected metadata-store fault on {sql.split(None, 1)[0]}")

    #: the statements the epoch fence guards (reads are always served)
    _MUTATING_VERBS = ("INSERT", "UPDATE", "DELETE")

    def _fence_check_locked(self) -> None:  # guarded-by: _lock
        """The fence's check, with the lock held, right before a mutating
        statement or inside an exclusive transaction: the validity first
        (a writer paused past its TTL refuses before trusting the store),
        then the lease row's epoch."""
        epoch = self._fence_epoch
        if epoch is None:
            return
        if time.monotonic() >= self._fence_valid_until:
            raise StaleEpochError(
                f"self-fenced: leadership lease (epoch {epoch}) was not "
                "renewed within its TTL; refusing to mutate the store",
                expected=epoch)
        row = self._conn.execute(
            "SELECT epoch FROM control_lease WHERE id=?",
            (LEASE_ID,)).fetchone()
        current = row["epoch"] if row else 0
        if current != epoch:
            raise StaleEpochError(
                f"stale epoch {epoch}: the leadership lease is now held at "
                f"epoch {current}; this admin must stop mutating",
                expected=epoch, current=current)

    def set_fence(self, epoch: int, valid_until: float) -> None:
        """Arm or extend the epoch write-fence; ``valid_until`` is a
        ``time.monotonic()`` deadline (a renewal extends it by the TTL)."""
        with self._lock:
            self._fence_epoch = int(epoch)
            self._fence_valid_until = float(valid_until)

    def clear_fence(self) -> None:
        """Disarm the fence (a graceful shutdown, after the release)."""
        with self._lock:
            self._fence_epoch = None

    def _exec(self, sql: str, args: tuple = ()) -> None:
        self._chaos(sql)
        with self._lock:
            if (self._fence_epoch is not None
                    and sql.lstrip()[:6].upper() in self._MUTATING_VERBS):
                self._fence_check_locked()
            self._conn.execute(sql, args)

    def _one(self, sql: str, args: tuple = ()) -> Optional[Dict[str, Any]]:
        self._chaos(sql)
        with self._lock:
            row = self._conn.execute(sql, args).fetchone()
        return dict(row) if row else None

    def _all(self, sql: str, args: tuple = ()) -> List[Dict[str, Any]]:
        self._chaos(sql)
        with self._lock:
            rows = self._conn.execute(sql, args).fetchall()
        return [dict(r) for r in rows]

    # -- the leadership lease ------------------------------------------------

    @staticmethod
    def _lease_chaos(op: str) -> None:
        """The ``lease`` chaos site at acquisition and renewal (target
        ``acquire`` or ``renew``): ``delay`` is a slow store near the TTL's
        edge, anything else the false-lease-loss drill's error."""
        rule = chaos.hit(chaos.SITE_LEASE, op)
        if rule is None:
            return
        if rule.action == chaos.ACTION_DELAY:
            chaos.sleep_for(rule)
            return
        raise MetadataStoreChaosError(f"chaos-injected lease fault on {op}")

    def _lease_txn(self, fn):
        """Run ``fn(row)`` on the lease row in one IMMEDIATE transaction:
        it returns its result, or None to roll back."""
        with self._lock:
            self._conn.execute("BEGIN IMMEDIATE")
            try:
                row = self._conn.execute(
                    "SELECT * FROM control_lease WHERE id=?",
                    (LEASE_ID,)).fetchone()
                out = fn(dict(row) if row else None)
                self._conn.execute("COMMIT" if out is not None
                                   else "ROLLBACK")
            except BaseException:
                self._conn.execute("ROLLBACK")
                raise
        return out

    def acquire_lease(self, holder: str, ttl_s: float,
                      addr: Optional[str] = None) -> Optional[Dict]:
        """Take the lease when it is absent, expired or already
        ``holder``'s; every take bumps the epoch (a re-take by the same
        holder too: its earlier incarnation's writes must fence). Returns
        the new row, or None while another holder's lease is live."""
        self._lease_chaos("acquire")
        now = time.time()

        def take(row):
            if row is None:
                epoch = 1
                self._conn.execute(
                    "INSERT INTO control_lease (id, holder, addr, epoch,"
                    " expires_at, datetime_updated) VALUES (?,?,?,?,?,?)",
                    (LEASE_ID, holder, addr, epoch, now + ttl_s, now))
            elif row["holder"] == holder or row["expires_at"] <= now:
                epoch = row["epoch"] + 1
                self._conn.execute(
                    "UPDATE control_lease SET holder=?, addr=?, epoch=?,"
                    " expires_at=?, datetime_updated=? WHERE id=?",
                    (holder, addr, epoch, now + ttl_s, now, LEASE_ID))
            else:
                return None
            return {"id": LEASE_ID, "holder": holder, "addr": addr,
                    "epoch": epoch, "expires_at": now + ttl_s,
                    "datetime_updated": now}

        return self._lease_txn(take)

    def renew_lease(self, holder: str, epoch: int, ttl_s: float,
                    addr: Optional[str] = None) -> bool:
        """Extend the lease iff (holder, epoch) still match: expiry alone
        does not fail it (nobody else took the lease). False means the
        leadership is gone for good."""
        self._lease_chaos("renew")
        now = time.time()

        def extend(row):
            if (row is None or row["holder"] != holder
                    or row["epoch"] != epoch):
                return None
            self._conn.execute(
                "UPDATE control_lease SET addr=?, expires_at=?,"
                " datetime_updated=? WHERE id=?",
                (addr if addr is not None else row["addr"], now + ttl_s,
                 now, LEASE_ID))
            return True

        return bool(self._lease_txn(extend))

    def release_lease(self, holder: str, epoch: int) -> bool:
        """Expire the lease now (compare-and-set on holder and epoch), so a
        standby promotes without waiting out the TTL; the row and its
        epoch stay."""
        now = time.time()

        def expire(row):
            if (row is None or row["holder"] != holder
                    or row["epoch"] != epoch):
                return None
            self._conn.execute(
                "UPDATE control_lease SET expires_at=?, datetime_updated=?"
                " WHERE id=?", (now, now, LEASE_ID))
            return True

        return bool(self._lease_txn(expire))

    def read_lease(self) -> Optional[Dict]:
        return self._one("SELECT * FROM control_lease WHERE id=?",
                         (LEASE_ID,))

    # -- users -------------------------------------------------------------

    def create_user(self, email: str, password_hash: str,
                    user_type: str) -> Dict:
        uid = uuid.uuid4().hex
        self._exec(
            'INSERT INTO "user" (id, email, password_hash, user_type, banned,'
            " datetime_created) VALUES (?,?,?,?,0,?)",
            (uid, email, password_hash, user_type, time.time()))
        return self.get_user(uid)

    def get_user(self, user_id: str) -> Optional[Dict]:
        return self._one('SELECT * FROM "user" WHERE id=?', (user_id,))

    def get_user_by_email(self, email: str) -> Optional[Dict]:
        return self._one('SELECT * FROM "user" WHERE email=?', (email,))

    def get_users(self) -> List[Dict]:
        return self._all('SELECT * FROM "user" ORDER BY datetime_created')

    def ban_user(self, user_id: str) -> None:
        self._exec('UPDATE "user" SET banned=1 WHERE id=?', (user_id,))

    # -- models ------------------------------------------------------------

    def create_model(self, user_id: str, name: str, task: str,
                     model_file_bytes: bytes, model_class: str,
                     dependencies: Dict[str, Optional[str]],
                     access_right: str,
                     verification: Optional[str] = None) -> Dict:
        mid = uuid.uuid4().hex
        self._exec(
            "INSERT INTO model (id, user_id, name, task, model_file_bytes,"
            " model_class, dependencies, access_right, verification,"
            " datetime_created) VALUES (?,?,?,?,?,?,?,?,?,?)",
            (mid, user_id, name, task, model_file_bytes, model_class,
             json.dumps(dependencies), access_right, verification,
             time.time()))
        return self.get_model(mid)

    def get_model(self, model_id: str) -> Optional[Dict]:
        return _decode(self._one("SELECT * FROM model WHERE id=?",
                                 (model_id,)), "dependencies")

    def get_model_by_name(self, user_id: str, name: str) -> Optional[Dict]:
        return _decode(self._one(
            "SELECT * FROM model WHERE user_id=? AND name=?",
            (user_id, name)), "dependencies")

    def get_models(self, task: Optional[str] = None) -> List[Dict]:
        if task:
            rows = self._all("SELECT * FROM model WHERE task=?", (task,))
        else:
            rows = self._all("SELECT * FROM model")
        return [_decode(m, "dependencies") for m in rows]

    def delete_model(self, model_id: str) -> None:
        self._exec("DELETE FROM model WHERE id=?", (model_id,))

    # -- train jobs ----------------------------------------------------------

    def create_train_job(self, user_id: str, app: str, app_version: int,
                         task: str, train_dataset_uri: str,
                         test_dataset_uri: str,
                         budget: Dict[str, Any]) -> Dict:
        tid = uuid.uuid4().hex
        self._exec(
            "INSERT INTO train_job (id, user_id, app, app_version, task,"
            " train_dataset_uri, test_dataset_uri, budget, status,"
            " datetime_started) VALUES (?,?,?,?,?,?,?,?,?,?)",
            (tid, user_id, app, app_version, task, train_dataset_uri,
             test_dataset_uri, json.dumps(budget), TrainJobStatus.STARTED,
             time.time()))
        return self.get_train_job(tid)

    def get_train_job(self, train_job_id: str) -> Optional[Dict]:
        return _decode(self._one("SELECT * FROM train_job WHERE id=?",
                                 (train_job_id,)), "budget")

    def get_train_jobs_of_user(self, user_id: str) -> List[Dict]:
        return [_decode(j, "budget") for j in self._all(
            "SELECT * FROM train_job WHERE user_id=?"
            " ORDER BY datetime_started DESC", (user_id,))]

    def get_train_jobs_of_app(self, user_id: str, app: str) -> List[Dict]:
        return [_decode(j, "budget") for j in self._all(
            "SELECT * FROM train_job WHERE user_id=? AND app=?"
            " ORDER BY app_version DESC", (user_id, app))]

    def get_train_job_by_app_version(self, user_id: str, app: str,
                                     app_version: int) -> Optional[Dict]:
        """``app_version`` -1 is the app's newest version."""
        if app_version == -1:
            rows = self.get_train_jobs_of_app(user_id, app)
            return rows[0] if rows else None
        return _decode(self._one(
            "SELECT * FROM train_job WHERE user_id=? AND app=? AND"
            " app_version=?", (user_id, app, app_version)), "budget")

    def get_next_app_version(self, user_id: str, app: str) -> int:
        row = self._one(
            "SELECT MAX(app_version) AS v FROM train_job WHERE user_id=? AND"
            " app=?", (user_id, app))
        return (row["v"] or 0) + 1 if row else 1

    def get_train_jobs_by_statuses(self, statuses: List[str]) -> List[Dict]:
        marks = ",".join("?" * len(statuses))
        return [_decode(j, "budget") for j in self._all(
            f"SELECT * FROM train_job WHERE status IN ({marks})",
            tuple(statuses))]

    # Guarded transitions: a fast worker can run a whole job to STOPPED
    # before the deploy path marks it RUNNING, and that late RUNNING loses.

    def mark_train_job_as_running(self, train_job_id: str) -> None:
        self._exec(
            "UPDATE train_job SET status=? WHERE id=? AND status=?",
            (TrainJobStatus.RUNNING, train_job_id, TrainJobStatus.STARTED))

    def mark_train_job_as_stopped(self, train_job_id: str) -> None:
        self._exec(
            "UPDATE train_job SET status=?, datetime_stopped=? WHERE id=?"
            " AND status IN (?,?)",
            (TrainJobStatus.STOPPED, time.time(), train_job_id,
             TrainJobStatus.STARTED, TrainJobStatus.RUNNING))

    def mark_train_job_as_errored(self, train_job_id: str,
                                  fault_kind: Optional[str] = None,
                                  error_reason: Optional[str] = None) -> None:
        self._exec(
            "UPDATE train_job SET status=?, fault_kind=?, error_reason=?,"
            " datetime_stopped=? WHERE id=? AND status IN (?,?)",
            (TrainJobStatus.ERRORED, fault_kind, error_reason, time.time(),
             train_job_id, TrainJobStatus.STARTED, TrainJobStatus.RUNNING))

    # -- sub train jobs ------------------------------------------------------

    def create_sub_train_job(self, train_job_id: str, model_id: str) -> Dict:
        sid = uuid.uuid4().hex
        self._exec(
            "INSERT INTO sub_train_job (id, train_job_id, model_id)"
            " VALUES (?,?,?)", (sid, train_job_id, model_id))
        return self.get_sub_train_job(sid)

    def get_sub_train_job(self, sub_train_job_id: str) -> Optional[Dict]:
        return self._one("SELECT * FROM sub_train_job WHERE id=?",
                         (sub_train_job_id,))

    def get_sub_train_jobs_of_train_job(self,
                                        train_job_id: str) -> List[Dict]:
        return self._all("SELECT * FROM sub_train_job WHERE train_job_id=?",
                         (train_job_id,))

    def update_sub_train_job_advisor(self, sub_train_job_id: str,
                                     advisor_id: str) -> None:
        self._exec("UPDATE sub_train_job SET advisor_id=? WHERE id=?",
                   (advisor_id, sub_train_job_id))

    # -- train workers -------------------------------------------------------

    def create_train_job_worker(self, service_id: str,
                                sub_train_job_id: str) -> Dict:
        self._exec(
            "INSERT INTO train_job_worker (service_id, sub_train_job_id)"
            " VALUES (?,?)", (service_id, sub_train_job_id))
        return {"service_id": service_id,
                "sub_train_job_id": sub_train_job_id}

    def get_train_job_worker(self, service_id: str) -> Optional[Dict]:
        return self._one("SELECT * FROM train_job_worker WHERE service_id=?",
                         (service_id,))

    def get_workers_of_sub_train_job(self,
                                     sub_train_job_id: str) -> List[Dict]:
        return self._all(
            "SELECT * FROM train_job_worker WHERE sub_train_job_id=?",
            (sub_train_job_id,))

    def get_workers_of_train_job(self, train_job_id: str) -> List[Dict]:
        return self._all(
            "SELECT w.* FROM train_job_worker w"
            " JOIN sub_train_job s ON w.sub_train_job_id = s.id"
            " WHERE s.train_job_id=?", (train_job_id,))

    # -- trials --------------------------------------------------------------

    _INSERT_TRIAL = (
        "INSERT INTO trial (id, sub_train_job_id, model_id, worker_id, knobs,"
        " status, datetime_started) VALUES (?,?,?,?,?,?,?)")

    def create_trial(self, sub_train_job_id: str, model_id: str,
                     knobs: Dict[str, Any],
                     worker_id: Optional[str] = None) -> Dict:
        tid = uuid.uuid4().hex
        self._exec(self._INSERT_TRIAL,
                   (tid, sub_train_job_id, model_id, worker_id,
                    json.dumps(knobs), TrialStatus.RUNNING, time.time()))
        return self.get_trial(tid)

    def reserve_trial(self, sub_train_job_id: str, model_id: str,
                      knobs: Dict[str, Any], worker_id: Optional[str] = None,
                      max_trials: Optional[int] = None) -> Optional[Dict]:
        """Create a RUNNING trial iff the sub-train-job's budget allows it
        (every trial but a TERMINATED one counts): the count and the insert
        run in one IMMEDIATE transaction, which takes the write lock first,
        so N workers (threads here, or processes on one WAL file) never
        overshoot ``max_trials``. Returns the row, or None when the budget
        is spent."""
        tid = uuid.uuid4().hex
        with self._lock:
            self._conn.execute("BEGIN IMMEDIATE")
            try:
                # the fence inside the transaction: a fenced admin never
                # mints a trial row
                self._fence_check_locked()
                if max_trials is not None:
                    row = self._conn.execute(
                        "SELECT COUNT(*) AS c FROM trial"
                        " WHERE sub_train_job_id=? AND status != ?",
                        (sub_train_job_id, TrialStatus.TERMINATED)).fetchone()
                    if row["c"] >= max_trials:
                        self._conn.execute("ROLLBACK")
                        return None
                self._conn.execute(
                    self._INSERT_TRIAL,
                    (tid, sub_train_job_id, model_id, worker_id,
                     json.dumps(knobs), TrialStatus.RUNNING, time.time()))
                self._conn.execute("COMMIT")
            except BaseException:
                self._conn.execute("ROLLBACK")
                raise
        return self.get_trial(tid)

    def get_trial(self, trial_id: str) -> Optional[Dict]:
        return _decode(self._one("SELECT * FROM trial WHERE id=?",
                                 (trial_id,)), "knobs")

    def _trials(self, sql: str, args: tuple) -> List[Dict]:
        return [_decode(t, "knobs") for t in self._all(sql, args)]

    def get_trials_of_sub_train_job(self,
                                    sub_train_job_id: str) -> List[Dict]:
        return self._trials(
            "SELECT * FROM trial WHERE sub_train_job_id=?"
            " ORDER BY datetime_started", (sub_train_job_id,))

    def get_trials_of_train_job(self, train_job_id: str) -> List[Dict]:
        return self._trials(
            "SELECT t.* FROM trial t"
            " JOIN sub_train_job s ON t.sub_train_job_id = s.id"
            " WHERE s.train_job_id=? ORDER BY t.datetime_started",
            (train_job_id,))

    def get_trial_fault_summary_of_live_jobs(self) -> Dict[str, Dict]:
        """One grouped query for ``/fleet/health``'s training section:
        train job id -> ``{"faults": {kind: count}, "retries": total}``
        over every STARTED or RUNNING train job. ``faults`` counts the
        ERRORED rows; absorbed re-runs, on any row, add to ``retries``."""
        rows = self._all(
            "SELECT s.train_job_id AS jid, t.fault_kind AS k,"
            " t.status AS st, COUNT(*) AS c,"
            " COALESCE(SUM(t.attempt), 0) AS a"
            " FROM trial t"
            " JOIN sub_train_job s ON t.sub_train_job_id = s.id"
            " JOIN train_job j ON s.train_job_id = j.id"
            " WHERE j.status IN (?,?)"
            " GROUP BY s.train_job_id, t.fault_kind, t.status",
            (TrainJobStatus.STARTED, TrainJobStatus.RUNNING))
        out: Dict[str, Dict] = {}
        for r in rows:
            entry = out.setdefault(r["jid"], {"faults": {}, "retries": 0})
            if r["k"] is not None and r["st"] == TrialStatus.ERRORED:
                entry["faults"][r["k"]] = \
                    entry["faults"].get(r["k"], 0) + int(r["c"])
            entry["retries"] += int(r["a"])
        return out

    def get_best_trials_of_train_job(self, train_job_id: str,
                                     max_count: int = 2) -> List[Dict]:
        """COMPLETED trials, best score first."""
        return self._trials(
            "SELECT t.* FROM trial t"
            " JOIN sub_train_job s ON t.sub_train_job_id = s.id"
            " WHERE s.train_job_id=? AND t.status=?"
            " ORDER BY t.score DESC LIMIT ?",
            (train_job_id, TrialStatus.COMPLETED, max_count))

    def count_trials_of_sub_train_job(self, sub_train_job_id: str) -> int:
        """Every trial but a TERMINATED one counts toward the budget."""
        row = self._one(
            "SELECT COUNT(*) AS c FROM trial WHERE sub_train_job_id=?"
            " AND status != ?", (sub_train_job_id, TrialStatus.TERMINATED))
        return row["c"] if row else 0

    def mark_trial_as_complete(self, trial_id: str, score: float,
                               params_file_path: Optional[str]) -> None:
        self._exec(
            "UPDATE trial SET status=?, score=?, params_file_path=?,"
            " datetime_stopped=? WHERE id=?",
            (TrialStatus.COMPLETED, score, params_file_path, time.time(),
             trial_id))

    def mark_trial_as_errored(self, trial_id: str,
                              fault_kind: Optional[str] = None,
                              fault_detail: Optional[str] = None) -> None:
        """Terminal failure, with its kind and truncated traceback."""
        self._exec(
            "UPDATE trial SET status=?, fault_kind=?, fault_detail=?,"
            " datetime_stopped=? WHERE id=?",
            (TrialStatus.ERRORED, fault_kind, fault_detail, time.time(),
             trial_id))

    def record_trial_fault(self, trial_id: str, fault_kind: str,
                           fault_detail: Optional[str]) -> int:
        """An infra-class fault the worker is about to retry: bump the
        attempt counter and record the fault, but keep the trial RUNNING
        (same id, knobs and budget slot). Returns the new attempt."""
        self._exec(
            "UPDATE trial SET attempt=attempt+1, fault_kind=?,"
            " fault_detail=? WHERE id=?",
            (fault_kind, fault_detail, trial_id))
        row = self._one("SELECT attempt FROM trial WHERE id=?", (trial_id,))
        return int(row["attempt"]) if row else 0

    def mark_trial_as_terminated(self, trial_id: str) -> None:
        self._exec(
            "UPDATE trial SET status=?, datetime_stopped=? WHERE id=?",
            (TrialStatus.TERMINATED, time.time(), trial_id))

    def add_trial_log(self, trial_id: str, line: str) -> None:
        self._exec(
            "INSERT INTO trial_log (trial_id, line, datetime) VALUES (?,?,?)",
            (trial_id, line, time.time()))

    def get_trial_logs(self, trial_id: str) -> List[str]:
        return [r["line"] for r in self._all(
            "SELECT line FROM trial_log WHERE trial_id=? ORDER BY id",
            (trial_id,))]

    # -- inference jobs ------------------------------------------------------

    def create_inference_job(self, user_id: str, train_job_id: str,
                             budget: Optional[Dict[str, Any]] = None) -> Dict:
        iid = uuid.uuid4().hex
        self._exec(
            "INSERT INTO inference_job (id, user_id, train_job_id, status,"
            " budget, datetime_started) VALUES (?,?,?,?,?,?)",
            (iid, user_id, train_job_id, InferenceJobStatus.STARTED,
             json.dumps(budget or {}), time.time()))
        return self.get_inference_job(iid)

    def get_inference_job(self, inference_job_id: str) -> Optional[Dict]:
        return _decode(self._one("SELECT * FROM inference_job WHERE id=?",
                                 (inference_job_id,)), "budget", empty="{}")

    def get_inference_jobs_of_train_job(self,
                                        train_job_id: str) -> List[Dict]:
        return [_decode(r, "budget", empty="{}") for r in self._all(
            "SELECT * FROM inference_job WHERE train_job_id=?"
            " ORDER BY datetime_started DESC", (train_job_id,))]

    def get_inference_jobs_by_statuses(self,
                                       statuses: List[str]) -> List[Dict]:
        marks = ",".join("?" * len(statuses))
        return [_decode(r, "budget", empty="{}") for r in self._all(
            f"SELECT * FROM inference_job WHERE status IN ({marks})",
            tuple(statuses))]

    def get_running_inference_job_of_train_job(
            self, train_job_id: str) -> Optional[Dict]:
        return _decode(self._one(
            "SELECT * FROM inference_job WHERE train_job_id=? AND status IN"
            " (?,?)", (train_job_id, InferenceJobStatus.STARTED,
                       InferenceJobStatus.RUNNING)), "budget", empty="{}")

    def update_inference_job_predictor(self, inference_job_id: str,
                                       predictor_service_id: str) -> None:
        self._exec(
            "UPDATE inference_job SET predictor_service_id=? WHERE id=?",
            (predictor_service_id, inference_job_id))

    def mark_inference_job_as_running(self, inference_job_id: str) -> None:
        self._exec(
            "UPDATE inference_job SET status=? WHERE id=? AND status=?",
            (InferenceJobStatus.RUNNING, inference_job_id,
             InferenceJobStatus.STARTED))

    def _end_inference_job(self, inference_job_id: str, status: str) -> None:
        self._exec(
            "UPDATE inference_job SET status=?, datetime_stopped=? WHERE id=?"
            " AND status IN (?,?)",
            (status, time.time(), inference_job_id,
             InferenceJobStatus.STARTED, InferenceJobStatus.RUNNING))

    def mark_inference_job_as_stopped(self, inference_job_id: str) -> None:
        self._end_inference_job(inference_job_id, InferenceJobStatus.STOPPED)

    def mark_inference_job_as_errored(self, inference_job_id: str) -> None:
        self._end_inference_job(inference_job_id, InferenceJobStatus.ERRORED)

    def create_inference_job_worker(self, service_id: str,
                                    inference_job_id: str, trial_id: str,
                                    model_version: int = 0,
                                    standby: bool = False) -> Dict:
        self._exec(
            "INSERT INTO inference_job_worker (service_id, inference_job_id,"
            " trial_id, model_version, standby) VALUES (?,?,?,?,?)",
            (service_id, inference_job_id, trial_id, int(model_version),
             1 if standby else 0))
        return {"service_id": service_id,
                "inference_job_id": inference_job_id, "trial_id": trial_id,
                "model_version": int(model_version),
                "standby": 1 if standby else 0}

    def get_inference_job_worker(self, service_id: str) -> Optional[Dict]:
        return self._one(
            "SELECT * FROM inference_job_worker WHERE service_id=?",
            (service_id,))

    def get_workers_of_inference_job(self,
                                     inference_job_id: str) -> List[Dict]:
        return self._all(
            "SELECT * FROM inference_job_worker WHERE inference_job_id=?",
            (inference_job_id,))

    def set_worker_borrowed_chips(self, service_id: str,
                                  n_chips: int) -> None:
        """The cards a serving replica borrowed above the training floor
        (0: none), the durable twin of the arbiter's loan book."""
        self._exec("UPDATE inference_job_worker SET borrowed_chips=?"
                   " WHERE service_id=?", (int(n_chips), service_id))

    def set_worker_standby(self, service_id: str, standby: bool) -> None:
        """A replica's warm-standby flag (0: routable). A promotion clears
        it before the predictor routes to the replica."""
        self._exec(
            "UPDATE inference_job_worker SET standby=? WHERE service_id=?",
            (1 if standby else 0, service_id))

    # -- rollouts (admin/rollout.py) -----------------------------------------

    @staticmethod
    def _parse_rollout(row: Optional[Dict]) -> Optional[Dict]:
        if row is not None:
            try:
                row["events"] = json.loads(row.get("events") or "[]")
            except ValueError:
                row["events"] = []
            row["operator_ack"] = bool(row.get("operator_ack"))
        return row

    def create_rollout(self, inference_job_id: str,
                       from_trial_id: Optional[str], to_trial_id: str,
                       from_version: int, to_version: int,
                       n_replicas_before: int, phase: str) -> Dict:
        rid = uuid.uuid4().hex
        self._exec(
            "INSERT INTO rollout (id, inference_job_id, from_trial_id,"
            " to_trial_id, from_version, to_version, n_replicas_before,"
            " phase, datetime_started) VALUES (?,?,?,?,?,?,?,?,?)",
            (rid, inference_job_id, from_trial_id, to_trial_id,
             int(from_version), int(to_version), int(n_replicas_before),
             phase, time.time()))
        return self.get_rollout(rid)

    def get_rollout(self, rollout_id: str) -> Optional[Dict]:
        return self._parse_rollout(self._one(
            "SELECT * FROM rollout WHERE id=?", (rollout_id,)))

    def get_rollouts_of_inference_job(self,
                                      inference_job_id: str) -> List[Dict]:
        """The job's rollouts, newest first."""
        return [self._parse_rollout(r) for r in self._all(
            "SELECT * FROM rollout WHERE inference_job_id=?"
            " ORDER BY datetime_started DESC", (inference_job_id,))]

    def get_rollouts_by_phases(self, phases: List[str]) -> List[Dict]:
        marks = ",".join("?" * len(phases))
        return [self._parse_rollout(r) for r in self._all(
            f"SELECT * FROM rollout WHERE phase IN ({marks})",
            tuple(phases))]

    def mark_rollout_phase(self, rollout_id: str, phase: str,
                           reason: Optional[str] = None) -> None:
        """A phase move; a terminal phase stamps ``datetime_stopped`` and
        keeps the reason (the rollback's trigger, the abort's cause)."""
        if phase in RolloutPhase.TERMINAL:
            self._exec("UPDATE rollout SET phase=?, reason=?,"
                       " datetime_stopped=? WHERE id=?",
                       (phase, reason, time.time(), rollout_id))
        else:
            self._exec("UPDATE rollout SET phase=? WHERE id=?",
                       (phase, rollout_id))

    def update_rollout_events(self, rollout_id: str,
                              events: List[Dict]) -> None:
        self._exec("UPDATE rollout SET events=? WHERE id=?",
                   (json.dumps(events), rollout_id))

    def ack_rollout(self, rollout_id: str) -> None:
        """An operator saw the rollback."""
        self._exec("UPDATE rollout SET operator_ack=1 WHERE id=?",
                   (rollout_id,))

    # -- the drift loop's rows (admin/drift.py) ------------------------------

    @staticmethod
    def _parse_drift_state(row: Optional[Dict]) -> Optional[Dict]:
        if row is not None:
            for key in ("baseline", "signals"):
                try:
                    row[key] = (json.loads(row[key])
                                if row.get(key) else None)
                except ValueError:
                    row[key] = None
            try:
                row["events"] = json.loads(row.get("events") or "[]")
            except ValueError:
                row["events"] = []
            row["operator_ack"] = bool(row.get("operator_ack"))
        return row

    def create_drift_state(self, inference_job_id: str, phase: str) -> Dict:
        self._exec("INSERT INTO drift_state (inference_job_id, phase,"
                   " datetime_updated) VALUES (?,?,?)",
                   (inference_job_id, phase, time.time()))
        return self.get_drift_state(inference_job_id)

    def get_drift_state(self, inference_job_id: str) -> Optional[Dict]:
        return self._parse_drift_state(self._one(
            "SELECT * FROM drift_state WHERE inference_job_id=?",
            (inference_job_id,)))

    def get_drift_states(self) -> List[Dict]:
        """Every drift row (a restarted admin resumes the live ones)."""
        return [self._parse_drift_state(r)
                for r in self._all("SELECT * FROM drift_state")]

    def update_drift_state(self, inference_job_id: str, **fields) -> None:
        """Write the loop's mutable row; the JSON fields are encoded here,
        and an explicit None nulls ``baseline`` or ``signals``."""
        allowed = ("phase", "reason", "baseline", "signals",
                   "retrain_job_id", "candidate_trial_id",
                   "cooldown_until", "consecutive_rollbacks", "events",
                   "operator_ack")
        unknown = set(fields) - set(allowed)
        if unknown:
            raise ValueError(f"unknown drift_state fields {sorted(unknown)}")
        sets, vals = [], []
        for key in allowed:
            if key not in fields:
                continue
            val = fields[key]
            if key in ("baseline", "signals"):
                val = json.dumps(val) if val is not None else None
            elif key == "events":
                val = json.dumps(val or [])
            elif key == "operator_ack":
                val = 1 if val else 0
            sets.append(f"{key}=?")
            vals.append(val)
        sets.append("datetime_updated=?")
        vals += [time.time(), inference_job_id]
        self._exec("UPDATE drift_state SET " + ", ".join(sets)
                   + " WHERE inference_job_id=?", tuple(vals))

    # -- services ------------------------------------------------------------

    def create_service(self, service_type: str, replicas: int = 1,
                       chips: Optional[List[Any]] = None) -> Dict:
        sid = uuid.uuid4().hex
        self._exec(
            "INSERT INTO service (id, service_type, status, replicas, chips,"
            " datetime_started) VALUES (?,?,?,?,?,?)",
            (sid, service_type, ServiceStatus.STARTED, replicas,
             json.dumps(chips or []), time.time()))
        return self.get_service(sid)

    def get_service(self, service_id: str) -> Optional[Dict]:
        return _decode(self._one("SELECT * FROM service WHERE id=?",
                                 (service_id,)), "chips")

    def get_services(self, status: Optional[str] = None,
                     statuses: Optional[List[str]] = None) -> List[Dict]:
        """Services, filtered in SQL by one ``status`` or a ``statuses``
        list."""
        if statuses:
            marks = ",".join("?" * len(statuses))
            rows = self._all(
                f"SELECT * FROM service WHERE status IN ({marks})",
                tuple(statuses))
        elif status:
            rows = self._all("SELECT * FROM service WHERE status=?",
                             (status,))
        else:
            rows = self._all("SELECT * FROM service")
        return [_decode(s, "chips") for s in rows]

    def get_non_terminal_services(self) -> List[Dict]:
        """Crash recovery's scan in one query: every non-terminal service
        joined to its job linkage (a train worker's sub-train-job, train
        job and its status; a serving worker's inference job, trial,
        version, borrowed cards and its job's status; a predictor's job
        and its status)."""
        live = (ServiceStatus.STARTED, ServiceStatus.DEPLOYING,
                ServiceStatus.RUNNING)
        marks = ",".join("?" * len(live))
        rows = self._all(
            "SELECT s.*,"
            " tw.sub_train_job_id AS sub_train_job_id,"
            " st.train_job_id AS train_job_id,"
            " tj.status AS train_job_status,"
            " iw.inference_job_id AS inference_job_id,"
            " iw.trial_id AS trial_id,"
            " iw.model_version AS model_version,"
            " iw.borrowed_chips AS borrowed_chips,"
            " ij.status AS inference_job_status,"
            " pj.id AS predictor_job_id,"
            " pj.status AS predictor_job_status"
            " FROM service s"
            " LEFT JOIN train_job_worker tw ON tw.service_id = s.id"
            " LEFT JOIN sub_train_job st ON st.id = tw.sub_train_job_id"
            " LEFT JOIN train_job tj ON tj.id = st.train_job_id"
            " LEFT JOIN inference_job_worker iw ON iw.service_id = s.id"
            " LEFT JOIN inference_job ij ON ij.id = iw.inference_job_id"
            " LEFT JOIN inference_job pj ON pj.predictor_service_id = s.id"
            f" WHERE s.status IN ({marks})", live)
        return [_decode(s, "chips") for s in rows]

    def update_service_pid(self, service_id: str,
                           pid: Optional[int]) -> None:
        """The child process backing a process-placed service, so a
        restarted admin can adopt or fence it."""
        self._exec("UPDATE service SET pid=? WHERE id=?", (pid, service_id))

    def update_service_chips(self, service_id: str,
                             chips: List[Any]) -> None:
        self._exec("UPDATE service SET chips=? WHERE id=?",
                   (json.dumps(list(chips)), service_id))

    def update_service_host_port(self, service_id: str, host: str,
                                 port: int) -> None:
        self._exec("UPDATE service SET host=?, port=? WHERE id=?",
                   (host, port, service_id))

    def mark_service_as_deploying(self, service_id: str) -> None:
        """Guarded STARTED -> DEPLOYING: a fast worker may already have
        reported RUNNING, and that later status wins."""
        self._exec("UPDATE service SET status=? WHERE id=? AND status=?",
                   (ServiceStatus.DEPLOYING, service_id,
                    ServiceStatus.STARTED))

    def mark_service_as_running(self, service_id: str) -> None:
        self._exec("UPDATE service SET status=? WHERE id=?",
                   (ServiceStatus.RUNNING, service_id))

    def mark_service_as_stopped(self, service_id: str) -> None:
        self._exec(
            "UPDATE service SET status=?, datetime_stopped=? WHERE id=?",
            (ServiceStatus.STOPPED, time.time(), service_id))

    def mark_service_as_errored(self, service_id: str) -> None:
        self._exec(
            "UPDATE service SET status=?, datetime_stopped=? WHERE id=?",
            (ServiceStatus.ERRORED, time.time(), service_id))
