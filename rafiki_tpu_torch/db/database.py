"""The metadata store: SQLite in WAL mode, shared by every thread.

Own copy of ``rafiki_tpu/db/database.py`` for the tables this slice uses
(``user``, ``model``, ``train_job``, ``sub_train_job``, ``service``,
``trial``, ``train_job_worker``, ``inference_job``,
``inference_job_worker``, ``trial_log``), with the same columns, types,
method names and row shapes. JSON columns (``budget``, ``knobs``,
``dependencies``, ``chips``) come back decoded. Job status changes are
guarded transitions (``WHERE status IN ...``): a late write that would
move a job backwards loses. :meth:`Database.reserve_trial` counts and
inserts in one IMMEDIATE transaction, so parallel workers never overshoot
a trial budget.

Not ported (ROADMAP.md): the PostgreSQL backend, epoch fencing and its
lease table, the rollout and drift tables, chaos hooks and the migrations
for stores written by older versions.
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
    ServiceStatus,
    TrainJobStatus,
    TrialStatus,
)

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
CREATE TABLE IF NOT EXISTS trial_log (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    trial_id TEXT NOT NULL REFERENCES trial(id),
    line TEXT NOT NULL,
    datetime REAL NOT NULL
);
CREATE INDEX IF NOT EXISTS idx_trial_log_trial ON trial_log(trial_id);
"""

#: the tables of :data:`_SCHEMA`, in creation order
TABLES = ("user", "model", "train_job", "sub_train_job", "service", "trial",
          "train_job_worker", "inference_job", "inference_job_worker",
          "trial_log")


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
        if path != ":memory:":
            # owner-only: the store holds password hashes and uploads
            os.chmod(path, 0o600)

    def close(self) -> None:
        with self._lock:
            self._conn.close()

    # -- low-level helpers -------------------------------------------------

    def _exec(self, sql: str, args: tuple = ()) -> None:
        with self._lock:
            self._conn.execute(sql, args)

    def _one(self, sql: str, args: tuple = ()) -> Optional[Dict[str, Any]]:
        with self._lock:
            row = self._conn.execute(sql, args).fetchone()
        return dict(row) if row else None

    def _all(self, sql: str, args: tuple = ()) -> List[Dict[str, Any]]:
        with self._lock:
            rows = self._conn.execute(sql, args).fetchall()
        return [dict(r) for r in rows]

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
