"""The port's metadata store and auth against the JAX package's.

The same seeded sequence of calls runs on ``rafiki_tpu.db.database.
Database(":memory:")`` and on the port's; the schemas of the carried
tables and every returned row must match, with ids and timestamps set
aside. ``reserve_trial`` under racing threads gives exactly the budget on
both. Tokens and password hashes made by either package check in the
other.
"""

import re
import threading

import numpy as np
import pytest

from rafiki_tpu.db import database as jax_database
from rafiki_tpu.utils import auth as jax_auth
from rafiki_tpu_torch import config
from rafiki_tpu_torch.config import NotPortedError
from rafiki_tpu_torch.db import database
from rafiki_tpu_torch.utils import auth

_ID = re.compile(r"^[0-9a-f]{32}$")


def _stores():
    return [("jax", jax_database.Database(":memory:")),
            ("torch", database.Database(":memory:"))]


def _normalize(value, ids):
    """Ids become their order of first appearance; timestamps a marker."""
    if isinstance(value, dict):
        return {k: ("<time>" if k.startswith("datetime") and v is not None
                    else _normalize(v, ids)) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_normalize(v, ids) for v in value]
    if isinstance(value, str) and _ID.match(value):
        return f"<id{ids.setdefault(value, len(ids))}>"
    return value


def _sequence(db, seed):
    """A seeded walk through every carried table; returns what each call
    gave back."""
    rng = np.random.default_rng(seed)
    out = []
    user = db.create_user(f"u{seed}@x", "hash", "MODEL_DEVELOPER")
    out += [user, db.get_user_by_email(f"u{seed}@x"), db.get_users()]
    db.ban_user(user["id"])
    out.append(db.get_user(user["id"]))
    models = [db.create_model(user["id"], f"m{i}", "IMAGE_CLASSIFICATION",
                              bytes(rng.integers(0, 255, 16, np.uint8)),
                              "M", {"numpy": None}, "PUBLIC",
                              verification='{"ok": true}')
              for i in range(2)]
    out += [models, db.get_models("IMAGE_CLASSIFICATION"),
            db.get_model_by_name(user["id"], "m1"), db.get_models("NONE")]
    db.delete_model(models[1]["id"])
    out.append(db.get_models())
    budget = {"MODEL_TRIAL_COUNT": int(rng.integers(2, 5)), "CHIP_COUNT": 1}
    for version in (1, 2):
        out.append(db.create_train_job(user["id"], "app", version,
                                       "IMAGE_CLASSIFICATION", "tr", "te",
                                       budget))
    job = out[-1]
    out += [db.get_next_app_version(user["id"], "app"),
            db.get_train_job_by_app_version(user["id"], "app", -1),
            db.get_train_jobs_of_user(user["id"]),
            db.get_train_jobs_of_app(user["id"], "app")]
    sub = db.create_sub_train_job(job["id"], models[0]["id"])
    db.update_sub_train_job_advisor(sub["id"], sub["id"])
    out += [sub, db.get_sub_train_job(sub["id"]),
            db.get_sub_train_jobs_of_train_job(job["id"])]
    svc = db.create_service("TRAIN", replicas=1)
    out += [svc, db.create_train_job_worker(svc["id"], sub["id"]),
            db.get_train_job_worker(svc["id"]),
            db.get_workers_of_sub_train_job(sub["id"]),
            db.get_workers_of_train_job(job["id"])]
    db.update_service_chips(svc["id"], [0])
    db.mark_service_as_deploying(svc["id"])
    db.mark_service_as_running(svc["id"])
    db.mark_service_as_deploying(svc["id"])  # guarded: stays RUNNING
    out += [db.get_service(svc["id"]), db.get_services(status="RUNNING")]
    db.mark_train_job_as_running(job["id"])
    trials = []
    for i in range(budget["MODEL_TRIAL_COUNT"] + 1):
        knobs = {"lr": float(rng.random()), "k": int(rng.integers(9))}
        trials.append(db.reserve_trial(
            sub["id"], models[0]["id"], knobs, worker_id=svc["id"],
            max_trials=budget["MODEL_TRIAL_COUNT"]))
    out.append(trials)
    reserved = [t for t in trials if t is not None]
    scores = rng.random(len(reserved))
    for n, (t, s) in enumerate(zip(reserved[1:], scores[1:])):
        db.mark_trial_as_complete(t["id"], float(s), f"/p/{n}.params")
    db.mark_trial_as_errored(reserved[0]["id"], "USER", "traceback")
    out.append(db.create_trial(sub["id"], models[0]["id"], {"lr": 0.5}))
    db.mark_trial_as_terminated(out[-1]["id"])
    for line in ("a", '{"type": "MESSAGE"}'):
        db.add_trial_log(reserved[1]["id"], line)
    out += [db.get_trial(reserved[0]["id"]),
            db.get_trials_of_sub_train_job(sub["id"]),
            db.get_trials_of_train_job(job["id"]),
            db.get_best_trials_of_train_job(job["id"], max_count=2),
            db.count_trials_of_sub_train_job(sub["id"]),
            db.get_trial_logs(reserved[1]["id"])]
    db.mark_service_as_stopped(svc["id"])
    db.mark_train_job_as_stopped(job["id"])
    db.mark_train_job_as_running(job["id"])  # guarded: stays STOPPED
    db.mark_train_job_as_errored(job["id"])  # guarded: stays STOPPED
    out += [db.get_train_job(job["id"]),
            db.get_train_jobs_by_statuses(["STOPPED", "STARTED"])]
    inf = db.create_inference_job(user["id"], job["id"],
                                  budget={"CHIPS_PER_WORKER": 1})
    psvc = db.create_service("PREDICT")
    db.update_inference_job_predictor(inf["id"], psvc["id"])
    isvc = db.create_service("INFERENCE", chips=[0])
    out += [inf, db.create_inference_job_worker(isvc["id"], inf["id"],
                                                reserved[1]["id"]),
            db.get_inference_job_worker(isvc["id"]),
            db.get_workers_of_inference_job(inf["id"]),
            db.get_running_inference_job_of_train_job(job["id"])]
    db.mark_inference_job_as_running(inf["id"])
    db.mark_service_as_errored(isvc["id"])
    out += [db.get_inference_job(inf["id"]),
            db.get_inference_jobs_by_statuses(["RUNNING"]),
            db.get_services(statuses=["ERRORED", "STARTED"])]
    db.mark_inference_job_as_stopped(inf["id"])
    db.mark_inference_job_as_errored(inf["id"])  # guarded: stays STOPPED
    out += [db.get_inference_jobs_of_train_job(job["id"]),
            db.get_running_inference_job_of_train_job(job["id"])]
    return out


@pytest.mark.parametrize("table", database.TABLES)
def test_schema_matches(table):
    (_, jax_db), (_, torch_db) = _stores()
    info = [conn.execute(f'PRAGMA table_info("{table}")').fetchall()
            for conn in (jax_db._b.conn, torch_db._conn)]
    assert info[1], f"no table {table}"
    assert [tuple(r) for r in info[0]] == [tuple(r) for r in info[1]]


@pytest.mark.parametrize("seed", range(3))
def test_rows_match(seed):
    results = {}
    for name, db in _stores():
        results[name] = _normalize(_sequence(db, seed), {})
    assert results["torch"] == results["jax"]


def _race(db, threads=8, budget=5):
    user = db.create_user("r@x", "h", "MODEL_DEVELOPER")
    model = db.create_model(user["id"], "m", "IMAGE_CLASSIFICATION", b"",
                            "M", {}, "PRIVATE")
    job = db.create_train_job(user["id"], "a", 1, "IMAGE_CLASSIFICATION",
                              "t", "e", {"MODEL_TRIAL_COUNT": budget})
    sub = db.create_sub_train_job(job["id"], model["id"])
    got, barrier = [], threading.Barrier(threads)

    def reserve():
        barrier.wait(timeout=10)
        for _ in range(budget):
            got.append(db.reserve_trial(sub["id"], model["id"], {},
                                        max_trials=budget))

    workers = [threading.Thread(target=reserve) for _ in range(threads)]
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=30)
    assert not any(w.is_alive() for w in workers)
    return (sum(t is not None for t in got),
            db.count_trials_of_sub_train_job(sub["id"]))


def test_reserve_trial_under_threads_gives_the_budget():
    """8 threads, each trying 5 times for a budget of 5: exactly 5 trials
    on both stores."""
    assert [_race(db) for _, db in _stores()] == [(5, 5), (5, 5)]


def test_postgres_url_is_refused():
    with pytest.raises(NotPortedError, match="PostgreSQL"):
        database.Database("postgresql://localhost/rafiki")


def test_default_store_file_is_the_ports_own(tmp_path, monkeypatch):
    monkeypatch.setenv("RAFIKI_WORKDIR", str(tmp_path))
    for name in ("RAFIKI_DB_URL", "RAFIKI_DB_PATH"):
        monkeypatch.delenv(name, raising=False)
    from rafiki_tpu import config as jax_config

    assert config.DB_PATH == str(tmp_path / "rafiki_torch.sqlite3")
    assert config.DB_PATH != jax_config.DB_PATH
    db = database.Database()
    assert db.path == config.DB_PATH
    assert (tmp_path / "rafiki_torch.sqlite3").exists()
    db.close()


@pytest.mark.parametrize("make,check", [
    (jax_auth, auth), (auth, jax_auth), (auth, auth)],
    ids=["jax-to-torch", "torch-to-jax", "torch"])
def test_tokens_and_passwords_check_across_packages(make, check):
    payload = {"user_id": "u1", "user_type": "APP_DEVELOPER"}
    token = make.generate_token(payload, secret="s3cret")
    decoded = check.decode_token(token, secret="s3cret")
    assert {k: decoded[k] for k in payload} == payload
    with pytest.raises(check.UnauthorizedError):
        check.decode_token(token, secret="other")
    with pytest.raises(check.UnauthorizedError):
        check.decode_token(token[:-2] + "xx", secret="s3cret")
    expired = make.generate_token({**payload, "exp": 1.0}, secret="s3cret")
    with pytest.raises(check.UnauthorizedError, match="expired"):
        check.decode_token(expired, secret="s3cret")
    hashed = make.hash_password("pw")
    assert check.verify_password("pw", hashed)
    assert not check.verify_password("nope", hashed)
    check.auth_check(decoded, ["APP_DEVELOPER"])
    with pytest.raises(check.UnauthorizedError):
        check.auth_check(decoded, ["ADMIN"])


def _rollout_sequence(db, seed):
    """A seeded walk through the rollout table and the worker row's loan
    and standby columns; returns what each call gave back."""
    rng = np.random.default_rng(seed)
    user = db.create_user(f"r{seed}@x", "hash", "ADMIN")
    job = db.create_train_job(user["id"], "app", 1, "IMAGE_CLASSIFICATION",
                              "tr", "te", {})
    inf = db.create_inference_job(user["id"], job["id"])
    out = []
    rows = []
    for i in range(int(rng.integers(2, 5))):
        rows.append(db.create_rollout(
            inf["id"], f"t{i}", f"t{i + 1}", i, i + 1,
            int(rng.integers(1, 4)), "CANARY"))
        out.append(rows[-1])
    for row in rows:
        phase = ["ROLLING", "DONE", "ROLLED_BACK", "ABORTED"][
            int(rng.integers(0, 4))]
        db.mark_rollout_phase(row["id"], phase,
                              f"reason {int(rng.integers(0, 9))}")
        db.update_rollout_events(row["id"], [
            {"event": "started", "n": int(rng.integers(0, 9))}])
        if rng.random() < 0.5:
            db.ack_rollout(row["id"])
        out.append(db.get_rollout(row["id"]))
    out += [db.get_rollouts_of_inference_job(inf["id"]),
            db.get_rollouts_by_phases(["CANARY", "ROLLING"]),
            db.get_rollouts_by_phases(["DONE", "ROLLED_BACK", "ABORTED"]),
            db.get_rollout("missing")]
    svc = db.create_service("INFERENCE")
    model = db.create_model(user["id"], "m", "IMAGE_CLASSIFICATION", b"",
                            "M", {}, "PRIVATE")
    sub = db.create_sub_train_job(job["id"], model["id"])
    trial = db.create_trial(sub["id"], model["id"], {})
    out.append(db.create_inference_job_worker(
        svc["id"], inf["id"], trial["id"],
        model_version=int(rng.integers(0, 3)), standby=True))
    db.set_worker_borrowed_chips(svc["id"], int(rng.integers(1, 4)))
    db.set_worker_standby(svc["id"], False)
    out.append(db.get_inference_job_worker(svc["id"]))
    return out


@pytest.mark.parametrize("seed", range(3))
def test_rollout_rows_match(seed):
    """Rollout rows of one seeded call sequence equal JAX's (the ORDER BY
    of rows started in one timestamp tick aside: compared as a set)."""
    results = {}
    for name, db in _stores():
        out = _normalize(_rollout_sequence(db, seed), {})
        for i, v in enumerate(out):
            if isinstance(v, list):
                out[i] = sorted(v, key=repr)
        results[name] = out
    assert results["torch"] == results["jax"]
