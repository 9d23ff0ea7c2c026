"""The leadership lease and the epoch write-fence:
``rafiki_tpu_torch/db/database.py`` and ``admin/lease.py`` against
``rafiki_tpu``'s, the twins of ``tests/test_control_plane_ha.py:195-381``.

Each case runs one script on each package's store (two handles on one
SQLite file where the case needs a second admin) and records every
return value, epoch, role and raised type; the two records must be
equal (exact: they are integers, booleans, strings and type names). The
cases that wait on the lease's renewal thread wait on a condition with a
deadline of at least five TTLs, at TTLs of 1 s or more, never on a fixed
sleep.
"""

import os
import time
import types

import pytest

from rafiki_tpu import config as jax_config
from rafiki_tpu.admin import lease as jax_lease
from rafiki_tpu.admin.recovery import ControlPlaneRecovery as JaxRecovery
from rafiki_tpu.db import database as jax_database
from rafiki_tpu.utils import chaos as jax_chaos
from rafiki_tpu_torch import config
from rafiki_tpu_torch.admin import lease
from rafiki_tpu_torch.admin.recovery import ControlPlaneRecovery
from rafiki_tpu_torch.db import database
from rafiki_tpu_torch.utils import chaos

PACKAGES = {
    "jax": types.SimpleNamespace(db=jax_database, lease=jax_lease,
                                 chaos=jax_chaos, config=jax_config,
                                 recovery=JaxRecovery),
    "torch": types.SimpleNamespace(db=database, lease=lease, chaos=chaos,
                                   config=config,
                                   recovery=ControlPlaneRecovery),
}


@pytest.fixture(autouse=True)
def _clean_chaos():
    for p in PACKAGES.values():
        p.chaos.clear()
    yield
    for p in PACKAGES.values():
        p.chaos.clear()


def wait_for(cond, timeout_s):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return cond()


def outcome(fn):
    """``fn()``'s value, or the name of the type it raised."""
    try:
        return fn()
    except Exception as e:
        return type(e).__name__


def _epoch(row):
    return None if row is None else row["epoch"]


def seq_acquire(p, path, rec):
    db = p.db.Database(path)
    rec.append(_epoch(db.acquire_lease("a", ttl_s=30.0, addr="h:1")))
    # the same holder's re-take bumps the epoch too
    rec.append(_epoch(db.acquire_lease("a", ttl_s=30.0, addr="h:1")))
    rec.append(db.acquire_lease("b", ttl_s=30.0))  # a live lease excludes
    row = db.read_lease()
    rec.append((row["holder"], row["epoch"], row["addr"]))
    # an expired lease is up for grabs, and the epoch keeps climbing
    rec.append(_epoch(db.acquire_lease("a", ttl_s=0.0)))
    rec.append(_epoch(db.acquire_lease("b", ttl_s=30.0)))


def seq_renew(p, path, rec):
    db = p.db.Database(path)
    row = db.acquire_lease("a", ttl_s=0.0)
    # expiry alone does not fail a renewal: the (holder, epoch) CAS does
    rec.append(db.renew_lease("a", row["epoch"], ttl_s=30.0))
    rec.append(db.renew_lease("a", row["epoch"] + 1, ttl_s=30.0))
    rec.append(db.renew_lease("someone-else", row["epoch"], ttl_s=30.0))
    rec.append(db.release_lease("a", row["epoch"]))
    rec.append(db.release_lease("a", row["epoch"]))  # still its epoch
    rec.append(_epoch(db.acquire_lease("b", ttl_s=30.0)))
    rec.append(db.renew_lease("a", row["epoch"], ttl_s=30.0))
    rec.append(db.release_lease("a", row["epoch"]))


def seq_fence(p, path, rec):
    stale, new = p.db.Database(path), p.db.Database(path)
    row = stale.acquire_lease("old", ttl_s=0.0)
    stale.set_fence(row["epoch"], time.monotonic() + 60.0)
    new.acquire_lease("new", ttl_s=60.0)
    try:
        stale.create_user("stale@x", "h", "APP_DEVELOPER")
        rec.append("wrote")
    except p.db.StaleEpochError as e:
        rec.append((type(e).__name__, e.expected, e.current,
                    "stale epoch" in str(e)))
    # reads are served to a fenced handle
    rec.append(stale.read_lease()["epoch"])
    rec.append(stale.get_user_by_email("stale@x"))
    rec.append(outcome(lambda: new.create_user(
        "new@x", "h", "APP_DEVELOPER")["email"]))
    stale.clear_fence()
    rec.append(outcome(lambda: stale.create_user(
        "later@x", "h", "APP_DEVELOPER")["email"]))


def seq_self_fence(p, path, rec):
    db = p.db.Database(path)
    row = db.acquire_lease("a", ttl_s=60.0)
    # the row is live and its own, but the validity lapsed: refused first
    db.set_fence(row["epoch"], time.monotonic() - 0.001)
    try:
        db.create_user("x@x", "h", "APP_DEVELOPER")
        rec.append("wrote")
    except p.db.StaleEpochError as e:
        rec.append((type(e).__name__, e.expected, e.current,
                    "self-fenced" in str(e)))
    rec.append(db.get_user_by_email("x@x"))


def seq_reserve_trial(p, path, rec):
    db = p.db.Database(path)
    db.acquire_lease("a", ttl_s=60.0)
    db.set_fence(1, time.monotonic() - 0.001)
    rec.append(outcome(lambda: db.reserve_trial(
        "no-such-sub", "no-such-model", {}, max_trials=1)))
    db.set_fence(2, time.monotonic() + 60.0)  # a stale epoch, still valid
    rec.append(outcome(lambda: db.reserve_trial(
        "no-such-sub", "no-such-model", {}, max_trials=1)))


def seq_renew_errors(p, path, rec):
    """Two renewals error (the false-lease-loss drill): no demotion while
    the TTL holds, and the fence extends again after."""
    db = p.db.Database(path)
    mgr = p.lease.LeaseManager(db, holder="L", ttl_s=2.0, renew_s=0.1)
    try:
        rec.append(mgr.acquire())
        mgr.start()
        (rule,) = p.chaos.parse_rules(
            "site=lease;action=error;match=renew;times=2")
        p.chaos.install([rule])
        # the third renewal is past the two errors and lands
        rec.append(wait_for(lambda: rule.hits >= 3, 5 * mgr.ttl_s))
        rec.append((mgr.role(), mgr.epoch()))
        rec.append(wait_for(lambda: mgr.valid_for_s() > 1.5, 5 * mgr.ttl_s))
    finally:
        p.chaos.clear()
        mgr.stop()


def seq_persistent_failure(p, path, rec):
    """Every renewal errors: the leader fences itself at its TTL, and a
    successor takes the lease only after the wall-clock TTL."""
    db = p.db.Database(path)
    mgr = p.lease.LeaseManager(db, holder="L", ttl_s=1.0, renew_s=0.1)
    try:
        rec.append(mgr.acquire())
        mgr.start()
        p.chaos.install(p.chaos.parse_rules(
            "site=lease;action=error;match=renew"))
        rec.append(wait_for(lambda: mgr.role() == "fenced", 5 * mgr.ttl_s))
        rec.append(outcome(lambda: db.create_user("x@x", "h",
                                                  "APP_DEVELOPER")))
        p.chaos.clear()
        db2 = p.db.Database(path)
        rec.append(wait_for(
            lambda: db2.acquire_lease("S", ttl_s=30.0) is not None,
            5 * mgr.ttl_s))
        rec.append(db2.read_lease()["epoch"])
        # the CAS now fails for good: the old manager stays fenced
        rec.append(wait_for(lambda: mgr.valid_for_s() == 0.0, 5 * mgr.ttl_s))
        rec.append(mgr.role())
    finally:
        p.chaos.clear()
        mgr.stop(release=False)


def seq_slow_store(p, path, rec):
    """Renewals delayed by a slow store still land: leadership holds."""
    db = p.db.Database(path)
    mgr = p.lease.LeaseManager(db, holder="L", ttl_s=2.0, renew_s=0.1)
    try:
        rec.append(mgr.acquire())
        mgr.start()
        (rule,) = p.chaos.parse_rules(
            "site=lease;action=delay;match=renew;delay_s=0.15")
        p.chaos.install([rule])
        rec.append(wait_for(lambda: rule.hits >= 4, 5 * mgr.ttl_s))
        rec.append((mgr.role(), mgr.epoch()))
    finally:
        p.chaos.clear()
        mgr.stop()


def seq_release_on_stop(p, path, rec):
    """A graceful stop expires the lease, so a standby takes it at once,
    and clears the fence."""
    db = p.db.Database(path)
    mgr = p.lease.LeaseManager(db, holder="L", ttl_s=30.0)
    rec.append(mgr.acquire())
    rec.append(mgr.status()["role"])
    standby = p.lease.LeaseManager(p.db.Database(path), holder="S",
                                   ttl_s=30.0)
    rec.append(standby.acquire(block=False))
    mgr.stop(release=True)
    rec.append(standby.acquire(block=False))
    rec.append(standby.last_epoch())
    rec.append(outcome(lambda: db.create_user("after@x", "h",
                                              "APP_DEVELOPER")["email"]))
    standby.stop(release=True)


def seq_prune_reports(p, path, rec):
    logs = os.path.join(os.path.dirname(path), "logs")
    os.makedirs(logs)
    for e in range(1, 9):
        with open(os.path.join(logs, f"recovery-e{e}.json"), "w") as f:
            f.write("{}")
    with open(os.path.join(logs, "recovery.json"), "w") as f:
        f.write("{}")
    p.recovery._prune_epoch_reports(logs)
    rec.append(sorted(os.listdir(logs)))


SEQUENCES = {
    "acquire_bumps_epoch_and_excludes_a_live_holder": seq_acquire,
    "renew_is_cas_on_holder_and_epoch": seq_renew,
    "fence_blocks_stale_writes_not_reads": seq_fence,
    "self_fence_past_validity_without_reading_the_store": seq_self_fence,
    "reserve_trial_refuses_under_a_stale_fence": seq_reserve_trial,
    "renewal_errors_do_not_demote_while_the_ttl_holds": seq_renew_errors,
    "persistent_failure_self_fences_then_fails_over":
        seq_persistent_failure,
    "slow_lease_store_delays_but_keeps_leadership": seq_slow_store,
    "stop_releases_the_lease_and_clears_the_fence": seq_release_on_stop,
    "epoch_suffixed_recovery_reports_are_pruned": seq_prune_reports,
}


@pytest.mark.parametrize("case", sorted(SEQUENCES))
def test_lease_and_fence_match_jax(case, tmp_path):
    """The same script gives the same record on both packages (exact)."""
    records = {}
    for name, p in PACKAGES.items():
        rec = []
        (tmp_path / name).mkdir()
        SEQUENCES[case](p, str(tmp_path / name / "meta.sqlite3"), rec)
        records[name] = rec
    assert records["torch"] == records["jax"]
    assert records["torch"], "the script recorded nothing"


def test_lease_table_and_fence_verbs_match_jax(tmp_path):
    """The lease row's shape, its one id, and the verbs the fence
    guards are JAX's."""
    assert database.LEASE_ID == jax_database.LEASE_ID
    assert database.Database._MUTATING_VERBS \
        == jax_database.Database._MUTATING_VERBS
    ours = database.Database(str(tmp_path / "a.sqlite3"))
    theirs = jax_database.Database(str(tmp_path / "b.sqlite3"))
    for db in (ours, theirs):
        db.acquire_lease("h", ttl_s=5.0, addr="x:1")
    assert sorted(ours.read_lease()) == sorted(theirs.read_lease())
    assert "lease" in chaos.HOOKED_SITES and "db" in chaos.HOOKED_SITES


@pytest.mark.parametrize("action", ["error", "delay"])
def test_db_chaos_site_matches_jax(action):
    """The ``db`` site: an error rule raises the typed transient failure
    once and the store is healthy after it; a delay rule sleeps."""
    got = {}
    for name, p in PACKAGES.items():
        db = p.db.Database(":memory:")
        p.chaos.install([p.chaos.ChaosRule(
            site="db", action=action, match="FROM service", times=1,
            delay_s=0.05)])
        t0 = time.monotonic()
        first = outcome(db.get_services)
        slept = time.monotonic() - t0 >= 0.05
        got[name] = (first, slept, db.get_services())
        p.chaos.clear()
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == ("MetadataStoreChaosError" if action ==
                               "error" else [])


def test_store_chaos_is_an_infra_fault():
    """``classify_failure`` puts a chaos-injected store fault with the
    platform's (INFRA), as JAX's does."""
    from rafiki_tpu.worker.faults import classify_failure as jax_classify
    from rafiki_tpu_torch.worker.faults import classify_failure

    ours = classify_failure(database.MetadataStoreChaosError("x"))[0]
    theirs = jax_classify(jax_database.MetadataStoreChaosError("x"))[0]
    assert ours == theirs == "INFRA"
