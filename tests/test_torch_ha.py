"""Control-plane HA: ``rafiki_tpu_torch/admin/standby.py``, the door's
standby gate, the client's walk of the admin addresses and the child's
admin client, against ``rafiki_tpu``'s, on the CPU; the twins of
``tests/test_control_plane_ha.py:382-786`` that need no host agent.

- A standby's door answers the root and login, sheds the rest with a
  503 carrying ``standby`` and the leader hint (twice over one
  keep-alive connection), and once the leader shuts down it promotes and
  the same door serves the new leader: the same answers, route by route,
  as JAX's standby (exact: statuses, roles, hints, epochs).
- The client walks its address list past a refused address to a live
  admin, and from a standby to the leader its 503 names; a single
  refused address is the typed ``AdminUnavailableError``, as JAX's.
- Split brain on thread placement: a leader paused past its TTL (its
  renewals suspended) while a second admin takes the lease at epoch 2
  has every write refused, at the store, in ``reserve_trial``, through
  its admin and through its door (a standby-style 503 naming the new
  leader), as JAX's does.
- A generation stream of the port in flight while its admin loses the
  leadership finishes with no error: the stream never consults the
  fence, while the fenced admin's control writes are refused.
- A fenced ex-leader's door sheds every route but the root and
  ``/tokens``; JAX's goes on answering reads and its stale advisor
  sessions (ROADMAP.md, C).
- A surviving train child reaches the promoted leader: its admin client
  walks ``RAFIKI_ADMIN_ADDR`` and then ``RAFIKI_ADMIN_ADDRS``, past a
  refused address and past a hung one (no answer in two lease TTLs); the
  JAX child's client, built from ``RAFIKI_ADMIN_ADDR`` alone
  (``rafiki_tpu/worker/bootstrap.py:136-141``), stays on the dead
  leader: its advisor call fails, or hangs (ROADMAP.md, C).

Waits are on conditions with deadlines of five TTLs or more, at TTLs of
1 s or more.
"""

import http.client
import json
import os
import socket
import threading
import time
import types
import urllib.error
import urllib.request

import pytest

from rafiki_tpu import config as jax_config
from rafiki_tpu.admin.admin import Admin as JaxAdmin
from rafiki_tpu.admin.http import AdminServer as JaxAdminServer
from rafiki_tpu.admin.lease import LeaseManager as JaxLease
from rafiki_tpu.admin.standby import StandbyAdmin as JaxStandby
from rafiki_tpu.advisor.remote import RemoteAdvisorStore as JaxRemote
from rafiki_tpu.client import client as jax_client
from rafiki_tpu.db.database import Database as JaxDatabase
from rafiki_tpu.placement import manager as jax_manager
from rafiki_tpu_torch import config
from rafiki_tpu_torch.admin.admin import Admin
from rafiki_tpu_torch.admin.http import AdminServer
from rafiki_tpu_torch.admin.lease import LeaseManager
from rafiki_tpu_torch.admin.standby import StandbyAdmin
from rafiki_tpu_torch.advisor.remote import RemoteAdvisorStore
from rafiki_tpu_torch.client import client
from rafiki_tpu_torch.db.database import Database, StaleEpochError
from rafiki_tpu_torch.placement import manager
from test_torch_stack import FAKE_TEMPLATE, JAX_FAKE

PACKAGES = {
    "jax": types.SimpleNamespace(
        Admin=JaxAdmin, AdminServer=JaxAdminServer, Database=JaxDatabase,
        Lease=JaxLease, Standby=JaxStandby, client=jax_client,
        placement=lambda: jax_manager.LocalPlacementManager(
            allocator=jax_manager.ChipAllocator([0])),
        template=JAX_FAKE.read_bytes(), config=jax_config),
    "torch": types.SimpleNamespace(
        Admin=Admin, AdminServer=AdminServer, Database=Database,
        Lease=LeaseManager, Standby=StandbyAdmin, client=client,
        placement=lambda: manager.LocalPlacementManager(
            manager.ChipAllocator(["cpu"])),
        template=FAKE_TEMPLATE, config=config),
}
CREDS = {"email": config.SUPERADMIN_EMAIL,
         "password": config.SUPERADMIN_PASSWORD}
TTL_S = 1.0


def wait_for(cond, timeout_s):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return cond()


def dead_addr():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return f"127.0.0.1:{port}"


def door(port, method, path, body=None, token=None):
    """(status, JSON body) of one request to a door."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", method=method,
        data=json.dumps(body).encode() if body is not None else None,
        headers={"Content-Type": "application/json",
                 **({"Authorization": f"Bearer {token}"} if token else {})})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


# ---------------------------------------------------------------------------
# the standby's door, then its promotion
# ---------------------------------------------------------------------------


def _standby_script(p, path, tmp_path):
    out = []
    db_leader = p.Database(path)
    lease1 = p.Lease(db_leader, holder="L1", ttl_s=5.0, renew_s=0.2)
    out.append(lease1.acquire())
    admin1 = p.Admin(db=db_leader, placement=p.placement(),
                     params_dir=str(tmp_path / "params"), lease=lease1)
    srv1 = p.AdminServer(admin1).start()
    leader = f"127.0.0.1:{srv1.port}"
    lease1.addr = leader  # advertised from the next renewal on
    out.append(wait_for(lambda: (db_leader.read_lease() or {}).get("addr")
                        == leader, 25))
    standby = p.Standby(
        p.Database(path), factory=lambda lease: p.Admin(
            db=p.Database(path), placement=p.placement(),
            params_dir=str(tmp_path / "params"), lease=lease), poll_s=0.1)
    srv2 = p.AdminServer(standby).start()
    try:
        root = door(srv2.port, "GET", "/")[1]["data"]
        out.append((root["ha"]["role"], root["ha"]["leader"] == leader,
                    root["recovery"]))
        status, body = door(srv2.port, "POST", "/tokens", CREDS)
        out.append(status)
        token = body["data"]["token"]
        # over one keep-alive connection: the shed drains the body
        conn = http.client.HTTPConnection("127.0.0.1", srv2.port,
                                          timeout=30)
        for _ in range(2):
            conn.request("POST", "/inference_jobs",
                         body=json.dumps({"app": "nope"}),
                         headers={"Authorization": f"Bearer {token}",
                                  "Content-Type": "application/json"})
            resp = conn.getresponse()
            shed = json.loads(resp.read())
            out.append((resp.status, shed["standby"],
                        shed["leader"] == leader,
                        resp.getheader("Retry-After")))
        conn.close()
        # a graceful handoff: the leader releases, the standby promotes
        srv1.stop()
        admin1.shutdown()
        out.append(standby.wait_promoted(timeout_s=25))
        out.append(wait_for(
            lambda: standby.recovery_status()["state"] == "ready", 25))
        root = door(srv2.port, "GET", "/")[1]["data"]
        out.append(root["ha"]["role"])
        status, _ = door(srv2.port, "POST", "/inference_jobs",
                         {"app": "nope"}, token)
        out.append(status != 503)
        out.append(db_leader.read_lease()["epoch"])
    finally:
        srv2.stop()
        standby.shutdown()
    return out


def test_the_standby_sheds_with_the_leader_hint_then_promotes(tmp_path):
    got = {}
    for name, p in PACKAGES.items():
        (tmp_path / name).mkdir()
        got[name] = _standby_script(p, str(tmp_path / name / "m.sqlite3"),
                                    tmp_path / name)
    assert got["torch"] == got["jax"]
    assert got["torch"][2] == ("standby", True, {"state": "ready"})
    assert got["torch"][4] == (503, True, True, "1")
    assert got["torch"][-3:] == ["leader", True, 2]


# ---------------------------------------------------------------------------
# the client's walk
# ---------------------------------------------------------------------------


def _walk_script(p, tmp_path):
    out = []
    c = p.client.Client(admin_addrs=[dead_addr()])
    try:
        c.login(config.SUPERADMIN_EMAIL, config.SUPERADMIN_PASSWORD)
    except Exception as e:
        out.append((type(e).__name__, isinstance(e, p.client.RafikiError)))
    admin = p.Admin(db=p.Database(":memory:"), placement=p.placement(),
                    params_dir=str(tmp_path))
    server = p.AdminServer(admin).start()
    try:
        live = f"127.0.0.1:{server.port}"
        c = p.client.Client(admin_addrs=[dead_addr(), live])
        out.append(c.login(config.SUPERADMIN_EMAIL,
                           config.SUPERADMIN_PASSWORD)["user_type"])
        out.append(c._addrs[c._active] == live)
        out.append(c.get_train_jobs())
    finally:
        server.stop()
        admin.shutdown()
    return out


def test_the_client_walks_the_address_list_to_a_live_admin(tmp_path):
    got = {}
    for name, p in PACKAGES.items():
        (tmp_path / name).mkdir()
        got[name] = _walk_script(p, tmp_path / name)
    assert got["torch"] == got["jax"] == [
        ("AdminUnavailableError", True), "SUPERADMIN", True, []]


def test_the_client_follows_a_standbys_hint_to_the_leader(tmp_path):
    """A client that knows only the standby logs in there, then follows
    the hint of the standby's 503 to the leader."""
    path = str(tmp_path / "m.sqlite3")
    db = Database(path)
    lease = LeaseManager(db, holder="L", ttl_s=30.0)
    assert lease.acquire()
    leader = Admin(db=db, placement=PACKAGES["torch"].placement(),
                   params_dir=str(tmp_path), lease=lease)
    srv1 = AdminServer(leader).start()
    lease.addr = f"127.0.0.1:{srv1.port}"
    db.renew_lease(lease.holder, lease.last_epoch(), 30.0, addr=lease.addr)
    standby = StandbyAdmin(Database(path), factory=lambda le: None,
                           poll_s=0.1)
    srv2 = AdminServer(standby).start()
    try:
        c = client.Client(admin_addrs=[f"127.0.0.1:{srv2.port}"])
        c.login(config.SUPERADMIN_EMAIL, config.SUPERADMIN_PASSWORD)
        assert c._addrs[c._active] == f"127.0.0.1:{srv2.port}"
        assert c.get_train_jobs() == []  # shed, then the leader answered
        assert c._addrs[c._active] == lease.addr
        # the standby's read-only view of the store, kept warm each poll
        assert wait_for(lambda: standby.snapshot().get(
            "inference_jobs_running") == 0, 5 * TTL_S)
    finally:
        srv2.stop()
        standby.shutdown()
        srv1.stop()
        leader.shutdown()


# ---------------------------------------------------------------------------
# split brain on thread placement
# ---------------------------------------------------------------------------


def _split_brain_script(p, path, tmp_path):
    out = []
    db_leader = p.Database(path)
    lease1 = p.Lease(db_leader, holder="L1", ttl_s=TTL_S, renew_s=0.2)
    out.append(lease1.acquire())
    admin1 = p.Admin(db=db_leader, placement=p.placement(),
                     params_dir=str(tmp_path / "p1"), lease=lease1)
    srv1 = p.AdminServer(admin1).start()
    admin2 = srv2 = None
    try:
        token = admin1.authenticate_user(**CREDS)["token"]
        uid = admin1.authenticate_user(**CREDS)["user_id"]
        admin1.create_model(uid, "fake", "IMAGE_CLASSIFICATION", p.template,
                            "FakeModel")
        # the leader pauses past its TTL (its renewals suspended)
        lease1.suspend()
        out.append(wait_for(lambda: db_leader.read_lease()["expires_at"]
                            <= time.time(), 5 * TTL_S))
        db2 = p.Database(path)
        lease2 = p.Lease(db2, holder="L2", ttl_s=30.0, renew_s=5.0)
        out.append(lease2.acquire())
        out.append(lease2.last_epoch())
        admin2 = p.Admin(db=db2, placement=p.placement(),
                         params_dir=str(tmp_path / "p2"), lease=lease2)
        srv2 = p.AdminServer(admin2).start()
        lease2.addr = f"127.0.0.1:{srv2.port}"
        db2.renew_lease("L2", 2, 30.0, addr=lease2.addr)
        out.append(wait_for(lambda: admin2.recovery_status()["state"]
                            == "ready", 25))
        # the old leader resumes at epoch 1: every write is refused
        lease1.resume()
        for write in (
                lambda: db_leader.create_user("stale@x", "h",
                                              "APP_DEVELOPER"),
                lambda: db_leader.reserve_trial("sub", "model", {},
                                                max_trials=9),
                lambda: admin1.create_train_job(
                    uid, "app", "IMAGE_CLASSIFICATION", "u://t", "u://e",
                    budget={"MODEL_TRIAL_COUNT": 1})):
            try:
                write()
                out.append("wrote")
            except Exception as e:
                out.append(type(e).__name__)
        status, body = door(srv1.port, "POST", "/users",
                            {"email": "x@y", "password": "p",
                             "user_type": "ADMIN"}, token)
        out.append((status, body.get("standby"),
                    body.get("leader") == lease2.addr))
        out.append(wait_for(lambda: admin1.ha_role() == "fenced",
                            5 * TTL_S))
        out.append(db_leader.get_user_by_email("stale@x"))
        out.append(db_leader.get_user_by_email("x@y"))
        out.append(len(db2.get_train_jobs_of_user(uid)))
        # the new leader writes
        out.append(admin2.create_user("new@x", "p", "ADMIN")["email"])
        out.append(door(srv2.port, "GET", "/")[1]["data"]["ha"]["role"])
    finally:
        lease1.resume()
        srv1.stop()
        lease1.stop(release=False)
        if srv2 is not None:
            srv2.stop()
        if admin2 is not None:
            admin2.shutdown()
    return out


def test_a_paused_leaders_writes_are_refused_everywhere(tmp_path):
    got = {}
    for name, p in PACKAGES.items():
        (tmp_path / name).mkdir()
        got[name] = _split_brain_script(p, str(tmp_path / name / "m.sqlite3"),
                                        tmp_path / name)
    assert got["torch"] == got["jax"]
    assert got["torch"][:4] == [True, True, True, 2]
    assert got["torch"][5:9] == ["StaleEpochError"] * 3 + [
        (503, True, True)]
    assert got["torch"][9:13] == [True, None, None, 0]


def _fenced_door_script(p, path, tmp_path):
    """An admin whose lease lapsed (renewals suspended past the TTL, no
    successor needed): what its door answers, route by route."""
    from rafiki_tpu.sdk.knob import FixedKnob as JaxFixed
    from rafiki_tpu_torch.sdk.knob import FixedKnob

    db = p.Database(path)
    lease = p.Lease(db, holder="L1", ttl_s=TTL_S, renew_s=0.2)
    out = [lease.acquire()]
    admin = p.Admin(db=db, placement=p.placement(),
                    params_dir=str(tmp_path), lease=lease)
    srv = p.AdminServer(admin).start()
    try:
        token = admin.authenticate_user(**CREDS)["token"]
        knob = (FixedKnob if p.Admin is Admin else JaxFixed)(1)
        admin.advisor_store.create_advisor({"k": knob}, advisor_id="sub")
        out.append(door(srv.port, "POST", "/advisors/sub/propose", {},
                        token)[0])
        lease.suspend()
        out.append(wait_for(lambda: admin.ha_role() == "fenced",
                            5 * TTL_S))
        for method, route, body in (
                ("POST", "/advisors/sub/propose", {}),
                ("GET", "/train_jobs", None),
                ("POST", "/users", {"email": "x@y", "password": "p",
                                    "user_type": "ADMIN"})):
            status, answer = door(srv.port, method, route, body, token)
            out.append((route, status, answer.get("standby"),
                        "StaleEpochError" in answer.get("error", "")))
        out.append(door(srv.port, "GET", "/")[1]["data"]["ha"]["role"])
        out.append(db.get_user_by_email("x@y"))
    finally:
        lease.resume()
        srv.stop()
        lease.stop(release=False)
        admin.shutdown()
    return out


def test_a_fenced_ex_leader_sheds_every_route_not_only_writes(tmp_path):
    """A fenced ex-leader's door sheds every route but the root and
    ``/tokens`` with the standby-style 503 typed as the fence's, so a
    client walks to the leader. JAX's sheds only the writes the fence
    refuses: it answers reads, and the advisor routes from its stale
    in-memory sessions (ROADMAP.md, C)."""
    got = {}
    for name, p in PACKAGES.items():
        (tmp_path / name).mkdir()
        got[name] = _fenced_door_script(
            p, str(tmp_path / name / "m.sqlite3"), tmp_path / name)
    shed = (503, True, True)
    assert got["torch"] == [True, 200, True,
                            ("/advisors/sub/propose",) + shed,
                            ("/train_jobs",) + shed,
                            ("/users",) + shed, "fenced", None]
    assert got["jax"] == [True, 200, True,
                          ("/advisors/sub/propose", 200, None, False),
                          ("/train_jobs", 200, None, False),
                          ("/users",) + shed, "fenced", None]


# ---------------------------------------------------------------------------
# a generation stream across a leadership loss
# ---------------------------------------------------------------------------


def test_a_generation_stream_survives_leadership_loss(tmp_path,
                                                      monkeypatch):
    from rafiki_tpu_torch.utils import chaos
    from test_torch_generation import TEMPLATE

    monkeypatch.setenv("RAFIKI_PREDICTOR_PORTS", "1")
    monkeypatch.setenv("RAFIKI_GEN_MAX_SLOTS", "2")
    monkeypatch.setenv("RAFIKI_GEN_SPEC", "0")
    path = str(tmp_path / "m.sqlite3")
    db_leader = Database(path)
    lease1 = LeaseManager(db_leader, holder="L1", ttl_s=TTL_S, renew_s=0.2)
    assert lease1.acquire()
    admin = Admin(db=db_leader, placement=PACKAGES["torch"].placement(),
                  params_dir=str(tmp_path / "params"), lease=lease1)
    server = AdminServer(admin).start()
    record = {"tokens": [], "error": None}
    try:
        uid = admin.authenticate_user(**CREDS)["user_id"]
        with open(TEMPLATE, "rb") as f:
            admin.create_model(uid, "gen", "TEXT_GENERATION", f.read(),
                               "TorchGenLM")
        admin.create_train_job(uid, "genha", "TEXT_GENERATION", "u://t",
                               "u://e", budget={"MODEL_TRIAL_COUNT": 1})
        assert admin.wait_until_train_job_stopped(
            uid, "genha", timeout_s=120)["status"] == "STOPPED"
        admin.create_inference_job(uid, "genha")
        c = client.Client("127.0.0.1", server.port, timeout_s=120)
        c.login(config.SUPERADMIN_EMAIL, config.SUPERADMIN_PASSWORD)
        # each decode round slowed, so the stream spans the handover
        chaos.install(chaos.parse_rules(
            "site=generate;action=delay;match=slot;delay_s=0.2"))

        def collect():
            try:
                for delta in c.generate("genha", [2, 3, 4], max_tokens=24):
                    record["tokens"].extend(delta.get("tokens") or [])
            except Exception as e:
                record["error"] = e
            record["done"] = True

        t = threading.Thread(target=collect, daemon=True)
        t.start()
        assert wait_for(lambda: record["tokens"] or record.get("done"), 60)
        # the leadership goes mid-stream: renewals frozen, the TTL lapses,
        # another holder takes the lease at epoch 2
        lease1.suspend()
        usurper = Database(path)
        assert wait_for(lambda: usurper.acquire_lease(
            "usurper", ttl_s=60.0) is not None, 5 * TTL_S)
        assert wait_for(lambda: lease1.role() == "fenced", 5 * TTL_S)
        assert not record.get("done"), "the stream ended before the loss"
        chaos.clear()
        t.join(timeout=120)
        assert not t.is_alive() and record["error"] is None
        assert len(record["tokens"]) >= 8
        with pytest.raises(StaleEpochError):
            db_leader.create_user("stale@x", "h", "APP_DEVELOPER")
        # through the door: the fenced admin sheds as a standby, and a
        # client of that one address cannot walk anywhere
        with pytest.raises(client.AdminUnavailableError):
            c.stop_inference_job("genha")
    finally:
        chaos.clear()
        server.stop()
        lease1.stop(release=False)
        admin.shutdown()


# ---------------------------------------------------------------------------
# the surviving child's admin client (ROADMAP.md, C)
# ---------------------------------------------------------------------------


def _hang(addr):
    """A listening socket at ``addr`` that never accepts: a connection is
    made and no answer comes, as from a leader stopped mid-call."""
    host, port = addr.rsplit(":", 1)
    s = socket.socket()
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind((host, int(port)))
    s.listen(8)
    return s


def test_the_childs_advisor_reaches_the_promoted_leader(tmp_path,
                                                        monkeypatch, caplog):
    """The old leader refuses connections: see ``_childs_advisor``."""
    _childs_advisor(tmp_path, monkeypatch, caplog, "refused")


def test_the_childs_advisor_walks_past_a_hung_leader(tmp_path, monkeypatch,
                                                     caplog):
    """The old leader takes connections and never answers: see
    ``_childs_advisor``."""
    _childs_advisor(tmp_path, monkeypatch, caplog, "hung")


def _childs_advisor(tmp_path, monkeypatch, caplog, loss):
    """The child logs in at its start, while its leader lives; after a
    failover the new leader answers at another address. The port's child
    walks ``RAFIKI_ADMIN_ADDR`` then ``RAFIKI_ADMIN_ADDRS``, past a
    refused address and past one that gives no answer in two lease TTLs,
    and its proposal lands on the new leader's (rebuilt) session; its
    client logs the walk. JAX's child client, built as its bootstrap
    builds it (an explicit host and port), holds the dead address alone:
    refused, its advisor call raises the typed unavailability at once
    (its ride-out catches neither that nor a walk); hung, it is still
    waiting when the port's call has long been answered."""
    import logging

    from rafiki_tpu.sdk.knob import FixedKnob as JaxFixed
    from rafiki_tpu_torch.sdk.knob import FixedKnob
    from rafiki_tpu_torch.worker import bootstrap

    monkeypatch.setenv("RAFIKI_ADVISOR_RETRY_S", "3")
    monkeypatch.setenv("RAFIKI_ADMIN_LEASE_TTL_S", str(TTL_S))
    caplog.set_level(logging.INFO, logger="rafiki_tpu_torch.client.client")
    got = {}
    for name, p in PACKAGES.items():
        admins = [p.Admin(db=p.Database(":memory:"), placement=p.placement(),
                          params_dir=str(tmp_path / name / str(i)))
                  for i in range(2)]
        servers = [p.AdminServer(a).start() for a in admins]
        old, new = (f"127.0.0.1:{srv.port}" for srv in servers)
        monkeypatch.setenv("RAFIKI_ADMIN_ADDR", old)
        monkeypatch.setenv("RAFIKI_ADMIN_ADDRS", f"{old},{new}")
        knob = (JaxFixed if name == "jax" else FixedKnob)(1)
        hung = None
        try:
            if name == "torch":
                c, remote = bootstrap._admin_client(), RemoteAdvisorStore
            else:
                host, port = os.environ["RAFIKI_ADMIN_ADDR"].rsplit(":", 1)
                c = p.client.Client(admin_host=host, admin_port=int(port))
                remote = JaxRemote
            c.login(config.SUPERADMIN_EMAIL, config.SUPERADMIN_PASSWORD)
            # the old leader dies, or hangs; the new one rebuilt the session
            servers[0].stop()
            if loss == "hung":
                hung = _hang(old)
            admins[1].advisor_store.create_advisor({"k": knob},
                                                   advisor_id="sub")
            box = {}

            def call():
                try:
                    box["answer"] = remote(c).propose("sub")
                except Exception as e:
                    box["answer"] = type(e).__name__

            t = threading.Thread(target=call, daemon=True)
            t.start()
            # the port's child walks on after 2 TTLs; JAX's is waited on
            # as long again
            t.join(timeout=5 * TTL_S if loss == "hung" else 30)
            answer = box.get("answer", "still waiting")
            if hung is not None:
                hung.close()  # a waiting call ends on the reset
                t.join(timeout=30)
            got[name] = (c._addrs == [old, new], c._addrs == [old], answer)
            if name == "torch":
                walk = (f"admin call POST /advisors/sub/propose answered by "
                        f"{new}, walked on from {old}")
        finally:
            if hung is not None:
                hung.close()
            servers[1].stop()
            for a in admins:
                a.shutdown()
    assert got["torch"] == (True, False, {"k": 1})
    assert got["jax"] == (False, True, "AdminUnavailableError"
                          if loss == "refused" else "still waiting")
    walks = [r.getMessage() for r in caplog.records
             if "walked on from" in r.getMessage()]
    assert walks == [walk], walks


# ---------------------------------------------------------------------------
# the two acceptance drills over real host agents: the twins of
# tests/test_control_plane_ha.py:494 (split brain) and :592 (the leader
# killed under load), through both packages' admins, agents (real
# AgentServers over thread engines, test_torch_hosts.ThreadEngine) and
# clients
# ---------------------------------------------------------------------------

from test_torch_hosts import KEY  # noqa: E402
from test_torch_hosts import PACKAGES as HOSTS  # noqa: E402
from test_torch_hosts import host_placement, seed_app, spawn_host  # noqa: E402
from test_torch_hosts import superadmin  # noqa: E402
from test_torch_recovery import crash, wait_ready  # noqa: E402


def _ha_hosts(p, tmp_path, monkeypatch):
    work = tmp_path / p.name
    (work / "logs").mkdir(parents=True)
    monkeypatch.setenv("RAFIKI_WORKDIR", str(work))
    monkeypatch.setenv("RAFIKI_LOGS_DIR", str(work / "logs"))
    path = str(work / "meta.sqlite3")
    db_agents = p.Database(path)
    hosts = [spawn_host(p, db_agents, ids) for ids in ((0, 1), (2, 3))]
    return work, path, db_agents, hosts


def _split_brain_drill(p, tmp_path, monkeypatch):
    p.chaos.clear()
    p.http.reset_breaker()
    work, path, db_agents, hosts = _ha_hosts(p, tmp_path, monkeypatch)
    addrs = [h[2] for h in hosts]
    Lease = PACKAGES[p.name].Lease
    db_leader = p.Database(path)
    lease1 = Lease(db_leader, holder="L1", addr="127.0.0.1:0", ttl_s=1.2,
                   renew_s=0.2)
    out = [lease1.acquire()]
    admin1 = p.Admin(db=db_leader,
                     placement=host_placement(p, addrs, db_leader),
                     params_dir=str(work / "params"), lease=lease1)
    admin2 = None
    try:
        uid = superadmin(p, admin1)
        out.append(seed_app(p, admin1, uid, "splitserve")["status"])
        admin1.create_inference_job(uid, "splitserve")
        inf = db_agents.get_inference_jobs_by_statuses(["RUNNING"])[0]
        sids = sorted(w["service_id"] for w in
                      db_agents.get_workers_of_inference_job(inf["id"]))
        # the leader pauses past its TTL
        lease1.suspend()
        out.append(wait_for(lambda: (db_agents.read_lease() or {
            "expires_at": 0})["expires_at"] <= time.time(), 6.0))
        db_new = p.Database(path)
        lease2 = Lease(db_new, holder="L2", ttl_s=30.0, renew_s=5.0)
        out += [lease2.acquire(), lease2.last_epoch()]
        admin2 = p.Admin(db=db_new, placement=host_placement(p, addrs,
                                                             db_new),
                         params_dir=str(work / "params"), lease=lease2)
        report = wait_ready(admin2)
        out.append(report["adopted"] == len(sids))
        out.append(sorted(f.name for f in (work / "logs").glob(
            "recovery*.json")))
        # the old leader resumes at epoch 1: refused at the store and by
        # every agent, typed (the agents learned epoch 2 from the probes)
        lease1.resume()
        for write in (
                lambda: db_leader.create_user("stale@x", "h",
                                              "APP_DEVELOPER"),
                lambda: db_leader.reserve_trial("any-sub", "any-model", {},
                                                max_trials=9)):
            with pytest.raises(Exception) as err:
                write()
            out.append(type(err.value).__name__)
        with pytest.raises(p.http.AgentHTTPError) as err:
            p.http.call_agent(addrs[0], "POST", f"/services/{sids[0]}/stop",
                              {"wait": False}, key=KEY, epoch=1)
        out.append(err.value.code)
        handle = p.hosts._AgentHandle(addrs[0], key=KEY)
        handle.epoch_provider = lambda: 1
        for call in (lambda: handle.stop_service(sids[0], wait=False),
                     lambda: handle.create_service(
                         "split-doomed", "INFERENCE", 1, False,
                         {"inference_job_id": inf["id"], "trial_id": "t"})):
            with pytest.raises(p.hosts.StaleAdminEpochError):
                call()
        # the fenced admin's own placement gets the typed refusal too
        with pytest.raises(p.hosts.StaleAdminEpochError):
            admin1.placement.agents[addrs[0]].stop_service(sids[0],
                                                           wait=False)
        running = []
        for addr in addrs:
            inv = p.http.call_agent(addr, "GET", "/inventory", key=KEY,
                                    timeout_s=5)
            running += [e["service_id"] for e in inv["services"]]
            out.append(inv["admin_epoch"])
        out.append((len(running) == len(set(running)),
                    sorted(set(running) & set(sids)) == sids,
                    "split-doomed" in running))
        tj = db_agents.get_train_jobs_of_user(uid)[0]
        out.append(len([t for t in db_agents.get_trials_of_train_job(
            tj["id"]) if t["status"] == "COMPLETED"]))
        out.append(admin2.predict(uid, "splitserve", [[1.0]]))
    finally:
        lease1.resume()
        crash(admin1)
        lease1.stop(release=False)
        if admin2 is not None:
            admin2.shutdown()
        for _, srv, _ in hosts:
            srv.stop()
    return out


def test_a_resumed_stale_leader_is_fenced_by_the_agents_too(
        tmp_path, monkeypatch):
    """Split brain over agents: the paused leader's successor adopts the
    fleet at epoch 2 (its probes teach the agents the epoch); the resumed
    ex-leader is refused at the store and 412 by every agent, as a raw
    call, through a stale handle and through its own placement; nothing
    is placed twice; the job scored its budget; serving goes on."""
    got = {name: _split_brain_drill(p, tmp_path, monkeypatch)
           for name, p in HOSTS.items()}
    assert got["torch"] == got["jax"]
    assert got["torch"] == [
        True, "STOPPED", True, True, 2, True,
        ["recovery-e2.json", "recovery.json"], "StaleEpochError",
        "StaleEpochError", 412, 2, 2, (True, True, False), 2,
        [[0.5, 0.5]]]


def _leader_kill_drill(p, tmp_path, monkeypatch):
    p.chaos.clear()
    p.http.reset_breaker()
    monkeypatch.setattr(p.config, "INFERENCE_WORKER_REPLICAS_PER_TRIAL", 1)
    ttl = 2.5
    work, path, db_agents, hosts = _ha_hosts(p, tmp_path, monkeypatch)
    addrs = [h[2] for h in hosts]
    ns = PACKAGES[p.name]
    db_leader = p.Database(path)
    lease1 = ns.Lease(db_leader, holder="L1", ttl_s=ttl, renew_s=0.4)
    assert lease1.acquire() is True
    admin1 = p.Admin(db=db_leader,
                     placement=host_placement(p, addrs, db_leader),
                     params_dir=str(work / "params"), lease=lease1)
    srv1 = p.AdminServer(admin1).start()
    lease1.addr = f"127.0.0.1:{srv1.port}"

    def factory(lease):
        db = p.Database(path)
        return p.Admin(db=db, placement=host_placement(p, addrs, db),
                       params_dir=str(work / "params"), lease=lease)

    standby = ns.Standby(p.Database(path), factory=factory, poll_s=0.1)
    srv2 = p.AdminServer(standby).start()
    standby._lease.addr = f"127.0.0.1:{srv2.port}"
    both_doors = [f"127.0.0.1:{srv1.port}", f"127.0.0.1:{srv2.port}"]
    out = []
    stop_load = threading.Event()
    try:
        uid = superadmin(p, admin1)
        out.append(seed_app(p, admin1, uid, "hakill")["status"])
        admin1.create_inference_job(uid, "hakill")
        c = ns.client.Client(admin_addrs=both_doors)
        c.login(**CREDS)
        out.append(len(c.predict("hakill", [[1.0]])))
        ok, failures = [0], []

        def load():
            lc = ns.client.Client(admin_addrs=both_doors)
            lc.login(**CREDS)
            while not stop_load.is_set():
                try:
                    assert len(lc.predict("hakill", [[1.0]])) == 1
                    ok[0] += 1
                except Exception as e:  # every failure is the drill's
                    failures.append(repr(e))
                time.sleep(0.02)

        loader = threading.Thread(target=load, daemon=True)
        loader.start()
        wait_for(lambda: ok[0] >= 3, 20.0)
        # a budget-2 train job in flight across the failover
        template = work / "fake_model.py"
        template.write_bytes(ns.template)
        c.create_model("fake-live", "IMAGE_CLASSIFICATION", str(template),
                       "FakeModel")
        c.create_train_job("halive", "IMAGE_CLASSIFICATION", "uri://t",
                           "uri://e", budget={"MODEL_TRIAL_COUNT": 2,
                                              "CHIP_COUNT": 2},
                           models=["fake-live"])
        # the leader dies: door, renewals and placement at once
        t_kill = time.monotonic()
        srv1.stop()
        lease1.suspend()
        crash(admin1)
        out.append(standby.wait_promoted(timeout_s=2 * ttl + 10.0))
        promoted_in = time.monotonic() - t_kill
        out.append(wait_for(lambda: standby.recovery_status()["state"]
                            == "ready", 30.0))
        out.append(db_agents.read_lease()["epoch"])
        out.append(wait_for(lambda: c.get_train_job("halive")["status"]
                            == "STOPPED", 60.0))
        wait_for(lambda: ok[0] >= 10, 30.0)  # load on the promoted leader
        stop_load.set()
        loader.join(timeout=30.0)
        out.append((failures, ok[0] >= 10))
        tj = c.get_train_job("halive")
        out.append(len([t for t in db_agents.get_trials_of_train_job(
            tj["id"]) if t["status"] == "COMPLETED"]))
        out.append(len(c.predict("hakill", [[1.0]])))
    finally:
        stop_load.set()
        lease1.resume()
        crash(admin1)
        lease1.stop(release=False)
        srv2.stop()
        standby.shutdown()
        for _, srv, _ in hosts:
            srv.stop()
    return out, promoted_in


def test_the_leader_killed_under_load_fails_over_with_no_failed_request(
        tmp_path, monkeypatch):
    """A continuous predict load and a budget-2 train job on the agents
    while the leader's door, renewals and placement die at once: the
    standby promotes within two TTLs, adopts the agents' fleet, the
    client's address walk absorbs the gap with no failed request, and the
    job scores exactly 2 trials."""
    got = {name: _leader_kill_drill(p, tmp_path, monkeypatch)
           for name, p in HOSTS.items()}
    assert got["torch"][0] == got["jax"][0]
    assert got["torch"][0] == ["STOPPED", 1, True, True, 2, True, ([], True),
                               2, 1]
    # the port's promotion within two TTLs of the kill, as JAX's test
    # holds JAX's (tests/test_control_plane_ha.py:592)
    assert got["torch"][1] <= 2 * 2.5, got
