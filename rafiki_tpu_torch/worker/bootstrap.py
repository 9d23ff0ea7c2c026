"""A service's child process: ``python -m rafiki_tpu_torch.worker.bootstrap``.

Own copy of ``rafiki_tpu/worker/bootstrap.py``. ``ProcessPlacementManager``
starts it with what it needs in the environment:

    RAFIKI_SERVICE_ID / RAFIKI_SERVICE_TYPE   identity and dispatch
    CUDA_VISIBLE_DEVICES                      the granted cards (physical ids)
    RAFIKI_CHIP_GRANT                         their indices here (0..n-1),
                                              or CPU entries ("cpu",
                                              "cpu:0,cpu:1")
    RAFIKI_DB_PATH                            the shared SQLite/WAL file
    RAFIKI_SUB_TRAIN_JOB_ID                   (TRAIN)
    RAFIKI_INFERENCE_JOB_ID, RAFIKI_TRIAL_ID  (INFERENCE; a fused
    ensemble's RAFIKI_TRIAL_IDS too)
    RAFIKI_ADMIN_ADDR                         host:port of the admin's door
    RAFIKI_ADMIN_ADDRS                        (HA) every admin's host:port
    RAFIKI_ORPHAN_SURVIVE                     (TRAIN) "1": outlive the admin
    RAFIKI_BROKER_PREFIX                      the shm data plane's namespace

Status protocol: the service's row goes RUNNING on ``ctx.ready()``, STOPPED
on a clean exit or SIGTERM, ERRORED on a crash, and the exit code mirrors
it (0 or 1) for the parent's monitor. A worker granted several devices
starts its followers here, one process a device, as rank 0 of their data
group (``parallel/ranks.py``); they write their own ``startup`` and
``kernel launches`` lines into this child's log. A child granted a card
that finds no CUDA raises before it reports ready.

The orphan watchdog: a child whose parent dies (it is reparented) stops
and marks its row ERRORED, a replica lost with its admin or host agent
(the original's writes STOPPED), unless it is a TRAIN child with
``RAFIKI_ORPHAN_SURVIVE=1`` (set by an admin's engine): that one keeps
training for the restarted or promoted
admin to adopt by pid, and stops only when its service row goes terminal
(a fence, a stop, or its own end). The admin client walks
``RAFIKI_ADMIN_ADDR`` and then every address of ``RAFIKI_ADMIN_ADDRS``,
so a surviving child's advisor calls reach a standby promoted at another
address (the JAX child's client holds ``RAFIKI_ADMIN_ADDR`` alone).

Log lines the smoke test reads, each with the pid: ``startup`` (JSON of
wall-clock stamps: the process's start, ``main``, torch imported, CUDA
ready, kernel libraries loaded, ready; and the grant) and, at exit,
``kernel launches`` (JSON of the four attention kernels' launch counters
in this process, which the parent cannot see). SIGUSR1 adds a ``kernel
launches so far`` line of the same counters (read by the next beat of
the watchdog, within 2 s), so a caller can split a long-lived child's
launches at a moment of its choosing.

Not ported: the JAX platform override.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import sys
import threading
import time
import traceback

logger = logging.getLogger(__name__)

#: the attention kernels' wrappers, by name in ops/flash_attention.py
KERNELS = ("flash_attention", "flash_attention_lse", "flash_attention_dq",
           "flash_attention_dkv")


def _require(name: str) -> str:
    v = os.environ.get(name)
    if not v:
        raise RuntimeError(f"bootstrap: missing env {name}")
    return v


def _process_start_time() -> float:
    """This process's start on the wall clock, to a clock tick: its age
    is the boot clock now less its start on that clock (/proc)."""
    with open(f"/proc/{os.getpid()}/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    age = (time.clock_gettime(time.CLOCK_BOOTTIME)
           - ticks / os.sysconf("SC_CLK_TCK"))
    return time.time() - age


def _parse_grant(spec: str) -> list:
    return [c if c.startswith("cpu") else int(c)
            for c in (c.strip() for c in spec.split(",")) if c]


def main() -> int:
    stamps = {"t_main": time.time()}
    service_id = _require("RAFIKI_SERVICE_ID")
    service_type = _require("RAFIKI_SERVICE_TYPE")
    logging.basicConfig(
        level=logging.INFO,
        format=f"%(levelname)s:%(asctime)s:{service_id[:8]}:%(name)s: "
               "%(message)s")
    stamps["t_start"] = _process_start_time()

    import torch

    stamps["t_torch"] = time.time()
    chips = _parse_grant(os.environ.get("RAFIKI_CHIP_GRANT", ""))
    cuda = bool(chips) and not any(str(c).startswith("cpu") for c in chips)
    if cuda:
        # granted a card: it must be there (no quiet run on the CPU)
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"granted CUDA devices {chips} (CUDA_VISIBLE_DEVICES="
                f"{os.environ.get('CUDA_VISIBLE_DEVICES')!r}) but CUDA is "
                "not available")
        torch.empty(1, device=f"cuda:{chips[0]}")
        torch.cuda.synchronize()
    stamps["t_cuda"] = time.time()
    if cuda:
        from rafiki_tpu_torch.ops import _build

        for name in _build.SOURCES:
            _build.load(name)
    stamps["t_kernels"] = time.time()

    from rafiki_tpu_torch import config
    from rafiki_tpu_torch.constants import ServiceType
    from rafiki_tpu_torch.db.database import Database
    from rafiki_tpu_torch.device import ServiceContext

    db = Database(_require("RAFIKI_DB_PATH"))
    stop_event = threading.Event()

    def on_signal(signum, frame):
        logger.info("signal %s: stopping", signum)
        stop_event.set()

    signal.signal(signal.SIGTERM, on_signal)
    signal.signal(signal.SIGINT, on_signal)
    snapshot = threading.Event()
    signal.signal(signal.SIGUSR1, lambda *a: snapshot.set())

    survivable = (os.environ.get("RAFIKI_ORPHAN_SURVIVE") == "1"
                  and service_type == ServiceType.TRAIN)
    lost = threading.Event()  # stopped because the parent died
    threading.Thread(target=_watch_parent, args=(
        stop_event, snapshot, db, service_id, survivable, os.getppid(),
        2.0, lost), name="orphan-watchdog", daemon=True).start()

    def on_ready():
        db.mark_service_as_running(service_id)
        stamps["t_ready"] = time.time()
        logger.info("startup (pid %d): %s", os.getpid(), json.dumps({
            **stamps, "cuda_visible_devices": os.environ.get(
                "CUDA_VISIBLE_DEVICES"), "grant": chips}))

    ctx = ServiceContext(service_id=service_id, chips=chips,
                         stop_event=stop_event, on_ready=on_ready,
                         service_type=service_type)
    admin_client = _admin_client()
    if admin_client is not None:
        admin_client.login(config.SUPERADMIN_EMAIL,
                           config.SUPERADMIN_PASSWORD)
    try:
        if service_type == ServiceType.TRAIN:
            _run_train(ctx, db, admin_client)
        elif service_type == ServiceType.INFERENCE:
            _run_inference(ctx, db, admin_client)
        else:
            raise RuntimeError(f"bootstrap: unsupported type {service_type}")
    except Exception:
        logger.error("service crashed:\n%s", traceback.format_exc())
        try:
            db.mark_service_as_errored(service_id)
        except Exception:
            logger.exception("could not mark errored")
        return 1
    finally:
        _log_launches()
    return _final_status(db, service_id, lost.is_set())


def _final_status(db, service_id: str, lost: bool) -> int:
    """A clean end: STOPPED and 0; a child stopped because its parent
    (its admin or host agent) died is a replica lost with its host:
    ERRORED and 1, whichever of it and the host's DOWN verdict writes
    first (the original's child writes STOPPED then)."""
    if lost:
        logger.warning("lost with its parent: marking the service ERRORED")
        db.mark_service_as_errored(service_id)
        return 1
    db.mark_service_as_stopped(service_id)
    return 0


def _watch_parent(stop_event, snapshot, db, service_id: str,
                  survivable: bool, parent0: int,
                  beat_s: float = 2.0, lost=None) -> None:
    """The orphan watchdog, a beat every ``beat_s``: a child whose parent
    died without stopping it (a hard kill) must not linger on a torn-down
    data plane, and reparenting tells. A survivable train child works on
    for the next admin and watches its row instead. Each beat also logs
    the launch counters a SIGUSR1 asked for."""
    orphaned = False
    while not stop_event.wait(beat_s):
        if snapshot.is_set():
            snapshot.clear()
            _log_launches("kernel launches so far")
        if not orphaned and os.getppid() != parent0:
            if not survivable:
                logger.warning("parent %d died; stopping", parent0)
                if lost is not None:
                    lost.set()
                stop_event.set()
                return
            orphaned = True
            logger.warning("parent %d died; surviving for the next admin "
                           "(stopping when the store says so)", parent0)
        if orphaned:
            try:
                svc = db.get_service(service_id)
            except Exception:  # a store hiccup: keep working
                continue
            if svc is None or svc["status"] in ("STOPPED", "ERRORED"):
                logger.warning("service row is terminal while orphaned; "
                               "stopping")
                stop_event.set()
                return


def _admin_client():
    """The client of the admin's door (None without ``RAFIKI_ADMIN_ADDR``):
    that address first, then the rest of ``RAFIKI_ADMIN_ADDRS``, since
    after a failover the leader answers at another address. With several
    addresses a call waits at most two lease TTLs for an answer: by then
    a hung leader's lease has lapsed and a standby has had a TTL to
    promote, so the walk goes on to it."""
    from rafiki_tpu_torch import config
    from rafiki_tpu_torch.client.client import Client

    addr = os.environ.get("RAFIKI_ADMIN_ADDR")
    if not addr:
        return None
    addrs = [addr] + [a.strip() for a in config.ADMIN_ADDRS.split(",")
                      if a.strip() and a.strip() != addr]
    return Client(admin_addrs=addrs, timeout_s=(
        2 * float(config.ADMIN_LEASE_TTL_S) if len(addrs) > 1 else None))


def _log_launches(label: str = "kernel launches") -> None:
    from rafiki_tpu_torch.parallel.ranks import launch_counts

    logger.info("%s (pid %d): %s", label, os.getpid(),
                json.dumps(launch_counts()))


def _run_train(ctx, db, admin_client) -> None:
    from rafiki_tpu_torch.advisor.remote import RemoteAdvisorStore
    from rafiki_tpu_torch.worker.train import TrainWorker

    if admin_client is None:
        raise RuntimeError("bootstrap: a train worker needs "
                           "RAFIKI_ADMIN_ADDR (the advisor is the admin's)")

    def send_event(name, payload):
        # advisory: the job's refresh also rides the service rows, so an
        # admin that cannot be reached now must not error a finished worker
        try:
            admin_client.send_event(name, **payload)
        except Exception as e:
            logger.warning("event %s could not reach the admin (%s); "
                           "continuing", name, e)

    TrainWorker(_require("RAFIKI_SUB_TRAIN_JOB_ID"), db,
                RemoteAdvisorStore(admin_client),
                send_event=send_event).start(ctx)


def _run_inference(ctx, db, admin_client) -> None:
    from rafiki_tpu_torch.cache.shm_broker import ShmBrokerClient
    from rafiki_tpu_torch.worker.inference import (
        EVENT_INFERENCE_WORKER_STATS,
        InferenceWorker,
    )

    report = None
    if admin_client is not None:
        # the admin cannot see this process's serving counters: relay them
        # for /inference_jobs/<app>/<v>/stats
        report = lambda payload: admin_client.send_event(  # noqa: E731
            EVENT_INFERENCE_WORKER_STATS, **payload)
    trial_ids = os.environ.get("RAFIKI_TRIAL_IDS")
    InferenceWorker(_require("RAFIKI_INFERENCE_JOB_ID"),
                    _require("RAFIKI_TRIAL_ID"), db,
                    ShmBrokerClient(_require("RAFIKI_BROKER_PREFIX")),
                    report_stats=report,
                    # a fused ensemble's group (budget ENSEMBLE_FUSED)
                    trial_ids=trial_ids.split(",") if trial_ids else None
                    ).start(ctx)


if __name__ == "__main__":
    sys.exit(main())
