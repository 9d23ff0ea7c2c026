"""Process placement: services run as child processes of the admin.

Own copy of ``rafiki_tpu/placement/process.py``. Each service is a child
process started on ``python -m rafiki_tpu_torch.worker.bootstrap`` (with
``subprocess.Popen``: fork then exec, never a ``multiprocessing`` fork of
a parent that may have touched CUDA), with in its environment:

- its device grant: ``CUDA_VISIBLE_DEVICES`` set to the physical ids of
  the cards granted (the parent's grant indices are positions in the
  parent's own visible list, so they are mapped through the parent's
  ``CUDA_VISIBLE_DEVICES``), and ``RAFIKI_CHIP_GRANT`` the child's indices
  of them, ``0..n-1``; a grant of CPU entries (tests: ``["cpu"]``, or
  ``["cpu:0", "cpu:1"]`` for gloo ranks) reaches the child as those
  entries with no card visible; a child granted several devices starts
  its followers, one process a device (``parallel/ranks.py``), which see
  the same cards;
- its payload ids (``sub_train_job_id``; ``inference_job_id`` and
  ``trial_id``, and a fused ensemble's ``trial_ids`` as
  ``RAFIKI_TRIAL_IDS``), from the service's ``extra``;
- the metadata store, which every process opens (the same SQLite/WAL
  file), the serving data plane's shm namespace (``cache/shm_broker.py``;
  the rings are created here, at placement, so the child only attaches),
  and the admin's REST address, through which a train child reaches the
  GP advisor (``advisor/remote.py``).

A child that exits non-zero while not being stopped is started again, up
to ``max_restarts`` times; a stop sends SIGTERM, then SIGKILL after
``stop_grace_s``. The devices a service owns come back only once its
child is gone. The child marks its own service RUNNING (when ready),
STOPPED or ERRORED in the store; the monitor thread here reports the
terminal status through ``on_status`` in every case, so a child that dies
without writing (SIGKILL) still ends its job. Each child's output goes to
``LOGS_DIR/service-<id>.log``, and its pid to its service row.

Crash recovery: an admin's engine is built ``orphan_survivable``, so its
TRAIN children carry ``RAFIKI_ORPHAN_SURVIVE=1`` and outlive their admin
(``worker/bootstrap.py``); a serving child never does (its shm data plane
dies with the admin). A restarted admin's recovery hands such a child's
recorded pid to :meth:`ProcessPlacementManager.adopt_pid`, which checks
that the pid is this package's worker bootstrap of that very service
(``/proc/<pid>/cmdline`` and its ``RAFIKI_SERVICE_ID``: a recycled pid,
another service's child or a JAX worker is never adopted or signalled),
takes its grant back in the allocator and watches it like a spawned
child (:class:`_AdoptedRunner`: a stop is SIGTERM, then SIGKILL).
"""

from __future__ import annotations

import logging
import os
import signal
import subprocess
import sys
import threading
import time
from typing import Any, Dict, List, Optional

from rafiki_tpu_torch import config
from rafiki_tpu_torch.constants import ServiceStatus, ServiceType
from rafiki_tpu_torch.device import ServiceContext
from rafiki_tpu_torch.placement.manager import (
    ChipAllocator,
    PlacementManager,
    StatusFn,
)

logger = logging.getLogger(__name__)

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class _ProcRunner:
    def __init__(self, manager: "ProcessPlacementManager", ctx: ServiceContext,
                 env: Dict[str, str], log_path: str, owned: List[Any]):
        self.manager = manager
        self.ctx = ctx
        self.owned = owned  # the devices that come back when it is gone
        self.env = env
        self.log_path = log_path
        self.proc: Optional[subprocess.Popen] = None
        self._proc_lock = threading.Lock()
        #: let go of the child: its stop signals and reports nothing
        self.detached = False
        self.thread = threading.Thread(
            target=self._run, name=f"proc-svc-{ctx.service_id[:8]}",
            daemon=True)

    def _spawn(self) -> subprocess.Popen:
        os.makedirs(os.path.dirname(self.log_path), exist_ok=True)
        with open(self.log_path, "ab") as logf:  # the child keeps its own fd
            return subprocess.Popen(
                [sys.executable, "-m", "rafiki_tpu_torch.worker.bootstrap"],
                env=self.env, cwd=_REPO_ROOT, stdin=subprocess.DEVNULL,
                stdout=logf, stderr=subprocess.STDOUT,
                start_new_session=True)

    def _run(self) -> None:
        mgr = self.manager
        try:
            restarts = 0
            rc: Optional[int] = None
            while not self.ctx.stop_event.is_set():
                with self._proc_lock:
                    self.proc = self._spawn()
                # the pid on the row, so a restarted admin can adopt (or
                # fence) the child; written again on every restart
                try:
                    mgr.db.update_service_pid(self.ctx.service_id,
                                              self.proc.pid)
                except Exception:
                    logger.exception("pid record failed for %s",
                                     self.ctx.service_id)
                rc = self._wait_current()
                if self.detached:
                    return
                if self.ctx.stop_event.is_set() or rc == 0:
                    break
                logger.error("service %s process exited rc=%s (log: %s)",
                             self.ctx.service_id, rc, self.log_path)
                restarts += 1
                if restarts > mgr.max_restarts:
                    self._report_final(ServiceStatus.ERRORED)
                    return
            self._report_final(ServiceStatus.STOPPED if rc in (0, None)
                               else ServiceStatus.ERRORED)
        except Exception:
            logger.exception("monitor of service %s failed",
                             self.ctx.service_id)
            self._report_final(ServiceStatus.ERRORED)
        finally:
            mgr._on_runner_exit(self)

    def _wait_current(self) -> Optional[int]:
        with self._proc_lock:
            proc = self.proc
        if proc is None:
            return None
        while True:
            try:
                return proc.wait(timeout=0.5)
            except subprocess.TimeoutExpired:
                if self.detached:
                    return None
                if self.ctx.stop_event.is_set():
                    return self._terminate(proc)

    def _terminate(self, proc: subprocess.Popen) -> Optional[int]:
        """SIGTERM (the child marks its own status and exits), then SIGKILL
        after the grace period."""
        try:
            proc.terminate()
        except ProcessLookupError:
            return proc.poll()
        try:
            return proc.wait(timeout=self.manager.stop_grace_s)
        except subprocess.TimeoutExpired:
            logger.warning("service %s ignored SIGTERM; killing",
                           self.ctx.service_id)
            proc.kill()
            return proc.wait(timeout=30)

    def _report_final(self, status_from_rc: str) -> None:
        """Report the terminal status through ``on_status`` always, even
        when the child wrote its own row: the job's refresh hangs off the
        callback. The child's own terminal row wins over the one the exit
        code implies (it knows a stop from a crash)."""
        mgr = self.manager
        final = status_from_rc
        try:
            svc = mgr.db.get_service(self.ctx.service_id)
            if svc is not None and svc["status"] in (ServiceStatus.STOPPED,
                                                     ServiceStatus.ERRORED):
                final = svc["status"]
            if mgr.on_status:
                mgr.on_status(self.ctx.service_id, final)
        except Exception:
            logger.exception("final status report failed for %s",
                             self.ctx.service_id)


#: the module a worker child runs, as it stands in /proc/<pid>/cmdline
_BOOTSTRAP = b"rafiki_tpu_torch.worker.bootstrap"


def _pid_is_worker(pid: Optional[int],
                   service_id: Optional[str] = None) -> bool:
    """Is ``pid`` a live worker bootstrap of this package, and with
    ``service_id``, the one of that very service? Its cmdline must run
    ``rafiki_tpu_torch.worker.bootstrap`` (a JAX worker's does not) and
    its environment must carry the matching ``RAFIKI_SERVICE_ID``, so a
    recycled pid is never adopted or signalled. Without a readable /proc
    nothing can be checked, and nothing is ours."""
    if not pid:
        return False
    try:
        os.kill(pid, 0)
    except OSError:
        return False
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            if _BOOTSTRAP not in f.read().split(b"\0"):
                return False
        if service_id is not None:
            with open(f"/proc/{pid}/environ", "rb") as f:
                env = f.read().split(b"\0")
            return b"RAFIKI_SERVICE_ID=" + service_id.encode() in env
        return True
    except OSError:
        return False


def terminate_worker_pid(pid: int, service_id: str, grace_s: float) -> None:
    """SIGTERM a worker that is not this process's child, wait up to
    ``grace_s`` for it to go, then SIGKILL; the pid's identity is checked
    again before every signal. ``grace_s <= 0`` sends SIGTERM alone (the
    child deserves its own store write)."""
    if not _pid_is_worker(pid, service_id=service_id):
        return
    try:
        os.kill(pid, signal.SIGTERM)
    except OSError:
        return
    if grace_s <= 0:
        return
    deadline = time.monotonic() + grace_s
    while time.monotonic() < deadline:
        if not _pid_is_worker(pid, service_id=service_id):
            return
        time.sleep(0.1)
    if _pid_is_worker(pid, service_id=service_id):
        logger.warning("worker %s (pid %d) ignored SIGTERM; killing",
                       service_id[:8], pid)
        try:
            os.kill(pid, signal.SIGKILL)
        except OSError:
            pass


class _AdoptedRunner:
    """The monitor of a child that outlived its admin: as
    :class:`_ProcRunner` (a stop is SIGTERM then SIGKILL; the terminal
    status goes through ``on_status``, the child's own row winning) with
    no ``Popen`` to wait on, so it polls the pid's identity: the pid
    cannot be reaped here and may be recycled."""

    def __init__(self, manager: "ProcessPlacementManager",
                 ctx: ServiceContext, pid: int, owned: List[Any]):
        self.manager = manager
        self.ctx = ctx
        self.pid = pid
        self.owned = owned
        self.detached = False  # as _ProcRunner's
        self.thread = threading.Thread(
            target=self._run, name=f"adopted-svc-{ctx.service_id[:8]}",
            daemon=True)

    def _alive(self) -> bool:
        return _pid_is_worker(self.pid, service_id=self.ctx.service_id)

    def _run(self) -> None:
        mgr = self.manager
        try:
            while self._alive():
                if self.ctx.stop_event.wait(0.5):
                    if self.detached:
                        return
                    terminate_worker_pid(self.pid, self.ctx.service_id,
                                         mgr.stop_grace_s)
                    break
            self._report_final()
        finally:
            mgr._on_runner_exit(self)

    def _report_final(self) -> None:
        """The exit code is unknowable here: the child's own terminal row
        decides, else STOPPED after a stop and ERRORED after a death that
        wrote nothing (SIGKILL)."""
        mgr = self.manager
        final = (ServiceStatus.STOPPED if self.ctx.stop_event.is_set()
                 else ServiceStatus.ERRORED)
        try:
            svc = mgr.db.get_service(self.ctx.service_id)
            if svc is not None and svc["status"] in (ServiceStatus.STOPPED,
                                                     ServiceStatus.ERRORED):
                final = svc["status"]
            if mgr.on_status:
                mgr.on_status(self.ctx.service_id, final)
        except Exception:
            logger.exception("final status report failed for adopted %s",
                             self.ctx.service_id)


class ProcessPlacementManager(PlacementManager):
    """Places services as child processes on this host.

    Needs a file-backed store (the children open the same SQLite file),
    and for serving an ``ShmBroker`` whose rings the children attach to.
    ``Admin`` fills in ``db`` and ``broker`` when they are not given, and
    ``AdminServer.start`` sets ``admin_addr`` (host, port): a train child
    reaches the advisor through it, so train services are refused until
    it is set.

    ``orphan_survivable`` (an admin's own engine): TRAIN children outlive
    their admin, to be adopted by pid at its restart."""

    def __init__(self, db=None, broker=None,
                 allocator: Optional[ChipAllocator] = None,
                 on_status: Optional[StatusFn] = None,
                 max_restarts: int = 3, stop_grace_s: float = 15.0,
                 orphan_survivable: bool = False):
        super().__init__(allocator, on_status, max_restarts)
        self.db = db
        self.broker = broker
        self.orphan_survivable = orphan_survivable
        #: (host, port) of the admin's door, set by ``AdminServer.start``
        self.admin_addr: Optional[tuple] = None
        self.stop_grace_s = stop_grace_s
        self._lock = threading.Lock()
        self._runners: Dict[str, _ProcRunner] = {}  # guarded-by: _lock
        # runners detached by destroy_service(wait=False) whose children may
        # still be in the SIGTERM-SIGKILL window; stop_all waits them out,
        # or an exiting admin would orphan a child that ignored SIGTERM
        self._dying: List[_ProcRunner] = []  # guarded-by: _lock

    def create_service(self, service_id: str, service_type: str,
                       run_fn=None, n_chips: int = 0,
                       extra: Optional[Dict[str, Any]] = None,
                       best_effort_chips: bool = False) -> ServiceContext:
        """Launch the service's child from its declarative ``extra``
        (``run_fn``, the thread placement's entry point, is not used)."""
        if self.db is None or self.db.path == ":memory:":
            raise RuntimeError(
                "ProcessPlacementManager needs a file-backed Database "
                "(its children open the same SQLite file)")
        owned, chips = self._grant(n_chips, best_effort_chips)
        ctx = ServiceContext(service_id=service_id, chips=chips,
                             service_type=service_type,
                             extra=dict(extra or {}))
        try:
            env = self._child_env(ctx)
            if service_type == ServiceType.INFERENCE:
                # the rings are created here, by their owner, so the child
                # (and the predictor's fan-out) can attach at once
                self.broker.register_worker(ctx.extra["inference_job_id"],
                                            service_id)
        except Exception:
            self.allocator.release(owned)
            raise
        runner = _ProcRunner(self, ctx, env, os.path.join(
            config.LOGS_DIR, f"service-{service_id}.log"), owned)
        with self._lock:
            self._runners[service_id] = runner
        runner.thread.start()
        return ctx

    def adopt_pid(self, service_id: str, service_type: str, pid: int,
                  extra: Optional[Dict[str, Any]] = None,
                  chips: Optional[List[Any]] = None) -> bool:
        """Adopt a child that survived its admin: check that ``pid`` is
        this service's worker, take its grant back in the allocator and
        watch it as a spawned child. False when the pid is gone or not
        ours (the caller reschedules or errors the service)."""
        if not _pid_is_worker(pid, service_id=service_id):
            return False
        chips = list(chips or [])
        owned = self.allocator.claim(chips)
        ctx = ServiceContext(service_id=service_id, chips=chips,
                             service_type=service_type,
                             extra=dict(extra or {}))
        runner = _AdoptedRunner(self, ctx, pid, owned)
        with self._lock:
            self._runners[service_id] = runner
        runner.thread.start()
        logger.info("adopted surviving worker %s (pid %d, grant %s)",
                    service_id[:8], pid, chips)
        return True

    def list_services(self) -> List[Dict[str, Any]]:
        """This host's live executors with their pid and grant, what a
        host agent's ``/inventory`` answers (a finished child wrote its
        terminal row already and is not listed)."""
        with self._lock:
            runners = dict(self._runners)
        out = []
        for sid, r in runners.items():
            if not r.thread.is_alive():
                continue
            proc = getattr(r, "proc", None)
            out.append({
                "service_id": sid, "service_type": r.ctx.service_type,
                "status": "RUNNING", "chips": list(r.ctx.chips),
                "pid": (proc.pid if proc is not None
                        else getattr(r, "pid", None))})
        return out

    def destroy_service(self, service_id: str, wait: bool = True) -> None:
        with self._lock:
            runner = self._runners.pop(service_id, None)
            # only a runner whose monitor still runs: a finished one has
            # already left _dying and would leak there
            if runner is not None and runner.thread.is_alive():
                self._dying.append(runner)
        if runner is None:
            return  # concurrent teardowns are expected
        runner.ctx.stop_event.set()
        if wait:
            runner.thread.join(timeout=self.stop_grace_s + 40)
        if runner.ctx.service_type == ServiceType.INFERENCE:
            try:
                self.broker.unregister_worker(
                    runner.ctx.extra["inference_job_id"], service_id)
            except Exception:
                logger.exception("broker unregister failed for %s",
                                 service_id)

    def detach_all(self) -> None:
        """Let go of every child without signalling it or writing its
        status: a fenced ex-leader's children belong to the new leader. A
        train child that survives orphaning is adopted there by pid; any
        other stops on its own once this process exits."""
        with self._lock:
            runners = list(self._runners.values())
            self._runners.clear()
        for runner in runners:
            runner.detached = True
            runner.ctx.stop_event.set()
        for runner in runners:
            runner.thread.join(timeout=5)
        logger.warning("detached %d children unsignalled (fenced)",
                       len(runners))

    def stop_all(self) -> None:
        with self._lock:
            ids = list(self._runners)
        for sid in ids:
            self.destroy_service(sid)
        # runners detached earlier with wait=False may still be escalating
        # SIGTERM to SIGKILL, and the caller exits right after this
        with self._lock:
            dying = list(self._dying)
        for runner in dying:
            runner.thread.join(timeout=self.stop_grace_s + 40)
        with self._lock:
            self._dying = [r for r in self._dying if r.thread.is_alive()]

    # -- internals ---------------------------------------------------------

    def _on_runner_exit(self, runner: _ProcRunner) -> None:
        self.allocator.release(runner.owned)
        with self._lock:
            self._dying = [r for r in self._dying if r is not runner]

    def _child_env(self, ctx: ServiceContext) -> Dict[str, str]:
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_REPO_ROOT, env.get("PYTHONPATH")) if p)
        env["RAFIKI_SERVICE_ID"] = ctx.service_id
        env["RAFIKI_SERVICE_TYPE"] = ctx.service_type
        env["RAFIKI_DB_PATH"] = os.path.abspath(self.db.path)
        env["RAFIKI_WORKDIR"] = config.WORKDIR
        env.update(_grant_env(ctx.chips, os.environ.get(
            "CUDA_VISIBLE_DEVICES")))
        # the process-wide fallback must not fight the explicit grant
        env.pop("RAFIKI_VISIBLE_DEVICES", None)
        if self.admin_addr is not None:
            env["RAFIKI_ADMIN_ADDR"] = (f"{self.admin_addr[0]}:"
                                        f"{self.admin_addr[1]}")
        if ctx.service_type == ServiceType.TRAIN:
            if self.admin_addr is None:
                raise RuntimeError(
                    "a process-placed train worker reaches the advisor "
                    "through the admin's REST door: start the AdminServer "
                    "before creating train jobs")
            env["RAFIKI_SUB_TRAIN_JOB_ID"] = ctx.extra["sub_train_job_id"]
            if self.orphan_survivable:
                # outlive the admin, to be adopted by pid at its restart
                env["RAFIKI_ORPHAN_SURVIVE"] = "1"
        elif ctx.service_type == ServiceType.INFERENCE:
            prefix = getattr(self.broker, "prefix", None)
            if prefix is None:
                raise RuntimeError(
                    "a process-placed inference worker needs the shm broker "
                    "(RAFIKI_BROKER=shm) to attach to the serving data plane")
            env["RAFIKI_INFERENCE_JOB_ID"] = ctx.extra["inference_job_id"]
            env["RAFIKI_TRIAL_ID"] = ctx.extra["trial_id"]
            if ctx.extra.get("trial_ids"):
                # a fused ensemble's group (budget ENSEMBLE_FUSED)
                env["RAFIKI_TRIAL_IDS"] = ",".join(ctx.extra["trial_ids"])
            env["RAFIKI_BROKER_PREFIX"] = prefix
        else:
            raise ValueError(
                f"unsupported process service type {ctx.service_type!r}")
        return env


def _grant_env(chips: List[Any], parent_visible: Optional[str]
               ) -> Dict[str, str]:
    """The child's device environment for a grant of the parent's CUDA
    indices (or CPU entries): ``CUDA_VISIBLE_DEVICES`` holds the physical
    ids, taken from the parent's ``CUDA_VISIBLE_DEVICES`` when it has one,
    and ``RAFIKI_CHIP_GRANT`` the child's own indices of them."""
    if any(str(c).startswith("cpu") for c in chips):
        return {"CUDA_VISIBLE_DEVICES": "",
                "RAFIKI_CHIP_GRANT": ",".join(str(c) for c in chips)}
    visible = ([v.strip() for v in parent_visible.split(",")]
               if parent_visible and parent_visible.strip() else None)
    physical = []
    for c in chips:
        if visible is None:
            physical.append(str(c))
        elif int(c) < len(visible):
            physical.append(visible[int(c)])
        else:
            raise ValueError(f"grant {chips} is outside the parent's "
                             f"CUDA_VISIBLE_DEVICES={parent_visible!r}")
    return {"CUDA_VISIBLE_DEVICES": ",".join(physical),
            "RAFIKI_CHIP_GRANT": ",".join(str(i) for i in range(len(chips)))}
