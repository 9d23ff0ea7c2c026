"""Host placement: the admin-side manager of the per-host agents, and the
chip arbiter between serving and training.

Own copy of ``rafiki_tpu/placement/hosts.py``. Every host runs a placement
agent (``placement/agent.py``) that owns its cards;
:class:`HostAgentPlacementManager` puts each executor on the least-loaded
agent that can meet its grant, behind the same ``PlacementManager`` seam:

- TRAIN services go to agents (their coordination runs over the shared
  store and the admin's door, so host boundaries do not matter);
- INFERENCE services go to agents too: each agent owns its host's shm
  data plane, and the admin's predictor reaches a remote worker through
  the agent's ``/predict_relay`` (``FleetBroker.register_remote_worker``,
  ``cache/fleet.py``; wired with :meth:`HostAgentPlacementManager.
  set_broker`). Where no agent can take a serving executor (no card free
  fleet-wide, or no fleet broker), it falls back to the ``local`` engine
  as the original does; an admin without a CUDA device has none, and the
  placement then raises;
- PREDICT stays in the admin process.

The fleet's health: a heartbeat probes each agent's ``/healthz``;
``AGENT_DOWN_THRESHOLD`` misses in a row mark it DOWN, which evicts its
relay queues, places its train executors again on a survivor under the
same ids, and errors the rest. An agent back UP is fenced: the services
taken from it while it was away are stopped there. Crash recovery
(``admin/recovery.py``) reads the agents through
:meth:`~HostAgentPlacementManager.probe_inventories`, ``adopt_service``,
``reschedule_service``, ``quarantine_on_rejoin`` and ``fence_service``.
Every agent call carries the leader's epoch once the admin has a lease
(``set_epoch_provider``), and an agent's 412 comes back as
:class:`StaleAdminEpochError`.

One card, several agents: a chip count is an agent's own. Agents that
list the same card (``RAFIKI_AGENT_CHIPS=0`` on a one-card host) each
count it, and their executors share it; on several cards the agents take
disjoint sets. A train executor moved off a dead agent asks for its own
card, as the original does: a survivor whose only card is held refuses
it, and the service is errored rather than put on a shared grant.
"""

from __future__ import annotations

import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Tuple

from rafiki_tpu_torch import config
from rafiki_tpu_torch.constants import AgentHealth, ServiceStatus, ServiceType
from rafiki_tpu_torch.device import ServiceContext
from rafiki_tpu_torch.placement.manager import (
    InsufficientChipsError,
    PlacementManager,
    StatusFn,
)
from rafiki_tpu_torch.utils.agent_http import (
    STALE_EPOCH_STATUS,
    AgentCircuitOpenError,
    AgentHTTPError,
    AgentTransportError,
    breaker_states,
    call_agent,
    reset_breaker,
)
from rafiki_tpu_torch.utils.metrics import REGISTRY

logger = logging.getLogger(__name__)


class AgentUnreachableError(Exception):
    pass


class AgentCircuitOpenUnreachable(AgentUnreachableError):
    """Refused by an open circuit: the request never reached the wire, so
    nothing can have been placed. Placement treats it as unplaced."""


class StaleAdminEpochError(Exception):
    """The agent refused this control call: a newer admin epoch holds the
    leadership lease (412). Final, and not an unreachability: this admin
    must stop mutating, not try the next agent."""


class _AgentHandle:
    """The client of one host agent (wire: ``utils/agent_http.py``)."""

    def __init__(self, addr: str, key: Optional[str] = None,
                 timeout_s: float = 10.0):
        self.addr = addr  # "host:port"
        self.key = key
        self.timeout_s = timeout_s
        # the leader's epoch, stamped on every call (set_epoch_provider)
        self.epoch_provider: Optional[Callable[[], Optional[int]]] = None

    def epoch(self) -> Optional[int]:
        return self.epoch_provider() if self.epoch_provider else None

    def _call(self, method: str, path: str,
              body: Optional[Dict[str, Any]] = None,
              idempotent: Optional[bool] = None) -> Dict[str, Any]:
        try:
            return call_agent(self.addr, method, path, body=body,
                              key=self.key, timeout_s=self.timeout_s,
                              idempotent=idempotent, epoch=self.epoch())
        except AgentHTTPError as e:
            if e.code == STALE_EPOCH_STATUS:
                raise StaleAdminEpochError(f"{self.addr}: {e.message}")
            if e.code == 503:
                raise InsufficientChipsError(e.message)
            raise AgentUnreachableError(f"{self.addr}: {e.message}")
        except AgentCircuitOpenError as e:
            raise AgentCircuitOpenUnreachable(str(e))
        except AgentTransportError as e:
            raise AgentUnreachableError(str(e))

    def inventory(self) -> Dict[str, Any]:
        return self._call("GET", "/inventory")

    def create_service(self, service_id: str, service_type: str,
                       n_chips: int, best_effort_chips: bool,
                       extra: Dict[str, Any]) -> List[Any]:
        out = self._call("POST", "/services", {
            "service_id": service_id, "service_type": service_type,
            "n_chips": n_chips, "best_effort_chips": best_effort_chips,
            "extra": extra})
        return list(out.get("chips", []))

    def stop_service(self, service_id: str, wait: bool) -> None:
        # stopping a stopped service is a no-op on the agent: retry-safe
        self._call("POST", f"/services/{service_id}/stop", {"wait": wait},
                   idempotent=True)


class _FleetInventory:
    """The allocator's shape that ``admin/services.py`` and the chip
    arbiter read: ``total_chips`` and ``free_chips`` over the reachable
    agents, and ``max_chips_per_service``, the largest one host has (a
    grant never spans hosts)."""

    def __init__(self, manager: "HostAgentPlacementManager"):
        self._manager = manager

    @property
    def total_chips(self) -> int:
        return sum(inv.get("total_chips", 0)
                   for _, inv in self._manager._inventories())

    @property
    def free_chips(self) -> int:
        return sum(inv.get("free_chips", 0)
                   for _, inv in self._manager._inventories())

    @property
    def max_chips_per_service(self) -> int:
        return max((inv.get("total_chips", 0)
                    for _, inv in self._manager._inventories()), default=0)


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


class HostAgentPlacementManager(PlacementManager):
    """Places train and serving executors on the per-host agents."""

    def __init__(self, agents: List[str],
                 local: Optional[PlacementManager] = None,
                 key: Optional[str] = None,
                 on_status: Optional[StatusFn] = None, db=None,
                 inventory_ttl_s: float = 1.0,
                 monitor_interval_s: float = 0.5,
                 heartbeat_interval_s: Optional[float] = None,
                 down_threshold: Optional[int] = None):
        if not agents:
            raise ValueError("at least one agent address required")
        super().__init__(_FleetInventory(self), on_status, 0)
        self.agents: Dict[str, _AgentHandle] = {
            a: _AgentHandle(a, key=key) for a in agents}
        self.local = local
        # the shared store: a monitor polls the rows of placed services and
        # reports their terminal statuses, so the job's refresh never
        # depends on an agent forwarding the event
        self.db = db
        self.broker = None  # a FleetBroker: set_broker
        self._inventory_ttl_s = inventory_ttl_s
        self._monitor_interval_s = monitor_interval_s
        self._lock = threading.Lock()
        self._inventory_cache: List[Tuple[str, Dict[str, Any]]] = []  # guarded-by: _lock
        self._inventory_at = 0.0  # guarded-by: _lock
        self._placed: Dict[str, str] = {}  # service id -> agent; guarded-by: _lock
        # service id -> inference job id, for the relay queue's teardown
        self._placed_jobs: Dict[str, str] = {}  # guarded-by: _lock
        # service id -> its create arguments, to place it again elsewhere
        self._placed_specs: Dict[str, Dict[str, Any]] = {}  # guarded-by: _lock
        # agent -> service ids taken from it while it was DOWN (or
        # unreachable at a boot's probe): stopped there if it comes back,
        # so one service id never has two live executors
        self._stripped: Dict[str, List[str]] = {}  # guarded-by: _lock
        self._reported: set = set()  # guarded-by: _lock
        self._monitor: Optional[threading.Thread] = None
        self._closed = threading.Event()
        self._heartbeat_interval_s = (
            heartbeat_interval_s if heartbeat_interval_s is not None
            else config.AGENT_HEARTBEAT_INTERVAL_S)
        self._down_threshold = max(
            down_threshold if down_threshold is not None
            else config.AGENT_DOWN_THRESHOLD, 1)
        self._health: Dict[str, Dict[str, Any]] = {  # guarded-by: _lock
            a: {"state": AgentHealth.UNKNOWN, "misses": 0,
                "last_ok": None, "last_error": None}
            for a in agents}
        self.epoch_provider: Optional[Callable[[], Optional[int]]] = None
        self._heartbeat: Optional[threading.Thread] = None
        if self._heartbeat_interval_s > 0:
            self._heartbeat = threading.Thread(
                target=self._heartbeat_loop, name="hosts-heartbeat",
                daemon=True)
            self._heartbeat.start()

    @property
    def admin_addr(self):
        """The admin door's (host, port), handed to the local engine's
        train children (``AdminServer.start`` sets it)."""
        return getattr(self.local, "admin_addr", None)

    @admin_addr.setter
    def admin_addr(self, addr) -> None:
        if self.local is not None and hasattr(self.local, "admin_addr"):
            self.local.admin_addr = addr

    def set_epoch_provider(
            self, fn: Optional[Callable[[], Optional[int]]]) -> None:
        """Stamp the leader's epoch on every agent call (the client's half
        of the epoch fence)."""
        self.epoch_provider = fn
        for handle in self.agents.values():
            handle.epoch_provider = fn

    def set_broker(self, broker) -> None:
        """The admin's ``FleetBroker``: a serving executor placed on an
        agent gets a relay queue there. Without it serving falls back to
        the local engine."""
        self.broker = broker

    # -- inventories ---------------------------------------------------------

    def _inventories(self) -> List[Tuple[str, Dict[str, Any]]]:
        with self._lock:
            if time.monotonic() - self._inventory_at < self._inventory_ttl_s:
                return list(self._inventory_cache)
            down = {a for a, h in self._health.items()
                    if h["state"] == AgentHealth.DOWN}
        out: List[Tuple[str, Dict[str, Any]]] = []
        for addr, handle in self.agents.items():
            if addr in down:
                continue  # the heartbeat says dead: spend no timeout on it
            try:
                out.append((addr, handle.inventory()))
            except AgentUnreachableError:
                logger.warning("agent %s unreachable; skipping", addr)
        with self._lock:
            self._inventory_cache = out
            self._inventory_at = time.monotonic()
        return list(out)

    def _choose_agent(self, n_chips: int,
                      exclude: frozenset = frozenset()) -> Optional[str]:
        """The least-loaded agent with ``n_chips`` free: fewest services,
        then most free cards. ``exclude`` skips agents that refused."""
        candidates = [
            (inv.get("n_services", 0), -inv.get("free_chips", 0), addr)
            for addr, inv in self._inventories()
            if inv.get("free_chips", 0) >= n_chips and addr not in exclude]
        if not candidates:
            return None
        candidates.sort()
        return candidates[0][2]

    # -- PlacementManager ----------------------------------------------------

    def create_service(self, service_id: str, service_type: str,
                       run_fn=None, n_chips: int = 0,
                       extra: Optional[Dict[str, Any]] = None,
                       best_effort_chips: bool = False) -> ServiceContext:
        can_relay = (self.broker is not None
                     and hasattr(self.broker, "register_remote_worker"))
        if service_type == ServiceType.INFERENCE and can_relay:
            # every agent, least loaded first, before the local engine.
            # Only a provably unplaced failure goes on: a refusal before
            # the create, or an ambiguous create whose undo was confirmed.
            # An ambiguous create whose undo failed raises: a remote copy
            # may be serving
            tried: set = set()
            while True:
                before = len(tried)
                try:
                    ctx = self._create_on_agent(
                        service_id, service_type, n_chips,
                        best_effort_chips, extra, tried=tried)
                except InsufficientChipsError as e:
                    if len(tried) == before:
                        logger.info("fleet cannot serve %s (%s)",
                                    service_id[:8], e)
                        break
                    logger.info("agent refused %s (%s); trying the next",
                                service_id[:8], e)
                    continue
                if ctx is not None:
                    return ctx
                if len(tried) > before:
                    continue  # undone on that agent: try the rest
                break
            logger.info("no agent can serve %s; trying the local engine",
                        service_id[:8])
        if service_type != ServiceType.TRAIN:
            if self.local is None:
                raise RuntimeError(
                    "HostAgentPlacementManager has no engine for "
                    f"{service_type} executors: no agent can take it and "
                    "no `local` engine is configured")
            return self.local.create_service(
                service_id, service_type, run_fn, n_chips=n_chips,
                extra=extra, best_effort_chips=best_effort_chips)
        ctx = self._create_on_agent(service_id, service_type, n_chips,
                                    best_effort_chips, extra)
        if ctx is None:
            raise AgentUnreachableError("no reachable agents")
        return ctx

    def _create_on_agent(self, service_id: str, service_type: str,
                         n_chips: int, best_effort_chips: bool,
                         extra: Optional[Dict[str, Any]],
                         tried: Optional[set] = None
                         ) -> Optional[ServiceContext]:
        """Place on the least-loaded agent. None when no agent was asked,
        or an ambiguous create was undone (the caller decides); ``tried``
        gets the chosen agent before the attempt, so a caller's loop
        always moves on."""
        requested_chips = n_chips  # the ask, replayed on a failover
        exclude = frozenset(tried or ())
        addr = self._choose_agent(n_chips, exclude=exclude)
        if addr is None:
            if not best_effort_chips and n_chips > 0:
                raise InsufficientChipsError(
                    f"No agent has {n_chips} free chips "
                    f"(fleet: {[i for _, i in self._inventories()]})")
            addr = self._choose_agent(0, exclude=exclude)
            if addr is None:
                return None
            n_chips = 0
        if tried is not None:
            tried.add(addr)
        try:
            chips = self.agents[addr].create_service(
                service_id, service_type, n_chips, best_effort_chips,
                dict(extra or {}))
        except AgentCircuitOpenUnreachable as e:
            # refused before anything was sent: unplaced, no undo
            logger.warning("agent %s circuit open; skipped (%s)", addr, e)
            return None
        except AgentUnreachableError:
            # ambiguous: the agent may have started it before the wire
            # failed. Only a confirmed undo makes another attempt safe
            try:
                self.agents[addr].stop_service(service_id, wait=False)
            except (AgentUnreachableError, InsufficientChipsError):
                raise AgentUnreachableError(
                    f"create on {addr} failed ambiguously and the undo "
                    f"stop also failed — service {service_id} may be "
                    "running there; not falling back")
            logger.warning("create on %s failed; undo confirmed, agent "
                           "skipped", addr)
            return None
        job_id = (extra or {}).get("inference_job_id")
        if service_type == ServiceType.INFERENCE and job_id:
            # the admin's half of the data plane: a relay to this agent
            self.broker.register_remote_worker(
                job_id, service_id, addr, key=self.agents[addr].key)
        self._record(service_id, addr, service_type, requested_chips,
                     best_effort_chips, extra)
        logger.info("placed %s on agent %s (chips=%s)", service_id[:8],
                    addr, chips)
        return ServiceContext(service_id=service_id, chips=chips,
                              service_type=service_type,
                              extra=dict(extra or {}))

    def _record(self, service_id: str, addr: str, service_type: str,
                n_chips: int, best_effort_chips: bool,
                extra: Optional[Dict[str, Any]]) -> None:
        job_id = (extra or {}).get("inference_job_id")
        with self._lock:
            self._placed[service_id] = addr
            if service_type == ServiceType.INFERENCE and job_id:
                self._placed_jobs[service_id] = job_id
            self._placed_specs[service_id] = {
                "service_type": service_type, "n_chips": n_chips,
                "best_effort_chips": best_effort_chips,
                "extra": dict(extra or {})}
            self._inventory_at = 0.0  # free counts changed
            if (self.db is not None and self._monitor is None
                    and not self._closed.is_set()):
                self._monitor = threading.Thread(
                    target=self._monitor_loop, name="hosts-status-monitor",
                    daemon=True)
                self._monitor.start()

    # -- crash recovery (admin/recovery.py) ----------------------------------

    def probe_inventories(self, timeout_s: Optional[float] = None
                          ) -> Dict[str, Optional[Dict[str, Any]]]:
        """One bounded ``/inventory`` probe an agent, all at once (a boot
        pays about one timeout for a partly dead fleet); an agent that
        does not answer maps to None."""
        if timeout_s is None:
            timeout_s = float(config.RECOVER_PROBE_TIMEOUT_S)

        def probe(item):
            addr, handle = item
            try:
                return addr, call_agent(addr, "GET", "/inventory",
                                        key=handle.key, timeout_s=timeout_s,
                                        epoch=handle.epoch())
            except Exception as e:
                logger.warning("recovery probe of agent %s failed: %s",
                               addr, e)
                return addr, None

        items = list(self.agents.items())
        with ThreadPoolExecutor(max_workers=max(1, min(len(items), 16)),
                                thread_name_prefix="recover-probe") as pool:
            return dict(pool.map(probe, items))

    def adopt_service(self, service_id: str, addr: str, service_type: str,
                      n_chips: int = 0,
                      extra: Optional[Dict[str, Any]] = None,
                      best_effort_chips: bool = False) -> bool:
        """Record a service already running on ``addr`` as if placed here
        (an admin's restart): the heartbeat's failover, the rejoin fence
        and the status monitor then cover it, and a serving worker gets
        its relay queue back, so predict answers without a redeploy."""
        if addr not in self.agents:
            return False
        extra = dict(extra or {})
        job_id = extra.get("inference_job_id")
        if (service_type == ServiceType.INFERENCE and job_id
                and self.broker is not None
                and hasattr(self.broker, "register_remote_worker")):
            self.broker.register_remote_worker(
                job_id, service_id, addr, key=self.agents[addr].key)
        self._record(service_id, addr, service_type, n_chips,
                     best_effort_chips, extra)
        logger.info("adopted service %s on agent %s (control-plane "
                    "restart)", service_id[:8], addr)
        return True

    def reschedule_service(self, service_id: str, service_type: str,
                           n_chips: int = 0,
                           extra: Optional[Dict[str, Any]] = None,
                           best_effort_chips: bool = False,
                           exclude=()) -> bool:
        """Place again, under the same id, a service whose host died while
        no admin ran (its new worker resumes the stale trials), never on
        an ``exclude``d agent: one that did not answer the boot's probe
        may still run the old executor."""
        return self._reschedule(
            service_id,
            {"service_type": service_type, "n_chips": n_chips,
             "best_effort_chips": best_effort_chips,
             "extra": dict(extra or {})},
            dead="<admin-restart>", exclude=exclude)

    def quarantine_on_rejoin(self, addrs, service_id: str) -> None:
        """``service_id`` was (or is about to be) placed again while these
        agents did not answer: if one is alive after all and runs the old
        executor, stop it there. An agent already UP is fenced now (its
        rejoin fence may have run before this record)."""
        fence_now = []
        with self._lock:
            for addr in addrs:
                if addr not in self.agents:
                    continue
                h = self._health.get(addr)
                if h is not None and h["state"] == AgentHealth.UP:
                    fence_now.append(addr)
                else:
                    self._stripped.setdefault(addr, []).append(service_id)
        for addr in fence_now:
            self.fence_service(service_id, addr)

    def fence_service(self, service_id: str, addr: str,
                      wait: bool = False) -> bool:
        """Stop an orphan on ``addr``: one service id, one live executor.
        ``wait`` blocks until it exited (its id is about to be placed
        again)."""
        if addr not in self.agents:
            return False
        try:
            self.agents[addr].stop_service(service_id, wait=wait)
        except (AgentUnreachableError, InsufficientChipsError) as e:
            logger.warning("could not fence orphan %s on %s (%s)",
                           service_id[:8], addr, e)
            return False
        logger.warning("fenced orphan service %s on agent %s (control-plane "
                       "restart)", service_id[:8], addr)
        return True

    def destroy_service(self, service_id: str, wait: bool = True) -> None:
        with self._lock:
            addr = self._placed.pop(service_id, None)
            job_id = self._placed_jobs.pop(service_id, None)
            self._placed_specs.pop(service_id, None)
        if addr is None:
            if self.local is not None:
                self.local.destroy_service(service_id, wait=wait)
            return
        if job_id is not None and self.broker is not None:
            # the relay goes first: no new predict races the teardown
            try:
                self.broker.unregister_worker(job_id, service_id)
            except Exception:
                logger.exception("relay unregister failed for %s",
                                 service_id)
        try:
            self.agents[addr].stop_service(service_id, wait)
        except AgentUnreachableError:
            logger.warning("agent %s unreachable destroying %s", addr,
                           service_id)
        with self._lock:
            self._inventory_at = 0.0

    def _monitor_loop(self) -> None:
        """Report each placed service's terminal row once through
        ``on_status``: the job's refresh does not wait for an agent's
        forwarded event."""
        while not self._closed.wait(self._monitor_interval_s):
            with self._lock:
                pending = [sid for sid in self._placed
                           if sid not in self._reported]
            for sid in pending:
                try:
                    svc = self.db.get_service(sid)
                except Exception:
                    logger.exception("status poll failed for %s", sid)
                    continue
                if svc is None or svc["status"] not in (
                        ServiceStatus.STOPPED, ServiceStatus.ERRORED):
                    continue
                with self._lock:
                    self._reported.add(sid)
                if self.on_status:
                    try:
                        self.on_status(sid, svc["status"])
                    except Exception:
                        logger.exception("status callback failed")

    # -- fleet health ----------------------------------------------------------

    def _heartbeat_loop(self) -> None:
        """Probe each agent's ``/healthz`` every interval, past the
        breaker (the probes decide recovery)."""
        while not self._closed.wait(self._heartbeat_interval_s):
            for addr, handle in list(self.agents.items()):
                if self._closed.is_set():
                    return
                try:
                    call_agent(
                        addr, "GET", "/healthz", key=handle.key,
                        timeout_s=min(config.AGENT_HEARTBEAT_TIMEOUT_S,
                                      max(self._heartbeat_interval_s, 0.1)),
                        idempotent=False, use_breaker=False,
                        epoch=handle.epoch())
                    alive, err = True, None
                except AgentHTTPError as e:
                    # the host answered: a configuration problem
                    alive, err = True, f"healthz {e.code}: {e.message}"
                # lint: absorb(a transport failure IS the down signal)
                except Exception as e:
                    alive, err = False, str(e)
                try:
                    self._note_heartbeat(addr, alive, err)
                except Exception:
                    logger.exception("heartbeat bookkeeping failed for %s",
                                     addr)

    def _note_heartbeat(self, addr: str, alive: bool,
                        err: Optional[str]) -> None:
        went_down = came_up = was_down = False
        with self._lock:
            h = self._health.get(addr)
            if h is None:
                return
            if alive:
                h["misses"] = 0
                h["last_ok"] = time.monotonic()
                h["last_error"] = err
                if h["state"] != AgentHealth.UP:
                    # any move into UP runs the rejoin fence (UNKNOWN->UP
                    # too: a host unreachable at a boot's probe)
                    was_down = h["state"] == AgentHealth.DOWN
                    came_up = True
                    h["state"] = AgentHealth.UP
                    self._inventory_at = 0.0
            else:
                h["misses"] += 1
                h["last_error"] = err
                if (h["state"] != AgentHealth.DOWN
                        and h["misses"] >= self._down_threshold):
                    h["state"] = AgentHealth.DOWN
                    went_down = True
        # reconciliation runs off the heartbeat thread: a slow failover
        # must not stall the detection for the other agents
        if came_up:
            reset_breaker(addr)
            if was_down:
                logger.warning("agent %s recovered; rejoining the fleet",
                               addr)
            threading.Thread(target=self._fence_rejoined, args=(addr,),
                             name=f"fence-{addr}", daemon=True).start()
        if went_down:
            logger.error("agent %s DOWN after %d missed heartbeats (%s)",
                         addr, self._down_threshold, err)
            threading.Thread(target=self._run_failover, args=(addr,),
                             name=f"failover-{addr}", daemon=True).start()

    def _run_failover(self, addr: str) -> None:
        try:
            self._handle_agent_down(addr)
        except Exception:
            logger.exception("failover for dead agent %s failed", addr)

    def _fence_rejoined(self, addr: str) -> None:
        """Stop, on an agent back from DOWN, the services moved or errored
        while it was away (a partition is not a crash)."""
        with self._lock:
            orphans = self._stripped.pop(addr, [])
        for sid in orphans:
            try:
                self.agents[addr].stop_service(sid, wait=False)
                logger.warning("fenced orphan service %s on rejoined agent "
                               "%s", sid[:8], addr)
            except (AgentUnreachableError, InsufficientChipsError) as e:
                logger.warning("could not fence orphan %s on %s (%s)",
                               sid[:8], addr, e)

    def _handle_agent_down(self, addr: str) -> None:
        """A dead host: (1) evict its relay queues, (2) place its train
        executors again on survivors under the same ids (the new workers
        resume the stale trials), (3) error what could not move, so the
        job's refresh runs without an operator."""
        if self.broker is not None and hasattr(self.broker, "evict_agent"):
            try:
                evicted = self.broker.evict_agent(addr)
                if evicted:
                    logger.warning("evicted %d relay queue(s) of dead agent "
                                   "%s: %s", len(evicted), addr, evicted)
            except Exception:
                logger.exception("relay eviction failed for %s", addr)
        with self._lock:
            doomed = [sid for sid, a in self._placed.items() if a == addr]
            specs = {}
            for sid in doomed:
                self._placed.pop(sid, None)
                self._placed_jobs.pop(sid, None)
                specs[sid] = self._placed_specs.pop(sid, None)
            self._stripped.setdefault(addr, []).extend(doomed)
            self._inventory_at = 0.0
        for sid in doomed:
            if self.db is not None:
                try:
                    row = self.db.get_service(sid)
                # lint: absorb(a store hiccup reads as non-terminal)
                except Exception:
                    row = None
                if row is not None and row["status"] in (
                        ServiceStatus.STOPPED, ServiceStatus.ERRORED):
                    continue  # ended before its host: nothing to move
            spec = specs.get(sid)
            if (spec is not None
                    and spec["service_type"] == ServiceType.TRAIN
                    and self._reschedule(sid, spec, dead=addr)):
                continue
            self._mark_errored(sid)

    def _reschedule(self, service_id: str, spec: Dict[str, Any], dead: str,
                    exclude=()) -> bool:
        """Place a train executor again through the least-loaded path,
        never on a DOWN agent, ``dead`` or an ``exclude``d one."""
        with self._lock:
            tried = {a for a, h in self._health.items()
                     if h["state"] == AgentHealth.DOWN}
        tried.add(dead)
        tried.update(exclude)
        while True:
            before = len(tried)
            try:
                ctx = self._create_on_agent(
                    service_id, spec["service_type"], spec["n_chips"],
                    spec["best_effort_chips"], spec["extra"], tried=tried)
            except InsufficientChipsError as e:
                if len(tried) == before:
                    logger.warning("cannot reschedule %s: %s",
                                   service_id[:8], e)
                    return False
                continue
            except AgentUnreachableError:
                logger.exception("rescheduling %s failed", service_id[:8])
                return False
            if ctx is not None:
                logger.warning("service %s failed over %s -> %s",
                               service_id[:8], dead,
                               self.placements().get(service_id))
                return True
            if len(tried) > before:
                continue
            logger.warning("no surviving agent can take %s", service_id[:8])
            return False

    def _mark_errored(self, service_id: str) -> None:
        """The terminal row of a service that died with its host (the
        agent that would have written it died too)."""
        if self.db is not None:
            try:
                self.db.mark_service_as_errored(service_id)
            except Exception:
                logger.exception("could not mark %s ERRORED", service_id)
        with self._lock:
            self._reported.add(service_id)
        if self.on_status:
            try:
                self.on_status(service_id, ServiceStatus.ERRORED)
            except Exception:
                logger.exception("status callback failed for %s",
                                 service_id)

    def agent_health(self) -> Dict[str, Dict[str, Any]]:
        """Each agent's heartbeat state, breaker and services placed."""
        breakers = breaker_states()
        now = time.monotonic()
        with self._lock:
            placed_by_addr: Dict[str, int] = {}
            for a in self._placed.values():
                placed_by_addr[a] = placed_by_addr.get(a, 0) + 1
            return {
                addr: {
                    "state": h["state"],
                    "consecutive_misses": h["misses"],
                    "seconds_since_ok": (
                        round(now - h["last_ok"], 3)
                        if h["last_ok"] is not None else None),
                    "last_error": h["last_error"],
                    "breaker": breakers.get(addr, "CLOSED"),
                    "services_placed": placed_by_addr.get(addr, 0),
                }
                for addr, h in self._health.items()}

    def stop_all(self) -> None:
        self._closed.set()
        with self._lock:
            placed = dict(self._placed)
            self._placed.clear()
            self._placed_jobs.clear()
            self._placed_specs.clear()
        for sid, addr in placed.items():
            try:
                self.agents[addr].stop_service(sid, wait=False)
            except (AgentUnreachableError, StaleAdminEpochError) as e:
                logger.warning("could not stop %s on %s (%s)", sid[:8],
                               addr, e)
        if self.local is not None:
            self.local.stop_all()

    def detach_all(self) -> None:
        """A fenced ex-leader lets go of the fleet: its loops stop, and
        nothing is stopped on the agents (the new leader adopted it)."""
        self._closed.set()
        with self._lock:
            self._placed.clear()
            self._placed_jobs.clear()
            self._placed_specs.clear()
        if self.local is not None and hasattr(self.local, "detach_all"):
            self.local.detach_all()

    def placements(self) -> Dict[str, str]:
        with self._lock:
            return dict(self._placed)
