"""Device-affine service placement.

Own copy of ``rafiki_tpu/placement/manager.py``: ``ChipAllocator`` owns
the host's device inventory; ``PlacementManager`` is the seam both
placements implement. ``LocalPlacementManager`` runs each service entry
point on a daemon thread of this process with its grant (the runner sets
the thread's grant with :func:`~rafiki_tpu_torch.device.set_device_grant`
through the worker's ``start``), reports RUNNING when the service calls
``ctx.ready()``, restarts a crashing service up to ``max_restarts`` times,
and releases the grant once the thread is off the devices.
``ProcessPlacementManager`` (``placement/process.py``) runs each service as
a child process instead.

Two differences from the JAX package:

- ``ChipAllocator()`` lists the visible CUDA devices and raises when
  there is none. Only an allocator built over ``["cpu"]`` (the tests)
  grants the CPU.
- A service that asks for no device, or a serving worker whose exclusive
  grant cannot be met (``best_effort_chips``), shares the allocator's
  first device instead of getting an empty grant. An empty grant in the
  JAX package means "every visible device", the CPU when there is no TPU;
  here it never means the CPU. So on a one-card host the two best trials
  of an inference job are both served on ``cuda:0``, under either
  placement.
"""

from __future__ import annotations

import abc
import logging
import threading
import traceback
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from rafiki_tpu_torch.device import DeviceSpec, ServiceContext, visible_devices

logger = logging.getLogger(__name__)


class InsufficientChipsError(Exception):
    pass


class ChipAllocator:
    """Per-host device bookkeeping. ``device_indices`` are CUDA indices,
    or CPU entries (``"cpu"``; ``"cpu:0"``, ``"cpu:1"``, ... for several,
    each a rank of its own under gloo); by default the visible CUDA
    devices (``RAFIKI_VISIBLE_DEVICES`` or all), and a RuntimeError
    without CUDA."""

    def __init__(self, device_indices: Optional[List[DeviceSpec]] = None):
        if device_indices is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "no CUDA device to place services on; build the "
                    "allocator over ['cpu'] to run on the CPU")
            device_indices = [d.index for d in visible_devices()]
        self._lock = threading.Lock()
        self._free: List[DeviceSpec] = list(device_indices)
        self._total: List[DeviceSpec] = list(device_indices)

    @property
    def total_chips(self) -> int:
        return len(self._total)

    @property
    def max_chips_per_service(self) -> int:
        """The largest grant one service can hold: a service's devices
        never span hosts, and this allocator is one host's."""
        return len(self._total)

    @property
    def free_chips(self) -> int:
        with self._lock:
            return len(self._free)

    def allocate(self, n: int) -> List[DeviceSpec]:
        with self._lock:
            if n > len(self._free):
                raise InsufficientChipsError(
                    f"Requested {n} chips, only {len(self._free)} free")
            grant, self._free = self._free[:n], self._free[n:]
            return grant

    def shared(self, n: int) -> List[DeviceSpec]:
        """``n`` devices (at least one) to share with their owners: the
        first of the inventory, marked busy for no one."""
        return list(self._total[:max(n, 1)])

    def claim(self, chips: List[DeviceSpec]) -> List[DeviceSpec]:
        """Mark these devices busy (crash recovery: an adopted worker
        already holds its grant, so no later grant may land on it).
        Devices outside the inventory or already busy are ignored; returns
        the ones this call took."""
        with self._lock:
            taken = [c for c in self._free if c in chips]
            self._free = [c for c in self._free if c not in taken]
            return taken

    def release(self, chips: List[DeviceSpec]) -> None:
        with self._lock:
            for c in chips:
                if c in self._total and c not in self._free:
                    self._free.append(c)
            self._free.sort(key=self._total.index)


RunFn = Callable[[ServiceContext], None]
StatusFn = Callable[[str, str], None]  # (service_id, status)


class PlacementManager(abc.ABC):
    """The seam both placements implement: deploy a service on its device
    grant, report its status through ``on_status``, stop it."""

    def __init__(self, allocator: Optional[ChipAllocator],
                 on_status: Optional[StatusFn], max_restarts: int):
        self.allocator = allocator or ChipAllocator()
        self.on_status = on_status
        self.max_restarts = max_restarts

    def _grant(self, n_chips: int, best_effort_chips: bool
               ) -> Tuple[List[DeviceSpec], List[DeviceSpec]]:
        """(the devices the service owns, its grant). With none asked for,
        or with ``best_effort_chips`` when too few are free, the grant is
        the allocator's first devices, shared and owned by no one."""
        owned: List[DeviceSpec] = []
        try:
            owned = self.allocator.allocate(n_chips) if n_chips > 0 else []
        except InsufficientChipsError:
            if not best_effort_chips:
                raise
        return owned, owned or self.allocator.shared(n_chips)

    @abc.abstractmethod
    def create_service(self, service_id: str, service_type: str,
                       run_fn: Optional[RunFn], n_chips: int = 0,
                       extra: Optional[Dict[str, Any]] = None,
                       best_effort_chips: bool = False) -> ServiceContext:
        """Deploy a service on ``n_chips`` devices of its own (see
        :meth:`_grant`). A thread runs ``run_fn``; a process is launched
        from the declarative ``extra`` payload."""

    @abc.abstractmethod
    def destroy_service(self, service_id: str, wait: bool = True) -> None:
        ...

    @abc.abstractmethod
    def stop_all(self) -> None:
        ...


class _ServiceRunner:
    def __init__(self, ctx: ServiceContext, run_fn: RunFn,
                 on_status: Optional[StatusFn], max_restarts: int,
                 on_exit: Optional[Callable[[], None]] = None):
        self.ctx = ctx
        self.run_fn = run_fn
        self.on_status = on_status
        self.max_restarts = max_restarts
        self.on_exit = on_exit
        ctx.on_ready = lambda: self._status("RUNNING")
        self.thread = threading.Thread(target=self._run,
                                       name=f"svc-{ctx.service_id[:8]}",
                                       daemon=True)

    def _status(self, status: str) -> None:
        if self.on_status:
            try:
                self.on_status(self.ctx.service_id, status)
            except Exception:
                logger.exception("status callback failed")

    def _run(self) -> None:
        # RUNNING comes from ctx.ready() inside run_fn, once the service
        # has started: one that crashes on start lands ERRORED without
        # ever having claimed to run
        try:
            restarts = 0
            while not self.ctx.stop_event.is_set():
                try:
                    self.run_fn(self.ctx)
                    break
                except Exception:
                    logger.error("service %s crashed:\n%s",
                                 self.ctx.service_id, traceback.format_exc())
                    restarts += 1
                    if restarts > self.max_restarts:
                        self._status("ERRORED")
                        return
            self._status("STOPPED")
        finally:
            # the grant comes home only once the thread is off the devices
            if self.on_exit:
                self.on_exit()


class LocalPlacementManager(PlacementManager):
    """Runs services as daemon threads of this process."""

    def __init__(self, allocator: Optional[ChipAllocator] = None,
                 on_status: Optional[StatusFn] = None,
                 max_restarts: int = 3):
        super().__init__(allocator, on_status, max_restarts)
        self._lock = threading.Lock()
        self._runners: Dict[str, _ServiceRunner] = {}  # guarded-by: _lock

    def create_service(self, service_id: str, service_type: str,
                       run_fn: Optional[RunFn], n_chips: int = 0,
                       extra: Optional[Dict[str, Any]] = None,
                       best_effort_chips: bool = False) -> ServiceContext:
        owned, chips = self._grant(n_chips, best_effort_chips)
        ctx = ServiceContext(service_id=service_id, chips=chips,
                             service_type=service_type,
                             extra=dict(extra or {}))
        runner = _ServiceRunner(
            ctx, run_fn, self.on_status, self.max_restarts,
            on_exit=lambda: self.allocator.release(owned))
        with self._lock:
            self._runners[service_id] = runner
        runner.thread.start()
        return ctx

    def destroy_service(self, service_id: str, wait: bool = True) -> None:
        with self._lock:
            runner = self._runners.pop(service_id, None)
        if runner is None:
            return  # already gone: concurrent teardowns are expected
        runner.ctx.stop_event.set()
        if wait:
            runner.thread.join(timeout=30)

    def list_services(self) -> List[Dict[str, Any]]:
        """This host's live executors (a host agent's ``/inventory``): a
        thread has no pid of its own."""
        with self._lock:
            runners = dict(self._runners)
        return [{"service_id": sid, "service_type": r.ctx.service_type,
                 "status": "RUNNING", "chips": list(r.ctx.chips),
                 "pid": None}
                for sid, r in runners.items() if r.thread.is_alive()]

    def stop_all(self) -> None:
        with self._lock:
            ids = list(self._runners)
        for sid in ids:
            self.destroy_service(sid)
