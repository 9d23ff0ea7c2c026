"""Device grant and service context.

Counterpart of ``rafiki_tpu/parallel/mesh.py`` (the thread grant) and
``rafiki_tpu/placement/manager.py`` (``ServiceContext``). Under thread
placement executors are threads of one process, so the placement layer
grants each thread its devices with :func:`set_device_grant`; under
process placement a child sees only its granted cards
(``CUDA_VISIBLE_DEVICES``) and its grant is their indices there. Model
code asks :func:`default_device` for the device to run on.
``RAFIKI_VISIBLE_DEVICES`` (comma-separated CUDA indices) is the
process-wide fallback.

A grant names CUDA indices (ints) or ``"cpu"``. With no grant and no CUDA
device, :func:`default_device` raises: the port never carries on quietly
on the CPU. Callers that want the CPU (the tests) say so with
``device="cpu"`` or a ``["cpu"]`` grant.

Caveat, as in the JAX package: the grant is per-thread. Model code that
spawns helper threads must propagate it with
``set_device_grant(get_device_grant())``.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, List, Optional, Sequence,
                    Tuple, Union)

import torch

DeviceSpec = Union[int, str, torch.device]

_thread_grant = threading.local()


def set_device_grant(devices: Optional[Sequence[DeviceSpec]]) -> None:
    """Restrict this thread's devices to ``devices`` (CUDA indices, or
    ``"cpu"``). ``None`` or empty clears the grant."""
    _thread_grant.devices = (tuple(_as_device(d) for d in devices)
                             if devices else None)


def get_device_grant() -> Optional[Tuple[torch.device, ...]]:
    """This thread's device grant (for propagating into helper threads)."""
    return getattr(_thread_grant, "devices", None)


def _as_device(spec: DeviceSpec) -> torch.device:
    if isinstance(spec, int):
        return torch.device("cuda", spec)
    return torch.device(spec)


def visible_devices() -> List[torch.device]:
    """Devices this thread may use: the thread grant if set, else the
    ``RAFIKI_VISIBLE_DEVICES`` indices, else every CUDA device (an empty
    list without CUDA)."""
    grant = get_device_grant()
    if grant:
        return list(grant)
    spec = os.environ.get("RAFIKI_VISIBLE_DEVICES", "").strip()
    if spec:
        return [torch.device("cuda", int(s)) for s in spec.split(",")
                if s.strip()]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def default_device(device: Optional[DeviceSpec] = None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else the
    first visible device. Raises when that is a CUDA device and CUDA is
    absent, or when nothing is visible."""
    dev = _as_device(device) if device is not None else None
    if dev is None:
        visible = visible_devices()
        if not visible:
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' (or grant "
                "['cpu']) to run on the CPU")
        dev = visible[0]
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{dev} requested but CUDA is not available; pass "
                "device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", 0)
        if dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"{dev} requested but only {torch.cuda.device_count()} "
                "CUDA device(s) exist")
    return dev


@dataclass
class ServiceContext:
    """Handed to a service entry point: identity, device grant, stop
    signal. ``chips`` are CUDA indices, or ``["cpu"]``; empty means the
    process default (:func:`default_device`). ``extra`` is the service's
    declarative payload (``sub_train_job_id``; ``inference_job_id`` and
    ``trial_id``), which a process placement hands its child."""

    service_id: str
    chips: List[DeviceSpec] = field(default_factory=list)
    stop_event: threading.Event = field(default_factory=threading.Event)
    on_ready: Optional[Callable[[], None]] = None
    service_type: str = ""
    extra: Dict[str, Any] = field(default_factory=dict)

    @property
    def stopping(self) -> bool:
        return self.stop_event.is_set()

    def ready(self) -> None:
        """Called by the service once initialised (model loaded and warm);
        only then does the service take traffic."""
        if self.on_ready:
            self.on_ready()

    def device(self) -> torch.device:
        """The first granted device."""
        return default_device(self.chips[0] if self.chips else None)
