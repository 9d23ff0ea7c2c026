"""Mesh shapes over a grant of devices, one rank a device.

Counterpart of ``rafiki_tpu/parallel/mesh.py``'s axis names,
:class:`MeshSpec` (copied with its cases) and :func:`make_mesh`. In JAX a
mesh is one program's view of its devices; here it is the shape of the
process group that a grant becomes, rank ``r`` running on ``devices[r]``
(``parallel/ranks.py`` starts the ranks). Only the data axis is ported
(the batch is split over the ranks, the parameters are copied); a mesh
that gives another axis more than one device is item 5b of ROADMAP.md.
The thread grant (``set_device_grant``, ``visible_devices``) stays in
``rafiki_tpu_torch/device.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from rafiki_tpu_torch.device import DeviceSpec, _as_device, visible_devices

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
EXPERT_AXIS = "expert"
PIPELINE_AXIS = "pipe"


@dataclass
class MeshSpec:
    """Declarative mesh shape. ``-1`` on one axis means "all remaining
    devices"."""

    axes: Dict[str, int] = field(default_factory=lambda: {DATA_AXIS: -1})

    def resolve(self, n_devices: int) -> Dict[str, int]:
        fixed = {k: v for k, v in self.axes.items() if v != -1}
        known = int(np.prod(list(fixed.values()))) if fixed else 1
        free = [k for k, v in self.axes.items() if v == -1]
        if len(free) > 1:
            raise ValueError("At most one mesh axis may be -1")
        out = dict(fixed)
        if free:
            if n_devices % known != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes {fixed}"
                )
            out[free[0]] = n_devices // known
        elif known != n_devices:
            raise ValueError(f"Mesh {self.axes} needs {known} devices, have {n_devices}")
        # preserve declaration order
        return {k: out[k] for k in self.axes}


@dataclass(frozen=True)
class Mesh:
    """The devices of a grant in rank order, and the axes' sizes."""

    devices: Tuple[torch.device, ...]
    shape: Dict[str, int]

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(spec: Optional[MeshSpec] = None,
              devices: Optional[Sequence[DeviceSpec]] = None) -> Mesh:
    """A mesh over the granted devices (default: this thread's visible
    devices, pure data-parallel)."""
    devices = tuple(_as_device(d) for d in (
        devices if devices is not None else visible_devices()))
    shape = (spec or MeshSpec()).resolve(len(devices))
    split = sorted(k for k, v in shape.items() if k != DATA_AXIS and v > 1)
    if split:
        raise NotImplementedError(
            f"mesh axes {split} split the model over ranks; rafiki_tpu_torch "
            "has the data axis only (ROADMAP.md, item 5b)")
    return Mesh(devices, shape)
