"""Mesh shapes over a grant of devices, one rank a device.

Counterpart of ``rafiki_tpu/parallel/mesh.py``'s axis names,
:class:`MeshSpec` (copied with its cases) and :func:`make_mesh`. In JAX a
mesh is one program's view of its devices; here it is the shape of the
process group that a grant becomes, rank ``r`` running on ``devices[r]``
(``parallel/ranks.py`` starts the ranks). Every axis is taken: the data
axis splits the batch (``parallel/ranks.py``'s data group); the model,
seq, expert and pipe axes split the model over the ranks
(``parallel/sharding.py``), each rank finding its coordinates with
:meth:`Mesh.coords` and its fellows along an axis with :meth:`Mesh.line`.
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

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.shape)

    def coords(self, rank: int) -> Dict[str, int]:
        """Rank ``rank``'s index on each axis: ranks fill the mesh in row-
        major order over the axes as declared (``np.reshape``'s order, as
        a JAX mesh's device array)."""
        idx = np.unravel_index(rank, tuple(self.shape.values()))
        return {k: int(i) for k, i in zip(self.shape, idx)}

    def line(self, axis: str, rank: int) -> Tuple[int, ...]:
        """The ranks that differ from ``rank`` on ``axis`` alone, in the
        order of their index on it (``rank``'s group along ``axis``)."""
        grid = np.arange(self.size).reshape(tuple(self.shape.values()))
        at = self.coords(rank)
        index = tuple(slice(None) if k == axis else at[k] for k in self.shape)
        return tuple(int(r) for r in grid[index])


def make_mesh(spec: Optional[MeshSpec] = None,
              devices: Optional[Sequence[DeviceSpec]] = None) -> Mesh:
    """A mesh over the granted devices (default: this thread's visible
    devices, pure data-parallel)."""
    devices = tuple(_as_device(d) for d in (
        devices if devices is not None else visible_devices()))
    return Mesh(devices, (spec or MeshSpec()).resolve(len(devices)))
