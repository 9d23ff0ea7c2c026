"""Training with the model split over the ranks of a train mesh.

Counterpart of ``rafiki_tpu/parallel/sharding.py``: :class:`P` (JAX's
``PartitionSpec``, which the port cannot import), :func:`filter_pspec`,
:func:`make_train_mesh` (the ``(pipe, data, expert, seq, model)`` mesh),
the activation-mesh hook (:func:`activation_mesh`, :func:`current_mesh`,
:func:`mesh_axis_size`, :func:`shard_activations`) and
:class:`GspmdTrainer`.

The JAX trainer holds global arrays that XLA lays out by the spec tree;
here every rank is a process on its own device that holds its slice of
each leaf (:func:`local_index`: an axis named on a dimension splits it
into equal parts, the rank's coordinate on that axis choosing its part)
and runs the same step, the collectives written out by the model code
(``parallel/collectives.py``). What the step computes, and how:

- the batch is global on every rank, which keeps its part by
  ``batch_specs``;
- the loss function returns this rank's share of the loss over the batch
  axes ``GRAD_AXES`` (``data``, ``seq``): the shares sum to the loss,
  which :meth:`GspmdTrainer.step` returns (:func:`mean_share` divides a
  sum by the global count, ``lm.loss_fn`` and the dryrun's ViT loss use
  it);
- backward gives each leaf this rank's share of its gradient over
  ``GRAD_AXES`` and the whole gradient over the other axes (where the
  model code closes every split region with a conjugate pair). So each
  gradient is summed over ``GRAD_AXES`` alone, one flat buffer an axis;
- the optimizer is a ``torch.optim`` factory over this rank's leaves.
  Adam and AdamW are elementwise, so the update of a slice is the slice
  of the update (optax's ``adamw(1e-3)``, the dryrun's, is
  ``torch.optim.AdamW(lr=1e-3, weight_decay=1e-4, eps=1e-8)``).
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence
from typing import Tuple

import numpy as np
import torch

from rafiki_tpu_torch.device import DeviceSpec, _as_device, visible_devices
from rafiki_tpu_torch.parallel.collectives import MeshGroups, sum_over
from rafiki_tpu_torch.parallel.mesh import Mesh

#: the axes that split the batch: a rank's loss and gradients are its
#: share over them, and each gradient is summed over them
GRAD_AXES = ("data", "seq")

LossFn = Callable[[Any, Any, Any], Tuple[torch.Tensor, Dict[str, Any]]]
OptimizerFactory = Callable[[List[torch.Tensor]], torch.optim.Optimizer]


class P(tuple):
    """A partition spec: one entry a dimension, each None, an axis name
    or a tuple of names (the dimension split over their product, the
    first the outermost); a tuple of one name is that name, as in JAX."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, (tuple, list)) and len(e) == 1
            else tuple(e) if isinstance(e, list) else e for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


def is_spec(x: Any) -> bool:
    return isinstance(x, P)


def filter_pspec(spec: P, mesh: Mesh) -> P:
    """Drop mesh-axis names the mesh doesn't define (so ``model``-sharded
    specs degrade to replicated on a pure-DP mesh, etc.)."""
    names = set(mesh.axis_names)

    def keep(entry):
        if entry is None:
            return None
        if isinstance(entry, (tuple, list)):
            kept = tuple(a for a in entry if a in names)
            return kept if kept else None
        return entry if entry in names else None

    return P(*(keep(e) for e in spec))


def make_train_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None,
                    tp: int = 1, sp: int = 1, pp: int = 1, ep: int = 1,
                    devices: Optional[Sequence[DeviceSpec]] = None) -> Mesh:
    """Build a (pipe, data, expert, seq, model) mesh, ``model`` innermost
    (the ranks of a tensor-parallel group are neighbours) and ``pipe``
    outermost. Unspecified dp absorbs the remaining devices."""
    devs = [_as_device(d) for d in (
        devices if devices is not None else visible_devices())]
    if n_devices is not None:
        devs = devs[:n_devices]
    n = len(devs)
    fixed = tp * sp * pp * ep
    if dp is None:
        if n % fixed:
            raise ValueError(f"{n} devices not divisible by tp*sp*pp*ep={fixed}")
        dp = n // fixed
    if dp * fixed != n:
        raise ValueError(f"dp*tp*sp*pp*ep={dp * fixed} != {n} devices")
    return Mesh(tuple(devs), {"pipe": pp, "data": dp, "expert": ep,
                              "seq": sp, "model": tp})


# -- the activation mesh -------------------------------------------------------
# Model code reads the mesh a trainer installed (thread-local, as trial
# executors are threads) to route to its mesh-aware paths: tensor-parallel
# heads, a sequence shard, ring attention, GPipe, experts.

_act = threading.local()


@contextlib.contextmanager
def activation_mesh(mesh: Optional[MeshGroups]) -> Iterator[None]:
    prev = getattr(_act, "mesh", None)
    _act.mesh = mesh
    try:
        yield
    finally:
        _act.mesh = prev


def current_mesh() -> Optional[MeshGroups]:
    """This rank's view of the mesh installed by the innermost
    :func:`activation_mesh` (None outside a trainer)."""
    return getattr(_act, "mesh", None)


def mesh_axis_size(axis: str) -> int:
    """Size of ``axis`` on the current mesh (1 if absent / no mesh)."""
    mesh = current_mesh()
    return 1 if mesh is None else mesh.size(axis)


def shard_activations(x: torch.Tensor, axes: Sequence[Any]) -> torch.Tensor:
    """JAX's sharding constraint on activations, called where JAX's
    blocks call it. A rank here holds its shard of every activation
    already (its rows on ``data``, its positions on ``seq``), so there is
    nothing to constrain: ``x`` as it is."""
    return x


# -- slices of the spec tree ---------------------------------------------------

def local_index(shape: Sequence[int], spec: P, mesh: Mesh,
                coords: Dict[str, int]) -> Tuple[slice, ...]:
    """The slice of a global array of ``shape`` that a rank at
    ``coords`` holds under ``spec`` (axes the mesh lacks dropped)."""
    spec = filter_pspec(spec, mesh)
    index = []
    for dim, size in enumerate(shape):
        entry = spec[dim] if dim < len(spec) else None
        names = () if entry is None else (
            tuple(entry) if isinstance(entry, (tuple, list)) else (entry,))
        parts, at = 1, 0
        for name in names:
            parts *= mesh.shape[name]
            at = at * mesh.shape[name] + coords[name]
        if size % parts:
            raise ValueError(f"dimension {dim} of {tuple(shape)} does not "
                             f"split into {parts} parts over {names}")
        step = size // parts
        index.append(slice(at * step, (at + 1) * step))
    return tuple(index)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of nested dicts (and lists), with the
    matching leaves of ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not is_spec(tree):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    out: List[Any] = []
    tree_map(out.append, tree)
    return out


def mean_share(values: torch.Tensor, weights: Optional[torch.Tensor] = None,
               split: Sequence[str] = GRAD_AXES) -> torch.Tensor:
    """This rank's share of the (weighted) mean of ``values`` over the
    global batch: its weighted sum over the global weight (summed over
    the ``split`` axes, on which the rows differ), over the number of
    ranks on the other ``GRAD_AXES``, which hold the same rows. Off a
    mesh, the mean itself."""
    if weights is None:
        weights = torch.ones_like(values)
    local = (values * weights).sum()
    total = weights.detach().sum().float()
    mesh = current_mesh()
    replicas = 1
    if mesh is not None:
        total = sum_over(total, mesh, split)
        replicas = math.prod(mesh.size(a) for a in GRAD_AXES
                             if a not in split)
    return local / total.clamp_min(1.0) / replicas


class GspmdTrainer:
    """The port of JAX's pjit-style trainer: parameters split over the
    ranks by the model's spec tree, the batch by ``batch_specs``, one
    step every rank runs on its own shards.

    ``loss_fn(params, batch, rng) -> (loss share, {name: share})`` over
    this rank's leaves (a dict tree in the JAX layout, blocks stacked)
    and its part of the batch; ``rng`` is a ``utils/jrandom`` key (or
    None). ``optimizer`` is a ``torch.optim`` factory over the leaves.
    ``mesh`` is this rank's :class:`MeshGroups`. ``predict_fn(params,
    x)`` serves with the same shards, the input split like the first
    train-batch element; its output is gathered over the data axis (every rank holds the whole
    answer)."""

    def __init__(self, loss_fn: LossFn, optimizer: OptimizerFactory,
                 param_specs: Any, batch_specs: Any, mesh: MeshGroups,
                 predict_fn: Optional[Callable[[Any, Any], torch.Tensor]]
                 = None):
        self.mesh = mesh
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.param_specs = param_specs
        self.batch_specs = batch_specs
        self.predict_fn = predict_fn
        self.predict_in_specs = (batch_specs if is_spec(batch_specs)
                                 else batch_specs[0])

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    # -- lifecycle --------------------------------------------------------

    def init(self, init_fn: Callable[[np.random.Generator], Any],
             seed: int = 0) -> Tuple[Any, torch.optim.Optimizer]:
        """``init_fn(np.random.default_rng(seed))`` (a numpy tree in the
        JAX layout, the same on every rank), this rank's slice of each
        leaf on its device (f32, requiring grad), and the optimizer over
        them."""
        # convert imports the model families, which import this module
        from rafiki_tpu_torch import convert

        local = convert.shard_tree(init_fn(np.random.default_rng(seed)),
                                   self.param_specs, self.mesh.mesh,
                                   self.mesh.rank)
        params = tree_map(lambda a: torch.tensor(
            a, dtype=torch.float32, device=self.device).requires_grad_(),
            local)
        return params, self.optimizer(tree_leaves(params))

    def _local_batch(self, batch: Any, specs: Any) -> Any:
        def part(a, spec):
            a = a if isinstance(a, torch.Tensor) else torch.from_numpy(
                np.ascontiguousarray(a))
            index = local_index(a.shape, spec, self.mesh.mesh,
                                self.mesh.coords)
            return a[index].to(self.device)

        if is_spec(specs):
            return part(batch, specs)
        return type(batch)(part(a, s) for a, s in zip(batch, specs))

    def step(self, params: Any, opt: torch.optim.Optimizer, batch: Any,
             rng: Any = None) -> Tuple[Any, torch.optim.Optimizer,
                                       torch.Tensor, Dict[str, Any]]:
        """One step over the global ``batch``; returns (params, the
        optimizer, the loss, the aux values), the loss and aux summed
        over the ranks' shares (the same on every rank). ``params`` are
        updated in place."""
        local = self._local_batch(batch, self.batch_specs)
        leaves = tree_leaves(params)
        with activation_mesh(self.mesh):
            loss, aux = self.loss_fn(params, local, rng)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        self._sum_grads(grads)
        for p, g in zip(leaves, grads):
            p.grad = g
        opt.step()
        opt.zero_grad(set_to_none=True)
        shares = torch.stack([loss.detach().float().reshape(())]
                             + [torch.as_tensor(v, dtype=torch.float32,
                                                device=self.device)
                                .detach().reshape(()) for v in aux.values()])
        total = sum_over(shares, self.mesh, GRAD_AXES)
        return (params, opt, total[0],
                {k: total[i + 1] for i, k in enumerate(aux)})

    def _sum_grads(self, grads: List[torch.Tensor]) -> None:
        """Sum each gradient over ``GRAD_AXES``, one flat f32 buffer an
        axis."""
        groups = [self.mesh.group(a) for a in GRAD_AXES]
        if not any(groups) or not grads:
            return
        flat = torch.cat([g.reshape(-1).float() for g in grads])
        for g in groups:
            if g is not None:
                g.all_reduce_(flat)
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))

    def predict(self, params: Any, x: Any) -> torch.Tensor:
        """``predict_fn`` over this rank's part of ``x`` under the mesh,
        without gradients, gathered over the data axis."""
        if self.predict_fn is None:
            raise ValueError("this trainer has no predict_fn")
        local = self._local_batch(x, self.predict_in_specs)
        with activation_mesh(self.mesh), torch.no_grad():
            out = self.predict_fn(params, local)
        g = self.mesh.group("data")
        if g is None:
            return out
        return torch.cat(g.all_gather(out.contiguous()).unbind(0), 0)
