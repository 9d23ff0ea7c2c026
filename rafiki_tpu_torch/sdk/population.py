"""Population training: K hyperparameter variants of one model trained at
once, as one vectorized program.

Counterpart of ``rafiki_tpu/sdk/population.py``. The K members' parameters
are stacked on a leading member axis (:class:`~rafiki_tpu_torch.sdk.
torch_backend.StackedModels`), and a step is ``torch.func.vmap`` of
``torch.func.grad_and_value`` of the template's loss over
``functional_call``, the members mapped and the batch shared, the
counterpart of ``jax.vmap`` of the JAX member step: K convolutions become
one grouped convolution, K dense products one batched product. The
trial's ``torch.optim`` optimizer holds one parameter group a member,
over the views ``p[k]`` of the stacked tensors, each group with that
member's hyperparameters (optax's ``inject_hyperparams`` state, vmapped),
so members that differ only in them share the one program. torch's SGD
and AdamW take optax's ``sgd`` and ``adamw`` update up to rounding (eps
outside the square root, AdamW's decay ``lr·wd·p`` decoupled), and a
member at lr 0 keeps its parameters bit for bit.

As in the JAX trainer: member k is initialised from its own draw
(``init_fn(np.random.default_rng([seed, k]))``); each epoch's batch
order comes from ``np.random.default_rng([seed, epoch])`` and is the same
for every member; the log reports the population's mean ``loss`` and each
``member{k}_loss``; ``StopTrialEarly`` from the log ends the fit after that
epoch with the members as they are; the stacked checkpoint is written
every ``checkpoint_every_epochs`` and at the end, a checkpoint of another
member count is typed corruption and the fit starts fresh; the dataset
stays on the device across fits of the same arrays. Stateless models only.
``FIT_STATS`` counts the fits begun (``member_counts``, as in JAX) and,
beside them, the fits that returned (``completed_member_counts``): a fit
that raised shows in the first alone.

Over the ranks of a data group (``parallel/ranks.py``) every rank holds
every member, the global batch is split over the ranks in order, the
gradients are averaged per member over them (the JAX trainer's data axis),
rank 0 alone logs, decides a stop and writes the checkpoint, and
``member_scores`` pads each chunk to a multiple of the ranks.
"""

from __future__ import annotations

import copy
import io
import logging
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from rafiki_tpu_torch.device import default_device
from rafiki_tpu_torch.parallel.ranks import current_group, verdict_point
from rafiki_tpu_torch.sdk.artifact import (
    ArtifactCorruptError,
    read_artifact,
    write_artifact,
)
from rafiki_tpu_torch.sdk.log import StopTrialEarly
from rafiki_tpu_torch.sdk.torch_backend import (
    LossFn,
    OptimizerFactory,
    StackedModels,
    broadcast_bytes,
    shuffled_batches,
)

logger = logging.getLogger(__name__)

#: process-local fit telemetry: how many times :meth:`PopulationTrainer.fit`
#: began and with how many stacked members each time, and the member counts
#: of the fits that returned (bounded tails)
FIT_STATS: Dict[str, Any] = {"fit_calls": 0, "member_counts": [],
                             "completed_member_counts": []}
_FIT_STATS_TAIL = 64

OptState = torch.optim.Optimizer


def reset_fit_stats() -> None:
    FIT_STATS["fit_calls"] = 0
    FIT_STATS["member_counts"] = []
    FIT_STATS["completed_member_counts"] = []


def _note_fit(key: str, n_members: int) -> None:
    FIT_STATS[key].append(n_members)
    del FIT_STATS[key][:-_FIT_STATS_TAIL]


class _Loss(torch.nn.Module):
    """``loss_fn(model, batch)`` as a module's forward, so that
    ``functional_call`` runs it over a member's parameters."""

    def __init__(self, model: torch.nn.Module, loss_fn: LossFn):
        super().__init__()
        self.model = model
        self.loss_fn = loss_fn

    def forward(self, batch):
        return self.loss_fn(self.model, batch)


class PopulationTrainer:
    """Train a population of K members that differ only in dynamic
    hyperparameters. ``optimizer`` is a :func:`~rafiki_tpu_torch.sdk.
    torch_backend.tunable_optimizer` factory, called with one parameter
    group a member; ``loss_fn(model, batch) -> (loss, aux)`` and
    ``predict_fn(model, x)`` as for ``DataParallelTrainer``."""

    def __init__(self, loss_fn: LossFn, optimizer: OptimizerFactory,
                 predict_fn: Optional[Callable[..., torch.Tensor]] = None,
                 device=None):
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.predict_fn = predict_fn
        self.device = default_device(device)
        self._fit_data_cache: Optional[tuple] = None

    @property
    def n_data(self) -> int:
        group = current_group()
        return group.size if group is not None else 1

    def _shard(self, n: int) -> slice:
        group = current_group()
        if group is None:
            return slice(0, n)
        part = n // group.size
        return slice(group.rank * part, (group.rank + 1) * part)

    # -- lifecycle ---------------------------------------------------------

    def init(self, init_fn: Callable[[np.random.Generator], torch.nn.Module],
             hyperparams: Dict[str, Sequence[float]], seed: int = 0
             ) -> Tuple[StackedModels, OptState]:
        """The member-stacked (params, optimizer). ``hyperparams`` maps
        the optimizer's hyperparameter names to K-length sequences (K
        inferred, all of one length); member k is
        ``init_fn(np.random.default_rng([seed, k]))``."""
        lengths = {k: len(v) for k, v in hyperparams.items()}
        if not lengths:
            raise ValueError("hyperparams must name at least one "
                             "K-length value sequence")
        sizes = set(lengths.values())
        if len(sizes) != 1:
            raise ValueError(f"hyperparam lengths differ: {lengths}")
        (n_members,) = sizes
        if n_members < 1:
            raise ValueError("population must have at least one member")
        return self.stack([init_fn(np.random.default_rng([seed, k]))
                           for k in range(n_members)], hyperparams)

    def stack(self, models: List[torch.nn.Module],
              hyperparams: Dict[str, Sequence[float]]
              ) -> Tuple[StackedModels, OptState]:
        """(params, optimizer) of the given members, in order. Over
        several ranks rank 0's members are every rank's."""
        params = StackedModels(models, self.device)
        # the structure functional_call runs: its own tensors never are
        params._structure = copy.deepcopy(models[0]).to("meta")
        for stacked in (params.params, params.buffers):
            # a stack of channels_last kernels is not contiguous, and a
            # collective (and the optimizer's flat view) wants it to be
            stacked.update({k: v.contiguous() for k, v in stacked.items()})
        group = current_group()
        if group is not None:
            with torch.no_grad():
                for t in [*params.params.values(), *params.buffers.values()]:
                    group.broadcast_(t)
        return params, self._member_optimizer(params, hyperparams)

    def _member_optimizer(self, params: StackedModels,
                          hyperparams: Dict[str, Sequence[float]]
                          ) -> torch.optim.Optimizer:
        """The factory's optimizer with one parameter group a member, over
        the views ``p[k]`` of the stacked tensors, group k holding member
        k's hyperparameters. An unknown name raises: a typo must not
        silently train at the wrong lr."""
        opt = self.optimizer([{"params": [p[k] for p in
                                          params.params.values()]}
                              for k in range(params.n_models)])
        for name, values in hyperparams.items():
            if name not in opt.defaults:
                raise KeyError(f"optimizer has no hyperparam {name!r}; has "
                               f"{sorted(opt.defaults)}")
            for group, value in zip(opt.param_groups, values):
                group[name] = float(value)
        return opt

    def n_members(self, params: StackedModels) -> int:
        return params.n_models

    def member_params(self, params: StackedModels, k: int
                      ) -> torch.nn.Module:
        """Member ``k`` as a module of its own (e.g. the winner), on the
        trainer's device."""
        model = copy.deepcopy(params._structure)
        state = {name[len("model."):]: t[k].detach().clone()
                 for name, t in [*params.params.items(),
                                 *params.buffers.items()]}
        model.load_state_dict(state, strict=True, assign=True)
        return model.eval()

    # -- training ----------------------------------------------------------

    def _grad_fn(self, params: StackedModels):
        """vmap over the members of (gradients, (loss, aux)) of one
        member's loss on the shared batch."""
        wrapper = _Loss(params._structure, self.loss_fn)

        def member_loss(p, b, batch):
            return torch.func.functional_call(wrapper, (p, b), (batch,))

        return torch.func.vmap(
            torch.func.grad_and_value(member_loss, has_aux=True),
            in_dims=(0, 0, None))

    def grads(self, params: StackedModels, batch: Tuple[torch.Tensor, ...],
              grad_fn=None) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """Every member's gradients of one batch (each the mean of the
        ranks' over a group: equal shards, so the global batch's, summed
        in f32 in one buffer) and this rank's losses (K,)."""
        grad_fn = grad_fn or self._grad_fn(params)
        grads, (losses, _) = grad_fn(params.params, params.buffers, batch)
        group = current_group()
        if group is not None:
            names = list(grads)
            flat = torch.cat([grads[k].reshape(-1).float() for k in names])
            group.all_reduce_(flat).div_(group.size)
            offset = 0
            for k in names:
                g = grads[k]
                grads[k] = flat[offset: offset + g.numel()].view_as(g).to(
                    g.dtype)
                offset += g.numel()
        return grads, losses.detach()

    @staticmethod
    def apply_(params: StackedModels, opt_state: OptState,
               grads: Dict[str, torch.Tensor]) -> None:
        """The optimizer's step over every member, in place, from the
        members' stacked gradients."""
        for k, group in enumerate(opt_state.param_groups):
            for name, p in zip(params.params, group["params"]):
                p.grad = grads[name][k]
        opt_state.step()
        opt_state.zero_grad(set_to_none=True)

    def step(self, params: StackedModels, opt_state: OptState,
             batch: Tuple[torch.Tensor, ...], grad_fn=None) -> torch.Tensor:
        """One step of every member, in place; their losses (K,), not
        synchronised."""
        grads, losses = self.grads(params, batch, grad_fn)
        self.apply_(params, opt_state, grads)
        return losses

    def fit(self, params: StackedModels, opt_state: OptState,
            data: Tuple[np.ndarray, ...], epochs: int, batch_size: int,
            seed: int = 0, log: Optional[Callable[..., None]] = None,
            checkpoint_path: Optional[str] = None,
            checkpoint_every_epochs: int = 1
            ) -> Tuple[StackedModels, OptState]:
        """The epoch loop; ``params`` and ``opt_state`` are trained in
        place and returned. Remainder batches are dropped."""
        FIT_STATS["fit_calls"] += 1
        _note_fit("member_counts", self.n_members(params))
        n = len(data[0])
        n_data = self.n_data
        group = current_group()
        lead = group is None or group.rank == 0
        fit_cap = (n // n_data) * n_data
        if fit_cap == 0:
            raise ValueError(
                f"dataset ({n}) smaller than the data axis ({n_data})")
        batch_size = min(max(batch_size - batch_size % n_data, n_data),
                         fit_cap)
        start_epoch = self._resume(checkpoint_path, params, opt_state)
        key = tuple(id(d) for d in data)
        cached = self._fit_data_cache
        data_dev = cached[2] if cached and cached[0] == key else None
        self._fit_data_cache = None if data_dev is None else cached
        grad_fn = self._grad_fn(params)
        for epoch in range(start_epoch, epochs):
            upload: Dict[str, float] = {}
            if data_dev is None:
                t0 = time.time()
                data_dev = tuple(torch.as_tensor(d, device=self.device)
                                 for d in data)
                self._fit_data_cache = (key, tuple(data), data_dev)
                upload["upload_time"] = time.time() - t0
            t0 = time.time()
            epoch_rng = np.random.default_rng([seed, epoch])
            losses: List[torch.Tensor] = []
            for idx in shuffled_batches(n, batch_size, epoch_rng):
                idx = torch.as_tensor(idx[self._shard(len(idx))],
                                      device=self.device)
                losses.append(self.step(params, opt_state,
                                        tuple(d[idx] for d in data_dev),
                                        grad_fn))
            stop_early = False
            if log is not None:
                member_mean = torch.stack(losses).float().mean(0)  # (K,)
                if group is not None:
                    member_mean = group.all_reduce_(member_mean) / group.size
                values = member_mean.cpu().numpy()
                try:
                    if lead:
                        with verdict_point():
                            log(loss=float(values.mean()),
                                epoch=float(epoch),
                                epoch_time=time.time() - t0, **upload,
                                **{f"member{k}_loss": float(v)
                                   for k, v in enumerate(values)})
                except StopTrialEarly:
                    logger.info("population early stop after epoch %d",
                                epoch)
                    stop_early = True
                if group is not None:
                    flag = torch.tensor([float(stop_early)],
                                        device=self.device)
                    stop_early = bool(group.broadcast_(flag).item())
            if lead and checkpoint_path and (
                    (epoch + 1) % max(checkpoint_every_epochs, 1) == 0
                    or epoch + 1 == epochs or stop_early):
                self._save_checkpoint(checkpoint_path, params, opt_state,
                                      epoch + 1)
            if stop_early:
                break
        _note_fit("completed_member_counts", self.n_members(params))
        return params, opt_state

    @staticmethod
    def _save_checkpoint(path: str, params: StackedModels,
                         opt_state: OptState, next_epoch: int) -> None:
        """The port's checkpoint frame (npz, no pickle, inside the
        checksummed artifact): the members' stacked parameters, the
        optimizer's state by index (as ``DataParallelTrainer`` writes it)
        and the epoch to resume at."""
        arrays = {f"params/{k[len('model.'):]}": v.detach().cpu().numpy()
                  for k, v in params.params.items()}
        for i, state in opt_state.state_dict()["state"].items():
            for k, v in state.items():
                arrays[f"opt/{i}/{k}"] = torch.as_tensor(v).cpu().numpy()
        arrays["epoch"] = np.asarray(next_epoch)
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        write_artifact(path, buf.getvalue())

    def _resume(self, path: Optional[str], params: StackedModels,
                opt_state: OptState) -> int:
        """The epoch a fit starts at: 0, or the one after the checkpoint
        at ``path``, loaded in place (rank 0 reads it; every rank loads
        its bytes). A corrupt or mismatched checkpoint costs the saved
        epochs, never the trial."""
        group = current_group()
        blob: Optional[bytes] = None
        if (group is None or group.rank == 0) and path \
                and os.path.exists(path):
            try:
                blob = read_artifact(path)
            except ArtifactCorruptError:
                logger.warning("population checkpoint %s is corrupt or "
                               "unreadable; restarting from scratch", path,
                               exc_info=True)
        if group is not None:
            blob = broadcast_bytes(group, blob, self.device)
        if blob is None:
            return 0
        try:
            epoch = self._load_checkpoint(blob, path, params, opt_state)
        except (ArtifactCorruptError, KeyError, ValueError):
            logger.warning("population checkpoint %s is corrupt or "
                           "unreadable; restarting from scratch", path,
                           exc_info=True)
            return 0
        logger.info("resuming population fit from %s at epoch %d", path,
                    epoch)
        return epoch

    def _restore_checkpoint(self, path: str, params: StackedModels,
                            opt_state: OptState) -> int:
        """Load the checkpoint at ``path`` in place; the epoch to resume
        at."""
        return self._load_checkpoint(read_artifact(path), path, params,
                                     opt_state)

    def _load_checkpoint(self, blob: bytes, path: Optional[str],
                         params: StackedModels, opt_state: OptState) -> int:
        """The member count is checked against the fit's own stack before
        anything is loaded: a checkpoint of another K is typed artifact
        corruption (the fit then starts fresh), as is one written under
        another program."""
        with np.load(io.BytesIO(blob), allow_pickle=False) as z:
            arrays = {k: z[k] for k in z.files}
        expect = self.n_members(params)
        saved = {k[len("params/"):]: v for k, v in arrays.items()
                 if k.startswith("params/")}
        got = int(next(iter(saved.values())).shape[0]) if saved else 0
        if got != expect:
            raise ArtifactCorruptError(
                path,
                f"population checkpoint stacks {got} member(s) but this "
                f"fit stacks {expect}: resuming with a different "
                "population size is not a resume; treating the checkpoint "
                "as corrupt (fresh start)")
        own = {k[len("model."):]: v for k, v in params.params.items()}
        if {k: v.shape for k, v in saved.items()} != {
                k: tuple(v.shape) for k, v in own.items()}:
            raise ArtifactCorruptError(
                path, "checkpoint params do not match this fit's (written "
                "under a different program)")
        with torch.no_grad():
            for k, v in saved.items():
                own[k].copy_(torch.from_numpy(v))
        state: Dict[int, Dict[str, torch.Tensor]] = {}
        for k, v in arrays.items():
            if k.startswith("opt/"):
                _, i, name = k.split("/", 2)
                state.setdefault(int(i), {})[name] = torch.from_numpy(v)
        opt_sd = opt_state.state_dict()
        opt_sd["state"] = state
        opt_state.load_state_dict(opt_sd)  # onto the members' device
        return int(arrays["epoch"])

    # -- evaluation --------------------------------------------------------

    def member_scores(self, params: StackedModels, x: np.ndarray,
                      y: np.ndarray, batch_size: int = 256) -> np.ndarray:
        """Classification accuracy a member over (x, y), every member
        answering each chunk in one vmapped forward: the winner-selection
        signal."""
        assert self.predict_fn is not None
        k = self.n_members(params)
        correct = np.zeros((k,), np.int64)
        n_data = self.n_data
        group = current_group()
        batch_size = max(batch_size - batch_size % n_data, n_data)
        for i in range(0, len(x), batch_size):
            chunk = np.asarray(x[i:i + batch_size])
            n_real = len(chunk)
            pad = (-n_real) % n_data  # the ranks need equal parts
            if pad:
                chunk = np.concatenate(
                    [chunk, np.zeros((pad,) + chunk.shape[1:], chunk.dtype)])
            part = np.ascontiguousarray(chunk[self._shard(len(chunk))])
            with torch.inference_mode():
                probs = params.forward(
                    self.predict_fn,
                    torch.from_numpy(part).to(self.device))  # (K, n, C)
                if group is not None:
                    probs = group.all_gather(probs).transpose(0, 1).flatten(
                        1, 2)
                pred = probs.argmax(-1).cpu().numpy()[:, :n_real]
            correct += (pred == np.asarray(y[i:i + n_real])[None, :]).sum(
                axis=1)
        return correct / float(len(x))
