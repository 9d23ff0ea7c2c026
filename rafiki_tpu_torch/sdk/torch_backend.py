"""Training and batched prediction for model templates.

Counterpart of ``rafiki_tpu/sdk/jax_backend.py``: ``DataParallelTrainer``
(``init``, ``fit`` with mid-trial checkpoints, the stateful variant, the
padded predict-bucket ladder, ``predict_batched``, ``warm_predict``),
the fused ensemble's stacked predict (``stack_ensemble_params``,
``predict_batched_stacked``, ``warm_predict_stacked`` and
``trainer_ensemble_stack``), ``cached_trainer`` and
``trainer_cache_clear``, ``tunable_optimizer`` and
``set_opt_hyperparams``, ``shuffled_batches``,
``softmax_classifier_loss`` and ``classification_accuracy``. The class
keeps its name. ``DataParallelTrainer(serve_int8=True)`` (or
``RAFIKI_SERVE_INT8=1``) predicts from weight-only int8 copies
(``sdk/quant.py``): quantized once a module object (each module its own
entry, dropped with the module and when the trainer trains it), on its
device, and dequantized in the source dtype into the module through
``functional_call`` at each forward; a fused ensemble quantizes each
trial on its own and stacks the int8 values and scales, and each vmap
instance dequantizes its own. BERT's embedding table is dequantized
whole, as the JAX graph asks.

Over several devices each rank of the thread's data group
(``parallel/ranks.py``) runs the same calls on its own device, and the
trainer keeps the JAX trainer's semantics by hand, where XLA inserts them
over the mesh: ``n_data`` is the group's size; the batch is the *global*
batch, rounded up to a multiple of ``n_data``, and rank ``r`` takes the
``r``-th contiguous slice of each (every rank draws the same shuffle); the
parameters are initialised (or restored) on rank 0 and copied to the
others; the gradients are averaged over the ranks in f32, so a step
equals one device's step over the global batch; the logged loss is the
global batch's; rank 0 alone logs, decides a stop and writes the
checkpoint; each predict bucket (a multiple of ``n_data``) is split over
the ranks and gathered in order, so every rank returns the whole answer.
BatchNorm's moments are global (``models/resnet.py``).

What the JAX trainer's arguments become here:

- params: an ``nn.Module`` (f32 master weights), trained in place;
- opt_state: a ``torch.optim.Optimizer`` over its parameters;
- ``loss_fn(model, batch) -> (loss, aux)``; ``predict_fn(model, x)``;
- ``init_fn(rng) -> nn.Module``, with ``rng`` a seeded
  ``numpy.random.Generator``;
- with ``stateful=True`` (BatchNorm's running statistics): the state is a
  ``{name: tensor}`` mapping that no optimizer sees (the model's buffers,
  for the zoo's ResNet); ``init_fn(rng) -> (model, state)``,
  ``loss_fn(model, state, batch) -> (loss, (aux, new_state))``,
  ``predict_fn(model, state, x)``, and ``fit``/``predict_batched``/
  ``warm_predict`` take ``state=``. ``fit`` copies each step's new state
  into the mapping in place, under ``no_grad``.

``cached_trainer`` keeps the JAX package's contract (an LRU of trainers
keyed by the architecture and the thread's grant, the trial's
hyperparameters set at ``init``), but here it is a memo, not a compile
cache: PyTorch compiles nothing per shape. The predict ladder still
bounds the shapes the kernels see, and ``warm_predict`` builds and loads
every kernel before the first request. ``fit`` moves the whole dataset to
the device once and indexes batches there (the JAX trainer's
device-resident epoch scan), and keeps it there for the next ``fit`` of
the same arrays (the trials of one job); datasets larger than device
memory wait for a streaming path.
"""

from __future__ import annotations

import collections
import io
import logging
import os
import threading
import time
import weakref
from typing import (Any, Callable, Dict, Hashable, Iterator, List, Optional,
                    Tuple)

import numpy as np
import torch
import torch.nn.functional as F

from rafiki_tpu_torch import config
from rafiki_tpu_torch.device import default_device, visible_devices
from rafiki_tpu_torch.parallel.ranks import current_group, verdict_point
from rafiki_tpu_torch.sdk.artifact import (
    ArtifactCorruptError,
    read_artifact,
    write_artifact,
)
from rafiki_tpu_torch.sdk.log import StopTrialEarly

logger = logging.getLogger(__name__)

LossFn = Callable[[torch.nn.Module, Tuple[torch.Tensor, ...]],
                  Tuple[torch.Tensor, Dict[str, torch.Tensor]]]
OptimizerFactory = Callable[[Any], torch.optim.Optimizer]
State = Dict[str, torch.Tensor]

_trainer_cache: "collections.OrderedDict[Hashable, Any]" = \
    collections.OrderedDict()
_trainer_cache_lock = threading.Lock()
_TRAINER_CACHE_CAP = int(os.environ.get("RAFIKI_TRAINER_CACHE_CAP", "8"))


def cached_trainer(key: Hashable, build: Callable[[], Any]) -> Any:
    """The trainer cached for ``key`` in this thread's device grant,
    built with ``build()`` on first use.

    The key covers every knob that changes the architecture (and the
    model class); a trial's own hyperparameters (the learning rate, through
    :func:`tunable_optimizer`) stay out of it and are set at ``init``.
    LRU-capped (``RAFIKI_TRAINER_CACHE_CAP``, default 8); models and
    optimizers live outside the trainer, so eviction loses nothing."""
    grant = tuple(str(d) for d in visible_devices())
    full_key = (key, grant)
    with _trainer_cache_lock:
        if full_key in _trainer_cache:
            _trainer_cache.move_to_end(full_key)
            return _trainer_cache[full_key]
    trainer = build()
    with _trainer_cache_lock:
        if full_key not in _trainer_cache:
            _trainer_cache[full_key] = trainer
            while len(_trainer_cache) > _TRAINER_CACHE_CAP:
                _trainer_cache.popitem(last=False)
        _trainer_cache.move_to_end(full_key)
        return _trainer_cache[full_key]


def trainer_cache_clear() -> None:
    with _trainer_cache_lock:
        _trainer_cache.clear()


def drop_fit_data() -> None:
    """Drop the dataset uploads that the cached trainers keep for their
    next ``fit`` (the train worker calls it after a failed trial, whose
    upload must not hold the card); the next fit uploads again."""
    with _trainer_cache_lock:
        trainers = list(_trainer_cache.values())
    for trainer in trainers:
        if getattr(trainer, "_fit_data_cache", None) is not None:
            trainer._fit_data_cache = None


def tunable_optimizer(make: Callable[..., torch.optim.Optimizer],
                      **hyperparams: float) -> OptimizerFactory:
    """A factory ``params -> make(params, **hyperparams)``, e.g.
    ``tunable_optimizer(torch.optim.AdamW, lr=3e-4, weight_decay=1e-4)``;
    a trial's own values are set at ``DataParallelTrainer.init(...,
    hyperparams={...})`` through :func:`set_opt_hyperparams`."""
    def factory(params):
        return make(params, **hyperparams)

    return factory


def set_opt_hyperparams(optimizer: torch.optim.Optimizer,
                        hyperparams: Dict[str, float]) -> torch.optim.Optimizer:
    """Override hyperparameter values in every parameter group. An unknown
    key raises: a typo must not silently train at the wrong lr."""
    groups = optimizer.param_groups
    for k, v in hyperparams.items():
        if k not in groups[0]:
            raise KeyError(f"optimizer has no hyperparam {k!r}; has "
                           f"{sorted(groups[0])}")
        for group in groups:
            group[k] = v
    return optimizer


def shuffled_batches(n: int, batch_size: int, rng: np.random.Generator,
                     drop_remainder: bool = True) -> Iterator[np.ndarray]:
    """Yield shuffled index batches of a fixed size."""
    perm = rng.permutation(n)
    n_full = n // batch_size
    for i in range(n_full):
        yield perm[i * batch_size: (i + 1) * batch_size]
    if not drop_remainder and n % batch_size:
        yield perm[n_full * batch_size:]


def broadcast_bytes(group, blob: Optional[bytes], device
                    ) -> Optional[bytes]:
    """Rank 0's ``blob`` (or None) on every rank of ``group``."""
    size = torch.tensor([-1 if blob is None else len(blob)],
                        dtype=torch.int64, device=device)
    n = int(group.broadcast_(size).item())
    if n < 0:
        return None
    buf = (torch.frombuffer(bytearray(blob), dtype=torch.uint8).to(device)
           if group.rank == 0 else
           torch.empty(n, dtype=torch.uint8, device=device))
    return group.broadcast_(buf).cpu().numpy().tobytes()


class DataParallelTrainer:
    # padding 1 query to 8 wastes little, and bounds the shapes served
    MIN_PREDICT_BUCKET = 8

    def __init__(self, loss_fn: Optional[LossFn] = None,
                 optimizer: Optional[OptimizerFactory] = None,
                 predict_fn: Optional[Callable[..., torch.Tensor]] = None,
                 device=None, stateful: bool = False,
                 serve_int8: Optional[bool] = None):
        """``loss_fn`` and ``optimizer`` are needed to train, ``predict_fn``
        to predict; ``device`` defaults to :func:`default_device`.
        ``stateful`` threads a state the optimizer never sees through
        training and prediction (see the module docstring).
        ``serve_int8`` (default: ``RAFIKI_SERVE_INT8=1``) predicts from
        weight-only int8 copies (``sdk/quant.py``)."""
        from rafiki_tpu_torch.sdk.quant import serve_int8_enabled

        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.predict_fn = predict_fn
        self.stateful = stateful
        self.device = default_device(device)
        self.serve_int8 = (serve_int8 if serve_int8 is not None
                           else serve_int8_enabled())
        # module -> its int8 copy: quantized once a module object, each
        # served module its own entry, dropped with the module (and by
        # train_step, which changes its weights)
        self._qcache: "weakref.WeakKeyDictionary[torch.nn.Module, Any]" = \
            weakref.WeakKeyDictionary()
        # (ids of the host arrays, the host arrays, their device copies):
        # the trials of one job fit the same arrays (dataset_utils caches
        # them); holding the host arrays keeps their ids from being reused
        self._fit_data_cache: Optional[tuple] = None

    @property
    def n_data(self) -> int:
        """Devices on the data axis: the size of this thread's data
        group, 1 without one."""
        group = current_group()
        return group.size if group is not None else 1

    def round_batch(self, batch_size: int) -> int:
        """Round a batch size up to a multiple of the data-axis size."""
        return -(-batch_size // self.n_data) * self.n_data

    def _shard(self, n: int) -> slice:
        """This rank's contiguous part of ``n`` rows (a multiple of
        ``n_data``)."""
        group = current_group()
        if group is None:
            return slice(0, n)
        part = n // group.size
        return slice(group.rank * part, (group.rank + 1) * part)

    # -- training ---------------------------------------------------------

    def init(self, init_fn: Callable[[np.random.Generator], Any],
             seed: int = 0, hyperparams: Optional[Dict[str, float]] = None
             ) -> tuple:
        """(model on the trainer's device, its optimizer), and the state
        for a stateful trainer (whose ``init_fn`` returns (model, state)).
        ``init_fn`` gets ``np.random.default_rng(seed)``; ``hyperparams``
        overrides the optimizer's values (see :func:`tunable_optimizer`)."""
        out = init_fn(np.random.default_rng(seed))
        model, state = out if self.stateful else (out, None)
        model = model.to(self.device)
        group = current_group()
        if group is not None:
            # rank 0's initialisation is every rank's
            with torch.no_grad():
                for t in [*model.parameters(), *model.buffers(),
                          *(state or {}).values()]:
                    group.broadcast_(t.data)
        opt = self.optimizer(model.parameters())
        if hyperparams:
            set_opt_hyperparams(opt, hyperparams)
        if self.stateful:
            # the same tensors where they are on the device already: a
            # model's own buffers stay its buffers
            return model, opt, {k: v.to(self.device)
                                for k, v in state.items()}
        return model, opt

    def train_step(self, model: torch.nn.Module,
                   opt: torch.optim.Optimizer,
                   batch: Tuple[torch.Tensor, ...],
                   state: Optional[State] = None) -> torch.Tensor:
        """One forward, backward and optimizer step, and for a stateful
        trainer the new state copied into ``state``; returns the loss (a
        device scalar, not synchronised)."""
        self._qcache.pop(model, None)  # an int8 copy of the old weights
        if self.stateful:
            loss, (_, new_state) = self.loss_fn(model, state, batch)
        else:
            loss, _ = self.loss_fn(model, batch)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        group = current_group()
        if group is not None:
            self._average_grads(model, group)
        opt.step()
        if self.stateful:
            with torch.no_grad():
                for k, v in new_state.items():
                    state[k].copy_(v)
        return loss.detach()

    @staticmethod
    def _average_grads(model: torch.nn.Module, group) -> None:
        """Each gradient becomes the mean of the ranks' (equal shards, so
        the global batch's), summed in f32 in one flat buffer."""
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        if not grads:
            return
        flat = torch.cat([g.reshape(-1).float() for g in grads])
        group.all_reduce_(flat).div_(group.size)
        offset = 0
        for g in grads:
            g.copy_(flat[offset: offset + g.numel()].view_as(g))
            offset += g.numel()

    def fit(self, params: torch.nn.Module, opt_state: torch.optim.Optimizer,
            data: Tuple[np.ndarray, ...], epochs: int, batch_size: int,
            seed: int = 0, log: Optional[Callable[..., None]] = None,
            checkpoint_path: Optional[str] = None,
            checkpoint_every_epochs: int = 1,
            state: Optional[State] = None) -> tuple:
        """Run the epoch loop over in-memory arrays (equal leading dim; a
        step's batch is the tuple of their rows). Returns
        ``(params, opt_state)``, trained in place, or ``(params, opt_state,
        state)`` for a stateful trainer (pass the initial ``state=``; it is
        updated in place).

        As in the JAX trainer: remainder batches are dropped; the batch
        order of epoch e comes from ``np.random.default_rng([seed, e])``;
        ``loss``, ``epoch`` and ``epoch_time`` are logged each epoch and a
        ``StopTrialEarly`` from ``log`` ends the fit after that epoch. The
        epoch that moves the dataset to the device also logs the move's
        time as ``upload_time`` (kept out of its ``epoch_time``). With
        ``checkpoint_path``, (params, optimizer state, next epoch) are
        written every ``checkpoint_every_epochs`` and at the end, and a fit
        that finds the file resumes from it; a resumed run takes exactly
        the steps the uninterrupted run would have; a stateful trainer's
        checkpoint holds the state too."""
        model, opt = params, opt_state
        if self.stateful and state is None:
            raise ValueError("a stateful trainer's fit needs state=")
        n = len(data[0])
        group = current_group()
        lead = group is None or group.rank == 0
        # the largest multiple of the data-axis size that fits the dataset;
        # a dataset smaller than the mesh is resampled to one row a rank
        fit_cap = (n // self.n_data) * self.n_data
        batch_size = min(self.round_batch(batch_size),
                         fit_cap or self.n_data)
        start_epoch = self._resume(checkpoint_path, model, opt, state)
        # uploaded once: a resume at epoch == epochs skips it, and the
        # next fit of the same arrays reuses it
        key = tuple(id(d) for d in data)
        cached = self._fit_data_cache
        data_dev = cached[2] if cached and cached[0] == key else None
        self._fit_data_cache = None if data_dev is None else cached
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
            if fit_cap == 0:
                batches: Any = [epoch_rng.choice(n, self.n_data)]
            else:
                batches = shuffled_batches(n, batch_size, epoch_rng)
            losses: List[torch.Tensor] = []
            for idx in batches:
                idx = torch.as_tensor(idx[self._shard(len(idx))],
                                      device=self.device)
                losses.append(self.train_step(
                    model, opt, tuple(d[idx] for d in data_dev), state))
            stop_early = False
            if losses and log is not None:
                loss = torch.stack(losses).float().mean()
                if group is not None:
                    loss = group.all_reduce_(loss.reshape(1)) / group.size
                try:
                    if lead:
                        # rank 0's verdict reaches every rank just below
                        with verdict_point():
                            log(loss=float(loss), epoch=float(epoch),
                                epoch_time=time.time() - t0, **upload)
                except StopTrialEarly:
                    logger.info("early stop after epoch %d", epoch)
                    stop_early = True
                if group is not None:
                    # rank 0's verdict ends every rank's fit
                    flag = torch.tensor([float(stop_early)],
                                        device=self.device)
                    stop_early = bool(group.broadcast_(flag).item())
            if lead and checkpoint_path and (
                    (epoch + 1) % max(checkpoint_every_epochs, 1) == 0
                    or epoch + 1 == epochs or stop_early):
                self._save_checkpoint(checkpoint_path, model, opt, epoch + 1,
                                      state)
            if stop_early:
                break
        if self.stateful:
            return model, opt, state
        return model, opt

    @staticmethod
    def _save_checkpoint(path: str, model: torch.nn.Module,
                         opt: torch.optim.Optimizer, next_epoch: int,
                         state: Optional[State] = None) -> None:
        """npz (no pickle) inside the checksummed artifact frame: the
        model's parameters, the trainer's state, each parameter's
        optimizer state by index, the epoch to resume at."""
        arrays = {f"params/{k}": v.detach().cpu().numpy()
                  for k, v in model.named_parameters()}
        for k, v in (state or {}).items():
            arrays[f"state/{k}"] = v.detach().cpu().numpy()
        for i, state in opt.state_dict()["state"].items():
            for k, v in state.items():
                arrays[f"opt/{i}/{k}"] = torch.as_tensor(v).cpu().numpy()
        arrays["epoch"] = np.asarray(next_epoch)
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        write_artifact(path, buf.getvalue())

    def _resume(self, path: Optional[str], model: torch.nn.Module,
                opt: torch.optim.Optimizer, state: Optional[State]) -> int:
        """The epoch a fit starts at: 0, or the one after the checkpoint
        at ``path``, loaded in place. Over several ranks rank 0 reads the
        file and every rank loads the bytes it copies to them, so all
        resume alike (whatever ``path`` a follower was given)."""
        group = current_group()
        blob: Optional[bytes] = None
        if (group is None or group.rank == 0) and path \
                and os.path.exists(path):
            try:
                blob = read_artifact(path)
            except ArtifactCorruptError:
                logger.warning("checkpoint %s is corrupt; restarting the "
                               "trial from scratch", path, exc_info=True)
        if group is not None:
            blob = self._broadcast_bytes(group, blob)
        if blob is None:
            return 0
        try:
            epoch = self._load_checkpoint(blob, path, model, opt, state)
        except (ArtifactCorruptError, KeyError, ValueError):
            # losing the saved epochs beats crashing the trial over a
            # damaged cache of them
            logger.warning("checkpoint %s is unreadable; restarting the "
                           "trial from scratch", path, exc_info=True)
            return 0
        logger.info("resuming fit from %s at epoch %d", path, epoch)
        return epoch

    def _broadcast_bytes(self, group, blob: Optional[bytes]
                         ) -> Optional[bytes]:
        return broadcast_bytes(group, blob, self.device)

    def _restore_checkpoint(self, path: str, model: torch.nn.Module,
                            opt: torch.optim.Optimizer,
                            state: Optional[State] = None) -> int:
        """Load the checkpoint at ``path`` into ``model``, ``opt`` and
        ``state`` (in place); returns the epoch to resume at."""
        return self._load_checkpoint(read_artifact(path), path, model, opt,
                                     state)

    def _load_checkpoint(self, blob: bytes, path: Optional[str],
                         model: torch.nn.Module, opt: torch.optim.Optimizer,
                         state: Optional[State] = None) -> int:
        """Load a checkpoint's bytes in place; returns the epoch to resume
        at. A checkpoint whose parameter or state names or shapes differ
        from the fit's was written under another program: typed
        corruption, so the fit starts fresh."""
        with np.load(io.BytesIO(blob), allow_pickle=False) as z:
            arrays = {k: z[k] for k in z.files}
        targets = {"params": dict(model.named_parameters()),
                   "state": state or {}}
        saved = {}
        for part, own in targets.items():
            saved[part] = {k[len(part) + 1:]: v for k, v in arrays.items()
                           if k.startswith(part + "/")}
            if {k: v.shape for k, v in saved[part].items()} != {
                    k: tuple(v.shape) for k, v in own.items()}:
                raise ArtifactCorruptError(
                    path, f"checkpoint {part} do not match this fit's "
                    "(written under a different program)")
        with torch.no_grad():
            for part, values in saved.items():
                for k, v in values.items():
                    targets[part][k].copy_(torch.from_numpy(v))
        opt_state: Dict[int, Dict[str, torch.Tensor]] = {}
        for k, v in arrays.items():
            if k.startswith("opt/"):
                _, i, name = k.split("/", 2)
                opt_state.setdefault(int(i), {})[name] = torch.from_numpy(v)
        opt_sd = opt.state_dict()
        opt_sd["state"] = opt_state
        opt.load_state_dict(opt_sd)  # moves the state to the params' device
        return int(arrays["epoch"])

    # -- inference --------------------------------------------------------

    def predict_buckets(self, cap: int) -> List[int]:
        """Powers of two from MIN_PREDICT_BUCKET up to ``cap``, and
        ``cap``, each rounded up to a multiple of the data-axis size."""
        buckets = []
        b = self.MIN_PREDICT_BUCKET
        while b < cap:
            buckets.append(self.round_batch(b))
            b *= 2
        buckets.append(self.round_batch(cap))
        # rounding can collapse neighbours on a wide group
        return sorted(set(buckets))

    def _bucket_for(self, n: int, cap: int) -> int:
        buckets = self.predict_buckets(cap)
        return next((b for b in buckets if b >= n), buckets[-1])

    def _bucket_chunks(self, x: np.ndarray,
                       batch_size: int) -> Iterator[Tuple[np.ndarray, int]]:
        """``(padded_chunk, pad)`` per bucket; a chunk is padded by
        repeating its last row."""
        n = len(x)
        cap = self.round_batch(max(batch_size, 1))
        i = 0
        while i < n:
            chunk = x[i: i + cap]
            pad = self._bucket_for(len(chunk), cap) - len(chunk)
            if pad:
                chunk = np.concatenate(
                    [chunk, np.repeat(chunk[-1:], pad, axis=0)])
            yield chunk, pad
            i += len(chunk) - pad

    def _serving_params(self, params: torch.nn.Module) -> Any:
        """With ``serve_int8``, the int8 copy of ``params`` that predict
        dequantizes (``quant.quantize_module``, on the module's device),
        quantized once a module object; else ``params``."""
        if not self.serve_int8:
            return params
        qp = self._qcache.get(params)
        if qp is None:
            from rafiki_tpu_torch.sdk.quant import quantize_module

            qp = quantize_module(params)
            self._qcache[params] = qp
        return qp

    def _forward(self, params: torch.nn.Module, x: torch.Tensor,
                 state: Optional[State]) -> torch.Tensor:
        """``predict_fn`` on one batch; with ``serve_int8`` over the int8
        copy, dequantized in the source dtype into the module through
        ``functional_call``."""
        args = (state, x) if self.stateful else (x,)
        if not self.serve_int8:
            return self.predict_fn(params, *args)
        from rafiki_tpu_torch.sdk.quant import dequantize_pytree

        weights = dequantize_pytree(self._serving_params(params))
        return torch.func.functional_call(
            _Predict(params, self.predict_fn),
            {"model." + k: v for k, v in weights.items()}, args)

    def _run_predict(self, params: Any, chunk: np.ndarray,
                     state: Optional[State] = None) -> np.ndarray:
        """The answer to a bucket; over several ranks each answers its
        slice and the slices are gathered in rank order."""
        group = current_group()
        chunk = chunk[self._shard(len(chunk))]
        with torch.inference_mode():
            x = torch.from_numpy(np.ascontiguousarray(chunk)).to(self.device)
            out = self._forward(params, x, state)
            if group is not None:
                out = group.all_gather(out).flatten(0, 1)
            return out.cpu().numpy()

    def predict_batched(self, params: Any, x: np.ndarray,
                        batch_size: int = 256,
                        state: Optional[State] = None) -> np.ndarray:
        """Run ``predict_fn(params, batch)`` (``predict_fn(params, state,
        batch)`` when stateful) over ``x`` in padded buckets, under
        ``torch.inference_mode``; the padding rows are dropped from the
        result."""
        outs = []
        for chunk, pad in self._bucket_chunks(x, batch_size):
            out = self._run_predict(params, chunk, state)
            outs.append(out[: len(out) - pad] if pad else out)
        return np.concatenate(outs) if outs else np.zeros((0,))

    def warm_predict(self, params: Any, example: np.ndarray,
                     batch_size: int = 256,
                     state: Optional[State] = None) -> int:
        """Run every bucket once on copies of ``example`` (one query), so
        kernels are built and loaded before real traffic. Returns the
        number of buckets warmed."""
        example = np.asarray(example)
        buckets = self.predict_buckets(self.round_batch(max(batch_size, 1)))
        for b in buckets:
            self._run_predict(
                params, np.broadcast_to(example[None], (b,) + example.shape),
                state)
        return len(buckets)

    # -- fused ensemble serving -------------------------------------------

    def stack_ensemble_params(self, params_list: List[torch.nn.Module]
                              ) -> "StackedModels":
        """N models of one architecture as one stacked ensemble on the
        trainer's device: every parameter and buffer stacked along a new
        leading axis (the co-resident ensemble's device layout), the first
        model as the structure :func:`torch.func.functional_call` runs.
        With ``serve_int8`` each model is quantized on its own (its own
        scales and pass-through gates, as it serves alone) and the int8
        values and scales are stacked; each vmap instance dequantizes
        its own."""
        quantized = None
        if self.serve_int8:
            from rafiki_tpu_torch.sdk.quant import quantize_module

            quantized = [quantize_module(m) for m in params_list]
        return StackedModels(params_list, self.device, quantized)

    def _run_predict_stacked(self, stacked: "StackedModels",
                             chunk: np.ndarray) -> np.ndarray:
        """(n_models, len(chunk), ...) for one bucket, every model in ONE
        vmapped forward; over several ranks each answers its slice of the
        bucket for every model, and the slices are gathered in rank
        order."""
        group = current_group()
        chunk = chunk[self._shard(len(chunk))]
        with torch.inference_mode():
            x = torch.from_numpy(np.ascontiguousarray(chunk)).to(self.device)
            out = stacked.forward(self.predict_fn, x)
            if group is not None:
                # (ranks, models, rows, ...) -> (models, ranks * rows, ...)
                out = group.all_gather(out).transpose(0, 1).flatten(1, 2)
            return out.cpu().numpy()

    def predict_batched_stacked(self, stacked: "StackedModels",
                                x: np.ndarray,
                                batch_size: int = 256) -> np.ndarray:
        """``predict_batched`` for a fused ensemble: ``(n_models, len(x),
        ...)``, one vmapped forward a padded bucket, on the same bucket
        ladder."""
        if self.stateful or self.predict_fn is None:
            raise ValueError("fused ensemble serving takes a stateless "
                             "trainer with a predict_fn")
        outs = []
        for chunk, pad in self._bucket_chunks(x, batch_size):
            out = self._run_predict_stacked(stacked, chunk)
            outs.append(out[:, : out.shape[1] - pad] if pad else out)
        if not outs:
            return np.zeros((stacked.n_models, 0))
        return np.concatenate(outs, axis=1)

    def warm_predict_stacked(self, stacked: "StackedModels",
                             example: np.ndarray,
                             batch_size: int = 256) -> int:
        """``warm_predict`` for the fused ensemble: every bucket once."""
        example = np.asarray(example)
        buckets = self.predict_buckets(self.round_batch(max(batch_size, 1)))
        for b in buckets:
            self._run_predict_stacked(
                stacked,
                np.broadcast_to(example[None], (b,) + example.shape))
        return len(buckets)


class _Predict(torch.nn.Module):
    """``predict_fn(model, x)`` as a module's forward, so that
    :func:`torch.func.functional_call` can run it over another model's
    parameters."""

    def __init__(self, model: torch.nn.Module, predict_fn: Callable):
        super().__init__()
        self.model = model
        self.predict_fn = predict_fn

    def forward(self, *args: Any) -> torch.Tensor:
        return self.predict_fn(self.model, *args)


class StackedModels:
    """The counterpart of the JAX package's stacked parameter tree: N
    models of one architecture, their parameters and buffers stacked on a
    leading axis on one device, answered by ``torch.func.vmap`` of
    ``functional_call`` over that axis, the counterpart of
    ``jax.vmap(predict_fn, in_axes=(0, None))``. The attention of a
    transformer inside runs K1 once a layer over every model's rows (the
    kernel's vmap rule, ``ops/flash_attention.py``); the other products are
    batched products. A parameter may be an int8 leaf (``{"q", "scale"}``
    stacked; ``sdk/quant.py``), dequantized by each vmap instance. A
    population (``sdk/population.py``) trains ``params`` in place."""

    def __init__(self, models: List[torch.nn.Module], device,
                 quantized: Optional[List[Dict[str, Any]]] = None):
        self.n_models = len(models)

        def stacked(named):
            # "model.": the parameters' names inside _Predict
            out = {}
            for k, first in named[0].items():
                if isinstance(first, dict):  # an int8 leaf
                    out["model." + k] = {part: torch.stack([
                        t[k][part].to(device) for t in named])
                        for part in first}
                else:
                    out["model." + k] = torch.stack([
                        t[k].detach().to(device) for t in named])
            return out

        with torch.no_grad():
            self.params = stacked(quantized or [dict(m.named_parameters())
                                                for m in models])
            self.buffers = stacked([dict(m.named_buffers())
                                    for m in models])
        self._structure = models[0]

    def forward(self, predict_fn: Callable, x: torch.Tensor) -> torch.Tensor:
        """(n_models, B, ...): ``predict_fn(model_i, x)`` for every i."""
        from rafiki_tpu_torch.sdk.quant import dequantize_pytree

        wrapper = _Predict(self._structure, predict_fn)

        def one(params, buffers, x):
            return torch.func.functional_call(
                wrapper, (dequantize_pytree(params), buffers), (x,))

        return torch.func.vmap(one, in_dims=(0, 0, None))(
            self.params, self.buffers, x)


def trainer_ensemble_stack(models: list, example: np.ndarray,
                           to_predictions: Optional[Callable] = None,
                           to_batch: Optional[Callable] = None):
    """``BaseModel.ensemble_stack`` for templates on
    :class:`DataParallelTrainer` (a template's ``_trainer``, and its
    trained module in ``_model``): the co-served group ``models`` fused
    into one vmapped predict over stacked parameters, or None when they
    cannot share one. Fusion needs every model on the SAME trainer
    instance (the ``cached_trainer`` entry: one template, one
    architecture), a stateless trainer with a predict_fn (a BatchNorm
    trainer is stateful: None), and parameters of equal names and shapes.
    ``example`` is one query for the warm-up; ``to_predictions(out)``
    turns one model's output batch into its answers (default: a list a
    row); ``to_batch(queries)`` turns queries into the batch (default:
    ``np.asarray(queries, np.float32)``; a text template passes its
    tokenizer). Once the stack exists each model's own parameters move to
    the host: the stack is the device's copy."""
    first = models[0]
    trainer = getattr(first, "_trainer", None)
    if trainer is None or getattr(first, "_model", None) is None:
        return None
    if trainer.stateful or trainer.predict_fn is None:
        return None
    if any(getattr(m, "_trainer", None) is not trainer for m in models):
        return None
    shapes = [{k: tuple(v.shape) for k, v in
               [*m._model.named_parameters(), *m._model.named_buffers()]}
              for m in models]
    if any(s != shapes[0] for s in shapes[1:]):
        return None
    stacked = trainer.stack_ensemble_params([m._model for m in models])
    for m in models:
        m._model.to("cpu")
    example = np.asarray(example)
    convert = to_predictions or (lambda out: [row.tolist() for row in out])
    batchify = to_batch or (
        lambda queries: np.asarray(queries, dtype=np.float32))

    class _Fused:
        n_models = len(models)

        @staticmethod
        def predict_all(queries):
            out = trainer.predict_batched_stacked(
                stacked, batchify(queries),
                batch_size=config.PREDICT_MAX_BATCH_SIZE)
            return [convert(per_model) for per_model in out]

        @staticmethod
        def warm_up():
            trainer.warm_predict_stacked(
                stacked, example, batch_size=config.PREDICT_MAX_BATCH_SIZE)

    return _Fused()


def softmax_classifier_loss(apply_fn: Callable[..., torch.Tensor]) -> LossFn:
    """Cross-entropy for an ``apply_fn(model, x) -> logits`` classifier;
    batch = (x, labels)."""

    def loss_fn(model, batch):
        x, y = batch
        logits = apply_fn(model, x).float()
        loss = F.cross_entropy(logits, y.long())
        acc = (logits.argmax(-1) == y).float().mean()
        return loss, {"acc": acc}

    return loss_fn


def classification_accuracy(trainer: DataParallelTrainer, params: Any,
                            x: np.ndarray, y: np.ndarray) -> float:
    logits = trainer.predict_batched(params, x)
    return float((np.argmax(logits, -1) == np.asarray(y)).mean())
