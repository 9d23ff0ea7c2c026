"""Training and batched prediction for model templates.

Counterpart of ``rafiki_tpu/sdk/jax_backend.py``: ``DataParallelTrainer``
(``init``, ``fit`` with mid-trial checkpoints, the stateful variant, the
padded predict-bucket ladder, ``predict_batched``, ``warm_predict``),
``cached_trainer`` and ``trainer_cache_clear``, ``tunable_optimizer`` and
``set_opt_hyperparams``, ``shuffled_batches``,
``softmax_classifier_loss`` and ``classification_accuracy``. The class
keeps its name; one device per trainer in this slice (multi-GPU:
ROADMAP.md), so ``n_data`` is 1 and the JAX package's mesh rounding is the
identity.

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
from typing import (Any, Callable, Dict, Hashable, Iterator, List, Optional,
                    Tuple)

import numpy as np
import torch
import torch.nn.functional as F

from rafiki_tpu_torch.device import default_device, visible_devices
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


class DataParallelTrainer:
    # padding 1 query to 8 wastes little, and bounds the shapes served
    MIN_PREDICT_BUCKET = 8

    def __init__(self, loss_fn: Optional[LossFn] = None,
                 optimizer: Optional[OptimizerFactory] = None,
                 predict_fn: Optional[Callable[..., torch.Tensor]] = None,
                 device=None, stateful: bool = False):
        """``loss_fn`` and ``optimizer`` are needed to train, ``predict_fn``
        to predict; ``device`` defaults to :func:`default_device`.
        ``stateful`` threads a state the optimizer never sees through
        training and prediction (see the module docstring)."""
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.predict_fn = predict_fn
        self.stateful = stateful
        self.device = default_device(device)
        self.n_data = 1  # devices on the data axis
        # (ids of the host arrays, the host arrays, their device copies):
        # the trials of one job fit the same arrays (dataset_utils caches
        # them); holding the host arrays keeps their ids from being reused
        self._fit_data_cache: Optional[tuple] = None

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
        if self.stateful:
            loss, (_, new_state) = self.loss_fn(model, state, batch)
        else:
            loss, _ = self.loss_fn(model, batch)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if self.stateful:
            with torch.no_grad():
                for k, v in new_state.items():
                    state[k].copy_(v)
        return loss.detach()

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
        # the largest multiple of the data-axis size that fits the dataset
        fit_cap = (n // self.n_data) * self.n_data
        batch_size = min(batch_size, fit_cap or self.n_data)
        start_epoch = 0
        if checkpoint_path and os.path.exists(checkpoint_path):
            try:
                start_epoch = self._restore_checkpoint(checkpoint_path,
                                                       model, opt, state)
                logger.info("resuming fit from %s at epoch %d",
                            checkpoint_path, start_epoch)
            except (ArtifactCorruptError, KeyError, ValueError):
                # losing the saved epochs beats crashing the trial over a
                # damaged cache of them
                logger.warning("checkpoint %s is corrupt or unreadable; "
                               "restarting the trial from scratch",
                               checkpoint_path, exc_info=True)
                start_epoch = 0
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
                idx = torch.as_tensor(idx, device=self.device)
                losses.append(self.train_step(
                    model, opt, tuple(d[idx] for d in data_dev), state))
            stop_early = False
            if losses and log is not None:
                try:
                    log(loss=float(torch.stack(losses).mean()),
                        epoch=float(epoch), epoch_time=time.time() - t0,
                        **upload)
                except StopTrialEarly:
                    logger.info("early stop after epoch %d", epoch)
                    stop_early = True
            if checkpoint_path and (
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

    def _restore_checkpoint(self, path: str, model: torch.nn.Module,
                            opt: torch.optim.Optimizer,
                            state: Optional[State] = None) -> int:
        """Load a checkpoint into ``model``, ``opt`` and ``state`` (in
        place); returns the epoch to resume at. A checkpoint whose
        parameter or state names or shapes differ from the fit's was
        written under another program: typed corruption, so the fit
        starts fresh."""
        with np.load(io.BytesIO(read_artifact(path)),
                     allow_pickle=False) as z:
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
        """Powers of two from MIN_PREDICT_BUCKET up to ``cap``, and ``cap``."""
        buckets = []
        b = self.MIN_PREDICT_BUCKET
        while b < cap:
            buckets.append(b)
            b *= 2
        buckets.append(cap)
        return sorted(set(buckets))

    def _bucket_for(self, n: int, cap: int) -> int:
        buckets = self.predict_buckets(cap)
        return next((b for b in buckets if b >= n), buckets[-1])

    def _bucket_chunks(self, x: np.ndarray,
                       batch_size: int) -> Iterator[Tuple[np.ndarray, int]]:
        """``(padded_chunk, pad)`` per bucket; a chunk is padded by
        repeating its last row."""
        n = len(x)
        cap = max(batch_size, 1)
        i = 0
        while i < n:
            chunk = x[i: i + cap]
            pad = self._bucket_for(len(chunk), cap) - len(chunk)
            if pad:
                chunk = np.concatenate(
                    [chunk, np.repeat(chunk[-1:], pad, axis=0)])
            yield chunk, pad
            i += len(chunk) - pad

    def _run_predict(self, params: Any, chunk: np.ndarray,
                     state: Optional[State] = None) -> np.ndarray:
        with torch.inference_mode():
            x = torch.from_numpy(np.ascontiguousarray(chunk)).to(self.device)
            if self.stateful:
                return self.predict_fn(params, state, x).cpu().numpy()
            return self.predict_fn(params, x).cpu().numpy()

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
        buckets = self.predict_buckets(max(batch_size, 1))
        for b in buckets:
            self._run_predict(
                params, np.broadcast_to(example[None], (b,) + example.shape),
                state)
        return len(buckets)


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
