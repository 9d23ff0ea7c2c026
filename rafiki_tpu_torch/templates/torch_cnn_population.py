"""TorchCnnPopulation: one trial trains a population of learning rates at
once and keeps its best member.

The twin of ``examples/models/image_classification/JaxCnnPopulation.py``:
a 3x3 stem, a 3x3 stride-2 convolution, a global average pool and a dense
head, trained as a population of ``population_size`` learning rates
spaced geometrically between the ``lr_min`` and ``lr_max`` knobs, inside
one trial (``sdk/population.PopulationTrainer``: one vectorized program,
AdamW with optax.adamw's defaults). The winner is the member with the
best accuracy on a held-out eighth of the training set, taken from a
seeded shuffle of it (and kept on the cached trainer, so the trials of a
job see the same split arrays); the trial's log names the winning member,
and the trial serves it. ``dump_parameters`` hands back the winner's
JAX-layout tree and its learning rate.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from rafiki_tpu_torch.convert import from_jax_tree, to_jax_tree
from rafiki_tpu_torch.models import core
from rafiki_tpu_torch.sdk.dataset import dataset_utils
from rafiki_tpu_torch.sdk.knob import (
    CategoricalKnob,
    FixedKnob,
    FloatKnob,
    IntegerKnob,
)
from rafiki_tpu_torch.sdk.model import BaseModel
from rafiki_tpu_torch.sdk.population import PopulationTrainer
from rafiki_tpu_torch.sdk.torch_backend import (
    cached_trainer,
    softmax_classifier_loss,
    tunable_optimizer,
)

#: rows a predict call runs at once
CHUNK = 256


def init_params(rng: np.random.Generator, base: int, channels_in: int,
                num_classes: int) -> dict:
    """A parameter tree in the layout of ``JaxCnnPopulation``'s, numpy
    f32."""
    return {"stem": core.conv2d_init(rng, 3, 3, channels_in, base),
            "conv": core.conv2d_init(rng, 3, 3, base, 2 * base),
            "head": core.dense_init(rng, 2 * base, num_classes)}


class PopCnn(torch.nn.Module):
    """Stem conv -> stride-2 conv -> GAP -> Dense."""

    def __init__(self, base: int, channels_in: int, num_classes: int,
                 device=None):
        super().__init__()
        self.stem = core.Conv2d(3, 3, channels_in, base, device)
        self.conv = core.Conv2d(3, 3, base, 2 * base, device)
        self.head = core.Dense(2 * base, num_classes, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.stem(core.cast_for_compute(x)))
        x = torch.relu(self.conv(x, stride=2))
        x = x.mean(dim=(1, 2))  # global average pool
        return self.head(x).float()


def _logits(model, x):
    return model(x)


def _probs(model, x):
    return torch.softmax(model(x), dim=-1)


class TorchCnnPopulation(BaseModel):
    @staticmethod
    def get_knob_config():
        return {
            "epochs": IntegerKnob(1, 4),
            "base_channels": CategoricalKnob([16, 32]),
            "lr_min": FloatKnob(1e-4, 1e-3, is_exp=True),
            "lr_max": FloatKnob(1e-2, 1e-1, is_exp=True),
            "population_size": CategoricalKnob([4, 8]),
            "batch_size": CategoricalKnob([128, 256]),
            "image_size": FixedKnob(32),
        }

    def __init__(self, **knobs: Any):
        super().__init__(**knobs)
        self._model = None  # the winning member
        self._trainer = None
        self._best_lr = None

    def _build_trainer(self) -> PopulationTrainer:
        key = ("TorchCnnPopulation", self._knobs["base_channels"],
               self._knobs["population_size"], self._knobs["image_size"])
        return cached_trainer(key, lambda: PopulationTrainer(
            softmax_classifier_loss(_logits),
            tunable_optimizer(torch.optim.AdamW, lr=1e-3,
                              betas=(0.9, 0.999), eps=1e-8,
                              weight_decay=1e-4),
            predict_fn=_probs))

    def _load(self, dataset_uri: str):
        size = self._knobs["image_size"]
        return dataset_utils.load_image_arrays(dataset_uri,
                                               image_size=(size, size))

    def _build(self, params, device=None, train=False):
        channels_in = int(np.shape(params["stem"]["kernel"])[2])
        num_classes = int(np.shape(params["head"]["kernel"])[1])
        with torch.device("meta"):
            model = PopCnn(self._knobs["base_channels"], channels_in,
                           num_classes)
        return from_jax_tree(model, params, None, device, train)

    def _split(self, x: np.ndarray, y: np.ndarray) -> tuple:
        """(x_train, y_train, x_val, y_val): the last eighth of a seeded
        shuffle held out (a dataset may come sorted by class), memoized on
        the cached trainer with the arrays it was made from, so the next
        trial passes the same arrays to fit (its device cache keys on
        them)."""
        cached = getattr(self._trainer, "_split_cache", None)
        if cached is not None and cached[0] is x and cached[1] is y:
            return cached[2]
        perm = np.random.default_rng(0).permutation(len(x))
        xs, ys = x[perm], y[perm]
        n_val = max(len(xs) // 8, 1)
        split = (xs[:-n_val], ys[:-n_val], xs[-n_val:], ys[-n_val:])
        self._trainer._split_cache = (x, y, split)
        return split

    def train(self, dataset_uri: str) -> None:
        x, y = self._load(dataset_uri)
        num_classes = int(y.max()) + 1
        k = int(self._knobs["population_size"])
        lo, hi = float(self._knobs["lr_min"]), float(self._knobs["lr_max"])
        lrs = np.geomspace(min(lo, hi), max(lo, hi), k).tolist()
        self._trainer = self._build_trainer()
        x_tr, y_tr, x_val, y_val = self._split(x, y)
        base = self._knobs["base_channels"]
        params, opt = self._trainer.init(
            lambda rng: self._build(
                init_params(rng, base, x.shape[-1], num_classes),
                self._trainer.device, train=True),
            {"lr": lrs})
        self.logger.define_plot("Population loss", ["loss"], x_axis="epoch")
        params, _ = self._trainer.fit(
            params, opt, (x_tr, y_tr),
            epochs=self._knobs["epochs"],
            batch_size=self._knobs["batch_size"],
            log=self.logger.log,
            checkpoint_path=self.checkpoint_path)
        scores = self._trainer.member_scores(params, x_val, y_val)
        best = int(np.argmax(scores))
        self._best_lr = lrs[best]
        self._model = self._trainer.member_params(params, best)
        self.logger.log(
            f"population winner: member {best} (lr={lrs[best]:.2e})",
            best_member=float(best), best_val_accuracy=float(scores[best]))

    def _predict_probs(self, x: np.ndarray) -> np.ndarray:
        device = next(self._model.parameters()).device
        out = []
        with torch.inference_mode():
            for i in range(0, len(x), CHUNK):
                chunk = torch.from_numpy(
                    np.ascontiguousarray(x[i:i + CHUNK], np.float32))
                out.append(_probs(self._model, chunk.to(device))
                           .cpu().numpy())
        return np.concatenate(out) if out else np.zeros((0,))

    def evaluate(self, dataset_uri: str) -> float:
        x, y = self._load(dataset_uri)
        probs = self._predict_probs(x)
        return float((np.argmax(probs, axis=-1) == y).sum()) / float(len(x))

    def predict(self, queries: List[Any]) -> List[Any]:
        probs = self._predict_probs(np.asarray(queries, np.float32))
        return [p.tolist() for p in probs]

    def dump_parameters(self) -> Dict[str, Any]:
        return {"params": to_jax_tree(self._model)[0],
                "best_lr": float(self._best_lr or 0.0)}

    def load_parameters(self, params: Dict[str, Any]) -> None:
        self._best_lr = float(params.get("best_lr", 0.0))
        self._model = self._build(params["params"])
