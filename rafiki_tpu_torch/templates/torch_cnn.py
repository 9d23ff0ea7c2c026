"""TorchCnn: a small convolutional image classifier.

The twin of ``examples/models/image_classification/JaxCnn.py``: a 3x3
stem, then ``num_stages`` stages of two 3x3 relu convolutions closed by a
2x2 mean pool, a global average pool and a dense head; the same knobs
(epochs, stages, base channels, learning rate, batch size, image size);
AdamW with optax.adamw's defaults (``weight_decay=1e-4``).
``dump_parameters`` hands back the JAX-layout tree. The vectorized
population path of ``JaxCnn`` (``train_population``) waits (ROADMAP.md).
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from rafiki_tpu_torch import config
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
from rafiki_tpu_torch.sdk.torch_backend import (
    DataParallelTrainer,
    cached_trainer,
    classification_accuracy,
    softmax_classifier_loss,
    tunable_optimizer,
)


def _widths(stages: int, base: int):
    """(name, cin, cout) of every stage convolution."""
    cin = base
    for s in range(stages):
        cout = base * (2 ** s)
        yield f"conv{s}a", cin, cout
        yield f"conv{s}b", cout, cout
        cin = cout


def init_params(rng: np.random.Generator, stages: int, base: int,
                channels_in: int, num_classes: int) -> dict:
    """A parameter tree in the layout of ``JaxCnn``'s, numpy f32."""
    params = {"stem": core.conv2d_init(rng, 3, 3, channels_in, base)}
    for name, cin, cout in _widths(stages, base):
        params[name] = core.conv2d_init(rng, 3, 3, cin, cout)
    params["head"] = core.dense_init(rng, base * 2 ** (stages - 1),
                                     num_classes)
    return params


class Cnn(torch.nn.Module):
    """Conv -> [Conv-Conv-pool] x stages -> GAP -> Dense."""

    def __init__(self, stages: int, base: int, channels_in: int,
                 num_classes: int, device=None):
        super().__init__()
        self.stages = stages
        self.stem = core.Conv2d(3, 3, channels_in, base, device)
        for name, cin, cout in _widths(stages, base):
            self.add_module(name, core.Conv2d(3, 3, cin, cout, device))
        self.head = core.Dense(base * 2 ** (stages - 1), num_classes,
                               device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.stem(core.cast_for_compute(x)))
        for s in range(self.stages):
            x = torch.relu(getattr(self, f"conv{s}a")(x))
            x = torch.relu(getattr(self, f"conv{s}b")(x))
            x = core.mean_pool(x, 2, 2)
        x = x.mean(dim=(1, 2))  # global average pool
        return self.head(x).float()


def _logits(model, x):
    return model(x)


def _probs(model, x):
    return torch.softmax(model(x), dim=-1)


class TorchCnn(BaseModel):
    @staticmethod
    def get_knob_config():
        return {
            "epochs": IntegerKnob(1, 5),
            "num_stages": IntegerKnob(1, 3),
            "base_channels": CategoricalKnob([16, 32, 64]),
            "learning_rate": FloatKnob(1e-4, 1e-1, is_exp=True),
            "batch_size": CategoricalKnob([64, 128, 256]),
            "image_size": FixedKnob(32),
        }

    def __init__(self, **knobs: Any):
        super().__init__(**knobs)
        self._model = None
        self._trainer = None
        self._num_classes = None

    def _build_trainer(self) -> DataParallelTrainer:
        key = ("TorchCnn", self._knobs["num_stages"],
               self._knobs["base_channels"], self._knobs["image_size"])
        return cached_trainer(key, lambda: DataParallelTrainer(
            softmax_classifier_loss(_logits),
            tunable_optimizer(torch.optim.AdamW, betas=(0.9, 0.999),
                              eps=1e-8, weight_decay=1e-4),
            predict_fn=_probs))

    def _load(self, dataset_uri: str):
        size = self._knobs["image_size"]
        return dataset_utils.load_image_arrays(dataset_uri,
                                               image_size=(size, size))

    def _build(self, params, device=None, train=False):
        channels_in = int(np.shape(params["stem"]["kernel"])[2])
        with torch.device("meta"):
            model = Cnn(self._knobs["num_stages"],
                        self._knobs["base_channels"], channels_in,
                        self._num_classes)
        return from_jax_tree(model, params, None, device, train)

    def train(self, dataset_uri: str) -> None:
        x, y = self._load(dataset_uri)
        self._num_classes = int(y.max()) + 1
        self._trainer = self._build_trainer()
        model, opt = self._trainer.init(
            lambda rng: self._build(
                init_params(rng, self._knobs["num_stages"],
                            self._knobs["base_channels"], x.shape[-1],
                            self._num_classes),
                self._trainer.device, train=True),
            hyperparams={"lr": self._knobs["learning_rate"]})
        self.logger.define_plot("Loss over epochs", ["loss"], x_axis="epoch")
        self._model, _ = self._trainer.fit(
            model, opt, (x, y),
            epochs=self._knobs["epochs"],
            batch_size=self._knobs["batch_size"],
            log=self.logger.log,
            checkpoint_path=self.checkpoint_path)
        self._model.eval()

    def evaluate(self, dataset_uri: str) -> float:
        x, y = self._load(dataset_uri)
        return classification_accuracy(self._trainer, self._model, x, y)

    def predict(self, queries: List[Any]) -> List[Any]:
        x = np.asarray(queries, dtype=np.float32)
        probs = self._trainer.predict_batched(
            self._model, x, batch_size=config.PREDICT_MAX_BATCH_SIZE)
        return [p.tolist() for p in probs]

    def warm_up(self) -> None:
        size = self._knobs["image_size"]
        channels = self._model.stem.kernel.shape[1]
        self._trainer.warm_predict(
            self._model, np.zeros((size, size, channels), np.float32),
            batch_size=config.PREDICT_MAX_BATCH_SIZE)

    def dump_parameters(self) -> Dict[str, Any]:
        return {"params": to_jax_tree(self._model)[0],
                "num_classes": self._num_classes}

    def load_parameters(self, params: Dict[str, Any]) -> None:
        self._num_classes = params["num_classes"]
        if self._trainer is None:
            self._trainer = self._build_trainer()
        self._model = self._build(params["params"], self._trainer.device)
