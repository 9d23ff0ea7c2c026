"""TorchFeedForward: a dense feed-forward image classifier.

The twin of ``examples/models/image_classification/JaxFeedForward.py``:
the same knobs (epochs, hidden layer count and width, learning rate,
batch size, image size), the MLP of ``rafiki_tpu_torch.models.feedforward``
over each image flattened in its NHWC order, trained with Adam (optax.adam's
defaults) through ``DataParallelTrainer``. ``dump_parameters`` hands back
the JAX-layout tree and the config.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import numpy as np
import torch

from rafiki_tpu_torch import config
from rafiki_tpu_torch.convert import from_jax_tree, to_jax_tree
from rafiki_tpu_torch.models import feedforward
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


def _logits(model, x):
    return model(x)


def _probs(model, x):
    return torch.softmax(model(x), dim=-1)


class TorchFeedForward(BaseModel):
    @staticmethod
    def get_knob_config():
        return {
            "epochs": FixedKnob(2),
            "hidden_layer_count": IntegerKnob(1, 2),
            "hidden_layer_units": IntegerKnob(2, 128),
            "learning_rate": FloatKnob(1e-5, 1e-1, is_exp=True),
            "batch_size": CategoricalKnob([16, 32, 64, 128]),
            "image_size": FixedKnob(32),
        }

    def __init__(self, **knobs: Any):
        super().__init__(**knobs)
        self._model = None
        self._trainer = None
        self._cfg = None

    def _build_trainer(self) -> DataParallelTrainer:
        return cached_trainer(("TorchFeedForward", self._cfg),
                              lambda: DataParallelTrainer(
            softmax_classifier_loss(_logits),
            tunable_optimizer(torch.optim.Adam, betas=(0.9, 0.999),
                              eps=1e-8),
            predict_fn=_probs))

    def _load(self, dataset_uri: str):
        size = self._knobs["image_size"]
        return dataset_utils.load_image_arrays(dataset_uri,
                                               image_size=(size, size))

    def _build(self, params, device=None, train=False):
        with torch.device("meta"):
            model = feedforward.FeedForward(self._cfg)
        return from_jax_tree(model, params, None, device, train)

    def train(self, dataset_uri: str) -> None:
        x, y = self._load(dataset_uri)
        self._cfg = feedforward.FeedForwardConfig(
            in_dim=int(np.prod(x.shape[1:])),
            hidden_layers=self._knobs["hidden_layer_count"],
            hidden_units=self._knobs["hidden_layer_units"],
            num_classes=int(y.max()) + 1)
        self._trainer = self._build_trainer()
        model, opt = self._trainer.init(
            lambda rng: self._build(feedforward.init(rng, self._cfg),
                                    self._trainer.device, train=True),
            hyperparams={"lr": self._knobs["learning_rate"]})
        self.logger.define_plot("Loss over epochs", ["loss"], x_axis="epoch")
        self._model, _ = self._trainer.fit(
            model, opt, (x, y),
            epochs=self._knobs["epochs"],
            batch_size=self._knobs["batch_size"],
            log=self.logger.log)
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
        channels = self._cfg.in_dim // (size * size)
        self._trainer.warm_predict(
            self._model, np.zeros((size, size, channels), np.float32),
            batch_size=config.PREDICT_MAX_BATCH_SIZE)

    def dump_parameters(self) -> Dict[str, Any]:
        return {"params": to_jax_tree(self._model)[0],
                "cfg": dataclasses.asdict(self._cfg)}

    def load_parameters(self, params: Dict[str, Any]) -> None:
        self._cfg = feedforward.FeedForwardConfig(**params["cfg"])
        if self._trainer is None:
            self._trainer = self._build_trainer()
        self._model = self._build(params["params"], self._trainer.device)
