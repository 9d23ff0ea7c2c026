"""TorchVgg16: a VGG-style convnet image classifier.

The twin of ``examples/models/image_classification/JaxVgg16.py``: a
``depth`` knob picks the trimmed small-input plan or the full 16-layer
plan of ``rafiki_tpu_torch.models.vgg``; epochs, learning rate and batch
size as there; Adam with optax.adam's defaults. ``dump_parameters`` hands
back the JAX-layout tree.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from rafiki_tpu_torch import config
from rafiki_tpu_torch.convert import from_jax_tree, to_jax_tree
from rafiki_tpu_torch.models import vgg
from rafiki_tpu_torch.sdk.dataset import dataset_utils
from rafiki_tpu_torch.sdk.knob import CategoricalKnob, FixedKnob, FloatKnob
from rafiki_tpu_torch.sdk.model import BaseModel
from rafiki_tpu_torch.sdk.torch_backend import (
    DataParallelTrainer,
    cached_trainer,
    classification_accuracy,
    softmax_classifier_loss,
    trainer_ensemble_stack,
    tunable_optimizer,
)


def _logits(model, x):
    return model(x)


def _probs(model, x):
    return torch.softmax(model(x), dim=-1)


class TorchVgg16(BaseModel):
    @staticmethod
    def get_knob_config():
        return {
            "epochs": FixedKnob(2),
            "learning_rate": FloatKnob(1e-5, 1e-2, is_exp=True),
            "batch_size": CategoricalKnob([16, 32, 64, 128]),
            "depth": CategoricalKnob(["small", "vgg16"]),
            "image_size": FixedKnob(32),
        }

    def __init__(self, **knobs: Any):
        super().__init__(**knobs)
        self._model = None
        self._trainer = None
        self._cfg = None

    def _build_trainer(self) -> DataParallelTrainer:
        return cached_trainer(("TorchVgg16", self._cfg),
                              lambda: DataParallelTrainer(
            softmax_classifier_loss(_logits),
            tunable_optimizer(torch.optim.Adam, betas=(0.9, 0.999),
                              eps=1e-8),
            predict_fn=_probs))

    def _make_cfg(self, channels: int, num_classes: int) -> vgg.VggConfig:
        plan = (vgg.VGG16_PLAN if self._knobs["depth"] == "vgg16"
                else vgg.VGG_SMALL_PLAN)
        return vgg.VggConfig(plan=plan, channels=channels,
                             num_classes=num_classes)

    def _load(self, dataset_uri: str):
        size = self._knobs["image_size"]
        return dataset_utils.load_image_arrays(dataset_uri,
                                               image_size=(size, size))

    def _build(self, params, device=None, train=False):
        with torch.device("meta"):
            model = vgg.Vgg(self._cfg)
        return from_jax_tree(model, params, None, device, train)

    def train(self, dataset_uri: str) -> None:
        x, y = self._load(dataset_uri)
        self._cfg = self._make_cfg(x.shape[-1], int(y.max()) + 1)
        self._trainer = self._build_trainer()
        model, opt = self._trainer.init(
            lambda rng: self._build(vgg.init(rng, self._cfg),
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
        self._trainer.warm_predict(
            self._model, np.zeros((size, size, self._cfg.channels),
                                  np.float32),
            batch_size=config.PREDICT_MAX_BATCH_SIZE)

    def ensemble_stack(self, models):
        # fused-ensemble serving (budget ENSEMBLE_FUSED)
        if self._model is None or self._cfg is None:
            return None
        size = self._knobs["image_size"]
        return trainer_ensemble_stack(
            models, np.zeros((size, size, self._cfg.channels), np.float32))

    def dump_parameters(self) -> Dict[str, Any]:
        return {"params": to_jax_tree(self._model)[0],
                "channels": self._cfg.channels,
                "num_classes": self._cfg.num_classes,
                "depth": self._knobs["depth"]}

    def load_parameters(self, params: Dict[str, Any]) -> None:
        self._knobs["depth"] = params["depth"]
        self._cfg = self._make_cfg(params["channels"], params["num_classes"])
        if self._trainer is None:
            self._trainer = self._build_trainer()
        self._model = self._build(params["params"], self._trainer.device)
