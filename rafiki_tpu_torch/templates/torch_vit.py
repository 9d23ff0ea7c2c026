"""TorchViT: a model template that trains and serves a Vision Transformer.

Written as a user's template is, in the shape of the JAX examples'
``JaxBert``: it subclasses the port's ``BaseModel``, takes its
architecture from fixed knobs (ViT-B/16 at 224 px with ImageNet's 1000
classes) and tunes the learning rate and batch size. ``train`` fits the
model with ``DataParallelTrainer`` (AdamW with optax.adamw's defaults)
on an image dataset (``.npz`` or image zip); ``evaluate`` scores its
accuracy; ``dump_parameters`` hands back the parameter tree in the JAX
layout; and ``predict`` answers each query (an (H, W, C) float image)
with its softmax class probabilities.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from rafiki_tpu_torch import config
from rafiki_tpu_torch.convert import from_jax_params, to_jax_params
from rafiki_tpu_torch.models import vit
from rafiki_tpu_torch.models.transformer import TransformerConfig
from rafiki_tpu_torch.sdk.dataset import dataset_utils
from rafiki_tpu_torch.sdk.knob import CategoricalKnob, FixedKnob, FloatKnob
from rafiki_tpu_torch.sdk.model import BaseModel
from rafiki_tpu_torch.sdk.torch_backend import (
    DataParallelTrainer,
    classification_accuracy,
    softmax_classifier_loss,
    tunable_optimizer,
)


def _logits(model, x):
    return model(x)


def _probs(model, x):
    return torch.softmax(model(x), dim=-1)


class TorchViT(BaseModel):
    @staticmethod
    def get_knob_config():
        return {
            # the architecture: ViT-B/16 at 224 px over ImageNet's classes
            "image_size": FixedKnob(224),
            "patch_size": FixedKnob(16),
            "dim": FixedKnob(768),
            "depth": FixedKnob(12),
            "heads": FixedKnob(12),
            "num_classes": FixedKnob(1000),
            # ordinary hyperparameters
            "learning_rate": FloatKnob(1e-5, 1e-3, is_exp=True),
            "batch_size": CategoricalKnob([64, 128]),
            "epochs": FixedKnob(1),
        }

    def __init__(self, **knobs: Any):
        super().__init__(**knobs)
        self._model = None
        self._trainer = None

    def _cfg(self) -> vit.ViTConfig:
        k = self._knobs
        return vit.ViTConfig(
            image_size=k["image_size"], patch_size=k["patch_size"],
            num_classes=k["num_classes"],
            encoder=TransformerConfig(dim=k["dim"], depth=k["depth"],
                                      heads=k["heads"]))

    def train(self, dataset_uri: str) -> None:
        x, y = dataset_utils.load_image_arrays(dataset_uri)
        cfg = self._cfg()
        self._trainer = DataParallelTrainer(
            softmax_classifier_loss(_logits),
            tunable_optimizer(torch.optim.AdamW, betas=(0.9, 0.999),
                              eps=1e-8, weight_decay=1e-4),
            predict_fn=_probs)
        device = self._trainer.device
        self._model, opt = self._trainer.init(
            lambda rng: from_jax_params(vit.init(rng, cfg), cfg, device,
                                        train=True),
            hyperparams={"lr": self._knobs["learning_rate"]})
        self.logger.define_plot("Loss over epochs", ["loss"], x_axis="epoch")
        self._trainer.fit(self._model, opt, (x, y),
                          epochs=self._knobs["epochs"],
                          batch_size=self._knobs["batch_size"],
                          log=self.logger.log,
                          checkpoint_path=self.checkpoint_path)
        self._model.eval()

    def evaluate(self, dataset_uri: str) -> float:
        x, y = dataset_utils.load_image_arrays(dataset_uri)
        return classification_accuracy(self._trainer, self._model, x, y)

    def load_parameters(self, params: Dict[str, Any]) -> None:
        self._model = from_jax_params(params, self._cfg())
        self._trainer = DataParallelTrainer(
            predict_fn=_probs, device=next(self._model.parameters()).device)

    def dump_parameters(self) -> Dict[str, Any]:
        return to_jax_params(self._model)

    def predict(self, queries: List[Any]) -> List[Any]:
        # the worker hands an (n, H, W, C) array when the queries arrived
        # as arrays (no copy here), a list of nested lists from JSON
        x = np.asarray(queries, np.float32)
        probs = self._trainer.predict_batched(
            self._model, x, batch_size=config.PREDICT_MAX_BATCH_SIZE)
        return [p.tolist() for p in probs]

    def warm_up(self) -> None:
        size = self._knobs["image_size"]
        self._trainer.warm_predict(self._model,
                                   np.zeros((size, size, 3), np.float32),
                                   batch_size=config.PREDICT_MAX_BATCH_SIZE)
