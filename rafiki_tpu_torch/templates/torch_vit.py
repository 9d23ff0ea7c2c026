"""TorchViT: a model template that serves a Vision Transformer.

Written as a user's template is: it subclasses the port's ``BaseModel``,
takes its architecture from knobs (as ``JaxBert`` does in the JAX
examples), loads a JAX-layout parameter tree, and answers each query (an
(H, W, C) float image) with its softmax class probabilities. The knob
values are fixed in this slice; the knob classes come with training.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from rafiki_tpu_torch import config
from rafiki_tpu_torch.convert import from_jax_params, to_jax_params
from rafiki_tpu_torch.models.transformer import TransformerConfig
from rafiki_tpu_torch.models.vit import ViTConfig
from rafiki_tpu_torch.sdk.model import BaseModel
from rafiki_tpu_torch.sdk.torch_backend import DataParallelTrainer


class TorchViT(BaseModel):
    @staticmethod
    def get_knob_config() -> Dict[str, Any]:
        # ViT-B/16 at 224 px over ImageNet's 1000 classes
        return {"image_size": 224, "patch_size": 16, "dim": 768,
                "depth": 12, "heads": 12, "num_classes": 1000}

    def __init__(self, **knobs: Any):
        super().__init__(**{**self.get_knob_config(), **knobs})
        self._model = None
        self._trainer = None

    def _cfg(self) -> ViTConfig:
        k = self._knobs
        return ViTConfig(
            image_size=k["image_size"], patch_size=k["patch_size"],
            num_classes=k["num_classes"],
            encoder=TransformerConfig(dim=k["dim"], depth=k["depth"],
                                      heads=k["heads"]))

    def load_parameters(self, params: Dict[str, Any]) -> None:
        self._model = from_jax_params(params, self._cfg())
        model = self._model
        self._trainer = DataParallelTrainer(
            lambda x: torch.softmax(model(x), dim=-1),
            device=next(model.parameters()).device)

    def dump_parameters(self) -> Dict[str, Any]:
        return to_jax_params(self._model)

    def predict(self, queries: List[Any]) -> List[Any]:
        # the worker hands an (n, H, W, C) array when the queries arrived
        # as arrays (no copy here), a list of nested lists from JSON
        x = np.asarray(queries, np.float32)
        probs = self._trainer.predict_batched(
            x, batch_size=config.PREDICT_MAX_BATCH_SIZE)
        return [p.tolist() for p in probs]

    def warm_up(self) -> None:
        size = self._knobs["image_size"]
        self._trainer.warm_predict(np.zeros((size, size, 3), np.float32),
                                   batch_size=config.PREDICT_MAX_BATCH_SIZE)
