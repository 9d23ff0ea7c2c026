"""TorchResNet: a residual convnet image classifier with BatchNorm.

The twin of ``examples/models/image_classification/JaxResNet.py`` (the
CIFAR-10 ResNet under GP HPO): a ``depth`` knob picks the ResNet-18 or
ResNet-50 plan (``rafiki_tpu_torch.models.resnet``, CIFAR stem), and the
learning rate, epochs and batch size are tuned. BatchNorm's running
statistics ride the trainer's stateful path
(``DataParallelTrainer(stateful=True)``): updated in every step,
checkpointed next to the parameters and never seen by the optimizer;
inference uses them, so one query's answer does not depend on its batch.
AdamW with optax.adamw's defaults (``weight_decay=1e-4``).
``dump_parameters`` hands back the JAX-layout trees.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List

import numpy as np
import torch

from rafiki_tpu_torch import config
from rafiki_tpu_torch.convert import from_jax_tree, to_jax_tree
from rafiki_tpu_torch.models import resnet
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
    tunable_optimizer,
)


def _loss(model, state, batch):
    x, y = batch
    logits, new_state = model(x, state, train=True)
    loss = torch.nn.functional.cross_entropy(logits, y.long())
    acc = (logits.argmax(-1) == y).float().mean()
    return loss, ({"acc": acc}, new_state)


def _probs(model, state, x):
    logits, _ = model(x, state, train=False)
    return torch.softmax(logits, dim=-1)


class TorchResNet(BaseModel):
    @staticmethod
    def get_knob_config():
        return {
            "depth": CategoricalKnob(["resnet18", "resnet50"]),
            "learning_rate": FloatKnob(1e-4, 1e-1, is_exp=True),
            "epochs": IntegerKnob(1, 4),
            "batch_size": CategoricalKnob([64, 128, 256]),
            "image_size": FixedKnob(32),
        }

    def __init__(self, **knobs: Any):
        super().__init__(**knobs)
        self._model = None
        self._state = None  # BatchNorm running statistics
        self._cfg = None

    def _make_cfg(self, num_classes: int) -> resnet.ResNetConfig:
        make = (resnet.resnet50 if self._knobs["depth"] == "resnet50"
                else resnet.resnet18)
        return make(num_classes=num_classes, small_inputs=True)

    def _build_trainer(self) -> DataParallelTrainer:
        return cached_trainer(("TorchResNet", self._cfg),
                              lambda: DataParallelTrainer(
            _loss,
            tunable_optimizer(torch.optim.AdamW,
                              lr=self._knobs["learning_rate"],
                              betas=(0.9, 0.999), eps=1e-8,
                              weight_decay=1e-4),
            predict_fn=_probs, stateful=True))

    def _load(self, dataset_uri: str):
        size = self._knobs["image_size"]
        return dataset_utils.load_image_arrays(dataset_uri,
                                               image_size=(size, size))

    def _build(self, params, state, device=None, train=False):
        with torch.device("meta"):
            model = resnet.ResNet(self._cfg)
        self._model = from_jax_tree(model, params, state, device, train)
        self._state = self._model.state()
        return self._model, self._state

    # -- BaseModel contract ------------------------------------------------

    def train(self, dataset_uri: str) -> None:
        t0 = time.time()
        x, y = self._load(dataset_uri)
        t1 = time.time()
        self._cfg = self._make_cfg(int(y.max()) + 1)
        trainer = self._build_trainer()
        model, opt, state = trainer.init(
            lambda rng: self._build(*resnet.init(rng, self._cfg),
                                    trainer.device, train=True),
            hyperparams={"lr": self._knobs["learning_rate"]})
        # the set-up before the first epoch: the dataset's read and decode
        # (a cache hit after the job's first trial), the parameters' init
        self.logger.log(read_time=t1 - t0, init_time=time.time() - t1)
        self.logger.define_plot("Loss over epochs", ["loss"], x_axis="epoch")
        self._model, _, self._state = trainer.fit(
            model, opt, (x, y),
            epochs=self._knobs["epochs"],
            batch_size=self._knobs["batch_size"],
            log=self.logger.log,
            checkpoint_path=self.checkpoint_path,
            state=state)
        self._model.eval()

    def evaluate(self, dataset_uri: str) -> float:
        x, y = self._load(dataset_uri)
        probs = self._build_trainer().predict_batched(self._model, x,
                                                      state=self._state)
        return float((np.argmax(probs, -1) == np.asarray(y)).mean())

    def predict(self, queries: List[Any]) -> List[Any]:
        x = np.asarray(queries, dtype=np.float32)
        probs = self._build_trainer().predict_batched(
            self._model, x, batch_size=config.PREDICT_MAX_BATCH_SIZE,
            state=self._state)
        return [p.tolist() for p in probs]

    def warm_up(self) -> None:
        size = self._knobs["image_size"]
        example = np.zeros((size, size, 3), np.float32)
        self._build_trainer().warm_predict(
            self._model, example, batch_size=config.PREDICT_MAX_BATCH_SIZE,
            state=self._state)

    def dump_parameters(self) -> Dict[str, Any]:
        params, state = to_jax_tree(self._model)
        return {"params": params, "state": state,
                "num_classes": self._cfg.num_classes,
                "depth": self._knobs["depth"]}

    def load_parameters(self, blob: Dict[str, Any]) -> None:
        self._knobs["depth"] = blob["depth"]
        self._cfg = self._make_cfg(blob["num_classes"])
        self._build(blob["params"], blob["state"],
                    self._build_trainer().device)
