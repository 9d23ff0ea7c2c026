"""TorchBert: a BERT encoder text classifier with architecture-search knobs.

The twin of ``examples/models/text_classification/JaxBert.py``: depth,
heads and width are knobs, so the GP advisor searches the BERT family
(each sampled architecture is a trial) beside the learning rate, epochs
and batch size. Tokens are hashed into a fixed vocabulary (``_hash_ids``:
no tokenizer to install; id 1 first, the pooling slot, and 0 the
padding), sequences padded to the fixed ``max_len``. The label vocabulary
comes from the first tag column of the corpus zip. ``cached_trainer``
keys the trainer by the architecture; AdamW with optax.adamw's defaults
(``weight_decay=1e-4``); ``predict`` answers each query (a string or a
token list) with its softmax class probabilities, and
``dump_parameters`` hands back the JAX-layout tree.
"""

from __future__ import annotations

import zlib
from typing import Any, Dict, List

import numpy as np
import torch

from rafiki_tpu_torch import config
from rafiki_tpu_torch.convert import from_jax_params, to_jax_params
from rafiki_tpu_torch.models import bert
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

ARCH_KNOBS = ("depth", "heads", "dim", "max_len", "vocab")


def _hash_ids(tokens, vocab: int, max_len: int) -> np.ndarray:
    """A stable token hash into [2, vocab); 0 is the padding, 1 the
    first (pooling) slot."""
    ids = np.zeros((max_len,), np.int32)
    ids[0] = 1
    for i, tok in enumerate(tokens[: max_len - 1]):
        ids[i + 1] = 2 + zlib.crc32(tok.lower().encode()) % (vocab - 2)
    return ids


def _logits(model, ids):
    return model(ids)


def _probs(model, ids):
    return torch.softmax(model(ids), dim=-1)


class TorchBert(BaseModel):
    """Hashed-token BERT encoder; the class is the argmax of the pooled
    logits."""

    @staticmethod
    def get_knob_config():
        return {
            # the architecture search space
            "depth": IntegerKnob(2, 4),
            "heads": CategoricalKnob([2, 4]),
            "dim": CategoricalKnob([64, 128]),
            # ordinary hyperparameters
            "learning_rate": FloatKnob(1e-4, 5e-3, is_exp=True),
            "epochs": IntegerKnob(1, 3),
            "batch_size": CategoricalKnob([16, 32, 64]),
            "max_len": FixedKnob(64),
            "vocab": FixedKnob(4096),
        }

    def __init__(self, **knobs: Any):
        super().__init__(**knobs)
        self._model = None
        self._trainer = None
        self._cfg = None
        self._label_vocab = None

    def _make_cfg(self, num_classes: int) -> bert.BertConfig:
        k = self._knobs
        return bert.tiny(vocab=k["vocab"], max_len=k["max_len"],
                         num_classes=num_classes, dim=k["dim"],
                         depth=k["depth"], heads=k["heads"])

    def _build_trainer(self) -> DataParallelTrainer:
        # keyed by the whole architecture; the learning rate is set at init
        return cached_trainer(("TorchBert", self._cfg),
                              lambda: DataParallelTrainer(
            softmax_classifier_loss(_logits),
            tunable_optimizer(torch.optim.AdamW,
                              lr=self._knobs["learning_rate"],
                              betas=(0.9, 0.999), eps=1e-8,
                              weight_decay=1e-4),
            predict_fn=_probs))

    # -- data --------------------------------------------------------------

    def _load(self, dataset_uri: str):
        """The corpus zip; each sentence's first tag column is its
        class."""
        ds = dataset_utils.load_dataset_of_corpus(dataset_uri)
        texts, labels = [], []
        for tokens, tags in ds:
            texts.append(tokens)
            labels.append(tags[0][0] if tags and tags[0] else "")
        if self._label_vocab is None:
            self._label_vocab = sorted(set(labels))
        lut = {t: i for i, t in enumerate(self._label_vocab)}
        k = self._knobs
        x = np.stack([_hash_ids(t, k["vocab"], k["max_len"]) for t in texts])
        y = np.array([lut.get(label, 0) for label in labels], np.int32)
        return x, y

    def _to_ids(self, queries: List[Any]) -> np.ndarray:
        k = self._knobs
        if not len(queries):
            return np.zeros((0, k["max_len"]), np.int32)
        return np.stack([
            _hash_ids(q.split() if isinstance(q, str) else list(q),
                      k["vocab"], k["max_len"])
            for q in queries])

    # -- BaseModel contract ------------------------------------------------

    def train(self, dataset_uri: str) -> None:
        x, y = self._load(dataset_uri)
        self._cfg = self._make_cfg(len(self._label_vocab))
        self._trainer = trainer = self._build_trainer()
        cfg = self._cfg
        self._model, opt = trainer.init(
            lambda rng: from_jax_params(bert.init(rng, cfg), cfg,
                                        trainer.device, train=True),
            hyperparams={"lr": self._knobs["learning_rate"]})
        self.logger.define_plot("Loss over epochs", ["loss"], x_axis="epoch")
        trainer.fit(self._model, opt, (x, y),
                    epochs=self._knobs["epochs"],
                    batch_size=self._knobs["batch_size"],
                    log=self.logger.log,
                    checkpoint_path=self.checkpoint_path)
        self._model.eval()

    def evaluate(self, dataset_uri: str) -> float:
        x, y = self._load(dataset_uri)
        return classification_accuracy(self._trainer, self._model, x, y)

    def predict(self, queries: List[Any]) -> List[Any]:
        probs = self._trainer.predict_batched(
            self._model, self._to_ids(queries),
            batch_size=config.PREDICT_MAX_BATCH_SIZE)
        return [p.tolist() for p in probs]

    def warm_up(self) -> None:
        self._trainer.warm_predict(
            self._model, np.zeros((self._knobs["max_len"],), np.int32),
            batch_size=config.PREDICT_MAX_BATCH_SIZE)

    def dump_parameters(self) -> Dict[str, Any]:
        return {"params": to_jax_params(self._model),
                "label_vocab": self._label_vocab,
                "arch": {k: self._knobs[k] for k in ARCH_KNOBS}}

    def load_parameters(self, params: Dict[str, Any]) -> None:
        self._label_vocab = list(params["label_vocab"])
        self._knobs.update(params["arch"])
        self._cfg = self._make_cfg(len(self._label_vocab))
        # rebuilt: a trainer of the old architecture must not serve it
        self._trainer = self._build_trainer()
        self._model = from_jax_params(params["params"], self._cfg,
                                      self._trainer.device)
