"""TorchBiLstm: a BiLSTM part-of-speech tagger (``POS_TAGGING``).

The twin of ``examples/models/pos_tagging/JaxBiLstm.py``: the same knobs
(the embedding and hidden widths, word dropout, learning rate, batch
size; 10 epochs), the tagger :mod:`rafiki_tpu_torch.models.bilstm`
trained through ``DataParallelTrainer`` with Adam (optax's defaults) on
the masked per-token negative log-likelihood.

- The vocabulary is fitted on the training corpus: lower-cased words
  from id 2 (0 is the padding, 1 the unknown word), the first tag
  column's sorted tags; sentences are padded (or cut) to the longest
  training sentence. A gold tag unseen in training encodes as -1: it
  stays in ``evaluate``'s denominator and never matches (an honest
  miss).
- Word dropout is host-side: each epoch, ids are replaced by the unknown
  word at the knob's rate, from ``default_rng(0)`` drawn anew every
  epoch, as the JAX twin does.
- Over several ranks (``CHIPS_PER_TRIAL``) the trainer splits each batch
  as every ``DataParallelTrainer`` template does, and the loss stays the
  global batch's masked mean: each rank divides its sum by the global
  count of tokens.
- ``predict`` answers each query (a token list) with a tag a token, in
  buckets of at most ``PREDICT_MAX_BATCH_SIZE`` sentences.
- ``dump_parameters``: the JAX-layout tree, the words in id order, the
  tags, ``max_len`` and the widths.
"""

from typing import Any, Dict, List

import numpy as np
import torch

from rafiki_tpu_torch import config
from rafiki_tpu_torch.convert import from_jax_tree, to_jax_tree
from rafiki_tpu_torch.models import bilstm
from rafiki_tpu_torch.parallel.ranks import current_group
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

_PAD, _UNK = 0, 1


def _loss(model, batch):
    """The masked mean of the per-token NLL over the global batch."""
    ids, mask, tags = batch
    logp = torch.log_softmax(model(ids.long(), mask), dim=-1)
    nll = -torch.gather(logp, -1, tags.long()[..., None])[..., 0]
    count = mask.sum()
    group = current_group()
    if group is not None:
        # each rank's share of the global mean: the trainer averages the
        # ranks' gradients
        count = group.all_reduce_(count.reshape(1).clone())[0] / group.size
    return (nll * mask).sum() / count.clamp_min(1.0), {}


def _predict(model, batch):
    return model(batch[..., 0].long(), batch[..., 1].float()).argmax(-1)


class TorchBiLstm(BaseModel):

    @staticmethod
    def get_knob_config():
        return {
            "epochs": FixedKnob(10),
            "word_embed_dims": IntegerKnob(16, 128),
            "word_rnn_hidden_size": IntegerKnob(16, 128),
            "word_dropout": FloatKnob(1e-3, 2e-1, is_exp=True),
            "learning_rate": FloatKnob(1e-2, 1e-1, is_exp=True),
            "batch_size": CategoricalKnob([16, 32, 64, 128]),
        }

    def __init__(self, **knobs: Any):
        super().__init__(**knobs)
        self._model = None
        self._trainer = None
        self._cfg = None
        self._word_vocab = None  # word -> id (0 pad, 1 unk)
        self._tag_vocab = None   # the tags, in id order
        self._max_len = None

    # -- data --------------------------------------------------------------

    def _encode(self, sentences, max_len):
        ids = np.full((len(sentences), max_len), _PAD, np.int32)
        mask = np.zeros((len(sentences), max_len), np.float32)
        tags = np.zeros((len(sentences), max_len), np.int32)
        tag_index = {t: i for i, t in enumerate(self._tag_vocab)}
        for i, (tokens, tag_rows) in enumerate(sentences):
            for j, tok in enumerate(tokens[:max_len]):
                ids[i, j] = self._word_vocab.get(tok.lower(), _UNK)
                mask[i, j] = 1.0
                if tag_rows is not None:
                    tags[i, j] = tag_index.get(tag_rows[j][0], -1)
        return ids, mask, tags

    def _load(self, dataset_uri, fit_vocab=False):
        ds = dataset_utils.load_dataset_of_corpus(dataset_uri)
        sentences = list(ds)
        if fit_vocab:
            words = sorted({t.lower() for toks, _ in sentences for t in toks})
            self._word_vocab = {w: i + 2 for i, w in enumerate(words)}
            self._tag_vocab = ds.tag_vocabs[0]
            self._max_len = max(ds.max_len, 1)
        return self._encode(sentences, self._max_len)

    # -- model -------------------------------------------------------------

    def _make_cfg(self, embed_dim: int, hidden: int) -> bilstm.BiLstmConfig:
        return bilstm.BiLstmConfig(
            vocab=len(self._word_vocab) + 2, n_tags=len(self._tag_vocab),
            embed_dim=embed_dim, hidden=hidden, max_len=self._max_len)

    def _build_trainer(self) -> DataParallelTrainer:
        # keyed by the frozen config; the learning rate is set at init
        return cached_trainer(("TorchBiLstm", self._cfg),
                              lambda: DataParallelTrainer(
            _loss, tunable_optimizer(torch.optim.Adam,
                                     lr=self._knobs["learning_rate"]),
            predict_fn=_predict))

    def _module(self, tree, train: bool = False) -> bilstm.BiLstm:
        with torch.device("meta"):
            model = bilstm.BiLstm(self._cfg)
        return from_jax_tree(model, tree, device=self._trainer.device,
                             train=train)

    def train(self, dataset_uri: str) -> None:
        ids, mask, tags = self._load(dataset_uri, fit_vocab=True)
        self._cfg = self._make_cfg(self._knobs["word_embed_dims"],
                                   self._knobs["word_rnn_hidden_size"])
        self._trainer = trainer = self._build_trainer()
        model, opt = trainer.init(
            lambda rng: self._module(bilstm.init(rng, self._cfg), True),
            hyperparams={"lr": self._knobs["learning_rate"]})
        self.logger.define_plot("Loss over epochs", ["loss"], x_axis="epoch")
        drop_rng = np.random.default_rng(0)
        for epoch in range(self._knobs["epochs"]):
            # word dropout, resampled every epoch
            drop = drop_rng.uniform(size=ids.shape)
            ids_train = np.where(
                (drop < self._knobs["word_dropout"]) & (ids != _PAD),
                _UNK, ids).astype(np.int32)

            def log_with_epoch(_e=epoch, **kw):
                kw["epoch"] = float(_e)  # fit counts its one epoch as 0
                self.logger.log(**kw)

            trainer.fit(model, opt, (ids_train, mask, tags), epochs=1,
                        batch_size=self._knobs["batch_size"], seed=epoch,
                        log=log_with_epoch)
        self._model = model.eval()

    def evaluate(self, dataset_uri: str) -> float:
        ids, mask, tags = self._load(dataset_uri)
        pred = self._predict_ids(ids, mask)
        correct = ((pred == tags) & (tags >= 0) & (mask > 0)).sum()
        return float(correct / np.maximum(mask.sum(), 1.0))

    def _predict_ids(self, ids, mask):
        packed = np.stack([ids, mask.astype(np.int32)], axis=-1)
        return self._trainer.predict_batched(
            self._model, packed, batch_size=config.PREDICT_MAX_BATCH_SIZE)

    def warm_up(self) -> None:
        self._trainer.warm_predict(
            self._model, np.zeros((self._max_len, 2), np.int32),
            batch_size=config.PREDICT_MAX_BATCH_SIZE)

    def predict(self, queries: List[Any]) -> List[Any]:
        sentences = [(list(toks), None) for toks in queries]
        ids, mask, _ = self._encode(sentences, self._max_len)
        pred = self._predict_ids(ids, mask)
        return [[self._tag_vocab[t] for t in pred[i, :min(len(toks),
                                                            self._max_len)]]
                for i, toks in enumerate(queries)]

    def dump_parameters(self) -> Dict[str, Any]:
        words = sorted(self._word_vocab, key=self._word_vocab.get)
        return {"params": to_jax_tree(self._model)[0], "words": words,
                "tag_vocab": list(self._tag_vocab),
                "max_len": self._max_len, "embed_dim": self._cfg.embed_dim,
                "hidden": self._cfg.hidden}

    def load_parameters(self, params: Dict[str, Any]) -> None:
        self._word_vocab = {w: i + 2 for i, w in enumerate(params["words"])}
        self._tag_vocab = list(params["tag_vocab"])
        self._max_len = int(params["max_len"])
        self._cfg = self._make_cfg(int(params["embed_dim"]),
                                   int(params["hidden"]))
        self._trainer = self._build_trainer()
        self._model = self._module(params["params"])
