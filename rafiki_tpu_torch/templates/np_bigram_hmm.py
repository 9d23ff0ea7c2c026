"""NpBigramHmm — a bigram hidden-Markov part-of-speech tagger, numpy only.

The twin of ``examples/models/pos_tagging/BigramHmm.py``: count-based
transition and emission log-probabilities with add-one smoothing (the
same dictionaries), and Viterbi decoding. The
decoder works on dense tables built from the dictionaries (a tag x tag
transition matrix with a start row, a tag x word emission matrix with
each tag's unknown-word column), a numpy pass a token in place of the
JAX twin's per-pair dictionary lookups: the same float64 sums, and the
same first-maximum tie-breaking in tag order, so the same tags.
Empty knob config. ``dump_parameters`` holds each table as one JSON text
(the JAX twin's msgpack holds the dictionaries; the port's artifact
would key a path by each word).

Run ``python -m rafiki_tpu_torch.templates.np_bigram_hmm`` for the local
contract check.
"""

import json
import math

import numpy as np

from rafiki_tpu_torch.sdk.dataset import dataset_utils
from rafiki_tpu_torch.sdk.model import BaseModel

_START, _UNK = "<s>", "<unk>"
_MISSING = math.log(1e-8)  # a context never seen in training


class NpBigramHmm(BaseModel):

    @staticmethod
    def get_knob_config():
        return {}

    def __init__(self, **knobs):
        super().__init__(**knobs)
        self._trans = {}   # prev_tag -> {tag: logp}
        self._emiss = {}   # tag -> {word: logp}
        self._tags = []
        self._tables = None

    # -- training ----------------------------------------------------------

    def train(self, dataset_uri):
        ds = dataset_utils.load_dataset_of_corpus(dataset_uri)
        trans_counts, emiss_counts = {}, {}
        tags = set()
        for tokens, tag_rows in ds:
            prev = _START
            for tok, row in zip(tokens, tag_rows):
                tag = row[0]
                tags.add(tag)
                trans_counts.setdefault(prev, {}).setdefault(tag, 0)
                trans_counts[prev][tag] += 1
                emiss_counts.setdefault(tag, {}).setdefault(tok.lower(), 0)
                emiss_counts[tag][tok.lower()] += 1
                prev = tag
        self._tags = sorted(tags)
        # add-one smoothing over the tag/word vocab
        self._trans = self._normalize(trans_counts, self._tags)
        self._emiss = self._normalize(emiss_counts, None)
        self._tables = None
        self.logger.log(f"No. of tags: {len(self._tags)}")

    @staticmethod
    def _normalize(counts, support):
        out = {}
        for ctx, dist in counts.items():
            total = sum(dist.values())
            n_events = len(support) if support else len(dist) + 1
            out[ctx] = {k: math.log((v + 1) / (total + n_events))
                        for k, v in dist.items()}
            out[ctx][_UNK] = math.log(1.0 / (total + n_events))
        return out

    # -- decoding ----------------------------------------------------------

    def _dense(self):
        """(start (T,), trans (T, T) prev x next, emission (T, V+1) with
        the unknown-word column last, word -> column)."""
        if self._tables is not None:
            return self._tables

        def row(table, ctx, keys):
            dist = table.get(ctx)
            if dist is None:
                return np.full(len(keys), _MISSING)
            return np.array([dist.get(k, dist[_UNK]) for k in keys])

        tags = self._tags
        words = sorted({w for dist in self._emiss.values() for w in dist
                        if w != _UNK})
        column = {w: i for i, w in enumerate(words)}
        emission = (np.stack([row(self._emiss, t, words + [_UNK])
                              for t in tags]) if tags else np.zeros((0, 1)))
        trans = (np.stack([row(self._trans, p, tags) for p in tags])
                 if tags else np.zeros((0, 0)))
        self._tables = (row(self._trans, _START, tags), trans, emission,
                        column)
        return self._tables

    def _viterbi(self, tokens):
        if not tokens:
            return []
        start, trans, emission, column = self._dense()
        unk = emission.shape[1] - 1
        cols = [column.get(t.lower(), unk) for t in tokens]
        scores = start + emission[:, cols[0]]
        back = []
        for col in cols[1:]:
            cand = scores[:, None] + trans           # (prev, next)
            best = cand.argmax(axis=0)               # first maximum
            scores = cand[best, np.arange(len(best))] + emission[:, col]
            back.append(best)
        tag = int(scores.argmax())
        path = [tag]
        for best in reversed(back):
            tag = int(best[tag])
            path.append(tag)
        return [self._tags[i] for i in path[::-1]]

    # -- BaseModel contract --------------------------------------------------

    def evaluate(self, dataset_uri):
        ds = dataset_utils.load_dataset_of_corpus(dataset_uri)
        correct = total = 0
        for tokens, tag_rows in ds:
            pred = self._viterbi(list(tokens))
            for p, row in zip(pred, tag_rows):
                correct += p == row[0]
                total += 1
        return correct / max(total, 1)

    def predict(self, queries):
        return [self._viterbi(list(tokens)) for tokens in queries]

    def dump_parameters(self):
        # each table as one JSON text: the port's artifact keys paths by
        # dictionary key, and a word may hold a "/"
        return {"trans": json.dumps(self._trans),
                "emiss": json.dumps(self._emiss), "tags": self._tags}

    def load_parameters(self, params):
        self._trans = json.loads(params["trans"])
        self._emiss = json.loads(params["emiss"])
        self._tags = list(params["tags"])
        self._tables = None


if __name__ == "__main__":
    import os
    import random
    import tempfile

    from rafiki_tpu_torch.sdk import model
    from rafiki_tpu_torch.sdk.dataset import write_corpus_dataset

    random.seed(0)
    nouns = ["cat", "dog", "bird", "tree"]
    verbs = ["runs", "sees", "eats"]
    dets = ["the", "a"]
    sents = []
    for _ in range(80):
        toks = [random.choice(dets), random.choice(nouns),
                random.choice(verbs), random.choice(dets),
                random.choice(nouns)]
        tags = [["DT"], ["NN"], ["VB"], ["DT"], ["NN"]]
        sents.append((toks, tags))
    with tempfile.TemporaryDirectory() as d:
        train_uri = write_corpus_dataset(sents, os.path.join(d, "train.zip"))
        test_uri = write_corpus_dataset(sents[:20], os.path.join(d, "test.zip"))
        model.test_model_class(
            clazz=NpBigramHmm,
            task="POS_TAGGING",
            train_dataset_uri=train_uri,
            test_dataset_uri=test_uri,
            queries=[["the", "cat", "runs"]],
        )
