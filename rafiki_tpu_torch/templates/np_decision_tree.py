"""NpDecisionTree — CART decision-tree classifier, dependency-free numpy.

Parity with the reference's SkDt (reference
examples/models/image_classification/SkDt.py:12-126: an sklearn
DecisionTreeClassifier with max_depth / criterion knobs). This build avoids
the sklearn dependency entirely — the CPU-path models in the zoo must run in
a bare worker — so the tree is a ~100-line vectorized CART: gini or entropy
impurity (the same two criteria the reference exposes), quantile candidate
thresholds, and a feature subsample per node to keep image-sized inputs
tractable.

Run ``python -m rafiki_tpu_torch.templates.np_decision_tree`` for the
local contract check (reference SkDt.py:109).
"""

import os

import numpy as np

from rafiki_tpu_torch.sdk.dataset import dataset_utils
from rafiki_tpu_torch.sdk.knob import CategoricalKnob, IntegerKnob
from rafiki_tpu_torch.sdk.model import BaseModel


def _impurity(counts: np.ndarray, criterion: str) -> np.ndarray:
    """counts (..., C) -> impurity (...)."""
    n = counts.sum(axis=-1, keepdims=True)
    p = counts / np.maximum(n, 1)
    if criterion == "entropy":
        with np.errstate(divide="ignore", invalid="ignore"):
            t = np.where(p > 0, -p * np.log2(p), 0.0)
        return t.sum(axis=-1)
    return 1.0 - (p ** 2).sum(axis=-1)  # gini


class _Cart:
    def __init__(self, max_depth: int, criterion: str, n_classes: int,
                 max_features: int = 64, n_thresholds: int = 8, seed: int = 0):
        self.max_depth = max_depth
        self.criterion = criterion
        self.n_classes = n_classes
        self.max_features = max_features
        self.n_thresholds = n_thresholds
        self.rng = np.random.default_rng(seed)
        self.tree = None  # nested dicts: {leaf: probs} | {f, t, lo, hi}

    def _build(self, x, y, depth):
        counts = np.bincount(y, minlength=self.n_classes).astype(np.float64)
        if depth >= self.max_depth or len(np.unique(y)) <= 1 or len(y) < 4:
            return {"leaf": (counts / counts.sum()).tolist()}
        n_feat = x.shape[1]
        feats = (np.arange(n_feat) if n_feat <= self.max_features
                 else self.rng.choice(n_feat, self.max_features, replace=False))
        best = (None, None, _impurity(counts[None], self.criterion)[0])
        qs = np.linspace(0.1, 0.9, self.n_thresholds)
        for f in feats:
            col = x[:, f]
            for t in np.unique(np.quantile(col, qs)):
                left = y[col <= t]
                right = y[col > t]
                if not len(left) or not len(right):
                    continue
                cl = np.bincount(left, minlength=self.n_classes).astype(float)
                cr = np.bincount(right, minlength=self.n_classes).astype(float)
                w = (len(left) * _impurity(cl[None], self.criterion)[0]
                     + len(right) * _impurity(cr[None], self.criterion)[0]
                     ) / len(y)
                if w < best[2] - 1e-12:
                    best = ((int(f), float(t)), (cl, cr), w)
        if best[0] is None:
            return {"leaf": (counts / counts.sum()).tolist()}
        f, t = best[0]
        m = x[:, f] <= t
        return {
            "f": f, "t": t,
            "lo": self._build(x[m], y[m], depth + 1),
            "hi": self._build(x[~m], y[~m], depth + 1),
        }

    def fit(self, x, y):
        self.tree = self._build(x, y, 0)

    def _predict_one(self, node, row):
        while "leaf" not in node:
            node = node["lo"] if row[node["f"]] <= node["t"] else node["hi"]
        return node["leaf"]

    def predict_proba(self, x):
        return np.array([self._predict_one(self.tree, r) for r in x])


class NpDecisionTree(BaseModel):

    dependencies = {"numpy": None}

    @staticmethod
    def get_knob_config():
        # reference SkDt.py:17-21
        return {
            "max_depth": IntegerKnob(1, 32),
            "criterion": CategoricalKnob(["gini", "entropy"]),
        }

    def __init__(self, **knobs):
        super().__init__(**knobs)
        self._knobs = knobs
        self._clf = None
        self._n_classes = None

    def _load(self, dataset_uri):
        x, y = dataset_utils.load_image_arrays(dataset_uri)
        return x.reshape(len(x), -1), y.astype(np.int64)

    def train(self, dataset_uri):
        x, y = self._load(dataset_uri)
        self._n_classes = int(y.max()) + 1
        self._clf = _Cart(self._knobs["max_depth"], self._knobs["criterion"],
                          self._n_classes)
        self._clf.fit(x, y)
        self.logger.log("tree trained", depth=float(self._knobs["max_depth"]))

    def evaluate(self, dataset_uri):
        x, y = self._load(dataset_uri)
        pred = self._clf.predict_proba(x).argmax(axis=-1)
        return float((pred == y).mean())

    def predict(self, queries):
        x = np.asarray(queries, np.float32).reshape(len(queries), -1)
        return [p.tolist() for p in self._clf.predict_proba(x)]

    def dump_parameters(self):
        return {
            "tree": self._clf.tree,
            "n_classes": self._n_classes,
            "max_depth": self._knobs["max_depth"],
            "criterion": self._knobs["criterion"],
        }

    def load_parameters(self, params):
        self._n_classes = params["n_classes"]
        self._clf = _Cart(params["max_depth"], params["criterion"],
                          self._n_classes)
        self._clf.tree = params["tree"]


if __name__ == "__main__":
    import tempfile

    from rafiki_tpu_torch.sdk.dataset import write_numpy_dataset
    from rafiki_tpu_torch.sdk.model import test_model_class

    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as d:
        # separable blobs so the tree demonstrably learns
        y = rng.integers(0, 3, size=300).astype(np.int32)
        x = (rng.normal(size=(300, 8, 8, 1)) + y[:, None, None, None] * 2.0
             ).astype(np.float32)
        train_uri = write_numpy_dataset(x, y, os.path.join(d, "train.npz"))
        test_uri = write_numpy_dataset(x[:64], y[:64], os.path.join(d, "test.npz"))
        test_model_class(
            clazz=NpDecisionTree,
            task="IMAGE_CLASSIFICATION",
            train_dataset_uri=train_uri,
            test_dataset_uri=test_uri,
            queries=[x[0].tolist()],
        )
