"""NpLinearSvm — multiclass SVM via hinge-loss SGD, dependency-free numpy.

Parity with the reference's SkSvm (reference
examples/models/image_classification/SkSvm.py:12-127: sklearn SVC with
max_iter / kernel / gamma / C knobs). Differences by design: no sklearn in
the zoo's bare CPU path, so the solver is one-vs-rest linear SVM trained by
averaged SGD on the squared-hinge loss with L2 strength 1/C. The `kernel`
knob keeps the reference's choice but maps 'rbf' to random Fourier features
(Rahimi-Recht) over the linear solver — the standard primal approximation of
an rbf SVM — with `gamma` as the kernel width heuristic.

Run ``python -m rafiki_tpu_torch.templates.np_linear_svm`` for the
local contract check.
"""

import os

import numpy as np

from rafiki_tpu_torch.sdk.dataset import dataset_utils
from rafiki_tpu_torch.sdk.knob import CategoricalKnob, FloatKnob, IntegerKnob
from rafiki_tpu_torch.sdk.model import BaseModel

N_RFF = 256  # random Fourier features for the 'rbf' kernel approximation


class NpLinearSvm(BaseModel):

    dependencies = {"numpy": None}

    @staticmethod
    def get_knob_config():
        # reference SkSvm.py:17-23
        return {
            "max_iter": IntegerKnob(10, 20),
            "kernel": CategoricalKnob(["rbf", "linear"]),
            "gamma": CategoricalKnob(["scale", "auto"]),
            "C": FloatKnob(1e-2, 1e2, is_exp=True),
        }

    def __init__(self, **knobs):
        super().__init__(**knobs)
        self._knobs = knobs
        self._w = None          # (D_feat, C) weights
        self._b = None          # (C,) biases
        self._rff = None        # (D_in, N_RFF) projection or None
        self._rff_phase = None  # (N_RFF,)
        self._mean = None
        self._std = None

    # -- featurization -----------------------------------------------------

    def _gamma_value(self, x_raw):
        """sklearn semantics: 'scale' uses the *raw* input variance (on the
        standardized features var ~= 1 and the two options would collapse)."""
        d = x_raw.shape[1]
        if self._knobs["gamma"] == "scale":
            v = x_raw.var()
            return 1.0 / (d * v) if v > 0 else 1.0 / d
        return 1.0 / d  # 'auto'

    def _featurize(self, x, fit=False):
        if self._knobs["kernel"] == "linear":
            if fit:
                self._mean = x.mean(axis=0)
                self._std = x.std(axis=0) + 1e-8
            return (x - self._mean) / self._std
        # rbf: gamma acts on the raw inputs, as in sklearn's SVC (which does
        # not standardize internally) — standardizing first would make
        # 'scale' and 'auto' coincide
        if fit:
            self._gamma = self._gamma_value(x)
            rng = np.random.default_rng(0)
            self._rff = rng.normal(scale=np.sqrt(2 * self._gamma),
                                   size=(x.shape[1], N_RFF))
            self._rff_phase = rng.uniform(0, 2 * np.pi, N_RFF)
            # identity standardization so param dump/load stays uniform
            self._mean = np.zeros(x.shape[1])
            self._std = np.ones(x.shape[1])
        return np.sqrt(2.0 / N_RFF) * np.cos(x @ self._rff + self._rff_phase)

    # -- solver ------------------------------------------------------------

    def _fit(self, feats, y, n_classes):
        n, d = feats.shape
        lam = 1.0 / (self._knobs["C"] * n)
        w = np.zeros((d, n_classes))
        b = np.zeros(n_classes)
        w_avg, b_avg, n_avg = np.zeros_like(w), np.zeros_like(b), 0
        targets = np.where(y[:, None] == np.arange(n_classes)[None], 1.0, -1.0)
        rng = np.random.default_rng(1)
        batch = min(64, n)
        step = 0
        n_full = max(n // batch, 1) * batch
        total_steps = self._knobs["max_iter"] * (n_full // batch)
        # squared-hinge curvature scales with E||x||^2 (d for standardized
        # raw pixels, ~1 for the unit-norm Fourier features), so the stable
        # step size does too
        lr_cap = 1.0 / max(float(np.mean(np.sum(feats ** 2, axis=1))), 1e-8)
        for _ in range(self._knobs["max_iter"]):
            for idx in rng.permutation(n)[:n_full].reshape(-1, batch):
                step += 1
                # Pegasos schedule, capped: 1/(lam*t) diverges for large C
                # when the run is only max_iter*(n/batch) steps long
                lr = min(1.0 / (lam * (step + 10)), lr_cap)
                fx = feats[idx]
                margins = fx @ w + b                       # (B, C)
                viol = np.maximum(0.0, 1.0 - targets[idx] * margins)
                grad_m = -2.0 * viol * targets[idx] / len(idx)
                w -= lr * (fx.T @ grad_m + lam * w)
                b -= lr * grad_m.sum(axis=0)
                # tail averaging: only the last quarter of iterates, so the
                # averaged solution is not dragged toward early transients
                if step > 0.75 * total_steps:
                    w_avg += w
                    b_avg += b
                    n_avg += 1
        self._w = w_avg / max(n_avg, 1)
        self._b = b_avg / max(n_avg, 1)

    # -- BaseModel contract --------------------------------------------------

    def _load(self, dataset_uri):
        x, y = dataset_utils.load_image_arrays(dataset_uri)
        return x.astype(np.float64).reshape(len(x), -1), y.astype(np.int64)

    def train(self, dataset_uri):
        x, y = self._load(dataset_uri)
        feats = self._featurize(x, fit=True)
        self._fit(feats, y, int(y.max()) + 1)
        self.logger.log("svm trained", C=float(self._knobs["C"]))

    def evaluate(self, dataset_uri):
        x, y = self._load(dataset_uri)
        pred = (self._featurize(x) @ self._w + self._b).argmax(axis=-1)
        return float((pred == y).mean())

    def predict(self, queries):
        x = np.asarray(queries, np.float64).reshape(len(queries), -1)
        margins = self._featurize(x) @ self._w + self._b
        e = np.exp(margins - margins.max(axis=-1, keepdims=True))
        return [p.tolist() for p in e / e.sum(axis=-1, keepdims=True)]

    def dump_parameters(self):
        return {
            "w": self._w, "b": self._b, "rff": self._rff,
            "rff_phase": self._rff_phase, "mean": self._mean,
            "std": self._std, "kernel": self._knobs["kernel"],
        }

    def load_parameters(self, params):
        self._knobs["kernel"] = params["kernel"]
        self._w, self._b = params["w"], params["b"]
        self._rff, self._rff_phase = params["rff"], params["rff_phase"]
        self._mean, self._std = params["mean"], params["std"]


if __name__ == "__main__":
    import tempfile

    from rafiki_tpu_torch.sdk.dataset import write_numpy_dataset
    from rafiki_tpu_torch.sdk.model import test_model_class

    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as d:
        y = rng.integers(0, 3, size=300).astype(np.int32)
        x = (rng.normal(size=(300, 8, 8, 1)) + y[:, None, None, None] * 2.0
             ).astype(np.float32)
        train_uri = write_numpy_dataset(x, y, os.path.join(d, "train.npz"))
        test_uri = write_numpy_dataset(x[:64], y[:64], os.path.join(d, "test.npz"))
        test_model_class(
            clazz=NpLinearSvm,
            task="IMAGE_CLASSIFICATION",
            train_dataset_uri=train_uri,
            test_dataset_uri=test_uri,
            queries=[x[0].tolist()],
        )
