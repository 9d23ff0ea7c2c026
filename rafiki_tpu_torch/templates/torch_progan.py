"""TorchProGan: a Progressive GAN template (``IMAGE_GENERATION``).

The twin of ``examples/models/image_generation/JaxProGan.py``: the same
knobs (``D_repeats``, ``minibatch_base``, ``G_lrate``, ``D_lrate``,
``lod_initial_resolution``), the same run length read from the
environment under the twin's own names (``TORCHPROGAN_TOTAL_KIMG``,
default 2, and ``TORCHPROGAN_PHASE_KIMG``, the kimg of each lod's hold
and of its fade, default 600), the engine :mod:`rafiki_tpu_torch.models.
pggan` on one device (the JAX template builds its trainer with no mesh,
so a trial computes on one device whatever its grant; this one passes no
group).

- ``train``: an ``.npz`` (``x`` as stored) or an image zip, mapped to
  [-1, 1] (0..255 or 0..1 inputs) and padded to a square power of two;
- ``evaluate``: a polynomial-kernel MMD (KID-style) between 256 samples
  of Gs (seed 123) and the test images on 8x8-pooled pixels, as
  ``1 / (1 + MMD)`` (numpy f64, as the JAX template computes it);
- ``predict``: each query ``[gw, gh, n]`` renders ``min(n, gw*gh)``
  samples (seed ``1000 + i`` for the i-th query) into a uint8 grid
  written to ``output{i}.npy`` in the working directory, and answers
  the file's path. The JAX template writes a JPEG when PIL is there;
  the port has no PIL, so it always takes the ``.npy`` branch (ROADMAP.md,
  queue C). Two requests at once write the same names, as in the JAX
  template;
- ``dump_parameters``: the JAX-layout ``g``, ``d`` and ``gs`` trees,
  ``resolution``, ``num_channels`` and ``last_lod``.

Run ``python -m rafiki_tpu_torch.templates.torch_progan`` for the local
contract check at ``TORCHPROGAN_TOTAL_KIMG=0.2``.
"""

import os

import numpy as np

from rafiki_tpu_torch.convert import to_jax_tree
from rafiki_tpu_torch.models.pggan import PgganConfig, PgganTrainer, build
from rafiki_tpu_torch.sdk.dataset import dataset_utils
from rafiki_tpu_torch.sdk.knob import (
    CategoricalKnob,
    FixedKnob,
    FloatKnob,
    IntegerKnob,
)
from rafiki_tpu_torch.sdk.model import BaseModel


def _to_grid(images: np.ndarray, gw: int, gh: int) -> np.ndarray:
    """Tile (n, h, w, c) images in [-1,1] into one (gh*h, gw*w, c) uint8
    grid."""
    n, h, w, c = images.shape
    grid = np.zeros((gh * h, gw * w, c), np.float32)
    for i in range(min(n, gw * gh)):
        r, col = divmod(i, gw)
        grid[r * h:(r + 1) * h, col * w:(col + 1) * w] = images[i]
    return np.clip((grid + 1.0) * 127.5, 0, 255).astype(np.uint8)


def _kid_mmd(a: np.ndarray, b: np.ndarray, feat_res: int = 8) -> float:
    """Polynomial-kernel MMD^2 between two image sets on downscaled
    pixels."""

    def feats(x):
        n, h, w, c = x.shape
        f = h // feat_res
        if f > 1:
            x = x[:, : f * feat_res, : f * feat_res].reshape(
                n, feat_res, f, feat_res, f, c).mean(axis=(2, 4))
        return x.reshape(n, -1).astype(np.float64)

    fa, fb = feats(a), feats(b)
    d = fa.shape[1]

    def k(x, y):
        return (x @ y.T / d + 1.0) ** 3

    m, n = len(fa), len(fb)
    kaa_m, kbb_m = k(fa, fa), k(fb, fb)
    kaa = (kaa_m.sum() - np.trace(kaa_m)) / (m * (m - 1))
    kbb = (kbb_m.sum() - np.trace(kbb_m)) / (n * (n - 1))
    kab = k(fa, fb).mean()
    return float(max(kaa + kbb - 2 * kab, 0.0))


class TorchProGan(BaseModel):

    TOTAL_KIMG = float(os.environ.get("TORCHPROGAN_TOTAL_KIMG", 2.0))
    # each lod's hold and fade, in kimg (the reference holds 600)
    PHASE_KIMG = float(os.environ.get("TORCHPROGAN_PHASE_KIMG", 600.0))

    @staticmethod
    def get_knob_config():
        return {
            "D_repeats": IntegerKnob(1, 3),
            "minibatch_base": CategoricalKnob([4, 8, 16, 32]),
            "G_lrate": FloatKnob(1e-3, 3e-3, is_exp=False),
            "D_lrate": FloatKnob(1e-3, 3e-3, is_exp=False),
            "lod_initial_resolution": FixedKnob(4),
        }

    def __init__(self, **knobs):
        super().__init__(**knobs)
        self._trainer = None
        self._cfg = None

    def _load_images(self, dataset_uri):
        if dataset_uri.endswith(".npz"):
            x = dataset_utils.load_dataset_of_arrays(dataset_uri).x
        else:
            x, _ = dataset_utils.load_dataset_of_image_files(
                dataset_uri).load_as_arrays()
        x = x.astype(np.float32)
        if x.max() > 1.5:            # 0..255 -> [-1, 1]
            x = x / 127.5 - 1.0
        elif x.min() >= 0.0:         # 0..1 -> [-1, 1]
            x = x * 2.0 - 1.0
        side = max(x.shape[1], x.shape[2])
        res = 1 << (side - 1).bit_length()  # pad up to a square power of 2
        if res != x.shape[1] or res != x.shape[2]:
            pad_h, pad_w = res - x.shape[1], res - x.shape[2]
            x = np.pad(x, ((0, 0), (0, pad_h), (0, pad_w), (0, 0)))
        return x

    def train(self, dataset_uri):
        x = self._load_images(dataset_uri)
        self._cfg = PgganConfig(resolution=x.shape[1],
                                num_channels=x.shape[-1])
        self._trainer = PgganTrainer(self._cfg)
        self.logger.define_plot("Losses over kimg", ["d_loss", "g_loss"],
                                x_axis="kimg")
        self._trainer.train(
            x,
            total_kimg=self.TOTAL_KIMG,
            D_repeats=self._knobs["D_repeats"],
            minibatch_base=self._knobs["minibatch_base"],
            G_lrate=self._knobs["G_lrate"],
            D_lrate=self._knobs["D_lrate"],
            lod_initial_resolution=self._knobs["lod_initial_resolution"],
            lod_training_kimg=self.PHASE_KIMG,
            lod_transition_kimg=self.PHASE_KIMG,
            log=self.logger.log,
        )

    def evaluate(self, dataset_uri):
        reals = self._load_images(dataset_uri)
        n = min(256, len(reals))
        fakes = self._trainer.generate(n, seed=123)
        return 1.0 / (1.0 + _kid_mmd(fakes[:n], reals[:n]))

    def predict(self, queries):
        """queries: [[gw, gh, n], ...] -> paths of the written grids."""
        out_paths = []
        for i, q in enumerate(queries):
            gw, gh, n = int(q[0]), int(q[1]), int(q[2])
            imgs = self._trainer.generate(min(n, gw * gh), seed=1000 + i)
            path = os.path.abspath(f"output{i}.npy")
            np.save(path, _to_grid(imgs, gw, gh))
            out_paths.append(path)
        return out_paths

    def dump_parameters(self):
        t = self._trainer
        return {"gs": to_jax_tree(t.gs)[0], "g": to_jax_tree(t.g)[0],
                "d": to_jax_tree(t.d)[0],
                "resolution": self._cfg.resolution,
                "num_channels": self._cfg.num_channels,
                "last_lod": t.last_lod}

    def load_parameters(self, params):
        self._cfg = PgganConfig(resolution=int(params["resolution"]),
                                num_channels=int(params["num_channels"]))
        t = self._trainer = PgganTrainer(self._cfg)
        t.g = build(params["g"], self._cfg, "g", t.device)
        t.d = build(params["d"], self._cfg, "d", t.device)
        t.gs = build(params["gs"], self._cfg, "g",
                     t.device).requires_grad_(False)
        t.last_lod = float(params.get("last_lod", 0.0))


if __name__ == "__main__":
    import tempfile

    from rafiki_tpu_torch.sdk import model
    from rafiki_tpu_torch.sdk.dataset import write_numpy_dataset

    TorchProGan.TOTAL_KIMG = float(
        os.environ.get("TORCHPROGAN_TOTAL_KIMG", "0.2"))
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as d:
        x = rng.normal(size=(128, 16, 16, 3)).astype(np.float32).clip(-1, 1)
        y = np.zeros(128, np.int32)  # unused by the GAN; npz carries it
        train_uri = write_numpy_dataset(x, y, os.path.join(d, "train.npz"))
        test_uri = write_numpy_dataset(x[:64], y[:64],
                                       os.path.join(d, "test.npz"))
        os.chdir(d)  # predict writes grids to cwd
        model.test_model_class(
            clazz=TorchProGan,
            task="IMAGE_GENERATION",
            train_dataset_uri=train_uri,
            test_dataset_uri=test_uri,
            queries=[[2, 2, 4]],
        )
