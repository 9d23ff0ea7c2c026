"""Datasets for model templates: the dense ``.npz`` path.

Own copy of the ``.npz`` path of ``rafiki_tpu/sdk/dataset.py``:
``NumpyDataset``, ``dataset_utils.load_image_arrays`` for ``.npz`` files
(with its in-memory cache, so the trials of one job share one load) and
``write_numpy_dataset``. Local paths and ``file://`` URIs resolve; remote
URIs come with the control-plane slice. The image-zip format
(``ImageFilesDataset``) decodes with PIL, which the machine with the card
lacks: asking for it raises :class:`InvalidDatasetError` (ROADMAP.md).
"""

from __future__ import annotations

import collections
import os
from typing import Optional, Tuple

import numpy as np


class InvalidDatasetError(Exception):
    pass


class DatasetUtils:
    """Facade exposed to model code as ``dataset_utils``."""

    def __init__(self) -> None:
        # successive trials of one job load the SAME dataset: keyed by
        # (resolved path, mtime, size, inode, image_size); a worker serves
        # one job (train + test sets), so a tiny LRU is enough
        self._array_cache: "collections.OrderedDict" = \
            collections.OrderedDict()
        self._array_cache_cap = 4

    def download_dataset_from_uri(self, uri: str) -> str:
        """Resolve a dataset URI to a local file path."""
        if uri.startswith("file://"):
            return uri[len("file://"):]
        if uri.startswith(("http://", "https://")):
            raise InvalidDatasetError(
                f"remote dataset URIs are not ported to rafiki_tpu_torch "
                f"yet (ROADMAP.md): {uri}")
        if not os.path.exists(uri):
            raise InvalidDatasetError(f"Dataset not found: {uri}")
        return uri

    def load_image_arrays(
        self, uri: str, image_size: Optional[Tuple[int, int]] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """An ``.npz`` dataset -> (x float32, y int32) dense arrays, cached
        in memory per file identity: repeat loads return the SAME array
        objects, which callers must treat as read-only."""
        if not uri.endswith(".npz"):
            raise InvalidDatasetError(
                "only .npz datasets are ported to rafiki_tpu_torch; the "
                "image-zip format needs PIL, which is not available on the "
                f"GPU machine (ROADMAP.md): {uri}")
        path = self.download_dataset_from_uri(uri)
        st = os.stat(path)
        key = (path, st.st_mtime_ns, st.st_size, st.st_ino, image_size)
        hit = self._array_cache.get(key)
        if hit is not None:
            self._array_cache.move_to_end(key)
            return hit
        ds = NumpyDataset(path)
        out = (ds.x.astype(np.float32), ds.y.astype(np.int32))
        self._array_cache[key] = out
        while len(self._array_cache) > self._array_cache_cap:
            self._array_cache.popitem(last=False)
        return out


class NumpyDataset:
    """A ``.npz`` with arrays ``x`` and ``y`` — the dense fast path."""

    def __init__(self, path: str):
        with np.load(path) as z:
            if "x" not in z or "y" not in z:
                raise InvalidDatasetError(
                    ".npz dataset must contain arrays x and y")
            self.x = z["x"]
            self.y = z["y"]
        if len(self.x) != len(self.y):
            raise InvalidDatasetError("x and y lengths differ")
        self.size = len(self.x)
        self.label_num_classes = int(self.y.max()) + 1 if self.size else 0

    def __len__(self) -> int:
        return self.size


def write_numpy_dataset(x: np.ndarray, y: np.ndarray, out_path: str) -> str:
    np.savez_compressed(out_path, x=x, y=y)
    return out_path


#: module singleton, as in the JAX package
dataset_utils = DatasetUtils()
