"""Datasets for model templates: the dense ``.npz``, the image zip and the
corpus zip.

Own copy of ``rafiki_tpu/sdk/dataset.py``:

- ``NumpyDataset`` (an ``.npz`` of ``x`` and ``y``) and
  ``write_numpy_dataset``;
- ``CorpusDataset``: a zip of ``corpus.tsv`` (a token and its tag columns
  a line, sentences separated by blank lines), and
  ``write_corpus_dataset``, its inverse;
- ``ImageFilesDataset``: a zip of ``images.csv`` (columns ``path,class``)
  and PNG files, decoded by the port's own codec (:mod:`.png`; the JAX
  package decodes with PIL, which the port does not use), and
  ``write_image_files_dataset``, its inverse;
- ``dataset_utils.load_image_arrays`` for either format, with its
  in-memory cache, so the trials of one job share one load.

An image whose size differs from the requested ``image_size``, or a
member that is not a PNG the codec reads (a palette or 16-bit PNG, an
interlaced one, a JPEG), raises :class:`InvalidDatasetError`: the JAX
package resizes with PIL's bicubic filter, which the port does not
reproduce (ROADMAP.md). Local paths and ``file://`` URIs resolve; remote
URIs wait (ROADMAP.md).
"""

from __future__ import annotations

import collections
import csv
import io
import os
import zipfile
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from rafiki_tpu_torch.sdk import png


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

    def load_dataset_of_corpus(self, uri: str) -> "CorpusDataset":
        return CorpusDataset(self.download_dataset_from_uri(uri))

    def load_dataset_of_image_files(
        self, uri: str, image_size: Optional[Tuple[int, int]] = None
    ) -> "ImageFilesDataset":
        return ImageFilesDataset(self.download_dataset_from_uri(uri),
                                 image_size)

    def load_image_arrays(
        self, uri: str, image_size: Optional[Tuple[int, int]] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Either format -> (x float32, y int32) dense arrays, cached in
        memory per (file identity, image_size): repeat loads return the
        SAME array objects, which callers must treat as read-only."""
        path = self.download_dataset_from_uri(uri)
        st = os.stat(path)
        key = (path, st.st_mtime_ns, st.st_size, st.st_ino, image_size)
        hit = self._array_cache.get(key)
        if hit is not None:
            self._array_cache.move_to_end(key)
            return hit
        if uri.endswith(".npz"):
            ds = NumpyDataset(path)
            out = (ds.x.astype(np.float32), ds.y.astype(np.int32))
        else:
            x, y = ImageFilesDataset(path, image_size).load_as_arrays()
            out = (x.astype(np.float32), y.astype(np.int32))
        self._array_cache[key] = out
        while len(self._array_cache) > self._array_cache_cap:
            self._array_cache.popitem(last=False)
        return out


class CorpusDataset:
    """Zip of ``corpus.tsv``: tab-separated token and tag columns,
    sentences separated by blank lines. Iterating yields (tokens, tags)
    sentence pairs (``tags`` one list of tag columns a token);
    ``tag_vocabs`` holds each tag column's sorted vocabulary."""

    def __init__(self, path: str):
        self.path = path
        self.sentences: List[Tuple[List[str], List[List[str]]]] = []
        tag_vocab: List[set] = []
        try:
            with zipfile.ZipFile(path) as zf:
                if "corpus.tsv" not in zf.namelist():
                    raise InvalidDatasetError(
                        "corpus zip must contain corpus.tsv")
                with zf.open("corpus.tsv") as f:
                    text = io.TextIOWrapper(f, encoding="utf-8")
                    tokens: List[str] = []
                    tags: List[List[str]] = []
                    for line in text:
                        line = line.rstrip("\n")
                        if not line.strip():
                            if tokens:
                                self.sentences.append((tokens, tags))
                                tokens, tags = [], []
                            continue
                        cols = line.split("\t")
                        tokens.append(cols[0])
                        tags.append(cols[1:])
                        while len(tag_vocab) < len(cols) - 1:
                            tag_vocab.append(set())
                        for i, t in enumerate(cols[1:]):
                            tag_vocab[i].add(t)
                    if tokens:
                        self.sentences.append((tokens, tags))
        except zipfile.BadZipFile as e:
            raise InvalidDatasetError(f"not a zip archive: {path}") from e
        self.tag_num_classes = [len(v) for v in tag_vocab]
        self.tag_vocabs = [sorted(v) for v in tag_vocab]
        self.size = len(self.sentences)
        self.max_len = max((len(t) for t, _ in self.sentences), default=0)

    def __iter__(self) -> Iterator[Tuple[List[str], List[List[str]]]]:
        return iter(self.sentences)

    def __len__(self) -> int:
        return self.size


class ImageFilesDataset:
    """Zip of ``images.csv`` (columns ``path,class``) and PNG files.

    Iterating yields (``uint8`` (H, W, C) array, class), decoded lazily;
    ``load_as_arrays`` decodes the whole set into dense arrays.
    ``image_size`` is (H, W); every image must already have that size.
    """

    def __init__(self, path: str,
                 image_size: Optional[Tuple[int, int]] = None):
        self.path = path
        self._image_size = image_size
        try:
            with zipfile.ZipFile(path) as zf:
                if "images.csv" not in zf.namelist():
                    raise InvalidDatasetError(
                        "image dataset zip must contain images.csv")
                with zf.open("images.csv") as f:
                    rows = list(csv.DictReader(
                        io.TextIOWrapper(f, encoding="utf-8")))
        except zipfile.BadZipFile as e:
            raise InvalidDatasetError(f"not a zip archive: {path}") from e
        if not rows or "path" not in rows[0] or "class" not in rows[0]:
            raise InvalidDatasetError(
                "images.csv must have columns: path, class")
        self._rows = [(r["path"], int(r["class"])) for r in rows]
        self.classes = sorted({c for _, c in self._rows})
        self.label_num_classes = max(self.classes) + 1 if self.classes else 0
        self.size = len(self._rows)

    def __len__(self) -> int:
        return self.size

    def __iter__(self) -> Iterator[Tuple[np.ndarray, int]]:
        with zipfile.ZipFile(self.path) as zf:
            for rel, cls in self._rows:
                yield self._decode(rel, zf.read(rel), self._image_size), cls

    @staticmethod
    def _decode(rel: str, data: bytes,
                size: Optional[Tuple[int, int]]) -> np.ndarray:
        try:
            pixels = png.decode(data)
        except png.PngError as e:
            raise InvalidDatasetError(f"{rel}: {e}") from e
        if size is not None and pixels.shape[:2] != tuple(size):
            raise InvalidDatasetError(
                f"{rel} is {pixels.shape[0]}x{pixels.shape[1]}, not the "
                f"requested {size[0]}x{size[1]}; resizing is not ported to "
                "rafiki_tpu_torch (ROADMAP.md)")
        return pixels

    def load_as_arrays(
        self, image_size: Optional[Tuple[int, int]] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Every image as (N, H, W, C) float32 in [0, 1], and the int32
        labels."""
        size = image_size or self._image_size
        xs: List[np.ndarray] = []
        with zipfile.ZipFile(self.path) as zf:
            for rel, _ in self._rows:
                xs.append(self._decode(rel, zf.read(rel), size))
        if not xs:
            raise InvalidDatasetError("image dataset holds no images")
        try:
            x = np.stack(xs)
        except ValueError as e:
            raise InvalidDatasetError(
                f"images of different shapes: {e}") from e
        return (x.astype(np.float32) / 255.0,
                np.asarray([c for _, c in self._rows], dtype=np.int32))


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


def write_image_files_dataset(images: np.ndarray, labels: np.ndarray,
                              out_path: str) -> str:
    """An image-zip dataset from dense arrays (the inverse of
    :class:`ImageFilesDataset`): float images are clipped to [0, 1] and
    scaled to ``uint8``, as in the JAX package; every PNG row uses
    filter 0."""
    with zipfile.ZipFile(out_path, "w", zipfile.ZIP_STORED) as zf:
        lines = ["path,class"]
        for i, (img, lbl) in enumerate(zip(images, labels)):
            arr = img
            if arr.dtype != np.uint8:
                arr = (np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)
            rel = f"images/{i}.png"
            zf.writestr(rel, png.encode(arr))
            lines.append(f"{rel},{int(lbl)}")
        zf.writestr("images.csv", "\n".join(lines) + "\n")
    return out_path


def write_corpus_dataset(
        sentences: Sequence[Tuple[Sequence[str], Sequence[Sequence[str]]]],
        out_path: str) -> str:
    """A corpus zip from (tokens, tags) sentence pairs (the inverse of
    :class:`CorpusDataset`); the same bytes as the JAX package's
    writer."""
    lines: List[str] = []
    for tokens, tags in sentences:
        for tok, row_tags in zip(tokens, tags):
            lines.append("\t".join([tok, *row_tags]))
        lines.append("")
    with zipfile.ZipFile(out_path, "w") as zf:
        zf.writestr("corpus.tsv", "\n".join(lines) + "\n")
    return out_path


def write_numpy_dataset(x: np.ndarray, y: np.ndarray, out_path: str) -> str:
    np.savez_compressed(out_path, x=x, y=y)
    return out_path


#: module singleton, as in the JAX package
dataset_utils = DatasetUtils()
