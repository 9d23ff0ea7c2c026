"""Batched prediction in padded buckets.

Counterpart of the predict half of ``DataParallelTrainer`` in
``rafiki_tpu/sdk/jax_backend.py``: the power-of-two bucket ladder, the
pad-with-repeat chunking, ``predict_batched`` and ``warm_predict``. The
class keeps its name; the training half lands in it with the training
slice. One device per trainer in this slice (multi-GPU: ROADMAP.md).

PyTorch compiles nothing per shape, but the ladder still bounds the set
of shapes the kernels see, and ``warm_predict`` builds and loads every
kernel before the first real request.
"""

from __future__ import annotations

from typing import Callable, Iterator, List, Tuple

import numpy as np
import torch

from rafiki_tpu_torch.device import default_device


class DataParallelTrainer:
    # padding 1 query to 8 wastes little, and bounds the shapes served
    MIN_PREDICT_BUCKET = 8

    def __init__(self, predict_fn: Callable[[torch.Tensor], torch.Tensor],
                 device=None):
        """``predict_fn`` maps a batch tensor on ``device`` to a batch of
        outputs; ``device`` defaults to :func:`default_device`."""
        self.predict_fn = predict_fn
        self.device = default_device(device)

    def predict_buckets(self, cap: int) -> List[int]:
        """Powers of two from MIN_PREDICT_BUCKET up to ``cap``, and ``cap``."""
        buckets = []
        b = self.MIN_PREDICT_BUCKET
        while b < cap:
            buckets.append(b)
            b *= 2
        buckets.append(cap)
        return sorted(set(buckets))

    def _bucket_for(self, n: int, cap: int) -> int:
        buckets = self.predict_buckets(cap)
        return next((b for b in buckets if b >= n), buckets[-1])

    def _bucket_chunks(self, x: np.ndarray,
                       batch_size: int) -> Iterator[Tuple[np.ndarray, int]]:
        """``(padded_chunk, pad)`` per bucket; a chunk is padded by
        repeating its last row."""
        n = len(x)
        cap = max(batch_size, 1)
        i = 0
        while i < n:
            chunk = x[i: i + cap]
            pad = self._bucket_for(len(chunk), cap) - len(chunk)
            if pad:
                chunk = np.concatenate(
                    [chunk, np.repeat(chunk[-1:], pad, axis=0)])
            yield chunk, pad
            i += len(chunk) - pad

    def _run_predict(self, chunk: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            x = torch.from_numpy(np.ascontiguousarray(chunk)).to(self.device)
            return self.predict_fn(x).cpu().numpy()

    def predict_batched(self, x: np.ndarray,
                        batch_size: int = 256) -> np.ndarray:
        """Run ``predict_fn`` over ``x`` in padded buckets; the padding rows
        are dropped from the result."""
        outs = []
        for chunk, pad in self._bucket_chunks(x, batch_size):
            out = self._run_predict(chunk)
            outs.append(out[: len(out) - pad] if pad else out)
        return np.concatenate(outs) if outs else np.zeros((0,))

    def warm_predict(self, example: np.ndarray,
                     batch_size: int = 256) -> int:
        """Run every bucket once on copies of ``example`` (one query), so
        kernels are built and loaded before real traffic. Returns the
        number of buckets warmed."""
        example = np.asarray(example)
        buckets = self.predict_buckets(max(batch_size, 1))
        for b in buckets:
            self._run_predict(
                np.broadcast_to(example[None], (b,) + example.shape))
        return len(buckets)
