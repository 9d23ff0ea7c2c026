"""Dense feed-forward classifier.

Counterpart of ``rafiki_tpu/models/feedforward.py``: each image flattened
in its NHWC order (a channels-first flatten would pair the carried-over
weights with other pixels), ``hidden_layers`` relu dense layers, and a
dense head. bf16 compute, f32 logits.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from rafiki_tpu_torch.models import core


@dataclass(frozen=True)
class FeedForwardConfig:
    in_dim: int = 784
    hidden_layers: int = 1
    hidden_units: int = 128
    num_classes: int = 10


def init(rng: np.random.Generator, cfg: FeedForwardConfig) -> dict:
    """A parameter tree in the JAX layout, numpy f32."""
    layers, d = [], cfg.in_dim
    for _ in range(cfg.hidden_layers):
        layers.append(core.dense_init(rng, d, cfg.hidden_units))
        d = cfg.hidden_units
    return {"layers": layers,
            "head": core.dense_init(rng, d, cfg.num_classes)}


class FeedForward(torch.nn.Module):
    """x (B, ...) -> logits (B, num_classes) f32."""

    def __init__(self, cfg: FeedForwardConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dims = [cfg.in_dim] + [cfg.hidden_units] * cfg.hidden_layers
        self.layers = torch.nn.ModuleList(
            core.Dense(a, b, device) for a, b in zip(dims, dims[1:]))
        self.head = core.Dense(dims[-1], cfg.num_classes, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = core.cast_for_compute(x.reshape(x.shape[0], -1))
        for layer in self.layers:
            x = torch.relu(layer(x))
        return self.head(x).float()
