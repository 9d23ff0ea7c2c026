"""VGG-style convnet.

Counterpart of ``rafiki_tpu/models/vgg.py``: stages of 3x3 ``"SAME"``
relu convolutions, each stage closed by a 2x2 ``"VALID"`` max pool, then
a global average pool, a relu ``fc1`` and a dense head. NHWC, bf16
compute, f32 logits.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from rafiki_tpu_torch.models import core

VGG16_PLAN: Sequence[Sequence[int]] = (
    (64, 64), (128, 128), (256, 256, 256), (512, 512, 512), (512, 512, 512))
VGG_SMALL_PLAN: Sequence[Sequence[int]] = ((32, 32), (64, 64), (128, 128))


@dataclass(frozen=True)
class VggConfig:
    plan: Sequence[Sequence[int]] = VGG_SMALL_PLAN
    channels: int = 3
    dense_units: int = 256
    num_classes: int = 10


def _conv_dims(cfg: VggConfig):
    cin = cfg.channels
    for stage in cfg.plan:
        for cout in stage:
            yield cin, cout
            cin = cout


def init(rng: np.random.Generator, cfg: VggConfig) -> dict:
    """A parameter tree in the JAX layout, numpy f32."""
    convs = [core.conv2d_init(rng, 3, 3, cin, cout)
             for cin, cout in _conv_dims(cfg)]
    cin = cfg.plan[-1][-1]
    return {"convs": convs,
            "fc1": core.dense_init(rng, cin, cfg.dense_units),
            "head": core.dense_init(rng, cfg.dense_units, cfg.num_classes)}


class Vgg(torch.nn.Module):
    """images (B, H, W, C) -> logits (B, num_classes) f32."""

    def __init__(self, cfg: VggConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.convs = torch.nn.ModuleList(
            core.Conv2d(3, 3, cin, cout, device)
            for cin, cout in _conv_dims(cfg))
        self.fc1 = core.Dense(cfg.plan[-1][-1], cfg.dense_units, device)
        self.head = core.Dense(cfg.dense_units, cfg.num_classes, device)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = core.cast_for_compute(images)
        convs = iter(self.convs)
        for stage in self.cfg.plan:
            for _ in stage:
                x = torch.relu(next(convs)(x))
            x = core.max_pool(x, 2, 2, "VALID")
        x = x.mean(dim=(1, 2))  # global average pool
        x = torch.relu(self.fc1(x))
        return self.head(x).float()
