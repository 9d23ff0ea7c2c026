"""Vision Transformer.

Counterpart of ``rafiki_tpu/models/vit.py``: patchify as one product,
learned position embeddings, the pre-LN transformer stack, a final
layernorm, global average pooling (no cls token, so S = 196 at 224/16)
and a dense head. Images are cast to bf16; logits come out in f32.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from rafiki_tpu_torch.models import core
from rafiki_tpu_torch.models.transformer import (
    Stack,
    TransformerConfig,
    block_init,
    stack_trees,
)


@dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    channels: int = 3
    num_classes: int = 1000
    encoder: TransformerConfig = field(default_factory=TransformerConfig)

    @property
    def seq_len(self) -> int:
        return (self.image_size // self.patch_size) ** 2


def vit_b16(num_classes: int = 1000, image_size: int = 224) -> ViTConfig:
    return ViTConfig(image_size=image_size, num_classes=num_classes,
                     encoder=TransformerConfig(dim=768, depth=12, heads=12))


def tiny(num_classes: int = 10, image_size: int = 32, patch_size: int = 4,
         dim: int = 64, depth: int = 2, heads: int = 4) -> ViTConfig:
    """A test-scale config."""
    return ViTConfig(image_size=image_size, patch_size=patch_size,
                     num_classes=num_classes,
                     encoder=TransformerConfig(dim=dim, depth=depth,
                                               heads=heads))


def init(rng: np.random.Generator, cfg: ViTConfig) -> dict:
    """A parameter tree in the JAX package's layout, numpy f32, with the
    block parameters stacked on a leading depth axis (``core.stack_layers``
    there)."""
    p, dim = cfg.patch_size, cfg.encoder.dim
    blocks = [block_init(rng, cfg.encoder) for _ in range(cfg.encoder.depth)]
    return {
        "patch": core.conv2d_init(rng, p, p, cfg.channels, dim),
        "pos": core.normal_init(rng, (1, cfg.seq_len, dim)),
        "blocks": stack_trees(blocks),
        "ln_f": core.layernorm_init(dim),
        "head": core.dense_init(rng, dim, cfg.num_classes),
    }


class ViT(torch.nn.Module):
    """images (B, H, W, C) float -> logits (B, num_classes) f32."""

    def __init__(self, cfg: ViTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dim = cfg.encoder.dim
        self.patch = core.PatchEmbed(cfg.patch_size, cfg.channels, dim, device)
        self.pos = torch.nn.Parameter(
            torch.empty(1, cfg.seq_len, dim, dtype=torch.float32,
                        device=device))
        self.blocks = Stack(cfg.encoder, device)
        self.ln_f = core.LayerNorm(dim, device)
        self.head = core.Dense(dim, cfg.num_classes, device)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = self.patch(core.cast_for_compute(images))
        x = x + self.pos.to(x.dtype)
        x = self.ln_f(self.blocks(x))
        return self.head(x.mean(dim=1)).float()
