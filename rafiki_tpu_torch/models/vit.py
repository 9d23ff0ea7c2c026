"""Vision Transformer.

Counterpart of ``rafiki_tpu/models/vit.py``: patchify as one product,
learned position embeddings, the pre-LN transformer stack, a final
layernorm, global average pooling (no cls token, so S = 196 at 224/16)
and a dense head. Images are cast to bf16; logits come out in f32.

:func:`apply` takes the module's tree or a JAX-layout one (a train
mesh's shard of it, ``parallel/sharding.py``). Under a mesh the batch is
split over ``data`` and the patch sequence over ``seq``: each rank runs
the encoder on its positions, and the pooled mean is a ``psum`` of the
shards' sums (its backward a ``psum`` too: the rows, and so the loss, are
the same on every ``seq`` rank, each holding a share).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from rafiki_tpu_torch.models import core
from rafiki_tpu_torch.models.transformer import (
    Stack,
    TransformerConfig,
    block_init,
    block_partition_specs,
    stack_apply,
    stack_trees,
)
from rafiki_tpu_torch.parallel import collectives as C
from rafiki_tpu_torch.parallel.sharding import P, current_mesh


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


def apply(params: dict, images: torch.Tensor, cfg: ViTConfig,
          rng: Optional[np.ndarray] = None,
          deterministic: bool = True) -> torch.Tensor:
    """images (B, H, W, C) float -> logits (B, num_classes) f32;
    ``params`` in the JAX layout (blocks stacked, or a list of per-layer
    trees), ``rng`` a ``utils/jrandom`` key for dropout."""
    x = core.patch_project(params["patch"], core.cast_for_compute(images))
    x = x + params["pos"].to(x.dtype)
    mesh = current_mesh()
    sp = mesh.group("seq") if mesh is not None else None
    if sp is not None:
        x = x.chunk(sp.size, 1)[sp.rank]
    x, _ = stack_apply(params["blocks"], x, cfg.encoder, rng, deterministic)
    x = core.layernorm(params["ln_f"], x)
    if sp is None:
        x = x.mean(dim=1)  # GAP
    else:
        x = (C.psum(x.float().sum(1), sp) / cfg.seq_len).to(x.dtype)
    return core.dense(params["head"], x).float()


def partition_specs(cfg: ViTConfig) -> dict:
    """Param PartitionSpecs: transformer blocks TP-sharded (and pipe-sharded
    on their stacked depth axis); everything else replicated."""
    return {
        "patch": {"kernel": P(None, None, None, None), "bias": P(None)},
        "pos": P(None, None, None),
        "blocks": block_partition_specs(cfg.encoder, stacked=True),
        "ln_f": {"scale": P(None), "bias": P(None)},
        "head": {"kernel": P(None, None), "bias": P(None)},
    }


def batch_spec() -> Any:
    """Activations: batch over data, sequence over seq (SP), features full."""
    return P("data", None, None, None)


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

    def tree(self) -> dict:
        """The parameters as the JAX layout's tree, a block a list item."""
        own = core.own_params
        return {"patch": own(self.patch), "pos": self.pos,
                "blocks": [b.tree() for b in self.blocks],
                "ln_f": own(self.ln_f), "head": own(self.head)}

    def forward(self, images: torch.Tensor,
                rng: Optional[np.ndarray] = None,
                deterministic: bool = True) -> torch.Tensor:
        return apply(self.tree(), images, self.cfg, rng, deterministic)
