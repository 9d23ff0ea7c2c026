"""Pre-LN transformer blocks and the plain depth loop.

Counterpart of ``rafiki_tpu/models/transformer.py`` (``TransformerConfig``,
``block_apply`` and the scan over stacked layers). Here the depth axis is
split: each layer is its own :class:`Block` in an ``nn.ModuleList``, and
the loop over them is plain Python (PyTorch runs eagerly; there is no
compiled block body to share).

Serving needs none of MoE, ring sequence parallelism, GPipe, remat or
dropout; a config that asks for one raises ``NotImplementedError`` until
the slice that ports it lands (ROADMAP.md).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from rafiki_tpu_torch.models import core
from rafiki_tpu_torch.ops.attention import MultiHeadAttention, attention_init


@dataclass(frozen=True)
class TransformerConfig:
    dim: int = 768
    depth: int = 12
    heads: int = 12
    mlp_ratio: int = 4
    dropout: float = 0.0
    causal: bool = False
    # None: the flash kernel on CUDA tensors, mha_reference on the CPU
    # (ops/attention.py)
    use_flash: Optional[bool] = None
    moe_experts: int = 0
    seq_parallel: Optional[str] = None
    remat: Optional[str] = None
    pipeline: Optional[str] = None
    # one (BS, D) x (D, 3HDh) product for the q/k/v projections
    fused_qkv: bool = False

    def __post_init__(self):
        unported = {
            "moe_experts": self.moe_experts > 0,
            "seq_parallel": self.seq_parallel is not None,
            "remat": self.remat is not None,
            "pipeline": self.pipeline is not None,
            "dropout": self.dropout > 0,
        }
        for name, asked in unported.items():
            if asked:
                raise NotImplementedError(
                    f"TransformerConfig.{name} is not ported to "
                    "rafiki_tpu_torch yet (see ROADMAP.md)")


def block_init(rng: np.random.Generator, cfg: TransformerConfig) -> dict:
    hidden = cfg.dim * cfg.mlp_ratio
    return {
        "ln1": core.layernorm_init(cfg.dim),
        "attn": attention_init(rng, cfg.dim, cfg.heads),
        "ln2": core.layernorm_init(cfg.dim),
        "mlp": {"w1": core.dense_init(rng, cfg.dim, hidden),
                "w2": core.dense_init(rng, hidden, cfg.dim)},
    }


def stack_trees(trees: list) -> dict:
    """Per-layer parameter trees stacked on a leading depth axis, the JAX
    package's layout (``core.stack_layers`` there)."""
    if isinstance(trees[0], dict):
        return {k: stack_trees([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


class Block(torch.nn.Module):
    """One pre-LN block: x + attn(ln1(x)), then x + mlp(ln2(x))."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        hidden = cfg.dim * cfg.mlp_ratio
        self.ln1 = core.LayerNorm(cfg.dim, device)
        self.attn = MultiHeadAttention(cfg.dim, cfg.heads, device)
        self.ln2 = core.LayerNorm(cfg.dim, device)
        self.mlp = torch.nn.ModuleDict({
            "w1": core.Dense(cfg.dim, hidden, device),
            "w2": core.Dense(hidden, cfg.dim, device)})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = x + self.attn(self.ln1(x), causal=cfg.causal,
                          use_flash=cfg.use_flash, fused_qkv=cfg.fused_qkv)
        h = core.gelu(self.mlp["w1"](self.ln2(x)))
        return x + self.mlp["w2"](h)


class Stack(torch.nn.ModuleList):
    """The depth loop over :class:`Block` s."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__([Block(cfg, device) for _ in range(cfg.depth)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self:
            x = block(x)
        return x
