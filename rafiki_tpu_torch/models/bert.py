"""BERT-style encoder for text classification.

Counterpart of ``rafiki_tpu/models/bert.py``: token and learned position
embeddings, the non-causal pre-LN transformer stack
(``models/transformer.py``), a final layernorm, first-token pooling
(``tanh(dense(x[:, 0]))``) and a dense head. As there, there is no
padding mask (pad id 0 is attended like any token), activations run in
bf16 and the logits come out in f32.
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
class BertConfig:
    vocab: int = 30522
    max_len: int = 512
    num_classes: int = 2
    encoder: TransformerConfig = field(default_factory=TransformerConfig)


def bert_base(num_classes: int = 2) -> BertConfig:
    return BertConfig(num_classes=num_classes,
                      encoder=TransformerConfig(dim=768, depth=12, heads=12))


def tiny(vocab: int = 1000, max_len: int = 64, num_classes: int = 2,
         dim: int = 64, depth: int = 2, heads: int = 4) -> BertConfig:
    return BertConfig(vocab=vocab, max_len=max_len, num_classes=num_classes,
                      encoder=TransformerConfig(dim=dim, depth=depth,
                                                heads=heads))


def init(rng: np.random.Generator, cfg: BertConfig) -> dict:
    """A parameter tree in the JAX package's layout, numpy f32, blocks
    stacked on a leading depth axis."""
    dim = cfg.encoder.dim
    return {
        "embed": core.embedding_init(rng, cfg.vocab, dim),
        "pos": core.normal_init(rng, (1, cfg.max_len, dim)),
        "blocks": stack_trees([block_init(rng, cfg.encoder)
                               for _ in range(cfg.encoder.depth)]),
        "ln_f": core.layernorm_init(dim),
        "pool": core.dense_init(rng, dim, dim),
        "head": core.dense_init(rng, dim, cfg.num_classes),
    }


class Bert(torch.nn.Module):
    """ids (B, S) int -> logits (B, num_classes) f32, computed in
    ``dtype`` (bf16 by default, as the JAX forward)."""

    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dim = cfg.encoder.dim
        self.embed = core.Embedding(cfg.vocab, dim, device)
        self.pos = torch.nn.Parameter(torch.empty(
            1, cfg.max_len, dim, dtype=torch.float32, device=device))
        self.blocks = Stack(cfg.encoder, device)
        self.ln_f = core.LayerNorm(dim, device)
        self.pool = core.Dense(dim, dim, device)
        self.head = core.Dense(dim, cfg.num_classes, device)

    def forward(self, ids: torch.Tensor,
                dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        x = self.embed(ids.long(), dtype)
        x = x + self.pos[:, :ids.shape[1]].to(x.dtype)
        x = self.ln_f(self.blocks(x))
        pooled = torch.tanh(self.pool(x[:, 0]))
        return self.head(pooled).float()
