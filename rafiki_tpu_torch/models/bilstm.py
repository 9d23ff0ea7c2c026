"""BiLSTM sequence tagger.

Counterpart of ``rafiki_tpu/models/bilstm.py``: an embedding (f32), a
forward and a backward LSTM whose four gates (i, f, g, o) come from one
(D, 4H) product of the input and one (H, 4H) product of the state, with a
single bias, and a dense head over the two directions' states. A padded
position (mask 0) holds h and c: the state stops at a sequence's end and
is carried, unchanged, through the padding. The backward direction is the
same scan over the reversed sequence and the reversed mask, so its state
stays 0 through the leading padding, and its states are reversed back.

The scan is written out, one step per token, with both directions in one
batched product a step (``baddbmm`` over a leading direction axis), not
``nn.LSTM``: cuDNN's packed sequences write 0 at padded positions where
the JAX scan carries the last state, and its two biases and gate order
would need their own conversion. Parameters are the JAX tree's
(``embed/table``, ``fwd/wx``, ``fwd/wh``, ``fwd/b``, ``bwd/...``,
``head/kernel``, ``head/bias``); :func:`init` draws them from a numpy
generator at the JAX package's scalings.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from rafiki_tpu_torch.models import core


@dataclass(frozen=True)
class BiLstmConfig:
    vocab: int = 10000
    n_tags: int = 50
    embed_dim: int = 64
    hidden: int = 128
    max_len: int = 128


def _lstm_init(rng: np.random.Generator, in_dim: int, hidden: int) -> dict:
    g = 4 * hidden
    return {"wx": core.xavier_uniform(rng, (in_dim, g), in_dim, g),
            "wh": core.xavier_uniform(rng, (hidden, g), hidden, g),
            "b": np.zeros((g,), np.float32)}


def init(rng: np.random.Generator, cfg: BiLstmConfig) -> dict:
    """The JAX-layout parameter tree (numpy)."""
    return {"embed": core.embedding_init(rng, cfg.vocab, cfg.embed_dim),
            "fwd": _lstm_init(rng, cfg.embed_dim, cfg.hidden),
            "bwd": _lstm_init(rng, cfg.embed_dim, cfg.hidden),
            "head": core.dense_init(rng, 2 * cfg.hidden, cfg.n_tags)}


class Lstm(torch.nn.Module):
    def __init__(self, in_dim: int, hidden: int):
        super().__init__()
        self.wx = torch.nn.Parameter(torch.empty(in_dim, 4 * hidden))
        self.wh = torch.nn.Parameter(torch.empty(hidden, 4 * hidden))
        self.b = torch.nn.Parameter(torch.empty(4 * hidden))


class BiLstm(torch.nn.Module):
    """(ids, mask) (B, T) -> per-token tag logits (B, T, n_tags) f32."""

    def __init__(self, cfg: BiLstmConfig):
        super().__init__()
        self.embed = core.Embedding(cfg.vocab, cfg.embed_dim)
        self.fwd = Lstm(cfg.embed_dim, cfg.hidden)
        self.bwd = Lstm(cfg.embed_dim, cfg.hidden)
        self.head = core.Dense(2 * cfg.hidden, cfg.n_tags)

    def forward(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = self.embed(ids, dtype=torch.float32)
        # direction 0 runs over the sequence, 1 over its reverse
        xs = torch.stack([x, x.flip(1)])                     # (2, B, T, D)
        ms = torch.stack([mask, mask.flip(1)]) > 0           # (2, B, T)
        wx = torch.stack([self.fwd.wx, self.bwd.wx])         # (2, D, 4H)
        wh = torch.stack([self.fwd.wh, self.bwd.wh])         # (2, H, 4H)
        b = torch.stack([self.fwd.b, self.bwd.b])[:, None, None]
        hs = _scan(torch.einsum("sbtd,sdg->sbtg", xs, wx) + b, ms, wh)
        h = torch.cat([hs[0], hs[1].flip(1)], dim=-1)
        return self.head(h).float()


def _scan(xg: torch.Tensor, mask: torch.Tensor,
          wh: torch.Tensor) -> torch.Tensor:
    """xg (S, B, T, 4H): the input's gate terms with the bias; mask (S,
    B, T) bool; wh (S, H, 4H) -> the hidden states (S, B, T, H). A masked
    step keeps the carried h and c."""
    s, b, t, g4 = xg.shape
    hidden = g4 // 4
    h = xg.new_zeros(s, b, hidden)
    c = xg.new_zeros(s, b, hidden)
    out = []
    for step in range(t):
        gates = torch.baddbmm(xg[:, :, step], h, wh)
        sig = torch.sigmoid(gates)
        i, f, o = (sig[..., :hidden], sig[..., hidden:2 * hidden],
                   sig[..., 3 * hidden:])
        g = torch.tanh(gates[..., 2 * hidden:3 * hidden])
        c_new = f * c + i * g
        h_new = o * torch.tanh(c_new)
        m = mask[:, :, step, None]
        h = torch.where(m, h_new, h)
        c = torch.where(m, c_new, c)
        out.append(h)
    return torch.stack(out, dim=2)
