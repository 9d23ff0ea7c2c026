"""TorchGenLM: a small decoder LM that serves ``TEXT_GENERATION``.

The twin of ``tests/fixtures/gen_model.py`` (``TinyGenLM``): the same
knobs (``lr``, ``dim``), the same deterministic token pattern to train on
(``_pattern_batch``: interleaved arithmetic sequences, no dataset file),
three Adam steps, ``evaluate`` the negated loss, a ``GenerationSpec``
with no EOS and a 64-token context, and every decode method the
generation worker drives: the ring (``init_kv_cache``, ``prefill``,
``decode_step``), the paged pool (``init_paged_kv_cache``,
``paged_prefill``, ``paged_decode_step``, ``kv_copy_blocks``) and the
sampled steps (``decode_step_sampled``, ``paged_decode_step_sampled``).
Speculative decoding's methods are not ported (ROADMAP.md).

The architecture beyond the knobs (``arch``: the vocabulary of 64,
``depth`` 1, ``heads`` 2), the training batch and its steps
(``training``: 4 rows of 32 tokens, 3 steps) and the context
(``generation_spec.max_context``) are class attributes, which a subclass
may set; the knob config stays the JAX template's.
Prompts are padded to a power-of-two bucket (to ``max_context`` at most),
as in the JAX template. ``dump_parameters`` hands back the JAX-layout
tree, which ``TinyGenLM.load_parameters`` takes as it is.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from rafiki_tpu_torch.convert import from_jax_params, to_jax_params
from rafiki_tpu_torch.device import default_device
from rafiki_tpu_torch.models import lm
from rafiki_tpu_torch.sdk.knob import FixedKnob, FloatKnob
from rafiki_tpu_torch.sdk.model import BaseModel, GenerationSpec

_VOCAB = 64
_MAX_CONTEXT = 64
# no EOS: a 3-step-trained LM's greedy argmax can land on any token, and
# the drills need streams of exact lengths
_EOS = None


def _pattern_batch(n_rows: int = 4, seq: int = 32, vocab: int = _VOCAB):
    """Deterministic next-token data: interleaved arithmetic sequences."""
    base = np.arange(n_rows * seq, dtype=np.int64).reshape(n_rows, seq)
    ids = ((base * 3 + 2) % vocab).astype(np.int32)
    return ids, np.ones((n_rows, seq), np.float32)


def _buckets(max_context: int) -> List[int]:
    """Prompt buckets: powers of two from 8, and ``max_context``."""
    out, b = [], 8
    while b < max_context:
        out.append(b)
        b *= 2
    return out + [max_context]


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


class TorchGenLM(BaseModel):
    dependencies = {"numpy": None}
    generation_spec = GenerationSpec(eos_token_id=_EOS,
                                     max_context=_MAX_CONTEXT)
    arch = {"vocab": _VOCAB, "depth": 1, "heads": 2}
    training = (4, 32, 3)  # rows, tokens a row, Adam steps

    @staticmethod
    def get_knob_config():
        return {
            "lr": FloatKnob(1e-3, 1e-1, is_exp=True),
            "dim": FixedKnob(16),
        }

    def __init__(self, **knobs: Any):
        super().__init__(**knobs)
        self._max_context = type(self).generation_spec.max_context
        self._cfg = lm.tiny(max_len=self._max_context,
                            dim=int(self._knobs.get("dim", 16)),
                            **type(self).arch)
        self._buckets = _buckets(self._max_context)
        self._model = None

    def _batch(self, device):
        rows, seq, _ = type(self).training
        ids, mask = _pattern_batch(rows, seq, self._cfg.vocab)
        return (torch.from_numpy(ids).to(device),
                torch.from_numpy(mask).to(device))

    def train(self, dataset_uri: str) -> None:
        device = default_device()
        self._model = from_jax_params(
            lm.init(np.random.default_rng(0), self._cfg), self._cfg, device,
            train=True)
        # optax.adam's defaults
        opt = torch.optim.Adam(self._model.parameters(),
                               lr=float(self._knobs.get("lr", 1e-2)),
                               betas=(0.9, 0.999), eps=1e-8)
        batch = self._batch(device)
        for _ in range(type(self).training[2]):
            loss, _ = lm.loss_fn(self._model, batch)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
        self._model.eval()

    def evaluate(self, dataset_uri: str) -> float:
        with torch.inference_mode():
            loss, _ = lm.loss_fn(self._model, self._batch(self._device()))
        return float(-loss)

    def predict(self, queries: List[Any]) -> List[Any]:
        """Each query is a prompt-id list; its prediction an 8-token
        greedy completion (the streaming door is the serving path)."""
        out = []
        for q in queries:
            cache = self.init_kv_cache(1)
            tok, cache = self.prefill(cache, 0, list(q))
            toks = [tok]
            for _ in range(7):
                ids = np.array([tok], np.int32)
                pos = np.array([len(q) + len(toks) - 1], np.int32)
                nxt, cache = self.decode_step(cache, ids, pos)
                tok = int(nxt[0])
                toks.append(tok)
            out.append(toks)
        return out

    def dump_parameters(self) -> Dict[str, Any]:
        return to_jax_params(self._model)

    def load_parameters(self, params: Dict[str, Any]) -> None:
        self._model = from_jax_params(params, self._cfg)

    def _device(self) -> torch.device:
        return self._model.embed.table.device

    def _padded(self, prompt_ids: List[int]) -> np.ndarray:
        n = len(prompt_ids)
        bucket = next(b for b in self._buckets if b >= n)
        ids = np.zeros(bucket, np.int32)
        ids[:n] = prompt_ids
        return ids

    # -- the generation contract -------------------------------------------

    def init_kv_cache(self, max_slots: int):
        return lm.init_kv_cache(self._cfg, max_slots,
                                max_len=self._max_context,
                                device=self._device())

    def prefill(self, cache, slot, prompt_ids):
        logits, cache = lm.prefill(self._model, cache, slot,
                                   self._padded(prompt_ids), len(prompt_ids))
        return int(lm.greedy_token(logits)), cache

    def decode_step(self, cache, ids, positions):
        logits, cache = lm.decode_step(self._model, cache, ids, positions)
        return _host(lm.greedy_token(logits)), cache

    def init_paged_kv_cache(self, pool_blocks: int, block_tokens: int):
        return lm.init_paged_kv_cache(self._cfg, pool_blocks, block_tokens,
                                      device=self._device())

    def paged_prefill(self, cache, block_table, prompt_ids, start):
        logits, cache = lm.paged_prefill(
            self._model, cache, block_table, self._padded(prompt_ids),
            int(start), len(prompt_ids))
        return int(lm.greedy_token(logits)), cache

    def paged_decode_step(self, cache, ids, positions, block_tables):
        logits, cache = lm.paged_decode_step(self._model, cache, ids,
                                             positions, block_tables)
        return _host(lm.greedy_token(logits)), cache

    def kv_copy_blocks(self, cache, src, dst):
        return lm.copy_kv_blocks(cache, src, dst)

    def decode_step_sampled(self, cache, ids, positions, sampling):
        tok, probs, cache = lm.decode_step_sampled(self._model, cache, ids,
                                                   positions, sampling)
        return _host(tok), probs, cache

    def paged_decode_step_sampled(self, cache, ids, positions,
                                  block_tables, sampling):
        tok, probs, cache = lm.paged_decode_step_sampled(
            self._model, cache, ids, positions, block_tables, sampling)
        return _host(tok), probs, cache
