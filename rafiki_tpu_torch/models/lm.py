"""Decoder-only transformer LM and its KV-cached decode.

Counterpart of ``rafiki_tpu/models/lm.py``: a causal pre-LN transformer
over token ids with a tied output head (``logits = x @ table^T``), its
next-token loss, and the decode path the generation worker drives:

- the contiguous ring cache (:func:`init_kv_cache`, :func:`prefill`,
  :func:`decode_step`): per-layer K/V of ``(depth, slots, max_len, heads,
  head_dim)``;
- the paged cache (:func:`init_paged_kv_cache`, :func:`paged_prefill`,
  :func:`paged_decode_step`, :func:`copy_kv_blocks`): a pool of
  ``block_tokens``-row pages and per-slot block tables; a forward gathers
  the slot's logical view from the pool, runs the same
  :func:`_cached_forward` as the ring, and writes back only the new rows;
- sampling keyed by position (:func:`modified_dist`,
  :func:`sample_from`, :func:`_uniform_at`, the ``*_sampled`` steps);
- speculative decoding: the draft's burst of k chained sampled steps
  (:func:`decode_steps_sampled`) and the target's verify of k+1
  positions in one forward with rejection sampling
  (:func:`paged_verify_step`).

Differences of form, not of result:

- JAX's caches are values; here they are tensors updated in place, and
  each function returns the same dict it was given.
- Writes that JAX drops (``mode="drop"``: sentinel table entries,
  positions past the table) are never issued here: the rows to write are
  chosen on the host from the block tables and positions, which are host
  integer arrays (numpy, lists or CPU tensors) in every call.
- The draws' uniforms are computed on the host in numpy
  (:func:`_uniform_at`: threefry2x32, ``fold_in`` and the mantissa trick
  of ``jax.random.uniform``, bit for bit), since their inputs, the
  streams' seeds and positions, live there. A draft's burst and a
  verify know every position they draw at before they start, so their
  uniforms are made up front and neither waits on the card mid-call:
  the burst feeds each sampled token to the next step as a device
  tensor, and the verify picks its bonus draw's uniform on the card.

``apply`` (training and evaluation) runs attention through the flash
kernels on a CUDA tensor (``ops/attention.py``); the cached forward is
plain products and softmax, as the JAX package's is (no Pallas there).
MoE and the partition specs are not ported (ROADMAP.md).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from rafiki_tpu_torch.models import core
from rafiki_tpu_torch.models.transformer import (
    Stack,
    TransformerConfig,
    block_init,
    stack_trees,
)
# the draws' roles: a target draw, a draft's proposal, an accept test
from rafiki_tpu_torch.sdk.model import (  # noqa: F401
    ROLE_ACCEPT,
    ROLE_DRAFT,
    ROLE_TARGET,
)
from rafiki_tpu_torch.utils.jrandom import threefry2x32

Cache = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class LMConfig:
    vocab: int = 32000
    max_len: int = 2048
    encoder: TransformerConfig = field(
        default_factory=lambda: TransformerConfig(causal=True))


def tiny(vocab: int = 256, max_len: int = 128, dim: int = 64, depth: int = 2,
         heads: int = 4, **encoder_kw) -> LMConfig:
    """``encoder_kw`` passes through to TransformerConfig."""
    return LMConfig(vocab=vocab, max_len=max_len,
                    encoder=TransformerConfig(dim=dim, depth=depth,
                                              heads=heads, causal=True,
                                              **encoder_kw))


def init(rng: np.random.Generator, cfg: LMConfig) -> dict:
    """A parameter tree in the JAX package's layout, numpy f32, blocks
    stacked on a leading depth axis."""
    dim = cfg.encoder.dim
    return {
        "embed": core.embedding_init(rng, cfg.vocab, dim),
        "pos": core.normal_init(rng, (1, cfg.max_len, dim)),
        "blocks": stack_trees([block_init(rng, cfg.encoder)
                               for _ in range(cfg.encoder.depth)]),
        "ln_f": core.layernorm_init(dim),
    }


class LM(torch.nn.Module):
    """ids (B, S) int -> logits (B, S, vocab) f32, computed in ``dtype``
    (bf16 by default, as the JAX forward)."""

    def __init__(self, cfg: LMConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dim = cfg.encoder.dim
        self.embed = core.Embedding(cfg.vocab, dim, device)
        self.pos = torch.nn.Parameter(torch.empty(
            1, cfg.max_len, dim, dtype=torch.float32, device=device))
        self.blocks = Stack(cfg.encoder, device)
        self.ln_f = core.LayerNorm(dim, device)

    def forward(self, ids: torch.Tensor,
                dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        x = self.embed(ids.long(), dtype)
        x = x + self.pos[:, :ids.shape[1]].to(x.dtype)
        x = self.ln_f(self.blocks(x))
        # tied output head
        logits = torch.einsum("bsd,vd->bsv", x, self.embed.table.to(x.dtype))
        return logits.float()


def apply(model: LM, ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(logits (B, S, V) f32, the MoE aux loss: 0 for dense blocks)."""
    logits = model(ids)
    return logits, torch.zeros((), device=logits.device)


def loss_fn(model: LM, batch: Tuple[torch.Tensor, torch.Tensor],
            aux_weight: float = 1e-2) -> Tuple[torch.Tensor, dict]:
    """Next-token cross-entropy, the masked mean over the targets
    (optax's per-token loss, summed under the mask, over the mask's
    count); batch = (ids, mask)."""
    ids, mask = batch
    logits, aux = apply(model, ids)
    targets = ids[:, 1:].long()
    lm_mask = mask[:, 1:].float()
    ce = F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                         targets.reshape(-1), reduction="none")
    ce = ce.reshape(targets.shape)
    loss = (ce * lm_mask).sum() / lm_mask.sum().clamp_min(1.0)
    return loss + aux_weight * aux, {"ce": loss, "moe_aux": aux}


# -- the decode path -----------------------------------------------------------


def _host_ints(a: Any) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.cpu().numpy()
    return np.ascontiguousarray(a, np.int64)


def init_kv_cache(cfg: LMConfig, max_slots: int,
                  max_len: Optional[int] = None, dtype=torch.float32,
                  device=None) -> Cache:
    """The ring: per-layer K/V of ``(depth, max_slots, max_len, heads,
    head_dim)``, zeros; ``max_len`` defaults to ``cfg.max_len``."""
    enc = cfg.encoder
    shape = (enc.depth, int(max_slots), int(max_len or cfg.max_len),
             enc.heads, enc.dim // enc.heads)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def cache_max_len(cache: Cache) -> int:
    return int(cache["k"].shape[2])


def cache_max_slots(cache: Cache) -> int:
    return int(cache["k"].shape[1])


def _cached_forward(model: LM, ck: torch.Tensor, cv: torch.Tensor,
                    ids: Any, positions: Any) -> torch.Tensor:
    """The shared prefill/decode forward. ``ids``/``positions``: (B, T)
    host ints, or integer tensors (on the card for a draft's chained
    steps, which then wait on no copy), every position inside the cache's
    length; ``ck``/``cv``:
    (depth, B, L, H, Dh), written in place at ``positions`` before each
    layer's attention, which reads the cache up to each query's own
    position. Returns logits (B, T, V) f32. Computed in the cache's type,
    statistics in f32: the JAX package's ``_cached_forward``."""
    dev = ck.device
    b, _ = ids.shape
    length = ck.shape[2]
    dt = ck.dtype
    pos, ids = (t if isinstance(t, torch.Tensor)
                else torch.from_numpy(np.ascontiguousarray(t))
                for t in (positions, ids))
    pos = pos.to(dev)
    x = model.embed(ids.to(dev, torch.int64), dt)
    x = x + model.pos[0].to(dt)[pos]
    batch_ix = torch.arange(b, device=dev)[:, None]
    # (B, T, L): the query at positions[b, i] attends cache rows <= it
    mask = (torch.arange(length, device=dev)[None, None, :]
            <= pos[:, :, None])[:, :, None, :]
    scale = 1.0 / math.sqrt(model.cfg.encoder.dim // model.cfg.encoder.heads)
    for layer, block in enumerate(model.blocks):
        attn = block.attn
        lk, lv = ck[layer], cv[layer]
        h = block.ln1(x)
        q = torch.einsum("btd,dhk->bthk", h, attn.wq.to(dt))
        k = torch.einsum("btd,dhk->bthk", h, attn.wk.to(dt))
        v = torch.einsum("btd,dhk->bthk", h, attn.wv.to(dt))
        lk[batch_ix, pos] = k.to(lk.dtype)
        lv[batch_ix, pos] = v.to(lv.dtype)
        s = torch.einsum("bthk,blhk->bthl", q.float(), lk.float()) * scale
        s = torch.where(mask, s, -1e30)
        a = torch.softmax(s, dim=-1).to(q.dtype)
        o = torch.einsum("bthl,blhk->bthk", a, lv.to(q.dtype))
        x = (x + torch.einsum("bthk,hkd->btd", o, attn.wo.to(dt))
             + attn.bo.to(dt))
        h = core.gelu(block.mlp["w1"](block.ln2(x)))
        x = x + block.mlp["w2"](h)
    x = model.ln_f(x)
    logits = torch.einsum("btd,vd->btv", x, model.embed.table.to(dt))
    return logits.float()


def _chunk(ids: Any, length: int) -> Tuple[np.ndarray, int]:
    """A prompt chunk's ids as host ints, and its real length checked."""
    ids = _host_ints(ids).reshape(-1)
    length = int(length)
    if length < 1 or length > len(ids):
        raise ValueError(f"length {length} outside the {len(ids)} ids given")
    return ids, length


@torch.inference_mode()
def prefill(model: LM, cache: Cache, slot: int, ids: Any, length: int
            ) -> Tuple[torch.Tensor, Cache]:
    """Ingest one slot's prompt (``ids`` right-padded to a bucket,
    ``length`` real tokens) at positions 0.. and return the next-token
    logits (V,) at the last real position."""
    ids, length = _chunk(ids, length)
    # bucket padding past the cache's end: JAX drops those writes
    ids = ids[:cache_max_len(cache)]
    if length > len(ids):
        raise ValueError(f"prompt of {length} tokens exceeds the cache's "
                         f"{cache_max_len(cache)} rows")
    positions = np.arange(len(ids))[None]
    slot = int(slot)
    logits = _cached_forward(model, cache["k"][:, slot:slot + 1],
                             cache["v"][:, slot:slot + 1], ids[None],
                             positions)
    return logits[0, length - 1], cache


@torch.inference_mode()
def decode_step(model: LM, cache: Cache, ids: Any, positions: Any
                ) -> Tuple[torch.Tensor, Cache]:
    """Advance every slot one token: ``ids``/``positions`` (S,) host ints
    (the last token per slot and the cache row it lands at; idle slots
    carry zeros and their outputs are ignored). Returns (logits (S, V)
    f32, cache)."""
    logits = _cached_forward(model, cache["k"], cache["v"],
                             _host_ints(ids)[:, None],
                             _host_ints(positions)[:, None])
    return logits[:, 0], cache


# -- the paged cache -------------------------------------------------------


def init_paged_kv_cache(cfg: LMConfig, pool_blocks: int, block_tokens: int,
                        dtype=torch.float32, device=None) -> Cache:
    """The pool: per-layer K/V of ``(depth, pool_blocks, block_tokens,
    heads, head_dim)``, zeros."""
    enc = cfg.encoder
    shape = (enc.depth, int(pool_blocks), int(block_tokens), enc.heads,
             enc.dim // enc.heads)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def paged_pool_blocks(cache: Cache) -> int:
    return int(cache["k"].shape[1])


def paged_block_tokens(cache: Cache) -> int:
    return int(cache["k"].shape[2])


def paged_pool_bytes(cache: Cache) -> int:
    """Device memory the pool holds (both K and V planes)."""
    return sum(t.numel() * t.element_size() for t in cache.values())


def _paged_view(plane: torch.Tensor, block_tables: np.ndarray
                ) -> torch.Tensor:
    """The slots' logical views gathered from the pool: ``plane``
    (depth, NBpool, BT, H, Dh), ``block_tables`` (B, NB) -> (depth, B,
    NB*BT, H, Dh), a copy. Sentinel entries (>= the pool size) read the
    last block, finite rows the mask excludes (JAX's ``mode="clip"``)."""
    depth, nbpool, bt, h, dh = plane.shape
    b, nb = block_tables.shape
    idx = torch.from_numpy(np.clip(block_tables, 0, nbpool - 1).reshape(-1))
    flat = plane[:, idx.to(plane.device)]
    return flat.reshape(depth, b, nb * bt, h, dh)


def _scatter_rows(plane: torch.Tensor, view: torch.Tensor,
                  block_tables: np.ndarray, positions: np.ndarray) -> None:
    """Write the view rows at ``positions`` (B, T) back into the pool, in
    place. Rows that map through a sentinel entry or past the table are
    not written (JAX drops them)."""
    nbpool, bt = plane.shape[1], plane.shape[2]
    nb = block_tables.shape[1]
    blk = np.clip(positions // bt, 0, nb - 1)
    phys = np.take_along_axis(block_tables, blk, axis=1)
    keep = (positions < nb * bt) & (phys >= 0) & (phys < nbpool)
    rows, cols = np.nonzero(keep)
    if not len(rows):
        return
    dev = plane.device

    def ix(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    plane[:, ix(phys[rows, cols]), ix(positions[rows, cols] % bt)] = \
        view[:, ix(rows), ix(positions[rows, cols])]


def _paged_forward(model: LM, cache: Cache, block_tables: np.ndarray,
                   ids: np.ndarray, positions: np.ndarray) -> torch.Tensor:
    vk = _paged_view(cache["k"], block_tables)
    vv = _paged_view(cache["v"], block_tables)
    logits = _cached_forward(model, vk, vv, ids, positions)
    _scatter_rows(cache["k"], vk, block_tables, positions)
    _scatter_rows(cache["v"], vv, block_tables, positions)
    return logits


@torch.inference_mode()
def paged_prefill(model: LM, cache: Cache, block_table: Any, ids: Any,
                  start: int, length: int) -> Tuple[torch.Tensor, Cache]:
    """Ingest (a chunk of) one slot's prompt at positions ``start ..
    start+T-1``: ``block_table`` (NB,) host ints (sentinels for
    unallocated tails), ``ids`` (T,) right-padded to a bucket, ``length``
    its real tokens. Returns (logits (V,) at the chunk's last real
    position, cache)."""
    table = _host_ints(block_table).reshape(1, -1)
    ids, length = _chunk(ids, length)
    room = table.shape[1] * paged_block_tokens(cache) - int(start)
    if length > room:
        raise ValueError(f"chunk of {length} tokens at {start} overruns the "
                         f"table's {table.shape[1]} blocks")
    ids = ids[:room]  # padding past the table: JAX drops those writes
    positions = (int(start) + np.arange(len(ids)))[None]
    logits = _paged_forward(model, cache, table, ids[None], positions)
    return logits[0, length - 1], cache


@torch.inference_mode()
def paged_decode_step(model: LM, cache: Cache, ids: Any, positions: Any,
                      block_tables: Any) -> Tuple[torch.Tensor, Cache]:
    """Advance every slot one token against the pool: ``ids``/
    ``positions`` (S,), ``block_tables`` (S, NB), host ints; idle slots
    carry all-sentinel rows, so nothing of theirs is written."""
    logits = _paged_forward(model, cache, _host_ints(block_tables),
                            _host_ints(ids)[:, None],
                            _host_ints(positions)[:, None])
    return logits[:, 0], cache


@torch.inference_mode()
def copy_kv_blocks(cache: Cache, src: Any, dst: Any) -> Cache:
    """Copy whole pool blocks ``src[i] -> dst[i]``, the allocator's
    copy-on-write; dst blocks are private to one slot."""
    dev = cache["k"].device
    src = torch.from_numpy(_host_ints(src)).to(dev)
    dst = torch.from_numpy(_host_ints(dst)).to(dev)
    for plane in cache.values():
        plane[:, dst] = plane[:, src]
    return cache


def greedy_token(logits: torch.Tensor) -> torch.Tensor:
    """argmax over the vocab axis (the first of equal maxima)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


# -- sampling keyed by position --------------------------------------------
#
# Every draw of a stream is keyed fold_in(fold_in(PRNGKey(seed), position),
# role): a function of the stream's seed, the absolute position of the
# token drawn and the kind of draw, never of round boundaries, so a
# preempted stream re-prefilled from its history draws the same tokens.
# temperature <= 0 gives the one-hot of the argmax, so sampling at 0 is
# the greedy path, bit for bit.

def _fold_in(key: Tuple[np.ndarray, np.ndarray], data: np.ndarray):
    data = np.asarray(data, np.uint32)
    return threefry2x32(key[0], key[1], np.zeros_like(data), data)


def _uniform_at(seeds: Any, positions: Any, role: int) -> np.ndarray:
    """One uniform in [0, 1) per entry of ``positions`` ((S,) or (S, T)),
    ``jax.random.uniform(fold_in(fold_in(PRNGKey(seed), pos), role))``
    bit for bit (threefry's partitionable bits: the two output words
    xor-ed); ``seeds``: (S,) per-slot uint32 seeds."""
    shape = np.shape(positions)
    positions = np.atleast_1d(np.asarray(positions, np.int64))
    seeds = np.asarray(seeds, np.uint64).astype(np.uint32)
    seeds = np.broadcast_to(
        seeds.reshape((-1,) + (1,) * (positions.ndim - 1)), positions.shape)
    key = (np.zeros(positions.shape, np.uint32), seeds)
    key = _fold_in(key, positions.astype(np.uint32))
    key = _fold_in(key, np.full(positions.shape, role, np.uint32))
    zero = np.zeros(positions.shape, np.uint32)
    b1, b2 = threefry2x32(key[0], key[1], zero, zero)
    bits = (b1 ^ b2) >> np.uint32(9) | np.uint32(0x3F800000)
    return np.maximum(bits.view(np.float32) - np.float32(1.0),
                      np.float32(0.0)).reshape(shape)


def modified_dist(logits: torch.Tensor, temperature: Any, top_k: Any,
                  top_p: Any) -> torch.Tensor:
    """The temperature/top-k/top-p-modified distribution over the last
    axis of ``logits`` (..., V) f32; the three knobs broadcast against
    the leading shape. top_k <= 0 and top_p >= 1 turn their filters off;
    top-k keeps every value equal to the k-th largest; top-p keeps the
    shortest prefix of the stable descending order whose mass reaches
    top_p (the first token always). Rows with temperature <= 0 are the
    exact one-hot of the argmax."""
    head, v = logits.shape[:-1], logits.shape[-1]
    dev = logits.device

    def knob(value, dtype):
        if not isinstance(value, torch.Tensor):
            value = np.asarray(value)
        return torch.as_tensor(value, dtype=dtype,
                               device=dev).broadcast_to(head)

    t = knob(temperature, torch.float32)
    tk = knob(top_k, torch.int64)
    tp = knob(top_p, torch.float32)
    greedy = t <= 0.0
    scaled = logits / torch.where(greedy, 1.0, t)[..., None]
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    k = torch.where(tk <= 0, v, tk).clamp(1, v)
    kth = torch.gather(sorted_desc, -1, (k - 1)[..., None])
    scaled = torch.where(scaled >= kth, scaled, float("-inf"))
    probs = torch.softmax(scaled, dim=-1)
    order = torch.argsort(-probs, dim=-1, stable=True)
    sp = torch.gather(probs, -1, order)
    keep_sorted = (torch.cumsum(sp, dim=-1) - sp) < tp[..., None]
    keep = torch.empty_like(keep_sorted).scatter_(-1, order, keep_sorted)
    probs = probs * keep
    probs = probs / probs.sum(-1, keepdim=True).clamp_min(1e-20)
    onehot = F.one_hot(torch.argmax(logits, dim=-1), v).to(torch.float32)
    return torch.where(greedy[..., None], onehot, probs)


def sample_from(probs: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF draw: the smallest index whose cumulative mass exceeds
    ``u``; exact on one-hot rows for any u in [0, 1)."""
    c = torch.cumsum(probs, dim=-1)
    idx = (c <= u[..., None]).to(torch.int64).sum(-1)
    return idx.clamp(0, probs.shape[-1] - 1).to(torch.int32)


def _draw(logits: torch.Tensor, token_positions: Any,
          sampling: Dict[str, Any]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(token ids, modified distribution) for a batched one-position draw;
    ``token_positions`` are the positions the drawn tokens will occupy.
    A batch that is all greedy skips the sorts and the keys: the argmax
    and its one-hot are what the full path gives for it."""
    v = logits.shape[-1]
    if (np.asarray(sampling["temperature"], np.float32) <= 0.0).all():
        am = torch.argmax(logits, dim=-1)
        return am.to(torch.int32), F.one_hot(am, v).to(torch.float32)
    probs = modified_dist(logits, sampling["temperature"],
                          sampling["top_k"], sampling["top_p"])
    u = torch.from_numpy(_uniform_at(sampling["seed"], token_positions,
                                     int(sampling["role"])))
    return sample_from(probs, u.to(probs.device)), probs


@torch.inference_mode()
def decode_step_sampled(model: LM, cache: Cache, ids: Any, positions: Any,
                        sampling: Dict[str, Any]
                        ) -> Tuple[torch.Tensor, torch.Tensor, Cache]:
    """:func:`decode_step` and a sampled draw: (token ids (S,), modified
    distribution (S, V), cache)."""
    logits, cache = decode_step(model, cache, ids, positions)
    tok, probs = _draw(logits, _host_ints(positions) + 1, sampling)
    return tok, probs, cache


@torch.inference_mode()
def paged_decode_step_sampled(model: LM, cache: Cache, ids: Any,
                              positions: Any, block_tables: Any,
                              sampling: Dict[str, Any]
                              ) -> Tuple[torch.Tensor, torch.Tensor, Cache]:
    """:func:`paged_decode_step` and a sampled draw."""
    logits, cache = paged_decode_step(model, cache, ids, positions,
                                      block_tables)
    tok, probs = _draw(logits, _host_ints(positions) + 1, sampling)
    return tok, probs, cache


@torch.inference_mode()
def decode_steps_sampled(model: LM, cache: Cache, ids: Any, positions: Any,
                         k: int, sampling: Dict[str, Any]
                         ) -> Tuple[torch.Tensor, torch.Tensor, Cache]:
    """``k`` chained :func:`decode_step_sampled` calls on the ring: the
    draft's proposal burst of a speculative round, the same tokens and
    distributions. The ids, positions, knobs and the k steps' uniforms go
    to the cache's device once, and each drawn token feeds the next step
    there, so no step waits on a copy. Returns (tokens (S, k) int32,
    modified distributions q (S, k, V) f32, cache)."""
    dev = cache["k"].device
    positions = _host_ints(positions)
    k = int(k)
    greedy = (np.asarray(sampling["temperature"], np.float32) <= 0.0).all()
    pos = torch.from_numpy(positions).to(dev)
    cur = torch.from_numpy(_host_ints(ids)).to(dev)
    if not greedy:
        u = torch.from_numpy(_uniform_at(
            sampling["seed"], positions[:, None] + 1 + np.arange(k),
            int(sampling["role"]))).to(dev)
        knobs = [torch.from_numpy(np.asarray(sampling[key], dtype)).to(dev)
                 for key, dtype in (("temperature", np.float32),
                                    ("top_k", np.int64),
                                    ("top_p", np.float32))]
    toks, probs = [], []
    for j in range(k):
        logits = _cached_forward(model, cache["k"], cache["v"],
                                 cur[:, None], (pos + j)[:, None])[:, 0]
        if greedy:
            am = torch.argmax(logits, dim=-1)
            cur = am.to(torch.int32)
            pj = F.one_hot(am, logits.shape[-1]).to(torch.float32)
        else:
            pj = modified_dist(logits, *knobs)
            cur = sample_from(pj, u[:, j])
        toks.append(cur)
        probs.append(pj)
    return torch.stack(toks, 1), torch.stack(probs, 1), cache


@torch.inference_mode()
def paged_verify_step(model: LM, cache: Cache, ids: Any, positions: Any,
                      block_tables: Any, draft_probs: Any,
                      sampling: Dict[str, Any]
                      ) -> Tuple[torch.Tensor, torch.Tensor, Cache]:
    """Verify k drafted tokens a slot in one forward over k+1 positions.

    ``ids`` (S, k+1): each slot's last committed token, then the draft's
    k proposals; ``positions`` (S, k+1) their write positions;
    ``block_tables`` (S, NB) host ints; ``draft_probs`` (S, k, V) the
    draft's modified distributions q (a tensor, on the card when the
    draft ran there). Rejection sampling per slot: proposal d_j is
    accepted iff u_j q(d_j) < p(d_j), u_j keyed ``ROLE_ACCEPT`` at d_j's
    position; the first rejection draws from max(p - q, 0) normalised
    (from p when its mass is at most 1e-20), and a row that accepts all
    k draws a bonus token from the (k+1)-th target distribution, keyed
    ``ROLE_TARGET`` at ``positions[:, 0] + a + 1``. A batch that is all
    greedy takes the argmax path, which gives the same tokens. All k+1
    rows are written before attention, as every cached forward does; a
    rejected suffix's rows are overwritten before anything attends them,
    so nothing is rolled back. Returns (accept_len (S,) int32, tokens
    (S, k+1) int32: the accepted prefix and the drawn token, then 0,
    cache)."""
    ids = _host_ints(ids)
    positions = _host_ints(positions)
    logits = _paged_forward(model, cache, _host_ints(block_tables), ids,
                            positions)                     # (S, k+1, V)
    dev = logits.device
    s, k1 = ids.shape
    k = k1 - 1
    d = torch.from_numpy(ids[:, 1:]).to(dev)               # (S, k)
    d_pad = torch.cat([d, torch.zeros(s, 1, dtype=d.dtype, device=dev)], 1)
    jj = torch.arange(k1, device=dev)[None, :]
    if (np.asarray(sampling["temperature"], np.float32) <= 0.0).all():
        am = torch.argmax(logits, dim=-1)                  # (S, k+1)
        accept = d == am[:, :k]
        a = torch.cumprod(accept.to(torch.int64), -1).sum(-1)
        extra = torch.gather(am, 1, a[:, None])
    else:
        def col(key, dtype):
            return np.asarray(sampling[key], dtype)[:, None]

        p = modified_dist(logits, col("temperature", np.float32),
                          col("top_k", np.int64), col("top_p", np.float32))
        q = torch.as_tensor(draft_probs, dtype=torch.float32, device=dev)
        p_head = p[:, :k]
        p_d = torch.gather(p_head, -1, d[..., None])[..., 0]
        q_d = torch.gather(q, -1, d[..., None])[..., 0]
        seed = sampling["seed"]
        u_acc = torch.from_numpy(_uniform_at(seed, positions[:, 1:],
                                             ROLE_ACCEPT)).to(dev)
        accept = u_acc * q_d < p_d
        a = torch.cumprod(accept.to(torch.int64), -1).sum(-1)
        resid = torch.clamp(p_head - q, min=0.0)
        rs = resid.sum(-1, keepdim=True)
        corr = torch.where(rs > 1e-20, resid / rs.clamp_min(1e-20), p_head)
        dist_all = torch.cat([corr, p[:, k:]], 1)          # (S, k+1, V)
        xdist = torch.gather(
            dist_all, 1,
            a[:, None, None].expand(-1, 1, dist_all.shape[-1]))[:, 0]
        # the bonus draw's uniform at each accept length it may follow
        u_all = torch.from_numpy(_uniform_at(
            seed, positions[:, :1] + 1 + np.arange(k1), ROLE_TARGET)).to(dev)
        u_x = torch.gather(u_all, 1, a[:, None])[:, 0]
        extra = sample_from(xdist, u_x)[:, None].to(d.dtype)
    toks = torch.where(jj < a[:, None], d_pad,
                       torch.where(jj == a[:, None], extra,
                                   torch.zeros_like(d_pad)))
    return a.to(torch.int32), toks.to(torch.int32), cache
