"""Paged KV allocator and shared prefix cache: host-side block bookkeeping.

Own copy of ``rafiki_tpu/worker/kv_paging.py`` (pure Python and numpy).
A fixed pool of ``block_tokens``-row pages and a block table a slot, so a
stream holds pages only for the tokens it has written (PagedAttention,
Kwon et al. 2023). A **shared prefix cache** sits on the pool: after a
prompt's prefill its blocks are published under a content hash of the
token prefix they hold, refcounted, and mapped read-only into later
streams that share the prefix; a write into a shared block goes through
**copy-on-write** (``ensure_writable``). Cache-only blocks are evicted
LRU when the pool runs dry.

This class keeps block ids, refcounts, tables, hashes and copy
instructions; the model owns the device tensors (``models/lm.py``
``paged_prefill``, ``paged_decode_step``, ``copy_kv_blocks``) and the
generation worker, its only caller, drives both from its serve thread,
so nothing here locks. A matched tail block may carry rows past the
matched length that belong to the publisher's prompt; the new stream
writes those positions before attention can read them, so stale rows are
never attended. The speculative rollback (``truncate_to``) is not ported
(ROADMAP.md).
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np


class KVPoolExhaustedError(RuntimeError):
    """The pool cannot hold even one stream's working set — a typed
    stream-level error (the caller fails THAT stream; siblings and the
    worker keep serving)."""


def _digest(tokens: Sequence[int]) -> str:
    return hashlib.sha1(
        np.asarray(list(tokens), np.int32).tobytes()).hexdigest()


def _common_prefix_len(a: Sequence[int], b: Sequence[int]) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


class AdmitPlan:
    """What :meth:`PagedKVAllocator.open_slot` resolved for a prompt:
    ``cached_tokens`` logical positions 0..cached_tokens-1 are already in
    the pool (shared chain blocks + a copied tail), and ``copies`` are
    (src, dst) block pairs the caller must apply to the device cache
    (``copy_kv_blocks``) before running any forward for this slot."""

    __slots__ = ("cached_tokens", "copies")

    def __init__(self, cached_tokens: int,
                 copies: List[Tuple[int, int]]) -> None:
        self.cached_tokens = cached_tokens
        self.copies = copies


class PagedKVAllocator:
    """Block pool + per-slot tables + refcounted prefix cache.

    ``pool_blocks`` physical pages of ``block_tokens`` K/V rows each;
    ``table_blocks`` is the fixed per-slot table width (ceil(max_context /
    block_tokens)) so the jitted decode program's shapes never change.
    The sentinel id ``pool_blocks`` marks unallocated table entries —
    the model layer drops writes through it.
    """

    def __init__(self, pool_blocks: int, block_tokens: int,
                 table_blocks: int, prefix_cache: bool = True,
                 max_tails_per_chain: int = 4) -> None:
        if pool_blocks < 1 or block_tokens < 1 or table_blocks < 1:
            raise ValueError(
                f"degenerate paged-KV geometry: pool_blocks={pool_blocks} "
                f"block_tokens={block_tokens} table_blocks={table_blocks}")
        self.pool_blocks = int(pool_blocks)
        self.block_tokens = int(block_tokens)
        self.table_blocks = int(table_blocks)
        self.sentinel = self.pool_blocks
        self.prefix_cache = bool(prefix_cache)
        self.max_tails_per_chain = int(max_tails_per_chain)
        self._free: List[int] = list(range(self.pool_blocks - 1, -1, -1))
        self._refs = [0] * self.pool_blocks
        self._tables: Dict[Any, List[int]] = {}
        self._shared: Dict[Any, set] = {}
        #: LRU-ordered cache entries: chain entries keyed by the prefix
        #: digest, tail entries by ("tail", chain_digest, tokens_tuple)
        self._entries: "OrderedDict[Any, Dict[str, Any]]" = OrderedDict()
        self._tails: Dict[str, List[tuple]] = {}
        # counters (mirrored into the PR-6 registry by the worker)
        self.hits = 0
        self.misses = 0
        self.hit_tokens = 0
        self.cow_copies = 0
        self.cache_evictions = 0

    # -- pool primitives -----------------------------------------------------

    def free_blocks(self) -> int:
        return len(self._free)

    def used_blocks(self) -> int:
        return self.pool_blocks - len(self._free)

    def evictable_blocks(self) -> int:
        """Cache-only blocks (refcount 1, held by no slot) LRU eviction
        could reclaim right now."""
        return sum(1 for e in self._entries.values()
                   if self._refs[e["block"]] == 1)

    def blocks_for(self, tokens: int) -> int:
        return -(-max(int(tokens), 0) // self.block_tokens)

    def _alloc_one(self) -> Optional[int]:
        """One private block (refcount 1), evicting LRU cache-only
        entries if the free list is dry. None = genuinely exhausted."""
        if not self._free and not self._evict_lru():
            return None
        b = self._free.pop()
        self._refs[b] = 1
        return b

    def _evict_lru(self) -> bool:
        for key, e in self._entries.items():
            if self._refs[e["block"]] == 1:
                self._drop_entry(key)
                self.cache_evictions += 1
                return True
        return False

    def _drop_entry(self, key: Any) -> None:
        e = self._entries.pop(key)
        b = e["block"]
        self._refs[b] -= 1
        if self._refs[b] == 0:
            self._free.append(b)
        if e["kind"] == "tail":
            toks = self._tails.get(e["chain"], [])
            if e["tokens"] in toks:
                toks.remove(e["tokens"])
                if not toks:
                    self._tails.pop(e["chain"], None)

    # -- slot lifecycle ------------------------------------------------------

    def open_slot(self, slot: Any, prompt: Sequence[int]) -> AdmitPlan:
        """Map the longest cached prefix of ``prompt`` into a new slot's
        table (shared chain blocks refcounted; a matching partial tail is
        COPIED into a private block — the 'copy' of copy-on-write). At
        most ``len(prompt) - 1`` tokens come from cache: the last prompt
        token is always forwarded so prefill has logits to return."""
        if slot in self._tables:
            raise ValueError(f"slot {slot!r} already open")
        prompt = list(prompt)
        usable = len(prompt) - 1
        bt = self.block_tokens
        table: List[int] = []
        shared: set = set()
        copies: List[Tuple[int, int]] = []
        cached = 0
        if self.prefix_cache and usable > 0:
            c = 0
            while (c + 1) * bt <= usable and c < self.table_blocks:
                d = _digest(prompt[:(c + 1) * bt])
                e = self._entries.get(d)
                if e is None:
                    break
                table.append(e["block"])
                self._refs[e["block"]] += 1
                shared.add(c)
                self._entries.move_to_end(d)
                c += 1
            cached = c * bt
            chain_d = _digest(prompt[:cached])
            best_key = None
            best_t = 0
            for toks in self._tails.get(chain_d, ()):
                key = ("tail", chain_d, toks)
                e = self._entries.get(key)
                if e is None:
                    continue
                t = _common_prefix_len(toks, prompt[cached:usable])
                if t > best_t:
                    best_t, best_key = t, key
            if best_key is not None and len(table) < self.table_blocks:
                # pin the source entry across the allocation: _alloc_one
                # may LRU-evict refcount-1 cache entries, and the matched
                # tail (not yet touched this admission) is a prime victim
                # — unpinned, its freed block could even be handed back
                # as the copy TARGET
                src_block = self._entries[best_key]["block"]
                self._refs[src_block] += 1
                dst = self._alloc_one()
                self._refs[src_block] -= 1
                if dst is not None:
                    copies.append((src_block, dst))
                    table.append(dst)
                    cached += best_t
                    self._entries.move_to_end(best_key)
                    self.cow_copies += 1
        if cached > 0:
            self.hits += 1
            self.hit_tokens += cached
        else:
            self.misses += 1
        self._tables[slot] = table
        self._shared[slot] = shared
        return AdmitPlan(cached, copies)

    def close_slot(self, slot: Any) -> None:
        """Release every block the slot maps: private refcounts drop to
        zero and return to the free list; shared blocks stay alive under
        the cache's own reference."""
        table = self._tables.pop(slot, None)
        self._shared.pop(slot, None)
        if table is None:
            return
        for b in table:
            self._refs[b] -= 1
            if self._refs[b] == 0:
                self._free.append(b)

    def ensure_capacity(self, slot: Any, position: int) -> bool:
        """Grow the slot's table until it covers logical ``position``
        (the next write). False = pool exhausted even after cache
        eviction — the caller preempts the youngest stream and retries."""
        if position >= self.table_blocks * self.block_tokens:
            raise KVPoolExhaustedError(
                f"position {position} is past the table "
                f"({self.table_blocks} x {self.block_tokens} tokens)")
        table = self._tables[slot]
        need = position // self.block_tokens + 1
        while len(table) < need:
            b = self._alloc_one()
            if b is None:
                return False
            table.append(b)
        return True

    def ensure_writable(self, slot: Any, position: int
                        ) -> Optional[List[Tuple[int, int]]]:
        """Copy-on-write barrier: if the block holding ``position`` is
        shared (a published tail another stream — or the cache — still
        references), move this slot onto a private copy first. Returns
        the (src, dst) copy list to apply (usually empty), or None when
        the pool cannot supply the copy target (caller preempts)."""
        ix = position // self.block_tokens
        table = self._tables[slot]
        if ix >= len(table) or ix not in self._shared[slot]:
            return []
        dst = self._alloc_one()
        if dst is None:
            return None
        src = table[ix]
        table[ix] = dst
        self._shared[slot].discard(ix)
        self._refs[src] -= 1
        if self._refs[src] == 0:  # defensive: shared implies a cache ref
            self._free.append(src)
        self.cow_copies += 1
        return [(src, dst)]

    def publish(self, slot: Any, prompt: Sequence[int]) -> None:
        """Offer a freshly-prefilled prompt to the prefix cache: every
        full block under its chain digest, the partial tail block (if
        any) under its chain + token tuple. Published blocks gain a cache
        reference and become copy-on-write for the OWNER too — its next
        decode write into the tail block goes through a private copy,
        leaving the cached content immutable."""
        if not self.prefix_cache:
            return
        prompt = list(prompt)
        bt = self.block_tokens
        table = self._tables[slot]
        shared = self._shared[slot]
        fb = len(prompt) // bt
        for i in range(min(fb, len(table))):
            d = _digest(prompt[:(i + 1) * bt])
            if d in self._entries:
                self._entries.move_to_end(d)
                continue
            b = table[i]
            self._entries[d] = {"kind": "chain", "block": b}
            self._refs[b] += 1
            shared.add(i)
        r = len(prompt) - fb * bt
        if r > 0 and fb < len(table):
            chain_d = _digest(prompt[:fb * bt])
            toks = tuple(prompt[fb * bt:])
            key = ("tail", chain_d, toks)
            tails = self._tails.setdefault(chain_d, [])
            if key not in self._entries \
                    and len(tails) < self.max_tails_per_chain:
                b = table[fb]
                self._entries[key] = {"kind": "tail", "block": b,
                                      "chain": chain_d, "tokens": toks}
                tails.append(toks)
                self._refs[b] += 1
                shared.add(fb)

    # -- views ---------------------------------------------------------------

    def table_row(self, slot: Any) -> np.ndarray:
        """The slot's fixed-width table row, sentinel-padded — what the
        jitted paged forwards consume."""
        row = np.full(self.table_blocks, self.sentinel, np.int32)
        t = self._tables[slot]
        row[:len(t)] = t
        return row

    def idle_row(self) -> np.ndarray:
        return np.full(self.table_blocks, self.sentinel, np.int32)

    def refcounts(self) -> List[int]:
        return list(self._refs)

    def drop_cache(self) -> int:
        """Evict every cache-only entry (deploy/rollback flush and the
        refcount drill); returns blocks freed. Entries still mapped by a
        live slot stay until that slot closes."""
        freed = 0
        for key in [k for k, e in self._entries.items()
                    if self._refs[e["block"]] == 1]:
            self._drop_entry(key)
            freed += 1
            self.cache_evictions += 1
        return freed

    def stats(self) -> Dict[str, int]:
        return {
            "pool_blocks": self.pool_blocks,
            "block_tokens": self.block_tokens,
            "used_blocks": self.used_blocks(),
            "free_blocks": self.free_blocks(),
            "cache_entries": len(self._entries),
            "evictable_blocks": self.evictable_blocks(),
            "prefix_hits": self.hits,
            "prefix_misses": self.misses,
            "prefix_hit_tokens": self.hit_tokens,
            "cow_copies": self.cow_copies,
            "cache_evictions": self.cache_evictions,
        }
