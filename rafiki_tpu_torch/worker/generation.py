"""Generation worker: token streaming with continuous batching.

Counterpart of ``rafiki_tpu/worker/generation.py``. The classification
worker takes a batch and answers it; a completion of hundreds of tokens
cannot hold its batch that long, so this worker schedules at the token
(Orca's iteration-level scheduling):

- a fixed table of ``RAFIKI_GEN_MAX_SLOTS`` slots; the model's cache is
  allocated for that many co-resident sequences;
- each round it pulls newly queued requests from the same bounded
  ``WorkerQueue`` the other serving hops use, prefills them into free
  slots, runs ONE decode step for every resident sequence and pushes each
  sequence's token onto its :class:`~rafiki_tpu_torch.cache.queue.TokenStream`;
- a sequence leaves mid-decode (EOS, ``max_tokens``, the context's end,
  its deadline, a cancel) and frees its slot to the next request.

A template with the paged methods serves under the paged allocator
(``worker/kv_paging.py``, ``RAFIKI_GEN_KV_PAGED``): a pool of
``RAFIKI_GEN_KV_BLOCK_TOKENS``-row pages and a block table a slot, with
the shared prefix cache (``RAFIKI_GEN_PREFIX_CACHE``), chunked prefill
(``RAFIKI_GEN_PREFILL_CHUNK``: a long prompt joins a chunk a round,
between decode rounds) and preemption (a dry pool preempts the youngest
stream, which is re-queued and later re-prefilled from its history).
Sampling (temperature, top-k, top-p, ``RAFIKI_GEN_SAMPLING``) draws under
keys of (stream seed, position, role), so a preempted sampled stream
resumes with the same tokens; temperature 0 is the greedy path.

Not ported (ROADMAP.md): speculative decoding (the draft model,
``_spec_round``), the hand-back of resident streams to the door for a
resume on a sibling (a stopping worker ends them with a typed error
instead) and resume requests (refused typed), chaos injection, and the
metrics registry (the counters ride the worker's ``serving_stats``
row).
"""

from __future__ import annotations

import logging
import time
import traceback
import uuid
from typing import Dict, List, Optional

import numpy as np

from rafiki_tpu_torch import config
from rafiki_tpu_torch.cache.queue import TokenStream
from rafiki_tpu_torch.device import set_device_grant
from rafiki_tpu_torch.sdk.model import (
    ROLE_TARGET,
    GenerationSpec,
    generation_capability,
    paged_generation_capability,
    sampling_capability,
)
from rafiki_tpu_torch.worker.inference import (
    SERVING_STATS,
    InferenceWorker,
    _record_batch,
    _stats_lock,
)
from rafiki_tpu_torch.worker.kv_paging import PagedKVAllocator

logger = logging.getLogger(__name__)


class GenerationUnsupportedError(RuntimeError):
    """The deployed template does not advertise a fully wired generation
    capability: a typed deploy-time error."""


class GenerationRequestError(ValueError):
    """A malformed generation request, resolved onto its future (the door
    answers 400)."""


class _Slot:
    """One resident sequence's scheduler state."""

    __slots__ = ("stream", "last_id", "position", "produced", "max_tokens",
                 "deadline", "prompt", "tokens", "pending_from", "seq",
                 "temperature", "top_k", "top_p", "rng_seed")

    def __init__(self, stream: TokenStream, prompt: List[int],
                 max_tokens: int, deadline: Optional[float], seq: int,
                 produced: int = 0, sampling: Optional[tuple] = None):
        self.stream = stream
        self.prompt = prompt          # the token history being prefilled
        self.tokens: List[int] = []   # tokens produced since (re)admission
        self.last_id = 0
        self.position = 0             # the cache row the NEXT token lands at
        self.produced = produced      # tokens the client has been sent
        self.max_tokens = max_tokens
        self.deadline = deadline
        #: admission order: a dry pool preempts the youngest stream
        self.seq = seq
        #: the next prompt index still to prefill (None: decoding)
        self.pending_from: Optional[int] = None
        #: temperature 0 is greedy; the seed is fixed at first admission,
        #: so a resumed stream draws the same tokens
        t, tk, tp, sd = sampling or (0.0, 0, 1.0, 0)
        self.temperature = float(t)
        self.top_k = int(tk)
        self.top_p = float(tp)
        self.rng_seed = int(sd)


class _Pending:
    """A stream waiting for pool pages: a request not yet admitted
    (``fut``/``query``) or a preempted stream (``stream``/``prompt``, its
    whole token history)."""

    __slots__ = ("fut", "query", "stream", "prompt", "produced",
                 "max_tokens", "deadline", "seq", "sampling")

    def __init__(self, seq: int, fut=None, query=None, stream=None,
                 prompt=None, produced=0, max_tokens=0, deadline=None,
                 sampling=None):
        self.seq = seq
        self.fut = fut
        self.query = query
        self.stream = stream
        self.prompt = prompt
        self.produced = produced
        self.max_tokens = max_tokens
        self.deadline = deadline
        self.sampling = sampling


class GenerationWorker(InferenceWorker):
    """Serves one trained trial's LM as token streams; the model loading
    and queue registration are the classification worker's."""

    def start(self, ctx) -> None:
        set_device_grant(ctx.chips)
        model = None
        queue = self._broker.register_worker(self._job_id, ctx.service_id)
        try:
            model = self._load_model()
            spec = generation_capability(type(model))
            if spec is None:
                raise GenerationUnsupportedError(
                    f"trial {self._trial_id}'s template does not advertise "
                    "a fully wired GenerationSpec (init_kv_cache, prefill, "
                    "decode_step): it cannot serve TEXT_GENERATION")
            max_slots = max(int(config.GEN_MAX_SLOTS), 1)
            self._alloc: Optional[PagedKVAllocator] = None
            self._chunk = 0
            if (bool(config.GEN_KV_PAGED)
                    and paged_generation_capability(type(model))):
                block_tokens = max(int(config.GEN_KV_BLOCK_TOKENS), 1)
                table_blocks = -(-spec.max_context // block_tokens)
                pool_blocks = (int(config.GEN_KV_POOL_BLOCKS)
                               or max_slots * table_blocks)
                self._alloc = PagedKVAllocator(
                    pool_blocks, block_tokens, table_blocks,
                    prefix_cache=bool(config.GEN_PREFIX_CACHE))
                self._chunk = max(int(config.GEN_PREFILL_CHUNK), 0)
                cache = model.init_paged_kv_cache(pool_blocks, block_tokens)
                logger.info(
                    "generation worker %s: paged KV (%d blocks x %d tokens, "
                    "prefix cache %s, prefill chunk %d)", ctx.service_id,
                    pool_blocks, block_tokens,
                    "on" if self._alloc.prefix_cache else "off", self._chunk)
            else:
                cache = model.init_kv_cache(max_slots)
            self._sampling_cap = sampling_capability(type(model))
            model.warm_up()
            ctx.ready()
            self._service_id = ctx.service_id
            self._queue = queue
            slots: List[Optional[_Slot]] = [None] * max_slots
            self._tokens_emitted = 0
            self._seq = 0
            self._pending: List[_Pending] = []
            self._evictions: Dict[str, int] = {}
            self._preempted = 0
            while not ctx.stopping:
                n_active = sum(1 for s in slots if s is not None)
                free = [i for i, s in enumerate(slots) if s is None]
                # -- admit: resumes first, then queued requests ----------
                if free and self._pending:
                    cache = self._readmit(model, spec, cache, slots, free)
                if free and (n_active == 0 or queue.depth() > 0) \
                        and self._room_for_new():
                    batch = queue.take_batch(
                        max_size=len(free), deadline_s=0.0,
                        wait_timeout_s=(0.25 if n_active == 0
                                        and not self._pending else 0.0))
                    if batch is None:
                        logger.info("query queue closed; generation worker "
                                    "%s exiting", ctx.service_id)
                        break
                    for fut, query in batch:
                        cache = self._admit(model, spec, cache, slots, free,
                                            fut, query)
                # -- chunked prefill: one chunk a prefilling slot ---------
                if self._alloc is not None:
                    cache = self._prefill_round(model, spec, cache, slots)
                n_active = sum(1 for s in slots if s is not None)
                self._stats_row(slots, max_slots)
                if n_active == 0 and not self._pending:
                    continue
                # -- decode: one token for every resident sequence -------
                if any(s is not None and s.pending_from is None
                       for s in slots):
                    cache = self._decode_round(model, spec, cache, slots)
                elif n_active == 0:
                    # only stashed streams remain and none can run yet
                    time.sleep(0.005)
            self._end_all(slots)
        finally:
            self._broker.unregister_worker(self._job_id, ctx.service_id)
            if model is not None:
                model.destroy()
            set_device_grant(None)

    def _end_all(self, slots: List[Optional[_Slot]]) -> None:
        """A stopping worker ends every resident and stashed stream with a
        typed error (the JAX package hands them back for a resume on a
        sibling, which is not ported), and fails the requests still
        waiting on their future."""
        message = ("generation worker stopped mid-stream (resuming a stream "
                   "on another replica is not ported)")
        for i, s in enumerate(slots):
            if s is not None:
                s.stream.fail(message)
                self._evict_slot(slots, i, "error")
        for entry in self._pending:
            if entry.stream is not None:
                entry.stream.fail(message)
            elif entry.fut is not None:
                entry.fut.set_error(RuntimeError("worker queue closed"))
        self._pending = []

    def _sampling_arrays(self, slots, role, only=None) -> Dict[str, object]:
        """The slots' sampling parameters as the arrays the sampled steps
        take; idle and filtered rows are greedy (temperature 0)."""
        n = len(slots)
        seed = np.zeros(n, np.uint32)
        temp = np.zeros(n, np.float32)
        tk = np.zeros(n, np.int32)
        tp = np.ones(n, np.float32)
        for i, s in enumerate(slots):
            if s is None or (only is not None and i not in only):
                continue
            seed[i] = np.uint32(s.rng_seed & 0xFFFFFFFF)
            temp[i] = np.float32(s.temperature)
            tk[i] = np.int32(s.top_k)
            tp[i] = np.float32(s.top_p)
        return {"seed": seed, "temperature": temp, "top_k": tk,
                "top_p": tp, "role": int(role)}

    # -- admission -----------------------------------------------------------

    def _room_for_new(self) -> bool:
        """Under the paged allocator, stashed streams resume before new
        requests are pulled, and a pool with under 2 free or evictable
        pages admits no one."""
        if self._alloc is None:
            return True
        if self._pending:
            return False
        return (self._alloc.free_blocks()
                + self._alloc.evictable_blocks()) >= 2

    def _admit(self, model, spec: GenerationSpec, cache,
               slots: List[Optional[_Slot]], free: List[int], fut, query,
               seq: Optional[int] = None):
        """Prefill one queued request into a free slot and hand its stream
        back through the request's future. A malformed request fails its
        future typed and costs no slot; a failed prefill fails only its
        request. ``seq`` re-admits a stashed request under its first
        admission order."""
        try:
            prompt, max_tokens, max_duration_s, sampling = \
                self._parse_query(query)
        except GenerationRequestError as e:
            fut.set_error(e)
            return cache
        if sampling[0] > 0.0 and self._sampling_cap is None:
            fut.set_error(GenerationRequestError(
                "sampled generation (temperature > 0) needs a "
                "sampling-capable template (decode_step_sampled; and "
                "paged_decode_step_sampled under the paged layout)"))
            return cache
        if not free:
            fut.set_error(RuntimeError("no free generation slot"))
            return cache
        if len(prompt) + max_tokens > spec.max_context:
            fut.set_error(GenerationRequestError(
                f"prompt ({len(prompt)} tokens) + max_tokens ({max_tokens}) "
                f"exceeds the template's max_context ({spec.max_context})"))
            return cache
        deadline = (time.monotonic() + max_duration_s
                    if max_duration_s else None)
        if self._alloc is not None:
            if self._alloc.blocks_for(len(prompt) + 1) \
                    > self._alloc.pool_blocks:
                fut.set_error(GenerationRequestError(
                    f"prompt ({len(prompt)} tokens) cannot fit the KV pool "
                    f"({self._alloc.pool_blocks} blocks x "
                    f"{self._alloc.block_tokens} tokens); raise "
                    "RAFIKI_GEN_KV_POOL_BLOCKS"))
                return cache
            return self._admit_paged(model, spec, cache, slots, free, fut,
                                     prompt, max_tokens, deadline, seq=seq,
                                     sampling=sampling)
        # -- the contiguous ring ---------------------------------------------
        slot_ix = free.pop(0)
        try:
            first_id, cache = model.prefill(cache, slot_ix, list(prompt))
        except Exception as e:
            free.insert(0, slot_ix)
            logger.error("prefill failed in generation worker %s:\n%s",
                         self._service_id, traceback.format_exc())
            fut.set_error(RuntimeError(f"prefill failed: {e}"))
            return cache
        stream = TokenStream(seq_id=uuid.uuid4().hex[:12])
        slot = _Slot(stream, list(prompt), max_tokens, deadline,
                     self._next_seq() if seq is None else seq,
                     sampling=sampling)
        slots[slot_ix] = slot
        fut.set_result(stream)
        _record_batch(self._service_id, 1, self._queue)
        if slot.temperature > 0.0:
            # prefill's token is the greedy pick: rewind one row, so the
            # next decode round rewrites the last prompt position (the same
            # K/V) and samples the first token under its position's key
            slot.last_id = prompt[-1]
            slot.position = len(prompt) - 1
            return cache
        first_id = int(first_id)
        slot.last_id = first_id
        slot.position = len(prompt)
        slot.produced += 1
        slot.tokens.append(first_id)
        self._tokens_emitted += 1
        finished, reason = self._finish_reason(slot, spec, first_id)
        stream.push([first_id], finished=finished, reason=reason)
        if finished:
            self._evict_slot(slots, slot_ix, reason)
        return cache

    def _next_seq(self) -> int:
        self._seq += 1
        return self._seq

    # -- paged admission and prefill -------------------------------------------

    def _admit_paged(self, model, spec, cache, slots, free, fut, prompt,
                     max_tokens, deadline, seq=None, sampling=None):
        """Open a block table for the prompt (mapping any cached prefix),
        run the first prefill chunk and resolve the request's future; the
        other chunks run one a round. A pool too dry for the first chunk
        stashes the request, the youngest stream, with its future."""
        slot_ix = free.pop(0)
        slot = _Slot(TokenStream(seq_id=uuid.uuid4().hex[:12]),
                     list(prompt), max_tokens, deadline,
                     self._next_seq() if seq is None else seq,
                     sampling=sampling)
        plan = self._alloc.open_slot(slot_ix, prompt)
        slot.pending_from = plan.cached_tokens
        slot.position = plan.cached_tokens
        slots[slot_ix] = slot  # a first-token finish evicts normally
        try:
            if plan.copies:
                cache = self._apply_copies(model, cache, plan.copies)
            n = len(prompt)
            end = n if self._chunk <= 0 else min(n, plan.cached_tokens
                                                 + self._chunk)
            ok, cache = self._try_chunk(model, spec, cache, slots, slot_ix,
                                        slot, end)
            if not ok:
                slots[slot_ix] = None
                self._alloc.close_slot(slot_ix)
                free.insert(0, slot_ix)
                # the derived seed rides along: the resumed parse replays
                # the same sampled stream
                query = {"prompt_ids": list(prompt),
                         "max_tokens": max_tokens, "max_duration_s": None,
                         "temperature": slot.temperature,
                         "top_k": slot.top_k, "top_p": slot.top_p,
                         "seed": slot.rng_seed}
                self._stash(_Pending(slot.seq, fut=fut, query=query,
                                     deadline=deadline))
                return cache
        except Exception as e:
            slots[slot_ix] = None
            self._alloc.close_slot(slot_ix)
            free.insert(0, slot_ix)
            logger.error("prefill failed in generation worker %s:\n%s",
                         self._service_id, traceback.format_exc())
            fut.set_error(RuntimeError(f"prefill failed: {e}"))
            return cache
        fut.set_result(slot.stream)
        _record_batch(self._service_id, 1, self._queue)
        return cache

    def _readmit(self, model, spec, cache, slots, free):
        """Resume stashed streams, oldest first: a preempted stream
        re-prefills its whole history (the position-keyed draws make the
        continuation exact), a stashed request is admitted afresh."""
        while free and self._pending:
            entry = self._pending[0]
            if not self._room_for_resume(entry):
                break
            self._pending.pop(0)
            now = time.monotonic()
            if entry.deadline is not None and now >= entry.deadline:
                if entry.stream is not None:
                    entry.stream.push([], finished=True, reason="deadline")
                elif entry.fut is not None:
                    entry.fut.set_error(TimeoutError(
                        "generation request expired waiting for KV pool "
                        "blocks"))
                continue
            if entry.fut is not None:
                if entry.deadline is not None:
                    # the remaining duration keeps the absolute bound
                    entry.query["max_duration_s"] = max(
                        entry.deadline - now, 0.001)
                cache = self._admit(model, spec, cache, slots, free,
                                    entry.fut, entry.query, seq=entry.seq)
                continue
            if entry.stream.cancelled:
                continue
            slot_ix = free.pop(0)
            slot = _Slot(entry.stream, list(entry.prompt), entry.max_tokens,
                         entry.deadline, entry.seq, produced=entry.produced,
                         sampling=entry.sampling)
            plan = self._alloc.open_slot(slot_ix, slot.prompt)
            slot.pending_from = plan.cached_tokens
            slot.position = plan.cached_tokens
            try:
                if plan.copies:
                    cache = self._apply_copies(model, cache, plan.copies)
            except Exception:
                logger.error("resume copy failed in generation worker "
                             "%s:\n%s", self._service_id,
                             traceback.format_exc())
                self._alloc.close_slot(slot_ix)
                free.insert(0, slot_ix)
                slot.stream.fail("preempted stream could not be resumed")
                continue
            slots[slot_ix] = slot  # its chunks run in _prefill_round
        return cache

    def _room_for_resume(self, entry: _Pending) -> bool:
        need = self._alloc.blocks_for(
            self._chunk if self._chunk > 0
            else len(entry.prompt or (entry.query or {}).get(
                "prompt_ids", [])) + 1)
        return (self._alloc.free_blocks()
                + self._alloc.evictable_blocks()) >= max(need, 1)

    def _stash(self, entry: _Pending) -> None:
        self._pending.append(entry)
        self._pending.sort(key=lambda e: e.seq)

    @staticmethod
    def _apply_copies(model, cache, copies):
        src = np.asarray([s for s, _ in copies], np.int32)
        dst = np.asarray([d for _, d in copies], np.int32)
        return model.kv_copy_blocks(cache, src, dst)

    def _try_chunk(self, model, spec, cache, slots, slot_ix, slot, end):
        """Prefill prompt positions [pending_from, end) of one slot.
        ``(ok, cache)``; ok False: the pool could not supply the pages even
        after preempting every younger stream (the caller stashes or
        preempts this slot). A model's exception propagates."""
        start = slot.pending_from
        n = len(slot.prompt)
        bt = self._alloc.block_tokens
        if not self._make_capacity(slots, slot_ix, end - 1):
            return False, cache
        for ix in range(start // bt, (end - 1) // bt + 1):
            copies = self._alloc.ensure_writable(slot_ix, ix * bt)
            if copies is None:
                if not self._preempt_youngest(slots, exclude=slot_ix):
                    return False, cache
                copies = self._alloc.ensure_writable(slot_ix, ix * bt)
                if copies is None:
                    return False, cache
            if copies:
                cache = self._apply_copies(model, cache, copies)
        tok, cache = model.paged_prefill(
            cache, self._alloc.table_row(slot_ix), list(slot.prompt[start:end]),
            int(start))
        slot.pending_from = end
        slot.position = end
        if end < n:
            return True, cache
        slot.pending_from = None
        if slot.temperature > 0.0:
            # sampled: rewind past prefill's greedy pick (see _admit); a
            # preempted sampled stream resumes the same way
            slot.last_id = slot.prompt[-1]
            slot.position = n - 1
            self._alloc.publish(slot_ix, slot.prompt)
            return True, cache
        tok = int(tok)
        slot.last_id = tok
        slot.produced += 1
        slot.tokens.append(tok)
        self._tokens_emitted += 1
        finished, reason = self._finish_reason(slot, spec, tok)
        if slot.deadline is not None and time.monotonic() >= slot.deadline:
            finished, reason = True, "deadline"
        slot.stream.push([tok], finished=finished, reason=reason)
        if finished:
            self._evict_slot(slots, slot_ix, reason)
        else:
            self._alloc.publish(slot_ix, slot.prompt)
        return True, cache

    def _prefill_round(self, model, spec, cache, slots):
        """Advance every prefilling slot by one chunk."""
        for i, slot in enumerate(slots):
            if slot is None or slot.pending_from is None:
                continue
            if slot.stream.cancelled:
                self._evict_slot(slots, i, "cancelled")
                continue
            n = len(slot.prompt)
            end = n if self._chunk <= 0 else min(n, slot.pending_from
                                                 + self._chunk)
            try:
                ok, cache = self._try_chunk(model, spec, cache, slots, i,
                                            slot, end)
            except Exception:
                logger.error("chunked prefill failed in generation worker "
                             "%s:\n%s", self._service_id,
                             traceback.format_exc())
                slot.stream.fail("prefill failed on the serving worker")
                self._evict_slot(slots, i, "error")
                continue
            if not ok and slots[i] is slot:
                # the pool is dry even after preempting younger streams:
                # this slot yields its pages and waits its turn
                self._preempt(slots, i)
        return cache

    # -- preemption ----------------------------------------------------------

    def _make_capacity(self, slots, slot_ix, position) -> bool:
        """Pages for ``position``, preempting streams younger than the
        requester until they land or none is left: an older stream is never
        displaced by a newer one, so the oldest always progresses."""
        while not self._alloc.ensure_capacity(slot_ix, position):
            if not self._preempt_youngest(slots, exclude=slot_ix):
                return False
        return True

    def _preempt_youngest(self, slots, exclude: int) -> bool:
        """Preempt the youngest stream younger than slot ``exclude``'s;
        False when there is none."""
        mine = slots[exclude].seq if slots[exclude] is not None else -1
        cand = [(s.seq, i) for i, s in enumerate(slots)
                if s is not None and i != exclude and s.seq > mine]
        if not cand:
            return False
        self._preempt(slots, max(cand)[1])
        return True

    def _preempt(self, slots, i) -> None:
        """Evict slot ``i`` for a dry pool: its pages go back and the
        stream is stashed with its whole history, to be re-prefilled (the
        client sees a pause, never an error or a repeated token). A history
        that can never fit the pool again fails typed instead of cycling
        through preemption."""
        slot = slots[i]
        slots[i] = None
        self._alloc.close_slot(i)
        if slot.stream.cancelled:
            self._count_eviction("cancelled")
            return
        history = list(slot.prompt)
        if slot.pending_from is None:
            history += slot.tokens
        if self._alloc.blocks_for(len(history) + 1) > self._alloc.pool_blocks:
            slot.stream.fail(
                f"stream outgrew the KV pool ({len(history)} tokens vs "
                f"{self._alloc.pool_blocks} blocks x "
                f"{self._alloc.block_tokens} tokens); raise "
                "RAFIKI_GEN_KV_POOL_BLOCKS")
            self._count_eviction("kv_pool")
            return
        self._count_eviction("preempted")
        self._preempted += 1
        logger.warning("generation worker: KV pool exhausted; preempting "
                       "the youngest stream %s (seq %d, %d tokens produced)",
                       slot.stream.seq_id, slot.seq, slot.produced)
        self._stash(_Pending(
            slot.seq, stream=slot.stream, prompt=history,
            produced=slot.produced, max_tokens=slot.max_tokens,
            deadline=slot.deadline,
            sampling=(slot.temperature, slot.top_k, slot.top_p,
                      slot.rng_seed)))

    # -- the decode round ----------------------------------------------------

    def _decode_round(self, model, spec: GenerationSpec, cache,
                      slots: List[Optional[_Slot]]):
        """Advance every resident decoding sequence one token."""
        n = len(slots)
        paged = self._alloc is not None
        if paged:
            # growth and copy-on-write before this round's writes
            for i, s in enumerate(slots):
                if s is None or s.pending_from is not None:
                    continue
                if not self._make_capacity(slots, i, s.position):
                    if slots[i] is s:
                        self._preempt(slots, i)
                    continue
                copies = self._alloc.ensure_writable(i, s.position)
                if copies is None:
                    if not self._preempt_youngest(slots, exclude=i):
                        s.stream.fail("KV pool exhausted and no younger "
                                      "stream left to preempt; raise "
                                      "RAFIKI_GEN_KV_POOL_BLOCKS")
                        self._evict_slot(slots, i, "kv_pool")
                        continue
                    copies = self._alloc.ensure_writable(i, s.position)
                    if copies is None:
                        s.stream.fail("KV pool exhausted")
                        self._evict_slot(slots, i, "kv_pool")
                        continue
                if copies:
                    cache = self._apply_copies(model, cache, copies)
        active = [(i, s) for i, s in enumerate(slots)
                  if s is not None and s.pending_from is None]
        if not active:
            return cache
        ids = np.zeros(n, np.int32)
        positions = np.zeros(n, np.int32)
        for i, s in active:
            ids[i] = s.last_id
            positions[i] = s.position
        live = set(i for i, _ in active)
        # one sampled slot puts the batch through the sampled step; its
        # greedy rows draw the argmax there
        sampled = (self._sampling_cap is not None
                   and any(s.temperature > 0.0 for _, s in active))
        try:
            if paged:
                tables = np.stack([
                    self._alloc.table_row(i) if i in live
                    else self._alloc.idle_row() for i in range(n)])
                if sampled:
                    next_ids, _, cache = model.paged_decode_step_sampled(
                        cache, ids, positions, tables,
                        self._sampling_arrays(slots, ROLE_TARGET, only=live))
                else:
                    next_ids, cache = model.paged_decode_step(
                        cache, ids, positions, tables)
            elif sampled:
                next_ids, _, cache = model.decode_step_sampled(
                    cache, ids, positions,
                    self._sampling_arrays(slots, ROLE_TARGET, only=live))
            else:
                next_ids, cache = model.decode_step(cache, ids, positions)
            next_ids = np.asarray(next_ids)
        except Exception:
            # a failed step may leave the cache half written: every
            # resident stream fails typed and the table is cleared; the
            # worker keeps serving new requests
            logger.error("decode_step failed in generation worker %s:\n%s",
                         self._service_id, traceback.format_exc())
            for i, s in enumerate(slots):
                if s is not None:
                    s.stream.fail("decode step failed on the serving worker")
                    self._evict_slot(slots, i, "error")
            return cache
        now = time.monotonic()
        for i, slot in active:
            if slots[i] is not slot:
                continue
            if slot.stream.cancelled:
                self._evict_slot(slots, i, "cancelled")
                continue
            token = int(next_ids[i])
            slot.position += 1
            slot.last_id = token
            slot.produced += 1
            slot.tokens.append(token)
            self._tokens_emitted += 1
            finished, reason = self._finish_reason(slot, spec, token)
            if slot.deadline is not None and now >= slot.deadline:
                finished, reason = True, "deadline"
            slot.stream.push([token], finished=finished, reason=reason)
            if finished:
                self._evict_slot(slots, i, reason)
        return cache

    @staticmethod
    def _finish_reason(slot: _Slot, spec: GenerationSpec, token: int):
        if spec.eos_token_id is not None and token == spec.eos_token_id:
            return True, "eos"
        if slot.produced >= slot.max_tokens:
            return True, "max_tokens"
        if slot.position + 1 >= spec.max_context:
            return True, "context"
        return False, None

    def _evict_slot(self, slots: List[Optional[_Slot]], i: int,
                    reason: str) -> None:
        slots[i] = None
        if self._alloc is not None:
            self._alloc.close_slot(i)
        self._count_eviction(reason or "unknown")

    def _count_eviction(self, reason: str) -> None:
        self._evictions[reason] = self._evictions.get(reason, 0) + 1

    @staticmethod
    def _parse_query(query):
        """(prompt, max_tokens, max_duration_s, (temperature, top_k,
        top_p, seed)); a malformed field raises
        :class:`GenerationRequestError`, a resume request too (not
        ported)."""
        if not isinstance(query, dict):
            raise GenerationRequestError(
                "generation query must be an object with 'prompt_ids'")
        if query.get("resume_tokens") is not None:
            raise GenerationRequestError(
                "resume_tokens asks to resume a stream on this replica; "
                "stream resume is not ported to rafiki_tpu_torch "
                "(ROADMAP.md)")
        prompt = query.get("prompt_ids")
        if (not isinstance(prompt, (list, tuple)) or not prompt
                or not all(isinstance(t, int) and t >= 0 for t in prompt)):
            raise GenerationRequestError(
                "'prompt_ids' must be a non-empty list of non-negative "
                "token ids")
        cap = max(int(config.GEN_MAX_TOKENS), 1)
        raw = query.get("max_tokens", cap)
        try:
            max_tokens = int(raw)
        except (TypeError, ValueError):
            raise GenerationRequestError(
                f"max_tokens={raw!r} is not an integer") from None
        if max_tokens < 1:
            raise GenerationRequestError(
                f"max_tokens={max_tokens} must be >= 1")
        max_tokens = min(max_tokens, cap)
        max_duration_s = query.get("max_duration_s")
        if max_duration_s is not None:
            try:
                max_duration_s = float(max_duration_s)
            except (TypeError, ValueError):
                raise GenerationRequestError(
                    "max_duration_s must be a number") from None

        def number(key, cast, default):
            raw = query.get(key, default)
            try:
                return cast(raw if raw is not None else default)
            except (TypeError, ValueError):
                raise GenerationRequestError(
                    f"{key}={raw!r} is not a number") from None

        temperature = number("temperature", float, 0.0)
        if temperature < 0.0:
            raise GenerationRequestError(
                f"temperature={temperature} must be >= 0")
        top_k = number("top_k", int, 0)
        if top_k < 0:
            raise GenerationRequestError(f"top_k={top_k} must be >= 0")
        top_p = number("top_p", float, 1.0)
        if not 0.0 < top_p <= 1.0:
            raise GenerationRequestError(f"top_p={top_p} must be in (0, 1]")
        if query.get("seed") is not None:
            seed = number("seed", int, 0)
            if seed < 0:
                raise GenerationRequestError(f"seed={seed} must be >= 0")
        elif temperature > 0.0:
            # derived now and kept for the stream's life: a preempted
            # stream must replay the same draws
            seed = uuid.uuid4().int & 0x7FFFFFFF
        else:
            seed = 0
        if temperature > 0.0 and not bool(config.GEN_SAMPLING):
            raise GenerationRequestError(
                "sampled generation is disabled on this deployment "
                "(RAFIKI_GEN_SAMPLING=0)")
        return (list(prompt), max_tokens, max_duration_s,
                (temperature, top_k, top_p, seed))

    # -- stats -----------------------------------------------------------------

    def _stats_row(self, slots, max_slots: int) -> None:
        """Fold the slot table into this worker's ``serving_stats`` row
        ('queries' stays the admitted-request count): busy slots, resident
        and stashed streams, tokens emitted, evictions by reason,
        preemptions, and under the paged layout the pool and the prefix
        cache's counters."""
        busy = sum(1 for s in slots if s is not None)
        with _stats_lock:
            s = SERVING_STATS.setdefault(
                self._service_id, {"batches": 0, "queries": 0})
            s["gen_slots_busy"] = busy
            s["gen_slots_max"] = max_slots
            s["gen_resident_streams"] = busy + len(self._pending)
            s["gen_tokens"] = self._tokens_emitted
            s["gen_job"] = self._job_id
            s["gen_evictions"] = dict(self._evictions)
            s["gen_preemptions"] = self._preempted
            if self._alloc is not None:
                st = self._alloc.stats()
                s["gen_kv_blocks_used"] = st["used_blocks"]
                s["gen_kv_blocks_cached"] = st["evictable_blocks"]
                s["gen_kv_pool_blocks"] = st["pool_blocks"]
                s["gen_kv_block_tokens"] = st["block_tokens"]
                s["gen_prefix_hits"] = st["prefix_hits"]
                s["gen_prefix_misses"] = st["prefix_misses"]
                s["gen_prefix_hit_tokens"] = st["prefix_hit_tokens"]
                s["gen_cow_copies"] = st["cow_copies"]
