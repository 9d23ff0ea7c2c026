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

Speculative decoding (``RAFIKI_GEN_SPEC``, on by default, whenever the
inference job's budget names a draft trial, ``GEN_DRAFT_TRIAL``): each
round the draft LM proposes ``RAFIKI_GEN_SPEC_K`` tokens a stream from
its own ring cache, the target verifies the k+1 positions in one
``paged_verify_step`` forward with rejection sampling, and each stream
commits its accepted prefix and one drawn token. A draft or verify fault
degrades the worker to plain decode, typed (``gen_spec_degraded`` in the
stats row), and the round finishes plain: the streams lose the speedup,
never a token.

Stream continuity: a retiring worker (stopping, its queue closed, a
``RAFIKI_CHAOS`` ``site=worker`` ``error``) hands each unfinished stream
back typed ``migrating`` for the door to resume on a sibling; a
``site=worker`` ``drop`` is the SIGKILL drill, which abandons them. A
resume request (``resume_tokens``, the committed tokens) prefills the
prompt and those tokens under the stream's seed and goes on from them.

The counters ride the worker's ``serving_stats`` row (a drain waits out
its ``gen_resident_streams``), mirrored each round into the metrics
registry under JAX's ``rafiki_gen_*`` names; the job's
``slot_occupancy:job:<id>`` ring
in the metrics registry carries the share of the binding resource (pool
pages, or slots) in use each round, the autoscaler's signal. The worker
serves from its grant's first card, under a ``CHIPS_PER_WORKER`` grant
too: the JAX worker only sets the grant, and its model sits on the
default device.
"""

from __future__ import annotations

import logging
import time
import traceback
import uuid
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from rafiki_tpu_torch import config
from rafiki_tpu_torch.cache.queue import TokenStream
from rafiki_tpu_torch.constants import BudgetType
from rafiki_tpu_torch.device import set_device_grant
from rafiki_tpu_torch.sdk.model import (
    ROLE_DRAFT,
    ROLE_TARGET,
    GenerationSpec,
    draft_capability,
    generation_capability,
    paged_generation_capability,
    sampling_capability,
    spec_verify_capability,
)
from rafiki_tpu_torch.utils import chaos
from rafiki_tpu_torch.utils.metrics import REGISTRY
from rafiki_tpu_torch.worker.inference import (
    SERVING_STATS,
    InferenceWorker,
    _record_batch,
    _stats_lock,
)
from rafiki_tpu_torch.worker.kv_paging import PagedKVAllocator

logger = logging.getLogger(__name__)



def _gen_metrics() -> Dict[str, Any]:
    """The generation plane's registry handles, under JAX's names."""
    c, g = REGISTRY.counter, REGISTRY.gauge
    return {
        "tokens": c("rafiki_gen_tokens_total",
                    "tokens emitted by generation workers in this process"),
        "slots": g("rafiki_gen_slots_busy",
                   "generation slots currently decoding", ("service",)),
        "evictions": c("rafiki_gen_evictions_total",
                       "sequences leaving the slot table, by finish reason",
                       ("reason",)),
        "kv_used": g("rafiki_gen_kv_blocks_used",
                     "paged-KV pool blocks currently allocated",
                     ("service",)),
        "kv_pool": g("rafiki_gen_kv_pool_blocks",
                     "paged-KV pool size in blocks", ("service",)),
        "prefix_hits": c("rafiki_gen_prefix_hits_total",
                         "admissions that reused cached prompt-prefix "
                         "blocks"),
        "prefix_misses": c("rafiki_gen_prefix_misses_total",
                           "admissions that found no cached prefix"),
        "prefix_tokens": c("rafiki_gen_prefix_tokens_total",
                           "prompt tokens served from the prefix cache "
                           "instead of prefill compute"),
        "cow": c("rafiki_gen_kv_cow_copies_total",
                 "copy-on-write page copies (tail-block divergence)"),
        "preempts": c("rafiki_gen_preemptions_total",
                      "streams preempted by pool exhaustion"),
        "spec_proposed": c("rafiki_gen_spec_proposed_total",
                           "draft tokens proposed to the speculative "
                           "verify step"),
        "spec_accepted": c("rafiki_gen_spec_accepted_total",
                           "draft tokens accepted by the target's verify "
                           "step"),
        "spec_rounds": c("rafiki_gen_spec_rounds_total",
                         "speculative draft-propose/verify rounds run"),
        "spec_degraded": c("rafiki_gen_spec_degraded_total",
                           "speculation degradations to plain decode"),
        "migrated": c("rafiki_gen_streams_migrated_total",
                      "unfinished streams handed back typed (MIGRATING) "
                      "by a retiring generation replica"),
    }

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
                 "temperature", "top_k", "top_p", "rng_seed", "muted",
                 "draft_ready")

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
        #: chaos ``drop`` at the slot: it decodes on, its deltas unsent
        #: (the door's stall window owns recovery)
        self.muted = False
        #: the draft's ring holds this slot's history; a round the slot
        #: sits out writes junk there, so it is prefilled again lazily
        self.draft_ready = False


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
            self._service_id = ctx.service_id
            self._init_spec(model, spec, max_slots)
            model.warm_up()
            ctx.ready()
            self._queue = queue
            slots: List[Optional[_Slot]] = [None] * max_slots
            # the job's occupancy series, the autoscaler's generation
            # signal
            occupancy_ring = REGISTRY.ring(
                f"slot_occupancy:job:{self._job_id}")
            self._tokens_emitted = 0
            self._seq = 0
            self._pending: List[_Pending] = []
            self._evictions: Dict[str, int] = {}
            self._preempted = 0
            # the registry's handles, and the counters' values last
            # mirrored into them
            self._gm = _gen_metrics()
            self._mirrored: Dict[str, int] = {}
            killed = False
            while not ctx.stopping:
                # the replica drills (RAFIKI_CHAOS site=worker): drop is
                # the SIGKILL drill, its streams abandoned with no last
                # delta (the door finds the queue gone at its stall window
                # and resumes them from its journal); error a clean
                # retirement, its streams handed back MIGRATING
                rule = chaos.hit(chaos.SITE_WORKER,
                                 f"{self._job_id}/{ctx.service_id}")
                if rule is not None:
                    if rule.action == chaos.ACTION_DELAY:
                        chaos.sleep_for(rule)
                    elif rule.action == chaos.ACTION_DROP:
                        logger.warning("chaos: killing generation replica "
                                       "%s (streams abandoned)",
                                       ctx.service_id)
                        killed = True
                        break
                    else:
                        logger.warning("chaos: retiring generation replica "
                                       "%s (streams handed back)",
                                       ctx.service_id)
                        break
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
                occupancy_ring.record(self._occupancy(slots, max_slots))
                self._stats_row(slots, max_slots)
                if n_active == 0 and not self._pending:
                    continue
                # -- decode: one token for every resident sequence -------
                if any(s is not None and s.pending_from is None
                       for s in slots):
                    if self._spec_on:
                        cache = self._spec_round(model, spec, cache, slots)
                    else:
                        cache = self._decode_round(model, spec, cache,
                                                   slots)
                elif n_active == 0:
                    # only stashed streams remain and none can run yet
                    time.sleep(0.005)
            # a retiring replica hands every unfinished stream back for a
            # resume on a sibling; the SIGKILL drill must not
            if not killed:
                self._hand_back_all(slots)
        finally:
            self._broker.unregister_worker(self._job_id, ctx.service_id)
            if getattr(self, "_draft", None) is not None:
                self._draft.destroy()
            if model is not None:
                model.destroy()
            set_device_grant(None)

    def _hand_back_all(self, slots: List[Optional[_Slot]]) -> None:
        """Hand every unfinished resident and stashed stream back typed
        ``migrating``: the door resumes each on a sibling from its journal
        (with no sibling left, its client gets a typed error). A request
        still waiting on its future gets the closed queue's error, as the
        door's submit walk expects."""
        message = (f"generation replica {self._service_id} is retiring; "
                   "stream handed back for resume on a sibling")
        handed = 0
        for i, s in enumerate(slots):
            if s is None:
                continue
            if s.stream.cancelled:
                self._evict_slot(slots, i, "cancelled")
                continue
            s.stream.hand_back(message)
            handed += 1
            self._evict_slot(slots, i, "migrating")
        for entry in self._pending:
            if entry.stream is not None:
                if not entry.stream.cancelled:
                    entry.stream.hand_back(message)
                    handed += 1
            elif entry.fut is not None:
                entry.fut.set_error(RuntimeError("worker queue closed"))
        self._pending = []
        if handed:
            logger.info("generation replica %s handed back %d unfinished "
                        "stream(s)", self._service_id, handed)

    # -- speculation set-up --------------------------------------------------

    def _init_spec(self, model, spec: GenerationSpec, max_slots: int) -> None:
        """Sampling needs a capable template; speculation the paged plane,
        the verify capability and a draft trial in the job's budget.
        Anything missing serves plain decode, its reason in the stats row
        (a job that budgets no draft is not a fault)."""
        self._sampling_cap = sampling_capability(type(model))
        self._spec_on = False
        self._spec_degraded: Optional[str] = None
        self._spec_k = min(max(int(config.GEN_SPEC_K), 1), 16)
        self._spec_proposed = 0
        self._spec_accepted = 0
        self._spec_rounds = 0
        self._draft = None
        self._draft_spec: Optional[GenerationSpec] = None
        self._draft_cache = None
        if not bool(config.GEN_SPEC) or self._alloc is None:
            return
        if spec_verify_capability(type(model)) is None:
            self._spec_degraded = (
                "template lacks the speculative verify capability "
                "(paged_verify_step and the sampled steps)")
            return
        try:
            draft = self._load_draft_model()
        except Exception:
            logger.error("draft model failed to load in generation worker "
                         "%s:\n%s", self._service_id, traceback.format_exc())
            self._spec_degraded = "draft model failed to load"
            return
        if draft is None:
            return
        dspec = draft_capability(type(draft))
        if dspec is None:
            draft.destroy()
            self._spec_degraded = (
                "draft trial's template is not draft-capable (the "
                "generation contract and decode_step_sampled)")
            return
        self._draft = draft
        self._draft_spec = dspec
        self._draft_cache = draft.init_kv_cache(max_slots)
        self._spec_on = True
        logger.info("generation worker %s: speculative decoding on (k=%d, "
                    "draft max_context=%d)", self._service_id, self._spec_k,
                    dspec.max_context)

    def _load_draft_model(self):
        """The draft trial the inference job's budget names
        (``GEN_DRAFT_TRIAL``), loaded as the served trial is; None when
        it names none."""
        if self._db is None:
            return None
        inf = self._db.get_inference_job(self._job_id)
        draft_tid = ((inf or {}).get("budget") or {}).get(
            BudgetType.GEN_DRAFT_TRIAL)
        if not draft_tid:
            return None
        return self._load_trial(str(draft_tid))

    def _degrade_spec(self, reason: str) -> None:
        """A draft or verify fault: plain decode from now on, typed. The
        resident streams decode on."""
        if not self._spec_on:
            return
        self._spec_on = False
        self._spec_degraded = reason
        logger.error("generation worker %s: speculative decoding degraded "
                     "to plain decode: %s", self._service_id, reason)

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
        admission order.

        A resume request (``resume_tokens``: the committed tokens of a
        stream a sibling lost) is admitted the same way: the prompt and
        those tokens are prefilled under the stream's seed, the keyed
        draws go on where the sibling stopped, and ``produced`` starts at
        the committed count, so ``max_tokens`` stays the first budget."""
        try:
            prompt, max_tokens, max_duration_s, sampling = \
                self._parse_query(query)
            resume = self._parse_resume(query)
        except GenerationRequestError as e:
            fut.set_error(e)
            return cache
        if resume and len(resume) >= max_tokens:
            fut.set_error(GenerationRequestError(
                f"resume_tokens ({len(resume)}) already meets max_tokens "
                f"({max_tokens}): nothing left to resume"))
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
        # the prefill history: the prompt, and a resume's committed tokens
        history = prompt + resume
        produced = len(resume)
        deadline = (time.monotonic() + max_duration_s
                    if max_duration_s else None)
        if self._alloc is not None:
            if self._alloc.blocks_for(len(history) + 1) \
                    > self._alloc.pool_blocks:
                fut.set_error(GenerationRequestError(
                    f"prompt and history ({len(history)} tokens) cannot fit "
                    f"the KV pool ({self._alloc.pool_blocks} blocks x "
                    f"{self._alloc.block_tokens} tokens); raise "
                    "RAFIKI_GEN_KV_POOL_BLOCKS"))
                return cache
            return self._admit_paged(model, spec, cache, slots, free, fut,
                                     history, max_tokens, deadline, seq=seq,
                                     sampling=sampling, produced=produced)
        # -- the contiguous ring ---------------------------------------------
        slot_ix = free.pop(0)
        try:
            first_id, cache = model.prefill(cache, slot_ix, list(history))
        except Exception as e:
            free.insert(0, slot_ix)
            logger.error("prefill failed in generation worker %s:\n%s",
                         self._service_id, traceback.format_exc())
            fut.set_error(RuntimeError(f"prefill failed: {e}"))
            return cache
        stream = TokenStream(seq_id=uuid.uuid4().hex[:12])
        slot = _Slot(stream, list(history), max_tokens, deadline,
                     self._next_seq() if seq is None else seq,
                     produced=produced, sampling=sampling)
        slots[slot_ix] = slot
        fut.set_result(stream)
        _record_batch(self._service_id, 1, self._queue)
        if slot.temperature > 0.0:
            # prefill's token is the greedy pick: rewind one row, so the
            # next decode round rewrites the last history position (the
            # same K/V) and samples the next token under its position's key
            slot.last_id = history[-1]
            slot.position = len(history) - 1
            return cache
        first_id = int(first_id)
        slot.last_id = first_id
        slot.position = len(history)
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
                     max_tokens, deadline, seq=None, sampling=None,
                     produced=0):
        """Open a block table for the prompt (mapping any cached prefix),
        run the first prefill chunk and resolve the request's future; the
        other chunks run one a round. A pool too dry for the first chunk
        stashes the request, the youngest stream, with its future. For a
        resume ``prompt`` is the whole history and ``produced`` the
        committed count."""
        slot_ix = free.pop(0)
        slot = _Slot(TokenStream(seq_id=uuid.uuid4().hex[:12]),
                     list(prompt), max_tokens, deadline,
                     self._next_seq() if seq is None else seq,
                     produced=produced, sampling=sampling)
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
                cut = len(prompt) - produced
                query = {"prompt_ids": list(prompt[:cut]),
                         "max_tokens": max_tokens, "max_duration_s": None,
                         "temperature": slot.temperature,
                         "top_k": slot.top_k, "top_p": slot.top_p,
                         "seed": slot.rng_seed}
                if produced:
                    query["resume_tokens"] = list(prompt[cut:])
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
                      slots: List[Optional[_Slot]], only=None):
        """Advance every resident decoding sequence one token; ``only``
        limits the round to those slots (a speculative round's streams
        that sat its verify out). The ``generate`` chaos rule is asked at
        each slot: a drill hurts one stream while the others decode on."""
        n = len(slots)
        paged = self._alloc is not None
        if paged:
            # growth and copy-on-write before this round's writes
            for i, s in enumerate(slots):
                if s is None or s.pending_from is not None:
                    continue
                if only is not None and i not in only:
                    continue
                if not self._make_capacity(slots, i, s.position):
                    if slots[i] is s:
                        self._preempt(slots, i)
                    continue
                copies = self._alloc.ensure_writable(i, s.position)
                while copies is None and self._preempt_youngest(slots,
                                                                exclude=i):
                    copies = self._alloc.ensure_writable(i, s.position)
                if copies is None:
                    # the youngest stream short of a copy-on-write page
                    # yields its own pages and waits its turn, as it does
                    # for a dry pool (the JAX worker fails it here)
                    self._preempt(slots, i)
                    continue
                if copies:
                    cache = self._apply_copies(model, cache, copies)
        active = [(i, s) for i, s in enumerate(slots)
                  if s is not None and s.pending_from is None
                  and (only is None or i in only)]
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
            if not self._slot_chaos(slots, i, slot):
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
            if not slot.muted:
                slot.stream.push([token], finished=finished, reason=reason)
            if finished:
                self._evict_slot(slots, i, reason)
        return cache

    def _slot_chaos(self, slots, i: int, slot: _Slot) -> bool:
        """The ``generate`` rule at one slot this round: ``delay`` sleeps,
        ``drop`` mutes the stream (it decodes on, unheard: the door's
        stall window owns recovery), ``error`` fails it. False when the
        slot was evicted."""
        rule = chaos.hit(chaos.SITE_GENERATE,
                         f"{self._job_id}/{self._service_id}/slot{i}/"
                         f"{slot.stream.seq_id}")
        if rule is None:
            return True
        if rule.action == chaos.ACTION_DELAY:
            chaos.sleep_for(rule)
        elif rule.action == chaos.ACTION_DROP:
            logger.warning("chaos: muting generation slot %d (%s)", i,
                           slot.stream.seq_id)
            slot.muted = True
        else:
            slot.stream.fail("chaos-injected mid-stream generation fault")
            self._evict_slot(slots, i, "error")
            return False
        return True

    # -- the speculative round -----------------------------------------------

    def _spec_round(self, model, spec: GenerationSpec, cache,
                    slots: List[Optional[_Slot]]):
        """One draft-propose and verify round: the draft proposes k tokens
        for each stream that can take them, the target verifies the k+1
        positions in one ``paged_verify_step``, and each commits its
        accepted prefix and one drawn token. A stream at a context edge,
        or whose k+1 pages could not be had, decodes plain this round; a
        draft or verify fault degrades speculation and the round finishes
        plain for all."""
        k = self._spec_k
        cand = [i for i, s in enumerate(slots)
                if s is not None and s.pending_from is None
                and s.position + k < spec.max_context
                and s.position + k < self._draft_spec.max_context]
        if not cand:
            return self._decode_round(model, spec, cache, slots)
        # the draft drills: a slow or failing draft costs the speedup,
        # never the streams
        rule = chaos.hit(chaos.SITE_GENERATE,
                         f"draft/{self._job_id}/{self._service_id}")
        if rule is not None:
            if rule.action == chaos.ACTION_DELAY:
                chaos.sleep_for(rule)
            elif rule.action == chaos.ACTION_DROP:
                return self._decode_round(model, spec, cache, slots)
            else:
                self._degrade_spec("chaos-injected draft fault")
                return self._decode_round(model, spec, cache, slots)
        # growth and copy-on-write over the whole k+1-row burst: a
        # published prefix page never takes a verify write
        bt = self._alloc.block_tokens
        part: List[int] = []
        for i in cand:
            s = slots[i]
            if s is None:
                continue  # preempted for an earlier stream's burst
            ok = self._make_capacity(slots, i, s.position + k)
            if ok:
                for bx in range(s.position // bt, (s.position + k) // bt + 1):
                    copies = self._alloc.ensure_writable(i, bx * bt)
                    if copies is None:
                        ok = False
                        break
                    if copies:
                        cache = self._apply_copies(model, cache, copies)
            if ok:
                part.append(i)
        part = [i for i in part if slots[i] is not None]
        rest = set(i for i, s in enumerate(slots)
                   if s is not None and s.pending_from is None
                   and i not in part)
        if not part:
            return self._decode_round(model, spec, cache, slots, only=rest)
        # the burst writes junk into the draft ring rows of the slots
        # that sit it out: they prefill it again when they next take part
        for i in rest:
            slots[i].draft_ready = False
        n = len(slots)
        try:
            for i in part:
                s = slots[i]
                if s.draft_ready:
                    continue
                # the committed history, rows 0..position (the burst's
                # first step rewrites row position with the same K/V)
                _, self._draft_cache = self._draft.prefill(
                    self._draft_cache, i, list(s.prompt) + list(s.tokens))
                s.draft_ready = True
            cur = np.zeros(n, np.int32)
            cpos = np.zeros(n, np.int32)
            for i in part:
                cur[i] = slots[i].last_id
                cpos[i] = slots[i].position
            dsamp = self._sampling_arrays(slots, ROLE_DRAFT, only=part)
            burst = getattr(self._draft, "decode_steps_sampled", None)
            if callable(burst):
                d_ids, draft_probs, self._draft_cache = burst(
                    self._draft_cache, cur, cpos, k, dsamp)
                d_ids = np.asarray(d_ids, np.int32)          # (S, k)
            else:
                d_ids = np.zeros((n, k), np.int32)
                q_list = []
                for j in range(k):
                    nxt, q, self._draft_cache = \
                        self._draft.decode_step_sampled(
                            self._draft_cache, cur.copy(), cpos.copy(),
                            dsamp)
                    nxt = np.asarray(nxt, np.int32)
                    d_ids[:, j] = nxt
                    q_list.append(q)
                    cur = nxt
                    cpos = cpos + 1
                # (S, k, V), on the draft's device
                draft_probs = torch.stack(
                    [torch.as_tensor(q) for q in q_list], 1)
        except Exception:
            logger.error("draft propose failed in generation worker %s:\n%s",
                         self._service_id, traceback.format_exc())
            self._degrade_spec("draft propose failed")
            return self._decode_round(model, spec, cache, slots)
        ids2 = np.zeros((n, k + 1), np.int32)
        pos2 = np.tile(np.arange(k + 1, dtype=np.int32), (n, 1))
        for i in part:
            s = slots[i]
            ids2[i, 0] = s.last_id
            ids2[i, 1:] = d_ids[i]
            pos2[i] = s.position + np.arange(k + 1, dtype=np.int32)
        tables = np.stack([self._alloc.table_row(i) if i in part
                           else self._alloc.idle_row() for i in range(n)])
        vsamp = self._sampling_arrays(slots, ROLE_TARGET, only=part)
        try:
            acc, toks, cache = model.paged_verify_step(
                cache, ids2, pos2, tables, draft_probs, vsamp)
            acc = np.asarray(acc)
            toks = np.asarray(toks)
        except Exception:
            # raised before a new cache came back: the table is whole
            # (a draft and target of other vocabularies is the usual cause)
            logger.error("speculative verify failed in generation worker "
                         "%s:\n%s", self._service_id, traceback.format_exc())
            self._degrade_spec("verify step failed (draft/target mismatch?)")
            return self._decode_round(model, spec, cache, slots)
        now = time.monotonic()
        self._spec_rounds += 1
        for i in part:
            s = slots[i]
            if s is None or not self._slot_chaos(slots, i, s):
                continue
            if s.stream.cancelled:
                self._evict_slot(slots, i, "cancelled")
                continue
            a = int(acc[i])
            self._spec_proposed += k
            self._spec_accepted += a
            emit: List[int] = []
            finished, reason = False, None
            for t in toks[i, :a + 1]:
                token = int(t)
                s.position += 1
                s.last_id = token
                s.produced += 1
                s.tokens.append(token)
                emit.append(token)
                self._tokens_emitted += 1
                finished, reason = self._finish_reason(s, spec, token)
                if finished:
                    break
            if s.deadline is not None and now >= s.deadline:
                finished, reason = True, "deadline"
            if not s.muted:
                s.stream.push(emit, finished=finished, reason=reason)
            if finished:
                self._evict_slot(slots, i, reason)
            else:
                # the pages holding only rejected rows go back; a stale
                # row in the frontier page is written before it is read
                self._alloc.truncate_to(i, s.position)
        if rest:
            cache = self._decode_round(model, spec, cache, slots, only=rest)
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
        :class:`GenerationRequestError`."""
        if not isinstance(query, dict):
            raise GenerationRequestError(
                "generation query must be an object with 'prompt_ids'")
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

    @staticmethod
    def _parse_resume(query) -> List[int]:
        """A resume request's committed tokens (``resume_tokens``; [] for
        a new stream)."""
        raw = query.get("resume_tokens") if isinstance(query, dict) \
            else None
        if raw is None:
            return []
        if (not isinstance(raw, (list, tuple))
                or not all(isinstance(t, int) and t >= 0 for t in raw)):
            raise GenerationRequestError(
                "'resume_tokens' must be a list of non-negative token ids")
        return list(raw)

    # -- stats -----------------------------------------------------------------

    def _occupancy(self, slots, max_slots: int) -> float:
        """The share of the binding resource in use: pool pages under the
        paged layout (a few long streams can exhaust the pool with slots
        to spare), else slots."""
        if self._alloc is not None:
            return self._alloc.used_blocks() / self._alloc.pool_blocks
        return sum(1 for s in slots if s is not None) / max_slots

    def _stats_row(self, slots, max_slots: int) -> None:
        """Fold the slot table into this worker's ``serving_stats`` row
        ('queries' stays the admitted-request count): busy slots, resident
        and stashed streams, tokens emitted, evictions by reason,
        preemptions, speculation (on, tokens proposed and accepted,
        rounds, and the reason it degraded), and under the paged layout
        the pool and the prefix cache's counters."""
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
            s["gen_spec_on"] = self._spec_on
            s["gen_spec_proposed"] = self._spec_proposed
            s["gen_spec_accepted"] = self._spec_accepted
            s["gen_spec_rounds"] = self._spec_rounds
            if self._spec_degraded:
                s["gen_spec_degraded"] = self._spec_degraded
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
            row = dict(s)
        self._mirror_row(row)

    def _mirror_row(self, row: Dict[str, Any]) -> None:
        """The stats row into the metrics registry under JAX's names: the
        gauges set, the counters advanced by what they gained since the
        last round."""
        m = self._gm
        sid = self._service_id
        m["slots"].labels(sid).set(row["gen_slots_busy"])
        if "gen_kv_pool_blocks" in row:
            m["kv_used"].labels(sid).set(row["gen_kv_blocks_used"])
            m["kv_pool"].labels(sid).set(row["gen_kv_pool_blocks"])
        totals = {"tokens": row["gen_tokens"],
                  "preempts": row["gen_preemptions"],
                  "spec_proposed": row["gen_spec_proposed"],
                  "spec_accepted": row["gen_spec_accepted"],
                  "spec_rounds": row["gen_spec_rounds"],
                  "spec_degraded": int(bool(row.get("gen_spec_degraded"))),
                  "migrated": row["gen_evictions"].get("migrating", 0),
                  "prefix_hits": row.get("gen_prefix_hits", 0),
                  "prefix_misses": row.get("gen_prefix_misses", 0),
                  "prefix_tokens": row.get("gen_prefix_hit_tokens", 0),
                  "cow": row.get("gen_cow_copies", 0)}
        totals.update({f"evictions:{r}": n
                       for r, n in row["gen_evictions"].items()})
        for key, total in totals.items():
            gained = total - self._mirrored.get(key, 0)
            if gained <= 0:
                continue
            self._mirrored[key] = total
            name, _, reason = key.partition(":")
            (m[name].labels(reason) if reason else m[name]).inc(gained)

