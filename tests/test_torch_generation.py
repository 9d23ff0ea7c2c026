"""Streamed generation in the port: ``TokenStream``, the paged allocator,
the slot scheduler (``worker/generation.py``), the ``/generate`` door,
and the ``Client`` -> admin -> per-job door cycle, held against the JAX
package.

- ``PagedKVAllocator`` against ``rafiki_tpu/worker/kv_paging.py`` on one
  scripted sequence of open, capacity, publish, copy-on-write and close:
  the same tables, refcounts and stats.
- The scheduler cases of ``tests/test_generation.py`` and
  ``tests/test_paged_kv.py``, on a scripted model and on
  ``templates/torch_gen_lm.py`` (``TorchGenLM``, trained on the CPU).
- The cycle: ``TorchGenLM`` uploaded under ``TEXT_GENERATION``, trained,
  deployed with ``RAFIKI_PREDICTOR_PORTS=1``; its greedy streams equal
  the JAX ``TinyGenLM``'s (``tests/fixtures/gen_model.py``) on the same
  trained weights, token for token; sampled streams with a fixed seed
  repeat.
"""

import importlib.util
import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from rafiki_tpu.worker import kv_paging as jkv
from rafiki_tpu_torch import config
from rafiki_tpu_torch.admin.admin import Admin
from rafiki_tpu_torch.admin.http import AdminServer
from rafiki_tpu_torch.cache import wire
from rafiki_tpu_torch.cache.queue import (
    GenerationError,
    InProcessBroker,
    TokenStream,
)
from rafiki_tpu_torch.client.client import (
    Client,
    GenerationStreamError,
    RafikiError,
)
from rafiki_tpu_torch.db.database import Database
from rafiki_tpu_torch.device import set_device_grant
from rafiki_tpu_torch.placement.manager import (
    ChipAllocator,
    LocalPlacementManager,
)
from rafiki_tpu_torch.predictor.predictor import Predictor
from rafiki_tpu_torch.predictor.server import PredictorServer
from rafiki_tpu_torch.sdk.model import (
    BaseModel,
    GenerationSpec,
    generation_capability,
    paged_generation_capability,
    sampling_capability,
)
from rafiki_tpu_torch.sdk.params import load_params
from rafiki_tpu_torch.templates.torch_gen_lm import TorchGenLM
from rafiki_tpu_torch.worker import kv_paging
from rafiki_tpu_torch.worker.generation import (
    GenerationRequestError,
    GenerationUnsupportedError,
    GenerationWorker,
)

HERE = os.path.dirname(__file__)
TEMPLATE = os.path.join(HERE, "..", "rafiki_tpu_torch", "templates",
                        "torch_gen_lm.py")


# -- the stream ----------------------------------------------------------------

def test_token_stream_semantics():
    s = TokenStream("seq1")
    s.push([1, 2])
    s.push([3], finished=True, reason="eos")
    d1 = s.next_delta(0.1)
    assert d1.tokens == [1, 2] and not d1.finished
    d2 = s.next_delta(0.1)
    assert d2.tokens == [3] and d2.finished and d2.reason == "eos"
    assert s.finished
    with pytest.raises(StopIteration):
        s.next_delta(0.1)
    s.push([9])  # after the terminal delta: dropped
    with pytest.raises(StopIteration):
        s.next_delta(0.1)


def test_token_stream_fail_timeout_and_cancel():
    s = TokenStream("seq2")
    with pytest.raises(TimeoutError):
        s.next_delta(0.05)
    s.fail("worker exploded")
    with pytest.raises(GenerationError, match="worker exploded"):
        s.next_delta(0.1)
    s2 = TokenStream("seq3")
    assert not s2.cancelled
    s2.cancel()
    assert s2.cancelled


# -- the allocator against the JAX package's ----------------------------------

def _script(mod):
    """One scripted run of the allocator; its observable state after each
    step."""
    a = mod.PagedKVAllocator(pool_blocks=8, block_tokens=4, table_blocks=6)
    seen = []

    def snap(label, value=None):
        seen.append((label, value, a.refcounts(), a.stats(),
                     {s: a.table_row(s).tolist() for s in ("A", "B", "C")
                      if s in a._tables}))

    prompt = list(range(10))
    plan = a.open_slot("A", prompt)
    snap("open A", (plan.cached_tokens, plan.copies))
    snap("cap A", a.ensure_capacity("A", 9))
    a.publish("A", prompt)
    snap("publish A")
    plan = a.open_slot("B", prompt)
    snap("open B", (plan.cached_tokens, plan.copies))
    snap("cow B", a.ensure_writable("B", 9))
    snap("cow A", a.ensure_writable("A", 10))
    snap("cap A 13", a.ensure_capacity("A", 13))
    # the speculative rollback: A's burst took pages to row 13 and kept 11
    snap("trunc A 11", a.truncate_to("A", 11))
    snap("trunc A 12", a.truncate_to("A", 12))
    plan = a.open_slot("C", list(range(4)) + [99, 98])
    snap("open C", (plan.cached_tokens, plan.copies))
    snap("cap C", a.ensure_capacity("C", 20))
    snap("trunc C 9", a.truncate_to("C", 9))
    # through B's shared prefix pages: dereferenced, never freed while
    # the cache holds them
    snap("trunc B 3", a.truncate_to("B", 3))
    snap("trunc B 0", a.truncate_to("B", 0))
    a.close_slot("A")
    a.close_slot("B")
    snap("close A B")
    snap("cap C again", a.ensure_capacity("C", 20))
    a.close_slot("C")
    snap("drop", a.drop_cache())
    return seen


def test_allocator_matches_jax_on_a_scripted_sequence():
    ours, theirs = _script(kv_paging), _script(jkv)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert a == b, (a[0], a, b)
    assert ours[-1][2] == [0] * 8  # every refcount drained


def test_allocator_exhaustion_is_typed():
    a = kv_paging.PagedKVAllocator(pool_blocks=2, block_tokens=4,
                                   table_blocks=4, prefix_cache=False)
    a.open_slot(0, [1, 2, 3])
    with pytest.raises(kv_paging.KVPoolExhaustedError):
        a.ensure_capacity(0, 999)


# -- the capability oracle -------------------------------------------------------

class _HalfWired(BaseModel):
    generation_spec = GenerationSpec(eos_token_id=0)

    @staticmethod
    def get_knob_config():
        return {}

    def train(self, dataset_uri):
        pass

    def evaluate(self, dataset_uri):
        return 0.0

    def predict(self, queries):
        return list(queries)

    def dump_parameters(self):
        return {}

    def load_parameters(self, params):
        pass


class _Scripted(_HalfWired):
    """Next token = last + 1; EOS 99."""

    generation_spec = GenerationSpec(eos_token_id=99, max_context=100000)

    def init_kv_cache(self, max_slots):
        return {"slots": max_slots}

    def prefill(self, cache, slot, prompt_ids):
        return prompt_ids[-1] + 1, cache

    def decode_step(self, cache, ids, positions):
        return np.asarray(ids) + 1, cache


def test_generation_capability_oracle():
    assert generation_capability(_HalfWired) is None
    spec = generation_capability(_Scripted)
    assert spec is not None and spec.eos_token_id == 99
    assert paged_generation_capability(_Scripted) is None
    assert sampling_capability(_Scripted) is None
    assert generation_capability(type("NoSpec", (BaseModel,), {})) is None
    assert paged_generation_capability(TorchGenLM).max_context == 64
    assert sampling_capability(TorchGenLM) is not None


# -- the slot scheduler ------------------------------------------------------------

class _Ctx:
    def __init__(self, service_id="w1"):
        self.service_id = service_id
        self.chips = ["cpu"]
        self.stopping = False
        self.ready_event = threading.Event()

    def ready(self):
        self.ready_event.set()


def _start_worker(broker, model, job="genjob"):
    worker = GenerationWorker(job, "trial1", db=None, broker=broker)
    worker._load_model = lambda: model
    ctx = _Ctx()
    t = threading.Thread(target=worker.start, args=(ctx,), daemon=True)
    t.start()
    assert ctx.ready_event.wait(30), "worker never became ready"
    return worker, ctx, t


def _stop(ctx, t):
    ctx.stopping = True
    t.join(timeout=10)
    assert not t.is_alive()


def _stream(broker, job, query, timeout_s=30.0):
    q = list(broker.get_worker_queues(job).values())[0]
    fut = q.submit_many([query], deadline=time.monotonic() + timeout_s)[0]
    return fut.result(timeout_s)


def _drain(stream, timeout_s=30.0):
    toks, reason = [], None
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            d = stream.next_delta(1.0)
        except StopIteration:
            break
        toks.extend(d.tokens)
        if d.finished:
            reason = d.reason
            break
    return toks, reason


def test_scheduler_eos_and_max_tokens(monkeypatch):
    monkeypatch.setenv("RAFIKI_GEN_MAX_SLOTS", "2")
    broker = InProcessBroker()
    _, ctx, t = _start_worker(broker, _Scripted())
    try:
        assert _drain(_stream(broker, "genjob", {
            "prompt_ids": [97], "max_tokens": 50})) == ([98, 99], "eos")
        assert _drain(_stream(broker, "genjob", {
            "prompt_ids": [5], "max_tokens": 3})) == ([6, 7, 8],
                                                      "max_tokens")
    finally:
        _stop(ctx, t)


def test_scheduler_admits_mid_decode(monkeypatch):
    """A short sequence finishing frees its slot to a queued request while
    the long co-resident sequence keeps decoding."""
    monkeypatch.setenv("RAFIKI_GEN_MAX_SLOTS", "2")

    class _Slow(_Scripted):
        def decode_step(self, cache, ids, positions):
            time.sleep(0.01)
            return np.asarray(ids) + 1, cache

    broker = InProcessBroker()
    _, ctx, t = _start_worker(broker, _Slow())
    try:
        q = list(broker.get_worker_queues("genjob").values())[0]
        deadline = time.monotonic() + 30
        fa = q.submit_many([{"prompt_ids": [1], "max_tokens": 200}],
                           deadline=deadline)[0]
        fb = q.submit_many([{"prompt_ids": [1], "max_tokens": 3}],
                           deadline=deadline)[0]
        sa, sb = fa.result(10), fb.result(10)
        fc = q.submit_many([{"prompt_ids": [1], "max_tokens": 3}],
                           deadline=deadline)[0]
        assert _drain(sb)[1] == "max_tokens"
        sc = fc.result(10)  # admitted when B's slot freed
        assert sc.next_delta(5).tokens
        assert not sa.next_delta(5).finished  # A still decoding
        sa.cancel()
        _drain(sc)
    finally:
        _stop(ctx, t)


def test_scheduler_refuses_malformed_and_resume_requests_typed(monkeypatch):
    """Malformed requests are refused typed and cost no slot. A resume
    request (``resume_tokens``, as the door's journal sends it) is
    admitted: the prompt and the committed tokens are prefilled, and the
    stream goes on to the first budget (``max_tokens`` counts the
    committed tokens), as the JAX package's worker does."""
    monkeypatch.setenv("RAFIKI_GEN_MAX_SLOTS", "1")
    broker = InProcessBroker()
    _, ctx, t = _start_worker(broker, _Scripted())
    try:
        for query, match in (
                ({"prompt_ids": []}, "prompt_ids"),
                ({"prompt_ids": [1], "max_tokens": 0}, "max_tokens"),
                ({"prompt_ids": [1], "top_p": 0}, "top_p"),
                ({"prompt_ids": [1], "resume_tokens": [-2]},
                 "resume_tokens"),
                ({"prompt_ids": [1], "max_tokens": 2,
                  "resume_tokens": [2, 3]}, "nothing left to resume"),
                # a greedy-only template refuses sampling, typed
                ({"prompt_ids": [1], "temperature": 0.5},
                 "sampling-capable")):
            with pytest.raises(GenerationRequestError, match=match):
                _stream(broker, "genjob", query)
        # the refusals cost no slot
        assert _drain(_stream(broker, "genjob", {
            "prompt_ids": [10], "max_tokens": 2}))[0] == [11, 12]
        # a resume continues from its committed tokens
        assert _drain(_stream(broker, "genjob", {
            "prompt_ids": [10], "max_tokens": 4,
            "resume_tokens": [11, 12]})) == ([13, 14], "max_tokens")
    finally:
        _stop(ctx, t)


def test_scheduler_context_edge(monkeypatch):
    monkeypatch.setenv("RAFIKI_GEN_MAX_SLOTS", "1")

    class _Tiny(_Scripted):
        generation_spec = GenerationSpec(eos_token_id=9999, max_context=8)

    broker = InProcessBroker()
    _, ctx, t = _start_worker(broker, _Tiny())
    try:
        toks, reason = _drain(_stream(broker, "genjob", {
            "prompt_ids": [1, 2, 3, 4], "max_tokens": 4}))
        assert reason in ("context", "max_tokens") and len(toks) >= 3
        with pytest.raises(GenerationRequestError, match="max_context"):
            _stream(broker, "genjob", {"prompt_ids": [1, 2, 3, 4, 5, 6],
                                       "max_tokens": 50})
    finally:
        _stop(ctx, t)


def test_worker_without_capability_is_a_typed_deploy_error():
    broker = InProcessBroker()
    worker = GenerationWorker("j2", "t", db=None, broker=broker)
    worker._load_model = lambda: _HalfWired()
    with pytest.raises(GenerationUnsupportedError):
        worker.start(_Ctx())
    assert not broker.get_worker_queues("j2")


def test_stopping_worker_ends_resident_streams_typed(monkeypatch):
    """A stopping worker hands its resident streams back typed MIGRATING
    for a resume on a sibling, never silently; through the door's
    ``Predictor`` with no sibling left, the client gets a typed
    ``GenerationError``, not the hand-back."""
    from rafiki_tpu_torch.cache.queue import StreamMigratingError

    monkeypatch.setenv("RAFIKI_GEN_MAX_SLOTS", "2")

    class _Slow(_Scripted):
        def decode_step(self, cache, ids, positions):
            time.sleep(0.01)
            return np.asarray(ids) + 1, cache

    broker = InProcessBroker()
    _, ctx, t = _start_worker(broker, _Slow())
    s = _stream(broker, "genjob", {"prompt_ids": [1], "max_tokens": 500})
    door = Predictor("genjob", broker, None).generate(
        {"prompt_ids": [1], "max_tokens": 500})
    s.next_delta(5)
    door.next_delta(5)
    _stop(ctx, t)
    with pytest.raises(StreamMigratingError, match="retiring"):
        while not s.next_delta(5).finished:
            pass
    with pytest.raises(GenerationError, match="model_version") as err:
        while not door.next_delta(5).finished:
            pass
    assert not isinstance(err.value, StreamMigratingError)


def _cow_shortfall(jax_side: bool):
    """A 3-page pool (4 rows a page) where stream B, the youngest, must
    copy its published tail page before its next write, no page is free
    or evictable and no younger stream is left: one decode round, then
    B's stream, A's new token and whether B waits stashed."""
    if jax_side:
        from rafiki_tpu.cache.queue import TokenStream as Stream
        from rafiki_tpu.worker import generation as gen
        alloc_mod = jkv
    else:
        Stream = TokenStream
        from rafiki_tpu_torch.worker import generation as gen
        alloc_mod = kv_paging

    class _Paged:
        def paged_decode_step(self, cache, ids, positions, tables):
            return np.asarray(ids) + 1, cache

        def kv_copy_blocks(self, cache, src, dst):
            return cache

    alloc = alloc_mod.PagedKVAllocator(pool_blocks=3, block_tokens=4,
                                       table_blocks=4)
    a_prompt, b_prompt = [1, 2, 3, 4, 5, 6], [1, 2, 3, 4, 9, 9, 9]
    alloc.open_slot(0, a_prompt)
    assert alloc.ensure_capacity(0, 5)
    alloc.publish(0, a_prompt)
    assert alloc.ensure_writable(0, 6)  # A's tail copied: its own page
    alloc.open_slot(1, b_prompt)        # the chain page shared
    assert alloc.ensure_capacity(1, 6)  # evicts A's published tail
    alloc.publish(1, b_prompt)
    assert alloc.free_blocks() == 0 and alloc.evictable_blocks() == 0
    worker = gen.GenerationWorker("cowjob", "t", db=None, broker=None)
    worker._alloc = alloc
    worker._sampling_cap = None
    worker._service_id = "w"
    worker._pending, worker._evictions = [], {}
    worker._preempted = worker._tokens_emitted = 0
    slots = []
    for seq, (prompt, pos) in enumerate(((a_prompt, 7), (b_prompt, 7)),
                                        start=1):
        slot = gen._Slot(Stream(seq_id=f"s{seq}"), list(prompt), 50, None,
                         seq)
        slot.position, slot.last_id = pos, 70 + seq
        slot.tokens = [prompt[-1] + 1]
        slots.append(slot)
    b_stream = slots[1].stream
    args = (_Paged(), gen.GenerationSpec(eos_token_id=None,
                                         max_context=16), {}, slots)
    if jax_side:
        worker._decode_round(*args, _Ctx("w"))
    else:
        worker._decode_round(*args)
    a_token = slots[0].stream.next_delta(1).tokens
    return b_stream, a_token, [p.stream for p in worker._pending]


def test_the_youngest_stream_short_of_a_copy_page_yields(monkeypatch):
    """The JAX worker fails the youngest stream whose copy-on-write page
    the pool cannot supply when no younger stream is left to preempt
    (``rafiki_tpu/worker/generation.py:1053-1061``); the port preempts
    that stream itself, as for a dry pool: it waits stashed with its
    history and resumes when pages come back. The oldest decodes on in
    both."""
    from rafiki_tpu.cache.queue import GenerationError as JaxGenerationError

    theirs, jax_a, jax_pending = _cow_shortfall(jax_side=True)
    with pytest.raises(JaxGenerationError, match="KV pool exhausted"):
        theirs.next_delta(1)
    assert jax_pending == []
    ours, a_token, pending = _cow_shortfall(jax_side=False)
    assert a_token == jax_a == [72]
    assert pending == [ours] and not ours.cancelled
    with pytest.raises(TimeoutError):
        ours.next_delta(0.05)  # no error: it waits for its pages


# -- TorchGenLM under the scheduler ---------------------------------------------

@pytest.fixture(scope="module")
def tiny_lm():
    set_device_grant(["cpu"])
    try:
        model = TorchGenLM(lr=0.01, dim=16)
        model.train(None)
    finally:
        set_device_grant(None)
    return model


def _serve(monkeypatch, model, prompts, max_tokens, job, env,
           sampling=None, one_at_a_time=False):
    """Each prompt's tokens, streamed by one worker: the prompts all at
    once, or each after the last ended."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    broker = InProcessBroker()
    worker, ctx, t = _start_worker(broker, model, job=job)

    def submit(p):
        return _stream(broker, job, {"prompt_ids": p,
                                     "max_tokens": max_tokens,
                                     **(sampling or {})})

    try:
        if one_at_a_time:
            outs = [_drain(submit(p)) for p in prompts]
        else:
            outs = [_drain(s) for s in [submit(p) for p in prompts]]
        return [toks for toks, _ in outs], worker
    finally:
        _stop(ctx, t)


def test_paged_and_ring_serve_the_same_streams(monkeypatch, tiny_lm):
    shared = list(range(1, 21))
    prompts = [shared + [30], shared + [30], shared + [40], [7, 7, 7]]
    env = {"RAFIKI_GEN_MAX_SLOTS": "2", "RAFIKI_GEN_KV_BLOCK_TOKENS": "8",
           "RAFIKI_GEN_PREFILL_CHUNK": "8"}
    paged, worker = _serve(monkeypatch, tiny_lm, prompts, 6, "pj",
                           {**env, "RAFIKI_GEN_KV_PAGED": "1"},
                           one_at_a_time=True)
    st = worker._alloc.stats()
    assert st["prefix_hits"] >= 2 and st["cow_copies"] >= 1, st
    ring, worker2 = _serve(monkeypatch, tiny_lm, prompts, 6, "rj",
                           {**env, "RAFIKI_GEN_KV_PAGED": "0"},
                           one_at_a_time=True)
    assert worker2._alloc is None
    assert paged == ring and paged[0] == paged[1]
    assert all(len(toks) == 6 for toks in paged)


def test_shared_prefix_pays_prefill_once(monkeypatch, tiny_lm):
    calls = []
    orig = tiny_lm.paged_prefill

    def spy(cache, block_table, prompt_ids, start):
        calls.append((int(start), len(prompt_ids)))
        return orig(cache, block_table, prompt_ids, start)

    monkeypatch.setattr(tiny_lm, "paged_prefill", spy)
    system = list(range(1, 25))  # 3 full blocks
    outs, worker = _serve(
        monkeypatch, tiny_lm, [system + [30 + i] for i in range(4)], 4, "sj",
        {"RAFIKI_GEN_MAX_SLOTS": "4", "RAFIKI_GEN_KV_BLOCK_TOKENS": "8",
         "RAFIKI_GEN_KV_PAGED": "1", "RAFIKI_GEN_PREFILL_CHUNK": "0"})
    assert all(len(toks) == 4 for toks in outs)
    assert calls[0] == (0, 25)
    assert all(c[0] >= 16 and c[1] <= 9 for c in calls[1:]), calls
    assert worker._alloc.hits == 3 and worker._alloc.misses == 1


@pytest.mark.parametrize("sampling", [None, {"temperature": 0.9,
                                             "top_p": 0.95, "seed": 11}])
def test_pool_exhaustion_preempts_and_streams_stay_exact(monkeypatch,
                                                         tiny_lm, sampling):
    """Three streams of 32 tokens through a pool of 48: the youngest is
    preempted and re-prefilled, every stream completes, and each equals
    its uncontended run (greedy, and sampled with a fixed seed); after
    the streams no page is held."""
    prompts = [[10 + i] * 16 for i in range(3)]
    env = {"RAFIKI_GEN_MAX_SLOTS": "3", "RAFIKI_GEN_KV_BLOCK_TOKENS": "8",
           "RAFIKI_GEN_KV_POOL_BLOCKS": "6", "RAFIKI_GEN_KV_PAGED": "1",
           "RAFIKI_GEN_PREFIX_CACHE": "0", "RAFIKI_GEN_PREFILL_CHUNK": "8"}
    outs, worker = _serve(monkeypatch, tiny_lm, prompts, 16, "fj", env,
                          sampling)
    assert all(len(toks) == 16 for toks in outs), outs
    assert worker._preempted >= 1
    assert worker._alloc.used_blocks() == 0
    assert all(r == 0 for r in worker._alloc.refcounts())
    alone = [_serve(monkeypatch, tiny_lm, [p], 16, f"solo{i}",
                    {"RAFIKI_GEN_KV_POOL_BLOCKS": "0"}, sampling)[0][0]
             for i, p in enumerate(prompts)]
    assert outs == alone


def test_sampled_streams_repeat_with_a_seed_and_differ_across(monkeypatch,
                                                              tiny_lm):
    env = {"RAFIKI_GEN_MAX_SLOTS": "2"}
    runs = [_serve(monkeypatch, tiny_lm, [[2, 3, 4]], 12, f"s{seed}{i}",
                   env, {"temperature": 1.0, "seed": seed})[0][0]
            for seed in (1, 2) for i in range(2)]
    assert runs[0] == runs[1] and runs[2] == runs[3]
    assert runs[0] != runs[2]


def test_chunked_prefill_interleaves_with_decode(monkeypatch, tiny_lm):
    events = []
    op, od = tiny_lm.paged_prefill, tiny_lm.paged_decode_step

    def spy_p(cache, bt, ids, start):
        events.append(("prefill", int(start)))
        return op(cache, bt, ids, start)

    def spy_d(cache, ids, pos, bts):
        events.append(("decode", None))
        return od(cache, ids, pos, bts)

    monkeypatch.setattr(tiny_lm, "paged_prefill", spy_p)
    monkeypatch.setattr(tiny_lm, "paged_decode_step", spy_d)
    for k, v in {"RAFIKI_GEN_MAX_SLOTS": "2", "RAFIKI_GEN_KV_BLOCK_TOKENS":
                 "8", "RAFIKI_GEN_KV_PAGED": "1", "RAFIKI_GEN_PREFIX_CACHE":
                 "0", "RAFIKI_GEN_PREFILL_CHUNK": "8"}.items():
        monkeypatch.setenv(k, v)
    broker = InProcessBroker()
    _, ctx, t = _start_worker(broker, tiny_lm, job="joinjob")
    try:
        resident = _stream(broker, "joinjob", {"prompt_ids": [5, 6, 7],
                                               "max_tokens": 48})
        resident.next_delta(10)
        join = _stream(broker, "joinjob", {"prompt_ids": list(range(1, 57)),
                                           "max_tokens": 4})
        assert len(_drain(join)[0]) == 4
        resident.cancel()
        starts = [i for i, e in enumerate(events)
                  if e[0] == "prefill" and e[1] > 0]
        assert len(starts) >= 3
        interleaved = sum(
            1 for a, b in zip(starts, starts[1:])
            if any(events[i][0] == "decode" for i in range(a + 1, b)))
        assert interleaved >= len(starts) - 2, events
    finally:
        _stop(ctx, t)


# -- the door ---------------------------------------------------------------------

def _post_stream(port, body, headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
        method="POST")
    with urllib.request.urlopen(req, timeout=30) as resp:
        return resp.headers["Content-Type"], resp.read()


def _frames(raw):
    out = []
    while len(raw) >= 4:
        n = int.from_bytes(raw[:4], "little")
        out.append(wire.decode_token_delta(raw[4:4 + n])[1].to_json())
        raw = raw[4 + n:]
    return out


def test_door_json_and_wire_streams_and_the_stall_error(monkeypatch):
    monkeypatch.setenv("RAFIKI_GEN_MAX_SLOTS", "2")
    monkeypatch.setenv("RAFIKI_GEN_STREAM_TIMEOUT_S", "0.5")
    stall = threading.Event()

    class _Stalling(_Scripted):
        def decode_step(self, cache, ids, positions):
            if stall.is_set() and (np.asarray(ids) > 52).any():
                time.sleep(1.5)  # past the door's stall window
            return np.asarray(ids) + 1, cache

    broker = InProcessBroker()
    _, ctx, t = _start_worker(broker, _Stalling(), job="doorjob")
    server = PredictorServer(Predictor("doorjob", broker, None), "doorapp",
                             auth=False).start()
    try:
        ctype, raw = _post_stream(server.port, {"prompt_ids": [5],
                                                "max_tokens": 4})
        assert ctype.startswith("application/x-ndjson")
        lines = [json.loads(x) for x in raw.splitlines() if x]
        assert [t for d in lines for t in d["tokens"]] == [6, 7, 8, 9]
        assert lines[-1]["finished"] and lines[-1]["reason"] == "max_tokens"
        ctype, raw = _post_stream(server.port,
                                  {"prompt_ids": [5], "max_tokens": 4},
                                  {"Accept": wire.CONTENT_TYPE})
        assert ctype.startswith(wire.CONTENT_TYPE)
        assert _frames(raw) == lines
        stall.set()
        _, raw = _post_stream(server.port, {"prompt_ids": [50],
                                            "max_tokens": 20})
        last = json.loads(raw.splitlines()[-1])
        assert last["finished"] and "stalled" in last["error"]
        # Client.generate yields the tokens before the fault, then raises
        # it typed (the wire frames here)
        c = Client("127.0.0.1", 1)
        c._dedicated_door = lambda app, version: (
            "127.0.0.1", server.port, float("inf"))
        got = []
        with pytest.raises(GenerationStreamError, match="stalled"):
            for d in c.generate("doorapp", [50], max_tokens=20, binary=True):
                got += d["tokens"]
        assert got[:3] == [51, 52, 53]
        # a malformed request is a 400 before any stream
        with pytest.raises(urllib.error.HTTPError) as err:
            _post_stream(server.port, {"prompt_ids": []})
        assert err.value.code == 400
    finally:
        server.stop()
        _stop(ctx, t)


def test_door_auth(monkeypatch):
    """Both POST routes of the per-job door take the admin's tokens."""
    from rafiki_tpu_torch.utils.auth import generate_token

    monkeypatch.setenv("RAFIKI_GEN_MAX_SLOTS", "1")
    broker = InProcessBroker()
    _, ctx, t = _start_worker(broker, _Scripted(), job="authjob")
    server = PredictorServer(Predictor("authjob", broker, None),
                             "authapp").start()
    try:
        for path in ("/generate", "/predict"):
            req = urllib.request.Request(
                f"http://127.0.0.1:{server.port}{path}",
                data=json.dumps({"prompt_ids": [1]}).encode(),
                headers={"Content-Type": "application/json"}, method="POST")
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(req, timeout=30)
            assert err.value.code == 401
        token = generate_token({"user_id": "u", "user_type": "APP_DEVELOPER"})
        _, raw = _post_stream(server.port, {"prompt_ids": [1],
                                            "max_tokens": 2},
                              {"Authorization": f"Bearer {token}"})
        assert [json.loads(x)["tokens"] for x in raw.splitlines()] == [
            [2], [3]]
    finally:
        server.stop()
        _stop(ctx, t)


# -- the cycle through Client -----------------------------------------------------

def _jax_tiny_gen_lm():
    spec = importlib.util.spec_from_file_location(
        "jax_gen_model", os.path.join(HERE, "fixtures", "gen_model.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.TinyGenLM


def test_client_cycle_streams_equal_jax_on_the_same_weights(monkeypatch,
                                                            tmp_path):
    monkeypatch.setenv("RAFIKI_PREDICTOR_PORTS", "1")
    with open(TEMPLATE, "rb") as f:
        source = f.read()
    admin = Admin(db=Database(":memory:"),
                  placement=LocalPlacementManager(ChipAllocator(["cpu"])),
                  params_dir=str(tmp_path))
    server = AdminServer(admin, port=0).start()
    try:
        c = Client("127.0.0.1", server.port, timeout_s=120)
        c.login(config.SUPERADMIN_EMAIL, config.SUPERADMIN_PASSWORD)
        # a generative template belongs to TEXT_GENERATION only
        with pytest.raises(RafikiError) as err:
            c.create_model("gen0", "TEXT_CLASSIFICATION", source, "TorchGenLM")
        assert err.value.status == 400
        c.create_model("gen", "TEXT_GENERATION", source, "TorchGenLM")
        c.create_train_job("g", "TEXT_GENERATION", "u://t", "u://e",
                           budget={"MODEL_TRIAL_COUNT": 2})
        assert c.wait_until_train_job_stopped("g", timeout_s=120)[
            "status"] == "STOPPED"
        trials = c.get_trials_of_train_job("g")
        assert [t["status"] for t in trials] == ["COMPLETED"] * 2
        # GEN_DRAFT_TRIAL is validated at deploy: an unknown trial is a
        # typed deploy error, which the admin door answers 500, as the JAX
        # package's does
        with pytest.raises(RafikiError) as err:
            c.create_inference_job("g", budget={"GEN_DRAFT_TRIAL": "t404"})
        assert err.value.status == 500
        inf = c.create_inference_job("g")
        assert inf["status"] == "RUNNING" and len(inf["workers"]) == 1
        assert inf["predictor_host"] and inf["predictor_port"]
        best = max(trials, key=lambda t: t["score"])
        assert inf["workers"][0]["trial_id"] == best["id"]
        prompts = [[2, 3, 4], [5, 6, 7, 8, 9], [2, 3, 4, 11]]
        results = {}

        def run(i, prompt, binary):
            results[i, binary] = [t for d in c.generate(
                "g", prompt, max_tokens=8, binary=binary)
                for t in d["tokens"]]

        threads = [threading.Thread(target=run, args=(i, p, b))
                   for i, p in enumerate(prompts) for b in (False, True)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
        assert not any(th.is_alive() for th in threads)
        # JAX's TinyGenLM on the trained weights, greedy
        jax_model = _jax_tiny_gen_lm()(**best["knobs"])
        jax_model.load_parameters(load_params(
            c.download_trial_params(best["id"])))
        want = jax_model.predict(prompts)
        for i in range(len(prompts)):
            assert results[i, False] == results[i, True]
            assert results[i, False][:8] == want[i]
        sampled = [[t for d in c.generate("g", [2, 3, 4], max_tokens=8,
                                          temperature=0.8, top_p=0.95,
                                          seed=5) for t in d["tokens"]]
                   for _ in range(2)]
        assert sampled[0] == sampled[1] and len(sampled[0]) == 8
        with pytest.raises(RafikiError) as err:
            list(c.generate("g", [], max_tokens=2))
        assert err.value.status == 400
        stats = c.get_inference_job_stats("g")["workers"][0]
        assert stats["gen_tokens"] >= 8 * 8 and stats["gen_prefix_hits"] >= 1
        c.stop_inference_job("g")
        with pytest.raises(RafikiError):
            list(c.generate("g", [2, 3], max_tokens=2))
    finally:
        server.stop()
        admin.shutdown()


def test_generation_under_process_placement_is_refused_typed(tmp_path):
    """Token streams do not cross the shm rings: the deploy refuses."""
    from rafiki_tpu_torch.admin.services import ServiceDeploymentError
    from rafiki_tpu_torch.placement.process import ProcessPlacementManager

    admin = Admin(db=Database(":memory:"),
                  placement=LocalPlacementManager(ChipAllocator(["cpu"])),
                  params_dir=str(tmp_path))
    try:
        uid = admin.authenticate_user(config.SUPERADMIN_EMAIL,
                                      config.SUPERADMIN_PASSWORD)["user_id"]
        with open(TEMPLATE, "rb") as f:
            admin.create_model(uid, "gen", "TEXT_GENERATION", f.read(),
                               "TorchGenLM")
        admin.create_train_job(uid, "g", "TEXT_GENERATION", "t", "e",
                               budget={"MODEL_TRIAL_COUNT": 1})
        admin.wait_until_train_job_stopped(uid, "g", timeout_s=120)
        admin.services._placement = ProcessPlacementManager(
            allocator=ChipAllocator(["cpu"]))
        with pytest.raises(ServiceDeploymentError, match="not ported"):
            admin.create_inference_job(uid, "g")
        # a draft trial does not lift the refusal
        (trial,) = admin.get_trials_of_train_job(uid, "g")
        with pytest.raises(ServiceDeploymentError, match="not ported"):
            admin.create_inference_job(
                uid, "g", budget={"GEN_DRAFT_TRIAL": trial["id"]})
    finally:
        admin.shutdown()


def _streams(predictor, prompts, max_tokens=8):
    out = []
    for prompt in prompts:
        stream = predictor.generate({"prompt_ids": prompt,
                                     "max_tokens": max_tokens})
        toks = []
        while True:
            delta = stream.next_delta(timeout=60)
            toks += list(delta.tokens)
            if delta.finished:
                break
        out.append(toks)
    return out


def test_a_generation_job_on_a_two_card_grant_matches_jax(tmp_path):
    """``CHIPS_PER_WORKER=2`` on a TEXT_GENERATION job, on a host of four
    devices: the same replica count and grants as the JAX admin (2
    replicas of 2), and on the same weights (JAX's ``TinyGenLM`` trained
    by the JAX admin, carried into the port's trial) the same greedy
    streams."""
    from rafiki_tpu.admin.admin import Admin as JaxAdmin
    from rafiki_tpu.db.database import Database as JaxDatabase
    from rafiki_tpu.placement import manager as jmanager
    from rafiki_tpu.sdk.params import load_params as jax_load_params
    from rafiki_tpu_torch.sdk.artifact import write_artifact
    from rafiki_tpu_torch.sdk.params import dump_params

    budget = {"CHIPS_PER_WORKER": 2}
    prompts = [[2, 3, 4], [5, 6, 7, 8, 9]]
    jadmin = JaxAdmin(
        db=JaxDatabase(":memory:"),
        placement=jmanager.LocalPlacementManager(
            jmanager.ChipAllocator([0, 1, 2, 3])),
        params_dir=str(tmp_path / "jax"), recover=False)
    try:
        juid = jadmin.authenticate_user(
            config.SUPERADMIN_EMAIL, config.SUPERADMIN_PASSWORD)["user_id"]
        with open(os.path.join(HERE, "fixtures", "gen_model.py"), "rb") as f:
            jadmin.create_model(juid, "gen", "TEXT_GENERATION", f.read(),
                                "TinyGenLM")
        jadmin.create_train_job(juid, "g", "TEXT_GENERATION", "t", "e",
                                budget={"MODEL_TRIAL_COUNT": 1})
        jadmin.wait_until_train_job_stopped(juid, "g", timeout_s=120)
        jinf = jadmin.create_inference_job(juid, "g", budget=budget)
        (jtrial,) = jadmin.get_trials_of_train_job(juid, "g")
        tree = jax_load_params(jadmin.get_trial_params(jtrial["id"]))
        want = _streams(jadmin.services.get_predictor(jinf["id"]), prompts)
    finally:
        jadmin.shutdown()
    admin = Admin(db=Database(":memory:"),
                  placement=LocalPlacementManager(
                      ChipAllocator([f"cpu:{i}" for i in range(4)])),
                  params_dir=str(tmp_path / "torch"))
    try:
        uid = admin.authenticate_user(
            config.SUPERADMIN_EMAIL, config.SUPERADMIN_PASSWORD)["user_id"]
        with open(TEMPLATE, "rb") as f:
            admin.create_model(uid, "gen", "TEXT_GENERATION", f.read(),
                               "TorchGenLM")
        admin.create_train_job(uid, "g", "TEXT_GENERATION", "t", "e",
                               budget={"MODEL_TRIAL_COUNT": 1})
        admin.wait_until_train_job_stopped(uid, "g", timeout_s=120)
        (trial,) = admin.db.get_trials_of_train_job(
            admin.db.get_train_job_by_app_version(uid, "g", -1)["id"])
        write_artifact(trial["params_file_path"], dump_params(tree))
        inf = admin.create_inference_job(uid, "g", budget=budget)
        got = _streams(admin.services.get_predictor(inf["id"]), prompts)
    finally:
        admin.shutdown()
    assert len(inf["workers"]) == len(jinf["workers"]) == 2
    assert sorted([int(str(c).split(":")[1]) for c in w["chips"]]
                  for w in inf["workers"]) == sorted(
        w["chips"] for w in jinf["workers"])
    assert got == want
    assert all(len(t) == 8 for t in got)
