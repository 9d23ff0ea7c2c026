"""Stream continuity in the port, held against the JAX package.

The drills of ``tests/test_stream_continuity.py``, each run through both
packages' ``Predictor`` and ``GenerationWorker`` on an in-process broker
with the same scripted sampled model (the counterpart of its
``_SampledScripted``: the token drawn at position p is
``last + 1 + (seed + p) % 3``, a function of the seed and the position as
the keyed draws of a real LM are, so "token-identical" is an exact
check):

- a ``site=worker`` ``drop`` kill of a replica under three sampled
  streams: every stream finishes with its uncontended tokens;
- a clean retirement: the replica hands its stream back ``migrating``
  and the door resumes it on the sibling;
- ``RAFIKI_GEN_RESUME_MAX=0``: the death is a typed error naming it;
- a stream whose version no sibling serves: ``CrossVersionResumeError``;
- the journal's byte cap ends resume, not streaming.

After each drill ``gen_continuity_stats()`` equals the JAX predictor's,
key for key and count for count.
"""

import threading
import time

import numpy as np
import pytest

from rafiki_tpu.cache import queue as jax_queue
from rafiki_tpu.predictor import predictor as jax_predictor
from rafiki_tpu.sdk import BaseModel as JaxBaseModel
from rafiki_tpu.sdk import GenerationSpec as JaxGenerationSpec
from rafiki_tpu.utils import chaos as jax_chaos
from rafiki_tpu.worker import generation as jax_generation
from rafiki_tpu_torch.cache import queue
from rafiki_tpu_torch.predictor import predictor
from rafiki_tpu_torch.sdk.model import BaseModel, GenerationSpec
from rafiki_tpu_torch.utils import chaos
from rafiki_tpu_torch.worker import generation

PACKAGES = {
    "jax": dict(queue=jax_queue, predictor=jax_predictor, chaos=jax_chaos,
                generation=jax_generation, base=JaxBaseModel,
                spec=JaxGenerationSpec),
    "torch": dict(queue=queue, predictor=predictor, chaos=chaos,
                  generation=generation, base=BaseModel,
                  spec=GenerationSpec),
}


@pytest.fixture(autouse=True)
def _clean_chaos():
    for pkg in PACKAGES.values():
        pkg["chaos"].clear()
    yield
    for pkg in PACKAGES.values():
        pkg["chaos"].clear()


def _scripted(pkg, delay_s=0.02):
    """The scripted sampled model on ``pkg``'s ``BaseModel``: a round
    takes ``delay_s``, so a death lands mid-stream."""

    class SampledScripted(pkg["base"]):
        generation_spec = pkg["spec"](eos_token_id=0, max_context=100000)

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

        def init_kv_cache(self, max_slots):
            return {"slots": max_slots}

        def prefill(self, cache, slot, prompt_ids):
            return prompt_ids[-1] + 1, cache

        def decode_step(self, cache, ids, positions):
            return np.asarray(ids) + 1, cache

        def decode_step_sampled(self, cache, ids, positions, sampling):
            time.sleep(delay_s)
            ids = np.asarray(ids, np.int64)
            pos = np.asarray(positions, np.int64)
            seed = np.asarray(sampling["seed"], np.int64)
            return ids + 1 + (seed + pos) % 3, None, cache

    return SampledScripted()


def _expected(prompt, seed, n):
    """The uncontended continuation: draw i at position len(prompt)-1+i
    (a sampled stream re-draws its last prompt position)."""
    toks, last, pos = [], prompt[-1], len(prompt) - 1
    for _ in range(n):
        last = last + 1 + (seed + pos) % 3
        pos += 1
        toks.append(last)
    return toks


class _Ctx:
    def __init__(self, service_id):
        self.service_id = service_id
        self.chips = ["cpu"]
        self.stopping = False

    def ready(self):
        pass


class _Fleet:
    """Replicas of the scripted model on one in-process broker of
    ``pkg``, and the job's predictor."""

    def __init__(self, pkg, job, sids, delay_s=0.02):
        self.pkg, self.job = pkg, job
        self.broker = pkg["queue"].InProcessBroker()
        self.ctxs, self.threads = {}, []
        for sid in sids:
            worker = pkg["generation"].GenerationWorker(
                job, f"trial-{sid}", db=None, broker=self.broker)
            model = _scripted(pkg, delay_s)
            worker._load_model = lambda *_, m=model: m
            ctx = self.ctxs[sid] = _Ctx(sid)
            t = threading.Thread(target=worker.start, args=(ctx,),
                                 daemon=True)
            t.start()
            self.threads.append(t)
            deadline = time.monotonic() + 10
            while sid not in self.broker.get_worker_queues(job):
                assert time.monotonic() < deadline, "worker never registered"
                time.sleep(0.01)
        self.predictor = pkg["predictor"].Predictor(job, self.broker,
                                                    task=None)

    def generate(self, prompt, seed, max_tokens):
        return self.predictor.generate(
            {"prompt_ids": prompt, "max_tokens": max_tokens,
             "temperature": 0.8, "seed": seed}, timeout_s=60.0)

    def drill(self, rule):
        chaos_mod = self.pkg["chaos"]
        chaos_mod.install(chaos_mod.parse_rules(rule))

    def close(self):
        self.pkg["chaos"].clear()
        for sid, ctx in self.ctxs.items():
            ctx.stopping = True
            self.broker.unregister_worker(self.job, sid)
        for t in self.threads:
            t.join(timeout=10)


def _pump(stream, into, timeout_s=30.0):
    """Drain a resumable stream to its terminal delta; a TimeoutError is
    the door's stall window passing while a resume is under way."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            d = stream.next_delta(timeout=0.5)
        except TimeoutError:
            continue
        except StopIteration:
            return None
        into.extend(d.tokens)
        if d.finished:
            return d.reason
    raise AssertionError(f"stream never finished ({len(into)} tokens)")


def _read(stream, got, n):
    while len(got) < n:
        d = stream.next_delta(timeout=5.0)
        got.extend(d.tokens)
        assert not d.finished


def _both(monkeypatch, drill, env):
    """``drill(pkg)`` under ``env`` for each package: {name: result}."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    return {name: drill(pkg) for name, pkg in PACKAGES.items()}


def _kill_drill(pkg):
    fleet = _Fleet(pkg, "contkill", ["w1", "w2"])
    try:
        streams = []
        for i in range(3):
            prompt, seed = [1000 + 97 * i, 1001 + 97 * i], 7 + i
            streams.append((prompt, seed, fleet.generate(prompt, seed, 30),
                            []))
        for _, _, s, got in streams:
            _read(s, got, 3)
        holders = [s._entry.worker_id for _, _, s, _ in streams]
        victim = holders[0]
        fleet.drill(f"site=worker;action=drop;match=contkill/{victim};"
                    "times=1")
        out = []
        for prompt, seed, s, got in streams:
            assert _pump(s, got) == "max_tokens"
            assert got == _expected(prompt, seed, 30), seed
            out.append(got)
        assert victim not in fleet.broker.get_worker_queues("contkill")
        return out, holders, fleet.predictor.gen_continuity_stats()
    finally:
        fleet.close()


def test_a_killed_replica_s_sampled_streams_resume_token_identical(
        monkeypatch):
    runs = _both(monkeypatch, _kill_drill,
                 {"RAFIKI_GEN_MAX_SLOTS": "4",
                  "RAFIKI_GEN_RESUME_BACKOFF_S": "0.01"})
    assert runs["torch"] == runs["jax"]
    _, holders, stats = runs["torch"]
    assert holders == ["w1", "w2", "w1"]
    assert stats["resumes_worker_death"] == 2  # the streams w1 held
    assert stats["resume_failures"] == stats["cross_version_refusals"] == 0
    assert stats["journal_streams"] == stats["journal_bytes"] == 0


def _retire_drill(pkg):
    fleet = _Fleet(pkg, "contdrain", ["w1", "w2"])
    try:
        prompt, seed = [2000, 2001], 13
        s = fleet.generate(prompt, seed, 30)
        got = []
        _read(s, got, 3)
        fleet.ctxs[s._entry.worker_id].stopping = True  # the retirement
        assert _pump(s, got) == "max_tokens"
        assert got == _expected(prompt, seed, 30)
        return got, fleet.predictor.gen_continuity_stats()
    finally:
        fleet.close()


def test_a_retiring_replica_hands_its_stream_back_migrating(monkeypatch):
    runs = _both(monkeypatch, _retire_drill,
                 {"RAFIKI_GEN_MAX_SLOTS": "4",
                  "RAFIKI_GEN_RESUME_BACKOFF_S": "0.01"})
    assert runs["torch"] == runs["jax"]
    stats = runs["torch"][1]
    assert stats["resumes_migrating"] == 1 and stats["resume_failures"] == 0


def _fail_drill(pkg, bump_version, error, match):
    fleet = _Fleet(pkg, "contfail", ["w1", "w2"])
    try:
        s = fleet.generate([3000, 3001], 3, 40)
        assert s.next_delta(timeout=5.0).tokens
        if bump_version:
            # the fleet moved to a new serving version mid-stream
            with fleet.predictor._route_lock:
                fleet.predictor._serving_version += 1
        fleet.drill(f"site=worker;action=drop;match=contfail/"
                    f"{s._entry.worker_id};times=1")
        with pytest.raises(error(pkg), match=match):
            deadline = time.monotonic() + 20
            while time.monotonic() < deadline:
                try:
                    d = s.next_delta(timeout=0.5)
                except TimeoutError:
                    continue
                assert not d.finished, "the stream must not finish clean"
        return fleet.predictor.gen_continuity_stats()
    finally:
        fleet.close()


def test_resume_disabled_is_a_typed_error(monkeypatch):
    runs = _both(monkeypatch, lambda pkg: _fail_drill(
        pkg, False, lambda p: p["queue"].GenerationError,
        "RAFIKI_GEN_RESUME_MAX"),
        {"RAFIKI_GEN_MAX_SLOTS": "2", "RAFIKI_GEN_RESUME_MAX": "0"})
    assert runs["torch"] == runs["jax"]
    assert runs["torch"]["resume_failures"] == 1


def test_a_cross_version_resume_is_refused_typed(monkeypatch):
    runs = _both(monkeypatch, lambda pkg: _fail_drill(
        pkg, True, lambda p: p["predictor"].CrossVersionResumeError,
        "model_version"),
        {"RAFIKI_GEN_MAX_SLOTS": "2", "RAFIKI_GEN_RESUME_BACKOFF_S": "0.01"})
    assert runs["torch"] == runs["jax"]
    stats = runs["torch"]
    assert stats["cross_version_refusals"] == 1
    assert stats["resume_failures"] == 1


def _cap_drill(pkg):
    fleet = _Fleet(pkg, "contcap", ["w1"], delay_s=0.0)
    try:
        got = []
        s = fleet.generate([5000, 5001], 5, 200)
        assert _pump(s, got, timeout_s=60) == "max_tokens"
        assert got == _expected([5000, 5001], 5, 200)
        return fleet.predictor.gen_continuity_stats()
    finally:
        fleet.close()


def test_the_journal_cap_ends_resume_not_streaming(monkeypatch):
    """8 B a token, 96 B a record: a 1 KB cap overflows after ~115
    tokens, and the stream streams on to its 200."""
    runs = _both(monkeypatch, _cap_drill,
                 {"RAFIKI_GEN_MAX_SLOTS": "2", "RAFIKI_GEN_MAX_TOKENS": "200",
                  "RAFIKI_GEN_JOURNAL_MAX_KB": "1"})
    assert runs["torch"] == runs["jax"]
    stats = runs["torch"]
    assert stats["journal_overflows"] == 1
    assert stats["journal_bytes"] == stats["journal_streams"] == 0


def test_a_sampled_request_without_a_seed_gets_one_at_the_door(monkeypatch):
    """The door pins the seed before the first submit (a seed the worker
    chose would die with it), and the journal's books match JAX's while
    the stream is live."""
    monkeypatch.setenv("RAFIKI_GEN_MAX_SLOTS", "2")
    books = {}
    for name, pkg in PACKAGES.items():
        fleet = _Fleet(pkg, "contseed", ["w1"])
        try:
            s = fleet.predictor.generate(
                {"prompt_ids": [7000, 7001], "max_tokens": 8,
                 "temperature": 0.5}, timeout_s=30.0)
            seed = s._entry.query["seed"]
            assert isinstance(seed, int) and 0 <= seed < 2 ** 31
            live = fleet.predictor.gen_continuity_stats()
            got = []
            assert _pump(s, got) == "max_tokens"
            assert got == _expected([7000, 7001], seed, 8)
            books[name] = (live, fleet.predictor.gen_continuity_stats())
        finally:
            fleet.close()
    assert books["torch"] == books["jax"]
    live, done = books["torch"]
    assert live["journal_streams"] == 1 and live["journal_bytes"] == 112
    assert done["journal_streams"] == done["journal_bytes"] == 0
