"""Speculative decoding in the port, held against the JAX package.

- ``models/lm.py``: ``paged_verify_step`` against
  ``rafiki_tpu.models.lm.paged_verify_step`` on the same weights (``lm``
  ``tiny``, carried by ``convert``) and the same prefilled pool, S = 4
  slots at k = 4: a batch mixing one greedy row with rows sampled under
  top-k and top-p, and an all-greedy batch (the fast path). Accept
  lengths and tokens equal exactly; the pools' written rows within
  ``ROW_RTOL`` relative. The verify at temperature 0 equals the port's
  own chained greedy decode; ``decode_steps_sampled`` equals its chained
  ``decode_step_sampled`` and JAX's burst (tokens exactly, distributions
  within ``PROB_ATOL``).
- The worker (``worker/generation.py`` ``_spec_round``): a CPU-trained
  ``TorchGenLM`` target and a half-width draft (the JAX fixture's
  ``TinyGenLM`` and ``TinyDraftLM`` given the same weights): greedy
  speculative streams equal plain greedy; sampled speculative streams
  equal JAX's ``GenerationWorker``'s token for token at the same seeds
  and k; a draft fault degrades typed, the streams finish and the stats
  row has JAX's keys.
- ``GEN_DRAFT_TRIAL`` at deploy: the four typed errors, each beside the
  JAX admin's message for the same case.
"""

import importlib.util
import os
import re
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rafiki_tpu.cache.queue import InProcessBroker as JaxBroker
from rafiki_tpu.models import lm as jlm
from rafiki_tpu.utils import chaos as jax_chaos
from rafiki_tpu.worker.generation import GenerationWorker as JaxWorker
from rafiki_tpu_torch import convert
from rafiki_tpu_torch.cache.queue import InProcessBroker
from rafiki_tpu_torch.device import set_device_grant
from rafiki_tpu_torch.models import lm
from rafiki_tpu_torch.sdk.knob import FixedKnob, FloatKnob
from rafiki_tpu_torch.sdk.model import (
    GENERATION_SPEC_METHODS,
    draft_capability,
    sampling_capability,
    spec_verify_capability,
)
from rafiki_tpu_torch.templates.torch_gen_lm import TorchGenLM
from rafiki_tpu_torch.utils import chaos
from rafiki_tpu_torch.worker.generation import GenerationWorker
from rafiki_tpu_torch.worker.inference import serving_stats

HERE = os.path.dirname(__file__)
ROW_RTOL = 1e-5
PROB_ATOL = 1e-6
VOCAB, MAX_LEN, DIM, DEPTH, HEADS = 64, 32, 32, 2, 2
S, K, BT, NBPOOL = 4, 4, 4, 24


def _cfgs(dim=DIM):
    args = dict(vocab=VOCAB, max_len=MAX_LEN, dim=dim, depth=DEPTH,
                heads=HEADS)
    return lm.tiny(**args), jlm.tiny(**args)


def _pair(seed, dim=DIM):
    """(port config, JAX config, the port's module, JAX's parameters) of
    one seeded tree."""
    cfg, jcfg = _cfgs(dim)
    tree = lm.init(np.random.default_rng(seed), cfg)
    return (cfg, jcfg, convert.from_jax_params(tree, cfg, "cpu"),
            jax.tree.map(jnp.asarray, tree))


def _sampling(temps, role, seeds=(11, 22, 33, 44)):
    n = len(temps)
    return {"seed": np.asarray(seeds[:n], np.uint32),
            "temperature": np.asarray(temps, np.float32),
            "top_k": np.asarray([0, 8, 0, 5][:n], np.int32),
            "top_p": np.asarray([1.0, 0.95, 0.9, 1.0][:n], np.float32),
            "role": role}


# -- the verify step and the burst ----------------------------------------------

def _prefilled(target, jtarget):
    """Both packages' pools with each slot's prompt prefilled, the
    prompts, the tables and each slot's first greedy token."""
    cfg, jcfg, model, jp = target
    tables = np.full((S, 8), NBPOOL, np.int32)
    tables[:, :6] = np.arange(S * 6, dtype=np.int32).reshape(S, 6)
    rng = np.random.default_rng(7)
    tc = lm.init_paged_kv_cache(cfg, NBPOOL, BT)
    jc = jlm.init_paged_kv_cache(jcfg, NBPOOL, BT)
    prompts, first = [], []
    for i in range(S):
        n = 5 + i
        padded = np.zeros(16, np.int32)
        padded[:n] = rng.integers(0, VOCAB, n)
        logits, tc = lm.paged_prefill(model, tc, tables[i], padded, 0, n)
        _, jc = jlm.paged_prefill(jp, jc, jnp.asarray(tables[i]),
                                  jnp.asarray(padded), 0, n, jcfg)
        prompts.append(padded[:n].tolist())
        first.append(int(logits.argmax()))
    return tc, jc, prompts, tables, np.asarray(first, np.int32)


def _ring(model, cfg, prompts):
    cache = lm.init_kv_cache(cfg, S, MAX_LEN)
    for i, p in enumerate(prompts):
        padded = np.zeros(16, np.int32)
        padded[:len(p)] = p
        _, cache = lm.prefill(model, cache, i, padded, len(p))
    return cache


@pytest.fixture(scope="module")
def target():
    return _pair(0)


@pytest.mark.parametrize("batch", ["mixed", "greedy"])
def test_paged_verify_matches_jax(target, batch):
    """Row 0 greedy, its proposals the target's own greedy chain (all
    accepted, then the bonus); row 1 sampled with the target as its own
    draft (q = p: accepted, the bonus draw); rows 2-3 sampled with a
    half-width random draft (rejections and residual draws)."""
    cfg, jcfg, model, jp = target
    tc, jc, prompts, tables, first = _prefilled(target, None)
    n = np.asarray([len(p) for p in prompts], np.int32)
    temps = [0.0, 0.8, 1.0, 0.7] if batch == "mixed" else [0.0] * S
    dsamp = _sampling(temps, lm.ROLE_DRAFT)
    own_ids, own_q, _ = lm.decode_steps_sampled(
        model, _ring(model, cfg, prompts), first, n, K, dsamp)
    dcfg, _, dmodel, _ = _pair(5, dim=16)
    small_ids, small_q, _ = lm.decode_steps_sampled(
        dmodel, _ring(dmodel, dcfg, prompts), first, n, K, dsamp)
    pick = np.asarray([True, True, False, False])
    d_ids = np.where(pick[:, None], own_ids.numpy(), small_ids.numpy())
    q = np.where(pick[:, None, None], own_q.numpy(), small_q.numpy())
    ids = np.concatenate([first[:, None], d_ids], 1).astype(np.int32)
    pos = (n[:, None] + np.arange(K + 1)).astype(np.int32)
    vsamp = _sampling(temps, lm.ROLE_TARGET)
    ja, jt, jc = jlm.paged_verify_step(
        jp, jc, jnp.asarray(ids), jnp.asarray(pos), jnp.asarray(tables),
        jnp.asarray(q), vsamp, jcfg)
    ta, tt, tc = lm.paged_verify_step(model, tc, ids, pos, tables,
                                      torch.from_numpy(q), vsamp)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    acc = ta.numpy()
    assert acc[0] == K and acc[1] == K, acc  # a perfect draft: the bonus
    if batch == "mixed":
        assert acc[2:].min() < K  # the random draft is rejected somewhere
    # past accept_len + 1 the tokens are 0
    for i in range(S):
        assert (tt.numpy()[i, acc[i] + 1:] == 0).all()
    # the k+1 rows written, within ROW_RTOL of JAX's
    for key in ("k", "v"):
        jpool = np.asarray(jc[key])
        for i in range(S):
            for p in pos[i]:
                blk, off = tables[i, p // BT], p % BT
                np.testing.assert_allclose(
                    tc[key][:, blk, off].numpy(), jpool[:, blk, off],
                    rtol=ROW_RTOL, atol=ROW_RTOL)


def test_verify_at_temperature_zero_equals_chained_greedy_decode(target):
    """A perfect draft commits k+1 greedy tokens in one forward; a draft
    wrong at j=1 commits the greedy prefix and the argmax correction."""
    cfg, _, model, _ = target
    prompt = np.asarray([5, 9, 2, 7, 3, 0, 0, 0], np.int32)
    n, table = 5, np.asarray([[0, 1, 2, NBPOOL, NBPOOL, NBPOOL, NBPOOL,
                               NBPOOL]], np.int32)
    pool = lm.init_paged_kv_cache(cfg, NBPOOL, BT)
    logits, pool = lm.paged_prefill(model, pool, table[0], prompt, 0, n)
    g = [int(logits.argmax())]
    ref = {k: v.clone() for k, v in pool.items()}
    for j in range(K + 1):
        logits, ref = lm.paged_decode_step(model, ref, [g[-1]], [n + j],
                                           table)
        g.append(int(logits[0].argmax()))
    greedy = _sampling([0.0], lm.ROLE_TARGET)
    q = torch.full((1, K, VOCAB), 1.0 / VOCAB)
    pos = (n + np.arange(K + 1))[None]
    acc, toks, _ = lm.paged_verify_step(
        model, {k: v.clone() for k, v in pool.items()},
        np.asarray([g[:K + 1]]), pos, table, q, greedy)
    assert int(acc[0]) == K and toks[0].tolist() == g[1:K + 2]
    bad = [g[0], g[1], (g[2] + 1) % VOCAB, 0, 0]
    acc, toks, _ = lm.paged_verify_step(
        model, {k: v.clone() for k, v in pool.items()}, np.asarray([bad]),
        pos, table, q, greedy)
    assert int(acc[0]) == 1 and toks[0].tolist() == [g[1], g[2], 0, 0, 0]


@pytest.mark.parametrize("temp", [0.0, 0.8])
def test_burst_equals_chained_steps_and_jax(target, temp):
    cfg, jcfg, model, jp = target
    prompts = [[3, 8, 1, 9, 6], [4, 4, 2, 7, 1]]
    pos = np.full(2, 5, np.int32)
    ids = np.asarray([12, 40], np.int32)
    samp = _sampling([temp, temp], lm.ROLE_DRAFT)
    samp = {k: (v[:2] if isinstance(v, np.ndarray) else v)
            for k, v in samp.items()}

    def ring():
        cache = lm.init_kv_cache(cfg, 2, MAX_LEN)
        for i, p in enumerate(prompts):
            _, cache = lm.prefill(model, cache, i, np.asarray(p + [0] * 3),
                                  5)
        return cache

    toks, q, burst_cache = lm.decode_steps_sampled(model, ring(), ids, pos,
                                                   K, samp)
    chained, cur = ring(), ids
    ref_t, ref_q = [], []
    for j in range(K):
        cur, qj, chained = lm.decode_step_sampled(model, chained, cur,
                                                  pos + j, samp)
        ref_t.append(cur)
        ref_q.append(qj)
    np.testing.assert_array_equal(toks.numpy(), torch.stack(ref_t, 1))
    np.testing.assert_allclose(q.numpy(), torch.stack(ref_q, 1).numpy(),
                               atol=PROB_ATOL, rtol=0)
    for key in ("k", "v"):
        np.testing.assert_array_equal(burst_cache[key].numpy(),
                                      chained[key].numpy())
    jc = jlm.init_kv_cache(jcfg, 2, MAX_LEN)
    for i, p in enumerate(prompts):
        _, jc = jlm.prefill(jp, jc, i, jnp.asarray(p + [0] * 3), 5, jcfg)
    jt, jq, _ = jlm.decode_steps_sampled(jp, jc, jnp.asarray(ids),
                                         jnp.asarray(pos), K, samp, jcfg)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jt))
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), atol=PROB_ATOL,
                               rtol=0)


# -- the worker ---------------------------------------------------------------------

#: Adam steps on the pattern: enough for the target and its draft to
#: agree on most tokens of it, so verify rounds accept
STEPS = 60


class TorchGenLMTarget(TorchGenLM):
    """The JAX fixture's ``TinyGenLM`` (dim 16), trained longer."""

    training = (4, 32, STEPS)


class TorchGenLMDraft(TorchGenLM):
    """The half-width draft: the JAX fixture's ``TinyDraftLM``."""

    training = (4, 32, STEPS)

    @staticmethod
    def get_knob_config():
        return {"lr": FloatKnob(1e-3, 1e-1, is_exp=True),
                "dim": FixedKnob(8)}


def _jax_fixture():
    spec = importlib.util.spec_from_file_location(
        "jax_gen_model_spec", os.path.join(HERE, "fixtures", "gen_model.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def lms():
    """The port's trained target and draft, and JAX's fixtures holding
    the same weights."""
    set_device_grant(["cpu"])
    try:
        target = TorchGenLMTarget(lr=0.01, dim=16)
        target.train(None)
        draft = TorchGenLMDraft(lr=0.01, dim=8)
        draft.train(None)
    finally:
        set_device_grant(None)
    fixture = _jax_fixture()
    jtarget = fixture.TinyGenLM(dim=16)
    jtarget.load_parameters(target.dump_parameters())
    jdraft = fixture.TinyDraftLM(dim=8)
    jdraft.load_parameters(draft.dump_parameters())
    return target, draft, jtarget, jdraft


class _Ctx:
    def __init__(self, service_id):
        self.service_id = service_id
        self.chips = ["cpu"]
        self.stopping = False
        self.ready_event = threading.Event()

    def ready(self):
        self.ready_event.set()


def _serve(monkeypatch, jax_side, model, draft, prompts, max_tokens, job,
           sampling=None, seeds=None):
    """Each prompt's stream from one worker of either package, all
    submitted at once; returns the streams and the worker."""
    env = {"RAFIKI_GEN_MAX_SLOTS": "4", "RAFIKI_GEN_KV_BLOCK_TOKENS": "8",
           "RAFIKI_GEN_KV_POOL_BLOCKS": "32", "RAFIKI_GEN_KV_PAGED": "1",
           "RAFIKI_GEN_SPEC_K": str(K),
           "RAFIKI_GEN_SPEC": "1" if draft is not None else "0"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if jax_side:
        broker = JaxBroker()
        worker = JaxWorker(job, "trial1", db=None, broker=broker)
        worker._load_model = lambda sid: model
        worker._load_draft_model = lambda sid: draft
    else:
        broker = InProcessBroker()
        worker = GenerationWorker(job, "trial1", db=None, broker=broker)
        worker._load_model = lambda: model
        worker._load_draft_model = lambda: draft
    ctx = _Ctx(f"{job}-w")
    t = threading.Thread(target=worker.start, args=(ctx,), daemon=True)
    t.start()
    deadline = time.monotonic() + 60
    while not broker.get_worker_queues(job) and time.monotonic() < deadline:
        time.sleep(0.01)
    q = list(broker.get_worker_queues(job).values())[0]
    try:
        futs = []
        for i, p in enumerate(prompts):
            query = {"prompt_ids": p, "max_tokens": max_tokens,
                     **(sampling or {})}
            if seeds:
                query["seed"] = seeds[i]
            futs.append(q.submit_many(
                [query], deadline=time.monotonic() + 120)[0])
        outs = []
        for fut in futs:
            stream = fut.result(120)
            toks, reason = [], None
            while reason is None:
                d = stream.next_delta(60)
                toks += d.tokens
                if d.finished:
                    reason = d.reason
            assert reason == "max_tokens", (reason, toks)
            outs.append(toks)
        return outs, worker, ctx.service_id
    finally:
        ctx.stopping = True
        t.join(timeout=30)
        assert not t.is_alive()


#: pattern runs (token 3b + 2 mod 64), and two prompts off it
PROMPTS = [[2, 5, 8, 11], [20, 23, 26], [41, 44, 47, 50, 53], [40] * 6,
           [5, 9, 2, 7, 3]]


class _ChainedDraft(TorchGenLMDraft):
    """A draft without the fused burst: the worker chains k sampled
    steps."""

    decode_steps_sampled = None


@pytest.mark.parametrize("burst", [True, False])
def test_greedy_speculation_equals_plain_greedy(monkeypatch, lms, burst):
    target, draft, _, _ = lms
    if not burst:
        chained = _ChainedDraft(lr=0.01, dim=8)
        set_device_grant(["cpu"])
        try:
            chained.load_parameters(draft.dump_parameters())
        finally:
            set_device_grant(None)
        draft = chained
    spec, worker, _ = _serve(monkeypatch, False, target, draft, PROMPTS, 12,
                             f"sg{int(burst)}")
    assert worker._spec_on and worker._spec_degraded is None
    assert worker._spec_rounds >= 1 and worker._spec_proposed > 0
    assert worker._spec_accepted > 0
    plain, worker2, _ = _serve(monkeypatch, False, target, None, PROMPTS,
                               12, "pg")
    assert not worker2._spec_on and worker2._spec_rounds == 0
    assert spec == plain


def test_sampled_speculation_equals_jax(monkeypatch, lms):
    """Sampled speculative streams through both packages' workers: the
    same tokens at the same seeds and k, and the same spec counters."""
    target, draft, jtarget, jdraft = lms
    kw = {"temperature": 0.9, "top_k": 16, "top_p": 0.95}
    seeds = [101, 202, 303, 404, 505]
    ours, worker, _ = _serve(monkeypatch, False, target, draft, PROMPTS, 16,
                             "ss", kw, seeds)
    theirs, jworker, _ = _serve(monkeypatch, True, jtarget, jdraft, PROMPTS,
                                16, "ssj", kw, seeds)
    assert ours == theirs
    assert worker._spec_accepted > 0
    assert (worker._spec_rounds, worker._spec_proposed,
            worker._spec_accepted) == (jworker._spec_rounds,
                                       jworker._spec_proposed,
                                       jworker._spec_accepted)


def test_draft_fault_degrades_typed_and_streams_finish(monkeypatch, lms):
    """A chaos error at the draft (site=generate, the draft's target):
    speculation degrades, named in the stats row, every stream finishes
    with the plain greedy tokens, and the row has the JAX worker's keys
    after the same drill."""
    target, draft, jtarget, jdraft = lms
    rows = {}
    for mod, jax_side, model, dm in ((chaos, False, target, draft),
                                     (jax_chaos, True, jtarget, jdraft)):
        mod.install(mod.parse_rules(
            "site=generate;action=error;match=draft/"))
        try:
            outs, worker, sid = _serve(monkeypatch, jax_side, model, dm,
                                       PROMPTS[:2], 8, f"df{int(jax_side)}")
        finally:
            mod.clear()
        assert not worker._spec_on and "chaos" in worker._spec_degraded
        if jax_side:
            from rafiki_tpu.worker.inference import (
                serving_stats as jax_serving_stats,
            )

            rows["jax"] = jax_serving_stats()[sid]
        else:
            rows["torch"] = serving_stats()[sid]
            degraded = outs
    plain, _, _ = _serve(monkeypatch, False, target, None, PROMPTS[:2], 8,
                         "dfp")
    assert degraded == plain
    spec_keys = {k for k in rows["jax"] if k.startswith("gen_spec")}
    assert spec_keys == {k for k in rows["torch"]
                         if k.startswith("gen_spec")}
    assert spec_keys == {"gen_spec_on", "gen_spec_proposed",
                         "gen_spec_accepted", "gen_spec_rounds",
                         "gen_spec_degraded"}
    for row in rows.values():
        assert row["gen_spec_on"] is False
        assert "chaos" in row["gen_spec_degraded"]


def test_capabilities_of_the_templates():
    assert GENERATION_SPEC_METHODS == ("paged_verify_step",)
    assert spec_verify_capability(TorchGenLM) is not None
    assert draft_capability(TorchGenLMDraft) is not None
    assert sampling_capability(TorchGenLMDraft) is not None

    from rafiki_tpu_torch.sdk.model import BaseModel

    class NoVerify(TorchGenLM):
        paged_verify_step = BaseModel.paged_verify_step

    assert spec_verify_capability(NoVerify) is None
    assert draft_capability(NoVerify) is not None


# -- GEN_DRAFT_TRIAL at deploy ---------------------------------------------------

#: a classification template of the port (a draft that is not
#: generation-capable)
PORT_FAKE = b"""
from rafiki_tpu_torch.sdk.knob import FixedKnob
from rafiki_tpu_torch.sdk.model import BaseModel


class FakeModel(BaseModel):
    @staticmethod
    def get_knob_config():
        return {"fixed_knob": FixedKnob("fixed")}

    def train(self, dataset_uri):
        self._params = {"weight": [1.0, 2.0]}

    def evaluate(self, dataset_uri):
        return 0.5

    def predict(self, queries):
        return [[0.5, 0.5] for _ in queries]

    def dump_parameters(self):
        return self._params

    def load_parameters(self, params):
        self._params = params
"""

def _deploy_errors(tmp_path, jax_side):
    """The deploy errors of the four bad drafts, trial ids masked: a
    draft for a job that is not generative, an unknown trial, a trial not
    COMPLETED and a template that is not generation-capable. Then a
    valid draft deploys."""
    if jax_side:
        from rafiki_tpu.admin.admin import Admin as A
        from rafiki_tpu.admin.services import ServiceDeploymentError as E
        from rafiki_tpu.db.database import Database as D
        from rafiki_tpu.placement.manager import (
            ChipAllocator,
            LocalPlacementManager,
        )
        from rafiki_tpu import config as cfg

        chips = [0]
        gen = (os.path.join(HERE, "fixtures", "gen_model.py"), "TinyGenLM")
        fake = (os.path.join(HERE, "fixtures", "fake_model.py"), "FakeModel")
    else:
        from rafiki_tpu_torch.admin.admin import Admin as A
        from rafiki_tpu_torch.admin.services import (
            ServiceDeploymentError as E,
        )
        from rafiki_tpu_torch.db.database import Database as D
        from rafiki_tpu_torch.placement.manager import (
            ChipAllocator,
            LocalPlacementManager,
        )
        from rafiki_tpu_torch import config as cfg

        chips = ["cpu"]
        gen = (os.path.join(HERE, "..", "rafiki_tpu_torch", "templates",
                            "torch_gen_lm.py"), "TorchGenLM")
        fake = (None, "FakeModel")
    admin = A(db=D(":memory:"),
              placement=LocalPlacementManager(
                  allocator=ChipAllocator(chips)),
              params_dir=str(tmp_path / ("jax" if jax_side else "torch")))
    errors = []
    try:
        uid = admin.authenticate_user(cfg.SUPERADMIN_EMAIL,
                                      cfg.SUPERADMIN_PASSWORD)["user_id"]
        for name, task, (path, cls) in (
                ("gen", "TEXT_GENERATION", gen),
                ("fake", "IMAGE_CLASSIFICATION", fake)):
            if path is None:
                source = PORT_FAKE
            else:
                with open(path, "rb") as f:
                    source = f.read()
            admin.create_model(uid, name, task, source, cls)
        admin.create_train_job(uid, "g", "TEXT_GENERATION", "t", "e",
                               budget={"MODEL_TRIAL_COUNT": 2})
        admin.create_train_job(uid, "a", "IMAGE_CLASSIFICATION", "t", "e",
                               budget={"MODEL_TRIAL_COUNT": 1})
        for app in ("g", "a"):
            assert admin.wait_until_train_job_stopped(
                uid, app, timeout_s=300)["status"] == "STOPPED"
        g1, g2 = [t["id"] for t in admin.get_trials_of_train_job(uid, "g")]
        (a1,) = [t["id"] for t in admin.get_trials_of_train_job(uid, "a")]
        admin.db.mark_trial_as_errored(g2)
        for app, draft in (("a", g1), ("g", "t404"), ("g", g2), ("g", a1)):
            with pytest.raises(E) as err:
                admin.create_inference_job(uid, app,
                                           budget={"GEN_DRAFT_TRIAL": draft})
            errors.append(re.sub(r"'[0-9a-f-]{8,}'", "'<trial>'",
                                 str(err.value)))
        inf = admin.create_inference_job(uid, "g",
                                         budget={"GEN_DRAFT_TRIAL": g1})
        assert inf["status"] == "RUNNING"
        admin.stop_inference_job(uid, "g")
    finally:
        admin.shutdown()
    return errors


def test_draft_trial_is_checked_at_deploy_as_jax_does(tmp_path):
    ours = _deploy_errors(tmp_path, jax_side=False)
    theirs = _deploy_errors(tmp_path, jax_side=True)
    assert ours == theirs
    assert [e.split(" ")[3] for e in ours] == [
        "only", "unknown", "'<trial>'", "'<trial>'"]
    assert "not COMPLETED" in ours[2] and "generation-capable" in ours[3]
