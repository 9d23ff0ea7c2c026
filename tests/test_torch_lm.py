"""The port's decoder LM (``rafiki_tpu_torch/models/lm.py``) against
``rafiki_tpu/models/lm.py`` on one parameter tree.

The tree is made with numpy from a seed in the JAX layout and carried into
the port by ``convert.py``; ids, positions, block tables and sampling
knobs are seeded numpy arrays fed to both. Tolerances:

- the training forward in bf16 (``apply``, as both packages compute it):
  ``LOGIT_ATOL`` as for the ViT; the same forward in f32 (the embedding's
  compute type switched to f32 on both sides): ``F32_ATOL``;
- the cached forwards (ring and paged prefill and decode) compute in the
  cache's f32 in both packages: ``F32_ATOL`` on logits and on the caches;
  the port's paged and ring forwards run the same code on the same rows:
  equal bit for bit;
- sampling: ``_uniform_at`` bit for bit; ``modified_dist`` within
  ``F32_ATOL``; the drawn tokens equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rafiki_tpu.models import core as jcore
from rafiki_tpu.models import lm as jlm
from rafiki_tpu_torch import convert
from rafiki_tpu_torch.models import core, lm

LOGIT_ATOL = 2.5e-2
F32_ATOL = 1e-5
VOCAB, MAX_LEN, DIM, DEPTH, HEADS = 64, 32, 32, 2, 2


def _cfgs(**kw):
    args = dict(vocab=VOCAB, max_len=MAX_LEN, dim=DIM, depth=DEPTH,
                heads=HEADS, **kw)
    return lm.tiny(**args), jlm.tiny(**args)


@pytest.fixture(scope="module")
def models():
    cfg, jcfg = _cfgs()
    tree = lm.init(np.random.default_rng(0), cfg)
    model = convert.from_jax_params(tree, cfg, "cpu")
    return cfg, jcfg, tree, jax.tree.map(jnp.asarray, tree), model


def _ids(shape, seed=1):
    return np.random.default_rng(seed).integers(0, VOCAB, shape).astype(
        np.int32)


def _f32_embedding(monkeypatch):
    """Both packages' embeddings in f32, so the whole forward is f32."""
    jemb, emb = jcore.embedding, core.embedding
    monkeypatch.setattr(jcore, "embedding",
                        lambda p, ids, dtype=None: jemb(p, ids, jnp.float32))
    monkeypatch.setattr(core, "embedding",
                        lambda p, ids, dtype=None: emb(p, ids, torch.float32))


def test_init_matches_jax_layout(models):
    _, jcfg, tree, _, model = models
    jtree = jlm.init(jax.random.key(0), jcfg)
    shapes = lambda t: {  # noqa: E731
        jax.tree_util.keystr(p): v.shape
        for p, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    assert shapes(tree) == shapes(jtree)
    back = convert.to_jax_params(model)
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        got = back
        for k in path:
            got = got[k.key]
        np.testing.assert_array_equal(got, leaf)


def test_apply_and_loss_match_jax(models):
    _, jcfg, _, jp, model = models
    ids = _ids((3, 12))
    mask = np.ones((3, 12), np.float32)
    mask[1, 8:] = 0
    jl, _ = jlm.apply(jp, jnp.asarray(ids), jcfg)
    jloss, jaux = jlm.loss_fn(jp, (jnp.asarray(ids), jnp.asarray(mask)),
                              jax.random.PRNGKey(0), jcfg)
    with torch.no_grad():
        logits, aux = lm.apply(model, torch.from_numpy(ids))
        loss, parts = lm.loss_fn(model, (torch.from_numpy(ids),
                                         torch.from_numpy(mask)))
    assert logits.dtype == torch.float32 and logits.shape == (3, 12, VOCAB)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl),
                               atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_allclose(float(loss), float(jloss), atol=LOGIT_ATOL)
    assert float(aux) == float(jaux["moe_aux"]) == 0.0
    assert float(parts["ce"]) == float(loss)


def test_apply_in_f32_matches_jax(models, monkeypatch):
    _, jcfg, _, jp, model = models
    _f32_embedding(monkeypatch)
    ids = _ids((2, 16), seed=2)
    jl, _ = jlm.apply(jp, jnp.asarray(ids), jcfg)
    with torch.no_grad():
        logits, _ = lm.apply(model, torch.from_numpy(ids))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl),
                               atol=F32_ATOL, rtol=0)


def _jcache(c):
    return {k: np.asarray(v) for k, v in c.items()}


def test_ring_prefill_and_decode_match_jax(models):
    cfg, jcfg, _, jp, model = models
    jc = jlm.init_kv_cache(jcfg, 2, MAX_LEN)
    tc = lm.init_kv_cache(cfg, 2, MAX_LEN)
    prompt = np.zeros(8, np.int32)
    prompt[:5] = _ids((5,), seed=3)
    jlg, jc = jlm.prefill(jp, jc, 1, jnp.asarray(prompt), 5, jcfg)
    tlg, tc = lm.prefill(model, tc, 1, prompt, 5)
    np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), atol=F32_ATOL,
                               rtol=0)
    ids = np.array([0, int(np.asarray(jlg).argmax())], np.int32)
    pos = np.array([0, 5], np.int32)
    for _ in range(4):
        jlg, jc = jlm.decode_step(jp, jc, jnp.asarray(ids), jnp.asarray(pos),
                                  jcfg)
        tlg, tc = lm.decode_step(model, tc, ids, pos)
        np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg),
                                   atol=F32_ATOL, rtol=0)
        ids = np.asarray(lm.greedy_token(tlg))
        pos = pos + np.array([0, 1], np.int32)
    for k, v in _jcache(jc).items():
        np.testing.assert_allclose(tc[k].numpy(), v, atol=F32_ATOL, rtol=0)


def test_prefill_then_decode_tracks_a_fresh_prefill(models):
    """Decoding from a prefilled cache predicts what a fresh prefill over
    the longer sequence predicts (the cache's invariant)."""
    cfg, _, _, _, model = models
    cache = lm.init_kv_cache(cfg, 2, MAX_LEN)
    prompt = [5, 9, 2, 7]
    logits, cache = lm.prefill(model, cache, 0, prompt + [0] * 4, 4)
    toks = [int(lm.greedy_token(logits))]
    ids, pos = np.array([toks[0], 0]), np.array([4, 0])
    for _ in range(5):
        lg, cache = lm.decode_step(model, cache, ids, pos)
        toks.append(int(lm.greedy_token(lg)[0]))
        ids[0], pos[0] = toks[-1], pos[0] + 1
    longer = prompt + toks[:-1]
    fresh = lm.init_kv_cache(cfg, 1, MAX_LEN)
    lg2, _ = lm.prefill(model, fresh, 0, longer + [0] * (16 - len(longer)),
                        len(longer))
    assert int(lm.greedy_token(lg2)) == toks[-1]


def test_paged_prefill_and_decode_match_jax_and_the_ring(models):
    """Paged prefill (one-shot and chunked) and decode against the JAX
    package's on the same pool, and against the port's ring on the same
    prompt: the logits equal bit for bit. Idle slots carry all-sentinel
    tables, and a sentinel's writes are dropped."""
    cfg, jcfg, _, jp, model = models
    bt, nbpool, nb = 4, 10, 8
    sentinel = nbpool
    table = np.array([3, 7, 1, sentinel, sentinel, sentinel, sentinel,
                      sentinel], np.int32)
    prompt = _ids((9,), seed=4)
    padded = np.zeros(16, np.int32)
    padded[:9] = prompt
    jpc = jlm.init_paged_kv_cache(jcfg, nbpool, bt)
    tpc = lm.init_paged_kv_cache(cfg, nbpool, bt)
    jlg, jpc = jlm.paged_prefill(jp, jpc, jnp.asarray(table),
                                 jnp.asarray(padded), 0, 9, jcfg)
    tlg, tpc = lm.paged_prefill(model, tpc, table, padded, 0, 9)
    np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), atol=F32_ATOL,
                               rtol=0)
    for k, v in _jcache(jpc).items():
        np.testing.assert_allclose(tpc[k].numpy(), v, atol=F32_ATOL, rtol=0)
    # the same prompt in two chunks (5 + 4 tokens, unpadded) writes the
    # same rows at the prompt's positions
    chunked = lm.init_paged_kv_cache(cfg, nbpool, bt)
    lm.paged_prefill(model, chunked, table, prompt[:5], 0, 5)
    clg, chunked = lm.paged_prefill(model, chunked, table, prompt[5:], 5, 4)
    np.testing.assert_array_equal(clg.numpy(), tlg.numpy())
    rows = [(table[p // bt], p % bt) for p in range(9)]
    for k in chunked:
        for blk, off in rows:
            np.testing.assert_array_equal(chunked[k][:, blk, off].numpy(),
                                          tpc[k][:, blk, off].numpy())
    # the ring, on the same prompt
    ring = lm.init_kv_cache(cfg, 2, nb * bt)
    rlg, ring = lm.prefill(model, ring, 1, padded, 9)
    np.testing.assert_array_equal(rlg.numpy(), tlg.numpy())
    tables = np.stack([np.full(nb, sentinel, np.int32), table])
    ids = np.array([0, int(tlg.argmax())], np.int32)
    pos = np.array([0, 9], np.int32)
    for _ in range(3):
        jlg, jpc = jlm.paged_decode_step(jp, jpc, jnp.asarray(ids),
                                         jnp.asarray(pos),
                                         jnp.asarray(tables), jcfg)
        before = tpc["k"][:, sentinel - 1].clone()
        tlg, tpc = lm.paged_decode_step(model, tpc, ids, pos, tables)
        rlg, ring = lm.decode_step(model, ring, ids, pos)
        np.testing.assert_allclose(tlg.numpy()[1], np.asarray(jlg)[1],
                                   atol=F32_ATOL, rtol=0)
        np.testing.assert_array_equal(tlg.numpy()[1], rlg.numpy()[1])
        # the idle slot (all sentinel) wrote nothing
        np.testing.assert_array_equal(tpc["k"][:, sentinel - 1].numpy(),
                                      before.numpy())
        ids = np.array([0, int(tlg[1].argmax())], np.int32)
        pos = pos + np.array([0, 1], np.int32)
    for k, v in _jcache(jpc).items():
        np.testing.assert_allclose(tpc[k].numpy(), v, atol=F32_ATOL, rtol=0)


def test_copy_kv_blocks_matches_jax(models):
    cfg, jcfg, _, _, _ = models
    pool = np.random.default_rng(5).standard_normal(
        (DEPTH, 6, 4, HEADS, DIM // HEADS)).astype(np.float32)
    src, dst = np.array([0, 2], np.int32), np.array([5, 3], np.int32)
    jout = jlm.copy_kv_blocks({"k": jnp.asarray(pool),
                               "v": jnp.asarray(pool * 2)}, src, dst)
    tout = lm.copy_kv_blocks({"k": torch.from_numpy(pool.copy()),
                              "v": torch.from_numpy(pool * 2)}, src, dst)
    for k in ("k", "v"):
        np.testing.assert_array_equal(tout[k].numpy(), np.asarray(jout[k]))


@pytest.mark.parametrize("shape", [(7,), (3, 4)])
@pytest.mark.parametrize("role", [lm.ROLE_TARGET, lm.ROLE_DRAFT,
                                  lm.ROLE_ACCEPT])
def test_uniform_at_is_jax_bit_for_bit(shape, role):
    rng = np.random.default_rng(6)
    n = shape[0]
    seeds = np.concatenate([[0, 2 ** 32 - 1], rng.integers(
        0, 2 ** 32, n - 2)]).astype(np.uint32)[:n]
    positions = rng.integers(0, 4096, shape).astype(np.int32)
    want = np.asarray(jlm._uniform_at(jnp.asarray(seeds),
                                      jnp.asarray(positions), role))
    got = lm._uniform_at(seeds, positions, role)
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_uniform_keys_are_pure_and_role_separated():
    seeds = np.asarray([7, 7], np.uint32)
    pos = np.asarray([11, 12], np.int32)
    a = lm._uniform_at(seeds, pos, lm.ROLE_TARGET)
    assert (a == lm._uniform_at(seeds, pos, lm.ROLE_TARGET)).all()
    assert a[0] != a[1]
    assert (a != lm._uniform_at(seeds, pos, lm.ROLE_ACCEPT)).any()
    assert lm._uniform_at(seeds[:1], pos[:1], lm.ROLE_TARGET)[0] == a[0]


def test_modified_dist_and_sample_from_match_jax():
    rng = np.random.default_rng(7)
    logits = rng.standard_normal((8, VOCAB)).astype(np.float32)
    logits[3, :4] = logits[3].max() + 1  # a 4-way tie at the top
    temp = np.array([0, 0.5, 1, 1.5, 0.8, 1, 2, 0.7], np.float32)
    top_k = np.array([0, 5, 0, 3, 0, 1, 2, 64], np.int32)
    top_p = np.array([1, 1, 0.9, 0.5, 0.95, 1, 0.3, 0.99], np.float32)
    want = np.asarray(jlm.modified_dist(jnp.asarray(logits), temp, top_k,
                                        top_p))
    got = lm.modified_dist(torch.from_numpy(logits), temp, top_k, top_p)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL, rtol=0)
    u = rng.random((5, 8)).astype(np.float32)
    for row in u:
        assert (lm.sample_from(got, torch.from_numpy(row)).numpy()
                == np.asarray(jlm.sample_from(jnp.asarray(want),
                                              jnp.asarray(row)))).all()


def test_temperature_zero_is_the_exact_argmax():
    logits = torch.from_numpy(
        np.random.RandomState(0).randn(3, 16).astype(np.float32))
    probs = lm.modified_dist(logits, 0.0, 0, 1.0)
    hot = logits.argmax(-1)
    assert (probs.argmax(-1) == hot).all()
    assert (probs.max(-1).values == 1.0).all() and (probs.sum(-1) == 1).all()
    for u in (0.0, 0.5, 0.999999):
        assert (lm.sample_from(probs, torch.full((3,), u)) == hot).all()


def test_top_k_and_top_p_filters():
    logits = torch.tensor([[4.0, 3.0, 2.0, 1.0, 0.0]])
    p = lm.modified_dist(logits, 1.0, 2, 1.0)[0]
    assert (p[2:] == 0).all() and p[0] > p[1] > 0
    assert abs(float(p.sum()) - 1.0) < 1e-6
    p = lm.modified_dist(logits, 1.0, 0, 0.01)[0]
    assert p[0] == 1.0 and (p[1:] == 0).all()
    warm = lm.modified_dist(logits, 1.0, 0, 1.0)[0]
    cold = lm.modified_dist(logits, 0.25, 0, 1.0)[0]
    assert cold[0] > warm[0]


@pytest.mark.parametrize("paged", [False, True])
def test_sampled_steps_match_jax_and_temperature_zero_is_greedy(models,
                                                                paged):
    cfg, jcfg, _, jp, model = models
    bt, nbpool, nb = 4, 12, 8
    tables = np.arange(16, dtype=np.int32).reshape(2, nb) % nbpool
    tables[0, 4:] = nbpool
    tables[1] = np.array([4, 5, 6, 7, 8, 9, 10, 11])
    sampling = {"seed": np.array([3, 2 ** 31 - 5], np.uint32),
                "temperature": np.array([0.9, 0.0], np.float32),
                "top_k": np.array([0, 0], np.int32),
                "top_p": np.array([0.9, 1.0], np.float32),
                "role": lm.ROLE_TARGET}
    greedy = dict(sampling, temperature=np.zeros(2, np.float32))
    ids = _ids((2,), seed=8)
    pos = np.array([6, 9], np.int32)
    if paged:
        jc = jlm.init_paged_kv_cache(jcfg, nbpool, bt)
        caches = [lm.init_paged_kv_cache(cfg, nbpool, bt) for _ in range(3)]
        jtok, _, _ = jlm.paged_decode_step_sampled(
            jp, jc, jnp.asarray(ids), jnp.asarray(pos), jnp.asarray(tables),
            sampling, jcfg)
        tok, probs, _ = lm.paged_decode_step_sampled(
            model, caches[0], ids, pos, tables, sampling)
        gtok, _, _ = lm.paged_decode_step_sampled(model, caches[1], ids, pos,
                                                  tables, greedy)
        logits, _ = lm.paged_decode_step(model, caches[2], ids, pos, tables)
    else:
        jc = jlm.init_kv_cache(jcfg, 2, MAX_LEN)
        caches = [lm.init_kv_cache(cfg, 2, MAX_LEN) for _ in range(3)]
        jtok, _, _ = jlm.decode_step_sampled(
            jp, jc, jnp.asarray(ids), jnp.asarray(pos), sampling, jcfg)
        tok, probs, _ = lm.decode_step_sampled(model, caches[0], ids, pos,
                                               sampling)
        gtok, _, _ = lm.decode_step_sampled(model, caches[1], ids, pos,
                                            greedy)
        logits, _ = lm.decode_step(model, caches[2], ids, pos)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    assert probs.shape == (2, VOCAB)
    np.testing.assert_array_equal(gtok.numpy(),
                                  lm.greedy_token(logits).numpy())
    assert int(tok[1]) == int(lm.greedy_token(logits)[1])


def test_moe_is_refused(monkeypatch):
    """MoE blocks now build and train: an LM of 2 experts gives JAX's
    logits, aux term and loss (f32, within 1e-5); only the KV caches
    refuse them, with JAX's ValueError."""
    _f32_embedding(monkeypatch)
    cfg, jcfg = _cfgs(moe_experts=2)
    tree = lm.init(np.random.default_rng(0), cfg)
    assert tree["blocks"]["moe"]["w1"].shape == (DEPTH, 2, DIM, 4 * DIM)
    model = convert.from_jax_params(tree, cfg, "cpu", train=True)
    ids, mask = _ids((2, 16)), np.ones((2, 16), np.int32)
    jp = jax.tree.map(jnp.asarray, tree)
    jlogits, jaux = jlm.apply(jp, jnp.asarray(ids), jcfg)
    jloss, jparts = jlm.loss_fn(jp, (jnp.asarray(ids), jnp.asarray(mask)),
                                jax.random.key(0), jcfg)
    logits, aux = lm.apply(model, torch.from_numpy(ids))
    loss, parts = lm.loss_fn(model, (torch.from_numpy(ids),
                                     torch.from_numpy(mask)))
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               atol=F32_ATOL, rtol=F32_ATOL)
    assert float(aux) > 0
    np.testing.assert_allclose(float(aux), float(jaux), rtol=F32_ATOL)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=F32_ATOL)
    assert model.blocks[0].moe.w1.grad is not None
    for name, args in (("init_kv_cache", (2, 8)),
                       ("init_paged_kv_cache", (4, 4))):
        with pytest.raises(ValueError) as theirs:
            getattr(jlm, name)(jcfg, *args)
        with pytest.raises(ValueError) as ours:
            getattr(lm, name)(cfg, *args)
        assert str(ours.value) == str(theirs.value)


def test_kv_caches_hold_f32_rows_of_the_config(models):
    cfg, _, _, _, _ = models
    ring = lm.init_kv_cache(cfg, 3, 16)
    assert ring["k"].shape == (DEPTH, 3, 16, HEADS, DIM // HEADS)
    assert lm.cache_max_len(ring) == 16 and lm.cache_max_slots(ring) == 3
    pool = lm.init_paged_kv_cache(cfg, 5, 4)
    assert lm.paged_pool_blocks(pool) == 5 and lm.paged_block_tokens(pool) == 4
    assert lm.paged_pool_bytes(pool) == 2 * DEPTH * 5 * 4 * DIM * 4
    assert dataclasses.replace(cfg).encoder.causal
