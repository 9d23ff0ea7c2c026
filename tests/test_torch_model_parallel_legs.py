"""Model-parallel training, the whole: each leg of the dryrun
(``parallel/dryrun.py``, the port of ``__graft_entry__.dryrun_multichip``)
on four gloo ranks against JAX's ``GspmdTrainer`` on four of conftest's
virtual CPU devices, from the same (JAX-drawn) parameters and batch, and
the LM's ring, GPipe and sequence-shard paths against the dense forward
(``tests/test_graft_entry.py``'s cases).

A step here is SGD at lr 1 on both sides, so that each updated leaf is
the parameter less its gradient (AdamW's first step moves a weight by
about lr times the sign of its gradient and would hide the gradients);
the dryrun itself, with AdamW, ends in its OK line. The LM legs run in
f32 (both packages' ``core.embedding`` set to f32, as
``tests/test_torch_text.py`` does): loss and every updated leaf within
2e-4. The ViT leg runs in bf16, as the model does, at the tolerance of
``tests/test_torch_parallel.py``'s ViT fit parity: the loss within 1e-3
relative and each leaf's update within 20% of its norm (relative L2).

The rank-side functions live here, at module level: a follower imports
this module by name to run them.
"""

import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from rafiki_tpu.models import core as jcore
from rafiki_tpu.models import lm as jlm
from rafiki_tpu.models import vit as jvit
from rafiki_tpu.parallel import sharding as jsharding
from rafiki_tpu_torch import convert
from rafiki_tpu_torch.device import set_device_grant
from rafiki_tpu_torch.models import core, lm
from rafiki_tpu_torch.parallel import dryrun, ranks, sharding
from rafiki_tpu_torch.utils import jrandom

CPUS = ["cpu:0", "cpu:1", "cpu:2", "cpu:3"]
DIST_TIMEOUT_S = 120
F32_TOL = 2e-4
VIT_LOSS_RTOL = 1e-3
VIT_LEAF_RTOL = 0.2


@pytest.fixture(autouse=True, scope="module")
def _ranks_env():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAFIKI_DIST_TIMEOUT_S", str(DIST_TIMEOUT_S))
        mp.setenv("OMP_NUM_THREADS", "1")
        yield


@pytest.fixture(scope="module")
def world():
    with ranks.Ranks(CPUS) as r:
        yield r


def on_ranks(r, fn, *args):
    set_device_grant(r.devices)
    ranks.set_group(r.group)
    try:
        return r.run(fn, *args)
    finally:
        ranks.set_group(None)
        set_device_grant(None)


@contextlib.contextmanager
def f32_embedding(on: bool):
    """The port's ``core.embedding`` in f32 for the block (the LM then
    computes in f32 throughout)."""
    orig = core.embedding
    if on:
        core.embedding = lambda p, ids, dtype=None: orig(p, ids,
                                                         torch.float32)
    try:
        yield
    finally:
        core.embedding = orig


@pytest.fixture
def jax_f32_embedding(monkeypatch):
    monkeypatch.setattr(jcore, "embedding", functools.partial(
        jcore.embedding, dtype=jnp.float32))


def sgd(params):
    return torch.optim.SGD(params, lr=1.0)


def leg_rank(devices, leg, tree, f32):
    """Rank side: one SGD step of ``leg`` from ``tree`` on this rank's
    shards; (the loss, the whole updated tree on rank 0, the predict of
    leg 1 over the batch's images)."""
    with f32_embedding(f32):
        groups = dryrun.mesh_groups(leg, devices)
        try:
            trainer = dryrun.trainer_for(leg, groups, sgd)
            params, opt = trainer.init(lambda rng: tree)
            predicted = None
            if leg.family == "vit":
                predicted = trainer.predict(params, leg.batch[0]).numpy()
            params, opt, loss, aux = trainer.step(
                params, opt, leg.batch, jrandom.PRNGKey(leg.key))
            whole = convert.gather_tree(params, trainer.param_specs, groups)
        finally:
            groups.close()
    first = ranks.current_group().rank == 0
    return (float(loss), {k: float(v) for k, v in aux.items()},
            whole if first else None, predicted)


def jax_leg(leg, n=4):
    """(JAX's initial tree, its step's loss and updated tree, its predict
    of the images for a ViT) on an ``n``-device mesh of the leg's axes
    (one device: the leg's computation unsplit)."""
    devs = jax.devices()[:n]
    axes = {k: leg.axes.get(k, 1) for k in dryrun.AXES} if n > 1 else {}
    mesh = jsharding.make_train_mesh(devices=devs, **axes)
    if leg.family == "vit":
        cfg = jvit.tiny()

        def loss_fn(p, b, rng):
            logits = jvit.apply(p, b[0], cfg, rng, deterministic=False)
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, b[1]).mean(), {}

        trainer = jsharding.GspmdTrainer(
            loss_fn, optax.sgd(1.0), jvit.partition_specs(cfg),
            (jvit.batch_spec(), JP("data")), mesh,
            predict_fn=lambda p, xb: jvit.apply(p, xb, cfg))
        tree = jvit.init(jax.random.key(0), cfg)
    else:
        enc = leg.cfg.encoder
        cfg = jlm.tiny(max_len=leg.cfg.max_len, depth=enc.depth,
                       moe_experts=enc.moe_experts,
                       seq_parallel=enc.seq_parallel, pipeline=enc.pipeline,
                       n_microbatches=enc.n_microbatches)
        trainer = jsharding.GspmdTrainer(
            lambda p, b, rng: jlm.loss_fn(p, b, rng, cfg), optax.sgd(1.0),
            jlm.partition_specs(cfg), jlm.batch_spec(), mesh)
        tree = jlm.init(jax.random.key(0), cfg)
    tree = jax.tree.map(np.asarray, tree)
    params, opt = trainer.init(lambda rng: jax.tree.map(jnp.asarray, tree))
    predicted = None
    if leg.family == "vit":
        predicted = np.asarray(trainer.predict(params, leg.batch[0]))
    params, opt, loss, aux = trainer.step(params, opt, leg.batch,
                                          jax.random.key(leg.key))
    return tree, float(loss), jax.tree.map(np.asarray, params), predicted


def seeded(leg):
    """``leg`` with a seeded batch (the dryrun's are constants): random
    images and labels, or random ids with the mask's tail off in row 0."""
    rng = np.random.default_rng(7)
    if leg.family == "vit":
        x, y = leg.batch
        batch = (rng.standard_normal(x.shape).astype(np.float32),
                 rng.integers(0, 10, y.shape).astype(np.int32))
    else:
        ids = rng.integers(0, leg.cfg.vocab, leg.batch[0].shape)
        mask = np.ones_like(ids)
        mask[0, -5:] = 0
        batch = (ids.astype(np.int32), mask.astype(np.int32))
    return dataclasses.replace(leg, batch=batch)


def _agrees(mine, want, start, f32) -> bool:
    if f32:
        return np.allclose(mine, want, atol=F32_TOL, rtol=F32_TOL)
    d, d_jax = mine - start, want - start
    return np.linalg.norm(d - d_jax) <= VIT_LEAF_RTOL * max(
        np.linalg.norm(d_jax), 1e-12)


def compare(leg, tree, jloss, jparams, got, f32, single=None):
    """The port's step (``got``, every rank's) against JAX's on the mesh
    (``jparams``). A leaf where JAX's mesh step disagrees with its own
    one-device step (``single``) is a fault of the reference: there the
    port is held to the one-device step. Returns those leaves' names."""
    (loss, aux, whole, _), *_ = got
    np.testing.assert_allclose(loss, jloss,
                               rtol=F32_TOL if f32 else VIT_LOSS_RTOL)
    assert all(r[0] == loss for r in got)  # the same total on every rank
    faults = set()
    leaves = zip(jax.tree_util.tree_leaves_with_path(jparams),
                 jax.tree_util.tree_leaves_with_path(tree),
                 jax.tree_util.tree_leaves(single or jparams))
    for (path, want), (_, start), alone in leaves:
        mine = whole
        for key in path:
            mine = mine[key.key]
        name = jax.tree_util.keystr(path)
        assert mine.shape == want.shape, name
        if not _agrees(want, alone, start, f32):
            faults.add(name)
            want = alone
        assert _agrees(mine, want, start, f32), name
    return faults


@pytest.mark.parametrize("index", [0, 1, 2, 3],
                         ids=["vit-dp-tp-sp", "moe-pp-dp-ep", "ring-dp-sp",
                              "gpipe-pp-dp"])
def test_dryrun_leg_step_matches_jax(world, jax_f32_embedding, index):
    """Each training leg's step on 4 ranks against JAX's on 4 devices
    (the tolerances of the module's note); leg 1 also serves (leg 5):
    its tensor-split predict against JAX's within 2e-2 (bf16 logits, as
    ``tests/test_torch_vit.py`` holds the forward)."""
    leg = seeded(dryrun.legs(4)[index])
    f32 = leg.family == "lm"
    tree, jloss, jparams, jpred = jax_leg(leg)
    single = jax_leg(leg, n=1)[2]
    got = on_ranks(world, leg_rank, CPUS, leg, tree, f32)
    faults = compare(leg, tree, jloss, jparams, got, f32, single)
    # JAX's GSPMD step over dp=1 x tp=2 x sp=2 doubles the patch kernel's
    # gradient against its own one-device step (ROADMAP.md, C)
    assert faults == ({"['patch']['kernel']"} if index == 0 else set())
    if leg.family == "vit":
        for *_, pred in got:
            np.testing.assert_allclose(pred, jpred, atol=2e-2, rtol=2e-2)
    if leg.family == "lm" and leg.cfg.encoder.moe_experts:
        assert all(r[1]["moe_aux"] > 0 for r in got)


def test_lm_seq_shard_without_ring_matches_jax(world, jax_f32_embedding):
    """The LM over dp=2 x sp=2 without ring attention: each shard's
    queries against the keys gathered up to its end (causal), the
    next-token targets across the shards' edge, the global mask count."""
    leg = seeded(dryrun.Leg("seq-LM", "lm", lm.tiny(depth=2, max_len=16),
                            dict(dp=2, sp=2),
                            (np.ones((4, 16), np.int32),) * 2, key=5))
    tree, jloss, jparams, _ = jax_leg(leg)
    got = on_ranks(world, leg_rank, CPUS, leg, tree, True)
    compare(leg, tree, jloss, jparams, got, True)


def logits_rank(devices, leg, tree):
    """Rank side: ``lm.apply`` on this rank's shard under the leg's mesh
    (parameters sharded), no gradient; (data, seq index, logits)."""
    groups = dryrun.mesh_groups(leg, devices)
    specs = lm.partition_specs(leg.cfg)
    local = sharding.tree_map(torch.tensor, convert.shard_tree(
        tree, specs, groups.mesh, groups.rank))
    ids = leg.batch[0]
    rows = ids.shape[0] // groups.size("data")
    cols = ids.shape[1] // groups.size("seq")
    d, s = groups.index("data"), groups.index("seq")
    part = torch.from_numpy(ids[d * rows:(d + 1) * rows,
                                s * cols:(s + 1) * cols])
    with sharding.activation_mesh(groups), torch.no_grad():
        logits, _ = lm.apply(local, part, leg.cfg)
    groups.close()
    return d, s, logits.numpy()


@pytest.mark.parametrize("mode", ["ring", "gpipe", "seq"])
def test_lm_parallel_modes_match_dense(world, mode):
    """``seq_parallel='ring'`` (dp=2 x sp=2), ``pipeline='gpipe'`` (dp=2
    x pp=2, 2 microbatches) and a plain sequence shard give the dense
    logits for the same parameters: within 1e-2 in bf16 (the JAX test's
    bound for ring), and JAX's dense logits alike."""
    cfg_dense = lm.tiny(depth=4, max_len=32)
    kw = {"ring": dict(seq_parallel="ring"),
          "gpipe": dict(pipeline="gpipe", n_microbatches=2),
          "seq": {}}[mode]
    axes = dict(dp=2, pp=2) if mode == "gpipe" else dict(dp=2, sp=2)
    cfg = lm.tiny(depth=4, max_len=32, **kw)
    tree = jax.tree.map(np.asarray, jlm.init(jax.random.key(0),
                                             jlm.tiny(depth=4, max_len=32)))
    ids = np.asarray(jax.random.randint(jax.random.key(1), (4, 32), 0, 256),
                     np.int32)
    leg = dryrun.Leg(mode, "lm", cfg, axes, (ids, ids))
    with torch.no_grad():
        dense, _ = lm.apply(sharding.tree_map(torch.tensor, tree),
                            torch.from_numpy(ids), cfg_dense)
    got = on_ranks(world, logits_rank, CPUS, leg, tree)
    rows, cols = 2, 32 // axes.get("sp", 1)
    for d, s, logits in got:
        np.testing.assert_allclose(
            logits, dense.numpy()[d * rows:(d + 1) * rows,
                                  s * cols:(s + 1) * cols],
            atol=1e-2, rtol=1e-2)
    jdense, _ = jlm.apply(tree, ids, jlm.tiny(depth=4, max_len=32))
    np.testing.assert_allclose(dense.numpy(), np.asarray(jdense),
                               atol=1e-2, rtol=1e-2)


def test_dryrun_multichip_on_four_cpu_ranks(capsys):
    """The entry point itself on 4 gloo ranks: a line a leg, then its OK
    line; every leg's loss finite on every rank."""
    records = dryrun.dryrun_multichip(4, device="cpu")
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1].startswith("dryrun_multichip OK on 4 cpu ranks: ViT ")
    assert len(out) == 6 and all(
        line.startswith("dryrun_multichip: ") for line in out[:5])
    assert "MoE-LM dp=1 pp=2 ep=2" in out[-1]
    assert "ring-LM dp=2 sp=2" in out[-1]
    assert "gpipe-LM dp=2 pp=2" in out[-1]
    assert "serve-predict dp=1 tp=2 sp=2 batch=4 ok" in out[-1]
    assert len(records) == 4
    for rank in records:
        assert [r["name"] for r in rank] == ["ViT", "MoE-LM", "ring-LM",
                                             "gpipe-LM", "serve-predict"]
        assert all(np.isfinite(r["losses"]).all() for r in rank[:4])


@pytest.mark.parametrize("remat", ["dots", "full"])
def test_remat_over_ranks_matches_no_remat(world, remat):
    """Leg 1 (dp=1 x tp=2 x sp=2) at ``remat``: the backward runs each
    block again under the same mesh, its collectives included, so the
    step's loss and every updated leaf are those without remat (bf16;
    within 1e-6, the same products in the same order)."""
    leg = seeded(dryrun.legs(4)[0])
    rleg = dataclasses.replace(leg, cfg=dataclasses.replace(
        leg.cfg, encoder=dataclasses.replace(leg.cfg.encoder, remat=remat)))
    tree = jax.tree.map(np.asarray, jvit.init(jax.random.key(0),
                                              jvit.tiny()))
    (loss, _, whole, _), *_ = on_ranks(world, leg_rank, CPUS, leg, tree,
                                       False)
    (rloss, _, rwhole, _), *_ = on_ranks(world, leg_rank, CPUS, rleg, tree,
                                         False)
    np.testing.assert_allclose(rloss, loss, rtol=1e-6)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(whole),
                            jax.tree_util.tree_leaves(rwhole)):
        np.testing.assert_allclose(b, a, atol=1e-6, rtol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))
