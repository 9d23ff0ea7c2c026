"""Model-parallel training, the parts: the port's train mesh, its
collectives, dropout, remat and the stack's refusals against the JAX
package's (``tests/test_parallel.py``'s and ``tests/test_models.py``'s
cases and more; ring attention, GPipe and MoE are in
``tests/test_torch_model_parallel_ops.py``).

The JAX functions run over a mesh of conftest's virtual CPU devices from
one process; the port runs one gloo rank a CPU entry (rank 0 in the test
process, three followers spawned, shared by the module), each holding its
shard (``parallel/sharding.py``). The rank-side functions live here, at
module level: a follower imports this module by name to run them.
Tolerances are stated at each test: f32 paths within 1e-5 of JAX (the
same products in another order, summed over ranks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from rafiki_tpu.models import core as jcore
from rafiki_tpu.models import lm as jlm
from rafiki_tpu.models import vit as jvit
from rafiki_tpu.parallel import sharding as jsharding
from rafiki_tpu_torch import convert
from rafiki_tpu_torch.device import set_device_grant
from rafiki_tpu_torch.models import core, lm, vit
from rafiki_tpu_torch.parallel import collectives as C
from rafiki_tpu_torch.parallel import ranks, sharding
from rafiki_tpu_torch.parallel.collectives import MeshGroups
from rafiki_tpu_torch.parallel.sharding import P, make_train_mesh
from rafiki_tpu_torch.utils import jrandom

CPUS = ["cpu:0", "cpu:1", "cpu:2", "cpu:3"]
#: the group's timeout: a follower imports this module (JAX with it) at
#: its first call while rank 0 waits in a collective
DIST_TIMEOUT_S = 120
#: f32 results of the same products in another order (and summed over
#: ranks) against JAX's
F32_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _ranks_env():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAFIKI_DIST_TIMEOUT_S", str(DIST_TIMEOUT_S))
        mp.setenv("OMP_NUM_THREADS", "1")
        yield


@pytest.fixture(scope="module")
def world():
    """Four gloo ranks, rank 0 here, for the module's tests."""
    with ranks.Ranks(CPUS) as r:
        yield r


def on_ranks(r, fn, *args):
    """``fn(*args)`` on every rank of ``r``; every rank's result."""
    set_device_grant(r.devices)
    ranks.set_group(r.group)
    try:
        return r.run(fn, *args)
    finally:
        ranks.set_group(None)
        set_device_grant(None)


def view(axes, devices=CPUS):
    """This rank's view of a mesh of ``axes`` over ``devices``."""
    return MeshGroups.create(make_train_mesh(devices=devices, **axes),
                             ranks.current_group())


def t32(a, grad=False):
    return torch.tensor(np.asarray(a), dtype=torch.float32,
                        requires_grad=grad)


# ---------------------------------------------------------------------------
# specs and meshes
# ---------------------------------------------------------------------------

def test_filter_pspec():
    mesh = make_train_mesh(dp=4, tp=2, devices=["cpu"] * 8)
    jmesh = jsharding.make_train_mesh(dp=4, tp=2)
    for spec in [("data", "model"), ("bogus", "model"),
                 (("data", "bogus"), None), (("bogus",), "seq")]:
        ours = sharding.filter_pspec(P(*spec), mesh)
        theirs = jsharding.filter_pspec(JP(*spec), jmesh)
        assert tuple(ours) == tuple(theirs)
    assert sharding.filter_pspec(P("bogus", "model"), mesh) == P(None,
                                                                 "model")


@pytest.mark.parametrize("axes", [
    dict(dp=2, tp=2, sp=2), dict(dp=3, tp=3), dict(tp=2, pp=2, ep=2),
    dict(dp=None, sp=4), dict(dp=None, tp=3), dict(pp=2, dp=2, ep=2)])
def test_make_train_mesh_axes_as_jax(axes):
    """The same axes, in JAX's order, with the same sizes and errors; a
    rank's coordinates are its place in JAX's device array."""
    devs = jax.devices()

    def outcome(make, devices):
        try:
            return make(devices=devices, **axes)
        except ValueError as e:
            return ("ValueError", str(e))

    theirs = outcome(jsharding.make_train_mesh, devs)
    ours = outcome(make_train_mesh, [f"cpu:{i}" for i in range(8)])
    if isinstance(theirs, tuple):
        assert ours == theirs
        return
    assert ours.axis_names == tuple(theirs.axis_names)
    assert ours.shape == dict(theirs.shape)
    ids = np.vectorize(lambda d: d.id)(theirs.devices)
    for rank in range(8):
        at = np.argwhere(ids == devs[rank].id)[0]
        assert tuple(ours.coords(rank).values()) == tuple(at)
        for axis in ours.axis_names:
            line = ours.line(axis, rank)
            k = ours.axis_names.index(axis)
            index = tuple(slice(None) if i == k else int(a)
                          for i, a in enumerate(at))
            want = [devs.index(d) for d in theirs.devices[index]]
            assert list(line) == want


def test_shard_tree_cuts_as_jax_device_put():
    """``convert.shard_tree``'s part of each leaf is the shard JAX puts on
    the same device under the same spec, and ``local_index`` refuses a
    dimension that does not divide."""
    cfg = jvit.tiny()
    tree = jax.tree.map(np.asarray, jvit.init(jax.random.key(0), cfg))
    jmesh = jsharding.make_train_mesh(dp=2, tp=2, pp=2)
    placed = jax.device_put(tree, jsharding.named_shardings(
        jmesh, jvit.partition_specs(cfg)))
    mesh = make_train_mesh(dp=2, tp=2, pp=2,
                           devices=[f"cpu:{i}" for i in range(8)])
    specs = vit.partition_specs(vit.tiny())
    for rank in range(8):
        part = convert.shard_tree(tree, specs, mesh, rank)
        dev = jax.devices()[rank]
        for (path, got), leaf in zip(
                jax.tree_util.tree_leaves_with_path(part),
                jax.tree.leaves(placed)):
            shard = next(s for s in leaf.addressable_shards
                         if s.device == dev)
            np.testing.assert_array_equal(got, np.asarray(shard.data),
                                          err_msg=str(path))
    with pytest.raises(ValueError, match="does not split"):
        sharding.local_index((3, 4), P("data"), mesh, mesh.coords(0))


# ---------------------------------------------------------------------------
# the collectives, on 4 gloo ranks
# ---------------------------------------------------------------------------

def collectives_rank(devices):
    """Rank side: each operator forward and backward on a seq axis of 4
    (and the data x seq lines of a 2 x 2 mesh); the values seen."""
    g = view(dict(sp=4), devices)
    seq = g.group("seq")
    r = seq.rank
    out = {}
    x = (torch.arange(6.0).reshape(2, 3) + 10 * r).requires_grad_()
    ring = [(i, (i + 1) % 4) for i in range(4)]
    y = C.ppermute(x, seq, ring)
    (y * (r + 1)).sum().backward()
    out["ppermute"] = (y.detach().numpy(), x.grad.numpy())
    x.grad = None
    y = C.ppermute(x, seq, [(0, 1)])  # rank 0 to 1 alone; the rest zeros
    (y * (r + 1)).sum().backward()
    out["ppermute_one"] = (y.detach().numpy(), x.grad.numpy())
    x.grad = None
    y = C.all_gather(x, seq, 1)
    (y * torch.arange(12.0) * (r + 1)).sum().backward()
    out["all_gather"] = (y.detach().numpy(), x.grad.numpy())
    x.grad = None
    y = C.copy_to(x, seq) * (r + 1)
    y.sum().backward()
    out["copy_to"] = x.grad.numpy()
    x.grad = None
    y = C.reduce_from(x, seq)
    (y * (r + 1)).sum().backward()
    out["reduce_from"] = (y.detach().numpy(), x.grad.numpy())
    x.grad = None
    y = C.psum(x, seq)
    (y * (r + 1)).sum().backward()
    out["psum"] = (y.detach().numpy(), x.grad.numpy())
    x.grad = None
    y = C.gather_whole(x, seq, 0)
    (y * (r + 1)).sum().backward()
    out["gather_whole"] = (y.detach().numpy(), x.grad.numpy())
    x.grad = None
    (a,) = C.fetch([x], seq, 2)
    (a * (r + 1)).sum().backward()
    out["fetch"] = (a.detach().numpy(),
                    None if x.grad is None else x.grad.numpy())
    g.close()
    g = view(dict(dp=2, sp=2), devices)
    out["coords"] = g.coords
    out["sum_over"] = float(C.sum_over(torch.tensor([1.0 + g.rank]), g,
                                       ("data", "seq"))[0])
    g.close()
    return out


def test_collectives_and_their_conjugates(world):
    got = on_ranks(world, collectives_rank, CPUS)
    base = np.arange(6.0).reshape(2, 3)
    for r, out in enumerate(got):
        y, gx = out["ppermute"]
        np.testing.assert_array_equal(y, base + 10 * ((r - 1) % 4))
        np.testing.assert_array_equal(gx, np.full((2, 3), (r + 1) % 4 + 1))
        y, gx = out["ppermute_one"]
        np.testing.assert_array_equal(y, base if r == 1 else 0 * base)
        np.testing.assert_array_equal(gx, np.full((2, 3), 2.0 if r == 0
                                                  else 0.0))
        y, gx = out["all_gather"]
        np.testing.assert_array_equal(
            y, np.concatenate([base + 10 * s for s in range(4)], 1))
        # the sum over ranks of (s + 1) * arange, this rank's columns
        np.testing.assert_array_equal(
            gx, np.broadcast_to(10 * np.arange(3.0 * r, 3.0 * r + 3), (2, 3)))
        np.testing.assert_array_equal(out["copy_to"], np.full((2, 3), 10.0))
        y, gx = out["reduce_from"]
        np.testing.assert_array_equal(y, 4 * base + 60)
        np.testing.assert_array_equal(gx, np.full((2, 3), r + 1.0))
        y, gx = out["psum"]
        np.testing.assert_array_equal(y, 4 * base + 60)
        np.testing.assert_array_equal(gx, np.full((2, 3), 10.0))
        y, gx = out["gather_whole"]
        assert y.shape == (8, 3)
        np.testing.assert_array_equal(gx, np.full((2, 3), r + 1.0))
        a, gx = out["fetch"]
        np.testing.assert_array_equal(a, base + 20)
        if r == 2:
            np.testing.assert_array_equal(gx, np.full((2, 3), 3.0))
        else:
            assert gx is None
        assert out["sum_over"] == 10.0
    assert [tuple(o["coords"].values()) for o in got] == [
        (0, 0, 0, 0, 0), (0, 0, 0, 1, 0), (0, 1, 0, 0, 0), (0, 1, 0, 1, 0)]


# ---------------------------------------------------------------------------
# dropout, remat, the stack's refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rate,shape", [(0.1, (2, 5, 8)), (0.5, (3, 7, 4))])
def test_dropout_masks_are_jax_bit_for_bit(rate, shape):
    key = jax.random.key(11)
    x = np.asarray(jax.random.normal(jax.random.key(2), shape),
                   np.float32)
    want = np.asarray(jcore.dropout(key, jnp.asarray(x), rate, False))
    got = core.dropout(jrandom.PRNGKey(11), t32(x), rate, False).numpy()
    np.testing.assert_array_equal(got, want)
    keep = np.asarray(jax.random.bernoulli(key, 1.0 - rate, shape))
    np.testing.assert_array_equal(
        jrandom.bernoulli(jrandom.PRNGKey(11), 1.0 - rate, shape), keep)
    # bf16, as the models run
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jcore.dropout(key, xb, rate, False).astype(
        jnp.float32))
    got = core.dropout(jrandom.PRNGKey(11), t32(x).bfloat16(), rate,
                       False).float().numpy()
    np.testing.assert_array_equal(got, want)
    assert core.dropout(None, t32(x), rate, True) is not None


def dropout_rank(devices, x, rate):
    """Rank side: dropout of this rank's (rows, positions) shard under a
    2 x 2 data x seq mesh."""
    g = view(dict(dp=2, sp=2), devices)
    d, s = g.index("data"), g.index("seq")
    rows, cols = x.shape[0] // 2, x.shape[1] // 2
    xl = t32(x[d * rows:(d + 1) * rows, s * cols:(s + 1) * cols])
    with sharding.activation_mesh(g):
        y = core.dropout(jrandom.PRNGKey(5), xl, rate, False)
    g.close()
    return d, s, y.numpy()


def test_dropout_over_ranks_is_the_global_mask(world):
    x = np.asarray(jax.random.normal(jax.random.key(3), (4, 6, 8)))
    want = np.asarray(jcore.dropout(jax.random.key(5), jnp.asarray(x), 0.3,
                                    False))
    for d, s, y in on_ranks(world, dropout_rank, CPUS, x, 0.3):
        np.testing.assert_array_equal(y, want[d * 2:(d + 1) * 2,
                                              s * 3:(s + 1) * 3])


def _vit_grads(cfg, params, x, y, rng=None):
    tree = {k: (sharding.tree_map(lambda a: t32(a, True), v)) for k, v in
            params.items()}
    logits = vit.apply(tree, t32(x), cfg, rng, deterministic=rng is None)
    loss = torch.nn.functional.cross_entropy(logits, torch.from_numpy(y))
    leaves = sharding.tree_leaves(tree)
    grads = torch.autograd.grad(loss, leaves)
    return float(loss), [g.numpy() for g in grads]


@pytest.mark.parametrize("remat", ["dots", "full"])
def test_vit_remat_matches_no_remat(remat):
    """remat is a memory knob only: loss and grads as without it (JAX's
    test: rtol 1e-6 on the loss, atol 1e-5 on each gradient), with
    dropout too (the masks drawn again from the same keys)."""
    import dataclasses

    jcfg = jvit.tiny()
    params = jax.tree.map(np.asarray, jvit.init(jax.random.key(0), jcfg))
    x = np.asarray(jax.random.normal(jax.random.key(1), (2, 32, 32, 3)))
    y = np.zeros((2,), np.int64)
    cfg = vit.tiny()
    for dropout, rng in ((0.0, None), (0.1, jrandom.PRNGKey(4))):
        base = dataclasses.replace(cfg, encoder=dataclasses.replace(
            cfg.encoder, dropout=dropout))
        cfg_r = dataclasses.replace(base, encoder=dataclasses.replace(
            base.encoder, remat=remat))
        l0, g0 = _vit_grads(base, params, x, y, rng)
        l1, g1 = _vit_grads(cfg_r, params, x, y, rng)
        np.testing.assert_allclose(l0, l1, rtol=1e-6)
        for a, b in zip(g0, g1):
            np.testing.assert_allclose(a, b, atol=1e-5)


def test_vit_dropout_forward_is_jax():
    """A dropout ViT forward (bf16) from the same key as JAX's: the
    masks of every block equal, so the logits agree as the
    deterministic forward does (test_torch_vit's bound, 2e-2)."""
    import dataclasses

    jcfg = jvit.tiny()
    jcfg = dataclasses.replace(jcfg, encoder=dataclasses.replace(
        jcfg.encoder, dropout=0.2))
    cfg = vit.tiny()
    cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
        cfg.encoder, dropout=0.2))
    params = jax.tree.map(np.asarray, jvit.init(jax.random.key(0), jcfg))
    x = np.asarray(jax.random.normal(jax.random.key(1), (2, 32, 32, 3)))
    want = np.asarray(jvit.apply(params, x, jcfg, jax.random.key(9),
                                 deterministic=False))
    tree = sharding.tree_map(t32, params)
    got = vit.apply(tree, t32(x), cfg, jrandom.PRNGKey(9),
                    deterministic=False).detach().numpy()
    plain = vit.apply(tree, t32(x), cfg).detach().numpy()
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)
    assert np.abs(got - plain).max() > 1e-3  # the masks did something


def _refusal(make_cfg, axes, jax_devices):
    """(JAX's ValueError, the port's) for an LM apply under ``axes``."""
    jcfg, cfg = make_cfg(jlm), make_cfg(lm)
    jmesh = jsharding.make_train_mesh(devices=jax_devices, **axes)
    ids = np.ones((4, 8), np.int32)
    params = jax.tree.map(np.asarray, jlm.init(jax.random.key(0), jcfg))
    with pytest.raises(ValueError) as theirs:
        with jsharding.activation_mesh(jmesh):
            jlm.apply(params, ids, jcfg, jax.random.key(0),
                      deterministic=False)
    n = len(jax_devices)
    mesh = make_train_mesh(devices=["cpu"] * n, **axes)
    view_ = MeshGroups(mesh, 0, torch.device("cpu"), {})
    with pytest.raises(ValueError) as ours:
        with sharding.activation_mesh(view_):
            lm.apply(sharding.tree_map(t32, params), torch.from_numpy(ids),
                     cfg, jrandom.PRNGKey(0), deterministic=False)
    return str(theirs.value), str(ours.value)


@pytest.mark.parametrize("case", ["remat", "moe", "tp", "depth", "dropout",
                                  "microbatches"])
def test_stack_refusals_are_jax(case):
    """The stack's ValueErrors with JAX's messages: an unknown remat,
    GPipe with MoE, with TP, over a depth that does not divide, with
    dropout, over a batch that does not divide into microbatches. The
    port's raise before any collective (its mesh view has no groups)."""
    devs = jax.devices()
    made = {
        "remat": (lambda m: m.tiny(depth=2, remat="bogus"), dict(dp=1),
                  devs[:1]),
        "moe": (lambda m: m.tiny(depth=2, moe_experts=2, pipeline="gpipe"),
                dict(pp=2), devs[:2]),
        "tp": (lambda m: m.tiny(depth=2, pipeline="gpipe"),
               dict(pp=2, tp=2), devs[:4]),
        "depth": (lambda m: m.tiny(depth=3, pipeline="gpipe"), dict(pp=2),
                  devs[:2]),
        "dropout": (lambda m: m.tiny(depth=2, pipeline="gpipe",
                                     dropout=0.1), dict(pp=2), devs[:2]),
        "microbatches": (lambda m: m.tiny(depth=2, pipeline="gpipe",
                                          n_microbatches=3), dict(pp=2),
                         devs[:2]),
    }[case]
    theirs, ours = _refusal(*made)
    assert ours == theirs
