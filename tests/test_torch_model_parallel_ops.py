"""Model-parallel training, the parallel operators: ring attention,
GPipe and the expert-parallel MoE against the JAX package's
(``tests/test_parallel.py``'s cases and more).

The JAX functions run over a mesh of conftest's virtual CPU devices from
one process; the port runs one gloo rank a CPU entry (rank 0 in the test
process, three followers spawned, shared by the module), each holding its
shard (``parallel/sharding.py``). The rank-side functions live here, at
module level: a follower imports this module by name to run them.
Tolerances are stated at each test: f32 paths within 1e-5 of JAX (the
same products in another order, summed over ranks).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from rafiki_tpu.models import core as jcore
from rafiki_tpu.ops.attention import mha_reference as j_mha_reference
from rafiki_tpu.parallel.moe import moe_apply as j_moe_apply
from rafiki_tpu.parallel.moe import moe_init as j_moe_init
from rafiki_tpu.parallel.pipeline import gpipe_apply as j_gpipe_apply
from rafiki_tpu.parallel.ring import ring_attention as j_ring_attention
from rafiki_tpu_torch import convert
from rafiki_tpu_torch.device import set_device_grant
from rafiki_tpu_torch.models import core
from rafiki_tpu_torch.ops.attention import mha_reference
from rafiki_tpu_torch.parallel import collectives as C
from rafiki_tpu_torch.parallel import ranks, sharding
from rafiki_tpu_torch.parallel.collectives import MeshGroups
from rafiki_tpu_torch.parallel.moe import moe_apply
from rafiki_tpu_torch.parallel.pipeline import gpipe_apply
from rafiki_tpu_torch.parallel.ring import ring_attention
from rafiki_tpu_torch.parallel.sharding import make_train_mesh

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
# ring attention
# ---------------------------------------------------------------------------

def ring_rank(devices, q, k, v, causal):
    """Rank side: ring attention over a seq axis of 4 on this rank's
    sequence shard; its output shard and the gradients of sum(out^2)."""
    g = view(dict(sp=4), devices)
    s = g.index("seq")

    def part(a):
        n = a.shape[2] // 4
        return t32(a[:, :, s * n:(s + 1) * n], grad=True)

    ql, kl, vl = part(q), part(k), part(v)
    with sharding.activation_mesh(g):
        out = ring_attention(ql, kl, vl, g, causal=causal)
    (out ** 2).sum().backward()
    g.close()
    return [t.detach().numpy() for t in (out, ql.grad, kl.grad, vl.grad)]


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_reference_and_jax(world, causal):
    """Output and gradients (the JAX test's sum of squares) against the
    port's plain attention and JAX's ring over 4 devices, within 2e-5 (the
    JAX test's bound)."""
    k1, k2, k3 = jax.random.split(jax.random.key(0), 3)
    shape = (2, 2, 32, 16)
    q, k, v = (np.asarray(jax.random.normal(key, shape)) for key in
               (k1, k2, k3))
    parts = on_ranks(world, ring_rank, CPUS, q, k, v, causal)
    out, dq, dk, dv = (np.concatenate([p[i] for p in parts], 2)
                       for i in range(4))
    tq, tk, tv = t32(q, True), t32(k, True), t32(v, True)
    ref = mha_reference(tq, tk, tv, causal=causal)
    (ref ** 2).sum().backward()
    np.testing.assert_allclose(out, ref.detach().numpy(), atol=2e-5,
                               rtol=2e-5)
    for got, want in ((dq, tq.grad), (dk, tk.grad), (dv, tv.grad)):
        np.testing.assert_allclose(got, want.numpy(), atol=1e-4, rtol=1e-4)
    jmesh = JMesh(np.array(jax.devices()[:4]).reshape(1, 4), ("data", "seq"))
    jout = jax.jit(functools.partial(j_ring_attention, mesh=jmesh,
                                     causal=causal))(q, k, v)
    np.testing.assert_allclose(out, np.asarray(jout), atol=2e-5, rtol=2e-5)
    jd = jax.jit(jax.grad(lambda a, b, c: jnp.sum(j_ring_attention(
        a, b, c, jmesh, causal=causal) ** 2), argnums=(0, 1, 2)))(q, k, v)
    for got, want in zip((dq, dk, dv), jd):
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-4,
                                   rtol=1e-4)
    jref = j_mha_reference(q, k, v, causal=causal)
    np.testing.assert_allclose(ref.detach().numpy(), np.asarray(jref),
                               atol=2e-5, rtol=2e-5)


# ---------------------------------------------------------------------------
# GPipe
# ---------------------------------------------------------------------------

def _dense_layers(depth, dim):
    keys = jax.random.split(jax.random.key(0), depth)
    stacked = jcore.stack_layers([jcore.dense_init(k, dim, dim)
                                  for k in keys])
    return jax.tree.map(np.asarray, stacked)


def _tanh_block(layer, x):
    return torch.tanh(core.dense(layer, x))


def gpipe_rank(devices, stages, stacked, x, m):
    """Rank side: ``gpipe_apply`` of tanh-dense layers over ``stages``
    stages (the rest of the ranks on data), this stage's layers; the
    output (its data rows) and the gradients of sum(y^2)."""
    g = view(dict(pp=stages, dp=4 // stages), devices)
    s, d = g.index("pipe"), g.index("data")
    n = stacked["kernel"].shape[0] // stages
    leaves = [t32(stacked[k][s * n:(s + 1) * n], grad=True)
              for k in ("kernel", "bias")]
    rows = x.shape[0] // g.size("data")
    xl = t32(x[d * rows:(d + 1) * rows], grad=True)
    y = gpipe_apply(_tanh_block, leaves,
                    lambda own, j: {"kernel": own[0][j], "bias": own[1][j]},
                    xl, g, m)
    (y ** 2).sum().backward()
    g.close()
    return (s, d, y.detach().numpy(), xl.grad.numpy(),
            [t.grad.numpy() for t in leaves])


@pytest.mark.parametrize("stages,m", [(2, 2), (2, 3), (2, 4), (2, 8),
                                      (4, 2), (4, 3), (4, 4), (4, 8)])
def test_gpipe_matches_sequential(world, stages, m):
    """Forward and gradients against the plain depth loop and JAX's
    ``gpipe_apply`` over the same stages, within 1e-5 (the JAX tests'
    bound); M need not divide by the stages (the JAX queue pads)."""
    depth, dim = 4, 16
    stacked = _dense_layers(depth, dim)
    batch = m * (4 // stages)
    x = np.asarray(jax.random.normal(jax.random.key(m), (batch, dim)))
    got = on_ranks(world, gpipe_rank, CPUS, stages, stacked, x, m)
    # the sequential reference in the port, with its gradients
    leaves = [t32(stacked[k], grad=True) for k in ("kernel", "bias")]
    h = tx = t32(x, grad=True)
    for j in range(depth):
        h = _tanh_block({"kernel": leaves[0][j], "bias": leaves[1][j]}, h)
    (h ** 2).sum().backward()
    rows = batch // (4 // stages)
    n = depth // stages
    for s, d, y, gx, grads in got:
        np.testing.assert_allclose(y, h.detach().numpy()[d * rows:(d + 1)
                                                         * rows],
                                   atol=F32_TOL, rtol=F32_TOL)
        np.testing.assert_allclose(gx, tx.grad.numpy()[d * rows:(d + 1)
                                                       * rows],
                                   atol=F32_TOL, rtol=F32_TOL)
    # the layer gradients summed over the data ranks, stage by stage
    for s in range(stages):
        for i in range(2):
            total = sum(gr[i] for ss, d, _, _, gr in got if ss == s)
            np.testing.assert_allclose(
                total, leaves[i].grad.numpy()[s * n:(s + 1) * n],
                atol=F32_TOL, rtol=F32_TOL)
    jmesh = JMesh(np.array(jax.devices()[:stages]), ("pipe",))
    jy = j_gpipe_apply(lambda layer, a: jnp.tanh(jcore.dense(layer, a)),
                       stacked, x, jmesh, n_microbatches=m)
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(jy),
                               atol=F32_TOL, rtol=F32_TOL)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def _moe_params(dim, hidden, n_exp, seed=0):
    return jax.tree.map(np.asarray,
                        j_moe_init(jax.random.key(seed), dim, hidden, n_exp))


def test_moe_single_expert_equals_dense_and_jax():
    dim, hidden = 8, 16
    params = _moe_params(dim, hidden, 1)
    x = np.asarray(jax.random.normal(jax.random.key(1), (2, 4, dim)))
    y, aux = moe_apply({k: t32(v) for k, v in params.items()}, t32(x), 1.0)
    # with one expert the gate is 1 and MoE reduces to its dense FFN
    xt = t32(x).reshape(-1, dim)
    href = core.gelu(xt @ t32(params["w1"][0]) + t32(params["b1"][0]))
    yref = (href @ t32(params["w2"][0]) + t32(params["b2"][0])).reshape(
        x.shape)
    np.testing.assert_allclose(y.numpy(), yref.numpy(), atol=F32_TOL,
                               rtol=F32_TOL)
    assert abs(float(aux) - 1.0) < F32_TOL
    jy, jaux = j_moe_apply(params, x, capacity_factor=1.0)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=F32_TOL,
                               rtol=F32_TOL)


def test_moe_capacity_drops_overflow_as_jax():
    dim, hidden, n_exp = 4, 8, 2
    params = _moe_params(dim, hidden, n_exp)
    # positive inputs + this router force every token to expert 0
    params["router"] = np.array([[10.0, -10.0]] * dim, np.float32)
    x = np.abs(np.asarray(jax.random.normal(jax.random.key(1),
                                            (1, 8, dim)))) + 0.1
    y, aux = moe_apply({k: t32(v) for k, v in params.items()}, t32(x), 0.5)
    n_nonzero = int((y[0].abs() > 1e-9).any(-1).sum())
    assert n_nonzero == 2  # capacity 2 of 8
    jy, jaux = j_moe_apply(params, x, capacity_factor=0.5)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=F32_TOL,
                               rtol=F32_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=F32_TOL)


def moe_rank(devices, axes, params, x, cf):
    """Rank side: ``moe_apply`` on this rank's (rows, positions) shard
    under ``axes``, its experts' part of the parameters; the output
    shard, the total loss, and the gradients of sum(y^2)/2 + aux."""
    g = view(axes, devices)
    specs = {k: v for k, v in moe_partition_specs().items()}
    local = {k: t32(v, grad=True) for k, v in convert.shard_tree(
        params, specs, g.mesh, g.rank).items()}
    rows = x.shape[0] // g.size("data")
    cols = x.shape[1] // g.size("seq")
    d, s = g.index("data"), g.index("seq")
    xl = t32(x[d * rows:(d + 1) * rows, s * cols:(s + 1) * cols], grad=True)
    with sharding.activation_mesh(g):
        y, aux = moe_apply(local, xl, cf)
        loss = sharding.mean_share((y.float() ** 2).sum(-1) / 2) + aux
    loss.backward()
    grads = {k: v.grad for k, v in local.items()}
    # each gradient is this rank's share over data and seq
    whole = convert.gather_tree(
        {k: C.sum_over(v, g, sharding.GRAD_AXES) for k, v in grads.items()},
        specs, g)
    total = float(C.sum_over(loss.detach().reshape(1), g,
                             sharding.GRAD_AXES)[0])
    g.close()
    return (d, s, y.detach().numpy(), total, xl.grad.numpy(), whole)


def moe_partition_specs():
    from rafiki_tpu_torch.parallel.moe import moe_partition_specs as specs

    return specs()


@pytest.mark.parametrize("axes", [dict(ep=2, dp=2), dict(ep=2, sp=2),
                                  dict(ep=4), dict(dp=2, sp=2)])
def test_moe_over_ranks_matches_jax(world, axes):
    """The experts split over ``expert`` and the tokens over data and seq
    give JAX's global routing: each token's queue position over the
    whole batch, the global capacity (some tokens dropped at 1.0), the
    global aux loss; outputs and gradients within 1e-5."""
    dim, hidden, n_exp = 8, 16, 4
    params = _moe_params(dim, hidden, n_exp, seed=3)
    x = np.asarray(jax.random.normal(jax.random.key(4), (4, 8, dim)))
    got = on_ranks(world, moe_rank, CPUS, axes, params, x, 1.0)

    def jloss(p, xx):
        y, aux = j_moe_apply(p, xx, capacity_factor=1.0)
        return jnp.mean(jnp.sum(y ** 2, -1) / 2) + aux, y

    (jl, jy), (jg, jgx) = jax.value_and_grad(jloss, argnums=(0, 1),
                                             has_aux=True)(params, x)
    jy, jgx = np.asarray(jy), np.asarray(jgx)
    dp, sp = axes.get("dp", 1), axes.get("sp", 1)
    rows, cols = x.shape[0] // dp, x.shape[1] // sp
    dropped = np.all(jy == 0, -1).sum()
    assert 0 < dropped < x.shape[0] * x.shape[1] / 2
    for d, s, y, total, gx, whole in got:
        index = np.s_[d * rows:(d + 1) * rows, s * cols:(s + 1) * cols]
        np.testing.assert_allclose(y, jy[index], atol=F32_TOL, rtol=F32_TOL)
        np.testing.assert_allclose(gx, jgx[index], atol=F32_TOL,
                                   rtol=F32_TOL)
        np.testing.assert_allclose(total, float(jl), rtol=F32_TOL)
        for k in params:
            np.testing.assert_allclose(whole[k], np.asarray(jg[k]),
                                       atol=F32_TOL, rtol=1e-4, err_msg=k)
