"""The Progressive GAN of the port against the JAX package's.

Every case feeds the same seeded numpy inputs to ``rafiki_tpu.models.
pggan`` and ``rafiki_tpu_torch.models.pggan`` (resolution 16, latent 16,
``fmap_base`` 64, ``fmap_max`` 32, f32 compute, as ``tests/test_pggan.py``
runs the JAX module), with the tolerance stated at each:

- ``utils/jrandom.py`` against ``jax.random``: keys, splits and uniforms
  bit for bit, normals within 1 ulp;
- the primitive layers, ``minibatch_stddev`` (batches divisible by the
  group size and not), ``stage_weights`` and ``training_schedule``;
- ``g_apply``/``d_apply`` at lod 2, 1.3 and 0, with and without ACGAN
  labels, and the ``max_stage`` bound;
- ``d_loss_fn`` (the penalty's double backward) and ``g_loss_fn``: values
  and gradients, per leaf;
- Adam(0, 0.99) against optax: steps, a reset, a dormant leaf;
- a 2-tick ``PgganTrainer.train`` against JAX's (the same draws), and
  ``generate``;
- the trainer over 2 gloo ranks against one rank (``minibatch_stddev``
  over the global batch, through the penalty's double backward);
- ``convert.py``'s round trips;
- ``TorchProGan``: ``test_model_class``, serving ``JaxProGan``'s dump,
  and a 2-trial ``IMAGE_GENERATION`` job through the port's admin.

The rank-side function lives here, at module level: a follower imports
this module by name to run it.
"""

import dataclasses
import importlib.util
import math
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rafiki_tpu.models import pggan as jpggan
from rafiki_tpu_torch import config
from rafiki_tpu_torch.admin.admin import Admin
from rafiki_tpu_torch.admin.http import AdminServer
from rafiki_tpu_torch.client.client import Client
from rafiki_tpu_torch.convert import from_jax_tree, to_jax_tree
from rafiki_tpu_torch.db.database import Database
from rafiki_tpu_torch.device import set_device_grant
from rafiki_tpu_torch.models import pggan
from rafiki_tpu_torch.parallel import ranks
from rafiki_tpu_torch.placement.manager import (
    ChipAllocator,
    LocalPlacementManager,
)
from rafiki_tpu_torch.sdk import model as sdk_model
from rafiki_tpu_torch.sdk import params as sdk_params
from rafiki_tpu_torch.sdk.dataset import write_numpy_dataset
from rafiki_tpu_torch.utils import jrandom

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(resolution=16, latent_size=16, fmap_base=64, fmap_max=32)
JCFG = jpggan.PgganConfig(**SMALL, compute_dtype=jnp.float32)
TCFG = pggan.PgganConfig(**SMALL, compute_dtype=torch.float32)
#: f32 forwards: the same ops in another order
FWD_ATOL = 1e-5
#: losses and gradients (relative L2 per leaf)
GRAD_RTOL = 1e-4
#: parameters after a trainer's steps: Adam at b1=0 moves a weight by
#: about lr a step whatever the gradient's size, so f32 rounding that
#: flips a tiny gradient's sign moves it by up to 2 lr (2e-3); the rest
#: agree to f32 rounding. Held: the max over leaves of the mean absolute
#: difference, and the largest single difference
PARAM_MEAN_ATOL = 1e-5
PARAM_MAX_ATOL = 2e-3 + 1e-5
DIST_TIMEOUT_S = 120

# the JAX functions, compiled once a (config, max_stage)
_j_g_apply = jax.jit(jpggan.g_apply, static_argnums=(4, 5))
_j_d_apply = jax.jit(jpggan.d_apply, static_argnums=(3, 4))
_j_d_loss = jax.jit(jax.value_and_grad(jpggan.d_loss_fn, has_aux=True),
                    static_argnums=(7, 8))
_j_g_loss = jax.jit(jax.value_and_grad(jpggan.g_loss_fn),
                    static_argnums=(5, 6))


def _jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _models(seed=0, cfg=TCFG, jcfg=JCFG):
    """The JAX trees from ``g_init``/``d_init`` and the port's modules
    holding them (the port draws the same trees itself)."""
    kg, kd = jax.random.split(jax.random.PRNGKey(seed))
    jg, jd = jpggan.g_init(kg, jcfg), jpggan.d_init(kd, jcfg)
    g = from_jax_tree(_meta(pggan.Generator, cfg), jax.tree.map(np.asarray, jg),
                      device="cpu", train=True)
    d = from_jax_tree(_meta(pggan.Discriminator, cfg),
                      jax.tree.map(np.asarray, jd), device="cpu", train=True)
    return jg, jd, g, d


def _meta(make, *args):
    """``make(*args)`` on the meta device (``from_jax_tree`` fills it)."""
    with torch.device("meta"):
        return make(*args)


def _flat(tree):
    return sdk_params.flatten(jax.tree.map(np.asarray, tree))


def _grad_tree(model):
    """A module's ``.grad``s in the JAX layout."""
    out = {}
    for name, p in model.named_parameters():
        g = p.grad
        out[name.replace(".", "/")] = (g.permute(2, 3, 1, 0) if g.dim() == 4
                                       else g).numpy()
    return out


def _assert_rel_l2(got: dict, ref: dict, rtol: float, what: str,
                   floor: float = 0.0):
    """Each leaf's L2 distance over its reference's norm (at least
    ``floor``: a leaf whose terms cancel has a tiny norm)."""
    assert set(got) == set(ref), what
    for k, r in ref.items():
        num = np.linalg.norm(np.asarray(got[k], np.float64) - r)
        den = max(np.linalg.norm(np.asarray(r, np.float64)), floor)
        err = num / den if den > 0 else num
        assert err <= rtol, f"{what} {k}: rel L2 {err:.3g} > {rtol:g}"


# ---------------------------------------------------------------------------
# the draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 123, 2**31 + 5])
def test_jrandom_matches_jax_random(seed):
    key, jkey = jrandom.PRNGKey(seed), jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(key, np.asarray(jkey))
    for num in (2, 5):
        np.testing.assert_array_equal(jrandom.split(key, num),
                                      np.asarray(jax.random.split(jkey, num)))
    for shape in [(16, 1, 1, 1), (3, 5), ()]:
        u = jrandom.uniform(key, shape)
        np.testing.assert_array_equal(u, np.asarray(jax.random.uniform(
            jkey, shape)))
        assert u.dtype == np.float32 and u.shape == shape
    n = jrandom.normal(key, (64, 128))
    ref = np.asarray(jax.random.normal(jkey, (64, 128)))
    ulps = np.abs(n.view(np.int32).astype(np.int64)
                  - ref.view(np.int32).astype(np.int64))
    assert n.dtype == np.float32 and ulps.max() <= 1


# ---------------------------------------------------------------------------
# the primitive layers
# ---------------------------------------------------------------------------

def test_primitive_layers_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 8, 8, 6)).astype(np.float32)
    for k, gain in [(1, 1.0), (3, math.sqrt(2.0))]:
        jp = {"w": rng.normal(size=(k, k, 6, 5)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32)}
        conv = from_jax_tree(_meta(pggan.EqConv, k, 6, 5),
                             jp, device="cpu")
        np.testing.assert_allclose(
            pggan.eq_conv(conv, torch.from_numpy(x), gain).detach().numpy(),
            np.asarray(jpggan.eq_conv(_jtree(jp), jnp.asarray(x), gain)),
            atol=FWD_ATOL, rtol=0)
    jp = {"w": rng.normal(size=(6, 7)).astype(np.float32),
          "b": rng.normal(size=(7,)).astype(np.float32)}
    dense = from_jax_tree(_meta(pggan.EqDense, 6, 7), jp,
                          device="cpu")
    np.testing.assert_allclose(
        pggan.eq_dense(dense, torch.from_numpy(x), 0.5).detach().numpy(),
        np.asarray(jpggan.eq_dense(_jtree(jp), jnp.asarray(x), 0.5)),
        atol=FWD_ATOL, rtol=0)
    t, j = torch.from_numpy(x), jnp.asarray(x)
    for ours, theirs in [(pggan.pixel_norm, jpggan.pixel_norm),
                         (pggan.upscale2d, jpggan.upscale2d),
                         (pggan.downscale2d, jpggan.downscale2d)]:
        np.testing.assert_allclose(ours(t).numpy(), np.asarray(theirs(j)),
                                   atol=FWD_ATOL, rtol=0)


@pytest.mark.parametrize("n", [8, 6, 5, 3, 1])
def test_minibatch_stddev_matches_jax(n):
    """The group is the largest divisor of n up to 4, taken across the
    batch (samples j, j + n/g, ...)."""
    x = np.random.default_rng(n).normal(size=(n, 4, 4, 3)).astype(np.float32)
    got = pggan.minibatch_stddev(torch.from_numpy(x), 4).numpy()
    ref = np.asarray(jpggan.minibatch_stddev(jnp.asarray(x), 4))
    assert got.shape == (n, 4, 4, 4)
    np.testing.assert_allclose(got, ref, atol=FWD_ATOL, rtol=0)


def test_stage_weights_match_jax():
    for lod in np.linspace(0.0, 3.0, 31, dtype=np.float32):
        np.testing.assert_array_equal(
            pggan.stage_weights(float(lod), 4),
            np.asarray(jpggan.stage_weights(jnp.float32(lod), 4)))


def test_training_schedule_matches_jax_exactly():
    for res in (16, 32):
        jc = dataclasses.replace(JCFG, resolution=res)
        tc = dataclasses.replace(TCFG, resolution=res)
        for nimg in range(0, 9000, 137):
            for kw in [dict(lod_training_kimg=1.0, lod_transition_kimg=1.0),
                       dict(lod_training_kimg=0.5, lod_transition_kimg=0.25,
                            lod_initial_resolution=8, minibatch_base=8,
                            minibatch_dict={8: 4})]:
                assert dataclasses.asdict(pggan.training_schedule(
                    nimg, tc, **kw)) == dataclasses.asdict(
                        jpggan.training_schedule(nimg, jc, **kw))


# ---------------------------------------------------------------------------
# the networks and the losses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("label_size", [0, 5])
@pytest.mark.parametrize("lod", [2.0, 1.3, 0.0])
def test_g_and_d_apply_match_jax(lod, label_size):
    tc = dataclasses.replace(TCFG, label_size=label_size)
    jc = dataclasses.replace(JCFG, label_size=label_size)
    jg, jd, g, d = _models(1, tc, jc)
    rng = np.random.default_rng(2)
    z = rng.normal(size=(6, 16)).astype(np.float32)
    labels = (np.eye(5, dtype=np.float32)[rng.integers(0, 5, 6)]
              if label_size else None)
    imgs = rng.uniform(-1, 1, size=(6, 16, 16, 3)).astype(np.float32)
    with torch.no_grad():
        got = pggan.g_apply(
            g, torch.from_numpy(z),
            None if labels is None else torch.from_numpy(labels), lod, tc)
        scores, logits = pggan.d_apply(d, torch.from_numpy(imgs), lod, tc)
    ref = _j_g_apply(jg, jnp.asarray(z),
                     None if labels is None else jnp.asarray(labels),
                     jnp.float32(lod), jc, None)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=FWD_ATOL,
                               rtol=0)
    rs, rl = _j_d_apply(jd, jnp.asarray(imgs), jnp.float32(lod), jc, None)
    np.testing.assert_allclose(scores.numpy(), np.asarray(rs),
                               atol=FWD_ATOL, rtol=0)
    if label_size:
        np.testing.assert_allclose(logits.numpy(), np.asarray(rl),
                                   atol=FWD_ATOL, rtol=0)
    else:
        assert logits is None and rl is None


def test_max_stage_bounds_the_computation_as_jax():
    jg, jd, g, d = _models(2)
    rng = np.random.default_rng(3)
    z = rng.normal(size=(4, 16)).astype(np.float32)
    imgs = rng.uniform(-1, 1, size=(4, 16, 16, 3)).astype(np.float32)
    lod = 1.5  # stages 0 and 1 active
    with torch.no_grad():
        full = pggan.g_apply(g, torch.from_numpy(z), None, lod, TCFG)
        bounded = pggan.g_apply(g, torch.from_numpy(z), None, lod, TCFG, 1)
        d_full, _ = pggan.d_apply(d, torch.from_numpy(imgs), lod, TCFG)
        d_bounded, _ = pggan.d_apply(d, torch.from_numpy(imgs), lod, TCFG, 1)
    np.testing.assert_allclose(bounded.numpy(), full.numpy(),
                               atol=FWD_ATOL, rtol=0)
    np.testing.assert_allclose(d_bounded.numpy(), d_full.numpy(),
                               atol=FWD_ATOL, rtol=0)
    ref = _j_g_apply(jg, jnp.asarray(z), None, jnp.float32(lod), JCFG, 1)
    np.testing.assert_allclose(bounded.numpy(), np.asarray(ref),
                               atol=FWD_ATOL, rtol=0)
    ref, _ = _j_d_apply(jd, jnp.asarray(imgs), jnp.float32(lod), JCFG, 1)
    np.testing.assert_allclose(d_bounded.numpy(), np.asarray(ref),
                               atol=FWD_ATOL, rtol=0)


@pytest.mark.parametrize("lod,max_stage,label_size", [
    (1.3, 1, 0), (2.0, 1, 0), (0.7, 2, 5), (0.0, 2, 0)])
def test_losses_and_gradients_match_jax(lod, max_stage, label_size):
    """The critic's loss with the penalty's double backward, and G's, each
    with ``jax.value_and_grad``'s gradients per leaf (1e-4 relative L2).
    At (2.0, 1) the stage-1 weight is 0: its leaves see only the
    penalty's second-order terms; above ``max_stage`` a stage's leaves
    get zeros."""
    tc = dataclasses.replace(TCFG, label_size=label_size)
    jc = dataclasses.replace(JCFG, label_size=label_size)
    jg, jd, g, d = _models(3, tc, jc)
    rng = np.random.default_rng(4)
    n = 8
    z = rng.normal(size=(n, 16)).astype(np.float32)
    reals = rng.uniform(-1, 1, size=(n, 16, 16, 3)).astype(np.float32)
    labels = (np.eye(5, dtype=np.float32)[rng.integers(0, 5, n)]
              if label_size else None)
    jl = None if labels is None else jnp.asarray(labels)
    tl = None if labels is None else torch.from_numpy(labels)
    key = jax.random.PRNGKey(9)

    (jloss, jaux), jgrads = _j_d_loss(
        jd, jg, jnp.asarray(reals), jnp.asarray(z), jl, jnp.float32(lod),
        key, jc, max_stage)
    eps = torch.from_numpy(jrandom.uniform(jrandom.PRNGKey(9), (n, 1, 1, 1)))
    loss, aux = pggan.d_loss_fn(d, g, torch.from_numpy(reals),
                                torch.from_numpy(z), tl, lod, eps, tc,
                                max_stage)
    pggan._grads_of(loss, list(d.parameters()), None)
    assert all(p.grad is None for p in g.parameters())
    for got, ref in [(loss.detach(), jloss), (aux["wdist"], jaux["wdist"]),
                     (aux["gp_norm"], jaux["gp_norm"])]:
        assert float(got) == pytest.approx(float(ref), rel=GRAD_RTOL,
                                           abs=1e-6)
    _assert_rel_l2(_grad_tree(d), _flat(jgrads), GRAD_RTOL, "d_loss grad")

    jloss, jgrads = _j_g_loss(
        jg, jd, jnp.asarray(z), jl, jnp.float32(lod), jc, max_stage)
    loss = pggan.g_loss_fn(g, d, torch.from_numpy(z), tl, lod, tc,
                           max_stage)
    pggan._grads_of(loss, list(g.parameters()), None)
    assert float(loss) == pytest.approx(float(jloss), rel=GRAD_RTOL,
                                        abs=1e-6)
    _assert_rel_l2(_grad_tree(g), _flat(jgrads), GRAD_RTOL, "g_loss grad")


def test_adam_matches_optax_with_dormant_leaves_and_a_reset():
    """optax keeps one step count and gives an untouched leaf a zero
    gradient: a stage that wakes later is bias-corrected by the global
    count. The reset clears the counts with the moments."""
    trainer = pggan.PgganTrainer(TCFG, device="cpu")
    trainer.init_optimizers(2e-3, 1e-3)
    opt = optax.adam(1e-3, b1=0.0, b2=0.99, eps=1e-8)
    update = jax.jit(opt.update)
    tree = jax.tree.map(jnp.asarray, to_jax_tree(trainer.d)[0])
    state = opt.init(tree)
    rng = np.random.default_rng(5)
    dormant = "fromrgb/2/"
    for step in range(4):
        if step == 2:
            trainer.reset_optimizer_state()
            state = opt.init(tree)
        grads = {}
        for name, p in trainer.d.named_parameters():
            path = name.replace(".", "/")
            g = rng.normal(size=tuple(p.shape)).astype(np.float32)
            if step == 0 and path.startswith(dormant):
                g[:] = 0.0
            grads[path] = g
            p.grad = torch.from_numpy(g)
        trainer._opt["d"].step()
        jgrads = {}
        for name, p in trainer.d.named_parameters():
            g = grads[name.replace(".", "/")]
            jgrads[name.replace(".", "/")] = (g.transpose(2, 3, 1, 0)
                                              if g.ndim == 4 else g)
        jgrads = sdk_params.unflatten(jgrads)
        jgrads = _as_lists(jgrads)
        updates, state = update(_jtree(jgrads), state, tree)
        tree = optax.apply_updates(tree, updates)
        got = sdk_params.flatten(to_jax_tree(trainer.d)[0])
        for k, ref in _flat(tree).items():
            np.testing.assert_allclose(got[k], ref, atol=1e-6, rtol=1e-6,
                                       err_msg=f"step {step} {k}")
    assert {int(s["step"]) for s in trainer._opt["d"].state.values()} == {2}


def _as_lists(tree):
    if not isinstance(tree, dict):
        return tree
    out = {k: _as_lists(v) for k, v in tree.items()}
    if out and all(k.isdigit() for k in out):
        return [out[str(i)] for i in range(len(out))]
    return out


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

TRAIN_KW = dict(total_kimg=0.032, minibatch_base=8, minibatch_repeats=2,
                D_repeats=1, lod_training_kimg=0.008,
                lod_transition_kimg=0.016)


def test_trainer_two_ticks_match_jax():
    """Tick 1 at lod 2 (4x4), tick 2 at lod 1.5 (two stages blended,
    Adam reset at the lod change): the metrics within 1e-4, G, D and Gs
    within PARAM_*_ATOL, ``generate`` within 1e-4, ``last_lod`` equal."""
    images = np.random.default_rng(6).uniform(
        -1, 1, size=(40, 16, 16, 3)).astype(np.float32)
    jt = jpggan.PgganTrainer(JCFG, seed=0)
    tt = pggan.PgganTrainer(TCFG, seed=0, device="cpu")
    jlog, tlog = [], []
    jm = jt.train(images, **TRAIN_KW, log=lambda _m, **kw: jlog.append(kw))
    tm = tt.train(images, **TRAIN_KW, log=lambda _m, **kw: tlog.append(kw))
    assert [r["lod"] for r in jlog] == [r["lod"] for r in tlog] == [2.0, 1.5]
    for got, ref in zip(tlog + [tm], jlog + [jm]):
        assert got.keys() == ref.keys()
        for k in ref:
            assert got[k] == pytest.approx(ref[k], rel=1e-4, abs=1e-4), k
    for ours, theirs in [(tt.g, jt.g_params), (tt.d, jt.d_params),
                         (tt.gs, jt.gs_params)]:
        got = sdk_params.flatten(to_jax_tree(ours)[0])
        for k, ref in _flat(theirs).items():
            diff = np.abs(got[k] - ref)
            assert diff.mean() <= PARAM_MEAN_ATOL, k
            assert diff.max() <= PARAM_MAX_ATOL, k
    assert tt.last_lod == jt.last_lod == 1.5
    np.testing.assert_allclose(tt.generate(5, seed=11),
                               jt.generate(5, seed=11), atol=1e-4, rtol=0)


@pytest.fixture(scope="module")
def world2():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAFIKI_DIST_TIMEOUT_S", str(DIST_TIMEOUT_S))
        mp.setenv("OMP_NUM_THREADS", "1")
        with ranks.Ranks(["cpu:0", "cpu:1"]) as r:
            yield r


def rank_gan_steps(images: np.ndarray, seed: int) -> dict:
    """One D step and one G step of a trainer over this thread's group
    (or alone), at lod 0.7 (stages 1 and 2 blended): the global losses,
    D's gradients before its Adam step, and the parameters after."""
    group = ranks.current_group()
    trainer = pggan.PgganTrainer(TCFG, group=group, seed=seed, device="cpu")
    trainer.init_optimizers(1e-3, 1e-3)
    n = len(images)
    reals = trainer._part(torch.from_numpy(images))
    key, gkey = jrandom.split(jrandom.PRNGKey(seed))
    d_loss, aux = trainer.d_step(reals, None, 0.7, key, n, 2)
    d_grads = _grad_tree(trainer.d)
    g_loss = trainer.g_step(None, 0.7, gkey, n, 2)
    return {"d_loss": trainer._mean(d_loss),
            "gp_norm": trainer._mean(aux["gp_norm"]),
            "g_loss": trainer._mean(g_loss), "d_grads": d_grads,
            "d": sdk_params.flatten(to_jax_tree(trainer.d)[0]),
            "gs": sdk_params.flatten(to_jax_tree(trainer.gs)[0])}


def test_two_ranks_step_equals_one_rank(world2):
    """mb 8 over 2 ranks, mbstd groups of 4 (samples j, j+2, j+4, j+6):
    every group spans both ranks, so the penalty's gradient crosses them
    through the gathered statistic. The group's step is one rank's step
    (losses 1e-5 relative, gradients 1e-5 relative L2 per leaf against at
    least 1e-2, parameters after the Adam steps within 1e-5, 1% of the
    learning rate), and a rank-local statistic would not be."""
    images = np.random.default_rng(7).uniform(
        -1, 1, size=(8, 16, 16, 3)).astype(np.float32)
    set_device_grant(world2.devices)
    ranks.set_group(world2.group)
    try:
        out = world2.run(rank_gan_steps, images, 4)
    finally:
        ranks.set_group(None)
        set_device_grant(None)
    alone = rank_gan_steps(images, 4)
    for r in out:
        for k in ("d_loss", "gp_norm", "g_loss"):
            assert r[k] == pytest.approx(alone[k], rel=1e-5), k
        _assert_rel_l2(r["d_grads"], alone["d_grads"], 1e-5, "d grads",
                       floor=1e-2)
        for part in ("d", "gs"):
            for k, v in alone[part].items():
                np.testing.assert_allclose(r[part][k], v, atol=1e-5,
                                           rtol=0, err_msg=k)
    # the statistic taken on each rank's half alone moves the gradients
    jg, jd, g, d = _models(4)
    halves = []
    for half in (slice(0, 4), slice(4, 8)):
        sub = images[half]
        key = jrandom.split(jrandom.PRNGKey(4))[0]
        zkey, gpkey = jrandom.split(key)
        z = torch.from_numpy(jrandom.normal(zkey, (8, 16))[half])
        eps = torch.from_numpy(jrandom.uniform(gpkey, (8, 1, 1, 1))[half])
        loss, _ = pggan.d_loss_fn(d, g, torch.from_numpy(sub), z, None, 0.7,
                                  eps, TCFG, 2)
        pggan._grads_of(loss, list(d.parameters()), None)
        halves.append(_grad_tree(d))
    local = {k: (halves[0][k] + halves[1][k]) / 2 for k in halves[0]}
    with pytest.raises(AssertionError):
        _assert_rel_l2(local, alone["d_grads"], 1e-3, "rank-local stddev",
                       floor=1e-2)


def test_convert_round_trips_are_exact():
    jg, jd, g, d = _models(5)
    for model, tree in [(g, jg), (d, jd)]:
        back, state = to_jax_tree(model)
        assert state == {}
        ref = _flat(tree)
        got = sdk_params.flatten(back)
        assert got.keys() == ref.keys()
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k])
    # lists by index, kernels HWIO there and OIHW channels_last here
    assert isinstance(to_jax_tree(g)[0]["torgb"], list)
    assert g.torgb[0].w.shape == (3, 32, 1, 1)
    assert g.blocks[1]["conv0"].w.is_contiguous(
        memory_format=torch.channels_last)
    np.testing.assert_array_equal(
        g.blocks[1]["conv0"].w.detach().permute(2, 3, 1, 0).numpy(),
        np.asarray(jg["blocks"][1]["conv0"]["w"]))


# ---------------------------------------------------------------------------
# the template
# ---------------------------------------------------------------------------

def _load_template(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _npz_sets(tmp_path: Path):
    rng = np.random.default_rng(8)
    x = rng.normal(size=(128, 16, 16, 3)).astype(np.float32).clip(-1, 1)
    y = np.zeros(128, np.int32)
    return (write_numpy_dataset(x, y, str(tmp_path / "train.npz")),
            write_numpy_dataset(x[:64], y[:64], str(tmp_path / "test.npz")))


def test_torch_progan_model_class(tmp_path, monkeypatch):
    """The JAX template's own check: 0.2 kimg, 16x16 images, one grid."""
    from rafiki_tpu_torch.templates.torch_progan import TorchProGan

    train_uri, test_uri = _npz_sets(tmp_path)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(TorchProGan, "TOTAL_KIMG", 0.2)
    set_device_grant(["cpu"])
    try:
        preds = sdk_model.test_model_class(
            clazz=TorchProGan, task="IMAGE_GENERATION",
            train_dataset_uri=train_uri, test_dataset_uri=test_uri,
            queries=[[2, 2, 4]])
    finally:
        set_device_grant(None)
    assert preds == [str(tmp_path / "output0.npy")]
    grid = np.load(preds[0])
    assert grid.shape == (32, 32, 3) and grid.dtype == np.uint8


def test_torch_progan_serves_the_jax_templates_parameters(tmp_path,
                                                         monkeypatch):
    """``JaxProGan``'s dump loaded into ``TorchProGan`` writes the same
    ``.npy`` grids (within 1 in uint8) and scores the same (1e-4); both
    templates compute in f32 here (their configs patched), and JAX takes
    its ``.npy`` branch (no PIL)."""
    from rafiki_tpu_torch.templates import torch_progan

    jmod = _load_template(
        ROOT / "examples" / "models" / "image_generation" / "JaxProGan.py",
        "_jax_progan")
    monkeypatch.setattr(jmod, "PgganConfig", lambda **kw: jpggan.PgganConfig(
        **kw, compute_dtype=jnp.float32))
    monkeypatch.setattr(torch_progan, "PgganConfig",
                        lambda **kw: pggan.PgganConfig(
                            **kw, compute_dtype=torch.float32))
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.chdir(tmp_path)
    _, test_uri = _npz_sets(tmp_path)
    knobs = {"D_repeats": 1, "minibatch_base": 8, "G_lrate": 1e-3,
             "D_lrate": 1e-3, "lod_initial_resolution": 4}
    jm = jmod.JaxProGan(**knobs)
    jm._cfg = jpggan.PgganConfig(resolution=16, num_channels=3,
                                 compute_dtype=jnp.float32)
    jm._trainer = jpggan.PgganTrainer(jm._cfg, seed=3)
    jm._trainer.gs_params = jax.tree.map(lambda a: a * 0.9,
                                         jm._trainer.g_params)
    jm._trainer.last_lod = 0.7
    queries = [[2, 2, 4], [3, 1, 2]]
    jpaths = jm.predict(queries)
    jgrids = [np.load(p) for p in jpaths]
    jscore = jm.evaluate(test_uri)
    blob = sdk_params.load_params(sdk_params.dump_params(
        jax.tree.map(lambda a: np.asarray(a) if hasattr(a, "shape") else a,
                     jm.dump_parameters())))
    set_device_grant(["cpu"])
    try:
        tm = torch_progan.TorchProGan(**knobs)
        tm.load_parameters(blob)
        tpaths = tm.predict(queries)
        tscore = tm.evaluate(test_uri)
    finally:
        set_device_grant(None)
    assert tpaths == jpaths
    assert tm._trainer.last_lod == 0.7
    for got, ref in zip([np.load(p) for p in tpaths], jgrids):
        assert got.shape == ref.shape and got.dtype == np.uint8
        assert np.abs(got.astype(int) - ref).max() <= 1
    assert tscore == pytest.approx(jscore, rel=1e-4)


#: the template narrowed (latent 16, 32 feature maps), with minibatch 4
#: and one D step a G step: 0.06 kimg is then 4 ticks, and the lod falls
#: below 2 within them
NARROW = dict(latent_size=16, fmap_base=64, fmap_max=32)
_NARROW_IMPORT = (
    "from rafiki_tpu_torch.models.pggan import PgganConfig, PgganTrainer, "
    "build\n",
    "import functools\n"
    "from rafiki_tpu_torch.models.pggan import PgganTrainer, build\n"
    "from rafiki_tpu_torch.models import pggan as _pggan\n"
    "PgganConfig = functools.partial(_pggan.PgganConfig, latent_size=16, "
    "fmap_base=64, fmap_max=32)\n")
TINY_PROGAN = """

class TinyProGan(TorchProGan):
    @staticmethod
    def get_knob_config():
        knobs = TorchProGan.get_knob_config()
        knobs.update(D_repeats=FixedKnob(1), minibatch_base=FixedKnob(4))
        return knobs
"""


def test_image_generation_through_the_admin(tmp_path, monkeypatch):
    """A 2-trial ``TorchProGan`` job (narrowed, 0.06 kimg each, growing
    from 4x4 on 16x16 images) through ``Client`` on the CPU, served: the grids of
    ``/predict`` are a trial's own ``generate`` at seeds 1000 + i."""
    from rafiki_tpu_torch.templates import torch_progan

    monkeypatch.setenv("TORCHPROGAN_TOTAL_KIMG", "0.06")
    monkeypatch.setenv("TORCHPROGAN_PHASE_KIMG", "0.02")
    monkeypatch.chdir(tmp_path)
    train_uri, test_uri = _npz_sets(tmp_path)
    admin = Admin(db=Database(str(tmp_path / "store.sqlite3")),
                  placement=LocalPlacementManager(ChipAllocator(["cpu"])),
                  params_dir=str(tmp_path / "params"))
    srv = AdminServer(admin, port=0).start()
    try:
        c = Client("127.0.0.1", srv.port, timeout_s=300)
        c.login(config.SUPERADMIN_EMAIL, config.SUPERADMIN_PASSWORD)
        source = (ROOT / "rafiki_tpu_torch" / "templates"
                  / "torch_progan.py").read_text()
        assert source.count(_NARROW_IMPORT[0]) == 1
        source = source.replace(*_NARROW_IMPORT) + TINY_PROGAN
        model = c.create_model("progan", "IMAGE_GENERATION",
                               source.encode(), "TinyProGan")
        assert model["verification"]["ok"]
        c.create_train_job("gan", "IMAGE_GENERATION", train_uri, test_uri,
                           budget={"MODEL_TRIAL_COUNT": 2, "CHIP_COUNT": 1})
        job = c.wait_until_train_job_stopped("gan", timeout_s=300)
        assert job["status"] == "STOPPED", job
        trials = c.get_trials_of_train_job("gan")
        assert [t["status"] for t in trials] == ["COMPLETED"] * 2, trials
        for t in trials:
            assert 0.0 < t["score"] <= 1.0
            lods = [m["lod"] for m in c.get_trial_logs(t["id"])["metrics"]
                    if "lod" in m]
            assert lods[0] == 2.0 and lods[-1] < 2.0
        blobs = [sdk_params.load_params(c.download_trial_params(t["id"]))
                 for t in trials]
        inf = c.create_inference_job("gan")
        assert inf["status"] == "RUNNING"
        paths = c.predict("gan", [[2, 2, 4], [1, 1, 1]])
        c.stop_inference_job("gan")
    finally:
        srv.stop()
        admin.shutdown()
    grids = [np.load(p) for p in paths]
    assert [g.shape for g in grids] == [(32, 32, 3), (16, 16, 3)]
    monkeypatch.setattr(torch_progan, "PgganConfig",
                        lambda **kw: pggan.PgganConfig(**kw, **NARROW))
    set_device_grant(["cpu"])
    try:
        refs = []
        for blob in blobs:
            m = torch_progan.TorchProGan(**trials[0]["knobs"])
            m.load_parameters(blob)
            refs.append([torch_progan._to_grid(
                m._trainer.generate(min(q[2], q[0] * q[1]), seed=1000 + i),
                q[0], q[1]) for i, q in enumerate([[2, 2, 4], [1, 1, 1]])])
    finally:
        set_device_grant(None)
    # the ensemble answers with the first worker's paths; both workers
    # write the same names in one working directory (the JAX template's
    # behaviour), so each file holds one of the two trials' grid
    for i, grid in enumerate(grids):
        assert any(np.array_equal(grid, ref[i]) for ref in refs), i
