"""Several devices: the port's data group against the JAX package's mesh.

The JAX trainer runs over a mesh from one process; the port runs one
process a device, gloo ranks here on CPU entries (``parallel/ranks.py``),
rank 0 in the test's process and the followers spawned. Held here:

- ``MeshSpec.resolve``: the same shapes and errors as JAX's;
- world 2: a tiny-ViT ``fit`` of 8 steps against JAX's
  ``DataParallelTrainer.fit`` on a 2-device slice of the 8-CPU mesh of
  ``tests/conftest.py`` (same numpy weights, data and seed; the steps
  and tolerance of ``tests/test_torch_train.py``'s fit: at 3 steps JAX's
  own fits over 1, 2 and 8 devices already differ by 0.8 x its per-weight
  bound), and against the
  port's own world-1 fit over the same global batch;
- world 2: a narrow ResNet's parameters and running statistics against
  JAX's after 2 steps (BatchNorm over the global batch);
- worlds 2 and 4: ``predict_batched`` at 1, 7 and 33 rows against world 1;
- world 2: a checkpointed fit resumes from rank 0's file;
- a follower's exception is raised on rank 0 as itself; a SIGKILLed one
  is an INFRA fault, fast; one that exits before the group forms ends
  ``Ranks(...)`` with an INFRA fault in seconds, not at the timeout;
- the stack: ``CHIPS_PER_TRIAL`` and ``CHIPS_PER_WORKER`` deploy as the
  JAX package's do (``tests/test_stack.py``), a trial trains over its
  grant's ranks, a several-rank worker serves one rank's answers, a
  killed follower's trial is a fault row and the worker goes on,
  generation across cards is refused typed, and a fused ensemble over 2
  ranks answers as over one.

The rank-side functions live here, at module level: a follower imports
this module by name to run them.
"""

import os
import re
import signal
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rafiki_tpu.models import resnet as jresnet
from rafiki_tpu.models import vit as jvit
from rafiki_tpu.parallel import mesh as jmesh
from rafiki_tpu.sdk import jax_backend
from rafiki_tpu_torch import config, convert
from rafiki_tpu_torch.admin.admin import Admin, InvalidRequestError
from rafiki_tpu_torch.constants import TrialStatus
from rafiki_tpu_torch.db.database import Database
from rafiki_tpu_torch.device import set_device_grant
from rafiki_tpu_torch.models import resnet, vit
from rafiki_tpu_torch.parallel import mesh, ranks
from rafiki_tpu_torch.placement.manager import (
    ChipAllocator,
    LocalPlacementManager,
)
from rafiki_tpu_torch.sdk import torch_backend
from rafiki_tpu_torch.sdk.log import ModelLogger
from rafiki_tpu_torch.sdk.model import load_model_class
from rafiki_tpu_torch.worker.faults import FaultKind, TrialFault

CPUS = ["cpu:0", "cpu:1", "cpu:2", "cpu:3"]
LR = 1e-3
#: the group's timeout in these tests: every collective and reply wait is
#: bounded by it. A follower imports this module (and JAX with it) at its
#: first call while rank 0 waits in a collective, which takes some seconds
#: alone and several times that under the whole suite's load
DIST_TIMEOUT_S = 120


@pytest.fixture(autouse=True, scope="module")
def _ranks_env():
    """The group's timeout, and one torch thread in each follower: the
    suite runs these ranks beside other tests' processes."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAFIKI_DIST_TIMEOUT_S", str(DIST_TIMEOUT_S))
        mp.setenv("OMP_NUM_THREADS", "1")
        yield


@pytest.fixture(scope="module")
def world2():
    """Rank 0 here, rank 1 a spawned process, for the module's tests."""
    with ranks.Ranks(CPUS[:2]) as r:
        yield r


def _on_ranks(r, fn, *args):
    """``fn(*args)`` on every rank of ``r``, rank 0 in this thread (on
    the grant's first entry, as a worker's thread is)."""
    set_device_grant(r.devices)
    ranks.set_group(r.group)
    try:
        return r.run(fn, *args)
    finally:
        ranks.set_group(None)
        set_device_grant(None)


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

MESH_CASES = [
    ({"data": -1}, 8), ({"data": -1}, 1), ({"data": -1, "model": 2}, 8),
    ({"data": 2, "model": -1}, 8), ({"data": 4}, 4), ({"data": 3}, 8),
    ({"data": -1, "model": 3}, 8), ({"data": -1, "model": -1}, 8),
    ({"data": 2, "model": 2}, 8),
]


@pytest.mark.parametrize("axes,n", MESH_CASES)
def test_mesh_spec_resolves_as_jax(axes, n):
    def outcome(spec_cls):
        try:
            return spec_cls(dict(axes)).resolve(n)
        except ValueError as e:
            return ("ValueError", str(e))

    ours, theirs = outcome(mesh.MeshSpec), outcome(jmesh.MeshSpec)
    assert ours == theirs
    if isinstance(ours, dict):
        assert list(ours) == list(axes)


def test_make_mesh_is_the_data_axis_over_the_grant():
    """The default mesh is the data axis over the grant; a model axis is
    taken too (model parallelism, ``parallel/sharding.py``), the ranks
    laid out as JAX lays out its devices."""
    m = mesh.make_mesh(devices=CPUS)
    assert m.shape == {"data": 4} and m.size == 4
    assert [str(d) for d in m.devices] == CPUS
    m = mesh.make_mesh(mesh.MeshSpec({"data": -1, "model": 2}),
                       devices=CPUS)
    jm = jmesh.make_mesh(jmesh.MeshSpec({"data": -1, "model": 2}),
                         devices=jax.devices()[:4])
    assert m.shape == dict(jm.shape) == {"data": 2, "model": 2}
    ids = [d.id for d in jax.devices()[:4]]
    for rank in range(4):
        at = np.argwhere(np.vectorize(lambda d: d.id)(jm.devices)
                         == ids[rank])[0]
        assert tuple(m.coords(rank).values()) == tuple(at)
    assert m.line("model", 2) == (2, 3) and m.line("data", 1) == (1, 3)


# ---------------------------------------------------------------------------
# fit: the tiny ViT against JAX's 2-device mesh and the port's world 1
# ---------------------------------------------------------------------------

VIT_N, VIT_BATCH, VIT_EPOCHS = 64, 16, 2
VIT_STEPS = VIT_EPOCHS * VIT_N // VIT_BATCH  # 8, as tests/test_torch_train.py


def _vit_cfgs():
    kw = dict(dim=32, depth=2, heads=2)
    return vit.tiny(**kw), jvit.tiny(**kw)


def _vit_problem():
    cfg, _ = _vit_cfgs()
    tree = vit.init(np.random.default_rng(0), cfg)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((VIT_N, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, cfg.num_classes, VIT_N).astype(np.int32)
    return tree, x, y


def _vit_trainer():
    return torch_backend.DataParallelTrainer(
        torch_backend.softmax_classifier_loss(lambda m, x: m(x)),
        torch_backend.tunable_optimizer(
            torch.optim.AdamW, lr=LR, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=1e-4),
        predict_fn=lambda m, x: torch.softmax(m(x), -1))


def vit_fit(tree, x, y, epochs=VIT_EPOCHS, checkpoint_path=None,
            stop_after_first=False):
    """Rank side: the port's fit from ``tree`` on this rank's device;
    (the trained tree, the logged metrics, predictions on 7 rows)."""
    cfg, _ = _vit_cfgs()
    trainer = _vit_trainer()
    model, opt = trainer.init(lambda rng: convert.from_jax_params(
        tree, cfg, trainer.device, train=True))
    logged = []
    log = lambda **m: logged.append(m)  # noqa: E731
    if stop_after_first:
        stopper = ModelLogger()
        stopper.set_sink(lambda line: logged.append(line))
        stopper.set_stop_check(lambda metrics: True)
        log = stopper.log
    trainer.fit(model, opt, (x, y), epochs=epochs, batch_size=VIT_BATCH,
                seed=3, log=log, checkpoint_path=checkpoint_path)
    model.eval()
    return (convert.to_jax_params(model), logged,
            trainer.predict_batched(model, x[:7]))


@pytest.fixture(scope="module")
def vit_fits(world2):
    tree, x, y = _vit_problem()
    _, jcfg = _vit_cfgs()
    apply_fn = lambda p, xb: jvit.apply(p, xb, jcfg)  # noqa: E731
    jtrainer = jax_backend.DataParallelTrainer(
        jax_backend.softmax_classifier_loss(apply_fn),
        jax_backend.tunable_optimizer(optax.adamw, learning_rate=LR),
        predict_fn=lambda p, xb: jax.nn.softmax(apply_fn(p, xb), -1),
        mesh=jmesh.make_mesh(devices=jax.devices()[:2]))
    assert jtrainer.n_data == 2
    params, opt_state = jtrainer.init(
        lambda rng: jax.tree.map(jnp.asarray, tree),
        hyperparams={"learning_rate": LR})
    jlogged = []
    params, _ = jtrainer.fit(params, opt_state, (x, y), epochs=VIT_EPOCHS,
                             batch_size=VIT_BATCH, seed=3,
                             log=lambda **m: jlogged.append(m))
    two = _on_ranks(world2, vit_fit, tree, x, y)
    return dict(
        tree=tree, two=two,
        one=_world1(vit_fit, tree, x, y),
        jax=(jax.tree.map(np.asarray, params), jlogged))


def _world1(fn, *args):
    """``fn`` on one CPU rank: no data group, the thread's grant cpu:0."""
    set_device_grant(["cpu:0"])
    try:
        return fn(*args)
    finally:
        set_device_grant(None)


def _updates(tree, start):
    return {jax.tree_util.keystr(p): np.asarray(v) - np.asarray(s)
            for (p, v), (_, s) in zip(
                jax.tree_util.tree_leaves_with_path(tree),
                jax.tree_util.tree_leaves_with_path(start))}


def test_world2_vit_fit_matches_jax_two_device_mesh(vit_fits):
    """Rank 0's loss and every rank's parameters against JAX's fit over a
    2-device mesh, with the tolerance of the single-card fit test: the
    loss within 1e-3, each weight's update within lr x steps and each
    leaf's within 20% of its norm."""
    (tree0, logged0, _), (tree1, logged1, _) = vit_fits["two"]
    jtree, jlogged = vit_fits["jax"]
    assert logged1 == []  # rank 0 alone logs
    assert [m["epoch"] for m in logged0] == [0.0, 1.0]
    np.testing.assert_allclose([m["loss"] for m in logged0],
                               [m["loss"] for m in jlogged], rtol=1e-3)
    want = _updates(jtree, vit_fits["tree"])
    for got in (_updates(tree0, vit_fits["tree"]),
                _updates(tree1, vit_fits["tree"])):
        assert got.keys() == want.keys()
        for name, d_jax in want.items():
            d = got[name]
            assert np.abs(d - d_jax).max() <= LR * VIT_STEPS, name
            assert np.linalg.norm(d - d_jax) <= 0.2 * np.linalg.norm(
                d_jax), name
            assert np.abs(d_jax).max() > 0.5 * LR, name


def test_world2_vit_fit_equals_world1_over_the_global_batch(vit_fits):
    """The two ranks end with the same parameters and answers bit for
    bit, and those are one device's over the same global batches within
    the tolerance above: a bf16 forward over half the batch rounds
    otherwise than over the whole (the losses measured 7e-5 apart)."""
    (tree0, logged0, probs0), (tree1, _, probs1) = vit_fits["two"]
    tree_one, logged_one, probs_one = vit_fits["one"]
    for a, b in zip(jax.tree_util.tree_leaves(tree0),
                    jax.tree_util.tree_leaves(tree1)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(probs0, probs1)
    np.testing.assert_allclose([m["loss"] for m in logged0],
                               [m["loss"] for m in logged_one], rtol=1e-3)
    got = _updates(tree0, vit_fits["tree"])
    for name, d in _updates(tree_one, vit_fits["tree"]).items():
        assert np.abs(got[name] - d).max() <= LR * VIT_STEPS, name
        assert np.linalg.norm(got[name] - d) <= 0.2 * np.linalg.norm(d), \
            name
    np.testing.assert_allclose(probs0, probs_one, rtol=0, atol=1e-2)


def test_world2_checkpoint_is_rank0s_and_resumes_every_rank(world2,
                                                            tmp_path):
    """A fit stopped after epoch 1 of 2 writes one checkpoint (rank 0's);
    a fresh fit on both ranks resumes from it, rank 1 reading no file,
    and ends where the uninterrupted fit ends."""
    tree, x, y = _vit_problem()
    whole = _on_ranks(world2, vit_fit, tree, x, y, 2)
    path = str(tmp_path / "trial.ckpt")
    rank1_path = str(tmp_path / "elsewhere" / "trial.ckpt")
    # rank 1 is handed a path that does not exist: the bytes are rank 0's
    set_device_grant(world2.devices)
    ranks.set_group(world2.group)
    try:
        world2._send(("fn", ranks._fn_name(vit_fit),
                      (tree, x, y, 2, rank1_path, True)))
        stopped, _ = world2._run_local(
            lambda: vit_fit(tree, x, y, 2, path, True))
    finally:
        ranks.set_group(None)
        set_device_grant(None)
    assert os.listdir(tmp_path) == ["trial.ckpt"]
    assert any("trial stopped" in str(line) or "epoch" in str(line)
               for line in stopped[1])
    resumed = _on_ranks(world2, vit_fit, tree, x, y, 2, path)
    assert [m["epoch"] for m in resumed[0][1]] == [1.0]
    for a, b in zip(jax.tree_util.tree_leaves(resumed[1][0]),
                    jax.tree_util.tree_leaves(whole[1][0])):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
    for a, b in zip(jax.tree_util.tree_leaves(resumed[0][0]),
                    jax.tree_util.tree_leaves(resumed[1][0])):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# predict_batched over 1, 2 and 4 ranks
# ---------------------------------------------------------------------------


def vit_predict(tree, x, sizes):
    """Rank side: the tiny ViT's answers to the first ``n`` rows of ``x``
    for each ``n`` in ``sizes``, and the bucket ladder."""
    cfg, _ = _vit_cfgs()
    trainer = _vit_trainer()
    model = convert.from_jax_params(tree, cfg, trainer.device)
    return ([trainer.predict_batched(model, x[:n], batch_size=16)
             for n in sizes], trainer.predict_buckets(16))


@pytest.mark.parametrize("world", [2, 4])
def test_predict_batched_over_ranks_equals_one_rank(world):
    """Sizes 1, 7 and 33 (one bucket, a padded one, and three chunks of
    the 16-cap): every rank answers every row, in order, as one rank
    does; the buckets are multiples of the group (JAX's
    ``predict_buckets``)."""
    tree, x, _ = _vit_problem()
    sizes = (1, 7, 33)
    one, one_buckets = _world1(vit_predict, tree, x, sizes)
    assert one_buckets == [8, 16]
    with ranks.Ranks(CPUS[:world]) as r:
        outs = _on_ranks(r, vit_predict, tree, x, sizes)
    for answers, buckets in outs:
        assert buckets == ([8, 16] if world == 2 else [8, 16])
        for got, want, n in zip(answers, one, sizes):
            assert got.shape == (n, 10)
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# the narrow ResNet: BatchNorm over the global batch
# ---------------------------------------------------------------------------

RN_N, RN_BATCH = 32, 16  # 2 steps


def _rn_cfgs():
    kw = dict(stage_sizes=(1, 1), bottleneck=True, width=8, num_classes=10,
              small_inputs=True)
    return resnet.ResNetConfig(**kw), jresnet.ResNetConfig(**kw)


def _rn_problem():
    cfg, _ = _rn_cfgs()
    params, stats = resnet.init(np.random.default_rng(0), cfg)
    rng = np.random.default_rng(1)
    y = rng.integers(0, 10, RN_N).astype(np.int32)
    x = (rng.standard_normal((RN_N, 8, 8, 3))
         + 0.5 * y[:, None, None, None]).astype(np.float32)
    return params, stats, x, y


def _rn_loss(model, state, batch):
    x, y = batch
    logits, new_state = model(x, state, train=True)
    loss = torch.nn.functional.cross_entropy(logits, y.long())
    return loss, ({}, new_state)


def resnet_fit(params, stats, x, y):
    """Rank side: 2 AdamW steps of the narrow ResNet; (the tree, the
    running statistics)."""
    cfg, _ = _rn_cfgs()
    trainer = torch_backend.DataParallelTrainer(
        _rn_loss, torch_backend.tunable_optimizer(
            torch.optim.AdamW, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=1e-4), device=None, stateful=True)

    def init_fn(rng):
        with torch.device("meta"):
            model = resnet.ResNet(cfg)
        model = convert.from_jax_tree(model, params, stats, trainer.device,
                                      True)
        return model, model.state()

    model, opt, state = trainer.init(init_fn, hyperparams={"lr": LR})
    trainer.fit(model, opt, (x, y), epochs=1, batch_size=RN_BATCH, seed=3,
                state=state)
    tree, _ = convert.to_jax_tree(model)
    return tree, {k: v.numpy().copy() for k, v in state.items()}


def test_world2_resnet_matches_jax_with_global_batchnorm(world2):
    """After 2 steps: each weight's update within lr x steps and each
    leaf's within 20% of its norm (as ``tests/test_torch_resnet.py``),
    the convolutions' biases aside (BatchNorm takes their gradient out);
    the running statistics within 1e-2 of the largest entry, on both
    ranks, which hold the same statistics and parameters bit for bit."""
    params, stats, x, y = _rn_problem()
    _, jcfg = _rn_cfgs()

    def loss_fn(p, s, batch, rng):
        xb, yb = batch
        logits, new = jresnet.apply(p, s, xb, jcfg, train=True)
        return (optax.softmax_cross_entropy_with_integer_labels(
            logits, yb).mean(), ({}, new))

    jtrainer = jax_backend.DataParallelTrainer(
        loss_fn, jax_backend.tunable_optimizer(optax.adamw,
                                               learning_rate=LR),
        stateful=True, mesh=jmesh.make_mesh(devices=jax.devices()[:2]))
    jp, jo, js = jtrainer.init(
        lambda rng: jax.tree.map(jnp.asarray, (params, stats)),
        hyperparams={"learning_rate": LR})
    jp, _, js = jtrainer.fit(jp, jo, (x, y), epochs=1, batch_size=RN_BATCH,
                             seed=3, state=js)
    (tree0, state0), (tree1, state1) = _on_ranks(world2, resnet_fit,
                                                 params, stats, x, y)
    for k in state0:
        np.testing.assert_array_equal(state0[k], state1[k])
    for a, b in zip(jax.tree_util.tree_leaves(tree0),
                    jax.tree_util.tree_leaves(tree1)):
        np.testing.assert_array_equal(a, b)
    compared = 0
    for path, final_jax in jax.tree_util.tree_leaves_with_path(
            jax.tree.map(np.asarray, jp)):
        final, init = tree0, params
        for key in path:
            final, init = final[key.key], init[key.key]
        keys = [key.key for key in path]
        if keys[-1] == "bias" and keys[-2] in ("stem", "conv1", "conv2",
                                                "conv3", "proj"):
            continue
        compared += 1
        d, d_jax = final - init, final_jax - init
        name = jax.tree_util.keystr(path)
        assert np.abs(d - d_jax).max() <= LR * 2, name
        assert np.linalg.norm(d - d_jax) <= 0.2 * np.linalg.norm(d_jax), \
            name
    assert compared == 3 + 2 * 12 + 2
    flat_js = {}
    for path, v in jax.tree_util.tree_leaves_with_path(js):
        flat_js[".".join(str(k.key) for k in path)] = np.asarray(v)
    # the port's state names are "<bn>.mean"/"<bn>.var" of the same tree
    assert len(flat_js) == len(state0)
    ours_sorted = sorted(state0.items())
    theirs_sorted = sorted(flat_js.items())
    for (k, got), (_, ref) in zip(ours_sorted, theirs_sorted):
        np.testing.assert_allclose(
            got, ref, rtol=0, atol=1e-2 * max(1.0, np.abs(ref).max()),
            err_msg=k)
    assert not np.allclose(state0["stem_bn.var"], 1.0)


# ---------------------------------------------------------------------------
# faults between ranks
# ---------------------------------------------------------------------------


def raise_on(rank_to_fail):
    """Rank side: a ValueError on one rank, a sum over the group after."""
    g = ranks.current_group()
    if g.rank == rank_to_fail:
        raise ValueError(f"bad knob on rank {g.rank}")
    return float(g.all_reduce_(torch.ones(1))[0])


def kill_self_on(rank_to_die):
    g = ranks.current_group()
    if g.rank == rank_to_die:
        os.kill(os.getpid(), signal.SIGKILL)
    return float(g.all_reduce_(torch.ones(1))[0])


def test_a_follower_error_is_raised_on_rank0_as_itself():
    """The follower's ValueError, raised on rank 0 with its traceback as a
    note, well inside the group's timeout; the ranks are then broken and
    refuse further calls."""
    with ranks.Ranks(CPUS[:2]) as r:
        assert r.startups[0]["rank"] == 1
        # the follower imports this module at its first call
        assert _on_ranks(r, raise_on, -1) == [2.0, 2.0]
        t0 = time.monotonic()
        with pytest.raises(ValueError, match="bad knob on rank 1") as e:
            _on_ranks(r, raise_on, 1)
        assert time.monotonic() - t0 < 15
        assert "raised on rank 1" in "".join(e.value.__notes__)
        assert r.broken
        with pytest.raises(TrialFault, match="broken"):
            r.run(raise_on, 5)
        pids = r.pids
    assert all(not os.path.exists(f"/proc/{p}") or _is_zombie(p)
               for p in pids)


def test_a_killed_follower_is_an_infra_fault_not_a_hang():
    """A follower dead in a collective: rank 0's call ends at once (gloo
    sees the closed connection), not at the group's timeout, with INFRA."""
    with ranks.Ranks(CPUS[:2]) as r:
        assert _on_ranks(r, kill_self_on, -1) == [2.0, 2.0]
        t0 = time.monotonic()
        with pytest.raises(TrialFault, match="died") as e:
            _on_ranks(r, kill_self_on, 1)
        assert e.value.kind == FaultKind.INFRA
        assert time.monotonic() - t0 < 15


@pytest.mark.parametrize("n", [2, 4])
def test_a_follower_dead_before_joining_raises_in_seconds(
        n, tmp_path, monkeypatch):
    """A follower that cannot start (here, as when the parent's main
    module is ``<stdin>``, its main module cannot be re-imported, so it
    exits before joining) ends ``Ranks(...)`` with an INFRA fault naming
    the rank and its exit code, in seconds, not at the group's timeout
    (40 s here); no follower is left behind."""
    import types

    monkeypatch.setenv("RAFIKI_DIST_TIMEOUT_S", "40")
    gone = types.ModuleType("__main__")
    gone.__file__ = str(tmp_path / "gone" / "main.py")
    gone.__spec__ = None
    monkeypatch.setitem(__import__("sys").modules, "__main__", gone)
    procs = []
    real = ranks.Ranks._join

    def spy(self, *args):
        procs.extend(f.proc for f in self._followers)
        return real(self, *args)

    monkeypatch.setattr(ranks.Ranks, "_join", spy)
    t0 = time.monotonic()
    with pytest.raises(TrialFault, match=r"exited with code \d+ before "
                                         r"the group formed") as e:
        ranks.Ranks(CPUS[:n])
    assert time.monotonic() - t0 < 10
    assert e.value.kind == FaultKind.INFRA
    assert re.search(r"rank [1-3] \(pid \d+\)", str(e.value))
    assert len(procs) == n - 1
    assert not any(p.is_alive() for p in procs)


def test_each_gives_every_rank_its_part_alone(world2):
    """``Ranks.each``: rank r answers ``parts[r]`` outside the group (no
    collective), the results come back in rank order, a rank whose part
    is None is left out, and a rank's error is raised on rank 0 and
    leaves the ranks whole."""
    world2.new_model(_PARTS_MODULE, "Parts", {})
    model = load_model_class(_PARTS_MODULE, "Parts")()
    ranks.set_group(world2.group)
    try:
        assert world2.each(model, "answer", [("a", 2), ("b", 3)]) == [
            ("a", [0, 1], True), ("b", [0, 1, 2], True)]
        assert world2.each(model, "answer", [("a", 1), None]) == [
            ("a", [0], True), None]
        assert ranks.current_group() is world2.group
        with pytest.raises(ValueError, match="bad part b"):
            world2.each(model, "answer", [("a", 1), ("b", -1)])
        assert not world2.broken
        assert world2.each(model, "answer", [None, ("b", 1)]) == [
            None, ("b", [0], True)]
    finally:
        ranks.set_group(None)


_PARTS_MODULE = b'''
from rafiki_tpu_torch.parallel import ranks
from rafiki_tpu_torch.sdk.model import BaseModel


class Parts(BaseModel):
    @staticmethod
    def get_knob_config():
        return {}

    def answer(self, tag, n):
        if n < 0:
            raise ValueError(f"bad part {tag}")
        return (tag, list(range(n)), ranks.current_group() is None)

    def train(self, dataset_uri):
        pass

    def evaluate(self, dataset_uri):
        return 0.0

    def predict(self, queries):
        return queries

    def dump_parameters(self):
        return {}

    def load_parameters(self, params):
        pass
'''


def _is_zombie(pid):
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] == "Z"
    except OSError:
        return True


# ---------------------------------------------------------------------------
# the stack
# ---------------------------------------------------------------------------

PROBE = b'''
import os
from pathlib import Path

import numpy as np
import torch

from rafiki_tpu_torch.sdk.knob import FixedKnob, FloatKnob
from rafiki_tpu_torch.sdk.model import BaseModel
from rafiki_tpu_torch.sdk.torch_backend import (
    DataParallelTrainer,
    softmax_classifier_loss,
    tunable_optimizer,
)


def _apply(model, x):
    return model(x)


def _probs(model, x):
    return torch.softmax(model(x), -1)


class MeshProbe(BaseModel):
    """Trains data-parallel over whatever ranks its grant gives it and
    scores the number it trained over."""

    @staticmethod
    def get_knob_config():
        return {"learning_rate": FloatKnob(1e-2, 1e-1, is_exp=True),
                "dim": FixedKnob(4)}

    def __init__(self, **knobs):
        super().__init__(**knobs)
        self._n = None
        self._model = None

    def _trainer(self):
        return DataParallelTrainer(
            softmax_classifier_loss(_apply),
            tunable_optimizer(torch.optim.SGD,
                              lr=self._knobs["learning_rate"]),
            predict_fn=_probs)

    def train(self, dataset_uri):
        d = self._knobs["dim"]
        rng = np.random.default_rng(0)
        x = rng.standard_normal((64, d)).astype(np.float32)
        y = (x[:, 0] > 0).astype(np.int64)
        trainer = self._trainer()
        self._n = trainer.n_data
        self._model, opt = trainer.init(lambda rng: torch.nn.Linear(d, 2))
        # a report before the fit, as TorchResNet's of its read time
        self.logger.log(read_time=0.0)
        # the test of a killed follower stretches the first trial
        epochs = int(os.environ.get("PROBE_EPOCHS", "2"))
        trainer.fit(self._model, opt, (x, y), epochs=epochs, batch_size=16,
                    log=self.logger.log,
                    checkpoint_path=self.checkpoint_path)

    def evaluate(self, dataset_uri):
        return float(self._n)

    def predict(self, queries):
        x = np.asarray(queries, np.float32)
        return self._trainer().predict_batched(self._model, x).tolist()

    def dump_parameters(self):
        return {"w": self._model.weight.detach().numpy().copy(),
                "b": self._model.bias.detach().numpy().copy(),
                "n": self._n}

    def load_parameters(self, params):
        d = self._knobs["dim"]
        self._model = torch.nn.Linear(d, 2)
        with torch.no_grad():
            self._model.weight.copy_(torch.as_tensor(params["w"]))
            self._model.bias.copy_(torch.as_tensor(params["b"]))
        self._n = params["n"]
'''


@pytest.fixture
def cpu4_admin(tmp_path):
    admin = Admin(db=Database(":memory:"),
                  placement=LocalPlacementManager(ChipAllocator(CPUS)),
                  params_dir=str(tmp_path))
    uid = admin.authenticate_user(config.SUPERADMIN_EMAIL,
                                  config.SUPERADMIN_PASSWORD)["user_id"]
    try:
        yield admin, uid
    finally:
        admin.shutdown()


def test_chips_per_trial_trains_each_trial_over_its_grant(cpu4_admin):
    """CHIPS_PER_TRIAL=4 on 4 CPU entries: one worker, whose trials train
    over 4 ranks and score 4.0 (``tests/test_stack.py``'s probe)."""
    admin, uid = cpu4_admin
    admin.create_model(uid, "probe", "IMAGE_CLASSIFICATION", PROBE,
                       "MeshProbe")
    job = admin.create_train_job(
        uid, "mesh", "IMAGE_CLASSIFICATION", "u://t", "u://e",
        budget={"MODEL_TRIAL_COUNT": 2, "CHIP_COUNT": 4,
                "CHIPS_PER_TRIAL": 4})
    assert len(job["workers"]) == 1
    assert job["workers"][0]["chips"] == CPUS
    job = admin.wait_until_train_job_stopped(uid, "mesh", timeout_s=120)
    assert job["status"] == "STOPPED"
    trials = admin.get_trials_of_train_job(uid, "mesh")
    assert [t["status"] for t in trials] == [TrialStatus.COMPLETED] * 2
    assert all(t["score"] == 4.0 for t in trials)


def test_chips_per_trial_splits_workers_over_disjoint_grants(cpu4_admin):
    """CHIPS_PER_TRIAL=2 on 4: two workers of 2 ranks each, on grants
    that share no entry; their trials score 2.0. A CHIPS_PER_TRIAL above
    the host clamps to it (one worker of 4)."""
    admin, uid = cpu4_admin
    admin.create_model(uid, "probe", "IMAGE_CLASSIFICATION", PROBE,
                       "MeshProbe")
    job = admin.create_train_job(
        uid, "split", "IMAGE_CLASSIFICATION", "u://t", "u://e",
        budget={"MODEL_TRIAL_COUNT": 2, "CHIP_COUNT": 4,
                "CHIPS_PER_TRIAL": 2})
    chips = [w["chips"] for w in job["workers"]]
    assert len(chips) == 2 and all(len(c) == 2 for c in chips)
    assert sorted(c for grant in chips for c in grant) == CPUS
    job = admin.wait_until_train_job_stopped(uid, "split", timeout_s=120)
    trials = admin.get_trials_of_train_job(uid, "split")
    assert [t["score"] for t in trials] == [2.0, 2.0]
    job = admin.create_train_job(
        uid, "clamp", "IMAGE_CLASSIFICATION", "u://t", "u://e",
        budget={"MODEL_TRIAL_COUNT": 1, "CHIP_COUNT": 4,
                "CHIPS_PER_TRIAL": 8})
    assert [len(w["chips"]) for w in job["workers"]] == [4]
    admin.wait_until_train_job_stopped(uid, "clamp", timeout_s=120)


def test_chips_per_worker_serves_what_one_card_serves(cpu4_admin):
    """A trial served by workers of 2 ranks answers as the same trial
    loaded on one rank does."""
    admin, uid = cpu4_admin
    admin.create_model(uid, "probe", "IMAGE_CLASSIFICATION", PROBE,
                       "MeshProbe")
    admin.create_train_job(uid, "serve", "IMAGE_CLASSIFICATION", "u://t",
                           "u://e", budget={"MODEL_TRIAL_COUNT": 1})
    admin.wait_until_train_job_stopped(uid, "serve", timeout_s=120)
    (trial,) = admin.get_trials_of_train_job(uid, "serve")
    inf = admin.create_inference_job(uid, "serve",
                                     budget={"CHIPS_PER_WORKER": 2})
    # one best trial, two replicas of 2 ranks each on the 4 entries
    grants = [w["chips"] for w in inf["workers"]]
    assert sorted(c for grant in grants for c in grant) == CPUS
    queries = np.random.default_rng(5).standard_normal((9, 4)).tolist()
    answers = admin.predict(uid, "serve", queries)
    clazz = load_model_class(PROBE, "MeshProbe")
    from rafiki_tpu_torch.parallel.ranks import load_params_file

    model = clazz(**trial["knobs"])
    _world1(load_params_file, model,
            admin.db.get_trial(trial["id"])["params_file_path"])
    want = _world1(model.predict, queries)
    np.testing.assert_allclose(np.asarray(answers), np.asarray(want),
                               rtol=0, atol=1e-6)
    admin.stop_inference_job(uid, "serve")


def test_generation_across_cards_is_refused_typed(cpu4_admin):
    """A TEXT_GENERATION deploy over several cards is a 400 before any
    row is made (JAX serves it: ``rafiki_tpu/worker/generation.py``)."""
    admin, uid = cpu4_admin
    job = admin.db.create_train_job(uid, "gen", 1, "TEXT_GENERATION", "t",
                                    "e", {})
    admin.db.mark_train_job_as_stopped(job["id"])
    with pytest.raises(InvalidRequestError, match="generation across cards"):
        admin.create_inference_job(uid, "gen",
                                   budget={"CHIPS_PER_WORKER": 2})
    assert admin.db.get_inference_jobs_of_train_job(job["id"]) == []


def test_a_killed_follower_faults_its_trial_and_the_worker_goes_on(
        cpu4_admin, monkeypatch):
    """A follower SIGKILLed mid-fit: its trial's row carries an INFRA
    fault (at once: gloo sees the closed connection), the ranks start
    again, and the worker takes the next trial, the job ending inside the
    group's timeout."""
    monkeypatch.setenv("RAFIKI_TRIAL_RETRY_MAX", "0")
    monkeypatch.setenv("PROBE_EPOCHS", "100000")
    admin, uid = cpu4_admin
    admin.create_model(uid, "probe", "IMAGE_CLASSIFICATION", PROBE,
                       "MeshProbe")
    before = set(_follower_pids())  # other tests' ranks, left alone
    t0 = time.monotonic()
    job = admin.create_train_job(
        uid, "kill", "IMAGE_CLASSIFICATION", "u://t", "u://e",
        budget={"MODEL_TRIAL_COUNT": 2, "CHIP_COUNT": 2,
                "CHIPS_PER_TRIAL": 2})
    (worker,) = job["workers"]
    killed = _kill_a_follower_mid_trial(admin, uid, "kill", before)
    monkeypatch.setenv("PROBE_EPOCHS", "2")
    job = admin.wait_until_train_job_stopped(uid, "kill", timeout_s=150)
    assert job["status"] == "STOPPED"
    trials = admin.get_trials_of_train_job(uid, "kill")
    first, second = trials
    assert first["status"] == TrialStatus.ERRORED
    assert first["fault_kind"] == FaultKind.INFRA
    assert f"pid {killed}" in first["fault_detail"]
    assert second["status"] == TrialStatus.COMPLETED
    assert second["score"] == 2.0
    assert time.monotonic() - t0 < DIST_TIMEOUT_S
    assert worker["chips"] == CPUS[:2]


def test_a_verdict_before_the_fit_waits_for_the_epochs_report(
        cpu4_admin, monkeypatch):
    """TRIAL_TIMEOUT_S already spent at the probe's report before its fit:
    over 2 ranks the verdict waits for the fit's first per-epoch report,
    where every rank stops, so each trial completes with its truncated
    score and no fault (raised at the earlier report, it would leave the
    follower in the fit's collectives and fault the trial)."""
    monkeypatch.setenv("PROBE_EPOCHS", "4")
    admin, uid = cpu4_admin
    admin.create_model(uid, "probe", "IMAGE_CLASSIFICATION", PROBE,
                       "MeshProbe")
    admin.create_train_job(
        uid, "cap", "IMAGE_CLASSIFICATION", "u://t", "u://e",
        budget={"MODEL_TRIAL_COUNT": 2, "CHIP_COUNT": 2,
                "CHIPS_PER_TRIAL": 2, "TRIAL_TIMEOUT_S": 1e-6})
    job = admin.wait_until_train_job_stopped(uid, "cap", timeout_s=120)
    assert job["status"] == "STOPPED"
    trials = admin.get_trials_of_train_job(uid, "cap")
    assert [t["status"] for t in trials] == [TrialStatus.COMPLETED] * 2
    assert [t["score"] for t in trials] == [2.0, 2.0]
    assert all(t["fault_kind"] is None for t in trials)
    for t in trials:
        logs = admin.db.get_trial_logs(t["id"])
        assert any('"read_time"' in line for line in logs)
        assert sum('"epoch_time"' in line for line in logs) == 1


def _kill_a_follower_mid_trial(admin, uid, app, before):
    """SIGKILL the job's follower process (one not in ``before``) once a
    trial is RUNNING and its fit has logged an epoch; returns its pid."""
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        trials = admin.get_trials_of_train_job(uid, app)
        if trials and trials[0]["status"] == TrialStatus.RUNNING:
            logs = admin.db.get_trial_logs(trials[0]["id"])
            if any('"epoch"' in line for line in logs):
                pids = [p for p in _follower_pids() if p not in before]
                if pids:
                    os.kill(pids[0], signal.SIGKILL)
                    return pids[0]
        time.sleep(0.05)
    raise AssertionError("no trial reached its first epoch")


def _follower_pids():
    import multiprocessing

    return [p.pid for p in multiprocessing.active_children()
            if p.name.startswith("rafiki-rank")]


def test_a_process_placed_worker_starts_its_followers(tmp_path,
                                                     monkeypatch):
    """Process placement: the train child granted two CPU entries is rank
    0 and starts its follower, which writes its own ``startup`` and
    ``kernel launches`` lines into the child's log; the trials train over
    both ranks (score 2.0) and no process is left after the stop."""
    from rafiki_tpu_torch.admin.http import AdminServer
    from rafiki_tpu_torch.placement.process import ProcessPlacementManager

    logs = tmp_path / "logs"
    monkeypatch.setenv("RAFIKI_WORKDIR", str(tmp_path))
    monkeypatch.setenv("RAFIKI_LOGS_DIR", str(logs))
    monkeypatch.setenv("SERVICE_DEPLOY_TIMEOUT_S", "600")
    admin = Admin(db=Database(str(tmp_path / "store.sqlite3")),
                  params_dir=str(tmp_path / "params"),
                  placement=ProcessPlacementManager(
                      allocator=ChipAllocator(CPUS[:2])))
    srv = AdminServer(admin).start()
    try:
        uid = admin.authenticate_user(config.SUPERADMIN_EMAIL,
                                      config.SUPERADMIN_PASSWORD)["user_id"]
        admin.create_model(uid, "probe", "IMAGE_CLASSIFICATION", PROBE,
                           "MeshProbe")
        job = admin.create_train_job(
            uid, "proc", "IMAGE_CLASSIFICATION", "u://t", "u://e",
            budget={"MODEL_TRIAL_COUNT": 2, "CHIP_COUNT": 2,
                    "CHIPS_PER_TRIAL": 2})
        (worker,) = job["workers"]
        job = admin.wait_until_train_job_stopped(uid, "proc", timeout_s=300)
        trials = admin.get_trials_of_train_job(uid, "proc")
    finally:
        srv.stop()
        admin.shutdown()
    assert job["status"] == "STOPPED"
    assert worker["chips"] == CPUS[:2]
    assert [t["score"] for t in trials] == [2.0, 2.0]
    log = (logs / f"service-{worker['service_id']}.log").read_text()
    pids = {int(p) for p in re.findall(r"startup \(pid (\d+)\)", log)}
    exits = {int(p) for p in re.findall(r"kernel launches \(pid (\d+)\)",
                                        log)}
    assert len(pids) == 2 and exits == pids, log[-3000:]
    assert ":rank1:" in log
    assert not any(os.path.exists(f"/proc/{p}") and not _is_zombie(p)
                   for p in pids)


FUSED_FF = (Path(torch_backend.__file__).parents[1] / "templates"
            / "torch_feedforward.py").read_text() + '''

class FusedFF(TorchFeedForward):
    @staticmethod
    def get_knob_config():
        cfg = dict(TorchFeedForward.get_knob_config())
        cfg["epochs"] = FixedKnob(1)
        cfg["hidden_layer_count"] = FixedKnob(1)
        cfg["hidden_layer_units"] = FixedKnob(8)
        cfg["batch_size"] = FixedKnob(16)
        cfg["image_size"] = FixedKnob(4)
        return cfg
'''


def test_a_fused_worker_over_ranks_serves_what_one_rank_serves(
        cpu4_admin, tmp_path):
    """ENSEMBLE_FUSED with CHIPS_PER_WORKER=2: each worker's ranks hold
    the whole group (each rank its own stacked ensemble) and answer their
    part of a batch; the answers equal the fused ensemble on one rank."""
    from rafiki_tpu_torch.sdk.dataset import write_numpy_dataset
    from rafiki_tpu_torch.worker.inference import serving_stats

    admin, uid = cpu4_admin
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 4, 4, 3)).astype(np.float32)
    y = rng.integers(0, 3, size=64).astype(np.int32)
    uri = write_numpy_dataset(x, y, str(tmp_path / "d.npz"))
    admin.create_model(uid, "ff", "IMAGE_CLASSIFICATION", FUSED_FF.encode(),
                       "FusedFF")
    admin.create_train_job(uid, "ffapp", "IMAGE_CLASSIFICATION", uri, uri,
                           budget={"MODEL_TRIAL_COUNT": 2})
    job = admin.wait_until_train_job_stopped(uid, "ffapp", timeout_s=120)
    assert job["status"] == "STOPPED"
    queries = [q.tolist() for q in x[:5]]
    inf = admin.create_inference_job(uid, "ffapp",
                                     budget={"ENSEMBLE_FUSED": 1})
    one = admin.predict(uid, "ffapp", queries)
    admin.stop_inference_job(uid, "ffapp")
    inf = admin.create_inference_job(
        uid, "ffapp", budget={"ENSEMBLE_FUSED": 1, "CHIPS_PER_WORKER": 2})
    assert [len(w["chips"]) for w in inf["workers"]] == [2, 2]
    two = admin.predict(uid, "ffapp", queries)
    assert all(serving_stats()[w["service_id"]]["fused_dispatch"]
               for w in inf["workers"])
    admin.stop_inference_job(uid, "ffapp")
    np.testing.assert_allclose(np.asarray(two), np.asarray(one), atol=1e-6)
