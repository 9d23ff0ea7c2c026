"""The port's ResNet and stateful trainer against the JAX package's.

- ``models/resnet.py``: logits and the updated BatchNorm running
  statistics of one training forward, and the logits of an evaluation
  forward on those statistics, for both block kinds (basic, bottleneck)
  and both stems (CIFAR, ImageNet with its ``"SAME"`` 3x3/2 max pool) at
  a test width (``stage_sizes=(1, 1)``, ``width=8``; and ``(2, 1)`` for
  an identity shortcut), the same numpy tree carried into both packages;
- ``DataParallelTrainer(stateful=True)``: epoch losses, parameters and
  running statistics after two epochs of AdamW against the JAX stateful
  ``fit``, and a checkpointed fit that resumes with its state;
- evaluation mode: one image's answer does not depend on its batch.

The JAX trainer runs on the 8-device CPU mesh of ``tests/conftest.py``
(its batch statistics are over the whole sharded batch, as the port's
are over its one batch).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rafiki_tpu.models import resnet as jresnet
from rafiki_tpu.sdk import jax_backend
from rafiki_tpu_torch import convert
from rafiki_tpu_torch.models import resnet
from rafiki_tpu_torch.sdk import torch_backend
from rafiki_tpu_torch.sdk.log import ModelLogger

#: bf16 activations: a logit may differ by a few bf16 ulps where the two
#: packages round a convolution's sum differently (measured equal here,
#: 2e-3 on O(2) logits with the BatchNorm written out in f32 passes)
LOGIT_ATOL = 2e-2
#: running statistics (f32, from bf16 activations), relative to each
#: vector's largest entry (measured 1.8e-7)
STATS_RTOL = 1e-3

# both block kinds and both stems at one block a stage, and both block
# kinds with an identity shortcut (a stage's second block)
KINDS = [(bottleneck, small, (1, 1)) for bottleneck in (True, False)
         for small in (True, False)] + [(True, True, (2, 1)),
                                        (False, True, (2, 1))]


def _cfgs(bottleneck, small, stage_sizes=(1, 1)):
    kw = dict(stage_sizes=stage_sizes, bottleneck=bottleneck, width=8,
              num_classes=10, small_inputs=small)
    return resnet.ResNetConfig(**kw), jresnet.ResNetConfig(**kw)


def _model(cfg, params, stats, train=False):
    with torch.device("meta"):
        model = resnet.ResNet(cfg)
    return convert.from_jax_tree(model, params, stats, "cpu", train)


def _flat_state(tree):
    return {k.replace("/", "."): np.asarray(v)
            for k, v in convert.flatten(jax.tree.map(np.asarray,
                                                     tree)).items()}


def _close_stats(ours, theirs):
    assert set(ours) == set(theirs)
    for name, ref in theirs.items():
        got = ours[name].detach().numpy()
        np.testing.assert_allclose(
            got, ref, rtol=0, atol=STATS_RTOL * max(1.0, np.abs(ref).max()),
            err_msg=name)


@pytest.mark.parametrize("bottleneck,small,stage_sizes", KINDS)
def test_train_forward_and_running_stats_match_jax(bottleneck, small,
                                                   stage_sizes):
    """One training forward: the logits, and every BatchNorm's running
    statistics 0.9 * old + 0.1 * (batch mean, biased batch variance)."""
    cfg, jcfg = _cfgs(bottleneck, small, stage_sizes)
    params, stats = resnet.init(np.random.default_rng(0), cfg)
    size = 16 if small else 33  # odd: the stem's SAME pads (2, 3)
    x = np.random.default_rng(1).standard_normal(
        (8, size, size, 3)).astype(np.float32)
    jparams, jstats = (jax.tree.map(jnp.asarray, t) for t in (params, stats))
    jlogits, jnew = jresnet.apply(jparams, jstats, jnp.asarray(x), jcfg,
                                  train=True)
    model = _model(cfg, params, stats, train=True)
    with torch.no_grad():
        logits, new = model(torch.from_numpy(x), train=True)
    assert logits.dtype == torch.float32 and logits.shape == (8, 10)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=0, atol=LOGIT_ATOL)
    _close_stats(new, _flat_state(jnew))
    # the forward leaves the buffers alone: the trainer writes them back
    _close_stats(model.state(), _flat_state(stats))

    # evaluation on the updated statistics
    jeval, same = jresnet.apply(jparams, jnew, jnp.asarray(x), jcfg,
                                train=False)
    with torch.no_grad():
        logits, kept = model(torch.from_numpy(x), new, train=False)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jeval), rtol=0,
                               atol=LOGIT_ATOL)
    assert all(kept[k] is new[k] for k in new)


def test_batchnorm_keeps_the_biased_variance():
    """Against the formula itself: torch's own BatchNorm would keep the
    unbiased variance."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((4, 3, 3, 5)).astype(
        np.float32)).to(torch.bfloat16)
    p = {"scale": torch.ones(5), "bias": torch.zeros(5)}
    old = {"mean": torch.full((5,), 0.5), "var": torch.full((5,), 2.0)}
    y, new = resnet.batchnorm(p, old, x, train=True)
    xf = x.float().reshape(-1, 5)
    torch.testing.assert_close(new["mean"], 0.45 + 0.1 * xf.mean(0))
    torch.testing.assert_close(new["var"],
                               1.8 + 0.1 * xf.var(0, unbiased=False))
    assert y.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the stateful trainer
# ---------------------------------------------------------------------------

LR = 1e-3
EPOCHS = 2
BATCH = 16  # a multiple of the 8-device CPU mesh
N = 64
STEPS = EPOCHS * (N // BATCH)


@pytest.fixture(scope="module")
def problem():
    cfg, jcfg = _cfgs(bottleneck=True, small=True)
    params, stats = resnet.init(np.random.default_rng(0), cfg)
    rng = np.random.default_rng(1)
    y = rng.integers(0, 10, N).astype(np.int32)
    x = (rng.standard_normal((N, 8, 8, 3))
         + 0.5 * y[:, None, None, None]).astype(np.float32)
    return cfg, jcfg, params, stats, x, y


def _loss(model, state, batch):
    x, y = batch
    logits, new_state = model(x, state, train=True)
    loss = torch.nn.functional.cross_entropy(logits, y.long())
    return loss, ({}, new_state)


def _probs(model, state, x):
    return torch.softmax(model(x, state, train=False)[0], -1)


def _torch_fit(problem, epochs=EPOCHS, log=None, checkpoint_path=None):
    cfg, _, params, stats, x, y = problem
    trainer = torch_backend.DataParallelTrainer(
        _loss, torch_backend.tunable_optimizer(
            torch.optim.AdamW, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=1e-4),
        predict_fn=_probs, device="cpu", stateful=True)

    def init_fn(rng):
        model = _model(cfg, params, stats, train=True)
        return model, model.state()

    model, opt, state = trainer.init(init_fn, hyperparams={"lr": LR})
    assert all(v is b for v, b in zip(state.values(), model.buffers()))
    # the optimizer holds the parameters, never the running statistics
    held = {id(p) for g in opt.param_groups for p in g["params"]}
    assert held == {id(p) for p in model.parameters()}
    model, _, out = trainer.fit(model, opt, (x, y), epochs=epochs,
                                batch_size=BATCH, seed=3, log=log,
                                checkpoint_path=checkpoint_path, state=state)
    assert out is state
    return trainer, model, state


@pytest.fixture(scope="module")
def fitted(problem):
    cfg, jcfg, params, stats, x, y = problem

    def loss_fn(p, s, batch, rng):
        xb, yb = batch
        logits, new = jresnet.apply(p, s, xb, jcfg, train=True)
        loss = optax.softmax_cross_entropy_with_integer_labels(
            logits, yb).mean()
        return loss, ({}, new)

    jtrainer = jax_backend.DataParallelTrainer(
        loss_fn, jax_backend.tunable_optimizer(optax.adamw,
                                               learning_rate=LR),
        predict_fn=lambda p, s, xb: jax.nn.softmax(
            jresnet.apply(p, s, xb, jcfg)[0], -1),
        stateful=True)
    jp, jo, js = jtrainer.init(
        lambda rng: jax.tree.map(jnp.asarray, (params, stats)),
        hyperparams={"learning_rate": LR})
    jlosses = []
    jp, _, js = jtrainer.fit(jp, jo, (x, y), epochs=EPOCHS, batch_size=BATCH,
                             seed=3, log=lambda **m: jlosses.append(m),
                             state=js)
    jprobs = jtrainer.predict_batched(jp, x, state=js)

    losses = []
    trainer, model, state = _torch_fit(problem,
                                       log=lambda **m: losses.append(m))
    probs = trainer.predict_batched(model, x, state=state)
    tree, _ = convert.to_jax_tree(model)
    return (dict(losses=losses, tree=tree, state=state, probs=probs),
            dict(losses=jlosses, tree=jax.tree.map(np.asarray, jp),
                 state=_flat_state(js), probs=np.asarray(jprobs)))


def test_stateful_fit_losses_match_jax(fitted):
    """Epoch losses (measured within 3.2e-4 relative)."""
    ours, theirs = fitted
    assert [m["epoch"] for m in ours["losses"]] == [0.0, 1.0]
    np.testing.assert_allclose([m["loss"] for m in ours["losses"]],
                               [m["loss"] for m in theirs["losses"]],
                               rtol=1e-2)


def test_stateful_fit_params_and_state_match_jax(fitted, problem):
    """Parameters as updates from the common start: each weight within
    lr x steps (an AdamW step moves a weight by about lr whatever its
    gradient), and each leaf's update within 20% of its norm (measured
    13% at most). Not
    compared: the bias of a convolution. Every one feeds a BatchNorm,
    which takes the per-channel mean out again, so its gradient is zero
    but for rounding, and AdamW moves it by amplified rounding noise in
    either package. The running statistics after the 8 steps, within
    STATS_RTOL x 10 (they follow the trained weights; measured 4.7e-3)."""
    ours, theirs = fitted
    start = problem[2]
    compared = 0
    for path, final_jax in jax.tree_util.tree_leaves_with_path(
            theirs["tree"]):
        final_ours, init = ours["tree"], start
        for key in path:
            final_ours, init = final_ours[key.key], init[key.key]
        d_ours, d_jax = final_ours - init, final_jax - init
        name = jax.tree_util.keystr(path)
        keys = [key.key for key in path]
        if keys[-1] == "bias" and keys[-2] in ("stem", "conv1", "conv2",
                                                "conv3", "proj"):
            continue
        compared += 1
        assert np.abs(d_ours - d_jax).max() <= LR * STEPS, name
        assert np.linalg.norm(d_ours - d_jax) <= 0.2 * np.linalg.norm(
            d_jax), name
    # the stem (kernel, BatchNorm), two blocks of 4 kernels and 4
    # BatchNorms, the head
    assert compared == 3 + 2 * 12 + 2
    for name, ref in theirs["state"].items():
        got = ours["state"][name].numpy()
        np.testing.assert_allclose(
            got, ref, rtol=0,
            atol=10 * STATS_RTOL * max(1.0, np.abs(ref).max()),
            err_msg=name)
    # the statistics did move from their start (0 and 1)
    assert not np.allclose(ours["state"]["stem_bn.var"].numpy(), 1.0)


def test_stateful_predict_matches_jax(fitted):
    """Evaluation-mode probabilities on the running statistics, after the
    8 steps in which the two runs drift apart by bf16 rounding (measured
    3.2e-2 at most)."""
    ours, theirs = fitted
    np.testing.assert_allclose(ours["probs"], theirs["probs"], rtol=0,
                               atol=5e-2)


def test_eval_answer_does_not_depend_on_its_batch(fitted, problem):
    """One image alone (padded to the 8-bucket with copies of itself) and
    in a batch of 16 others: the same answer, in evaluation mode."""
    x = problem[4]
    trainer, model, state = _torch_fit(problem, epochs=1)
    batch = trainer.predict_batched(model, x[:16], state=state)
    for i in (0, 5, 15):
        alone = trainer.predict_batched(model, x[i:i + 1], state=state)
        np.testing.assert_allclose(alone[0], batch[i], rtol=0, atol=1e-5)


def test_stateful_checkpoint_resume_carries_the_state(problem, tmp_path):
    """A fit stopped after epoch 1 of 2 and resumed from its checkpoint
    in a fresh model ends where the uninterrupted fit ends, running
    statistics included."""
    _, whole, whole_state = _torch_fit(problem)
    path = str(tmp_path / "trial.ckpt")
    stopper = ModelLogger()
    stopper.set_sink(lambda line: None)
    stopper.set_stop_check(lambda metrics: True)
    _, _, stopped_state = _torch_fit(problem, log=stopper.log,
                                     checkpoint_path=path)
    logged = []
    _, resumed, resumed_state = _torch_fit(
        problem, log=lambda **m: logged.append(m), checkpoint_path=path)
    assert [m["epoch"] for m in logged] == [1.0]
    for name, a in whole.state_dict().items():
        np.testing.assert_allclose(resumed.state_dict()[name].numpy(),
                                   a.numpy(), atol=1e-6, rtol=0,
                                   err_msg=name)
    assert any(not torch.equal(whole_state[k], stopped_state[k])
               for k in whole_state)
    for k in whole_state:
        torch.testing.assert_close(resumed_state[k], whole_state[k],
                                   atol=1e-6, rtol=0)


def test_stateful_fit_needs_its_state(problem):
    cfg, _, params, stats, x, y = problem
    trainer = torch_backend.DataParallelTrainer(
        _loss, torch_backend.tunable_optimizer(torch.optim.AdamW),
        device="cpu", stateful=True)
    model, opt, _ = trainer.init(
        lambda rng: (lambda m: (m, m.state()))(_model(cfg, params, stats)))
    with pytest.raises(ValueError, match="state="):
        trainer.fit(model, opt, (x, y), epochs=1, batch_size=BATCH)
