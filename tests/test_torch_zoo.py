"""The port's image-classification zoo against the JAX package's.

- ``models/core.py``: ``conv2d`` for every kernel, stride and padding the
  templates use (3x3 and 1x1 at stride 1 and 2, the ImageNet stem's 7x7/2,
  all ``"SAME"``, where XLA pads the odd pixel low-right), at odd and
  even sizes, in f32 and bf16; the max and mean pools of VGG, ResNet and
  the CNN.
- ``models/feedforward.py``, ``models/vgg.py`` and ``TorchCnn``'s network:
  logits against ``feedforward.apply``, ``vgg.apply`` and ``JaxCnn``'s
  forward on the same numpy tree (ResNet: ``tests/test_torch_resnet.py``).
- ``convert.py``: the JAX trees of every family through the port's
  modules and back, exactly (conv kernels HWIO there, OIHW here; lists
  of layers; the BatchNorm state tree); ``sdk/params.py`` carries the
  twins' non-array leaves (``None``, numbers, strings, lists) exactly.
- ``test_model_class`` on every twin; the decision-tree and SVM twins
  give the JAX originals' predictions, identically.
- A 2-trial ``TorchResNet`` job (at test width) through the port's
  ``Client`` on ``["cpu"]``, on an image-zip dataset, served: the
  ensemble against JAX's ``resnet.apply`` on the downloaded trees, and
  one image alone against its row in a batch.
"""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rafiki_tpu_torch
from rafiki_tpu.models import core as jcore
from rafiki_tpu.models import feedforward as jfeedforward
from rafiki_tpu.models import resnet as jresnet
from rafiki_tpu.models import vgg as jvgg
from rafiki_tpu_torch import config, convert
from rafiki_tpu_torch.admin.admin import Admin
from rafiki_tpu_torch.admin.http import AdminServer
from rafiki_tpu_torch.client.client import Client
from rafiki_tpu_torch.db.database import Database
from rafiki_tpu_torch.device import set_device_grant
from rafiki_tpu_torch.models import core, feedforward, resnet, vgg, vit
from rafiki_tpu_torch.placement.manager import (
    ChipAllocator,
    LocalPlacementManager,
)
from rafiki_tpu_torch.sdk import model as sdk_model
from rafiki_tpu_torch.sdk import params as sdk_params
from rafiki_tpu_torch.sdk.dataset import (
    write_image_files_dataset,
    write_numpy_dataset,
)

ROOT = Path(rafiki_tpu_torch.__file__).resolve().parents[1]
TEMPLATES = ROOT / "rafiki_tpu_torch" / "templates"
EXAMPLES = ROOT / "examples" / "models" / "image_classification"

#: f32: both packages call one convolution algorithm family on the same
#: numbers (measured exact, 5e-7 at most), relative to the output's scale
F32_RTOL = 1e-5
#: bf16: the output is rounded to bf16 in both, and an accumulation in a
#: different order may round one ulp apart (2^-7 relative; measured
#: 0.125 on outputs of ~24)
BF16_RTOL = 2 ** -6
#: logits of a small bf16 network: a few bf16 ulps
LOGIT_ATOL = 2e-2


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def _close(ours, theirs, rtol):
    ours = ours.float().numpy() if isinstance(ours, torch.Tensor) else ours
    theirs = np.asarray(jnp.asarray(theirs, jnp.float32))
    assert ours.shape == theirs.shape
    scale = max(1.0, float(np.abs(theirs).max()))
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=rtol * scale)


# ---------------------------------------------------------------------------
# conv2d and pooling
# ---------------------------------------------------------------------------

CONVS = [(size, k, stride) for size in (16, 15)
         for k, stride in ((3, 1), (3, 2), (1, 1), (1, 2))] + [
    (32, 7, 2), (33, 7, 2)]


def test_same_pads_are_xla_pads():
    assert core.same_pads(32, 3, 2) == (0, 1)    # not padding=1's (1, 1)
    assert core.same_pads(224, 7, 2) == (2, 3)
    assert core.same_pads(33, 3, 2) == (1, 1)
    assert core.same_pads(16, 1, 2) == (0, 0)
    assert core.same_pads(112, 3, 2) == (0, 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("size,k,stride", CONVS)
def test_conv2d_matches_jax(size, k, stride, dtype):
    rng = np.random.default_rng(size * 10 + k)
    x = rng.standard_normal((2, size, size, 5)).astype(np.float32)
    kernel = rng.standard_normal((k, k, 5, 6)).astype(np.float32)
    bias = rng.standard_normal(6).astype(np.float32)
    ref = jcore.conv2d({"kernel": jnp.asarray(kernel),
                        "bias": jnp.asarray(bias)},
                       jnp.asarray(x).astype(dtype), stride=stride)
    out = core.conv2d({"kernel": core.hwio_to_oihw(torch.from_numpy(kernel)),
                       "bias": torch.from_numpy(bias)},
                      torch.from_numpy(x).to(getattr(torch, dtype)), stride)
    assert out.dtype == getattr(torch, dtype)
    assert out.shape == (2, -(-size // stride), -(-size // stride), 6)
    _close(out, ref, F32_RTOL if dtype == "float32" else BF16_RTOL)


@pytest.mark.parametrize("size", [16, 15, 112, 33])
def test_pools_match_jax(size):
    x = np.random.default_rng(size).standard_normal(
        (2, size, size, 4)).astype(np.float32)
    jx = jnp.asarray(x)
    cases = [
        # VGG's 2x2 VALID max pool
        (core.max_pool(torch.from_numpy(x), 2, 2, "VALID"),
         jax.lax.reduce_window(jx, -jnp.inf, jax.lax.max, (1, 2, 2, 1),
                               (1, 2, 2, 1), "VALID")),
        # the ImageNet stem's 3x3/2 SAME max pool, -inf padded
        (core.max_pool(torch.from_numpy(x), 3, 2, "SAME"),
         jax.lax.reduce_window(jx, -jnp.inf, jax.lax.max, (1, 3, 3, 1),
                               (1, 2, 2, 1), "SAME")),
        # JaxCnn's 2x2 mean pool
        (core.mean_pool(torch.from_numpy(x), 2, 2),
         jax.lax.reduce_window(jx, 0.0, jax.lax.add, (1, 2, 2, 1),
                               (1, 2, 2, 1), "VALID") / 4.0),
    ]
    for ours, theirs in cases:
        _close(ours, theirs, F32_RTOL)


def test_conv2d_module_keeps_cudnn_layout():
    conv = core.Conv2d(3, 3, 4, 8)
    assert conv.kernel.shape == (8, 4, 3, 3)
    assert conv.kernel.is_contiguous(memory_format=torch.channels_last)
    hwio = torch.randn(3, 3, 4, 8)
    torch.testing.assert_close(core.oihw_to_hwio(core.hwio_to_oihw(hwio)),
                               hwio, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

def _load(path):
    """The template file at ``path``, imported as a module of its own."""
    spec = importlib.util.spec_from_file_location(
        f"zoo_{path.parent.name}_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _port(model, params, state=None):
    return convert.from_jax_tree(model, params, state, "cpu")


def _meta(factory, *args):
    with torch.device("meta"):
        return factory(*args)


FF_CFG = dict(in_dim=6 * 5 * 3, hidden_layers=2, hidden_units=16,
              num_classes=10)
VGG_CFG = dict(plan=((4, 4), (8,)), channels=3, dense_units=16,
               num_classes=10)


@pytest.mark.parametrize("hidden_layers", [1, 2])
def test_feedforward_logits_match_jax(hidden_layers):
    """The flatten is NHWC's: a channels-first flatten would pair the
    carried-over weights with other pixels, and the logits would differ
    by O(1)."""
    kw = dict(FF_CFG, hidden_layers=hidden_layers)
    cfg = feedforward.FeedForwardConfig(**kw)
    tree = feedforward.init(np.random.default_rng(0), cfg)
    x = np.random.default_rng(1).standard_normal((4, 6, 5, 3)).astype(
        np.float32)
    ref = jfeedforward.apply(_jnp(tree), jnp.asarray(x),
                             jfeedforward.FeedForwardConfig(**kw))
    model = _port(_meta(feedforward.FeedForward, cfg), tree)
    with torch.no_grad():
        _close(model(torch.from_numpy(x)), ref, LOGIT_ATOL)


@pytest.mark.parametrize("size", [12, 13])
def test_vgg_logits_match_jax(size):
    cfg = vgg.VggConfig(**VGG_CFG)
    tree = vgg.init(np.random.default_rng(0), cfg)
    x = np.random.default_rng(1).standard_normal(
        (4, size, size, 3)).astype(np.float32)
    ref = jvgg.apply(_jnp(tree), jnp.asarray(x), jvgg.VggConfig(**VGG_CFG))
    model = _port(_meta(vgg.Vgg, cfg), tree)
    with torch.no_grad():
        _close(model(torch.from_numpy(x)), ref, LOGIT_ATOL)


CNN_KNOBS = dict(epochs=1, num_stages=2, base_channels=16,
                 learning_rate=1e-3, batch_size=64, image_size=8)


def test_cnn_logits_match_jax():
    twin = _load(TEMPLATES / "torch_cnn.py")
    jax_cnn = _load(EXAMPLES / "JaxCnn.py").JaxCnn(**CNN_KNOBS)
    tree = twin.init_params(np.random.default_rng(0), 2, 16, 3, 10)
    x = np.random.default_rng(1).standard_normal((4, 8, 8, 3)).astype(
        np.float32)
    ref = jax_cnn._apply(_jnp(tree), jnp.asarray(x))
    model = _port(_meta(twin.Cnn, 2, 16, 3, 10), tree)
    with torch.no_grad():
        _close(model(torch.from_numpy(x)), ref, LOGIT_ATOL)


# ---------------------------------------------------------------------------
# carrying trees across
# ---------------------------------------------------------------------------

def _families():
    rng = np.random.default_rng(0)
    rcfg = resnet.ResNetConfig(stage_sizes=(1, 1), width=8, num_classes=10)
    twin = _load(TEMPLATES / "torch_cnn.py")
    return {
        "feedforward": (
            lambda: feedforward.FeedForward(
                feedforward.FeedForwardConfig(**FF_CFG)),
            (feedforward.init(rng, feedforward.FeedForwardConfig(**FF_CFG)),
             None)),
        "vgg": (lambda: vgg.Vgg(vgg.VggConfig(**VGG_CFG)),
                (vgg.init(rng, vgg.VggConfig(**VGG_CFG)), None)),
        "cnn": (lambda: twin.Cnn(2, 16, 3, 10),
                (twin.init_params(rng, 2, 16, 3, 10), None)),
        "resnet": (lambda: resnet.ResNet(rcfg), resnet.init(rng, rcfg)),
        "resnet-basic": (
            lambda: resnet.ResNet(dataclasses.replace(rcfg,
                                                      bottleneck=False)),
            resnet.init(rng, dataclasses.replace(rcfg, bottleneck=False))),
    }


def _same_tree(a, b):
    """Structure (dicts, lists) and every leaf's dtype and bits."""
    assert type(a) is type(b)
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _same_tree(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_tree(x, y)
    else:
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("family", list(_families()))
def test_convert_round_trips_exactly(family):
    factory, (params, state) = _families()[family]
    model = _port(_meta(factory), params, state)
    back, back_state = convert.to_jax_tree(model)
    _same_tree(back, params)
    _same_tree(back_state, state or {})
    # and through the params artifact, as the train worker writes it
    blob = sdk_params.load_params(sdk_params.dump_params(
        {"params": back, "state": back_state, "n": 10, "depth": "resnet50"}))
    _same_tree(blob["params"], params)
    assert (blob["n"], blob["depth"]) == (10, "resnet50")
    kernels = [m.kernel for m in model.modules()
               if isinstance(m, core.Conv2d)]
    assert all(k.is_contiguous(memory_format=torch.channels_last)
               for k in kernels)


def test_convert_refuses_a_mismatched_tree():
    factory, (params, state) = _families()["resnet"]
    with pytest.raises(RuntimeError):
        _port(_meta(factory), params)  # the state tree is missing
    bad = dict(params, head={"kernel": np.zeros((3, 10), np.float32),
                             "bias": np.zeros(10, np.float32)})
    with pytest.raises(RuntimeError):
        _port(_meta(factory), bad, state)


def test_vit_conversion_unchanged():
    cfg = vit.tiny()
    tree = vit.init(np.random.default_rng(0), cfg)
    model = convert.from_jax_params(tree, cfg, "cpu")
    _same_tree(convert.to_jax_params(model), tree)


def test_params_artifact_carries_python_leaves():
    tree = {"tree": {"f": 3, "t": 0.25, "lo": {"leaf": [0.5, 0.5]},
                     "hi": {"leaf": [1.0, 0.0]}},
            "rff": None, "kernel": "linear", "flag": True,
            "w": np.arange(6.0).reshape(2, 3),
            "layers": [{"kernel": np.ones((2, 2), np.float32)},
                       {"kernel": np.zeros((2, 1), np.float32)}],
            "cfg": {"in_dim": 192, "hidden_layers": 1}}
    back = sdk_params.load_params(sdk_params.dump_params(tree))
    assert back["tree"] == tree["tree"] and back["rff"] is None
    assert back["kernel"] == "linear" and back["flag"] is True
    assert back["cfg"] == tree["cfg"]
    np.testing.assert_array_equal(back["w"], tree["w"])
    _same_tree(back["layers"], tree["layers"])
    with pytest.raises(ValueError, match="reserved"):
        sdk_params.dump_params({sdk_params.LISTS: 1})


# ---------------------------------------------------------------------------
# the twins
# ---------------------------------------------------------------------------

def _image_set(tmp_path, n_train=64, n_test=32, size=32, fmt="zip"):
    """CIFAR-shaped classes: a coarse per-class pattern plus noise."""
    rng = np.random.default_rng(0)
    protos = rng.random((10, 4, 4, 3))

    def split(n, name):
        y = rng.integers(0, 10, n)
        x = np.kron(protos[y], np.ones((1, size // 4, size // 4, 1)))
        x = np.clip(x + 0.1 * rng.standard_normal(x.shape), 0, 1).astype(
            np.float32)
        if fmt == "zip":
            return write_image_files_dataset(x, y, str(tmp_path / f"{name}"
                                                       ".zip")), x
        return write_numpy_dataset(x, y.astype(np.int32),
                                   str(tmp_path / f"{name}.npz")), x

    (train, _), (test, x_test) = split(n_train, "train"), split(n_test,
                                                                 "test")
    return train, test, x_test


#: (module, class, knobs: None lets the port's advisor propose)
TWIN_CASES = [
    ("torch_feedforward", "TorchFeedForward", None),
    ("torch_cnn", "TorchCnn", dict(CNN_KNOBS, image_size=32)),
    ("torch_vgg16", "TorchVgg16", dict(epochs=2, learning_rate=1e-3,
                                       batch_size=16, depth="small",
                                       image_size=32)),
    ("torch_resnet", "TorchResNet", dict(depth="resnet18",
                                         learning_rate=1e-3, epochs=1,
                                         batch_size=64, image_size=32)),
    ("np_decision_tree", "NpDecisionTree", None),
    ("np_linear_svm", "NpLinearSvm", None),
]


@pytest.fixture(scope="module")
def image_set(tmp_path_factory):
    return _image_set(tmp_path_factory.mktemp("zoo"))


@pytest.mark.parametrize("module,class_name,knobs", TWIN_CASES,
                         ids=[c[0] for c in TWIN_CASES])
def test_model_class_contract_of_each_twin(module, class_name, knobs,
                                           image_set):
    train, test, x = image_set
    set_device_grant(["cpu"])
    try:
        preds = sdk_model.test_model_class(
            model_file_path=str(TEMPLATES / f"{module}.py"),
            model_class=class_name, task="IMAGE_CLASSIFICATION",
            train_dataset_uri=train, test_dataset_uri=test,
            queries=[x[0].tolist(), x[1].tolist()], knobs=knobs)
    finally:
        set_device_grant(None)
    assert len(preds) == 2
    for p in preds:
        assert len(p) == 10 and abs(sum(p) - 1.0) < 1e-4


@pytest.mark.parametrize("name,twin,knobs", [
    ("NpDecisionTree", "np_decision_tree",
     dict(max_depth=6, criterion="gini")),
    ("NpDecisionTree", "np_decision_tree",
     dict(max_depth=4, criterion="entropy")),
    ("NpLinearSvm", "np_linear_svm",
     dict(max_iter=10, kernel="rbf", gamma="scale", C=1.0)),
    ("NpLinearSvm", "np_linear_svm",
     dict(max_iter=12, kernel="linear", gamma="auto", C=10.0)),
])
def test_numpy_twins_predict_as_the_jax_originals(name, twin, knobs,
                                                  tmp_path):
    """The same numpy code on the same arrays: identical scores and
    predictions, also after the parameters cross the port's artifact."""
    train, test, x = _image_set(tmp_path, size=8, fmt="npz")
    theirs = getattr(_load(EXAMPLES / f"{name}.py"), name)(**dict(knobs))
    ours_cls = getattr(_load(TEMPLATES / f"{twin}.py"), name)
    ours = ours_cls(**dict(knobs))
    for m in (theirs, ours):
        m.logger.set_sink(lambda line: None)
        m.train(train)
    assert ours.evaluate(test) == theirs.evaluate(test)
    queries = x[:6].tolist()
    expect = theirs.predict(queries)
    assert ours.predict(queries) == expect
    again = ours_cls(**dict(knobs))
    again.load_parameters(sdk_params.load_params(
        sdk_params.dump_params(ours.dump_parameters())))
    assert again.predict(queries) == expect


# ---------------------------------------------------------------------------
# a TorchResNet job through the Client
# ---------------------------------------------------------------------------

#: TorchResNet at test width: both plans cut to one block a stage and 8
#: channels, on 8x8 images
_TINY_RESNET = [
    ("class TorchResNet(BaseModel):", "class TinyResNet(BaseModel):"),
    ("        return make(num_classes=num_classes, small_inputs=True)",
     "        return dataclasses.replace(\n"
     "            make(num_classes=num_classes, small_inputs=True),\n"
     "            stage_sizes=(1, 1), width=8)"),
    ("from typing import Any, Dict, List\n",
     "import dataclasses\nfrom typing import Any, Dict, List\n"),
    ('"image_size": FixedKnob(32)', '"image_size": FixedKnob(8)'),
]
#: the served ensemble against JAX's forward on the downloaded trees:
#: bf16 logits a few ulps apart (see LOGIT_ATOL), through a softmax
PROB_ATOL = 1e-2


def _tiny_resnet():
    source = (TEMPLATES / "torch_resnet.py").read_text()
    for old, new in _TINY_RESNET:
        assert source.count(old) == 1, old
        source = source.replace(old, new)
    return source.encode()


def test_tiny_resnet_cycle_through_the_client(tmp_path):
    admin = Admin(db=Database(str(tmp_path / "store.sqlite3")),
                  placement=LocalPlacementManager(ChipAllocator(["cpu"])),
                  params_dir=str(tmp_path / "params"))
    srv = AdminServer(admin, port=0).start()
    train_uri, test_uri, x = _image_set(tmp_path, size=8)
    try:
        c = Client("127.0.0.1", srv.port, timeout_s=300)
        c.login(config.SUPERADMIN_EMAIL, config.SUPERADMIN_PASSWORD)
        model = c.create_model("tiny-resnet", "IMAGE_CLASSIFICATION",
                               _tiny_resnet(), "TinyResNet")
        assert model["verification"]["ok"]
        c.create_train_job("resnet", "IMAGE_CLASSIFICATION", train_uri,
                           test_uri, budget={"MODEL_TRIAL_COUNT": 2,
                                             "CHIP_COUNT": 1})
        job = c.wait_until_train_job_stopped("resnet", timeout_s=300)
        assert job["status"] == "STOPPED"
        trials = c.get_trials_of_train_job("resnet")
        assert [t["status"] for t in trials] == ["COMPLETED"] * 2, trials
        assert all(0.0 <= t["score"] <= 1.0 for t in trials)
        blobs = [sdk_params.load_params(c.download_trial_params(t["id"]))
                 for t in trials]
        assert all(b["num_classes"] == 10 for b in blobs)

        inf = c.create_inference_job("resnet")
        assert inf["status"] == "RUNNING" and len(inf["workers"]) == 2
        probs = {n: np.asarray(c.predict("resnet", x[:n].tolist()))
                 for n in (1, 8)}
        c.stop_inference_job("resnet")
    finally:
        srv.stop()
        admin.shutdown()
    refs = []
    for blob in blobs:
        cfg = dataclasses.replace(
            (jresnet.resnet50 if blob["depth"] == "resnet50"
             else jresnet.resnet18)(num_classes=10, small_inputs=True),
            stage_sizes=(1, 1), width=8)
        logits, _ = jresnet.apply(_jnp(blob["params"]), _jnp(blob["state"]),
                                  jnp.asarray(x[:8]), cfg, train=False)
        refs.append(np.asarray(jax.nn.softmax(logits, -1)))
    ensemble = (refs[0] + refs[1]) / 2
    for n, p in probs.items():
        assert p.shape == (n, 10)
        np.testing.assert_allclose(p, ensemble[:n], atol=PROB_ATOL, rtol=0)
    # evaluation mode: the first image alone answers as in the batch
    np.testing.assert_allclose(probs[1][0], probs[8][0], atol=1e-5, rtol=0)


def test_cached_trainer_is_an_lru_per_grant(monkeypatch):
    """The JAX package's contract (``jax_backend.py:67-96``): one trainer
    per (key, grant), built once; the least recently used one goes past
    the cap; a trial's learning rate is its own, set at ``init``."""
    from rafiki_tpu_torch.sdk import torch_backend as tb

    tb.trainer_cache_clear()
    monkeypatch.setattr(tb, "_TRAINER_CACHE_CAP", 2)
    built = []

    def build():
        built.append(tb.DataParallelTrainer(
            optimizer=tb.tunable_optimizer(torch.optim.AdamW, lr=1.0),
            device="cpu"))
        return built[-1]

    set_device_grant(["cpu"])
    try:
        first = tb.cached_trainer(("Net", 1), build)
        assert tb.cached_trainer(("Net", 1), build) is first
        assert len(built) == 1
        tb.cached_trainer(("Net", 2), build)
        tb.cached_trainer(("Net", 1), build)  # now the most recent
        tb.cached_trainer(("Net", 3), build)  # evicts ("Net", 2)
        assert tb.cached_trainer(("Net", 1), build) is first
        assert len(built) == 3
        tb.cached_trainer(("Net", 2), build)
        assert len(built) == 4
        lrs = [first.init(lambda rng: torch.nn.Linear(2, 2),
                          hyperparams={"lr": lr})[1].param_groups[0]["lr"]
               for lr in (1e-3, 3e-4)]
        assert lrs == [1e-3, 3e-4]
    finally:
        set_device_grant(None)
    # another grant, another trainer
    monkeypatch.setenv("RAFIKI_VISIBLE_DEVICES", "0")
    assert tb.cached_trainer(("Net", 1), build) is not first
    tb.trainer_cache_clear()
    assert not tb._trainer_cache
