"""Package rules of ``rafiki_tpu_torch``: what it may import, and that its
entry points never fall back to the CPU quietly.

The import ban is checked statically, over the source: this test process
imports JAX itself (and some environments pre-import it), so a
``sys.modules`` check could not tell.
"""

import ast
import threading
from pathlib import Path

import pytest
import torch

import rafiki_tpu_torch
from rafiki_tpu_torch import device
from rafiki_tpu_torch.sdk.model import InvalidModelClassError, load_model_class

ROOT = Path(rafiki_tpu_torch.__file__).resolve().parents[1]
BANNED = ("jax", "jaxlib", "flax", "optax", "msgpack", "rafiki_tpu")


def _sources():
    files = sorted((ROOT / "rafiki_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _banned_imports(path):
    found = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            if name.split(".")[0] in BANNED:  # rafiki_tpu_torch passes
                found.append(f"{path.name}:{node.lineno} imports {name}")
    return found


def test_sources_are_found():
    names = {p.relative_to(ROOT).as_posix() for p in _sources()}
    assert {"chip_smoke.py", "rafiki_tpu_torch/ops/flash_attention.py",
            "rafiki_tpu_torch/predictor/server.py"} <= names


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_and_nothing_of_rafiki_tpu(path):
    assert _banned_imports(path) == []


def test_the_ban_catches_what_it_should(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import jax.numpy as jnp\nfrom rafiki_tpu.ops import x\n"
                   "from rafiki_tpu_torch import config\nimport optax\n")
    assert [f.split(" imports ")[1] for f in _banned_imports(bad)] == [
        "jax.numpy", "rafiki_tpu.ops", "optax"]


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    monkeypatch.delenv("RAFIKI_VISIBLE_DEVICES", raising=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        device.default_device()
    with pytest.raises(RuntimeError):
        device.default_device("cuda:0")
    monkeypatch.setenv("RAFIKI_VISIBLE_DEVICES", "0")
    with pytest.raises(RuntimeError):
        device.default_device()
    assert device.default_device("cpu") == torch.device("cpu")


def test_default_device_with_cuda(monkeypatch):
    """With cards present: cuda:0, or the granted index."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.delenv("RAFIKI_VISIBLE_DEVICES", raising=False)
    assert device.default_device() == torch.device("cuda", 0)
    assert device.default_device("cuda") == torch.device("cuda", 0)
    monkeypatch.setenv("RAFIKI_VISIBLE_DEVICES", "2,3")
    assert device.visible_devices() == [torch.device("cuda", 2),
                                        torch.device("cuda", 3)]
    assert device.default_device() == torch.device("cuda", 2)
    with pytest.raises(RuntimeError, match="only 4"):
        device.default_device(7)


def test_grant_is_per_thread(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    seen = {}

    def worker(name, grant):
        device.set_device_grant(grant)
        ctx = device.ServiceContext(name, chips=grant)
        seen[name] = (device.default_device(), ctx.device(),
                      device.get_device_grant())

    threads = [threading.Thread(target=worker, args=("a", [1])),
               threading.Thread(target=worker, args=("b", ["cpu"]))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert seen["a"][:2] == (torch.device("cuda", 1),) * 2
    assert seen["b"][:2] == (torch.device("cpu"),) * 2
    assert seen["b"][2] == (torch.device("cpu"),)
    assert device.get_device_grant() is None  # this thread was never granted


def test_service_context():
    calls = []
    ctx = device.ServiceContext("s", chips=["cpu"],
                                on_ready=lambda: calls.append(1))
    assert not ctx.stopping
    ctx.ready()
    ctx.stop_event.set()
    assert ctx.stopping and calls == [1]


@pytest.mark.parametrize("source,name,match", [
    (b"class M:\n    pass\n", "M", "subclass"),
    (b"x = 1\n", "M", "not found"),
])
def test_load_model_class_refuses(source, name, match):
    with pytest.raises(InvalidModelClassError, match=match):
        load_model_class(source, name)


def test_load_model_class_takes_the_template():
    path = ROOT / "rafiki_tpu_torch" / "templates" / "torch_vit.py"
    clazz = load_model_class(path.read_bytes(), "TorchViT")
    assert clazz.get_knob_config()["dim"].value == 768
