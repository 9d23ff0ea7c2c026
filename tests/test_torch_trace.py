"""Trial tracing and device profiling: ``rafiki_tpu_torch/utils/trace.py``
and the train worker's spans against ``rafiki_tpu``'s, on the CPU.

The scripts of ``tests/test_trace.py`` run through both packages:

- spans nest per tracer and thread, save in start order and read back;
  ``summary`` sums by name (names, depths, attributes and order are
  compared between the packages; durations only as lower bounds);
- the profile is a no-op without ``RAFIKI_PROFILE`` in both packages,
  and a profiler that fails to start is logged while the body runs;
- a trial through each package's stack (``Admin`` + ``AdminServer`` +
  ``Client``, the fake template of ``tests/fixtures/fake_model.py`` and
  its twin) saves the same span names, served by ``get_trial_trace``,
  and the same ``trace_*_s`` phase record in the trial's log;
- under ``RAFIKI_PROFILE=1`` a tiny-ViT trial through the port's stack
  writes ``LOGS_DIR/profiles/trial-<id>-<pid>.json``, a Chrome trace
  that holds the train step's operators (its forward and backward
  matmuls and the optimizer step); JAX writes an xplane directory there
  instead, which is not compared.
"""

import json
import logging
import os
import time
from pathlib import Path

import pytest

from rafiki_tpu.admin.admin import Admin as JaxAdmin
from rafiki_tpu.admin.http import AdminServer as JaxAdminServer
from rafiki_tpu.client.client import Client as JaxClient
from rafiki_tpu.db.database import Database as JaxDatabase
from rafiki_tpu.placement import manager as jax_manager
from rafiki_tpu.utils import trace as jax_trace
from rafiki_tpu_torch import config
from rafiki_tpu_torch.admin.admin import Admin
from rafiki_tpu_torch.admin.http import AdminServer
from rafiki_tpu_torch.client.client import Client
from rafiki_tpu_torch.db.database import Database
from rafiki_tpu_torch.placement.manager import (
    ChipAllocator,
    LocalPlacementManager,
)
from rafiki_tpu_torch.utils import trace
from test_torch_stack import FAKE_TEMPLATE, JAX_FAKE, _dataset, _tiny_template

PACKAGES = {"jax": jax_trace, "torch": trace}
PHASES = {"propose", "train", "evaluate", "persist_params"}


def _nested(t):
    with t.span("outer"):
        time.sleep(0.01)
        with t.span("inner", detail="x"):
            time.sleep(0.01)
    return t


@pytest.mark.parametrize("name", sorted(PACKAGES))
def test_span_timing_and_nesting(tmp_workdir, name):
    t = _nested(PACKAGES[name].Tracer("t1"))
    spans = {s.name: s for s in t.spans}
    assert spans["outer"].depth == 0 and spans["inner"].depth == 1
    assert spans["inner"].attrs == {"detail": "x"}
    # durations: lower bounds only (the sleeps)
    assert spans["outer"].duration_s >= spans["inner"].duration_s >= 0.01
    rows = [json.loads(line) for line in open(t.save())]
    assert [r["name"] for r in rows] == ["outer", "inner"]


def test_saved_rows_have_the_originals_shape(tmp_workdir):
    """The same script saves rows with the same keys, names, depths and
    attributes in the same order in both packages (times set aside)."""
    got = {}
    for name, p in PACKAGES.items():
        _nested(p.Tracer(f"shape-{name}")).save()
        got[name] = [{k: v for k, v in r.items()
                      if k not in ("start", "end", "duration_s")}
                     for r in p.load_trace(f"shape-{name}")]
        assert set(p.load_trace(f"shape-{name}")[0]) == {
            "name", "start", "end", "duration_s", "depth"}
    assert got["torch"] == got["jax"]
    assert trace.trace_path("x") == jax_trace.trace_path("x")


@pytest.mark.parametrize("name", sorted(PACKAGES))
def test_trace_roundtrip(tmp_workdir, name):
    p = PACKAGES[name]
    t = p.Tracer("trial-xyz")
    with t.span("train"):
        pass
    t.save()
    assert os.path.exists(p.trace_path("trial-xyz"))
    rows = p.load_trace("trial-xyz")
    assert len(rows) == 1 and rows[0]["name"] == "train"
    assert p.load_trace("nonexistent") == []


@pytest.mark.parametrize("name", sorted(PACKAGES))
def test_summary_sums_by_name(tmp_workdir, name):
    t = PACKAGES[name].Tracer("t2")
    for _ in range(3):
        with t.span("step"):
            time.sleep(0.005)
    s = t.summary()
    assert set(s) == {"step"} and s["step"] >= 0.015


def test_the_profile_is_a_noop_without_the_variable(tmp_workdir,
                                                    monkeypatch):
    monkeypatch.delenv("RAFIKI_PROFILE", raising=False)
    assert trace.profiling_enabled() is jax_trace.profiling_enabled() \
        is False
    with trace.torch_profile("x") as out, jax_trace.jax_profile() as jout:
        assert out is None and jout is None
    assert not os.path.exists(trace.profile_dir())
    for value, on in (("0", False), ("false", False), ("1", True)):
        monkeypatch.setenv("RAFIKI_PROFILE", value)
        assert trace.profiling_enabled() is jax_trace.profiling_enabled() \
            is on


def test_a_profiler_that_fails_to_start_is_logged(tmp_workdir, monkeypatch,
                                                  caplog):
    import torch.profiler

    def refuse(*a, **k):
        raise RuntimeError("profiler busy")

    monkeypatch.setattr(torch.profiler, "profile", refuse)
    ran = []
    with caplog.at_level(logging.ERROR, logger=trace.__name__):
        with trace.torch_profile("x", force=True) as out:
            ran.append(out)
    assert ran == [None]
    assert "torch profiler failed to start" in caplog.text


def _run_trial(client_cls, port, template, cls, tmp_path, uris=None):
    """One trial through a live door; (its trace, its phase record)."""
    c = client_cls("127.0.0.1", port)
    c.login(config.SUPERADMIN_EMAIL, config.SUPERADMIN_PASSWORD)
    path = tmp_path / "template.py"
    path.write_bytes(template)
    c.create_model("m", "IMAGE_CLASSIFICATION", str(path), cls)
    train_uri, test_uri = uris or ("u://t", "u://e")
    c.create_train_job("app", "IMAGE_CLASSIFICATION", train_uri, test_uri,
                       budget={"MODEL_TRIAL_COUNT": 1, "CHIP_COUNT": 1})
    deadline = time.monotonic() + 300
    while c.get_train_job("app")["status"] not in ("STOPPED", "ERRORED"):
        assert time.monotonic() < deadline
        time.sleep(0.1)
    (trial,) = c.get_trials_of_train_job("app")
    assert trial["status"] == "COMPLETED", trial
    logs = c.get_trial_logs(trial["id"])
    phases = [m for m in logs["metrics"] if "trace_train_s" in m]
    return trial["id"], c.get_trial_trace(trial["id"]), phases


def test_trial_trace_through_the_stack(tmp_path, monkeypatch):
    """A train job records a trace a trial, served over REST, in both
    packages: the same four phase spans at depth 0, the same phase
    record in the trial's log."""
    got = {}
    for name in ("jax", "torch"):
        tmp = tmp_path / name
        tmp.mkdir()
        monkeypatch.setenv("RAFIKI_WORKDIR", str(tmp))
        if name == "jax":
            admin = JaxAdmin(db=JaxDatabase(str(tmp / "s.sqlite3")),
                             placement=jax_manager.LocalPlacementManager(
                                 allocator=jax_manager.ChipAllocator([0])),
                             params_dir=str(tmp / "params"))
            srv = JaxAdminServer(admin, port=0).start()
            client_cls, template = JaxClient, JAX_FAKE.read_bytes()
        else:
            admin = Admin(db=Database(str(tmp / "s.sqlite3")),
                          placement=LocalPlacementManager(
                              ChipAllocator(["cpu"])),
                          params_dir=str(tmp / "params"))
            srv = AdminServer(admin, port=0).start()
            client_cls, template = Client, FAKE_TEMPLATE
        try:
            tid, spans, phases = _run_trial(client_cls, srv.port, template,
                                            "FakeModel", tmp)
        finally:
            srv.stop()
            admin.shutdown()
        assert Path(tmp / "logs" / f"trace-{tid}.jsonl").exists()
        got[name] = (sorted((s["name"], s["depth"]) for s in spans),
                     [sorted(p) for p in phases])
    assert got["torch"] == got["jax"]
    assert {n for n, _ in got["torch"][0]} == PHASES
    assert got["torch"][1] == [sorted(["time"] + [f"trace_{p}_s"
                                                  for p in PHASES])]


def test_a_profiled_trial_writes_a_chrome_trace_of_its_steps(tmp_path,
                                                             monkeypatch):
    """``RAFIKI_PROFILE=1``: the tiny ViT's trial through the port's stack
    writes a Chrome trace under ``LOGS_DIR/profiles`` holding its train
    steps' operators: forward and backward matmuls and the optimizer's
    step (on the card the same capture holds K1-LSE, K2 and K3 by name,
    ``chip_smoke.py`` phase 20a)."""
    monkeypatch.setenv("RAFIKI_WORKDIR", str(tmp_path))
    monkeypatch.setenv("RAFIKI_PROFILE", "1")
    admin = Admin(db=Database(str(tmp_path / "s.sqlite3")),
                  placement=LocalPlacementManager(ChipAllocator(["cpu"])),
                  params_dir=str(tmp_path / "params"))
    srv = AdminServer(admin, port=0).start()
    try:
        tid, spans, _ = _run_trial(Client, srv.port, _tiny_template(),
                                   "TinyViT", tmp_path,
                                   uris=_dataset(tmp_path))
    finally:
        srv.stop()
        admin.shutdown()
    assert {s["name"] for s in spans} == PHASES
    (path,) = (tmp_path / "logs" / "profiles").glob(f"trial-{tid}-*.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n in ("aten::mm", "aten::addmm", "aten::bmm") for n in names)
    assert any("Backward" in n for n in names), "no backward in the capture"
    assert any(n.startswith("Optimizer.step") for n in names)
