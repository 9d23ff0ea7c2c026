"""Observability: the metrics exposition, request traces across the shm
and relay hops, ``/fleet/health`` and the ``wire`` and ``cache`` chaos
sites, held against ``rafiki_tpu``'s on the CPU.

- The registry: one script of operations through both packages'
  ``Registry`` renders the same Prometheus text and the same JSON
  snapshot, and ``parse_prometheus`` reads it back the same; the unit
  behaviour of ``tests/test_metrics.py`` (labels, redeclaration, bucket
  math, rings, the kill switch) in both packages.
- The wire: a traceless frame is version 1 and a traced one version 2,
  byte for byte the same in both packages, and each package's frame is
  decoded by the other's ``decode_meta``.
- Request traces: hostile ``X-Rafiki-Trace`` headers, sampling and the
  exemplar rotation answer as JAX's; a sampled predict through the port's
  shm stack (door, ``Predictor``, ``ShmBroker``, a worker thread over the
  worker's own span helpers) yields JAX's span names plus the port's
  ``codec_encode``, one tree from the door through the worker and back,
  whose spans sum to 0.3-1.3x the request's wall time (JAX's drill's
  bound); an unsampled request leaves no exemplar; the door's
  ``/metrics`` carries its ``/healthz`` counters and the names JAX
  publishes.
- The relay: a sampled request's context rides the relay body and the
  agent's ``trace_spans`` are grafted back, with the port's relay against
  JAX's agent and JAX's relay against the port's agent; an agent over an
  in-process broker answers its spans, and the plain shape without a
  context.
- ``/fleet/health``: the same sections and keys as JAX's for one script
  (a train job over two agents with a trial fault injected, an inference
  job serving a request), a standby's snapshot, and the doors' gates for
  ``/metrics`` (open) and ``/fleet/health`` (admins).
- Chaos: ``wire`` and ``cache`` rules fire on the same schedule with the
  same actions and corrupt bytes; a corrupt frame is dropped typed and a
  failing cache serves the miss path.

Times are compared only where stated (the span sum's bound).
"""

import io
import json
import os
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

from rafiki_tpu.admin.standby import StandbyAdmin as JaxStandby
from rafiki_tpu.cache import fleet as jax_fleet
from rafiki_tpu.cache import queue as jax_queue
from rafiki_tpu.cache import shm_broker as jax_shm
from rafiki_tpu.cache import wire as jax_wire
from rafiki_tpu.db.database import Database as JaxDatabase
from rafiki_tpu.placement import agent as jax_agent
from rafiki_tpu.predictor import result_cache as jax_cache
from rafiki_tpu.predictor.predictor import Predictor as JaxPredictor
from rafiki_tpu.predictor.server import PredictorServer as JaxDoor
from rafiki_tpu.utils import agent_http as jax_http
from rafiki_tpu.utils import chaos as jax_chaos
from rafiki_tpu.utils import metrics as jax_metrics
from rafiki_tpu.utils import trace as jax_trace
from rafiki_tpu.worker.inference import _BatchAssembler
from rafiki_tpu_torch.admin.standby import StandbyAdmin
from rafiki_tpu_torch.cache import fleet, queue, shm_broker, wire
from rafiki_tpu_torch.db.database import Database
from rafiki_tpu_torch.placement import agent
from rafiki_tpu_torch.predictor import result_cache
from rafiki_tpu_torch.predictor.predictor import Predictor
from rafiki_tpu_torch.predictor.server import PredictorServer
from rafiki_tpu_torch.utils import agent_http, chaos, metrics
from rafiki_tpu_torch.utils import trace as rtrace
from rafiki_tpu_torch.worker import inference
from test_torch_hosts import (
    KEY,
    PACKAGES as HOSTS,
    host_placement,
    seed_app,
    spawn_host,
    superadmin,
    wait_for,
)

PACKAGES = {
    "jax": types.SimpleNamespace(
        metrics=jax_metrics, trace=jax_trace, wire=jax_wire,
        chaos=jax_chaos, http=jax_http, fleet=jax_fleet, queue=jax_queue,
        agent=jax_agent, shm=jax_shm, cache=jax_cache,
        Predictor=JaxPredictor, Door=JaxDoor),
    "torch": types.SimpleNamespace(
        metrics=metrics, trace=rtrace, wire=wire, chaos=chaos,
        http=agent_http, fleet=fleet, queue=queue, agent=agent,
        shm=shm_broker, cache=result_cache, Predictor=Predictor,
        Door=PredictorServer),
}

#: the metric names JAX publishes (tests/test_metrics.py), a contract
PUBLISHED = {
    "rafiki_admission_admitted_total",
    "rafiki_admission_shed_total",
    "rafiki_admission_inflight",
    "rafiki_admission_ewma_query_seconds",
    "rafiki_request_seconds",
    "rafiki_queue_expired_total",
    "rafiki_queue_rejected_total",
    "rafiki_predictor_hedges_total",
    "rafiki_predictor_hedges_suppressed_total",
    "rafiki_predictor_trials_shed_total",
    "rafiki_predictor_requests_shed_total",
    "rafiki_wire_errors_total",
    "rafiki_phase_seconds",
}
#: the fake worker's forward (seconds)
FORWARD_S = 0.015
#: the door-to-worker phases of one sampled predict over the shm hop
PHASES = ("admission_wait", "queue_wait", "codec_decode", "batch_assembly",
          "model_forward", "respond")


@pytest.fixture(autouse=True)
def _clean_fault_state():
    for p in PACKAGES.values():
        p.chaos.clear()
        p.http.reset_breaker()
    yield
    for p in PACKAGES.values():
        p.chaos.clear()
        p.http.reset_breaker()


# ---------------------------------------------------------------------------
# the registry and its exposition
# ---------------------------------------------------------------------------


def _registry_script(m):
    r = m.Registry()
    c = r.counter("t_requests_total", "requests", ("door", "code"))
    c.labels("predictor:a", "200").inc()
    c.labels("predictor:a", "200").inc(2)
    c.labels('hostile "door"\\\n', "429").inc()
    r.counter("t_plain_total", "no labels").inc(5)
    g = r.gauge("t_depth", "a gauge", ("service",))
    g.labels("s1").set(7)
    g.labels("s2").set(0.25)
    g.labels("s2").inc(1.5)
    h = r.histogram("t_latency_seconds", "default ladder", ("phase",))
    for v in (0.00005, 0.003, 0.003, 0.7, 12.0, 900.0):
        h.labels("model_forward").observe(v)
    h.labels("respond").observe(float("nan"))  # dropped
    hb = r.histogram("t_batch", "custom", buckets=[1, 2, 4, 8])
    for v in (1, 3, 3, 8, 9):
        hb.observe(v)
    text = r.render()
    snap = r.snapshot()["metrics"]
    got = (text, snap, r.names(), m.parse_prometheus(text),
           r.get("t_depth").kind, r.get("nope"))
    r.reset()
    return got + (r.render(), r.names())


def test_the_exposition_equals_the_originals():
    ours, theirs = _registry_script(metrics), _registry_script(jax_metrics)
    assert ours == theirs
    text = ours[0]
    assert "# TYPE t_latency_seconds histogram" in text
    assert 't_latency_seconds_bucket{phase="model_forward",le="+Inf"} 6' \
        in text
    assert ours[-2:] == ("\n", [])
    assert metrics.PROMETHEUS_CONTENT_TYPE == \
        jax_metrics.PROMETHEUS_CONTENT_TYPE


def test_a_garbled_exposition_line_is_refused_alike():
    for m in (metrics, jax_metrics):
        assert m.parse_prometheus("# HELP x\n\nx 1\n") == {"x": 1.0}
        with pytest.raises(ValueError, match="unparseable"):
            m.parse_prometheus("x one\n")


@pytest.mark.parametrize("name", sorted(PACKAGES))
def test_counter_gauge_labels_and_redeclaration(name):
    r = PACKAGES[name].metrics.Registry()
    c = r.counter("t_total", "help", ("a",))
    c.labels("x").inc()
    c.labels("x").inc(2)
    c.labels("y").inc()
    assert (c.value("x"), c.value("y")) == (3, 1)
    g = r.gauge("t_gauge", "help")
    g.set(7)
    assert g.value() == 7
    with pytest.raises(ValueError):
        r.gauge("t_total")
    with pytest.raises(ValueError):
        r.counter("t_total", "help", ("a", "b"))


@pytest.mark.parametrize("name", sorted(PACKAGES))
def test_histogram_buckets_quantiles_rings_and_the_kill_switch(
        name, monkeypatch):
    m = PACKAGES[name].metrics
    r = m.Registry()
    child = r.histogram("t_seconds", "help",
                        buckets=[0.001, 0.01, 0.1, 1.0]).labels()
    for v in (0.0005, 0.005, 0.005, 0.05, 0.5, 5.0):
        child.observe(v)
    snap = child.snapshot()
    assert snap["count"] == 6 and abs(snap["sum"] - 5.5605) < 1e-9
    assert [n for _, n in snap["buckets"]] == [1, 3, 4, 5, 6]
    assert child.quantile(0.5) == 0.01 and child.quantile(0.99) == 2.0
    ring, ring2 = r.ring("t_ring"), r.ring("t_ring2")
    ring.record(3)
    ring.record(5)  # one second: the last wins
    ring2.add(1)
    ring2.add(2)  # one second: summed
    assert ring.series()[-1][1] == 5 and ring2.series()[-1][1] == 3
    c = r.counter("t_off_total", "help")
    monkeypatch.setenv("RAFIKI_METRICS", "0")
    c.inc()
    assert c.value() == 0
    monkeypatch.delenv("RAFIKI_METRICS")
    c.inc()
    assert c.value() == 1


# ---------------------------------------------------------------------------
# the wire: version 1 without a trace, version 2 with one
# ---------------------------------------------------------------------------


def test_frames_are_byte_identical_and_cross_decode():
    body = {"ids": ["a", "b"], "qarr": np.arange(8, dtype=np.float32
                                                  ).reshape(2, 4)}
    meta = {"id": "abc123", "s": 1, "ts": 12.5}
    for trace, version in ((None, 1), (meta, 2)):
        ours, theirs = wire.encode(body, trace=trace), \
            jax_wire.encode(body, trace=trace)
        assert ours == theirs and ours[4] == version
        for decode in (wire.decode_meta, jax_wire.decode_meta):
            got, got_meta = decode(ours)
            np.testing.assert_array_equal(got["qarr"], body["qarr"])
            assert got_meta == ({} if trace is None else {"trace": meta})
    assert wire.VERSION == jax_wire.VERSION == 2
    assert wire.finish_frame(wire.prepare_frame(body), trace=meta) == \
        jax_wire.encode(body, trace=meta)
    assert wire.decode_any_meta(b'{"x": 1}') == ({"x": 1}, {}) == \
        jax_wire.decode_any_meta(b'{"x": 1}')
    frame = bytearray(wire.encode({"x": 1}))
    frame[4] = 99
    for decode in (wire.decode, jax_wire.decode):
        with pytest.raises(ValueError):
            decode(bytes(frame))


# ---------------------------------------------------------------------------
# trace contexts, sampling, exemplars
# ---------------------------------------------------------------------------


def test_hostile_headers_and_sampling_answer_alike(monkeypatch):
    headers = [None, "", "x" * 200, "../../etc;s=1", "Abc123;s=0",
               "abc123", "abc;s=1;junk", " abc ;s=1"]

    def parse(t):
        out = []
        for h in headers:
            ctx = t.TraceContext.from_header(h)
            out.append(None if ctx is None
                       else (ctx.trace_id, ctx.sampled, ctx.to_header(),
                             ctx.to_wire()))
        out.append([t.TraceContext.from_wire(w) is None for w in (
            None, {"id": 1}, "x", {"id": "a"})])
        return out

    assert parse(rtrace) == parse(jax_trace)
    for value, rate in (("", 0.0), ("garbage", 0.0), ("0.25", 0.25),
                        ("7", 1.0), ("-1", 0.0)):
        monkeypatch.setenv("RAFIKI_TRACE_SAMPLE", value)
        assert rtrace.sample_rate() == jax_trace.sample_rate() == rate
    monkeypatch.setenv("RAFIKI_TRACE_SAMPLE", "0")
    assert rtrace.start_trace(None) is None
    monkeypatch.setenv("RAFIKI_TRACE_SAMPLE", "1")
    rt = rtrace.start_trace(None)
    assert rt is not None and rt.ctx.sampled
    assert rtrace.start_trace("abc123;s=0") is None
    assert rtrace.start_trace("abc123;s=1").ctx.trace_id == "abc123"
    for value in ("", "oops", "250"):
        monkeypatch.setenv("RAFIKI_TRACE_SLOW_MS", value)
        assert rtrace.slow_threshold_s() == jax_trace.slow_threshold_s()


def test_wire_spans_round_trip_as_the_originals():
    got = {}
    for name, p in PACKAGES.items():
        rt = p.trace.RequestTrace(p.trace.TraceContext("r1", True))
        rt.t_submit = rt.t0 + 0.5
        rt.add_wire_spans([["queue_wait", 0.001, 0.004],
                           ["model_forward", 0.005, 0.01], ["bad"], 7])
        rt.mark_dequeued(rt.t0 + 1.0)
        rt.mark_dequeued(rt.t0 + 2.0)  # once only
        got[name] = (rt.wire_spans(rt.t0), rt.phase_durations())
    assert got["torch"] == got["jax"]


@pytest.mark.parametrize("name", sorted(PACKAGES))
def test_the_exemplar_file_rotates(tmp_workdir, monkeypatch, name):
    t = PACKAGES[name].trace
    monkeypatch.setenv("RAFIKI_TRACE_EXEMPLAR_MAX_MB", "1")
    path = t.exemplar_path()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write("x" * (1 << 20))
    rt = t.RequestTrace(t.TraceContext("r0tate"))
    rt.add_span("x", rt.t0, rt.t0 + 0.1)
    t.record_exemplar(rt, 0.1, door="t")
    assert os.path.exists(path + ".1")
    assert os.path.getsize(path) < (1 << 19)
    (line,) = open(path).read().splitlines()
    assert set(json.loads(line)) == {"trace_id", "ts", "door", "e2e_s",
                                     "spans"}


# ---------------------------------------------------------------------------
# the shm stack: door -> predictor -> ShmBroker -> a worker thread
# ---------------------------------------------------------------------------


def _worker_loop(p, wq, stop):
    """The serve loop's span instrumentation over one queue: the port's
    own helpers (``_trace_sinks``, ``_assemble``), JAX's as its drill."""
    assembler = _BatchAssembler() if p is PACKAGES["jax"] else None
    while not stop.is_set():
        batch = wq.take_batch(max_size=64, deadline_s=0.0,
                              wait_timeout_s=0.1)
        if batch is None:
            return
        if not batch:
            continue
        futures = [f for f, _ in batch]
        if assembler is None:
            sinks = inference._trace_sinks(futures)
        else:
            sinks = []
            for f in futures:
                s = getattr(f, "trace", None)
                if s is not None and all(x is not s for x in sinks):
                    sinks.append(s)
        t0 = time.monotonic()
        qs = (inference._assemble([q for _, q in batch]) if assembler is None
              else assembler.assemble([q for _, q in batch],
                                      reusable=False))
        t1 = time.monotonic()
        for s in sinks:
            s.add_span("batch_assembly", t0, t1)
        out = np.asarray(qs, dtype=np.float32) * 2.0
        # a forward's width: ViT-B/16's one-image forward on the H100
        # (chip_smoke.py phase 20b), so the scheduling gaps a loaded host
        # adds between the hops stay a share of the request, as on a card
        time.sleep(FORWARD_S)
        t2 = time.monotonic()
        for s in sinks:
            s.add_span("model_forward", t1, t2)
        for fut, row in zip(futures, out):
            fut.set_result(row)


def _shm_stack(name, app):
    p = PACKAGES[name]
    broker = p.shm.ShmBroker()
    wq = broker.register_worker("mjob", "w1")
    stop = threading.Event()
    threading.Thread(target=_worker_loop, args=(p, wq, stop),
                     daemon=True).start()
    server = p.Door(p.Predictor("mjob", broker, task=None), app,
                    auth=False).start()

    def cleanup():
        stop.set()
        server.stop(drain_timeout_s=0.0)
        broker.close()

    return server, cleanup


def _binary_predict(port, header=None):
    buf = io.BytesIO()
    np.save(buf, np.ones((1, 16), dtype=np.float32), allow_pickle=False)
    headers = {"Content-Type": "application/x-npy"}
    if header:
        headers[rtrace.TRACE_HEADER] = header
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/predict", data=buf.getvalue(),
        headers=headers, method="POST")
    t0 = time.monotonic()
    with urllib.request.urlopen(req, timeout=30) as r:
        body = json.loads(r.read())
        return (time.monotonic() - t0, body,
                r.headers.get(rtrace.TRACE_HEADER))


def _exemplar(t, trace_id):
    path = t.exemplar_path()
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline:
        if os.path.exists(path):
            for line in open(path).read().splitlines():
                ex = json.loads(line)
                if ex["trace_id"] == trace_id:
                    return ex
        time.sleep(0.02)
    raise AssertionError(f"no exemplar for {trace_id}")


def test_a_sampled_predict_yields_the_cross_hop_span_tree(tmp_path,
                                                          monkeypatch):
    """One sampled predict over the binary shm path in each package: one
    tree from the door through the worker and back. The port's names are
    JAX's and ``codec_encode``; the spans sum to at least 0.3x the
    door's end-to-end time and at most 1.3x the client's (the bound of
    JAX's drill)."""
    names = {}
    for name, p in PACKAGES.items():
        monkeypatch.setenv("RAFIKI_WORKDIR", str(tmp_path / name))
        server, cleanup = _shm_stack(name, f"tracedrill{name}")
        try:
            _binary_predict(server.port)  # warm
            trace_id = ("feedbeef" if name == "jax" else "beefcafe") * 4
            e2e_s, body, echoed = _binary_predict(
                server.port, header=f"{trace_id};s=1")
            assert echoed == f"{trace_id};s=1"
            assert body["data"]["predictions"] == [[2.0] * 16]
            ex = _exemplar(p.trace, trace_id)
        finally:
            cleanup()
        names[name] = {s["name"] for s in ex["spans"]}
        total = sum(s["duration_s"] for s in ex["spans"])
        assert ex["door"] == f"predictor:tracedrill{name}"
        if name == "torch":
            assert set(PHASES) <= names[name]
            assert total <= e2e_s * 1.3
            assert total >= ex["e2e_s"] * 0.3, (total, ex)
    assert names["torch"] - {"codec_encode"} == names["jax"]
    assert "codec_encode" in names["torch"]


def test_an_unsampled_request_leaves_no_exemplar(tmp_workdir):
    server, cleanup = _shm_stack("torch", "unsampled")
    try:
        _, _, echoed = _binary_predict(server.port)
        assert echoed is None
        assert not os.path.exists(rtrace.exemplar_path())
    finally:
        cleanup()


def test_the_doors_metrics_carry_its_healthz_counters_and_the_names(
        tmp_workdir, monkeypatch):
    """The job's door: ``/metrics`` holds the counters ``/healthz`` shows,
    ``?format=json`` the snapshot with the rings, and after one sampled
    request the registry holds every name JAX publishes."""
    monkeypatch.setenv("RAFIKI_TRACE_SAMPLE", "1")
    server, cleanup = _shm_stack("torch", "paritymetrics")
    try:
        for _ in range(3):
            _binary_predict(server.port)
        base = f"http://127.0.0.1:{server.port}"
        with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
            assert r.headers["Content-Type"].startswith("text/plain")
            samples = metrics.parse_prometheus(r.read().decode())
        with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
            adm = json.loads(r.read())["admission"]
        with urllib.request.urlopen(base + "/metrics?format=json",
                                    timeout=10) as r:
            snap = json.loads(r.read())
    finally:
        cleanup()
    door = 'door="predictor:paritymetrics"'
    assert samples[f"rafiki_admission_admitted_total{{{door}}}"] \
        == adm["admitted"] == 3
    assert samples[f"rafiki_admission_inflight{{{door}}}"] == adm["inflight"]
    assert samples[f'rafiki_admission_shed_total{{{door},'
                   f'reason="capacity"}}'] == adm["shed_capacity"] == 0
    ewma = samples[f"rafiki_admission_ewma_query_seconds{{{door}}}"]
    assert abs(ewma - adm["ewma_query_s"]) < 1e-3
    assert samples[f"rafiki_request_seconds_count{{{door}}}"] == 3
    assert "rings" in snap and "metrics" in snap
    missing = PUBLISHED - set(metrics.REGISTRY.names())
    assert not missing, f"published metric names missing: {missing}"


# ---------------------------------------------------------------------------
# the relay hop
# ---------------------------------------------------------------------------


class _Served:
    """An agent engine whose one in-process worker answers each query and
    records a ``model_forward`` span into a sampled request's trace."""

    def __init__(self, p):
        self.broker = p.queue.InProcessBroker()
        self._runners = {}
        self.q = self.broker.register_worker("rjob", "w1")
        threading.Thread(target=self._serve, daemon=True).start()

    def _serve(self):
        while True:
            batch = self.q.take_batch(16, 0.0, 0.1)
            if batch is None:
                return
            for fut, query in batch:
                sink = getattr(fut, "trace", None)
                if sink is not None:
                    now = time.monotonic()
                    sink.add_span("model_forward", now, now + 0.001)
                fut.set_result(query)

    def list_services(self):
        return []

    def stop_all(self):
        self.q.close()


@pytest.mark.parametrize("relay,agent_of", [
    ("torch", "jax"), ("jax", "torch"), ("torch", "torch")])
def test_the_relay_forwards_the_trace_and_grafts_the_agents_spans(
        relay, agent_of):
    """A sampled request relayed to an agent of either package: the
    context rides the body, the agent's spans come back and join the
    request's tree; a request without a context is served the same."""
    r, a = PACKAGES[relay], PACKAGES[agent_of]
    engine = _Served(a)
    srv = a.agent.AgentServer(engine, key=KEY).start()
    addr = f"127.0.0.1:{srv.port}"
    q = r.fleet.HttpWorkerQueue(addr, "rjob", "w1", key=KEY)
    try:
        rt = r.trace.RequestTrace(r.trace.TraceContext("re1ay", True))
        futs = q.submit_many([[1.0]], trace=rt)
        assert np.asarray(futs[0].result(10.0)).tolist() == [1.0]
        names = {s.name for s in rt.spans}
        assert {"queue_wait", "model_forward"} <= names
        plain = q.submit_many([[3.0]])
        assert np.asarray(plain[0].result(10.0)).tolist() == [3.0]
        out = a.http.call_agent(addr, "POST", "/predict_relay/rjob/w1",
                                body={"queries": [[2.0]]}, key=KEY)
        assert "trace_spans" not in out
    finally:
        q.close()
        engine.stop_all()
        srv.stop()


def test_an_agent_answers_its_spans_as_the_original():
    got = {}
    for name, p in PACKAGES.items():
        engine = _Served(p)
        srv = p.agent.AgentServer(engine, key=KEY).start()
        addr = f"127.0.0.1:{srv.port}"
        try:
            out = p.http.call_agent(
                addr, "POST", "/predict_relay/rjob/w1",
                body={"queries": [[2.0]],
                      "trace": {"id": "abc999", "s": 1}}, key=KEY)
            unsampled = p.http.call_agent(
                addr, "POST", "/predict_relay/rjob/w1",
                body={"queries": [[2.0]],
                      "trace": {"id": "abc999", "s": 0}}, key=KEY)
            got[name] = (out["predictions"],
                         [s[0] for s in out["trace_spans"]],
                         all(len(s) == 3 for s in out["trace_spans"]),
                         sorted(unsampled))
        finally:
            engine.stop_all()
            srv.stop()
    assert got["torch"] == got["jax"]
    assert got["torch"][1] == ["queue_wait", "model_forward"]


# ---------------------------------------------------------------------------
# /fleet/health
# ---------------------------------------------------------------------------


def _keys(obj, depth):
    """The key structure of ``obj`` to ``depth`` levels (values set
    aside)."""
    if depth == 0 or not isinstance(obj, dict):
        return None
    return {k: _keys(v, depth - 1) for k, v in obj.items()}


def _fleet_health(p, tmp_path):
    """Two agents; a train job over them whose first trial attempt is
    failed by chaos and retried; an inference job that serves one
    request. Returns the health's structure, with ids replaced."""
    db = p.Database(str(tmp_path / f"{p.name}.sqlite3"))
    hosts = [spawn_host(p, db, [i]) for i in range(2)]
    placement = host_placement(p, [h[2] for h in hosts], db)
    admin = p.Admin(db=db, placement=placement,
                    params_dir=str(tmp_path / p.name))
    try:
        uid = superadmin(p, admin)
        p.chaos.install(p.chaos.parse_rules(
            "site=trial;action=error;times=1"))
        job = seed_app(p, admin, uid, "app", trials=1, chips=1)
        assert job["status"] == "STOPPED"
        admin.create_inference_job(uid, "app")
        assert admin.predict(uid, "app", [[0.1]])
        health = admin.get_fleet_health()
    finally:
        admin.shutdown()
        for engine, srv, _ in hosts:
            srv.stop()
            engine.stop_all()
    serving = health["serving"]
    (job_row,) = serving["jobs"].values()
    return {
        "top": sorted(health),
        "sections": {k: _keys(v, 1) for k, v in health.items()
                     if k not in ("agents", "serving", "training")},
        "agent_rows": [sorted(row) for row in health["agents"].values()],
        "agents_down": health["agents_down"],
        "chaos_active": health["chaos_active"],
        "serving": sorted(serving),
        "serving_job": sorted(job_row),
        "serving_job_status": job_row["status"],
        "admission": sorted(serving["admission"]),
        "prediction_cache": sorted(serving["prediction_cache"]),
        "training": sorted(health["training"]),
        "placement": health["placement"],
    }


def test_fleet_health_has_the_originals_sections_and_keys(tmp_path):
    got = {name: _fleet_health(p, tmp_path) for name, p in HOSTS.items()}
    assert got["torch"] == got["jax"]
    assert got["torch"]["top"] == sorted([
        "placement", "agents", "agents_down", "chaos_active", "recovery",
        "ha", "autoscaler", "warm_pool", "rollouts", "drift", "serving",
        "training"])
    assert got["torch"]["serving"] == sorted([
        "jobs", "admission", "fair_shares", "workers", "generation",
        "prediction_cache"])
    assert len(got["torch"]["agent_rows"]) == 2
    assert got["torch"]["chaos_active"] is True
    assert got["torch"]["serving_job_status"] == "ok"


def test_a_standby_answers_its_snapshot_as_the_original(tmp_path):
    got = {}
    for name, (db_cls, standby_cls) in {
            "jax": (JaxDatabase, JaxStandby),
            "torch": (Database, StandbyAdmin)}.items():
        path = str(tmp_path / f"{name}.sqlite3")
        db_cls(path)
        standby = standby_cls(db_cls(path), factory=lambda le: None,
                              poll_s=0.05)
        try:
            assert wait_for(
                lambda: standby.get_fleet_health()["snapshot"], 5.0)
            health = standby.get_fleet_health()
        finally:
            standby.shutdown()
        got[name] = (sorted(health), sorted(health["ha"]),
                     sorted(health["snapshot"]), health["standby"])
    assert got["torch"] == got["jax"]


def _door_statuses(admin_cls, server_cls, p, tmp_path):
    admin = admin_cls(db=p.Database(str(tmp_path / f"{p.name}-d.sqlite3")),
                      placement=p.manager.LocalPlacementManager(
                          allocator=p.manager.ChipAllocator(p.chips([0]))),
                      params_dir=str(tmp_path / f"{p.name}-d"))
    srv = server_cls(admin, port=0).start()
    base = f"http://127.0.0.1:{srv.port}"

    def status(path, token=None):
        req = urllib.request.Request(base + path)
        if token:
            req.add_header("Authorization", f"Bearer {token}")
        try:
            with urllib.request.urlopen(req, timeout=10) as r:
                return r.status, r.headers["Content-Type"].split(";")[0]
        except urllib.error.HTTPError as e:
            return e.code, None

    try:
        admin.create_user("dev@x", "pw", "APP_DEVELOPER")
        su = admin.authenticate_user(p.config.SUPERADMIN_EMAIL,
                                     p.config.SUPERADMIN_PASSWORD)["token"]
        dev = admin.authenticate_user("dev@x", "pw")["token"]
        out = [status("/metrics"), status("/metrics?format=json"),
               status("/fleet/health"), status("/fleet/health", dev),
               status("/fleet/health", su)]
        admin._recovery = {"state": "recovering"}  # the recovery gate
        out += [status("/metrics"), status("/fleet/health", su),
                status("/trials/nope/trace", su)]
        admin._recovery = {"state": "ready"}
        out.append(status("/trials/nope/trace", su))
        return out
    finally:
        srv.stop()
        admin.shutdown()


def test_the_doors_gate_metrics_and_fleet_health_as_the_originals(
        tmp_path):
    got = {name: _door_statuses(p.Admin, p.AdminServer, p, tmp_path)
           for name, p in HOSTS.items()}
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == (200, "text/plain")
    assert got["torch"][4][0] == 200 and got["torch"][2][0] == 401


# ---------------------------------------------------------------------------
# the wire and cache chaos sites
# ---------------------------------------------------------------------------


def test_wire_and_cache_rules_fire_alike():
    script = ("site=wire;action=corrupt;match=-q;every=2|"
              "site=cache;action=error;match=/lookup;after=1;times=2|"
              "site=cache;action=delay;match=/fill;delay_s=0")
    targets = [("wire", "/rafiki1-q"), ("wire", "/rafiki1-r"),
               ("wire", "/rafiki1-q"), ("wire", "/rafiki1-q"),
               ("cache", "j/lookup"), ("cache", "j/lookup"),
               ("cache", "j/fill"), ("cache", "j/lookup"),
               ("cache", "j/lookup"), ("cache", "j/join")]
    raw = wire.encode({"ids": ["a"], "qarr": np.arange(40, dtype=np.int32)})
    got = {}
    for name, p in PACKAGES.items():
        p.chaos.install(p.chaos.parse_rules(script))
        out = []
        for site, target in targets:
            rule = p.chaos.hit(site, target)
            out.append(None if rule is None else rule.action)
            if rule is not None and rule.action == "corrupt":
                out.append(p.chaos.corrupt_bytes(raw, rule))
        got[name] = out
        p.chaos.clear()
    assert got["torch"] == got["jax"]
    assert got["torch"].count("corrupt") == 2
    assert {"wire", "cache"} <= set(chaos.HOOKED_SITES)


def test_a_corrupt_frame_is_dropped_typed_on_both_rings():
    broker = shm_broker.ShmBroker()
    try:
        wq = broker.register_worker("cjob", "w1")
        proxy = broker.get_worker_queues("cjob")["w1"]
        before = metrics.REGISTRY.counter(
            "rafiki_wire_errors_total").value()
        chaos.install(chaos.parse_rules(
            "site=wire;action=corrupt;times=1"))
        futs = proxy.submit_many([[1.0]], deadline=time.monotonic() + 0.5)
        assert wq.take_batch(8, 0.0, wait_timeout_s=2.0) == []
        assert wq.stats()["wire_errors"] == 1
        with pytest.raises(TimeoutError):
            futs[0].result(2.0)
        # the response ring: the listener drops it, the request times out
        rq = broker._response_qs["cjob"]
        chaos.install(chaos.parse_rules(
            f"site=wire;action=corrupt;match={rq.name};times=1"))
        futs = proxy.submit_many([[2.0]], deadline=time.monotonic() + 5)
        (handle, query), = wq.take_batch(8, 0.0, wait_timeout_s=2.0)
        handle.set_result(query)
        with pytest.raises(TimeoutError):
            futs[0].result(1.0)
        assert wait_for(lambda: broker.stats()["wire_errors"] == 1, 5.0)
        assert metrics.REGISTRY.counter(
            "rafiki_wire_errors_total").value() == before + 2
    finally:
        chaos.clear()
        broker.close()


def test_a_failing_cache_serves_the_miss_path(monkeypatch):
    """``site=cache`` errors at every operation: the predictor answers
    from the worker, and the absorbed faults count, as JAX's do."""
    monkeypatch.setenv("RAFIKI_PREDICT_CACHE", "1")
    monkeypatch.setattr(jax_cache, "_CACHE", jax_cache.ResultCache(),
                        raising=False)
    got = {}
    for name, p in PACKAGES.items():
        b = p.queue.InProcessBroker()
        q = b.register_worker(f"cache-{name}", "w1")
        stop = threading.Event()

        def serve(q=q, stop=stop):
            while not stop.is_set():
                batch = q.take_batch(16, 0.0, 0.1)
                for fut, query in batch or []:
                    fut.set_result([float(query[0]) * 2.0])

        threading.Thread(target=serve, daemon=True).start()
        errors = p.metrics.REGISTRY.counter("rafiki_cache_errors_total")
        before = errors.value()
        p.chaos.install(p.chaos.parse_rules("site=cache;action=error"))
        try:
            pred = p.Predictor(f"cache-{name}", b, task=None)
            got[name] = (pred.predict_batch([[1.0], [2.0]], timeout_s=5),
                         pred.predict_batch([[1.0]], timeout_s=5),
                         errors.value() - before > 0)
        finally:
            p.chaos.clear()
            stop.set()
            q.close()
    assert got["torch"] == got["jax"] == (
        [[2.0], [4.0]], [[2.0]], True)
