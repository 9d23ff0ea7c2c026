"""The serving data plane across hosts: ``rafiki_tpu_torch/cache/fleet.py``
against ``rafiki_tpu``'s, on the CPU.

Twins of ``tests/test_fleet_serving.py``'s relay-queue tests and
``tests/test_chaos_failover.py``'s broker tests, each script through both
packages' ``HttpWorkerQueue``/``FleetBroker`` against one stub agent: a
relay round trip and its coalescing, a worker error and an unreachable
agent, local and remote queues merged, a dead agent's queues evicted,
close. Then the relay through real agents: each package's relay queue
against each package's ``AgentServer`` (a worker served from an
in-process queue), in JSON and in binary frames, with the same answers;
the relay's refusals (404, 400, 429, 504) as JSON.
"""

import json
import socket
import threading
import time
import types
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from rafiki_tpu import config as jax_config
from rafiki_tpu.cache import fleet as jax_fleet
from rafiki_tpu.cache import queue as jax_queue
from rafiki_tpu.placement import agent as jax_agent
from rafiki_tpu.placement import manager as jax_manager
from rafiki_tpu.utils import agent_http as jax_http
from rafiki_tpu.utils import chaos as jax_chaos
from rafiki_tpu_torch import config
from rafiki_tpu_torch.cache import fleet
from rafiki_tpu_torch.cache import queue
from rafiki_tpu_torch.placement import agent
from rafiki_tpu_torch.placement import manager
from rafiki_tpu_torch.utils import agent_http
from rafiki_tpu_torch.utils import chaos

PACKAGES = {
    "jax": types.SimpleNamespace(
        fleet=jax_fleet, queue=jax_queue, agent=jax_agent, http=jax_http,
        chaos=jax_chaos, config=jax_config,
        allocator=lambda: jax_manager.ChipAllocator([0])),
    "torch": types.SimpleNamespace(
        fleet=fleet, queue=queue, agent=agent, http=agent_http, chaos=chaos,
        config=config, allocator=lambda: manager.ChipAllocator(["cpu"])),
}


@pytest.fixture(autouse=True)
def _clean_fault_state():
    for p in PACKAGES.values():
        p.chaos.clear()
        p.http.reset_breaker()
    yield
    for p in PACKAGES.values():
        p.chaos.clear()
        p.http.reset_breaker()


def both(script):
    return {name: script(p) for name, p in PACKAGES.items()}


class StubAgent:
    """A ``/predict_relay`` that answers each query with [query, index of
    the relay that carried it], so coalescing shows."""

    def __init__(self, fail_with=None, delay_s=0.0):
        stub = self
        stub.batches = []
        stub.fail_with = fail_with
        stub.delay_s = delay_s

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def do_POST(self):
                length = int(self.headers.get("Content-Length") or 0)
                body = json.loads(self.rfile.read(length))
                if stub.delay_s:
                    time.sleep(stub.delay_s)
                if stub.fail_with is not None:
                    data = json.dumps({"error": stub.fail_with}).encode()
                    self.send_response(502)
                else:
                    idx = len(stub.batches)
                    stub.batches.append(body["queries"])
                    data = json.dumps({"predictions": [
                        [q, idx] for q in body["queries"]]}).encode()
                    self.send_response(200)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.addr = f"127.0.0.1:{self.httpd.server_address[1]}"
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def test_a_relay_round_trip_coalesces_a_burst():
    def script(p):
        stub = StubAgent(delay_s=0.05)
        q = p.fleet.HttpWorkerQueue(stub.addr, "job1", "w1")
        try:
            futs = [q.submit(i) for i in range(10)]
            results = [f.result(10.0) for f in futs]
        finally:
            q.close()
            stub.close()
        return ([r[0] for r in results], len(stub.batches) < 10,
                sum(len(b) for b in stub.batches))

    got = both(script)
    assert got["torch"] == got["jax"] == (list(range(10)), True, 10)


def test_a_worker_error_and_an_unreachable_agent_fail_the_futures():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        dead = f"127.0.0.1:{s.getsockname()[1]}"

    def script(p):
        stub = StubAgent(fail_with="worker exploded")
        out = []
        for addr in (stub.addr, dead):
            q = p.fleet.HttpWorkerQueue(addr, "job1", "w1", timeout_s=2.0)
            try:
                with pytest.raises(RuntimeError) as err:
                    q.submit([1.0]).result(10.0)
                msg = str(err.value)
                out.append(("worker exploded" in msg, "unreachable" in msg))
            finally:
                q.close()
        stub.close()
        return out

    got = both(script)
    assert got["torch"] == got["jax"] == [(True, False), (False, True)]


def test_a_full_relay_queue_sheds_admin_side(monkeypatch):
    """``RAFIKI_PREDICT_QUEUE_DEPTH`` counts pending and in-flight queries
    of a relay queue: past it a submit raises QueueFullError."""
    def script(p):
        monkeypatch.setenv("RAFIKI_PREDICT_QUEUE_DEPTH", "3")
        stub = StubAgent(delay_s=0.3)
        q = p.fleet.HttpWorkerQueue(stub.addr, "job1", "w1")
        try:
            futs = q.submit_many([1, 2, 3])
            with pytest.raises(p.queue.QueueFullError):
                q.submit(4)
            answers = [f.result(10.0)[0] for f in futs]
            stats = q.stats()
        finally:
            q.close()
            stub.close()
        return answers, stats["rejected"]

    got = both(script)
    assert got["torch"] == got["jax"] == ([1, 2, 3], 1)


def test_the_fleet_broker_merges_evicts_and_closes():
    def script(p):
        stub = StubAgent()
        broker = p.fleet.FleetBroker(p.queue.InProcessBroker())
        out = []
        try:
            local_q = broker.register_worker("job1", "local-w")
            broker.register_remote_worker("job1", "remote-w", stub.addr)
            queues = broker.get_worker_queues("job1")
            out.append(sorted(queues))
            out.append(queues["remote-w"].submit(7).result(10.0))
            broker.unregister_worker("job1", "remote-w")
            broker.unregister_worker("job1", "local-w")
            out.append(broker.get_worker_queues("job1"))
            with pytest.raises(RuntimeError):
                local_q.submit_many([1])[0].result(1.0)
            # a dead host's relay queues leave the fan-out
            q_dead = broker.register_remote_worker("job", "w-dead",
                                                   "10.0.0.1:1")
            broker.register_remote_worker("job", "w-live", "10.0.0.2:1")
            broker.register_worker("job", "local")
            out.append(broker.evict_agent("10.0.0.1:1"))
            out.append(sorted(broker.get_worker_queues("job")))
            with pytest.raises(RuntimeError, match="closed"):
                q_dead.submit(1).result(1.0)
            out.append(broker.prefix)
            rq = broker.register_remote_worker("job2", "w", stub.addr)
        finally:
            broker.close()
            broker.close()  # idempotent
            stub.close()
        with pytest.raises(RuntimeError, match="closed"):
            rq.submit(1).result(1.0)
        out.append(rq._thread.is_alive())
        return out

    got = both(script)
    assert got["torch"] == got["jax"] == [
        ["local-w", "remote-w"], [7, 0], {}, [("job", "w-dead")],
        ["local", "w-live"], None, False]


class Engine:
    """A host agent's engine with one serving worker: an in-process queue
    served by a thread (each answer is ``[sum(query), len(batch)]``),
    enough for the relay."""

    def __init__(self, p, fail=False, stall=False):
        self.broker = p.queue.InProcessBroker()
        self.allocator = p.allocator()
        self._runners = {}
        self.q = self.broker.register_worker("job", "w")
        self.fail, self.stall = fail, stall
        self.batches = []
        self.row_types = []  # of every query served
        self._stop = threading.Event()
        threading.Thread(target=self._serve, daemon=True).start()

    def _serve(self):
        while not self._stop.is_set():
            batch = self.q.take_batch(64, 0.0, 0.05)
            if not batch:
                continue
            self.batches.append(len(batch))
            self.row_types += [type(entry[1]).__name__ for entry in batch]
            if self.stall:
                continue
            for entry in batch:
                fut, query = entry[0], entry[1]
                if self.fail:
                    fut.set_error(RuntimeError("model exploded"))
                else:
                    fut.set_result([float(np.sum(query)), len(batch)])

    def list_services(self):
        return []

    def stop_all(self):
        self._stop.set()
        self.q.close()


def _relay(p_client, addr, queries, binary_ok=True):
    q = p_client.fleet.HttpWorkerQueue(addr, "job", "w", key="k")
    try:
        if not binary_ok:
            q._wire_ok = False
        out = [f.result(10.0) for f in q.submit_many(queries)]
        return out, bool(q._wire_ok)
    finally:
        q.close()


@pytest.mark.parametrize("client", ["jax", "torch"])
@pytest.mark.parametrize("server", ["jax", "torch"])
def test_the_relay_answers_the_same_through_either_agent(client, server):
    """A batch of image-shaped rows through ``client``'s relay queue and
    ``server``'s agent: binary frames once the agent advertised them
    (answered in kind), JSON otherwise, and the same answers all four
    ways."""
    rng = np.random.default_rng(0)
    rows = [rng.standard_normal((4, 4, 3)).astype(np.float32)
            for _ in range(5)]
    engine = Engine(PACKAGES[server])
    srv = PACKAGES[server].agent.AgentServer(engine, key="k").start()
    addr = f"127.0.0.1:{srv.port}"
    try:
        binary = _relay(PACKAGES[client], addr, rows)
        plain = _relay(PACKAGES[client], addr, [r.tolist() for r in rows],
                       binary_ok=False)
    finally:
        srv.stop()
    assert binary[1] is True and plain[1] is False
    expect = [[float(np.sum(r)), 5] for r in rows]
    for answers, _ in (binary, plain):
        assert [a[1] for a in answers] == [5] * 5  # one worker batch
        np.testing.assert_allclose([a[0] for a in answers],
                                   [e[0] for e in expect], rtol=1e-5)


def test_the_relays_refusals_are_json_and_typed():
    """The agent's relay answers 404 for an unknown worker, 400 for an
    empty body, 502 for a worker error (no traceback), 504 past the
    relay's deadline and 429 when the worker's queue is full: the same
    codes in both packages."""
    def script(p):
        out = []
        for kind in ("ok", "fail", "stall"):
            engine = Engine(p, fail=kind == "fail", stall=kind == "stall")
            srv = p.agent.AgentServer(engine, key="k").start()
            addr = f"127.0.0.1:{srv.port}"

            def call(path, body):
                try:
                    p.http.call_agent(addr, "POST", path, body, key="k",
                                      timeout_s=10)
                    return 200, None
                except p.http.AgentHTTPError as e:
                    return e.code, "Traceback" in e.message

            try:
                if kind == "ok":
                    out.append(call("/predict_relay/job/nobody",
                                    {"queries": [1]}))
                    out.append(call("/predict_relay/job/w", {"queries": []}))
                    out.append(call("/predict_relay/job/w",
                                    {"queries": [1], "timeout_s": "x"}))
                    engine.q._max_depth = 1
                    out.append(call("/predict_relay/job/w",
                                    {"queries": [1, 2]}))
                elif kind == "fail":
                    out.append(call("/predict_relay/job/w",
                                    {"queries": [1]}))
                else:
                    out.append(call("/predict_relay/job/w",
                                    {"queries": [1], "timeout_s": 0.3}))
            finally:
                srv.stop()
        return out

    got = both(script)
    assert got["torch"] == got["jax"] == [
        (404, False), (400, False), (400, False), (429, False),
        (502, False), (504, False)]


def test_json_rows_cross_a_binary_relay_as_one_array():
    """A difference from the original (ROADMAP.md, C): JSON rows that
    form one float array (what the admin door's JSON body decodes to)
    cross the port's binary relay as that array, float64, as the shm
    rings carry them, and the worker gets ndarray rows; the original
    sends them as JSON text inside the frame and its worker gets lists.
    The answers agree, and a sampled ``trace`` field of the body gets the
    agent's spans back as ``trace_spans`` in both packages, with the same
    span names."""
    rows = [[float(i), float(i) + 0.5, -1.0] for i in range(4)]
    seen = {}
    for name, p in PACKAGES.items():
        engine = Engine(p)
        srv = p.agent.AgentServer(engine, key="k").start()
        addr = f"127.0.0.1:{srv.port}"
        try:
            answers, binary = _relay(p, addr, rows)
            relayed = sorted(set(engine.row_types))
            out = p.http.call_agent(
                addr, "POST", "/predict_relay/job/w",
                {"queries": rows[:1], "trace": {"id": "abc123", "s": 1}},
                key="k", timeout_s=10)
            seen[name] = (binary, [a[0] for a in answers], relayed,
                          sorted({s[0] for s in out["trace_spans"]})
                          if "trace_spans" in out else None)
        finally:
            srv.stop()
    assert seen["torch"][0] is seen["jax"][0] is True
    np.testing.assert_allclose(seen["torch"][1], seen["jax"][1])
    assert seen["torch"][2] == ["ndarray"] and seen["jax"][2] == ["list"]
    assert seen["torch"][3] == seen["jax"][3]
    assert "queue_wait" in seen["torch"][3]
