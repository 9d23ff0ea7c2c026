"""The agent wire protocol: ``rafiki_tpu_torch/utils/agent_http.py`` against
``rafiki_tpu``'s, on the CPU.

Twins of ``tests/test_chaos_failover.py``'s chaos-schedule and transport
tests: each script runs through both packages (their own chaos modules
and breakers) and the outcomes are compared: the chaos schedule, a retry
through a transient drop, no retry of a non-idempotent call, the
breaker's states step by step, failing fast on an open circuit, a drop at
the agent reading as a dead host, and a stale epoch's 412 that is never
retried. The fake host is one stdlib HTTP server both packages call.
"""

import json
import threading
import time
import types
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from rafiki_tpu import config as jax_config
from rafiki_tpu.placement import agent as jax_agent
from rafiki_tpu.placement import manager as jax_manager
from rafiki_tpu.placement import process as jax_process
from rafiki_tpu.utils import agent_http as jax_http
from rafiki_tpu.utils import chaos as jax_chaos
from rafiki_tpu_torch import config
from rafiki_tpu_torch.placement import agent
from rafiki_tpu_torch.placement import manager
from rafiki_tpu_torch.placement import process
from rafiki_tpu_torch.utils import agent_http
from rafiki_tpu_torch.utils import chaos

PACKAGES = {
    "jax": types.SimpleNamespace(
        http=jax_http, chaos=jax_chaos, config=jax_config, agent=jax_agent,
        engine=lambda: jax_process.ProcessPlacementManager(
            allocator=jax_manager.ChipAllocator([0]))),
    "torch": types.SimpleNamespace(
        http=agent_http, chaos=chaos, config=config, agent=agent,
        engine=lambda: process.ProcessPlacementManager(
            allocator=manager.ChipAllocator(["cpu"]))),
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


class FakeHost:
    """A host agent's surface, enough for the transport: ``/healthz``,
    ``/inventory`` and a relay that counts what reached it."""

    def __init__(self):
        host = self
        host.relays = 0

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def _send(self, code, payload):
                data = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                path = self.path.split("?", 1)[0].rstrip("/")
                if path == "/healthz":
                    return self._send(200, {"status": "ok"})
                if path == "/inventory":
                    return self._send(200, {
                        "host": "fake", "total_chips": 2, "free_chips": 2,
                        "n_services": 0})
                self._send(404, {"error": "no route"})

            def do_POST(self):
                length = int(self.headers.get("Content-Length") or 0)
                body = json.loads(self.rfile.read(length) or b"{}")
                if self.path.startswith("/predict_relay/"):
                    host.relays += 1
                    return self._send(200, {"predictions": [
                        ["served", q] for q in body["queries"]]})
                self._send(404, {"error": "no route"})

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.addr = f"127.0.0.1:{self.httpd.server_address[1]}"
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def both(script):
    """``script(p)`` through each package; the two outcomes."""
    return {name: script(p) for name, p in PACKAGES.items()}


def test_chaos_rules_fire_on_the_same_schedule():
    def script(p):
        rule = p.chaos.ChaosRule(site="agent", action="drop", match="/x",
                                 after=2, times=2)
        misses = [rule.fires("call_agent", "/x"),
                  rule.fires("agent", "/other")]
        return misses + [rule.fires("agent", "/x") for _ in range(5)]

    got = both(script)
    assert got["torch"] == got["jax"] == [False, False, False, False, True,
                                          True, False]


def test_the_agent_sites_are_read_from_the_environment(monkeypatch):
    """``agent`` and ``call_agent`` are hooked sites now: an env rule is
    read, spent after ``times``, and an unknown site still refused."""
    def script(p):
        monkeypatch.setenv(p.chaos.ENV_VAR,
                           "site=agent;action=error;code=418;times=1")
        out = [p.chaos.enabled()]
        rule = p.chaos.hit(p.chaos.SITE_AGENT, "/anything")
        out += [rule.code, p.chaos.hit(p.chaos.SITE_AGENT, "/anything")]
        monkeypatch.setenv(p.chaos.ENV_VAR,
                           "site=call_agent;action=drop;match=h:1")
        out.append(p.chaos.hit(p.chaos.SITE_CALL_AGENT, "h:1 /x").action)
        monkeypatch.setenv(p.chaos.ENV_VAR, "")
        out.append(p.chaos.enabled())
        with pytest.raises(p.chaos.ChaosSpecError):
            p.chaos.parse_rules("site=nowhere;action=drop")
        return out

    got = both(script)
    assert got["torch"] == got["jax"] == [True, 418, None, "drop", False]


def test_an_idempotent_call_retries_through_a_transient_drop(monkeypatch):
    host = FakeHost()
    try:
        def script(p):
            monkeypatch.setattr(p.config, "AGENT_RETRY_BACKOFF_S", 0.01)
            p.chaos.install([p.chaos.ChaosRule(
                site="call_agent", action="drop", match=host.addr, times=1)])
            out = p.http.call_agent(host.addr, "GET", "/inventory",
                                    timeout_s=5)
            return out, p.http.get_breaker(host.addr).state

        got = both(script)
    finally:
        host.close()
    assert got["torch"] == got["jax"]
    assert got["torch"][0]["total_chips"] == 2  # the second attempt landed


def test_a_non_idempotent_call_is_never_retried():
    host = FakeHost()
    try:
        def script(p):
            p.chaos.install([p.chaos.ChaosRule(
                site="call_agent", action="drop", match=host.addr, times=1)])
            before = host.relays
            with pytest.raises(p.http.AgentTransportError):
                p.http.call_agent(host.addr, "POST", "/predict_relay/j/w",
                                  body={"queries": [1]}, timeout_s=5)
            return host.relays - before

        got = both(script)
    finally:
        host.close()
    assert got["torch"] == got["jax"] == 0


def test_the_breaker_moves_through_the_same_states():
    def script(p):
        br = p.http.CircuitBreaker(threshold=2, cooldown_s=0.15)
        out = [br.state, br.allow()]
        br.record_failure()
        out.append(br.state)
        br.record_failure()
        out += [br.state, br.allow()]
        time.sleep(0.2)
        out += [br.state, br.allow(), br.allow()]  # one probe only
        br.record_failure()  # the probe failed
        out.append(br.state)
        time.sleep(0.2)
        out.append(br.allow())
        br.record_success()  # the probe passed
        out += [br.state, br.allow()]
        return out

    got = both(script)
    assert got["torch"] == got["jax"] == [
        "CLOSED", True, "CLOSED", "OPEN", False, "HALF_OPEN", True, False,
        "OPEN", True, "CLOSED", True]


def test_an_open_circuit_fails_fast(monkeypatch):
    """An open circuit refuses in well under the transport timeout; an
    HTTP answer counts as the host alive."""
    addr = "127.0.0.1:59999"

    def script(p):
        monkeypatch.setattr(p.config, "AGENT_BREAKER_THRESHOLD", 1)
        p.chaos.install([p.chaos.ChaosRule(site="call_agent", action="drop",
                                           match=addr)])
        with pytest.raises(p.http.AgentTransportError):
            p.http.call_agent(addr, "POST", "/services", body={},
                              timeout_s=10)
        states = [p.http.get_breaker(addr).state]
        t0 = time.monotonic()
        with pytest.raises(p.http.AgentCircuitOpenError):
            p.http.call_agent(addr, "POST", "/services", body={},
                              timeout_s=10)
        fast = time.monotonic() - t0 < 0.1
        p.http.reset_breaker(addr)
        p.chaos.install([p.chaos.ChaosRule(site="call_agent",
                                           action="error", match=addr,
                                           code=503)])
        with pytest.raises(p.http.AgentHTTPError) as err:
            p.http.call_agent(addr, "GET", "/inventory", timeout_s=5)
        states.append(p.http.get_breaker(addr).state)
        return states, fast, err.value.code, sorted(
            p.http.breaker_states())

    got = both(script)
    assert got["torch"] == got["jax"] == (["OPEN", "CLOSED"], True, 503,
                                          [addr])


def test_a_drop_at_the_agent_reads_as_a_dead_host():
    """The agent-side chaos site closes the connection unanswered: the
    caller sees what a killed host gives, and after ``clear`` the agent
    answers again."""
    def script(p):
        srv = p.agent.AgentServer(p.engine(), allow_insecure=True).start()
        addr = f"127.0.0.1:{srv.port}"
        try:
            p.chaos.install([p.chaos.ChaosRule(site="agent", action="drop",
                                               match="/healthz")])
            with pytest.raises(p.http.AgentTransportError):
                p.http.call_agent(addr, "GET", "/healthz", timeout_s=5,
                                  idempotent=False, use_breaker=False)
            p.chaos.clear()
            h = p.http.call_agent(addr, "GET", "/healthz", timeout_s=5)
            # the frame versions both packages' relays send (JAX's agent
            # also lists its token-delta version, which no relay carries)
            return (h["status"], h["admin_epoch"],
                    {1, 2} <= set(h["wire_versions"]))
        finally:
            srv.stop()

    got = both(script)
    assert got["torch"] == got["jax"] == ("ok", 0, True)


def test_a_stale_epoch_is_refused_412_and_never_retried():
    """An agent that saw epoch 2 refuses a stop from epoch 1 (and one with
    no epoch) 412, once: the answer is final, even for a call marked
    idempotent; the relay is not fenced; every call reached the agent
    once (the ``agent`` site counts them)."""
    def script(p):
        srv = p.agent.AgentServer(p.engine(), key="k").start()
        addr = f"127.0.0.1:{srv.port}"
        counter = p.chaos.ChaosRule(site="agent", action="delay",
                                    delay_s=0.0)
        p.chaos.install([counter])
        out = []
        try:
            inv = p.http.call_agent(addr, "GET", "/inventory", key="k",
                                    timeout_s=5, epoch=2)
            out.append(inv["admin_epoch"])
            for epoch in (1, None):
                with pytest.raises(p.http.AgentHTTPError) as err:
                    p.http.call_agent(addr, "POST", "/services/x/stop",
                                      {"wait": False}, key="k", timeout_s=5,
                                      idempotent=True, epoch=epoch)
                out.append((err.value.code, err.value.message))
            # the new leader's stop passes
            out.append(p.http.call_agent(addr, "POST", "/services/x/stop",
                                         {"wait": False}, key="k",
                                         timeout_s=5, epoch=2))
            with pytest.raises(p.http.AgentHTTPError) as err:
                p.http.call_agent(addr, "POST", "/predict_relay/j/w",
                                  {"queries": [1]}, key="k", timeout_s=5,
                                  epoch=1)
            out.append(err.value.code)  # past the fence: no data plane
            out.append(counter.hits)
            out.append(p.http.get_breaker(addr).state)
        finally:
            srv.stop()
        return out

    got = both(script)
    assert got["torch"] == got["jax"]
    assert got["torch"][1][0] == got["torch"][2][0] == 412
    assert got["torch"][-2] == 5  # one request each, no retry


def test_the_auth_gate_answers_as_the_originals(monkeypatch):
    """A keyed agent: the right key passes, a wrong or missing one is
    401; a keyless agent refuses 403 unless insecure; ``/healthz`` and
    ``/metrics`` are open, in both packages."""
    def status(p, addr, path, key=None):
        try:
            p.http.call_agent(addr, "GET", path, key=key, timeout_s=5)
            return 200
        except p.http.AgentHTTPError as e:
            return e.code
        except ValueError:
            return 200  # answered, in Prometheus text rather than JSON

    def script(p):
        out = []
        for kw in ({"key": "sekrit"}, {}, {"allow_insecure": True}):
            srv = p.agent.AgentServer(p.engine(), **kw).start()
            addr = f"127.0.0.1:{srv.port}"
            try:
                out.append([status(p, addr, path, key)
                            for path, key in (
                                ("/inventory", "sekrit"),
                                ("/inventory", "wrong"), ("/inventory", None),
                                ("/healthz", None), ("/nowhere", "sekrit"))])
                out.append(status(p, addr, "/metrics"))
            finally:
                srv.stop()
        return out

    got = both(script)
    metrics = {name: out[1::2] for name, out in got.items()}
    assert {name: out[0::2] for name, out in got.items()}["torch"] == \
        {name: out[0::2] for name, out in got.items()}["jax"] == [
            [200, 401, 401, 200, 404], [403, 403, 403, 200, 403],
            [200, 200, 200, 200, 404]]
    assert metrics["jax"] == metrics["torch"] == [200, 200, 200]
