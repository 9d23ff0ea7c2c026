"""The one wire protocol for talking to host agents (``placement/agent.py``).

Own copy of ``rafiki_tpu/utils/agent_http.py``. The control plane
(``placement/hosts.py``'s ``_AgentHandle``) and the serving data plane
(``cache/fleet.py``'s ``HttpWorkerQueue``) both call agents through
:func:`call_agent`, and map its two error types onto their own:

- **bounded retry** with exponential backoff and full jitter, for
  idempotent calls only (GETs by default; a caller asserts it for a POST
  such as ``/services/<id>/stop``). A non-idempotent call never retries:
  the caller owns an ambiguous create;
- a **circuit breaker** per agent: ``AGENT_BREAKER_THRESHOLD`` transport
  failures in a row open it, and every call then fails at once with
  :class:`AgentCircuitOpenError` instead of waiting out the transport
  timeout; after ``AGENT_BREAKER_COOLDOWN_S`` one half-open probe goes
  through, and its outcome closes or opens the circuit again. An HTTP
  error is a success to the breaker (the host answered);
- the agent key (``X-Rafiki-Agent-Key``) and the admin's leadership epoch
  (``X-Rafiki-Admin-Epoch``) ride every call; an agent that has seen a
  newer epoch refuses a mutation with :data:`STALE_EPOCH_STATUS`, which
  is an answer and never retried;
- the ``call_agent`` chaos site fires inside the attempt loop, so an
  injected fault goes through the retry and the breaker as a real one.

A data-plane body may travel as one binary wire frame (``wire_frames``,
``cache/wire.py``); an answer is sniffed either way.
"""

from __future__ import annotations

import http.client
import json
import logging
import random
import threading
import time
import urllib.error
import urllib.request
from typing import Any, Dict, Optional

from rafiki_tpu_torch import config
from rafiki_tpu_torch.cache import wire
from rafiki_tpu_torch.utils import chaos
from rafiki_tpu_torch.utils.jsonutil import json_default
from rafiki_tpu_torch.utils.metrics import REGISTRY

logger = logging.getLogger(__name__)

AGENT_KEY_HEADER = "X-Rafiki-Agent-Key"
ADMIN_EPOCH_HEADER = "X-Rafiki-Admin-Epoch"
#: Precondition Failed: a mutation from an admin older than the newest
#: epoch the agent has seen; typed, never retried
STALE_EPOCH_STATUS = 412

BREAKER_CLOSED = "CLOSED"
BREAKER_OPEN = "OPEN"
BREAKER_HALF_OPEN = "HALF_OPEN"


class AgentHTTPError(Exception):
    """The agent answered with an error status."""

    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code
        self.message = message


class AgentTransportError(Exception):
    """The agent could not be reached (connect, timeout, socket error, a
    garbled answer)."""


class AgentCircuitOpenError(AgentTransportError):
    """Refused at once: this agent's circuit is open. Nothing went on the
    wire."""


class CircuitBreaker:
    """CLOSED, then OPEN after ``threshold`` transport failures in a row,
    then HALF_OPEN once ``cooldown_s`` has passed, where exactly one probe
    call is let through; its outcome closes or opens the circuit."""

    def __init__(self, threshold: int, cooldown_s: float):
        self.threshold = max(int(threshold), 1)
        self.cooldown_s = float(cooldown_s)
        self._lock = threading.Lock()
        self._failures = 0  # guarded-by: _lock
        self._state = BREAKER_CLOSED  # guarded-by: _lock
        self._opened_at = 0.0  # guarded-by: _lock
        self._probing = False  # guarded-by: _lock

    @property
    def state(self) -> str:
        with self._lock:
            if (self._state == BREAKER_OPEN
                    and time.monotonic() - self._opened_at >= self.cooldown_s):
                return BREAKER_HALF_OPEN
            return self._state

    def allow(self) -> bool:
        """May a call go now? Half open, one probe at a time."""
        with self._lock:
            if self._state == BREAKER_CLOSED:
                return True
            if self._state == BREAKER_HALF_OPEN:
                if self._probing:
                    return False
                self._probing = True
                return True
            if time.monotonic() - self._opened_at >= self.cooldown_s:
                self._state = BREAKER_HALF_OPEN
                self._probing = True
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._state = BREAKER_CLOSED
            self._probing = False

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            if (self._state != BREAKER_CLOSED
                    or self._failures >= self.threshold):
                self._state = BREAKER_OPEN
                self._opened_at = time.monotonic()
                self._probing = False


_breakers: Dict[str, CircuitBreaker] = {}  # guarded-by: _breakers_lock
_breakers_lock = threading.Lock()


def get_breaker(addr: str) -> CircuitBreaker:
    with _breakers_lock:
        br = _breakers.get(addr)
        if br is None:
            br = _breakers[addr] = CircuitBreaker(
                config.AGENT_BREAKER_THRESHOLD,
                config.AGENT_BREAKER_COOLDOWN_S)
        return br


def reset_breaker(addr: Optional[str] = None) -> None:
    """Close one agent's breaker (its heartbeat came back), or with no
    address drop every breaker."""
    with _breakers_lock:
        if addr is None:
            _breakers.clear()
        elif addr in _breakers:
            _breakers[addr].record_success()


def breaker_states() -> Dict[str, str]:
    with _breakers_lock:
        return {addr: br.state for addr, br in _breakers.items()}


def _raw_call(addr: str, method: str, path: str,
              body: Optional[Dict[str, Any]], key: Optional[str],
              timeout_s: float, wire_frames: bool = False,
              epoch: Optional[int] = None) -> Dict[str, Any]:
    rule = chaos.hit(chaos.SITE_CALL_AGENT, f"{addr} {path}")
    if rule is not None:
        if rule.action == chaos.ACTION_DELAY:
            chaos.sleep_for(rule)
        elif rule.action == chaos.ACTION_DROP:
            raise AgentTransportError(f"{addr}: chaos-injected drop")
        elif rule.action == chaos.ACTION_ERROR:
            raise AgentHTTPError(rule.code, "chaos-injected error")
    data = None
    ctype = "application/json"
    if body is not None:
        if wire_frames:
            data = wire.encode(body)
            ctype = wire.CONTENT_TYPE
        else:
            data = json.dumps(body, default=json_default).encode()
    req = urllib.request.Request(f"http://{addr}{path}", data=data,
                                 method=method)
    req.add_header("Content-Type", ctype)
    if key:
        req.add_header(AGENT_KEY_HEADER, key)
    if epoch is not None:
        req.add_header(ADMIN_EPOCH_HEADER, str(int(epoch)))
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as resp:
            raw = resp.read() or b"{}"
            if wire.is_frame(raw):
                try:
                    return wire.decode(raw)
                except wire.WireFormatError as e:
                    raise AgentTransportError(
                        f"{addr}: garbled wire response: {e}") from e
            return json.loads(raw)
    except urllib.error.HTTPError as e:
        try:
            message = json.loads(e.read() or b"{}").get("error", str(e))
        except (ValueError, TypeError, AttributeError):
            message = str(e)
        raise AgentHTTPError(e.code, message) from e
    except (urllib.error.URLError, OSError, TimeoutError,
            http.client.HTTPException) as e:
        # HTTPException: a truncated or garbled answer, a half-dead host
        raise AgentTransportError(f"{addr}: {e}") from e


def call_agent(addr: str, method: str, path: str,
               body: Optional[Dict[str, Any]] = None,
               key: Optional[str] = None, timeout_s: float = 10.0,
               idempotent: Optional[bool] = None, use_breaker: bool = True,
               wire_frames: bool = False,
               epoch: Optional[int] = None) -> Dict[str, Any]:
    """One request to a host agent, with retry and circuit breaking.

    ``idempotent`` (default: GETs only) retries transport failures.
    ``use_breaker=False`` is the heartbeat's: its probes must reach the
    wire whatever the breaker says, since they decide recovery.
    ``wire_frames`` sends the body as one binary frame (the data plane,
    once the agent advertised a codec version). ``epoch`` stamps the
    admin's leadership epoch."""
    if idempotent is None:
        idempotent = method.upper() == "GET"
    breaker = get_breaker(addr) if use_breaker else None
    if breaker is not None and not breaker.allow():
        raise AgentCircuitOpenError(
            f"{addr}: circuit open (agent recently unreachable; next probe "
            f"within {breaker.cooldown_s:.1f}s)")
    attempts = 1 + (config.AGENT_RETRY_MAX if idempotent else 0)
    backoff = config.AGENT_RETRY_BACKOFF_S
    last: Optional[AgentTransportError] = None
    for attempt in range(attempts):
        if attempt:
            # full jitter: callers of one recovering agent spread out
            time.sleep(backoff * (2 ** (attempt - 1))
                       * random.uniform(0.5, 1.5))
        try:
            out = _raw_call(addr, method, path, body, key, timeout_s,
                            wire_frames=wire_frames, epoch=epoch)
        except AgentHTTPError:
            if breaker is not None:
                breaker.record_success()  # the host answered
            raise
        except AgentTransportError as e:
            last = e
            REGISTRY.counter(
                "rafiki_agent_transport_failures_total",
                "agent calls that failed at the transport layer").inc()
            if breaker is not None:
                breaker.record_failure()
                if attempt + 1 < attempts and not breaker.allow():
                    break  # a retry never tunnels through an open circuit
            if attempt + 1 < attempts:
                logger.info("agent %s transport failure (%s); retry %d/%d",
                            addr, e, attempt + 1, attempts - 1)
            continue
        except BaseException:
            # a half-open probe slot must come back whatever happened
            if breaker is not None:
                breaker.record_failure()
            raise
        if breaker is not None:
            breaker.record_success()
        return out
    assert last is not None
    raise last
