"""What the doors share with the JAX package's doors.

Own copy of the parts of ``rafiki_tpu/utils/reqfields.py`` the port's
doors use: the low-latency handler base, the bounded body read, the
server that can sever its live connections and the timeout field's check
(the host agent's, ``placement/agent.py``).
"""

from __future__ import annotations

import math
import socket
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple


class LowLatencyHandler(BaseHTTPRequestHandler):
    """Handler base that sends a response as one TCP segment.

    The stock handler writes the header lines and the body separately,
    and with Nagle on the body waits for the peer's delayed ACK of the
    headers (about 40 ms a response, even over loopback). Buffering
    ``wfile`` coalesces the response (``handle_one_request`` flushes it),
    and TCP_NODELAY covers any path that still writes more than once."""

    wbufsize = 1 << 16
    disable_nagle_algorithm = True

    def log_message(self, fmt, *args):  # the doors log through `logging`
        pass


def read_bounded_body(handler, max_mb: float):
    """``(raw_bytes, None)`` or ``(None, (status, error))``: 400 for a
    malformed or negative Content-Length (reading -1 would block until
    EOF), 413 over ``max_mb`` before a byte is read, and a broken
    ``max_mb`` (NaN or <= 0) falls back to 256 MB, the admin's default. A
    refusal closes the connection: the unread body would desync
    keep-alive."""
    if not math.isfinite(max_mb) or max_mb <= 0:
        max_mb = 256.0
    try:
        length = int(handler.headers.get("Content-Length") or 0)
    except ValueError:
        handler.close_connection = True
        return None, (400, "bad Content-Length")
    if length < 0:
        handler.close_connection = True
        return None, (400, "bad Content-Length")
    if length > max_mb * (1 << 20):
        handler.close_connection = True
        return None, (413, f"request body exceeds {max_mb:g} MB")
    return (handler.rfile.read(length) if length else b""), None


class SeveringHTTPServer(ThreadingHTTPServer):
    """A threading server whose stop can also sever the live connections.

    ``shutdown()`` and ``server_close()`` close the listener only: handler
    threads on established keep-alive connections would go on answering,
    which a killed process never does. :meth:`sever` resets every open
    connection, so a stopped door goes dark as a dead process does."""

    daemon_threads = True

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._conns: set = set()  # guarded-by: _conns_lock
        self._conns_lock = threading.Lock()

    def process_request_thread(self, request, client_address):
        with self._conns_lock:
            self._conns.add(request)
        try:
            super().process_request_thread(request, client_address)
        finally:
            with self._conns_lock:
                self._conns.discard(request)

    def handle_error(self, request, client_address):
        # a severed socket raises in its handler thread: expected
        if isinstance(sys.exc_info()[1], OSError):
            return
        super().handle_error(request, client_address)

    def sever(self) -> None:
        with self._conns_lock:
            conns = list(self._conns)
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass


def parse_timeout_s(value: object, default: float,
                    cap: Optional[float] = 300.0,
                    label: str = "timeout_s"
                    ) -> Tuple[Optional[float], Optional[str]]:
    """``(timeout_s, None)`` or ``(None, error)`` for a 400: a timeout is
    a positive finite number, clamped to ``cap`` (``None``: no clamp, for
    callers that hold the fleet key, such as the agent's relay)."""
    if value is None:
        return float(default), None
    try:
        t = float(value)
    except (TypeError, ValueError):
        return None, f"{label} must be a number"
    if not math.isfinite(t) or t <= 0:
        return None, f"{label} must be a positive finite number"
    return (t if cap is None else min(t, cap)), None
