"""What the admin door shares with the JAX package's doors.

Own copy of the parts of ``rafiki_tpu/utils/reqfields.py`` the admin door
uses: the low-latency handler base and the bounded body read.
"""

from __future__ import annotations

import math
from http.server import BaseHTTPRequestHandler


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
