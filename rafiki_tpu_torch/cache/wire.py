"""Versioned binary wire codec of the serving data plane.

Own copy of ``rafiki_tpu/cache/wire.py``: the request and response frames
that cross the shm rings, byte for byte the original's, so either
package decodes the other's frames. ndarrays travel as raw C-contiguous
bytes behind a small JSON header and decode as zero-copy
``np.frombuffer`` views into the frame.

Frame layout (integers little-endian)::

    [0:4]    magic  b"\\xabRWF"   (0xAB cannot start UTF-8 JSON text,
                                   so frames and JSON bodies are
                                   told apart on one byte)
    [4]      version (1; 2 when trace metadata rides the header)
    [5]      reserved (0)
    [6:10]   u32 header length H
    [10:10+H] header JSON: {"b": <body>,
                            "a": [[dtype, shape, off, nbytes], ...]}
    ...      zero padding to a 16-byte boundary
    [P:]     array payload region; each array 16-byte aligned, ``off``
             relative to P

The body is any JSON-able structure in which each ndarray was replaced by
the placeholder ``{"\\u0000nd": k}`` (an index into the array table).
Dtypes are stored as ``np.dtype.str``, byte order included. Dict keys that
collide with the placeholder are escaped, so an untrusted JSON query
cannot forge an array reference. Values that are not numeric or bool
ndarrays (strings, dicts, object arrays) stay in the JSON header through
:func:`~rafiki_tpu_torch.utils.jsonutil.json_default`; :func:`decode_any`
sniffs the magic and falls back to ``json.loads``. Every malformed input
raises :class:`WireFormatError`.

The token-delta frames of streamed generation are version 3: a frame
whose header carries a ``"g"`` key (``{"sid": sequence id, "fin":
finished, "reason": ..., "err": ...}``) and whose one array is the
delta's int32 token ids (:func:`encode_token_delta`,
:func:`decode_token_delta`). The streaming door sends them to a client
that asks for ``CONTENT_TYPE``; no ring carries them, so :func:`decode`
(request and response frames) refuses version 3 typed.

Not ported: trace metadata on the encoding side (the tracer is not
ported; a version-2 frame's ``"t"`` is still decoded), the sender's
JSON framing switch ``RAFIKI_WIRE_BINARY`` (the port sends frames only;
its receivers still take JSON), and the result cache's
``canonical_digest``.
"""

from __future__ import annotations

import json
from typing import Any, List

import numpy as np

from rafiki_tpu_torch.utils.jsonutil import json_default

MAGIC = b"\xabRWF"
#: versions this receiver decodes: 1, and 2 (a "t" trace key in the
#: header, which is read and set aside)
SUPPORTED_VERSIONS = frozenset({1, 2})
#: the version byte of a token-delta frame
TOKEN_DELTA_VERSION = 3
#: the media type a client names in ``Accept`` to get token-delta frames
CONTENT_TYPE = "application/x-rafiki-wire"
_ALIGN = 16

# placeholder and escape sentinels: NUL cannot appear in sane user keys,
# but a hostile JSON query may send it, hence the escape
_ND_KEY = "\x00nd"
_ESC_KEY = "\x00esc"

# dtype kinds that travel as raw bytes (bool, (u)int, float, complex)
_BINARY_KINDS = frozenset("biufc")


class WireFormatError(ValueError):
    """A frame failed to parse (truncated, garbled, unknown version)."""


def _pad16(n: int) -> int:
    return (-n) % _ALIGN


def _strip_arrays(obj: Any, arrays: List[np.ndarray]) -> Any:
    """Replace every binary-kind ndarray in ``obj`` with a placeholder,
    collecting the (C-contiguous) arrays; escape colliding dict keys."""
    if isinstance(obj, np.ndarray):
        if obj.dtype.kind in _BINARY_KINDS:
            a = np.ascontiguousarray(obj)
            if a.shape != obj.shape:  # ascontiguousarray promotes 0-d to 1-d
                a = a.reshape(obj.shape)
            arrays.append(a)
            return {_ND_KEY: len(arrays) - 1}
        return obj.tolist()  # str/object arrays: the JSON escape hatch
    if isinstance(obj, np.generic):
        if obj.dtype.kind in _BINARY_KINDS:
            arrays.append(np.asarray(obj))  # 0-d array
            return {_ND_KEY: len(arrays) - 1}
        return obj.item()
    if isinstance(obj, dict):
        out = {k: _strip_arrays(v, arrays) for k, v in obj.items()}
        if _ND_KEY in obj or _ESC_KEY in obj:
            # a user dict that looks like a placeholder must never decode
            # as one
            return {_ESC_KEY: out}
        return out
    if isinstance(obj, (list, tuple)):
        return [_strip_arrays(v, arrays) for v in obj]
    return obj


def _restore_arrays(obj: Any, views: List[np.ndarray]) -> Any:
    if isinstance(obj, dict):
        if _ND_KEY in obj:
            try:
                return views[int(obj[_ND_KEY])]
            except (IndexError, TypeError, ValueError) as e:
                raise WireFormatError(f"bad array reference: {e}") from e
        if _ESC_KEY in obj:
            inner = obj[_ESC_KEY]
            if not isinstance(inner, dict):
                raise WireFormatError("bad escape wrapper")
            return {k: _restore_arrays(v, views) for k, v in inner.items()}
        return {k: _restore_arrays(v, views) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_restore_arrays(v, views) for v in obj]
    return obj


def encode(obj: Any) -> bytes:
    """One version-1 frame for ``obj`` (any JSON-able structure, ndarrays
    at any depth). Raises TypeError for leaves that are neither."""
    arrays: List[np.ndarray] = []
    body = _strip_arrays(obj, arrays)
    table = []
    off = 0
    for a in arrays:
        off += _pad16(off)
        table.append([a.dtype.str, list(a.shape), off, a.nbytes])
        off += a.nbytes
    header = json.dumps({"b": body, "a": table},
                        default=json_default).encode()
    pieces = [MAGIC, bytes([1, 0]), len(header).to_bytes(4, "little"),
              header, b"\x00" * _pad16(len(MAGIC) + 2 + 4 + len(header))]
    pos = 0
    for a, (_, _, o, _) in zip(arrays, table):
        if o > pos:
            pieces.append(b"\x00" * (o - pos))
            pos = o
        pieces.append(a.tobytes())  # C-contiguous by construction
        pos += a.nbytes
    return b"".join(pieces)


def is_frame(raw: bytes) -> bool:
    return len(raw) >= 4 and raw[:4] == MAGIC


def decode(raw: bytes) -> Any:
    """Decode one frame. Array leaves come back as read-only zero-copy
    views into ``raw`` (they keep the frame alive); callers that mutate
    must copy."""
    return _decode(raw, SUPPORTED_VERSIONS)[0]


def _decode(raw: bytes, versions: frozenset) -> tuple:
    """(body, header) of one frame of one of ``versions``."""
    if not is_frame(raw):
        raise WireFormatError("not a wire frame (bad magic)")
    if len(raw) < 10:
        raise WireFormatError("truncated frame header")
    if raw[4] not in versions:
        raise WireFormatError(f"unsupported wire version {raw[4]}")
    hlen = int.from_bytes(raw[6:10], "little")
    if 10 + hlen > len(raw):
        raise WireFormatError("truncated frame (header extent)")
    try:
        header = json.loads(raw[10:10 + hlen])
        body, table = header["b"], header["a"]
    except (ValueError, KeyError, TypeError, UnicodeDecodeError) as e:
        raise WireFormatError(f"garbled frame header: {e}") from e
    payload = memoryview(raw)[10 + hlen + _pad16(10 + hlen):]
    if not isinstance(table, list):
        raise WireFormatError("garbled array table")
    views: List[np.ndarray] = []
    for entry in table:
        try:
            dtype_str, shape, off, nbytes = entry
            dt = np.dtype(dtype_str)
            shape = tuple(int(s) for s in shape)
            off, nbytes = int(off), int(nbytes)
        except (ValueError, TypeError) as e:
            raise WireFormatError(f"garbled array entry: {e}") from e
        if dt.kind not in _BINARY_KINDS:
            raise WireFormatError(f"non-binary dtype {dtype_str!r} on wire")
        if any(s < 0 for s in shape):
            raise WireFormatError("negative array dimension")
        # a Python-int product: a hostile shape like [2**32, 2**32] must
        # not wrap to 0 and slip past the extent check
        expected = dt.itemsize
        for s in shape:
            expected *= s
        if nbytes != expected or off < 0 or off + nbytes > len(payload):
            raise WireFormatError("array extent out of range")
        try:
            views.append(np.frombuffer(
                payload[off:off + nbytes], dtype=dt).reshape(shape))
        except ValueError as e:  # numpy's own refusals
            raise WireFormatError(f"bad array extent: {e}") from e
    return _restore_arrays(body, views), header


def decode_any(raw: bytes) -> Any:
    """The receiver's sniff: a binary frame goes to :func:`decode`,
    anything else is parsed as JSON (the legacy framing)."""
    if is_frame(raw):
        return decode(raw)
    try:
        return json.loads(raw)
    except (ValueError, UnicodeDecodeError) as e:
        raise WireFormatError(f"neither wire frame nor JSON: {e}") from e


def encode_token_delta(seq_id: str, tokens, finished: bool = False,
                       reason: Any = None, error: Any = None) -> bytes:
    """One version-3 token-delta frame: the sequence id, this increment's
    token ids (int32), the finished flag and, on the terminal delta, the
    reason and the typed error's text."""
    arr = np.ascontiguousarray(np.asarray(list(tokens), dtype=np.int32))
    g: dict = {"sid": str(seq_id), "fin": bool(finished)}
    if reason is not None:
        g["reason"] = str(reason)
    if error is not None:
        g["err"] = str(error)
    table = [[arr.dtype.str, list(arr.shape), 0, arr.nbytes]]
    header = json.dumps({"b": {_ND_KEY: 0}, "a": table, "g": g}).encode()
    return b"".join([
        MAGIC, bytes([TOKEN_DELTA_VERSION, 0]),
        len(header).to_bytes(4, "little"), header,
        b"\x00" * _pad16(len(MAGIC) + 2 + 4 + len(header)),
        arr.tobytes()])


def is_token_delta(raw: bytes) -> bool:
    """A frame whose version byte marks a token delta (validated in
    :func:`decode_token_delta`)."""
    return is_frame(raw) and len(raw) >= 5 and raw[4] == TOKEN_DELTA_VERSION


def decode_token_delta(raw: bytes):
    """``(seq_id, TokenDelta)`` of one token-delta frame; every malformed
    shape raises :class:`WireFormatError`."""
    from rafiki_tpu_torch.cache.queue import TokenDelta

    body, header = _decode(raw, frozenset({TOKEN_DELTA_VERSION}))
    g = header.get("g") if isinstance(header, dict) else None
    if not isinstance(g, dict):
        raise WireFormatError("frame carries no token-delta metadata")
    sid, fin = g.get("sid"), g.get("fin")
    if not isinstance(sid, str) or not isinstance(fin, bool):
        raise WireFormatError("garbled token-delta metadata (sid/fin)")
    reason, err = g.get("reason"), g.get("err")
    if ((reason is not None and not isinstance(reason, str))
            or (err is not None and not isinstance(err, str))):
        raise WireFormatError("garbled token-delta metadata (reason/err)")
    if not isinstance(body, np.ndarray) or body.dtype.kind not in "iu":
        raise WireFormatError("token-delta payload is not an integer array")
    return sid, TokenDelta([int(t) for t in body.ravel()],
                           finished=fin, reason=reason, error=err)


def stackable(queries: List[Any]) -> bool:
    """True when ``queries`` is a non-empty batch of numeric ndarrays of
    one dtype and shape."""
    first = queries[0] if queries else None
    return (isinstance(first, np.ndarray)
            and first.dtype.kind in _BINARY_KINDS
            and all(isinstance(q, np.ndarray) and q.dtype == first.dtype
                    and q.shape == first.shape for q in queries))


def stack_batch(queries: List[Any]) -> Any:
    """One ``(n, ...)`` array for a stackable batch (a view for one row),
    or None when the batch is not stackable."""
    if not stackable(queries):
        return None
    return queries[0][None] if len(queries) == 1 else np.stack(queries)
