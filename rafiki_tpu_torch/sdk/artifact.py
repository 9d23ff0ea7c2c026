"""Durable artifact I/O: atomic writes and a checksummed frame.

Own copy of ``rafiki_tpu/sdk/artifact.py``: :func:`write_artifact` writes
a tmp file in the target directory, fsyncs and renames it, so a crash
leaves the old file or nothing; the payload sits in a frame (magic,
version, CRC32, length) that :func:`read_artifact` verifies, raising the
typed :class:`ArtifactCorruptError` on a truncated or bit-rotten file.
Unframed data passes through unchanged, as in the original. The port's
payloads are npz archives (``sdk/params.py``), which start with ``PK``,
never with the magic.
"""

from __future__ import annotations

import os
import struct
import tempfile
import zlib

#: frame layout: magic(4) | version(1) | crc32(4, BE) | payload_len(8, BE)
MAGIC = b"RFKA"
VERSION = 1
_HEADER = struct.Struct(">4sBIQ")
HEADER_SIZE = _HEADER.size


class ArtifactCorruptError(Exception):
    """A checksummed artifact failed verification (truncated, bit-rotten,
    or half-written by a crashed process). Carries the offending path so
    doors can surface a clean, typed error."""

    def __init__(self, path: str, detail: str):
        super().__init__(f"artifact {path!r} is corrupt: {detail}")
        self.path = path
        self.detail = detail


def wrap(payload: bytes) -> bytes:
    """Frame ``payload`` with the checksummed header."""
    return _HEADER.pack(MAGIC, VERSION,
                        zlib.crc32(payload) & 0xFFFFFFFF,
                        len(payload)) + payload


def unwrap(data: bytes, path: str = "<bytes>") -> bytes:
    """Verify and strip the frame. Un-framed data (legacy artifacts)
    passes through unchanged — the downstream deserializer keeps owning
    that case. A non-empty strict prefix of the magic IS corruption (a
    framed file truncated inside the magic): legacy msgpack artifacts can
    never start with ASCII ``R``, so the prefix is provably not legacy."""
    if len(data) < len(MAGIC):
        if data and MAGIC.startswith(data):
            raise ArtifactCorruptError(
                path, f"truncated inside the magic ({len(data)} bytes)")
        return data
    if not data.startswith(MAGIC):
        return data
    if len(data) < HEADER_SIZE:
        raise ArtifactCorruptError(
            path, f"truncated inside the header ({len(data)} bytes)")
    magic, version, crc, length = _HEADER.unpack_from(data)
    payload = data[HEADER_SIZE:]
    if version != VERSION:
        raise ArtifactCorruptError(
            path, f"unknown artifact frame version {version}")
    if len(payload) != length:
        raise ArtifactCorruptError(
            path, f"payload is {len(payload)} bytes, header says {length} "
                  "(truncated or half-written)")
    if zlib.crc32(payload) & 0xFFFFFFFF != crc:
        raise ArtifactCorruptError(path, "checksum mismatch (bit rot or "
                                         "torn write)")
    return payload


def atomic_write_bytes(path: str, data: bytes,
                       mode: int | None = None) -> None:
    """Write ``data`` to ``path`` via tmp + fsync + rename. Readers only
    ever observe the previous complete file or the new complete file."""
    directory = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=directory,
                               prefix=os.path.basename(path) + ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        if mode is not None:
            os.chmod(tmp, mode)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    # fsync the directory so the rename itself survives a host crash;
    # best-effort — not every filesystem supports directory fds
    try:
        dfd = os.open(directory, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:
        pass


def write_artifact(path: str, payload: bytes,
                   mode: int | None = None) -> None:
    """Atomically persist ``payload`` inside a checksummed frame."""
    atomic_write_bytes(path, wrap(payload), mode=mode)


def read_artifact(path: str) -> bytes:
    """Read and verify an artifact file; raises :class:`ArtifactCorruptError`
    on checksum/length damage, passes legacy (un-framed) files through."""
    with open(path, "rb") as f:
        return unwrap(f.read(), path=path)
