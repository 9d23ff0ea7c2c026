"""A PNG codec in the standard library and numpy, for the image-zip
datasets.

The JAX package reads and writes the images of an image-zip dataset with
PIL; the port has no PIL, so it carries its own codec for the PNGs such
datasets hold:

- :func:`decode`: 8-bit gray, gray + alpha, RGB and RGBA, not interlaced,
  with every row filter (None, Sub, Up, Average, Paeth: PIL's writer picks
  one per row), into an (H, W, C) ``uint8`` array, C = 1, 2, 3 or 4.
  Anything else (a palette, 16-bit samples, Adam7 interlacing, not a PNG
  at all) raises :class:`PngError`.
- :func:`encode`: an (H, W) or (H, W, C) ``uint8`` array into a PNG whose
  rows all use filter 0 (None).

Chunks other than IHDR, IDAT and IEND are skipped after their CRC is
checked; a bad CRC raises.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
#: colour type -> channels (8-bit samples only)
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}
_COLOUR_TYPE = {c: t for t, c in _CHANNELS.items()}


class PngError(ValueError):
    """The bytes are not a PNG this codec reads."""


def _chunks(data: bytes):
    pos = len(SIGNATURE)
    while pos + 12 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length or pos + 12 + length > len(data):
            raise PngError("truncated chunk")
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise PngError(f"bad CRC in chunk {kind!r}")
        yield kind, body
        pos += 12 + length
        if kind == b"IEND":
            return
    raise PngError("no IEND chunk")


def header(data: bytes) -> tuple:
    """(height, width, channels) of a PNG this codec reads."""
    if data[:8] != SIGNATURE:
        raise PngError("not a PNG (bad signature)")
    if len(data) < 33 or data[12:16] != b"IHDR":
        raise PngError("PNG without an IHDR chunk")
    w, h, depth, colour, comp, filt, interlace = struct.unpack(
        ">IIBBBBB", data[16:29])
    if colour == 3:
        raise PngError("palette PNGs are not read (colour type 3)")
    if colour not in _CHANNELS:
        raise PngError(f"unknown PNG colour type {colour}")
    if depth != 8:
        raise PngError(f"{depth}-bit PNGs are not read (8-bit only)")
    if interlace != 0:
        raise PngError("interlaced PNGs are not read")
    if comp != 0 or filt != 0:
        raise PngError("unknown PNG compression or filter method")
    if w == 0 or h == 0:
        raise PngError("empty PNG")
    return h, w, _CHANNELS[colour]


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """The Paeth predictor, on int16 columns."""
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the row filters of ``raw`` ((h, 1 + stride) bytes) into
    (h, stride) bytes."""
    rows = raw.reshape(h, 1 + stride)
    kinds = rows[:, 0]
    if int(kinds.max()) > 4:
        raise PngError(f"unknown row filter {int(kinds.max())}")
    out = rows[:, 1:].copy()
    if not kinds.any():
        return out
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        line = out[y]
        kind = kinds[y]
        if kind == 1:  # Sub: a running sum along each byte lane, mod 256
            lanes = line.reshape(-1, bpp).astype(np.uint32)
            line[:] = (np.cumsum(lanes, axis=0) & 0xFF).reshape(-1)
        elif kind == 2:  # Up
            line += prev
        elif kind == 3:  # Average: depends on the byte just decoded
            lanes = line.reshape(-1, bpp).astype(np.int32)
            up = prev.reshape(-1, bpp).astype(np.int32)
            left = np.zeros(bpp, np.int32)
            for i in range(len(lanes)):
                left = (lanes[i] + ((left + up[i]) >> 1)) & 0xFF
                lanes[i] = left
            line[:] = lanes.reshape(-1)
        elif kind == 4:  # Paeth: depends on the byte just decoded
            lanes = line.reshape(-1, bpp).astype(np.int16)
            up = prev.reshape(-1, bpp).astype(np.int16)
            left = np.zeros(bpp, np.int16)
            up_left = np.zeros(bpp, np.int16)
            for i in range(len(lanes)):
                left = (lanes[i] + _paeth(left, up[i], up_left)) & 0xFF
                lanes[i] = left
                up_left = up[i]
            line[:] = lanes.reshape(-1)
        prev = line
    return out


def decode(data: bytes) -> np.ndarray:
    """A PNG's pixels as an (H, W, C) ``uint8`` array."""
    h, w, c = header(data)
    idat = b"".join(body for kind, body in _chunks(data) if kind == b"IDAT")
    try:
        raw = zlib.decompress(idat)
    except zlib.error as e:
        raise PngError(f"corrupt image data: {e}") from e
    stride = w * c
    if len(raw) != h * (1 + stride):
        raise PngError(f"image data holds {len(raw)} bytes, expected "
                       f"{h * (1 + stride)}")
    pixels = _unfilter(np.frombuffer(raw, np.uint8), h, stride, c)
    return pixels.reshape(h, w, c)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def encode(pixels: np.ndarray, level: int = 6) -> bytes:
    """An (H, W) or (H, W, C) ``uint8`` array (C = 1, 2, 3 or 4) as a PNG,
    every row with filter 0."""
    arr = np.asarray(pixels)
    if arr.dtype != np.uint8:
        raise PngError(f"PNG pixels must be uint8, not {arr.dtype}")
    if arr.ndim == 2:
        arr = arr[..., None]
    if arr.ndim != 3 or arr.shape[-1] not in _COLOUR_TYPE:
        raise PngError(f"cannot write a PNG of shape {arr.shape}")
    h, w, c = arr.shape
    rows = np.zeros((h, 1 + w * c), np.uint8)
    rows[:, 1:] = arr.reshape(h, w * c)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOUR_TYPE[c], 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + _chunk(b"IEND", b""))
