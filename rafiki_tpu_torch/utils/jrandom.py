"""The draws of ``jax.random`` that the port repeats, on the host in numpy.

``jax.random``'s default generator is threefry2x32 with partitionable
bits (``jax_threefry_partitionable``, on by default since JAX 0.5): a
key is two uint32 words, and the bits of an array of shape ``s`` are
threefry of the key over the counters (hi, lo) of each flat index into
``s``. This module gives the same keys and numbers, so a trial of the
port can be held draw for draw against the JAX package's:

- :func:`PRNGKey` (a non-negative seed below 2**32) and :func:`split`:
  bit for bit;
- :func:`uniform` (f32 in [minval, maxval)): bit for bit;
- :func:`normal` (f32): JAX's ``sqrt(2) * erfinv(u)`` for ``u`` uniform
  on the open interval (-1, 1), with ``erfinv`` written out as XLA's CPU
  backend computes it (Giles' polynomials over Cephes' ``log1p`` and
  ``logf``, with its fused multiply-adds). A fused multiply-add is
  emulated in f64, which may round a value differently in its last bit,
  so the tests hold ``normal`` to 1 ulp; a GPU's XLA may compute
  ``erfinv`` otherwise.

Threefry's additions wrap modulo 2**32 by design.

A key is a ``(2,)`` uint32 array, as ``jax.random.PRNGKey`` returns, and
``split`` returns ``(num, 2)``. The draws are small (a latent batch, a
mixing weight a sample) and are copied to the device by the caller.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def threefry2x32(k1: np.ndarray, k2: np.ndarray, x1: np.ndarray,
                 x2: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The threefry2x32 block cipher of ``jax.random`` (20 rounds) over
    uint32 arrays: key (k1, k2), counter (x1, x2)."""
    k1, k2 = np.asarray(k1, np.uint32), np.asarray(k2, np.uint32)
    with np.errstate(over="ignore"):
        return _rounds(k1, k2, x1, x2)


def _rounds(k1, k2, x1, x2):
    ks = (k1, k2, k1 ^ k2 ^ np.uint32(0x1BD11BDA))
    x = [np.asarray(x1, np.uint32) + ks[0], np.asarray(x2, np.uint32) + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def PRNGKey(seed: int) -> np.ndarray:  # noqa: N802  (jax.random's name)
    """``jax.random.PRNGKey(seed)``: the words (seed >> 32, seed & 0xffffffff)."""
    seed = int(seed)
    if not 0 <= seed < 1 << 32:
        raise ValueError(f"seed {seed} is outside [0, 2**32)")
    return np.array([0, seed], np.uint32)


def _counters(shape: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
    """The (hi, lo) words of each flat index into ``shape``."""
    n = int(np.prod(shape, dtype=np.int64))
    idx = np.arange(n, dtype=np.uint64).reshape(tuple(shape))
    return ((idx >> np.uint64(32)).astype(np.uint32),
            (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: (num, 2) uint32 keys."""
    hi, lo = _counters((num,))
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return np.stack([b1, b2], axis=-1)


def _random_bits(key: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """32 random bits for each element of ``shape``: the two output words
    of threefry over the element's counter, xor-ed."""
    hi, lo = _counters(shape)
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return b1 ^ b2


def uniform(key: np.ndarray, shape: Sequence[int] = (),
            minval: float = 0.0, maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    bits = _random_bits(key, shape)
    floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(
        np.float32) - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    return np.maximum(lo, floats * (hi - lo) + lo).reshape(tuple(shape))


def _fma(a, b, c) -> np.ndarray:
    """f32 ``a * b + c`` rounded once: the product of two f32 is exact in
    f64 (the sum's rounding to f64 first can differ from a true fused
    multiply-add in the last bit, very rarely)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


# XLA's CPU log (Cephes' logf), its polynomial evaluated with fused
# multiply-adds as XLA's CPU backend emits them
_LOG_P = tuple(np.float32(c) for c in (
    7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1, -1.2420140846E-1,
    1.4249322787E-1, -1.6668057665E-1, 2.0000714765E-1, -2.4999993993E-1,
    3.3333331174E-1))


def _log(x: np.ndarray) -> np.ndarray:
    """XLA's CPU ``log`` of a positive f32."""
    f32 = np.float32
    x = np.maximum(x, np.array(0x00800000, np.uint32).view(f32))
    bits = x.view(np.int32)
    m = ((bits & ~0x7F800000) | np.array(0.5, f32).view(np.int32)).view(f32)
    e = f32(1) + ((bits >> 23) - 0x7F).astype(f32)
    below = m < f32(0.707106781186547524)
    e = e - np.where(below, f32(1), f32(0))
    m = (m - f32(1)) + np.where(below, m, f32(0))
    x2 = m * m
    x3 = x2 * m
    p = _LOG_P
    y = _fma(_fma(m, p[0], p[1]), m, p[2])
    y1 = _fma(_fma(m, p[3], p[4]), m, p[5])
    y2 = _fma(_fma(m, p[6], p[7]), m, p[8])
    y = _fma(_fma(y, x3, y1), x3, y2)
    y = _fma(y, x3, f32(-2.12194440e-4) * e)
    return _fma(f32(0.693359375), e, (m - f32(0.5) * x2) + y)


# XLA's log1p: Cephes' rational approximation below sqrt(2) - 1, else
# log(1 + x); polynomials highest degree first
_LOG1P_NUM = tuple(np.float32(c) for c in (
    4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
    6.5787325942061044846969E0, 2.9911919328553073277375E1,
    6.0949667980987787057556E1, 5.7112963590585538103336E1,
    2.0039553499201281259648E1))
_LOG1P_DEN = tuple(np.float32(c) for c in (
    1., 1.5062909083469192043167E1, 8.3047565967967209469434E1,
    2.2176239823732856465394E2, 3.0909872225312059774938E2,
    2.1642788614495947685003E2, 6.0118660497603843919306E1))


def _poly(x: np.ndarray, coeffs) -> np.ndarray:
    p = np.zeros_like(x)
    for c in coeffs:
        p = _fma(p, x, c)
    return p


def _log1p(x: np.ndarray) -> np.ndarray:
    """XLA's CPU ``log1p`` of an f32 above -1."""
    f32 = np.float32
    x2 = x * x
    small = (x * x2) * (_poly(x, _LOG1P_NUM) / _poly(x, _LOG1P_DEN))
    small = x + _fma(f32(-0.5), x2, small)
    with np.errstate(divide="ignore"):
        large = _log(x + f32(1))
    return np.where(np.abs(x) < f32(0.41421356237309504880), small, large)


# XLA's ErfInv<float>: M. Giles, "Approximating the erfinv function"
_ERFINV_SMALL = tuple(np.float32(c) for c in (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
    1.50140941))
_ERFINV_LARGE = tuple(np.float32(c) for c in (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682))


def erfinv(x: np.ndarray) -> np.ndarray:
    """Single-precision ``erfinv`` as XLA's CPU backend computes it."""
    f32 = np.float32
    x = np.asarray(x, f32)
    w = -_log1p(x * -x)
    small = w < f32(5.0)
    w = np.where(small, w - f32(2.5),
                 np.sqrt(np.maximum(w, f32(0))) - f32(3.0))
    p = np.where(small, _ERFINV_SMALL[0], _ERFINV_LARGE[0])
    for cs, cl in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
        p = _fma(p, w, np.where(small, cs, cl))
    return np.where(np.abs(x) == f32(1), x * f32(np.inf), p * x)


def normal(key: np.ndarray, shape: Sequence[int] = ()) -> np.ndarray:
    """``jax.random.normal(key, shape)`` (float32)."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform(key, shape, lo, 1.0)
    return (np.float32(np.sqrt(2)) * erfinv(u)).astype(np.float32)
