"""The port's wire codec (``rafiki_tpu_torch/cache/wire.py``) against the
JAX package's (``rafiki_tpu/cache/wire.py``), on the CPU.

- The same object encodes to the same bytes in both packages, for every
  binary dtype and rank, nested and escaped structures, and the batched
  request and response frames of the shm broker.
- Each package decodes the other's frames to equal values, version-2
  frames (trace metadata) included.
- Malformed, hostile and fuzzed frames raise the port's typed
  ``WireFormatError``, and a non-array payload takes the JSON escape
  hatch.
"""

import json

import numpy as np
import pytest

from rafiki_tpu.cache import wire as jwire
from rafiki_tpu_torch.cache import wire
from rafiki_tpu_torch.utils import jsonutil
from rafiki_tpu.utils import jsonutil as jjsonutil

DTYPES = [np.float32, np.float64, np.float16, np.int8, np.int64, np.uint16,
          np.bool_, np.complex64, ">f8"]
SHAPES = [(), (1,), (7,), (3, 4), (2, 3, 4), (2, 1, 3, 2), (0,), (2, 0, 3)]


def _array(dtype, shape, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * 10).astype(dtype)


def _equal(a, b):
    """Deep equality of decoded structures (arrays by dtype, shape and
    bits)."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
                and a.dtype == b.dtype and a.shape == b.shape
                and a.tobytes() == b.tobytes())
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_equal(a[k], b[k]) for k in a))
    if isinstance(a, list):
        return (isinstance(b, list) and len(a) == len(b)
                and all(_equal(x, y) for x, y in zip(a, b)))
    return a == b


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_same_bytes_and_cross_decode(dtype, shape):
    a = _array(dtype, shape)
    obj = {"q": a, "scalar": a.reshape(-1)[0] if a.size else 1.5}
    ours, theirs = wire.encode(obj), jwire.encode(obj)
    assert ours == theirs
    assert _equal(wire.decode(theirs), jwire.decode(ours))
    assert _equal(wire.decode(ours), jwire.decode(theirs))


REQUESTS = {
    # the shm broker's query frame: a stacked f32 batch with a deadline
    "query frame": {"ids": ["a", "b"], "deadline": 1234.5,
                    "qarr": _array(np.float32, (2, 8, 8, 3))},
    # a response frame: JSON answers, one error by index
    "response frame": {"ids": ["a", "b"], "results": [[0.25, 0.75], None],
                       "errors": {"1": "model failed"}},
    # nested arrays, numpy scalars, strings and an object array
    "nested": {"x": [np.arange(5, dtype=np.int32), {"y": np.float32(2.5)}],
               "s": "text", "o": np.array(["a", "bc"], dtype=object),
               "b": np.bool_(True), "t": (1, 2)},
    # user dicts that look like placeholders are escaped
    "hostile keys": {"q": {"\x00nd": 0}, "r": {"\x00esc": {"\x00nd": 1}},
                     "a": np.ones(3, np.float32)},
    # non-contiguous and 0-d arrays
    "views": {"v": np.arange(40.0).reshape(5, 8)[:, ::2],
              "z": np.array(3, np.int16)},
}


@pytest.mark.parametrize("name", sorted(REQUESTS))
def test_frames_are_byte_identical(name):
    obj = REQUESTS[name]
    ours, theirs = wire.encode(obj), jwire.encode(obj)
    assert ours == theirs
    assert wire.is_frame(ours) and ours[4] == 1
    assert _equal(wire.decode(theirs), jwire.decode(ours))


def test_json_framed_messages_of_the_jax_package_decode(monkeypatch):
    """A JAX-package sender under RAFIKI_WIRE_BINARY=0 sends JSON; the
    port's receivers sniff and decode it as the JAX ones do."""
    monkeypatch.setenv("RAFIKI_WIRE_BINARY", "0")
    obj = {"ids": ["a"], "queries": [np.arange(3.0)], "deadline": 1.0}
    raw = jwire.dumps(obj)
    assert not wire.is_frame(raw)
    assert wire.decode_any(raw) == jwire.decode_any(raw) == {
        "ids": ["a"], "queries": [[0.0, 1.0, 2.0]], "deadline": 1.0}


def test_json_default_is_the_reference():
    obj = {"a": np.arange(3), "b": np.float32(1.5), "c": [np.int8(2)]}
    assert jsonutil.dumps(obj) == jjsonutil.dumps(obj)
    for bad in (object(), {1, 2}):
        with pytest.raises(TypeError):
            jsonutil.dumps({"x": bad})


def test_version_2_frames_of_the_jax_package_decode():
    """A sampled request's frame carries trace metadata (version 2): the
    port decodes its body and sets the metadata aside."""
    obj = REQUESTS["query frame"]
    frame = jwire.encode(obj, trace={"id": "t1", "s": 1})
    assert frame[4] == 2
    assert _equal(wire.decode(frame), obj)


def test_token_delta_frames_are_refused_typed():
    """Version 3 (streamed generation) is not ported: refused typed."""
    frame = jwire.encode_token_delta("s1", [1, 2, 3], finished=True)
    with pytest.raises(wire.WireFormatError, match="version 3"):
        wire.decode(frame)


def test_decoded_arrays_are_read_only_views():
    out = wire.decode(wire.encode({"q": np.arange(8, dtype=np.float32)}))["q"]
    assert not out.flags.writeable
    with pytest.raises(ValueError):
        out[0] = 1


def test_non_array_payload_takes_the_json_escape_hatch():
    obj = {"words": ["a", "b"], "n": 3, "nested": {"k": [1.5, None]}}
    frame = wire.encode(obj)
    assert frame == jwire.encode(obj)
    hlen = int.from_bytes(frame[6:10], "little")
    header = json.loads(frame[10:10 + hlen])
    assert header["a"] == [] and header["b"] == obj
    assert wire.decode(frame) == obj
    assert wire.decode_any(json.dumps(obj).encode()) == obj


@pytest.mark.parametrize("mutate", [
    lambda f: f[:3],                                   # shorter than magic
    lambda f: f[:9],                                   # truncated header len
    lambda f: f[:len(f) // 2],                         # truncated payload
    lambda f: b"\xabRWF" + bytes([99]) + f[5:],        # unknown version
    lambda f: f[:10] + b"\xff" * 8 + f[18:],           # garbled header JSON
    lambda f: f[:6] + (2 ** 31 - 1).to_bytes(4, "little") + f[10:],  # huge H
    lambda f: b"\xab\x00garbage",                      # neither frame nor JSON
], ids=["short", "no-len", "half", "version", "garbled", "huge-header",
        "garbage"])
def test_malformed_frames_raise_the_typed_error(mutate):
    frame = wire.encode({"q": np.arange(32, dtype=np.float32)})
    with pytest.raises(wire.WireFormatError):
        wire.decode_any(mutate(frame))


@pytest.mark.parametrize("dtype,shape,nbytes", [
    ("<f4", [1024], 4096),          # extent past the payload
    ("<f4", [2 ** 32, 2 ** 32], 0),  # a product that wraps to 0
    ("<f4", [2 ** 63, 2], 0),        # one that wraps negative
    ("<f4", [-4], 16),               # a negative dimension
    ("|O", [2], 16),                 # an object dtype on the wire
])
def test_hostile_array_tables_raise_the_typed_error(dtype, shape, nbytes):
    header = json.dumps(
        {"b": {"\x00nd": 0}, "a": [[dtype, shape, 0, nbytes]]}).encode()
    frame = (wire.MAGIC + bytes([1, 0]) + len(header).to_bytes(4, "little")
             + header + b"\x00" * 32)
    with pytest.raises(wire.WireFormatError):
        wire.decode(frame)


def test_fuzzed_frames_raise_only_the_typed_error():
    """Random byte flips in a query frame: each decode either succeeds or
    raises WireFormatError, the one error a pop loop absorbs; the JAX
    decoder agrees on which frames are valid and on their values."""
    rng = np.random.default_rng(7)
    frame = bytearray(wire.encode(REQUESTS["query frame"]))
    failed = 0
    for _ in range(300):
        bad = bytearray(frame)
        for _ in range(rng.integers(1, 6)):
            bad[rng.integers(0, len(bad))] ^= int(rng.integers(1, 256))
        try:
            ours = wire.decode(bytes(bad))
        except wire.WireFormatError:
            failed += 1
            with pytest.raises(jwire.WireFormatError):
                jwire.decode_meta(bytes(bad), frozenset({1, 2}))
            continue
        assert _equal(ours, jwire.decode(bytes(bad)))
    assert failed > 0


def test_stack_batch_matches_the_reference():
    rows = [np.full((2, 3), i, np.float32) for i in range(4)]
    for queries in (rows, rows[:1], [], [[1.0], [2.0]],
                    [rows[0], rows[1].astype(np.float64)]):
        assert wire.stackable(queries) == jwire.stackable(queries)
        ours, theirs = wire.stack_batch(queries), jwire.stack_batch(queries)
        assert _equal(ours, theirs)
