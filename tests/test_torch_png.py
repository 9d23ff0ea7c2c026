"""The port's PNG codec and image-zip datasets against PIL and the JAX
package.

- ``sdk/png.py`` decodes PIL-written PNGs (gray, gray + alpha, RGB, RGBA;
  PIL's writer picks a row filter per row: None, Sub, Up or Paeth, never
  Average) to the arrays PIL reads, exactly, and PNGs built by hand with
  one filter on every row (all four non-trivial filters, Average
  included) to the pixels they encode, as PIL reads them too; what the
  port writes, PIL reads back exactly; palette, 16-bit, interlaced and
  non-PNG inputs raise typed errors.
- ``sdk/dataset.py``: a zip the port writes reads in the JAX package's
  ``ImageFilesDataset`` (PIL) to the arrays the port reads, and a zip the
  JAX package writes reads in the port to the arrays JAX reads, exactly;
  a wrong image size or a bad member raises ``InvalidDatasetError``.
"""

import io
import struct
import zipfile
import zlib

import numpy as np
import pytest
from PIL import Image

from rafiki_tpu.sdk import dataset as jax_dataset
from rafiki_tpu_torch.sdk import dataset, png

MODES = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}


def _image(rng, h, w, c):
    """Smooth gradients plus noise: PIL's adaptive filter choice then
    varies from row to row."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = (yy * 7 + xx * 3)[..., None] + np.arange(c) * 40
    noise = rng.integers(0, 24, (h, w, c))
    mask = rng.random((h, 1, 1)) < 0.5  # some rows pure gradient
    return ((base + np.where(mask, 0, noise)) % 256).astype(np.uint8)


def _pil_png(arr, mode):
    img = Image.fromarray(arr[..., 0] if mode == "L" else arr, mode)
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return buf.getvalue()


def _pil_read(data):
    arr = np.asarray(Image.open(io.BytesIO(data)))
    return arr[..., None] if arr.ndim == 2 else arr


def _row_filters(data):
    h, w, c = png.header(data)
    pos, idat = 8, b""
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        if data[pos + 4:pos + 8] == b"IDAT":
            idat += data[pos + 8:pos + 8 + length]
        pos += 12 + length
    raw = zlib.decompress(idat)
    return {raw[y * (1 + w * c)] for y in range(h)}


@pytest.fixture(scope="module")
def pil_files():
    rng = np.random.default_rng(0)
    files = []
    for mode, c in MODES.items():
        for h, w in ((32, 32), (7, 13), (1, 5)):
            arr = _image(rng, h, w, c)
            files.append((mode, arr, _pil_png(arr, mode)))
        # white noise: PIL leaves such rows unfiltered
        arr = rng.integers(0, 256, (16, 16, c)).astype(np.uint8)
        files.append((mode, arr, _pil_png(arr, mode)))
    return files


def test_decoder_reads_pil_files_exactly(pil_files):
    """Every mode and size, against PIL's own reading; across the files
    every row filter PIL's writer uses (0 None, 1 Sub, 2 Up, 4 Paeth)
    occurs. (It never picks 3, Average: over 300 varied 32x32 RGB images
    it chose 0, 1, 2 and 4 only; the hand-built files below cover 3.)"""
    seen = set()
    for mode, arr, data in pil_files:
        got = png.decode(data)
        assert got.dtype == np.uint8 and got.shape == arr.shape, mode
        np.testing.assert_array_equal(got, _pil_read(data), err_msg=mode)
        np.testing.assert_array_equal(got, arr, err_msg=mode)
        seen |= _row_filters(data)
    assert seen == {0, 1, 2, 4}


@pytest.mark.parametrize("kind", [1, 2, 3, 4])
def test_each_row_filter_alone(kind):
    """A PNG whose every row uses one filter, built by hand from the
    filter's definition, decodes to the pixels it encodes."""
    rng = np.random.default_rng(kind)
    h, w, c = 6, 9, 3
    pix = rng.integers(0, 256, (h, w, c)).astype(np.int64)
    rows = pix.reshape(h, w * c)
    out = bytearray()
    for y in range(h):
        prev = rows[y - 1] if y else np.zeros(w * c, np.int64)
        line = rows[y]
        filt = []
        for i in range(w * c):
            a = line[i - c] if i >= c else 0
            b = prev[i]
            cc = prev[i - c] if i >= c else 0
            if kind == 1:
                pred = a
            elif kind == 2:
                pred = b
            elif kind == 3:
                pred = (a + b) // 2
            else:
                p = a + b - cc
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc
                                                        else cc)
            filt.append((line[i] - pred) % 256)
        out += bytes([kind] + filt)
    data = (png.SIGNATURE + png._chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, 8, 2, 0, 0, 0))
        + png._chunk(b"IDAT", zlib.compress(bytes(out)))
        + png._chunk(b"IEND", b""))
    np.testing.assert_array_equal(png.decode(data), pix.astype(np.uint8))
    np.testing.assert_array_equal(_pil_read(data), pix.astype(np.uint8))


@pytest.mark.parametrize("mode", list(MODES))
def test_writer_is_read_by_pil_exactly(mode):
    arr = _image(np.random.default_rng(3), 11, 17, MODES[mode])
    data = png.encode(arr)
    assert _row_filters(data) == {0}
    np.testing.assert_array_equal(_pil_read(data), arr)
    np.testing.assert_array_equal(png.decode(data), arr)
    assert Image.open(io.BytesIO(data)).mode == mode


def _with_ihdr(data, **fields):
    """``data`` with IHDR fields replaced (and its CRC recomputed)."""
    names = ("width", "height", "depth", "colour", "comp", "filter",
             "interlace")
    values = dict(zip(names, struct.unpack(">IIBBBBB", data[16:29])))
    values.update(fields)
    body = struct.pack(">IIBBBBB", *(values[n] for n in names))
    return data[:8] + png._chunk(b"IHDR", body) + data[33:]


def _refusals():
    rng = np.random.default_rng(4)
    rgb = _pil_png(_image(rng, 8, 8, 3), "RGB")
    buf = io.BytesIO()
    Image.fromarray(_image(rng, 8, 8, 3)).convert("P").save(buf, "PNG")
    palette = buf.getvalue()
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 60000, (8, 8)).astype(np.uint16)).save(
        buf, "PNG")
    sixteen = buf.getvalue()
    buf = io.BytesIO()
    Image.fromarray(_image(rng, 8, 8, 3)).save(buf, "JPEG")
    jpeg = buf.getvalue()
    bad_crc = bytearray(rgb)
    bad_crc[40] ^= 1
    return {
        "palette": (palette, "palette"),
        "16-bit": (sixteen, "16-bit"),
        "interlaced": (_with_ihdr(rgb, interlace=1), "interlaced"),
        "jpeg": (jpeg, "not a PNG"),
        "bad crc": (bytes(bad_crc), "CRC"),
        "truncated": (rgb[:-20], "truncated|IEND|CRC"),
    }


@pytest.mark.parametrize("case", list(_refusals()))
def test_decoder_refuses_typed(case):
    data, match = _refusals()[case]
    with pytest.raises(png.PngError, match=match):
        png.decode(data)


def test_encoder_refuses_what_png_cannot_hold():
    with pytest.raises(png.PngError):
        png.encode(np.zeros((4, 4, 3), np.float32))
    with pytest.raises(png.PngError):
        png.encode(np.zeros((4, 4, 5), np.uint8))


# ---------------------------------------------------------------------------
# image-zip datasets across the two packages
# ---------------------------------------------------------------------------

def _images(c, n=12, size=(6, 5)):
    rng = np.random.default_rng(c)
    x = rng.random((n,) + size + (c,)).astype(np.float32)
    x[0, 0, 0] = 1.0  # the clip's edges
    x[1, 0, 0] = 0.0
    return x, rng.integers(0, 4, n)


@pytest.mark.parametrize("c", [1, 2, 3, 4])
def test_port_zip_reads_in_jax_as_in_the_port(c, tmp_path):
    x, y = _images(c)
    path = dataset.write_image_files_dataset(x, y, str(tmp_path / "p.zip"))
    ours = dataset.DatasetUtils().load_image_arrays(path, image_size=(6, 5))
    theirs = jax_dataset.DatasetUtils().load_image_arrays(path,
                                                          image_size=(6, 5))
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert ours[0].shape == (12, 6, 5, c)
    # uint8 quantisation of the float images, as the JAX writer does it
    np.testing.assert_array_equal(
        ours[0], (np.clip(x, 0, 1) * 255).astype(np.uint8) / np.float32(255))
    np.testing.assert_array_equal(ours[1], y)


@pytest.mark.parametrize("c", [1, 2, 3, 4])
def test_jax_zip_reads_in_the_port_as_in_jax(c, tmp_path):
    x, y = _images(c)
    path = jax_dataset.write_image_files_dataset(x, y,
                                                 str(tmp_path / "j.zip"))
    ours = dataset.ImageFilesDataset(path).load_as_arrays()
    theirs = jax_dataset.ImageFilesDataset(path).load_as_arrays()
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    ds = dataset.dataset_utils.load_dataset_of_image_files(path)
    assert (len(ds), ds.label_num_classes) == (12, int(y.max()) + 1)
    first, cls = next(iter(ds))
    assert first.dtype == np.uint8 and first.shape == (6, 5, c)
    assert cls == y[0]


def test_zip_array_cache(tmp_path):
    x, y = _images(3)
    path = dataset.write_image_files_dataset(x, y, str(tmp_path / "d.zip"))
    utils = dataset.DatasetUtils()
    first = utils.load_image_arrays(path, image_size=(6, 5))
    assert utils.load_image_arrays("file://" + path,
                                   image_size=(6, 5))[0] is first[0]


def _zip(tmp_path, members, csv="path,class\nimages/0.png,1\n"):
    path = str(tmp_path / "bad.zip")
    with zipfile.ZipFile(path, "w") as zf:
        if csv is not None:
            zf.writestr("images.csv", csv)
        for name, data in members.items():
            zf.writestr(name, data)
    return path


def test_dataset_refusals_are_typed(tmp_path):
    utils = dataset.DatasetUtils()
    x, y = _images(3)
    good = dataset.write_image_files_dataset(x, y, str(tmp_path / "g.zip"))
    with pytest.raises(dataset.InvalidDatasetError, match="resizing"):
        utils.load_image_arrays(good, image_size=(32, 32))
    refusals = _refusals()
    for name in ("palette", "16-bit", "interlaced", "jpeg"):
        path = _zip(tmp_path, {"images/0.png": refusals[name][0]})
        with pytest.raises(dataset.InvalidDatasetError,
                           match=refusals[name][1]):
            dataset.DatasetUtils().load_image_arrays(path)
    with pytest.raises(dataset.InvalidDatasetError, match="images.csv"):
        utils.load_image_arrays(_zip(tmp_path, {}, csv=None))
    with pytest.raises(dataset.InvalidDatasetError, match="columns"):
        utils.load_image_arrays(_zip(tmp_path, {}, csv="file,label\n"))
    not_zip = tmp_path / "not.zip"
    not_zip.write_bytes(b"plain text")
    with pytest.raises(dataset.InvalidDatasetError, match="zip"):
        utils.load_image_arrays(str(not_zip))
