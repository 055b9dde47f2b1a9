"""The port's PNG codec against the JAX package's (``tests/test_imgio.py``).

The port defilters scanlines in C (``native/pngcodec.cpp:png_defilter``,
built into ``build/torch_native/``) and keeps the numpy loop as the
fallback and the reference. All comparisons are exact: the codec is
integer arithmetic.
"""

from __future__ import annotations

import io
import os
import struct
import time
import zlib

import numpy as np
import pytest
from PIL import Image

from lowlight_image_enhancement_tpu.data import transforms as jtransforms
from lowlight_image_enhancement_tpu.utils import imgio as jimgio
from lowlight_image_enhancement_tpu_torch.data import debug_fixtures
from lowlight_image_enhancement_tpu_torch.data import transforms
from lowlight_image_enhancement_tpu_torch.data import make_synthetic_stereo
from lowlight_image_enhancement_tpu_torch.utils import imgio


def _row_filters(buf: bytes) -> list:
    """The filter type byte of every scanline of a non-interlaced PNG."""
    pos, idat, ihdr = 8, [], None
    while pos + 8 <= len(buf):
        (length,) = struct.unpack(">I", buf[pos:pos + 4])
        ctype, body = buf[pos + 4:pos + 8], buf[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
    w, h, depth, ctype_ = ihdr[:4]
    stride = w * {0: 1, 2: 3, 4: 2, 6: 4}[ctype_] * depth // 8
    raw = zlib.decompress(b"".join(idat))
    return [raw[r * (stride + 1)] for r in range(h)]


def _pil_png(arr: np.ndarray) -> bytes:
    bio = io.BytesIO()
    Image.fromarray(arr).save(bio, format="PNG")
    return bio.getvalue()


def test_native_defilter_is_built_here():
    assert imgio.uses_native_defilter()


@pytest.mark.parametrize("ft", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("bpp", [1, 2, 3, 4, 6, 8])
def test_defilter_native_python_jax_agree(ft, bpp):
    """Synthesised streams (every row of one type), since encoders choose
    the types adaptively."""
    rng = np.random.default_rng(ft * 10 + bpp)
    h, w = 7, 11
    stride = w * bpp
    rows = rng.integers(0, 256, (h, stride + 1), dtype=np.uint8)
    rows[:, 0] = ft
    raw = rows.tobytes()
    before = imgio.defilter.native
    native = imgio.defilter(raw, h, stride, bpp)
    assert imgio.defilter.native == before + 1
    python = imgio._defilter(raw, h, stride, bpp)
    np.testing.assert_array_equal(native, python)
    np.testing.assert_array_equal(native,
                                  jimgio._defilter_py(raw, h, stride, bpp))


def test_invalid_filter_type_raises_on_both_routes():
    raw = bytes([9]) + bytes(6)
    with pytest.raises(ValueError, match="invalid PNG filter type"):
        imgio.defilter(raw, 1, 6, 3)
    with pytest.raises(ValueError, match="invalid PNG filter type"):
        imgio._defilter(raw, 1, 6, 3)


def test_decode_pil_written_rgb_matches_jax():
    rng = np.random.default_rng(1)
    x = np.linspace(0, 255, 64).astype(np.uint8)
    img = np.stack([np.tile(x, (64, 1)), np.tile(x[:, None], (1, 64)),
                    rng.integers(0, 256, (64, 64), dtype=np.uint8)], -1)
    buf = _pil_png(img)
    assert len(set(_row_filters(buf))) > 1   # PIL mixes the filter types
    got = imgio.imdecode(buf)
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(got, jimgio.imdecode(buf))


@pytest.mark.parametrize("shape,dtype", [
    ((37, 53, 3), np.uint8), ((21, 33, 3), np.uint16), ((20, 30), np.uint8),
    ((20, 30), np.uint16), ((15, 17, 4), np.uint8), ((15, 17, 4), np.uint16),
    ((9, 13, 2), np.uint8)])
@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,),
                                     tuple(range(5))])
def test_encode_decode_roundtrip(shape, dtype, filters):
    arr = np.random.default_rng(0).integers(
        0, np.iinfo(dtype).max + 1, shape, dtype=dtype)
    buf = imgio.encode_png(arr, filter_types=filters)
    assert _row_filters(buf) == [filters[r % len(filters)]
                                 for r in range(shape[0])]
    out = imgio.imdecode(buf)
    assert out.dtype == dtype
    np.testing.assert_array_equal(out, arr)
    np.testing.assert_array_equal(jimgio.decode_png(buf), arr)
    if dtype == np.uint8 and arr.ndim == 3 and shape[-1] in (3, 4):
        np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(buf))),
                                      arr)


def test_default_encoding_is_jax_filter_zero():
    arr = np.random.default_rng(3).integers(0, 65536, (6, 5, 3),
                                            dtype=np.uint16)
    assert imgio.encode_png(arr) == jimgio.encode_png(arr)
    assert imgio.imencode(arr, ".PNG") == jimgio.imencode(arr, ".png")
    with pytest.raises(ValueError, match="invalid PNG filter type"):
        imgio.encode_png(arr, filter_types=(5,))


def test_imwrite_imread_png_and_pil_formats(tmp_path):
    arr16 = np.random.default_rng(4).integers(0, 65536, (8, 9, 3),
                                              dtype=np.uint16)
    imgio.imwrite(str(tmp_path / "sub" / "a.png"), arr16)
    np.testing.assert_array_equal(imgio.imread(str(tmp_path / "sub" / "a.png")),
                                  arr16)
    np.testing.assert_array_equal(jimgio.imread(str(tmp_path / "sub" / "a.png")),
                                  arr16)
    arr8 = (arr16 >> 8).astype(np.uint8)
    imgio.imwrite(str(tmp_path / "b.bmp"), arr8)
    np.testing.assert_array_equal(imgio.imread(str(tmp_path / "b.bmp")), arr8)
    jpg = imgio.imencode(arr8, ".jpg")
    assert imgio.imdecode(jpg).shape == arr8.shape
    with pytest.raises(ValueError, match="requires uint8"):
        imgio.imencode(arr16, ".jpg")
    with pytest.raises(ValueError, match="unsupported image extension"):
        imgio.imencode(arr8, ".nope")


def test_decode_png_uint16_matches_jax():
    rng = np.random.default_rng(5)
    for arr in (rng.integers(0, 65536, (6, 7, 3), dtype=np.uint16),
                rng.integers(0, 256, (6, 7), dtype=np.uint8)):
        buf = _pil_png(arr) if arr.dtype == np.uint8 else imgio.encode_png(arr)
        np.testing.assert_array_equal(transforms.decode_png_uint16(buf),
                                      jtransforms.decode_png_uint16(buf))


def test_native_decode_of_a_paeth_view_is_fast():
    """A 368x500 RGB view (about a Flickr1024 x2 LR view), every row
    Paeth: the Python loop took seconds for it, the C defilter takes
    milliseconds."""
    rng = np.random.default_rng(6)
    img = (np.cumsum(rng.integers(0, 8, (368, 500, 3)), axis=1) % 256
           ).astype(np.uint8)
    buf = imgio.encode_png(img, filter_types=(4,))
    imgio.imdecode(buf)                    # loads the library
    native, python = imgio.defilter.native, imgio.defilter.python
    t0 = time.perf_counter()
    out = imgio.imdecode(buf)
    elapsed = time.perf_counter() - t0
    np.testing.assert_array_equal(out, img)
    assert (imgio.defilter.native, imgio.defilter.python) == (native + 1,
                                                               python)
    assert elapsed < 0.5, f"{elapsed:.3f} s"


def test_stereo_fixture_rows_use_every_filter(tmp_path, monkeypatch):
    """The stereo views mix filter types 0-4 and decode to the pixels
    that the filter-0 fixture wrote."""
    paths = make_synthetic_stereo(str(tmp_path / "new"), n_train=3, n_val=1)

    def filter_zero(path, arr):
        imgio.imwrite(path, arr)

    monkeypatch.setattr(debug_fixtures, "_write_filtered_png", filter_zero)
    old = make_synthetic_stereo(str(tmp_path / "old"), n_train=3, n_val=1)
    seen = set()
    for key in ("train_hr", "train_lr", "val_hr", "val_lr"):
        for sample in sorted(os.listdir(paths[key])):
            for name in sorted(os.listdir(os.path.join(paths[key], sample))):
                new_file = os.path.join(paths[key], sample, name)
                old_file = os.path.join(old[key], sample, name)
                with open(new_file, "rb") as f:
                    seen.update(_row_filters(f.read()))
                with open(old_file, "rb") as f:
                    assert set(_row_filters(f.read())) == {0}
                np.testing.assert_array_equal(imgio.imread(new_file),
                                              imgio.imread(old_file))
    assert seen == {0, 1, 2, 3, 4}
