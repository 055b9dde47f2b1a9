"""Image read/write: the port's copy of the PNG codec of
``lowlight_image_enhancement_tpu/utils/imgio.py``.

PNG is decoded and encoded here (8- and 16-bit, gray/gray+alpha/RGB/RGBA/
palette, non-interlaced): chunk parsing and zlib in Python, the scanline
defilter in C (``native/pngcodec.cpp:png_defilter``, from the library
:mod:`..data.native_loader` builds into ``build/torch_native/``), with the
numpy :func:`_defilter` where that library cannot be built. Other formats
and interlaced PNGs go through PIL; there is no cv2 branch. Every function
takes and returns **RGB** channel order, HWC uint8/uint16 (or HW for
grayscale).

:func:`defilter` counts the images each route defiltered
(``defilter.native``, ``defilter.python``), so a silent fallback to the
Python loop can be seen.
"""

from __future__ import annotations

import ctypes
import io
import os
import struct
import zlib
from typing import Optional, Sequence

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_CT_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}   # colortype -> channels

_DEFILTER: Optional[ctypes.CDLL] = None
_DEFILTER_TRIED = False


def _native_defilter() -> Optional[ctypes.CDLL]:
    """``png_defilter`` of the port's native library, or None where it
    cannot be built (no g++ or zlib)."""
    global _DEFILTER, _DEFILTER_TRIED
    if _DEFILTER_TRIED:
        return _DEFILTER
    _DEFILTER_TRIED = True
    from lowlight_image_enhancement_tpu_torch.data.native_loader import (
        _load_library,
    )

    lib = _load_library()
    if lib is None or not hasattr(lib, "png_defilter"):
        return None
    lib.png_defilter.restype = ctypes.c_int
    lib.png_defilter.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                 ctypes.c_int64, ctypes.c_int,
                                 ctypes.c_char_p]
    _DEFILTER = lib
    return _DEFILTER


def uses_native_defilter() -> bool:
    """Whether :func:`decode_png` defilters in C (loading the library on
    first call)."""
    return _native_defilter() is not None


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _defilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """PNG scanline defilter in numpy (PNG spec 4.5.4): the fallback of
    :func:`defilter` and the version the tests hold the C one against."""
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    for r in range(h):
        ft = int(rows[r, 0])
        cur_in = rows[r, 1:].astype(np.int64)
        up = out[r - 1].astype(np.int64) if r > 0 else np.zeros(stride, np.int64)
        if ft == 0:
            out[r] = rows[r, 1:]
        elif ft == 1:  # Sub: cumsum along each bpp lane
            lanes = cur_in.reshape(-1, bpp)
            out[r] = (np.cumsum(lanes, axis=0) % 256).astype(np.uint8).reshape(-1)
        elif ft == 2:  # Up
            out[r] = ((cur_in + up) % 256).astype(np.uint8)
        elif ft in (3, 4):  # Average / Paeth: sequential in the left pixel
            upl = np.zeros(stride, np.int64)
            if r > 0:
                upl[bpp:] = out[r - 1][:-bpp]
            cur = np.zeros(stride, np.int64)
            for i in range(0, stride, bpp):
                j = i + bpp
                left = cur[i - bpp:i] if i else 0
                if ft == 3:
                    pred = (left + up[i:j]) >> 1
                else:
                    pred = _paeth(left, up[i:j], upl[i:j] if i else 0)
                cur[i:j] = (cur_in[i:j] + pred) % 256
            out[r] = cur.astype(np.uint8)
        else:
            raise ValueError(f"invalid PNG filter type {ft}")
    return out


def defilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """``h`` filtered scanlines -> ``[h, stride]`` uint8: C's
    ``png_defilter`` where the library loads, else :func:`_defilter`."""
    lib = _native_defilter()
    if lib is None:
        defilter.python += 1
        return _defilter(raw, h, stride, bpp)
    out = np.empty((h, stride), np.uint8)
    if lib.png_defilter(raw, h, stride, bpp,
                        out.ctypes.data_as(ctypes.c_char_p)) != 0:
        raise ValueError("invalid PNG filter type")
    defilter.native += 1
    return out


defilter.native = 0
defilter.python = 0


def _decode_via_pil(buf: bytes) -> np.ndarray:
    from PIL import Image

    with Image.open(io.BytesIO(buf)) as im:
        if im.mode in ("I;16", "I"):
            return np.asarray(im, np.uint16).copy()
        if im.mode == "P":
            im = im.convert("RGBA" if "transparency" in im.info else "RGB")
        return np.asarray(im).copy()


def png_size(head: bytes) -> tuple:
    """``(height, width)`` from a PNG's first 24 bytes (its IHDR, which
    the format puts first), without decoding the image."""
    if head[:8] != _PNG_SIG or head[12:16] != b"IHDR":
        raise ValueError("not a PNG stream")
    width, height = struct.unpack(">II", head[16:24])
    return height, width


def decode_png(buf: bytes) -> np.ndarray:
    """PNG bytes -> RGB(A)/gray array, keeping 16-bit depth."""
    if buf[:8] != _PNG_SIG:
        raise ValueError("not a PNG stream")
    pos, n = 8, len(buf)
    width = height = bitdepth = colortype = interlace = None
    palette = trns = None
    idat = []
    while pos + 8 <= n:
        (length,) = struct.unpack(">I", buf[pos:pos + 4])
        ctype = buf[pos + 4:pos + 8]
        body = buf[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            width, height, bitdepth, colortype, _c, _f, interlace = (
                struct.unpack(">IIBBBBB", body))
        elif ctype == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"tRNS":
            trns = body
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if width is None or not idat:
        raise ValueError("malformed PNG: missing IHDR/IDAT")
    if (interlace or bitdepth not in (8, 16) or colortype not in _CT_CHANNELS
            or (colortype == 3 and bitdepth != 8)):
        return _decode_via_pil(buf)

    channels = _CT_CHANNELS[colortype]
    bpp = max(1, channels * bitdepth // 8)
    stride = width * channels * (bitdepth // 8)
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != height * (stride + 1):
        raise ValueError("PNG data length mismatch")
    out = defilter(raw, height, stride, bpp)
    if bitdepth == 16:
        img = out.reshape(height, stride).view(">u2").astype(np.uint16)
        img = img.reshape(height, width, channels)
    else:
        img = out.reshape(height, width, channels)
    if colortype == 3:  # palette expand
        if palette is None:
            raise ValueError("malformed PNG: palette image without PLTE")
        idx = img[..., 0]
        img = palette[idx]
        if trns is not None:
            alpha = np.full(256, 255, np.uint8)
            alpha[: len(trns)] = np.frombuffer(trns, np.uint8)
            img = np.concatenate([img, alpha[idx][..., None]], axis=-1)
    if img.shape[-1] == 1:
        img = img[..., 0]
    return np.ascontiguousarray(img)


def _filter_rows(rows: np.ndarray, bpp: int,
                 filter_types: Sequence[int]) -> np.ndarray:
    """The PNG forward filters (PNG spec 9.2) of ``rows [h, stride]``:
    row ``r`` takes ``filter_types[r % len]``; returns ``[h, 1 + stride]``
    with each row's type byte in front. Every filter predicts from the
    unfiltered bytes, so all rows are filtered at once."""
    x = rows.astype(np.int16)
    h, stride = x.shape
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    upl = np.zeros_like(x)
    upl[1:, bpp:] = x[:-1, :-bpp]
    preds = (np.zeros_like(x), left, up, (left + up) >> 1,
             _paeth(left, up, upl))
    types = np.asarray([filter_types[r % len(filter_types)]
                        for r in range(h)], np.uint8)
    if types.max(initial=0) > 4:
        raise ValueError(f"invalid PNG filter type in {filter_types}")
    pred = np.stack(preds)[types, np.arange(h)]
    body = ((x - pred) % 256).astype(np.uint8)
    return np.concatenate([types[:, None], body], axis=1)


def encode_png(arr: np.ndarray, compress_level: int = 6,
               filter_types: Sequence[int] = (0,)) -> bytes:
    """Gray/gray+alpha/RGB/RGBA uint8 or uint16 array -> PNG bytes.

    Scanline ``r`` gets filter ``filter_types[r % len(filter_types)]``
    (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth); the default is filter 0 on
    every row, as the JAX codec writes. The pixels decode the same
    whatever the filters."""
    arr = np.asarray(arr)
    if arr.ndim == 2:
        arr = arr[..., None]
    if arr.ndim != 3 or arr.shape[-1] not in (1, 2, 3, 4):
        raise ValueError(f"unsupported image shape {arr.shape}")
    if arr.dtype == np.uint8:
        bitdepth, body = 8, arr
    elif arr.dtype == np.uint16:
        bitdepth, body = 16, arr.astype(">u2")
    else:
        raise ValueError(f"unsupported dtype {arr.dtype} (uint8/uint16)")
    h, w, c = arr.shape

    def chunk(ctype: bytes, data: bytes) -> bytes:
        crc = zlib.crc32(ctype + data) & 0xFFFFFFFF
        return struct.pack(">I", len(data)) + ctype + data + struct.pack(">I", crc)

    ihdr = struct.pack(">IIBBBBB", w, h, bitdepth, {1: 0, 2: 4, 3: 2, 4: 6}[c],
                       0, 0, 0)
    rows = body.reshape(h, -1).view(np.uint8).reshape(h, -1)
    if tuple(filter_types) == (0,):
        raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    else:
        raw = _filter_rows(rows, c * bitdepth // 8, filter_types)
    return (_PNG_SIG + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), compress_level))
            + chunk(b"IEND", b""))


def imdecode(buf: bytes) -> np.ndarray:
    """Decode an encoded image buffer -> RGB (or gray) uint8/uint16 HWC."""
    buf = bytes(buf)
    return decode_png(buf) if buf[:8] == _PNG_SIG else _decode_via_pil(buf)


def imread(path: str) -> np.ndarray:
    """Read an image file -> RGB (or gray) uint8/uint16 HWC."""
    with open(path, "rb") as f:
        return imdecode(f.read())


def imencode(arr: np.ndarray, ext: str = ".png") -> bytes:
    """Encode an RGB (or gray) uint8/uint16 array: PNG natively, other
    formats through PIL (8-bit)."""
    ext = ext.lower()
    arr = np.asarray(arr)
    if ext == ".png":
        return encode_png(arr)
    from PIL import Image

    if arr.dtype != np.uint8:
        raise ValueError(f"{ext} encode requires uint8")
    fmt = Image.registered_extensions().get(ext)
    if fmt is None:
        raise ValueError(f"unsupported image extension: {ext}")
    bio = io.BytesIO()
    Image.fromarray(arr).save(bio, format=fmt)
    return bio.getvalue()


def imwrite(path: str, arr: np.ndarray) -> None:
    """Write an RGB (or gray) uint8/uint16 array; format from the
    extension (PNG without one)."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    ext = os.path.splitext(path)[1] or ".png"
    with open(path, "wb") as f:
        f.write(imencode(np.asarray(arr), ext))


def to_uint8(img01: np.ndarray) -> np.ndarray:
    """float [0,1] -> rounded uint8."""
    return (np.clip(np.asarray(img01), 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def to_float01(img: np.ndarray) -> np.ndarray:
    """uint8/uint16 -> float32 [0,1] (divides by the dtype max)."""
    img = np.asarray(img)
    if img.dtype == np.uint8:
        return img.astype(np.float32) / 255.0
    if img.dtype == np.uint16:
        return img.astype(np.float32) / 65535.0
    return img.astype(np.float32)
