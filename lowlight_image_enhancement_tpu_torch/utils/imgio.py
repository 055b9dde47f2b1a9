"""Image read/write: the port's copy of the PNG codec of
``lowlight_image_enhancement_tpu/utils/imgio.py``.

PNG is decoded and encoded here (8- and 16-bit, gray/gray+alpha/RGB/RGBA/
palette, non-interlaced; scanline defiltering in numpy); other formats and
interlaced PNGs go through PIL. Every function takes and returns **RGB**
channel order, HWC uint8/uint16 (or HW for grayscale).
"""

from __future__ import annotations

import io
import os
import struct
import zlib

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_CT_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}   # colortype -> channels


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _defilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """PNG scanline defilter (PNG spec 4.5.4)."""
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


def _decode_via_pil(buf: bytes) -> np.ndarray:
    from PIL import Image

    with Image.open(io.BytesIO(buf)) as im:
        if im.mode in ("I;16", "I"):
            return np.asarray(im, np.uint16).copy()
        if im.mode == "P":
            im = im.convert("RGBA" if "transparency" in im.info else "RGB")
        return np.asarray(im).copy()


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
    out = _defilter(raw, height, stride, bpp)
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


def encode_png(arr: np.ndarray, compress_level: int = 6) -> bytes:
    """Gray/gray+alpha/RGB/RGBA uint8 or uint16 array -> PNG bytes."""
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
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()
    return (_PNG_SIG + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, compress_level))
            + chunk(b"IEND", b""))


def imread(path: str) -> np.ndarray:
    """Read an image file -> RGB (or gray) uint8/uint16 HWC."""
    with open(path, "rb") as f:
        buf = f.read()
    return decode_png(buf) if buf[:8] == _PNG_SIG else _decode_via_pil(buf)


def imwrite(path: str, arr: np.ndarray) -> None:
    """Write an RGB (or gray) uint8/uint16 array; PNG natively, other
    extensions through PIL (uint8)."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    ext = (os.path.splitext(path)[1] or ".png").lower()
    arr = np.asarray(arr)
    if ext == ".png":
        data = encode_png(arr)
    else:
        from PIL import Image

        fmt = Image.registered_extensions().get(ext)
        if fmt is None or arr.dtype != np.uint8:
            raise ValueError(f"cannot write {ext} from {arr.dtype}")
        bio = io.BytesIO()
        Image.fromarray(arr).save(bio, format=fmt)
        data = bio.getvalue()
    with open(path, "wb") as f:
        f.write(data)


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
