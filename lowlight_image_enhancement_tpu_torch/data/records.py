"""SIDPack: the packed-record store of the SID data (the port's own copy).

The port's copy of ``lowlight_image_enhancement_tpu/data/records.py``
(numpy + zlib, no JAX): the same writer and reader, so a pack written by
either package is byte-equal to the other's from the same arrays, and
each reads the other's. The format replaces the reference's LMDB
databases (``basicsr/utils/file_client.py:82-153``):

```
offset 0:   magic  b"SIDPACK1"
offset 8:   uint64 little-endian index_offset
offset 16:  entry payloads (concatenated, 64-byte aligned)
index_offset: JSON index  {key: {"offset", "nbytes", "shape", "dtype",
                                 "comp"}}
```

Payloads are raw C-order array bytes, optionally zlib-compressed
(``comp in {"none", "zlib", "zlib_band"}``). The native C++ reader
(``native/sidpack.cpp``, bound by :mod:`.native_loader`) mmaps the same
file and serves crop reads on the data-loading hot path; this module is
the pure-Python reader and the writer.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
import zlib
from typing import Dict, Iterable, Mapping, Optional

import numpy as np

_MAGIC = b"SIDPACK1"
_ALIGN = 64


class SidPackWriter:
    """Streaming writer. Usage::

        with SidPackWriter(path) as w:
            w.add("00001_short", arr_uint16)        # raw
            w.add("00001_long", arr_uint16, comp="zlib")
            w.add("00002_long", arr_uint16, comp="zlib_band")

    ``comp='zlib_band'`` compresses HWC arrays in independent row stripes
    (``band_rows`` rows each) so crop reads only inflate the overlapping
    stripes — on full-resolution SID frames (2848x4256) a 384^2 crop
    touches ~14% of rows, cutting decode work ~7x. Payload layout::

        uint32 band_rows | uint32 n_bands | uint64 ends[n_bands]
        | band 0 zlib stream | band 1 zlib stream | ...

    where ``ends[i]`` is the offset (relative to the first stream byte) of
    the end of stream *i*.
    """

    def __init__(self, path: str, comp: str = "zlib",
                 band_rows: int = 64):
        if comp not in {"none", "zlib", "zlib_band"}:
            raise ValueError("comp must be 'none', 'zlib' or 'zlib_band'")
        self.path = path
        self.default_comp = comp
        self.band_rows = int(band_rows)
        self._index: Dict[str, dict] = {}
        self._f = open(path, "wb")
        self._f.write(_MAGIC)
        self._f.write(struct.pack("<Q", 0))  # index_offset placeholder
        self._pos = 16

    def _pad(self) -> None:
        rem = self._pos % _ALIGN
        if rem:
            pad = _ALIGN - rem
            self._f.write(b"\0" * pad)
            self._pos += pad

    def add(self, key: str, arr: np.ndarray,
            comp: Optional[str] = None) -> None:
        if key in self._index:
            raise KeyError(f"duplicate key {key!r}")
        comp = comp or self.default_comp
        arr = np.ascontiguousarray(arr)
        entry: Dict = {
            "shape": list(arr.shape),
            "dtype": str(arr.dtype),
            "comp": comp,
        }
        if comp == "zlib_band":
            if arr.ndim < 2:
                raise ValueError("zlib_band requires >= 2-D arrays")
            h = arr.shape[0]
            streams = [
                zlib.compress(arr[r : r + self.band_rows].tobytes(),
                              level=1)
                for r in range(0, h, self.band_rows)
            ]
            ends, acc = [], 0
            for s in streams:
                acc += len(s)
                ends.append(acc)
            header = struct.pack("<II", self.band_rows, len(streams))
            header += struct.pack(f"<{len(streams)}Q", *ends)
            payload = header + b"".join(streams)
            entry["band_rows"] = self.band_rows
        elif comp == "zlib":
            payload = zlib.compress(arr.tobytes(), level=1)
        else:
            payload = arr.tobytes()
        self._pad()
        self._f.write(payload)
        entry["offset"] = self._pos
        entry["nbytes"] = len(payload)
        self._index[key] = entry
        self._pos += len(payload)

    def close(self) -> None:
        if self._f.closed:
            return
        self._pad()
        index_offset = self._pos
        blob = json.dumps(self._index).encode()
        self._f.write(blob)
        self._f.seek(8)
        self._f.write(struct.pack("<Q", index_offset))
        self._f.close()

    def __enter__(self) -> "SidPackWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class SidPackReader:
    """mmap-backed reader. Thread-safe for reads (mmap slicing is atomic).

    The native C++ fast path (``native/``) implements the same `get`
    semantics; :mod:`..data.native_loader` picks it automatically when the
    shared library is built.
    """

    def __init__(self, path: str):
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        self.path = path
        self._file = open(path, "rb")
        self._mm = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        if self._mm[:8] != _MAGIC:
            raise ValueError(f"{path}: not a SIDPACK1 file")
        (index_offset,) = struct.unpack("<Q", self._mm[8:16])
        self.index: Dict[str, dict] = json.loads(
            self._mm[index_offset:].decode()
        )

    def keys(self) -> Iterable[str]:
        return self.index.keys()

    def __contains__(self, key: str) -> bool:
        return key in self.index

    def __len__(self) -> int:
        return len(self.index)

    def meta(self, key: str) -> dict:
        return self.index[key]

    def _band_table(self, ent: dict):
        """Parse a zlib_band payload header -> (band_rows, stream_spans)
        where spans are absolute (start, end) file offsets per band."""
        off = ent["offset"]
        band_rows, n_bands = struct.unpack(
            "<II", self._mm[off : off + 8]
        )
        ends = struct.unpack(
            f"<{n_bands}Q", self._mm[off + 8 : off + 8 + 8 * n_bands]
        )
        data0 = off + 8 + 8 * n_bands
        spans = []
        start = 0
        for end in ends:
            spans.append((data0 + start, data0 + end))
            start = end
        return band_rows, spans

    def get(self, key: str) -> np.ndarray:
        ent = self.index[key]
        if ent["comp"] == "zlib_band":
            _, spans = self._band_table(ent)
            raw = b"".join(
                zlib.decompress(self._mm[s:e]) for s, e in spans
            )
        else:
            raw = self._mm[ent["offset"] : ent["offset"] + ent["nbytes"]]
            if ent["comp"] == "zlib":
                raw = zlib.decompress(raw)
        arr = np.frombuffer(raw, dtype=np.dtype(ent["dtype"]))
        return arr.reshape(ent["shape"])

    def get_rows(self, key: str, top: int, nrows: int) -> np.ndarray:
        """Decode only rows [top, top+nrows) — inflates just the
        overlapping stripes for ``zlib_band`` records (full decode + slice
        otherwise)."""
        ent = self.index[key]
        if ent["comp"] != "zlib_band":
            return self.get(key)[top : top + nrows]
        band_rows, spans = self._band_table(ent)
        b0 = top // band_rows
        b1 = (top + nrows - 1) // band_rows
        raw = b"".join(
            zlib.decompress(self._mm[s:e]) for s, e in spans[b0 : b1 + 1]
        )
        shape = ent["shape"]
        arr = np.frombuffer(raw, dtype=np.dtype(ent["dtype"]))
        arr = arr.reshape((-1,) + tuple(shape[1:]))
        local_top = top - b0 * band_rows
        return arr[local_top : local_top + nrows]

    def close(self) -> None:
        self._mm.close()
        self._file.close()

    def __enter__(self) -> "SidPackReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def build_sidpack(
    path: str, arrays: Mapping[str, np.ndarray], comp: str = "zlib"
) -> None:
    """One-shot pack builder (tooling convenience)."""
    with SidPackWriter(path, comp=comp) as w:
        for key, arr in arrays.items():
            w.add(key, arr)
