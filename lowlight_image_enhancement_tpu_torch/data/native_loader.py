"""ctypes binding of the native SIDPack decoder (``native/sidpack.cpp``).

Counterpart of ``lowlight_image_enhancement_tpu/data/native_loader.py``.
The port builds its own copy of the library from the repository's
``native/sidpack.cpp`` and ``native/pngcodec.cpp`` at first use, with g++
(``-lz -lpthread``), into ``build/torch_native/`` at the repository root.
The library's name hashes the sources, flags and platform, it is written to a
temporary name and renamed into place, and a file lock keeps concurrent
processes (``pytest -n``) from compiling it twice. Where no compiler or
zlib is found, every API falls back to the pure-Python
:class:`.records.SidPackReader`; :attr:`NativeSidPack.uses_native` says
which reader ran. This is host code: it decodes on the CPU.

Hot-path API: :class:`NativeSidPack` -- ``decode_crop(key, top, left, ph,
pw, expo=None)`` returns a float32 crop, fusing inflate + crop + uint16 ->
float conversion (and optional exposure-align) in C.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import logging
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from lowlight_image_enhancement_tpu_torch.data.records import SidPackReader

logger = logging.getLogger(__name__)

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
SOURCES = ("sidpack.cpp", "pngcodec.cpp")
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-Wall", "-Wextra"]
LIBS = ["-lz", "-lpthread"]

_LIB: Optional[ctypes.CDLL] = None
_LIB_TRIED = False
_LIB_LOCK = threading.Lock()


def library_path() -> Path:
    """The library's path; its name hashes the sources, the flags and the
    platform (a build directory copied from another machine is not
    loaded)."""
    digest = hashlib.sha256()
    for name in SOURCES:
        digest.update((NATIVE_DIR / name).read_bytes())
    digest.update(" ".join(CXX_FLAGS + LIBS + [platform.platform()]).encode())
    return BUILD_DIR / f"libsidpack.{digest.hexdigest()[:12]}.so"


def build_library() -> Path:
    """Compile the library unless it exists; returns its path. Raises
    when g++ or zlib is missing or the compile fails."""
    lib = library_path()
    if lib.exists():
        return lib
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) found")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib.exists():                 # another process built it meanwhile
            return lib
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [cxx, *CXX_FLAGS, "-o", str(tmp),
               *[str(NATIVE_DIR / s) for s in SOURCES], *LIBS]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed on native/sidpack.cpp:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)
    return lib


def _load_library() -> Optional[ctypes.CDLL]:
    global _LIB, _LIB_TRIED
    with _LIB_LOCK:
        if _LIB_TRIED:
            return _LIB
        _LIB_TRIED = True
        try:
            lib = ctypes.CDLL(str(build_library()))
        except (RuntimeError, OSError, subprocess.SubprocessError) as e:
            logger.info("native sidpack unavailable, using the Python "
                        "reader: %s", e)
            return None
        lib.sp_open.restype = ctypes.c_void_p
        lib.sp_open.argtypes = [ctypes.c_char_p]
        lib.sp_close.argtypes = [ctypes.c_void_p]
        lib.sp_decode_crop_f32.restype = ctypes.c_int
        lib.sp_decode_crop_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_float,
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.sp_decode_crop_banded_f32.restype = ctypes.c_int
        lib.sp_decode_crop_banded_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_float,
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.sp_decode_crop_batch_f32.restype = ctypes.c_int
        lib.sp_decode_crop_batch_f32.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_float,
            ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ]
        _LIB = lib
        return _LIB


def native_available() -> bool:
    return _load_library() is not None


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return a.ctypes.data_as(ctypes.c_void_p)


class NativeSidPack:
    """SIDPack reader with the C fast path (falls back to Python).

    ``get(key)`` matches :meth:`SidPackReader.get`; ``decode_crop`` fuses
    decode + crop + float conversion (+ optional exposure-align producing
    ``lq`` directly)."""

    def __init__(self, path: str):
        self._py = SidPackReader(path)  # index + fallback
        self.index = self._py.index
        self._lib = _load_library()
        self._handle = None
        if self._lib is not None:
            handle = self._lib.sp_open(path.encode())
            if handle:
                self._handle = ctypes.c_void_p(handle)
        # the inflate scratch is thread-local: threaded loaders decode
        # concurrently
        self._tls = threading.local()

    def __reduce__(self):
        """Pickled as its path: a copy in another process opens the pack
        anew (worker processes of ``data/grain_pipeline.py``)."""
        return type(self), (self._py.path,)

    @property
    def uses_native(self) -> bool:
        """True when the C library serves the reads."""
        return self._handle is not None

    def keys(self):
        return self.index.keys()

    def __contains__(self, key):
        return key in self.index

    def __len__(self):
        return len(self.index)

    def get(self, key: str) -> np.ndarray:
        return self._py.get(key)

    def meta_shape(self, key: str) -> tuple:
        return tuple(self.index[key]["shape"])

    def meta_dtype(self, key: str) -> str:
        return self.index[key]["dtype"]

    def _scratch(self, need: int) -> np.ndarray:
        scratch = getattr(self._tls, "scratch", None)
        if scratch is None or scratch.size < need:
            scratch = np.empty(need, np.uint16)
            self._tls.scratch = scratch
        return scratch

    def decode_crop(self, key: str, top: int, left: int, ph: int, pw: int,
                    *, scale: float = 1.0 / 65535.0,
                    expo: Optional[float] = None) -> np.ndarray:
        """-> float32 ``[ph, pw, C]`` crop; when ``expo`` is given the
        output is ``clip(crop * scale * expo, 0, 1)`` (the aligned lq)."""
        ent = self.index[key]
        h, w, *rest = ent["shape"]
        c = rest[0] if rest else 1
        if self._handle is None or ent["dtype"] != "uint16":
            if ent["comp"] == "zlib_band" and ent["dtype"] == "uint16":
                rows = self._py.get_rows(key, top, ph)
                arr = rows[:, left:left + pw].astype(np.float32) * scale
            else:
                arr = self._py.get(key).astype(np.float32)
                if ent["dtype"] == "uint16":
                    arr = arr * scale
                arr = arr[top:top + ph, left:left + pw]
            if expo is not None:
                arr = np.clip(arr * expo, 0.0, 1.0)
            return np.ascontiguousarray(arr, dtype=np.float32)

        out = np.empty((ph, pw, c), np.float32)
        gain = ctypes.c_float(expo if expo is not None else 1.0)
        if ent["comp"] == "zlib_band":
            band_rows = ent["band_rows"]
            b0 = top // band_rows
            b1 = (top + ph - 1) // band_rows
            rows_span = min((b1 + 1) * band_rows, h) - b0 * band_rows
            rc = self._lib.sp_decode_crop_banded_f32(
                self._handle, ent["offset"], ent["nbytes"],
                h, w, c, top, left, ph, pw, ctypes.c_float(scale), gain,
                1 if expo is not None else 0,
                _ptr(self._scratch(rows_span * w * c)), _ptr(out))
        else:
            comp = 1 if ent["comp"] == "zlib" else 0
            scratch = _ptr(self._scratch(h * w * c)) if comp else None
            rc = self._lib.sp_decode_crop_f32(
                self._handle, ent["offset"], ent["nbytes"], comp,
                h, w, c, top, left, ph, pw, ctypes.c_float(scale), gain,
                1 if expo is not None else 0, scratch, _ptr(out))
        if rc != 0:
            raise RuntimeError(f"native decode failed for {key!r}")
        return out

    def decode_crop_batch(self, keys, tops, lefts, ph: int, pw: int, *,
                          scale: float = 1.0 / 65535.0,
                          expos=None) -> np.ndarray:
        """N crops in parallel (one pthread per record) through the C batch
        API -> ``[N, ph, pw, C]`` float32. All records uint16 with one
        channel count. Banded records, and a host without the library,
        take the per-record :meth:`decode_crop`."""
        n = len(keys)
        ents = [self.index[k] for k in keys]
        if (self._handle is None
                or any(e["dtype"] != "uint16" for e in ents)
                or any(e["comp"] == "zlib_band" for e in ents)):
            return np.stack([
                self.decode_crop(k, t, l, ph, pw, scale=scale,
                                 expo=(expos[i] if expos is not None
                                       else None))
                for i, (k, t, l) in enumerate(zip(keys, tops, lefts))])
        c = ents[0]["shape"][2] if len(ents[0]["shape"]) > 2 else 1
        handles = (ctypes.c_void_p * n)(*([self._handle.value] * n))
        offsets = np.asarray([e["offset"] for e in ents], np.uint64)
        nbytes = np.asarray([e["nbytes"] for e in ents], np.uint64)
        comps = np.asarray([1 if e["comp"] == "zlib" else 0 for e in ents],
                           np.int32)
        hs = np.asarray([e["shape"][0] for e in ents], np.int64)
        ws = np.asarray([e["shape"][1] for e in ents], np.int64)
        cs = np.full((n,), c, np.int64)
        tops_a = np.asarray(tops, np.int64)
        lefts_a = np.asarray(lefts, np.int64)
        expos_a = (np.asarray(expos, np.float32) if expos is not None
                   else None)
        max_elems = int((hs * ws * cs).max())
        scratch = np.empty(n * max_elems, np.uint16)
        out = np.empty((n, ph, pw, c), np.float32)
        rc = self._lib.sp_decode_crop_batch_f32(
            handles, n, _ptr(offsets), _ptr(nbytes), _ptr(comps), _ptr(hs),
            _ptr(ws), _ptr(cs), _ptr(tops_a), _ptr(lefts_a), ph, pw,
            ctypes.c_float(scale),
            _ptr(expos_a) if expos_a is not None else None,
            1 if expos is not None else 0, _ptr(scratch), max_elems,
            _ptr(out))
        if rc != 0:
            raise RuntimeError("native batch decode failed")
        return out

    def close(self) -> None:
        if self._handle is not None and self._lib is not None:
            self._lib.sp_close(self._handle)
            self._handle = None
        self._py.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
