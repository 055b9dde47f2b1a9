"""Manifest-driven SID Sony dataset (reference ``SonySIDLMDBDataset``).

Counterpart of ``lowlight_image_enhancement_tpu/data/sid_dataset.py``
(rebuild of ``basicsr/data/sony_sid_lmdb_dataset.py:59-251``), with the
same crop pushdown and the same ``self._rng`` draws, so a seeded pass
gives the same items, bit for bit. Items stay NHWC numpy float32; the
loader's prefetcher (:mod:`.pipeline`) moves a batch to the device and to
NCHW. With a threaded loader (``num_workers > 0``) the draws of the
crops follow thread timing, as in the JAX package; the parity tests use
``num_workers=0``. A JSON
manifest lists pairs ``{pair_id, subset, short_key, long_key,
short_exposure, long_exposure, exposure_ratio}``; image payloads come from
either

- a **pack** backend: two SIDPack files keyed ``short``/``long``
  (replacing the reference's two LMDB databases), or
- a **disk** backend: 16-bit PNGs under ``{root}/{short,long}/{key}.png``.

Per-item protocol (all float32 HWC in [0,1], identical to the reference):
``short_raw`` (the observation A), ``long_raw`` (the target B),
``lq = clip(short_raw * ratio)`` (exposure-aligned network input),
``gt = long_raw``, ``short_obs = short_raw`` (un-aligned observation for
the sRGB physics term), ``expo_ratio`` scalar. Train phase takes a joint
random crop of all arrays; val uses center crop (when ``patch_size`` set)
or full images. ``samples_per_pair`` repeats pairs per epoch.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from lowlight_image_enhancement_tpu_torch.data.native_loader import NativeSidPack
from lowlight_image_enhancement_tpu_torch.data.transforms import (
    augment,
    center_crop,
    decode_png_uint16,
    joint_random_crop,
    uint16_to_float01,
)
from lowlight_image_enhancement_tpu_torch.utils.registry import DATASET_REGISTRY


@DATASET_REGISTRY.register()
class SonySIDDataset:
    """Map-style dataset over SID pairs.

    Args (mirroring the reference YAML keys):
      manifest_path: JSON manifest file.
      subset: 'train' | 'val' | 'test' filter.
      phase: 'train' enables random crop + augmentation.
      patch_size: crop size (None = full images).
      samples_per_pair: epoch-length multiplier.
      random_crop: random (True) vs center (False) crops in train phase.
      use_augment: hflip/vflip/rot90 augmentation in train phase.
      io_backend: {'type': 'pack', 'short_path': ..., 'long_path': ...} or
        {'type': 'disk', 'root': ...}.
      allowed_pair_ids: optional whitelist.
    """

    def __init__(
        self,
        manifest_path: str,
        subset: str = "train",
        phase: str = "train",
        patch_size: Optional[int] = None,
        samples_per_pair: int = 1,
        random_crop: bool = True,
        use_augment: bool = False,
        io_backend: Optional[Dict[str, Any]] = None,
        allowed_pair_ids: Optional[Sequence[str]] = None,
        seed: int = 0,
        **_ignored: Any,
    ):
        with open(manifest_path) as f:
            manifest = json.load(f)
        records = manifest["pairs"] if isinstance(manifest, dict) else manifest
        self.records: List[dict] = [
            r for r in records
            if r.get("subset", subset) == subset
            and (allowed_pair_ids is None
                 or r["pair_id"] in set(allowed_pair_ids))
        ]
        if not self.records:
            raise ValueError(
                f"no pairs for subset={subset!r} in {manifest_path}"
            )
        self.subset = subset
        self.phase = phase
        self.patch_size = patch_size
        self.samples_per_pair = max(int(samples_per_pair), 1)
        self.random_crop = random_crop
        self.use_augment = use_augment
        self._rng = np.random.default_rng(seed)
        # numpy Generators are not thread-safe; threaded loaders
        # (Loader(num_workers=...), grain) fetch items concurrently
        self._rng_lock = threading.Lock()

        io_backend = dict(io_backend or {"type": "disk", "root": "."})
        self.backend_type = io_backend.pop("type")
        if self.backend_type == "pack":
            # NativeSidPack: C fast path (mmap + inflate + fused crop) with
            # transparent pure-Python fallback.
            self._short = NativeSidPack(io_backend["short_path"])
            self._long = NativeSidPack(io_backend["long_path"])
        elif self.backend_type == "disk":
            self._root = io_backend.get("root", ".")
        else:
            raise ValueError(
                f"io_backend type must be 'pack' or 'disk', got "
                f"{self.backend_type!r}"
            )

    # ------------------------------------------------------------------
    def __getstate__(self) -> Dict[str, Any]:
        """Picklable for worker processes: the lock is made anew."""
        state = dict(self.__dict__)
        del state["_rng_lock"]
        return state

    def __setstate__(self, state: Dict[str, Any]) -> None:
        self.__dict__.update(state)
        self._rng_lock = threading.Lock()

    def __len__(self) -> int:
        return len(self.records) * self.samples_per_pair

    def _load(self, which: str, key: str) -> np.ndarray:
        """-> float32 [0,1] HWC."""
        if self.backend_type == "pack":
            reader = self._short if which == "short" else self._long
            arr = reader.get(key)
            if arr.dtype == np.uint16:
                return uint16_to_float01(arr)
            return np.asarray(arr, dtype=np.float32)
        path = os.path.join(self._root, which, f"{key}.png")
        with open(path, "rb") as f:
            return uint16_to_float01(decode_png_uint16(f.read()))

    def _crop_coords(self, h: int, w: int) -> tuple[int, int]:
        ps = self.patch_size
        if self.phase == "train" and self.random_crop:
            with self._rng_lock:
                return (int(self._rng.integers(0, h - ps + 1)),
                        int(self._rng.integers(0, w - ps + 1)))
        return max((h - ps) // 2, 0), max((w - ps) // 2, 0)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        rec = self.records[idx % len(self.records)]
        ratio = float(rec.get(
            "exposure_ratio",
            rec.get("long_exposure", 1.0) / max(rec.get("short_exposure", 1.0),
                                                1e-12),
        ))

        if (self.patch_size and self.backend_type == "pack"
                and rec["short_key"] in self._short
                and self._short.meta_dtype(rec["short_key"]) == "uint16"
                and self._long.meta_dtype(rec["long_key"]) == "uint16"
                and self._short.meta_shape(rec["short_key"])
                == self._long.meta_shape(rec["long_key"])):
            # crop pushdown: decode only the crop window natively
            h, w = self._short.meta_shape(rec["short_key"])[:2]
            top, left = self._crop_coords(h, w)
            ps = self.patch_size
            short_raw = self._short.decode_crop(rec["short_key"], top, left,
                                                ps, ps)
            long_raw = self._long.decode_crop(rec["long_key"], top, left,
                                              ps, ps)
        else:
            short_raw = self._load("short", rec["short_key"])
            long_raw = self._load("long", rec["long_key"])
            if self.patch_size:
                if self.phase == "train" and self.random_crop:
                    short_raw, long_raw = joint_random_crop(
                        [short_raw, long_raw], self.patch_size,
                        rng=self._rng
                    )
                else:
                    short_raw = center_crop(short_raw, self.patch_size)
                    long_raw = center_crop(long_raw, self.patch_size)
        if self.phase == "train" and self.use_augment:
            short_raw, long_raw = augment([short_raw, long_raw],
                                          rng=self._rng)

        lq = np.clip(short_raw * ratio, 0.0, 1.0).astype(np.float32)
        return {
            "lq": lq,
            "gt": long_raw,
            "short_raw": short_raw,
            "long_raw": long_raw,
            "short_obs": short_raw,
            "expo_ratio": np.float32(ratio),
            "pair_id": rec["pair_id"],
            "key": rec["short_key"],
        }


def load_manifest(manifest_path: str) -> List[dict]:
    with open(manifest_path) as f:
        manifest = json.load(f)
    return manifest["pairs"] if isinstance(manifest, dict) else manifest
