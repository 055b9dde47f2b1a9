"""Standalone SID RAW dataset: train directly off ``.ARW`` captures.
The port's copy of ``lowlight_image_enhancement_tpu/data/sid_raw_dataset.py``
(host code: numpy items, as the JAX data set gives them).

Rebuild of the reference's research-stack dataset
(``datasets/sony_sid_dataset.py:28-354``): filename-driven pair
discovery (``{scene}_{frame}_{exposure}{s|ms}.ARW``), rawpy 16-bit
postprocessing with camera white balance, exposure-ratio brightness
alignment, optional aligned random/center patch sampling, and an
optional in-memory cache of the decoded 16-bit RGB arrays.

Differences from the reference (by design, documented):

* Items are the framework's SID batch dicts (float32 **HWC** arrays with
  ``lq/gt/short_raw/long_raw/short_obs/expo_ratio`` keys — the protocol
  every trainer/loss in this framework consumes, see
  ``data/sid_dataset.py``) rather than CHW torch tensors; the loader's
  device prefetch turns them to NCHW on the card.
* The RAW decoder is pluggable: ``rawpy`` when importable (the reference
  hard-requires it at import time, ``sony_sid_dataset.py:14-19``),
  otherwise any ``decode(path) -> uint16 HWC RGB`` callable — so the
  class is testable and usable on hosts without rawpy (e.g. pack/PNG
  decode fallbacks).
"""

from __future__ import annotations

import logging
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from lowlight_image_enhancement_tpu_torch.utils.registry import DATASET_REGISTRY

logger = logging.getLogger(__name__)

RAW_EXTENSIONS = (".ARW", ".arw")
MAX_16BIT_VALUE = np.float32(65535.0)
# reference sony_sid_dataset.py:25 — trailing `{value}{s|ms}` token
_EXPOSURE_PATTERN = re.compile(
    r"(?P<value>\d+(?:\.\d+)?)(?P<unit>s|ms)$", re.IGNORECASE)


@dataclass(frozen=True)
class SIDPairMetadata:
    """One matched short/long exposure pair (reference :28-43)."""

    pair_id: str
    short_path: Path
    long_path: Path
    short_exposure: float
    long_exposure: float

    @property
    def exposure_ratio(self) -> float:
        if self.short_exposure <= 0.0:
            raise ValueError(
                f"Short exposure for pair {self.pair_id} must be positive.")
        return self.long_exposure / self.short_exposure


def _iter_raw_files(directory: Path) -> Iterable[Path]:
    for ext in RAW_EXTENSIONS:
        yield from directory.glob(f"*{ext}")


def parse_sid_filename(path: Path) -> Tuple[str, float]:
    """``00001_00_0.04s.ARW`` -> (``"00001_00"``, ``0.04``) seconds.

    Reference contract (``sony_sid_dataset.py:51-75``): pair id is the
    first two ``_``-separated tokens; the third token is the exposure
    with an ``s``/``ms`` unit suffix; ``ms`` converts to seconds;
    non-positive or unparseable exposures raise.
    """
    parts = path.stem.split("_")
    if len(parts) < 3:
        raise ValueError(f"Unexpected SID filename format: {path.name}")
    pair_id = "_".join(parts[:2])
    m = _EXPOSURE_PATTERN.match(parts[2])
    if not m:
        raise ValueError(
            f"Unable to parse exposure from filename: {path.name}")
    value = float(m.group("value"))
    if m.group("unit").lower() == "ms":
        value /= 1000.0
    if value <= 0.0:
        raise ValueError(f"Exposure must be positive in filename: {path.name}")
    return pair_id, value


def _scan_exposures(directory: Path,
                    kind: str) -> Dict[str, Tuple[Path, float]]:
    records: Dict[str, Tuple[Path, float]] = {}
    for path in sorted(_iter_raw_files(directory)):
        pair_id, exposure = parse_sid_filename(path)
        if pair_id in records:
            # reference :109-130 — first file wins, duplicate is logged
            logger.warning(
                "Duplicate %s exposure for %s detected. Keeping %s, "
                "ignoring %s", kind, pair_id, records[pair_id][0].name,
                path.name)
            continue
        records[pair_id] = (path, exposure)
    return records


def find_sid_pairs(
    root_dir,
    camera: str = "Sony",
    allow_incomplete: bool = False,
) -> List[SIDPairMetadata]:
    """Scan ``{root}/{camera}/{long,short}`` and match pairs by id.

    Reference contract (``sony_sid_dataset.py:78-176``): missing
    ``long``/``short`` directories raise FileNotFoundError; unmatched
    entries raise unless ``allow_incomplete`` (then they are logged and
    skipped); an empty result raises RuntimeError; output is sorted by
    pair id.
    """
    camera_dir = Path(root_dir) / camera
    long_dir, short_dir = camera_dir / "long", camera_dir / "short"
    for d in (long_dir, short_dir):
        if not d.is_dir():
            raise FileNotFoundError(f"Missing directory: {d}")

    short_records = _scan_exposures(short_dir, "short")
    long_records = _scan_exposures(long_dir, "long")

    common = sorted(set(short_records) & set(long_records))
    missing_short = sorted(set(long_records) - set(short_records))
    missing_long = sorted(set(short_records) - set(long_records))
    if not allow_incomplete:
        if missing_short:
            raise FileNotFoundError(
                f"{len(missing_short)} long exposures have no matching "
                f"short exposure. Examples: {missing_short[:5]}")
        if missing_long:
            raise FileNotFoundError(
                f"{len(missing_long)} short exposures have no matching "
                f"long exposure. Examples: {missing_long[:5]}")
    else:
        if missing_short:
            logger.warning("%d long exposures skipped (no short match).",
                           len(missing_short))
        if missing_long:
            logger.warning("%d short exposures skipped (no long match).",
                           len(missing_long))

    pairs = [
        SIDPairMetadata(
            pair_id=pid,
            short_path=short_records[pid][0],
            long_path=long_records[pid][0],
            short_exposure=short_records[pid][1],
            long_exposure=long_records[pid][1],
        )
        for pid in common
    ]
    if not pairs:
        raise RuntimeError(
            f"No SID pairs discovered under {camera_dir}. Ensure the "
            "dataset is downloaded and unzipped correctly.")
    return pairs


def _default_raw_decoder(path: Path) -> np.ndarray:
    """rawpy 16-bit postprocess with camera WB (reference :296-317)."""
    try:
        import rawpy  # type: ignore
    except ImportError as exc:  # pragma: no cover - env without rawpy
        raise ImportError(
            "rawpy is required to read SID RAW files (install it on the "
            "data host, or pass a custom `raw_decoder`). Offline "
            "alternative: tools/convert_sid_raw_to_png.py + "
            "SonySIDDataset's disk/pack backends.") from exc
    with rawpy.imread(str(path)) as raw:
        rgb = raw.postprocess(
            use_camera_wb=True, half_size=False, no_auto_bright=True,
            output_bps=16)
    if rgb.dtype != np.uint16:
        raise RuntimeError(
            f"Expected uint16 output from rawpy, got {rgb.dtype}")
    return rgb


@DATASET_REGISTRY.register()
class SonySIDRawDataset:
    """Map-style dataset over SID ``.ARW`` pairs with full preprocessing.

    Mirrors the reference constructor surface
    (``sony_sid_dataset.py:191-257``); see the module docstring for the
    two deliberate protocol differences.  ``cache_in_memory`` keeps the
    decoded uint16 RGB arrays (a full SID Sony split is ~80 GB decoded —
    reference docstring calls it out for small experiments only).
    """

    def __init__(
        self,
        root_dir,
        camera: str = "Sony",
        patch_size: Optional[int] = 512,
        random_crop: bool = True,
        samples_per_pair: int = 1,
        cache_in_memory: bool = False,
        rng_seed: Optional[int] = None,
        return_metadata: bool = False,
        allowed_pair_ids: Optional[Sequence[str]] = None,
        allow_incomplete: bool = False,
        raw_decoder: Optional[Callable[[Path], np.ndarray]] = None,
    ) -> None:
        if samples_per_pair < 1:
            raise ValueError("samples_per_pair must be >= 1.")
        self.root_dir = Path(root_dir)
        self.camera = camera
        self.patch_size = patch_size
        self.random_crop = random_crop
        self.samples_per_pair = int(samples_per_pair)
        self.cache_in_memory = cache_in_memory
        self.return_metadata = return_metadata
        self._decode = raw_decoder or _default_raw_decoder
        self._rng = np.random.default_rng(rng_seed)

        pairs = find_sid_pairs(self.root_dir, camera=camera,
                               allow_incomplete=allow_incomplete)
        if allowed_pair_ids is not None:
            allowed = set(allowed_pair_ids)
            pairs_f = [p for p in pairs if p.pair_id in allowed]
            missing = allowed - {p.pair_id for p in pairs_f}
            if missing:
                raise ValueError(
                    f"Requested pair ids not found in dataset: "
                    f"{sorted(missing)}")
            pairs = pairs_f
        if not pairs:
            raise RuntimeError("No SID pairs available after filters.")
        self.pairs = pairs
        self._cache: Dict[Path, np.ndarray] = {}

    def __len__(self) -> int:
        return len(self.pairs) * self.samples_per_pair

    def _load_rgb_uint16(self, path: Path) -> np.ndarray:
        if self.cache_in_memory and path in self._cache:
            return self._cache[path]
        rgb = self._decode(path)
        if self.cache_in_memory:
            self._cache[path] = rgb
        return rgb

    def _crop_coords(self, h: int, w: int) -> Tuple[int, int]:
        patch = self.patch_size
        if patch > h or patch > w:
            raise ValueError(
                f"Requested patch_size={patch} exceeds image dimensions "
                f"({h}x{w}). Reduce the patch size or disable cropping.")
        if self.random_crop:
            return (int(self._rng.integers(0, h - patch + 1)),
                    int(self._rng.integers(0, w - patch + 1)))
        return (h - patch) // 2, (w - patch) // 2

    def __getitem__(self, index: int) -> Dict[str, object]:
        pair = self.pairs[index // self.samples_per_pair]

        long_f = self._load_rgb_uint16(pair.long_path).astype(np.float32)
        short_f = self._load_rgb_uint16(pair.short_path).astype(np.float32)
        if long_f.shape != short_f.shape:
            raise ValueError(
                "Input and target images must share the same shape before "
                "cropping.")

        ratio = pair.exposure_ratio
        short_raw = short_f / MAX_16BIT_VALUE                # observation A
        gt = long_f / MAX_16BIT_VALUE                        # target B
        # aligned input: clip(short * rho) in 16-bit domain (reference
        # :272-275 clips at MAX_16BIT then normalizes — identical result)
        lq = np.clip(short_raw * ratio, 0.0, 1.0)

        if self.patch_size is not None:
            top, left = self._crop_coords(*gt.shape[:2])
            sl = np.s_[top:top + self.patch_size,
                       left:left + self.patch_size, :]
            short_raw, gt, lq = short_raw[sl], gt[sl], lq[sl]

        item: Dict[str, object] = {
            "lq": np.ascontiguousarray(lq.astype(np.float32)),
            "gt": np.ascontiguousarray(gt.astype(np.float32)),
            "short_raw": np.ascontiguousarray(short_raw.astype(np.float32)),
            "long_raw": np.ascontiguousarray(gt.astype(np.float32)),
            "short_obs": np.ascontiguousarray(short_raw.astype(np.float32)),
            "expo_ratio": np.float32(ratio),
        }
        if self.return_metadata:
            item["metadata"] = {
                "pair_id": pair.pair_id,
                "short_path": str(pair.short_path),
                "long_path": str(pair.long_path),
                "short_exposure": pair.short_exposure,
                "long_exposure": pair.long_exposure,
                "exposure_ratio": ratio,
            }
        return item

    def __repr__(self) -> str:  # pragma: no cover - debug helper
        patch = self.patch_size if self.patch_size is not None else "full"
        return (f"SonySIDRawDataset(num_pairs={len(self.pairs)}, "
                f"camera='{self.camera}', patch={patch}, "
                f"samples_per_pair={self.samples_per_pair}, "
                f"cache={self.cache_in_memory})")
