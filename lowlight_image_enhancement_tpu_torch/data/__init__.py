"""Data layer: SIDPack records, the SID, paired-image and stereo datasets,
transforms, the input pipeline with device prefetch.

Counterpart of ``lowlight_image_enhancement_tpu/data/__init__.py``:
``create_dataset(opt)`` resolves ``{'type': Name, **kwargs}`` through the
port's DATASET_REGISTRY (reference ``data/__init__.py:38-62``);
``create_loader`` builds the batching pipeline (``data/__init__.py:
65-131``). The raw-SID and video datasets are not ported yet (ROADMAP.md,
queue 1).
"""

from __future__ import annotations

import copy
from typing import Any, Mapping

from lowlight_image_enhancement_tpu_torch.data.debug_fixtures import (  # noqa: F401
    make_debug_sid,
    make_synthetic_sid,
    make_synthetic_sid_tree,
    make_synthetic_stereo,
)
from lowlight_image_enhancement_tpu_torch.data.paired_image_dataset import (  # noqa: F401
    FFHQDataset,
    PairedImageDataset,
    SingleImageDataset,
)
from lowlight_image_enhancement_tpu_torch.data.pipeline import (  # noqa: F401
    Loader,
    epochs,
    prefetch_to_device,
)
from lowlight_image_enhancement_tpu_torch.data.records import (  # noqa: F401
    SidPackReader,
    SidPackWriter,
    build_sidpack,
)
from lowlight_image_enhancement_tpu_torch.data.stereo_dataset import (  # noqa: F401
    PairedImageSRLRDataset,
    PairedImageSRLRFullImageMemoryDataset,
    PairedStereoImageDataset,
)
from lowlight_image_enhancement_tpu_torch.data.sid_dataset import (  # noqa: F401
    SonySIDDataset,
    load_manifest,
)
from lowlight_image_enhancement_tpu_torch.utils.registry import (
    DATASET_REGISTRY,
)


def create_dataset(opt: Mapping[str, Any]):
    """Instantiate a dataset from ``{'type': Name, **kwargs}``."""
    opt = copy.deepcopy(dict(opt))
    return DATASET_REGISTRY.get(opt.pop("type"))(**opt)


def create_loader(dataset, opt: Mapping[str, Any], *, num_hosts: int = 1,
                  host_id: int = 0, seed: int = 0) -> Loader:
    """A :class:`Loader` from reference-style dataset options: shuffled
    and dropping the last partial batch in the train phase."""
    is_train = opt.get("phase", "train") == "train"
    batch = int(opt.get("batch_size_per_gpu", 1))
    return Loader(
        dataset,
        batch_size=batch * max(num_hosts, 1),
        shuffle=is_train,
        seed=seed,
        enlarge_ratio=int(opt.get("dataset_enlarge_ratio", 1)),
        drop_last=is_train,
        num_hosts=num_hosts,
        host_id=host_id,
    )
