"""Data layer: SIDPack records, the SID, paired-image and stereo datasets,
transforms, the input pipeline with device prefetch.

Counterpart of ``lowlight_image_enhancement_tpu/data/__init__.py``:
``create_dataset(opt)`` resolves ``{'type': Name, **kwargs}`` through the
port's DATASET_REGISTRY (reference ``data/__init__.py:38-62``);
``create_loader`` builds the batching pipeline (``data/__init__.py:
65-131``). Since the video slice also the raw SID data set, the video test
data sets and ``VideoFrameDataset``.
"""

from __future__ import annotations

import copy
import os
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
    splits_draws,
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
from lowlight_image_enhancement_tpu_torch.data.sid_raw_dataset import (  # noqa: F401
    SIDPairMetadata,
    SonySIDRawDataset,
    find_sid_pairs,
    parse_sid_filename,
)
from lowlight_image_enhancement_tpu_torch.data.video_dataset import (  # noqa: F401
    VideoFrameDataset,
    pad_frame_indices,
)
from lowlight_image_enhancement_tpu_torch.data.video_test_dataset import (  # noqa: F401
    VideoRecurrentTestDataset,
    VideoTestDataset,
    VideoTestDUFDataset,
    VideoTestVimeo90KDataset,
    duf_downsample,
    generate_frame_indices,
    generate_gaussian_kernel,
    read_img_seq,
)
from lowlight_image_enhancement_tpu_torch.utils.registry import (
    DATASET_REGISTRY,
)


def create_dataset(opt: Mapping[str, Any]):
    """Instantiate a dataset from ``{'type': Name, **kwargs}``."""
    opt = copy.deepcopy(dict(opt))
    return DATASET_REGISTRY.get(opt.pop("type"))(**opt)


def create_loader(dataset, opt: Mapping[str, Any], *, num_hosts: int = 1,
                  host_id: int = 0, seed: int = 0,
                  num_workers: int = 0) -> Loader:
    """A :class:`Loader` from reference-style dataset options: shuffled
    and dropping the last partial batch in the train phase;
    ``num_workers`` threads load ahead (:func:`loader_threads`)."""
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
        num_workers=num_workers,
    )


def loader_threads(dataset, opt: Mapping[str, Any]) -> int:
    """Threads that load a train set's items ahead of the step: none for a
    data set that does not split its draws from its loads
    (:func:`.pipeline.splits_draws`), so that its items stay the serial
    loader's; else the options' ``num_worker_per_gpu`` (the reference's
    key) where given; else the per-GPU batch, at most a quarter of the
    CPUs this process may use, and at least 1. The decodes compete with
    the training thread, which launches the step and pins each batch: on
    an H100 host of 8 CPUs, 7 threads made each decode 2.7 times slower
    and the pinning with it, for no shorter step than 2 threads gave."""
    if not splits_draws(dataset):
        return 0
    if opt.get("num_worker_per_gpu") is not None:
        return max(int(opt["num_worker_per_gpu"]), 0)
    cpus = len(os.sched_getaffinity(0)) if hasattr(
        os, "sched_getaffinity") else (os.cpu_count() or 1)
    return max(min(int(opt.get("batch_size_per_gpu", 1)), cpus // 4), 1)
