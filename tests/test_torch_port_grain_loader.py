"""The port's multi-worker loader (``data/grain_pipeline.py``) on the CPU:
``tests/test_grain_pipeline.py``'s claims (the batch contract,
determinism by seed, the 6/6 host split, a bad split refused) on the same
debug packs, the sampler's shards and epochs, and two worker processes:
the same multiset of records as none, and crop positions drawn from each
worker's own generator ``default_rng([seed, worker])``."""

import collections

import numpy as np
import pytest

from lowlight_image_enhancement_tpu.data import make_debug_sid
from lowlight_image_enhancement_tpu_torch.data import SonySIDDataset
from lowlight_image_enhancement_tpu_torch.data.grain_pipeline import (
    IndexSampler,
    make_grain_loader,
)
from lowlight_image_enhancement_tpu_torch.data.pipeline import (
    prefetch_to_device,
)

PATCH = 16


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    return make_debug_sid(str(tmp_path_factory.mktemp("grain_sid")),
                          n_pairs=3)


def _dataset(paths, **kw):
    return SonySIDDataset(
        manifest_path=paths["manifest"], subset="train", patch_size=PATCH,
        samples_per_pair=4,
        io_backend={"type": "pack", "short_path": paths["train_short"],
                    "long_path": paths["train_long"]}, **kw)


@pytest.fixture(scope="module")
def dataset(paths):
    return _dataset(paths)


def test_batches_and_contract(dataset):
    batches = list(make_grain_loader(dataset, batch_size=4, num_epochs=1))
    assert len(batches) == 3
    b = batches[0]
    assert b["lq"].shape == (4, PATCH, PATCH, 3)
    assert b["expo_ratio"].shape == (4,)
    assert isinstance(b["lq"], np.ndarray) and b["lq"].flags["C_CONTIGUOUS"]
    assert isinstance(b["pair_id"], list) and isinstance(b["key"][0], str)
    np.testing.assert_allclose(
        b["lq"],
        np.clip(b["short_raw"] * b["expo_ratio"][:, None, None, None], 0, 1),
        atol=1e-6)
    # the batch feeds the device prefetcher (NCHW, strings dropped)
    dev = next(prefetch_to_device(iter(batches), device="cpu"))
    assert tuple(dev["lq"].shape) == (4, 3, PATCH, PATCH)
    assert "pair_id" not in dev


def test_deterministic_with_seed(dataset):
    ids = [[tuple(b["pair_id"]) for b in
            make_grain_loader(dataset, 4, seed=seed, num_epochs=1)]
           for seed in (5, 5, 6)]
    assert ids[0] == ids[1] and ids[0] != ids[2]


def test_host_sharding(dataset):
    """The 12 records split over two hosts (6 each), each batching at the
    local size (global 4 / 2 hosts = 2)."""
    per_host, seen = [], []
    for host in (0, 1):
        loader = make_grain_loader(dataset, 4, shuffle=False, num_epochs=1,
                                   num_hosts=2, host_id=host)
        batches = list(loader)
        assert all(b["lq"].shape[0] == 2 for b in batches)
        per_host.append(sum(b["lq"].shape[0] for b in batches))
        seen.append(sum((b["key"] for b in batches), []))
    assert per_host == [6, 6]
    assert sorted(seen[0] + seen[1]) == sorted(
        dataset.records[i % 3]["short_key"] for i in range(12))


def test_bad_host_split(dataset):
    with pytest.raises(ValueError):
        make_grain_loader(dataset, 5, num_hosts=2)


@pytest.mark.parametrize("drop,shards", [(True, [[0, 1, 2], [3, 4, 5],
                                                 [6, 7, 8]]),
                                         (False, [[0, 1, 2], [3, 4, 5],
                                                  [6, 7, 8, 9]])])
def test_sampler_shards_and_epochs(drop, shards):
    for i, want in enumerate(shards):
        s = IndexSampler(10, shard_index=i, shard_count=3,
                         drop_remainder=drop, shuffle=False, num_epochs=2)
        assert list(s) == want * 2 and len(s) == 2 * len(want)
    s = IndexSampler(10, shuffle=True, num_epochs=3, seed=4)
    order = list(s)
    epochs = [order[:10], order[10:20], order[20:]]
    assert all(sorted(e) == list(range(10)) for e in epochs)
    assert epochs[0] != epochs[1]
    assert order == list(IndexSampler(10, shuffle=True, num_epochs=3,
                                      seed=4))
    endless = iter(IndexSampler(4, shuffle=False, num_epochs=None))
    assert [next(endless) for _ in range(9)] == [0, 1, 2, 3] * 2 + [0]
    with pytest.raises(TypeError):
        len(IndexSampler(4, num_epochs=None))
    with pytest.raises(ValueError):
        IndexSampler(4, shard_index=2, shard_count=2)


def _crop_origin(full: np.ndarray, crop: np.ndarray) -> tuple:
    """(top, left) of ``crop`` in ``full``: the only exact match."""
    ph, pw = crop.shape[:2]
    hits = [(t, l) for t in range(full.shape[0] - ph + 1)
            for l in range(full.shape[1] - pw + 1)
            if np.array_equal(full[t:t + ph, l:l + pw], crop)]
    assert len(hits) == 1
    return hits[0]


def test_two_workers(paths):
    """Two worker processes: the records of the run without workers, and
    each worker's crops at the positions its own generator draws (batch
    ``i`` comes from worker ``i % 2``), so the workers' streams differ."""
    ds = _dataset(paths)
    none = list(make_grain_loader(ds, 2, seed=3, num_epochs=1))
    two = list(make_grain_loader(ds, 2, seed=3, num_epochs=1,
                                 worker_count=2))
    keys = lambda bs: collections.Counter(sum((b["key"] for b in bs), []))  # noqa: E731
    assert keys(none) == keys(two) and len(two) == 6
    assert all(b["lq"].shape == (2, PATCH, PATCH, 3) for b in two)

    side = ds._short.meta_shape(ds.records[0]["short_key"])[0]
    full = {r["short_key"]: ds._short.decode_crop(r["short_key"], 0, 0, side,
                                                  side)
            for r in ds.records}
    streams = {0: [], 1: []}
    for i, b in enumerate(two):
        for key, crop in zip(b["key"], b["short_raw"]):
            streams[i % 2].append(_crop_origin(full[key], crop))
    for w, got in streams.items():
        rng = np.random.default_rng([3, w])
        hi = side - PATCH + 1
        want = [(int(rng.integers(0, hi)), int(rng.integers(0, hi)))
                for _ in got]
        assert got == want, w
    assert streams[0] != streams[1]


def test_copies_of_a_dataset_repeat_its_crop_draws(paths):
    """Why ``_seed_worker`` exists: every pickled copy of the dataset (one
    per worker) starts from the same generator state. The JAX data set
    does not pickle at all (its ``threading.Lock``): a spawned grain
    worker cannot receive it, and a forked one copies its generator."""
    import pickle

    from lowlight_image_enhancement_tpu.data import SonySIDDataset as JaxSID

    ds = _dataset(paths)
    a, b = (pickle.loads(pickle.dumps(ds)) for _ in range(2))
    assert a._rng.integers(1 << 30, size=4).tolist() == \
        b._rng.integers(1 << 30, size=4).tolist()
    assert a[0]["key"] == ds[0]["key"] and a._short.uses_native
    jds = JaxSID(manifest_path=paths["manifest"], subset="train",
                 patch_size=PATCH,
                 io_backend={"type": "pack",
                             "short_path": paths["train_short"],
                             "long_path": paths["train_long"]})
    with pytest.raises(TypeError, match="lock"):
        pickle.dumps(jds)
