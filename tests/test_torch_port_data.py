"""The port's data layer against the JAX package's, on the CPU:

- SIDPack: packs written by the two writers from the same arrays are
  byte-equal (comp none, zlib, zlib_band), and each reader reads the
  other's packs (whole records and banded row ranges);
- the native reader (built by the port from ``native/``) and the
  pure-Python fallback against the JAX ``NativeSidPack``: ``decode_crop``
  and ``decode_crop_batch`` exact, with and without exposure alignment;
- every transform, with the same seeded numpy generator: exact;
- ``SonySIDDataset``: every item of a seeded train pass (random crops,
  augmentation) and a val pass, exact, ``pair_id`` and ``expo_ratio``
  included;
- ``Loader``: batch for batch over two epochs (shuffle, ``enlarge_ratio``
  2, ``drop_last`` both ways, the threaded path on a dataset without
  random draws);
- ``prefetch_to_device(device="cpu")``: the NCHW numpy batch, strings
  dropped;
- ``make_debug_sid`` / ``make_synthetic_sid``: byte-equal files.

Inputs come from numpy seeds.
"""

import os

import numpy as np
import pytest
import torch

from lowlight_image_enhancement_tpu.data import debug_fixtures as jfix
from lowlight_image_enhancement_tpu.data import native_loader as jnative
from lowlight_image_enhancement_tpu.data import pipeline as jpipe
from lowlight_image_enhancement_tpu.data import records as jrec
from lowlight_image_enhancement_tpu.data import sid_dataset as jsid
from lowlight_image_enhancement_tpu.data import transforms as jtf
from lowlight_image_enhancement_tpu_torch.data import (
    create_dataset,
    create_loader,
    debug_fixtures,
    native_loader,
    pipeline,
    records,
    sid_dataset,
    transforms,
)


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "a_u16": rng.integers(0, 65535, (70, 33, 3), dtype=np.uint16),
        "b_u16": rng.integers(0, 65535, (64, 64, 3), dtype=np.uint16),
        "c_f32": rng.normal(size=(10, 7)).astype(np.float32),
    }


@pytest.mark.parametrize("comp", ["none", "zlib", "zlib_band"])
def test_pack_bytes_equal_jax(tmp_path, comp):
    arrays = _arrays()
    for mod, name in ((jrec, "jax.pack"), (records, "port.pack")):
        with mod.SidPackWriter(str(tmp_path / name), comp=comp,
                               band_rows=16) as w:
            for k, a in arrays.items():
                w.add(k, a)
    assert ((tmp_path / "jax.pack").read_bytes()
            == (tmp_path / "port.pack").read_bytes())


@pytest.mark.parametrize("comp", ["zlib", "zlib_band"])
def test_readers_read_each_others_packs(tmp_path, comp):
    arrays = _arrays(1)
    jrec.build_sidpack(str(tmp_path / "jax.pack"), arrays, comp=comp)
    records.build_sidpack(str(tmp_path / "port.pack"), arrays, comp=comp)
    for writer in ("jax.pack", "port.pack"):
        path = str(tmp_path / writer)
        with jrec.SidPackReader(path) as jr, records.SidPackReader(path) as r:
            assert list(jr.keys()) == list(r.keys())
            for k, a in arrays.items():
                np.testing.assert_array_equal(r.get(k), a)
                np.testing.assert_array_equal(jr.get(k), a)
                if a.ndim >= 2:
                    np.testing.assert_array_equal(r.get_rows(k, 5, 20),
                                                  jr.get_rows(k, 5, 20))


@pytest.fixture(scope="module")
def debug_set(tmp_path_factory):
    root = tmp_path_factory.mktemp("sid_debug")
    return debug_fixtures.make_debug_sid(str(root), n_pairs=3, size=64)


@pytest.fixture(scope="module")
def plain_packs(tmp_path_factory):
    """Packs of uint16 records with comp zlib and none (the native batch
    path takes no banded records)."""
    root = tmp_path_factory.mktemp("packs")
    rng = np.random.default_rng(5)
    arrays = {f"k{i}": rng.integers(0, 65535, (48, 40, 3), dtype=np.uint16)
              for i in range(4)}
    paths = {}
    for comp in ("zlib", "none"):
        paths[comp] = str(root / f"{comp}.pack")
        records.build_sidpack(paths[comp], arrays, comp=comp)
    return paths


def test_native_library_is_built_by_the_port():
    assert native_loader.native_available()
    assert native_loader.library_path().parent == native_loader.BUILD_DIR


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("expo", [None, 37.5])
def test_decode_crop_matches_jax(debug_set, plain_packs, native, expo):
    paths = [debug_set["train_short"], debug_set["val_long"],
             plain_packs["zlib"], plain_packs["none"]]
    for path in paths:
        jr = jnative.NativeSidPack(path)
        r = native_loader.NativeSidPack(path)
        if not native:
            r._handle = None
        assert r.uses_native == native
        for k in r.keys():
            h, w = r.meta_shape(k)[:2]
            for top, left, ph, pw in ((0, 0, 32, 32), (h - 17, w - 9, 17, 9),
                                      (3, 5, h - 3, w - 5)):
                np.testing.assert_array_equal(
                    r.decode_crop(k, top, left, ph, pw, expo=expo),
                    jr.decode_crop(k, top, left, ph, pw, expo=expo))
        np.testing.assert_array_equal(r.get(k), jr.get(k))


@pytest.mark.parametrize("comp", ["zlib", "none"])
def test_decode_crop_batch_matches_jax(plain_packs, comp):
    jr = jnative.NativeSidPack(plain_packs[comp])
    r = native_loader.NativeSidPack(plain_packs[comp])
    keys = sorted(r.keys())
    tops, lefts = [0, 5, 11, 16], [0, 3, 7, 8]
    expos = [1.0, 2.5, 100.0, 7.0]
    for ex in (None, expos):
        np.testing.assert_array_equal(
            r.decode_crop_batch(keys, tops, lefts, 32, 32, expos=ex),
            jr.decode_crop_batch(keys, tops, lefts, 32, 32, expos=ex))


def _imgs(seed, shape=(40, 48, 3), n=2):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 1, shape).astype(np.float32) for _ in range(n)]


TRANSFORMS = {
    "paired_random_crop": lambda m, rng: m.paired_random_crop(
        _imgs(1, (40, 48, 3)), _imgs(2, (20, 24, 3)), 12, scale=2, rng=rng),
    "paired_random_crop_single": lambda m, rng: m.paired_random_crop(
        _imgs(1)[0], _imgs(2)[0], 16, rng=rng),
    "paired_random_crop_hw": lambda m, rng: m.paired_random_crop_hw(
        _imgs(1, (40, 48, 3)), _imgs(2, (20, 24, 3)), 16, 20, scale=2,
        rng=rng),
    "pad_to_min_size": lambda m, rng: m.pad_to_min_size(
        _imgs(3, (10, 7, 3))[0], _imgs(4, (20, 14, 3))[0], 32, scale=2),
    "center_crop": lambda m, rng: m.center_crop(_imgs(5)[0], 17),
    "joint_random_crop": lambda m, rng: m.joint_random_crop(
        _imgs(6, n=3), 19, rng=rng),
    "augment": lambda m, rng: [m.augment(_imgs(7), rng=rng)
                               for _ in range(6)],
    "augment_status": lambda m, rng: [
        m.augment(_imgs(8), hflip=True, rotation=True, vflip=False, rng=rng,
                  return_status=True) for _ in range(6)],
    "mod_crop": lambda m, rng: m.mod_crop(_imgs(9, (41, 47, 3))[0], 4),
    "uint16_to_float01": lambda m, rng: m.uint16_to_float01(
        np.random.default_rng(10).integers(0, 65535, (9, 8, 3),
                                           dtype=np.uint16)),
}


def _flat(x):
    if isinstance(x, (list, tuple)):
        return [y for v in x for y in _flat(v)]
    return [x]


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transforms_match_jax(name):
    got = _flat(TRANSFORMS[name](transforms, np.random.default_rng(3)))
    want = _flat(TRANSFORMS[name](jtf, np.random.default_rng(3)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def _ds_opts(paths, subset, **kw):
    root = os.path.dirname(paths["manifest"])
    return dict(manifest_path=paths["manifest"], subset=subset,
                io_backend={"type": "pack",
                            "short_path": f"{root}/{subset}_short.pack",
                            "long_path": f"{root}/{subset}_long.pack"}, **kw)


def _same_item(got, want):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], str):
            assert got[k] == want[k], k
        else:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]), err_msg=k)
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k


@pytest.mark.parametrize("case", [
    dict(subset="train", phase="train", patch_size=24, samples_per_pair=3),
    dict(subset="train", phase="train", patch_size=24, use_augment=True,
         samples_per_pair=2, seed=4),
    dict(subset="train", phase="train", patch_size=None, use_augment=True),
    dict(subset="val", phase="val", random_crop=False),
    dict(subset="val", phase="val", patch_size=40, random_crop=False),
], ids=["train_crop", "train_augment", "train_full_augment", "val_full",
        "val_center"])
def test_sid_dataset_items_match_jax(debug_set, case):
    opts = _ds_opts(debug_set, **case)
    ds = sid_dataset.SonySIDDataset(**opts)
    jds = jsid.SonySIDDataset(**opts)
    assert len(ds) == len(jds)
    for _ in range(2):                    # two passes: the rng runs on
        for i in range(len(ds)):
            _same_item(ds[i], jds[i])


def test_create_dataset_and_load_manifest(debug_set):
    ds = create_dataset({"type": "SonySIDDataset",
                         **_ds_opts(debug_set, "val", phase="val")})
    assert isinstance(ds, sid_dataset.SonySIDDataset)
    assert sid_dataset.load_manifest(debug_set["manifest"]) == \
        jsid.load_manifest(debug_set["manifest"])


class _Indexed:
    """A dataset without random draws: item i is a seeded image."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.default_rng(i)
        return {"lq": rng.uniform(size=(4, 5, 3)).astype(np.float32),
                "expo_ratio": np.float32(i + 1), "pair_id": f"p{i}"}


def _same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _same_item(g, w)


@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("shuffle", [True, False])
def test_loader_batch_for_batch(drop_last, shuffle):
    kw = dict(batch_size=3, shuffle=shuffle, seed=11, enlarge_ratio=2,
              drop_last=drop_last)
    loader = pipeline.Loader(_Indexed(7), **kw)
    jloader = jpipe.Loader(_Indexed(7), **kw)
    assert len(loader) == len(jloader)
    _same_batches(list(pipeline.epochs(loader, num_epochs=2, start_epoch=1)),
                  list(jpipe.epochs(jloader, num_epochs=2, start_epoch=1)))


def test_loader_threaded_and_host_strided():
    for kw in (dict(num_workers=3), dict(num_hosts=2, host_id=1)):
        loader = pipeline.Loader(_Indexed(9), batch_size=2, seed=2,
                                 drop_last=False, **kw)
        jloader = jpipe.Loader(_Indexed(9), batch_size=2, seed=2,
                               drop_last=False, **kw)
        _same_batches(list(pipeline.epochs(loader, num_epochs=2)),
                      list(jpipe.epochs(jloader, num_epochs=2)))


def test_loader_over_sid_dataset_matches_jax(debug_set):
    opts = dict(_ds_opts(debug_set, "train", phase="train", patch_size=16,
                         samples_per_pair=2), batch_size_per_gpu=2)
    loader = create_loader(create_dataset({"type": "SonySIDDataset",
                                           **opts}), opts, seed=7)
    jds = jsid.SonySIDDataset(**{k: v for k, v in opts.items()
                                 if k != "batch_size_per_gpu"})
    jloader = jpipe.Loader(jds, batch_size=2, seed=7)
    _same_batches(list(pipeline.epochs(loader, num_epochs=2)),
                  list(jpipe.epochs(jloader, num_epochs=2)))


def test_prefetch_to_device_cpu_gives_nchw():
    batches = list(pipeline.Loader(_Indexed(5), batch_size=2, seed=0))
    got = list(pipeline.prefetch_to_device(iter(batches), device="cpu"))
    assert len(got) == len(batches)
    for g, b in zip(got, batches):
        assert set(g) == {"lq", "expo_ratio"}
        assert g["lq"].is_contiguous() and g["lq"].device.type == "cpu"
        np.testing.assert_array_equal(
            g["lq"].numpy(), np.transpose(b["lq"], (0, 3, 1, 2)))
        np.testing.assert_array_equal(g["expo_ratio"].numpy(),
                                      b["expo_ratio"])
        assert g["lq"].dtype == torch.float32


def test_prefetch_to_device_refuses_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        next(pipeline.prefetch_to_device(iter([]), device="cuda"))


def _tree_bytes(root):
    return {name: open(os.path.join(root, name), "rb").read()
            for name in sorted(os.listdir(root))}


@pytest.mark.parametrize("which", ["debug", "synthetic"])
def test_fixtures_byte_equal_jax(tmp_path, which):
    if which == "debug":
        kw = dict(n_pairs=2, size=64, seed=3)
        debug_fixtures.make_debug_sid(str(tmp_path / "port"), **kw)
        jfix.make_debug_sid(str(tmp_path / "jax"), **kw)
    else:
        kw = dict(n_train=3, n_val=1, size=64, seed=5)
        debug_fixtures.make_synthetic_sid(str(tmp_path / "port"), **kw)
        jfix.make_synthetic_sid(str(tmp_path / "jax"), **kw)
    port, jax_ = _tree_bytes(tmp_path / "port"), _tree_bytes(tmp_path / "jax")
    assert sorted(port) == sorted(jax_) and len(port) == 5
    for name in port:
        assert port[name] == jax_[name], name
