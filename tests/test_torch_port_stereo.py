"""The port's paired-image and stereo datasets held against the JAX
package's, item for item, and the synthetic stereo tree.

Every dataset class of ``data/paired_image_dataset.py`` and
``data/stereo_dataset.py`` is built twice from the same options, on the
fixtures of ``tests/test_stereo_data.py`` (rebuilt here), and read at the
same index sequence: every array of every item equals the JAX item
exactly (the same numpy draws in the same order: crops, flips, rotations
and the ``flip_RGB`` permutation), and so do the strings. The loaders of
both packages give the same batches.
"""

import os
import pickle

import numpy as np
import pytest

from lowlight_image_enhancement_tpu.data import (
    create_dataset as jax_create_dataset,
)
from lowlight_image_enhancement_tpu.data import (
    create_loader as jax_create_loader,
)
from lowlight_image_enhancement_tpu.data.paired_image_dataset import (
    paired_paths_from_meta_info_file as jax_meta_pairs,
)
from lowlight_image_enhancement_tpu_torch.data import (
    create_dataset,
    create_loader,
    make_synthetic_stereo,
)
from lowlight_image_enhancement_tpu_torch.data.paired_image_dataset import (
    paired_paths_from_meta_info_file,
)
from lowlight_image_enhancement_tpu_torch.utils import imgio

ORDER = [0, 2, 1, 0, 2, 1, 0, 5]


def _rand_img(rng, h, w):
    return (rng.random((h, w, 3)) * 255).astype(np.uint8)


@pytest.fixture()
def flat_lr_root(tmp_path):
    """PairedImageSRLRDataset layout: flat folders of {i:04d}_{L,R}.png."""
    rng = np.random.default_rng(0)
    gt_dir, lq_dir = tmp_path / "hr", tmp_path / "lr"
    gt_dir.mkdir(), lq_dir.mkdir()
    for i in (1, 2, 3):
        for side in ("L", "R"):
            imgio.imwrite(str(gt_dir / f"{i:04}_{side}.png"),
                          _rand_img(rng, 64, 96))
            imgio.imwrite(str(lq_dir / f"{i:04}_{side}.png"),
                          _rand_img(rng, 32, 48))
    return str(gt_dir), str(lq_dir)


@pytest.fixture()
def folder_stereo_root(tmp_path):
    """PairedStereoImageDataset layout: one dir per sample (hr0/hr1,
    lr0/lr1)."""
    rng = np.random.default_rng(1)
    gt_dir, lq_dir = tmp_path / "hr", tmp_path / "lr"
    for i in range(3):
        g = gt_dir / f"{i:04}"
        l = lq_dir / f"{i:04}"
        g.mkdir(parents=True), l.mkdir(parents=True)
        imgio.imwrite(str(g / "hr0.png"), _rand_img(rng, 64, 96))
        imgio.imwrite(str(g / "hr1.png"), _rand_img(rng, 64, 96))
        imgio.imwrite(str(l / "lr0.png"), _rand_img(rng, 32, 48))
        imgio.imwrite(str(l / "lr1.png"), _rand_img(rng, 32, 48))
    return str(gt_dir), str(lq_dir)


@pytest.fixture()
def paired_root(tmp_path):
    """PairedImageDataset / SingleImageDataset / FFHQDataset layout: stems
    paired across two folders (one gray, one RGBA image among them), a
    meta_info file naming the GT files."""
    rng = np.random.default_rng(2)
    gt_dir, lq_dir = tmp_path / "gt", tmp_path / "lq"
    gt_dir.mkdir(), lq_dir.mkdir()
    names = []
    for i in range(3):
        stem = f"{i:08d}"
        names.append(f"{stem}.png")
        gt, lq = _rand_img(rng, 40, 56), _rand_img(rng, 20, 28)
        if i == 1:
            gt, lq = gt[..., 0], lq[..., 0]
        if i == 2:
            gt = np.concatenate([gt, _rand_img(rng, 40, 56)[..., :1]], -1)
        imgio.imwrite(str(gt_dir / f"{stem}.png"), gt)
        imgio.imwrite(str(lq_dir / f"{stem}.png"), lq)
    (lq_dir / "notes.txt").write_text("not an image")
    meta = tmp_path / "meta_info.txt"
    meta.write_text("".join(f"{n} (40,56,3)\n" for n in names))
    return str(gt_dir), str(lq_dir), str(meta)


def _assert_same_item(got, ref, where):
    assert set(got) == set(ref), where
    for k, v in ref.items():
        if isinstance(v, np.ndarray):
            g = got[k]
            assert isinstance(g, np.ndarray) and g.dtype == v.dtype \
                and g.shape == v.shape, f"{where} {k}"
            np.testing.assert_array_equal(g, v, err_msg=f"{where} {k}")
        else:
            assert got[k] == v, f"{where} {k}"


def _hold(opt, order=ORDER):
    ref_ds, ds = jax_create_dataset(dict(opt)), create_dataset(dict(opt))
    assert len(ds) == len(ref_ds)
    for i in order:
        _assert_same_item(ds[i], ref_ds[i], f"{opt['type']}[{i}]")
    return ds


@pytest.mark.parametrize("phase", ["train", "val"])
def test_flat_lr_items_equal_jax(flat_lr_root, phase):
    gt_dir, lq_dir = flat_lr_root
    ds = _hold({"type": "PairedImageSRLRDataset", "dataroot_gt": gt_dir,
                "dataroot_lq": lq_dir, "phase": phase, "gt_size": 32,
                "scale": 2, "seed": 3})
    if phase == "train":
        assert ds[0]["lq"].shape == (16, 16, 6)


def test_flat_lr_pads_small_images_as_jax(tmp_path):
    rng = np.random.default_rng(4)
    gt_dir, lq_dir = tmp_path / "hr", tmp_path / "lr"
    gt_dir.mkdir(), lq_dir.mkdir()
    for side in ("L", "R"):
        imgio.imwrite(str(gt_dir / f"0001_{side}.png"), _rand_img(rng, 20, 20))
        imgio.imwrite(str(lq_dir / f"0001_{side}.png"), _rand_img(rng, 10, 10))
    ds = _hold({"type": "PairedImageSRLRDataset", "dataroot_gt": str(gt_dir),
                "dataroot_lq": str(lq_dir), "phase": "train", "gt_size": 32,
                "scale": 2}, order=[0, 0, 0])
    assert ds[0]["gt"].shape == (32, 32, 6)


@pytest.mark.parametrize("phase", ["train", "val"])
@pytest.mark.parametrize("hw", [(24, 40), (16, None)])
def test_folder_stereo_items_equal_jax(folder_stereo_root, phase, hw):
    """``flip_RGB``, hflip, vflip and rotation on; a rectangular crop and a
    square one (``gt_size``)."""
    gt_dir, lq_dir = folder_stereo_root
    h, w = hw
    size = ({"gt_size_h": h, "gt_size_w": w} if w else {"gt_size": h})
    ds = _hold({"type": "PairedStereoImageDataset", "dataroot_gt": gt_dir,
                "dataroot_lq": lq_dir, "phase": phase, "scale": 2,
                "flip_RGB": True, "use_hflip": True, "use_vflip": True,
                "use_rot": True, "seed": 1, **size})
    want = (h // 2, (w or h) // 2, 6) if phase == "train" else (32, 48, 6)
    assert ds[1]["lq"].shape in (want, want[1::-1] + (6,))


@pytest.mark.parametrize("kind", ["pkl", "npz", "npy"])
@pytest.mark.parametrize("phase", ["train", "val"])
def test_full_image_memory_items_equal_jax(tmp_path, kind, phase):
    rng = np.random.default_rng(5)
    gts = np.stack([(rng.random((40, 40, 6)) * 255).astype(np.uint8)
                    for _ in range(2)])
    lqs = np.stack([(rng.random((20, 20, 6)) * 255).astype(np.uint8)
                    for _ in range(2)])
    paths = []
    for name, arr in (("gts", gts), ("lqs", lqs)):
        path = tmp_path / f"{name}.{kind}"
        if kind == "pkl":
            path.write_bytes(pickle.dumps(list(arr)))
        elif kind == "npz":
            np.savez(path, **{f"{i:03}": a for i, a in enumerate(arr)})
        else:
            np.save(path, arr)
        paths.append(str(path))
    _hold({"type": "PairedImageSRLRFullImageMemoryDataset",
           "dataroot_gt": paths[0], "dataroot_lq": paths[1], "phase": phase,
           "gt_size": 24, "scale": 2, "seed": 6, "num_samples": 5},
          order=[0, 3, 1, 4, 2])


@pytest.mark.parametrize("meta", [False, True])
@pytest.mark.parametrize("phase", ["train", "val"])
def test_paired_image_items_equal_jax(paired_root, meta, phase):
    gt_dir, lq_dir, meta_file = paired_root
    _hold({"type": "PairedImageDataset", "dataroot_gt": gt_dir,
           "dataroot_lq": lq_dir, "phase": phase, "gt_size": 16, "scale": 2,
           "seed": 7, **({"meta_info_file": meta_file} if meta else {})},
          order=[0, 1, 2, 4, 0])


def test_meta_info_pairs_equal_jax(paired_root):
    gt_dir, lq_dir, meta_file = paired_root
    for tmpl in ("{}", "{}x2"):
        assert paired_paths_from_meta_info_file(
            lq_dir, gt_dir, meta_file, tmpl) == jax_meta_pairs(
                lq_dir, gt_dir, meta_file, tmpl)


def test_paired_image_without_pairs_raises(tmp_path):
    (tmp_path / "a").mkdir(), (tmp_path / "b").mkdir()
    with pytest.raises(ValueError):
        create_dataset({"type": "PairedImageDataset",
                        "dataroot_gt": str(tmp_path / "a"),
                        "dataroot_lq": str(tmp_path / "b")})


@pytest.mark.parametrize("opts", [{}, {"use_hflip": True, "seed": 8},
                                  {"num_images": 2}, {"meta": True}])
def test_ffhq_items_equal_jax(paired_root, opts):
    gt_dir, _, meta_file = paired_root
    opts = dict(opts)
    if opts.pop("meta", False):
        opts["meta_info_file"] = meta_file
    _hold({"type": "FFHQDataset", "dataroot_gt": gt_dir, **opts},
          order=[0, 1, 2, 0, 1, 2])


def test_single_image_items_equal_jax(paired_root):
    _, lq_dir, _ = paired_root
    _hold({"type": "SingleImageDataset", "dataroot_lq": lq_dir},
          order=[0, 1, 2, 3])


def test_stereo_loader_batches_equal_jax(folder_stereo_root):
    """The config-style loader of both packages over the same set: the
    same batches in the same order for two epochs."""
    gt_dir, lq_dir = folder_stereo_root
    opt = {"type": "PairedStereoImageDataset", "dataroot_gt": gt_dir,
           "dataroot_lq": lq_dir, "phase": "train", "gt_size_h": 16,
           "gt_size_w": 24, "scale": 2, "flip_RGB": True, "seed": 2,
           "batch_size_per_gpu": 2, "use_vflip": True}
    ref = jax_create_loader(jax_create_dataset(dict(opt)), opt, seed=4)
    got = create_loader(create_dataset(dict(opt)), opt, seed=4)
    assert len(got) == len(ref) == 1
    for epoch in range(2):
        ref.set_epoch(epoch), got.set_epoch(epoch)
        b_refs, b_gots = list(ref), list(got)
        assert len(b_refs) == len(b_gots) == 1
        for b_ref, b_got in zip(b_refs, b_gots):
            _assert_same_item(b_got, {k: (np.asarray(v) if k in ("lq", "gt")
                                          else v) for k, v in b_ref.items()},
                              f"epoch {epoch}")


def test_synthetic_stereo_tree_is_the_config_layout(tmp_path):
    """``make_synthetic_stereo``: the Flickr1024 directories that
    ``configs/stereo_nafssr.yml`` reads, HR = 2 x LR (LR the 2x2 mean of
    HR), the right view the left one shifted, validation images of two
    sizes; the same seed writes the same bytes."""
    paths = make_synthetic_stereo(str(tmp_path / "a"), n_train=5, n_val=2)
    again = make_synthetic_stereo(str(tmp_path / "b"), n_train=5, n_val=2)
    for subset, n in (("train", 5), ("val", 2)):
        hr, lr = paths[f"{subset}_hr"], paths[f"{subset}_lr"]
        assert hr == str(tmp_path / "a" / subset / "hr")
        assert lr == str(tmp_path / "a" / subset / "lr_x2")
        assert sorted(os.listdir(hr)) == [f"{i:04d}" for i in range(1, n + 1)]
        for sample in os.listdir(hr):
            views = [imgio.imread(os.path.join(hr, sample, f"hr{k}.png"))
                     for k in (0, 1)]
            small = [imgio.imread(os.path.join(lr, sample, f"lr{k}.png"))
                     for k in (0, 1)]
            for big, lo in zip(views, small):
                assert big.dtype == lo.dtype == np.uint8
                assert big.shape == (2 * lo.shape[0], 2 * lo.shape[1], 3)
                mean = big.astype(np.float32).reshape(
                    lo.shape[0], 2, lo.shape[1], 2, 3).mean((1, 3))
                assert np.abs(mean - lo).max() <= 0.5
            assert not np.array_equal(views[0], views[1])
            for k in (0, 1):
                with open(os.path.join(hr, sample, f"hr{k}.png"), "rb") as a, \
                        open(os.path.join(again[f"{subset}_hr"], sample,
                                          f"hr{k}.png"), "rb") as b:
                    assert a.read() == b.read()
    val = create_dataset({"type": "PairedStereoImageDataset",
                          "dataroot_gt": paths["val_hr"],
                          "dataroot_lq": paths["val_lr"], "phase": "val",
                          "scale": 2})
    assert val[0]["gt"].shape != val[1]["gt"].shape
