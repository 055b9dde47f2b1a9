"""The port's video/flow path and raw-SID data set against the JAX package.

Held against ``tests/test_video_test_dataset.py`` (its 20 claims, each
repeated here on both packages with the items compared bit for bit),
``tests/test_sid_raw_dataset.py`` (its 15 claims, with the same stub
decoder), ``tests/test_aux_completeness.py`` (flow I/O, VideoFrameDataset,
memcached against an in-test server) and ``tests/test_misc_components.py``
(flow warps). Tolerances: ``flow_warp`` 1e-6 (the same fp32 arithmetic in
the same order), ``resize_flow`` and ``duf_downsample`` 1e-5 (a filter
sum in another order), data set items and indices exact.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import socket
import threading
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lowlight_image_enhancement_tpu.data as jdata
from lowlight_image_enhancement_tpu.data import memcached_client as jmc
from lowlight_image_enhancement_tpu.data import sid_raw_dataset as jraw
from lowlight_image_enhancement_tpu.data import video_dataset as jvd
from lowlight_image_enhancement_tpu.data import video_test_dataset as jvt
from lowlight_image_enhancement_tpu.ops import image_ops as jops
from lowlight_image_enhancement_tpu.utils import flow_util as jflow
from lowlight_image_enhancement_tpu.utils import misc as jmisc
import lowlight_image_enhancement_tpu_torch.data as tdata
from lowlight_image_enhancement_tpu_torch.data import memcached_client as tmc
from lowlight_image_enhancement_tpu_torch.data import sid_raw_dataset as traw
from lowlight_image_enhancement_tpu_torch.data import video_dataset as tvd
from lowlight_image_enhancement_tpu_torch.data import video_test_dataset as tvt
from lowlight_image_enhancement_tpu_torch.ops import image_ops as tops
from lowlight_image_enhancement_tpu_torch.utils import flow_util as tflow
from lowlight_image_enhancement_tpu_torch.utils import imgio
from lowlight_image_enhancement_tpu_torch.utils import misc as tmisc


def _same_items(a, b):
    """Two items (dicts of arrays, strings, numbers) equal bit for bit."""
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


# ---------------------------------------------------------------------------
# flow warps
# ---------------------------------------------------------------------------

def _flow_case(seed=0, n=2, h=9, w=13, c=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    flow = rng.uniform(-4, 4, (n, h, w, 2)).astype(np.float32)
    # whole and half-integer displacements, and some far out of bounds
    flow[0, :3] = np.round(flow[0, :3])
    flow[0, 3:6] = np.floor(flow[0, 3:6]) + 0.5
    flow[1, :2] *= 5.0
    return x, flow


@pytest.mark.parametrize("interp", ["bilinear", "nearest"])
@pytest.mark.parametrize("padding", ["zeros", "border"])
def test_flow_warp_matches_jax(interp, padding):
    x, flow = _flow_case()
    want = np.asarray(jops.flow_warp(jnp.asarray(x), jnp.asarray(flow),
                                     interp, padding))
    got = tops.flow_warp(torch.from_numpy(x), torch.from_numpy(flow),
                         interp, padding).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_flow_warp_identity_shift_and_errors():
    x, _ = _flow_case(1)
    xt = torch.from_numpy(x)
    zero = torch.zeros(x.shape[:3] + (2,))
    torch.testing.assert_close(tops.flow_warp(xt, zero), xt)
    shift = zero.clone()
    shift[..., 0] = 1.0     # sample one pixel to the right
    out = tops.flow_warp(xt, shift)
    torch.testing.assert_close(out[:, :, :-1], xt[:, :, 1:])
    assert float(out[:, :, -1].abs().max()) == 0.0
    with pytest.raises(ValueError, match="interp_mode"):
        tops.flow_warp(xt, zero, interp_mode="cubic")
    with pytest.raises(ValueError, match="padding_mode"):
        tops.flow_warp(xt, zero, padding_mode="reflect")
    with pytest.raises(ValueError, match="flow shape"):
        tops.flow_warp(xt, zero[:, :-1])


@pytest.mark.parametrize("size_type,sizes", [
    ("ratio", (0.5, 0.5)), ("ratio", (2.0, 2.0)), ("ratio", (0.5, 2.0)),
    ("shape", (7, 30)), ("shape", (4, 5))])
def test_resize_flow_matches_jax(size_type, sizes):
    rng = np.random.default_rng(2)
    flow = rng.uniform(-3, 3, (2, 12, 16, 2)).astype(np.float32)
    want = np.asarray(jops.resize_flow(jnp.asarray(flow), size_type, sizes))
    got = tops.resize_flow(torch.from_numpy(flow), size_type, sizes).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_resize_flow_nearest_upsampling_matches_jax():
    flow = np.random.default_rng(3).uniform(
        -3, 3, (1, 6, 8, 2)).astype(np.float32)
    want = np.asarray(jops.resize_flow(jnp.asarray(flow), "ratio", (2, 2),
                                       "nearest"))
    got = tops.resize_flow(torch.from_numpy(flow), "ratio", (2, 2),
                           "nearest").numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="size_type"):
        tops.resize_flow(torch.from_numpy(flow), "scale", (2, 2))


def test_measure_inference_speed_counts_calls():
    calls = []

    def fn(v):
        calls.append(v)
        return torch.ones(2) * v

    fps = tops.measure_inference_speed(fn, 3.0, max_iter=10)
    assert len(calls) == 10 and fps > 0


# ---------------------------------------------------------------------------
# flow files, misc
# ---------------------------------------------------------------------------

def test_flo_files_cross_read(tmp_path):
    flow = np.random.default_rng(4).standard_normal(
        (12, 17, 2)).astype(np.float32)
    tflow.flowwrite(flow, str(tmp_path / "port.flo"))
    jflow.flowwrite(flow, str(tmp_path / "jax.flo"))
    assert ((tmp_path / "port.flo").read_bytes()
            == (tmp_path / "jax.flo").read_bytes())
    np.testing.assert_array_equal(jflow.flowread(str(tmp_path / "port.flo")),
                                  flow)
    np.testing.assert_array_equal(tflow.flowread(str(tmp_path / "jax.flo")),
                                  flow)
    bad = tmp_path / "bad.flo"
    bad.write_bytes(b"\x00" * 16)
    with pytest.raises(ValueError, match="magic"):
        tflow.flowread(str(bad))
    with pytest.raises(ValueError, match="expected"):
        tflow.flowwrite(np.zeros((4, 4, 3)), str(tmp_path / "x.flo"))


@pytest.mark.parametrize("max_magnitude", [None, 2.0])
def test_flow_to_color_matches_jax(max_magnitude):
    flow = np.random.default_rng(5).standard_normal(
        (8, 9, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        tflow.flow_to_color(flow, max_magnitude),
        jflow.flow_to_color(flow, max_magnitude))
    white = tflow.flow_to_color(np.zeros((4, 4, 2)), max_magnitude=1.0)
    np.testing.assert_allclose(white, 1.0, atol=1e-6)


def test_misc_scandir_and_helpers_match_jax(tmp_path):
    for rel in ("a.png", "b.txt", "sub/c.png", "sub/deep/d.png", ".hidden"):
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(b"")
    for kw in ({}, {"suffix": ".png"}, {"recursive": True},
               {"suffix": ".png", "recursive": True, "full_path": True}):
        assert (list(tmisc.scandir(str(tmp_path), **kw))
                == list(jmisc.scandir(str(tmp_path), **kw)))
    for size in (0, 1000, 123456789, 2.0 ** 85):
        assert tmisc.sizeof_fmt(size) == jmisc.sizeof_fmt(size)
    opt = {"path": {"resume_state": "x", "models": "m",
                    "pretrain_network_g": "p"}}
    jopt = {"path": dict(opt["path"])}
    tmisc.check_resume(opt, 20)
    jmisc.check_resume(jopt, 20)
    assert opt == jopt
    tmisc.set_random_seed(3)
    a = (np.random.rand(), torch.rand(1).item())
    tmisc.set_random_seed(3)
    assert (np.random.rand(), torch.rand(1).item()) == a


def test_misc_make_exp_dirs_archives(tmp_path):
    root = tmp_path / "exp"
    root.mkdir()
    (root / "old.txt").write_text("x")
    opt = {"is_train": True,
           "path": {"experiments_root": str(root),
                    "models": str(root / "models"),
                    "pretrain_network_g": str(tmp_path / "none")}}
    tmisc.make_exp_dirs(opt)
    assert (root / "models").is_dir() and not (root / "old.txt").exists()
    assert any(p.name.startswith("exp_archived_") for p in tmp_path.iterdir())
    assert not (tmp_path / "none").exists()


# ---------------------------------------------------------------------------
# video test data sets (tests/test_video_test_dataset.py on both packages)
# ---------------------------------------------------------------------------

def _write_png(path, seed, shape=(12, 16, 3)):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    rng = np.random.default_rng(seed)
    arr = rng.integers(0, 256, size=shape, dtype=np.int64).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(imgio.encode_png(arr))
    return arr


def make_clip_tree(root, clips=("clipA", "clipB"), frames=5,
                   shape=(12, 16, 3)):
    for ci, clip in enumerate(clips):
        for i in range(frames):
            _write_png(str(root / "lq" / clip / f"{i:08d}.png"),
                       seed=1000 * ci + i, shape=shape)
            _write_png(str(root / "gt" / clip / f"{i:08d}.png"),
                       seed=9000 + 1000 * ci + i, shape=shape)
    return str(root / "lq"), str(root / "gt")


@pytest.mark.parametrize("padding", ["replicate", "reflection",
                                     "reflection_circle", "circle"])
def test_generate_frame_indices_match_jax(padding):
    for crt in (0, 1, 2, 50, 97, 98, 99):
        for num in (1, 3, 5, 7):
            assert (tvt.generate_frame_indices(crt, 100, num, padding)
                    == jvt.generate_frame_indices(crt, 100, num, padding))
    table = {"replicate": [0, 0, 0, 1, 2], "reflection": [2, 1, 0, 1, 2],
             "reflection_circle": [4, 3, 0, 1, 2], "circle": [3, 4, 0, 1, 2]}
    assert tvt.generate_frame_indices(0, 100, 5, padding) == table[padding]


def test_generate_frame_indices_edges_and_errors():
    assert tvt.generate_frame_indices(99, 100, 5, "reflection") == \
        [97, 98, 99, 98, 97]
    assert tvt.generate_frame_indices(50, 100, 5, "replicate") == \
        [48, 49, 50, 51, 52]
    with pytest.raises(AssertionError):
        tvt.generate_frame_indices(0, 10, 4)
    with pytest.raises(AssertionError):
        tvt.generate_frame_indices(0, 10, 5, "zero")


def test_read_img_seq_matches_jax(tmp_path):
    arrs = [_write_png(str(tmp_path / "c" / f"{i}.png"), seed=i)
            for i in range(3)]
    seq = tvt.read_img_seq(str(tmp_path / "c"))
    assert seq.shape == (3, 12, 16, 3) and seq.dtype == np.float32
    np.testing.assert_array_equal(seq, jvt.read_img_seq(str(tmp_path / "c")))
    np.testing.assert_allclose(seq[1], arrs[1] / 255.0, atol=1e-6)
    one = [str(tmp_path / "c" / "2.png")]
    np.testing.assert_array_equal(tvt.read_img_seq(one), jvt.read_img_seq(one))
    _write_png(str(tmp_path / "d" / "0.png"), seed=0, shape=(13, 17, 3))
    cropped = tvt.read_img_seq(str(tmp_path / "d"), require_mod_crop=True,
                               scale=4)
    assert cropped.shape == (1, 12, 16, 3)
    np.testing.assert_array_equal(
        cropped, jvt.read_img_seq(str(tmp_path / "d"), require_mod_crop=True,
                                  scale=4))


def test_gaussian_kernel_matches_jax():
    k = tvt.generate_gaussian_kernel(13, 1.6)
    np.testing.assert_array_equal(k, jvt.generate_gaussian_kernel(13, 1.6))
    assert k.shape == (13, 13) and k[6, 6] == k.max()
    assert np.isclose(k.sum(), 1.0, atol=1e-6)


@pytest.mark.parametrize("scale,shape", [
    (2, (2, 3, 16, 16, 3)), (3, (1, 2, 18, 21, 2)), (4, (1, 2, 16, 24, 3)),
    # frames smaller than the padding (13 // 2 + 2 * scale): numpy's
    # repeated reflection
    (4, (1, 2, 8, 12, 1)), (2, (1, 1, 4, 6, 3)), (3, (1, 1, 1, 9, 1))])
def test_duf_downsample_matches_jax(scale, shape):
    x = np.random.default_rng(6).uniform(0, 1, shape).astype(np.float32)
    want = np.asarray(jvt.duf_downsample(x, kernel_size=13, scale=scale))
    got = tvt.duf_downsample(x, kernel_size=13, scale=scale)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    got4 = tvt.duf_downsample(torch.from_numpy(x[0]), scale=scale)
    np.testing.assert_allclose(got4.numpy(), got[0].numpy(), atol=1e-6)


def test_duf_downsample_constant_and_bad_scale():
    x = np.full((1, 1, 16, 16, 1), 0.5, np.float32)
    np.testing.assert_allclose(tvt.duf_downsample(x, scale=2).numpy(), 0.5,
                               atol=1e-5)
    with pytest.raises(AssertionError):
        tvt.duf_downsample(np.zeros((1, 1, 8, 8, 1), np.float32), scale=5)


def _vid_opt(lq, gt, **kw):
    opt = {"name": "Vid4", "dataroot_gt": gt, "dataroot_lq": lq,
           "io_backend": {"type": "disk"}, "cache_data": False,
           "num_frame": 3, "padding": "reflection"}
    opt.update(kw)
    return opt


def _both(cls_name, opt):
    return getattr(tvt, cls_name)(dict(opt)), getattr(jvt, cls_name)(dict(opt))


@pytest.mark.parametrize("cache", [False, True])
def test_video_test_dataset_items_match_jax(tmp_path, cache):
    lq, gt = make_clip_tree(tmp_path, frames=5)
    ours, ref = _both("VideoTestDataset", _vid_opt(lq, gt, cache_data=cache))
    assert len(ours) == len(ref) == 10
    assert ours.data_info == ref.data_info
    assert ours.data_info["border"][:5] == [1, 0, 0, 0, 1]
    for i in range(len(ours)):
        _same_items(ours[i], ref[i])
    item = ours[0]
    assert item["lq"].shape == (3, 12, 16, 3) and item["gt"].shape == (12, 16, 3)
    assert item["folder"] == "clipA" and item["idx"] == "0/5"
    np.testing.assert_array_equal(item["lq"][0], item["lq"][2])


def test_video_test_dataset_cache_equivalence(tmp_path):
    lq, gt = make_clip_tree(tmp_path, frames=4)
    cold = tvt.VideoTestDataset(_vid_opt(lq, gt, cache_data=False))
    hot = tvt.VideoTestDataset(_vid_opt(lq, gt, cache_data=True))
    assert isinstance(hot.imgs_lq["clipA"], np.ndarray)
    for i in (0, 3, 5):
        np.testing.assert_array_equal(cold[i]["lq"], hot[i]["lq"])
        np.testing.assert_array_equal(cold[i]["gt"], hot[i]["gt"])


def test_video_test_dataset_meta_info_subsets(tmp_path):
    lq, gt = make_clip_tree(tmp_path, frames=3)
    meta = tmp_path / "meta.txt"
    meta.write_text("clipB 3\n")
    ours, ref = _both("VideoTestDataset",
                      _vid_opt(lq, gt, meta_info_file=str(meta)))
    assert len(ours) == 3 and set(ours.data_info["folder"]) == {"clipB"}
    assert ours.data_info == ref.data_info
    _same_items(ours[1], ref[1])


def test_video_test_dataset_rejects(tmp_path):
    lq, gt = make_clip_tree(tmp_path, frames=2)
    with pytest.raises(ValueError, match="Non-supported"):
        tvt.VideoTestDataset(_vid_opt(lq, gt, name="mystery"))
    with pytest.raises(AssertionError, match="lmdb"):
        tvt.VideoTestDataset(_vid_opt(lq, gt, io_backend={"type": "lmdb"}))
    _write_png(str(tmp_path / "lq" / "clipA" / "00000099.png"), seed=5)
    with pytest.raises(AssertionError, match="Different number"):
        tvt.VideoTestDataset(_vid_opt(lq, gt))


def test_vimeo90k_matches_jax(tmp_path):
    for i in range(1, 8):
        _write_png(str(tmp_path / "lq" / "00001" / "0266" / f"im{i}.png"),
                   seed=i)
    _write_png(str(tmp_path / "gt" / "00001" / "0266" / "im4.png"), seed=40)
    meta = tmp_path / "meta.txt"
    meta.write_text("00001/0266 7 (256,448,3)\n")
    opt = {"name": "Vimeo90K", "dataroot_gt": str(tmp_path / "gt"),
           "dataroot_lq": str(tmp_path / "lq"),
           "io_backend": {"type": "disk"}, "cache_data": False,
           "num_frame": 5, "meta_info_file": str(meta)}
    ours, ref = _both("VideoTestVimeo90KDataset", opt)
    assert len(ours) == 1
    _same_items(ours[0], ref[0])
    assert ours[0]["lq"].shape == (5, 12, 16, 3)
    assert ours[0]["lq_path"].endswith("im4.png")
    with pytest.raises(NotImplementedError):
        tvt.VideoTestVimeo90KDataset({**opt, "cache_data": True})


@pytest.mark.parametrize("cache", [False, True])
def test_duf_dataset_matches_jax(tmp_path, cache):
    lq, gt = make_clip_tree(tmp_path, clips=("clipA",), frames=3,
                            shape=(16, 16, 3))
    opt = _vid_opt(lq, gt, cache_data=cache, use_duf_downsampling=True,
                   scale=2)
    ours, ref = _both("VideoTestDUFDataset", opt)
    for i in range(len(ours)):
        a, b = ours[i], ref[i]
        assert a["lq"].shape == (3, 8, 8, 3) and a["gt"].shape == (16, 16, 3)
        np.testing.assert_allclose(a["lq"], b["lq"], atol=1e-5, rtol=0)
        np.testing.assert_array_equal(a["gt"], b["gt"])
        assert {k: a[k] for k in ("folder", "idx", "border", "lq_path")} == \
            {k: b[k] for k in ("folder", "idx", "border", "lq_path")}
    plain = tvt.VideoTestDUFDataset(
        _vid_opt(lq, gt, use_duf_downsampling=False, scale=2))
    _same_items(plain[1], jvt.VideoTestDUFDataset(
        _vid_opt(lq, gt, use_duf_downsampling=False, scale=2))[1])


def test_recurrent_dataset_matches_jax(tmp_path):
    lq, gt = make_clip_tree(tmp_path, frames=4)
    opt = {"name": "REDS4", "dataroot_gt": gt, "dataroot_lq": lq,
           "io_backend": {"type": "disk"}, "cache_data": True,
           "num_frame": 3}
    ours, ref = _both("VideoRecurrentTestDataset", opt)
    assert len(ours) == 2 and ours.folders == ref.folders
    for i in range(2):
        _same_items(ours[i], ref[i])
    assert ours[0]["lq"].shape == (4, 12, 16, 3)
    with pytest.raises(NotImplementedError):
        tvt.VideoRecurrentTestDataset({**opt, "cache_data": False})[0]


def test_video_datasets_registered():
    from lowlight_image_enhancement_tpu_torch.utils.registry import (
        DATASET_REGISTRY,
    )

    for name in ("VideoTestDataset", "VideoTestVimeo90KDataset",
                 "VideoTestDUFDataset", "VideoRecurrentTestDataset",
                 "VideoFrameDataset", "SonySIDRawDataset"):
        assert DATASET_REGISTRY.get(name) is getattr(tdata, name)


# ---------------------------------------------------------------------------
# VideoFrameDataset (training clips)
# ---------------------------------------------------------------------------

@pytest.fixture
def video_root(tmp_path):
    rng = np.random.default_rng(7)
    for clip in ("clip_a", "clip_b"):
        for fi in range(6):
            img = rng.integers(0, 255, (24, 24, 3)).astype("uint8")
            imgio.imwrite(str(tmp_path / "gt" / clip / f"{fi:08d}.png"), img)
            imgio.imwrite(str(tmp_path / "lq" / clip / f"{fi:08d}.png"),
                          img // 2)
    return tmp_path


@pytest.mark.parametrize("mode", ["reflection", "replicate"])
def test_pad_frame_indices_match_jax(mode):
    for center in range(10):
        for num in (1, 3, 5, 7):
            assert (tvd.pad_frame_indices(center, 10, num, mode)
                    == jvd.pad_frame_indices(center, 10, num, mode))
    with pytest.raises(ValueError, match="padding mode"):
        tvd.pad_frame_indices(0, 10, 5, "circle")


@pytest.mark.parametrize("phase,gt_size", [("train", 16), ("val", None)])
def test_video_frame_dataset_matches_jax(video_root, phase, gt_size):
    kw = dict(dataroot_gt=str(video_root / "gt"),
              dataroot_lq=str(video_root / "lq"), num_frame=5, phase=phase,
              gt_size=gt_size, seed=3)
    ours, ref = tvd.VideoFrameDataset(**kw), jvd.VideoFrameDataset(**kw)
    assert len(ours) == len(ref) == 12
    for i in (0, 5, 7, 11, 0):
        _same_items(ours[i], ref[i])
    side = gt_size or 24
    assert ours[3]["lq"].shape == (5, side, side, 3)
    ds = tdata.create_dataset({"type": "VideoFrameDataset", **kw})
    assert ds[0]["key"].startswith("clip_a/")


# ---------------------------------------------------------------------------
# memcached client against an in-test server
# ---------------------------------------------------------------------------

class _FakeMemcached(threading.Thread):
    """Minimal in-process memcached server (one connection) on localhost."""

    def __init__(self):
        super().__init__(daemon=True)
        self.store = {}
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(1)
        self.port = self.sock.getsockname()[1]

    def run(self):
        conn, _ = self.sock.accept()
        buf = b""
        with conn:
            while True:
                data = conn.recv(4096)
                if not data:
                    return
                buf += data
                while b"\r\n" in buf:
                    line, buf = buf.split(b"\r\n", 1)
                    parts = line.split()
                    if parts and parts[0] == b"get":
                        key = parts[1].decode()
                        if key in self.store:
                            val = self.store[key]
                            conn.sendall(f"VALUE {key} 0 {len(val)}\r\n"
                                         .encode() + val + b"\r\nEND\r\n")
                        else:
                            conn.sendall(b"END\r\n")
                    elif parts and parts[0] == b"set":
                        nbytes = int(parts[4])
                        while len(buf) < nbytes + 2:
                            buf += conn.recv(4096)
                        self.store[parts[1].decode()] = buf[:nbytes]
                        buf = buf[nbytes + 2:]
                        conn.sendall(b"STORED\r\n")

    def stop(self):
        self.sock.close()
        self.join(timeout=5)
        assert not self.is_alive()


@pytest.mark.parametrize("client_mod", [tmc, jmc], ids=["port", "jax"])
def test_memcached_roundtrip(client_mod):
    server = _FakeMemcached()
    server.start()
    client = client_mod.MemcachedClient(port=server.port)
    png = imgio.encode_png(np.arange(48, dtype=np.uint8).reshape(4, 4, 3))
    assert client.set("img1", png)
    assert client.get("img1") == png
    assert client.get("missing") is None
    client.close()
    server.stop()


def test_memcached_backend_miss_and_unreachable():
    server = _FakeMemcached()
    server.start()
    backend = tmc.MemcachedBackend(port=server.port)
    with pytest.raises(KeyError):
        backend.get("nope")
    backend.close()
    server.stop()
    with pytest.raises(ConnectionError, match="unreachable"):
        tmc.MemcachedClient(port=1).get("x")   # nothing listens on port 1


# ---------------------------------------------------------------------------
# raw SID data set (tests/test_sid_raw_dataset.py on both packages)
# ---------------------------------------------------------------------------

def _touch(p: Path) -> None:
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_bytes(b"")


def make_tree(root: Path, shorts, longs, camera="Sony") -> Path:
    for name in shorts:
        _touch(root / camera / "short" / name)
    for name in longs:
        _touch(root / camera / "long" / name)
    return root


def fake_decoder(shape=(32, 48, 3)):
    """Deterministic uint16 image from the file name; counts calls."""
    calls = []

    def decode(path: Path) -> np.ndarray:
        calls.append(path)
        seed = sum(path.name.encode()) * 7919
        rng = np.random.default_rng(seed)
        return rng.integers(0, 65536, size=shape,
                            dtype=np.int64).astype(np.uint16)

    decode.calls = calls
    return decode


@pytest.mark.parametrize("name", ["00001_00_0.04s.ARW", "00123_07_100ms.ARW",
                                  "badname.ARW", "00001_00_fast.ARW",
                                  "00001_00_0s.ARW"])
def test_parse_sid_filename_matches_jax(name):
    try:
        want = jraw.parse_sid_filename(Path(name))
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split(":")[0][:20]):
            traw.parse_sid_filename(Path(name))
        return
    assert traw.parse_sid_filename(Path(name)) == want


def _pairs_equal(a, b):
    assert [dataclasses.asdict(p) for p in a] == \
        [dataclasses.asdict(p) for p in b]


def test_find_sid_pairs_matches_jax(tmp_path):
    make_tree(tmp_path, ["00002_00_0.1s.ARW", "00001_00_0.04s.ARW"],
              ["00002_00_10s.ARW", "00001_00_10s.ARW"])
    pairs = traw.find_sid_pairs(tmp_path)
    assert [p.pair_id for p in pairs] == ["00001_00", "00002_00"]
    assert pairs[0].exposure_ratio == pytest.approx(250.0)
    _pairs_equal(pairs, jraw.find_sid_pairs(tmp_path))


def test_find_sid_pairs_errors(tmp_path, caplog):
    with pytest.raises(FileNotFoundError, match="Missing directory"):
        traw.find_sid_pairs(tmp_path)
    make_tree(tmp_path, ["00001_00_0.04s.ARW", "00003_00_0.1s.ARW",
                         "00001_00_0.1s.ARW"], ["00001_00_10s.ARW"])
    with pytest.raises(FileNotFoundError, match="no matching long"):
        traw.find_sid_pairs(tmp_path)
    with caplog.at_level(logging.WARNING):
        pairs = traw.find_sid_pairs(tmp_path, allow_incomplete=True)
    assert [p.pair_id for p in pairs] == ["00001_00"]
    assert pairs[0].short_exposure == pytest.approx(0.04)
    assert any("skipped" in r.message for r in caplog.records)
    assert any("Duplicate" in r.message for r in caplog.records)
    _pairs_equal(pairs, jraw.find_sid_pairs(tmp_path, allow_incomplete=True))
    empty = tmp_path / "empty"
    (empty / "Sony" / "short").mkdir(parents=True)
    (empty / "Sony" / "long").mkdir(parents=True)
    with pytest.raises(RuntimeError, match="No SID pairs"):
        traw.find_sid_pairs(empty)


def _raw_both(tmp_path, **kw):
    make_tree(tmp_path, ["00001_00_0.1s.ARW", "00002_00_0.04s.ARW"],
              ["00001_00_10s.ARW", "00002_00_10s.ARW"])
    kw.setdefault("patch_size", 16)
    kw.setdefault("rng_seed", 0)
    ours = traw.SonySIDRawDataset(tmp_path, raw_decoder=fake_decoder(), **kw)
    ref = jraw.SonySIDRawDataset(tmp_path, raw_decoder=fake_decoder(), **kw)
    return ours, ref


@pytest.mark.parametrize("kw", [
    {"patch_size": None}, {}, {"random_crop": False},
    {"samples_per_pair": 3}, {"cache_in_memory": True},
    {"return_metadata": True}, {"allowed_pair_ids": ["00002_00"]}],
    ids=["full", "random_crop", "center_crop", "samples_per_pair", "cache",
         "metadata", "allowed_ids"])
def test_sid_raw_items_match_jax(tmp_path, kw):
    ours, ref = _raw_both(tmp_path, **kw)
    assert len(ours) == len(ref)
    for i in list(range(len(ours))) + [0]:
        a, b = ours[i], ref[i]
        meta_a, meta_b = a.pop("metadata", None), b.pop("metadata", None)
        _same_items(a, b)
        assert meta_a == meta_b


def test_sid_raw_item_math(tmp_path):
    ours, _ = _raw_both(tmp_path, patch_size=None)
    item = ours[0]
    ratio = 10.0 / 0.1
    assert item["expo_ratio"] == np.float32(ratio)
    for k in ("lq", "gt", "short_raw", "long_raw", "short_obs"):
        assert item[k].shape == (32, 48, 3) and item[k].dtype == np.float32
    np.testing.assert_allclose(item["lq"],
                               np.clip(item["short_raw"] * ratio, 0, 1),
                               rtol=1e-6)
    np.testing.assert_array_equal(item["long_raw"], item["gt"])
    np.testing.assert_array_equal(item["short_obs"], item["short_raw"])
    assert traw.MAX_16BIT_VALUE == jraw.MAX_16BIT_VALUE


def test_sid_raw_cache_decodes_once(tmp_path):
    make_tree(tmp_path, ["00001_00_0.1s.ARW"], ["00001_00_10s.ARW"])
    dec = fake_decoder()
    ds = traw.SonySIDRawDataset(tmp_path, raw_decoder=dec, patch_size=16,
                                cache_in_memory=True)
    ds[0], ds[0], ds[0]
    assert len(dec.calls) == 2
    dec2 = fake_decoder()
    ds2 = traw.SonySIDRawDataset(tmp_path, raw_decoder=dec2, patch_size=16)
    ds2[0], ds2[0]
    assert len(dec2.calls) == 4


def test_sid_raw_errors_and_registry(tmp_path):
    ours, _ = _raw_both(tmp_path, patch_size=64)
    with pytest.raises(ValueError, match="exceeds image dimensions"):
        ours[0]
    with pytest.raises(ValueError, match="not found"):
        _raw_both(tmp_path, allowed_pair_ids=["99999_00"])
    ds = tdata.create_dataset({"type": "SonySIDRawDataset",
                               "root_dir": str(tmp_path), "patch_size": None,
                               "raw_decoder": fake_decoder()})
    assert len(ds) == 2
    # no rawpy here or on the card's machine: the default decoder says so
    make_tree(tmp_path / "r", ["00001_00_0.1s.ARW"], ["00001_00_10s.ARW"])
    bare = traw.SonySIDRawDataset(tmp_path / "r", patch_size=None)
    with pytest.raises(ImportError, match="rawpy is required"):
        bare[0]
    assert "SonySIDRawDataset" in dir(jdata)
