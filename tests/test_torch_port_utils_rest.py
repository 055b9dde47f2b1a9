"""The port's own copies of the JAX package's host utilities, held
against it: ``utils/imgproc.py`` (warp_affine, resize_bilinear, erode,
gaussian_blur on their numpy branch) and ``utils/matlab_resize.py`` equal
to JAX's on seeded inputs; ``utils/face_util.py`` (Umeyama similarity and
the crop / paste round trip with an injected landmark function, the
composite equal to JAX's helper's); ``utils/download_util.py`` against an
in-process HTTP server on 127.0.0.1 (no other host); ``utils/profiling.py``
on ``torch.profiler``; the ``NewBPLayer`` guard of ``ops/psf.py``."""

import hashlib
import http.server
import os
import threading

import numpy as np
import pytest
import torch

from lowlight_image_enhancement_tpu.ops.psf import NewBPLayer as JaxNewBPLayer
from lowlight_image_enhancement_tpu.utils import face_util as jface
from lowlight_image_enhancement_tpu.utils import imgproc as jimgproc
from lowlight_image_enhancement_tpu.utils import matlab_resize as jmatlab
from lowlight_image_enhancement_tpu_torch.ops.psf import NewBPLayer
from lowlight_image_enhancement_tpu_torch.utils import face_util, imgproc
from lowlight_image_enhancement_tpu_torch.utils import matlab_resize
from lowlight_image_enhancement_tpu_torch.utils import profiling
from lowlight_image_enhancement_tpu_torch.utils.download_util import (
    download_file_from_url,
    load_file_from_url,
    sha256_of,
)


@pytest.fixture
def numpy_branch(monkeypatch):
    monkeypatch.setenv("LLIE_NO_CV2", "1")


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_imgproc_matches_jax(numpy_branch, dtype):
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (37, 45, 3)).astype(dtype)
    m = np.array([[0.9, -0.2, 4.5], [0.25, 1.1, -3.0]])
    for ours, ref in [
        (imgproc.warp_affine(img, m, (40, 30)),
         jimgproc.warp_affine(img, m, (40, 30))),
        (imgproc.resize_bilinear(img, (61, 23)),
         jimgproc.resize_bilinear(img, (61, 23))),
        (imgproc.erode(img, 4), jimgproc.erode(img, 4)),
        (imgproc.gaussian_blur(img, 5), jimgproc.gaussian_blur(img, 5)),
        (imgproc.gaussian_blur(img, 9), jimgproc.gaussian_blur(img, 9)),
    ]:
        assert ours.dtype == ref.dtype == dtype
        np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("kw", [{"scale": 0.5}, {"scale": 1.7},
                                {"out_shape": (20, 31)}])
def test_matlab_imresize_matches_jax(kw):
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 1, (33, 47, 3))
    np.testing.assert_array_equal(matlab_resize.imresize(img, **kw),
                                  jmatlab.imresize(img, **kw))
    np.testing.assert_array_equal(matlab_resize.imresize(img[..., 0], **kw),
                                  jmatlab.imresize(img[..., 0], **kw))
    with pytest.raises(ValueError):
        matlab_resize.imresize(img)


def _apply(affine, pts):
    return pts @ affine[:, :2].T + affine[:, 2]


def test_estimate_similarity_recovers_transform():
    rng = np.random.default_rng(0)
    src = rng.uniform(0, 100, (5, 2))
    theta, scale, t = 0.3, 1.7, np.array([12.0, -5.0])
    rot = np.array([[np.cos(theta), -np.sin(theta)],
                    [np.sin(theta), np.cos(theta)]])
    dst = scale * (src @ rot.T) + t
    est = face_util.estimate_similarity(src, dst)
    np.testing.assert_allclose(est[:, :2], scale * rot, atol=1e-9)
    np.testing.assert_allclose(est[:, 2], t, atol=1e-8)
    np.testing.assert_array_equal(est, jface.estimate_similarity(src, dst))
    with pytest.raises(ValueError):
        face_util.estimate_similarity(np.zeros((5, 2)), np.zeros((4, 2)))


@pytest.mark.parametrize("upscale", [1, 2])
def test_face_helper_round_trip_matches_jax(numpy_branch, upscale):
    face_size = 128
    template = face_util.FFHQ_TEMPLATE_1024 / (1024 // face_size)
    theta = 0.2
    rot = 0.8 * np.array([[np.cos(theta), -np.sin(theta)],
                          [np.sin(theta), np.cos(theta)]])
    affine = np.concatenate([rot, [[110.0], [120.0]]], axis=1)
    img = np.zeros((256, 256, 3), np.uint8)
    img[..., 0] = np.linspace(0, 200, 256, dtype=np.uint8)[None, :]
    center = _apply(affine, np.array([[64.0, 64.0]]))[0].astype(int)
    img[center[1] - 20:center[1] + 20,
        center[0] - 20:center[0] + 20] = (250, 180, 120)
    landmarks = _apply(affine, template)

    outs = []
    for mod in (face_util, jface):
        helper = mod.FaceRestorationHelper(
            upscale_factor=upscale, face_size=face_size,
            landmark_fn=lambda im: [landmarks])
        helper.set_input_image(img)
        assert helper.detect_faces() == 1
        helper.warp_crop_faces()
        crop = helper.cropped_faces[0]
        assert crop.shape == (face_size, face_size, 3)
        assert crop[64, 64, 0] > 200
        helper.add_restored_face(crop)
        outs.append(helper.paste_faces_to_input_image())
        helper.clean_all()
        assert helper.all_landmarks_5 == []
    assert outs[0].shape == (256 * upscale, 256 * upscale, 3)
    np.testing.assert_array_equal(outs[0], outs[1])
    if upscale == 1:
        region = (slice(center[1] - 10, center[1] + 10),
                  slice(center[0] - 10, center[0] + 10))
        diff = np.abs(outs[0][region].astype(int) - img[region].astype(int))
        assert diff.mean() < 8.0


def test_face_helper_without_detector_raises():
    helper = face_util.FaceRestorationHelper(1)
    helper.set_input_image(np.zeros((64, 64, 3), np.uint8))
    with pytest.raises(RuntimeError, match="landmark"):
        helper.detect_faces()


@pytest.fixture(scope="module")
def http_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("www")
    payload = os.urandom(70000)
    (root / "model.bin").write_bytes(payload)

    def handler(*a, **k):
        return http.server.SimpleHTTPRequestHandler(*a, directory=str(root),
                                                    **k)

    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{server.server_port}", payload
    server.shutdown()


def test_download_and_cache(http_root, tmp_path):
    base, payload = http_root
    sha = hashlib.sha256(payload).hexdigest()
    dest = str(tmp_path / "model.bin")
    assert download_file_from_url(f"{base}/model.bin", dest,
                                  expected_sha256=sha, progress=False) == dest
    assert open(dest, "rb").read() == payload
    with pytest.raises(ValueError, match="sha256 mismatch"):
        download_file_from_url(f"{base}/model.bin", str(tmp_path / "m2.bin"),
                               expected_sha256="0" * 64, progress=False)
    zoo = str(tmp_path / "zoo")
    p1 = load_file_from_url(f"{base}/model.bin", model_dir=zoo)
    assert sha256_of(p1) == sha
    # a cache hit does not fetch again (the server path is poisoned)
    assert load_file_from_url("http://127.0.0.1:1/model.bin",
                              model_dir=zoo) == p1


def test_chained_timeit_and_trace_summary(tmp_path):
    ms = profiling.chained_timeit(lambda x: x * 0.5 + 1.0, torch.ones(64, 64),
                                  runs=5, warmup=1)
    assert ms > 0
    a = torch.randn(128, 128)
    with profiling.trace(str(tmp_path)):
        with profiling.span("matmuls"):
            for _ in range(3):
                a = torch.tanh(a @ a)
    assert os.listdir(tmp_path) == ["trace_0000.json"]
    summary = profiling.summarize_trace(str(tmp_path), top=5)
    assert "aten::mm" in summary and summary["aten::mm"] > 0
    assert list(summary.values()) == sorted(summary.values(), reverse=True)
    with pytest.raises(FileNotFoundError):
        profiling.summarize_trace(str(tmp_path / "none"))


def test_newbp_layer_guard():
    for cls in (NewBPLayer, JaxNewBPLayer):
        layer = cls(3, deprecated=True)
        with pytest.raises(RuntimeError, match="CrosstalkPSF"):
            layer(None)
        with pytest.raises(NotImplementedError, match="Scenario B"):
            cls(deprecated=False)
