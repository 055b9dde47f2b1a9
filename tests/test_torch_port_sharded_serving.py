"""Serving over an in-process mesh of local devices: the sharded export
(``export_model(..., mesh=)``, ``ExportedModel`` of its artifact, the
``--mesh`` CLI) and ``RestorationServer(mesh=)``, as
``tests/test_export.py::TestShardedExport`` and
``tests/test_serving_and_profiling.py`` hold the JAX package's; the mesh
is two CPU devices here (``create_mesh(devices=["cpu", "cpu"])``).

- the manifest records ``{"axis": "data", "size": 2}`` and the global
  batch; the programs take the per-device batch;
- ``predict_batch`` of the artifact equals the live clipped forward
  (atol 1e-5) and the requests keep their order;
- a batch that the mesh does not divide is refused;
- the manifest names the device of the export, and a program loaded on
  another device (the meta device) is moved there and runs;
- the server's mesh-split forward batches and tiled path equal one
  device's (atol 1e-6; the tiled path's ``batch_tiles`` rounded up to a
  multiple of the mesh size)."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from lowlight_image_enhancement_tpu_torch import export as port_export
from lowlight_image_enhancement_tpu_torch.export import (
    ExportedModel,
    export_model,
)
from lowlight_image_enhancement_tpu_torch.models import define_network
from lowlight_image_enhancement_tpu_torch.parallel import create_mesh
from lowlight_image_enhancement_tpu_torch.serving import RestorationServer

NET = {"type": "NAFNet", "img_channel": 3, "width": 8,
       "middle_blk_num": 1, "enc_blk_nums": [1], "dec_blk_nums": [1]}
CONFIG = os.path.join(os.path.dirname(__file__), "..", "configs", "debug",
                      "sid_newbp_mono_debug.yml")


@pytest.fixture(scope="module")
def net():
    torch.manual_seed(0)
    net = define_network(dict(NET), device="cpu").eval()
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in net.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=gen))
    return net


@pytest.fixture(scope="module")
def sharded_dir(net, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("exported_sharded"))
    export_model(net, out, buckets=[(32, 32)], batch=4, device="cpu",
                 network_opt=NET, mesh=create_mesh(devices=["cpu", "cpu"]))
    return out


class TestShardedExport:
    def test_manifest_records_mesh(self, sharded_dir):
        with open(os.path.join(sharded_dir, "manifest.json")) as f:
            manifest = json.load(f)
        assert manifest["mesh"] == {"axis": "data", "size": 2}
        assert manifest["batch"] == 4
        assert manifest["bucket_files"] == {"32x32": "bucket_2x32x32.pt2"}

    def test_sharded_predict_batch_matches_live(self, sharded_dir, net):
        model = ExportedModel(sharded_dir)
        assert model.mesh is not None and model.mesh.size == 2
        rng = np.random.default_rng(7)
        imgs = [rng.uniform(0, 1, (32, 32, 3)).astype(np.float32)
                for _ in range(4)] + [
            rng.uniform(0, 1, (30, 20, 3)).astype(np.float32)]
        got = model.predict_batch(imgs)
        with torch.no_grad():
            want = [net(torch.from_numpy(np.pad(
                im, ((0, 32 - im.shape[0]), (0, 32 - im.shape[1]),
                     (0, 0))))[None].permute(0, 3, 1, 2)).clamp(0, 1)[
                0].permute(1, 2, 0).numpy()[:im.shape[0], :im.shape[1]]
                for im in imgs]
        assert [g.shape for g in got] == [im.shape for im in imgs]
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, atol=1e-5)

    def test_batch_not_divisible_by_mesh_rejected(self, net, tmp_path):
        with pytest.raises(ValueError, match="not divisible by mesh"):
            export_model(net, str(tmp_path), buckets=[(32, 32)], batch=3,
                         device="cpu",
                         mesh=create_mesh(devices=["cpu", "cpu"]))

    def test_programs_move_to_the_device_they_load_on(self, sharded_dir):
        """The manifest names the device the programs were exported on; a
        program loaded there stays as it is, one loaded elsewhere (the
        meta device here) has every device its graph names moved and runs
        there."""
        with open(os.path.join(sharded_dir, "manifest.json")) as f:
            assert json.load(f)["device"] == "cpu"
        path = os.path.join(sharded_dir, "bucket_2x32x32.pt2")
        program = torch.export.load(path)
        assert port_export._on_device(program, torch.device("cpu"),
                                      "cpu") is program

        def named(p):
            return {str(n.kwargs["device"]) for n in p.graph.nodes
                    if "device" in n.kwargs}

        assert named(program) == {"cpu"}
        moved = port_export._on_device(torch.export.load(path),
                                       torch.device("meta"), "cpu")
        assert named(moved) == {"meta"}
        with np.load(os.path.join(sharded_dir, "params.npz")) as flat:
            params = {k: torch.from_numpy(flat[k]).to("meta")
                      for k in flat.files}
        y = moved.module()(params, torch.zeros((2, 32, 32, 3),
                                               device="meta"))
        assert y.device.type == "meta" and tuple(y.shape) == (2, 32, 32, 3)

    def test_sharded_export_wants_its_devices(self, sharded_dir):
        with pytest.raises(ValueError, match="2 devices, only 1 available"):
            ExportedModel(sharded_dir, devices=["cpu"])


def test_export_cli_mesh(tmp_path, capsys):
    out = str(tmp_path / "cli")
    port_export.main(["-opt", CONFIG, "--out", out, "--buckets", "32",
                      "--batch", "2", "--mesh", "2", "--device", "cpu",
                      "--smoke"])
    with open(os.path.join(out, "manifest.json")) as f:
        assert json.load(f)["mesh"] == {"axis": "data", "size": 2}
    assert "smoke: max|exported - live|" in capsys.readouterr().out


def test_mesh_sharded_serving_matches_single_device(net):
    rng = np.random.default_rng(3)
    imgs = [rng.uniform(0, 1, (100, 140, 3)).astype(np.float32)] + [
        rng.uniform(0, 1, (40, 50, 3)).astype(np.float32) for _ in range(3)]
    one = RestorationServer(net, max_bucket=64, device="cpu")
    mesh = create_mesh(devices=["cpu"] * 3)
    split = RestorationServer(net, max_bucket=64, mesh=mesh)
    assert len(split.replicas) == 3
    for a, b in zip(one.predict(imgs), split.predict(imgs)):
        np.testing.assert_allclose(b, a, atol=1e-6)
    # a process-group mesh (here a stand-in) is refused
    with pytest.raises(ValueError, match="in-process mesh"):
        RestorationServer(net, mesh=dataclasses.replace(mesh, group=object()))
