"""The port's serving export (``torch.export`` per bucket) against the JAX
package's (``tests/test_export.py``, its unsharded claims), on its tiny
NAFNet (width 8, (1,)/1/(1,)) at buckets (32, 32) and (64, 48).

The fused NAFBlock's K1/K2 and the LayerNorm's K5 are registered ops
(``llie_torch::nafblock_a``, ``nafblock_b``, ``ln_fwd``); here, on the
CPU, they run their plain versions, and the exported graphs are checked
for one node per kernel call. Tolerances: exported against live 1e-6
(the same ops in the same order), port export against JAX export 1e-5
(fp32, two frameworks).
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lowlight_image_enhancement_tpu.export import (
    ExportedModel as JaxExportedModel,
)
from lowlight_image_enhancement_tpu.export import export_model as jax_export
from lowlight_image_enhancement_tpu.export import (
    flatten_params as jax_flatten,
)
from lowlight_image_enhancement_tpu.models import (
    define_network as jax_define_network,
)
from lowlight_image_enhancement_tpu_torch import export as texport
from lowlight_image_enhancement_tpu_torch.export import (
    ClippedForward,
    ExportedModel,
    export_model,
    flatten_params,
    net_state,
    unflatten_params,
)
from lowlight_image_enhancement_tpu_torch.models import define_network
from lowlight_image_enhancement_tpu_torch.ops import layernorm, nafblock
from lowlight_image_enhancement_tpu_torch.weights import params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {"type": "NAFNet", "width": 8, "enc_blk_nums": (1,),
        "middle_blk_num": 1, "dec_blk_nums": (1,)}
BUCKETS = [(32, 32), (64, 48)]
K1, K2, K5 = ("llie_torch.nafblock_a.default", "llie_torch.nafblock_b.default",
              "llie_torch.ln_fwd.default")


@pytest.fixture(scope="module")
def jax_net_params():
    net = jax_define_network(dict(TINY))
    params = net.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                    params["params"])
    # nonzero residual scales, so every block moves the output
    params = {k: ({**v, "beta": rng.normal(0, 0.5, v["beta"].shape),
                   "gamma": rng.normal(0, 0.5, v["gamma"].shape)}
                  if "_blk" in k else v) for k, v in params.items()}
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params)
    return net, params


@pytest.fixture(scope="module")
def port_net(jax_net_params):
    _, params = jax_net_params
    net = define_network(dict(TINY), device="cpu").eval()
    net.load_state_dict(params_from_jax(params, model=net), strict=True)
    return net


@pytest.fixture(scope="module")
def export_dir(port_net, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("exported"))
    export_model(port_net, out, buckets=BUCKETS, batch=1, device="cpu",
                 network_opt=dict(TINY))
    return out


def _img(seed, shape):
    return np.random.default_rng(seed).uniform(0, 1, shape + (3,)).astype(
        np.float32)


def _live(net, x_nhwc):
    with torch.no_grad():
        return ClippedForward(net)(net_state(net),
                                   torch.from_numpy(x_nhwc)).numpy()


def _graph_counts(path):
    program = torch.export.load(path)
    nodes = [str(n.target) for n in program.graph.nodes
             if n.op == "call_function"]
    return program, {k: nodes.count(k) for k in (K1, K2, K5)}


def test_flatten_roundtrip_matches_jax(jax_net_params):
    _, params = jax_net_params
    flat = flatten_params(params)
    want = jax_flatten(params)
    assert list(flat) == list(want) and all("//" in k for k in flat)
    for k in flat:
        np.testing.assert_array_equal(flat[k], want[k])
    back = unflatten_params(flat)
    jax.tree_util.tree_map(np.testing.assert_array_equal, params, back)


def test_artifact_layout(export_dir, port_net):
    files = sorted(os.listdir(export_dir))
    assert files == ["bucket_1x32x32.pt2", "bucket_1x64x48.pt2",
                     "manifest.json", "params.npz"]
    with open(os.path.join(export_dir, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["buckets"] == [[32, 32], [64, 48]]
    assert manifest["kind"] == "lowlight_image_enhancement_tpu_torch.export"
    assert manifest["format_version"] == 1
    assert manifest["platforms"] == ["cpu"]
    assert manifest["torch_version"] == torch.__version__
    assert manifest["network_opt"]["type"] == "NAFNet"
    assert manifest["bucket_files"] == {"32x32": "bucket_1x32x32.pt2",
                                        "64x48": "bucket_1x64x48.pt2"}
    with np.load(os.path.join(export_dir, "params.npz")) as flat:
        assert sorted(flat.files) == sorted(net_state(port_net))


def test_programs_hold_no_weights(export_dir):
    """Every parameter is a user input of the program: none is embedded."""
    for name in ("bucket_1x32x32.pt2", "bucket_1x64x48.pt2"):
        program = torch.export.load(os.path.join(export_dir, name))
        assert not program.state_dict and not program.constants
        kinds = {s.kind.name for s in program.graph_signature.input_specs}
        assert kinds == {"USER_INPUT"}


def test_exported_matches_live_forward(export_dir, port_net):
    model = ExportedModel(export_dir)
    img = _img(1, (32, 32))
    got = model.predict(img)
    assert got.shape == img.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, _live(port_net, img[None])[0], atol=1e-6,
                               rtol=0)


def test_port_export_matches_jax_export(export_dir, jax_net_params,
                                        tmp_path_factory):
    net, params = jax_net_params
    jdir = str(tmp_path_factory.mktemp("jax_exported"))
    jax_export(net, params, jdir, buckets=BUCKETS, batch=1,
               platforms=("cpu",), network_opt=dict(TINY))
    ours, ref = ExportedModel(export_dir), JaxExportedModel(jdir)
    for img in (_img(2, (32, 32)), _img(3, (30, 40)), _img(4, (60, 44))):
        np.testing.assert_allclose(ours.predict(img), ref.predict(img),
                                   atol=1e-5, rtol=0)


def test_bucket_pick_pad_and_crop(export_dir, port_net):
    model = ExportedModel(export_dir)
    assert model.buckets == [(32, 32), (64, 48)]
    assert model._pick_bucket(30, 40) == (64, 48)
    assert model._pick_bucket(20, 20) == (32, 32)
    img = _img(5, (30, 40))
    out = model.predict(img)
    assert out.shape == (30, 40, 3)
    x = np.zeros((1, 64, 48, 3), np.float32)
    x[0, :30, :40] = img
    np.testing.assert_allclose(out, _live(port_net, x)[0, :30, :40],
                               atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="exceeds every exported bucket"):
        model.predict(np.zeros((128, 128, 3), np.float32))
    with pytest.raises(ValueError, match="expected HWC RGB"):
        model.predict(np.zeros((32, 32), np.float32))


def test_loader_needs_no_model_code(export_dir):
    """A fresh process serves from the artifact alone: no module of the
    port's ``models`` or ``training`` is imported, and it gives the bits
    this process gives."""
    img = _img(6, (32, 32))
    np.save(os.path.join(export_dir, "..", "img.npy"), img)
    code = (
        "import sys, numpy as np\n"
        "from lowlight_image_enhancement_tpu_torch.export import "
        "ExportedModel\n"
        f"m = ExportedModel({export_dir!r})\n"
        f"out = m.predict(np.load({os.path.join(export_dir, '..', 'img.npy')!r}))\n"
        "bad = [k for k in sys.modules if k.startswith(("
        "'lowlight_image_enhancement_tpu_torch.models', "
        "'lowlight_image_enhancement_tpu_torch.training', 'jax', "
        "'lowlight_image_enhancement_tpu.'))]\n"
        "assert not bad, bad\n"
        f"np.save({os.path.join(export_dir, '..', 'out.npy')!r}, out)\n")
    env = {**os.environ, "PYTHONPATH": REPO}
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=REPO, timeout=300)
    got = np.load(os.path.join(export_dir, "..", "out.npy"))
    np.testing.assert_array_equal(got, ExportedModel(export_dir).predict(img))


def test_format_version_and_device_guards(export_dir, tmp_path):
    bad = tmp_path / "bad"
    shutil.copytree(export_dir, bad)
    mpath = bad / "manifest.json"
    manifest = json.loads(mpath.read_text())
    manifest["format_version"] = 999
    mpath.write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match="unsupported export format"):
        ExportedModel(str(bad))
    manifest["format_version"] = 1
    manifest["platforms"] = ["cuda"]
    mpath.write_text(json.dumps(manifest))
    if not torch.cuda.is_available():
        # a program exported for the card never moves to the CPU
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ExportedModel(str(bad))
    with pytest.raises(ValueError, match="runs on cpu"):
        ExportedModel(export_dir, device="meta")


def test_predict_batch_mixed_sizes(export_dir):
    model = ExportedModel(export_dir)
    imgs = [_img(7, (32, 32)), _img(8, (30, 40)), _img(9, (60, 44))]
    outs = model.predict_batch(imgs)
    assert [o.shape for o in outs] == [im.shape for im in imgs]
    for o, im in zip(outs, imgs):
        np.testing.assert_allclose(o, model.predict(im), atol=1e-6, rtol=0)


def test_predict_batch_packs_batch_images(port_net, tmp_path):
    export_model(port_net, str(tmp_path), buckets=[(32, 32)], batch=2,
                 device="cpu")
    model = ExportedModel(str(tmp_path))
    imgs = [_img(10, (32, 32)), _img(11, (20, 30)), _img(12, (32, 16))]
    outs = model.predict_batch(imgs)
    x = np.zeros((2, 32, 32, 3), np.float32)
    x[0], x[1, :20, :30] = imgs[0], imgs[1]
    want = _live(port_net, x)
    np.testing.assert_allclose(outs[0], want[0], atol=1e-6, rtol=0)
    np.testing.assert_allclose(outs[1], want[1, :20, :30], atol=1e-6, rtol=0)
    assert outs[2].shape == (32, 16, 3)


def test_graph_holds_one_k1_k2_node_per_fused_block(export_dir, port_net):
    blocks = len(port_net.blocks())
    assert blocks == 3
    for name in ("bucket_1x32x32.pt2", "bucket_1x64x48.pt2"):
        _, counts = _graph_counts(os.path.join(export_dir, name))
        assert counts == {K1: blocks, K2: blocks, K5: 0}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_baseline_graph_holds_two_k5_nodes_per_block(tmp_path, dtype):
    torch.manual_seed(0)
    net = define_network({**TINY, "type": "Baseline", "dtype": dtype},
                         device="cpu").eval()
    export_model(net, str(tmp_path), buckets=[(32, 32)], device="cpu")
    blocks = len(net.encoders[0]) + len(net.middle_blks) + len(net.decoders[0])
    _, counts = _graph_counts(str(tmp_path / "bucket_1x32x32.pt2"))
    assert counts == {K1: 0, K2: 0, K5: 2 * blocks}
    img = _img(13, (32, 32))
    np.testing.assert_array_equal(ExportedModel(str(tmp_path)).predict(img),
                                  _live(net, img[None])[0])


def test_bf16_nafnet_export_matches_live(tmp_path):
    torch.manual_seed(1)
    net = define_network({**TINY, "dtype": "bfloat16"}, device="cpu").eval()
    export_model(net, str(tmp_path), buckets=[(32, 32)], device="cpu")
    _, counts = _graph_counts(str(tmp_path / "bucket_1x32x32.pt2"))
    assert counts[K1] == counts[K2] == 3
    img = _img(14, (32, 32))
    np.testing.assert_array_equal(ExportedModel(str(tmp_path)).predict(img),
                                  _live(net, img[None])[0])


def test_swapping_params_moves_the_output(export_dir, port_net, tmp_path):
    swapped = tmp_path / "swapped"
    shutil.copytree(export_dir, swapped)
    torch.manual_seed(5)
    other = define_network(dict(TINY), device="cpu").eval()
    with torch.no_grad():
        for p in other.parameters():
            p.add_(0.1 * torch.randn_like(p))
    np.savez(swapped / "params.npz", **flatten_params(
        {k: v.numpy() for k, v in net_state(other).items()}))
    img = _img(15, (32, 32))
    before = ExportedModel(export_dir).predict(img)
    after = ExportedModel(str(swapped)).predict(img)
    assert np.abs(after - before).max() > 1e-3
    np.testing.assert_allclose(after, _live(other, img[None])[0], atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("op,args", [
    ("nafblock_a", "a"), ("nafblock_b", "b"), ("ln_fwd", "ln")])
def test_registered_ops_pass_opcheck(op, args):
    """Schema, fake (shape-only) kernel and dispatch of each registered op
    (``torch.library.opcheck``), fp32 and bf16."""
    rng = np.random.default_rng(16)
    for dt in (torch.float32, torch.bfloat16):
        n, c, h, w = 2, 8, 4, 6
        x = torch.from_numpy(rng.standard_normal((n, c, h * w))).to(dt)
        block = define_network(dict(TINY), device="cpu").blocks()[0]
        p = nafblock.pack_params(*[t.detach() for t in (
            block.norm1.weight, block.norm1.bias, block.conv1.weight,
            block.conv1.bias, block.conv2.weight, block.conv2.bias,
            block.sca[1].weight, block.sca[1].bias, block.conv3.weight,
            block.conv3.bias, block.norm2.weight, block.norm2.bias,
            block.conv4.weight, block.conv4.bias, block.conv5.weight,
            block.conv5.bias, block.beta, block.gamma)])
        if args == "a":
            call = (torch.ops.llie_torch.nafblock_a.default,
                    (x, [p[k] for k in nafblock._A_PARAMS], h, w, 1e-6))
        elif args == "b":
            g = torch.from_numpy(rng.standard_normal((n, c, h * w))).to(dt)
            att = torch.from_numpy(rng.standard_normal((n, c))).float()
            call = (torch.ops.llie_torch.nafblock_b.default,
                    (x, g, att, [p[k] for k in nafblock._B_PARAMS], 1e-6))
        else:
            call = (torch.ops.llie_torch.ln_fwd.default,
                    (x, torch.randn(c), torch.randn(c), 1e-6))
        torch.library.opcheck(*call)
        outs = call[0](*call[1])
        outs = outs if isinstance(outs, tuple) else (outs,)
        assert outs[0].shape == x.shape and outs[0].dtype == dt
        for t in outs[1:]:
            assert t.dtype == torch.float32


def test_cli_exports_and_smoke_checks(tmp_path, capsys):
    cfg = tmp_path / "tiny.yml"
    cfg.write_text(
        "name: tiny_export\nmodel_type: ImageRestorationModel\n"
        "network_g:\n  type: NewBPNAFNet\n  width: 8\n"
        "  enc_blk_nums: [1]\n  middle_blk_num: 1\n  dec_blk_nums: [1]\n"
        "path: {}\n")
    out = str(tmp_path / "art")
    texport.main(["-opt", str(cfg), "--out", out, "--buckets", "32,48x64",
                  "--device", "cpu", "--smoke"])
    printed = capsys.readouterr().out
    assert "exported 2 bucket(s)" in printed and "smoke: max|" in printed
    assert sorted(os.listdir(out)) == ["bucket_1x32x32.pt2",
                                       "bucket_1x48x64.pt2", "manifest.json",
                                       "params.npz"]
    assert texport.parse_buckets("256, 512x768,") == [(256, 256), (512, 768)]
    with pytest.raises(ValueError, match="no buckets"):
        texport.parse_buckets(" , ")


@pytest.mark.parametrize("kind", ["NAFNet", "Baseline"])
def test_training_through_the_ops_keeps_its_gradients(kind):
    """NAFBlockFunction's and LayerNorm2dFunction's forwards now call the
    registered ops; under autograd every parameter still gets the
    gradient of the module graph (fp32, 1e-4 of max|g|)."""
    torch.manual_seed(2)
    net = define_network({**TINY, "type": kind}, device="cpu")
    x = torch.rand(1, 3, 16, 16)
    net(x).square().mean().backward()
    fused = {k: p.grad.clone() for k, p in net.named_parameters()}
    net.zero_grad()
    for m in net.modules():
        if isinstance(m, layernorm.LayerNorm2d):
            m.forward = (lambda mod: lambda t: layernorm.layer_norm_2d(
                t, mod.weight, mod.bias, mod.eps))(m)
        if hasattr(m, "forward_eager"):
            m.forward = m.forward_eager
    net(x).square().mean().backward()
    for k, p in net.named_parameters():
        scale = float(fused[k].abs().max()) + 1e-12
        torch.testing.assert_close(fused[k], p.grad, atol=1e-4 * scale,
                                   rtol=0, msg=k)
