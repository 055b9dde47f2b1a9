"""Port's RestorationServer, tiled inference, demo CLI and image I/O held
against the JAX package on CPU (fp32, atol 1e-4 / rtol 1e-4)."""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from lowlight_image_enhancement_tpu.models.nafnet import NAFNet as JaxNAFNet
from lowlight_image_enhancement_tpu.serving import (
    RestorationServer as JaxRestorationServer,
)
from lowlight_image_enhancement_tpu.utils import imgio as jax_imgio
from lowlight_image_enhancement_tpu_torch import demo
from lowlight_image_enhancement_tpu_torch.models import (
    create_newbp_net,
    define_network,
)
from lowlight_image_enhancement_tpu_torch.models.nafnet import NAFNet
from lowlight_image_enhancement_tpu_torch.serving import RestorationServer
from lowlight_image_enhancement_tpu_torch.utils import imgio
from lowlight_image_enhancement_tpu_torch.weights import params_from_jax

KW = dict(img_channel=3, width=8, enc_blk_nums=(1,), middle_blk_num=1,
          dec_blk_nums=(1,))
SERVE = dict(bucket_step=16, min_bucket=16, max_bucket=32, max_batch=2,
             tile_overlap=0.5)


@pytest.fixture(scope="module")
def nets():
    jnet = JaxNAFNet(**KW)   # "auto": the unfused graph on CPU
    params = jax.jit(jnet.init)(jax.random.PRNGKey(0),
                                jnp.zeros((1, 16, 16, 3)))["params"]
    rng = np.random.default_rng(1)
    params = {k: ({**v, "beta": rng.normal(0, 0.5, v["beta"].shape),
                   "gamma": rng.normal(0, 0.5, v["gamma"].shape)}
                  if "_blk" in k else v) for k, v in params.items()}
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params)
    model = NAFNet(**KW)
    model.load_state_dict(params_from_jax(params, model=model), strict=True)
    return jnet, params, model


def _images():
    rng = np.random.default_rng(2)
    shapes = [(20, 24), (16, 16), (40, 28), (30, 18), (17, 23)]
    return [rng.uniform(0, 1, s + (3,)).astype(np.float32) for s in shapes]


def test_server_matches_jax_server(nets):
    """Mixed sizes: three share the 32x32 bucket (split by max_batch=2),
    one is alone in 16x16, and 40x28 exceeds max_bucket (tiled path)."""
    jnet, params, model = nets
    imgs = _images()
    ref = JaxRestorationServer(jnet, params, **SERVE).predict(imgs)
    server = RestorationServer(model, device="cpu", **SERVE)
    got = server.predict(imgs)
    assert server.forward_batches == 4   # (32x32: 2 + 1), 16x16, tiles
    assert len(got) == len(imgs)
    for g, r, im in zip(got, ref, imgs):
        assert g.shape == r.shape == im.shape
        np.testing.assert_allclose(g, np.asarray(r), atol=1e-4, rtol=1e-4)


def test_bucket_padding_changes_the_result(nets):
    """The SCA mean runs over the padded bucket, as in the JAX server, so
    the server's answer differs from an unpadded forward."""
    _, _, model = nets
    im = _images()[0]                          # 20x24 -> bucket 32x32
    served = RestorationServer(model, device="cpu", **SERVE).predict([im])[0]
    with torch.no_grad():
        direct = model(torch.from_numpy(im).permute(2, 0, 1)[None])[0]
    direct = direct.permute(1, 2, 0).numpy()
    assert served.shape == direct.shape
    assert np.max(np.abs(served - direct)) > 1e-4


def test_server_rejects_non_rgb(nets):
    server = RestorationServer(nets[2], device="cpu", **SERVE)
    with pytest.raises(ValueError):
        server.predict([np.zeros((16, 16), np.float32)])


def test_cuda_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the no-CUDA error path is not reachable")
    with pytest.raises(RuntimeError, match="CUDA"):
        define_network({"type": "NewBPNAFNet", **KW})
    with pytest.raises(RuntimeError, match="CUDA"):
        create_newbp_net(nafnet_params=KW)
    with pytest.raises(RuntimeError, match="CUDA"):
        RestorationServer(NAFNet(**KW))


def test_demo_cli_runs_npz_and_pth_weights(nets, tmp_path):
    _, params, model = nets
    rng = np.random.default_rng(3)
    img = (rng.uniform(0, 1, (20, 28, 3)) * 255).astype(np.uint8)
    imgio.imwrite(str(tmp_path / "in.png"), img)
    opt = {"name": "demo", "network_g": {"type": "NewBPNAFNet",
                                         "nafnet_params": KW}}
    (tmp_path / "opt.yml").write_text(yaml.safe_dump(opt))
    flat = {"/".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(params)}
    np.savez(tmp_path / "w.npz", **flat)
    torch.save(model.state_dict(), tmp_path / "w.pth")
    outs = []
    for w in ("w.npz", "w.pth"):
        out = tmp_path / f"out_{w}.png"
        demo.main(["-opt", str(tmp_path / "opt.yml"), "--input_path",
                   str(tmp_path / "in.png"), "--output_path", str(out),
                   "--weights", str(tmp_path / w), "--device", "cpu"])
        outs.append(imgio.imread(str(out)))
    with torch.no_grad():
        x = torch.from_numpy(img.astype(np.float32) / 255.0).permute(2, 0, 1)
        want = imgio.to_uint8(model(x[None])[0].permute(1, 2, 0).numpy())
    np.testing.assert_array_equal(outs[0], want)
    np.testing.assert_array_equal(outs[1], want)


@pytest.mark.parametrize("mode,dtype", [("RGB", np.uint8), ("L", np.uint8),
                                        ("RGBA", np.uint8), ("16", np.uint16)])
def test_png_codec_matches_jax_imgio(mode, dtype, tmp_path):
    """Port's PNG decoder vs the JAX package's on PNGs written with
    adaptive scanline filters (PIL) and by the JAX encoder."""
    from PIL import Image

    rng = np.random.default_rng(4)
    ramp = np.add.outer(np.arange(24), np.arange(32)).astype(np.int64)
    if mode == "16":
        arr = (ramp * 997 + rng.integers(0, 50, ramp.shape)).astype(np.uint16)
        data = jax_imgio.encode_png(np.stack([arr] * 3, -1))
    else:
        ch = {"RGB": 3, "L": 1, "RGBA": 4}[mode]
        arr = ((ramp[..., None] * 5 + rng.integers(0, 20, (24, 32, ch)))
               % 256).astype(dtype)
        arr = arr[..., 0] if ch == 1 else arr
        bio = io.BytesIO()
        Image.fromarray(arr, mode).save(bio, format="PNG", optimize=True)
        data = bio.getvalue()
    path = tmp_path / "x.png"
    path.write_bytes(data)
    got = imgio.imread(str(path))
    np.testing.assert_array_equal(got, jax_imgio.imread(str(path)))
    assert got.dtype == dtype
    imgio.imwrite(str(tmp_path / "y.png"), got)
    np.testing.assert_array_equal(jax_imgio.imread(str(tmp_path / "y.png")), got)
