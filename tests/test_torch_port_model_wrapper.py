"""The port's reference-API model wrappers (``training/model_wrapper.py``)
held against the JAX package's.

Both wrappers start from the same weights (the JAX initial parameters
bridged into the port) and see the same NHWC numpy batches:

- ``LowlightModel`` on NAFSSR (width 8, 2 blocks, drop-path 0, so that the
  JAX wrapper can run it) over the stereo loader: every logged
  ``l_total`` of 5 ``optimize_parameters`` steps within rtol 1e-4, then
  ``test()`` within 1e-4 of max|ref|;
- ``ImageRestorationModel`` on the debug NewBP config: 3 steps (every
  logged term), ``test``, ``test_grids``, ``validation``, the learning
  rate and the visuals, within the same limits;
- the save / resume / load surface, the registry, the short/long keys.
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from lowlight_image_enhancement_tpu.data import (
    create_dataset as jax_create_dataset,
)
from lowlight_image_enhancement_tpu.data import (
    create_loader as jax_create_loader,
)
from lowlight_image_enhancement_tpu.training.model_wrapper import (
    create_model as jax_create_model,
)
from lowlight_image_enhancement_tpu_torch.training.model_wrapper import (
    ImageRestorationModel,
    LowlightModel,
    create_model,
)
from lowlight_image_enhancement_tpu_torch.utils import imgio
from lowlight_image_enhancement_tpu_torch.weights import (
    nafssr_params_from_jax,
    params_from_jax,
)

REPO = Path(__file__).resolve().parent.parent
RTOL = 1e-4


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _close(got, ref, what):
    ref = np.asarray(ref)
    scale = float(np.abs(ref).max())
    err = float(np.abs(np.asarray(got) - ref).max())
    assert err <= RTOL * max(scale, 1e-30), f"{what}: {err} > {RTOL} * {scale}"


def _logs_close(got, ref, what):
    assert set(got) == set(ref), what
    for k, v in ref.items():
        np.testing.assert_allclose(got[k], v, rtol=RTOL, atol=1e-7,
                                   err_msg=f"{what} {k}")


@pytest.fixture()
def stereo_root(tmp_path):
    rng = np.random.default_rng(1)
    gt_dir, lq_dir = tmp_path / "hr", tmp_path / "lr"
    for i in range(3):
        g, l = gt_dir / f"{i:04}", lq_dir / f"{i:04}"
        g.mkdir(parents=True), l.mkdir(parents=True)
        for k in (0, 1):
            imgio.imwrite(str(g / f"hr{k}.png"),
                          (rng.random((64, 96, 3)) * 255).astype(np.uint8))
            imgio.imwrite(str(l / f"lr{k}.png"),
                          (rng.random((32, 48, 3)) * 255).astype(np.uint8))
    return str(gt_dir), str(lq_dir)


def _ssr_opt():
    return {"name": "stereo_wrapper", "model_type": "LowlightModel",
            "scale": 2, "manual_seed": 3,
            "network_g": {"type": "NAFSSR", "up_scale": 2, "width": 8,
                          "num_blks": 2, "img_channel": 3},
            "train": {"pixel_opt": {"type": "MSELoss"},
                      "optim_g": {"type": "AdamW", "lr": 1e-3}}}


def test_lowlight_model_on_nafssr_matches_jax(stereo_root):
    gt_dir, lq_dir = stereo_root
    ds_opt = {"type": "PairedStereoImageDataset", "dataroot_gt": gt_dir,
              "dataroot_lq": lq_dir, "phase": "train", "gt_size_h": 16,
              "gt_size_w": 24, "scale": 2, "seed": 2, "flip_RGB": True,
              "batch_size_per_gpu": 2}
    loader = jax_create_loader(jax_create_dataset(dict(ds_opt)), ds_opt)
    ref = jax_create_model(_ssr_opt())
    model = create_model(_ssr_opt(), device="cpu")
    assert isinstance(model, LowlightModel)
    model.net_g.load_state_dict(nafssr_params_from_jax(
        _np_tree(ref.state.params), model=model.net_g), strict=True)

    def batches():
        while True:
            yield from loader

    it = batches()
    for step in range(5):
        batch = next(it)
        ref.feed_data(batch)
        ref.optimize_parameters(step)
        model.feed_data(batch)
        model.optimize_parameters(step)
        _logs_close(model.get_current_log(), ref.get_current_log(),
                    f"step {step}")
    assert model.state.step == 5
    ref.test()
    model.test()
    assert tuple(model.output.shape) == (2, 6, 16, 24)
    _close(model.get_current_visuals()["result"], np.asarray(ref.output),
           "test() output")
    # short / long keys
    model.feed_data({"short": batch["lq"], "long": batch["gt"]})
    assert torch.equal(model.batch["gt"],
                       torch.from_numpy(np.asarray(batch["gt"])).permute(
                           0, 3, 1, 2))


def _debug_opt(tmp_path):
    with open(REPO / "configs" / "debug" / "sid_newbp_mono_debug.yml") as f:
        opt = yaml.safe_load(f)
    opt = {k: opt[k] for k in ("name", "model_type", "manual_seed",
                               "network_g", "train", "val")}
    opt["is_train"] = True
    opt["path"] = {"models": str(tmp_path / "models"),
                   "training_states": str(tmp_path / "states"),
                   "visualization": str(tmp_path / "visualization")}
    return opt


def _make_data(rng, n=2, s=32):
    short = rng.uniform(0, 0.1, (n, s, s, 3)).astype(np.float32)
    ratio = np.full((n,), 10.0, np.float32)
    lq = np.clip(short * ratio[:, None, None, None], 0, 1)
    gt = np.clip(lq + 0.02, 0, 1).astype(np.float32)
    return {"lq": lq, "gt": gt, "short_raw": short, "long_raw": gt,
            "short_obs": short, "expo_ratio": ratio}


@pytest.fixture(scope="module")
def restoration_pair(tmp_path_factory):
    """The JAX and the port ImageRestorationModel after the same 3 steps."""
    tmp = tmp_path_factory.mktemp("wrapper")
    ref = jax_create_model(_debug_opt(tmp / "jax"))
    model = create_model(_debug_opt(tmp / "port"), device="cpu")
    assert isinstance(model, ImageRestorationModel)
    model.net_g.load_state_dict(params_from_jax(
        _np_tree(ref.state.params), model=model.net_g), strict=True)
    rng = np.random.default_rng(0)
    logs = []
    for step in range(3):
        data = _make_data(rng)
        ref.feed_data(data)
        ref.optimize_parameters(step)
        model.feed_data(data)
        model.optimize_parameters(step)
        logs.append((model.get_current_log(), ref.get_current_log()))
    return ref, model, logs, tmp


def test_restoration_model_steps_match_jax(restoration_pair):
    ref, model, logs, _ = restoration_pair
    for i, (got, want) in enumerate(logs):
        assert {"l_l1_raw", "l_phys", "l_total", "grad_norm"} <= set(want)
        _logs_close(got, want, f"step {i}")
    assert model.state.step == 3
    for it in (None, 7):
        assert model.get_current_learning_rate(it) == pytest.approx(
            ref.get_current_learning_rate(it), rel=1e-6)


@pytest.mark.parametrize("how", ["test", "minibatch", "grids", "grids_whole"])
def test_restoration_model_inference_matches_jax(restoration_pair, how):
    """``test``, ``test(max_minibatch)`` and ``test_grids`` (32^2 tiles of
    a 64^2 image at half overlap; a tile that covers the image is the
    plain ``test``)."""
    ref, model, _, _ = restoration_pair
    rng = np.random.default_rng(5)
    data = _make_data(rng, n=4 if how == "minibatch" else 1,
                      s=64 if how.startswith("grids") else 32)
    for m in (ref, model):
        m.feed_data(data)
        if how == "minibatch":
            m.test(max_minibatch=3)
        elif how.startswith("grids"):
            m.grids(crop_size=32 if how == "grids" else 64)
            m.test()                      # grids() then test() runs tiled
            m.grids_inverse()
        else:
            m.test()
    vis = model.get_current_visuals()
    assert vis["result"].shape == vis["gt"].shape == data["gt"].shape
    np.testing.assert_array_equal(vis["lq"], data["lq"])
    _close(vis["result"], np.asarray(ref.output), f"{how} output")
    if how == "grids_whole":
        model.test()
        _close(vis["result"], model.get_current_visuals()["result"],
               "grids over the whole image vs test")


def test_restoration_model_validation_matches_jax(restoration_pair):
    ref, model, _, tmp = restoration_pair
    rng = np.random.default_rng(6)
    loader = [_make_data(rng, n=1), _make_data(rng, n=1)]
    want = ref.validation(loader)
    got = model.validation(loader, current_iter=3, save_img=True)
    assert set(got) == set(want) == set(ref.opt["val"]["metrics"])
    for i in range(2):
        name = f"img_{i:05d}"
        assert (tmp / "port" / "visualization" / name
                / f"{name}_3.png").exists()
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=RTOL)
        assert model.get_current_log()[f"m_{k}"] == got[k]


def test_restoration_model_save_resume_and_load(restoration_pair, tmp_path):
    _, model, _, tmp = restoration_pair
    model.save()
    again = create_model(_debug_opt(tmp / "port"), device="cpu")
    assert again.resume_training() == 3
    for a, b in zip(model.state.optimizer.params, again.state.optimizer.params):
        assert torch.equal(a, b)
    assert again.state.optimizer.count == 3
    fresh = create_model(_debug_opt(tmp_path / "fresh"), device="cpu")
    assert fresh.resume_training() == 0
    fresh.load_network(str(tmp / "port" / "models" / "net_g_latest.pth"))
    for (k, a), b in zip(model.net_g.state_dict().items(),
                         fresh.net_g.state_dict().values()):
        assert torch.equal(a, b), k
    states = sorted((tmp / "port" / "states").iterdir())
    assert fresh.resume_training(str(states[-1])) == 3


def test_create_model_registry(tmp_path):
    with pytest.raises(KeyError):
        create_model({**_debug_opt(tmp_path), "model_type": "NoSuchModel"},
                     device="cpu")
    opt = {**_debug_opt(tmp_path), "model_type": "LowlightModel"}
    opt["train"] = {"optim_g": {"type": "AdamW", "lr": 1e-3}}
    m = create_model(opt, device="cpu")
    assert isinstance(m, LowlightModel)
    assert type(m.cri_pix).__name__ == "L1Loss"   # the fallback
    d = _make_data(np.random.default_rng(7))
    m.feed_data({"lq": d["lq"], "gt": d["gt"]})
    m.optimize_parameters()
    assert set(m.get_current_log()) == {"l_pix", "l_total"}
