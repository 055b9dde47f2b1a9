"""The four shipped SID configurations that only the port's tier-1
network builds touched before, trained through the port's ``Trainer``
against the JAX ``Trainer`` on the CPU:

- ``sid_newbp_mono.yml`` (``pretrained: true``: the perceptual trunk is
  the seeded VGG19 ``.npz`` named by ``$LLIE_VGG19_NPZ``, read by both
  packages),
- ``sid_newbp_rgb.yml`` (``kernel_type: rgb``, the loss's ``B2``
  ``CrosstalkPSF`` in ``mode: rgb``),
- ``sid_nafnet_w64.yml`` (``NewBPNAFNet`` width 64, here at debug width),
- ``sid_nafnet_baseline.yml`` (``NAFNet``, ``pixel_opt: L1Loss``,
  ``hybrid_opt: ~``).

Each config is parsed by each package over one ``${SID_ROOT}`` tree that
the port's ``make_synthetic_sid_tree`` writes (the JAX package has no
such writer; both Trainers read the same files), its network cut to the
debug widths of ``test_torch_port_archs_more.py`` and its crops to 32^2,
and trained 3 iterations; the port starts from the JAX Trainer's initial
params (bridged). Both train in fp32 (``enable_amp: false``), as
``tests/test_torch_port_trainer.py`` does: the configs' bf16 runs on the
card in ``chip_smoke.py``'s path A. ``l_total`` agrees at every iteration
within rtol 1e-4, and ``validate`` of the port on the JAX Trainer's final
params (bridged) agrees with the JAX ``validate`` within 1e-4.
"""

import copy
import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from lowlight_image_enhancement_tpu.models.vgg import (
    _npz_to_params as jax_vgg_npz_to_params,
)
from lowlight_image_enhancement_tpu.training.config import parse as jax_parse
from lowlight_image_enhancement_tpu.training.trainer import Trainer as JaxTrainer
from lowlight_image_enhancement_tpu_torch.data import make_synthetic_sid_tree
from lowlight_image_enhancement_tpu_torch.models import define_network
from lowlight_image_enhancement_tpu_torch.models.vgg import (
    VGG19Features,
    _random_init_,
)
from lowlight_image_enhancement_tpu_torch.ops.psf import (
    CrosstalkPSF,
    build_psf_kernels,
    normalize_psf_energy,
)
from lowlight_image_enhancement_tpu_torch.training.config import parse
from lowlight_image_enhancement_tpu_torch.training.train_step import (
    make_eval_step,
)
from lowlight_image_enhancement_tpu_torch.training.trainer import Trainer
from lowlight_image_enhancement_tpu_torch.training.validation import validate
from lowlight_image_enhancement_tpu_torch.weights import bridge_for

REPO = Path(__file__).resolve().parent.parent
CONFIGS = ("sid_newbp_mono", "sid_newbp_rgb", "sid_nafnet_w64",
           "sid_nafnet_baseline")
ITERS = 3
CROP = 32
RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small networks: one intra-op thread, so that a run beside other
    test workers does not wait on idle threads' barriers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def sid_root(tmp_path_factory):
    """``${SID_ROOT}`` (2 train, 1 val pair of 64^2) and one seeded VGG19
    trunk in ``$LLIE_VGG19_NPZ``, for this module."""
    root = tmp_path_factory.mktemp("sid")
    make_synthetic_sid_tree(str(root / "tree"), n_train=2, n_val=1,
                            size=64, seed=0)
    vgg = VGG19Features()
    _random_init_(vgg, torch.Generator().manual_seed(3))
    npz = root / "vgg19.npz"
    np.savez(npz, **{k: v.numpy() for k, v in vgg.state_dict().items()})
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SID_ROOT", str(root / "tree"))
        mp.setenv("LLIE_VGG19_NPZ", str(npz))
        yield root


def _debug_width(net_opt):
    """``network_g`` at debug widths and depths (same type and options)."""
    opt = copy.deepcopy(dict(net_opt))
    if opt["type"] == "NewBPNAFNet":
        opt["nafnet_params"] = {**(opt.get("nafnet_params") or {}),
                                "width": 8, "enc_blk_nums": [1, 1],
                                "middle_blk_num": 1, "dec_blk_nums": [1, 1]}
    else:
        opt.update(width=8, enc_blk_nums=[1, 1], middle_blk_num=1,
                   dec_blk_nums=[1, 1])
    return opt


def _cut(opt):
    """The config cut for the CPU, the same way for both packages."""
    opt["network_g"] = _debug_width(opt["network_g"])
    opt["datasets"]["train"]["patch_size"] = CROP
    opt["train"].update(total_iter=ITERS, enable_amp=False)
    opt["logger"].update(print_freq=1, save_checkpoint_freq=ITERS,
                         use_tb_logger=False)
    opt["val"]["val_freq"] = 0
    return opt


def _jax_tree(params):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(params))


def _bridged(net, tree):
    return bridge_for(net)(tree, model=net)


@pytest.fixture(scope="module", params=CONFIGS)
def runs(request, sid_root, tmp_path_factory):
    """Both Trainers over ``ITERS`` iterations of one config, the port
    from the JAX initial params."""
    cfg = str(REPO / "configs" / f"{request.param}.yml")
    jopt = _cut(jax_parse(cfg, is_train=True, root_dir=str(
        tmp_path_factory.mktemp("jax_exp"))))
    jtrainer = JaxTrainer(jopt)
    init = _jax_tree(jtrainer.state.params)
    jlosses = []
    step = jtrainer.step_fn

    def recording(state, batch):
        state, logs = step(state, batch)
        jlosses.append(float(logs["l_total"]))
        return state, logs

    jtrainer.step_fn = recording
    jtrainer.train()

    opt = _cut(parse(cfg, is_train=True, root_dir=str(
        tmp_path_factory.mktemp("port_exp"))))
    trainer = Trainer(opt, device="cpu")
    trainer.net.load_state_dict(_bridged(trainer.net, init))
    trainer.train()
    return dict(name=request.param, jtrainer=jtrainer, jlosses=jlosses,
                opt=opt, trainer=trainer)


def test_trainer_logs_match_jax(runs):
    hist = runs["trainer"].history
    assert [h["iter"] for h in hist] == list(range(1, ITERS + 1))
    assert len(runs["jlosses"]) == ITERS
    np.testing.assert_allclose([h["l_total"] for h in hist], runs["jlosses"],
                               rtol=RTOL)
    assert runs["trainer"].net.dtype == torch.float32


def test_validate_matches_jax_on_bridged_weights(runs):
    opt = runs["opt"]
    net = define_network(dict(opt["network_g"]), device="cpu")
    net.load_state_dict(_bridged(net, _jax_tree(
        runs["jtrainer"].state.params)))
    metrics_opt = opt["val"]["metrics"]
    got = validate(make_eval_step(net), runs["trainer"].val_loader,
                   metrics_opt, device="cpu")
    want = runs["jtrainer"].validate()
    assert set(got) == set(want) == set(metrics_opt)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, err_msg=k)


def test_config_specific_losses(runs):
    """What sets each config apart reaches the port's loss: the VGG19
    trunk loaded from ``$LLIE_VGG19_NPZ``, the rgb ``B2`` PSF, the
    pixel-only objective."""
    loss, pixel = runs["trainer"].loss, runs["trainer"].pixel_loss
    name = runs["name"]
    if name == "sid_nafnet_baseline":
        assert sorted(runs["opt"]["val"]["metrics"]) == ["psnr_linear",
                                                         "ssim_linear"]
        assert pixel is not None and loss.w["l1_raw"] == 0.0
        assert not any(loss.use.values())
        return
    assert pixel is None and loss.use["perc"] and loss.use["phys"]
    assert loss.perceptual.pretrained
    npz = np.load(os.environ["LLIE_VGG19_NPZ"])
    for k, v in loss.perceptual.vgg.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), npz[k], err_msg=k)
    mode, spec = (("rgb", "B2") if name == "sid_newbp_rgb" else
                  ("mono", "P2"))
    assert isinstance(loss.psf, CrosstalkPSF) and loss.psf.mode == mode
    np.testing.assert_allclose(
        loss.psf.kernel.numpy(),
        normalize_psf_energy(build_psf_kernels(mode, spec)).numpy(),
        rtol=1e-6)
    assert loss.psf.kernel.shape[0] == (3 if mode == "rgb" else 1)


def test_jax_vgg_loader_reads_the_port_npz_keys(sid_root):
    """JAX's ``models/vgg.py:_npz_to_params`` takes every conv of the
    ``.npz`` written from the port's ``VGG19Features`` (OIHW -> HWIO)."""
    npz = dict(np.load(sid_root / "vgg19.npz"))
    params = jax_vgg_npz_to_params(npz)
    convs = sorted(k[:-len(".weight")] for k in npz if k.endswith(".weight"))
    assert sorted(params) == convs and len(convs) == 16
    for name in convs:
        np.testing.assert_array_equal(
            params[name]["kernel"],
            np.transpose(npz[f"{name}.weight"], (2, 3, 1, 0)))
        np.testing.assert_array_equal(params[name]["bias"],
                                      npz[f"{name}.bias"])


@pytest.mark.parametrize("name", ["sid_newbp_mono", "sid_nafnet_w64"])
def test_pretrained_trunk_without_weights_raises(name, sid_root, tmp_path,
                                                 monkeypatch):
    """The configs that ask for the ImageNet VGG19 (``pretrained: true``,
    or no ``pretrained`` key) never fall back to a random trunk: without
    ``$LLIE_VGG19_NPZ`` the port's Trainer refuses to start."""
    monkeypatch.delenv("LLIE_VGG19_NPZ")
    opt = _cut(parse(str(REPO / "configs" / f"{name}.yml"), is_train=True,
                     root_dir=str(tmp_path)))
    with pytest.raises(RuntimeError, match="pretrained VGG19"):
        Trainer(opt, device="cpu")
