"""The port's height-sharded NAFNet forward (``parallel/spatial.py``) over
real ranks (gloo on the CPU), as ``tests/test_spatial_parallel.py`` holds
the JAX package's:

- ``halo_exchange_rows`` against zero padding at 2 and 4 ranks, and one
  shard being a pad (``TestHaloExchange``);
- the 2-rank forward of a width-8 NAFNet (aligned height) and the 4-rank
  forward of a batch of 2 at a width the model must pad, against the JAX
  single-device ``NAFNet.apply`` on the same weights, fp32, 1e-5 (JAX's
  own spatial test holds its forward to that same single-device forward;
  this skips its ``shard_map`` compile);
- the TLC, dropout and non-NAFNet rejections;
- the parameter gradients of a loss through the 2-rank forward against
  the single-device gradients, 3e-5 (``TestSpatialGradients``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lowlight_image_enhancement_tpu.models.nafnet import NAFNet as JaxNAFNet
from lowlight_image_enhancement_tpu_torch.models import define_network
from lowlight_image_enhancement_tpu_torch.parallel.launch import (
    halo_rows,
    sequence,
    spatial_run,
    spawn,
)
from lowlight_image_enhancement_tpu_torch.parallel.spatial import (
    halo_exchange_rows,
    nafnet_apply_spatial,
    spatial_pad_multiple,
)
from lowlight_image_enhancement_tpu_torch.weights import params_from_jax

GEOMETRY = dict(img_channel=3, width=8, middle_blk_num=1,
                enc_blk_nums=(1, 1), dec_blk_nums=(1, 1))
NET = {"type": "NAFNet", **{k: list(v) if isinstance(v, tuple) else v
                            for k, v in GEOMETRY.items()}}


def _weights():
    """JAX init with beta/gamma off zero (every block contributes)."""
    jnet = JaxNAFNet(**GEOMETRY, fused_blocks=False, flat_trunk=False)
    params = jax.tree_util.tree_map(np.asarray, jnet.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 16, 3)))["params"])
    rng = np.random.default_rng(1)
    params = {k: ({**v, "beta": rng.normal(0, 0.3, v["beta"].shape).astype(
        np.float32), "gamma": rng.normal(0, 0.3, v["gamma"].shape).astype(
        np.float32)} if "_blk" in k else v) for k, v in params.items()}
    net = define_network(dict(NET), device="cpu")
    return jnet, params, params_from_jax(params, model=net)


def _jax_forward(jnet, params, x_nchw):
    y = jnet.apply({"params": params}, jnp.asarray(x_nchw.transpose(0, 2, 3,
                                                                    1)))
    return np.asarray(y).transpose(0, 3, 1, 2)


@pytest.fixture(scope="module")
def runs():
    jnet, params, sd = _weights()
    rng = np.random.default_rng(1)
    h2 = spatial_pad_multiple(define_network(dict(NET), device="cpu"), 2) * 2
    x2 = rng.normal(size=(1, 3, h2, 20)).astype(np.float32)
    tgt = rng.normal(size=x2.shape).astype(np.float32)
    h4 = spatial_pad_multiple(define_network(dict(NET), device="cpu"), 4)
    x4 = rng.normal(size=(2, 3, h4, 18)).astype(np.float32)
    halo2 = rng.normal(size=(2, 6, 16, 5)).astype(np.float32)
    halo4 = rng.normal(size=(2, 6, 32, 5)).astype(np.float32)
    spec2 = dict(network_g=NET, state_dict=sd, x=x2)
    two = spawn(sequence, 2, device="cpu", threads=2, args=([
        (halo_rows, (halo2, 1)), (spatial_run, (spec2,)),
        (spatial_run, (dict(spec2, target=tgt),))],))
    four = spawn(sequence, 4, device="cpu", threads=1, args=([
        (halo_rows, (halo4, 1)),
        (spatial_run, (dict(network_g=NET, state_dict=sd, x=x4),))],))
    return dict(jnet=jnet, params=params, sd=sd, x2=x2, x4=x4, tgt=tgt,
                halo={2: (halo2, [r[0] for r in two]),
                      4: (halo4, [r[0] for r in four])},
                two=[r[1:] for r in two], four=[r[1] for r in four])


class TestHaloExchange:
    @pytest.mark.parametrize("n_sh", [2, 4])
    def test_matches_zero_padding(self, runs, n_sh):
        x, got = runs["halo"][n_sh]
        hs = x.shape[2] // n_sh
        padded = np.pad(x, ((0, 0), (0, 0), (1, 1), (0, 0)))
        for s in range(n_sh):
            np.testing.assert_array_equal(
                got[s], padded[:, :, s * hs:s * hs + hs + 2],
                err_msg=f"shard {s}")

    def test_single_shard_is_pad(self):
        x = torch.arange(2 * 1 * 4 * 3, dtype=torch.float32).reshape(
            2, 1, 4, 3)
        np.testing.assert_array_equal(
            halo_exchange_rows(x, 2, None).numpy(),
            np.pad(x.numpy(), ((0, 0), (0, 0), (2, 2), (0, 0))))


class TestSpatialNAFNet:
    def test_two_ranks_match_jax_single_device(self, runs):
        want = _jax_forward(runs["jnet"], runs["params"], runs["x2"])
        for fwd, _ in runs["two"]:
            assert fwd["out"].shape == runs["x2"].shape
            np.testing.assert_allclose(fwd["out"], want, atol=1e-5,
                                       rtol=1e-5)

    def test_batch_and_unaligned_width_four_ranks(self, runs):
        want = _jax_forward(runs["jnet"], runs["params"], runs["x4"])
        for fwd in runs["four"]:
            assert fwd["out"].shape == runs["x4"].shape
            np.testing.assert_allclose(fwd["out"], want, atol=1e-5,
                                       rtol=1e-5)

    def test_one_process_is_the_padded_forward(self, runs):
        net = define_network(dict(NET), device="cpu").eval()
        net.load_state_dict(runs["sd"])
        x = torch.from_numpy(runs["x4"])
        with torch.no_grad():
            np.testing.assert_allclose(
                nafnet_apply_spatial(net, x, None).numpy(), net(x).numpy(),
                atol=1e-5, rtol=1e-5)

    def test_rejects_tlc_dropout_and_other_nets(self):
        x = torch.zeros((1, 3, 16, 16))
        tlc = define_network({**NET, "tlc_window": [8, 8]}, device="cpu")
        with pytest.raises(ValueError, match="TLC"):
            nafnet_apply_spatial(tlc, x, None)
        drop = define_network({**NET, "dropout_rate": 0.1}, device="cpu")
        with pytest.raises(ValueError, match="deterministic"):
            nafnet_apply_spatial(drop, x, None)
        with pytest.raises(ValueError, match="unrolled NAFNet"):
            nafnet_apply_spatial(torch.nn.Conv2d(3, 3, 1), x, None)


class TestSpatialGradients:
    def test_param_grads_match_single_device(self, runs):
        net = define_network(dict(NET), device="cpu")
        net.load_state_dict(runs["sd"])
        out = net(torch.from_numpy(runs["x2"]))
        loss = ((out - torch.from_numpy(runs["tgt"])) ** 2).mean()
        names = [k for k, _ in net.named_parameters()]
        want = dict(zip(names, torch.autograd.grad(loss,
                                                   list(net.parameters()))))
        for _, grad in runs["two"]:
            assert set(grad["grads"]) == set(names)
            for k in names:
                np.testing.assert_allclose(grad["grads"][k],
                                           want[k].numpy(), atol=3e-5,
                                           rtol=3e-5, err_msg=k)
