"""Distributed validation of the port (``training/validation.py``:
``allreduce_metric_sums``, ``dist_validate``; ``training/model_wrapper.py``:
``ImageRestorationModel.validation``), as the JAX package's
``validation.py:167-250`` and ``model_wrapper.py:220-262`` define it:
each rank takes the images (batches) ``i % world == rank`` and one
all-reduce sums the metric sums and counts. Two ranks are real processes
over gloo on the CPU; their means equal the single-process ones, rtol
1e-6 (another summation order of the same float64 sums)."""

import numpy as np
import pytest
import torch

from lowlight_image_enhancement_tpu_torch.models import define_network
from lowlight_image_enhancement_tpu_torch.parallel.launch import (
    spawn,
    validation_run,
)
from lowlight_image_enhancement_tpu_torch.training.train_step import (
    make_eval_step,
)
from lowlight_image_enhancement_tpu_torch.training.validation import (
    allreduce_metric_sums,
    dist_validate,
    validate,
)

NET = {"type": "NAFNet", "img_channel": 3, "width": 8,
       "middle_blk_num": 1, "enc_blk_nums": [1], "dec_blk_nums": [1]}
METRICS = {"psnr_linear": {"type": "linear_psnr", "data_range": 1.0},
           "ssim_linear": {"type": "linear_ssim", "data_range": 1.0}}


def _spec():
    torch.manual_seed(0)
    net = define_network(dict(NET), device="cpu")
    rng = np.random.default_rng(2)
    batches = []
    for i in range(4):
        gt = rng.uniform(0, 1, (1, 24, 32, 3)).astype(np.float32)
        lq = np.clip(gt * 0.3 + rng.normal(0, 0.02, gt.shape), 0,
                     1).astype(np.float32)
        batches.append({"lq": lq, "gt": gt, "pair_id": [f"img{i}"]})
    opt = {"network_g": NET, "val": {"metrics": METRICS}, "is_train": False,
           "manual_seed": 0}
    return dict(network_g=NET, state_dict=net.state_dict(), batches=batches,
                metrics=METRICS, opt=opt, device="cpu")


@pytest.fixture(scope="module")
def runs():
    spec = _spec()
    return spec, validation_run(spec), spawn(validation_run, 2,
                                             device="cpu", args=(spec,),
                                             threads=2)


@pytest.fixture(scope="module")
def one_image_runs():
    """One image over two ranks: rank 1's stride holds none."""
    spec = _spec()
    spec["batches"] = spec["batches"][:1]
    return validation_run(spec), spawn(validation_run, 2, device="cpu",
                                       args=(spec,), threads=2)


def test_allreduce_metric_sums_single_process():
    sums = {"psnr": 40.5, "ssim": 1.75}
    assert allreduce_metric_sums(sums, 2) == (sums, 2)
    got, n = allreduce_metric_sums({}, 0)
    assert got == {} and n == 0


def test_dist_validate_single_process_is_validate(runs):
    spec, _, _ = runs
    net = define_network(dict(NET), device="cpu")
    net.load_state_dict(spec["state_dict"])
    fwd = make_eval_step(net)
    want = validate(fwd, spec["batches"], METRICS, device="cpu")
    assert dist_validate(fwd, spec["batches"], METRICS,
                         device="cpu") == want


def test_dist_validate_two_ranks(runs):
    _, one, two = runs
    assert one["own_images"] == 4
    assert [r["own_images"] for r in two] == [2, 2]
    for r in two:
        assert set(r["dist_validate"]) == set(METRICS)
        for k, v in one["dist_validate"].items():
            np.testing.assert_allclose(r["dist_validate"][k], v, rtol=1e-6,
                                       err_msg=k)


def test_wrapper_validation_strides_two_ranks(runs):
    _, one, two = runs
    assert set(one["wrapper"]) == set(METRICS)
    for r in two:
        for k, v in one["wrapper"].items():
            np.testing.assert_allclose(r["wrapper"][k], v, rtol=1e-6,
                                       err_msg=k)
    # the wrapper and dist_validate agree on the same images
    for k, v in one["wrapper"].items():
        np.testing.assert_allclose(v, one["dist_validate"][k], rtol=1e-6)


def test_dist_validate_rank_without_images(one_image_runs):
    one, two = one_image_runs
    assert [r["own_images"] for r in two] == [1, 0]
    for r in two:
        for what in ("dist_validate", "wrapper"):
            assert set(r[what]) == set(METRICS)
            for k, v in one[what].items():
                np.testing.assert_allclose(r[what][k], v, rtol=1e-6,
                                           err_msg=f"{what} {k}")
