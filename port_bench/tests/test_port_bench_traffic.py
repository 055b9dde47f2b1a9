"""The traffic generators and the check's bookkeeping: the same seed gives
the same inputs, another seed other inputs of the same sizes."""

import numpy as np
import pytest
import torch

from port_bench.harness import data
from port_bench.harness.serve import Reservoir
from port_bench.harness.weights import make_params, subseed
from port_bench.reference.nafnet import nafnet_param_shapes
from port_bench.reference.serve import bucket_dim, tile_starts

SEED = 2 ** 31 + 12345


def test_image_pool_is_deterministic_by_seed():
    a = data.image_pool(3, 40, 56, SEED, "cpu")
    b = data.image_pool(3, 40, 56, SEED, "cpu")
    c = data.image_pool(3, 40, 56, SEED + 1, "cpu")
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])
    assert all(x.shape == (40, 56, 3) and x.dtype == np.float32 for x in c)
    assert all(0.0 <= x.min() and x.max() <= 1.0 for x in a)


def test_sid_pairs_and_sub_images_are_deterministic_by_seed():
    a = data.sid_pairs(2, 64, 80, [100, 300], SEED, "cpu")
    b = data.sid_pairs(2, 64, 80, [100, 300], SEED, "cpu")
    c = data.sid_pairs(2, 64, 80, [100, 300], SEED + 7, "cpu")
    for (s1, l1, r1), (s2, l2, r2) in zip(a, b):
        assert np.array_equal(s1, s2) and np.array_equal(l1, l2) and r1 == r2
    assert not np.array_equal(a[0][1], c[0][1])
    assert a[0][0].dtype == np.uint16 and a[1][2] == 300
    # long exposures are bright, short ones dark
    assert a[0][1].mean() > 20 * a[0][0].mean()
    subs = data.sub_images(a, 32, 24)
    # rows 0, 24, 32 (flush); columns 0, 24, 48 (flush at 48)
    assert len(subs) == 2 * 3 * 3
    assert np.array_equal(subs[1][1], a[0][1][0:32, 24:56])


def test_crop_finder_locates_every_crop():
    pairs = data.sid_pairs(2, 64, 80, [100, 300], SEED, "cpu")
    finder = data.CropFinder(pairs)
    for i, top, left in [(0, 0, 0), (1, 31, 47), (0, 32, 48)]:
        crop = pairs[i][1][top:top + 16, left:left + 16]
        assert finder.find(crop) == (i, top, left)
    assert finder.find(np.zeros((16, 16, 3), np.uint16)) is None


def test_packs_read_back_through_the_port(tmp_path):
    from lowlight_image_enhancement_tpu_torch.data.sid_dataset import (
        SonySIDDataset,
    )

    pairs = data.sid_pairs(2, 64, 80, [100, 300], SEED, "cpu")
    paths = data.write_sid_root(str(tmp_path), pairs)
    ds = SonySIDDataset(paths["manifest_path"], patch_size=16,
                        io_backend={"type": "pack",
                                    "short_path": paths["short_path"],
                                    "long_path": paths["long_path"]})
    item = ds[1]
    u16 = np.round(item["gt"] * 65535.0).astype(np.uint16)
    i, top, left = data.CropFinder(pairs).find(u16)
    assert i == 1 and item["expo_ratio"] == 300
    short = pairs[1][0][top:top + 16, left:left + 16].astype(np.float32)
    np.testing.assert_allclose(item["short_raw"], short / 65535.0, rtol=1e-6)


def test_weights_are_deterministic_and_scaled_by_kind():
    shapes = nafnet_param_shapes(3, 8, [1], 1, [1])
    a = make_params(shapes, SEED, "net", "cpu", residual_scale=0.1)
    b = make_params(shapes, SEED, "net", "cpu", residual_scale=0.1)
    c = make_params(shapes, SEED + 1, "net", "cpu", residual_scale=0.1)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["intro.weight"], c["intro.weight"])
    bound = 1 / (3 * 9) ** 0.5
    assert a["intro.weight"].abs().max() <= bound
    assert 0.0 <= float(a["encoders.0.0.beta"].min())
    assert float(a["encoders.0.0.gamma"].max()) <= 0.2
    assert (a["encoders.0.0.norm1.weight"] - 1).abs().max() <= 0.1


def test_subseeds_take_seeds_past_32_bits():
    for seed in (0, 2 ** 31 + 5, 2 ** 40):
        assert 0 <= subseed(seed, "x", bits=31) < 2 ** 31
    assert subseed(5, "a") != subseed(5, "b")


def test_reservoir_is_deterministic_and_bounded():
    def draw(seed):
        r = Reservoir(3, np.random.default_rng(seed))
        for i in range(100):
            r.offer(i, i)
        return r.items
    assert draw(1) == draw(1) and len(draw(1)) == 3
    assert draw(1) != draw(2)


def test_bucket_and_tile_arithmetic_match_the_server():
    from lowlight_image_enhancement_tpu_torch.serving import _bucket_dim
    from lowlight_image_enhancement_tpu_torch.training.validation import (
        _tile_starts,
    )

    for size in (1, 63, 64, 65, 683, 1024):
        assert bucket_dim(size, 64, 64) == _bucket_dim(size, 64, 64)
    assert bucket_dim(683, 64, 64) == 704
    assert tile_starts(2848, 1024, 512) == _tile_starts(2848, 1024, 512)
    assert len(tile_starts(2848, 1024, 512)) * len(
        tile_starts(4256, 1024, 512)) == 40


@pytest.mark.parametrize("h,w", [(43, 64), (150, 200)])
def test_reference_restore_matches_the_server_on_an_identity_net(h, w):
    """With a network that returns its input, the server and the
    reference both give the image back (bucketing and crop-back; tiling
    and overlap averaging at 150 x 200 with 64-pixel tiles)."""
    from lowlight_image_enhancement_tpu_torch.serving import RestorationServer
    from port_bench.reference.serve import restore_call

    server_opt = {"bucket_step": 64, "min_bucket": 64, "max_bucket": 64,
                  "max_batch": 8, "tile_overlap": 0.5}
    img = data.image_pool(1, h, w, SEED, "cpu")[0]
    ident = torch.nn.Conv2d(3, 3, 1, bias=False)
    with torch.no_grad():
        ident.weight.copy_(torch.eye(3)[:, :, None, None] * 2.0)
    server = RestorationServer(ident, device="cpu", **server_opt)
    got = server.predict([img])[0]
    ref = restore_call(lambda x: ident(x), [torch.from_numpy(img).permute(
        2, 0, 1)], server_opt)[0].permute(1, 2, 0).detach().numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, 2 * img, rtol=1e-5, atol=1e-6)
