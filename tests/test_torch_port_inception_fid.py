"""The port's InceptionV3, FID and bilinear resize against the JAX
package's, on the CPU:

- ``ops/image_ops.py:resize_bilinear`` against ``jax.image.resize(...,
  "bilinear")`` (antialiased when it shrinks) at 512^2 -> 299^2,
  64x48 -> 299^2, 37x53 -> 16^2 and 8^2 -> 24^2: within 1e-5;
- ``models/inception.py:InceptionV3Pool3`` (the FID variant and the
  torchvision one) with the JAX trunk's weights and perturbed BatchNorm
  statistics carried over by ``weights.inception_params_from_jax``: pool3
  features at 1x3x75^2 (resized to 299^2) and 2x3x299^2 within 1e-4 of
  max|feature|; the weight file read by both loaders;
- ``metrics/fid.py``: ``compute_feature_stats`` and
  ``calculate_fid_from_stats`` (rtol 1e-6), ``vgg_feature_extractor``
  against JAX's (1e-4) and equal under every ``pool_impl`` on the CPU,
  ``calculate_fid`` on the bridged VGG19 extractor (rtol 1e-5: six images,
  a singular covariance), and the default extractor's refusal without
  weights.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lowlight_image_enhancement_tpu.metrics import fid as jfid
from lowlight_image_enhancement_tpu.models.inception import (
    InceptionV3Pool3 as JInception,
)
from lowlight_image_enhancement_tpu.models.inception import (
    load_inception_v3 as jload_inception,
)
from lowlight_image_enhancement_tpu.models.vgg import (
    load_vgg19_features as jload_vgg,
)
from lowlight_image_enhancement_tpu_torch.metrics import fid
from lowlight_image_enhancement_tpu_torch.models.inception import (
    InceptionV3Pool3,
    load_inception_v3,
)
from lowlight_image_enhancement_tpu_torch.ops.image_ops import (
    resize_bilinear,
)
from lowlight_image_enhancement_tpu_torch.weights import (
    inception_params_from_jax,
    vgg_params_from_jax,
)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a,
                                                             (0, 3, 1, 2))))


@pytest.mark.parametrize("src,dst", [((512, 512), (299, 299)),
                                     ((64, 48), (299, 299)),
                                     ((37, 53), (16, 16)),
                                     ((8, 8), (24, 24))])
def test_resize_bilinear_matches_jax(src, dst):
    x = np.random.default_rng(0).standard_normal((2, *src, 3)).astype(
        np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, *dst, 3),
                                       "bilinear"))
    got = resize_bilinear(_nchw(x), dst)
    assert tuple(got.shape) == (2, 3, *dst)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=0, atol=1e-5)


def _perturbed_bn(tree, rng):
    """The JAX init's BatchNorm (identity) replaced by random statistics,
    so that the bridge's BN mapping is exercised."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturbed_bn(v, rng)
        elif k == "bn_var":
            out[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
        elif k in ("bn_mean", "bn_bias"):
            out[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)
        elif k == "bn_scale":
            out[k] = rng.uniform(0.8, 1.2, v.shape).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def jax_inception():
    module = JInception()
    variables = jax.jit(module.init)(jax.random.PRNGKey(0),
                                     jnp.zeros((1, 299, 299, 3)))
    params = _perturbed_bn(jax.tree_util.tree_map(np.asarray,
                                                  variables["params"]),
                           np.random.default_rng(1))
    return {"params": params}


@pytest.mark.parametrize("fid_variant", [True, False])
@pytest.mark.parametrize("shape", [(1, 75, 75, 3), (2, 299, 299, 3)])
def test_pool3_features_match_jax(jax_inception, shape, fid_variant):
    x = np.random.default_rng(2).uniform(-1, 1, shape).astype(np.float32)
    want = np.asarray(jax.jit(JInception(fid_variant=fid_variant).apply)(
        jax_inception, jnp.asarray(x)))
    model = InceptionV3Pool3(fid_variant=fid_variant)
    model.load_state_dict(inception_params_from_jax(jax_inception))
    model.train()              # stays in eval mode: frozen BatchNorm
    assert not model.training
    with torch.no_grad():
        got = model(_nchw(x)).numpy()
    assert got.shape == want.shape == (shape[0], 2048)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def test_inception_weight_file_is_read_by_both_loaders(jax_inception,
                                                       tmp_path,
                                                       monkeypatch):
    sd = inception_params_from_jax(jax_inception)
    arrays = {k: v.numpy() for k, v in sd.items()
              if not k.endswith("num_batches_tracked")}
    assert sum(k.endswith(".conv.weight") for k in arrays) == 94
    path = tmp_path / "inception_v3_fid.npz"
    np.savez(path, **arrays)
    monkeypatch.setenv("LLIE_INCEPTION_NPZ", str(path))
    jmodule, jvars, jpre = jload_inception()
    model, pretrained = load_inception_v3()
    assert jpre and pretrained
    x = np.random.default_rng(3).uniform(-1, 1, (1, 80, 80, 3)).astype(
        np.float32)
    want = np.asarray(jax.jit(jmodule.apply)(jvars, jnp.asarray(x)))
    with torch.no_grad():
        np.testing.assert_allclose(model(_nchw(x)).numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())
    del arrays["Mixed_7c.branch_pool.bn.running_var"]
    np.savez(path, **arrays)
    with pytest.raises(KeyError, match="running_var"):
        load_inception_v3()


def test_inception_without_weights(monkeypatch, tmp_path):
    monkeypatch.setenv("LLIE_INCEPTION_NPZ", str(tmp_path / "absent.npz"))
    a, pa = load_inception_v3()
    b, _ = load_inception_v3()
    assert not pa and all(torch.equal(u, v) for u, v in zip(
        a.state_dict().values(), b.state_dict().values()))
    with pytest.raises(RuntimeError, match="pretrained InceptionV3"):
        fid.inception_feature_extractor(device="cpu")
    with pytest.raises(RuntimeError, match="pretrained InceptionV3"):
        fid.calculate_fid(torch.zeros(2, 3, 32, 32),
                          torch.zeros(2, 3, 32, 32), device="cpu")
    extract = fid.inception_feature_extractor(allow_random=True,
                                              device="cpu")
    assert extract.metadata["pretrained"] is False
    feats = extract(torch.rand(2, 3, 40, 40))
    assert feats.shape == (2, 2048) and np.isfinite(feats).all()


def test_fid_statistics_match_jax():
    rng = np.random.default_rng(4)
    f1 = rng.normal(0, 1, (40, 6))
    f2 = rng.normal(0.3, 1.2, (50, 6)) @ rng.normal(0, 0.5, (6, 6))
    s1, s2 = fid.compute_feature_stats(f1), fid.compute_feature_stats(f2)
    j1, j2 = jfid.compute_feature_stats(f1), jfid.compute_feature_stats(f2)
    for a, b in zip(s1 + s2, j1 + j2):
        np.testing.assert_allclose(a, b, rtol=1e-6)
    np.testing.assert_allclose(fid.calculate_fid_from_stats(*s1, *s2),
                               jfid.calculate_fid_from_stats(*j1, *j2),
                               rtol=1e-6)
    assert abs(fid.calculate_fid_from_stats(*s1, *s1)) < 1e-6
    with pytest.raises(ValueError, match="N, D"):
        fid.compute_feature_stats(f1[0])


@pytest.fixture(scope="module")
def vgg_pair():
    """The JAX VGG19 extractor and the port's, on the JAX trunk's weights."""
    jextract = jfid.vgg_feature_extractor()
    _, variables, _ = jload_vgg(taps=("relu5_4",))
    sd = vgg_params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                    variables["params"]))
    return jextract, sd


def _vgg(sd, pool_impl=None):
    extract = fid.vgg_feature_extractor(pool_impl=pool_impl, device="cpu")
    extract.module.load_state_dict(sd)
    return extract


def test_vgg_extractor_matches_jax(vgg_pair):
    jextract, sd = vgg_pair
    x = np.random.default_rng(5).uniform(0, 1, (3, 48, 40, 3)).astype(
        np.float32)
    want = jextract(x)
    extract = _vgg(sd)
    got = extract(_nchw(x))
    assert got.shape == want.shape == (3, 512)
    assert extract.metadata["extractor"] == jextract.metadata["extractor"]
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("pool_impl", ["kernel_bwd", "kernel_fused"])
def test_vgg_extractor_pool_impls_agree(vgg_pair, pool_impl):
    _, sd = vgg_pair
    x = torch.rand(2, 3, 33, 47, generator=torch.Generator().manual_seed(6))
    np.testing.assert_array_equal(_vgg(sd, pool_impl)(x), _vgg(sd)(x))


def test_calculate_fid_matches_jax(vgg_pair):
    jextract, sd = vgg_pair
    rng = np.random.default_rng(7)
    a = rng.uniform(0, 1, (6, 32, 32, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.2, a.shape), 0, 1).astype(np.float32)
    want = jfid.calculate_fid(a, b, feature_extractor=jextract, batch_size=4)
    got = fid.calculate_fid(_nchw(a), _nchw(b), feature_extractor=_vgg(sd),
                            batch_size=4)
    np.testing.assert_allclose(got, want, rtol=1e-5)
