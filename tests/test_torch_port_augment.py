"""Mixup (``training/augment.py``) against the JAX ``mixup_batch``, on the
CPU: given the coefficient and permutation that the JAX function draws
from its key, the port's arithmetic gives the same batch (rtol 1e-6) for
every image entry and ``expo_ratio``; the port's own draws come from a
``torch.Generator`` (a stated difference from JAX's key), are seeded and
repeatable, and give Beta(alpha, alpha) coefficients and permutations.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lowlight_image_enhancement_tpu.training.augment import (
    mixup_batch as jax_mixup_batch,
)
from lowlight_image_enhancement_tpu_torch.training.augment import (
    mixup_batch,
    mixup_draw,
)

KEYS = ("lq", "gt", "short_raw", "long_raw", "short_obs")


def _batch(n=4, seed=0):
    rng = np.random.default_rng(seed)
    out = {k: rng.uniform(size=(n, 6, 5, 3)).astype(np.float32)
           for k in KEYS}
    out["expo_ratio"] = rng.uniform(100, 300, (n,)).astype(np.float32)
    return out


@pytest.mark.parametrize("alpha", [0.4, 1.2])
@pytest.mark.parametrize("step", [0, 5])
def test_mixup_arithmetic_matches_jax(alpha, step):
    b = _batch()
    key = jax.random.fold_in(jax.random.PRNGKey(3), step)
    want = jax_mixup_batch(key, {k: jnp.asarray(v) for k, v in b.items()},
                           alpha=alpha)
    k1, k2 = jax.random.split(key)
    lam = float(jax.random.beta(k1, alpha, alpha))
    perm = torch.from_numpy(np.array(jax.random.permutation(k2, 4)))
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    tb["key"] = ["a", "b", "c", "d"]
    got = mixup_batch(tb, alpha=alpha, lam=lam, perm=perm)
    assert got["key"] == tb["key"]
    for k in KEYS + ("expo_ratio",):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, err_msg=k)


def test_mixup_draws_are_seeded_beta_and_permutations():
    draws = [mixup_draw(4, 1.2, torch.Generator().manual_seed(9))
             for _ in range(2)]
    assert draws[0][0] == draws[1][0]
    assert torch.equal(draws[0][1], draws[1][1])
    gen = torch.Generator().manual_seed(1)
    lams = []
    for _ in range(400):
        lam, perm = mixup_draw(5, 1.2, gen)
        assert 0.0 < lam < 1.0
        assert sorted(perm.tolist()) == list(range(5))
        lams.append(lam)
    # Beta(1.2, 1.2): mean 1/2, variance 1/13.6
    assert abs(np.mean(lams) - 0.5) < 0.05
    assert abs(np.var(lams) - 1 / 13.6) < 0.02
    b = {k: torch.from_numpy(v) for k, v in _batch(seed=2).items()}
    out = mixup_batch(b, alpha=1.2, generator=torch.Generator().manual_seed(4))
    lam, perm = mixup_draw(4, 1.2, torch.Generator().manual_seed(4))
    np.testing.assert_allclose(
        out["lq"].numpy(), (lam * b["lq"] + (1 - lam) * b["lq"][perm]).numpy(),
        rtol=1e-6)
