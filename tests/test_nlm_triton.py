"""NL-means: the Pallas-Triton kernel (ops/nlm_triton.py, run here under
the Pallas interpreter) against the XLA reference (ops/denoise.py), the
reference against the numpy oracle, and the shifted-sum box filter against
the cumulative-sum formulation it replaced."""

import sys
import os

import numpy as np
import jax.numpy as jnp
import pytest

from hiprfish_tpu.ops import denoise
from hiprfish_tpu.ops.nlm_triton import denoise_nl_means_triton

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from ref_oracle import skim  # noqa: E402


def _smooth_noisy(h, w, seed=0):
    """Structure at the patch scale plus noise, so neighbouring patches
    carry real weight (pure noise leaves every weight ~0 but the self
    term, which would hide a wrong offset)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w]
    img = (0.5 + 0.2 * np.sin(yy / 5.0) * np.cos(xx / 7.0)
           + 0.01 * rng.randn(h, w))
    return img.astype(np.float32)


# shapes that are not multiples of the output tile (block - 2 * radius)
@pytest.mark.parametrize("h,w,patch,dist,block", [
    (70, 90, 7, 11, 32),
    (40, 50, 5, 3, 16),
    (64, 64, 7, 11, 64),
    (33, 129, 3, 5, 16),
])
def test_triton_kernel_interpret_matches_xla(h, w, patch, dist, block):
    img = jnp.asarray(_smooth_noisy(h, w))
    ref = np.asarray(denoise.denoise_nl_means(img, 0.02, patch, dist))
    got = np.asarray(denoise_nl_means_triton(img, 0.02, patch, dist, block,
                                             4, True))
    assert got.shape == (h, w)
    np.testing.assert_allclose(got, ref, rtol=0, atol=5e-6)


@pytest.mark.parametrize("patch,dist", [(7, 11), (5, 4)])
def test_xla_nlm_matches_oracle(patch, dist):
    img = _smooth_noisy(48, 56, seed=1)
    ref = skim.denoise_nl_means(img, 0.02, patch, dist)
    got = np.asarray(denoise.denoise_nl_means(jnp.asarray(img), 0.02,
                                              patch, dist))
    np.testing.assert_allclose(got, ref, rtol=0, atol=5e-6)


@pytest.mark.parametrize("size", [3, 5, 7])
def test_box_mean_matches_cumsum_form(size):
    rng = np.random.RandomState(size)
    img = rng.rand(37, 45).astype(np.float32)
    half = size // 2
    p = np.pad(img.astype(np.float64), half, mode="edge")
    c = np.pad(np.cumsum(p, axis=0), ((1, 0), (0, 0)))
    rows = c[size:] - c[:-size]
    c2 = np.pad(np.cumsum(rows, axis=1), ((0, 0), (1, 0)))
    want = (c2[:, size:] - c2[:, :-size]) / (size * size)
    got = np.asarray(denoise._box_mean(jnp.asarray(img), size))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_auto_dispatch_is_xla_on_cpu():
    img = jnp.asarray(_smooth_noisy(40, 40, seed=2))
    np.testing.assert_array_equal(
        np.asarray(denoise.denoise_nl_means_auto(img, 0.02, 7, 11)),
        np.asarray(denoise.denoise_nl_means(img, 0.02, 7, 11)))
