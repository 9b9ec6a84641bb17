"""The port's RoIPool (``ops/roi_pool.py``, ``ROIS.METHOD roi_pool``)
against the JAX package's jitted ``roi_pool`` on the CPU.

- The pooling: equal in float32 over pooled sizes, scales, window caps 1, 8
  and the exact cap of the Dev (``cells // pooled + 2``), malformed RoIs
  (forced to 1x1), RoIs off the map (empty bins, 0), a NaN RoI, corners that
  round at exactly half a cell and one float32 ulp either side of it, and
  bfloat16 maps.
- The gradient into the map: within 1e-6 of the largest value of
  ``jax.vjp``'s, on maps with ties (values drawn from a few levels) and caps
  that sample cells more than once, where the gradient of a bin splits
  evenly among its maxima.
- ``make_roi_pool_input``: exact.
"""

import test_torch_workers  # noqa: F401  (first: sizes this xdist worker's thread pools)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature_intertwiner_tpu.ops import roi_pool as jrp
from feature_intertwiner_tpu_torch.ops import roi_pool as rp

T = torch.from_numpy


def _rois(rng, n, b, image):
    """[N, 5] pixel RoIs of all kinds: ordinary, malformed (x2 < x1), off
    the map, a NaN one, and corners on and one ulp around the rounding
    points of the scales tested."""
    x1 = rng.uniform(-0.1 * image, image, n)
    y1 = rng.uniform(-0.1 * image, image, n)
    x2 = x1 + rng.uniform(-0.2 * image, 0.8 * image, n)
    y2 = y1 + rng.uniform(-0.2 * image, 0.8 * image, n)
    rois = np.stack([rng.randint(0, b, n), x1, y1, x2, y2], 1).astype(np.float32)
    # corners at half a cell for scales 1/4, 1/8, 1/2 and 1, and one ulp away
    halves = np.array([2.0, 6.0, 10.0, 4.0, 12.0, 1.0, 3.0, 0.5, 1.5], np.float32)
    edge = np.concatenate([halves, np.nextafter(halves, np.float32(0)),
                           np.nextafter(halves, np.float32(1e9))])
    k = min(len(edge), n // 3)
    rois[:k, 1] = edge[:k]
    rois[k:2 * k, 4] = edge[:k] + np.float32(16.0)
    rois[2 * k, 1:] = np.nan
    rois[2 * k + 1, 1:] = [image * 2, image * 2, image * 3, image * 3]   # off the map
    return rois


CASES = [
    # (pooled, map side, image, cap)
    ((7, 7), 16, 64, 8),
    ((14, 14), 8, 64, 8),
    ((7, 7), 32, 64, 1),
    ((3, 5), 16, 32, 8),
    ((14, 14), 16, 64, 16 // 14 + 2),        # the Dev's exact cap
    ((7, 7), 64, 64, 64 // 7 + 2),
    ((2, 2), 8, 64, 8),
]


def _pair(case, dtype=np.float32, seed=0, levels=None):
    pooled, side, image, cap = case
    rng = np.random.RandomState(seed)
    feats = rng.randn(2, side, side + 3, 5)
    if levels:
        feats = rng.randint(0, levels, feats.shape)
    feats = feats.astype(np.float32)
    rois = _rois(rng, 40, 2, image)
    return feats, rois, side / image, pooled, cap


@pytest.mark.parametrize("case", CASES, ids=[f"p{c[0][0]}x{c[0][1]}-s{c[1]}-i{c[2]}-cap{c[3]}"
                                              for c in CASES])
def test_roi_pool_equals_jax(case):
    feats, rois, scale, pooled, cap = _pair(case)
    want = np.asarray(jrp.roi_pool(jnp.asarray(feats), jnp.asarray(rois), scale, pooled,
                                   window_cap=cap))
    got = rp.roi_pool(T(feats), T(rois), scale, pooled, window_cap=cap).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want == 0).all(-1).any() and (want != 0).any()      # empty bins and values


@pytest.mark.parametrize("case", CASES[:3], ids=["p7", "p14", "cap1"])
def test_roi_pool_equals_jax_on_bf16_maps(case):
    feats, rois, scale, pooled, cap = _pair(case, seed=3)
    jf = jnp.asarray(feats).astype(jnp.bfloat16)
    want = jrp.roi_pool(jf, jnp.asarray(rois), scale, pooled, window_cap=cap)
    got = rp.roi_pool(T(feats).to(torch.bfloat16), T(rois), scale, pooled, window_cap=cap)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_cell_rounding_is_c_round_with_a_fused_multiply_add():
    """Corners at half a cell and one ulp around it, on the scales the Dev
    uses and on 0.1, where rounding the product before the add puts some
    of them a cell off the jitted JAX rounding."""
    rng = np.random.RandomState(5)
    cells = rng.randint(0, 300, 4000) + 0.5
    for scale in (0.25, 0.125, 1 / 32, 0.5, 1 / 3, 0.1):
        pix = (cells / scale).astype(np.float32)
        pix = np.concatenate([pix, np.nextafter(pix, np.float32(0)),
                              np.nextafter(pix, np.float32(1e9)),
                              rng.uniform(0, 2000, 4000).astype(np.float32)])
        want = jax.jit(lambda x, s: jnp.floor(x * s + 0.5).astype(jnp.int32))(
            jnp.asarray(pix), scale)
        np.testing.assert_array_equal(rp.c_round(T(pix), scale).numpy(), np.asarray(want))
    special = np.array([np.nan, np.inf, -np.inf, 3e9, -3e9], np.float32)
    np.testing.assert_array_equal(rp.c_round(T(special), 1.0).numpy(),
                                  [0, 2 ** 31 - 1, -2 ** 31, 2 ** 31 - 1, -2 ** 31])


@pytest.mark.parametrize("case", [CASES[0], CASES[1], CASES[4], CASES[6]],
                         ids=["p7-cap8", "p14-cap8-repeats", "p14-exact-cap", "p2"])
def test_roi_pool_gradient_matches_jax_vjp(case):
    feats, rois, scale, pooled, cap = _pair(case, seed=7, levels=4)
    g = np.random.RandomState(8).randn(len(rois), *pooled, feats.shape[-1]).astype(np.float32)
    _, vjp = jax.vjp(lambda f: jrp.roi_pool(f, jnp.asarray(rois), scale, pooled,
                                            window_cap=cap), jnp.asarray(feats))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    f = T(feats).requires_grad_()
    rp.roi_pool(f, T(rois), scale, pooled, window_cap=cap).backward(T(g))
    got = f.grad.numpy()
    scale_ = np.abs(want).max()
    assert scale_ > 0
    assert np.abs(got - want).max() <= 1e-6 * scale_, np.abs(got - want).max() / scale_
    # ties split: some cell takes a share that is not a whole cotangent sum
    assert ((got != 0) & (np.abs(got) < np.abs(g).max())).any()


def test_make_roi_pool_input_is_exact():
    rng = np.random.RandomState(2)
    boxes = rng.uniform(0, 1, (64, 4)).astype(np.float32)
    idx = rng.randint(0, 4, 64).astype(np.int32)
    for size in (1024.0, 128.0, 800.0):
        want = np.asarray(jrp.make_roi_pool_input(jnp.asarray(boxes), jnp.asarray(idx), size))
        got = rp.make_roi_pool_input(T(boxes), T(idx), size).numpy()
        np.testing.assert_array_equal(got, want)
