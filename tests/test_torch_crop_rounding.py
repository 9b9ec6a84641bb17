"""Where the single-level crops place their samples: the port against the
jitted JAX package (ROADMAP C.4 and C.5), on the CPU.

XLA compiles the JAX ``_sample_positions`` of a single-level crop (map
extent ``dim`` a constant) as ``fma(i, (c1 - c0) * ratio, c0 * (dim - 1))``
with ``ratio = f32(dim - 1) * f32(1 / (crop - 1))`` folded into one
constant; un-jitted it divides and adds in two roundings, as the Pallas
kernels K4 and K5 do. A box that ends at exactly 1.0 (a proposal clipped to
the image) has its last sample land on the map's last row or just past it,
and so read or extrapolated, by the rounding alone. The JAX train step is
jitted, so the port's Dev big-set crop (K4, ``positions="xla"``) and its
mask targets (``crop_and_resize_separable``) take the jitted rounding:
- positions, taps and validity bit for bit, for boxes ending at 1.0 at H =
  32, 64 and 256, crops 7 and 14, and on random boxes; the "pallas"
  rounding bit for bit as the un-jitted JAX function;
- the big-set crop within 1e-6 of the largest value of the jitted JAX
  ``crop_and_resize`` (which lerps x before y, K4 y before x);
- the mask targets' interpolation matrices bit for bit.

Run as a script (``python tests/test_torch_crop_rounding.py``, JAX on the
CPU), it prints how many of 100,000 boxes ending at 1.0 have their last
sample past the last row under each rounding; how many positions of
random boxes the folded ratio and a ratio rounded as one division,
``f32((H - 1) / (crop - 1))``, place off the jitted JAX crop's; and how
many rounded mask-target pixels the Pallas rounding flips.
"""

import test_torch_workers  # noqa: F401  (first: sizes this xdist worker's thread pools)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature_intertwiner_tpu.ops import roi_align as jra
from feature_intertwiner_tpu_torch.ops import roi_align as ra

T = torch.from_numpy


def boxes_ending_at_one(n, seed):
    """[n] starts below 0.999 and ends at exactly 1.0."""
    rng = np.random.RandomState(seed)
    return (rng.rand(n) * 0.999).astype(np.float32), np.ones(n, np.float32)


def jitted_positions(c0, c1, crop, dim):
    return np.asarray(jax.jit(lambda a, b: jra._sample_positions(a, b, crop, float(dim)))(c0, c1))


def port_positions(c0, c1, crop, dim, positions):
    return ra._single_level_positions(T(c0), T(c1), crop, dim, positions).numpy()


def overshoots(pos, dim):
    return int((pos[:, -1] > dim - 1).sum())


@pytest.mark.parametrize("crop", [7, 14])
@pytest.mark.parametrize("dim", [32, 64, 256])
def test_xla_positions_equal_the_jitted_jax_crop_bit_for_bit(dim, crop):
    c0, c1 = boxes_ending_at_one(20000, dim + crop)
    rng = np.random.RandomState(crop)
    a, b = rng.rand(2, 20000).astype(np.float32)
    c0 = np.concatenate([c0, np.minimum(a, b)])
    c1 = np.concatenate([c1, np.maximum(a, b)])
    want = jitted_positions(c0, c1, crop, dim)
    got = port_positions(c0, c1, crop, dim, "xla")
    np.testing.assert_array_equal(got, want)
    # the taps, lerps and validity of K4's plain version follow
    lo, hi, frac, valid = (t[0].numpy() for t in ra._grouped_axis(
        T(c0)[None], T(c1)[None], crop, dim, "xla"))
    wlo, whi, wfrac, wvalid = (np.asarray(t) for t in jra._corner_weights(jnp.asarray(want),
                                                                          float(dim)))
    np.testing.assert_array_equal(lo, wlo)
    np.testing.assert_array_equal(hi, whi)
    np.testing.assert_array_equal(frac, wfrac)
    np.testing.assert_array_equal(valid, wvalid)
    # the Pallas kernels' rounding is the un-jitted function's, and differs
    eager = np.asarray(jra._sample_positions(jnp.asarray(c0), jnp.asarray(c1), crop, float(dim)))
    np.testing.assert_array_equal(port_positions(c0, c1, crop, dim, "pallas"), eager)
    assert overshoots(eager[:20000], dim) != overshoots(want[:20000], dim)


def test_big_set_crop_matches_the_jitted_jax_crop():
    """K4's plain version in the big-set mode against the jitted JAX
    ``crop_and_resize`` on boxes grouped per image, a third of them ending
    at 1.0 in y or x: within 1e-6 of the largest value (the lerps run in
    another order), extrapolated exactly where JAX extrapolates."""
    rng = np.random.RandomState(3)
    image = rng.randn(2, 32, 24, 8).astype(np.float32)
    b = rng.rand(2, 60, 4).astype(np.float32)
    boxes = np.concatenate([np.minimum(b[..., :2], b[..., 2:]),
                            np.maximum(b[..., :2], b[..., 2:])], -1)
    boxes[:, ::3, 2] = 1.0
    boxes[:, 1::3, 3] = 1.0
    want = np.asarray(jra.crop_and_resize(jnp.asarray(image), jnp.asarray(boxes.reshape(-1, 4)),
                                          jnp.repeat(jnp.arange(2), 60), (14, 14)))
    got = ra.crop_and_resize_grouped(T(image), T(boxes), (14, 14),
                                     positions="xla").reshape(120, 14, 14, 8).numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    np.testing.assert_array_equal(got == 0, want == 0)
    pallas = ra.crop_and_resize_grouped(T(image), T(boxes), (14, 14)).reshape(120, 14, 14, 8)
    assert np.abs(pallas.numpy() - want).max() > 0.1 * np.abs(want).max()


@pytest.mark.parametrize("crop", [28, 1])
def test_mask_target_interpolation_matches_the_jitted_jax_crop(crop):
    """C.5: ``crop_and_resize_separable`` (the mask targets) builds the
    jitted JAX interpolation matrices bit for bit, mini-mask boxes reaching
    past the mask included, so that the rounded targets agree."""
    rng = np.random.RandomState(crop)
    b = rng.rand(3000, 4).astype(np.float32)
    boxes = np.concatenate([np.minimum(b[:, :2], b[:, 2:]) - 0.2,
                            np.maximum(b[:, :2], b[:, 2:]) + 0.2], 1).astype(np.float32)
    boxes[::4, 2] = 1.0
    for c0, c1 in ((boxes[:, 0:1], boxes[:, 2:3]), (boxes[:, 1:2], boxes[:, 3:4])):
        want = np.asarray(jax.jit(lambda a, b: jra._interp_matrix(a, b, crop, 14))(c0, c1))
        got = ra._interp_matrix(T(c0[:, 0]), T(c1[:, 0]), crop, 14).numpy()
        np.testing.assert_array_equal(got, want)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    print("last samples past the last row, of 100,000 boxes ending at 1.0 (crop 14)")
    print(f"{'H':>5} {'jitted JAX':>11} {'eager JAX':>10} {'K4 pallas':>10} {'K4 xla':>8} "
          f"{'K1':>6}")
    for dim in (32, 64, 256):
        c0, c1 = boxes_ending_at_one(100000, dim)
        k1 = ra._sample_positions(T(c0), T(c1), 14, torch.full((100000,), float(dim))).numpy()
        eager = np.asarray(jra._sample_positions(jnp.asarray(c0), jnp.asarray(c1), 14,
                                                 float(dim)))
        print(f"{dim:5d} {overshoots(jitted_positions(c0, c1, 14, dim), dim):11d} "
              f"{overshoots(eager, dim):10d} "
              f"{overshoots(port_positions(c0, c1, 14, dim, 'pallas'), dim):10d} "
              f"{overshoots(port_positions(c0, c1, 14, dim, 'xla'), dim):8d} "
              f"{overshoots(k1, dim):6d}")
    print("positions off the jitted JAX crop's, of 20,000 random boxes x crop")
    for crop in (7, 14, 28):
        for dim in (16, 32, 64, 65, 100, 128, 256):
            rng = np.random.RandomState(dim)
            a, b = rng.rand(2, 20000).astype(np.float32)
            c0, c1 = np.minimum(a, b), np.maximum(a, b)
            want = jitted_positions(c0, c1, crop, dim)
            one_div = np.float32(np.float32(dim - 1) / np.float32(crop - 1))
            step = T(c1 - c0) * float(one_div)
            pos = ra._fma(torch.arange(crop, dtype=torch.float32), step[:, None],
                          T(c0 * np.float32(dim - 1))[:, None]).numpy()
            folded = int((port_positions(c0, c1, crop, dim, "xla") != want).sum())
            print(f"  H {dim:4d} crop {crop:2d}: folded ratio {folded:6d}, "
                  f"one division {int((pos != want).sum()):6d} of {want.size}")
    sweep = [(dim, crop) for dim in list(range(2, 300)) + [512, 1024]
             for crop in (2, 3, 5, 7, 9, 14, 28)]
    off = 0
    for dim, crop in sweep:
        rng = np.random.RandomState(dim)
        a, b = rng.rand(2, 2000).astype(np.float32)
        c0, c1 = np.minimum(a, b), np.maximum(a, b)
        c1[:500] = 1.0
        off += int((port_positions(c0, c1, crop, dim, "xla")
                    != jitted_positions(c0, c1, crop, dim)).sum())
    print(f"  the folded ratio over H = 2-299, 512, 1024 and crops 2-28 "
          f"({len(sweep)} pairs, 2,000 boxes each): {off} positions off")
    rng = np.random.RandomState(28)
    b = rng.rand(4000, 4).astype(np.float32)
    boxes = np.concatenate([np.minimum(b[:, :2], b[:, 2:]) - 0.2,
                            np.maximum(b[:, :2], b[:, 2:]) + 0.2], 1).astype(np.float32)
    c0, c1 = boxes[:, 0:1], boxes[:, 2:3]
    want = np.asarray(jax.jit(lambda a, b: jra._interp_matrix(a, b, 28, 14))(c0, c1))
    pos = ra._single_level_positions(T(c0[:, 0]), T(c1[:, 0]), 28, 14, "pallas")
    lo = torch.floor(pos)
    frac = (pos - lo).numpy()
    valid = ((pos >= 0) & (pos <= 13)).numpy()
    lo_i = lo.clamp(0, 13).long().numpy()
    wfrac = np.take_along_axis(want, np.minimum(lo_i + 1, 13)[..., None], -1)[..., 0]
    differ = int(((frac != wfrac) & valid & (frac > 0)).sum())
    print(f"mask-target interpolation weights (28 samples of 4,000 mini-mask boxes over "
          f"14 rows): the Pallas rounding gives {differ} of {valid.sum()} valid lerps "
          f"another float than the jitted JAX matrices; the xla rounding none (tested)")
