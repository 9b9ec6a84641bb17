"""bfloat16 in the port against the JAX package, on the CPU.

- The RoIAlign kernels' bfloat16 entry (the forward K1 and the grouped
  crops K4 and K5, the gradient K3) against the JAX functions on bfloat16
  maps: the window kernel and ``crop_and_resize_pallas(_mm)`` in interpret
  mode, and the VJP of the window pooling. Tolerance: one bfloat16
  rounding, ``|port - jax| <= 2^-7 |jax| + 1e-5 max|jax|``; both widen the
  maps exactly, add in float32 and round once, so they differ only where
  their float32 sums straddle a rounding boundary (one unit in the last
  place of bfloat16, at most 2^-7 of the value).
- The modules in bfloat16 (ResNet, FPN, RPN, box head, mask head, the Dev
  make-up block and critic) against their flax twins built with
  ``dtype=jnp.bfloat16`` and the same float32 weights. bfloat16 rounds each
  layer's output to 8 significant bits, and the two frameworks sum their
  convolutions in other orders, so the port is held to JAX's own bfloat16
  error: with ``e = max|jax_bf16 - jax_f32|``, (a) ``max|port_bf16 -
  jax_f32| <= 2 e + 1e-3 max|jax_f32|`` (as near the float32 result as JAX's
  bfloat16 is, within a factor 2) and (b) ``max|port_bf16 - jax_bf16| <= 2 e
  + 1e-3 max|jax_f32|`` (as near JAX's bfloat16 result); the output dtypes
  are JAX's.
- Fresh weights (``models/common.py::init_weights``): the mask head's
  transposed conv draws flax's ``xavier_normal`` (a normal truncated at two
  standard deviations, variance 2 / (fan_in + fan_out)); ``DEV.UPSAMPLE_INIT
  identity`` gives the Dev conv JAX's ``_identity_conv_init`` kernel exactly;
  an unknown ``UPSAMPLE_INIT`` raises ``ValueError`` in both packages.
"""

import test_torch_workers  # noqa: F401  (first: sizes this xdist worker's thread pools)

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

import feature_intertwiner_tpu.ops.roi_align as jax_ra
from feature_intertwiner_tpu.models.fpn import FPN as JFPN
from feature_intertwiner_tpu.models.heads import BoxHead as JBoxHead
from feature_intertwiner_tpu.models.heads import MaskHead as JMaskHead
from feature_intertwiner_tpu.models.intertwiner import Critic as JCritic
from feature_intertwiner_tpu.models.intertwiner import UpsampleBlock as JUpsampleBlock
from feature_intertwiner_tpu.models.intertwiner import _identity_conv_init
from feature_intertwiner_tpu.models.resnet import ResNet as JResNet
from feature_intertwiner_tpu.models.rpn import RPNHead as JRPNHead
from feature_intertwiner_tpu.ops.roi_align_window import (hybrid_unfit_overflow,
                                                          multilevel_crop_and_resize_window,
                                                          window_origins_and_fits)
from feature_intertwiner_tpu.ops.roi_align_window_bwd import bwd_kernel_supported
from feature_intertwiner_tpu_torch.config import FLAGSHIP_OVERRIDES, build_config
from feature_intertwiner_tpu_torch.models.common import TRUNC_STD, init_weights
from feature_intertwiner_tpu_torch.models.detector import InterNet
from feature_intertwiner_tpu_torch.models.fpn import FPN
from feature_intertwiner_tpu_torch.models.heads import BoxHead, MaskHead
from feature_intertwiner_tpu_torch.models.intertwiner import Critic, UpsampleBlock
from feature_intertwiner_tpu_torch.models.resnet import ResNet
from feature_intertwiner_tpu_torch.models.rpn import RPNHead
from feature_intertwiner_tpu_torch.ops import roi_align as ra
from feature_intertwiner_tpu_torch.utils.convert_weights import from_jax_params
from test_torch_model import KEY, _redraw, init_pair, nhwc

T = torch.from_numpy
BF16 = jnp.bfloat16


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def assert_one_rounding(got, want):
    """Within one bfloat16 rounding of ``want`` (see the module docstring)."""
    got, want = f32(got), f32(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    tol = 2.0 ** -7 * np.abs(want) + 1e-5 * np.abs(want).max()
    assert (np.abs(got - want) <= tol).all(), float(np.abs(got - want).max())


def bf16_pyramid(rng, b=2, c=8, sizes=(64, 32, 16, 8)):
    """bfloat16 maps (as numpy float32 holding bfloat16 values)."""
    return [f32(T(rng.randn(b, s, s, c).astype(np.float32)).bfloat16()) for s in sizes]


# --- C.1: the RoIAlign kernels' bfloat16 entry ------------------------------------------
def _window_case(seed):
    """A 256² image's P2-P5 in bfloat16 and 48 boxes the JAX window kernel
    holds exactly (none past its fallback budget)."""
    rng = np.random.RandomState(seed)
    feats = bf16_pyramid(rng)
    yx = rng.rand(48, 2) * 0.7
    bx = np.concatenate([yx, yx + rng.rand(48, 2) * 0.25 + 0.02], 1).astype(np.float32)
    bidx = rng.randint(0, 2, 48).astype(np.int32)
    return rng, feats, bx, bidx


def test_bf16_roi_align_matches_jax_window_kernel():
    """K1's bfloat16 entry against the JAX main path's pooling on bfloat16
    maps: the window kernel (interpret mode), which adds in float32 and
    writes the maps' dtype."""
    rng, feats, bx, bidx = _window_case(40)
    jf = [jnp.asarray(f, BF16) for f in feats]
    lvl = jax_ra.assign_fpn_level(jnp.asarray(bx), (256, 256)) - 2
    assert int(hybrid_unfit_overflow(jf, jnp.asarray(bx), lvl, (7, 7))) == 0
    pf = [T(f).bfloat16() for f in feats]
    for crop in (7, 14):
        want = multilevel_crop_and_resize_window(
            jf, jnp.asarray(bx), jnp.asarray(bidx), (crop, crop), (256, 256), interpret=True)
        got = ra.multilevel_crop_and_resize(pf, T(bx), T(bidx), (crop, crop), (256, 256))
        assert want.dtype == BF16 and got.dtype == torch.bfloat16
        assert_one_rounding(got, want)
        # the float32 pooling of the widened maps, rounded once
        wide = ra.multilevel_crop_and_resize([f.float() for f in pf], T(bx), T(bidx),
                                             (crop, crop), (256, 256))
        assert torch.equal(got, wide.bfloat16())


def test_bf16_roi_align_gradient_matches_jax_vjp():
    """K3's bfloat16 entry (through ``RoIAlign``'s backward) against the VJP
    of the JAX window pooling on bfloat16 maps, on a pyramid whose levels
    its backward kernel tiles (interpret mode) and boxes its window holds:
    g taken to float32, each level's gradient cast back to bfloat16. (Where
    that kernel cannot run, JAX transposes its bfloat16 gather and adds in
    bfloat16, several roundings.)"""
    rng = np.random.RandomState(41)
    feats = bf16_pyramid(rng, sizes=(256, 128, 64, 32))
    side = rng.rand(64, 1) * 0.4 + 0.01
    yx = rng.rand(64, 2) * (1 - side)
    bx = np.concatenate([yx, yx + side], 1).astype(np.float32)
    bidx = rng.randint(0, 2, 64).astype(np.int32)
    jf = tuple(jnp.asarray(f, BF16) for f in feats)
    lvl = jax_ra.assign_fpn_level(jnp.asarray(bx), (1024, 1024)) - 2
    heights = jnp.array([f.shape[1] for f in feats], jnp.int32)
    _, _, fits = window_origins_and_fits(jnp.asarray(bx), lvl, heights, heights, (14, 14),
                                         (32, 40))
    assert bool(fits.all()) and len(set(np.asarray(lvl).tolist())) >= 3
    assert bwd_kernel_supported([f.shape for f in feats], (32, 40))
    for crop in (7, 14):
        g = f32(T(rng.randn(64, crop, crop, 8).astype(np.float32)).bfloat16())
        _, vjp = jax.vjp(lambda fs, c=crop: multilevel_crop_and_resize_window(
            list(fs), jnp.asarray(bx), jnp.asarray(bidx), (c, c), (1024, 1024),
            interpret=True), jf)
        (want,) = vjp(jnp.asarray(g, BF16))
        leaves = [T(f).bfloat16().requires_grad_() for f in feats]
        out = ra.multilevel_crop_and_resize(leaves, T(bx), T(bidx), (crop, crop), (1024, 1024))
        got = torch.autograd.grad(out, leaves, T(g).bfloat16())
        for d, w in zip(got, want):
            assert w.dtype == BF16 and d.dtype == torch.bfloat16
            assert_one_rounding(d, w)


@pytest.mark.parametrize("crop", [(1, 1), (7, 7), (5, 9)])
def test_bf16_grouped_crops_match_pallas_kernels(crop):
    """K4 (extrapolation 0 and -1.5) and K5 on a bfloat16 image against
    ``crop_and_resize_pallas(_mm)`` in interpret mode, whose crops come in
    the image's dtype; out-of-range, inverted and degenerate boxes."""
    from test_torch_roi_single import _grouped_boxes

    rng = np.random.RandomState(42)
    image = f32(T(rng.randn(2, 16, 20, 8).astype(np.float32)).bfloat16())
    boxes = _grouped_boxes(rng, 2, 8)
    ji, pi = jnp.asarray(image, BF16), T(image).bfloat16()
    for extrap in (0.0, -1.5):
        want = jax_ra.crop_and_resize_pallas(ji, jnp.asarray(boxes), crop, extrap, box_tile=4,
                                             channel_tile=8, interpret=True)
        got = ra.crop_and_resize_grouped(pi, T(boxes), crop, extrap)
        assert want.dtype == BF16 and got.dtype == torch.bfloat16
        assert_one_rounding(got, want)
    want = jax_ra.crop_and_resize_pallas_mm(ji, jnp.asarray(boxes), crop, box_tile=4,
                                            channel_tile=8, interpret=True)
    got = ra.crop_and_resize_grouped_mm(pi, T(boxes), crop)
    assert want.dtype == BF16 and got.dtype == torch.bfloat16
    assert_one_rounding(got, want)


def test_bf16_fused_crop_gradient_is_the_rounded_float32_gradient():
    """``crop_and_resize_fused`` on a bfloat16 image: crops and gradient in
    bfloat16, each the float32 result on the widened image rounded once."""
    from test_torch_roi_single import _grouped_boxes

    rng = np.random.RandomState(43)
    image = T(rng.randn(2, 16, 20, 8).astype(np.float32)).bfloat16()
    boxes = T(_grouped_boxes(rng, 2, 8))
    g = T(rng.randn(2, 8, 7, 7, 8).astype(np.float32)).bfloat16()
    outs = []
    for img in (image, image.float()):
        leaf = img.clone().requires_grad_()
        crops = ra.crop_and_resize_fused(leaf, boxes, (7, 7))
        (d,) = torch.autograd.grad(crops, leaf, g.to(img.dtype))
        outs.append((crops, d))
    (c16, d16), (c32, d32) = outs
    assert c16.dtype == d16.dtype == torch.bfloat16
    assert torch.equal(c16, c32.bfloat16()) and torch.equal(d16, d32.bfloat16())


def test_bf16_entry_refuses_other_dtypes():
    f = [torch.zeros(1, 8, 8, 4, dtype=torch.float16)]
    idx = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(TypeError):
        ra.roi_align_fwd(f, torch.zeros(3, 4), idx, idx, (7, 7))
    with pytest.raises(TypeError):       # levels of two dtypes
        ra.roi_align_fwd([torch.zeros(1, 8, 8, 4), torch.zeros(1, 4, 4, 4).bfloat16()],
                         torch.zeros(3, 4), idx, idx, (7, 7))
    with pytest.raises(ValueError):
        ra.roi_align_bwd(torch.zeros(3, 7, 7, 4, dtype=torch.float64), [(1, 8, 8, 4)],
                         torch.zeros(3, 4), idx, idx, (7, 7))
    for fn in (ra.crop_and_resize_grouped, ra.crop_and_resize_grouped_mm):
        with pytest.raises(TypeError):
            fn(torch.zeros(1, 8, 8, 4, dtype=torch.float16), torch.zeros(1, 2, 4), (3, 3))


# --- A1: the modules in bfloat16 against their flax twins ---------------------------------
def assert_bf16_module(got, j32, j16):
    """Conditions (a) and (b) of the module docstring, and JAX's dtype."""
    assert str(got.dtype).split(".")[-1] == str(j16.dtype), (got.dtype, j16.dtype)
    got, j32, j16 = f32(got), f32(j32), f32(j16)
    assert got.shape == j32.shape, (got.shape, j32.shape)
    scale = np.abs(j32).max()
    own = np.abs(j16 - j32).max()
    assert own > 0                      # JAX really ran in bfloat16
    floor = 1e-3 * scale
    assert np.abs(got - j32).max() <= 2 * own + floor, (np.abs(got - j32).max(), own, scale)
    assert np.abs(got - j16).max() <= 2 * own + floor, (np.abs(got - j16).max(), own, scale)


@pytest.fixture(scope="module")
def backbone16():
    x = np.random.RandomState(0).randn(2, 64, 64, 3).astype(np.float32) * 30
    jm, pm = JResNet("resnet50"), ResNet("resnet50")
    v = init_pair(jm, pm, (jnp.asarray(x),), lambda t: {"backbone": t}, "fpn.")
    return x, pm, v


def test_resnet50_in_bf16_matches_flax(backbone16):
    x, pm, v = backbone16
    j32 = JResNet("resnet50").apply(v, jnp.asarray(x))
    j16 = JResNet("resnet50", dtype=BF16).apply(v, jnp.asarray(x))
    with torch.inference_mode():
        got = pm(T(x).bfloat16().permute(0, 3, 1, 2))
    for g, a, b in zip(got, j32, j16):
        assert_bf16_module(nhwc(g), a, b)


def test_fpn_in_bf16_matches_flax(backbone16):
    x, pres, rv = backbone16
    cs16 = JResNet("resnet50", dtype=BF16).apply(rv, jnp.asarray(x))
    fv = JFPN(256).init(KEY, *cs16)
    params = {"backbone": rv["params"], "fpn": _redraw(fv["params"], np.random.RandomState(1))}
    pm = FPN(pres, 256)
    sd = from_jax_params(params, {"backbone": rv["batch_stats"]})
    pm.load_state_dict({k[len("fpn."):]: v for k, v in sd.items()}, strict=True)
    pm.eval()
    j32, _ = JFPN(256).apply({"params": params["fpn"]}, *cs16)
    j16, _ = JFPN(256, dtype=BF16).apply({"params": params["fpn"]}, *cs16)
    with torch.inference_mode():
        got = pm.top_down(*[T(f32(c)).bfloat16().permute(0, 3, 1, 2) for c in cs16])
    for g, a, b in zip(got, j32, j16):
        assert_bf16_module(nhwc(g), a, b)


def _module_case(name):
    """(flax class, its keyword arguments, port module, input shape, wrap,
    strip, NCHW input) of one head."""
    return {
        "rpn": (JRPNHead, dict(anchors_per_location=3, anchor_stride=1), RPNHead(3, 1, 256),
                (2, 8, 8, 256), lambda t: {"rpn": t}, "rpn.", True),
        "box": (JBoxHead, dict(num_classes=8, pool_size=7), BoxHead(8, 7, 256), (6, 7, 7, 256),
                lambda t: {"classifier": t}, "classifier.", False),
        "mask": (JMaskHead, dict(num_classes=8), MaskHead(8, 256), (3, 14, 14, 256),
                 lambda t: {"mask": t}, "mask.", False),
        "upsample": (JUpsampleBlock, dict(channels=256, factor=1.0), UpsampleBlock(256, 1.0),
                     (2, 16, 16, 256), lambda t: {"dev": {"upsample0": t}},
                     "dev_roi.upsample.0.", True),
        "critic": (JCritic, dict(feat_pool_size=14), Critic(256, 14), (4, 14, 14, 256),
                   lambda t: {"dev": {"critic": t}}, "dev_roi.feat_extract.", False),
    }[name]


@pytest.mark.parametrize("name", ["rpn", "box", "mask", "upsample", "critic"])
def test_head_in_bf16_matches_flax(name):
    """RPN (logits and deltas bfloat16, probabilities float32), box head
    (float32 logits, probabilities, deltas and feature), mask head (float32
    sigmoid), the Dev make-up block and the critic (bfloat16)."""
    jcls, kwargs, pm, shape, wrap, strip, nchw = _module_case(name)
    seed = ["rpn", "box", "mask", "upsample", "critic"].index(name) + 2
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    v = init_pair(jcls(**kwargs), pm, (jnp.asarray(x),), wrap, strip)
    j32 = jcls(**kwargs).apply(v, jnp.asarray(x))
    j16 = jcls(**kwargs, dtype=BF16).apply(v, jnp.asarray(x))
    xt = T(x).bfloat16()
    with torch.inference_mode():
        got = pm(xt.permute(0, 3, 1, 2) if nchw else xt)
    if not isinstance(got, tuple):
        got, j32, j16 = (got,), (j32,), (j16,)
    for g, a, b in zip(got, j32, j16):
        assert_bf16_module(nhwc(g) if nchw and g.dim() == 4 else g, a, b)
    assert all(p.dtype == torch.float32 for p in pm.parameters())
    assert all(b.dtype == torch.float32 for b in pm.buffers() if b.is_floating_point())


# --- C.3: fresh weights as the JAX package draws them ------------------------------------
def _moments(w: np.ndarray):
    w = w.astype(np.float64).ravel()
    var = (w ** 2).mean()
    return var, (w ** 4).mean() / var ** 2


def test_mask_deconv_draws_a_truncated_normal():
    """The mask head's 2x2 transposed conv: variance 2 / (fan_in + fan_out),
    the fourth moment of a normal cut at two standard deviations (2.3786;
    a uniform's is 1.8, a normal's 3), no draw past the cut; as flax's
    ``xavier_normal`` draws the same shape."""
    head = MaskHead(8, 256)
    init_weights(head, torch.Generator().manual_seed(0))
    w = head.deconv.weight.detach().numpy()
    fans = (256 + 256) * 4
    # the truncated standard normal's moments, by quadrature on [-2, 2]
    z = np.linspace(-2, 2, 200001)
    pdf = np.exp(-z * z / 2)
    m2, m4 = (z ** 2 * pdf).sum() / pdf.sum(), (z ** 4 * pdf).sum() / pdf.sum()
    assert abs(m2 - TRUNC_STD ** 2) < 1e-5
    var, kurt = _moments(w)
    jw = np.asarray(fnn.initializers.xavier_normal()(KEY, (2, 2, 256, 256)))
    jvar, jkurt = _moments(jw)
    for v, k in ((var, kurt), (jvar, jkurt)):
        assert abs(v / (2.0 / fans) - 1) < 0.01           # 262,144 draws: 0.3% sampling error
        assert abs(k - m4 / m2 ** 2) < 0.03               # 0.4% sampling error
    std = math.sqrt(2.0 / fans) / TRUNC_STD
    assert np.abs(w).max() <= 2 * std * (1 + 1e-6)
    assert np.abs(w).max() > 1.99 * std                   # the cut is reached, not narrower
    # the convs stay Xavier-uniform: a uniform's fourth moment
    assert abs(_moments(head.conv1.weight.detach().numpy())[1] - 1.8) < 0.03


def test_upsample_identity_init_is_the_jax_delta_kernel():
    """``DEV.UPSAMPLE_INIT identity`` through ``InterNet.from_config`` and
    ``init_weights``: the Dev conv is JAX's ``_identity_conv_init`` kernel
    (in the port's [out, in, kh, kw] layout) and its bias zero; ``xavier``
    draws it."""
    opts = list(FLAGSHIP_OVERRIDES) + ["MODEL.BACKBONE", "resnet50", "DATASET.NUM_CLASSES", "4"]
    model = InterNet.from_config(build_config(opts=opts + ["DEV.UPSAMPLE_INIT", "identity"]))
    init_weights(model, torch.Generator().manual_seed(0))
    conv = model.dev_roi.upsample[0][0]
    want = np.asarray(_identity_conv_init(KEY, (3, 3, 256, 256), jnp.float32))
    assert torch.equal(conv.weight, T(want.transpose(3, 2, 0, 1).copy()))
    assert not conv.bias.any()
    # the block starts as relu(x), up to BN's eps 1e-5 over a unit variance
    x = torch.randn(1, 256, 6, 6)
    with torch.no_grad():
        y = model.dev_roi.upsample[0].eval()(x)
    assert torch.allclose(y, torch.relu(x) / math.sqrt(1 + 1e-5), rtol=1e-6, atol=1e-6)
    xavier = InterNet.from_config(build_config(opts=opts))
    init_weights(xavier, torch.Generator().manual_seed(0))
    assert _moments(xavier.dev_roi.upsample[0][0].weight.detach().numpy())[1] < 2.0


def test_unknown_upsample_init_raises_as_in_jax():
    opts = list(FLAGSHIP_OVERRIDES) + ["DEV.UPSAMPLE_INIT", "bilinear"]
    with pytest.raises(ValueError, match="UPSAMPLE_INIT"):
        InterNet.from_config(build_config(opts=opts))
    with pytest.raises(ValueError, match="UPSAMPLE_INIT"):
        JUpsampleBlock(8, 1.0, init_mode="bilinear").init(KEY, jnp.zeros((1, 4, 4, 8)))
