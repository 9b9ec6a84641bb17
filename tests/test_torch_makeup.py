"""The Dev make-up layer at ``UPSAMPLE_FAC`` 2 with its variants, and
``CLS_MERGE_FEAT``, module by module: the port against the JAX package on
the CPU.

- ``UpsampleBlock`` against its flax twin at factor 1 and 2, ``xavier`` and
  ``identity``, with and without the residual (its gate redrawn, so that it
  weighs), in float32 and bfloat16; the residual's base, torch's bilinear
  2x upsample, against ``jax.image.resize``.
- Fresh weights (``init_weights``): ``identity`` gives JAX's delta and
  bilinear kernels exactly, the gate starts at zero, ``xavier`` draws the
  transposed conv from flax's truncated normal.
- ``BoxHead`` with ``simple_add`` and ``linear_add`` against flax, in
  float32 and bfloat16, the merge gate zero on some rows.
- ``Dev`` at inference (the two poolings, ``small_out``, ``small_gt``) and
  in training (every statistic) against flax, for the three
  configurations of :data:`CONFIGS`.
- Weights: ``from_jax_params`` of each configuration's JAX tree loads with
  ``strict=True``; the JAX converter of reference checkpoints reads the
  port's ``state_dict`` back into the same trees at ``upsample_fac=2.0``.
  The reference has no ``gate``, so that converter cannot carry it: the
  gate is checked on its own. The stage and weight-decay sets equal JAX's
  masks name for name.

Tolerances (ROADMAP): float32 within 1e-4 relative to the largest
magnitude (``test_torch_model.assert_rel``), the bilinear upsample within
float32 rounding (1e-6); bfloat16 within twice JAX's own bfloat16 error
(``test_torch_bf16.assert_bf16_module``).
"""

import test_torch_workers  # noqa: F401  (first: sizes this xdist worker's thread pools)

import math
from collections.abc import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from feature_intertwiner_tpu.models.heads import BoxHead as JBoxHead
from feature_intertwiner_tpu.models.intertwiner import Dev as JDev
from feature_intertwiner_tpu.models.intertwiner import UpsampleBlock as JUpsampleBlock
from feature_intertwiner_tpu.models.intertwiner import (_bilinear_deconv_init,
                                                        _identity_conv_init)
from feature_intertwiner_tpu.ops import roi_align as jroi
from feature_intertwiner_tpu.train import optim as joptim
from feature_intertwiner_tpu.utils.convert_weights import convert_reference_state_dict
from feature_intertwiner_tpu_torch.models.common import TRUNC_STD, init_weights
from feature_intertwiner_tpu_torch.models.detector import InterNet
from feature_intertwiner_tpu_torch.models.heads import BoxHead
from feature_intertwiner_tpu_torch.models.intertwiner import Dev, UpsampleBlock
from feature_intertwiner_tpu_torch.train import optim
from feature_intertwiner_tpu_torch.utils.convert_weights import from_jax_params
from test_torch_bf16 import _moments, assert_bf16_module
from test_torch_model import KEY, TINY, JInterNet, assert_rel, init_pair, nhwc
from test_torch_ot import _flat, _random_tree

T = torch.from_numpy
BF16 = jnp.bfloat16
# The slice's three configurations (InterNet keywords of both packages):
# the make-up layer at factor 2 with the merge (simple_add); one block per
# level, the gated residual from the identity init and linear_add; no
# make-up layer, the merge on the raw levels
CONFIGS = {
    "up2_merge": dict(dev_upsample_fac=2.0, cls_merge_feat=True),
    "multi_residual": dict(dev_upsample_fac=2.0, dev_multi_upsampler=True,
                           dev_upsample_residual=True, dev_upsample_init="identity",
                           cls_merge_feat=True, cls_merge_manner="linear_add",
                           cls_merge_fac=0.3),
    "dis_merge": dict(dev_upsample_fac=1.0, dev_dis_upsampler=True, cls_merge_feat=True),
}
# the same as Dev keywords (the merge is the classifier's)
DEV_KW = {name: {k[4:]: v for k, v in kw.items() if k.startswith("dev_")}
          for name, kw in CONFIGS.items()}


def _gated(tree, rng):
    """Redraw the gate leaves of a flax tree in [0, 1), so that the
    residual weighs in the comparison."""
    for name, sub in tree.items():
        if name == "gate":
            tree[name] = rng.uniform(0.0, 1.0, np.shape(sub)).astype(np.float32)
        elif isinstance(sub, Mapping):
            _gated(sub, rng)


def _load_gates(port, v, prefix):
    """Copy the redrawn gates of ``v`` into ``port`` (``prefix`` the port
    name of the flax tree's root)."""
    sd = from_jax_params(v["params"], {})
    gates = {k[len(prefix):]: t for k, t in sd.items() if k.endswith("gate")}
    port.load_state_dict(gates, strict=False)


# --- the make-up block -------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("residual", [False, True], ids=["plain", "residual"])
@pytest.mark.parametrize("init", ["xavier", "identity"])
@pytest.mark.parametrize("factor", [1.0, 2.0])
def test_upsample_block_matches_flax(factor, init, residual, dtype):
    """On a 7x9 map (the transposed conv's SAME cut on odd sides too). In
    bfloat16 all three take the map rounded to bfloat16, and JAX's
    bfloat16 block takes it in bfloat16, as the FPN gives it: at factor 1
    the residual's base is the input itself."""
    x = np.random.RandomState(5).randn(2, 7, 9, 32).astype(np.float32)
    if dtype == "bfloat16":
        x = T(x).bfloat16().float().numpy()
    jm = JUpsampleBlock(32, factor, init_mode=init, residual=residual)
    pm = UpsampleBlock(32, factor, init, residual)
    wrap, strip = (lambda t: {"dev": {"upsample0": t}}), "dev_roi.upsample.0."
    v = init_pair(jm, pm, (jnp.asarray(x),), wrap, strip)
    if residual:
        _gated(v["params"], np.random.RandomState(6))
        _load_gates(pm, {"params": wrap(v["params"])}, strip)
    j32 = jm.apply(v, jnp.asarray(x))
    xt = T(x).permute(0, 3, 1, 2)
    with torch.inference_mode():
        if dtype == "float32":
            got = nhwc(pm(xt))
            assert got.shape == (2, 7 * int(factor), 9 * int(factor), 32)
            assert_rel(got, j32)
        else:
            j16 = JUpsampleBlock(32, factor, init_mode=init, residual=residual,
                                 dtype=BF16).apply(v, jnp.asarray(x, BF16))
            assert_bf16_module(nhwc(pm(xt.bfloat16())), j32, j16)
    assert all(p.dtype == torch.float32 for p in pm.parameters())


def test_bilinear_upsample_matches_jax_image_resize():
    """The residual's base at factor 2: ``F.interpolate`` (bilinear,
    ``align_corners=False``) against ``jax.image.resize`` on maps of 8²,
    7x13, 64² and 256², edge rows and columns included."""
    rng = np.random.RandomState(7)
    for h, w in ((8, 8), (7, 13), (64, 64), (256, 256)):
        x = rng.randn(1, h, w, 4).astype(np.float32)
        want = jax.image.resize(jnp.asarray(x), (1, 2 * h, 2 * w, 4), method="bilinear")
        got = torch.nn.functional.interpolate(T(x).permute(0, 3, 1, 2), scale_factor=2,
                                              mode="bilinear", align_corners=False)
        np.testing.assert_allclose(nhwc(got).numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_make_up_layer_initialises_as_jax_does():
    """``identity``: the conv is JAX's ``_identity_conv_init`` kernel and the
    transposed conv its ``_bilinear_deconv_init`` kernel (spatially
    symmetric, so the flip the port holds leaves it as it is), biases zero,
    the gate zero: the residual block starts as its base exactly. ``xavier``
    at factor 2: flax's ``xavier_normal`` on [3, 3, I, O], variance 2 /
    (9 I + 9 O), a normal cut at two standard deviations."""
    for factor, jax_init in ((1.0, _identity_conv_init), (2.0, _bilinear_deconv_init)):
        block = UpsampleBlock(64, factor, "identity", residual=True)
        block.gate.data.fill_(0.5)
        init_weights(block, torch.Generator().manual_seed(0))
        w = block[0].weight.detach()
        want = np.asarray(jax_init(KEY, (3, 3, 64, 64), jnp.float32))
        layout = (2, 3, 0, 1) if factor == 2.0 else (3, 2, 0, 1)
        assert torch.equal(w, T(want.transpose(layout).copy()))
        assert torch.equal(w, w.flip(2, 3)) and not block[0].bias.any()
        assert not block.gate.any()
        x = torch.randn(1, 64, 5, 6)
        with torch.no_grad():
            y = block.eval()(x)
        base = x if factor == 1.0 else torch.nn.functional.interpolate(
            x, scale_factor=2, mode="bilinear", align_corners=False)
        assert torch.equal(y, base)
    block = UpsampleBlock(256, 2.0)
    init_weights(block, torch.Generator().manual_seed(0))
    w = block[0].weight.detach().numpy()
    fans = 9 * (256 + 256)
    var, kurt = _moments(w)
    jvar, jkurt = _moments(np.asarray(fnn.initializers.xavier_normal()(KEY, (3, 3, 256, 256))))
    for v, k in ((var, kurt), (jvar, jkurt)):
        assert abs(v / (2.0 / fans) - 1) < 0.01           # 589,824 draws
        assert abs(k - 2.3786) < 0.03                     # the cut normal's fourth moment
    assert np.abs(w).max() <= 2 * math.sqrt(2.0 / fans) / TRUNC_STD * (1 + 1e-6)


def test_unknown_upsample_factor_raises_as_in_jax():
    with pytest.raises(ValueError, match="UPSAMPLE_FAC"):
        UpsampleBlock(8, 3.0)
    with pytest.raises(ValueError, match="UPSAMPLE_FAC"):
        JUpsampleBlock(8, 3.0).init(KEY, jnp.zeros((1, 4, 4, 8)))


# --- the classifier's merge ---------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("manner", ["simple_add", "linear_add"])
def test_box_head_merge_matches_flax(manner, dtype):
    """The critic's vectors (float32, in [0, 1) as after a sigmoid) join
    ``fc1``'s feature where ``small_gt`` is positive; rows 0, 3 and 5 have
    it zero (a negative RoI in training, a level-5 RoI at inference)."""
    rng = np.random.RandomState(8)
    x = rng.randn(6, 7, 7, 64).astype(np.float32)
    small = rng.rand(6, 1024).astype(np.float32)
    small_gt = np.array([0, 3, 1, 0, 7, 0], np.float32)
    kw = dict(merge_feat=True, merge_manner=manner, merge_fac=0.3)
    jm, pm = JBoxHead(8, 7, **kw), BoxHead(8, 7, 64, **kw)
    args = (jnp.asarray(x), jnp.asarray(small), jnp.asarray(small_gt))
    v = init_pair(jm, pm, args, lambda t: {"classifier": t}, "classifier.")
    j32 = jm.apply(v, *args)
    plain = jm.apply(v, jnp.asarray(x))
    with torch.inference_mode():
        if dtype == "float32":
            got = pm(T(x), T(small), T(small_gt))
            for g, w in zip(got, j32):
                assert_rel(g, w)
        else:
            j16 = JBoxHead(8, 7, **kw, dtype=BF16).apply(v, *args)
            got = pm(T(x).bfloat16(), T(small), T(small_gt))
            for g, a, b in zip(got, j32, j16):
                assert_bf16_module(g, a, b)
    # the gated rows are the plain head's; the others moved
    feat, plain_feat = np.asarray(j32[3]), np.asarray(plain[3])
    off = small_gt == 0
    np.testing.assert_array_equal(feat[off], plain_feat[off])
    assert (np.abs(feat[~off] - plain_feat[~off]).max(1) > 0).all()


def test_unknown_merge_manner_raises_as_in_jax():
    with pytest.raises(ValueError, match="concat"):
        BoxHead(8, 7, 64, merge_feat=True, merge_manner="concat")
    x = jnp.zeros((2, 7, 7, 8))
    with pytest.raises(ValueError, match="concat"):
        JBoxHead(8, 7, merge_feat=True, merge_manner="concat").init(
            KEY, x, jnp.zeros((2, 1024)), jnp.ones((2,)))


# --- Dev ----------------------------------------------------------------------------------
def _dev_case(name, seed):
    """Levels 2 to 5 all occur (image_size 1024 over 32² to 4² maps); the
    flax Dev initialised in train mode (every branch), redrawn, gates too,
    and its port loaded."""
    rng = np.random.RandomState(seed)
    feats = [rng.randn(2, s, s, 32).astype(np.float32) for s in (32, 16, 8, 4)]
    side = np.exp(rng.uniform(np.log(0.02), np.log(0.5), (2, 24, 1)))
    y1x1 = rng.uniform(0, 1, (2, 24, 2)) * (1 - side)
    rois = np.concatenate([y1x1, y1x1 + side], -1).astype(np.float32)
    roi_gt = rng.randint(0, 4, (2, 24)).astype(np.int32)
    kw = dict(DEV_KW[name], num_classes=8, image_size=1024, loss_choice="l2")
    jm = JDev(**kw)
    pm = Dev(32, **kw)
    jf = [jnp.asarray(f) for f in feats]
    v = init_pair(jm, pm, (jf, jnp.asarray(rois)), lambda t: {"dev": t}, "dev_roi.",
                  roi_gt=jnp.asarray(roi_gt), train=True)
    _gated(v["params"], rng)
    _load_gates(pm, {"params": {"dev": v["params"]}}, "dev_roi.")
    lvl = np.asarray(jroi.assign_fpn_level(jnp.asarray(rois.reshape(-1, 4)), (1024, 1024)))
    assert set(lvl) == {2, 3, 4, 5}
    return jm, pm, v, jf, feats, rois, roi_gt


@pytest.mark.parametrize("name", list(CONFIGS))
def test_dev_at_inference_matches_flax(name):
    """The classifier's 7² and the critic's 14² pooling of every RoI from
    the make-up maps, and the critic's ``small_out`` (zero off meta levels)
    and ``small_gt`` (1.0 on them)."""
    jm, pm, v, jf, feats, rois, _ = _dev_case(name, 9)
    want_cls, want_mask, want = jm.apply(v, jf, jnp.asarray(rois))
    with torch.inference_mode():
        maps = pm.pooling_maps([T(f).permute(0, 3, 1, 2) for f in feats])
        fac = 1 if name == "dis_merge" else 2
        assert [m.shape[1] for m in maps] == [fac * f.shape[1] for f in feats]
        got_cls = pm.pool(maps, T(rois), 7)
        got_mask = pm.pool(maps, T(rois), 14)
        small_out, small_gt = pm.small_features(got_mask, T(rois))
    assert_rel(got_cls, want_cls)
    assert_rel(got_mask, want_mask)
    assert_rel(small_out, want["small_out"])
    np.testing.assert_array_equal(small_gt.numpy(), np.asarray(want["small_gt"]))
    assert 0 < float(small_gt.sum()) < small_gt.numel()


@pytest.mark.parametrize("name", list(CONFIGS))
def test_dev_in_train_mode_matches_flax(name):
    jm, pm, v, jf, feats, rois, roi_gt = _dev_case(name, 10)
    want_cls, want_mask, want = jm.apply(v, jf, jnp.asarray(rois), roi_gt=jnp.asarray(roi_gt),
                                         train=True)
    got_cls, got_mask, got = pm.forward_train([T(f).permute(0, 3, 1, 2) for f in feats],
                                              T(rois), T(roi_gt))
    assert_rel(got_cls, want_cls)
    assert_rel(got_mask, want_mask)
    for key in ("big_feat", "big_cnt", "small_feat", "small_cnt", "small_out", "small_gt",
                "big_loss"):
        assert_rel(got[key], want[key])
    assert float(got["small_cnt"].sum()) > 0
    # the classifier's input keeps its gradient into the critic and the
    # make-up layer of the meta levels (2-4; P5's block feeds no small_out)
    got["small_out"].sum().backward()
    assert pm.feat_extract[0].weight.grad.abs().max() > 0
    if pm.upsample is not None:
        assert all(b[0].weight.grad.abs().max() > 0 for b in pm.upsample[:3])


# --- weights and stage sets ---------------------------------------------------------------
@pytest.fixture(scope="module", params=list(CONFIGS))
def config_models(request):
    """The parameter and BN statistic trees of a tiny JAX InterNet of one
    configuration (shapes from ``jax.eval_shape`` of its train-mode init,
    values random), and the port model loaded from them (strict)."""
    name = request.param
    kw = dict(TINY, **CONFIGS[name], post_nms_train=64, rois_per_image=24,
              dev_loss_choice="l2")
    jm = JInterNet(**kw)
    zeros = {"gt_class_ids": jnp.zeros((1, 6), jnp.int32), "gt_boxes": jnp.zeros((1, 6, 4)),
             "gt_masks": jnp.zeros((1, 6, 14, 14))}
    shapes = jax.eval_shape(lambda: jm.init({"params": KEY, "sampling": KEY},
                                            jnp.zeros((1, 128, 128, 3)), mode="train", **zeros))
    rng = np.random.RandomState(11)
    v = {"params": _random_tree(shapes["params"], rng),
         "batch_stats": _random_tree(shapes["batch_stats"], rng)}
    pm = InterNet(**kw)
    pm.load_state_dict(from_jax_params(v["params"], v["batch_stats"]), strict=True)
    return name, v, pm


def test_weights_round_trip_through_reference_names(config_models):
    """The JAX converter of reference checkpoints (strict, at the
    configuration's factor) reads the port's ``state_dict`` back into the
    same trees; the gate, which the reference does not have, is left out of
    that round trip and held on its own."""
    name, v, pm = config_models
    sd = {k: t.numpy() for k, t in pm.state_dict().items()}
    gates = {k: sd.pop(k) for k in [k for k in sd if k.endswith(".gate")]}
    blocks = {"up2_merge": 1, "multi_residual": 4, "dis_merge": 0}[name]
    assert sum(k.endswith("upsample.%d.0.weight" % m) for k in sd for m in range(4)) == blocks
    params, stats = convert_reference_state_dict(
        sd, arch="resnet50", upsample_fac=CONFIGS[name]["dev_upsample_fac"], strict=True)
    want_params = _flat(v["params"])
    want_gates = {k: want_params.pop(k) for k in [k for k in want_params if k[-1] == "gate"]}
    for got, want in ((_flat(params), want_params), (_flat(stats), _flat(v["batch_stats"]))):
        assert got.keys() == want.keys()
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg="/".join(key))
    assert len(gates) == len(want_gates) == (4 if name == "multi_residual" else 0)
    for key, gate in want_gates.items():
        np.testing.assert_array_equal(gates[f"dev_roi.upsample.{key[1][-1]}.gate"], gate)


@pytest.mark.parametrize("layers", ["heads", "4+", "all"])
def test_stage_and_decay_sets_match_jax(config_models, layers):
    """``flax_paths`` names every JAX parameter (the deconvolution and the
    gate included); the trainable and weight-decay sets equal the JAX
    masks."""
    _, v, pm = config_models
    paths = optim.flax_paths(pm)
    flat = {"/".join(k) for k in _flat(v["params"])}
    assert sorted(paths.values()) == sorted(flat)
    want = {"/".join(p) for p, m in _flat(joptim.trainable_mask(v["params"], layers)).items()
            if m}
    assert {paths[n] for n in optim.trainable_names(pm, layers)} == want
    decay = {"/".join(p) for p, m in _flat(joptim.bn_mask(v["params"])).items() if m}
    assert {paths[n] for n in optim.decay_names(pm)} == decay
