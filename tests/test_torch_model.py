"""The PyTorch port's modules and inference slice against the JAX package's.

Each flax module is initialised, its BN statistics, BN scales and biases
are redrawn from a seeded numpy generator (so that BN epsilons and the bias
map matter), and the port's twin loads the same weights through
``from_jax_params``. The JAX modules run un-jitted (plain ``apply``).

Tolerance: 1e-4 relative to the largest magnitude of the compared tensor,
in float32 (convolutions sum in another order in the two frameworks). The
whole slice is compared stage by stage, and the port's second stage is fed
the JAX proposals, so that a near-tie in the proposal NMS cannot flip the
comparison. Detections are rounded to whole pixels, so they are held to
equal counts and classes, boxes within one pixel and scores within 1e-4.
"""

import test_torch_workers  # noqa: F401  (first: sizes this xdist worker's thread pools)

from collections.abc import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature_intertwiner_tpu.config import build_config as jax_build_config
from feature_intertwiner_tpu.models.detector import InterNet as JInterNet
from feature_intertwiner_tpu.models.fpn import FPN as JFPN
from feature_intertwiner_tpu.models.heads import BoxHead as JBoxHead
from feature_intertwiner_tpu.models.heads import MaskHead as JMaskHead
from feature_intertwiner_tpu.models.intertwiner import Critic as JCritic
from feature_intertwiner_tpu.models.intertwiner import Dev as JDev
from feature_intertwiner_tpu.models.intertwiner import UpsampleBlock as JUpsampleBlock
from feature_intertwiner_tpu.models.resnet import ResNet as JResNet
from feature_intertwiner_tpu.models.rpn import RPNHead as JRPNHead
from feature_intertwiner_tpu.ops.detection import detection_layer as jax_detection_layer
from feature_intertwiner_tpu.train import workflow as jax_workflow
from feature_intertwiner_tpu.utils.convert_weights import convert_reference_state_dict
from feature_intertwiner_tpu_torch.config import FLAGSHIP_OVERRIDES, build_config
from feature_intertwiner_tpu_torch.inference import mold_inputs, unmold_detections
from feature_intertwiner_tpu_torch.models.common import SameConv2d
from feature_intertwiner_tpu_torch.models.detector import InterNet
from feature_intertwiner_tpu_torch.models.fpn import FPN
from feature_intertwiner_tpu_torch.models.heads import BoxHead, MaskHead
from feature_intertwiner_tpu_torch.models.intertwiner import Critic, Dev, UpsampleBlock
from feature_intertwiner_tpu_torch.models.resnet import ResNet
from feature_intertwiner_tpu_torch.models.rpn import RPNHead
from feature_intertwiner_tpu_torch.ops.detection import detection_layer
from feature_intertwiner_tpu_torch.ops.proposals import proposal_layer
from feature_intertwiner_tpu_torch.utils.convert_weights import from_jax_params

T = torch.from_numpy
KEY = jax.random.PRNGKey(0)


def assert_rel(got, want, tol=1e-4):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-6)
    assert err <= tol, f"relative error {err:.3g} > {tol}"


def nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _redraw(tree, rng):
    """Numpy copy of a flax tree with BN statistics, BN scales and biases
    redrawn; kernels kept."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out[k] = _redraw(v, rng)
            continue
        v = np.asarray(v, np.float32)
        if k == "scale":
            v = rng.uniform(0.5, 1.5, v.shape)
        elif k in ("bias", "mean"):
            v = rng.normal(0.0, 0.2, v.shape)
        elif k == "var":
            v = rng.uniform(0.5, 2.0, v.shape)
        out[k] = np.asarray(v, np.float32)
    return out


def init_pair(flax_module, port_module, args, wrap, strip, seed=0, **kwargs):
    """Init the flax module on ``args``, redraw, load into the port module.
    Returns the flax variables (numpy)."""
    variables = flax_module.init(KEY, *args, **kwargs)
    rng = np.random.RandomState(seed)
    params = _redraw(variables.get("params", {}), rng)
    stats = _redraw(variables.get("batch_stats", {}), rng)
    sd = from_jax_params(wrap(params), wrap(stats))
    assert all(k.startswith(strip) for k in sd)
    port_module.load_state_dict({k[len(strip):]: v for k, v in sd.items()}, strict=True)
    port_module.eval()
    return {"params": params, "batch_stats": stats}


# --- modules ---------------------------------------------------------------------
@pytest.fixture(scope="module")
def backbone():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 64, 64, 3).astype(np.float32) * 30
    jm, pm = JResNet("resnet50"), ResNet("resnet50")
    v = init_pair(jm, pm, (jnp.asarray(x),), lambda t: {"backbone": t}, "fpn.")
    return x, jm, pm, v


def test_resnet50_matches_flax(backbone):
    x, jm, pm, v = backbone
    want = jm.apply(v, jnp.asarray(x))
    with torch.inference_mode():
        got = pm(T(x).permute(0, 3, 1, 2))
    for g, w in zip(got, want):
        assert_rel(nhwc(g), w)


def test_fpn_matches_flax(backbone):
    x, jres, pres, rv = backbone
    cs = jres.apply(rv, jnp.asarray(x))
    jm, pm = JFPN(256), FPN(pres, 256)
    fv = JFPN(256).init(KEY, *cs)
    params = {"backbone": rv["params"], "fpn": _redraw(fv["params"], np.random.RandomState(1))}
    stats = {"backbone": rv["batch_stats"]}
    sd = from_jax_params(params, stats)
    pm.load_state_dict({k[len("fpn."):]: v for k, v in sd.items()}, strict=True)
    pm.eval()
    want, _ = jm.apply({"params": params["fpn"]}, *cs)
    with torch.inference_mode():
        got = pm.top_down(*[T(np.array(c)).permute(0, 3, 1, 2) for c in cs])
        again = pm(T(x).permute(0, 3, 1, 2))
    assert len(got) == 5
    for g, a, w in zip(got, again, want):
        assert_rel(nhwc(g), w)
        assert_rel(nhwc(a), w)


def test_rpn_head_matches_flax():
    x = np.random.RandomState(2).randn(2, 8, 8, 256).astype(np.float32)
    jm, pm = JRPNHead(3, 1), RPNHead(3, 1, 256)
    v = init_pair(jm, pm, (jnp.asarray(x),), lambda t: {"rpn": t}, "rpn.")
    want = jm.apply(v, jnp.asarray(x))
    with torch.inference_mode():
        got = pm(T(x).permute(0, 3, 1, 2))
    for g, w in zip(got, want):
        assert_rel(g, w)


def test_box_head_matches_flax():
    x = np.random.RandomState(3).randn(6, 7, 7, 256).astype(np.float32)
    jm, pm = JBoxHead(8, 7), BoxHead(8, 7, 256)
    v = init_pair(jm, pm, (jnp.asarray(x),), lambda t: {"classifier": t}, "classifier.")
    want = jm.apply(v, jnp.asarray(x))
    with torch.inference_mode():
        got = pm(T(x))
    for g, w in zip(got, want):
        assert_rel(g, w)


def test_mask_head_matches_flax():
    """Includes the 2×2/2 SAME ConvTranspose, whose flax kernel the port
    holds spatially flipped."""
    x = np.random.RandomState(4).randn(3, 14, 14, 256).astype(np.float32)
    jm, pm = JMaskHead(8), MaskHead(8, 256)
    v = init_pair(jm, pm, (jnp.asarray(x),), lambda t: {"mask": t}, "mask.")
    want = jm.apply(v, jnp.asarray(x))
    with torch.inference_mode():
        got = pm(T(x))
    assert got.shape == (3, 28, 28, 8)
    assert_rel(got, want)


def test_upsample_block_matches_flax():
    x = np.random.RandomState(5).randn(2, 16, 16, 256).astype(np.float32)
    jm, pm = JUpsampleBlock(256, 1.0), UpsampleBlock(256, 1.0)
    v = init_pair(jm, pm, (jnp.asarray(x),), lambda t: {"dev": {"upsample0": t}},
                  "dev_roi.upsample.0.")
    want = jm.apply(v, jnp.asarray(x))
    with torch.inference_mode():
        got = pm(T(x).permute(0, 3, 1, 2))
    assert_rel(nhwc(got), want)


def test_critic_matches_flax():
    x = np.random.RandomState(6).randn(4, 14, 14, 256).astype(np.float32)
    jm, pm = JCritic(14), Critic(256, 14)
    v = init_pair(jm, pm, (jnp.asarray(x),), lambda t: {"dev": {"critic": t}},
                  "dev_roi.feat_extract.")
    want = jm.apply(v, jnp.asarray(x))
    with torch.inference_mode():
        got = pm(T(x))
    assert_rel(got, want)


@pytest.mark.parametrize("use_dev", [True, False])
def test_dev_at_inference_matches_flax(use_dev):
    rng = np.random.RandomState(7)
    feats = [rng.randn(2, s, s, 256).astype(np.float32) for s in (32, 16, 8, 4)]
    rois = np.sort(rng.rand(2, 24, 2, 2).astype(np.float32), axis=2)
    rois = rois.transpose(0, 1, 3, 2).reshape(2, 24, 4)
    jm = JDev(num_classes=8, image_size=128, use_dev=use_dev, upsample_fac=1.0)
    pm = Dev(256, image_size=128, use_dev=use_dev, upsample_fac=1.0)
    jf = [jnp.asarray(f) for f in feats]
    v = init_pair(jm, pm, (jf, jnp.asarray(rois)), lambda t: {"dev": t}, "dev_roi.")
    want_cls, want_mask, _ = jm.apply(v, jf, jnp.asarray(rois), need_small=False)
    with torch.inference_mode():
        maps = pm.pooling_maps([T(f).permute(0, 3, 1, 2) for f in feats])
        got_cls = pm.pool(maps, T(rois), 7)
        got_mask = pm.pool(maps, T(rois), 14)
    assert_rel(got_cls, want_cls)
    assert_rel(got_mask, want_mask)


@pytest.mark.parametrize("variant, value, error", [
    ("DEV.STRUCTURE", "alpha", NotImplementedError),
    ("DEV.UPSAMPLE_FAC", "3.0", ValueError),            # as JAX raises
])
def test_unported_variants_raise(variant, value, error):
    cfg = build_config(opts=list(FLAGSHIP_OVERRIDES) + [variant, value])
    with pytest.raises(error, match=variant.split(".")[1]):
        InterNet.from_config(cfg)


@pytest.mark.parametrize("opts, stride, meta_levels, method, cap", [
    ([], 1, (2, 3, 4), "roi_align", 8),
    (["RPN.ANCHOR_STRIDE", "2"], 2, (2, 3, 4), "roi_align", 8),
    (["DEV.ASSIGN_BOX_ON_ALL_SCALE", "True"], 1, (2, 3, 4, 5), "roi_align", 8),
    (["ROIS.METHOD", "roi_pool", "ROIS.WINDOW_CAP", "0"], 1, (2, 3, 4), "roi_pool", 0),
    (["ROIS.METHOD", "roi_pool", "DEV.ASSIGN_BOX_ON_ALL_SCALE", "True", "RPN.ANCHOR_STRIDE",
      "2"], 2, (2, 3, 4, 5), "roi_pool", 8),
    # both options act only with the intertwiner on, as in JAX
    (["DEV.SWITCH", "False", "ROIS.METHOD", "roi_pool", "DEV.ASSIGN_BOX_ON_ALL_SCALE", "True"],
     1, (2, 3, 4), "roi_align", 8),
], ids=["flagship", "stride2", "all_scale", "roi_pool_exact_cap", "all_three", "dev_off"])
def test_variants_build_what_they_name(opts, stride, meta_levels, method, cap):
    cfg = build_config(opts=list(FLAGSHIP_OVERRIDES) + opts)
    model = InterNet.from_config(cfg)
    conv = model.rpn.conv_shared
    assert conv.stride == (stride, stride)
    # flax's SAME: padding=1 at stride 1; at stride 2 the map is padded in
    # the forward, (0, 1) on an even side and (1, 1) on an odd one
    assert conv.padding == ((1, 1) if stride == 1 else (0, 0))
    assert isinstance(conv, SameConv2d) == (stride != 1)
    dev = model.dev_roi
    assert (dev.meta_levels, dev.roi_method, dev.window_cap) == (meta_levels, method, cap)
    assert dev.assign_all_scale == (len(meta_levels) == 4)
    assert model.anchors.shape[0] == sum(
        3 * (-(-(1024 // s) // stride)) ** 2 for s in (4, 8, 16, 32, 64))
    if stride == 2:
        with torch.inference_mode():
            outs = [conv(torch.zeros(1, 256, n, n)) for n in (8, 7)]
        assert [tuple(o.shape[2:]) for o in outs] == [(4, 4), (4, 4)]


# --- the whole slice ------------------------------------------------------------------
IMG = 128
TINY = dict(backbone="resnet50", num_classes=8, image_size=IMG,
            anchor_scales=(8, 16, 32, 64, 128), pre_nms_limit=200,
            post_nms_inference=48, det_max_instances=8, dev_switch=True,
            dev_upsample_fac=1.0)


@pytest.fixture(scope="module")
def slice_pair():
    rng = np.random.RandomState(8)
    images = (rng.randn(2, IMG, IMG, 3) * 40).astype(np.float32)
    windows = np.array([[0, 0, IMG, IMG], [16, 0, 112, IMG]], np.float32)
    jm = JInterNet(**TINY, post_nms_train=64, rois_per_image=24,
                   dev_loss_choice="l2", strict_quirks=True)
    variables = jm.init({"params": KEY}, jnp.asarray(images), mode="inference",
                        windows=jnp.asarray(windows))
    v = {"params": _redraw(variables["params"], rng),
         "batch_stats": _redraw(variables["batch_stats"], rng)}
    pm = InterNet(**TINY)
    pm.load_state_dict(from_jax_params(v["params"], v["batch_stats"]), strict=True)
    pm = pm.to(memory_format=torch.channels_last).eval()

    ji = jnp.asarray(images)
    j = {}
    j["cs"] = jm.apply(v, ji, method=lambda m, x: m.resnet(x, False))
    j["pyramid"], _ = jm.apply(v, *j["cs"], method=lambda m, *c: m.fpn(*c))
    j["maps"], j["rpn_logits"], j["rpn_deltas"], j["proposals"], _ = jm.apply(
        v, ji, method=lambda m, x: m._features_and_proposals(x, False, False))
    j["pooled"], _, _ = jm.apply(
        v, j["maps"], j["proposals"],
        method=lambda m, f, r: m.dev(f, r, need_cls=True, need_mask=False, need_small=False))
    _, j["probs"], j["bbox"], _ = jm.apply(v, j["pooled"], method=lambda m, p: m.classifier(p))
    j["out"] = jm.apply(v, ji, mode="inference", windows=jnp.asarray(windows))

    p = {}
    x = T(images)
    props = T(np.asarray(j["proposals"]))
    with torch.inference_mode():
        p["cs"] = pm.fpn.bottom_up(x.permute(0, 3, 1, 2))
        p["pyramid"], p["rpn_probs"], p["rpn_deltas"], _ = pm.first_stage(x)
        p["pooled"] = pm.dev_roi.pool(pm.dev_roi.pooling_maps(p["pyramid"][:4]), props, 7)
        _, p["probs"], p["bbox"], _ = pm.classifier(p["pooled"])
        p["out"] = pm.second_stage(p["pyramid"][:4], props, T(windows))
    return dict(jax=j, port=p, model=pm, variables=v, windows=windows)


def test_slice_backbone_and_pyramid(slice_pair):
    j, p = slice_pair["jax"], slice_pair["port"]
    for g, w in zip(p["cs"], j["cs"]):
        assert_rel(nhwc(g), w)
    assert len(p["pyramid"]) == len(j["pyramid"]) == 5
    for g, w in zip(p["pyramid"], j["pyramid"]):
        assert_rel(nhwc(g), w)


def test_slice_rpn(slice_pair):
    j, p = slice_pair["jax"], slice_pair["port"]
    assert_rel(p["rpn_probs"], jax.nn.softmax(j["rpn_logits"], axis=-1))
    assert_rel(p["rpn_deltas"], j["rpn_deltas"])


def test_slice_proposals(slice_pair):
    """The port's proposal layer on the JAX RPN outputs."""
    j, model = slice_pair["jax"], slice_pair["model"]
    probs = T(np.asarray(jax.nn.softmax(j["rpn_logits"], axis=-1)))
    got = proposal_layer(probs, T(np.asarray(j["rpn_deltas"])), model.anchors,
                         model.bbox_std, (IMG, IMG), pre_nms_limit=200,
                         proposal_count=48, nms_threshold=0.7).numpy()
    want = np.asarray(j["proposals"])
    np.testing.assert_array_equal((got != 0).any(-1), (want != 0).any(-1))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_slice_pooled_features_and_class_probs(slice_pair):
    j, p = slice_pair["jax"], slice_pair["port"]
    assert_rel(p["pooled"], j["pooled"])
    assert_rel(p["probs"], j["probs"])
    assert_rel(p["bbox"], j["bbox"])


def test_slice_detection_layer_on_jax_head_outputs(slice_pair):
    j = slice_pair["jax"]
    b, r, k = 2, 48, 8
    args = (np.asarray(j["proposals"]), np.asarray(j["probs"]).reshape(b, r, k),
            np.asarray(j["bbox"]).reshape(b, r, k, 4), slice_pair["windows"],
            np.array([0.1, 0.1, 0.2, 0.2], np.float32))
    got = detection_layer(*[T(a) for a in args], (IMG, IMG), max_instances=8)
    want = jax_detection_layer(*[jnp.asarray(a) for a in args], (IMG, IMG), max_instances=8)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_slice_detections_and_masks(slice_pair):
    """The port's second stage, on the JAX proposals, against the JAX
    forward's detections and own-class masks."""
    want, got = slice_pair["jax"]["out"], slice_pair["port"]["out"]
    wd, gd = np.asarray(want["detections"]), got["detections"].numpy()
    assert gd.shape == wd.shape == (2, 8, 6)
    np.testing.assert_array_equal((gd[..., 5] > 0).sum(1), (wd[..., 5] > 0).sum(1))
    assert (wd[..., 5] > 0).any()
    np.testing.assert_array_equal(gd[..., 4], wd[..., 4])
    np.testing.assert_allclose(gd[..., :4], wd[..., :4], rtol=0, atol=1.0)
    np.testing.assert_allclose(gd[..., 5], wd[..., 5], rtol=0, atol=1e-4)
    same = (gd[..., :4] == wd[..., :4]).all(-1)
    assert same.mean() > 0.5
    gm, wm = got["masks"].numpy(), np.asarray(want["masks"])
    assert gm.shape == wm.shape == (2, 8, 28, 28)
    np.testing.assert_allclose(gm[same], wm[same], rtol=0, atol=1e-4)


def test_weight_round_trip_through_reference_names(slice_pair):
    """The port's state_dict, read by the JAX package's own converter of
    reference checkpoints, gives back the flax trees it was loaded from."""
    sd = {k: v.numpy() for k, v in slice_pair["model"].state_dict().items()}
    params, stats = convert_reference_state_dict(sd, arch="resnet50", upsample_fac=1.0,
                                                 strict=True)
    v = slice_pair["variables"]

    def flat(tree, prefix=()):
        out = {}
        for k, val in tree.items():
            if isinstance(val, Mapping):
                out.update(flat(val, prefix + (k,)))
            else:
                out[prefix + (k,)] = np.asarray(val)
        return out

    for got, want in ((flat(params), flat(v["params"])), (flat(stats), flat(v["batch_stats"]))):
        assert got.keys() == want.keys()
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg="/".join(key))


def test_from_jax_params_rejects_unknown_leaves():
    with pytest.raises(ValueError, match="no port module"):
        from_jax_params({"dev": {"small_fc": {"kernel": np.zeros((1024, 4))}}}, {})
    with pytest.raises(ValueError, match="unknown leaf"):
        from_jax_params({"dev": {"critic": {"conv1": {"gate": np.zeros(4)}}}}, {})


# --- host steps: mold and unmold ---------------------------------------------------------
def _cfgs():
    opts = ["DATA.IMAGE_MIN_DIM", "96", "DATA.IMAGE_MAX_DIM", "128",
            "DATASET.NUM_CLASSES", "8"]
    return build_config(opts=opts), jax_build_config(opts=opts)


def test_mold_inputs_matches_jax():
    cfg, jcfg = _cfgs()
    rng = np.random.RandomState(9)
    images = [rng.randint(0, 256, shape).astype(np.uint8)
              for shape in ((60, 90, 3), (150, 100, 3), (96, 128, 3))]
    got, got_win = mold_inputs(images, cfg, "cpu")
    want, _, want_win = jax_workflow.mold_inputs(images, jcfg)
    assert got.shape == want.shape == (3, 128, 128, 3)
    np.testing.assert_array_equal(got_win.numpy(), want_win)
    # OpenCV's fixed-point bilinear against torch's float bilinear
    assert np.abs(got.numpy() - want).max() <= 1.0 + 1e-4


def test_unmold_detections_matches_jax():
    cfg, jcfg = _cfgs()
    rng = np.random.RandomState(10)
    m = 8
    det = np.zeros((m, 6), np.float32)
    y1x1 = rng.uniform(10, 60, (5, 2))
    det[:5, :2] = y1x1
    det[:5, 2:4] = y1x1 + rng.uniform(8, 50, (5, 2))
    det[:5, :4] = np.round(det[:5, :4])
    det[:5, 4] = rng.randint(1, 8, 5)
    det[:5, 5] = rng.uniform(0.1, 1.0, 5)
    yy, xx = np.mgrid[0:28, 0:28]
    masks = np.stack([np.exp(-((yy - rng.uniform(6, 22)) ** 2 + (xx - rng.uniform(6, 22)) ** 2)
                             / rng.uniform(20, 80)) for _ in range(m)]).astype(np.float32)
    shape, window = (150, 100, 3), np.array([0, 21, 128, 107], np.float32)
    got = unmold_detections(det, masks, shape, window)
    want = jax_workflow.unmold_detections(det, masks, shape, window, jcfg)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, w)
    assert len(got[3]) == len(want[3]) == 5
    agree = np.mean([np.mean(g == w) for g, w in zip(got[3], want[3])])
    assert agree >= 0.995, agree
