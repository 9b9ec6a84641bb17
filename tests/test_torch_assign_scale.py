"""``DEV.ASSIGN_BOX_ON_ALL_SCALE``, ``RPN.ANCHOR_STRIDE`` and ``ROIS.METHOD
roi_pool`` in the port against the JAX package on the CPU.

- The all-scale level of a box: exactly JAX ``Dev._assign_levels``, with
  boxes whose area lies at a threshold and one float32 ulp either side.
- The RPN head at anchor stride 2 (flax's SAME padding, (0, 1) on an even
  side, (1, 1) on an odd one): within 1e-4 relative of flax on even and odd
  maps, as many outputs as the level's anchors.
- The ``Dev`` in training against the jitted JAX ``Dev`` (BN in eval mode,
  ``BIG_SUPERVISE`` with the big class means attached, so the big sets'
  poolings carry a gradient too) under all-scale, under ``roi_pool`` and
  under both, on raw maps wider than high, wide enough that RoIs land on
  all of levels 2-6: the poolings and statistics within 1e-4 relative,
  every parameter's and map's gradient of a loss over the statistics
  within 1e-5 of its largest magnitude of ``jax.grad``'s.
- At inference under all-scale, RoIs too big for every level (6) join the
  critic's set (JAX merges them into level 5's; JAX
  ``tests/test_variants.py::test_assign_all_scale_inference_merges_big_rois``).
- One float32 'heads' SGD step against the jitted JAX step, set up and held
  as ``test_torch_makeup_train.py`` does (losses within 1e-4 relative,
  parameters within 1e-5 of each tensor's largest magnitude, the buffer
  within 1e-4): set C, all-scale with anchor stride 2; set D, ``roi_pool``.
  At this size (P5 4 cells wide) no RoI reaches level 5, so the step's
  level-5 statistics are empty; the Dev test above covers them.
- ``--phase train`` with all three options, float32, one step.
"""

import test_torch_workers  # noqa: F401  (first: sizes this xdist worker's thread pools)

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature_intertwiner_tpu.models.intertwiner import Dev as JDev
from feature_intertwiner_tpu.models.rpn import RPNHead as JRPNHead
from feature_intertwiner_tpu_torch import main as port_main
from feature_intertwiner_tpu_torch.models.intertwiner import Dev, assign_all_scale_levels
from feature_intertwiner_tpu_torch.models.rpn import RPNHead
from feature_intertwiner_tpu_torch.ops.anchors import generate_level_anchors
from feature_intertwiner_tpu_torch.utils.convert_weights import from_jax_params
from test_torch_makeup_train import check_float32_step, makeup_steps
from test_torch_model import assert_rel, init_pair
from test_torch_trainer import CLI_OPTS

T = torch.from_numpy


def test_all_scale_levels_equal_jax_at_the_thresholds():
    rng = np.random.RandomState(0)
    widths = (256, 128, 64, 32)
    side = np.exp(rng.uniform(np.log(0.01), np.log(1.0), (400, 2)))
    y1x1 = rng.uniform(0, 1, (400, 2)) * (1 - side)
    boxes = [np.concatenate([y1x1, y1x1 + side], -1)]
    for w in widths:
        # a square box of area exactly (14 / W)², and one ulp either side
        s = np.float32(14.0 / w)
        for t in (np.nextafter(s, np.float32(0)), s, np.nextafter(s, np.float32(2))):
            boxes.append(np.array([[0.0, 0.0, t, s], [0.0, 0.0, s, t]]))
    boxes = np.concatenate(boxes).astype(np.float32)
    jdev = JDev(assign_all_scale=True, feat_pool_size=14, image_size=1024)
    want, meta = jax.jit(lambda b: jdev._assign_levels(b, widths))(jnp.asarray(boxes))
    got = assign_all_scale_levels(T(boxes), widths, 14)
    assert got.dtype == torch.int32 and meta == (2, 3, 4, 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jdev._assign_levels(
        jnp.asarray(boxes), widths)[0]))
    assert set(np.unique(got.numpy())) == {2, 3, 4, 5, 6}


@pytest.mark.parametrize("side", [8, 7])
def test_strided_rpn_head_matches_flax(side):
    x = np.random.RandomState(side).randn(2, side, side + 2, 64).astype(np.float32)
    jm, pm = JRPNHead(3, 2), RPNHead(3, 2, 64)
    v = init_pair(jm, pm, (jnp.asarray(x),), lambda t: {"rpn": t}, "rpn.")
    want = jm.apply(v, jnp.asarray(x))
    with torch.inference_mode():
        got = pm(T(x).permute(0, 3, 1, 2))
    for g, w in zip(got, want):
        assert_rel(g, w)
    anchors = generate_level_anchors(32, (0.5, 1, 2), (side, side + 2), 4, anchor_stride=2)
    assert got[0].shape[1] == anchors.shape[0] == 3 * -(-side // 2) * -(-(side + 2) // 2)


# the Dev's options in each case, as keywords of both Dev classes
DEV_CASES = {
    "all_scale": dict(assign_all_scale=True),
    "roi_pool": dict(roi_method="roi_pool"),
    "both": dict(assign_all_scale=True, roi_method="roi_pool", window_cap=0),
}
# raw P2-P5 (H, W): wider than high, so that the levels read the widths
MAP_SHAPES = ((96, 128), (48, 64), (24, 32), (12, 16))
KEYS = ("big_feat", "big_cnt", "small_feat", "small_cnt", "big_loss", "small_out", "small_gt")


def _dev_inputs(rng):
    feats = [rng.randn(2, h, w, 16).astype(np.float32) for h, w in MAP_SHAPES]
    side = np.exp(rng.uniform(np.log(0.03), np.log(1.0), (2, 24, 2)))
    side[0, :3] = 1.0                                   # level 6 under all-scale
    y1x1 = rng.uniform(0, 1, (2, 24, 2)) * (1 - side)
    rois = np.concatenate([y1x1, y1x1 + side], -1).astype(np.float32)
    return feats, rois


def _dev_loss(stats, pooled_cls, pooled_mask, w):
    return (sum((stats[k] * w[k]).sum() for k in ("big_feat", "small_feat", "small_out"))
            + stats["big_loss"].sum() + (pooled_cls * w["cls"]).sum()
            + (pooled_mask * w["mask"]).sum())


@pytest.mark.parametrize("case", list(DEV_CASES))
def test_dev_statistics_and_gradients_match_jax(case):
    rng = np.random.RandomState(15)
    feats, rois = _dev_inputs(rng)
    roi_gt = rng.randint(0, 4, (2, 24)).astype(np.int32)
    kw = dict(upsample_fac=1.0, num_classes=8, image_size=256, assign_base=56.0,
              loss_choice="l2", big_supervise=True, big_feat_detach=False, feat_pool_size=8,
              **DEV_CASES[case])
    jm, pm = JDev(**kw, pool_size=4, mask_pool_size=8), Dev(16, **kw)
    jf = [jnp.asarray(f) for f in feats]
    v = init_pair(jm, pm, (jf, jnp.asarray(rois)), lambda t: {"dev": t}, "dev_roi.",
                  roi_gt=jnp.asarray(roi_gt), train=True)
    s = len(pm.meta_levels)
    assert s == (4 if "assign_all_scale" in kw else 3)
    w = {"big_feat": rng.randn(s, 1024, 8), "small_feat": rng.randn(s, 1024, 8),
         "small_out": rng.randn(48, 1024), "cls": rng.randn(48, 4, 4, 16),
         "mask": rng.randn(48, 8, 8, 16)}
    w = {k: a.astype(np.float32) for k, a in w.items()}

    def loss(params, maps):
        cls, mask, stats = jm.apply({"params": params, "batch_stats": v["batch_stats"]}, maps,
                                    jnp.asarray(rois), roi_gt=jnp.asarray(roi_gt), train=True)
        return _dev_loss(stats, cls, mask, w), (cls, mask, stats)

    (_, (want_cls, want_mask, want)), (g_params, g_maps) = jax.jit(
        jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(v["params"], jf)
    maps = [T(f).permute(0, 3, 1, 2).requires_grad_() for f in feats]
    cls, mask, stats = pm.forward_train(maps, T(rois), T(roi_gt), 4, 8)
    lvl = pm.levels(T(rois), [m.shape[3] for m in maps]).numpy()
    all_scale = kw.get("assign_all_scale", False)
    assert set(np.unique(lvl)) == ({2, 3, 4, 5, 6} if all_scale else {2, 3, 4, 5})
    if all_scale:
        assert float(cls.detach()[lvl == 6].abs().max()) == 0.0
        assert float(stats["big_cnt"][3].sum()) > 0             # level 5's big set: level 6
    assert_rel(cls, want_cls)
    assert_rel(mask, want_mask)
    for k in KEYS:
        assert_rel(stats[k], want[k])
    _dev_loss(stats, cls, mask, {k: T(a) for k, a in w.items()}).backward()
    sd = from_jax_params({"dev": g_params}, {})
    total = dict({k[len("dev_roi."):]: t.double() for k, t in sd.items()
                  if not k.endswith("num_batches_tracked")},
                 **{f"P{i + 2}": T(np.asarray(g)).double() for i, g in enumerate(g_maps)})
    got = dict({n: p.grad.double() for n, p in pm.named_parameters()},
               **{f"P{i + 2}": m.grad.permute(0, 2, 3, 1).double() for i, m in enumerate(maps)})
    assert got.keys() == total.keys()
    for k, t in total.items():
        scale = float(t.abs().max())
        err = float((got[k] - t).abs().max()) / max(scale, 1e-30)
        assert err <= 1e-5, (k, err, scale)
        assert scale > 0, k


@pytest.mark.parametrize("widths", [(32, 16, 8, 4), (128, 64, 32, 16)])
def test_all_scale_inference_merges_level_6_into_the_small_set(widths):
    kw = dict(num_classes=8, feat_pool_size=14, image_size=128, upsample_fac=1.0,
              assign_all_scale=True, loss_choice="l2")
    jm, pm = JDev(**kw, pool_size=7, mask_pool_size=14), Dev(8, **kw)
    rng = np.random.RandomState(0)
    feats = [rng.randn(1, w, w, 8).astype(np.float32) for w in widths]
    # a tiny RoI and a whole-image one (level 6 when P5 is wider than 14)
    rois = np.array([[[0.1, 0.1, 0.15, 0.15], [0.0, 0.0, 1.0, 1.0]]], np.float32)
    jf = [jnp.asarray(f) for f in feats]
    v = init_pair(jm, pm, (jf, jnp.asarray(rois)), lambda t: {"dev": t}, "dev_roi.",
                  roi_gt=jnp.ones((1, 2), jnp.int32), train=True)
    _, _, want = jm.apply(v, jf, jnp.asarray(rois))
    with torch.inference_mode():
        maps = pm.pooling_maps([T(f).permute(0, 3, 1, 2) for f in feats])
        lvl = pm.levels(T(rois), widths)
        out, gt = pm.small_features(pm.pool(maps, T(rois), 14, lvl=lvl), T(rois), lvl=lvl)
    assert lvl.tolist()[1] == (6 if widths[3] > 14 else 4)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(want["small_gt"]))
    assert gt.tolist() == [1.0, 1.0] and float(out[1].abs().max()) > 0
    assert_rel(out, want["small_out"])


STEP_SETS = {
    "all_scale_stride2": (dict(dev_assign_all_scale=True, anchor_stride=2),
                          ["DEV.ASSIGN_BOX_ON_ALL_SCALE", "True", "RPN.ANCHOR_STRIDE", "2"]),
    "roi_pool": (dict(roi_method="roi_pool"), ["ROIS.METHOD", "roi_pool"]),
}


@pytest.mark.parametrize("name", list(STEP_SETS))
def test_train_step_matches_jax_in_float32(name):
    model_kw, opts = STEP_SETS[name]
    step = makeup_steps(name, layers="heads", model_kw=dict(model_kw, dev_upsample_fac=1.0),
                        opts=opts)
    check_float32_step(step)
    pm, state = step["port"][torch.float32]
    if name == "all_scale_stride2":
        assert state.model.dev_roi.meta_levels == (2, 3, 4, 5) and "small_rois_p5" in pm
        assert state.model.rpn.conv_shared.stride == (2, 2)
    else:
        assert state.model.dev_roi.roi_method == "roi_pool"


def test_cli_trains_with_all_three_options(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    trainer = port_main.main([
        "--phase", "train", "--synthetic_data", "--device", "cpu", "--config_name", "c3",
        *CLI_OPTS, "DEV.SWITCH", "True", "DEV.LOSS_CHOICE", "l2", "DEV.BUFFER_SIZE", "1",
        "DEV.UPSAMPLE_FAC", "1.0", "DEV.ASSIGN_BOX_ON_ALL_SCALE", "True",
        "RPN.ANCHOR_STRIDE", "2", "ROIS.METHOD", "roi_pool", "TPU.COMPUTE_DTYPE", "float32",
        "TRAIN.BATCH_SIZE", "8", "TRAIN.SCHEDULE", "[1, 0, 0]",
        "TRAIN.DO_VALIDATION", "False"])
    dev = trainer.model.dev_roi
    assert dev.meta_levels == (2, 3, 4, 5) and dev.roi_method == "roi_pool"
    assert trainer.model.rpn.conv_shared.stride == (2, 2)
    assert trainer.state.step == 1
    assert all(p.dtype == torch.float32 for p in trainer.model.parameters())
    lines = [json.loads(x) for x in (tmp_path / "results/c3/train/metrics.jsonl").read_text()
             .splitlines()]
    steps = [x for x in lines if "total_loss" in x]
    assert steps and all(np.isfinite(x["total_loss"]) for x in steps)
    assert trainer.state.buffer.shape == (1, 1024, 4)
