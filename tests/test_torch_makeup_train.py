"""The slice with the make-up layer at ``UPSAMPLE_FAC`` 2 and
``CLS_MERGE_FEAT`` (``simple_add``): the port against the JAX package on
the CPU, at the ``TINY`` size of ``test_torch_model.py`` with the train
set-up of ``test_torch_train.py`` (RoI levels as at 1024², the P2-P4 output
convs tempered, GT from the model's largest proposals).

- The second stage, both packages fed the same proposals: the class
  probabilities and box deltas within 1e-4 relative; the detections as ``test_torch_model.py`` holds the
  flagship's (counts and classes equal, boxes within 1 px, scores within
  1e-4) and the masks within 1e-4 where the boxes agree.
- One 'all' train step in float32 against the jitted JAX step (the same
  weights, batch and uniform draws): losses within 1e-4 relative,
  parameters within 1e-5 of each tensor's largest magnitude, the buffer
  within 1e-4. The step has positive RoIs on meta levels, so the critic's
  vectors join the classifier, and the critic and the make-up layer take
  the classifier's gradient too.
- One 'all' step in bfloat16 against JAX's in bfloat16 and float32, held
  to JAX's own bfloat16 error as ``test_torch_bf16_slice.py`` holds the
  flagship's.

The proposals fed to both packages keep 2^-20 inside the image (``EDGE``:
ROADMAP "Not faults"). The weights are drawn with numpy by the JAX
package's laws: the flax init would cost one more compilation of the
train forward per configuration.
"""

import test_torch_workers  # noqa: F401  (first: sizes this xdist worker's thread pools)

from collections.abc import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature_intertwiner_tpu.config import build_config as jax_build_config
from feature_intertwiner_tpu.models import detector as jax_detector
from feature_intertwiner_tpu.train.step import create_train_state as jax_create_train_state
from feature_intertwiner_tpu.train.step import make_train_step
from feature_intertwiner_tpu_torch.config import FLAGSHIP_OVERRIDES, build_config
from feature_intertwiner_tpu_torch.models.detector import InterNet
from feature_intertwiner_tpu_torch.train.optim import set_trainable
from feature_intertwiner_tpu_torch.train.step import LOSS_KEYS, create_train_state, train_step
from feature_intertwiner_tpu_torch.utils.convert_weights import from_jax_params
from test_torch_bf16_slice import assert_within_jax_bf16_error
from test_torch_makeup import CONFIGS, _gated
from test_torch_model import TINY, JInterNet, _redraw, assert_rel
from test_torch_train import (FPN_SCALES, IMG, STEP_MODEL, STEP_OPTS, StepRecorder, _batch,
                              _assert_step_equal)

T = torch.from_numpy
# How far inside the image the proposals fed to both packages are kept. One
# float32 ulp, enough in test_torch_ot_train.py, is not on P5 (4 x 4): there
# the jitted JAX step still pools the last sample row of a box ending one
# ulp inside 1.0 apart from the JAX crop outside the step and from the port
# (ROADMAP "Not faults"); 2^-20 keeps that row 12 float32 ulps below the
# map's last row at P5.
EDGE = 2.0 ** -20
# each configuration as options of both packages' configs
CONFIG_OPTS = {
    "up2_merge": ["DEV.UPSAMPLE_FAC", "2.0", "DEV.CLS_MERGE_FEAT", "True"],
    "multi_residual": ["DEV.UPSAMPLE_FAC", "2.0", "DEV.MULTI_UPSAMPLER", "True",
                       "DEV.UPSAMPLE_RESIDUAL", "True", "DEV.UPSAMPLE_INIT", "identity",
                       "DEV.CLS_MERGE_FEAT", "True", "DEV.CLS_MERGE_MANNER", "linear_add",
                       "DEV.CLS_MERGE_FAC", "0.3"],
    "dis_merge": ["DEV.DIS_UPSAMPLER", "True", "DEV.CLS_MERGE_FEAT", "True"],
}


def _draw(tree, rng):
    """Numpy weights in the shapes of a flax tree of shapes, by the JAX
    package's laws (``models/common.py``): Xavier-uniform conv kernels (the
    transposed convs' Xavier-normal has the same variance), N(0, 0.01)
    dense kernels, zeros elsewhere (BN, biases and gates are redrawn
    after). The flax init would cost a compilation of the train forward."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out[k] = _draw(v, rng)
        elif k == "kernel" and v.ndim == 2:
            out[k] = rng.normal(0.0, 0.01, v.shape).astype(np.float32)
        elif k == "kernel":
            field = int(np.prod(v.shape[:-2]))
            bound = np.sqrt(6.0 / (field * (v.shape[-2] + v.shape[-1])))
            out[k] = rng.uniform(-bound, bound, v.shape).astype(np.float32)
        else:
            out[k] = np.zeros(v.shape, np.float32)
    return out


def makeup_steps(name, dtypes=(torch.float32,), layers="all", model_kw=None, opts=None):
    """One train step of stage ``layers`` of both packages in each of
    ``dtypes`` for the configuration ``name`` (or, with ``model_kw`` and
    ``opts``, for the model keywords and config options given), from the same float32 weights (drawn by
    :func:`_draw`, BN and biases by ``_redraw``, gates in [0, 1), the FPN
    tempered), batch, draws and proposals: the float32 port model's, kept
    ``EDGE`` inside the image. Returns the weights, the images, the
    models before their step, and per dtype the JAX (metrics, state) and
    the port's (metrics, state); and what a further port step needs (cfg,
    batch, draws, the fixed proposals' ``propose``)."""
    model_kw = dict(TINY, **STEP_MODEL, **(CONFIGS[name] if model_kw is None else model_kw))
    opts = list(FLAGSHIP_OVERRIDES) + STEP_OPTS + (CONFIG_OPTS[name] if opts is None else opts)
    with pytest.MonkeyPatch.context() as mp:
        rng = np.random.RandomState(0)
        images = (rng.randn(2, IMG, IMG, 3) * 40).astype(np.float32)
        kwargs = dict(model_kw, post_nms_train=64, strict_quirks=True)
        jms = {torch.float32: JInterNet(**kwargs),
               torch.bfloat16: JInterNet(**kwargs, dtype=jnp.bfloat16)}
        zeros = {"gt_class_ids": jnp.zeros((2, 6), jnp.int32), "gt_boxes": jnp.zeros((2, 6, 4)),
                 "gt_masks": jnp.zeros((2, 6, 14, 14))}
        key = jax.random.PRNGKey(0)
        shapes = jax.eval_shape(lambda: jms[torch.float32].init(
            {"params": key, "sampling": key}, jnp.asarray(images), mode="train", **zeros))
        variables = {k: _redraw(_draw(shapes[k], rng), rng) for k in ("params", "batch_stats")}
        _gated(variables["params"], rng)
        for level, scale in FPN_SCALES.items():
            out = variables["params"]["fpn"][f"p{level}_out"]
            out["kernel"], out["bias"] = out["kernel"] * scale, out["bias"] * scale
        models = {}
        for dtype in dtypes + ((torch.float32,) if torch.float32 not in dtypes else ()):
            models[dtype] = InterNet(**model_kw, dtype=dtype)
            models[dtype].load_state_dict(from_jax_params(variables["params"],
                                                          variables["batch_stats"]),
                                          strict=True)
            models[dtype].eval()
        first = models[torch.float32]
        with torch.no_grad():
            proposals = first.first_stage(T(images))[3].numpy()
        proposals = np.minimum(proposals, np.float32(1 - EDGE))
        batch = dict(_batch(proposals, rng), images=images)
        cfg, jcfg = build_config(opts=opts), jax_build_config(opts=opts)
        jax_batch = {k: jnp.asarray(v) for k, v in batch.items()}
        fed = jnp.asarray(proposals)
        mp.setattr(jax_detector, "proposal_layer", lambda *a, **k: fed)
        recorder = StepRecorder(mp)
        jax_steps = {}
        for dtype in dtypes:
            jstate, jmetrics = jax.jit(make_train_step(jms[dtype], jcfg, layers))(
                jax_create_train_state(jcfg, variables), jax_batch, jnp.float32(0.01),
                jnp.float32(1.0), jax.random.PRNGKey(1))
            jax_steps[dtype] = ({k: float(v) for k, v in jmetrics.items()},
                                jax.device_get(jstate))
        draws = recorder.feed(first, int(first.anchors.shape[0]))

    before = {k: v.clone() for k, v in first.state_dict().items()}
    port_steps = {}
    for dtype in dtypes:
        m = models[dtype]
        m._propose = first._propose
        state = create_train_state(cfg, m)
        set_trainable(m, layers)
        metrics = train_step(state, cfg, {k: T(v) for k, v in batch.items()}, 0.01, 1.0,
                             draws=draws)
        port_steps[dtype] = ({k: float(v) for k, v in metrics.items()}, state)
    return dict(name=name, variables=variables, images=images, proposals=proposals,
                before=before, jax=jax_steps, port=port_steps, model_kw=model_kw, cfg=cfg,
                batch=batch, draws=draws, propose=first._propose, layers=layers)


def check_float32_step(step):
    """The float32 step against JAX's (module docstring); the make-up
    layer, the critic and the classifier moved."""
    (pm, state), (jm, js) = step["port"][torch.float32], step["jax"][torch.float32]
    assert pm["positive_rois"] > 0 and pm["meta_loss"] > 0
    assert pm["small_rois_p2"] + pm["small_rois_p3"] + pm["small_rois_p4"] > 0
    _assert_step_equal(pm, jm, (state.model.state_dict(), state.buffer, state.buffer_cnt), js)
    after = state.model.state_dict()
    moved = [k for k in ("dev_roi.feat_extract.0.weight", "classifier.conv2.weight",
                         "dev_roi.upsample.0.0.weight", "dev_roi.upsample.0.gate")
             if k in after and not torch.equal(after[k], step["before"][k])]
    want = 3 + (step["name"] == "multi_residual") - (step["name"] == "dis_merge")
    assert len(moved) == want, moved


@pytest.fixture(scope="module")
def up2_step():
    return makeup_steps("up2_merge", (torch.bfloat16, torch.float32))


def test_second_stage_matches_jax(up2_step):
    """The port's second stage on its own pyramid against the jitted JAX
    forward from the same weights, both fed the step's proposals; the JAX
    detection layer's inputs are its class probabilities and deltas."""
    v, images = up2_step["variables"], up2_step["images"]
    windows = np.array([[0, 0, IMG, IMG], [16, 0, 112, IMG]], np.float32)
    jm = JInterNet(**up2_step["model_kw"], post_nms_train=64, strict_quirks=True)
    proposals = up2_step["proposals"]
    seen = {}
    detect = jax_detector.detection_layer

    def recorded(rois, probs, bbox, *args, **kwargs):
        jax.debug.callback(lambda p, b: seen.update(probs=np.asarray(p), bbox=np.asarray(b)),
                           probs, bbox)
        return detect(rois, probs, bbox, *args, **kwargs)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_detector, "proposal_layer", lambda *a, **k: jnp.asarray(proposals))
        mp.setattr(jax_detector, "detection_layer", recorded)
        want = jax.jit(lambda x, w: jm.apply(v, x, mode="inference", windows=w))(
            jnp.asarray(images), jnp.asarray(windows))
        jax.effects_barrier()

    pm = InterNet(**up2_step["model_kw"])
    pm.load_state_dict(from_jax_params(v["params"], v["batch_stats"]), strict=True)
    pm = pm.to(memory_format=torch.channels_last).eval()
    props = T(proposals)
    with torch.inference_mode():
        pyramid = pm.first_stage(T(images))[0]
        maps = pm.dev_roi.pooling_maps(pyramid[:4])
        small = pm.dev_roi.small_features(pm.dev_roi.pool(maps, props, 14), props)
        _, probs, bbox, _ = pm.classifier(pm.dev_roi.pool(maps, props, 7), *small)
        got = pm.second_stage(pyramid[:4], props, T(windows))
    assert float(small[1].sum()) > 0                        # the merge has RoIs to act on
    assert_rel(probs, seen["probs"].reshape(probs.shape))
    assert_rel(bbox, seen["bbox"].reshape(bbox.shape))
    wd, gd = np.asarray(want["detections"]), got["detections"].numpy()
    np.testing.assert_array_equal((gd[..., 5] > 0).sum(1), (wd[..., 5] > 0).sum(1))
    assert (wd[..., 5] > 0).any()
    np.testing.assert_array_equal(gd[..., 4], wd[..., 4])
    np.testing.assert_allclose(gd[..., :4], wd[..., :4], rtol=0, atol=1.0)
    np.testing.assert_allclose(gd[..., 5], wd[..., 5], rtol=0, atol=1e-4)
    same = (gd[..., :4] == wd[..., :4]).all(-1)
    assert same.mean() > 0.5
    np.testing.assert_allclose(got["masks"].numpy()[same], np.asarray(want["masks"])[same],
                               rtol=0, atol=1e-4)


def test_train_step_matches_jax_in_float32(up2_step):
    check_float32_step(up2_step)


def test_train_step_in_bf16_is_within_jax_bf16_error(up2_step):
    step = up2_step
    (pm, state), (pm32, state32) = step["port"][torch.bfloat16], step["port"][torch.float32]
    (jm16, js16), (jm32, js32) = step["jax"][torch.bfloat16], step["jax"][torch.float32]
    assert pm["positive_rois"] > 0 and pm["meta_loss"] > 0
    for k in LOSS_KEYS + ("meta_loss", "total_loss"):
        assert_within_jax_bf16_error(k, pm[k], pm32[k], jm32[k], jm16[k])
    before = step["before"]
    sds = (state.model.state_dict(), state32.model.state_dict(),
           from_jax_params(js16.params, js16.batch_stats),
           from_jax_params(js32.params, js32.batch_stats))
    updates = {k: [(sd[k].double() - p0.double()).numpy().ravel() for sd in sds]
               for k, p0 in before.items()}
    moved = {k: u for k, u in updates.items() if np.abs(u[3]).max() > 0}
    assert "dev_roi.upsample.0.0.weight" in moved and len(moved) > 100
    u16, u32p, j16, j32 = (np.concatenate([u[i] for u in moved.values()]) for i in range(4))
    norm = np.linalg.norm
    own, d = norm(j16 - j32), norm(u32p - j32)
    assert norm(u16 - j32) <= 1.5 * own + d, (norm(u16 - j32), own, d)
    assert norm(u16 - j16) <= 2.0 * own + d, (norm(u16 - j16), own, d)
    rel_port = np.array([norm(u[0] - u[3]) / norm(u[3]) for u in moved.values()])
    rel_jax = np.array([norm(u[2] - u[3]) / norm(u[3]) for u in moved.values()])
    assert rel_port.max() <= 2 * rel_jax.max(), (rel_port.max(), rel_jax.max())
    assert np.median(rel_port) <= 1.5 * np.median(rel_jax)
    for name, got, got32, a, b in (
            ("buffer", state.buffer, state32.buffer, js32.buffer, js16.buffer),
            ("buffer_cnt", state.buffer_cnt, state32.buffer_cnt, js32.buffer_cnt,
             js16.buffer_cnt)):
        assert_within_jax_bf16_error(name, got.numpy(), got32.numpy(), np.asarray(a),
                                     np.asarray(b))
    assert all(v.dtype in (torch.float32, torch.int64) for v in state.model.state_dict().values())
