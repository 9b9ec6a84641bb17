"""The port's training path against the JAX package's, on the CPU.

- One train step, and a second one from ``from_jax_train_state`` of the JAX
  state after the first, against ``make_train_step``: the same weights,
  batch and uniform draws (the JAX draws are read back from the keys its
  targets receive). The port's second stage gets the JAX step's proposals:
  the two RPNs agree to the last digits only, and a mask target at a rounding
  boundary would flip on such a difference. The ground truth holds some of
  the model's own proposals, so that the step has positive RoIs on FPN
  level 3 and a non-zero meta loss. The JAX step is jitted: un-jitted, its
  first step takes minutes on the CPU.

Tolerances: losses within 1e-4 relative; parameters after a step within
1e-5 of each tensor's largest magnitude; the buffer within 1e-4.
"""

import test_torch_workers  # noqa: F401  (first: sizes this xdist worker's thread pools)

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
from feature_intertwiner_tpu_torch.train.optim import set_trainable, trainable_names
from feature_intertwiner_tpu_torch.train.step import (LOSS_KEYS, create_train_state,
                                                      load_trainer_state, train_step)
from feature_intertwiner_tpu_torch.utils.convert_weights import (from_jax_params,
                                                                 from_jax_train_state)
from test_torch_model import TINY, JInterNet, _redraw
from test_torch_train_ops import jax_draws

T = torch.from_numpy
IMG = 128
# RoI levels as at 1024² with the default base 224 (a 128² image over 56);
# P2 to P4 output convs scaled down, as chip_smoke.py tempers its random
# model, so that the proposals are not all P2 anchors: the largest ones then
# land on FPN levels 3 and 4
STEP_MODEL = dict(rois_per_image=24, dev_loss_choice="l2", assign_base=56.0)
FPN_SCALES = {2: 0.1, 3: 0.2, 4: 0.5}
STEP_OPTS = ["DATASET.NUM_CLASSES", "8", "DEV.SWITCH", "True", "DEV.LOSS_CHOICE", "l2",
             "DEV.BUFFER_SIZE", "1", "DEV.LOSS_FAC", "10.0", "TRAIN.CLIP_GRAD", "True"]


# --- one and two train steps against the JAX package ------------------------------------
def _batch(proposals: np.ndarray, rng) -> dict:
    """GT: each image's three largest proposals (classes 1-3 and 4-6), a
    random box, a crowd and a padding row; random 14² mini-masks."""
    b, g = proposals.shape[0], 6
    boxes = np.zeros((b, g, 4), np.float32)
    cls = np.zeros((b, g), np.int32)
    for i in range(b):
        area = (proposals[i, :, 2] - proposals[i, :, 0]) * (proposals[i, :, 3] - proposals[i, :, 1])
        boxes[i, :3] = proposals[i, np.argsort(-area)[:3]] * IMG
        cls[i, :3] = np.arange(1, 4) + 3 * i
    y1x1 = rng.uniform(0, 64, (b, 2, 2))
    boxes[:, 3:5] = np.concatenate([y1x1, y1x1 + rng.uniform(16, 60, (b, 2, 2))], -1)
    cls[:, 3], cls[:, 4] = 7, -2
    masks = (rng.rand(b, g, 14, 14) > 0.4).astype(np.float32)
    return {"gt_class_ids": cls, "gt_boxes": boxes, "gt_masks": masks}


class StepRecorder:
    """Wraps the JAX proposal layer and targets so that what they see inside
    the jitted step comes back to the host (``jax.debug.callback``): the
    proposals, and the keys the targets draw their uniform scores from."""

    def __init__(self, monkeypatch):
        self.seen = {}
        for name in ("rpn_targets", "detection_targets"):
            monkeypatch.setattr(jax_detector, name, self._keys(name, getattr(jax_detector, name)))
        propose = jax_detector.proposal_layer

        def proposals(*args, **kwargs):
            out = propose(*args, **kwargs)
            jax.debug.callback(lambda p: self.seen.__setitem__("proposals", np.asarray(p)), out)
            return out
        monkeypatch.setattr(jax_detector, "proposal_layer", proposals)

    def _keys(self, name, fn):
        def wrapper(key, *args, **kwargs):
            jax.debug.callback(lambda k: self.seen.__setitem__(name, np.asarray(k)), key)
            return fn(key, *args, **kwargs)
        return wrapper

    def feed(self, model, anchors: int):
        """The last JAX step's draws for the port, whose ``model`` is given
        the same proposals."""
        jax.effects_barrier()
        proposals = T(self.seen["proposals"].copy())
        model._propose = lambda *args: proposals
        return {"rpn": T(jax_draws(self.seen["rpn_targets"], 2, anchors)),
                "det": T(jax_draws(self.seen["detection_targets"], 2, proposals.shape[1]))}


def _assert_step_equal(port_metrics, jax_metrics, port, jax_state):
    """``port``: (state_dict, buffer, buffer_cnt) of the port after the step."""
    for k in LOSS_KEYS + ("meta_loss", "total_loss"):
        got, want = float(port_metrics[k]), float(jax_metrics[k])
        assert abs(got - want) <= 1e-4 * max(abs(want), 1e-6), (k, got, want)
    got_sd, buffer, buffer_cnt = port
    want_sd = from_jax_params(jax_state.params, jax_state.batch_stats)
    assert got_sd.keys() == want_sd.keys()
    for k, want in want_sd.items():
        err = float((got_sd[k].float() - want.float()).abs().max())
        assert err <= 1e-5 * max(float(want.float().abs().max()), 1e-12), (k, err)
    np.testing.assert_allclose(buffer.numpy(), np.asarray(jax_state.buffer), rtol=0, atol=1e-4)
    np.testing.assert_allclose(buffer_cnt.numpy(), np.asarray(jax_state.buffer_cnt), rtol=0,
                               atol=1e-4)


def _snapshot(state):
    return ({k: v.clone() for k, v in state.model.state_dict().items()},
            state.buffer.clone(), state.buffer_cnt.clone())


@pytest.fixture(scope="module")
def step_pair():
    with pytest.MonkeyPatch.context() as mp:
        rng = np.random.RandomState(0)
        images = (rng.randn(2, IMG, IMG, 3) * 40).astype(np.float32)
        jm = JInterNet(**TINY, **STEP_MODEL, post_nms_train=64, strict_quirks=True)
        zeros = {"gt_class_ids": jnp.zeros((2, 6), jnp.int32), "gt_boxes": jnp.zeros((2, 6, 4)),
                 "gt_masks": jnp.zeros((2, 6, 14, 14))}
        key = jax.random.PRNGKey(0)
        variables = jax.jit(lambda: jm.init({"params": key, "sampling": key},
                                            jnp.asarray(images), mode="train", **zeros))()
        variables = {"params": _redraw(variables["params"], rng),
                     "batch_stats": _redraw(variables["batch_stats"], rng)}
        for level, scale in FPN_SCALES.items():
            out = variables["params"]["fpn"][f"p{level}_out"]
            out["kernel"], out["bias"] = out["kernel"] * scale, out["bias"] * scale
        model = InterNet(**TINY, **STEP_MODEL)
        model.load_state_dict(from_jax_params(variables["params"], variables["batch_stats"]))
        model.eval()
        with torch.no_grad():
            proposals = model.first_stage(T(images))[3].numpy()
        batch = dict(_batch(proposals, rng), images=images)

        cfg = build_config(opts=list(FLAGSHIP_OVERRIDES) + STEP_OPTS)
        jcfg = jax_build_config(opts=list(FLAGSHIP_OVERRIDES) + STEP_OPTS)
        recorder = StepRecorder(mp)
        n_anchors = int(model.anchors.shape[0])
        port_batch = {k: T(v) for k, v in batch.items()}
        jax_batch = {k: jnp.asarray(v) for k, v in batch.items()}

        # step 1: stage 'heads' from fresh states
        jstate = jax_create_train_state(jcfg, variables)
        jstate1, jm1 = jax.jit(make_train_step(jm, jcfg, "heads"))(
            jstate, jax_batch, jnp.float32(0.01), jnp.float32(1.0), jax.random.PRNGKey(1))
        state = create_train_state(cfg, model)
        set_trainable(model, "heads")
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        pm1 = train_step(state, cfg, port_batch, 0.01, 1.0, draws=recorder.feed(model, n_anchors))
        step1 = (pm1, jm1, _snapshot(state), jax.device_get(jstate1))

        # step 2: stage 'all', the port restarted from the JAX state
        load_trainer_state(state, from_jax_train_state(jax.device_get(jstate1)))
        jstate2, jm2 = jax.jit(make_train_step(jm, jcfg, "all"))(
            jstate1, jax_batch, jnp.float32(0.005), jnp.float32(1.0), jax.random.PRNGKey(2))
        set_trainable(model, "all")
        pm2 = train_step(state, cfg, port_batch, 0.005, 1.0, draws=recorder.feed(model, n_anchors))
        yield dict(step1=step1, step2=(pm2, jm2, _snapshot(state), jax.device_get(jstate2)),
                   steps=state.step, model=model, before=before)


def test_first_train_step_matches_jax(step_pair):
    pm, jm, port, jstate = step_pair["step1"]
    assert float(pm["positive_rois"]) > 0 and float(pm["meta_loss"]) > 0
    assert float(pm["small_rois_p3"]) > 0          # a positive on level 3 feeds level 2's big set
    _assert_step_equal(pm, jm, port, jstate)
    # 'heads' kept every other parameter bit for bit and moved the heads
    before, after = step_pair["before"], port[0]
    heads = trainable_names(step_pair["model"], "heads")
    for n, p in before.items():
        if n not in heads:
            assert torch.equal(after[n], p), n
    assert not torch.equal(after["classifier.linear_class.weight"],
                           before["classifier.linear_class.weight"])


def test_second_train_step_from_the_jax_state_matches_jax(step_pair):
    """The SGD momentum, buffer and step carried over by
    ``from_jax_train_state``; stage 'all', so the backbone's first step
    starts from a zero momentum on both sides."""
    pm, jm, port, jstate = step_pair["step2"]
    assert step_pair["steps"] == 2 and int(jstate.step) == 2
    _assert_step_equal(pm, jm, port, jstate)
