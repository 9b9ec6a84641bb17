"""The bfloat16 main path against the JAX package built with
``dtype=jnp.bfloat16``, on the CPU.

- One train step (stage 'all') of the port in bfloat16 against
  ``make_train_step`` of the JAX model in bfloat16, from the same float32
  weights, batch and uniform draws, the port fed the JAX step's proposals
  (as ``test_torch_train.py`` does in float32); a JAX float32 step and a
  port float32 step fed the same proposals and draws. JAX's own bfloat16
  error ``e = |jax_bf16 - jax_f32|`` and the float32 steps' difference ``d =
  |port_f32 - jax_f32|`` set the bounds. Each loss and the buffer:
  ``|port_bf16 - jax_f32| <= d + 2 e + f`` and ``|port_bf16 - jax_bf16| <= d
  + 2 e + f`` (maxima), with the floor ``f`` one bfloat16 rounding (2^-8)
  of the float32 value's magnitude (the buffer's largest). The parameters'
  updates, whose bfloat16 gradients are noisy tensor by tensor in JAX's
  own bfloat16 step too, are held as a whole and by distribution: over all
  parameters, the L2 norm of ``update_port_bf16 - update_jax_f32`` within
  1.5 of JAX's own ``||update_jax_bf16 - update_jax_f32||`` plus ``d``, and
  of ``update_port_bf16 - update_jax_bf16`` within 2 of it plus ``d``; per
  tensor, the relative L2 error of its update at most twice the largest
  JAX's own step shows, and in the median at most 1.5 times JAX's median.
  ``d`` is at float32 rounding: every class column of the float32 buffers
  agrees within 1e-4 (the big-set crop samples where the jitted JAX crop
  does, also for the boxes of this batch that end at exactly 1.0). Parameters,
  BN statistics, the SGD momentum, the buffer and a checkpoint stay
  float32.
- ``test_model`` of both packages in bfloat16 from the same weights, the
  port fed the JAX proposals: the 12 bbox and segm stats within 0.02.
- The command line trains and evaluates in bfloat16 by default
  (``TPU.COMPUTE_DTYPE``), and ``TEST.DTYPE float32`` re-types the model
  for ``--phase inference``.
"""

import test_torch_workers  # noqa: F401  (first: sizes this xdist worker's thread pools)

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature_intertwiner_tpu.config import build_config as jax_build_config
from feature_intertwiner_tpu.evaluation import COCO as JCOCO
from feature_intertwiner_tpu.models import detector as jax_detector
from feature_intertwiner_tpu.models.detector import InterNet as JInterNet
from feature_intertwiner_tpu.train import workflow as jax_workflow
from feature_intertwiner_tpu.train.step import create_train_state as jax_create_train_state
from feature_intertwiner_tpu.train.step import make_train_step
from feature_intertwiner_tpu_torch import main as port_main
from feature_intertwiner_tpu_torch.config import FLAGSHIP_OVERRIDES, build_config
from feature_intertwiner_tpu_torch.data import synthetic
from feature_intertwiner_tpu_torch.evaluation import COCO
from feature_intertwiner_tpu_torch.models.detector import InterNet
from feature_intertwiner_tpu_torch.train import checkpoint, workflow
from feature_intertwiner_tpu_torch.train.optim import set_trainable
from feature_intertwiner_tpu_torch.train.step import LOSS_KEYS, create_train_state, train_step
from feature_intertwiner_tpu_torch.utils.convert_weights import from_jax_params
from test_torch_eval import EVAL_OPTS, _jax_stats
from test_torch_model import KEY, TINY, _redraw
from test_torch_train import FPN_SCALES, IMG, STEP_MODEL, STEP_OPTS, StepRecorder, _batch
from test_torch_trainer import CLI_OPTS

T = torch.from_numpy
FLOOR = 2.0 ** -8     # one bfloat16 rounding


def assert_within_jax_bf16_error(name, got, got32, j32, j16, scale=None):
    """|got - j32| and |got - j16| within d + 2 e + FLOOR·scale, e = |j16 -
    j32|, d = |got32 - j32| (maxima over the tensor); ``scale`` defaults to
    max|j32|."""
    got, got32, j32, j16 = (np.asarray(x, np.float64) for x in (got, got32, j32, j16))
    scale = np.abs(j32).max() if scale is None else scale
    own = np.abs(j16 - j32).max()
    bound = np.abs(got32 - j32).max() + 2 * own + FLOOR * scale
    e32, e16 = np.abs(got - j32).max(), np.abs(got - j16).max()
    assert e32 <= bound and e16 <= bound, (name, e32, e16, own, scale)


@pytest.fixture(scope="module")
def bf16_step():
    with pytest.MonkeyPatch.context() as mp:
        rng = np.random.RandomState(0)
        images = (rng.randn(2, IMG, IMG, 3) * 40).astype(np.float32)
        kwargs = dict(**TINY, **STEP_MODEL, post_nms_train=64, strict_quirks=True)
        j16 = JInterNet(**kwargs, dtype=jnp.bfloat16)
        j32 = JInterNet(**kwargs)
        zeros = {"gt_class_ids": jnp.zeros((2, 6), jnp.int32), "gt_boxes": jnp.zeros((2, 6, 4)),
                 "gt_masks": jnp.zeros((2, 6, 14, 14))}
        key = jax.random.PRNGKey(0)
        variables = jax.jit(lambda: j16.init({"params": key, "sampling": key},
                                             jnp.asarray(images), mode="train", **zeros))()
        variables = {"params": _redraw(variables["params"], rng),
                     "batch_stats": _redraw(variables["batch_stats"], rng)}
        for level, scale in FPN_SCALES.items():
            out = variables["params"]["fpn"][f"p{level}_out"]
            out["kernel"], out["bias"] = out["kernel"] * scale, out["bias"] * scale
        models = {}
        for dtype in (torch.bfloat16, torch.float32):
            models[dtype] = InterNet(**TINY, **STEP_MODEL, dtype=dtype)
            models[dtype].load_state_dict(from_jax_params(variables["params"],
                                                          variables["batch_stats"]))
            models[dtype].eval()
        model = models[torch.bfloat16]
        with torch.no_grad():
            proposals = model.first_stage(T(images))[3].numpy()
        batch = dict(_batch(proposals, rng), images=images)
        cfg = build_config(opts=list(FLAGSHIP_OVERRIDES) + STEP_OPTS)
        jcfg = jax_build_config(opts=list(FLAGSHIP_OVERRIDES) + STEP_OPTS)
        jax_batch = {k: jnp.asarray(v) for k, v in batch.items()}
        step_key = jax.random.PRNGKey(1)

        # JAX in bfloat16, its proposals and draws recorded
        recorder = StepRecorder(mp)
        jstate16, jm16 = jax.jit(make_train_step(j16, jcfg, "all"))(
            jax_create_train_state(jcfg, variables), jax_batch, jnp.float32(0.01),
            jnp.float32(1.0), step_key)
        draws = recorder.feed(model, int(model.anchors.shape[0]))
        fed = jnp.asarray(recorder.seen["proposals"])
        # JAX in float32 on the same proposals (and, from the same key, draws)
        mp.setattr(jax_detector, "proposal_layer", lambda *a, **k: fed)
        jstate32, jm32 = jax.jit(make_train_step(j32, jcfg, "all"))(
            jax_create_train_state(jcfg, variables), jax_batch, jnp.float32(0.01),
            jnp.float32(1.0), step_key)
        mp.undo()                    # the JAX package as it was, for the module's other tests

        before = {k: v.clone() for k, v in model.state_dict().items()}
        steps = {}
        for dtype, m in models.items():
            m._propose = model._propose
            state = create_train_state(cfg, m)
            set_trainable(m, "all")
            metrics = train_step(state, cfg, {k: T(v) for k, v in batch.items()}, 0.01, 1.0,
                                 draws=draws)
            steps[dtype] = (metrics, state)
        (metrics, state), port32 = steps[torch.bfloat16], steps[torch.float32]
        yield dict(metrics=metrics, state=state, port32=port32, before=before, cfg=cfg,
                   j16=(jm16, jax.device_get(jstate16)), j32=(jm32, jax.device_get(jstate32)))


def test_bf16_train_step_matches_jax_bf16(bf16_step):
    pm, (pm32, state32) = bf16_step["metrics"], bf16_step["port32"]
    (jm16, js16), (jm32, js32) = bf16_step["j16"], bf16_step["j32"]
    assert float(pm["positive_rois"]) > 0 and float(pm["meta_loss"]) > 0
    for k in LOSS_KEYS + ("meta_loss", "total_loss"):
        assert_within_jax_bf16_error(k, float(pm[k]), float(pm32[k]), float(jm32[k]),
                                     float(jm16[k]))
    state, before = bf16_step["state"], bf16_step["before"]
    sds = (state.model.state_dict(), state32.model.state_dict(),
           from_jax_params(js16.params, js16.batch_stats),
           from_jax_params(js32.params, js32.batch_stats))
    # each tensor's update, where bfloat16 shows: port bf16, port f32, JAX bf16, JAX f32
    updates = {k: [(sd[k].double() - p0.double()).numpy().ravel() for sd in sds]
               for k, p0 in before.items()}
    moved = {k: u for k, u in updates.items() if np.abs(u[3]).max() > 0}
    assert len(moved) > 100 and all(np.abs(u[0]).max() > 0 for u in moved.values())
    u16, u32p, j16, j32 = (np.concatenate([u[i] for u in moved.values()]) for i in range(4))
    norm = np.linalg.norm
    own, d = norm(j16 - j32), norm(u32p - j32)
    assert norm(u16 - j32) <= 1.5 * own + d, (norm(u16 - j32), own, d)
    assert norm(u16 - j16) <= 2.0 * own + d, (norm(u16 - j16), own, d)
    rel_port = np.array([norm(u[0] - u[3]) / norm(u[3]) for u in moved.values()])
    rel_jax = np.array([norm(u[2] - u[3]) / norm(u[3]) for u in moved.values()])
    assert rel_port.max() <= 2 * rel_jax.max(), (rel_port.max(), rel_jax.max())
    assert np.median(rel_port) <= 1.5 * np.median(rel_jax)
    # in float32 every class column of the buffer agrees with JAX's
    per_class = np.abs(state32.buffer.numpy() - np.asarray(js32.buffer))[0].max(axis=0)
    assert per_class.max() < 1e-4, per_class
    for name, got, got32, a, b in (
            ("buffer", state.buffer, state32.buffer, js32.buffer, js16.buffer),
            ("buffer_cnt", state.buffer_cnt, state32.buffer_cnt, js32.buffer_cnt,
             js16.buffer_cnt)):
        assert_within_jax_bf16_error(name, got.numpy(), got32.numpy(), np.asarray(a),
                                     np.asarray(b))


def test_bf16_training_keeps_float32_state(bf16_step, tmp_path):
    """Parameters, BN statistics, momentum, buffer and a checkpoint's
    tensors stay float32; the model still computes in bfloat16."""
    state = bf16_step["state"]
    assert state.model.dtype == torch.bfloat16
    assert all(v.dtype in (torch.float32, torch.int64) for v in state.model.state_dict().values())
    assert all(s["momentum_buffer"].dtype == torch.float32
               for s in state.optimizer.state.values())
    assert state.buffer.dtype == state.buffer_cnt.dtype == torch.float32
    path = checkpoint.save_checkpoint(str(tmp_path), state, epoch=1, iter_ind=1)
    payload = torch.load(path, weights_only=True)
    tensors = [v for v in payload["model"].values()] + [payload["buffer"]]
    assert all(t.dtype in (torch.float32, torch.int64) for t in tensors)


# --- test_model in bfloat16 ---------------------------------------------------------------
def test_bf16_test_model_stats_match_jax(tmp_path):
    """Both packages' ``test_model`` in bfloat16, with masks, on 5 synthetic
    128² images from one set of weights; the port is fed the JAX proposals
    (a near-tie can flip in bfloat16 as in float32)."""
    data = synthetic.generate(num_images=5, size=(128, 128), seed=6, max_instances=3)
    gt = data.coco_dataset()
    cfg, jcfg = build_config(opts=EVAL_OPTS), jax_build_config(opts=EVAL_OPTS)
    jm = JInterNet.from_config(jcfg, dtype=jnp.bfloat16)
    images = np.stack([data.load_image(i) for i in range(2)]).astype(np.float32)
    windows = jnp.asarray(np.array([[0, 0, 128, 128]] * 2, np.float32))
    variables = jm.init({"params": KEY}, jnp.asarray(images), mode="inference", windows=windows)
    rng = np.random.RandomState(25)
    v = {"params": _redraw(variables["params"], rng),
         "batch_stats": _redraw(variables["batch_stats"], rng)}
    pm = InterNet.from_config(cfg, dtype=torch.bfloat16)
    pm.load_state_dict(from_jax_params(v["params"], v["batch_stats"]), strict=True)
    pm = pm.to(memory_format=torch.channels_last).eval()
    for name, c in (("port", cfg), ("jax", jcfg)):
        c.MISC.RESULT_FOLDER = str(tmp_path / name)
        c.MISC.LOG_FILE = str(tmp_path / name / "log.txt")
    api = COCO(dataset=json.loads(json.dumps(gt)))
    japi = JCOCO()
    japi.dataset = json.loads(json.dumps(gt))
    japi.create_index()

    seen = []
    propose = jax_detector.proposal_layer

    def recorded(*args, **kwargs):
        p = propose(*args, **kwargs)
        jax.debug.callback(lambda a: seen.append(np.array(a)), p)
        return p

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_detector, "proposal_layer", recorded)
        jstats = jax_workflow.test_model(jm, v, jcfg, data, japi, epoch=3, eval_masks=True)
        jax.effects_barrier()
    bs = cfg.TEST.BATCH_SIZE
    props = np.concatenate(seen)[:5]
    chunks = [torch.from_numpy(props[i:i + bs]) for i in range(0, 5, bs)]
    pm._propose = lambda *args: chunks.pop(0)
    stats = workflow.test_model(pm, cfg, data, api, epoch=3, eval_masks=True)
    assert not chunks
    img_ids = [i["id"] for i in gt["images"]]
    segm = {}
    for name, c in (("port", cfg), ("jax", jcfg)):
        with open(os.path.join(c.MISC.RESULT_FOLDER, "det_result_ep0003_n5_masks.json")) as f:
            results = json.load(f)
        assert results
        segm[name] = (workflow.coco_stats(api, results, img_ids, "segm") if name == "port"
                      else _jax_stats(japi, results, img_ids, "segm"))
    np.testing.assert_allclose(stats, np.asarray(jstats), rtol=0, atol=0.02)
    np.testing.assert_allclose(segm["port"], segm["jax"], rtol=0, atol=0.02)


# --- the command line -----------------------------------------------------------------------
def test_cli_trains_and_evaluates_in_bf16_by_default(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    base = ["--synthetic_data", "--device", "cpu", "--config_name", "bf", *CLI_OPTS]
    trainer = port_main.main(["--phase", "train", *base, "TRAIN.SCHEDULE", "[1, 0, 0]",
                              "TRAIN.DO_VALIDATION", "False"])
    assert trainer.model.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in trainer.model.parameters())
    log = (tmp_path / "results/bf/train/log.txt").read_text()
    assert "compute dtype torch.bfloat16" in log
    seen = []
    forward = InterNet.forward_inference

    def recording(self, images, *args, **kwargs):
        seen.append(self.dtype)
        return forward(self, images, *args, **kwargs)

    monkeypatch.setattr(InterNet, "forward_inference", recording)
    stats = port_main.main(["--phase", "inference", *base, "TEST.DTYPE", "float32"])
    assert stats.shape == (12,) and seen and set(seen) == {torch.float32}
    assert (tmp_path / "results/bf/inference/det_result_ep0001_n8_float32.json").exists()
