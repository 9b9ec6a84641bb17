"""Training with the OT meta loss (``DEV.LOSS_CHOICE ot``) and the FPN OT
loss (``TRAIN.FPN_OT_LOSS``): the port against the jitted JAX step, on the
CPU, and the command line on ``configs/104/meta_104_conv.yaml``.

Two cases, each one 'all' train step from the same weights, batch, uniform
draws and proposals as ``test_torch_train.py`` sets them up:
- ``conv_fpn``: ``OT_ONE_DIM_FORM conv`` with the FPN OT loss on;
- ``fc``: ``OT_ONE_DIM_FORM fc`` (in ``test_torch_ot_fc.py``, so that its
  JAX compilation runs on another worker).

The proposals fed to both packages keep one float32 ulp inside the image:
at a box that ends at exactly 1.0 the jitted JAX step's forward and its
gradient disagree on the last sample row (its ``fc1`` weight gradient lacks
exactly that row of one RoI of the ``fc`` batch, which its forward pooled;
ROADMAP "Not faults"), and the port, whose forward and gradient agree,
cannot follow both. ``test_torch_crop_rounding.py`` holds the forward at
such boxes.

Float32 (ROADMAP tolerances): the five losses, ``fpn_ot_loss`` and
``total_loss`` within 1e-4 relative; the meta loss, a weighted sum of
debiased divergences that can be far smaller than their terms, within 1e-4
of the sum of its terms' magnitudes; parameters within 1e-5 of each
tensor's largest magnitude; the buffer within 1e-4.

bfloat16 (``conv_fpn``): the port in bfloat16 against the JAX step in
bfloat16 and in float32, as ``test_torch_bf16_slice.py`` holds the flagship
step: each loss and the buffer within ``d + 2 e + f``, the parameter
updates as a whole and by distribution within JAX's own bfloat16 error.

The 1-D OT has almost no gradient (rows of dimension 1: the cosine cost is
``1 - sign sign``, and the plan is detached), in JAX too, so no test
expects the ``ot_loss`` weights to move beyond what JAX moves them.
"""

import test_torch_workers  # noqa: F401  (first: sizes this xdist worker's thread pools)

import json
import pathlib
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature_intertwiner_tpu.config import build_config as jax_build_config
from feature_intertwiner_tpu.models import detector as jax_detector
from feature_intertwiner_tpu.ops import sinkhorn as jsk
from feature_intertwiner_tpu.train.step import create_train_state as jax_create_train_state
from feature_intertwiner_tpu.train.step import make_train_step
from feature_intertwiner_tpu_torch import main as port_main
from feature_intertwiner_tpu_torch.config import FLAGSHIP_OVERRIDES, build_config
from feature_intertwiner_tpu_torch.models.detector import InterNet
from feature_intertwiner_tpu_torch.train.optim import set_trainable
from feature_intertwiner_tpu_torch.train.step import LOSS_KEYS, create_train_state, train_step
from feature_intertwiner_tpu_torch.utils.convert_weights import from_jax_params
from test_torch_bf16_slice import assert_within_jax_bf16_error
from test_torch_model import TINY, JInterNet, _redraw
from test_torch_train import FPN_SCALES, IMG, STEP_MODEL, STEP_OPTS, StepRecorder, _batch
from test_torch_trainer import CLI_OPTS

T = torch.from_numpy
CASES = {"conv_fpn": ("conv", True), "fc": ("fc", False)}
# The P2 output conv, scaled by 0.1 in FPN_SCALES, takes in the conv_fpn
# step an update of 12% of its largest magnitude (the next tensor 1.2%), so
# 1e-5 of that magnitude asks 8e-5 of its update: it lies 1.1e-4 of its
# update from JAX's, closer than the median tensor (3.2e-4 of its update;
# ROADMAP "Not faults"; running this file prints it)
TEMPERED = {("conv_fpn", "fpn.P2_conv2.1.weight"): 2e-5}


def _case(name):
    form, fpn = CASES[name]
    model = dict(STEP_MODEL, dev_loss_choice="ot", dev_ot_one_dim_form=form, fpn_ot_loss=fpn)
    opts = STEP_OPTS + ["DEV.LOSS_CHOICE", "ot", "DEV.OT_ONE_DIM_FORM", form,
                        "TRAIN.FPN_OT_LOSS", str(fpn)]
    return model, list(FLAGSHIP_OVERRIDES) + opts


def _meta_terms(model, stats_rows):
    """The scale of the meta loss's cancellation: the sum over the weighted
    samples of their three OT terms' magnitudes, ``w (2 |OT(x, y)| + |OT(x,
    x)| + |OT(y, y)|)``, recomputed in JAX on the port's critic embeddings of
    the step's rows."""
    small, big, w = stats_rows
    with torch.no_grad():
        ot = model.ot_loss
        cx = ot.embed(ot.G_net(small[:, :, None])).numpy()
        cy = ot.embed(big[:, :, None]).numpy()
    xy, xx, yy = (np.abs(np.asarray(jax.vmap(lambda p, q: jsk.sinkhorn_ot(p, q))(a, b)))
                  for a, b in ((cx, cy), (cx, cx), (cy, cy)))
    return float((w.numpy() * (2 * xy + xx + yy)).sum())


def _steps(name, inside=True, dtypes=None):
    """One 'all' step of both packages, in float32 and (``conv_fpn``) in
    bfloat16, on the same proposals: the float32 port model's, with every
    edge at 1.0 moved one float32 ulp inside the image (see the module
    docstring), fed to every step; with ``inside=False`` the first JAX
    step's own. The JAX step's draws feed the port's."""
    model_kw, opts = _case(name)
    if dtypes is None:
        dtypes = (torch.bfloat16, torch.float32) if name == "conv_fpn" else (torch.float32,)
    with pytest.MonkeyPatch.context() as mp:
        rng = np.random.RandomState(0)
        images = (rng.randn(2, IMG, IMG, 3) * 40).astype(np.float32)
        kwargs = dict(**TINY, **model_kw, post_nms_train=64, strict_quirks=True)
        jms = {torch.float32: JInterNet(**kwargs), torch.bfloat16: JInterNet(**kwargs,
                                                                             dtype=jnp.bfloat16)}
        zeros = {"gt_class_ids": jnp.zeros((2, 6), jnp.int32), "gt_boxes": jnp.zeros((2, 6, 4)),
                 "gt_masks": jnp.zeros((2, 6, 14, 14))}
        key = jax.random.PRNGKey(0)
        variables = jax.jit(lambda: jms[dtypes[0]].init(
            {"params": key, "sampling": key}, jnp.asarray(images), mode="train", **zeros))()
        variables = {"params": _redraw(variables["params"], rng),
                     "batch_stats": _redraw(variables["batch_stats"], rng)}
        for level, scale in FPN_SCALES.items():
            out = variables["params"]["fpn"][f"p{level}_out"]
            out["kernel"], out["bias"] = out["kernel"] * scale, out["bias"] * scale
        models = {}
        for dtype in dtypes:
            models[dtype] = InterNet(**TINY, **model_kw, dtype=dtype)
            models[dtype].load_state_dict(from_jax_params(variables["params"],
                                                          variables["batch_stats"]))
            models[dtype].eval()
        with torch.no_grad():
            proposals = models[torch.float32].first_stage(T(images))[3].numpy()
        if inside:
            proposals = np.minimum(proposals, np.nextafter(np.float32(1), np.float32(0)))
        batch = dict(_batch(proposals, rng), images=images)
        cfg, jcfg = build_config(opts=opts), jax_build_config(opts=opts)
        jax_batch = {k: jnp.asarray(v) for k, v in batch.items()}
        step_key = jax.random.PRNGKey(1)

        if inside:
            fed = jnp.asarray(proposals)
            mp.setattr(jax_detector, "proposal_layer", lambda *a, **k: fed)
        else:
            assert len(dtypes) == 1, "one JAX step proposes for the port"
        recorder = StepRecorder(mp)
        first = models[torch.float32]
        jax_steps = {}
        for dtype in dtypes:
            jstate, jmetrics = jax.jit(make_train_step(jms[dtype], jcfg, "all"))(
                jax_create_train_state(jcfg, variables), jax_batch, jnp.float32(0.01),
                jnp.float32(1.0), step_key)
            jax_steps[dtype] = ({k: float(v) for k, v in jmetrics.items()},
                                jax.device_get(jstate))
        draws = recorder.feed(first, int(first.anchors.shape[0]))

    before = {k: v.clone() for k, v in first.state_dict().items()}
    port_steps, rows = {}, {}
    for dtype, m in models.items():
        m._propose = first._propose
        state = create_train_state(cfg, m)
        set_trainable(m, "all")
        meta_ot = m.meta_ot

        def recording(small, big, w, meta_ot=meta_ot, dtype=dtype):
            rows[dtype] = (small.detach().clone(), big.detach().clone(), w.clone())
            return meta_ot(small, big, w)
        m.meta_ot = recording
        metrics = train_step(state, cfg, {k: T(v) for k, v in batch.items()}, 0.01, 1.0,
                             draws=draws)
        del m.meta_ot
        port_steps[dtype] = ({k: float(v) for k, v in metrics.items()}, state)
    # the meta loss's terms, on the float32 model before its step
    check = InterNet(**TINY, **model_kw)
    check.load_state_dict(before)
    terms = _meta_terms(check, rows[torch.float32])
    return dict(name=name, port=port_steps, jax=jax_steps, before=before, terms=terms)


@pytest.fixture(scope="module")
def conv_fpn_step():
    return _steps("conv_fpn")


def check_float32_step(ot_step):
    """The float32 step of one case against JAX's (module docstring)."""
    name = ot_step["name"]
    (pm, state), (jm, js) = ot_step["port"][torch.float32], ot_step["jax"][torch.float32]
    assert pm["positive_rois"] > 0
    for k in LOSS_KEYS + ("fpn_ot_loss", "total_loss"):
        assert abs(pm[k] - jm[k]) <= 1e-4 * max(abs(jm[k]), 1e-6), (k, pm[k], jm[k])
    assert abs(pm["meta_loss"] - jm["meta_loss"]) <= 1e-4 * ot_step["terms"], (
        pm["meta_loss"], jm["meta_loss"], ot_step["terms"])
    if ot_step["name"] == "conv_fpn":
        assert pm["fpn_ot_loss"] > 0
    else:
        assert pm["meta_loss"] > 0
    got_sd = state.model.state_dict()
    want_sd = from_jax_params(js.params, js.batch_stats)
    assert got_sd.keys() == want_sd.keys()
    moved = 0
    for k, want in want_sd.items():
        err = float((got_sd[k].float() - want.float()).abs().max())
        tol = TEMPERED.get((name, k), 1e-5)
        assert err <= tol * max(float(want.float().abs().max()), 1e-12), (k, err)
        moved += ("_ot." in k or k.startswith("ot_loss.")) and not torch.equal(
            got_sd[k], ot_step["before"][k])
    assert moved > 0                           # the OT weights took their step
    np.testing.assert_allclose(state.buffer.numpy(), np.asarray(js.buffer), rtol=0, atol=1e-4)
    np.testing.assert_allclose(state.buffer_cnt.numpy(), np.asarray(js.buffer_cnt), rtol=0,
                               atol=1e-4)


def test_ot_train_step_matches_jax_in_float32(conv_fpn_step):
    check_float32_step(conv_fpn_step)


def test_ot_train_step_in_bf16_is_within_jax_bf16_error(conv_fpn_step):
    step = conv_fpn_step
    (pm, state), (pm32, state32) = step["port"][torch.bfloat16], step["port"][torch.float32]
    (jm16, js16), (jm32, js32) = step["jax"][torch.bfloat16], step["jax"][torch.float32]
    assert pm["positive_rois"] > 0 and pm["fpn_ot_loss"] > 0
    for k in LOSS_KEYS + ("fpn_ot_loss", "total_loss"):
        assert_within_jax_bf16_error(k, pm[k], pm32[k], jm32[k], jm16[k])
    # the debiased divergences cancel: the meta loss is held at the scale of
    # its terms
    assert_within_jax_bf16_error("meta_loss", pm["meta_loss"], pm32["meta_loss"],
                                 jm32["meta_loss"], jm16["meta_loss"], scale=step["terms"])
    before = step["before"]
    sds = (state.model.state_dict(), state32.model.state_dict(),
           from_jax_params(js16.params, js16.batch_stats),
           from_jax_params(js32.params, js32.batch_stats))
    updates = {k: [(sd[k].double() - p0.double()).numpy().ravel() for sd in sds]
               for k, p0 in before.items()}
    moved = {k: u for k, u in updates.items() if np.abs(u[3]).max() > 0}
    assert any("_ot." in k for k in moved)
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


@pytest.mark.parametrize("fpn_ot", [False, True], ids=["meta_ot", "meta_ot_and_fpn_ot"])
def test_cli_trains_the_104_recipe(tmp_path, monkeypatch, fpn_ot):
    """``--config_file configs/104/meta_104_conv.yaml`` (OT meta loss, conv
    form) at a tiny size on the CPU, and with ``TRAIN.FPN_OT_LOSS True``:
    the logged metrics carry a finite meta loss and FPN OT loss."""
    config = str(pathlib.Path(__file__).resolve().parents[1] / "configs/104/meta_104_conv.yaml")
    monkeypatch.chdir(tmp_path)
    trainer = port_main.main([
        "--phase", "train", "--synthetic_data", "--device", "cpu", "--config_file", config,
        *CLI_OPTS, "TRAIN.BATCH_SIZE", "4", "TRAIN.SCHEDULE", "[1, 0, 0]",
        "TRAIN.DO_VALIDATION", "False", "TRAIN.FPN_OT_LOSS", str(fpn_ot)])
    cfg = trainer.cfg
    assert cfg.DEV.LOSS_CHOICE == "ot" and cfg.DEV.OT_ONE_DIM_FORM == "conv"
    assert trainer.model.ot_loss is not None and trainer.model.fpn.fpn_ot_loss == fpn_ot
    assert trainer.state.step == 2                  # 8 synthetic images at the YAML's batch 4
    lines = [json.loads(x) for x in (tmp_path / "results/meta_104_conv/train/metrics.jsonl").read_text()
             .splitlines()]
    steps = [x for x in lines if "meta_loss" in x]
    assert steps
    for x in steps:
        assert np.isfinite(x["meta_loss"]) and np.isfinite(x["fpn_ot_loss"])
        assert np.isfinite(x["total_loss"])
    assert any(x["fpn_ot_loss"] > 0 for x in steps) == fpn_ot
    # the run's checkpoint holds about 0.5 GB: free it for the tests after
    shutil.rmtree(tmp_path / "results")


def test_chip_smoke_ot_recipe_is_the_104_yaml():
    """``chip_smoke.py`` trains the 104 recipe from options (the card's
    machine has no PyYAML): they give the YAML's config."""
    import importlib.util

    root = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke", root / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    from_yaml = build_config("meta_104_conv", "train",
                             config_file=str(root / "configs/104/meta_104_conv.yaml"))
    from_opts = build_config("meta_104_conv", "train", opts=chip_smoke.OT_RECIPE)
    def flat(node, prefix=""):
        out = {}
        for k, v in node.items():
            if hasattr(v, "items"):
                out.update(flat(v, f"{prefix}{k}."))
            else:
                out[prefix + k] = v
        return out

    a, b = flat(from_yaml._tree), flat(from_opts._tree)
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(np.asarray(a[k], dtype=object), np.asarray(b[k], dtype=object)), k


def _report_float32_step(name, inside=True):
    """Print each tensor's distance from JAX's after the float32 step, of its
    magnitude and of its update, worst first."""
    step = _steps(name, inside, dtypes=(torch.float32,))
    got = step["port"][torch.float32][1].model.state_dict()
    js = step["jax"][torch.float32][1]
    rows = []
    for k, want in from_jax_params(js.params, js.batch_stats).items():
        w, b = want.double(), step["before"][k].double()
        upd, err = float((w - b).abs().max()), float((got[k].double() - w).abs().max())
        if upd > 0:
            rows.append((err / float(w.abs().max()), err / upd, upd / float(w.abs().max()), k))
    rows.sort(reverse=True)
    print(f"{name}, proposals {'one ulp inside' if inside else 'as JAX proposes'}: "
          f"median error {np.median([r[1] for r in rows]):.3g} of the update")
    for r in rows[:4]:
        print("  error %.3g of its magnitude, %.3g of its update; update %.3g of its "
              "magnitude: %s" % r)
    return got, from_jax_params(js.params, js.batch_stats)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    _report_float32_step("conv_fpn")
    got, want = _report_float32_step("fc", inside=False)
    k = "classifier.conv1.weight"
    rows = ((got[k] - want[k]).abs().amax(dim=(0, 1, 3)) / want[k].abs().max()).tolist()
    print(f"fc, as JAX proposes: {k} differs from JAX's by kernel row, of its magnitude: "
          + ", ".join(f"{r:.3g}" for r in rows))
