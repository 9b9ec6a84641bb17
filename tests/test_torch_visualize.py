"""The visualize phase and ``TEST.SAVE_IM`` in the port against the JAX
package, on the CPU.

- ``InterNet.forward_visualize`` against the JAX ``model.apply(...,
  mode="visualize")`` from the same weights (``from_jax_params``) and
  images, with ``CLS_MERGE_FEAT`` off and on. The port is fed the JAX
  proposals (its own lie within 1e-5 of them; a near-tie of the proposal
  NMS could otherwise reorder them, as in ``test_torch_model.py``).
  Detections are held as there: equal counts and classes, boxes within one
  pixel, scores within 1e-4. Features (the classifier's 1024-d penultimate
  feature per detection) within 1e-4 relative to their largest magnitude,
  in float32, and zero on the padding rows where JAX's are. In bfloat16
  the features are held to JAX's own bfloat16 error
  (``test_torch_bf16_slice.py::assert_within_jax_bf16_error``).
- ``python -m feature_intertwiner_tpu_torch.main --phase visualize``
  writes ``features.npz`` with the keys, shapes and dtypes that the JAX
  ``main.py`` writes: ``features`` [N, M, 1024] and ``detections``
  [N, M, 6], float32, for the N images of the set.
- ``utils/visualize.py``: ``display_instances`` and ``plot_loss_curves``
  draw PNGs whose decoded pixels equal the JAX package's from the same
  inputs (colours shuffled from seed 0 in both), ``apply_mask`` is
  bit-equal.
- ``test_model`` with ``TEST.SAVE_IM`` writes ``images/det_<id>.png`` for
  each evaluated image, on one scale and on two, and raises
  ``ImportError`` before any inference where matplotlib is missing.
"""

import test_torch_workers  # noqa: F401  (first: sizes this xdist worker's thread pools)

import functools
import json
import random
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from feature_intertwiner_tpu.models import detector as jax_detector
from feature_intertwiner_tpu.models.detector import InterNet as JInterNet
from feature_intertwiner_tpu.utils import visualize as jax_vis
from feature_intertwiner_tpu_torch import build_model
from feature_intertwiner_tpu_torch import main as port_main
from feature_intertwiner_tpu_torch.config import build_config
from feature_intertwiner_tpu_torch.data import synthetic
from feature_intertwiner_tpu_torch.evaluation import COCO
from feature_intertwiner_tpu_torch.models.detector import InterNet
from feature_intertwiner_tpu_torch.train import workflow
from feature_intertwiner_tpu_torch.utils import visualize as vis
from feature_intertwiner_tpu_torch.utils.convert_weights import from_jax_params
from test_torch_bf16_slice import assert_within_jax_bf16_error
from test_torch_eval import EVAL_OPTS
from test_torch_model import IMG, KEY, TINY, _redraw, assert_rel
from test_torch_trainer import CLI_OPTS

T = torch.from_numpy
# RoI levels as at 1024² (base 224 over a 128² image), so that the merge
# has RoIs of the meta levels to act on; room for more detections than the
# random model keeps, so that some rows are padding
MODEL = dict(TINY, assign_base=56.0, det_max_instances=32)
WINDOWS = np.array([[0, 0, IMG, IMG], [16, 0, 112, IMG]], np.float32)


def _jax_visualize(jm, v, images, proposals=None):
    """JAX ``mode="visualize"`` (un-jitted): its outputs and proposals; fed
    ``proposals`` where given."""
    seen = []
    propose = jax_detector.proposal_layer

    def recorded(*args, **kwargs):
        p = propose(*args, **kwargs) if proposals is None else jnp.asarray(proposals)
        seen.append(np.array(p))
        return p

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_detector, "proposal_layer", recorded)
        out = jm.apply(v, jnp.asarray(images), mode="visualize", windows=jnp.asarray(WINDOWS))
    return {k: np.asarray(x) for k, x in out.items()}, seen[0]


def _port_visualize(pm, images, proposals):
    """The port's ``forward_visualize``, its proposal layer giving
    ``proposals``."""
    pm._propose = lambda *args: T(proposals)
    try:
        with torch.inference_mode():
            out = pm.forward_visualize(T(images), T(WINDOWS))
    finally:
        del pm._propose
    return {k: x.float().numpy() for k, x in out.items()}


@functools.lru_cache(maxsize=None)
def _weights():
    """The JAX model's variables (one init serves both merge settings: the
    critic is there either way), BN statistics, scales and biases redrawn,
    and the images."""
    rng = np.random.RandomState(31)
    images = (rng.randn(2, IMG, IMG, 3) * 40).astype(np.float32)
    variables = jax.jit(lambda: _jax_model(True).init(
        {"params": KEY}, jnp.asarray(images), mode="inference", windows=jnp.asarray(WINDOWS)))()
    v = {"params": _redraw(variables["params"], rng),
         "batch_stats": _redraw(variables["batch_stats"], rng)}
    return v, images


def _jax_model(merge, dtype=jnp.float32):
    return JInterNet(**MODEL, cls_merge_feat=merge, post_nms_train=64, rois_per_image=24,
                     dev_loss_choice="l2", strict_quirks=True, dtype=dtype)


def _port_model(v, merge, dtype=torch.float32):
    pm = InterNet(**MODEL, cls_merge_feat=merge, dtype=dtype)
    pm.load_state_dict(from_jax_params(v["params"], v["batch_stats"]), strict=True)
    return pm.to(memory_format=torch.channels_last).eval()


@functools.lru_cache(maxsize=None)
def _vis_case(merge):
    v, images = _weights()
    want, props = _jax_visualize(_jax_model(merge), v, images)
    pm = _port_model(v, merge)
    with torch.inference_mode():
        pyramid, _, _, own = pm.first_stage(T(images))
        small = ()
        if merge:
            maps = pm.dev_roi.pooling_maps(pyramid[:4])
            small = pm.dev_roi.small_features(pm.dev_roi.pool(maps, T(props), 14), T(props))
    return dict(merge=merge, v=v, images=images, props=props, own=own.numpy(), want=want,
                got=_port_visualize(pm, images, props), small=small)


@pytest.fixture(scope="module", params=[False, True], ids=["merge_off", "merge_on"])
def vis_pair(request):
    return _vis_case(request.param)


def test_visualize_forward_matches_jax(vis_pair):
    np.testing.assert_allclose(vis_pair["own"], vis_pair["props"], rtol=0, atol=1e-5)
    if vis_pair["merge"]:
        assert float(vis_pair["small"][1].sum()) > 0    # the merge has RoIs to act on
    want, got = vis_pair["want"], vis_pair["got"]
    assert set(got) == set(want) == {"detections", "features"}
    wd, gd = want["detections"], got["detections"]
    assert gd.shape == wd.shape == (2, 32, 6)
    valid = wd[..., 5] > 0
    np.testing.assert_array_equal(gd[..., 5] > 0, valid)
    assert valid.any() and not valid.all()
    np.testing.assert_array_equal(gd[..., 4], wd[..., 4])
    np.testing.assert_allclose(gd[..., :4], wd[..., :4], rtol=0, atol=1.0)
    np.testing.assert_allclose(gd[..., 5], wd[..., 5], rtol=0, atol=1e-4)
    wf, gf = want["features"], got["features"]
    assert gf.shape == wf.shape == (2, 32, 1024) and gf.dtype == wf.dtype == np.float32
    assert_rel(gf[valid], wf[valid])
    assert (wf[~valid] == 0).all() and (gf[~valid] == 0).all()
    assert (np.abs(wf[valid]).max(-1) > 0).all()


def _alike(ref, other):
    """For each detection of ``ref`` [B, M, 6], the row of ``other`` with
    its class and its box within one pixel, or -1."""
    out = np.full(ref.shape[:2], -1)
    for b, i in zip(*np.nonzero(ref[..., 5] > 0)):
        ok = ((other[b, :, 5] > 0) & (other[b, :, 4] == ref[b, i, 4])
              & (np.abs(other[b, :, :4] - ref[b, i, :4]).max(-1) <= 1))
        if ok.any():
            out[b, i] = np.flatnonzero(ok)[0]
    return out


def test_visualize_in_bf16_is_within_jax_bf16_error():
    """The merge-off model in bfloat16 in both packages, all four runs fed
    the float32 JAX proposals. bfloat16 scores reorder near-ties and change
    which detections the NMS keeps, so rows are paired by class and box
    (within one pixel) with JAX's float32 detections; at least 90% of those
    have a twin in every run. On those the port's bfloat16 features lie as
    near JAX's float32 and bfloat16 features as JAX's bfloat16 lies from its
    float32 (within twice that, plus the float32 runs' difference and one
    bfloat16 rounding of the largest feature)."""
    case = _vis_case(False)
    props, images, v = case["props"], case["images"], case["v"]
    j16, _ = _jax_visualize(_jax_model(False, jnp.bfloat16), v, images, props)
    p16 = _port_visualize(_port_model(v, False, torch.bfloat16), images, props)
    j32, p32 = case["want"], case["got"]
    assert p16["features"].dtype == np.float32
    twins = {name: _alike(j32["detections"], r["detections"])
             for name, r in (("p16", p16), ("j16", j16), ("p32", p32))}
    common = np.all([t >= 0 for t in twins.values()], 0)
    valid = j32["detections"][..., 5] > 0
    assert common.sum() >= 0.9 * valid.sum() > 0
    b, i = np.nonzero(common)
    feats = {name: r["features"][b, twins[name][b, i]]
             for name, r in (("p16", p16), ("j16", j16), ("p32", p32))}
    assert_within_jax_bf16_error("features", feats["p16"], feats["p32"],
                                 j32["features"][b, i], feats["j16"])
    for r in (p16, j16):
        assert (r["features"][r["detections"][..., 5] == 0] == 0).all()


def test_cli_visualize_writes_the_jax_features_file(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    path = port_main.main(["--phase", "visualize", "--synthetic_data", "--device", "cpu",
                           "--config_name", "vis", *CLI_OPTS])
    assert path == "results/vis/visualize/features.npz"
    with np.load(tmp_path / path) as data:
        out = {k: data[k] for k in data.files}
    # the JAX main.py: np.savez(features=np.stack([out["features"][0]]),
    # detections=np.stack([out["detections"][0]])), one image at a time
    assert set(out) == {"features", "detections"}
    assert out["features"].shape == (8, 100, 1024) and out["features"].dtype == np.float32
    assert out["detections"].shape == (8, 100, 6) and out["detections"].dtype == np.float32
    valid = out["detections"][..., 5] > 0
    assert valid.any() and (out["features"][~valid] == 0).all()
    assert "saved features to" in (tmp_path / "results/vis/visualize/log.txt").read_text()


# --- drawing ------------------------------------------------------------------------------
def _drawing_case():
    rng = np.random.RandomState(40)
    image = (rng.rand(96, 128, 3) * 255).astype(np.uint8)
    boxes = np.array([[10, 10, 40, 50], [30, 60, 90, 120], [5, 5, 20, 100]])
    masks = np.zeros((3, 96, 128), np.uint8)
    masks[0, 12:30, 12:40] = 1
    masks[2, 6:18, 6:90] = 1
    return image, boxes, np.array([1, 2, 3]), ["BG", "a", "b", "c"], np.array([0.9, 0.5, 0.123]), masks


def _pixels(path):
    return np.asarray(Image.open(path))


@pytest.mark.parametrize("with_masks", [False, True])
def test_display_instances_draws_the_jax_picture(tmp_path, with_masks):
    image, boxes, ids, names, scores, masks = _drawing_case()
    masks = masks if with_masks else None
    random.seed(0)
    want = jax_vis.display_instances(image, boxes, ids, names, scores=scores, masks=masks,
                                     title="t", save_path=str(tmp_path / "jax/det.png"))
    got = vis.display_instances(image, boxes, ids, names, scores=scores, masks=masks,
                                title="t", save_path=str(tmp_path / "port/det.png"))
    a, b = _pixels(got), _pixels(want)
    assert a.shape == b.shape and a.shape[0] > 500
    np.testing.assert_array_equal(a, b)


def test_apply_mask_and_random_colors_are_bit_equal():
    image, _, _, _, _, masks = _drawing_case()
    random.seed(3)
    colors = jax_vis.random_colors(5)
    assert vis.random_colors(5, rng=random.Random(3)) == colors
    for color in colors:
        want = jax_vis.apply_mask(image.astype(np.float32), masks[0], color)
        got = vis.apply_mask(image.astype(np.float32), masks[0], color)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_plot_loss_curves_writes_the_jax_picture(tmp_path):
    metrics = [{"total_loss": 3.0 - i * 0.1, "rpn_class_loss": 0.5 + 0.01 * i, "lr": 0.01}
               for i in range(20)]
    got = vis.plot_loss_curves(metrics, str(tmp_path / "port/loss.png"))
    want = jax_vis.plot_loss_curves(metrics, str(tmp_path / "jax/loss.png"))
    np.testing.assert_array_equal(_pixels(got), _pixels(want))
    assert vis.plot_loss_curves([], str(tmp_path / "none.png")) is None


# --- TEST.SAVE_IM -------------------------------------------------------------------------
@pytest.fixture(scope="module")
def save_im_case():
    data = synthetic.generate(num_images=3, size=(128, 128), seed=6, max_instances=3)
    cfg = build_config(opts=EVAL_OPTS)
    cfg.TEST.BATCH_SIZE = 2
    return data, cfg, build_model(cfg, device="cpu", seed=0)


@pytest.mark.parametrize("scales", [[], [128, 96]], ids=["one_scale", "two_scales"])
def test_test_model_saves_one_image_per_evaluated_image(save_im_case, tmp_path, scales):
    data, cfg, model = save_im_case
    cfg.MISC.RESULT_FOLDER, cfg.MISC.LOG_FILE = str(tmp_path), str(tmp_path / "log.txt")
    cfg.TEST.SAVE_IM, cfg.TEST.MULTI_SCALE = True, scales
    try:
        workflow.test_model(model, cfg, data, COCO(dataset=data.coco_dataset()), epoch=1)
        cache = workflow.cache_path(cfg, 1, 3, False)
    finally:
        cfg.TEST.SAVE_IM, cfg.TEST.MULTI_SCALE = False, []
    names = sorted(p.name for p in (tmp_path / "images").iterdir())
    assert names == [f"det_{info['id']}.png" for info in data.image_info]
    for name in names:
        assert _pixels(tmp_path / "images" / name).shape[2] == 4
    with open(cache) as f:
        results = json.load(f)
    assert results and {r["image_id"] for r in results} <= {i["id"] for i in data.image_info}


def test_save_im_without_matplotlib_raises_before_inference(save_im_case, tmp_path, monkeypatch):
    data, cfg, _ = save_im_case

    class NoModel:
        def __getattr__(self, name):
            raise AssertionError("the model ran")

    cfg.MISC.RESULT_FOLDER, cfg.MISC.LOG_FILE = str(tmp_path), str(tmp_path / "log.txt")
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    cfg.TEST.SAVE_IM = True
    try:
        with pytest.raises(ImportError, match="TEST.SAVE_IM needs matplotlib"):
            workflow.test_model(NoModel(), cfg, data, COCO(dataset=data.coco_dataset()))
    finally:
        cfg.TEST.SAVE_IM = False
    assert not list(tmp_path.glob("det_result_*.json"))
