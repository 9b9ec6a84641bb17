"""The port's evaluation against the JAX package's, on the CPU.

- RLE masks (``evaluation/rle.py`` over the port's own ``maskrle.cpp``):
  encode, decode, area, IoU, merge, polygons, tight boxes, box IoU and the
  string codec give what the JAX package's give, exactly.
- COCOeval on one ground truth and one detection list (the ground truth
  perturbed, with misses, false positives and a crowd): the same 12 bbox
  and 12 segm stats.
- ``fuse_multiscale`` and ``boxes_from_masks``: exactly the JAX results.
- ``test_model`` of both packages from the same weights, images and ground
  truth: the same detections (classes equal, boxes within 1 px, scores
  within 1e-4) and the 12 bbox and segm stats within 0.02. The images are
  128² so that molding neither scales nor pads them (the JAX package
  resizes with OpenCV); full-size masks differ at a few border pixels
  (OpenCV's bilinear against torch's). The port's second stage is fed the
  JAX proposals, which its own match within 1e-5: on the random model a
  proposal a few ulps away can move a RoI across an FPN level boundary or a
  near-tie of the detection NMS, and change a detection's score by 0.03.
- ``python -m feature_intertwiner_tpu_torch.main --phase inference``: the
  stats and the det-result cache, a second run from the cache, and the
  evaluation at the end of a training stage with ``TRAIN.DO_VALIDATION``.
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
from feature_intertwiner_tpu.evaluation import COCOeval as JCOCOeval
from feature_intertwiner_tpu.evaluation import rle as jax_rle
from feature_intertwiner_tpu.models import detector as jax_detector
from feature_intertwiner_tpu.models.detector import InterNet as JInterNet
from feature_intertwiner_tpu.ops.boxes import boxes_from_masks as jax_boxes_from_masks
from feature_intertwiner_tpu.train import workflow as jax_workflow
from feature_intertwiner_tpu_torch import main as port_main
from feature_intertwiner_tpu_torch.config import FLAGSHIP_OVERRIDES, build_config
from feature_intertwiner_tpu_torch.data import synthetic
from feature_intertwiner_tpu_torch.evaluation import COCO, COCOeval
from feature_intertwiner_tpu_torch.evaluation import rle
from feature_intertwiner_tpu_torch.models.detector import InterNet
from feature_intertwiner_tpu_torch.ops.boxes import boxes_from_masks
from feature_intertwiner_tpu_torch.train import workflow
from feature_intertwiner_tpu_torch.utils.convert_weights import from_jax_params
from test_torch_model import KEY, _redraw
from test_torch_trainer import CLI_OPTS


# --- RLE -----------------------------------------------------------------------------
def _masks(rng, n=4, h=37, w=29):
    out = [(rng.rand(h, w) > p).astype(np.uint8) for p in np.linspace(0.3, 0.9, n)]
    out.append(np.zeros((h, w), np.uint8))
    out.append(np.ones((h, w), np.uint8))
    return out


def test_rle_matches_jax():
    rng = np.random.RandomState(20)
    masks = _masks(rng)
    ours = [rle.RLE.encode(m) for m in masks]
    theirs = [jax_rle.RLE.encode(m) for m in masks]
    for m, a, b in zip(masks, ours, theirs):
        np.testing.assert_array_equal(a.counts, b.counts)
        np.testing.assert_array_equal(a.decode(), b.decode())
        np.testing.assert_array_equal(a.decode(), m)
        assert a.area() == b.area() == m.sum()
        np.testing.assert_array_equal(a.bbox(), b.bbox())
        assert a.to_coco() == b.to_coco()
        back = rle.RLE.from_coco(a.to_coco(), *m.shape)
        np.testing.assert_array_equal(back.counts, a.counts)
    for i in range(len(masks)):
        for j in range(len(masks)):
            for crowd in (False, True):
                assert ours[i].iou(ours[j], crowd) == theirs[i].iou(theirs[j], crowd)
    np.testing.assert_array_equal(rle.RLE.merge(ours[:3]).counts,
                                  jax_rle.RLE.merge(theirs[:3]).counts)


def test_rle_polygons_and_box_iou_match_jax():
    rng = np.random.RandomState(21)
    t = np.linspace(0, 2 * np.pi, 24, endpoint=False)
    polys = [[10, 10, 30, 10, 30, 25, 10, 25],
             list(np.stack([20 + 12.5 * np.cos(t), 18 + 9.5 * np.sin(t)], 1).reshape(-1)),
             [2.5, 3.0, 40.2, 7.7, 22.1, 35.9],
             [5, 5, 9, 9]]                           # fewer than three vertices
    for poly in polys:
        np.testing.assert_array_equal(rle.RLE.from_poly(poly, 40, 48).counts,
                                      jax_rle.RLE.from_poly(poly, 40, 48).counts)
    seg = [polys[0], polys[2]]
    np.testing.assert_array_equal(rle.RLE.from_coco(seg, 40, 48).counts,
                                  jax_rle.RLE.from_coco(seg, 40, 48).counts)
    dt = np.concatenate([rng.uniform(0, 50, (7, 2)), rng.uniform(0, 30, (7, 2))], 1)
    gt = np.concatenate([rng.uniform(0, 50, (5, 2)), rng.uniform(0, 30, (5, 2))], 1)
    crowd = np.array([0, 1, 0, 0, 1], np.uint8)
    np.testing.assert_array_equal(rle.bbox_iou_matrix(dt, gt, crowd),
                                  jax_rle.bbox_iou_matrix(dt, gt, crowd))
    assert rle.bbox_iou_matrix(dt[:0], gt, crowd).shape == (0, 5)


def test_rle_library_builds_at_first_use_and_raises_when_it_cannot(monkeypatch, tmp_path):
    assert rle.lib() is rle.lib()
    assert rle.library_path().exists()
    monkeypatch.setattr(rle, "_lib", None)
    monkeypatch.setattr(rle, "BUILD_DIR", tmp_path / "empty")
    monkeypatch.setattr(rle, "SOURCE", tmp_path / "missing.cpp")
    (tmp_path / "missing.cpp").write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        rle.lib()


# --- COCOeval --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def coco_case():
    """A ground truth (with a crowd) and detections: each instance's box
    jittered and its mask shifted, some missed, false positives added."""
    data = synthetic.generate(num_images=6, size=(120, 160), seed=5, max_instances=4,
                              small_frac=0.3, medium_frac=0.3)
    gt = data.coco_dataset()
    crowd = dict(gt["annotations"][0], id=len(gt["annotations"]) + 1, iscrowd=1)
    gt["annotations"].append(crowd)
    rng = np.random.RandomState(22)
    results = []
    for ann in gt["annotations"][:-1]:
        if rng.rand() < 0.15:
            continue
        x, y, w, h = ann["bbox"]
        box = [x + rng.uniform(-3, 3), y + rng.uniform(-3, 3), w * rng.uniform(0.8, 1.2),
               h * rng.uniform(0.8, 1.2)]
        mask = rle.RLE.from_coco(ann["segmentation"], 120, 160).decode()
        mask = np.roll(mask, (rng.randint(-2, 3), rng.randint(-2, 3)), axis=(0, 1))
        cat = ann["category_id"] if rng.rand() < 0.85 else 1 + ann["category_id"] % 3
        results.append({"image_id": ann["image_id"], "category_id": cat, "bbox": box,
                        "score": float(rng.uniform(0.2, 1.0)),
                        "segmentation": rle.RLE.encode(mask).to_coco()})
    for img in gt["images"]:
        for _ in range(2):
            x, y = rng.uniform(0, 120), rng.uniform(0, 80)
            mask = np.zeros((120, 160), np.uint8)
            mask[int(y):int(y) + 20, int(x):int(x) + 30] = 1
            results.append({"image_id": img["id"], "category_id": int(rng.randint(1, 4)),
                            "bbox": [x, y, 30.0, 20.0], "score": float(rng.uniform(0, 0.5)),
                            "segmentation": rle.RLE.encode(mask).to_coco()})
    return gt, results


@pytest.mark.parametrize("iou_type", ["bbox", "segm"])
def test_cocoeval_matches_jax(coco_case, iou_type):
    gt, results = coco_case
    stats = []
    for coco_cls, eval_cls in ((COCO, COCOeval), (JCOCO, JCOCOeval)):
        api = coco_cls()
        api.dataset = json.loads(json.dumps(gt))
        api.create_index()
        ev = eval_cls(api, api.loadRes(json.loads(json.dumps(results))), iou_type)
        ev.evaluate()
        ev.accumulate()
        stats.append(ev.summarize())
    np.testing.assert_array_equal(stats[0], stats[1])
    assert stats[0][0] > 0.2 and stats[0][8] > 0.3


def test_coco_index_from_a_dict_or_a_file(coco_case, tmp_path):
    gt, _ = coco_case
    path = tmp_path / "gt.json"
    path.write_text(json.dumps(gt))
    a, b = COCO(dataset=gt), COCO(str(path))
    assert a.anns.keys() == b.anns.keys() and a.imgs.keys() == b.imgs.keys()
    assert a.getCatIds() == [1, 2, 3]
    with pytest.raises(ValueError):
        COCO(str(path), dataset=gt)


# --- host steps --------------------------------------------------------------------------
def test_fuse_multiscale_matches_jax():
    rng = np.random.RandomState(23)
    per_scale = []
    for _ in range(3):
        n = rng.randint(3, 9)
        y1x1 = rng.uniform(0, 80, (n, 2))
        boxes = np.round(np.concatenate([y1x1, y1x1 + rng.uniform(5, 40, (n, 2))], 1)).astype(np.int32)
        per_scale.append((boxes, rng.randint(1, 4, n).astype(np.int32),
                          rng.uniform(0, 1, n).astype(np.float32),
                          [rng.rand(100, 120) > 0.5 for _ in range(n)]))
    for limit, thr in ((100, 0.5), (5, 0.3)):
        got = workflow.fuse_multiscale(per_scale, limit, thr)
        want = jax_workflow.fuse_multiscale(per_scale, limit, thr)
        for g, w in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(g, w)
        assert len(got[3]) == len(want[3])
        assert all(a is b for a, b in zip(got[3], want[3]))


def test_boxes_from_masks_matches_jax():
    rng = np.random.RandomState(24)
    masks = rng.rand(3, 5, 20, 24) > 0.97
    masks[0, 0] = False
    masks[1, 2] = False
    masks[1, 2, 4:9, 3] = True
    got = boxes_from_masks(torch.from_numpy(masks))
    want = np.asarray(jax_boxes_from_masks(jnp.asarray(masks)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got[0, 0].numpy(), [0, 0, 0, 0])
    np.testing.assert_array_equal(got[1, 2].numpy(), [4, 3, 9, 4])


# --- test_model against the JAX package ------------------------------------------------
EVAL_OPTS = list(FLAGSHIP_OVERRIDES) + [
    "MODEL.BACKBONE", "resnet50", "DATASET.NUM_CLASSES", "4", "DATA.IMAGE_MIN_DIM", "96",
    "DATA.IMAGE_MAX_DIM", "128", "RPN.ANCHOR_SCALES", "(8, 16, 32, 64, 128)",
    "RPN.PRE_NMS_LIMIT", "200", "RPN.POST_NMS_ROIS_INFERENCE", "48",
    "TEST.DET_MAX_INSTANCES", "8", "TRAIN.BATCH_SIZE", "2", "TPU.ROI_WINDOW_KERNEL", "False"]


@pytest.fixture(scope="module")
def evaluated(tmp_path_factory):
    """Both packages' test_model, with masks, on one synthetic set of 5
    128² images (chunks of 4), from one set of weights."""
    data = synthetic.generate(num_images=5, size=(128, 128), seed=6, max_instances=3)
    gt = data.coco_dataset()
    cfg, jcfg = build_config(opts=EVAL_OPTS), jax_build_config(opts=EVAL_OPTS)
    jm = JInterNet.from_config(jcfg, dtype=jnp.float32)
    images = np.stack([data.load_image(i) for i in range(2)]).astype(np.float32)
    windows = jnp.asarray(np.array([[0, 0, 128, 128]] * 2, np.float32))
    variables = jm.init({"params": KEY}, jnp.asarray(images), mode="inference", windows=windows)
    rng = np.random.RandomState(25)
    v = {"params": _redraw(variables["params"], rng),
         "batch_stats": _redraw(variables["batch_stats"], rng)}
    pm = InterNet.from_config(cfg)
    pm.load_state_dict(from_jax_params(v["params"], v["batch_stats"]), strict=True)
    pm = pm.to(memory_format=torch.channels_last).eval()

    out = {}
    for name, c in (("port", cfg), ("jax", jcfg)):
        folder = tmp_path_factory.mktemp(name)
        c.MISC.RESULT_FOLDER = str(folder)
        c.MISC.LOG_FILE = str(folder / "log.txt")
    api = COCO(dataset=json.loads(json.dumps(gt)))
    japi = JCOCO()
    japi.dataset = json.loads(json.dumps(gt))
    japi.create_index()

    # the proposals of the JAX evaluation's jitted chunks (padded to
    # TEST.BATCH_SIZE images), read back from inside jit
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
    molded, _, _ = jax_workflow.mold_inputs([data.load_image(i) for i in range(5)], jcfg)
    with torch.inference_mode():
        own = pm.first_stage(torch.from_numpy(molded))[3].numpy()
    np.testing.assert_allclose(own, props, rtol=0, atol=1e-5)
    chunks = [torch.from_numpy(props[i:i + bs]) for i in range(0, 5, bs)]
    pm._propose = lambda *args: chunks.pop(0)
    stats = workflow.test_model(pm, cfg, data, api, epoch=3, eval_masks=True)
    assert not chunks
    del pm._propose
    for name, c, s, a in (("port", cfg, stats, api), ("jax", jcfg, jstats, japi)):
        with open(os.path.join(c.MISC.RESULT_FOLDER, "det_result_ep0003_n5_masks.json")) as f:
            results = json.load(f)
        img_ids = [i["id"] for i in gt["images"]]
        segm = (workflow.coco_stats(api, results, img_ids, "segm") if name == "port" else
                _jax_stats(a, results, img_ids, "segm"))
        out[name] = dict(stats=np.asarray(s), segm=np.asarray(segm), results=results,
                         folder=c.MISC.RESULT_FOLDER)
    out["cfg"], out["model"], out["data"], out["api"] = cfg, pm, data, api
    return out


def _jax_stats(api, results, img_ids, iou_type):
    ev = JCOCOeval(api, api.loadRes(results), iou_type)
    ev.params.img_ids = sorted(img_ids)
    ev.evaluate()
    ev.accumulate()
    return ev.summarize()


def match_detections(got, want, box_tol=1.0, score_tol=1e-4):
    """Pair each detection of ``got`` with one of ``want`` of the same image
    and class, its box within ``box_tol`` px and its score within
    ``score_tol`` (the order of near-equal scores may differ). Returns the
    unpaired detections of ``got``."""
    left = list(want)
    unpaired = []
    for g in got:
        for k, w in enumerate(left):
            if ((g["image_id"], g["category_id"]) == (w["image_id"], w["category_id"])
                    and max(abs(a - b) for a, b in zip(g["bbox"], w["bbox"])) <= box_tol
                    and abs(g["score"] - w["score"]) <= score_tol):
                del left[k]
                break
        else:
            unpaired.append(g)
    return unpaired


def test_test_model_detections_match_jax(evaluated):
    got, want = evaluated["port"]["results"], evaluated["jax"]["results"]
    assert len(got) == len(want) > 0
    assert match_detections(got, want) == []
    assert all(g["segmentation"]["size"] == [128, 128] for g in got)


def test_test_model_stats_match_jax(evaluated):
    for key in ("stats", "segm"):
        got, want = evaluated["port"][key], evaluated["jax"][key]
        assert got.shape == want.shape == (12,)
        np.testing.assert_allclose(got, want, rtol=0, atol=0.02)


def test_test_model_reads_its_cache_and_logs_one_ap_line(evaluated):
    """A second evaluation of the same epoch reads the cached detections
    (the model is not called) and gives the same stats."""
    cfg, data, api = evaluated["cfg"], evaluated["data"], evaluated["api"]

    class NoModel:
        def __getattr__(self, name):
            raise AssertionError("the cached evaluation ran the model")

    stats = workflow.test_model(NoModel(), cfg, data, api, epoch=3, eval_masks=True)
    np.testing.assert_array_equal(stats, evaluated["port"]["stats"])
    with open(os.path.join(evaluated["port"]["folder"], "metrics.jsonl")) as f:
        lines = [json.loads(x) for x in f]
    assert sum("AP" in r for r in lines) == 1
    assert "loading cached detections" in open(cfg.MISC.LOG_FILE).read()


def test_test_model_multiscale_and_unported_options(evaluated):
    cfg, data, api, model = (evaluated[k] for k in ("cfg", "data", "api", "model"))
    cfg.TEST.MULTI_SCALE = [128, 96]
    try:
        stats = workflow.test_model(model, cfg, data, api, epoch=4, limit=2)
        path = workflow.cache_path(cfg, 4, 2, False)
        assert path.endswith("det_result_ep0004_n2_ms128-96.json") and os.path.exists(path)
        assert stats.shape == (12,)
        # the 96² scale ran on 96² anchors, and left the model at its own size
        small = model.anchors_for(96)
        assert small.shape[0] < model.anchors.shape[0] and model.anchors_for(128) is model.anchors
        assert model.image_size == 128 and model.dev_roi.image_size == 128
    finally:
        cfg.TEST.MULTI_SCALE = []
    # TEST.DTYPE bfloat16: the model re-typed as main.py re-types it evaluates
    # in bfloat16 from its float32 parameters, into a cache named for the dtype
    seen = []
    hook = model.classifier.register_forward_hook(lambda m, args, out: seen.append(args[0].dtype))
    cfg.TEST.DTYPE, model.dtype = "bfloat16", torch.bfloat16
    try:
        stats = workflow.test_model(model, cfg, data, api, epoch=5, limit=2)
        path = workflow.cache_path(cfg, 5, 2, False)
        assert path.endswith("det_result_ep0005_n2_bfloat16.json") and os.path.exists(path)
        assert stats.shape == (12,) and seen and set(seen) == {torch.bfloat16}
        assert all(p.dtype == torch.float32 for p in model.parameters())
    finally:
        cfg.TEST.DTYPE, model.dtype = "", torch.float32
        hook.remove()
    cfg.TEST.SAVE_IM = True
    try:
        with pytest.raises(NotImplementedError):
            workflow.test_model(model, cfg, data, api, epoch=5)
    finally:
        cfg.TEST.SAVE_IM = False


# --- the command line ---------------------------------------------------------------------
def test_cli_inference_on_the_cpu_writes_and_reads_its_cache(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    argv = ["--phase", "inference", "--synthetic_data", "--device", "cpu",
            "--config_name", "ev", *CLI_OPTS]
    stats = port_main.main(argv)
    out = capsys.readouterr().out
    folder = tmp_path / "results/ev/inference"
    assert (folder / "det_result_ep0001_n8.json").exists()
    assert out.count("Average Precision") == 6 and out.count("Average Recall") == 6
    assert stats.shape == (12,)
    again = port_main.main(argv)
    np.testing.assert_array_equal(again, stats)
    assert "loading cached detections" in (folder / "log.txt").read_text()


def test_cli_validates_at_the_end_of_a_stage(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    port_main.main(["--phase", "train", "--synthetic_data", "--device", "cpu",
                    "--config_name", "val", *CLI_OPTS, "TRAIN.SCHEDULE", "[1, 0, 0]",
                    "TRAIN.DO_VALIDATION", "True"])
    folder = tmp_path / "results/val/train"
    assert (folder / "det_result_ep0001_n8.json").exists()
    assert "Validation at end of stage [HEADS]" in (folder / "log.txt").read_text()
    with open(folder / "metrics.jsonl") as f:
        assert any(json.loads(x).get("eval_epoch") == 1 for x in f)
