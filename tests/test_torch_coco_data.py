"""COCO-format data on disk in the port, against the JAX package, on the CPU.

- The port's writer (``data/synthetic.py::write_coco``, ``generate_rich``)
  writes the JAX package's files: the same parsed JSON, pixel-equal PNGs.
- Both packages' ``Dataset.load_coco`` on one root give the same registry
  (classes, images with ids, paths, sizes and annotations, source maps),
  also for a subset of the categories; ``load_image`` and ``load_mask`` give
  the same bits, a crowd RLE smaller than its image included.
- Both ``get_data`` on one root, ``CTRL.QUICK_VERIFY`` on and off, with and
  without ``valminusminival``: the same splits, and the first epoch's
  batches within the transforms' tolerance (one grey level, boxes within 1
  px, mini-masks on at least 99% of their pixels: OpenCV's fixed-point
  bilinear against torch's).
- ``auto_download`` leaves a root that has its folders alone; without PIL,
  reading a dataset raises ``ImportError`` naming it before anything is
  read; a missing annotation file raises ``FileNotFoundError`` naming it.
- ``python -m feature_intertwiner_tpu_torch.main --phase train`` and then
  ``--phase inference`` from ``--data_root`` at a tiny size on the CPU, the
  loader on process workers and ``CTRL.PROFILE_ANALYSIS`` on: a checkpoint,
  the ``[profile]`` fetch and step lines, the dashboard, the 12 bbox stats;
  and ``--synthetic_data --data_root`` writing the set and reading it back.
"""

import test_torch_workers  # noqa: F401  (first: sizes this xdist worker's thread pools)

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from feature_intertwiner_tpu.config import build_config as jax_build_config
from feature_intertwiner_tpu.data import coco_dataset as jax_coco
from feature_intertwiner_tpu.data import synthetic as jax_synthetic
from feature_intertwiner_tpu.evaluation.rle import RLE as JRLE
from feature_intertwiner_tpu_torch import main as port_main
from feature_intertwiner_tpu_torch.config import build_config
from feature_intertwiner_tpu_torch.data import coco_dataset, synthetic
from feature_intertwiner_tpu_torch.data.loader import DetectionDataset
from test_torch_trainer import CLI_OPTS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNTH = dict(num_images=4, size=(120, 160), seed=3, max_instances=4, small_frac=0.3,
             medium_frac=0.3)
DATA_OPTS = ["DATA.IMAGE_MIN_DIM", "96", "DATA.IMAGE_MAX_DIM", "128",
             "DATA.MAX_GT_INSTANCES", "6", "TRAIN.BATCH_SIZE", "2"]


def _png(path):
    from PIL import Image

    with Image.open(path) as img:
        return np.asarray(img)


def _same_files(a, b, folder):
    assert sorted(os.listdir(os.path.join(a, folder))) == sorted(os.listdir(os.path.join(b, folder)))
    for name in os.listdir(os.path.join(a, folder)):
        pa, pb = os.path.join(a, folder, name), os.path.join(b, folder, name)
        if name.endswith(".json"):
            with open(pa) as fa, open(pb) as fb:
                assert json.load(fa) == json.load(fb), name
        else:
            got, want = _png(pa), _png(pb)
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A root the JAX writer wrote, with a train split (minival's images
    copied to train2014/) and a valminusminival split (two of them)."""
    root = tmp_path_factory.mktemp("coco")
    ann = jax_synthetic.generate(str(root), **SYNTH)
    shutil.copytree(root / "val2014", root / "train2014")
    with open(ann) as f:
        data = json.load(f)
    shutil.copy(ann, root / "annotations" / "instances_train2014.json")
    vmm = dict(data, images=data["images"][:2],
               annotations=[a for a in data["annotations"] if a["image_id"] <= 2])
    with open(root / "annotations" / "vmm.json", "w") as f:
        json.dump(vmm, f)
    return root


def test_writer_writes_the_jax_files(tmp_path):
    for kw in (SYNTH, dict(num_images=2, size=(40, 56), seed=0, max_instances=6)):
        jax_synthetic.generate(str(tmp_path / "jax"), **kw)
        path = synthetic.write_coco(str(tmp_path / "port"), **kw)
        assert path == str(tmp_path / "port" / "annotations" / "instances_minival2014.json")
        _same_files(str(tmp_path / "jax"), str(tmp_path / "port"), "annotations")
        _same_files(str(tmp_path / "jax"), str(tmp_path / "port"), "val2014")


@pytest.mark.parametrize("split,color_mode", [("train", "class"), ("minival", "paired")])
def test_generate_rich_writes_the_jax_files(tmp_path, split, color_mode):
    kw = dict(num_images=3, size=(160, 144), split=split, seed=4, color_mode=color_mode)
    jax_synthetic.generate_rich(str(tmp_path / "jax"), **kw)
    synthetic.generate_rich(str(tmp_path / "port"), **kw)
    _same_files(str(tmp_path / "jax"), str(tmp_path / "port"), "annotations")
    folder = "train2014" if split == "train" else "val2014"
    _same_files(str(tmp_path / "jax"), str(tmp_path / "port"), folder)


def test_in_memory_set_is_the_written_one(tmp_path):
    """``generate`` draws what ``write_coco`` writes: the same images, and
    its ground truth the written boxes and areas."""
    synthetic.write_coco(str(tmp_path), **SYNTH)
    mem = synthetic.generate(**SYNTH)
    with open(tmp_path / "annotations" / "instances_minival2014.json") as f:
        written = json.load(f)
    gt = mem.coco_dataset()
    assert gt["images"] == written["images"] and gt["categories"] == written["categories"]
    for a, b in zip(gt["annotations"], written["annotations"]):
        assert [a[k] for k in ("id", "image_id", "category_id", "bbox", "area")] == \
               [b[k] for k in ("id", "image_id", "category_id", "bbox", "area")]
    for i, info in enumerate(written["images"]):
        np.testing.assert_array_equal(_png(tmp_path / "val2014" / info["file_name"]),
                                      mem.load_image(i))


def _load(module, root, class_ids=None):
    ds = module.Dataset()
    api = ds.load_coco(str(root / "annotations" / "instances_minival2014.json"),
                       str(root / "val2014"), class_ids=class_ids, return_coco=True)
    ds.prepare()
    return ds, api


def _same_registry(got, want):
    assert got.class_info == want.class_info
    assert got.image_info == want.image_info
    for key in ("num_classes", "class_names", "num_images", "class_from_source_map",
                "source_class_ids"):
        assert getattr(got, key) == getattr(want, key), key
    assert sorted(got.sources) == sorted(want.sources)
    np.testing.assert_array_equal(got.image_ids, want.image_ids)
    np.testing.assert_array_equal(got.class_ids, want.class_ids)
    for i in range(got.num_classes):
        if i:
            assert got.get_source_class_id(i, "coco") == want.get_source_class_id(i, "coco")
            key = f"coco.{got.class_info[i]['id']}"
            assert got.map_source_class_id(key) == want.map_source_class_id(key)


@pytest.mark.parametrize("class_ids", [None, [1, 3]])
def test_registry_images_and_masks_are_the_jax_ones(root, class_ids):
    got, api = _load(coco_dataset, root, class_ids)
    want, japi = _load(jax_coco, root, class_ids)
    _same_registry(got, want)
    assert api.dataset == japi.dataset
    for i in got.image_ids:
        image = got.load_image(int(i))
        ref = want.load_image(int(i))
        assert image.dtype == ref.dtype == np.uint8 and image.shape == ref.shape
        np.testing.assert_array_equal(image, ref)
        (mask, cls), (jmask, jcls) = got.load_mask(int(i)), want.load_mask(int(i))
        assert mask.dtype == jmask.dtype and cls.dtype == jcls.dtype
        np.testing.assert_array_equal(mask, jmask)
        np.testing.assert_array_equal(cls, jcls)


def test_crowd_masks_are_the_jax_ones(root):
    """A crowd as an uncompressed RLE smaller than its image (real COCO-2014
    has such): a full-image mask with a negative class id; a crowd as a
    compressed RLE of the image's size: decoded as it is."""
    got, _ = _load(coco_dataset, root)
    want, _ = _load(jax_coco, root)
    info = got.image_info[0]
    h, w = info["height"], info["width"]
    cat = info["annotations"][0]["category_id"]
    small = JRLE.encode(np.ones((h // 2, w // 2), bool))
    region = np.zeros((h, w), bool)
    region[5:40, 7:60] = True
    crowds = [{"category_id": cat, "iscrowd": 1,
               "segmentation": {"size": [h // 2, w // 2], "counts": small.counts.tolist()}},
              {"category_id": cat, "iscrowd": 1, "segmentation": JRLE.encode(region).to_coco()}]
    anns = list(info["annotations"]) + crowds
    for ds in (got, want):
        ds.image_info[0]["annotations"] = anns
    (mask, cls), (jmask, jcls) = got.load_mask(0), want.load_mask(0)
    np.testing.assert_array_equal(mask, jmask)
    np.testing.assert_array_equal(cls, jcls)
    assert mask.shape[:2] == (h, w) and (cls < 0).sum() == 2
    assert mask[..., -2].all() and np.array_equal(mask[..., -1], region)


def _agree(a, b):
    return float(np.mean(np.asarray(a, bool) == np.asarray(b, bool)))


@pytest.mark.parametrize("quick_verify", [True, False])
@pytest.mark.parametrize("with_vmm", [False, True])
def test_get_data_gives_the_jax_splits_and_batches(root, tmp_path, quick_verify, with_vmm):
    vmm = root / "annotations" / "instances_valminusminival2014.json"
    opts = DATA_OPTS + ["CTRL.QUICK_VERIFY", str(quick_verify)]
    cfg, jcfg = build_config(opts=opts), jax_build_config(opts=opts)
    if with_vmm:
        shutil.copy(root / "annotations" / "vmm.json", vmm)
    try:
        loader, val, api = coco_dataset.get_data(cfg, data_root=str(root))
        jloader, jval, japi = jax_coco.get_data(jcfg, data_root=str(root))
    finally:
        vmm.unlink(missing_ok=True)
    _same_registry(val, jval)
    _same_registry(loader.dataset.dataset, jloader.dataset.dataset)
    assert api.dataset == japi.dataset
    n_train = SYNTH["num_images"] + (2 if with_vmm and not quick_verify else 0)
    assert loader.dataset.dataset.num_images == n_train
    dirs = {os.path.basename(os.path.dirname(i["path"])) for i in loader.dataset.dataset.image_info}
    assert dirs == ({"val2014"} if quick_verify else
                    {"train2014", "val2014"} if with_vmm else {"train2014"})
    assert (loader.worker_mode, loader.num_workers, loader.batch_size) == ("thread", 2, 2)
    assert len(loader) == len(jloader) == n_train // 2
    loader.set_epoch(1)
    jloader.set_epoch(1)
    got, want = list(loader), list(jloader)
    assert len(got) == len(want) == len(loader)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        np.testing.assert_array_equal(g["image_meta"], w["image_meta"])
        np.testing.assert_array_equal(g["gt_class_ids"], w["gt_class_ids"])
        assert np.abs(g["gt_boxes"] - w["gt_boxes"]).max() <= 1
        assert np.abs(g["images"] - w["images"]).max() <= 1 + 1e-4
        assert _agree(g["gt_masks"], w["gt_masks"]) >= 0.99


def test_auto_download_leaves_existing_folders_alone(root, monkeypatch):
    import urllib.request

    def no_network(*args, **kwargs):
        raise AssertionError(f"a download was attempted: {args}")

    monkeypatch.setattr(urllib.request, "urlretrieve", no_network)
    before = sorted(os.listdir(root))
    coco_dataset.Dataset.auto_download(str(root), "val", "2014")
    ds = coco_dataset.Dataset()
    ds.load_coco(str(root / "annotations" / "instances_minival2014.json"),
                 str(root / "val2014"), auto_download=True)
    ds.prepare()
    assert ds.num_images == SYNTH["num_images"] and sorted(os.listdir(root)) == before


def test_without_pil_reading_raises_first_and_missing_files_are_named(root, tmp_path,
                                                                      monkeypatch):
    cfg = build_config(opts=DATA_OPTS)
    with pytest.raises(FileNotFoundError, match="instances_minival2014.json"):
        coco_dataset.get_data(cfg, data_root=str(tmp_path))
    (tmp_path / "annotations").mkdir()
    shutil.copy(root / "annotations" / "instances_minival2014.json", tmp_path / "annotations")
    with pytest.raises(FileNotFoundError, match="instances_train2014.json"):
        coco_dataset.get_data(cfg, data_root=str(tmp_path))
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="PIL"):
        coco_dataset.get_data(cfg, data_root=str(tmp_path / "nothing"))
    with pytest.raises(ImportError, match="PIL"):
        synthetic.write_coco(str(tmp_path / "nothing"))
    assert not (tmp_path / "nothing").exists()
    ds, _ = _load(coco_dataset, root)
    with pytest.raises(ImportError, match="PIL"):
        DetectionDataset(ds, cfg)[0]


def _cli(args, cwd):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-m", "feature_intertwiner_tpu_torch.main", *args],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    return proc.stdout


def test_cli_trains_and_evaluates_from_disk(tmp_path):
    """The command line on a COCO layout on disk (no synthetic flag): train
    from ``train2014`` on two process workers with the phase timer, then
    evaluate minival from the checkpoint."""
    data = tmp_path / "coco"
    ann = synthetic.write_coco(str(data), num_images=8)
    shutil.copytree(data / "val2014", data / "train2014")
    shutil.copy(ann, data / "annotations" / "instances_train2014.json")
    base = ["--device", "cpu", "--data_root", str(data), "--config_name", "disk", *CLI_OPTS]
    _cli(["--phase", "train", *base, "TRAIN.SCHEDULE", "[1, 0, 0]", "TRAIN.DO_VALIDATION",
          "False", "TRAIN.KEEP_CHECKPOINTS", "1", "DATA.LOADER_WORKER_MODE", "process",
          "DATA.LOADER_WORKER_NUM", "2",
          "CTRL.PROFILE_ANALYSIS", "True", "CTRL.SHOW_INTERVAL", "4"], tmp_path)
    folder = tmp_path / "results" / "disk" / "train"
    assert (folder / "checkpoints" / "ckpt_ep0001_iter000004.pt").exists()
    log = (folder / "log.txt").read_text()
    fetch = [line for line in log.splitlines() if line.startswith("[profile] fetch:")]
    step = [line for line in log.splitlines() if line.startswith("[profile] step:")]
    assert len(fetch) == len(step) == 2      # reported at iterations 1 (the first) and 4
    assert " over 4 calls (" in fetch[-1] and " over 4 calls (" in step[-1]
    assert (folder / "dashboard.html").exists() and (folder / "config.json").exists()
    out = _cli(["--phase", "inference", *base], tmp_path)
    assert out.count("Average Precision") == 6 and out.count("Average Recall") == 6
    assert (tmp_path / "results" / "disk" / "inference" / "det_result_ep0001_n8.json").exists()


def test_cli_writes_the_synthetic_set_to_the_data_root(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    stats = port_main.main(["--phase", "inference", "--synthetic_data", "--device", "cpu",
                            "--data_root", str(tmp_path / "synth"), "--config_name", "synth",
                            *CLI_OPTS])
    assert stats.shape == (12,)
    assert (tmp_path / "synth" / "annotations" / "instances_minival2014.json").exists()
    assert len(os.listdir(tmp_path / "synth" / "val2014")) == 8
    # the set in memory has the same images, boxes and areas: the same bbox stats
    again = port_main.main(["--phase", "inference", "--synthetic_data", "--device", "cpu",
                            "--config_name", "memory", *CLI_OPTS])
    np.testing.assert_array_equal(stats, again)
