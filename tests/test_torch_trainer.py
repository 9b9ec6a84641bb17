"""The port's trainer, CLI and data pipeline, on the CPU.

- The trainer over a tiny in-memory synthetic set: three stages with their
  learning rates and trainable sets, a run killed in stage 4+ that resumes
  from its mid-stage checkpoint and ends bit-equal to an uninterrupted run,
  and ``TRAIN.DO_VALIDATION`` ending a stage with an evaluation.
- ``python -m feature_intertwiner_tpu_torch.main``: a CPU run when asked, the
  GPU by default in every phase, and COCO data on disk, not ported yet,
  raising.
- The data pipeline against the JAX package's (PNG files, COCO polygons,
  OpenCV): the synthetic set itself, and ``load_image_and_gt`` and the
  loader's batches on one dataset, boxes within 1 px and mini-masks on at
  least 99% of their pixels (OpenCV's fixed-point bilinear against
  torch's).
"""

import test_torch_workers  # noqa: F401  (first: sizes this xdist worker's thread pools)

import numpy as np
import pytest
import torch

from feature_intertwiner_tpu.config import build_config as jax_build_config
from feature_intertwiner_tpu.data import synthetic as jax_synthetic
from feature_intertwiner_tpu.data import transforms as jax_transforms
from feature_intertwiner_tpu.data.coco_dataset import CocoDetectionDataset
from feature_intertwiner_tpu.data.coco_dataset import Dataset as JDataset
from feature_intertwiner_tpu.data.loader import PrefetchLoader
from feature_intertwiner_tpu_torch import build_model
from feature_intertwiner_tpu_torch import main as port_main
from feature_intertwiner_tpu_torch.config import FLAGSHIP_OVERRIDES, build_config
from feature_intertwiner_tpu_torch.data import synthetic
from feature_intertwiner_tpu_torch.data import transforms
from feature_intertwiner_tpu_torch.data.loader import DetectionDataset, Loader
from feature_intertwiner_tpu_torch.train import workflow


TRAIN_OPTS = list(FLAGSHIP_OVERRIDES) + [
    "MODEL.BACKBONE", "resnet50", "DATASET.NUM_CLASSES", "4",
    "DATA.IMAGE_MIN_DIM", "96", "DATA.IMAGE_MAX_DIM", "128", "DATA.MAX_GT_INSTANCES", "8",
    "RPN.ANCHOR_SCALES", "(8, 16, 32, 64, 128)", "RPN.PRE_NMS_LIMIT", "200",
    "RPN.POST_NMS_ROIS_INFERENCE", "48", "ROIS.TRAIN_ROIS_PER_IMAGE", "24",
    "MRCNN.MINI_MASK_SHAPE", "(14, 14)", "TRAIN.BATCH_SIZE", "2"]


def _trainer(folder, data, opts=()):
    cfg = build_config(opts=TRAIN_OPTS + ["TRAIN.SCHEDULE", "[1, 1, 1]", "TRAIN.KEEP_CHECKPOINTS",
                                          "2", "TRAIN.DO_VALIDATION", "False"] + list(opts))
    cfg.MISC.RESULT_FOLDER = str(folder)
    cfg.MISC.LOG_FILE = str(folder / "log.txt")
    loader = Loader(DetectionDataset(data, cfg, augment=True, seed=cfg.MISC.SEED),
                    batch_size=2, shuffle=True, seed=cfg.MISC.SEED)
    trainer = workflow.Trainer(build_model(cfg, device="cpu", seed=0), cfg).resume()
    return trainer, loader


def _run(trainer, loader):
    for stage in ("heads", "4+", "all"):
        workflow.train_model(trainer, loader, stage)


def test_trainer_runs_three_stages_and_resumes_mid_stage(tmp_path, monkeypatch):
    data = synthetic.generate(num_images=4, size=(96, 128), seed=1, max_instances=3)
    steps = []
    step_fn = workflow.train_step

    def counted(state, cfg, batch, lr, meta_gate, generator=None, draws=None):
        steps.append((lr, [n for n, p in state.model.named_parameters() if p.requires_grad]))
        return step_fn(state, cfg, batch, lr, meta_gate, generator, draws)

    monkeypatch.setattr(workflow, "train_step", counted)
    whole, loader = _trainer(tmp_path / "whole", data)
    _run(whole, loader)
    np.testing.assert_allclose([lr for lr, _ in steps], [0.01, 0.01, 1e-3, 1e-3, 1e-4, 1e-4])
    trained = [len(names) for _, names in steps]
    assert trained[0] == trained[1] < trained[2] == trained[3] < trained[4] == trained[5]
    assert whole.state.step == 6 and whole.epoch == 4

    # a run that dies in stage 4+ after its first step, then resumes
    def dies(state, cfg, batch, lr, meta_gate, generator=None, draws=None):
        if state.step == 3:
            raise RuntimeError("killed")
        return step_fn(state, cfg, batch, lr, meta_gate, generator, draws)

    monkeypatch.setattr(workflow, "train_step", dies)
    cut, loader = _trainer(tmp_path / "cut", data)
    with pytest.raises(RuntimeError, match="killed"):
        _run(cut, loader)
    monkeypatch.setattr(workflow, "train_step", step_fn)
    resumed, loader = _trainer(tmp_path / "cut", data)
    assert (resumed.epoch, resumed.iter, resumed.state.step) == (2, 2, 3)
    _run(resumed, loader)
    sd, want = resumed.state.model.state_dict(), whole.state.model.state_dict()
    for k in want:
        assert torch.equal(sd[k], want[k]), k
    assert torch.equal(resumed.state.buffer, whole.state.buffer)
    assert torch.equal(resumed.state.buffer_cnt, whole.state.buffer_cnt)
    for p, q in zip(resumed.state.model.parameters(), whole.state.model.parameters()):
        assert torch.equal(resumed.state.optimizer.state[p]["momentum_buffer"],
                           whole.state.optimizer.state[q]["momentum_buffer"])
    # a finished run resumes past its last stage and trains nothing
    again, loader = _trainer(tmp_path / "whole", data)
    _run(again, loader)
    assert again.state.step == 6


def test_validation_evaluates_at_the_end_of_a_stage(tmp_path):
    """The eval loop is ported: with ``TRAIN.DO_VALIDATION`` a stage ends
    with an evaluation of its last epoch when a validation set is given,
    and without one it skips it, as the JAX trainer does."""
    from feature_intertwiner_tpu_torch.evaluation import COCO

    data = synthetic.generate(num_images=2, size=(96, 128), seed=1, max_instances=2)
    trainer, loader = _trainer(tmp_path, data, ["TRAIN.DO_VALIDATION", "True"])
    workflow.train_model(trainer, loader, "heads")
    assert not list(tmp_path.glob("det_result_*.json"))
    workflow.train_model(trainer, loader, "4+", val_api=COCO(dataset=data.coco_dataset()),
                         val_dataset=data)
    assert (tmp_path / "det_result_ep0002_n2.json").exists()
    assert "Validation at end of stage [4+]" in (tmp_path / "log.txt").read_text()


CLI_OPTS = TRAIN_OPTS[len(FLAGSHIP_OVERRIDES):]


def test_cli_trains_on_the_cpu_when_asked(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    trainer = port_main.main(["--phase", "train", "--synthetic_data", "--device", "cpu",
                              "--config_name", "cli", *CLI_OPTS, "TRAIN.SCHEDULE", "[1, 0, 0]",
                              "TRAIN.DO_VALIDATION", "False"])
    assert trainer.state.step == 4 and trainer.epoch == 2
    assert (tmp_path / "results/cli/train/checkpoints/ckpt_ep0001_iter000004.pt").exists()
    assert "[HEADS]" in (tmp_path / "results/cli/train/log.txt").read_text()


def test_cli_runs_on_the_gpu_by_default_and_raises_for_what_waits(tmp_path, monkeypatch):
    """Every phase, visualize too, is accepted and wants the GPU unless
    ``--device cpu`` is given (``test_torch_visualize.py`` runs it on the
    CPU); COCO data on disk is what still raises."""
    monkeypatch.chdir(tmp_path)
    base = ["--synthetic_data", "--config_name", "cli", *CLI_OPTS]
    for phase in ("train", "inference", "visualize"):
        with pytest.raises(NotImplementedError, match="synthetic_data"):
            port_main.main(["--phase", phase, "--config_name", "cli"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for phase in ("train", "inference", "visualize"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port_main.main(["--phase", phase, *base, "TRAIN.DO_VALIDATION", "False"])


# --- data ---------------------------------------------------------------------------------
SYNTH = dict(num_images=4, seed=3, max_instances=4, small_frac=0.3, medium_frac=0.3)
DATA_OPTS = ["DATA.IMAGE_MIN_DIM", "256", "DATA.IMAGE_MAX_DIM", "384", "DATA.MAX_GT_INSTANCES", "6",
             "DATASET.NUM_CLASSES", "4"]


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    root = tmp_path_factory.mktemp("synthetic")
    ann = jax_synthetic.generate(str(root), **SYNTH)
    jds = JDataset()
    jds.load_coco(ann, str(root / "val2014"))
    jds.prepare()
    return jds, synthetic.generate(**SYNTH)


def _agree(a, b):
    return float(np.mean(np.asarray(a, bool) == np.asarray(b, bool)))


def test_synthetic_set_matches_jax(datasets):
    jds, pds = datasets
    assert pds.num_classes == jds.num_classes == 4
    for i in range(SYNTH["num_images"]):
        np.testing.assert_array_equal(pds.load_image(i), jds.load_image(i))
        pm, pc = pds.load_mask(i)
        jmask, jc = jds.load_mask(i)
        np.testing.assert_array_equal(pc, jc)
        for k in range(len(pc)):       # painted regions against rasterised polygons
            assert _agree(pm[..., k], jmask[..., k]) >= 0.99


def test_load_image_and_gt_matches_jax(datasets):
    """Both pipelines on one dataset, each of the two in turn."""
    cfg = build_config(opts=DATA_OPTS)
    jcfg = jax_build_config(opts=DATA_OPTS)
    for ds in datasets:
        for i in range(SYNTH["num_images"]):
            for augment in (False, True):
                got = transforms.load_image_and_gt(ds, cfg, i, augment, True,
                                                   np.random.RandomState(i))
                want = jax_transforms.load_image_and_gt(ds, jcfg, i, augment, True,
                                                        np.random.RandomState(i))
                image, meta, cls, bbox, mini = got
                assert image.shape == want[0].shape and image.dtype == want[0].dtype
                assert np.abs(image.astype(int) - want[0].astype(int)).max() <= 1
                np.testing.assert_array_equal(meta, want[1])
                np.testing.assert_array_equal(cls, want[2])
                assert np.abs(bbox - want[3]).max() <= 1
                assert mini.shape == want[4].shape
                assert _agree(mini, want[4]) >= 0.99


def test_loader_batches_match_jax(datasets):
    """The same shuffle, per-sample augmentation and padding as the JAX
    package's loader, on one dataset."""
    pds = datasets[1]
    cfg = build_config(opts=DATA_OPTS)
    jcfg = jax_build_config(opts=DATA_OPTS)
    loader = Loader(DetectionDataset(pds, cfg, augment=True, seed=5), 2, shuffle=True, seed=5)
    jloader = PrefetchLoader(CocoDetectionDataset(pds, jcfg, augment=True, seed=5), 2,
                             shuffle=True, num_workers=1, seed=5)
    for epoch in (1, 2):
        loader.set_epoch(epoch)
        jloader.set_epoch(epoch)
        got, want = list(loader), list(jloader)
        assert len(got) == len(want) == len(loader) == 2
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            np.testing.assert_array_equal(g["image_meta"], w["image_meta"])
            np.testing.assert_array_equal(g["gt_class_ids"], w["gt_class_ids"])
            assert np.abs(g["gt_boxes"] - w["gt_boxes"]).max() <= 1
            assert np.abs(g["images"] - w["images"]).max() <= 1 + 1e-4
            assert _agree(g["gt_masks"], w["gt_masks"]) >= 0.99
