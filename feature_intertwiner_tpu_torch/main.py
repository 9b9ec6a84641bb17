"""Command line of the port, with the flags of the JAX package's ``main.py``::

    python -m feature_intertwiner_tpu_torch.main --phase {train,inference} --synthetic_data \
        [--config_name NAME] [--config_file cfg.yaml] [--debug 0|1] \
        [--device cuda|cpu] [KEY.SUBKEY VALUE ...]

``--phase train`` runs the three-stage schedule (heads, 4+, all; only 'all'
with ``TRAIN.END2END``) with resume from the run's newest checkpoint, and
with ``TRAIN.DO_VALIDATION`` an evaluation at the end of each stage.
``--phase inference`` resumes the newest checkpoint of the run (its train
folder's when the inference folder has none) and runs the COCO evaluation
(``train/workflow.py::test_model``, the 12 bbox stats), caching the
detections in ``results/<name>/inference/``. Both run on the GPU unless
``--device cpu`` is given. The model computes in ``TPU.COMPUTE_DTYPE``
(bfloat16 by default) with float32 parameters, as the JAX ``main.py``
builds it; ``--phase inference`` re-types it to ``TEST.DTYPE`` where that is
set and differs. TF32 is off for the float32 convolutions and matmuls.

``--synthetic_data`` builds the JAX package's synthetic set (8 images) in
memory, with its COCO ground truth. Every model option of the config
builds (``DEV.STRUCTURE`` other than beta raises in both packages); what is
not ported yet raises ``NotImplementedError``: ``--phase visualize`` and
COCO data on disk.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import torch

from .config import build_config
from .data import synthetic
from .data.loader import DetectionDataset, Loader
from .evaluation import COCO
from .inference import COMPUTE_DTYPES, build_model
from .train.workflow import Trainer, test_model, train_model
from .utils.logging import print_log


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="InterNet, PyTorch/CUDA port")
    p.add_argument("--phase", default="train", choices=["train", "inference", "visualize"])
    p.add_argument("--config_name", default=None)
    p.add_argument("--config_file", default=None)
    p.add_argument("--debug", type=int, default=0)
    p.add_argument("--device_id", default="0", help="kept for parity with main.py")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    p.add_argument("--data_root", default=None,
                   help="COCO data on disk (not ported yet; see --synthetic_data)")
    p.add_argument("--synthetic_data", action="store_true",
                   help="build a synthetic dataset in memory")
    p.add_argument("opts", nargs=argparse.REMAINDER, help="KEY.SUBKEY VALUE overrides")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None):
    """Runs the phase; returns the :class:`Trainer` after ``train``, the 12
    bbox stats after ``inference``."""
    args = parse_args(argv)
    if args.phase == "visualize":
        raise NotImplementedError("--phase visualize is not ported yet")
    if not args.synthetic_data:
        raise NotImplementedError(
            "COCO data on disk is not ported yet (it needs an image decoder); "
            "pass --synthetic_data")
    opts = ["CTRL.QUICK_VERIFY", "True"] + list(args.opts or [])
    cfg = build_config(config_name=args.config_name or "default", phase=args.phase,
                       config_file=args.config_file, opts=opts, debug=bool(args.debug),
                       make_dirs=True)
    cfg.MISC.LOG_FILE = os.path.join(cfg.MISC.RESULT_FOLDER, "log.txt")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    dataset = synthetic.generate(num_images=8)
    # the synthetic set has fewer classes than COCO's 81
    cfg.DATASET.NUM_CLASSES = dataset.num_classes
    model = build_model(cfg, device=args.device, seed=cfg.MISC.SEED,
                        dtype=COMPUTE_DTYPES[cfg.TPU.COMPUTE_DTYPE])
    print_log(f"device: {next(model.parameters()).device}, compute dtype {model.dtype}",
              cfg.MISC.LOG_FILE, init=True)
    cfg.display(lambda msg: print_log(msg, cfg.MISC.LOG_FILE, quiet_terminal=True))
    val_api = COCO(dataset=dataset.coco_dataset())
    trainer = Trainer(model, cfg).resume()
    if args.phase == "inference":
        # the same float32 parameters, evaluated in TEST.DTYPE where it is set
        if cfg.TEST.DTYPE and cfg.TEST.DTYPE != cfg.TPU.COMPUTE_DTYPE:
            trainer.model.dtype = COMPUTE_DTYPES[cfg.TEST.DTYPE]
        return test_model(trainer.model, cfg, dataset, val_api, epoch=trainer.epoch)
    loader = Loader(DetectionDataset(dataset, cfg, augment=True, seed=cfg.MISC.SEED),
                    batch_size=cfg.TRAIN.BATCH_SIZE, shuffle=True, seed=cfg.MISC.SEED)
    for stage in ("all",) if cfg.TRAIN.END2END else ("heads", "4+", "all"):
        train_model(trainer, loader, stage, val_api=val_api, val_dataset=dataset)
    return trainer


if __name__ == "__main__":
    main()
