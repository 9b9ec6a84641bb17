"""Command line of the port, with the flags of the JAX package's ``main.py``::

    python -m feature_intertwiner_tpu_torch.main --phase {train,inference,visualize} \
        [--data_root PATH] [--synthetic_data] [--config_name NAME] [--config_file cfg.yaml] \
        [--debug 0|1] [--device cuda|cpu] [KEY.SUBKEY VALUE ...]

``--phase train`` runs the three-stage schedule (heads, 4+, all; only 'all'
with ``TRAIN.END2END``) with resume from the run's newest checkpoint, and
with ``TRAIN.DO_VALIDATION`` an evaluation at the end of each stage.
``--phase inference`` resumes the newest checkpoint of the run (its train
folder's when the inference folder has none) and runs the COCO evaluation
(``train/workflow.py::test_model``, the 12 bbox stats), caching the
detections in ``results/<name>/inference/`` (``TEST.SAVE_IM`` also draws
each image's detections to ``images/det_<id>.png`` there).
``--phase visualize`` resumes the same way and writes
``results/<name>/visualize/features.npz``: ``features`` [N, M, 1024], each
detection's penultimate classifier feature, and ``detections`` [N, M, 6],
one image at a time over the dataset, as the JAX phase writes it (the input
of ``utils/tsne.py``). Every phase starts from a pretrained ``.npz``,
``.pth`` or ``.h5`` file where ``MODEL.INIT_FILE_CHOICE`` names one and the
run has no checkpoint (``train/workflow.py::Trainer.resume``). All run on
the GPU unless ``--device cpu`` is given. The model computes in
``TPU.COMPUTE_DTYPE`` (bfloat16 by default) with float32 parameters, as the
JAX ``main.py`` builds it; ``--phase inference`` and ``visualize`` re-type
it to ``TEST.DTYPE`` where that is set and differs. TF32 is off for the
float32 convolutions and matmuls.

Data. ``--data_root`` (default ``DATASET.PATH``) names a COCO layout on
disk: ``annotations/instances_minival<year>.json`` with ``val<year>/`` for
the evaluation, ``instances_train<year>.json`` with ``train<year>/`` (and
``instances_valminusminival<year>.json`` where it exists) for training, or
minival under ``CTRL.QUICK_VERIFY`` (``data/coco_dataset.py::get_data``). A
missing annotation file raises ``FileNotFoundError`` naming it; reading
images needs PIL. The train loader prefetches on ``DATA.LOADER_WORKER_NUM``
workers, threads or spawned processes by ``DATA.LOADER_WORKER_MODE``
(``data/loader.py::PrefetchLoader``). ``--synthetic_data --data_root DIR``
first writes the JAX package's synthetic set (8 images) there in the COCO
layout and trains on it under ``CTRL.QUICK_VERIFY``, as the JAX ``main.py``
does; ``--synthetic_data`` alone builds the same set in memory, with its
COCO ground truth, where the JAX ``main.py`` writes it to ``DATASET.PATH``.
Every model option of the config builds (``DEV.STRUCTURE`` other than beta
raises in both packages).

Ranks. Under ``torchrun`` (``torchrun --nproc_per_node N -m
feature_intertwiner_tpu_torch.main ...``) every phase runs over N ranks
(``parallel/data_parallel.py``): NCCL on ``cuda:LOCAL_RANK``, or gloo on
the CPU with ``--device cpu``. ``TRAIN.BATCH_SIZE`` is the global batch,
which N must divide; each rank loads and trains on its rows of it, and the
evaluation shares each chunk of images over the ranks. Only rank 0 makes the
result folders and writes ``log.txt``, ``metrics.jsonl``, the checkpoints,
the detection cache and ``features.npz`` (``--phase visualize`` runs on rank
0 alone, as the JAX phase runs on one device; the other ranks return at
once). The rank count is
torchrun's; ``TPU.MESH_DATA`` does not set it.

Monitoring. The trainer writes ``dashboard.html`` beside ``metrics.jsonl``
and serves the run folder on ``MISC.VIS.PORT`` (8097 where it is not set)
under ``MISC.USE_VISDOM``; ``CTRL.PROFILE_ANALYSIS`` reports the loader's
fetch time and the step time as ``[profile]`` lines with each loss line.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np
import torch

from .config import build_config
from .data import synthetic
from .data.coco_dataset import get_data, make_loader
from .evaluation import COCO
from .inference import COMPUTE_DTYPES, build_model, visualize
from .parallel.data_parallel import init_distributed, rank_and_world
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
                   help="a COCO layout on disk (default DATASET.PATH); with "
                        "--synthetic_data, where to write the synthetic set")
    p.add_argument("--synthetic_data", action="store_true",
                   help="the synthetic set: written to --data_root and read from "
                        "there, or built in memory without --data_root")
    p.add_argument("opts", nargs=argparse.REMAINDER, help="KEY.SUBKEY VALUE overrides")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None):
    """Runs the phase; returns the :class:`Trainer` after ``train``, the 12
    bbox stats after ``inference``, the path of ``features.npz`` after
    ``visualize``."""
    args = parse_args(argv)
    owned = not torch.distributed.is_initialized()
    device, group = init_distributed(args.device)
    try:
        return _run(args, device, group)
    finally:
        if group is not None and owned:
            torch.distributed.destroy_process_group()


def _run(args: argparse.Namespace, device: torch.device, group):
    rank, world = rank_and_world(group)
    opts = list(args.opts or [])
    if args.synthetic_data:
        # before finalize(), which derives SHOW_INTERVAL and
        # SAVE_FREQ_WITHIN_EPOCH from it; first, so that the user's opts win
        opts = ["CTRL.QUICK_VERIFY", "True"] + opts
    cfg = build_config(config_name=args.config_name or "default", phase=args.phase,
                       config_file=args.config_file, opts=opts, debug=bool(args.debug),
                       make_dirs=rank == 0)
    cfg.MISC.LOG_FILE = os.path.join(cfg.MISC.RESULT_FOLDER, "log.txt") if rank == 0 else None
    say = (lambda msg, **kw: print_log(msg, cfg.MISC.LOG_FILE, **kw)) if rank == 0 else (
        lambda msg, **kw: None)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    if args.synthetic_data and not args.data_root:
        dataset = synthetic.generate(num_images=8)
        val_api = COCO(dataset=dataset.coco_dataset())
        loader = make_loader(dataset, cfg, rank, world)
    else:
        data_root = args.data_root or cfg.DATASET.PATH
        if args.synthetic_data:
            if rank == 0:
                synthetic.write_coco(data_root, num_images=8)
            if group is not None:
                torch.distributed.barrier(group)
        loader, dataset, val_api = get_data(cfg, data_root=data_root, rank=rank, world=world)
    # a synthetic or small dataset has fewer classes than COCO's 81
    cfg.DATASET.NUM_CLASSES = dataset.num_classes
    model = build_model(cfg, device=device, seed=cfg.MISC.SEED,
                        dtype=COMPUTE_DTYPES[cfg.TPU.COMPUTE_DTYPE])
    say(f"device: {next(model.parameters()).device}, compute dtype {model.dtype}, "
        f"{world} rank(s)", init=True)
    cfg.display(lambda msg: say(msg, quiet_terminal=True))
    trainer = Trainer(model, cfg, group).resume()
    if args.phase != "train":
        # the same float32 parameters, evaluated in TEST.DTYPE where it is set
        if cfg.TEST.DTYPE and cfg.TEST.DTYPE != cfg.TPU.COMPUTE_DTYPE:
            trainer.model.dtype = COMPUTE_DTYPES[cfg.TEST.DTYPE]
    if args.phase == "inference":
        return test_model(trainer.model, cfg, dataset, val_api, epoch=trainer.epoch, group=group)
    if args.phase == "visualize":
        # rank 0's alone; the other ranks return at once and wait in no
        # collective while it runs
        path = os.path.join(cfg.MISC.RESULT_FOLDER, "features.npz")
        if rank == 0:
            out = [visualize(trainer.model, [dataset.load_image(int(i))], cfg)[0]
                   for i in dataset.image_ids]
            np.savez(path, features=np.stack([o["features"] for o in out]),
                     detections=np.stack([o["detections"] for o in out]))
            say(f"saved features to {path}")
        return path
    for stage in ("all",) if cfg.TRAIN.END2END else ("heads", "4+", "all"):
        train_model(trainer, loader, stage, val_api=val_api, val_dataset=dataset)
    return trainer


if __name__ == "__main__":
    main()
