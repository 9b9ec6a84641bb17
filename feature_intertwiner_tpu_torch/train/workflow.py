"""The training loop: stages, epochs, iterations, checkpoints.

Port of the training half of ``feature_intertwiner_tpu/train/workflow.py``:

- :class:`Trainer` holds the model, the :class:`TrainState` and the
  epoch/iteration counters; :meth:`Trainer.resume` restarts from the newest
  checkpoint;
- :func:`train_model` runs one stage ('heads', '4+', 'all') over the epochs
  the cumulative ``TRAIN.SCHEDULE`` gives it, skipping a stage a resumed run
  has finished;
- :func:`train_epoch` runs the iterations: the learning rate per
  iteration, the meta-loss gate after ``EFFECT_AFER_EP_PERCENT`` of epoch 1,
  the loss line every ``SHOW_INTERVAL``, and ``SAVE_FREQ_WITHIN_EPOCH``
  saves per epoch. Each iteration's sampling generator is seeded from
  (seed, epoch, iteration), so a run resumed mid-epoch skips the iterations
  it has done and replays nothing.

The eval loop is slice S2 of the port and not here yet: with
``TRAIN.DO_VALIDATION`` on, :func:`train_model` raises.
"""

from __future__ import annotations

import math
import os
import time
from typing import Dict

import numpy as np
import torch

from ..utils.logging import MetricsLogger, format_loss_line, print_log
from . import checkpoint as ckpt
from .optim import learning_rate, set_trainable
from .step import create_train_state, train_step

STAGE_ORDER = {"heads": 1, "4+": 2, "all": 3}


def iteration_seed(seed: int, epoch: int, iteration: int) -> int:
    """The sampling seed of one iteration, a function of (seed, epoch,
    iteration) only."""
    return ((seed + 1009 * epoch) * 1_000_003 + iteration) % (2 ** 63)


class Trainer:
    """The model, its :class:`TrainState` and the epoch and iteration
    counters, across stages. The model stays in ``eval()``: BN uses its
    running statistics in training (the JAX package's ``strict_quirks``)."""

    def __init__(self, model: torch.nn.Module, cfg):
        self.model = model.eval()
        self.cfg = cfg
        self.device = next(model.parameters()).device
        self.state = create_train_state(cfg, model)
        self.epoch = 1
        self.iter = 1
        self.metrics_logger = MetricsLogger(
            os.path.join(cfg.MISC.RESULT_FOLDER or ".", "metrics.jsonl"))

    def resume(self) -> "Trainer":
        """Restart from the newest checkpoint of the run, if there is one."""
        path = ckpt.resolve_init(self.cfg, self.cfg.MISC.RESULT_FOLDER)
        if path and ckpt.CKPT_RE.search(os.path.basename(path)):
            self.state, epoch, it = ckpt.restore_checkpoint(path, self.state)
            self.epoch, self.iter = epoch, it + 1
            print_log(f"resumed from {path} (ep {epoch}, iter {it})", self.cfg.MISC.LOG_FILE)
        elif path:
            raise NotImplementedError(
                f"initialising from pretrained weights ({path}) is not ported: "
                "the repository holds no pretrained .pth, .npz or .h5 files")
        if self.cfg.TRAIN.FORCE_START_EPOCH:
            self.epoch = self.cfg.TRAIN.FORCE_START_EPOCH
            self.iter = 1
            print_log(f"FORCE_START_EPOCH={self.epoch}: schedule restarted there",
                      self.cfg.MISC.LOG_FILE)
        return self


def train_model(trainer: Trainer, loader, layers: str) -> None:
    """One stage; its epochs end at the cumulative SCHEDULE of the stage."""
    cfg = trainer.cfg
    if cfg.TRAIN.DO_VALIDATION:
        raise NotImplementedError(
            "TRAIN.DO_VALIDATION: the eval loop is slice S2 of the port, not "
            "ported yet; pass TRAIN.DO_VALIDATION False")
    stage_name = layers.upper()
    if trainer.iter > len(loader):
        # resumed from an end-of-epoch checkpoint: start the next epoch
        trainer.epoch += 1
        trainer.iter = 1
    total_ep = int(np.sum(cfg.TRAIN.SCHEDULE[:STAGE_ORDER[layers]]))
    if trainer.epoch > total_ep:
        print_log(f"skip {stage_name} stage ...", cfg.MISC.LOG_FILE)
        return
    print_log(f"\n[Stage {stage_name}] start at epoch {trainer.epoch}, "
              f"iter {trainer.iter}; stage ends at epoch {total_ep}.", cfg.MISC.LOG_FILE)
    for ep in range(trainer.epoch, total_ep + 1):
        epoch_str = f"[Ep {ep:03d}/{total_ep}]"
        print_log(epoch_str, cfg.MISC.LOG_FILE)
        train_epoch(trainer, loader, layers, ep, start_iter=trainer.iter,
                    stage_name=stage_name, epoch_str=epoch_str)
        ckpt.save_checkpoint(cfg.MISC.RESULT_FOLDER, trainer.state, ep, len(loader),
                             keep=cfg.TRAIN.KEEP_CHECKPOINTS)
        trainer.iter = 1
        trainer.epoch = ep
    trainer.epoch += 1


BATCH_KEYS = ("images", "gt_class_ids", "gt_boxes", "gt_masks")


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """The arrays of a loader batch the train step reads, as tensors on
    ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(batch[k])).to(device) for k in BATCH_KEYS}


def train_epoch(trainer: Trainer, loader, layers: str, epoch: int,
                start_iter: int = 1, stage_name: str = "", epoch_str: str = "") -> None:
    cfg = trainer.cfg
    set_trainable(trainer.model, layers)
    total_iter = len(loader)
    save_base = max(1, math.floor(total_iter / cfg.TRAIN.SAVE_FREQ_WITHIN_EPOCH))
    # the meta loss takes effect after a fraction of epoch 1
    if epoch == 1 and cfg.DEV.SWITCH:
        do_meta_after = math.floor(cfg.DEV.EFFECT_AFER_EP_PERCENT * total_iter)
    else:
        do_meta_after = -1

    loader.set_epoch(epoch)
    t_iter = time.time()
    for it, batch in enumerate(loader, start=1):
        if it > total_iter:
            break
        if it < start_iter:
            continue
        lr = learning_rate(cfg, epoch, it)
        meta_gate = 1.0 if it > do_meta_after else 0.0
        generator = torch.Generator(device=trainer.device)
        generator.manual_seed(iteration_seed(cfg.MISC.SEED, epoch, it))
        try:
            metrics = train_step(trainer.state, cfg, to_device(batch, trainer.device), lr,
                                 meta_gate, generator)
        except Exception as exc:
            trainer.metrics_logger.log(epoch=epoch, iter=it,
                                       error=f"{type(exc).__name__}: {exc}")
            print_log(f"[ERROR] ep {epoch} iter {it}: {exc}", cfg.MISC.LOG_FILE)
            raise
        if it % cfg.CTRL.SHOW_INTERVAL == 0 or it == start_iter or it == total_iter:
            host = {k: float(v) for k, v in metrics.items()}
            dt = time.time() - t_iter
            print_log(format_loss_line(stage_name, epoch_str, it, total_iter, lr, host,
                                       dt / max(1, cfg.CTRL.SHOW_INTERVAL)),
                      cfg.MISC.LOG_FILE)
            trainer.metrics_logger.log(epoch=epoch, iter=it, lr=lr, **host)
            t_iter = time.time()
        if it % save_base == 0:
            ckpt.save_checkpoint(cfg.MISC.RESULT_FOLDER, trainer.state, epoch, it,
                                 keep=cfg.TRAIN.KEEP_CHECKPOINTS)
    trainer.iter = 1
