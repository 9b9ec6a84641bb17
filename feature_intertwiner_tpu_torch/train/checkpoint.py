"""Checkpoints: save, find the newest, restore, prune.

Port of ``feature_intertwiner_tpu/train/checkpoint.py`` with ``torch.save``
in place of orbax. A checkpoint is one file
``<result folder>/checkpoints/ckpt_ep<epoch>_iter<iter>.pt`` holding the
model's state_dict (with the BN running statistics), the optimizer's
(SGD's momentum; Adam's and RMSprop's moments, RMSprop's trace and the step
count of both), the intertwiner buffer and its counts, the step, the epoch
and the iteration. It is written to a
temporary name and renamed, so a reader only ever sees whole files.
Resume takes the newest by (epoch, iteration); pruning keeps the newest by
modification time (see the JAX module for why the two orders differ).
Over the ranks of a group (``parallel/data_parallel.py``), whose states are
the same, rank 0 writes and prunes and every rank waits for it; each rank
restores from the same file.
"""

from __future__ import annotations

import os
import re
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from .step import TrainState

CKPT_RE = re.compile(r"ckpt_ep(\d+)_iter(\d+)\.pt$")


def checkpoint_dir(result_folder: str) -> str:
    return os.path.abspath(os.path.join(result_folder, "checkpoints"))


def _found(result_folder: str):
    d = checkpoint_dir(result_folder)
    if not os.path.isdir(d):
        return []
    return [(name, CKPT_RE.match(name)) for name in os.listdir(d) if CKPT_RE.match(name)]


def prune_old(result_folder: str, keep: int) -> None:
    """Delete all but the ``keep`` newest checkpoints (by modification
    time, then epoch and iteration); ``keep <= 0`` keeps every one."""
    if keep <= 0:
        return
    d = checkpoint_dir(result_folder)
    found = sorted((os.path.getmtime(os.path.join(d, name)), int(m.group(1)),
                    int(m.group(2)), name) for name, m in _found(result_folder))
    for *_, name in found[:max(len(found) - keep, 0)]:
        os.remove(os.path.join(d, name))


def save_checkpoint(result_folder: str, state: TrainState, epoch: int,
                    iter_ind: int, keep: int = 0, group=None) -> str:
    """Write the state at (epoch, iter_ind); then keep the ``keep`` newest
    (0: all). Returns the path. Under ``group`` only its rank 0 writes, and
    every rank returns once the file is there."""
    d = checkpoint_dir(result_folder)
    path = os.path.join(d, f"ckpt_ep{epoch:04d}_iter{iter_ind:06d}.pt")
    if group is None or dist.get_rank(group) == 0:
        _write(path, state, epoch, iter_ind)
        prune_old(result_folder, keep)
    if group is not None:
        dist.barrier(group)
    return path


def _write(path: str, state: TrainState, epoch: int, iter_ind: int) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "buffer": state.buffer,
        "buffer_cnt": state.buffer_cnt,
        "step": state.step,
        "epoch": epoch,
        "iter": iter_ind,
    }, tmp)
    os.replace(tmp, path)


def find_last(result_folder: str) -> Optional[str]:
    """The newest checkpoint by (epoch, iteration), or None."""
    found = [((int(m.group(1)), int(m.group(2))), name) for name, m in _found(result_folder)]
    if not found:
        return None
    return os.path.join(checkpoint_dir(result_folder), max(found)[1])


def restore_checkpoint(path: str, state: TrainState) -> Tuple[TrainState, int, int]:
    """Load ``path`` into ``state`` (on the model's device); returns
    (state, epoch, iter). A buffer of another shape (another
    ``DEV.BUFFER_SIZE``) is not loaded: the state keeps its own, as in the
    JAX package."""
    device = state.buffer.device
    payload = torch.load(path, map_location=device, weights_only=True)
    state.model.load_state_dict(payload["model"], strict=True)
    state.optimizer.load_state_dict(payload["optimizer"])
    if payload["buffer"].shape == state.buffer.shape:
        state.buffer = payload["buffer"].to(device)
        state.buffer_cnt = payload["buffer_cnt"].to(device)
    state.step = int(payload["step"])
    return state, int(payload["epoch"]), int(payload["iter"])


def resolve_init(cfg, result_folder: str) -> Optional[str]:
    """Where a run starts from: an explicit ``MODEL.INIT_FILE_CHOICE`` file,
    else the newest checkpoint of the run (of its train folder for another
    phase), else the pretrained file the choice names, else None."""
    choice = cfg.MODEL.INIT_FILE_CHOICE
    if choice and choice != "last" and os.path.exists(str(choice)):
        return str(choice)
    last = find_last(result_folder)
    if last:
        return last
    if os.path.basename(result_folder.rstrip("/")) != "train":
        last = find_last(os.path.join(os.path.dirname(result_folder.rstrip("/")), "train"))
        if last:
            return last
    if choice == "coco_pretrain" and os.path.exists(cfg.MODEL.PRETRAIN_COCO_MODEL):
        return cfg.MODEL.PRETRAIN_COCO_MODEL
    if choice == "imagenet_pretrain" and os.path.exists(cfg.MODEL.PRETRAIN_IMAGENET_MODEL):
        return cfg.MODEL.PRETRAIN_IMAGENET_MODEL
    return None
