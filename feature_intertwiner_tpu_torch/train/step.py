"""The training step: forward, the intertwiner buffer and meta loss, the
update.

Port of ``feature_intertwiner_tpu/train/step.py``. The class buffer of
big-object features is explicit state in :class:`TrainState`, beside the
model and the optimizer, and is checkpointed with them.

Loss assembly, as there: ``sum(five losses) + meta_gate · LOSS_FAC · meta
+ BIG_LOSS_FAC · mean(big) + FPN_OT_LOSS_FAC · mean(fpn_ot)`` (the last
with ``TRAIN.FPN_OT_LOSS``; the big term only with
``DEV.BIG_SUPERVISE``, and no Dev term under ``DEV.BASELINE``). The meta
loss is clamped at 0 when negative; ``meta_gate`` (0 before
``EFFECT_AFER_EP_PERCENT`` of epoch 1) gates its gradient, not the buffer
update; a step with no small-RoI statistics computes no meta loss and
leaves the buffer as it was. Under ``DEV.DIS_REG_LOSS`` the RPN box, box and
mask losses become ``x - x.detach()``: their value 0 (so is their share of
``total_loss``) and their gradient whole, as the JAX step (and the
reference's zeroing of ``.data``) has them. Under ``TRAIN.BN_LEARN`` the
forward runs with BN learning batch statistics (``models/common.py::
bn_learning``), frozen stages included, and the new running statistics are
the model's buffers after the step. Frozen parameters have no gradient
(see ``train/optim.py``); every trainable one gets one, zero where autograd
gave none, so that the optimizer decays and moves it as the JAX step does.
The gradients are clipped to their global norm, and the optimizer updates
in place.

Over ranks (``group``, ``parallel/data_parallel.py``), as the JAX step
under ``shard_map``: the Dev's statistics are summed over ranks before
their means (the sum's gradient summed too, as the transpose of ``psum``),
and so is the guard on small statistics, so that every rank takes the same
branch; after the zero-fill of the trainable gradients and before the clip
they are averaged in one flat bucket; the losses are averaged and the RoI
counts summed; under ``TRAIN.BN_LEARN`` the new BN statistics are averaged.
``INST_LOSS`` stays rank-local, and the OT meta loss runs on the merged
rows on every rank.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from ..parallel.data_parallel import (all_reduce_sum, mean_bn_statistics, mean_gradients,
                                      reduce_metrics)
from .optim import OPTIM_STATE, clip_global_norm, make_optimizer

EPS = 1e-20
LOSS_KEYS = ("rpn_class_loss", "rpn_bbox_loss", "mrcnn_class_loss",
             "mrcnn_bbox_loss", "mrcnn_mask_loss")


def init_buffer(buffer_size: int, num_classes: int, feat_dim: int = 1024,
                device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """A zero buffer [S, D, K] and its counts [S, 1, K]."""
    return (torch.zeros((buffer_size, feat_dim, num_classes), device=device),
            torch.zeros((buffer_size, 1, num_classes), device=device))


def _merge_stats(feat: torch.Tensor, cnt: torch.Tensor, group=None):
    """[S, D, K] statistics and [S, 1, K] counts over the meta levels (and
    the ranks of ``group``) -> their count-weighted mean [D, K] and summed
    count [1, K]."""
    wsum = all_reduce_sum((feat * cnt).sum(0), group)
    csum = all_reduce_sum(cnt.sum(0), group)
    return wsum / (csum + EPS), csum


def intertwiner_meta(
    cfg_dev: Dict[str, object],
    buffer: torch.Tensor,
    buffer_cnt: torch.Tensor,
    stats: Dict[str, torch.Tensor],
    meta_ot_fn: Optional[Callable[..., torch.Tensor]] = None,
    group=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The buffer update and the meta loss: (loss, new buffer, new counts).

    ``cfg_dev``: buffer_size, loss_choice ('l1' | 'l2' | 'kl' | 'ot') and
    inst_loss. ``stats``: the Dev statistics (``Dev.forward_train``).
    ``meta_ot_fn(small_rows, big_rows, row_weights)`` computes the 'ot'
    loss (``InterNet.meta_ot``), with no normalising denominator.
    ``BUFFER_SIZE`` 1 keeps the running mean of every step's big
    statistics; a larger buffer is a FIFO of the last steps. ``group``:
    the statistics are merged over its ranks."""
    buffer_size = cfg_dev["buffer_size"]
    loss_choice = cfg_dev["loss_choice"]
    big_merged, big_csum = _merge_stats(stats["big_feat"], stats["big_cnt"], group)
    has_small = (all_reduce_sum(stats["small_feat"].sum().detach(), group) != 0).float()

    if buffer_size == 1:
        feat_sum = buffer * buffer_cnt + big_merged[None] * big_csum[None]
        new_cnt = buffer_cnt + big_csum[None]
        new_buffer = feat_sum / (new_cnt + EPS)
        final_big = new_buffer[0]
        final_big_cnt = new_cnt[0]
    else:
        new_buffer = torch.cat([buffer[1:], big_merged[None]], dim=0)
        new_cnt = torch.cat([buffer_cnt[1:], big_csum[None]], dim=0)
        final_big = (new_buffer * new_cnt).sum(0) / (new_cnt.sum(0) + EPS)
        final_big_cnt = new_cnt.sum(0)

    # the buffer stays as it was when no small statistics came this step
    new_buffer = has_small * new_buffer + (1 - has_small) * buffer
    new_cnt = has_small * new_cnt + (1 - has_small) * buffer_cnt

    big_side = final_big.detach().T                                  # [K, D]
    if cfg_dev["inst_loss"]:
        # every small RoI of a class the buffer holds, against its class row
        small_gt = stats["small_gt"].to(torch.int64)
        in_buffer = final_big_cnt[0][small_gt] > 0
        w = ((small_gt > 0) & in_buffer).float()
        big_rows = big_side[small_gt]
        small_rows = stats["small_out"]
    else:
        small_merged, small_csum = _merge_stats(stats["small_feat"], stats["small_cnt"], group)
        small_csum = small_csum.clone()
        small_csum[0, 0] = 0.0                                       # no background
        w = ((small_csum[0] > 0) & (final_big_cnt[0] > 0)).float()
        small_rows = small_merged.T
        big_rows = big_side

    wm = w[:, None]
    denom = (wm.sum() * small_rows.shape[1]).clamp_min(1.0)
    if loss_choice == "l2":
        loss = (((small_rows - big_rows) ** 2) * wm).sum() / denom
    elif loss_choice == "l1":
        loss = ((small_rows - big_rows).abs() * wm).sum() / denom
    elif loss_choice == "kl":
        kl = big_rows * (torch.log(big_rows + EPS) - torch.log(small_rows + EPS))
        loss = (kl * wm).sum() / denom
    elif loss_choice == "ot":
        loss = meta_ot_fn(small_rows, big_rows, w)
    else:
        raise ValueError(f"DEV.LOSS_CHOICE {loss_choice}")
    loss = loss * has_small
    loss = torch.where(loss < 0, loss.new_zeros(()), loss)
    return loss, new_buffer, new_cnt


@dataclass
class TrainState:
    """What a training run carries from step to step."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    buffer: torch.Tensor       # [BUFFER_SIZE, 1024, K]
    buffer_cnt: torch.Tensor   # [BUFFER_SIZE, 1, K]
    step: int = 0


def create_train_state(cfg, model: torch.nn.Module) -> TrainState:
    """Optimizer and a zero buffer for ``model`` (on its device)."""
    device = next(model.parameters()).device
    buf, cnt = init_buffer(cfg.DEV.BUFFER_SIZE if cfg.DEV.SWITCH else 1,
                           cfg.DATASET.NUM_CLASSES, device=device)
    return TrainState(model, make_optimizer(cfg, model), buf, cnt)


def load_trainer_state(state: TrainState, payload: Dict[str, object]) -> None:
    """Load ``utils/convert_weights.py::from_jax_train_state``'s output (or
    a checkpoint's equivalent parts) into ``state``: weights and BN
    statistics, the optimizer's state (``payload["optim"]``: per slot of
    :data:`~.optim.OPTIM_STATE`, port parameter name -> tensor, and Adam's
    step ``count``), buffer and step. The payload's optimizer must be the
    state's."""
    model = state.model
    device = next(model.parameters()).device
    model.load_state_dict(payload["model"], strict=True)
    optim = payload["optim"]
    opt = state.optimizer
    method = "sgd" if isinstance(opt, torch.optim.SGD) else opt.param_groups[0]["method"]
    if set(optim) - {"count"} != set(OPTIM_STATE[method]):
        raise ValueError(f"the payload holds {sorted(optim)}, the {method} optimizer "
                         f"{OPTIM_STATE[method]}")
    for name, p in model.named_parameters():
        for slot in OPTIM_STATE[method]:
            opt.state[p][slot] = optim[slot][name].to(device=device, dtype=p.dtype).clone()
    if "count" in optim:
        opt.param_groups[0]["count"] = int(optim["count"])
    state.buffer = payload["buffer"].to(device).clone()
    state.buffer_cnt = payload["buffer_cnt"].to(device).clone()
    state.step = int(payload["step"])


# the losses DEV.DIS_REG_LOSS reads as 0 and still trains
REG_LOSS_KEYS = ("rpn_bbox_loss", "mrcnn_bbox_loss", "mrcnn_mask_loss")


def train_step(state: TrainState, cfg, batch: Dict[str, torch.Tensor], lr: float,
               meta_gate: float, generator: Optional[torch.Generator] = None,
               draws: Optional[Dict[str, torch.Tensor]] = None,
               group=None) -> Dict[str, torch.Tensor]:
    """One step on ``batch`` (images, gt_class_ids, gt_boxes, gt_masks as
    tensors on the model's device). Updates ``state`` in place and returns
    the metrics as tensors (no host sync): the five losses, total_loss,
    meta_loss, big_loss, fpn_ot_loss, grad_norm (with CLIP_GRAD),
    positive_rois and small_rois_p<l> (small RoIs of a class per meta level
    l: 2-4, or 2-5 under ``DEV.ASSIGN_BOX_ON_ALL_SCALE``). ``batch`` is this
    rank's shard under ``group``; the metrics are then the whole batch's
    (module docstring)."""
    model, opt = state.model, state.optimizer
    out = model.forward_train(batch["images"], batch["gt_class_ids"], batch["gt_boxes"],
                              batch["gt_masks"], generator=generator, draws=draws,
                              train_bn=bool(cfg.TRAIN.BN_LEARN))
    detailed = {k: out[k] for k in LOSS_KEYS}
    if cfg.DEV.DIS_REG_LOSS:
        for k in REG_LOSS_KEYS:
            detailed[k] = detailed[k] - detailed[k].detach()
    total = sum(detailed.values())
    zero = total.new_zeros(())
    meta, big_loss = zero, zero
    new_buf, new_cnt = state.buffer, state.buffer_cnt
    stats = out.get("intertwiner")
    if cfg.DEV.SWITCH and not cfg.DEV.BASELINE and stats is not None:
        dev_cfg = {"buffer_size": cfg.DEV.BUFFER_SIZE, "loss_choice": cfg.DEV.LOSS_CHOICE,
                   "inst_loss": cfg.DEV.INST_LOSS}
        meta, new_buf, new_cnt = intertwiner_meta(dev_cfg, state.buffer, state.buffer_cnt, stats,
                                                  meta_ot_fn=model.meta_ot, group=group)
        total = total + meta_gate * cfg.DEV.LOSS_FAC * meta
        big_loss = stats["big_loss"].mean()
        big_fac = cfg.DEV.BIG_LOSS_FAC if cfg.DEV.BIG_SUPERVISE else 0.0
        total = total + big_fac * big_loss
    fpn_ot = out["fpn_ot_loss"].mean()
    if cfg.TRAIN.FPN_OT_LOSS:
        total = total + cfg.TRAIN.FPN_OT_LOSS_FAC * fpn_ot

    opt.zero_grad(set_to_none=True)
    total.backward()
    params = [p for p in model.parameters() if p.requires_grad]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    mean_gradients(params, group)
    metrics = {k: v.detach() for k, v in detailed.items()}
    metrics.update(total_loss=total.detach(), meta_loss=meta.detach(),
                   big_loss=big_loss.detach(), fpn_ot_loss=fpn_ot.detach(),
                   positive_rois=out["positive_rois"])
    if stats is not None:
        for i, level in enumerate(model.dev_roi.meta_levels):
            metrics[f"small_rois_p{level}"] = stats["small_cnt"][i].sum()
    metrics = reduce_metrics(metrics, group)
    if cfg.TRAIN.BN_LEARN:
        mean_bn_statistics(model, group)
    if cfg.TRAIN.CLIP_GRAD:
        metrics["grad_norm"] = clip_global_norm([p.grad for p in params],
                                                cfg.TRAIN.MAX_GRAD_NORM)
    for pg in opt.param_groups:
        pg["lr"] = lr
    opt.step()
    state.buffer, state.buffer_cnt = new_buf.detach(), new_cnt.detach()
    state.step += 1
    return metrics
