"""The detector's five losses, as masked means.

Port of ``feature_intertwiner_tpu/train/losses.py``:

- rpn_class: cross entropy over the non-neutral anchors;
- rpn_bbox: smooth-L1 over the positive anchors, mean over positives × 4;
- mrcnn_class: cross entropy over every RoI slot (padding rows train as
  background), zero when the batch has no target class at all;
- mrcnn_bbox: smooth-L1 on the target class's deltas of positive rows,
  mean over positives × 4;
- mrcnn_mask: binary cross entropy on the target class's mask of positive
  rows, mean over positives × 28 × 28.
"""

from __future__ import annotations

import torch


def smooth_l1(x: torch.Tensor) -> torch.Tensor:
    """Elementwise smooth-L1 with beta 1."""
    ax = x.abs()
    return torch.where(ax < 1.0, 0.5 * x * x, ax - 0.5)


def _masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return (values * mask).sum() / mask.sum().clamp_min(1.0)


def rpn_class_loss(match: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """match [B, A] (1 / -1 / 0); logits [B, A, 2]."""
    target = (match == 1).to(torch.int64)
    logp = torch.log_softmax(logits.float(), dim=-1)
    ce = -torch.gather(logp, -1, target[..., None])[..., 0]
    return _masked_mean(ce, (match != 0).float())


def rpn_bbox_loss(target_deltas: torch.Tensor, match: torch.Tensor,
                  pred_deltas: torch.Tensor) -> torch.Tensor:
    """target and predicted deltas [B, A, 4]; the positives contribute."""
    pos = (match == 1).float()[..., None]
    err = smooth_l1(pred_deltas.float() - target_deltas)
    return _masked_mean(err, pos.expand_as(err))


def mrcnn_class_loss(target_class_ids: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """target [B, R] int; logits [B, R, K]. Mean over every slot."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ce = -torch.gather(logp, -1, target_class_ids.to(torch.int64)[..., None])[..., 0]
    has_any = (target_class_ids.sum() != 0).float()
    return ce.mean() * has_any


def mrcnn_bbox_loss(target_deltas: torch.Tensor, target_class_ids: torch.Tensor,
                    pred_deltas: torch.Tensor) -> torch.Tensor:
    """target_deltas [B, R, 4]; pred [B, R, K, 4]; positives: class > 0."""
    cls = target_class_ids.to(torch.int64).clamp_min(0)
    pred = torch.gather(pred_deltas, 2, cls[..., None, None].expand(-1, -1, 1, 4))[:, :, 0]
    pos = (target_class_ids > 0).float()[..., None]
    err = smooth_l1(pred.float() - target_deltas)
    return _masked_mean(err, pos.expand_as(err))


def mrcnn_mask_loss(target_masks: torch.Tensor, target_class_ids: torch.Tensor,
                    pred_masks: torch.Tensor) -> torch.Tensor:
    """target [B, R, mh, mw]; pred [B, R, mh, mw, K] (sigmoid outputs)."""
    b, r, mh, mw, _ = pred_masks.shape
    cls = target_class_ids.to(torch.int64).clamp_min(0)
    pred = torch.gather(pred_masks, 4, cls[:, :, None, None, None].expand(b, r, mh, mw, 1))[..., 0]
    p = pred.float().clamp(1e-7, 1.0 - 1e-7)
    t = target_masks.float()
    bce = -(t * torch.log(p) + (1.0 - t) * torch.log(1.0 - p))
    pos = (target_class_ids > 0).float()[:, :, None, None]
    return _masked_mean(bce, pos.expand_as(bce))
