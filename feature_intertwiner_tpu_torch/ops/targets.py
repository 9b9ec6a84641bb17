"""Training targets for the RPN and the second stage, batched.

Port of ``feature_intertwiner_tpu/ops/targets.py``. The JAX package vmaps a
per-sample function; here every tensor carries the batch as its first
dimension. Semantics, as there:

- crowd GT boxes (negative class ids) take part in no match, and an anchor
  or proposal that overlaps a crowd by IoU >= 0.001 cannot be a negative;
- RPN: negative below ``neg_thresh``, the best anchor of each GT forced
  positive, positive from ``pos_thresh``; at most half the budget positive,
  negatives fill the rest; deltas divided by BBOX_STD_DEV;
- second stage: positive from IoU 0.5; ``int(R ratio)`` positive slots
  ``[0, pos_cap)`` then the negative slots, ``int(n_pos (1/ratio - 1))``
  of them used; per-RoI deltas; mask targets cropped from each positive's
  (mini-)mask into the RoI frame at MASK_SHAPE and rounded;
- zero padding everywhere (padded rows are class 0).

The random subsets are the ``k`` highest of i.i.d. uniform scores over the
eligible elements (``_random_topk_mask``). Both functions take a
``torch.Generator`` that draws those scores, or the scores themselves as
``draws`` (the tests feed in the JAX package's own draws that way):
``[B, 2, N]``, the positive draw then the negative draw of each sample.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from . import boxes as box_ops
from .roi_align import crop_and_resize_separable


def _uniform_draws(shape, generator: Optional[torch.Generator],
                   draws: Optional[torch.Tensor], device) -> torch.Tensor:
    """The [B, 2, N] uniform scores: ``draws`` if given, else drawn from
    ``generator`` (on ``device``)."""
    if draws is not None:
        if tuple(draws.shape) != tuple(shape):
            raise ValueError(f"draws must be {tuple(shape)}, got {tuple(draws.shape)}")
        return draws.to(device=device, dtype=torch.float32)
    if generator is None:
        raise ValueError("the targets need a generator or draws")
    return torch.rand(shape, generator=generator, device=device)


def _random_topk_mask(uniform: torch.Tensor, eligible: torch.Tensor, k: int,
                      budget: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Up to ``k`` random elements of each row of ``eligible`` [B, N] bool,
    given the rows' uniform scores [B, N].

    Returns (idx [B, k] int64, valid [B, k] bool): the indices of the ``k``
    highest scores, eligible first, ties toward the lower index as
    ``jax.lax.top_k`` breaks them (a stable descending sort), padded with
    index 0 past N; ``valid`` marks the first ``min(#eligible, k, budget)``.
    """
    n = eligible.shape[1]
    scores = torch.where(eligible, uniform, uniform.new_tensor(-1.0))
    k_eff = min(k, n)
    idx = torch.sort(scores, dim=1, descending=True, stable=True)[1][:, :k_eff]
    if k_eff < k:
        idx = torch.cat([idx, idx.new_zeros((idx.shape[0], k - k_eff))], dim=1)
    count = eligible.sum(1).clamp_max(k_eff)
    if budget is not None:
        count = torch.minimum(count, budget)
    valid = torch.arange(k, device=eligible.device)[None, :] < count[:, None]
    return idx, valid


def _random_keep_mask(uniform: torch.Tensor, eligible: torch.Tensor, k: int,
                      budget: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dense [B, N] bool form of :func:`_random_topk_mask`: invalid slots,
    padded with index 0, must not mark element 0, so they write to a spare
    column that is dropped."""
    idx, valid = _random_topk_mask(uniform, eligible, k, budget)
    n = eligible.shape[1]
    keep = torch.zeros((eligible.shape[0], n + 1), dtype=torch.bool, device=eligible.device)
    keep.scatter_(1, torch.where(valid, idx, n), True)
    return keep[:, :n]


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, N, ...], idx [B, M] -> [B, M, ...]."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


class RPNTargets(NamedTuple):
    match: torch.Tensor     # [B, A] int32: 1 positive, -1 negative, 0 neutral
    deltas: torch.Tensor    # [B, A, 4] (valid on positive rows)


@torch.no_grad()
def rpn_targets(
    anchors: torch.Tensor,
    gt_class_ids: torch.Tensor,
    gt_boxes: torch.Tensor,
    bbox_std_dev: torch.Tensor,
    train_anchors_per_image: int = 256,
    pos_thresh: float = 0.7,
    neg_thresh: float = 0.3,
    generator: Optional[torch.Generator] = None,
    draws: Optional[torch.Tensor] = None,
) -> RPNTargets:
    """anchors [A, 4] pixels; gt_class_ids [B, G] (0 pad, < 0 crowd);
    gt_boxes [B, G, 4] pixels. Dense per-anchor targets."""
    b, a = gt_class_ids.shape[0], anchors.shape[0]
    half = train_anchors_per_image // 2
    uniform = _uniform_draws((b, 2, a), generator, draws, anchors.device)
    valid_gt = (gt_class_ids > 0)[:, None, :]
    crowd = (gt_class_ids < 0)[:, None, :]

    iou = box_ops.iou_matrix(anchors[None], gt_boxes)             # [B, A, G]
    iou_valid = torch.where(valid_gt, iou, iou.new_tensor(-1.0))
    anchor_iou_max, anchor_iou_argmax = iou_valid.max(dim=2)
    no_crowd = torch.where(crowd, iou, iou.new_tensor(-1.0)).amax(dim=2) < 0.001

    match = torch.zeros((b, a), dtype=torch.int32, device=anchors.device)
    match = torch.where((anchor_iou_max < neg_thresh) & no_crowd, -1, match)

    # force-match the best anchor of each valid GT
    gt_best_anchor = iou_valid.argmax(dim=1)                        # [B, G]
    force = torch.zeros((b, a), dtype=torch.int32, device=anchors.device)
    force.scatter_add_(1, gt_best_anchor, valid_gt[:, 0].to(torch.int32))
    match = torch.where(force > 0, 1, match)
    match = torch.where(anchor_iou_max >= pos_thresh, 1, match)

    pos = match == 1
    keep_pos = _random_keep_mask(uniform[:, 0], pos, half)
    match = torch.where(pos & ~keep_pos, 0, match)

    budget = train_anchors_per_image - (match == 1).sum(1)
    neg = match == -1
    keep_neg = _random_keep_mask(uniform[:, 1], neg, train_anchors_per_image, budget)
    match = torch.where(neg & ~keep_neg, 0, match)

    matched_gt = _take_rows(gt_boxes, anchor_iou_argmax)
    deltas = box_ops.encode(anchors[None], matched_gt, eps=1e-8) / bbox_std_dev
    deltas = torch.where((match == 1)[..., None], deltas, deltas.new_zeros(()))
    return RPNTargets(match, deltas)


class DetTargets(NamedTuple):
    rois: torch.Tensor        # [B, R, 4] normalised, zero-padded
    class_ids: torch.Tensor   # [B, R] int64 (0 background or padding)
    deltas: torch.Tensor      # [B, R, 4] (valid on positive rows)
    masks: torch.Tensor       # [B, R, mh, mw] binary
    pos_mask: torch.Tensor    # [B, R] bool: sampled positives
    valid_mask: torch.Tensor  # [B, R] bool: sampled rois, positive or negative


@torch.no_grad()
def detection_targets(
    proposals: torch.Tensor,
    gt_class_ids: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_masks: torch.Tensor,
    bbox_std_dev: torch.Tensor,
    rois_per_image: int = 200,
    positive_ratio: float = 0.33,
    mask_shape: Tuple[int, int] = (28, 28),
    use_mini_mask: bool = True,
    generator: Optional[torch.Generator] = None,
    draws: Optional[torch.Tensor] = None,
) -> DetTargets:
    """proposals [B, P, 4] normalised; gt_boxes [B, G, 4] normalised;
    gt_masks [B, G, mh, mw] (mini-masks or full).

    Static layout: positives in slots ``[0, pos_cap)``, negatives in
    ``[pos_cap, rois_per_image)``."""
    b, p = proposals.shape[:2]
    dev = proposals.device
    pos_cap = int(rois_per_image * positive_ratio)
    neg_cap = rois_per_image - pos_cap
    inv_ratio = torch.tensor(1.0 / positive_ratio, dtype=torch.float32)
    uniform = _uniform_draws((b, 2, p), generator, draws, dev)

    valid_gt = (gt_class_ids > 0)[:, None, :]
    crowd = (gt_class_ids < 0)[:, None, :]
    valid_prop = (proposals != 0.0).any(-1)

    iou = box_ops.iou_matrix(proposals, gt_boxes)                 # [B, P, G]
    iou_valid = torch.where(valid_gt, iou, iou.new_tensor(-1.0))
    roi_iou_max, gt_assign = iou_valid.max(dim=2)
    no_crowd = torch.where(crowd, iou, iou.new_tensor(-1.0)).amax(dim=2) < 0.001

    pos_bool = (roi_iou_max >= 0.5) & valid_prop
    neg_bool = (roi_iou_max < 0.5) & no_crowd & valid_prop

    pos_idx, pos_valid = _random_topk_mask(uniform[:, 0], pos_bool, pos_cap)
    n_pos = pos_valid.sum(1).to(torch.float32)
    # int(r pos - pos) in float32, as the JAX package computes it
    want_neg = torch.floor(inv_ratio.to(dev) * n_pos - n_pos).to(torch.int64)
    neg_idx, neg_avail = _random_topk_mask(uniform[:, 1], neg_bool, neg_cap)
    neg_valid = neg_avail & (torch.arange(neg_cap, device=dev)[None, :] < want_neg[:, None])

    idx = torch.cat([pos_idx, neg_idx], dim=1)
    sel_valid = torch.cat([pos_valid, neg_valid], dim=1)
    sel_pos = torch.cat([pos_valid, torch.zeros_like(neg_valid)], dim=1)

    rois = _take_rows(proposals, idx) * sel_valid[..., None]
    roi_gt = torch.gather(gt_assign, 1, idx)
    roi_cls = torch.gather(gt_class_ids.to(torch.int64), 1, roi_gt)
    roi_cls = torch.where(sel_pos, roi_cls, 0).clamp_min(0)

    matched = _take_rows(gt_boxes, roi_gt)
    deltas = box_ops.encode(rois, matched, eps=1e-8) / bbox_std_dev
    deltas = torch.where(sel_pos[..., None], deltas, deltas.new_zeros(()))

    # mask targets: only the positive slots are cropped
    p_rois = rois[:, :pos_cap]
    if use_mini_mask:
        gy1, gx1, gy2, gx2 = matched[:, :pos_cap].unbind(-1)
        gh = (gy2 - gy1).clamp_min(1e-8)
        gw = (gx2 - gx1).clamp_min(1e-8)
        mb = torch.stack([(p_rois[..., 0] - gy1) / gh, (p_rois[..., 1] - gx1) / gw,
                          (p_rois[..., 2] - gy1) / gh, (p_rois[..., 3] - gx1) / gw], dim=-1)
    else:
        mb = p_rois
    roi_masks = _take_rows(gt_masks, roi_gt[:, :pos_cap]).to(torch.float32)
    mh, mw = roi_masks.shape[-2:]
    crops = crop_and_resize_separable(
        roi_masks.reshape(b * pos_cap, mh, mw, 1), mb.reshape(b * pos_cap, 4),
        tuple(mask_shape))[..., 0].reshape(b, pos_cap, *mask_shape)
    crops = torch.round(crops) * sel_pos[:, :pos_cap, None, None]
    masks = torch.cat([crops, crops.new_zeros((b, neg_cap) + tuple(mask_shape))], dim=1)
    return DetTargets(rois, roi_cls, deltas, masks, sel_pos, sel_valid)
