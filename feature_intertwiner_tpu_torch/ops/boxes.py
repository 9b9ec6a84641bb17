"""Box math on ``(y1, x1, y2, x2)`` tensors.

Port of ``feature_intertwiner_tpu/ops/boxes.py`` (``decode`` and ``clip``
for inference, ``encode``, ``area`` and ``iou_matrix`` for the training
targets, ``boxes_from_masks``), in the same operation order so that the two
packages round alike.
"""

from __future__ import annotations

import torch


def decode(boxes: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """Apply ``(dy, dx, log(dh), log(dw))`` deltas to ``[..., 4]`` boxes."""
    height = boxes[..., 2] - boxes[..., 0]
    width = boxes[..., 3] - boxes[..., 1]
    center_y = boxes[..., 0] + 0.5 * height
    center_x = boxes[..., 1] + 0.5 * width

    center_y = center_y + deltas[..., 0] * height
    center_x = center_x + deltas[..., 1] * width
    height = height * torch.exp(deltas[..., 2])
    width = width * torch.exp(deltas[..., 3])

    y1 = center_y - 0.5 * height
    x1 = center_x - 0.5 * width
    # y2 = y1 + height, not center + height / 2: the JAX order, kept so the
    # two packages round alike.
    y2 = y1 + height
    x2 = x1 + width
    return torch.stack([y1, x1, y2, x2], dim=-1)


def clip(boxes: torch.Tensor, window) -> torch.Tensor:
    """Clamp boxes to ``window = (y1, x1, y2, x2)``: ``[4]`` shared, or any
    shape that broadcasts against ``boxes`` (e.g. ``[B, 1, 4]``)."""
    window = torch.as_tensor(window, dtype=boxes.dtype, device=boxes.device)
    lo_y, lo_x = window[..., 0], window[..., 1]
    hi_y, hi_x = window[..., 2], window[..., 3]

    def clamp(v, lo, hi):
        return torch.minimum(torch.maximum(v, lo), hi)

    return torch.stack(
        [
            clamp(boxes[..., 0], lo_y, hi_y),
            clamp(boxes[..., 1], lo_x, hi_x),
            clamp(boxes[..., 2], lo_y, hi_y),
            clamp(boxes[..., 3], lo_x, hi_x),
        ],
        dim=-1,
    )


def encode(boxes: torch.Tensor, gt_boxes: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Deltas ``(dy, dx, log(dh), log(dw))`` that turn ``boxes`` into
    ``gt_boxes`` ([..., 4] each). ``eps`` is added to every height and width
    (the targets pass 1e-8, since zero-padded rows may appear)."""
    height = boxes[..., 2] - boxes[..., 0] + eps
    width = boxes[..., 3] - boxes[..., 1] + eps
    center_y = boxes[..., 0] + 0.5 * height
    center_x = boxes[..., 1] + 0.5 * width

    gt_height = gt_boxes[..., 2] - gt_boxes[..., 0] + eps
    gt_width = gt_boxes[..., 3] - gt_boxes[..., 1] + eps
    gt_center_y = gt_boxes[..., 0] + 0.5 * gt_height
    gt_center_x = gt_boxes[..., 1] + 0.5 * gt_width

    dy = (gt_center_y - center_y) / height
    dx = (gt_center_x - center_x) / width
    dh = torch.log(gt_height / height)
    dw = torch.log(gt_width / width)
    return torch.stack([dy, dx, dh, dw], dim=-1)


def area(boxes: torch.Tensor) -> torch.Tensor:
    """[..., 4] -> [...] box areas (no +1 convention)."""
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


IOU_EPS = 1e-19


def iou_matrix(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """All-pairs IoU: [..., N, 4] and [..., M, 4] -> [..., N, M], with the
    reference's ``union + 1e-19``."""
    b1 = boxes1[..., :, None, :]
    b2 = boxes2[..., None, :, :]
    y1 = torch.maximum(b1[..., 0], b2[..., 0])
    x1 = torch.maximum(b1[..., 1], b2[..., 1])
    y2 = torch.minimum(b1[..., 2], b2[..., 2])
    x2 = torch.minimum(b1[..., 3], b2[..., 3])
    intersection = (x2 - x1).clamp_min(0.0) * (y2 - y1).clamp_min(0.0)
    union = area(b1) + area(b2) - intersection
    return intersection / (union + IOU_EPS)


def boxes_from_masks(masks: torch.Tensor) -> torch.Tensor:
    """Tight integer pixel boxes ``(y1, x1, y2, x2)``, exclusive of y2 and
    x2, of binary masks [..., H, W] -> [..., 4] int32; an empty mask gives a
    zero box."""
    masks = masks.to(torch.bool)
    h, w = masks.shape[-2], masks.shape[-1]
    row_any = masks.any(dim=-1)                       # [..., H]
    col_any = masks.any(dim=-2)                       # [..., W]
    ys = torch.arange(h, dtype=torch.int32, device=masks.device)
    xs = torch.arange(w, dtype=torch.int32, device=masks.device)
    big = torch.tensor(10 ** 8, dtype=torch.int32, device=masks.device)
    none = torch.tensor(-1, dtype=torch.int32, device=masks.device)
    y1 = torch.where(row_any, ys, big).amin(dim=-1)
    y2 = torch.where(row_any, ys, none).amax(dim=-1) + 1
    x1 = torch.where(col_any, xs, big).amin(dim=-1)
    x2 = torch.where(col_any, xs, none).amax(dim=-1) + 1
    box = torch.stack([y1, x1, y2, x2], dim=-1)
    empty = ~row_any.any(dim=-1)
    return torch.where(empty[..., None], torch.zeros_like(box), box).to(torch.int32)
