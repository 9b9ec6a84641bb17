"""Inference detection layer: refine, filter, per-class NMS, top-k.

Port of ``feature_intertwiner_tpu/ops/detection.py``:

- per-RoI argmax over all classes, background included, then filtered;
- class-specific delta times BBOX_STD_DEV, decode, scale to pixels, clip to
  the sample's un-padded window, round half to even to whole pixels;
- drop background, low-score and zero-area boxes;
- per-class NMS at DET_NMS_THRESHOLD (one class-offset NMS), top
  DET_MAX_INSTANCES by score;
- output [B, M, 6] = (y1, x1, y2, x2, class_id, score), zero-padded, plus
  the surviving RoI indices and their validity.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import boxes as box_ops
from .nms import class_aware_nms


def detection_layer(
    rois: torch.Tensor,
    probs: torch.Tensor,
    deltas: torch.Tensor,
    windows: torch.Tensor,
    bbox_std_dev,
    image_size: Tuple[int, int],
    max_instances: int = 100,
    nms_threshold: float = 0.3,
    min_confidence: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """rois [B, R, 4] normalised; probs [B, R, K]; deltas [B, R, K, 4];
    windows [B, 4] pixel (y1, x1, y2, x2) of each un-padded image; all
    float32 (a bfloat16 model casts its head outputs first, as the JAX
    package does).

    Returns (detections [B, M, 6], keep_idx [B, M] into R, keep_valid [B, M])."""
    if any(t.dtype != torch.float32 for t in (rois, probs, deltas, windows)):
        raise TypeError("detection_layer takes float32 boxes, scores, deltas and windows")
    h, w = image_size
    scale = rois.new_tensor([h, w, h, w])
    std = torch.as_tensor(bbox_std_dev, dtype=torch.float32, device=rois.device)

    class_ids = probs.argmax(dim=-1)                              # [B, R]
    class_scores = probs.amax(dim=-1)
    d_spec = torch.gather(
        deltas, 2, class_ids[..., None, None].expand(-1, -1, 1, 4))[:, :, 0]
    d_spec = d_spec * std
    refined = box_ops.decode(rois, d_spec) * scale
    refined = box_ops.clip(refined, windows.to(torch.float32)[:, None, :])
    refined = torch.round(refined)

    area = (refined[..., 0] - refined[..., 2]) * (refined[..., 1] - refined[..., 3])
    keep = (class_ids > 0) & (class_scores >= min_confidence) & (area > 0)

    keep_idx, keep_valid = class_aware_nms(
        refined, class_scores, class_ids, nms_threshold, max_instances,
        valid=keep)
    v = keep_valid.to(torch.float32)[..., None]
    det = torch.cat(
        [
            torch.gather(refined, 1, keep_idx[..., None].expand(-1, -1, 4)) * v,
            torch.gather(class_ids, 1, keep_idx)[..., None].to(torch.float32) * v,
            torch.gather(class_scores, 1, keep_idx)[..., None] * v,
        ],
        dim=-1,
    )
    return det, keep_idx, keep_valid
