"""Proposal layer: RPN outputs to the top-scoring proposals after NMS.

Port of ``feature_intertwiner_tpu/ops/proposals.py``: take the foreground
scores, keep the top ``pre_nms_limit`` anchors per sample, apply the deltas
times BBOX_STD_DEV, clip to the image, greedy NMS, keep ``proposal_count``,
normalise to [0, 1]. Short samples are zero-padded.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import boxes as box_ops
from .nms import batched_nms


def proposal_layer(
    rpn_probs: torch.Tensor,
    rpn_deltas: torch.Tensor,
    anchors: torch.Tensor,
    bbox_std_dev,
    image_size: Tuple[int, int],
    pre_nms_limit: int = 6000,
    proposal_count: int = 1000,
    nms_threshold: float = 0.7,
) -> torch.Tensor:
    """Normalised proposals [B, proposal_count, 4], zero-padded.

    rpn_probs [B, A, 2]; rpn_deltas [B, A, 4]; anchors [A, 4] in pixels;
    all float32 (a bfloat16 model casts its RPN outputs first, as the JAX
    package does)."""
    if any(t.dtype != torch.float32 for t in (rpn_probs, rpn_deltas, anchors)):
        raise TypeError("proposal_layer takes float32 scores, deltas and anchors")
    h, w = image_size
    scores = rpn_probs[:, :, 1]
    std = torch.as_tensor(bbox_std_dev, dtype=rpn_deltas.dtype, device=rpn_deltas.device)
    deltas = rpn_deltas * std

    # jax.lax.top_k breaks ties toward the lower index; a stable descending
    # sort does the same (torch.topk on CUDA does not promise it).
    k = min(pre_nms_limit, scores.shape[1])
    top_scores, order = torch.sort(scores, dim=1, descending=True, stable=True)
    top_scores, order = top_scores[:, :k], order[:, :k]
    top_deltas = torch.gather(deltas, 1, order[..., None].expand(-1, -1, 4))
    top_anchors = anchors[order]
    decoded = box_ops.decode(top_anchors, top_deltas)
    clipped = box_ops.clip(decoded, [0.0, 0.0, float(h), float(w)])

    keep_idx, keep_valid = batched_nms(clipped, top_scores, nms_threshold,
                                       proposal_count)
    kept = torch.gather(clipped, 1, keep_idx[..., None].expand(-1, -1, 4))
    kept = kept * keep_valid[..., None].to(clipped.dtype)
    return kept / clipped.new_tensor([h, w, h, w])
