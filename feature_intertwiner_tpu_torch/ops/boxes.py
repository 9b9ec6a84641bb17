"""Box math on ``(y1, x1, y2, x2)`` tensors.

Port of ``feature_intertwiner_tpu/ops/boxes.py`` (``decode`` and ``clip``,
the two the inference path uses), in the same operation order so that the
two packages round alike.
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
