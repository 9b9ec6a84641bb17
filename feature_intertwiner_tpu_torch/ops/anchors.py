"""FPN anchors, computed once at model build on the host.

A numpy copy of ``feature_intertwiner_tpu/ops/anchors.py``: per pyramid level
one scale and all ratios; centres at ``(cell_y * stride, cell_x * stride)``;
heights ``scale / sqrt(ratio)``, widths ``scale * sqrt(ratio)``. Order: levels
in scale order, cells row-major over (y, x), ratio fastest. At 1024² that is
261,888 anchors, bit-equal to the JAX package's.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def generate_level_anchors(
    scale: float,
    ratios: Sequence[float],
    feature_shape: Sequence[int],
    feature_stride: int,
    anchor_stride: int = 1,
) -> np.ndarray:
    """Anchors for one pyramid level: [H*W*A, 4] float32 (y1, x1, y2, x2)."""
    ratios = np.asarray(ratios, dtype=np.float64)
    heights = scale / np.sqrt(ratios)
    widths = scale * np.sqrt(ratios)

    shifts_y = np.arange(0, feature_shape[0], anchor_stride, dtype=np.float64) * feature_stride
    shifts_x = np.arange(0, feature_shape[1], anchor_stride, dtype=np.float64) * feature_stride

    ctr = np.stack(np.meshgrid(shifts_x, shifts_y)[::-1], axis=-1)[:, :, None, :]
    size = np.stack([heights, widths], axis=-1)[None, None, :, :]

    boxes = np.concatenate([ctr - 0.5 * size, ctr + 0.5 * size], axis=-1)
    return boxes.reshape(-1, 4).astype(np.float32)


def generate_pyramid_anchors(
    scales: Sequence[float],
    ratios: Sequence[float],
    feature_shapes: Sequence[Sequence[int]],
    feature_strides: Sequence[int],
    anchor_stride: int = 1,
) -> np.ndarray:
    """All-level anchors concatenated in scale order: [N, 4] float32."""
    return np.concatenate(
        [
            generate_level_anchors(scales[i], ratios, feature_shapes[i],
                                   feature_strides[i], anchor_stride)
            for i in range(len(scales))
        ],
        axis=0,
    )
