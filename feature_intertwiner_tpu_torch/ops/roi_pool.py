"""RoIPool, the quantised max pooling of ``ROIS.METHOD roi_pool``.

Port of ``feature_intertwiner_tpu/ops/roi_pool.py`` (the reference's CUDA
RoIPool semantics), bit for bit:

- RoIs are ``(batch_idx, x1, y1, x2, y2)`` in pixels; ``coord *
  spatial_scale`` is rounded to a cell as C's ``round`` does, ``floor(x +
  0.5)``, with the multiply and the add fused as the jitted JAX function
  computes them, and converted to int32 as XLA converts (NaN to 0, out of
  range saturated);
- a malformed RoI is forced to 1x1 (``max(end - start + 1, 1)``);
- bin ``p`` covers ``[floor(p roi / P), ceil((p + 1) roi / P)) + start``,
  clipped to the map, in exact integer arithmetic;
- the max runs over a ``window_cap`` x ``window_cap`` grid of samples spread
  evenly over the bin (``start + k (span - 1) // (cap - 1)``): every cell of
  a bin no wider than the cap (some sampled more than once), an evenly
  strided subset of a wider one; samples outside the bin are masked, and an
  empty bin gives 0.

The gradient is autograd's: ``torch.amax`` over the two window axes splits a
bin's gradient evenly among its tied samples, repeated samples included, as
JAX's ``reduce_max`` rule does, and the backward of the gather
(``index_select``: ``index_add_``, on the CPU in the samples' order, as
XLA's scatter adds them) sums the shares of a cell. (``max(dim)`` would
send it all to one sample.)

There is no Pallas kernel behind the JAX function, so this is plain PyTorch
on every device. It gathers the whole ``[N, P, cap, P, cap, C]`` sample
block at once.
"""

from __future__ import annotations

from typing import Tuple

import torch

NEG = -3.4e38
_INT32 = (-2.0 ** 31, 2.0 ** 31)


def c_round(coord: torch.Tensor, scale: float) -> torch.Tensor:
    """int32 ``floor(coord * scale + 0.5)``: the product and the add rounded
    once to float32 (a fused multiply-add; the float64 product of two
    float32 values is exact), converted as XLA converts float32 to int32."""
    scale = float(torch.tensor(scale, dtype=torch.float32))
    y = torch.floor((coord.double() * scale + 0.5).float())
    y = torch.nan_to_num(y, nan=0.0).clamp(*_INT32).to(torch.int64)
    return y.clamp(-2 ** 31, 2 ** 31 - 1).to(torch.int32)


def _offsets(start: torch.Tensor, end: torch.Tensor, cap: int):
    """[N, P] bin starts and ends -> ([N, P, cap] sample cells, validity)."""
    k = torch.arange(cap, dtype=torch.int32, device=start.device)
    span = (end - start)[:, :, None]
    if cap > 1:
        off = torch.div(k * (span - 1).clamp_min(0), cap - 1, rounding_mode="floor")
    else:
        off = torch.zeros_like(span) * k
    pos = start[:, :, None] + off
    return pos, pos < end[:, :, None]


def roi_pool(features: torch.Tensor, rois: torch.Tensor, spatial_scale: float,
             pooled_size: Tuple[int, int], window_cap: int = 8) -> torch.Tensor:
    """Max RoIPool: features [B, H, W, C] (NHWC), rois [N, 5] ``(batch_idx,
    x1, y1, x2, y2)`` in pixels, ``spatial_scale`` map cells per pixel ->
    [N, ph, pw, C] in the features' dtype (empty bins 0)."""
    b, h, w, c = features.shape
    n = rois.shape[0]
    ph, pw = (int(v) for v in pooled_size)
    device = features.device
    batch_idx = rois[:, 0].to(torch.int32)
    start_w = c_round(rois[:, 1], spatial_scale)
    start_h = c_round(rois[:, 2], spatial_scale)
    end_w = c_round(rois[:, 3], spatial_scale)
    end_h = c_round(rois[:, 4], spatial_scale)
    roi_w = (end_w - start_w + 1).clamp_min(1)
    roi_h = (end_h - start_h + 1).clamp_min(1)

    p_h = torch.arange(ph, dtype=torch.int32, device=device)[None, :]
    p_w = torch.arange(pw, dtype=torch.int32, device=device)[None, :]
    floor = dict(rounding_mode="floor")
    hstart = torch.div(p_h * roi_h[:, None], ph, **floor)
    hend = torch.div((p_h + 1) * roi_h[:, None] + ph - 1, ph, **floor)
    wstart = torch.div(p_w * roi_w[:, None], pw, **floor)
    wend = torch.div((p_w + 1) * roi_w[:, None] + pw - 1, pw, **floor)
    hstart = (hstart + start_h[:, None]).clamp(0, h)
    hend = (hend + start_h[:, None]).clamp(0, h)
    wstart = (wstart + start_w[:, None]).clamp(0, w)
    wend = (wend + start_w[:, None]).clamp(0, w)

    ys, ys_valid = _offsets(hstart, hend, window_cap)
    xs, xs_valid = _offsets(wstart, wend, window_cap)
    ys, xs = ys.clamp(0, h - 1), xs.clamp(0, w - 1)
    base = batch_idx.to(torch.int64) * (h * w)
    idx = (base[:, None, None, None, None] + ys[:, :, :, None, None].to(torch.int64) * w
           + xs[:, None, None, :, :])
    samples = torch.index_select(features.reshape(b * h * w, c), 0, idx.reshape(-1))
    samples = samples.reshape(n, ph, window_cap, pw, window_cap, c)
    mask = (ys_valid[:, :, :, None, None] & xs_valid[:, None, None, :, :])[..., None]
    samples = torch.where(mask, samples, torch.tensor(NEG, dtype=samples.dtype, device=device))
    pooled = torch.amax(samples, dim=(2, 4))
    empty = (hend <= hstart)[:, :, None, None] | (wend <= wstart)[:, None, :, None]
    return torch.where(empty, torch.zeros((), dtype=pooled.dtype, device=device), pooled)


def make_roi_pool_input(boxes: torch.Tensor, box_indices: torch.Tensor,
                        image_size: float) -> torch.Tensor:
    """Normalised (y1, x1, y2, x2) boxes -> RoIPool's pixel ``(idx, x1, y1,
    x2, y2)``, both axes scaled by the image height as the reference does
    (it assumes square inputs)."""
    p = boxes * float(image_size)
    return torch.stack([box_indices.to(boxes.dtype), p[:, 1], p[:, 0], p[:, 3], p[:, 2]],
                       dim=1)
