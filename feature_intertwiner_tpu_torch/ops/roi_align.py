"""Multilevel FPN RoIAlign with TF ``crop_and_resize`` semantics.

Port of ``feature_intertwiner_tpu/ops/roi_align.py`` (``assign_fpn_level``,
``multilevel_crop_and_resize``) and of the Pallas window kernel that pools on
the JAX package's main path
(``ops/roi_align_window.py::_window_roi_kernel``). The pooling runs in the
CUDA kernel ``csrc/roi_align_fwd.cu`` for tensors on the card, and in
:func:`multilevel_gather_plain`, a torch copy of the JAX gather
``_multilevel_gather``, for tensors on the CPU.

Sampling, for a box ``(y1, x1, y2, x2)`` on a map of height ``H``:
``pos_y(i) = y1 (H-1) + i (y2-y1)(H-1)/(crop-1)`` (the centre
``(y1+y2)(H-1)/2`` when crop is 1), taps ``floor``/``ceil``, and
``extrapolation_value`` where the position lies outside ``[0, H-1]``; the
same along x. Both versions round as XLA compiles the JAX gather on the CPU
(a multiply by the reciprocal of ``crop-1``, fused multiply-adds for the
position and the lerps), so they agree with it, and with each other, to the
last bit or nearly.

Layouts are the JAX package's: maps NHWC ``[B, H, W, C]``, boxes ``[N, 4]``
normalised, crops ``[N, ch, cw, C]``.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from . import cuda_build


def assign_fpn_level(
    boxes: torch.Tensor,
    image_shape: Tuple[int, int],
    base: float = 224.0,
    k0: int = 4,
    lo: int = 2,
    hi: int = 5,
) -> torch.Tensor:
    """FPN equation-1 level of each normalised box, int32 in [lo, hi]:
    ``round(k0 + log2(sqrt(h w) / (base / sqrt(H W))))``, rounding half to
    even as the JAX package does."""
    h = boxes[..., 2] - boxes[..., 0]
    w = boxes[..., 3] - boxes[..., 1]
    image_area = boxes.new_tensor(float(image_shape[0]) * float(image_shape[1]))
    scale = torch.sqrt((h * w).clamp_min(1e-12)) / (base / torch.sqrt(image_area))
    lvl = k0 + torch.log2(scale)
    return torch.clamp(torch.round(lvl).to(torch.int32), lo, hi)


def _fma(a, b, c):
    """``a * b + c`` rounded once to float32, as a fused multiply-add: the
    float64 product of two float32 values is exact."""
    return (a.double() * b.double() + c.double()).float()


def reciprocal(crop: int) -> float:
    """float32 ``1 / (crop - 1)``: XLA divides by a constant as a multiply by
    its reciprocal, and the port does the same on every device."""
    return float(torch.tensor(1.0 / max(crop - 1, 1), dtype=torch.float32))


def _sample_positions(c0, c1, crop: int, dim: torch.Tensor) -> torch.Tensor:
    """[N] coordinates and [N] map extents -> [N, crop] sample positions,
    rounded as XLA compiles the JAX package's ``_sample_positions``."""
    dm1 = dim - 1.0
    if crop > 1:
        step = ((c1 - c0) * dm1) * reciprocal(crop)
        i = torch.arange(crop, dtype=torch.float32, device=c0.device)
        return _fma(i[None, :], step[:, None], (c0 * dm1)[:, None])
    return (0.5 * (c0 + c1) * dm1)[:, None]


def _corner_weights(pos: torch.Tensor, dim: torch.Tensor):
    """floor/ceil tap indices, lerp and validity of [N, crop] positions."""
    dm1 = (dim - 1.0)[:, None]
    valid = (pos >= 0.0) & (pos <= dm1)
    lo = torch.floor(pos)
    hi = torch.ceil(pos)
    lerp = pos - lo
    zero = torch.zeros_like(dm1)
    lo_i = torch.clamp(lo, zero, dm1).to(torch.int64)
    hi_i = torch.clamp(hi, zero, dm1).to(torch.int64)
    return lo_i, hi_i, lerp, valid


def tap_rows(
    features: Sequence[torch.Tensor],
    boxes: torch.Tensor,
    box_indices: torch.Tensor,
    level_idx: torch.Tensor,
    crop_size: Tuple[int, int],
):
    """Where each sample reads: rows of the flattened pyramid
    ``[B * sum(H_l W_l), C]`` (levels concatenated per image).

    Returns ``(tl, tr, bl, br)`` row indices, each [N, ch, cw] int64, the
    lerps ``ly`` [N, ch] and ``lx`` [N, cw], and ``valid`` [N, ch, cw]."""
    ch, cw = crop_size
    dev = boxes.device
    heights = torch.tensor([f.shape[1] for f in features], device=dev)
    widths = torch.tensor([f.shape[2] for f in features], device=dev)
    sizes = [f.shape[1] * f.shape[2] for f in features]
    offsets = torch.tensor([sum(sizes[:i]) for i in range(len(sizes))], device=dev)

    level_idx = level_idx.to(torch.int64)
    hs = heights[level_idx].to(torch.float32)
    ws = widths[level_idx].to(torch.float32)
    y1, x1, y2, x2 = boxes.unbind(dim=1)
    ty, by, ly, vy = _corner_weights(_sample_positions(y1, y2, ch, hs), hs)
    lx_i, rx_i, lx, vx = _corner_weights(_sample_positions(x1, x2, cw, ws), ws)

    base = box_indices.to(torch.int64) * sum(sizes) + offsets[level_idx]
    wi = widths[level_idx]

    def rows(yi, xi):
        return base[:, None, None] + yi[:, :, None] * wi[:, None, None] + xi[:, None, :]

    taps = (rows(ty, lx_i), rows(ty, rx_i), rows(by, lx_i), rows(by, rx_i))
    return taps, ly, lx, vy[:, :, None] & vx[:, None, :]


def multilevel_gather_plain(
    features: Sequence[torch.Tensor],
    boxes: torch.Tensor,
    box_indices: torch.Tensor,
    level_idx: torch.Tensor,
    crop_size: Tuple[int, int],
    extrapolation_value: float = 0.0,
) -> torch.Tensor:
    """Plain version of the RoIAlign kernel: the JAX ``_multilevel_gather``.

    All levels flattened into one ``[B, sum(H_l W_l), C]`` buffer; each box
    gathers its four taps through its level's offset."""
    b, _, _, c = features[0].shape
    ch, cw = crop_size
    flat = torch.cat([f.reshape(b, -1, c) for f in features], dim=1).reshape(-1, c)
    (tl, tr, bl, br), ly, lx, valid = tap_rows(
        features, boxes, box_indices, level_idx, crop_size)

    def gather(idx):
        return flat[idx.reshape(-1)].reshape(-1, ch, cw, c)

    tl, tr, bl, br = gather(tl), gather(tr), gather(bl), gather(br)
    lxb = lx[:, None, :, None]
    lyb = ly[:, :, None, None]
    # the three lerps as fused multiply-adds, as XLA and the kernel round them
    top = _fma(tr - tl, lxb, tl)
    bot = _fma(br - bl, lxb, bl)
    out = _fma(bot - top, lyb, top)
    return torch.where(~valid[..., None], out.new_tensor(extrapolation_value), out)


def roi_align_fwd(
    features: Sequence[torch.Tensor],
    boxes: torch.Tensor,
    box_indices: torch.Tensor,
    level_idx: torch.Tensor,
    crop_size: Tuple[int, int],
    extrapolation_value: float = 0.0,
) -> torch.Tensor:
    """Multilevel RoIAlign forward: [N, ch, cw, C] float32.

    features: 1 to 4 NHWC float32 maps with one batch and channel count;
    boxes [N, 4] float32 normalised; box_indices [N] and level_idx [N]
    integers (level 0-based into ``features``).

    Kernel wrapper: on CUDA tensors it launches ``csrc/roi_align_fwd.cu``
    (which replaces ``feature_intertwiner_tpu/ops/roi_align_window.py::
    _window_roi_kernel``); on CPU tensors it runs
    :func:`multilevel_gather_plain`. Each launch adds one to
    ``cuda_build.launches["roi_align_fwd"]``."""
    features = list(features)
    if not 1 <= len(features) <= 4:
        raise ValueError(f"1 to 4 pyramid levels, got {len(features)}")
    b, _, _, c = features[0].shape
    dev = boxes.device
    for f in features:
        if f.dim() != 4 or f.shape[0] != b or f.shape[3] != c:
            raise ValueError("levels must be [B, H, W, C] with one B and C")
        if f.dtype != torch.float32 or f.device != dev:
            raise TypeError("levels must be float32 on the boxes' device")
    if boxes.dim() != 2 or boxes.shape[1] != 4 or boxes.dtype != torch.float32:
        raise ValueError("boxes must be a [N, 4] float32 tensor")
    n = boxes.shape[0]
    if box_indices.shape != (n,) or level_idx.shape != (n,):
        raise ValueError("box_indices and level_idx must be [N]")
    if box_indices.device != dev or level_idx.device != dev:
        raise ValueError("box_indices and level_idx must be on the boxes' device")
    ch, cw = (int(s) for s in crop_size)
    if dev.type == "cpu":
        return multilevel_gather_plain(features, boxes, box_indices, level_idx,
                                       (ch, cw), extrapolation_value)
    if dev.type != "cuda":
        raise ValueError(f"roi_align_fwd runs on cuda or cpu, not {dev}")
    if not all(f.is_contiguous() for f in features):
        raise ValueError("roi_align_fwd needs contiguous NHWC levels "
                         "(channels_last maps permuted to NHWC are)")

    boxes = boxes.contiguous()
    bidx = box_indices.to(torch.int32).contiguous()
    lidx = level_idx.to(torch.int32).contiguous()
    out = torch.empty((n, ch, cw, c), dtype=torch.float32, device=dev)
    lib = cuda_build.load("roi_align_fwd")
    fn = lib.roi_align_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
                   ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_float, ctypes.c_float, ctypes.c_float,
                   ctypes.c_void_p, ctypes.c_void_p]
    num = len(features)
    ptrs = (ctypes.c_void_p * num)(*[f.data_ptr() for f in features])
    hs = (ctypes.c_int * num)(*[f.shape[1] for f in features])
    ws = (ctypes.c_int * num)(*[f.shape[2] for f in features])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(ptrs, hs, ws, num, b, c, boxes.data_ptr(), bidx.data_ptr(),
                 lidx.data_ptr(), n, ch, cw, reciprocal(ch), reciprocal(cw),
                 float(extrapolation_value), out.data_ptr(), stream)
    cuda_build.check(err, "roi_align_fwd")
    if n > 0:  # the C entry launches nothing for no boxes
        cuda_build.launches["roi_align_fwd"] += 1
    return out


def multilevel_crop_and_resize(
    features: Sequence[torch.Tensor],
    boxes: torch.Tensor,
    box_indices: torch.Tensor,
    crop_size: Tuple[int, int],
    image_shape: Tuple[int, int],
    assign_base: float = 224.0,
    level_idx: torch.Tensor = None,
    extrapolation_value: float = 0.0,
) -> torch.Tensor:
    """FPN RoIAlign: boxes [N, 4] normalised, features = [P2..P5] NHWC.

    ``level_idx`` (0-based into ``features``) may be given; otherwise the
    FPN equation-1 assignment is used. Returns [N, ch, cw, C]."""
    if level_idx is None:
        level_idx = assign_fpn_level(boxes, image_shape, base=assign_base) - 2
    return roi_align_fwd(features, boxes, box_indices, level_idx, crop_size,
                         extrapolation_value)
