"""Multilevel FPN RoIAlign with TF ``crop_and_resize`` semantics, and its
gradient.

Port of ``feature_intertwiner_tpu/ops/roi_align.py`` (``assign_fpn_level``,
``multilevel_crop_and_resize``, ``crop_and_resize``,
``crop_and_resize_separable``) and of the two Pallas kernels of the JAX
package's main path: the window forward
(``ops/roi_align_window.py::_window_roi_kernel``) and its backward
(``ops/roi_align_window_bwd.py::_bwd_kernel``, reached from the custom VJP
``_hybrid_bwd``).

:class:`RoIAlign` is the ``torch.autograd.Function`` of the pooling: its
forward is :func:`roi_align_fwd` (the CUDA kernel ``csrc/roi_align_fwd.cu``
on the card, :func:`multilevel_gather_plain`, a torch copy of the JAX gather
``_multilevel_gather``, on the CPU) and its backward :func:`roi_align_bwd`
(``csrc/roi_align_bwd.cu`` on the card, the scatter
:func:`multilevel_gather_bwd_plain` on the CPU). Like ``_hybrid_bwd`` it
gives no gradient to the boxes or indices.

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

The single-level crops of boxes grouped per image (``[B, NB, 4]`` boxes,
``[B, NB, ch, cw, C]`` crops) port the other two Pallas kernels of
``ops/roi_align.py``: :func:`crop_and_resize_grouped` (K4,
``_roi_align_kernel``, any ``extrapolation_value``) and
:func:`crop_and_resize_grouped_mm` (K5, ``_roi_align_matmul_kernel``), both
``csrc/crop_and_resize.cu`` on the card; and :func:`crop_and_resize_fused`,
the JAX custom VJP of the same name (K4 forward, K3 backward). They sample
as those kernels do, with a true division and no fused multiply-add, or
with ``positions="xla"`` as the jitted JAX ``crop_and_resize`` does (the
Dev big-set crop); K3 then places its samples the same way (its ``xla``
mode, :func:`_sample_positions`).

Maps may be float32 or bfloat16 (:data:`POOL_DTYPES`). A bfloat16 map is
widened to float32 once per call (exact), the float32 kernel or plain
version runs, and the crops are rounded once to bfloat16, as the JAX window
kernel adds in float32 and writes the maps' dtype; a bfloat16 cotangent is
widened likewise and each level's gradient rounded once to bfloat16, as the
JAX custom VJP casts its float32 gradients to the levels' dtype.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from . import cuda_build

# The map dtypes the RoIAlign kernels take; a bfloat16 map runs the float32
# kernel on a widened copy.
POOL_DTYPES = (torch.float32, torch.bfloat16)


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


@functools.lru_cache(maxsize=None)
def reciprocal(crop: int) -> float:
    """float32 ``1 / (crop - 1)``: XLA divides by a constant as a multiply by
    its reciprocal, and the port does the same on every device."""
    return float(torch.tensor(1.0 / max(crop - 1, 1), dtype=torch.float32))


def _sample_positions(c0, c1, crop: int, dim: torch.Tensor, xla: bool = False) -> torch.Tensor:
    """[N] coordinates and [N] map extents -> [N, crop] sample positions,
    rounded as XLA compiles the JAX package's ``_sample_positions`` in the
    multilevel gather (K1, K3): ``step = ((c1 - c0)(dim-1)) · (1 /
    (crop-1))``; with ``xla`` (K3 only: the gradient of the Dev big-set
    crop, whose forward is K4's ``positions="xla"``) as it compiles the
    jitted single-level crop, the two constants folded first, ``step = (c1 -
    c0) · ((dim-1) · (1 / (crop-1)))`` (:func:`xla_ratio`,
    :func:`_single_level_positions`); then ``i · step + c0 (dim-1)`` as one
    fused multiply-add."""
    dm1 = dim - 1.0
    if crop > 1:
        if xla:
            step = (c1 - c0) * (dm1 * reciprocal(crop))
        else:
            step = ((c1 - c0) * dm1) * reciprocal(crop)
        i = torch.arange(crop, dtype=torch.float32, device=c0.device)
        return _fma(i[None, :], step[:, None], (c0 * dm1)[:, None])
    return (0.5 * (c0 + c1) * dm1)[:, None]


def _corner_weights(pos: torch.Tensor, dim: torch.Tensor):
    """floor/ceil tap indices, lerp and validity of [N, crop] positions. A
    NaN position (a NaN box) is invalid, taps cell 0 (as the kernels'
    ``fmaxf`` clamp makes it) with a zero lerp, and adds nothing."""
    dm1 = (dim - 1.0)[:, None]
    valid = (pos >= 0.0) & (pos <= dm1)
    lo = torch.floor(pos)
    hi = torch.ceil(pos)
    lerp = torch.nan_to_num(pos - lo, nan=0.0)
    zero = torch.zeros_like(dm1)
    lo_i = torch.clamp(torch.nan_to_num(lo, nan=0.0), zero, dm1).to(torch.int64)
    hi_i = torch.clamp(torch.nan_to_num(hi, nan=0.0), zero, dm1).to(torch.int64)
    return lo_i, hi_i, lerp, valid


def tap_rows(
    shapes: Sequence[Sequence[int]],
    boxes: torch.Tensor,
    box_indices: torch.Tensor,
    level_idx: torch.Tensor,
    crop_size: Tuple[int, int],
    xla: bool = False,
):
    """Where each sample reads: rows of the flattened pyramid
    ``[B * sum(H_l W_l), C]`` (levels concatenated per image), for levels of
    the NHWC ``shapes``, at the sample positions :func:`_sample_positions`
    rounds (with ``xla`` as the jitted single-level crop does).

    Returns ``(tl, tr, bl, br)`` row indices, each [N, ch, cw] int64, the
    lerps ``ly`` [N, ch] and ``lx`` [N, cw], and ``valid`` [N, ch, cw]."""
    ch, cw = crop_size
    dev = boxes.device
    heights = torch.tensor([s[1] for s in shapes], device=dev)
    widths = torch.tensor([s[2] for s in shapes], device=dev)
    sizes = [s[1] * s[2] for s in shapes]
    offsets = torch.tensor([sum(sizes[:i]) for i in range(len(sizes))], device=dev)

    level_idx = level_idx.to(torch.int64)
    hs = heights[level_idx].to(torch.float32)
    ws = widths[level_idx].to(torch.float32)
    y1, x1, y2, x2 = boxes.unbind(dim=1)
    ty, by, ly, vy = _corner_weights(_sample_positions(y1, y2, ch, hs, xla), hs)
    lx_i, rx_i, lx, vx = _corner_weights(_sample_positions(x1, x2, cw, ws, xla), ws)

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
    gathers its four taps through its level's offset. bfloat16 levels are
    widened to float32 and the crops rounded once to bfloat16."""
    dtype = features[0].dtype
    if dtype == torch.bfloat16:
        return multilevel_gather_plain([f.float() for f in features], boxes, box_indices,
                                       level_idx, crop_size, extrapolation_value).to(dtype)
    b, _, _, c = features[0].shape
    ch, cw = crop_size
    flat = torch.cat([f.reshape(b, -1, c) for f in features], dim=1).reshape(-1, c)
    (tl, tr, bl, br), ly, lx, valid = tap_rows(
        [f.shape for f in features], boxes, box_indices, level_idx, crop_size)

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


def _check_pooling_args(shapes, boxes, box_indices, level_idx):
    """The arguments both RoIAlign wrappers share: 1 to 4 NHWC level shapes
    with one batch and channel count, [N, 4] float32 boxes, [N] indices on
    the boxes' device."""
    if not 1 <= len(shapes) <= 4:
        raise ValueError(f"1 to 4 pyramid levels, got {len(shapes)}")
    b, c = shapes[0][0], shapes[0][-1]
    if any(len(s) != 4 or s[0] != b or s[3] != c for s in shapes):
        raise ValueError("levels must be [B, H, W, C] with one B and C")
    if boxes.dim() != 2 or boxes.shape[1] != 4 or boxes.dtype != torch.float32:
        raise ValueError("boxes must be a [N, 4] float32 tensor")
    n = boxes.shape[0]
    if box_indices.shape != (n,) or level_idx.shape != (n,):
        raise ValueError("box_indices and level_idx must be [N]")
    if box_indices.device != boxes.device or level_idx.device != boxes.device:
        raise ValueError("box_indices and level_idx must be on the boxes' device")


def roi_align_fwd(
    features: Sequence[torch.Tensor],
    boxes: torch.Tensor,
    box_indices: torch.Tensor,
    level_idx: torch.Tensor,
    crop_size: Tuple[int, int],
    extrapolation_value: float = 0.0,
) -> torch.Tensor:
    """Multilevel RoIAlign forward: [N, ch, cw, C] in the levels' dtype.

    features: 1 to 4 NHWC float32 or bfloat16 maps with one batch, channel
    count and dtype (bfloat16 levels are widened to float32 once per call,
    and the crops rounded once to bfloat16);
    boxes [N, 4] float32 normalised; box_indices [N] and level_idx [N]
    integers (level 0-based into ``features``).

    Kernel wrapper: on CUDA tensors it launches ``csrc/roi_align_fwd.cu``
    (which replaces ``feature_intertwiner_tpu/ops/roi_align_window.py::
    _window_roi_kernel``) on the blocks of :func:`fwd_plan`, reading
    :func:`fwd_vector_width` floats at a time; on CPU tensors it runs
    :func:`multilevel_gather_plain`. Each launch adds one to
    ``cuda_build.launches["roi_align_fwd"]``."""
    features = list(features)
    _check_pooling_args([tuple(f.shape) for f in features], boxes, box_indices, level_idx)
    b, _, _, c = features[0].shape
    n, dev = boxes.shape[0], boxes.device
    dtype = features[0].dtype
    if dtype not in POOL_DTYPES or any(f.dtype != dtype or f.device != dev for f in features):
        raise TypeError("levels must be float32 or bfloat16, of one dtype, on the boxes' device")
    if dtype != torch.float32:
        features = [f.float() for f in features]        # exact, once per call
    ch, cw = (int(s) for s in crop_size)
    if dev.type == "cpu":
        return multilevel_gather_plain(features, boxes, box_indices, level_idx,
                                       (ch, cw), extrapolation_value).to(dtype)
    if dev.type != "cuda":
        raise ValueError(f"roi_align_fwd runs on cuda or cpu, not {dev}")
    if not all(f.is_contiguous() for f in features):
        raise ValueError("roi_align_fwd needs contiguous NHWC levels "
                         "(channels_last maps permuted to NHWC are)")

    boxes = boxes.contiguous()
    bidx = box_indices.to(torch.int32).contiguous()
    lidx = level_idx.to(torch.int32).contiguous()
    out = torch.empty((n, ch, cw, c), dtype=torch.float32, device=dev)
    vec = fwd_vector_width(features, out)
    rows, _, _ = fwd_plan(n, (ch, cw), c, vec)
    num = len(features)
    ptrs = (ctypes.c_void_p * num)(*[f.data_ptr() for f in features])
    hs = (ctypes.c_int * num)(*[f.shape[1] for f in features])
    ws = (ctypes.c_int * num)(*[f.shape[2] for f in features])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _fwd_library().roi_align_fwd(
            ptrs, hs, ws, num, b, c, vec, boxes.data_ptr(), bidx.data_ptr(), lidx.data_ptr(),
            n, ch, cw, rows, reciprocal(ch), reciprocal(cw), float(extrapolation_value),
            out.data_ptr(), stream)
    cuda_build.check(err, "roi_align_fwd")
    if n > 0:  # the C entry launches nothing for no boxes
        cuda_build.launches["roi_align_fwd"] += 1
    return out.to(dtype)


@functools.lru_cache(maxsize=None)
def _fwd_library() -> ctypes.CDLL:
    """``csrc/roi_align_fwd.cu``'s library with its entry point typed."""
    lib = cuda_build.load("roi_align_fwd")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ints = ctypes.POINTER(ctypes.c_int)
    lib.roi_align_fwd.restype = i32
    lib.roi_align_fwd.argtypes = ([ctypes.POINTER(ctypes.c_void_p), ints, ints] + [i32] * 4
                                  + [ptr] * 3 + [i32] * 4 + [f32] * 3 + [ptr] * 2)
    return lib


# The forward kernels' plan: output vectors a block aims at; and the
# constants of csrc/roi_align_fwd.cu (K1) and csrc/crop_and_resize.cu (K4,
# K5), which stage their taps alike: threads per block (kThreads), the bytes
# of one row's staged y taps and of one column's x taps, and the most shared
# memory for them (kSharedLimit).
FWD_VECTORS = 4096
FWD_THREADS = 256
FWD_ROW_BYTES = 32
FWD_COL_BYTES = 16
FWD_SHARED_BYTES = 48 * 1024


def fwd_vector_width(features: Sequence[torch.Tensor], out: torch.Tensor) -> int:
    """Floats the forward kernel reads and writes at a time: 4 when the
    channel count is a multiple of 4 and every level and the crops start on
    16-byte boundaries (every map row and crop row then does), else 1."""
    aligned = all(t.data_ptr() % 16 == 0 for t in (*features, out))
    return 4 if out.shape[-1] % 4 == 0 and aligned else 1


def fwd_shared_bytes(rows: int, crop_size: Tuple[int, int]) -> int:
    """Shared memory of a forward block of ``rows`` consecutive sample rows:
    their y taps, and the x taps of the most boxes such rows can touch."""
    ch, cw = crop_size
    boxes = (rows + ch - 2) // ch + 1
    return rows * FWD_ROW_BYTES + boxes * cw * FWD_COL_BYTES


@functools.lru_cache(maxsize=None)
def _fwd_rows(crop_size: Tuple[int, int], vectors_per_row: int) -> int:
    rows = max(1, FWD_VECTORS // vectors_per_row)
    while rows > 1 and fwd_shared_bytes(rows, crop_size) > FWD_SHARED_BYTES:
        rows -= 1
    if fwd_shared_bytes(rows, crop_size) > FWD_SHARED_BYTES:
        raise ValueError(f"fwd_plan: a {crop_size[1]}-wide crop's taps do not fit "
                         f"{FWD_SHARED_BYTES} bytes of shared memory")
    return rows


def fwd_plan(n: int, crop_size: Tuple[int, int], channels: int, vec: int) -> Tuple[int, int, int]:
    """How the forward kernels (K1; K4 and K5 with ``n = B * NB``) split
    ``n`` boxes' crops: ``(rows per block, blocks, shared bytes per block)``.
    The crops are ``n * crop_h`` sample rows of ``crop_w * channels / vec``
    output vectors; a block takes about ``FWD_VECTORS`` vectors of
    consecutive rows (at least one row), as many as its staged taps leave
    room for."""
    ch, cw = (int(v) for v in crop_size)
    rows = _fwd_rows((ch, cw), cw * (channels // vec))
    return rows, -(-n * ch // rows), fwd_shared_bytes(rows, (ch, cw))


def multilevel_gather_bwd_plain(
    g: torch.Tensor,
    shapes: Sequence[Sequence[int]],
    boxes: torch.Tensor,
    box_indices: torch.Tensor,
    level_idx: torch.Tensor,
    crop_size: Tuple[int, int],
    xla: bool = False,
) -> List[torch.Tensor]:
    """Plain version of the RoIAlign backward kernel: the transpose of
    :func:`multilevel_gather_plain`, an ``index_add_`` of the four weighted
    taps of every valid sample into the flattened pyramid; the samples
    placed as :func:`_sample_positions` says with ``xla``.

    The weights are those XLA's transpose of the lerps gives:
    ``a = g ly``, ``top = g - a``, ``bot = a``; ``tl += top - top lx``,
    ``tr += top lx``, ``bl += bot - bot lx``, ``br += bot lx``. Returns one
    gradient ``[B, H_l, W_l, C]`` per level of ``shapes``, float32; float64
    for a float64 ``g`` (then every product and sum is taken in float64: the
    exact sum to compare a kernel's rounding with); for a bfloat16 ``g``,
    the float32 sums rounded once to bfloat16."""
    b, c = shapes[0][0], shapes[0][3]
    (tl, tr, bl, br), ly, lx, valid = tap_rows(
        shapes, boxes, box_indices, level_idx, crop_size, xla)
    dtype = torch.float64 if g.dtype == torch.float64 else torch.float32
    out = torch.bfloat16 if g.dtype == torch.bfloat16 else dtype
    g = torch.where(valid[..., None], g.to(dtype), g.new_zeros((), dtype=dtype))
    a = g * ly[:, :, None, None].to(dtype)
    top = g - a
    lxb = lx[:, None, :, None].to(dtype)
    sizes = [s[1] * s[2] for s in shapes]
    flat = torch.zeros((b * sum(sizes), c), dtype=dtype, device=g.device)
    for rows, vals in ((tl, top - top * lxb), (tr, top * lxb),
                       (bl, a - a * lxb), (br, a * lxb)):
        flat.index_add_(0, rows.reshape(-1), vals.reshape(-1, c))
    per_level = flat.reshape(b, sum(sizes), c).split(sizes, dim=1)
    return [d.reshape(b, s[1], s[2], c).to(out).contiguous()
            for d, s in zip(per_level, shapes)]


def roi_align_bwd(
    g: torch.Tensor,
    shapes: Sequence[Sequence[int]],
    boxes: torch.Tensor,
    box_indices: torch.Tensor,
    level_idx: torch.Tensor,
    crop_size: Tuple[int, int],
    xla: bool = False,
) -> List[torch.Tensor]:
    """Multilevel RoIAlign backward: the gradient of :func:`roi_align_fwd`
    with respect to each level, ``[B, H_l, W_l, C]`` in g's dtype; with
    ``xla`` the gradient of the single-level crops of K4's
    ``positions="xla"`` instead, every sample placed as the jitted JAX
    ``crop_and_resize`` places it (:func:`_sample_positions`).

    g: the crops' cotangent [N, ch, cw, C], float32 or bfloat16 (widened to
    float32, each level's gradient rounded once to bfloat16); shapes: the NHWC shapes
    of the 1 to 4 levels; boxes, box_indices, level_idx as the forward got
    them.

    Kernel wrapper: on CUDA tensors it launches ``csrc/roi_align_bwd.cu``
    (which replaces ``feature_intertwiner_tpu/ops/roi_align_window_bwd.py::
    _bwd_kernel``); on CPU tensors it runs
    :func:`multilevel_gather_bwd_plain`. See :func:`roi_align_bwd_with_plan`."""
    return roi_align_bwd_with_plan(g, shapes, boxes, box_indices, level_idx, crop_size,
                                   xla)[0]


def roi_align_bwd_with_plan(
    g: torch.Tensor,
    shapes: Sequence[Sequence[int]],
    boxes: torch.Tensor,
    box_indices: torch.Tensor,
    level_idx: torch.Tensor,
    crop_size: Tuple[int, int],
    xla: bool = False,
) -> Tuple[List[torch.Tensor], Optional[Dict[str, int]]]:
    """:func:`roi_align_bwd`'s gradients and, on CUDA tensors, the totals of
    the work plan the kernel made (those of :func:`bwd_work_plan` but
    ``tiles``); None on CPU tensors, where the plain version runs. Each
    launch adds one to ``cuda_build.launches["roi_align_bwd"]``, and one in
    the ``xla`` mode also to ``cuda_build.launches["roi_align_bwd_xla"]``.

    The kernel plans on the card how it splits each map tile's boxes across
    blocks, then reads the plan's five totals back to the host to size its
    grid and its scratch: one device-to-host read per call, which waits for
    the work queued before it. A map too wide for one launch's shared-memory
    tile takes one launch per channel chunk of :func:`bwd_channel_chunks`,
    all on the one plan (it depends on the boxes only); each chunk writes
    contiguous temporaries that are copied into its slice of the
    gradients. Every channel is summed in the same order whatever its
    chunk, so the result is bit-equal to the chunks' calls one by one."""
    shapes = [tuple(int(d) for d in s) for s in shapes]
    _check_pooling_args(shapes, boxes, box_indices, level_idx)
    b, c = shapes[0][0], shapes[0][3]
    ch, cw = (int(v) for v in crop_size)
    n = boxes.shape[0]
    dev = boxes.device
    if g.shape != (n, ch, cw, c) or g.dtype not in POOL_DTYPES or g.device != dev:
        raise ValueError(f"g must be float32 or bfloat16 [{n}, {ch}, {cw}, {c}] "
                         "on the boxes' device")
    dtype = g.dtype
    g = g.float()                                       # exact, once per call
    if dev.type == "cpu":
        return [d.to(dtype) for d in multilevel_gather_bwd_plain(
            g, shapes, boxes, box_indices, level_idx, (ch, cw), xla)], None
    if dev.type != "cuda":
        raise ValueError(f"roi_align_bwd runs on cuda or cpu, not {dev}")
    if not g.is_contiguous():
        raise ValueError("roi_align_bwd needs a contiguous cotangent")

    boxes = boxes.contiguous()
    bidx = box_indices.to(torch.int32).contiguous()
    lidx = level_idx.to(torch.int32).contiguous()
    outs = [torch.empty(s, dtype=torch.float32, device=dev) for s in shapes]
    lib = _bwd_library()
    num = len(shapes)
    hs = (ctypes.c_int * num)(*[s[1] for s in shapes])
    ws = (ctypes.c_int * num)(*[s[2] for s in shapes])
    size = lib.roi_align_bwd_scratch_ints(hs, ws, num, b, n, ch, cw)
    if size < 0:
        raise ValueError(f"roi_align_bwd: level shapes {shapes} out of the kernel's range")
    scratch = torch.empty(size, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.roi_align_bwd_plan(hs, ws, num, b, boxes.data_ptr(), bidx.data_ptr(),
                                     lidx.data_ptr(), n, ch, cw, reciprocal(ch),
                                     reciprocal(cw), int(xla),
                                     scratch.data_ptr(), stream)
        cuda_build.check(err, "roi_align_bwd_plan")
        items, partials, multi_tiles, max_chunks, pairs = scratch[-5:].tolist()
        work = torch.empty(items + pairs, dtype=torch.int32, device=dev)
        chunks = bwd_channel_chunks(c, (ch, cw))
        widest = max(c1 - c0 for c0, c1 in chunks)
        part = torch.empty(max(lib.roi_align_bwd_partial_floats(partials, widest), 1),
                           dtype=torch.float32, device=dev)
        for c0, c1 in chunks:
            if len(chunks) == 1:
                g_part, dst = g, outs
            else:
                g_part = g[..., c0:c1].contiguous()
                dst = [torch.empty((*s[:3], c1 - c0), dtype=torch.float32, device=dev)
                       for s in shapes]
            dst_ptrs = (ctypes.c_void_p * num)(*[o.data_ptr() for o in dst])
            err = lib.roi_align_bwd(dst_ptrs, hs, ws, num, b, c1 - c0, g_part.data_ptr(), n,
                                    ch, cw, scratch.data_ptr(), items, multi_tiles, pairs,
                                    work.data_ptr(), part.data_ptr(), stream)
            cuda_build.check(err, "roi_align_bwd")
            cuda_build.launches["roi_align_bwd"] += 1
            if xla:
                cuda_build.launches["roi_align_bwd_xla"] += 1
            if dst is not outs:
                for o, d in zip(outs, dst):
                    o[..., c0:c1].copy_(d)
    plan = dict(items=items, partials=partials, multi_tiles=multi_tiles,
                max_chunks=max_chunks, pairs=pairs)
    return [o.to(dtype) for o in outs], plan


# csrc/roi_align_bwd.cu's constants: a tile that more than BWD_SPLIT_ABOVE
# boxes meet is split into work items of BWD_CHUNK_BOXES boxes (kSplitAbove,
# kChunk); map columns per tile (kTileW); the accumulate pass's shared
# memory, its tile and the staged taps, at most BWD_SHARED_BYTES.
BWD_CHUNK_BOXES = 2
BWD_SPLIT_ABOVE = 16
BWD_TILE_W = 32
BWD_SHARED_BYTES = 200 * 1024


def bwd_shared_bytes(channels: int, crop_size: Tuple[int, int]) -> int:
    """The backward kernel's accumulate pass's shared memory for one
    launch: a tile of ``BWD_TILE_W`` columns of float32 channels, and the
    (int2) taps of up to ``BWD_SPLIT_ABOVE`` boxes."""
    ch, cw = crop_size
    return BWD_TILE_W * channels * 4 + BWD_SPLIT_ABOVE * (ch + cw) * 8


def bwd_channel_chunks(channels: int, crop_size: Tuple[int, int]) -> List[Tuple[int, int]]:
    """``[start, stop)`` channel ranges, in order, covering ``[0, channels)``,
    each of which fits one launch of the backward kernel: as few chunks as
    ``BWD_SHARED_BYTES`` allows, of equal widths rounded up to a multiple of
    4 where that still fits (so that their tiles store four floats at a
    time). One chunk up to 1,586 channels at a 7² crop, 1,572 at 14²."""
    ch, cw = (int(v) for v in crop_size)
    widest = (BWD_SHARED_BYTES - bwd_shared_bytes(0, (ch, cw))) // (BWD_TILE_W * 4)
    if widest < 1:
        raise ValueError(f"roi_align_bwd: a {ch}x{cw} crop does not fit shared memory")
    count = max(-(-channels // widest), 1)
    width = -(-channels // count)
    width = min(-(-width // 4) * 4, widest)
    return [(c0, min(c0 + width, channels)) for c0 in range(0, channels, width)]


@functools.lru_cache(maxsize=None)
def _bwd_library() -> ctypes.CDLL:
    """``csrc/roi_align_bwd.cu``'s library with its entry points typed."""
    lib = cuda_build.load("roi_align_bwd")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ints = ctypes.POINTER(ctypes.c_int)
    lib.roi_align_bwd_scratch_ints.restype = ctypes.c_longlong
    lib.roi_align_bwd_scratch_ints.argtypes = [ints, ints] + [i32] * 5
    lib.roi_align_bwd_partial_floats.restype = ctypes.c_longlong
    lib.roi_align_bwd_partial_floats.argtypes = [i32, i32]
    lib.roi_align_bwd_plan.restype = i32
    lib.roi_align_bwd_plan.argtypes = ([ints, ints, i32, i32, ptr, ptr, ptr] + [i32] * 3
                                       + [f32, f32, i32, ptr, ptr])
    lib.roi_align_bwd.restype = i32
    lib.roi_align_bwd.argtypes = ([ctypes.POINTER(ctypes.c_void_p), ints, ints] + [i32] * 3
                                  + [ptr] + [i32] * 3 + [ptr] + [i32] * 3 + [ptr] * 3)
    return lib


def bwd_work_plan(
    shapes: Sequence[Sequence[int]],
    boxes: torch.Tensor,
    box_indices: torch.Tensor,
    level_idx: torch.Tensor,
    crop_size: Tuple[int, int],
    chunk_boxes: int = BWD_CHUNK_BOXES,
    split_above: int = BWD_SPLIT_ABOVE,
    xla: bool = False,
) -> Dict[str, int]:
    """Plain version of the backward kernel's planning passes: how
    ``csrc/roi_align_bwd.cu`` splits the work for these boxes.

    A tile is (level, image, map row, ``BWD_TILE_W`` map columns); a box
    meets it when the rectangle of the cells its valid samples tap covers
    it. A tile that ``c > split_above`` boxes meet gets ``ceil(c /
    chunk_boxes)`` work items, every other tile one (the kernel's constants
    are the defaults); a tile of several items gets as many slots of
    partial tiles. The samples are placed as :func:`_sample_positions`
    says with ``xla``. Returns the totals the kernel reads
    back: ``items``, ``partials`` (slots), ``multi_tiles`` (tiles of several
    items), ``max_chunks`` (most items of one tile) and ``pairs`` (the
    (box, tile) pairs of the tiles' box lists), and ``tiles``."""
    chunk, split = int(chunk_boxes), int(split_above)
    shapes = [tuple(int(d) for d in s) for s in shapes]
    b, num = shapes[0][0], len(shapes)
    ch, cw = (int(v) for v in crop_size)
    dev = boxes.device
    lvl = level_idx.to(torch.int64).clamp(0, num - 1)     # the kernel clamps as the forward
    img = box_indices.to(torch.int64).clamp(0, b - 1)
    hs = torch.tensor([float(s[1]) for s in shapes], device=dev)[lvl]
    ws = torch.tensor([float(s[2]) for s in shapes], device=dev)[lvl]
    y1, x1, y2, x2 = boxes.unbind(dim=1)
    ty, by, _, vy = _corner_weights(_sample_positions(y1, y2, ch, hs, xla), hs)
    lx, rx, _, vx = _corner_weights(_sample_positions(x1, x2, cw, ws, xla), ws)
    far = 1 << 30
    r0, r1 = torch.where(vy, ty, far).amin(1), torch.where(vy, by, -1).amax(1)
    c0, c1 = torch.where(vx, lx, far).amin(1), torch.where(vx, rx, -1).amax(1)
    hit = (r1 >= 0) & (c1 >= 0)
    counts = []
    for level, (_, h, w, _) in enumerate(shapes):
        tiles = -(-w // BWD_TILE_W)
        sel = hit & (lvl == level)
        # +1/-1 at the corners of each box's tile rectangle, summed along
        # rows and tile columns: the boxes that meet each tile
        grid = torch.zeros((b, h + 1, tiles + 1), dtype=torch.int64, device=dev)
        bi = img[sel]
        ya, yb = r0[sel], r1[sel] + 1
        xa, xb = c0[sel] // BWD_TILE_W, c1[sel] // BWD_TILE_W + 1
        for y, x, sign in ((ya, xa, 1), (ya, xb, -1), (yb, xa, -1), (yb, xb, 1)):
            grid.index_put_((bi, y, x), torch.full_like(bi, sign), accumulate=True)
        counts.append(grid.cumsum(1).cumsum(2)[:, :h, :tiles].reshape(-1))
    count = torch.cat(counts)
    chunks = torch.where(count <= split, torch.ones_like(count), (count + chunk - 1) // chunk)
    multi = chunks > 1
    return {"tiles": count.numel(), "items": int(chunks.sum()),
            "partials": int(chunks[multi].sum()), "multi_tiles": int(multi.sum()),
            "max_chunks": int(chunks.max()), "pairs": int(count.sum())}


class RoIAlign(torch.autograd.Function):
    """Multilevel RoIAlign with a kernel on both sides: forward
    :func:`roi_align_fwd`, backward :func:`roi_align_bwd` into every level.
    The boxes and indices get no gradient. Call through :func:`roi_align`."""

    @staticmethod
    def forward(ctx, boxes, box_indices, level_idx, crop_size,
                extrapolation_value, *features):
        ctx.save_for_backward(boxes, box_indices, level_idx)
        ctx.shapes = [tuple(f.shape) for f in features]
        ctx.crop_size = crop_size
        return roi_align_fwd(features, boxes, box_indices, level_idx,
                             crop_size, extrapolation_value)

    @staticmethod
    def backward(ctx, g):
        boxes, box_indices, level_idx = ctx.saved_tensors
        grads = roi_align_bwd(g.contiguous(), ctx.shapes, boxes, box_indices,
                              level_idx, ctx.crop_size)
        return (None,) * 5 + tuple(grads)


def roi_align(
    features: Sequence[torch.Tensor],
    boxes: torch.Tensor,
    box_indices: torch.Tensor,
    level_idx: torch.Tensor,
    crop_size: Tuple[int, int],
    extrapolation_value: float = 0.0,
) -> torch.Tensor:
    """Differentiable multilevel RoIAlign: [N, ch, cw, C] crops of the NHWC
    ``features``, in their dtype (see :func:`roi_align_fwd`)."""
    crop = tuple(int(v) for v in crop_size)
    return RoIAlign.apply(boxes, box_indices, level_idx, crop,
                          float(extrapolation_value), *features)


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
    return roi_align(features, boxes, box_indices, level_idx, crop_size,
                     extrapolation_value)


def crop_and_resize(
    image: torch.Tensor,
    boxes: torch.Tensor,
    box_indices: torch.Tensor,
    crop_size: Tuple[int, int],
    extrapolation_value: float = 0.0,
) -> torch.Tensor:
    """TF ``crop_and_resize`` of one NHWC map: [N, ch, cw, C]. A one-level
    call of :func:`roi_align`, so the same two kernels run it. The JAX
    single-level version writes its lerps without fused multiply-adds, so
    the two agree within float32 rounding, not bit for bit."""
    level_idx = torch.zeros_like(box_indices, dtype=torch.int32)
    return roi_align([image], boxes, box_indices, level_idx, crop_size,
                     extrapolation_value)


# How the single-level crops round their sample positions: as the Pallas
# kernels K4 and K5 do ("pallas", K4's default) or as XLA compiles the JAX
# ``crop_and_resize`` and ``crop_and_resize_separable`` ("xla": the Dev
# big-set crop and the mask targets of a jitted train step)
POSITIONS = ("pallas", "xla")


@functools.lru_cache(maxsize=None)
def xla_ratio(dim: int, crop: int) -> float:
    """float32 ``(dim-1) * (1 / (crop-1))``: XLA turns the division by the
    constant ``crop-1`` into a multiply by its reciprocal and folds it with
    ``dim-1`` into one constant."""
    one, div = torch.tensor(1.0), torch.tensor(float(max(crop - 1, 1)))
    return float(torch.tensor(float(dim - 1)) * (one / div))


def _single_level_positions(c0: torch.Tensor, c1: torch.Tensor, crop: int, dim: int,
                            positions: str) -> torch.Tensor:
    """[...] box starts and ends on one map axis of extent ``dim`` ->
    [..., crop] sample positions of the single-level crops. ``positions``
    "pallas" rounds as the single-level Pallas kernels compute them: ``step
    = ((c1 - c0)(dim-1)) / (crop-1)`` by a true division (a divisor on the
    tensors' device, since PyTorch multiplies by the reciprocal of a host
    scalar on the card), then ``c0 (dim-1) + i step`` without a fused
    multiply-add. "xla" rounds as XLA compiles the JAX ``crop_and_resize``
    and ``crop_and_resize_separable``: ``step = (c1 - c0) ratio``
    (:func:`xla_ratio`), then ``i step + c0 (dim-1)`` as one fused
    multiply-add. A crop of 1 takes the box centre."""
    if positions not in POSITIONS:
        raise ValueError(f"positions must be one of {POSITIONS}, got {positions!r}")
    dm1 = float(dim - 1)
    if crop == 1:
        return ((0.5 * (c0 + c1)) * dm1)[..., None]
    i = torch.arange(crop, dtype=torch.float32, device=c0.device)
    if positions == "xla":
        step = (c1 - c0) * xla_ratio(dim, crop)
        return _fma(i, step[..., None], (c0 * dm1)[..., None])
    step = ((c1 - c0) * dm1) / c0.new_tensor(float(crop - 1))
    return (c0 * dm1)[..., None] + i * step[..., None]


def _interp_matrix(c0: torch.Tensor, c1: torch.Tensor, crop: int, dim: int) -> torch.Tensor:
    """[N] starts and ends -> [N, crop, dim] two-tap interpolation rows,
    zero for samples outside ``[0, dim-1]`` (JAX ``_interp_matrix``, its
    sample positions rounded as XLA compiles it)."""
    d = float(dim)
    pos = _single_level_positions(c0, c1, crop, dim, "xla")
    valid = (pos >= 0.0) & (pos <= d - 1.0)
    lo = torch.floor(pos)
    frac = pos - lo
    lo_i = lo.clamp(0, dim - 1).to(torch.int64)
    hi_i = torch.ceil(pos).clamp(0, dim - 1).to(torch.int64)
    cols = torch.arange(dim, device=c0.device)
    mat = ((cols == lo_i[..., None]).float() * (1.0 - frac)[..., None]
           + (cols == hi_i[..., None]).float() * frac[..., None])
    return torch.where(valid[..., None], mat, mat.new_zeros(()))


def crop_and_resize_separable(
    images: torch.Tensor,
    boxes: torch.Tensor,
    crop_size: Tuple[int, int],
) -> torch.Tensor:
    """``crop_and_resize`` of one source per box, as two interpolation
    products ``Wy @ img @ Wxᵀ``: images [N, H, W, C], boxes [N, 4]
    normalised -> [N, ch, cw, C], zero outside the source. The JAX package
    computes it outside any kernel; the mask targets use it."""
    _, h, w, _ = images.shape
    ch, cw = crop_size
    wy = _interp_matrix(boxes[:, 0], boxes[:, 2], ch, h)
    wx = _interp_matrix(boxes[:, 1], boxes[:, 3], cw, w)
    return torch.einsum("niwc,njw->nijc", torch.einsum("nih,nhwc->niwc", wy, images), wx)


# --- single-level crop_and_resize with boxes grouped per image (K4, K5) --------------
def _grouped_axis(c0: torch.Tensor, c1: torch.Tensor, crop: int, dim: int,
                  positions: str = "pallas"):
    """[B, NB] box starts and ends on one axis -> tap indices ``lo``, ``hi``
    (int64), ``frac`` and ``valid``, each [B, NB, crop], at the sample
    positions :func:`_single_level_positions` rounds as ``positions`` says
    (a NaN position invalid, on cell 0, as in the kernel)."""
    dm1 = float(dim - 1)
    pos = _single_level_positions(c0, c1, crop, dim, positions)
    valid = (pos >= 0.0) & (pos <= dm1)
    lo = torch.floor(pos)
    frac = torch.nan_to_num(pos - lo, nan=0.0)
    lo_i = torch.nan_to_num(lo, nan=0.0).clamp(0.0, dm1).to(torch.int64)
    hi_i = torch.nan_to_num(torch.ceil(pos), nan=0.0).clamp(0.0, dm1).to(torch.int64)
    return lo_i, hi_i, frac, valid


def _grouped_taps(image: torch.Tensor, boxes: torch.Tensor, crop_size,
                  positions: str = "pallas"):
    """What both grouped crops read: ``gather(yi, xi)`` -> [B, NB, ch, cw, C]
    pixels of each box's image, and the per-axis taps of
    :func:`_grouped_axis` broadcast to ``[B, NB, ch, cw, 1]``."""
    b, h, w, c = image.shape
    ch, cw = crop_size
    ty, by, fy, vy = _grouped_axis(boxes[..., 0], boxes[..., 2], ch, h, positions)
    lx, rx, fx, vx = _grouped_axis(boxes[..., 1], boxes[..., 3], cw, w, positions)
    flat = image.reshape(-1, c)
    base = (torch.arange(b, device=image.device) * (h * w))[:, None, None, None, None]

    def gather(yi, xi):
        idx = base + yi * w + xi                      # [B, NB, ch, cw, 1]
        return flat[idx.reshape(-1)].reshape(*idx.shape[:-1], c)

    def ys(t):
        return t[..., :, None, None]

    def xs(t):
        return t[..., None, :, None]

    return gather, (ys(ty), ys(by), ys(fy), ys(vy)), (xs(lx), xs(rx), xs(fx), xs(vx))


def crop_and_resize_grouped_plain(image: torch.Tensor, boxes: torch.Tensor,
                                  crop_size: Tuple[int, int],
                                  extrapolation_value: float = 0.0,
                                  positions: str = "pallas") -> torch.Tensor:
    """Plain version of the K4 kernel: sample positions rounded as
    ``positions`` says (:func:`_grouped_axis`); per sample row the y-lerp
    of the two tap rows, ``t + (b - t) fy``, then ``(1 - fx) r_l + fx r_r``;
    ``extrapolation_value`` where the sample lies outside the map. A
    bfloat16 image is widened and the crops rounded once to bfloat16."""
    if image.dtype == torch.bfloat16:
        return crop_and_resize_grouped_plain(image.float(), boxes, crop_size,
                                             extrapolation_value, positions).to(image.dtype)
    gather, (ty, by, fy, vy), (lx, rx, fx, vx) = _grouped_taps(image, boxes, crop_size,
                                                               positions)
    tl, tr, bl, br = gather(ty, lx), gather(ty, rx), gather(by, lx), gather(by, rx)
    rl = tl + (bl - tl) * fy
    rr = tr + (br - tr) * fy
    out = (1.0 - fx) * rl + fx * rr
    return torch.where(vy & vx, out, out.new_tensor(float(extrapolation_value)))


def crop_and_resize_grouped_mm_plain(image: torch.Tensor, boxes: torch.Tensor,
                                     crop_size: Tuple[int, int]) -> torch.Tensor:
    """Plain version of the K5 kernel, its two interpolation products with
    the zeros dropped: ``(1 - fy) img[lo] + fy img[hi]`` at the x taps (the
    tap alone where ``lo == hi``, whose weight is exactly 1), then the same
    along x; 0 outside the map. A bfloat16 image is widened and the crops
    rounded once to bfloat16."""
    if image.dtype == torch.bfloat16:
        return crop_and_resize_grouped_mm_plain(image.float(), boxes, crop_size).to(image.dtype)
    gather, (ty, by, fy, vy), (lx, rx, fx, vx) = _grouped_taps(image, boxes, crop_size)

    def y_pass(xi):
        top, bot = gather(ty, xi), gather(by, xi)
        return torch.where(ty == by, top, (1.0 - fy) * top + fy * bot)

    rl, rr = y_pass(lx), y_pass(rx)
    out = torch.where(lx == rx, rl, (1.0 - fx) * rl + fx * rr)
    return torch.where(vy & vx, out, out.new_zeros(()))


def _check_grouped(name: str, image: torch.Tensor, boxes: torch.Tensor) -> None:
    if image.dim() != 4 or image.dtype not in POOL_DTYPES:
        raise TypeError(f"{name}: image must be a [B, H, W, C] float32 or bfloat16 map")
    if (boxes.dim() != 3 or boxes.shape[0] != image.shape[0] or boxes.shape[2] != 4
            or boxes.dtype != torch.float32):
        raise ValueError(f"{name}: boxes must be [B, NB, 4] float32, B = {image.shape[0]}")
    if boxes.device != image.device:
        raise ValueError(f"{name}: image and boxes must be on one device")
    if image.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, not {image.device}")
    if image.device.type == "cuda" and not (image.is_contiguous() and boxes.is_contiguous()):
        raise ValueError(f"{name} needs a contiguous NHWC image and contiguous boxes")


@functools.lru_cache(maxsize=None)
def _grouped_library() -> ctypes.CDLL:
    """``csrc/crop_and_resize.cu``'s library with its entry point typed."""
    lib = cuda_build.load("crop_and_resize")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.crop_and_resize_grouped.restype = i32
    lib.crop_and_resize_grouped.argtypes = [ptr, ptr] + [i32] * 11 + [ctypes.c_float, ptr, ptr]
    return lib


def _launch_grouped(name: str, image: torch.Tensor, boxes: torch.Tensor, crop_size,
                    extrapolation_value: float, positions: str = "pallas") -> torch.Tensor:
    """Launch ``csrc/crop_and_resize.cu`` on the current stream as K4
    (``crop_and_resize_grouped``) or K5 (``crop_and_resize_grouped_mm``,
    extrapolation 0, "pallas" positions): [B, NB, ch, cw, C] float32 crops.
    A block takes the :func:`fwd_plan` rows of K1: the kernel stages its
    taps as K1 does."""
    b, h, w, c = image.shape
    nb = boxes.shape[1]
    out = torch.empty((b, nb, *crop_size, c), dtype=torch.float32, device=image.device)
    vec = mm_vector_width(image)
    rows, _, _ = fwd_plan(b * nb, crop_size, c, vec)
    with torch.cuda.device(image.device):
        stream = torch.cuda.current_stream(image.device).cuda_stream
        err = _grouped_library().crop_and_resize_grouped(
            image.data_ptr(), boxes.data_ptr(), b, nb, h, w, c,
            int(name == "crop_and_resize_grouped_mm"), int(positions == "xla"), vec,
            *crop_size, rows,
            extrapolation_value, out.data_ptr(), stream)
    cuda_build.check(err, name)
    if nb > 0:  # the C entry launches nothing for no boxes
        cuda_build.launches[name] += 1
    return out


def crop_and_resize_grouped(image: torch.Tensor, boxes: torch.Tensor,
                            crop_size: Tuple[int, int],
                            extrapolation_value: float = 0.0,
                            positions: str = "pallas") -> torch.Tensor:
    """TF ``crop_and_resize`` of boxes grouped per image: image [B, H, W, C]
    float32 or bfloat16, boxes [B, NB, 4] normalised -> [B, NB, ch, cw, C]
    in the image's dtype, any ``extrapolation_value``, any NB and C (a
    bfloat16 image is widened once and the crops rounded once). The sample
    positions are rounded as the Pallas kernel rounds them, or with
    ``positions="xla"`` as the jitted JAX ``crop_and_resize`` does
    (:func:`_grouped_axis`).

    Kernel wrapper: on CUDA tensors it launches ``csrc/crop_and_resize.cu``
    (which replaces ``feature_intertwiner_tpu/ops/roi_align.py::
    _roi_align_kernel``, behind ``crop_and_resize_pallas``); on CPU tensors
    it runs :func:`crop_and_resize_grouped_plain`. Each launch adds one to
    ``cuda_build.launches["crop_and_resize_grouped"]``."""
    _check_grouped("crop_and_resize_grouped", image, boxes)
    if positions not in POSITIONS:
        raise ValueError(f"positions must be one of {POSITIONS}, got {positions!r}")
    crop = tuple(int(v) for v in crop_size)
    if image.dtype != torch.float32:
        return crop_and_resize_grouped(image.float(), boxes, crop, extrapolation_value,
                                       positions).to(image.dtype)
    if image.device.type == "cpu":
        return crop_and_resize_grouped_plain(image, boxes, crop, extrapolation_value, positions)
    return _launch_grouped("crop_and_resize_grouped", image, boxes, crop,
                           float(extrapolation_value), positions)


def mm_vector_width(image: torch.Tensor) -> int:
    """Floats K4 and K5 read and write at a time: 4 when the channel count
    is a multiple of 4 and the image starts on a 16-byte boundary (every map
    row then does, and the crops the wrapper allocates always do), else 1."""
    return 4 if image.shape[-1] % 4 == 0 and image.data_ptr() % 16 == 0 else 1


def crop_and_resize_grouped_mm(image: torch.Tensor, boxes: torch.Tensor,
                               crop_size: Tuple[int, int]) -> torch.Tensor:
    """The same crop as :func:`crop_and_resize_grouped` with extrapolation 0,
    as two separable interpolation passes, any map width and channel count.

    Kernel wrapper: on CUDA tensors it launches ``csrc/crop_and_resize.cu``
    as K5 (which replaces ``feature_intertwiner_tpu/
    ops/roi_align.py::_roi_align_matmul_kernel``, behind
    ``crop_and_resize_pallas_mm``); on CPU tensors it runs
    :func:`crop_and_resize_grouped_mm_plain`. Each launch adds one to
    ``cuda_build.launches["crop_and_resize_grouped_mm"]``."""
    _check_grouped("crop_and_resize_grouped_mm", image, boxes)
    crop = tuple(int(v) for v in crop_size)
    if image.dtype != torch.float32:
        return crop_and_resize_grouped_mm(image.float(), boxes, crop).to(image.dtype)
    if image.device.type == "cpu":
        return crop_and_resize_grouped_mm_plain(image, boxes, crop)
    return _launch_grouped("crop_and_resize_grouped_mm", image, boxes, crop, 0.0)


class CropAndResizeFused(torch.autograd.Function):
    """K4 forward, K3 backward: the port of the JAX custom VJP
    ``crop_and_resize_fused``. The backward is the one-level
    :func:`roi_align_bwd` on the flattened boxes, as ``_fused_bwd`` takes
    the XLA gather's VJP. With ``positions`` "pallas" K4 samples with a
    true division and K3 with a reciprocal multiply and fused multiply-adds
    (as the JAX forward and its XLA backward do), so at a position that
    lands on an integer the two may tap cells one apart. With "xla" both
    place every sample as the jitted JAX ``crop_and_resize`` does (K4's and
    K3's ``xla`` modes), so the backward scatters to the taps the forward
    read: the gradient of the Dev big-set crop. The boxes get no
    gradient."""

    @staticmethod
    def forward(ctx, image, boxes, crop_size, extrapolation_value, positions):
        ctx.save_for_backward(boxes)
        ctx.shape = tuple(image.shape)
        ctx.crop_size = crop_size
        ctx.positions = positions
        return crop_and_resize_grouped(image, boxes, crop_size, extrapolation_value, positions)

    @staticmethod
    def backward(ctx, g):
        (boxes,) = ctx.saved_tensors
        b, nb = boxes.shape[:2]
        ch, cw = ctx.crop_size
        flat = boxes.reshape(b * nb, 4).contiguous()
        idx = torch.arange(b, dtype=torch.int32, device=boxes.device).repeat_interleave(nb)
        level = torch.zeros_like(idx)
        (d_image,) = roi_align_bwd(g.reshape(b * nb, ch, cw, ctx.shape[3]).contiguous(),
                                   [ctx.shape], flat, idx, level, ctx.crop_size,
                                   xla=ctx.positions == "xla")
        return d_image, None, None, None, None


def crop_and_resize_fused(image: torch.Tensor, boxes: torch.Tensor,
                          crop_size: Tuple[int, int],
                          extrapolation_value: float = 0.0,
                          positions: str = "pallas") -> torch.Tensor:
    """Differentiable :func:`crop_and_resize_grouped` (gradient into the
    image only, in its dtype): [B, H, W, C], [B, NB, 4] -> [B, NB, ch, cw, C];
    ``positions`` as :class:`CropAndResizeFused` says."""
    if positions not in POSITIONS:
        raise ValueError(f"positions must be one of {POSITIONS}, got {positions!r}")
    crop = tuple(int(v) for v in crop_size)
    return CropAndResizeFused.apply(image, boxes, crop, float(extrapolation_value), positions)
