"""Exact greedy non-max suppression.

Port of ``feature_intertwiner_tpu/ops/nms.py``. The alive mask over
score-sorted boxes runs in the CUDA kernel ``csrc/nms.cu`` (the port of the
Pallas kernel ``ops/nms_pallas.py::_nms_kernel``) for tensors on the card,
and in :func:`greedy_alive_sorted_plain`, a torch copy of the JAX block sweep
``_greedy_alive_sorted``, for tensors on the CPU. Both are bit-exact with the
JAX package.

Everything here is batched over a leading dimension, where the JAX package
vmaps its per-sample functions: ``boxes [B, N, 4]``, ``scores [B, N]``.

IoU conventions, as in the JAX package: ``plus_one=True`` measures a box as
``x2 - x1 + 1``; ``strict=True`` suppresses at ``iou > threshold`` and
``False`` at ``>=``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import cuda_build

NEG_INF = -1e30
TILE = 64  # rows per tile of the kernel's bitmask; padded N is a multiple
WORD_BYTES = 8  # one uint64 word of the bitmask: a row against one tile
SHARED_BYTES = 232_448  # the shared memory one block may opt in to on the H100 (227 KB)
STAGES = 2  # the sweep's stage buffers: a tile's run is staged one tile ahead
LIST_BYTES = 8 * TILE  # the sweep's lists of kept rows, one a warp


def _pairwise_iou(a: torch.Tensor, b: torch.Tensor, plus_one: bool) -> torch.Tensor:
    """IoU between row boxes [..., N, 4] and column boxes [..., M, 4]."""
    off = 1.0 if plus_one else 0.0
    y1 = torch.maximum(a[..., :, None, 0], b[..., None, :, 0])
    x1 = torch.maximum(a[..., :, None, 1], b[..., None, :, 1])
    y2 = torch.minimum(a[..., :, None, 2], b[..., None, :, 2])
    x2 = torch.minimum(a[..., :, None, 3], b[..., None, :, 3])
    inter = (x2 - x1 + off).clamp_min(0.0) * (y2 - y1 + off).clamp_min(0.0)
    area_a = (a[..., 2] - a[..., 0] + off) * (a[..., 3] - a[..., 1] + off)
    area_b = (b[..., 2] - b[..., 0] + off) * (b[..., 3] - b[..., 1] + off)
    return inter / (area_a[..., :, None] + area_b[..., None, :] - inter)


def _suppresses(iou: torch.Tensor, threshold: float, strict: bool) -> torch.Tensor:
    t = iou.new_tensor(threshold)  # rounded to float32, as the kernel gets it
    return iou > t if strict else iou >= t


def greedy_alive_sorted_plain(
    boxes: torch.Tensor,
    valid: torch.Tensor,
    iou_threshold: float,
    plus_one: bool = True,
    strict: bool = True,
) -> torch.Tensor:
    """Plain version of the alive-mask kernel: the JAX block sweep, one
    ``TILE`` of rows per block.

    boxes [B, N, 4] sorted by descending score, N a multiple of ``TILE``;
    valid [B, N] bool. For each block: earlier survivors suppress its
    candidates, then the in-block greedy recurrence is iterated to its
    fixpoint (unique, and equal to the greedy answer)."""
    n, block = boxes.shape[1], TILE
    positions = torch.arange(n, device=boxes.device)
    tri = positions[:block, None] < positions[None, :block]
    alive = valid.clone()
    for start in range(0, n, block):
        blk = boxes[:, start:start + block]
        cand = alive[:, start:start + block]
        prev_alive = alive & (positions < start)
        supp = _suppresses(_pairwise_iou(boxes, blk, plus_one), iou_threshold, strict)
        cand = cand & ~(supp & prev_alive[:, :, None]).any(dim=1)

        mat = _suppresses(_pairwise_iou(blk, blk, plus_one), iou_threshold, strict) & tri
        a = cand
        while True:
            new = cand & ~(mat & a[:, :, None]).any(dim=1)
            if torch.equal(new, a):
                break
            a = new
        alive[:, start:start + block] = a
    return alive


def sweep_plan(n: int) -> Tuple[int, int]:
    """The sweep kernel's staging plan for N boxes (N a multiple of
    ``TILE``): ``(words, shared_bytes)``.

    The sweep walks the ``N / TILE`` tiles in order. Each of tile c's
    ``TILE`` rows holds one mask word for each tile from c on (its run).
    The kernel stages the first ``words`` of each row in shared memory,
    one tile ahead in ``STAGES`` buffers, beside its ``removed``
    bitset (one word per tile) and its lists of kept rows, and reads the
    rest of a run from device memory. ``words`` is every tile where whole
    runs fit in ``SHARED_BYTES`` (up to 224 tiles, N = 14,336), else as
    many as fit. Raises ``ValueError`` where not even the diagonal word
    fits (N above 1,847,296)."""
    tiles = n // TILE
    fixed = tiles * WORD_BYTES + LIST_BYTES
    per_word = STAGES * TILE * WORD_BYTES
    words = min(tiles, (SHARED_BYTES - fixed) // per_word)
    if tiles and words < 1:
        raise ValueError(f"N={n}: the sweep's bitset leaves no room to stage a tile")
    return words, fixed + words * per_word


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry of ``csrc/nms.cu``, built and loaded on first use, its
    prototype set once."""
    fn = cuda_build.load("nms").nms_alive
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    return fn


def nms_alive(
    boxes_sorted: torch.Tensor,
    valid_sorted: torch.Tensor,
    iou_threshold: float,
    plus_one: bool = True,
    strict: bool = True,
) -> torch.Tensor:
    """Greedy-NMS alive mask: boxes [B, N, 4] float32 sorted by descending
    score, N a multiple of 64; valid [B, N] bool. Returns alive [B, N] bool.

    Kernel wrapper: on a CUDA tensor it launches ``csrc/nms.cu`` (which
    replaces ``feature_intertwiner_tpu/ops/nms_pallas.py::_nms_kernel``); on
    a CPU tensor it runs :func:`greedy_alive_sorted_plain`. Each launch adds
    one to ``cuda_build.launches["nms_alive"]``."""
    if boxes_sorted.dim() != 3 or boxes_sorted.shape[-1] != 4:
        raise ValueError(f"boxes must be [B, N, 4], got {tuple(boxes_sorted.shape)}")
    bsz, n, _ = boxes_sorted.shape
    if valid_sorted.shape != (bsz, n) or valid_sorted.dtype != torch.bool:
        raise ValueError("valid must be a [B, N] bool tensor matching boxes")
    if boxes_sorted.dtype != torch.float32:
        raise TypeError(f"boxes must be float32, got {boxes_sorted.dtype}")
    if n % TILE:
        raise ValueError(f"N must be a multiple of {TILE}, got {n}")
    if valid_sorted.device != boxes_sorted.device:
        raise ValueError("boxes and valid must be on one device")
    if boxes_sorted.device.type == "cpu":
        return greedy_alive_sorted_plain(boxes_sorted, valid_sorted,
                                         iou_threshold, plus_one, strict)
    if boxes_sorted.device.type != "cuda":
        raise ValueError(f"nms_alive runs on cuda or cpu, not {boxes_sorted.device}")
    if not (boxes_sorted.is_contiguous() and valid_sorted.is_contiguous()):
        raise ValueError("nms_alive needs contiguous boxes and valid")

    words, _ = sweep_plan(n)
    tiles = n // TILE
    dev = boxes_sorted.device
    # the bitmask's upper triangle: each of tile c's rows holds words c..tiles-1
    mask = torch.empty(bsz * TILE * tiles * (tiles + 1) // 2, dtype=torch.int64, device=dev)
    alive = torch.empty((bsz, n), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernel()(boxes_sorted.data_ptr(), valid_sorted.data_ptr(), bsz, n,
                        float(iou_threshold), int(plus_one), int(strict), words,
                        mask.data_ptr(), alive.data_ptr(), stream)
    cuda_build.check(err, "nms_alive")
    if bsz * n > 0:  # the C entry launches nothing for no boxes
        cuda_build.launches["nms_alive"] += 1
    return alive


def batched_nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: float,
    max_output: int,
    valid: Optional[torch.Tensor] = None,
    plus_one: bool = True,
    strict: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS per sample: boxes [B, N, 4], scores [B, N].

    Returns ``keep_idx [B, max_output]`` (int64 indices into the input
    order, by descending score; slots past the keep count are 0) and
    ``keep_valid [B, max_output]`` bool, as the JAX ``nms`` does per sample.
    """
    bsz, n = scores.shape
    dev = scores.device
    if valid is None:
        valid = torch.ones((bsz, n), dtype=torch.bool, device=dev)

    scores_eff = torch.where(valid, scores, scores.new_tensor(NEG_INF))
    order = torch.sort(-scores_eff, dim=1, stable=True).indices   # [B, N]
    boxes_sorted = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    valid_sorted = torch.gather(valid, 1, order)

    pad = (-n) % TILE
    if pad:
        boxes_sorted = torch.nn.functional.pad(boxes_sorted, (0, 0, 0, pad))
        valid_sorted = torch.nn.functional.pad(valid_sorted, (0, pad))
    alive = nms_alive(boxes_sorted.contiguous(), valid_sorted.contiguous(),
                      iou_threshold, plus_one=plus_one, strict=strict)[:, :n]

    # Compact the surviving sorted positions into [max_output] slots.
    slot = torch.cumsum(alive.to(torch.int64), dim=1) - 1
    in_range = alive & (slot < max_output)
    target = torch.where(in_range, slot, torch.full_like(slot, max_output))
    keep_idx = torch.zeros((bsz, max_output + 1), dtype=torch.int64, device=dev)
    keep_idx.scatter_(1, target, order)   # dropped rows land in the last slot
    keep_idx = keep_idx[:, :max_output]
    count = torch.clamp(alive.sum(dim=1), max=max_output)
    keep_valid = torch.arange(max_output, device=dev)[None, :] < count[:, None]
    return keep_idx, keep_valid


def nms(boxes, scores, iou_threshold, max_output, valid=None, **kwargs):
    """Greedy NMS for one sample: boxes [N, 4], scores [N] (JAX signature)."""
    keep_idx, keep_valid = batched_nms(
        boxes[None], scores[None], iou_threshold, max_output,
        valid=None if valid is None else valid[None], **kwargs)
    return keep_idx[0], keep_valid[0]


def class_aware_nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    class_ids: torch.Tensor,
    iou_threshold: float,
    max_output: int,
    valid: Optional[torch.Tensor] = None,
    **kwargs,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-class NMS in one call, batched: boxes [B, N, 4], class_ids [B, N].

    Each class's boxes move to a coordinate island of their own, so that
    boxes of two classes never overlap, then one NMS runs over all of them.
    ``span = max|boxes| + 2`` per sample and ``offset = class * span * 4``,
    in the JAX package's operation order."""
    span = boxes.abs().amax(dim=(1, 2)) + 2.0                    # [B]
    offsets = class_ids.to(boxes.dtype)[..., None] * span[:, None, None] * 4.0
    return batched_nms(boxes + offsets, scores, iou_threshold, max_output,
                       valid=valid, **kwargs)
