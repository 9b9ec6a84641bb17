"""Time the port's RoI pooling kernels, its window probe and its NMS kernel.

    python -m feature_intertwiner_tpu_torch.tools.profile_roi crop   [flags]
    python -m feature_intertwiner_tpu_torch.tools.profile_roi stage  [flags]
    python -m feature_intertwiner_tpu_torch.tools.profile_roi window [flags]
    python -m feature_intertwiner_tpu_torch.tools.profile_roi bwd    [flags]
    python -m feature_intertwiner_tpu_torch.tools.profile_roi nms    [flags]
    python -m feature_intertwiner_tpu_torch.tools.profile_roi fwd    [flags]

The port of four measuring scripts of the JAX package:

- ``crop`` (``scripts/profile_pallas_ra.py``): single-level 7² crops of
  ``--boxes`` boxes per image from a ``--size``² map of 256 channels at batch
  ``--batch`` (defaults 8, 1024, 256): the port's ``crop_and_resize`` (the
  multilevel kernel K1 on one level), the grouped kernels K4
  (``crop_and_resize_grouped``) and K5 (``crop_and_resize_grouped_mm``), and
  ``F.grid_sample`` as a yardstick;
- ``stage`` (``scripts/profile_roistage.py``): the second stage's pieces at
  batch ``--batch`` with ``--boxes`` RoIs per image over P2-P5 of a
  ``--size``² image (defaults 32, 1000, 1024): multilevel RoIAlign at 7²
  and 14² (K1), the classifier product ``[B N, 7·7·256] x [·, 1024]``, a raw
  4-corner row gather, and K5 on the P4 map with the boxes per image cut to
  a multiple of 128;
- ``window`` (``scripts/profile_window_dma.py``): the window-sum kernel K6
  over windows of 8² to 64² at ``--boxes`` random origins (default 4096) on
  a ``[--batch, --size, --size, 256]`` bfloat16 map (defaults 8, 256),
  against ``row_gather_checksum``, a plain gather of 196 and 784 rows per
  box; bytes, ms and GB/s;
- ``bwd`` (``scripts/profile_window_bwd.py``): the RoIAlign gradient at
  batch ``--batch`` with ``--boxes`` random boxes per image over P2-P5 of a
  ``--size``² image (defaults 8, 200, 1024: 1600 boxes), 256 channels, at
  7² and 14²: the backward kernel K3 alone, the forward K1 and K3 through
  ``roi_align`` and autograd, the plain backward, and ``grid_sample``'s
  backward into P2 for the same boxes as a yardstick.

And ``nms``, which has no JAX script: the NMS kernel K2 (``nms_alive``) and
its plain version at the shapes of the inference path's two calls, at batch
``--batch`` (default 2; the train step runs 4, the evaluation 8): the
proposals' ``--boxes`` boxes per image (default 6000, padded to 6016) at
IoU threshold 0.7, and the detections' 1000 per image (padded to 1024)
(or ``--boxes``, where fewer) in 2 classes, each class moved to an island
of its own as ``class_aware_nms`` moves it, at 0.3, on a ``--size``² image
(default 1024). The boxes come from ``--seed`` in clusters, so that about
40% of the proposals survive, as on the inference path.

And ``fwd``, which has no JAX script either: the multilevel RoIAlign
forward K1 (``roi_align_fwd``), its plain version and ``F.grid_sample``
over one map as a yardstick, at the shapes of the model's own calls over
P2-P5 of a ``--size``² image (default 1024), 256 channels. At batch
``--batch`` (default 2; 8 is the evaluation's) the inference path's two
calls: 7² on ``--boxes`` proposals per image (default 1000) and 14² on 100
detections per image (or ``--boxes``, where fewer). At ``--batch 4`` the
train step's: K1's two, 7² and 14² on ``--boxes`` RoIs per image (default
200) over P2-P5, and the three big-set crops, a 14² crop of every RoI on
each of P2, P3 and P4 alone, which the train step runs through K4
(``crop_and_resize_grouped`` with the jitted JAX crop's sample positions)
beside its plain version and ``F.grid_sample``. The boxes are clustered as ``nms``'s proposals, from
``--seed``, each on the level ``assign_fpn_level`` gives it.

``crop``, ``stage``, ``bwd`` and ``fwd`` run ``--dtype`` maps (and
cotangents, and the classifier product), bfloat16 by default as the JAX
scripts ran them: a bfloat16 map goes through the kernels' bfloat16 entry
(widened to float32 once per call, the float32 kernel, the result rounded
once). Each line names the dtype it used. Times are CUDA
events on the card (mean of ``--reps`` calls after one warm-up) and the host
clock with ``--device cpu``, where the kernels' plain versions run; each
table names its device. Each row of a sweep also holds the function it
timed (``fn``) and the arguments it timed it on (``args``), so that a
caller can check those very results.

``--trace`` adds, under each route, the host's time to enqueue one call
and the device kernels it launched as ``torch.profiler`` records them
(:func:`kernel_trace`): launches and device ms per call, grid, block,
registers per thread, shared memory per block, and the profiler's estimate
of the achieved occupancy.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import tempfile
import time
import warnings
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..inference import COMPUTE_DTYPES, resolve_device
from ..ops import cuda_build
from ..ops import nms as nms_ops
from ..ops import roi_align as roi_ops
from ..ops.window_sum import window_sum

CHANNELS = 256
WINDOW_SIZES = ((8, 8), (8, 16), (16, 16), (16, 32), (32, 32), (32, 64), (64, 64))
GATHER_ROWS = (196, 784)      # the corner rows of a 7² and a 14² crop
# The ``nms`` calls: (label, most boxes per image, IoU threshold, classes).
# The detections' call takes the inference path's 1000 RoIs per image (or
# ``--boxes``, where fewer); 2 classes leave about 28% of them, near the
# inference path's 23%
NMS_CALLS = (("proposals", None, 0.7, 0), ("detections", 1000, 0.3, 2))
NMS_BOXES_PER_CLUSTER, NMS_JITTER = 6, 0.08


def time_ms(fn: Callable[[], object], reps: int, device: torch.device) -> float:
    """Mean ms of one call after a warm-up: CUDA events on the card, the
    host clock on the CPU."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps


def random_boxes(rng: np.random.RandomState, shape: Sequence[int]) -> np.ndarray:
    """Normalised (y1, x1, y2, x2) boxes of the JAX scripts: corners in
    [0, 0.7), sides in [0.02, 0.3)."""
    y1x1 = rng.uniform(0, 0.7, tuple(shape) + (2,))
    hw = rng.uniform(0.02, 0.3, tuple(shape) + (2,))
    return np.concatenate([y1x1, y1x1 + hw], -1).astype(np.float32)


def box_grid(boxes: torch.Tensor, crop, batch: int) -> torch.Tensor:
    """``grid_sample``'s grid for the crops of ``boxes`` [N, 4] (normalised,
    N a multiple of ``batch``, in image order): [batch, N / batch * ch, cw, 2]
    in [-1, 1], sampling the box corners as ``align_corners=True`` does."""
    n, (ch, cw) = boxes.shape[0], crop
    ys = torch.linspace(0, 1, ch, device=boxes.device)
    xs = torch.linspace(0, 1, cw, device=boxes.device)
    by = boxes[:, 0:1] + (boxes[:, 2:3] - boxes[:, 0:1]) * ys
    bx = boxes[:, 1:2] + (boxes[:, 3:4] - boxes[:, 1:2]) * xs
    grid = torch.stack([bx[:, None, :].expand(n, ch, cw),
                        by[:, :, None].expand(n, ch, cw)], dim=-1) * 2 - 1
    return grid.reshape(batch, n // batch * ch, cw, 2)


def crop_inputs(batch: int, boxes: int, size: int, device, seed: int = 0,
                dtype: str = "float32"):
    """The ``crop`` inputs: a [B, S, S, 256] map of ``dtype`` and [B, NB, 4]
    float32 boxes."""
    rng = np.random.RandomState(seed)
    image = torch.from_numpy(rng.randn(batch, size, size, CHANNELS).astype(np.float32))
    return (image.to(device=device, dtype=COMPUTE_DTYPES[dtype]),
            torch.from_numpy(random_boxes(rng, (batch, boxes))).to(device))


def timed_rows(routes, reps: int, device: torch.device, dtype: str) -> List[Dict[str, object]]:
    """One row per (name, fn, args) route: its mean ms, ``fn`` and ``args``."""
    rows = []
    with torch.no_grad():
        for name, fn, args in routes:
            rows.append({"route": name, "dtype": dtype, "fn": fn, "args": args,
                         "ms": time_ms(lambda: fn(*args), reps, device)})
    return rows


def crop(batch: int = 8, boxes: int = 1024, size: int = 256, reps: int = 5,
         device=None, crop_size=(7, 7), dtype: str = "bfloat16") -> List[Dict[str, object]]:
    """The ``crop`` table: one row per route, with its ms."""
    dev = resolve_device(device)
    image, grouped = crop_inputs(batch, boxes, size, dev, dtype=dtype)
    flat = grouped.reshape(-1, 4)
    idx = torch.arange(batch, dtype=torch.int32, device=dev).repeat_interleave(boxes)
    grid = box_grid(flat, crop_size, batch).to(image.dtype)
    grid_sample = functools.partial(F.grid_sample, mode="bilinear", padding_mode="zeros",
                                    align_corners=True)
    routes = [
        ("crop_and_resize (K1, one level)", roi_ops.crop_and_resize,
         (image, flat, idx, crop_size)),
        ("crop_and_resize_grouped (K4)", roi_ops.crop_and_resize_grouped,
         (image, grouped, crop_size)),
        ("crop_and_resize_grouped_mm (K5)", roi_ops.crop_and_resize_grouped_mm,
         (image, grouped, crop_size)),
        ("F.grid_sample (yardstick)", grid_sample, (image.permute(0, 3, 1, 2), grid)),
    ]
    return timed_rows(routes, reps, dev, dtype)


def stage_inputs(batch: int, boxes: int, size: int, device, seed: int = 0,
                 dtype: str = "float32"):
    """P2-P5 maps ([B, size/4 ... size/32, 256] of ``dtype``) and [B N, 4]
    float32 boxes."""
    rng = np.random.RandomState(seed)
    maps = [torch.from_numpy(rng.randn(batch, size // s, size // s, CHANNELS)
                             .astype(np.float32)).to(device=device, dtype=COMPUTE_DTYPES[dtype])
            for s in (4, 8, 16, 32)]
    return maps, torch.from_numpy(random_boxes(rng, (batch * boxes,))).to(device)


def stage(batch: int = 32, boxes: int = 1000, size: int = 1024, reps: int = 5,
          device=None, dtype: str = "bfloat16") -> List[Dict[str, object]]:
    """The ``stage`` table: one row per piece of the second stage."""
    dev = resolve_device(device)
    maps, flat = stage_inputs(batch, boxes, size, dev, dtype=dtype)
    idx = torch.arange(batch, dtype=torch.int32, device=dev).repeat_interleave(boxes)
    rng = np.random.RandomState(1)
    n = batch * boxes
    x = torch.from_numpy(rng.randn(n, 7 * 7 * CHANNELS).astype(np.float32)).to(
        dev, COMPUTE_DTYPES[dtype])
    wmat = torch.from_numpy(rng.randn(7 * 7 * CHANNELS, 1024).astype(np.float32)).to(
        dev, COMPUTE_DTYPES[dtype])
    pyramid = torch.cat([m.reshape(batch, -1, CHANNELS) for m in maps], 1).reshape(-1, CHANNELS)
    gidx = torch.from_numpy(rng.randint(0, pyramid.shape[0], (n * 49 * 4,))).to(dev)
    cut = boxes // 128 * 128
    p4_boxes = flat.reshape(batch, boxes, 4)[:, :cut].contiguous()
    routes = [(f"multilevel RoIAlign {c}x{c} (K1), {boxes} per image",
               roi_ops.multilevel_crop_and_resize, (maps, flat, idx, (c, c), (size, size)))
              for c in (7, 14)]
    routes += [
        (f"classifier product [{n}, {7 * 7 * CHANNELS}] x [{7 * 7 * CHANNELS}, 1024]",
         torch.matmul, (x, wmat)),
        (f"raw 4-corner row gather ({gidx.numel()} rows)", torch.Tensor.__getitem__,
         (pyramid, gidx)),
    ]
    if cut:
        routes.append((f"crop_and_resize_grouped_mm (K5) on P4 {size // 16}², {cut} per image",
                       roi_ops.crop_and_resize_grouped_mm, (maps[2], p4_boxes, (7, 7))))
    return timed_rows(routes, reps, dev, dtype)


def bwd_inputs(batch: int, boxes: int, size: int, device, seed: int = 0,
               dtype: str = "float32"):
    """The ``bwd`` inputs of ``scripts/profile_window_bwd.py``: P2-P5 maps
    ([B, size/4 ... size/32, 256] of ``dtype``), ``B * boxes`` boxes clipped
    to the image, sorted by image, and their FPN levels."""
    maps, flat = stage_inputs(batch, boxes, size, device, seed, dtype)
    flat = flat.clamp(max=1.0)
    idx = torch.arange(batch, dtype=torch.int32, device=flat.device).repeat_interleave(boxes)
    level = (roi_ops.assign_fpn_level(flat, (size, size)) - 2).clamp(0, 3)
    return maps, flat, idx, level


def roi_align_fwd_bwd(maps, boxes, idx, level, crop, g):
    """K1 forward and K3 backward through ``roi_align`` and autograd: the
    gradient of ``sum(crops * g)`` with respect to each map."""
    with torch.enable_grad():
        leaves = [m.detach().requires_grad_() for m in maps]
        out = roi_ops.roi_align(leaves, boxes, idx, level, crop)
        return torch.autograd.grad(out, leaves, g)


def grid_sample_grad(sampled: torch.Tensor, p2: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The backward of a recorded ``grid_sample`` into ``p2``."""
    return torch.autograd.grad(sampled, p2, g, retain_graph=True)[0]


def grid_sample_backward_args(maps, boxes, crop, g):
    """(sampled, p2, g) for :func:`grid_sample_grad`: ``grid_sample`` of an
    NCHW copy of P2 at every box's crop, recorded, and the cotangent laid
    out as its output (boxes in image order)."""
    b, h2, w2, c = maps[0].shape
    n, (ch, cw) = boxes.shape[0], crop
    with torch.enable_grad():
        p2 = maps[0].permute(0, 3, 1, 2).contiguous().requires_grad_()
        sampled = F.grid_sample(p2, box_grid(boxes, crop, b).to(p2.dtype), mode="bilinear",
                                padding_mode="zeros", align_corners=True)
    gout = g.reshape(b, n // b * ch, cw, c).permute(0, 3, 1, 2).contiguous()
    return sampled, p2, gout


def bwd(batch: int = 8, boxes: int = 200, size: int = 1024, reps: int = 5,
        device=None, dtype: str = "bfloat16") -> List[Dict[str, object]]:
    """The ``bwd`` table: per crop size, K3 alone, K1 + K3 through autograd,
    the plain backward and ``grid_sample``'s backward."""
    dev = resolve_device(device)
    maps, flat, idx, level = bwd_inputs(batch, boxes, size, dev, dtype=dtype)
    shapes = [tuple(m.shape) for m in maps]
    rng = np.random.RandomState(1)
    routes = []
    for c in (7, 14):
        crop = (c, c)
        g = torch.from_numpy(rng.randn(flat.shape[0], c, c, CHANNELS).astype(np.float32)).to(
            dev, COMPUTE_DTYPES[dtype])
        routes += [
            (f"roi_align_bwd (K3) {c}x{c}", roi_ops.roi_align_bwd,
             (g, shapes, flat, idx, level, crop)),
            (f"roi_align fwd+bwd (K1+K3) {c}x{c}", roi_align_fwd_bwd,
             (maps, flat, idx, level, crop, g)),
            (f"multilevel_gather_bwd_plain {c}x{c}", roi_ops.multilevel_gather_bwd_plain,
             (g, shapes, flat, idx, level, crop)),
            (f"grid_sample backward into P2 {c}x{c} (yardstick)", grid_sample_grad,
             grid_sample_backward_args(maps, flat, crop, g)),
        ]
    return timed_rows(routes, reps, dev, dtype)


def window_origins(rng: np.random.RandomState, n: int, batch: int, size: int, sy: int,
                   sx: int) -> np.ndarray:
    """[n, 3] int32 origins (b, y0, x0 // 8) of windows that fit the map,
    x starting on a multiple of 8, as the JAX probe draws them."""
    return np.stack([rng.randint(0, batch, n), rng.randint(0, size - sy, n),
                     rng.randint(0, (size - sx) // 8 + 1, n)], axis=1).astype(np.int32)


def window_map(batch: int, size: int, device, seed: int = 0) -> torch.Tensor:
    rng = np.random.RandomState(seed)
    img = torch.from_numpy(rng.randn(batch, size, size, CHANNELS).astype(np.float32))
    return img.to(device=device, dtype=torch.bfloat16)


def row_gather_checksum(img: torch.Tensor, origins: torch.Tensor, rows: int) -> torch.Tensor:
    """The 4-corner row gather's traffic: per box, ``rows`` single [C] rows
    at scattered offsets from its origin, summed in float32 -> [N, C]."""
    b, h, w, c = img.shape
    o = origins.to(torch.int64)
    base = o[:, 0] * (h * w) + o[:, 1] * w + o[:, 2]
    offs = (torch.arange(rows, device=img.device) * 37) % (w * 7)
    vals = img.reshape(-1, c)[(base[:, None] + offs[None, :]).reshape(-1)]
    return vals.reshape(-1, rows, c).float().sum(1)


def window_cases(batch: int, size: int, boxes: int, device, sizes=WINDOW_SIZES):
    """The ``window`` sweep's inputs: the bfloat16 map, and (sy, sx, origins)
    per window size that fits it."""
    rng = np.random.RandomState(1)
    cases = [(sy, sx, torch.from_numpy(window_origins(rng, boxes, batch, size, sy, sx)).to(device))
             for sy, sx in sizes if sy < size and sx <= size]
    return window_map(batch, size, device), cases


def window(batch: int = 8, size: int = 256, boxes: int = 4096, reps: int = 5, device=None,
           sizes=WINDOW_SIZES) -> List[Dict[str, object]]:
    """The ``window`` table: K6 per window size, then the row gather."""
    dev = resolve_device(device)
    img, cases = window_cases(batch, size, boxes, dev, sizes)
    rng = np.random.RandomState(2)
    item = img.element_size()
    routes = [(f"window_sum (K6) {sy}x{sx}", window_sum, (img, o, sy, sx), sy * sx)
              for sy, sx, o in cases]
    for r in GATHER_ROWS:
        o = np.stack([rng.randint(0, batch, boxes), rng.randint(0, size - 8, boxes),
                      rng.randint(0, size - 8, boxes)], axis=1).astype(np.int32)
        routes.append((f"row_gather_checksum {r} rows", row_gather_checksum,
                       (img, torch.from_numpy(o).to(dev), r), r))
    rows = timed_rows([route[:3] for route in routes], reps, dev, "bfloat16")
    for row, (_, _, _, pixels) in zip(rows, routes):
        row["bytes"] = boxes * pixels * CHANNELS * item
        row["GB/s"] = row["bytes"] / row["ms"] / 1e6
    return rows


def fwd_boxes(batch: int, count: int, size: int, device, seed: int = 0):
    """``count`` normalised boxes per image clustered as :func:`nms_inputs`
    draws proposals, in image order: boxes [batch * count, 4] float32, their
    image indices [batch * count] int32 and FPN levels (0-based, int32)."""
    pixels, _ = nms_inputs(batch, count, size, "cpu", seed)
    flat = (pixels[:, :count] / size).reshape(-1, 4)
    idx = torch.arange(batch, dtype=torch.int32).repeat_interleave(count)
    level = roi_ops.assign_fpn_level(flat, (size, size)) - 2
    return flat.to(device), idx.to(device), level.to(device)


def fwd(batch: int = 2, boxes: Optional[int] = None, size: int = 1024, reps: int = 5,
        device=None, seed: int = 0, dtype: str = "bfloat16") -> List[Dict[str, object]]:
    """The ``fwd`` table: per call of the model's (the inference path's two,
    or at batch 4 the train step's two and its three big-set crops), K1 (K4
    for a big-set crop), its plain version and ``grid_sample`` over the
    call's first map for the same boxes."""
    dev = resolve_device(device)
    maps, _ = stage_inputs(batch, 0, size, dev, seed, dtype)
    train = batch == 4
    count = boxes or (200 if train else 1000)
    flat, idx, level = fwd_boxes(batch, count, size, dev, seed)
    n = flat.shape[0]
    grid_sample = functools.partial(F.grid_sample, mode="bilinear", padding_mode="zeros",
                                    align_corners=True)
    routes = []
    if train:
        calls = [(f"{c}x{c} on {n} RoIs over P2-P5", maps, flat, idx, level, c) for c in (7, 14)]
        grouped = flat.reshape(batch, count, 4)
        k4, k4_plain = (functools.partial(fn, crop_size=(14, 14), positions="xla") for fn in (
            roi_ops.crop_and_resize_grouped, roi_ops.crop_and_resize_grouped_plain))
        for p in (2, 3, 4):
            label = f"14x14 on {n} RoIs, P{p} alone (big set)"
            routes += [(f"crop_and_resize_grouped (K4) {label}", k4, (maps[p - 2], grouped)),
                       (f"crop_and_resize_grouped_plain {label}", k4_plain,
                        (maps[p - 2], grouped)),
                       (f"F.grid_sample {label} (yardstick)", grid_sample,
                        (maps[p - 2].permute(0, 3, 1, 2),
                         box_grid(flat, (14, 14), batch).to(maps[0].dtype)))]
    else:
        dets = fwd_boxes(batch, min(100, count), size, dev, seed + 1)
        calls = [(f"7x7 on {n} proposals over P2-P5", maps, flat, idx, level, 7),
                 (f"14x14 on {dets[0].shape[0]} detections over P2-P5", maps, *dets, 14)]
    for label, m, bx, bi, lvl, c in calls:
        args = (m, bx, bi, lvl, (c, c))
        routes += [(f"roi_align_fwd (K1) {label}", roi_ops.roi_align_fwd, args),
                   (f"multilevel_gather_plain {label}", roi_ops.multilevel_gather_plain, args),
                   (f"F.grid_sample {label.split(' over ')[0]}, first map (yardstick)",
                    grid_sample, (m[0].permute(0, 3, 1, 2),
                                  box_grid(bx, (c, c), batch).to(m[0].dtype)))]
    return timed_rows(routes, reps, dev, dtype)


def nms_inputs(batch: int, boxes: int, size: int, device, seed: int = 0, classes: int = 0):
    """Score-sorted boxes [B, N, 4] float32 (N = ``boxes`` padded to a
    multiple of 64) and valid [B, N] bool for ``nms_alive``: the first
    ``boxes`` rows of each image are valid, the padding is the zero box. The
    boxes lie in clusters of about ``NMS_BOXES_PER_CLUSTER``, each a cluster
    box (sides 2-30% of ``size``) with its centre and sides jittered by
    ``NMS_JITTER`` of its sides, clipped to the image; the row order stands
    for the score order. With ``classes``, each box gets a class in
    1..classes and moves to that class's island as ``class_aware_nms``
    moves it."""
    rng = np.random.RandomState(seed)
    k = max(1, boxes // NMS_BOXES_PER_CLUSTER)
    centre = rng.uniform(0, size, (batch, k, 2))
    sides = size * np.exp(rng.uniform(np.log(0.02), np.log(0.3), (batch, k, 2)))
    which = rng.randint(0, k, (batch, boxes))
    b = np.arange(batch)[:, None]
    hw = sides[b, which] * np.exp(rng.normal(0, NMS_JITTER, (batch, boxes, 2)))
    mid = centre[b, which] + rng.normal(0, NMS_JITTER, (batch, boxes, 2)) * sides[b, which]
    box = np.concatenate([mid - hw / 2, mid + hw / 2], -1).clip(0, size).astype(np.float32)
    if classes:
        cls = rng.randint(1, classes + 1, (batch, boxes, 1)).astype(np.float32)
        span = np.abs(box).max(axis=(1, 2), keepdims=True) + np.float32(2.0)
        box = box + cls * span * np.float32(4.0)
    n = -(-boxes // nms_ops.TILE) * nms_ops.TILE
    padded = np.zeros((batch, n, 4), np.float32)
    padded[:, :boxes] = box
    valid = np.zeros((batch, n), bool)
    valid[:, :boxes] = True
    return torch.from_numpy(padded).to(device), torch.from_numpy(valid).to(device)


def nms(batch: int = 2, boxes: int = 6000, size: int = 1024, reps: int = 5, device=None,
        seed: int = 0) -> List[Dict[str, object]]:
    """The ``nms`` table: per call of the inference path, K2 and its plain
    version on the same tensors; each row also holds ``kept``, the boxes
    that K2's alive mask keeps."""
    dev = resolve_device(device)
    routes = []
    for label, count, thr, classes in NMS_CALLS:
        bx, va = nms_inputs(batch, min(count or boxes, boxes), size, dev, seed, classes)
        shape = f"[{batch}, {bx.shape[1]}] thr {thr}"
        routes += [(f"nms_alive (K2) {label} {shape}", nms_ops.nms_alive, (bx, va, thr)),
                   (f"greedy_alive_sorted_plain {label} {shape}",
                    nms_ops.greedy_alive_sorted_plain, (bx, va, thr))]
    rows = timed_rows(routes, reps, dev, "float32")
    with torch.no_grad():
        for r in rows:
            r["kept"] = int(r["fn"](*r["args"]).sum())
    return rows


# what the profiler's trace records of each kernel launch, as kernel_trace names it
TRACE_ARGS = {"grid": "grid", "block": "block", "registers": "registers per thread",
              "shared_bytes": "shared memory", "blocks_per_sm": "blocks per SM",
              "occupancy_pct": "est. achieved occupancy %"}


def kernel_trace(fn: Callable[[], object], reps: int, device) -> Dict[str, object]:
    """Where a call of ``fn`` spends its time on the card, after a warm-up
    call: ``host_ms``, the host clock's time to enqueue one call (the mean
    of ``reps`` calls, no synchronisation between them; the card is the
    limit where its kernels take longer), and ``kernels``, the device
    kernels of ``reps`` calls under ``torch.profiler``, one row per kernel
    name, largest time first: ``launches`` and ``ms`` per call of ``fn``
    (from ``key_averages``), and the ``TRACE_ARGS`` of its last launch in
    the profiler's Chrome trace (written under the repository's ``build/``
    and removed), ``None`` where the trace lost it. The profiler records
    the second of two cycles of ``reps`` calls: in a process that has
    profiled before, a first short cycle can miss its device kernels.
    ``None`` and no kernels off the card."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"host_ms": None, "kernels": []}
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize(dev)
    recorded = {}

    def ready(prof):
        recorded["averages"] = prof.key_averages()
        prof.export_chrome_trace(recorded["path"])

    cuda_build.BUILD_DIR.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=cuda_build.BUILD_DIR.parent) as tmp, \
            warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*Profiler clears events")
        recorded["path"] = os.path.join(tmp, "trace.json")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1), on_trace_ready=ready) as prof:
            for _ in range(2):
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize(dev)
                prof.step()
        with open(recorded["path"]) as f:
            events = json.load(f)["traceEvents"]
    rows: Dict[str, Dict[str, object]] = {}
    for e in recorded["averages"]:
        # device kernels only: the aten ops above them carry their time again
        if (e.device_type == DeviceType.CUDA and not e.key.startswith("aten::")
                and not getattr(e, "is_user_annotation", False)
                and e.self_device_time_total > 0):
            rows[e.key] = {"name": e.key, "launches": e.count / reps,
                           "ms": e.self_device_time_total / 1e3 / reps,
                           **dict.fromkeys(TRACE_ARGS)}
    for e in events:
        if e.get("cat") == "kernel" and e.get("name") in rows:
            rows[e["name"]].update({k: e.get("args", {}).get(v) for k, v in TRACE_ARGS.items()})
    return {"host_ms": host_ms, "kernels": sorted(rows.values(), key=lambda r: -r["ms"])}


def print_trace(trace: Dict[str, object]) -> None:
    """Print a :func:`kernel_trace`, one line per kernel."""
    if trace["host_ms"] is None:
        print("    no device kernels (not measured off the card)")
        return
    print(f"    host {trace['host_ms']:.4f} ms to enqueue one call")
    if not trace["kernels"]:
        print("    the profiler recorded no device kernel")
    for k in trace["kernels"]:
        print(f"    {k['ms']:10.4f} ms  {k['launches']:g} launches  grid {k['grid']} "
              f"block {k['block']}  {k['registers']} registers  {k['shared_bytes']} B shared  "
              f"{k['blocks_per_sm']} blocks/SM  occupancy est. {k['occupancy_pct']}%  "
              f"{k['name'][:80]}")


def device_name(device) -> str:
    dev = torch.device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu (host clock)"


def print_table(title: str, rows: List[Dict[str, object]], device) -> None:
    print(f"{title} on {device_name(device)}")
    for r in rows:
        extra = ""
        if "bytes" in r:
            extra = f"  {r['bytes']:>13,} B  {r['GB/s']:8.1f} GB/s"
        elif "kept" in r:
            extra = f"  kept {r['kept']}"
        print(f"  {r['route']:64s} {r['dtype']:9s} {r['ms']:10.4f} ms{extra}")


def main(argv: Optional[Sequence[str]] = None) -> List[Dict[str, object]]:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("command", choices=["crop", "stage", "window", "bwd", "nms", "fwd"])
    p.add_argument("--batch", type=int, default=None)
    p.add_argument("--boxes", type=int, default=None,
                   help="boxes per image (crop, stage, bwd), windows (window) or "
                   "proposals per image (nms, fwd)")
    p.add_argument("--size", type=int, default=None,
                   help="map (crop, window) or image (stage, bwd, nms, fwd) side")
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--seed", type=int, default=0, help="the boxes' seed (nms, fwd)")
    p.add_argument("--dtype", default="bfloat16", choices=sorted(COMPUTE_DTYPES),
                   help="the maps' dtype (crop, stage, bwd, fwd)")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    p.add_argument("--trace", action="store_true",
                   help="print each route's device kernels from torch.profiler")
    args = p.parse_args(argv)
    fn = {"crop": crop, "stage": stage, "window": window, "bwd": bwd, "nms": nms,
          "fwd": fwd}[args.command]
    kwargs = {k: v for k, v in (("batch", args.batch), ("boxes", args.boxes),
                                ("size", args.size)) if v is not None}
    if args.command in ("nms", "fwd"):
        kwargs["seed"] = args.seed
    if args.command in ("crop", "stage", "bwd", "fwd"):
        kwargs["dtype"] = args.dtype
    device = resolve_device(args.device)
    rows = fn(reps=args.reps, device=device, **kwargs)
    print_table(args.command, rows, device)
    if args.trace:
        with torch.no_grad():
            for r in rows:
                print(f"  {r['route']} kernels per call:")
                r["trace"] = kernel_trace(lambda: r["fn"](*r["args"]), args.reps, device)
                print_trace(r["trace"])
    return rows


if __name__ == "__main__":
    main()
