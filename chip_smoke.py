#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one GPU and check its CUDA kernels.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, each of which must pass:

1. environment: torch, CUDA, nvcc and the card's name and power limit;
2. build: every CUDA source of the port compiled with nvcc (in parallel);
3. main path: the flagship recipe (R101-FPN, Dev on, UPSAMPLE_FAC 1.0, 81
   classes, 1024², 6000 pre-NMS, 1000 proposals, 100 detections) with seeded
   random weights runs ``detect()`` on two synthetic 480×640 images. Every
   kernel's launch counter is set to 0 just before that call and read just
   after: the RoIAlign kernel must launch twice (classifier and mask
   pooling) and the NMS kernel at least twice (proposals and detections);
4. kernels: each kernel's wrapper runs again on the tensors the main path
   gave it and is held against its plain PyTorch version on the same
   tensors: RoIAlign within 1e-5 and bit-equal over two launches, also one
   float at a time (3 and 6 channels, a 256-channel P2 4 bytes off a
   16-byte boundary), at crops 1² and 5x9, on boxes out of range and
   inverted with extrapolation -1.5, on one box at 14² (its rows in
   several blocks) and at 2,048 channels; NMS bit for bit and bit-equal
   over two launches, also on tie-heavy and padded cases, on boxes all
   disjoint (all kept) and on copies of one box (one kept) at the
   proposal shape, on the eval batch's [8, 6016] and on [1, 16384], whose
   tiles the NMS sweep cannot stage whole in shared memory; each is timed
   beside its plain version, its bound and a PyTorch yardstick, and both
   kernels' launches on the main path's calls are traced (torch.profiler);
5. breakdown: the forward's device time by kernel family (torch.profiler)
   and the device's busy share, reported and not checked;
6. train path: the flagship recipe trained through ``Trainer`` and
   ``train_model``, stages heads, 4+ and all of one epoch each over 8
   synthetic 1024² images at batch 4 (6 steps). The counters are set to 0
   before the run and read after it: per step the RoIAlign forward launches
   twice (7² and 14² on the make-up maps), the grouped crop K4 three times
   (the 14² big-set crop of P2, P3 and P4, with the jitted JAX crop's
   sample positions), the RoIAlign backward twice and the NMS kernel at
   least once. Losses must be finite, frozen parameters bit-equal,
   trainable ones moved, one step must have positive RoIs and a non-zero
   meta loss, and a fresh Trainer must restore the same weights, momentum
   and buffer from the newest checkpoint. Every NMS and K4 call of the six
   steps is held bit for bit against its plain version. Then the step time
   per stage (median of 5), the peak memory and one 'all' step's device
   time by kernel family;
7. kernel_roi_align_bwd: the RoIAlign backward replayed on the last train
   step's cotangents, then on two crowds at the train step's shapes (800
   slots of which 740 are the zero box; 200 distinct boxes of one image
   around one object), at 7² and 14²: each within 1e-5 of its plain version
   relative to the largest gradient, bit-equal over two launches, its work
   plan equal to the plain plan, timed beside its plain version, its bytes
   bound and grid_sample's backward; per train step it must beat
   grid_sample's backward. Then the per-pass device time of the two
   calls; the RoIAlign forward on that step's two poolings, within 1e-5 of
   its plain version, timed and traced; K4 on its three big-set crops,
   bit-equal to its plain version and over two launches, timed beside its
   plain version, its bytes bound and grid_sample on the same maps and
   boxes, and traced (K4's entry in the kernel line is this, per step);
   bwd_sweep: the ``bwd`` sweep of ``tools/profile_roi.py`` (B=8, 200
   random boxes per image over P2-P5 of 1024², 7² and 14²), on the timed
   tensors K3 held as above and K1 + K3 through autograd against the plain
   backward and bit-equal over two runs; K3's per-pass device time;
8. reference: a small model runs on the card and on the CPU (plain
   versions) from the same weights and two 128² images; the pyramid, and
   the detections of the second stage fed the same proposals (at least
   one), must agree; then
   one train step from the same weights, batch, draws and proposals: losses
   within 1e-4 relative, parameters within 1e-5, the buffer within 1e-4;
9. roi_single: the ``crop`` sweep (B=8, 1024 boxes per image, 256² x 256,
   7²) and the ``stage`` sweep at B=8 of ``tools/profile_roi.py``, their
   launches counted from 0; then, on the very tensors each sweep timed, K4
   and K5 at the ``crop`` shapes (bit-equal, also over two launches), K5
   on the ``stage`` P4 map (also timed beside its bound, plain version and
   grid_sample) and K1 at its 7² and 14² poolings against their plain
   versions within 1e-5, K4 with
   extrapolation -1.5 on out-of-range and inverted boxes, and the gradient
   of ``crop_and_resize_fused`` on the card against the CPU's within 1e-5
   of its largest value, on the sweep's maps and on a 3-channel image of
   odd width (map rows that are not 16-byte aligned); K4 (extrapolation 0
   and -1.5) and K5 bit-equal to their plain versions and over two
   launches at crops 7², 1² and 5x9: one float at a time (that image, a
   6-channel map, a 256-channel map 4 bytes off a 16-byte boundary), on a
   ragged last block, on no boxes and on a box whose rows span two blocks;
   K3 on a 2,048-channel map (two channel chunks): the fused gradient card
   against CPU within 1e-5 of its largest value, and bit-equal to one call
   per half of the channels; K4's and K5's launches at the crop shapes, and
   K5's at the stage shapes, under torch.profiler (registers, shared
   memory, estimated occupancy);
10. window_probe: the ``window`` sweep (K6 on a [8, 256, 256, 256] bf16 map
   at 4096 windows of 8x8 to 64x64), each size bit-equal to its plain
   version on the timed map and origins and over two launches, beside its
   bytes bound, its adds bound (one issue slot per fp32 add) and its share
   of the larger; then K6 bit-equal likewise on windows out of the map,
   repeated origins, a group over two images, sx 5 and 12, a float32 map
   whose rows are staged in pieces, C = 66, a map 4 bytes off an 8-byte
   boundary (two channels per thread) and no windows, staged and read
   directly; and K6's kernels under torch.profiler at 8x8 and 64x64;
11. eval_path: ``test_model`` (bbox and segm) with the flagship model over
   16 synthetic images, counted from 0: K1 twice and K2 at least twice per
   batch of TEST.BATCH_SIZE, every call held against its plain version on
   its own tensors; the 12 bbox and 12 segm stats, images per
   second and the device time of one batch's ``detect()``; then a small
   model evaluates on the card and on the CPU (fed the card's proposals):
   the same detections (boxes within 1 px, scores within 1e-4) and stats
   within 0.02;
12. bf16_main_path: the flagship in bfloat16 (float32 parameters, as the
   JAX ``main.py`` builds it under the default ``TPU.COMPUTE_DTYPE``) runs
   ``detect()``, counted from 0: K1 twice, K2 at least twice; outputs
   checked as in 3; each K1 call on bfloat16 maps bit-equal to its plain
   version and over two launches, timed beside the float32 kernel on the
   widened maps and the widening and rounding copies; ``detect()`` and
   ``forward_inference`` paired with float32 in turns; both forwards' device
   time by family, and the bfloat16 forward's costliest aten ops;
13. bf16_train_path: one 'all' stage of 2 steps in bfloat16 through
   ``train_model``: per step K1 2, K4 3, K3 2, K2 at least 1 launches;
   finite losses, positives and a meta loss; parameters, BN statistics,
   momentum, buffer and checkpoint float32; K1 and K4 bit-equal and K3
   within one bfloat16 rounding of their plain versions on the steps'
   tensors, with
   their copies' time; the 'all' step paired with float32 in turns; both
   steps' device time by family and their costliest aten ops;
14. bf16_eval_path: ``test_model`` in bfloat16 over 16 images under
   cProfile (K1 2 and K2 at least 2 launches per batch): the host's share
   outside ``detect()`` and the host functions that take it; ``detect()``
   of a batch of 8 paired with float32; both breakdowns;
15. bf16_reference: a small model in bfloat16 on the card against the CPU
   (pyramid, class probabilities and box deltas on the same proposals; one
   train step's losses, buffer and parameter updates), held to the CPU's
   own bfloat16 error (the CPU in bfloat16 against the CPU in float32);
16. ot_train_path: configs/104/meta_104_conv.yaml (the OT meta loss, conv
   form) with the FPN OT loss, at full width (R101-FPN, 1024², batch 4,
   200 RoIs per image, 81 classes), one 'all' stage of 2 steps through
   ``train_model`` in float32, then one in bfloat16: per step K1 2, K4 3,
   K3 2 and K2 at least 1 launches, finite losses, meta and FPN OT losses,
   the FPN OT loss positive, the buffer moved, K4 bit-equal to its plain
   version; the 'all' step in both dtypes in turns and in bfloat16 with and
   without the FPN OT in turns; each step's device time by family and the
   device time spanned by the OT modules' and the Sinkhorn loop's forward;
17. ot_reference: a small model with the OT meta loss (conv form with the
   FPN OT; fc form), one float32 train step card against CPU: losses within
   1e-4 relative (the meta loss within 1e-4 of its terms' magnitudes),
   parameters within 1e-5 plus what the meta loss moved them by (its
   gradient through the 1-D normalisation is rounding noise), the buffer
   within 1e-4.
18. dev_up2_merge_path: the flagship with ``DEV.UPSAMPLE_FAC 2.0`` (the
   make-up layer a 3x3 stride-2 transposed conv, maps of twice the side)
   and ``DEV.CLS_MERGE_FEAT`` (simple_add) at full width: ``detect()`` in
   float32 and bfloat16, counted from 0: K1 3 per forward (the 7²
   classifier, the 14² critic and the 14² mask pooling), K2 at least 2,
   each K1 call bit-equal to its plain version and over two launches; the
   forward paired with the factor-1 flagship's in turns; one 'all' stage of
   2 steps in bfloat16: per step K1 2, K4 3, K3 2, K2 at least 1, finite
   losses, the critic and the make-up layer moved, K1 and K4 bit-equal, K3
   on the last step's cotangents within 1e-5 of its plain version and
   bit-equal over two launches, timed beside its bytes bound, its plain
   version and grid_sample's backward; the step
   paired with the factor-1 flagship's; then two small models card against
   CPU (``MULTI_UPSAMPLER`` + ``UPSAMPLE_RESIDUAL`` + ``UPSAMPLE_INIT
   identity`` + linear_add at factor 2; ``DIS_UPSAMPLER`` with the merge):
   the second stage on the same proposals and one float32 train step, to
   the tolerances of 8.
19. train_options_path: the flagship recipe at full width in bfloat16
   under each of two option sets of ROADMAP A5, one 'all' stage of 2 steps
   through ``Trainer``: A (``TRAIN.OPTIM_METHOD adam``, ``TRAIN.BN_LEARN``,
   ``DEV.BIG_SUPERVISE``, ``DEV.BIG_FEAT_DETACH False``, ``DEV.BIG_FC_INIT
   coco_pretrain``) and B (``TRAIN.OPTIM_METHOD rmsprop``,
   ``DEV.DIS_REG_LOSS``, ``DEV.BASELINE``), counted from 0: per step under A
   K1 2, K4 3, K3 5 of which 3 in its ``xla`` mode (the big-set crops'
   gradient into P2-P4), K2 at least 1; under B K1 2, K4 0, K3 2, K2 at
   least 1; finite losses, A's big loss, B's regression losses 0, every BN
   statistic moved under A, big_fc seeded from the classifier, every K4
   call bit-equal to its plain version; K3's ``xla`` mode on the last
   step's three big-set cotangents (widened to float32) within 1e-5 of its
   plain version in float64 and of the autograd of
   ``crop_and_resize_grouped_plain(..., positions="xla")``, bit-equal over
   two launches, its plan the plain plan, timed beside its plain version,
   its bytes bound and grid_sample's backward (its entry in the kernel
   line); each set's peak memory; each set's step paired with the
   flagship's SGD step in turns, and its device time by kernel family; then
   each set on a small float32 model card
   against CPU: losses within 1e-4 relative, the buffer within 1e-4, BN
   running statistics within 1e-4, the parameters within 1e-5 of those the
   CPU's optimizer gives from the card's gradients, and the optimizer's
   ``mu`` and ``nu``: under B (as its root) within 1e-5, under A (BN
   learning makes these gradients ill-conditioned at this size, ROADMAP §C)
   as one vector within 1e-5 of its norm plus four times the CPU's own
   float32 error.
20. assign_roipool_path: the flagship at full width in bfloat16 under
   set C (``DEV.ASSIGN_BOX_ON_ALL_SCALE`` with ``RPN.ANCHOR_STRIDE 2``) and
   set D (``ROIS.METHOD roi_pool``), counted from 0: ``detect()`` of the two
   images (C: K1 2, D: K1 0; K2 at least 2; K1 and K2 bit-equal to their
   plain versions) and one 'all' train step (C: K1 2, K4 4 (the reliable
   sets of P2-P5), K3 2; D: no K1, K4 or K3; K2 at least 1), finite losses
   and outputs; under C every K4 call bit-equal to its plain version, the
   P5 call timed beside its float32 kernel, plain version and bound, K3
   within one bfloat16 rounding; both sets' ``detect()`` and step paired in
   turns with the flagship's (medians of 4), the peak memory of each, set
   D's step by kernel family and aten op; then each set on a small model
   card against CPU, to the tolerances of 8.
21. visualize_pretrained_path: from the seeded flagship (float32) a
   reference ``.pth`` payload (weights, buffer, counters), the converter
   command line's npz of it and, where h5py is present, a keras ``.h5``;
   ``python -m feature_intertwiner_tpu_torch.main --phase visualize
   --synthetic_data`` at full width in bfloat16, started from the npz and
   counted from 0: K1 1 and K2 at least 2 per image, ``features.npz`` with
   the JAX phase's keys, shapes and dtypes, finite, zero on exactly the
   padding rows; in float32 the visualize detections equal ``detect()``'s
   on the two images, and that batch's K1 and K2 calls held against their
   plain versions, timed beside their bounds (their ``_visualize`` entries
   in the kernel line, launches from the command line's run); the
   visualize forward and ``detect()`` of one image paired in bfloat16 and
   float32; a fresh model resumed from each file on the card through
   ``Trainer.resume`` equal to the seeded one in every tensor and in its
   detections (the payload's buffer and counters restored); ``TEST.SAVE_IM``
   on 2 images where matplotlib is present (what ran is logged, and which
   of matplotlib, h5py and PIL the machine has); ``tsne_embed`` over the
   dumped features timed.
22. coco_disk_path: the synthetic set written to disk in the COCO layout
   by the port's writer (8 1024² images, minival and a train split of the
   same images); one epoch of the train loader in process and on two
   thread and two process workers, bit-equal; ``python -m
   feature_intertwiner_tpu_torch.main --phase train --data_root`` in
   bfloat16, one 'all' stage of 2 steps at batch 4 on two process workers
   under ``CTRL.PROFILE_ANALYSIS``, started from a ``.pth`` of the tempered
   seeded model (4 classes) and counted from 0: per step K1 2, K4 3, K3 2,
   K2 at least 1, finite losses, the ``[profile]`` fetch and step totals
   logged; ``--phase inference --data_root`` from its checkpoint over the 8
   minival images: K1 1 and K2 at least 2, detections and 12 finite bbox
   stats; then the ``LOADER`` line: ms per 1024² batch of 4 over a
   16-image set in process and on 2 workers of each mode.
23. data_parallel_path: the port of the JAX ``shard_map`` step
   (``parallel/data_parallel.py``) at flagship width in bfloat16, 'all'
   stage, 2 steps of a global batch of 4 over the train path's 8
   synthetic 1024² images written as COCO files (``CTRL.QUICK_VERIFY``),
   from a ``.pth`` of the tempered seeded model: ``torchrun --standalone
   --nproc_per_node 1`` of this script's ``--dp-worker`` rank, which runs
   ``python -m feature_intertwiner_tpu_torch.main --phase train
   --data_root`` on NCCL: per step K1 2, K4 3, K3 2, K2 at least 1, finite losses, the
   state (weights, BN statistics, buffer) bit-equal to the same run without
   a group; two gloo ranks sharing the card, 2 images each: the same
   launches per rank, both ranks' states bit-equal, rank 0's last K3 calls
   within one bfloat16 rounding of their plain version, each rank's step
   ms, gradient all-reduce ms and peak memory beside the NCCL rank's; then
   in the same ranks the small model's step over the ranks on the card
   against the CPU, to the tolerances of 8.
``roi_single`` also runs the ``crop`` sweep on a bfloat16 map (K4 and K5
bit-equal to their plain versions), and ``window_probe`` K6 on C = 3 and
on a map one channel off a pair (one channel a lane).

Phases 1-11 run float32: TF32 is switched off for cuDNN convolutions and
for matmuls. The last three lines are a JSON object with one entry per kernel,
the card's name and power limit from ``nvidia-smi``, and
``{"ok": true, "device": {...}}``. Any failed phase exits non-zero without
them.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))

H100_BYTES_PER_S = 3.35e12      # HBM3, SXM data sheet
H100_FP32_OPS_PER_S = 67e12     # fp32 outside the tensor cores
# fp32 adds outside the tensor cores: an add takes one issue slot of a lane,
# 132 SMs x 128 lanes x 1.98 GHz (the 67e12 above counts an FMA as two)
H100_FP32_ADDS_PER_S = 33.5e12
# fp32 operations of greedy NMS, counted on ops/nms.py::_pairwise_iou with
# each box's area computed once: per pair 4 max/min, 4 sub/add (the two
# extents), 2 clamps, 1 mul (intersection), 2 add/sub (union), 1 div and the
# threshold compare; per box 2 sub, 2 add and 1 mul (its area)
IOU_OPS_PER_PAIR = 4 + 4 + 2 + 1 + 2 + 1 + 1
AREA_OPS_PER_BOX = 2 + 2 + 1
ROI_OPS_PER_VALUE = 6           # three lerps of one pooled value
# K4 and K5 per crop value: the y lerp of two tap columns (3 each), then
# the 2-tap x product (1 - fx, two multiplies, one add)
K45_OPS_PER_VALUE = 3 + 3 + 4
EPS32 = 2.0 ** -23              # float32 machine epsilon
# the RoIAlign gradient per valid sample and channel: a = g ly and g - a,
# then per tap row p lx and p - p lx, and the four adds into the map
ROI_BWD_OPS_PER_VALUE = 2 + 4 + 4
# the passes of csrc/roi_align_bwd.cu, by kernel name, for its breakdown
BWD_PASSES = {p: (f"roi_align_bwd_{p}",)
              for p in ("taps", "bin", "count", "scan", "list", "accumulate", "fold")}
# The synthetic training set of the train path (data/synthetic.py): 1024²
# canvases, so that molding neither scales nor pads them, with up to 24
# instances of 30-512 px each, so that the random model's proposals meet
# some of them at IoU 0.5 on FPN levels 3 to 5, where one positive RoI feeds
# both the small set of its level and the reliable set of the level below
TRAIN_DATA = dict(seed=0, size=(1024, 1024), max_instances=24)
# the small model of the card-against-CPU checks
SMALL_OPTS = ["MODEL.BACKBONE", "resnet50", "DATASET.NUM_CLASSES", "8",
              "DATA.IMAGE_MIN_DIM", "96", "DATA.IMAGE_MAX_DIM", "128",
              "RPN.ANCHOR_SCALES", "(8, 16, 32, 64, 128)", "RPN.PRE_NMS_LIMIT", "200",
              "RPN.POST_NMS_ROIS_INFERENCE", "48", "TEST.DET_MAX_INSTANCES", "8",
              "ROIS.TRAIN_ROIS_PER_IMAGE", "24"]
# configs/104/meta_104_conv.yaml as options (the card's machine has no
# PyYAML; tests/test_torch_ot_train.py holds the two equal): the flagship
# with the OT meta loss, conv form
OT_RECIPE = ["TRAIN.LR_WARM_UP", "False", "TRAIN.CLIP_GRAD", "True", "TRAIN.END2END", "False",
             "TRAIN.BATCH_SIZE", "4", "DEV.SWITCH", "True", "DEV.BUFFER_SIZE", "1",
             "DEV.LOSS_CHOICE", "ot", "DEV.OT_ONE_DIM_FORM", "conv", "DEV.LOSS_FAC", "10.0",
             "DEV.STRUCTURE", "beta", "DEV.UPSAMPLE_FAC", "1.0"]
# the training options of ROADMAP A5 as two option sets (train_options_path)
OPTION_SETS = {
    "A": ["TRAIN.OPTIM_METHOD", "adam", "TRAIN.BN_LEARN", "True", "DEV.BIG_SUPERVISE", "True",
          "DEV.BIG_FEAT_DETACH", "False", "DEV.BIG_FC_INIT", "coco_pretrain"],
    "B": ["TRAIN.OPTIM_METHOD", "rmsprop", "DEV.DIS_REG_LOSS", "True", "DEV.BASELINE", "True"],
}
# ROADMAP A6 and A7 as two option sets (assign_roipool_path): C, the
# all-scale RoI levels (meta levels 2-5, RoIs too big for every level on
# level 6) with one anchor every second cell; D, RoIPool for the heads and
# the reliable sets
ASSIGN_SETS = {
    "C": ["DEV.ASSIGN_BOX_ON_ALL_SCALE", "True", "RPN.ANCHOR_STRIDE", "2"],
    "D": ["ROIS.METHOD", "roi_pool"],
}
# the kernels a train step launches, by their launch counters
TRAIN_KERNELS = ("roi_align_fwd", "crop_and_resize_grouped", "roi_align_bwd", "nms_alive")
# Output-conv scales of P2, P3 and P4 for the train path's random model:
# its P2 objectness spreads about 3x wider than the other levels', so that
# untempered every one of the 1000 proposals is a 32-px P2 anchor and no
# RoI is positive
TRAIN_FPN_SCALES = {2: 0.1, 3: 0.2, 4: 0.5}


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond, msg: str) -> None:
    """A check that fails its phase (and holds under ``python -O``)."""
    if not cond:
        raise AssertionError(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else out.stderr.strip()


def synthetic_images(seed: int, n: int = 2, h: int = 480, w: int = 640):
    """Smooth backgrounds with a few flat-coloured rectangles, uint8."""
    import numpy as np

    rng = np.random.RandomState(seed)
    images = []
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    for _ in range(n):
        base = rng.uniform(40, 200, 3)
        grad = rng.uniform(-0.1, 0.1, (2, 3))
        img = base + yy[..., None] * grad[0] + xx[..., None] * grad[1]
        for _ in range(6):
            y1, x1 = rng.randint(0, h - 40), rng.randint(0, w - 40)
            y2 = min(h, y1 + rng.randint(30, h // 2))
            x2 = min(w, x1 + rng.randint(30, w // 2))
            img[y1:y2, x1:x2] = rng.uniform(0, 255, 3)
        img += rng.normal(0, 4, img.shape)
        images.append(np.clip(img, 0, 255).astype(np.uint8))
    return images


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean time of one call, from CUDA events around ``reps`` calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def seeded_model(build_model, cfg, seed, device=None, dtype=None):
    """The port's seeded random weights (Xavier-uniform convs, Xavier-normal
    transposed convs, N(0, 0.01) dense, BN at identity) in a model computing
    in ``dtype`` (default float32), tempered so that the proposals fall on the
    images as a trained model's do: the last BN scale of every bottleneck is
    0.1 (with BN at identity nothing normalises the residual stack), and the
    RPN's class and box convs are scaled by 0.1. Untempered, the saturated
    random objectness ranks the constant padding band of the molded 1024²
    canvas first, every proposal lies there, every detection is clipped to
    zero area by the image window, and the mask pass pools nothing."""
    import torch
    from feature_intertwiner_tpu_torch.models.resnet import Bottleneck

    model = build_model(cfg, device=device, seed=seed, dtype=dtype or torch.float32)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, Bottleneck):
                m.bn3.weight.fill_(0.1)
        model.rpn.conv_class.weight.mul_(0.1)
        model.rpn.conv_bbox.weight.mul_(0.1)
    return model


def temper_fpn(model):
    """Scale the P2-P4 FPN output convs by ``TRAIN_FPN_SCALES``."""
    import torch

    with torch.no_grad():
        for level, scale in TRAIN_FPN_SCALES.items():
            conv = getattr(model.fpn, f"P{level}_conv2")[1]
            conv.weight.mul_(scale)
            conv.bias.mul_(scale)
    return model


def greedy_pairs(nms_ops, boxes, valid, alive, thr, plus_one, strict) -> int:
    """The IoUs greedy NMS must compute on this data: each kept box i
    against every later valid box j that no kept box before i has removed,
    that is, whose first kept suppressor s(j) is i or later. Counted per
    image from the full suppression matrix of the plain IoU."""
    import torch

    n = boxes.shape[1]
    idx = torch.arange(n, device=boxes.device)
    none = torch.tensor(n, device=boxes.device)
    total = 0
    for b in range(boxes.shape[0]):
        supp = nms_ops._suppresses(nms_ops._pairwise_iou(boxes[b], boxes[b], plus_one), thr, strict)
        supp &= (idx[:, None] < idx[None, :]) & alive[b, :, None]
        first = torch.where(supp, idx[:, None], none).amin(0)      # s(j), n if none
        kept_upto = alive[b].long().cumsum(0)                       # kept boxes in [0, i]
        kept_before = kept_upto - alive[b].long()
        count = torch.where(first == n, kept_before, kept_upto[first.clamp_max(n - 1)])
        total += int(count[valid[b]].sum())
    return total


def nms_bound(nms_ops, calls):
    """The least time of K2 over ``calls`` [(boxes, valid, alive, thr,
    opts)]: (IoU pairs, fp32 operations, bytes, ms by operations, ms by
    bytes). The operations are each needed pair's IoU and each valid box's
    area; the bytes each box and valid flag read once, each alive flag
    written once."""
    pairs = n_ops = nbytes = 0
    for boxes, valid, alive, thr, opts in calls:
        p = greedy_pairs(nms_ops, boxes, valid, alive, thr, **opts)
        pairs += p
        n_ops += p * IOU_OPS_PER_PAIR + int(valid.sum()) * AREA_OPS_PER_BOX
        nbytes += boxes.numel() * 4 + valid.numel() * 2
    return (pairs, n_ops, nbytes, n_ops / H100_FP32_OPS_PER_S * 1e3,
            nbytes / H100_BYTES_PER_S * 1e3)


def call_opts(args, kwargs):
    """``nms_alive``'s IoU options of one recorded call."""
    opts = dict(zip(("plus_one", "strict"), args[3:]))
    opts.update(kwargs)
    return opts


def k1_work(torch, roi_ops, feats, boxes, bidx, lidx, crop):
    """What one RoIAlign forward call must do: (least bytes, distinct tap
    rows, fp32 operations). The bytes are the distinct tap rows that valid
    samples read, the boxes and indices, and the crops written once."""
    taps, _, _, valid = roi_ops.tap_rows([f.shape for f in feats], boxes, bidx, lidx, crop)
    rows = torch.cat([t[valid] for t in taps]).unique().numel()
    n, c = boxes.shape[0], feats[0].shape[3]
    values = n * crop[0] * crop[1] * c
    return rows * c * 4 + n * 24 + values * 4, rows, values * ROI_OPS_PER_VALUE


def k45_bound(torch, roi_ops, image, boxes, crop, positions="pallas"):
    """K4's and K5's least time on one call, as (bytes, distinct tap rows,
    fp32 operations, ms). The bytes are the distinct tap rows that valid
    samples read, the boxes, and the crops written once; the operations per
    value the y-lerp of two tap columns (3 each) and the 2-tap x product
    (4)."""
    b, h, w, c = image.shape
    ty, by, _, vy = roi_ops._grouped_axis(boxes[..., 0], boxes[..., 2], crop[0], h, positions)
    lx, rx, _, vx = roi_ops._grouped_axis(boxes[..., 1], boxes[..., 3], crop[1], w, positions)
    base = torch.arange(b, device=image.device)[:, None, None, None] * (h * w)
    valid = vy[..., :, None] & vx[..., None, :]
    rows = torch.cat([(base + y[..., :, None] * w + x[..., None, :])[valid]
                      for y in (ty, by) for x in (lx, rx)]).unique().numel()
    out_values = boxes.numel() // 4 * crop[0] * crop[1] * c
    nbytes = rows * c * 4 + boxes.numel() * 4 + out_values * 4
    ops = out_values * K45_OPS_PER_VALUE
    return nbytes, rows, ops, max(nbytes / H100_BYTES_PER_S, ops / H100_FP32_OPS_PER_S) * 1e3


def covered_pixels(torch, origins, shape, sy, sx) -> int:
    """The pixels of a [B, H, W, C] map that at least one window of
    ``origins`` [N, 3] (b, y0, x0 // 8) covers: each window adds +1 and -1 at
    its corners of a difference grid, whose 2-D prefix sum counts the
    windows over every pixel."""
    b, h, w, _ = shape
    o = origins.to(torch.int64)
    bi, y0, x0 = o[:, 0], o[:, 1], 8 * o[:, 2]
    grid = torch.zeros((b, h + 1, w + 1), dtype=torch.int32, device=origins.device)
    ones = torch.ones_like(bi, dtype=torch.int32)
    for dy, dx, sign in ((0, 0, 1), (0, sx, -1), (sy, 0, -1), (sy, sx, 1)):
        grid.index_put_((bi, y0 + dy, x0 + dx), sign * ones, accumulate=True)
    count = grid.cumsum(1).cumsum(2)[:, :h, :w]
    return int((count > 0).sum())


class Recorder:
    """Wrap a module-level kernel wrapper so the main path's calls are kept
    (their arguments), while the original wrapper still launches and counts.
    A call the wrapper makes of itself (the bfloat16 entry of K4 and K5
    calling its float32 self on the widened map) is not kept again."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.original = getattr(module, name)
        self.calls = []
        self.inside = False

    def __enter__(self):
        def recording(*args, **kwargs):
            if self.inside:
                return self.original(*args, **kwargs)
            self.calls.append((args, kwargs))
            self.inside = True
            try:
                return self.original(*args, **kwargs)
            finally:
                self.inside = False
        setattr(self.module, self.name, recording)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.original)
        return False


def profile_by_family(torch, fn, reps, families):
    """Device time of ``reps`` calls of ``fn`` by kernel family
    (torch.profiler), and the wall time per call. Returns (wall ms, device
    ms, {family: ms}, top kernels [(name, ms)]), all per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    kernels_us, kernels_n = {}, {}
    for e in prof.key_averages():
        # device kernels only: the aten ops above them, and their ranges
        # on the device's timeline, carry the same time again
        if (e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False)
                or e.key.startswith("aten::")):
            continue
        us = e.self_device_time_total
        if us > 0:
            kernels_us[e.key] = kernels_us.get(e.key, 0) + us
            kernels_n[e.key] = kernels_n.get(e.key, 0) + e.count
    total_ms = sum(kernels_us.values()) / 1e3 / reps
    by_family, launches = {}, {}
    for name, us in kernels_us.items():
        low = name.lower()
        fam = next((f for f, keys in families.items() if any(k in low for k in keys)), "other")
        by_family[fam] = by_family.get(fam, 0) + us / 1e3 / reps
        launches[fam] = launches.get(fam, 0) + kernels_n[name] / reps
    top = [(name, us / 1e3 / reps) for name, us in
           sorted(kernels_us.items(), key=lambda kv: -kv[1])[:12]]
    return wall_ms, total_ms, by_family, top, launches


def top_ops(torch, fn, count=8):
    """The aten ops of one call of ``fn`` that launch the most device time
    themselves (torch.profiler, grouped by input shapes): [(ms, launches,
    op, input shapes)], largest first."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.self_device_time_total / 1e3, e.count, e.key, e.input_shapes)
            for e in prof.key_averages(group_by_input_shape=True)
            if e.key.startswith("aten::") and e.self_device_time_total > 0]
    return sorted(rows, key=lambda r: -r[0])[:count]


def log_breakdown(label, wall_ms, total_ms, by_family, top, launches):
    if total_ms == 0:
        log(f"{label} not measured: the profiler saw no device time")
        return
    log(f"{label} wall {wall_ms:.2f} ms under the profiler, device busy "
        f"{total_ms:.2f} ms ({100 * total_ms / wall_ms:.1f}%)")
    for fam, ms in sorted(by_family.items(), key=lambda kv: -kv[1]):
        log(f"  {fam:26s} {ms:8.3f} ms  {100 * ms / total_ms:5.1f}%  "
            f"{launches[fam]:g} launches")
    for name, ms in top:
        log(f"    {ms:8.3f} ms  {name[:90]}")


def state_digest(torch, model, buffer, buffer_cnt) -> str:
    """SHA-1 over every tensor of the model's state_dict (weights and BN
    statistics), the intertwiner buffer and its counts, bytes as stored."""
    import hashlib

    h = hashlib.sha1()
    tensors = sorted(model.state_dict().items()) + [("buffer", buffer), ("cnt", buffer_cnt)]
    for name, t in tensors:
        h.update(name.encode())
        h.update(t.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def run_group(cmd, cwd, timeout: float):
    """Run ``cmd`` in its own process group, with the repository on
    PYTHONPATH; on its time limit kill the whole group (torchrun and its
    ranks). Returns (exit code, output)."""
    import signal

    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(cmd, cwd=cwd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        return 124, out
    return proc.returncode, out


def small_dp_step(torch, cfg, group, rank, world):
    """Phase 8's small train step over the ranks of ``group``, on the card
    and on the CPU in the same group (gloo): the same seeded weights with
    biases of N(0, 0.005), FPN tempered, the global batch of 2 128² images
    (GT from three of the card's largest proposals per image), each rank its
    rows, its draws and, on the CPU, the card's proposals. Returns the
    card-against-CPU errors: (losses rel, parameters rel of each tensor's
    largest magnitude, buffer abs, metrics on the card)."""
    import numpy as np
    from feature_intertwiner_tpu_torch import build_model
    from feature_intertwiner_tpu_torch.parallel import shard_batch
    from feature_intertwiner_tpu_torch.train.optim import set_trainable
    from feature_intertwiner_tpu_torch.train.step import create_train_state, train_step

    models = {}
    for dev in ("cuda", "cpu"):
        model = seeded_model(build_model, cfg, seed=3, device=dev)
        biases = torch.Generator().manual_seed(4)
        with torch.no_grad():
            for name, p in model.named_parameters():
                if name.endswith("bias"):
                    p.copy_(torch.randn(p.shape, generator=biases) * 0.005)
        models[dev] = temper_fpn(model)
    rng = np.random.RandomState(5)
    b, gt, size = 2, 5, 128
    images = rng.randn(b, size, size, 3) * 40
    with torch.no_grad():
        props = models["cuda"].first_stage(
            torch.as_tensor(images, dtype=torch.float32, device="cuda"))[3].cpu().numpy()
    area = (props[..., 2] - props[..., 0]) * (props[..., 3] - props[..., 1])
    boxes = np.zeros((b, gt, 4))
    for i in range(b):
        boxes[i, :3] = props[i, np.argsort(-area[i])[:3]] * size
    y1x1 = rng.uniform(4, 64, (b, 2, 2))
    boxes[:, 3:] = np.concatenate([y1x1, y1x1 + rng.uniform(16, 60, (b, 2, 2))], -1)
    batch = {"images": images, "gt_class_ids": rng.randint(1, 8, (b, gt)), "gt_boxes": boxes,
             "gt_masks": rng.rand(b, gt, 14, 14) > 0.5}
    n_anchors = int(models["cuda"].anchors.shape[0])
    draws = {"rpn": rng.rand(b, 2, n_anchors), "det": rng.rand(b, 2, 48)}
    batch, draws = shard_batch(batch, rank, world), shard_batch(draws, rank, world)
    runs = {}
    for dev, model in models.items():
        st = create_train_state(cfg, model)
        set_trainable(model, "all")
        dev_batch = {k: torch.as_tensor(v).to(dev, torch.int32 if k == "gt_class_ids"
                                              else torch.float32) for k, v in batch.items()}
        dev_draws = {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
                     for k, v in draws.items()}
        if dev == "cuda":
            propose = model._propose
            model._propose = lambda *a: runs.setdefault("proposals", propose(*a))
        else:
            model._propose = lambda *a: runs["proposals"].cpu()
        metrics = train_step(st, cfg, dev_batch, 0.01, 1.0, draws=dev_draws, group=group)
        runs[dev] = ({k: float(v) for k, v in metrics.items()},
                     {n: p.detach().cpu() for n, p in model.named_parameters()},
                     st.buffer.cpu(), st.buffer_cnt.cpu())
    (mg, pg, bg, cg), (mc, pc, bc, cc) = runs["cuda"], runs["cpu"]
    loss_rel = max(abs(mg[k] - mc[k]) / max(abs(mc[k]), 1e-6) for k in mc if k.endswith("_loss"))
    param_rel = max(float((pg[n] - pc[n]).abs().max() / pc[n].abs().max().clamp_min(1e-12))
                    for n in pc)
    buf_err = max(float((bg - bc).abs().max()), float((cg - cc).abs().max()))
    return loss_rel, param_rel, buf_err, mg


@contextlib.contextmanager
def step_records(torch):
    """Within the block, each ``train/workflow.py::train_step`` call is
    recorded in ``steps``: its metrics, its ms on the host clock between two
    synchronisations and each train kernel's launches in it; and each
    ``mean_gradients`` call in ``reduce_ms``: (ms, the same way, gradient
    count). Yields (steps, reduce_ms)."""
    from feature_intertwiner_tpu_torch.ops import cuda_build
    from feature_intertwiner_tpu_torch.train import step as step_mod
    from feature_intertwiner_tpu_torch.train import workflow

    steps, reduce_ms = [], []
    step_fn, mean_fn = workflow.train_step, step_mod.mean_gradients

    def recorded_step(*args, **kwargs):
        counts0 = dict(cuda_build.launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = step_fn(*args, **kwargs)
        torch.cuda.synchronize()
        steps.append(dict({k: float(v) for k, v in metrics.items()},
                          ms=(time.perf_counter() - t0) * 1e3,
                          launches={k: cuda_build.launches[k] - counts0.get(k, 0)
                                    for k in TRAIN_KERNELS}))
        return metrics

    def timed_mean(params, group_):
        params = list(params)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mean_fn(params, group_)
        torch.cuda.synchronize()
        reduce_ms.append(((time.perf_counter() - t0) * 1e3, sum(p.numel() for p in params)))

    workflow.train_step, step_mod.mean_gradients = recorded_step, timed_mean
    try:
        yield steps, reduce_ms
    finally:
        workflow.train_step, step_mod.mean_gradients = step_fn, mean_fn


def bucket_parts(torch, dist, grads, group) -> dict:
    """The parts of ``parallel/data_parallel.py::_mean_flat`` on ``grads``
    (copied back into fresh tensors), each from a synchronised start on the
    host clock: ms to issue its work and ms to finish it, for the
    concatenation, the all-reduce, the division and the copy back; the
    last of three rounds."""
    world = dist.get_world_size(group)
    dst = [torch.empty_like(g) for g in grads]
    parts = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        parts[name] = ((t1 - t0) * 1e3, (time.perf_counter() - t0) * 1e3)
        return out

    def copy_back(flat):
        offset = 0
        for t in dst:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()

    for _ in range(3):
        flat = timed("cat", lambda: torch.cat([g.reshape(-1) for g in grads]))
        timed("all_reduce", lambda: dist.all_reduce(flat, group=group))
        timed("div", lambda: flat.div_(world))
        timed("copy_back", lambda: copy_back(flat))
    return dict(parts, tensors=len(grads), mb=flat.numel() * flat.element_size() / 1e6)


def dp_worker(task: str, out_dir: str, argv) -> int:
    """One rank of ``data_parallel_path``, started by ``torchrun``: ``python
    -m feature_intertwiner_tpu_torch.main`` with ``argv`` (``task`` 'nccl':
    its own group, NCCL; 'gloo': gloo ranks sharing the card), each step's
    launches, metrics and time, the gradient all-reduce's time, the peak
    memory, the state's digest and the gradient bucket's parts on the last
    step's gradients (:func:`bucket_parts`); under 'gloo' also rank 0's last-step K3
    calls against their plain version and the small model's step over the
    ranks card against CPU. Writes ``<out_dir>/rank<r>.json``."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from feature_intertwiner_tpu_torch import main as port_main
    from feature_intertwiner_tpu_torch.config import FLAGSHIP_OVERRIDES, build_config
    from feature_intertwiner_tpu_torch.ops import cuda_build
    from feature_intertwiner_tpu_torch.ops import roi_align as roi_ops
    from feature_intertwiner_tpu_torch.parallel import init_distributed

    _, group = init_distributed("cuda", backend="gloo" if task == "gloo" else None)
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    with step_records(torch) as (steps, reduce_ms), \
            Recorder(roi_ops, "roi_align_bwd") as bwd_rec:
        torch.cuda.reset_peak_memory_stats()
        cuda_build.launches.clear()
        trainer = port_main.main(argv)
        last_k3 = bwd_rec.calls[-2:]
    st = trainer.state
    out = {"rank": rank, "world": world, "backend": dist.get_backend(group), "steps": steps,
           "reduce_ms": reduce_ms, "peak_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
           "digest": state_digest(torch, st.model, st.buffer, st.buffer_cnt),
           "device": str(next(st.model.parameters()).device)}
    out["bucket"] = bucket_parts(torch, dist, [p.grad for p in st.model.parameters()
                                               if p.requires_grad and p.grad is not None], group)
    if task == "gloo":
        if rank == 0:
            # K3 on this rank's last step, within one bfloat16 rounding of
            # its plain version and bit-equal over two launches
            worst, same = 0.0, True
            for args, kwargs in last_k3:
                got = roi_ops.roi_align_bwd(*args, **kwargs)
                again = roi_ops.roi_align_bwd(*args, **kwargs)
                want = roi_ops.multilevel_gather_bwd_plain(*args, **kwargs)
                for a, b_, c in zip(got, again, want):
                    same &= torch.equal(a, b_)
                    tol = 2.0 ** -7 * c.float().abs() + 1e-5 * c.float().abs().max()
                    worst = max(worst, float(((a.float() - c.float()).abs() - tol).max()))
            out["k3"] = {"calls": len(last_k3), "excess": worst, "two_launches_equal": same,
                         "dtype": str(last_k3[0][0][0].dtype) if last_k3 else None}
        small = build_config("smoke_small", "train", opts=list(FLAGSHIP_OVERRIDES) + SMALL_OPTS
                             + ["ROIS.ASSIGN_ANCHOR_BASE", "56.0"])
        loss_rel, param_rel, buf_err, metrics = small_dp_step(torch, small, group, rank, world)
        out["small"] = {"loss_rel": loss_rel, "param_rel": param_rel, "buf_err": buf_err,
                        "metrics": metrics}
    dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


def main() -> int:
    try:
        import numpy  # noqa: F401  (the synthetic images need it)
        import torch
    except ImportError as exc:
        print(f"chip_smoke: {exc}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        from feature_intertwiner_tpu_torch import build_model, detect
        from feature_intertwiner_tpu_torch.config import FLAGSHIP_OVERRIDES, build_config
        from feature_intertwiner_tpu_torch.inference import mold_inputs
        from feature_intertwiner_tpu_torch.ops import cuda_build
        from feature_intertwiner_tpu_torch.ops import nms as nms_ops
        from feature_intertwiner_tpu_torch.ops import roi_align as roi_ops
        from feature_intertwiner_tpu_torch.tools import profile_roi
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable here: {exc}", file=sys.stderr)
        return 2

    failures = []
    smi = nvidia_smi()

    def phase(name, fn):
        t0 = time.perf_counter()
        try:
            out = fn()
            log(f"PHASE {name} ok in {time.perf_counter() - t0:.1f} s")
            return out
        except Exception:  # a failed phase is reported and fails the run
            failures.append(name)
            log(f"PHASE {name} FAILED:\n{traceback.format_exc()}")
            return None

    # 1. environment --------------------------------------------------------
    def environment():
        try:
            nv = subprocess.run([cuda_build.nvcc(), "--version"], capture_output=True,
                                text=True, timeout=60).stdout.strip().splitlines()[-1]
        except RuntimeError as exc:
            nv = str(exc)
        try:
            import triton
            tri = triton.__version__
        except ImportError:
            tri = None
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        env = {"python": sys.version.split()[0], "torch": torch.__version__,
               "cuda": torch.version.cuda, "nvcc": nv, "triton": tri, "nvidia_smi": smi,
               "device": torch.cuda.get_device_name(0),
               "count": torch.cuda.device_count(),
               "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
               "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32}
        log("ENV " + json.dumps(env))

    phase("environment", environment)
    log(f"nvidia-smi: {smi}")

    # 2. build --------------------------------------------------------------
    def build():
        t0 = time.perf_counter()
        logs = cuda_build.build()
        dt = time.perf_counter() - t0
        for name, text in logs.items():
            for line in text.splitlines():
                if "registers" in line or "spill" in line or "error" in line:
                    log(f"  [{name}] {line.strip()}")
        log(f"BUILD {sorted(cuda_build.SOURCES)} in {dt:.1f} s")

    phase("build", build)

    # 3. main path ----------------------------------------------------------
    cfg = build_config("meta_105_quick_1", "inference", opts=list(FLAGSHIP_OVERRIDES))
    images = synthetic_images(seed=0)
    state = {}

    def main_path():
        model = seeded_model(build_model, cfg, seed=0)
        detect(model, images, cfg)               # warm-up (cuDNN, allocator)
        torch.cuda.synchronize()
        cuda_build.launches.clear()
        with Recorder(roi_ops, "roi_align_fwd") as roi_rec, \
                Recorder(nms_ops, "nms_alive") as nms_rec:
            results = detect(model, images, cfg)
        launches = {k: cuda_build.launches[k] for k in ("roi_align_fwd", "nms_alive")}
        log("LAUNCHES " + json.dumps(launches))
        if launches["roi_align_fwd"] != 2:
            raise AssertionError(f"RoIAlign kernel launched {launches['roi_align_fwd']} times, want 2")
        if launches["nms_alive"] < 2:
            raise AssertionError(f"NMS kernel launched {launches['nms_alive']} times, want >= 2")
        state.update(launches=launches, roi_calls=roi_rec.calls, nms_calls=nms_rec.calls)

        # what comes out: shapes, finiteness, ranges
        molded, windows = mold_inputs(images, cfg, "cuda")
        with torch.inference_mode():
            pyramid, _, _, proposals = model.first_stage(molded)
            out = model.second_stage(pyramid[:4], proposals, windows)
        det, masks = out["detections"], out["masks"]
        require(det.shape == (2, 100, 6) and masks.shape == (2, 100, 28, 28),
                f"output shapes {tuple(det.shape)}, {tuple(masks.shape)}")
        require(bool(torch.isfinite(det).all() and torch.isfinite(masks).all()),
                "non-finite detections or masks")
        require(bool(((masks >= 0) & (masks <= 1)).all()), "mask values outside [0, 1]")
        n_prop = [int((proposals[i].abs().sum(-1) > 0).sum()) for i in range(2)]
        n_det = [int((det[i, :, 5] > 0).sum()) for i in range(2)]
        require(min(n_det) > 0, f"no detections {n_det}: the mask pass pools nothing")
        for r, img in zip(results, images):
            require(all(m.shape == img.shape[:2] for m in r["masks"]),
                    "a full-size mask does not have its image's shape")
        log(f"MAIN proposals per image {n_prop}, detections per image {n_det}")

        # end-to-end time per batch of 2: host clock around detect(), which
        # ends in a device-to-host copy; forward alone with CUDA events
        e2e = []
        for _ in range(5):
            t0 = time.perf_counter()
            detect(model, images, cfg)
            e2e.append((time.perf_counter() - t0) * 1e3)
        with torch.inference_mode():
            fwd = cuda_ms(torch, lambda: model.forward_inference(molded, windows), 5)
        log(f"E2E detect() ms per batch of 2: median {sorted(e2e)[2]:.2f} "
            f"(runs {', '.join(f'{x:.2f}' for x in e2e)}); forward_inference {fwd:.2f} ms")
        state.update(model=model, molded=molded, windows=windows)

    phase("main_path", main_path)

    # 4. kernels against their plain versions --------------------------------
    kernels = []

    def fold_err(name, err):
        """Widen a kernel's ``max_abs_err`` by a check made on another path."""
        for k in kernels:
            if k["name"] == name:
                k["max_abs_err"] = max(k["max_abs_err"], err)

    def k1_cases():
        """K1 off the main path's shapes, each call against its plain version
        within 1e-5 and bit-equal over two launches: one float at a time (3
        and 6 channels, a 256-channel P2 4 bytes off a 16-byte boundary),
        crops 1² and 5x9, boxes out of range and inverted with
        extrapolation -1.5, one box at 14² (its rows split across blocks),
        2,048 channels. Returns the largest error."""
        g = torch.Generator(device="cuda").manual_seed(21)

        def pyramid(c, sizes=(64, 32, 16, 8)):
            return [torch.randn((2, s, s, c), device="cuda", generator=g) for s in sizes]

        n = 300
        yx = torch.rand((n, 2), device="cuda", generator=g) * 0.8
        boxes = torch.cat([yx, yx + torch.rand((n, 2), device="cuda", generator=g) * 0.3 + 0.01], 1)
        wild = torch.rand((n, 4), device="cuda", generator=g) * 1.8 - 0.4
        bidx = torch.randint(0, 2, (n,), dtype=torch.int32, device="cuda", generator=g)
        lvl = torch.randint(0, 4, (n,), dtype=torch.int32, device="cuda", generator=g)
        p256 = pyramid(256)
        off = torch.empty(2 * 64 * 64 * 256 + 1, device="cuda")[1:].view(2, 64, 64, 256)
        off.copy_(p256[0])
        one = (boxes[:1], bidx[:1], lvl[:1])
        cases = [("3 channels", pyramid(3), boxes, bidx, lvl, (7, 7), 0.0, 1),
                 ("6 channels", pyramid(6), boxes, bidx, lvl, (7, 7), 0.0, 1),
                 ("256 channels, P2 4 bytes off", [off] + p256[1:], boxes, bidx, lvl, (7, 7),
                  0.0, 1),
                 ("crop 1x1", p256, boxes, bidx, lvl, (1, 1), 0.0, 4),
                 ("crop 5x9", p256, boxes, bidx, lvl, (5, 9), 0.0, 4),
                 ("one box", p256, *one, (14, 14), 0.0, 4),
                 ("2048 channels", pyramid(2048, (32, 16, 8, 4)), boxes[:64], bidx[:64], lvl[:64],
                  (14, 14), 0.0, 4)]
        cases += [("out-of-range and inverted boxes, extrapolation -1.5", p256, wild, bidx, lvl,
                   crop, -1.5, 4) for crop in ((7, 7), (1, 1), (5, 9))]
        worst = 0.0
        for label, feats, bx, bi, lv, crop, extrap, width in cases:
            got = roi_ops.roi_align_fwd(feats, bx, bi, lv, crop, extrap)
            again = roi_ops.roi_align_fwd(feats, bx, bi, lv, crop, extrap)
            want = roi_ops.multilevel_gather_plain(feats, bx, bi, lv, crop, extrap)
            torch.cuda.synchronize()
            e = float((got - want).abs().max())
            worst = max(worst, e)
            vec = roi_ops.fwd_vector_width(feats, got)
            rows, blocks, _ = roi_ops.fwd_plan(bx.shape[0], crop, feats[0].shape[3], vec)
            extrapolated = int((got == extrap).all(-1).sum()) if extrap else 0
            log(f"  roi_align_fwd {label}, n={bx.shape[0]} crop={crop} C={feats[0].shape[3]}: "
                f"err {e:.3g}, {vec} float(s) at a time, {rows} rows per block over {blocks} "
                f"blocks, two launches bit-equal {torch.equal(got, again)}"
                + (f", {extrapolated} samples extrapolated" if extrap else ""))
            require(e <= 1e-5, f"K1 differs from its plain version by {e} ({label})")
            require(torch.equal(got, again), f"two K1 launches differ ({label})")
            require(vec == width, f"K1 reads {vec} floats at a time on {label}, want {width}")
            require(not extrap or extrapolated > 0, f"nothing extrapolated ({label})")
            if label == "one box":
                require(rows < crop[0], "the one box's rows are not split across blocks")
        return worst

    def roi_kernel():
        calls = state["roi_calls"]
        err, ms, plain_ms, lib_ms, bound_bytes, ops = 0.0, 0.0, 0.0, 0.0, 0, 0
        for args, kwargs in calls:
            feats, boxes, bidx, lidx, crop = args[:5]
            extrap = args[5] if len(args) > 5 else kwargs.get("extrapolation_value", 0.0)
            got = roi_ops.roi_align_fwd(feats, boxes, bidx, lidx, crop, extrap)
            again = roi_ops.roi_align_fwd(feats, boxes, bidx, lidx, crop, extrap)
            want = roi_ops.multilevel_gather_plain(feats, boxes, bidx, lidx, crop, extrap)
            torch.cuda.synchronize()
            e = float((got - want).abs().max())
            err = max(err, e)
            require(torch.equal(got, again), f"two RoIAlign launches differ (n={boxes.shape[0]})")
            k_ms = cuda_ms(torch, lambda: roi_ops.roi_align_fwd(feats, boxes, bidx, lidx, crop, extrap), 20)
            p_ms = cuda_ms(torch, lambda: roi_ops.multilevel_gather_plain(feats, boxes, bidx, lidx, crop, extrap), 5)
            # yardstick: one grid_sample over P2 for every box of the call
            p2 = feats[0].permute(0, 3, 1, 2)
            n = boxes.shape[0]
            grid = profile_roi.box_grid(boxes, crop, p2.shape[0])
            l_ms = cuda_ms(torch, lambda: torch.nn.functional.grid_sample(
                p2, grid, mode="bilinear", padding_mode="zeros", align_corners=True), 20)
            nbytes, rows, n_ops = k1_work(torch, roi_ops, feats, boxes, bidx, lidx, crop)
            bound_bytes += nbytes
            ops += n_ops
            ms, plain_ms, lib_ms = ms + k_ms, plain_ms + p_ms, lib_ms + l_ms
            b_ms = max(nbytes / H100_BYTES_PER_S, n_ops / H100_FP32_OPS_PER_S) * 1e3
            log(f"  roi_align_fwd n={n} crop={crop}: err {e:.3g}, {k_ms:.4f} ms, "
                f"plain {p_ms:.4f} ms, grid_sample {l_ms:.4f} ms, bound {b_ms:.6f} ms "
                f"({rows} tap rows, {nbytes} bytes)")
            # the kernel's launch on this call (torch.profiler)
            profile_roi.print_trace(profile_roi.kernel_trace(
                lambda: roi_ops.roi_align_fwd(feats, boxes, bidx, lidx, crop, extrap), 10, "cuda"))
        err = max(err, k1_cases())
        if err > 1e-5:
            raise AssertionError(f"RoIAlign kernel differs from its plain version by {err}")
        t_bytes = bound_bytes / H100_BYTES_PER_S * 1e3
        t_ops = ops / H100_FP32_OPS_PER_S * 1e3
        kernels.append({
            "name": "roi_align_fwd", "route": "cuda",
            "source": "feature_intertwiner_tpu_torch/csrc/roi_align_fwd.cu",
            "replaces": "feature_intertwiner_tpu/ops/roi_align_window.py:64",
            "launches": state["launches"]["roi_align_fwd"], "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms})

    def nms_kernel():
        calls = state["nms_calls"]
        cases = [(args, kwargs, "main path") for args, kwargs in calls]
        # tie-heavy and invalid-padded cases at the proposal shape
        g = torch.Generator(device="cuda").manual_seed(1)
        n = calls[0][0][0].shape[1]
        base = torch.rand((2, n // 8, 2), device="cuda", generator=g) * 900
        size = torch.rand((2, n // 8, 2), device="cuda", generator=g) * 100 + 10
        box = torch.cat([base, base + size], -1)
        ties = box.repeat_interleave(8, dim=1).round().contiguous()   # 8 copies of each box
        valid = torch.rand((2, n), device="cuda", generator=g) > 0.3
        valid[:, -n // 4:] = False
        for plus_one, strict in ((True, True), (False, False)):
            cases.append(((ties, valid.contiguous(), 0.7), {"plus_one": plus_one, "strict": strict},
                          f"ties plus_one={plus_one} strict={strict}"))
        # the sweep's extremes at the proposal shape: every box disjoint from
        # every other (all kept, 64 per tile: the most rows to OR), and copies
        # of one 500-px box moved by at most 4 px (the first suppresses all)
        all_valid = torch.ones((2, n), dtype=torch.bool, device="cuda")
        cell = torch.arange(n, device="cuda")
        side = math.ceil(math.sqrt(n))
        y, x = (cell // side).float() * 10, (cell % side).float() * 10
        disjoint = torch.stack([y, x, y + 8, x + 8], -1).expand(2, n, 4).contiguous()
        one = (torch.tensor([100.0, 100.0, 600.0, 600.0], device="cuda")
               + torch.rand((2, n, 4), device="cuda", generator=g) * 4)
        cases += [((disjoint, all_valid, 0.7), {}, "disjoint"),
                  ((one, all_valid, 0.7), {}, "one suppresses all")]
        # the eval batch's proposal call, and an N whose tiles the sweep
        # cannot double-buffer whole in shared memory (ops/nms.py::sweep_plan)
        for batch, count in ((8, 6000), (1, 16384)):
            bx, va = profile_roi.nms_inputs(batch, count, 1024, "cuda", seed=1)
            cases.append(((bx, va, 0.7), {}, f"clustered, {count} boxes"))
        mism, ms, plain_ms, needed = 0, 0.0, 0.0, []
        for args, kwargs, label in cases:
            boxes, valid, thr = args[:3]
            opts = call_opts(args, kwargs)
            got = nms_ops.nms_alive(boxes, valid, thr, **opts)
            again = nms_ops.nms_alive(boxes, valid, thr, **opts)
            want = nms_ops.greedy_alive_sorted_plain(boxes, valid, thr, **opts)
            bad = int((got != want).sum())
            mism += bad
            require(torch.equal(got, again), f"two NMS launches differ on {label}")
            if label == "disjoint":
                require(bool(got.all()), "a disjoint box was suppressed")
            if label == "one suppresses all":
                require(int(got.sum()) == boxes.shape[0], "not exactly one box kept per image")
            line = (f"  nms_alive {label} {tuple(boxes.shape)}: {bad} mismatches, two launches "
                    f"bit-equal, kept {int(got.sum())}")
            if label == "main path":
                k_ms = cuda_ms(torch, lambda: nms_ops.nms_alive(boxes, valid, thr, **opts), 20)
                p_ms = cuda_ms(torch, lambda: nms_ops.greedy_alive_sorted_plain(boxes, valid, thr, **opts), 2)
                needed.append((boxes, valid, got, thr, opts))
                ms, plain_ms = ms + k_ms, plain_ms + p_ms
                line += f", {k_ms:.4f} ms, plain {p_ms:.2f} ms"
            log(line)
            if label == "main path":
                # the kernel's passes on this call (torch.profiler)
                profile_roi.print_trace(profile_roi.kernel_trace(
                    lambda: nms_ops.nms_alive(boxes, valid, thr, **opts), 10, "cuda"))
        if mism:
            raise AssertionError(f"NMS kernel differs from its plain version in {mism} rows")
        pairs, n_ops, nbytes, t_ops, t_bytes = nms_bound(nms_ops, needed)
        log(f"  nms_alive bound per forward: {pairs} IoU pairs needed, {n_ops} fp32 ops -> "
            f"{t_ops:.6f} ms at {H100_FP32_OPS_PER_S:.3g}/s; {nbytes} bytes -> {t_bytes:.6f} ms "
            f"at {H100_BYTES_PER_S:.3g} B/s")
        kernels.append({
            "name": "nms_alive", "route": "cuda",
            "source": "feature_intertwiner_tpu_torch/csrc/nms.cu",
            "replaces": "feature_intertwiner_tpu/ops/nms_pallas.py:47",
            "launches": state["launches"]["nms_alive"], "max_abs_err": float(mism > 0),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None})

    if "main_path" not in failures:
        with torch.inference_mode():
            phase("kernel_roi_align_fwd", roi_kernel)
            phase("kernel_nms_alive", nms_kernel)
    else:
        failures.append("kernels (main path failed)")

    # 5. where the forward's device time goes -----------------------------------
    # first match wins: cuDNN's layout transposes before the convolutions
    families = {"layout transposes": ("nchwtonhwc", "nhwctonchw"),
                "crop_and_resize_grouped (K4)": ("grouped_crop",),
                "convolution": ("conv", "gemm", "xmma", "cudnn", "sm90_", "sm80_", "winograd",
                                "wgrad", "dgrad"),
                "roi_align_fwd (K1)": ("roi_align_fwd",),
                "roi_align_bwd (K3)": ("roi_align_bwd",),
                "nms (K2)": ("nms_mask", "nms_sweep"),
                "sort": ("sort", "radix"),
                "scatter / gather / index": ("scatter", "gather", "index"),
                "optimizer (SGD)": ("multi_tensor", "foreach"),
                "batch norm / elementwise": (
                    "batch_norm", "elementwise", "vectorized", "bn_", "relu", "reduce")}

    def breakdown():
        """Device time of three forwards by kernel family (torch.profiler),
        and the device's busy share of their wall time. Informational: a
        profiler that sees no device time is reported, not failed."""
        model, molded, windows = state["model"], state["molded"], state["windows"]
        with torch.inference_mode():
            out = profile_by_family(torch, lambda: model.forward_inference(molded, windows),
                                    3, families)
        log_breakdown("BREAKDOWN forward", *out)

    if "main_path" not in failures:
        phase("breakdown", breakdown)
    state.pop("model", None)   # frees the inference model before training

    # 6. the training main path ------------------------------------------------
    train = {}

    def step_launches_ok(launches, steps):
        """Per train step K1 twice (7² and 14² on the make-up maps), K4 three
        times (the 14² big-set crop of P2, P3 and P4), K3 twice and K2 at
        least once."""
        return (launches["roi_align_fwd"] == 2 * steps
                and launches["crop_and_resize_grouped"] == 3 * steps
                and launches["roi_align_bwd"] == 2 * steps and launches["nms_alive"] >= steps)

    k4_wrapper = roi_ops.crop_and_resize_grouped     # itself, not a Recorder's wrapping

    def held_k4(calls):
        """The values of recorded K4 calls that differ from their plain
        version on the same tensors (each call's map, boxes and rounding),
        called through the K4 wrapper itself, so that a Recorder of it keeps
        no call of the check's."""
        differ, counted = 0, cuda_build.launches["crop_and_resize_grouped"]
        with torch.no_grad():
            for args, kwargs in list(calls):
                got = k4_wrapper(*args, **kwargs)
                want = roi_ops.crop_and_resize_grouped_plain(*args, **kwargs)
                differ += int((got != want).sum())
        cuda_build.launches["crop_and_resize_grouped"] = counted   # checks do not count
        return differ

    def train_path():
        """The flagship recipe trained through Trainer/train_model: three
        stages (heads, 4+, all) of one epoch each over 8 in-memory synthetic
        images at batch 4, 2 steps per stage; then a fresh Trainer resumes
        from the newest checkpoint and must hold the same state."""
        import shutil
        import tempfile

        from feature_intertwiner_tpu_torch.data import synthetic
        from feature_intertwiner_tpu_torch.data.loader import DetectionDataset, Loader
        from feature_intertwiner_tpu_torch.train import workflow

        tcfg = build_config("meta_105_quick_1", "train", opts=list(FLAGSHIP_OVERRIDES) + [
            "TRAIN.DO_VALIDATION", "False", "TRAIN.SCHEDULE", "[1, 1, 1]",
            "TRAIN.KEEP_CHECKPOINTS", "2", "CTRL.SHOW_INTERVAL", "1"])
        folder = tempfile.mkdtemp(prefix="chip_smoke_train_", dir=os.path.join(ROOT, "build"))
        tcfg.MISC.RESULT_FOLDER = folder
        tcfg.MISC.LOG_FILE = os.path.join(folder, "log.txt")
        data = synthetic.generate(num_images=8, **TRAIN_DATA)
        loader = Loader(DetectionDataset(data, tcfg, augment=True, seed=tcfg.MISC.SEED),
                        batch_size=tcfg.TRAIN.BATCH_SIZE, shuffle=True, seed=tcfg.MISC.SEED)
        model = temper_fpn(seeded_model(build_model, tcfg, seed=0))
        trainer = workflow.Trainer(model, tcfg).resume()
        steps = []
        step_fn = workflow.train_step

        def recorded_step(st, cfg_, batch, lr, meta_gate, generator=None, draws=None, **kw):
            """One train step, with its launches, its time (CUDA events) and
            the parameters it must and must not move."""
            before = {n: p.detach().clone() for n, p in st.model.named_parameters()}
            bwd_rec.calls.clear()               # keep the last step's cotangents only
            fwd_rec.calls.clear()               # and its forward poolings
            k4_rec.calls.clear()                # and its big-set crops
            counts0 = dict(cuda_build.launches)
            t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0.record()
            metrics = step_fn(st, cfg_, batch, lr, meta_gate, generator, draws, **kw)
            t1.record()
            torch.cuda.synchronize()
            host = {k: float(v) for k, v in metrics.items()}
            frozen_moved, should, did = 0, 0, 0
            for n, p in st.model.named_parameters():
                moved = not torch.equal(p.detach(), before[n])
                if not p.requires_grad:
                    frozen_moved += moved
                    continue
                # SGD moves a trainable tensor by lr times its momentum
                # buffer; it must change where that step exceeds two ulps of
                # the value (a zero step, e.g. a BN bias of a head that saw no
                # positive RoI, or one the clip made tiny, may leave it)
                step = lr * st.optimizer.state[p]["momentum_buffer"].abs()
                must = bool((step > 2 * EPS32 * before[n].abs()).any())
                should += must
                did += moved and must
                require(moved or not must, f"trainable {n} did not move")
            launches = {k: cuda_build.launches[k] - counts0.get(k, 0) for k in TRAIN_KERNELS}
            k4_mism.append(held_k4(k4_rec.calls))
            steps.append(dict(host, ms=t0.elapsed_time(t1), launches=launches,
                              frozen_moved=frozen_moved, trainable=should, moved=did,
                              n_frozen=sum(not p.requires_grad for p in st.model.parameters())))
            return metrics

        torch.cuda.reset_peak_memory_stats()
        workflow.train_step = recorded_step
        k4_mism = []
        try:
            with Recorder(roi_ops, "roi_align_bwd") as bwd_rec, \
                    Recorder(roi_ops, "roi_align_fwd") as fwd_rec, \
                    Recorder(roi_ops, "crop_and_resize_grouped") as k4_rec, \
                    Recorder(nms_ops, "nms_alive") as nms_rec:
                cuda_build.launches.clear()
                for stage in ("heads", "4+", "all"):
                    workflow.train_model(trainer, loader, stage)
                    for s in steps:
                        s.setdefault("stage", stage)
                launches = {k: cuda_build.launches[k] for k in TRAIN_KERNELS}
        finally:
            workflow.train_step = step_fn
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        log("TRAIN LAUNCHES " + json.dumps(launches))
        for i, s in enumerate(steps):
            log(f"TRAIN step {i + 1} [{s['stage']}] "
                + " ".join(f"{k.replace('_loss', '')} {s[k]:.4f}" for k in (
                    "total_loss", "rpn_class_loss", "rpn_bbox_loss", "mrcnn_class_loss",
                    "mrcnn_bbox_loss", "mrcnn_mask_loss", "meta_loss"))
                + f" | positives {s['positive_rois']:.0f}, small RoIs of a class P2/P3/P4 "
                f"{s['small_rois_p2']:.0f}/{s['small_rois_p3']:.0f}/{s['small_rois_p4']:.0f}"
                f" | {s['ms']:.1f} ms | launches {s['launches']} | frozen {s['n_frozen']}"
                f" (moved {s['frozen_moved']}), trainable that must move {s['trainable']}"
                f" (moved {s['moved']})")
        require(len(steps) == 6, f"{len(steps)} train steps, want 6")
        require(step_launches_ok(launches, len(steps)), f"train launches {launches}")
        for s in steps:
            require(step_launches_ok(s["launches"], 1), f"step launches {s['launches']}")
            require(all(math.isfinite(s[k]) for k in s if k.endswith("_loss")),
                    "a non-finite loss")
            require(s["frozen_moved"] == 0, "a frozen parameter moved")
        require(all(s["n_frozen"] > 0 for s in steps if s["stage"] == "heads"),
                "the heads stage froze nothing")
        require(any(s["positive_rois"] > 0 and s["meta_loss"] > 0 for s in steps),
                "no step had positive RoIs and a non-zero meta loss")
        log(f"TRAIN peak memory {peak_gb:.2f} GiB (torch.cuda.max_memory_allocated)")
        mism, needed = 0, []
        with torch.no_grad():
            for args, kwargs in nms_rec.calls:
                got = nms_ops.nms_alive(*args, **kwargs)
                want = nms_ops.greedy_alive_sorted_plain(*args, **kwargs)
                mism += int((got != want).sum())
                needed.append((*args[:2], want, args[2], call_opts(args, kwargs)))
            _, _, _, t_ops, t_bytes = nms_bound(nms_ops, needed)
        log(f"TRAIN nms_alive against its plain version on the steps' tensors: {mism} "
            f"mismatches over {len(nms_rec.calls)} calls "
            f"(shapes {sorted({tuple(a[0].shape) for a, _ in nms_rec.calls})}); bound per step "
            f"{max(t_ops, t_bytes) / len(steps):.6f} ms by "
            f"{'operations' if t_ops >= t_bytes else 'bytes'}")
        require(mism == 0, "K2 differs from its plain version in training")
        fold_err("nms_alive", float(mism > 0))
        del nms_rec
        log(f"TRAIN crop_and_resize_grouped (K4, the Dev big-set crops) against its plain "
            f"version on each step's tensors: {sum(k4_mism)} values differ over "
            f"{3 * len(steps)} calls")
        require(sum(k4_mism) == 0, "K4 differs from its plain version in training")

        # resume: a fresh Trainer takes the newest checkpoint
        kept = sorted(os.listdir(os.path.join(folder, "checkpoints")))
        fresh = workflow.Trainer(seeded_model(build_model, tcfg, seed=1), tcfg).resume()
        sd, sd2 = trainer.state.model.state_dict(), fresh.state.model.state_dict()
        params_equal = all(torch.equal(sd[k], sd2[k]) for k in sd)
        mom = [trainer.state.optimizer.state[p].get("momentum_buffer")
               for p in trainer.state.model.parameters()]
        mom2 = [fresh.state.optimizer.state[p].get("momentum_buffer")
                for p in fresh.state.model.parameters()]
        mom_equal = all((a is None and b is None) or (a is not None and b is not None
                                                      and torch.equal(a, b))
                        for a, b in zip(mom, mom2))
        buf_equal = (torch.equal(trainer.state.buffer, fresh.state.buffer)
                     and torch.equal(trainer.state.buffer_cnt, fresh.state.buffer_cnt))
        log(f"TRAIN checkpoints kept {kept}; resumed at epoch {fresh.epoch} iter {fresh.iter}: "
            f"params equal {params_equal}, momentum equal {mom_equal}, buffer equal {buf_equal}")
        require(len(kept) == 2 and params_equal and mom_equal and buf_equal,
                "the restored state differs from the trained one")
        del fresh

        # step time per stage: the median of 5 more steps after the run
        batch = workflow.to_device(next(iter(loader)), "cuda")
        gen = torch.Generator(device="cuda")
        per_stage = {}
        for stage in ("heads", "4+", "all"):
            workflow.set_trainable(trainer.model, stage)
            times = []
            for i in range(5):
                gen.manual_seed(i)
                t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                t0.record()
                workflow.train_step(trainer.state, tcfg, batch, 1e-4, 1.0, gen)
                t1.record()
                torch.cuda.synchronize()
                times.append(t0.elapsed_time(t1))
            per_stage[stage] = sorted(times)[2]
            log(f"TRAIN step ms [{stage}] median {per_stage[stage]:.2f} "
                f"(runs {', '.join(f'{t:.2f}' for t in times)})")
        out = profile_by_family(
            torch, lambda: workflow.train_step(trainer.state, tcfg, batch, 1e-4, 1.0, gen),
            1, families)
        log_breakdown("TRAIN BREAKDOWN one 'all' step", *out)
        train.update(launches=launches, bwd_calls=list(bwd_rec.calls),
                     fwd_calls=list(fwd_rec.calls), k4_calls=list(k4_rec.calls),
                     step_ms=per_stage)
        shutil.rmtree(folder, ignore_errors=True)

    phase("train_path", train_path)

    def bwd_bytes(g, shapes):
        """K3's least bytes: g read once, the boxes and indices, every
        level's gradient written once."""
        return g.numel() * 4 + g.shape[0] * 24 + sum(4 * math.prod(s) for s in shapes)

    def grid_sample_bwd_ms(shapes, boxes, crop, g, images):
        """grid_sample's backward into a P2 of ``images`` images for every
        box of a call (boxes in image order, as many per image)."""
        _, h2, w2, c = shapes[0]
        p2 = torch.zeros((images, h2, w2, c), device="cuda")
        args = profile_roi.grid_sample_backward_args([p2], boxes, crop, g)
        return cuda_ms(torch, lambda: profile_roi.grid_sample_grad(*args), 20)

    def bwd_errors(got, g, shapes, boxes, bidx, lidx, crop, xla=False):
        """A K3 result against its plain version: (largest gradient, error
        against the plain version in float64, the exact sum, relative to
        it; the same against the plain version in float32; the float32
        plain version's own error against float64). The float32 plain
        version sums a crowded cell with float atomics in no fixed order."""
        want = roi_ops.multilevel_gather_bwd_plain(g.double(), shapes, boxes, bidx, lidx, crop,
                                                   xla)
        want32 = roi_ops.multilevel_gather_bwd_plain(g, shapes, boxes, bidx, lidx, crop, xla)
        torch.cuda.synchronize()
        top = max(float(w.abs().max()) for w in want)

        def err(xs, ys):
            return max(float((x.double() - y.double()).abs().max()) for x, y in zip(xs, ys))

        scale = max(top, 1e-30)
        return top, err(got, want), err(got, want) / scale, err(got, want32) / scale, \
            err(want32, want) / scale

    def hold_bwd(label, g, shapes, boxes, bidx, lidx, crop, xla=False):
        """One K3 call (in its ``xla`` mode or not) within 1e-5 of the
        largest gradient of its plain version in float64 (beside its
        distance to the float32 plain version), two launches bit-equal, its
        plan equal to the plain plan. Returns its error against float64 and
        its plan."""
        got, plan = roi_ops.roi_align_bwd_with_plan(g, shapes, boxes, bidx, lidx, crop, xla)
        again = roi_ops.roi_align_bwd(g, shapes, boxes, bidx, lidx, crop, xla)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        top, a_err, rel, rel32, plain32 = bwd_errors(got, g, shapes, boxes, bidx, lidx, crop, xla)
        del got, again
        plain_plan = roi_ops.bwd_work_plan(shapes, boxes, bidx, lidx, crop, xla=xla)
        log(f"  roi_align_bwd {label} n={boxes.shape[0]} crop={crop}: rel err {rel:.3g} "
            f"against the float64 plain version (max |grad| {top:.4g}; against the float32 "
            f"plain version {rel32:.3g}, which is {plain32:.3g} from float64), "
            f"two launches bit-equal {same}; work items {plan['items']}, largest chunk count "
            f"{plan['max_chunks']}, partial tiles {plan['partials']} over "
            f"{plan['multi_tiles']} tiles")
        require(same, f"two launches of the RoIAlign backward differ ({label})")
        require(rel <= 1e-5, f"RoIAlign backward differs from its plain version by {rel} ({label})")
        require(all(plan[k] == plain_plan[k] for k in plan),
                f"the kernel's plan {plan} is not the plain plan {plain_plan} ({label})")
        return a_err, plan

    def check_bwd(label, g, shapes, boxes, bidx, lidx, crop, images, xla=False):
        """One K3 call held by :func:`hold_bwd`, then timed beside its plain
        version, its bytes bound and grid_sample's backward. Returns its
        numbers."""
        a_err, _ = hold_bwd(label, g, shapes, boxes, bidx, lidx, crop, xla)
        k_ms = cuda_ms(torch, lambda: roi_ops.roi_align_bwd(g, shapes, boxes, bidx, lidx, crop,
                                                            xla), 20)
        p_ms = cuda_ms(torch, lambda: roi_ops.multilevel_gather_bwd_plain(
            g, shapes, boxes, bidx, lidx, crop, xla), 3)
        l_ms = grid_sample_bwd_ms(shapes, boxes, crop, g, images)
        nbytes = bwd_bytes(g, shapes)
        b_ms = nbytes / H100_BYTES_PER_S * 1e3
        log(f"  roi_align_bwd {label} n={boxes.shape[0]} crop={crop}: {k_ms:.4f} ms, "
            f"plain {p_ms:.4f} ms, grid_sample backward {l_ms:.4f} ms, bound {b_ms:.6f} ms "
            f"({nbytes} bytes)")
        return dict(abs=a_err, ms=k_ms, plain_ms=p_ms, lib_ms=l_ms, bytes=nbytes)

    def crowd_cases(shapes):
        """The two crowds at the train step's shapes, as (label, boxes,
        box indices, levels, images): (i) 800 slots of 4 images, 740 of
        them the zero box (the last 185 of each image's 200); (ii) 200
        distinct boxes of image 0 jittered around one object."""
        b = shapes[0][0]
        g = torch.Generator(device="cuda").manual_seed(11)
        n = 200 * b
        boxes = torch.zeros((n, 4), device="cuda")
        yx = torch.rand((b, 15, 2), device="cuda", generator=g) * 0.7
        hw = torch.rand((b, 15, 2), device="cuda", generator=g) * 0.25 + 0.02
        real = torch.cat([yx, yx + hw], -1)
        boxes.view(b, 200, 4)[:, :15] = real
        idx = torch.arange(b, dtype=torch.int32, device="cuda").repeat_interleave(200)
        obj = torch.tensor([0.40, 0.35, 0.52, 0.50], device="cuda")
        cluster = (obj + torch.randn((200, 4), device="cuda", generator=g) * 0.01).clamp(0, 1)
        cases = []
        for label, bx, bi, images in (("crowd (i) zero-padded slots", boxes, idx, b),
                                      ("crowd (ii) cluster on one object", cluster,
                                       torch.zeros(200, dtype=torch.int32, device="cuda"), 1)):
            lvl = (roi_ops.assign_fpn_level(bx, (1024, 1024)) - 2).contiguous()
            cases.append((label, bx.contiguous(), bi, lvl, images))
        require(int((boxes.abs().sum(1) == 0).sum()) == 740, "crowd (i) needs 740 zero boxes")
        require(cluster.unique(dim=0).shape[0] == 200, "crowd (ii) needs 200 distinct boxes")
        return cases

    def bwd_kernel():
        """K3 replayed on the cotangents of the last train step, then on the
        two crowds at the train step's shapes; K1 and K4 on the last train
        step's calls."""
        import torch.nn.functional as F

        calls = train["bwd_calls"]
        require(len(calls) == 2, f"{len(calls)} recorded backward calls, want 2")
        abs_err, ms, plain_ms, lib_ms, nbytes, ops = 0.0, 0.0, 0.0, 0.0, 0, 0
        for args, kwargs in calls:
            g, shapes, boxes, bidx, lidx, crop = args[:6]
            r = check_bwd("train step", g, shapes, boxes, bidx, lidx, crop, shapes[0][0])
            abs_err = max(abs_err, r["abs"])
            ms, plain_ms, lib_ms = ms + r["ms"], plain_ms + r["plain_ms"], lib_ms + r["lib_ms"]
            nbytes += r["bytes"]
            # operations: per valid sample and channel a = g ly, g - a, and
            # each tap's weight and add
            _, _, _, valid = roi_ops.tap_rows(shapes, boxes, bidx, lidx, crop)
            ops += int(valid.sum()) * shapes[0][3] * ROI_BWD_OPS_PER_VALUE
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        t_ops = ops / H100_FP32_OPS_PER_S * 1e3
        log(f"  roi_align_bwd per train step: {ms:.4f} ms over 2 launches, grid_sample backward "
            f"{lib_ms:.4f} ms, plain {plain_ms:.4f} ms; bound: {nbytes} bytes -> {t_bytes:.6f} ms "
            f"at {H100_BYTES_PER_S:.3g} B/s; {ops} fp32 ops -> {t_ops:.6f} ms")
        require(ms < lib_ms, f"K3 per train step ({ms:.4f} ms) is not below grid_sample's "
                f"backward ({lib_ms:.4f} ms)")
        # the two calls' device time by pass, and their wall time
        out = profile_by_family(torch, lambda: [roi_ops.roi_align_bwd(*a[:6]) for a, _ in calls],
                                5, BWD_PASSES)
        log_breakdown("BWD BREAKDOWN the train step's two calls", *out)

        # the two crowds at the train step's shapes and crops
        shapes = calls[0][0][1]
        rng = torch.Generator(device="cuda").manual_seed(12)
        for label, boxes, bidx, lidx, images in crowd_cases(shapes):
            for c in (7, 14):
                g = torch.randn((boxes.shape[0], c, c, shapes[0][3]), device="cuda", generator=rng)
                r = check_bwd(label, g, shapes, boxes, bidx, lidx, (c, c), images)
                abs_err = max(abs_err, r["abs"])

        # K1 on the train path: the last step's two forward poolings, each
        # against its plain version and timed
        fwd_ms, fwd_bound, fwd_err = [], 0.0, 0.0
        with torch.no_grad():
            for args, kwargs in train["fwd_calls"]:
                got = roi_ops.roi_align_fwd(*args, **kwargs)
                want = roi_ops.multilevel_gather_plain(*args, **kwargs)
                torch.cuda.synchronize()
                fwd_err = max(fwd_err, float((got - want).abs().max()))
                fwd_ms.append(cuda_ms(torch, lambda: roi_ops.roi_align_fwd(*args, **kwargs), 20))
                k1_bytes, k1_rows, k1_ops = k1_work(torch, roi_ops, *args[:5])
                b_ms = max(k1_bytes / H100_BYTES_PER_S, k1_ops / H100_FP32_OPS_PER_S) * 1e3
                fwd_bound += b_ms
                log(f"  roi_align_fwd on the train path: n={args[1].shape[0]} crop={args[4]} "
                    f"levels={len(args[0])}: {fwd_ms[-1]:.4f} ms, bound {b_ms:.6f} ms "
                    f"({k1_bytes} bytes, {k1_rows} tap rows)")
                profile_roi.print_trace(profile_roi.kernel_trace(
                    lambda: roi_ops.roi_align_fwd(*args, **kwargs), 10, "cuda"))
        require(len(fwd_ms) == 2, f"{len(fwd_ms)} recorded forward calls in a train step, want 2")
        log(f"  roi_align_fwd per train step: {sum(fwd_ms):.4f} ms over {len(fwd_ms)} launches, "
            f"bound {fwd_bound:.6f} ms; err {fwd_err:.3g} against its plain version")
        require(fwd_err <= 1e-5, f"K1 differs from its plain version by {fwd_err} in training")
        fold_err("roi_align_fwd", fwd_err)

        # K4 on the train path: the last step's three big-set crops (14² of
        # every RoI on P2, P3 and P4 with the jitted JAX crop's sample
        # positions), bit-equal to their plain version, timed beside it, its
        # bytes bound and grid_sample on the same maps and boxes
        calls4 = train["k4_calls"]
        require(len(calls4) == 3, f"{len(calls4)} recorded K4 calls in a train step, want 3")
        k4 = dict(ms=0.0, plain_ms=0.0, lib_ms=0.0, bytes=0, ops=0, err=0.0)
        with torch.no_grad():
            for args, kwargs in calls4:
                image, boxes, crop = args[:3]
                got = roi_ops.crop_and_resize_grouped(*args, **kwargs)
                again = roi_ops.crop_and_resize_grouped(*args, **kwargs)
                want = roi_ops.crop_and_resize_grouped_plain(*args, **kwargs)
                torch.cuda.synchronize()
                require(torch.equal(got, again), "two launches of K4 differ in training")
                err = float((got - want).abs().max())
                k4["err"] = max(k4["err"], err)
                t_ms = cuda_ms(torch, lambda: roi_ops.crop_and_resize_grouped(*args, **kwargs), 20)
                p_ms = cuda_ms(torch, lambda: roi_ops.crop_and_resize_grouped_plain(
                    *args, **kwargs), 3)
                grid = profile_roi.box_grid(boxes.reshape(-1, 4), crop, image.shape[0])
                nchw = image.permute(0, 3, 1, 2)
                l_ms = cuda_ms(torch, lambda: F.grid_sample(
                    nchw, grid, mode="bilinear", padding_mode="zeros", align_corners=True), 20)
                nbytes, rows, ops, b_ms = k45_bound(torch, roi_ops, image, boxes, crop,
                                                    kwargs.get("positions", "pallas"))
                for key, v in (("ms", t_ms), ("plain_ms", p_ms), ("lib_ms", l_ms),
                               ("bytes", nbytes), ("ops", ops)):
                    k4[key] += v
                log(f"  crop_and_resize_grouped on the train path: map {tuple(image.shape)} "
                    f"boxes {tuple(boxes.shape)} crop {crop}: {t_ms:.4f} ms, plain {p_ms:.4f} ms, "
                    f"grid_sample {l_ms:.4f} ms, bound {b_ms:.6f} ms ({nbytes} bytes, {rows} tap "
                    f"rows), err {err:.3g}")
            profile_roi.print_trace(profile_roi.kernel_trace(
                lambda: [roi_ops.crop_and_resize_grouped(*a, **k) for a, k in calls4], 5, "cuda"))
        k4_bytes = k4["bytes"] / H100_BYTES_PER_S * 1e3
        k4_ops = k4["ops"] / H100_FP32_OPS_PER_S * 1e3
        log(f"  crop_and_resize_grouped per train step: {k4['ms']:.4f} ms over 3 launches, "
            f"plain {k4['plain_ms']:.4f} ms, grid_sample {k4['lib_ms']:.4f} ms; bound "
            f"{k4['bytes']} bytes -> {k4_bytes:.6f} ms, {k4['ops']} fp32 ops -> {k4_ops:.6f} ms")
        require(k4["err"] == 0.0, f"K4 differs from its plain version by {k4['err']} in training")
        kernels.append({
            "name": "crop_and_resize_grouped", "route": "cuda",
            "source": "feature_intertwiner_tpu_torch/csrc/crop_and_resize.cu",
            "replaces": "feature_intertwiner_tpu/ops/roi_align.py:339",
            "launches": train["launches"]["crop_and_resize_grouped"], "max_abs_err": k4["err"],
            "ms": k4["ms"], "plain_ms": k4["plain_ms"], "bound_ms": max(k4_bytes, k4_ops),
            "bound_by": "bytes" if k4_bytes >= k4_ops else "operations",
            "library_ms": k4["lib_ms"]})
        kernels.append({
            "name": "roi_align_bwd", "route": "cuda",
            "source": "feature_intertwiner_tpu_torch/csrc/roi_align_bwd.cu",
            "replaces": "feature_intertwiner_tpu/ops/roi_align_window_bwd.py:106",
            "launches": train["launches"]["roi_align_bwd"], "max_abs_err": abs_err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms})

    def bwd_sweep():
        """The ``bwd`` sweep of tools/profile_roi.py (B=8, 200 boxes per
        image over P2-P5 of 1024², 7² and 14²), then K3 held by
        :func:`hold_bwd` on the very tensors it timed, and under K1 through
        autograd against the plain backward and bit-equal over two runs."""
        rows = profile_roi.bwd(batch=8, boxes=200, size=1024, reps=5, device="cuda",
                               dtype="float32")
        log("BWD_SWEEP B=8, 200 boxes per image, P2-P5 of 1024², 256 channels:")
        for r in rows:
            log(f"  {r['route']:64s} {r['dtype']:8s} {r['ms']:.4f} ms")
        k3 = next(r for r in rows if r["route"] == "roi_align_bwd (K3) 14x14")
        out = profile_by_family(torch, lambda: k3["fn"](*k3["args"]), 5, BWD_PASSES)
        log_breakdown("BWD BREAKDOWN the sweep's K3 14x14", *out)
        abs_err = 0.0
        for r in rows:
            if r["fn"] is roi_ops.roi_align_bwd:
                g, shapes = r["args"][:2]
                a_err, _ = hold_bwd(r["route"], *r["args"])
            elif r["fn"] is profile_roi.roi_align_fwd_bwd:
                maps, boxes, bidx, lidx, crop, g = r["args"]
                shapes = [tuple(m.shape) for m in maps]
                got, again = r["fn"](*r["args"]), r["fn"](*r["args"])
                torch.cuda.synchronize()
                same = all(torch.equal(a, b) for a, b in zip(got, again))
                _, a_err, rel, rel32, plain32 = bwd_errors(got, g, shapes, boxes, bidx, lidx, crop)
                del got, again
                log(f"  {r['route']}: rel err {rel:.3g} against the float64 plain backward "
                    f"({rel32:.3g} against float32, itself {plain32:.3g} from float64), "
                    f"two runs bit-equal {same}")
                require(same, f"two runs of {r['route']} differ")
                require(rel <= 1e-5, f"{r['route']} differs from the plain backward by "
                        f"{rel} of its largest gradient")
            else:
                continue
            log(f"  {r['route']}: {r['ms']:.4f} ms, bound "
                f"{bwd_bytes(g, shapes) / H100_BYTES_PER_S * 1e3:.6f} ms")
            abs_err = max(abs_err, a_err)
        fold_err("roi_align_bwd", abs_err)

    if "train_path" not in failures:
        phase("kernel_roi_align_bwd", bwd_kernel)
    else:
        failures.append("kernel_roi_align_bwd (train path failed)")
    train.clear()
    phase("bwd_sweep", bwd_sweep)

    # 6. card against CPU on a small model ------------------------------------
    def small_step_card_and_cpu(tsmall, watch=None, meta_free=False):
        """One train step of a small model on the card and on the CPU from the
        same weights, batch and uniform draws; the CPU is fed the card's
        proposals, so that a near-tie in the proposal NMS cannot change which
        RoIs the draws sample. RoI levels as at 1024² (``tsmall``'s base 56
        over a 128² image) and the FPN tempered as in the train path, so that
        the GT, three of the card's largest proposals per image, gives
        positives on level 3 and a meta loss. The biases are drawn non-zero
        (N(0, 0.005)), as a trained model's are: a bias that starts at zero
        is after one step its update alone, a sum of small gradients whose
        last digits the card and the CPU sum in another order, and would be
        held to its own rounding. ``watch(model, runs, key)`` may wrap the
        model before its step. With ``meta_free``, also a CPU step with the
        meta loss gated off (``cpu_meta_free``). Returns {key: (metrics,
        parameters, buffer, counts)} for the keys ``cuda`` and ``cpu``, and
        each run's TrainState under ``<key>_state``."""
        import numpy as np
        from feature_intertwiner_tpu_torch.train.optim import set_trainable
        from feature_intertwiner_tpu_torch.train.step import create_train_state, train_step

        models = {}
        for key in ("cuda", "cpu") + (("cpu_meta_free",) if meta_free else ()):
            model = seeded_model(build_model, tsmall, seed=3, device=key.split("_")[0])
            biases = torch.Generator().manual_seed(4)
            with torch.no_grad():
                for name, p in model.named_parameters():
                    if name.endswith("bias"):
                        p.copy_(torch.randn(p.shape, generator=biases) * 0.005)
            models[key] = temper_fpn(model)
        rng = np.random.RandomState(5)
        b, gt, size = 2, 5, 128
        images_np = rng.randn(b, size, size, 3) * 40
        with torch.no_grad():
            props = models["cuda"].first_stage(
                torch.as_tensor(images_np, dtype=torch.float32, device="cuda"))[3].cpu().numpy()
        area = (props[..., 2] - props[..., 0]) * (props[..., 3] - props[..., 1])
        boxes_np = np.zeros((b, gt, 4))
        for i in range(b):
            boxes_np[i, :3] = props[i, np.argsort(-area[i])[:3]] * size
        y1x1 = rng.uniform(4, 64, (b, 2, 2))
        boxes_np[:, 3:] = np.concatenate([y1x1, y1x1 + rng.uniform(16, 60, (b, 2, 2))], -1)
        batch_np = {"images": images_np, "gt_class_ids": rng.randint(1, 8, (b, gt)),
                    "gt_boxes": boxes_np, "gt_masks": rng.rand(b, gt, 14, 14) > 0.5}
        dtypes = {"gt_class_ids": torch.int32}
        n_anchors = int(models["cuda"].anchors.shape[0])
        draws_np = {"rpn": rng.rand(b, 2, n_anchors), "det": rng.rand(b, 2, 48)}
        runs = {}
        for key, model in models.items():
            dev = key.split("_")[0]
            st = create_train_state(tsmall, model)
            set_trainable(model, "all")
            batch = {k: torch.as_tensor(v).to(dev, dtypes.get(k, torch.float32))
                     for k, v in batch_np.items()}
            draws = {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
                     for k, v in draws_np.items()}
            if dev == "cuda":
                propose = model._propose
                model._propose = lambda *a: runs.setdefault("proposals", propose(*a))
            else:
                model._propose = lambda *a: runs["proposals"].cpu()
            if watch is not None:
                watch(model, runs, key)
            metrics = train_step(st, tsmall, batch, 0.01, 0.0 if key == "cpu_meta_free" else 1.0,
                                 draws=draws)
            runs[key] = ({k: float(v) for k, v in metrics.items()},
                         {n: p.detach().cpu() for n, p in model.named_parameters()},
                         st.buffer.cpu(), st.buffer_cnt.cpu())
            runs[f"{key}_state"] = st
        return runs

    small_opts = list(FLAGSHIP_OVERRIDES) + SMALL_OPTS
    # two 128² canvases, molded without a padding band: on images molded
    # with one the small random model detects nothing
    small_images = synthetic_images(seed=0, h=128, w=128)

    def small_second_stage(small, label):
        """A small model of config ``small`` on the card and on the CPU from
        the same seeded weights, on two 128² images: the pyramids within 1e-4
        relative, and the second stage fed the card's pyramid and proposals:
        at least one detection, counts and classes equal, boxes within 1 px,
        scores within 1e-4, masks within 1e-4 where the boxes agree."""
        gpu = seeded_model(build_model, small, seed=3)
        cpu = seeded_model(build_model, small, seed=3, device="cpu")
        m_gpu, w_gpu = mold_inputs(small_images, small, "cuda")
        m_cpu, w_cpu = m_gpu.cpu(), w_gpu.cpu()
        with torch.inference_mode():
            pyr_g, _, _, props = gpu.first_stage(m_gpu)
            pyr_c, _, _, _ = cpu.first_stage(m_cpu)
            rel = max(float((a.cpu() - b).abs().max() / b.abs().max())
                      for a, b in zip(pyr_g, pyr_c))
            out_g = gpu.second_stage(pyr_g[:4], props, w_gpu)
            out_c = cpu.second_stage([p.cpu() for p in pyr_g[:4]], props.cpu(), w_cpu)
        dg, dc = out_g["detections"].cpu(), out_c["detections"]
        count = int((dg[..., 5] > 0).sum())
        same_count = bool(((dg[..., 5] > 0).sum(1) == (dc[..., 5] > 0).sum(1)).all())
        box_err = float((dg[..., :4] - dc[..., :4]).abs().max())
        score_err = float((dg[..., 5] - dc[..., 5]).abs().max())
        cls_same = bool((dg[..., 4] == dc[..., 4]).all())
        # masks pool at the detection boxes: compared where the boxes agree
        same_box = (dg[..., :4] == dc[..., :4]).all(-1)
        mask_err = float((out_g["masks"].cpu() - out_c["masks"]).abs()[same_box].max())
        log(f"{label} small model card vs CPU: pyramid rel err {rel:.3g}, {count} detections, "
            f"count equal {same_count}, classes equal {cls_same}, box err {box_err} px, "
            f"score err {score_err:.3g}, mask err {mask_err:.3g}")
        require(rel <= 1e-4 and same_count and cls_same and count > 0,
                f"{label}: the card's pyramid or detections differ from the CPU's, or it "
                f"detects nothing")
        require(box_err <= 1.0 and score_err <= 1e-4 and mask_err <= 1e-4,
                f"{label}: the card's boxes, scores or masks differ from the CPU's")

    def small_step_checked(opts, label):
        """:func:`small_step_card_and_cpu` on the small config of ``opts``
        (RoI levels as at 1024²), held to the train-step tolerances: losses
        within 1e-4 relative, parameters within 1e-5 of each tensor's largest
        magnitude, the buffer within 1e-4; with positives and a meta loss."""
        tsmall = build_config("smoke_small", "train", opts=opts + [
            "ROIS.ASSIGN_ANCHOR_BASE", "56.0"])
        runs = small_step_card_and_cpu(tsmall)
        (mg, pg, bg, cg), (mc, pc, bc, cc) = runs["cuda"], runs["cpu"]
        loss_rel = max(abs(mg[k] - mc[k]) / max(abs(mc[k]), 1e-6) for k in mc
                       if k.endswith("_loss"))
        param_rel, worst = max((float((pg[n] - pc[n]).abs().max()
                                      / pc[n].abs().max().clamp_min(1e-12)), n) for n in pc)
        buf_err = max(float((bg - bc).abs().max()), float((cg - cc).abs().max()))
        log(f"{label} train step card vs CPU: losses rel err {loss_rel:.3g} "
            f"(total {mg['total_loss']:.5f} / {mc['total_loss']:.5f}, positives "
            f"{mg['positive_rois']:.0f}, meta {mg['meta_loss']:.4g}), parameters rel err "
            f"{param_rel:.3g} ({worst}), buffer err {buf_err:.3g}")
        require(loss_rel <= 1e-4 and param_rel <= 1e-5 and buf_err <= 1e-4,
                f"{label}: the card's train step differs from the CPU's")
        require(mg["positive_rois"] > 0 and mg["meta_loss"] > 0,
                f"{label}: the step had no positive RoI or no meta loss")

    def reference():
        small_second_stage(build_config("smoke_small", "inference", opts=small_opts),
                           "REFERENCE")

        # one train step of a small model, card against CPU
        small_step_checked(list(small_opts), "REFERENCE")

    phase("reference", reference)

    # 9. the single-level RoI pooling kernels K4 and K5 -----------------------------
    def roi_single():
        """The ``crop`` and ``stage`` sweeps of tools/profile_roi.py (their
        launches counted from 0); then every kernel route of both sweeps
        against its plain version on the very tensors it was timed on (K4
        and K5 at the ``crop`` shapes, K5 on the ``stage`` P4 map, K1 at the
        ``stage`` 7² and 14² poolings), K4 with a non-zero extrapolation on
        out-of-range and inverted boxes, the gradient of
        ``crop_and_resize_fused`` on the card against the CPU, on the sweep's
        maps and on a 3-channel image of odd width; K4 and K5 one float at a
        time, on a ragged last block, no boxes and a box over two blocks;
        K3 in channel chunks; K4's and K5's launches under the profiler."""
        import torch.nn.functional as F

        cuda_build.launches.clear()
        crop_rows = profile_roi.crop(batch=8, boxes=1024, size=256, reps=5, device="cuda",
                                     dtype="float32")
        with Recorder(roi_ops, "roi_align_fwd") as stage_k1:
            stage_rows = profile_roi.stage(batch=8, boxes=1000, size=1024, reps=5, device="cuda",
                                           dtype="float32")
        launches = {k: cuda_build.launches[k]
                    for k in ("crop_and_resize_grouped", "crop_and_resize_grouped_mm")}
        log("ROI_SINGLE LAUNCHES " + json.dumps(launches))
        for title, rows in (("crop B=8, 1024 boxes per image, 256² x 256, 7²", crop_rows),
                            ("stage B=8, 1000 RoIs per image, P2-P5 of 1024²", stage_rows)):
            log(f"ROI_SINGLE {title}:")
            for r in rows:
                log(f"  {r['route']:64s} {r['dtype']:8s} {r['ms']:.4f} ms")
        require(all(v >= 1 for v in launches.values()), f"K4/K5 launches {launches}")
        route = {r["route"].split(" ")[0]: r for r in crop_rows}
        plains = {"crop_and_resize_grouped": roi_ops.crop_and_resize_grouped_plain,
                  "crop_and_resize_grouped_mm": roi_ops.crop_and_resize_grouped_mm_plain}

        def held(row):
            """The row's kernel result against its plain version, both on the
            tensors the sweep timed; two launches must be bit-equal."""
            with torch.no_grad():
                got, again = row["fn"](*row["args"]), row["fn"](*row["args"])
                want = plains[row["fn"].__name__](*row["args"])
            torch.cuda.synchronize()
            require(torch.equal(got, again), f"two launches of {row['route']} differ")
            return float((got - want).abs().max())

        # K5 and K1 at the stage sweep's shapes
        stage_k5 = next(r for r in stage_rows if "(K5)" in r["route"])
        stage_err = held(stage_k5)
        log(f"  {stage_k5['route']}: err {stage_err:.3g} against its plain version")
        require(stage_err <= 1e-5, f"K5 differs from its plain version by {stage_err} on P4")
        k1_err = 0.0
        for crop_s in (7, 14):
            args, kwargs = next(c for c in stage_k1.calls if tuple(c[0][4]) == (crop_s, crop_s))
            with torch.no_grad():
                got = roi_ops.roi_align_fwd(*args, **kwargs)
                want = roi_ops.multilevel_gather_plain(*args, **kwargs)
            torch.cuda.synchronize()
            e = float((got - want).abs().max())
            k1_err = max(k1_err, e)
            log(f"  multilevel RoIAlign {crop_s}x{crop_s} (K1), stage sweep: err {e:.3g} "
                f"against its plain version")
        del stage_k1, got, want
        require(k1_err <= 1e-5, f"K1 differs from its plain version by {k1_err} in the stage sweep")
        fold_err("roi_align_fwd", k1_err)

        # K5 on the stage P4 map beside its plain version, its bound and
        # grid_sample on the same map and boxes
        p4, p4_boxes, p4_crop = stage_k5["args"]
        s_bytes, s_rows, _, s_bound = k45_bound(torch, roi_ops, p4, p4_boxes, p4_crop)
        s_plain = cuda_ms(torch, lambda: roi_ops.crop_and_resize_grouped_mm_plain(*stage_k5["args"]),
                          2)
        grid = profile_roi.box_grid(p4_boxes.reshape(-1, 4), p4_crop, p4.shape[0])
        s_lib = cuda_ms(torch, lambda: F.grid_sample(p4.permute(0, 3, 1, 2), grid, mode="bilinear",
                                                     padding_mode="zeros", align_corners=True), 5)
        log(f"  {stage_k5['route']}: {stage_k5['ms']:.4f} ms, plain {s_plain:.4f} ms, grid_sample "
            f"{s_lib:.4f} ms; bound {s_bytes} bytes ({s_rows} tap rows) -> {s_bound:.6f} ms")

        image, boxes, crop = route["crop_and_resize_grouped"]["args"]
        g = torch.Generator(device="cuda").manual_seed(7)
        wild = (torch.rand((8, 256, 4), device="cuda", generator=g) * 1.8 - 0.4).contiguous()
        nbytes, rows, ops, bound_ms = k45_bound(torch, roi_ops, image, boxes, crop)
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        t_ops = ops / H100_FP32_OPS_PER_S * 1e3
        lib_ms = route["F.grid_sample"]["ms"]
        for name, line in (("crop_and_resize_grouped", "roi_align.py:339"),
                           ("crop_and_resize_grouped_mm", "roi_align.py:507")):
            r = route[name]
            err = held(r)
            p_ms = cuda_ms(torch, lambda: plains[name](*r["args"]), 2)
            log(f"  {name}: err {err:.3g}, {r['ms']:.4f} ms, plain {p_ms:.4f} ms, "
                f"grid_sample {lib_ms:.4f} ms; bound {nbytes} bytes "
                f"({rows} tap rows) -> {t_bytes:.6f} ms, {ops} fp32 ops -> {t_ops:.6f} ms")
            require(err == 0.0, f"{name} differs from its plain version by {err}")
            if name == "crop_and_resize_grouped":
                # K4's entry is the train path's (bwd_kernel): this sweep is off it
                fold_err(name, err)
                continue
            err = max(err, stage_err)
            kernels.append({
                "name": name, "route": "cuda",
                "source": "feature_intertwiner_tpu_torch/csrc/crop_and_resize.cu",
                "replaces": f"feature_intertwiner_tpu/ops/{line}",
                "launches": launches[name], "max_abs_err": err, "ms": r["ms"],
                "plain_ms": p_ms, "bound_ms": bound_ms,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": lib_ms})
        for crop_w in ((7, 7), (1, 1), (5, 9)):
            got = roi_ops.crop_and_resize_grouped(image, wild, crop_w, -1.5)
            want = roi_ops.crop_and_resize_grouped_plain(image, wild, crop_w, -1.5)
            got_mm = roi_ops.crop_and_resize_grouped_mm(image, wild, crop_w)
            want_mm = roi_ops.crop_and_resize_grouped_mm_plain(image, wild, crop_w)
            torch.cuda.synchronize()
            e, e_mm = float((got - want).abs().max()), float((got_mm - want_mm).abs().max())
            extrap = int((got == -1.5).sum())
            log(f"  out-of-range and inverted boxes, crop {crop_w}: K4 extrapolation -1.5 err "
                f"{e:.3g} ({extrap} values extrapolated), K5 err {e_mm:.3g}")
            require(e <= 1e-5 and e_mm <= 1e-5 and extrap > 0,
                    "K4/K5 differ from their plain versions on out-of-range boxes")

        # the fused gradient, card against the CPU's plain versions: on the
        # sweep's maps, then on an RGB image 51 pixels wide, whose map rows
        # start off 16-byte boundaries: small boxes leave most tiles to one
        # work item that writes the map itself, and 12 zero boxes per image
        # give tile (0, 0) several
        rgb = torch.randn((2, 40, 51, 3), device="cuda", generator=g)
        yx = torch.rand((2, 64, 2), device="cuda", generator=g) * 0.85
        hw = torch.rand((2, 64, 2), device="cuda", generator=g) * 0.1 + 0.02
        rgb_boxes = torch.cat([yx, yx + hw], -1)
        rgb_boxes[:, :12] = 0.0
        for label, sub_img, sub_boxes in (
                ("256 channels", image[:2].clone(), boxes[:2, :256].contiguous()),
                ("3 channels, 51 wide", rgb, rgb_boxes)):
            grads = []
            for dev in ("cuda", "cpu"):
                x = sub_img.detach().to(dev).requires_grad_(True)
                out = roi_ops.crop_and_resize_fused(x, sub_boxes.to(dev), crop)
                (out * out).sum().backward()
                grads.append(x.grad.cpu())
            top = float(grads[1].abs().max())
            g_err = float((grads[0] - grads[1]).abs().max()) / max(top, 1e-30)
            log(f"  crop_and_resize_fused gradient card vs CPU, {label}: rel err {g_err:.3g} "
                f"(max |grad| {top:.4g})")
            require(g_err <= 1e-5, f"the fused gradient differs by {g_err} of its largest "
                    f"value ({label})")

        # K4 and K5 off the sweep's shapes, each call bit-equal to its plain
        # version and over two launches, at crops 7², 1² and 5x9, K4 at
        # extrapolation 0 and -1.5: one float at a time (map rows that do not
        # start on 16-byte boundaries: the RGB image, a 6-channel map; a
        # 256-channel map that starts 4 bytes off one), a ragged last block,
        # no boxes, and a box whose sample rows span two blocks
        six = torch.randn((2, 24, 37, 6), device="cuda", generator=g)
        off = torch.empty(2 * 20 * 24 * 256 + 1, device="cuda")[1:].view(2, 20, 24, 256)
        off.normal_(generator=g)
        calls = (("crop_and_resize_grouped", (0.0,)), ("crop_and_resize_grouped", (-1.5,)),
                 ("crop_and_resize_grouped_mm", ()))
        case_err = dict.fromkeys(plains, 0.0)
        for label, img, bx, width in (
                ("3 channels, 51 wide", rgb, rgb_boxes, 1),
                ("6 channels", six, wild[:2, :64].contiguous(), 1),
                ("256 channels, 4 bytes off", off, wild[:2, :64].contiguous(), 1),
                ("ragged last block", image[:1], wild[:1, :37].contiguous(), 4),
                ("no boxes", image[:2], wild[:2, :0].contiguous(), 4),
                ("a box over two blocks", image[:1], boxes[:1, :2].contiguous(), 4)):
            vec = roi_ops.mm_vector_width(img)
            require(vec == width, f"K4/K5 read {vec} floats at a time on {label}, want {width}")
            for crop_w in ((7, 7), (1, 1), (5, 9)):
                rows, blocks, _ = roi_ops.fwd_plan(bx.shape[0] * bx.shape[1], crop_w, img.shape[3],
                                                   vec)
                if label == "ragged last block":
                    require(bx.shape[1] * crop_w[0] % rows, f"no ragged block at {crop_w}")
                if label == "a box over two blocks" and crop_w[0] > 1:
                    require(crop_w[0] // rows != (2 * crop_w[0] - 1) // rows,
                            f"the second box's rows lie in one block at {crop_w}")
                line = []
                for name, extra in calls:
                    before = cuda_build.launches[name]
                    got = getattr(roi_ops, name)(img, bx, crop_w, *extra)
                    again = getattr(roi_ops, name)(img, bx, crop_w, *extra)
                    want = plains[name](img, bx, crop_w, *extra)
                    torch.cuda.synchronize()
                    e = float((got - want).abs().max()) if got.numel() else 0.0
                    case_err[name] = max(case_err[name], e)
                    same = torch.equal(got, again)
                    line.append(f"{'K5' if extra == () else f'K4 at {extra[0]}'} err {e:.3g}, "
                                f"two launches bit-equal {same}")
                    require(got.shape == want.shape and torch.equal(got, want) and same,
                            f"{name} differs from its plain version or itself ({label}, "
                            f"{crop_w}, {extra})")
                    require(cuda_build.launches[name] - before == (2 if bx.shape[1] else 0),
                            f"{name} launched {cuda_build.launches[name] - before} times")
                log(f"  K4/K5 {label}, {vec} float(s) at a time, crop {crop_w}, {rows} rows per "
                    f"block over {blocks} blocks: " + "; ".join(line))
        for name, e in case_err.items():
            fold_err(name, e)

        # K3 on a map wider than one launch's shared-memory tile: the fused
        # gradient of 2,048 channels at 7², card against the CPU, then the
        # chunked call against one call per half of the channels, bit-equal
        wide = torch.randn((2, 24, 40, 2048), device="cuda", generator=g)
        wide_boxes = rgb_boxes[:, :48].contiguous()
        grads = []
        for dev in ("cuda", "cpu"):
            x = wide.detach().to(dev).requires_grad_(True)
            out = roi_ops.crop_and_resize_fused(x, wide_boxes.to(dev), (7, 7))
            (out * out).sum().backward()
            grads.append(x.grad.cpu())
        top = float(grads[1].abs().max())
        g_err = float((grads[0] - grads[1]).abs().max()) / max(top, 1e-30)
        flat = wide_boxes.reshape(-1, 4)
        idx = torch.arange(2, dtype=torch.int32, device="cuda").repeat_interleave(48)
        level = torch.zeros_like(idx)
        gw = torch.randn((96, 7, 7, 2048), device="cuda", generator=g)
        cuda_build.launches.clear()
        (full,) = roi_ops.roi_align_bwd(gw, [tuple(wide.shape)], flat, idx, level, (7, 7))
        chunk_launches = cuda_build.launches["roi_align_bwd"]
        halves = [roi_ops.roi_align_bwd(gw[..., c0:c0 + 1024].contiguous(), [(2, 24, 40, 1024)],
                                        flat, idx, level, (7, 7))[0] for c0 in (0, 1024)]
        same = torch.equal(full, torch.cat(halves, -1))
        log(f"  roi_align_bwd at 2048 channels, 7x7: fused gradient card vs CPU rel err "
            f"{g_err:.3g} (max |grad| {top:.4g}); {chunk_launches} launches over "
            f"{roi_ops.bwd_channel_chunks(2048, (7, 7))}, bit-equal to one call per half {same}")
        require(g_err <= 1e-5, f"the 2,048-channel fused gradient differs by {g_err}")
        require(same and chunk_launches == 2, "the chunked backward differs from its halves")
        fold_err("roi_align_bwd", g_err * top)

        # the bfloat16 entry of K4 and K5: the crop sweep on a bfloat16 map
        # (widened once per call, the float32 kernel, the crops rounded once),
        # each route bit-equal to its plain version and over two launches on
        # the tensors it timed, beside the widening copy and the rounding
        crop16 = profile_roi.crop(batch=8, boxes=1024, size=256, reps=5, device="cuda",
                                  dtype="bfloat16")
        route16 = {r["route"].split(" ")[0]: r for r in crop16}
        image16, boxes16, _ = route16["crop_and_resize_grouped"]["args"]
        out32 = roi_ops.crop_and_resize_grouped(image16.float(), boxes16, crop)
        copy_ms = cuda_ms(torch, lambda: (image16.float(), out32.bfloat16()), 5)
        for name in plains:
            r = route16[name]
            err = held(r)
            require(err == 0.0, f"{name} on bfloat16 differs from its plain version by {err}")
            log(f"  {name} bfloat16 entry (crop sweep): err {err:.3g}, {r['ms']:.4f} ms against "
                f"{route[name]['ms']:.4f} ms in float32; the widening and rounding copies "
                f"{copy_ms:.4f} ms per call; grid_sample bfloat16 "
                f"{route16['F.grid_sample']['ms']:.4f} ms")

        # where K4's and K5's time goes: their launches at the crop shapes, K5's
        # at the stage shapes
        for r in (route["crop_and_resize_grouped"], route["crop_and_resize_grouped_mm"],
                  stage_k5):
            with torch.no_grad():
                trace = profile_roi.kernel_trace(lambda: r["fn"](*r["args"]), 5, "cuda")
            log(f"  {r['route']} kernels per call:")
            profile_roi.print_trace(trace)

    phase("roi_single", roi_single)

    # 10. the window probe K6 ---------------------------------------------------------
    def window_probe():
        """The ``window`` sweep of tools/profile_roi.py (launches counted from
        0), then each size's K6 on the map and origins the sweep timed, bit
        for bit against its plain version and over two launches, with its
        bytes and adds bounds; K6 on the hard cases, bit-equal likewise; and
        K6's kernels under torch.profiler at 8x8 and 64x64."""
        import numpy as np

        from feature_intertwiner_tpu_torch.ops import window_sum as ws

        def bits(a, b):
            return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))

        cuda_build.launches.clear()
        rows = profile_roi.window(batch=8, size=256, boxes=4096, reps=5, device="cuda")
        launches = cuda_build.launches["window_sum"]
        k6_rows = [r for r in rows if r["fn"] is ws.window_sum]
        abs_err, ms, plain_ms, bound_ms, adds_bound_ms = 0.0, 0.0, 0.0, 0.0, 0.0
        for r in k6_rows:
            img, o, sy, sx = r["args"]
            got, again, want = r["fn"](*r["args"]), r["fn"](*r["args"]), ws.window_sum_plain(*r["args"])
            torch.cuda.synchronize()
            same = bits(got, want) and bits(got, again)
            err = float((got - want).abs().max())
            abs_err = max(abs_err, err)
            p_ms = cuda_ms(torch, lambda: ws.window_sum_plain(img, o, sy, sx), 1)
            # least bytes: the map pixels some window covers, read once (the
            # windows overlap), the origins, and the sums written once; adds:
            # one fp32 add per window element, one issue slot each
            covered = covered_pixels(torch, o, img.shape, sy, sx)
            call_bytes = covered * img.shape[3] * img.element_size() + o.numel() * 4 + got.numel() * 4
            b_ms = call_bytes / H100_BYTES_PER_S * 1e3
            a_ms = o.shape[0] * sy * sx * img.shape[3] / H100_FP32_ADDS_PER_S * 1e3
            plan = ws.window_plan(o.shape[0], sy, sx, img.shape[3], img.dtype, img.shape[2],
                                  ws.window_vec(img))
            log(f"  window_sum {sy}x{sx}: bit-equal to plain and over two launches {same} (max "
                f"|diff| {err:.3g}), {r['ms']:.4f} ms, {r['GB/s']:.1f} GB/s of {r['bytes']} window "
                f"bytes; bound: bytes {b_ms:.4f} ms ({covered} pixels covered), adds "
                f"{a_ms:.4f} ms -> {max(b_ms, a_ms) / r['ms']:.1%} of bound; plain {p_ms:.3f} ms; "
                f"group {plan.group}, {plan.blocks} blocks, {plan.shared} B shared")
            require(same, f"window_sum {sy}x{sx} differs from its plain version or between launches")
            ms, plain_ms = ms + r["ms"], plain_ms + p_ms
            bound_ms += max(b_ms, a_ms)
            adds_bound_ms += a_ms if a_ms > b_ms else 0.0
        for r in rows:
            if r["route"].startswith("row_gather"):
                log(f"  {r['route']}: {r['ms']:.4f} ms, {r['GB/s']:.1f} GB/s of {r['bytes']} bytes")
        log(f"WINDOW LAUNCHES {launches}; sweep {ms:.4f} ms against a bound of {bound_ms:.4f} "
            f"({bound_ms / ms:.1%})")
        require(len(k6_rows) == 7 and launches >= len(k6_rows),
                f"window_sum launched {launches} times over {len(k6_rows)} sizes")

        # the hard cases, each bit-equal to the plain version over two launches
        g = np.random.RandomState(5)
        dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()  # noqa: E731

        def origins_for(n, b, h, w, sy, sx):
            return np.stack([g.randint(0, b, n), g.randint(0, h - sy + 1, n),
                             g.randint(0, (w - sx) // 8 + 1, n)], 1).astype(np.int32)

        m = dev(g.randn(2, 128, 80, 256).astype(np.float32)).bfloat16()
        mixed = origins_for(100, 2, 128, 80, 48, 12)
        mixed[:, 0] = np.r_[np.zeros(40), np.ones(60)]        # a group over both images
        mixed[50:55] = mixed[10]                              # repeated origins
        mixed[90:] = [[-1, 0, 0], [2, 0, 0], [0, 100, 0], [0, -1, 0], [1, 0, 9], [1, 0, -1],
                      [0, 81, 1], [1, 20, 8], [5, 5, 5], [0, 128, 0]]   # 9 out of the map
        thin = origins_for(300, 2, 128, 80, 112, 5)
        fp = dev(g.randn(2, 48, 320, 256).astype(np.float32))
        m66 = dev(g.randn(2, 40, 64, 66).astype(np.float32)).bfloat16()
        off = torch.zeros(m.numel() + 2, dtype=torch.bfloat16, device="cuda")[2:].view(m.shape)
        off.copy_(m)                                         # 4 bytes off an 8-byte boundary
        none = np.zeros((0, 3), np.int32)
        m3 = dev(g.randn(2, 64, 96, 3).astype(np.float32)).bfloat16()          # RGB
        odd = torch.zeros(m66.numel() + 1, dtype=torch.bfloat16, device="cuda")[1:]
        odd = odd.view(m66.shape)
        odd.copy_(m66)                                       # one channel off a pair
        cases = [("bf16, C = 3, read directly", m3, origins_for(200, 2, 64, 96, 8, 8), 8, 8),
                 ("bf16, C = 3, 24x24 read directly", m3, origins_for(200, 2, 64, 96, 24, 24),
                  24, 24),
                 ("fp32, C = 3, 24x24 read directly", m3.float(),
                  origins_for(200, 2, 64, 96, 24, 24), 24, 24),
                 ("bf16, a map one channel off a pair, 16x32 read directly", odd,
                  origins_for(130, 2, 40, 64, 16, 32), 16, 32),
                 ("bf16, out of the map, repeated, over two images", m, mixed, 48, 12),
                 ("bf16, the same origins, read directly", m, mixed, 4, 4),
                 ("bf16, sx 5", m, thin, 112, 5), ("bf16, sx 5, read directly", m, thin, 8, 5),
                 ("bf16, sx 12, read directly", m, mixed, 8, 12),
                 ("fp32, rows in three pieces", fp, origins_for(500, 2, 48, 320, 16, 32), 16, 32),
                 ("fp32, read directly", fp, origins_for(500, 2, 48, 320, 8, 8), 8, 8),
                 ("bf16, C = 66", m66, origins_for(130, 2, 40, 64, 16, 32), 16, 32),
                 ("fp32, C = 66", m66.float(), origins_for(130, 2, 40, 64, 16, 32), 16, 32),
                 ("bf16, C = 66, read directly", m66, origins_for(130, 2, 40, 64, 4, 4), 4, 4),
                 ("bf16, V = 2 on a map off an 8-byte boundary", off, mixed, 48, 12),
                 ("no windows", m, none, 16, 32), ("no windows, read directly", m, none, 4, 4)]
        for name, im, org, sy, sx in cases:
            o = dev(org)
            cuda_build.launches.clear()
            got, again = ws.window_sum(im, o, sy, sx), ws.window_sum(im, o, sy, sx)
            want = ws.window_sum_plain(im, o, sy, sx)
            torch.cuda.synchronize()
            plan = ws.window_plan(o.shape[0], sy, sx, im.shape[3], im.dtype, im.shape[2],
                                  ws.window_vec(im))
            same = bits(got, want) and bits(got, again)
            log(f"  window_sum {name} ({o.shape[0]} windows of {sy}x{sx} on "
                f"{list(im.shape)}): bit-equal to plain and over two launches {same}; group "
                f"{plan.group}, V {plan.vec}, piece {plan.piece}, {plan.blocks} blocks, "
                f"{cuda_build.launches['window_sum']} launches")
            require(same and cuda_build.launches["window_sum"] == (2 if o.shape[0] else 0),
                    f"window_sum on {name} differs from its plain version or between launches")
            require((plan.group == 1) == ("directly" in name), f"{name}: group {plan.group}")

        # where K6's time goes at the sweep's smallest and largest windows
        for r in (k6_rows[0], k6_rows[-1]):
            img, o, sy, sx = r["args"]
            trace = profile_roi.kernel_trace(lambda: ws.window_sum(img, o, sy, sx), 5, "cuda")
            log(f"  window_sum {sy}x{sx} kernels per call:")
            profile_roi.print_trace(trace)
        kernels.append({
            "name": "window_sum", "route": "cuda",
            "source": "feature_intertwiner_tpu_torch/csrc/window_sum.cu",
            "replaces": "scripts/profile_window_dma.py:39", "launches": launches,
            "max_abs_err": abs_err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if adds_bound_ms > bound_ms / 2 else "bytes",
            "library_ms": None})

    phase("window_probe", window_probe)

    # 11. evaluation: test_model on the card ------------------------------------------
    def eval_path():
        """``test_model`` with the flagship model (seeded, tempered weights)
        over 16 synthetic images on the card, its launches counted from 0:
        per batch of TEST.BATCH_SIZE images K1 twice and K2 at least twice,
        each call then held against its plain version on the same tensors.
        Then a small model evaluates the same way on the card and on the CPU
        (fed the card's proposals): the same detections and stats."""
        import contextlib
        import io
        import shutil
        import tempfile

        from feature_intertwiner_tpu_torch.data import synthetic
        from feature_intertwiner_tpu_torch.evaluation import COCO
        from feature_intertwiner_tpu_torch.train import workflow

        def evaluate(model, ecfg, data, tag, eval_masks=True):
            folder = tempfile.mkdtemp(prefix=f"chip_smoke_eval_{tag}_", dir=os.path.join(ROOT, "build"))
            ecfg.MISC.RESULT_FOLDER = folder
            ecfg.MISC.LOG_FILE = os.path.join(folder, "log.txt")
            api = COCO(dataset=data.coco_dataset())
            with contextlib.redirect_stdout(io.StringIO()):    # COCOeval's tables
                t0 = time.perf_counter()
                stats = workflow.test_model(model, ecfg, data, api, epoch=0, eval_masks=eval_masks)
                wall = time.perf_counter() - t0
                with open(workflow.cache_path(ecfg, 0, data.num_images, eval_masks)) as f:
                    results = json.load(f)
                segm = workflow.coco_stats(api, results, [i["id"] for i in data.image_info], "segm")
            shutil.rmtree(folder, ignore_errors=True)
            return stats, segm, results, wall

        data = synthetic.generate(num_images=16)
        ecfg = build_config("meta_105_quick_1", "inference", opts=list(FLAGSHIP_OVERRIDES))
        ecfg.DATASET.NUM_CLASSES = data.num_classes
        model = seeded_model(build_model, ecfg, seed=0)
        detect(model, [data.load_image(0), data.load_image(1)], ecfg)    # warm-up
        torch.cuda.synchronize()
        batches = math.ceil(data.num_images / ecfg.TEST.BATCH_SIZE)
        cuda_build.launches.clear()
        with Recorder(roi_ops, "roi_align_fwd") as roi_rec, \
                Recorder(nms_ops, "nms_alive") as nms_rec:
            stats, segm, results, wall = evaluate(model, ecfg, data, "flagship")
        launches = {k: cuda_build.launches[k] for k in ("roi_align_fwd", "nms_alive")}
        log(f"EVAL LAUNCHES {json.dumps(launches)} over {batches} batches of "
            f"{ecfg.TEST.BATCH_SIZE}; {len(results)} detections on {data.num_images} images; "
            f"test_model {wall:.2f} s, {data.num_images / wall:.2f} images/s (COCOeval included)")
        log("EVAL bbox " + " ".join(f"{v:.3f}" for v in stats))
        log("EVAL segm " + " ".join(f"{v:.3f}" for v in segm))
        require(launches["roi_align_fwd"] == 2 * batches, f"K1 launches {launches}")
        require(launches["nms_alive"] >= 2 * batches, f"K2 launches {launches}")
        require(len(results) > 0 and all(math.isfinite(r["score"]) for r in results),
                "no detections, or a non-finite score")
        k1_err, mism, k1_bytes, k1_ops = 0.0, 0, 0, 0
        with torch.inference_mode():
            for args, kwargs in roi_rec.calls:
                got = roi_ops.roi_align_fwd(*args, **kwargs)
                want = roi_ops.multilevel_gather_plain(*args, **kwargs)
                k1_err = max(k1_err, float((got - want).abs().max()))
                nbytes, _, n_ops = k1_work(torch, roi_ops, *args[:5])
                k1_bytes, k1_ops = k1_bytes + nbytes, k1_ops + n_ops
            needed = []
            for args, kwargs in nms_rec.calls:
                got = nms_ops.nms_alive(*args, **kwargs)
                want = nms_ops.greedy_alive_sorted_plain(*args, **kwargs)
                mism += int((got != want).sum())
                needed.append((*args[:2], want, args[2], call_opts(args, kwargs)))
            _, _, _, t_ops, t_bytes = nms_bound(nms_ops, needed)
        torch.cuda.synchronize()
        k1_tb, k1_to = k1_bytes / H100_BYTES_PER_S * 1e3, k1_ops / H100_FP32_OPS_PER_S * 1e3
        log(f"EVAL kernels against their plain versions on the eval path's tensors: "
            f"roi_align_fwd err {k1_err:.3g} over {len(roi_rec.calls)} calls "
            f"(n={[int(a[1].shape[0]) for a, _ in roi_rec.calls]}; bound per batch "
            f"{max(k1_tb, k1_to) / batches:.6f} ms by {'bytes' if k1_tb >= k1_to else 'operations'}"
            f"), nms_alive {mism} "
            f"mismatches over {len(nms_rec.calls)} calls "
            f"(shapes {[tuple(a[0].shape) for a, _ in nms_rec.calls]}; bound per batch "
            f"{max(t_ops, t_bytes) / batches:.6f} ms by "
            f"{'operations' if t_ops >= t_bytes else 'bytes'})")
        require(k1_err <= 1e-5 and mism == 0, "K1 or K2 differs from its plain version in eval")
        fold_err("roi_align_fwd", k1_err)
        fold_err("nms_alive", float(mism > 0))
        del roi_rec, nms_rec
        chunk = [data.load_image(i) for i in range(ecfg.TEST.BATCH_SIZE)]
        t0 = time.perf_counter()
        detect(model, chunk, ecfg)
        torch.cuda.synchronize()
        det_s = time.perf_counter() - t0
        log(f"EVAL detect() on one batch of {len(chunk)}: {det_s * 1e3:.1f} ms, "
            f"{len(chunk) / det_s:.2f} images/s")
        out = profile_by_family(torch, lambda: detect(model, chunk, ecfg), 1, families)
        log_breakdown(f"EVAL BREAKDOWN detect() of {len(chunk)} images with masks", *out)
        del model

        # a small model, card against CPU, the CPU fed the card's proposals
        small = build_config("smoke_small", "inference", opts=list(FLAGSHIP_OVERRIDES) + [
            "MODEL.BACKBONE", "resnet50", "DATA.IMAGE_MIN_DIM", "96", "DATA.IMAGE_MAX_DIM", "128",
            "RPN.ANCHOR_SCALES", "(8, 16, 32, 64, 128)", "RPN.PRE_NMS_LIMIT", "200",
            "RPN.POST_NMS_ROIS_INFERENCE", "48", "TEST.DET_MAX_INSTANCES", "8"])
        # 128² canvases: molding neither scales nor pads them, so both devices
        # see the same pixels and the random model's proposals lie on them
        sdata = synthetic.generate(num_images=24, size=(128, 128), seed=4, max_instances=3)
        small.DATASET.NUM_CLASSES = sdata.num_classes
        proposals = []
        runs = {}
        for dev in ("cuda", "cpu"):
            m = seeded_model(build_model, small, seed=3, device=dev)
            propose = m._propose
            if dev == "cuda":
                m._propose = lambda *a, f=propose: proposals.append(f(*a)) or proposals[-1]
            else:
                m._propose = lambda *a: proposals.pop(0).cpu()
            runs[dev] = evaluate(m, small, sdata, dev)
        (sg, mg, rg, _), (sc, mc, rc, _) = runs["cuda"], runs["cpu"]
        same = len(rg) == len(rc) and all(
            a["image_id"] == b["image_id"] and a["category_id"] == b["category_id"]
            for a, b in zip(rg, rc))
        box_err = max((max(abs(u - v) for u, v in zip(a["bbox"], b["bbox"]))
                       for a, b in zip(rg, rc)), default=0.0)
        score_err = max((abs(a["score"] - b["score"]) for a, b in zip(rg, rc)), default=0.0)
        stat_err = float(max(abs(sg - sc).max(), abs(mg - mc).max()))
        log(f"EVAL small model card vs CPU: {len(rg)} / {len(rc)} detections, images and "
            f"classes equal {same}, box err {box_err} px, score err {score_err:.3g}, "
            f"stats err {stat_err:.3g} (bbox AP {sg[0]:.3f} / {sc[0]:.3f})")
        require(same and len(rg) > 0 and box_err <= 1.0 and score_err <= 1e-4 and stat_err <= 0.02,
                "the card's evaluation differs from the CPU's")

    phase("eval_path", eval_path)

    # 12-15. bfloat16, as the JAX main.py runs the flagship ---------------------------

    def paired(fns, reps, events=False):
        """Medians of ``reps`` calls of each of two callables in turns: a,
        b, b, a (each call ends on a synchronised device), timed by the
        host clock or, with ``events``, by CUDA events around each call."""
        times = {k: [] for k in fns}
        order = list(fns) + list(fns)[::-1]
        for _ in range(reps):
            for k in order:
                t0, e0 = time.perf_counter(), torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                fns[k]()
                e1.record()
                torch.cuda.synchronize()
                times[k].append(e0.elapsed_time(e1) if events
                                else (time.perf_counter() - t0) * 1e3)
        return {k: sorted(v)[len(v) // 2] for k, v in times.items()}, times

    def widen_ms(feats, out):
        """The bfloat16 entry's copies of one K1 call: each level widened to
        float32 and the float32 crops rounded to bfloat16."""
        wide = roi_ops.roi_align_fwd([f.float() for f in feats], *out)
        return cuda_ms(torch, lambda: ([f.float() for f in feats], wide.bfloat16()), 10)

    def hold_k1_bf16(calls, label):
        """Each recorded K1 call on bfloat16 maps, bit-equal to its plain
        version (the float32 plain version on the widened maps, rounded) and
        over two launches; its time beside the float32 kernel on the widened
        maps and the copies. Returns (error, ms, float32 ms, copies ms)."""
        err, ms, ms32, copies = 0.0, 0.0, 0.0, 0.0
        for args, kwargs in calls:
            feats, rest = args[0], args[1:]
            require(all(f.dtype == torch.bfloat16 for f in feats), f"{label}: K1 maps not bf16")
            got = roi_ops.roi_align_fwd(feats, *rest, **kwargs)
            again = roi_ops.roi_align_fwd(feats, *rest, **kwargs)
            want = roi_ops.multilevel_gather_plain(feats, *rest, **kwargs)
            torch.cuda.synchronize()
            require(got.dtype == torch.bfloat16 and torch.equal(got, want)
                    and torch.equal(got, again),
                    f"{label}: K1 on bfloat16 maps differs from its plain version or itself")
            err = max(err, float((got.float() - want.float()).abs().max()))
            wide = [f.float() for f in feats]
            k_ms = cuda_ms(torch, lambda: roi_ops.roi_align_fwd(feats, *rest, **kwargs), 10)
            k32 = cuda_ms(torch, lambda: roi_ops.roi_align_fwd(wide, *rest, **kwargs), 10)
            c_ms = widen_ms(feats, rest)
            ms, ms32, copies = ms + k_ms, ms32 + k32, copies + c_ms
            log(f"  {label} roi_align_fwd bf16 n={rest[0].shape[0]} crop={tuple(rest[3])}: "
                f"bit-equal to plain, {k_ms:.4f} ms; the float32 kernel on the widened maps "
                f"{k32:.4f} ms; widening P2-P5 and rounding the crops {c_ms:.4f} ms")
        return err, ms, ms32, copies

    def bf16_main_path():
        """The flagship's ``detect()`` in bfloat16 (float32 parameters),
        counted from 0: K1 twice and K2 at least twice; the outputs' shapes,
        finiteness and ranges; each K1 call bit-equal to its plain version;
        ``detect()`` and ``forward_inference`` per batch of 2 paired with
        float32 in turns; the bfloat16 forward's device time by family."""
        m16 = seeded_model(build_model, cfg, seed=0, dtype=torch.bfloat16)
        m32 = seeded_model(build_model, cfg, seed=0)
        for m in (m16, m32):
            detect(m, images, cfg)                      # warm-up
        torch.cuda.synchronize()
        cuda_build.launches.clear()
        with Recorder(roi_ops, "roi_align_fwd") as roi_rec, \
                Recorder(nms_ops, "nms_alive") as nms_rec:
            results = detect(m16, images, cfg)
        launches = {k: cuda_build.launches[k] for k in ("roi_align_fwd", "nms_alive")}
        log("BF16 LAUNCHES " + json.dumps(launches))
        require(launches["roi_align_fwd"] == 2 and launches["nms_alive"] >= 2,
                f"bf16 main path launches {launches}")
        require(all(p.dtype == torch.float32 for p in m16.parameters()), "a bf16 parameter")
        molded, windows = mold_inputs(images, cfg, "cuda")
        with torch.inference_mode():
            pyramid, probs, _, proposals = m16.first_stage(molded)
            out = m16.second_stage(pyramid[:4], proposals, windows)
        det, masks = out["detections"], out["masks"]
        require(pyramid[0].dtype == torch.bfloat16 and probs.dtype == torch.float32
                and det.dtype == torch.float32, "bf16 main path dtypes")
        require(det.shape == (2, 100, 6) and masks.shape == (2, 100, 28, 28),
                f"bf16 output shapes {tuple(det.shape)}, {tuple(masks.shape)}")
        require(bool(torch.isfinite(det).all() and torch.isfinite(masks).all()),
                "non-finite bf16 detections or masks")
        require(bool(((masks >= 0) & (masks <= 1)).all()), "bf16 mask values outside [0, 1]")
        n_det = [int((det[i, :, 5] > 0).sum()) for i in range(2)]
        require(min(n_det) > 0, f"no bf16 detections {n_det}")
        log(f"BF16 MAIN detections per image {n_det}; "
            f"{sum(len(r['class_ids']) for r in results)} after unmolding")
        with torch.inference_mode():
            err, ms, ms32, copies = hold_k1_bf16(roi_rec.calls, "BF16 MAIN")
            mism = 0
            for args, kwargs in nms_rec.calls:
                mism += int((nms_ops.nms_alive(*args, **kwargs)
                             != nms_ops.greedy_alive_sorted_plain(*args, **kwargs)).sum())
        require(mism == 0, "K2 differs from its plain version on the bf16 path")
        fold_err("roi_align_fwd", err)
        log(f"BF16 MAIN per forward: K1 {ms:.4f} ms (float32 kernel {ms32:.4f}, copies "
            f"{copies:.4f})")
        del roi_rec, nms_rec
        with torch.inference_mode():
            e2e, runs = paired({"float32": lambda: detect(m32, images, cfg),
                                "bfloat16": lambda: detect(m16, images, cfg)}, 3)
            fwd = {k: cuda_ms(torch, lambda m=m: m.forward_inference(molded, windows), 5)
                   for k, m in (("float32", m32), ("bfloat16", m16), ("bfloat16 again", m16),
                                ("float32 again", m32))}
        log(f"BF16 E2E detect() ms per batch of 2, medians of 6 in turns: bfloat16 "
            f"{e2e['bfloat16']:.2f} (runs {', '.join(f'{x:.2f}' for x in runs['bfloat16'])}), "
            f"float32 {e2e['float32']:.2f} (runs "
            f"{', '.join(f'{x:.2f}' for x in runs['float32'])})")
        log("BF16 forward_inference ms (CUDA events, 5 calls): "
            + ", ".join(f"{k} {v:.2f}" for k, v in fwd.items()))
        with torch.inference_mode():
            for label, m in (("float32", m32), ("bfloat16", m16)):
                out = profile_by_family(torch, lambda m=m: m.forward_inference(molded, windows),
                                        3, families)
                log_breakdown(f"BF16 BREAKDOWN forward {label}", *out)
            log("BF16 the aten ops of a bfloat16 forward with the most device time:")
            for ms_, n_, op, shapes in top_ops(
                    torch, lambda: m16.forward_inference(molded, windows)):
                log(f"    {ms_:9.3f} ms  {n_:4d} calls  {op}  {str(shapes)[:110]}")

    def bf16_train_path():
        """The flagship trained in bfloat16 through Trainer/train_model: the
        'all' stage, one epoch of 2 steps at batch 4 over 8 synthetic 1024²
        images, counted from 0: per step K1 twice, K4 three times, K3 twice,
        K2 at least once; finite losses, a step with positives and a meta
        loss; float32 parameters, momentum, buffer and checkpoint. Each K1
        and K4 call bit-equal to its plain version (K4's on every step's
        bfloat16 maps), each K3 call within one bfloat16 rounding of
        its plain version (the float32 sums, each rounded once) and over two
        launches; K3's widening and rounding copies per call. Then the 'all'
        step in bfloat16 and float32 in turns (medians of 4), and one
        bfloat16 step's device time by family."""
        import shutil
        import tempfile

        from feature_intertwiner_tpu_torch.data import synthetic
        from feature_intertwiner_tpu_torch.data.loader import DetectionDataset, Loader
        from feature_intertwiner_tpu_torch.train import workflow

        tcfg = build_config("meta_105_quick_1", "train", opts=list(FLAGSHIP_OVERRIDES) + [
            "TRAIN.DO_VALIDATION", "False", "TRAIN.SCHEDULE", "[0, 0, 1]",
            "TRAIN.KEEP_CHECKPOINTS", "1", "CTRL.SHOW_INTERVAL", "1"])
        folder = tempfile.mkdtemp(prefix="chip_smoke_train16_", dir=os.path.join(ROOT, "build"))
        tcfg.MISC.RESULT_FOLDER = folder
        tcfg.MISC.LOG_FILE = os.path.join(folder, "log.txt")
        data = synthetic.generate(num_images=8, **TRAIN_DATA)
        loader = Loader(DetectionDataset(data, tcfg, augment=True, seed=tcfg.MISC.SEED),
                        batch_size=tcfg.TRAIN.BATCH_SIZE, shuffle=True, seed=tcfg.MISC.SEED)
        model = temper_fpn(seeded_model(build_model, tcfg, seed=0, dtype=torch.bfloat16))
        trainer = workflow.Trainer(model, tcfg).resume()
        steps = []
        step_fn = workflow.train_step

        k4_mism = []

        def recorded_step(st, cfg_, batch, lr, meta_gate, generator=None, draws=None, **kw):
            counts0 = dict(cuda_build.launches)
            k4_rec.calls.clear()
            metrics = step_fn(st, cfg_, batch, lr, meta_gate, generator, draws, **kw)
            torch.cuda.synchronize()
            steps.append(dict({k: float(v) for k, v in metrics.items()}, launches={
                k: cuda_build.launches[k] - counts0.get(k, 0) for k in TRAIN_KERNELS}))
            require(all(a[0].dtype == torch.bfloat16 for a, _ in k4_rec.calls),
                    "K4's big-set maps are not bfloat16")
            k4_mism.append(held_k4(k4_rec.calls))
            return metrics

        workflow.train_step = recorded_step
        try:
            with Recorder(roi_ops, "roi_align_bwd") as bwd_rec, \
                    Recorder(roi_ops, "roi_align_fwd") as fwd_rec, \
                    Recorder(roi_ops, "crop_and_resize_grouped") as k4_rec:
                cuda_build.launches.clear()
                workflow.train_model(trainer, loader, "all")
                launches = {k: cuda_build.launches[k] for k in TRAIN_KERNELS}
        finally:
            workflow.train_step = step_fn
        log("BF16 TRAIN LAUNCHES " + json.dumps(launches))
        for i, s in enumerate(steps):
            log(f"BF16 TRAIN step {i + 1} ['all'] "
                + " ".join(f"{k.replace('_loss', '')} {s[k]:.4f}" for k in (
                    "total_loss", "rpn_class_loss", "rpn_bbox_loss", "mrcnn_class_loss",
                    "mrcnn_bbox_loss", "mrcnn_mask_loss", "meta_loss"))
                + f" | positives {s['positive_rois']:.0f} | launches {s['launches']}")
        require(len(steps) == 2, f"{len(steps)} bf16 train steps, want 2")
        log(f"BF16 TRAIN crop_and_resize_grouped (K4) on bfloat16 maps against its plain "
            f"version on each step's tensors: {sum(k4_mism)} values differ over "
            f"{3 * len(steps)} calls")
        require(sum(k4_mism) == 0, "K4 on bfloat16 maps differs from its plain version")
        for s in steps:
            require(step_launches_ok(s["launches"], 1), f"bf16 step launches {s['launches']}")
            require(all(math.isfinite(s[k]) for k in s if k.endswith("_loss")),
                    "a non-finite bf16 loss")
        require(any(s["positive_rois"] > 0 and s["meta_loss"] > 0 for s in steps),
                "no bf16 step had positive RoIs and a non-zero meta loss")
        st = trainer.state
        ck = torch.load(os.path.join(folder, "checkpoints", sorted(os.listdir(
            os.path.join(folder, "checkpoints")))[-1]), map_location="cpu", weights_only=True)
        f32_state = (all(v.dtype in (torch.float32, torch.int64)
                         for v in st.model.state_dict().values())
                     and all(s_["momentum_buffer"].dtype == torch.float32
                             for s_ in st.optimizer.state.values())
                     and st.buffer.dtype == torch.float32
                     and all(v.dtype in (torch.float32, torch.int64)
                             for v in ck["model"].values()))
        log(f"BF16 TRAIN parameters, BN statistics, momentum, buffer and checkpoint float32: "
            f"{f32_state}")
        require(f32_state, "bf16 training left a state tensor outside float32")
        del ck

        # K1 and K3 on the last step's bfloat16 tensors
        with torch.no_grad():
            err, ms, ms32, copies = hold_k1_bf16(fwd_rec.calls, "BF16 TRAIN")
            fold_err("roi_align_fwd", err)
            k3_rel, k3_abs, k3_ms, k3_ms32, k3_copies = 0.0, 0.0, 0.0, 0.0, 0.0
            for args, kwargs in bwd_rec.calls:
                g = args[0]
                require(g.dtype == torch.bfloat16, "K3's cotangent is not bfloat16")
                got = roi_ops.roi_align_bwd(*args, **kwargs)
                again = roi_ops.roi_align_bwd(*args, **kwargs)
                want = roi_ops.multilevel_gather_bwd_plain(*args, **kwargs)
                torch.cuda.synchronize()
                for a, b, c in zip(got, again, want):
                    require(a.dtype == torch.bfloat16 and torch.equal(a, b),
                            "two bf16 K3 launches differ")
                    tol = 2.0 ** -7 * c.float().abs() + 1e-5 * c.float().abs().max()
                    excess = float(((a.float() - c.float()).abs() - tol).max())
                    require(excess <= 0, "bf16 K3 beyond one rounding of its plain version")
                    diff = float((a.float() - c.float()).abs().max())
                    k3_abs = max(k3_abs, diff)
                    k3_rel = max(k3_rel, diff / max(float(c.float().abs().max()), 1e-30))
                g32 = g.float()
                outs32 = roi_ops.roi_align_bwd(g32, *args[1:], **kwargs)
                t_ms = cuda_ms(torch, lambda: roi_ops.roi_align_bwd(*args, **kwargs), 10)
                t32 = cuda_ms(torch, lambda: roi_ops.roi_align_bwd(g32, *args[1:], **kwargs), 10)
                c_ms = cuda_ms(torch, lambda: (g.float(), [o.bfloat16() for o in outs32]), 10)
                k3_ms, k3_ms32, k3_copies = k3_ms + t_ms, k3_ms32 + t32, k3_copies + c_ms
                log(f"  BF16 TRAIN roi_align_bwd bf16 n={g.shape[0]} crop={tuple(g.shape[1:3])}: "
                    f"{t_ms:.4f} ms; the float32 kernel {t32:.4f} ms; widening g and rounding "
                    f"P2-P5's gradients {c_ms:.4f} ms")
            fold_err("roi_align_bwd", k3_abs)
        n = len(steps)
        log(f"BF16 TRAIN per step (the mean of {n}): K1 {ms / n:.4f} ms (float32 kernel "
            f"{ms32 / n:.4f}, copies {copies / n:.4f}); K3 {k3_ms / n:.4f} ms (float32 kernel "
            f"{k3_ms32 / n:.4f}, copies {k3_copies / n:.4f}); K3 within one rounding, largest "
            f"difference {k3_rel:.3g} of the largest gradient")
        del fwd_rec, bwd_rec, k4_rec

        # the 'all' step, bfloat16 and float32 in turns
        m32 = temper_fpn(seeded_model(build_model, tcfg, seed=0))
        t32 = workflow.Trainer(m32, tcfg)
        batch = workflow.to_device(next(iter(loader)), "cuda")
        gen = torch.Generator(device="cuda")
        for t in (trainer, t32):
            workflow.set_trainable(t.model, "all")

        def one(t):
            gen.manual_seed(0)
            workflow.train_step(t.state, tcfg, batch, 1e-4, 1.0, gen)

        one(t32)
        step_ms, runs = paired({"float32": lambda: one(t32), "bfloat16": lambda: one(trainer)}, 2)
        log(f"BF16 TRAIN step ms ['all'], medians of 4 in turns: bfloat16 "
            f"{step_ms['bfloat16']:.2f} (runs {', '.join(f'{x:.2f}' for x in runs['bfloat16'])}), "
            f"float32 {step_ms['float32']:.2f} (runs "
            f"{', '.join(f'{x:.2f}' for x in runs['float32'])})")
        for label, t in (("float32", t32), ("bfloat16", trainer)):
            out = profile_by_family(torch, lambda t=t: one(t), 1, families)
            log_breakdown(f"BF16 TRAIN BREAKDOWN one 'all' step {label}", *out)
            log(f"BF16 TRAIN the aten ops of one 'all' step {label} with the most device time:")
            for ms_, n_, op, shapes in top_ops(torch, lambda t=t: one(t)):
                log(f"    {ms_:9.3f} ms  {n_:4d} calls  {op}  {str(shapes)[:110]}")
        shutil.rmtree(folder, ignore_errors=True)

    def bf16_eval_path():
        """``test_model`` with the flagship in bfloat16 over 16 synthetic
        images, counted from 0 (K1 twice and K2 at least twice per batch,
        K1 bit-equal to its plain version), under cProfile: its host share
        (time outside ``detect()``'s forward) and the host functions that
        take it. Then ``detect()`` of one batch of 8 in bfloat16 and float32
        in turns, and the bfloat16 batch's device time by family."""
        import contextlib
        import cProfile
        import io
        import pstats
        import shutil
        import tempfile

        from feature_intertwiner_tpu_torch.data import synthetic
        from feature_intertwiner_tpu_torch.evaluation import COCO
        from feature_intertwiner_tpu_torch.train import workflow

        data = synthetic.generate(num_images=16)
        ecfg = build_config("meta_105_quick_1", "inference", opts=list(FLAGSHIP_OVERRIDES))
        ecfg.DATASET.NUM_CLASSES = data.num_classes
        m16 = seeded_model(build_model, ecfg, seed=0, dtype=torch.bfloat16)
        m32 = seeded_model(build_model, ecfg, seed=0)
        chunk = [data.load_image(i) for i in range(ecfg.TEST.BATCH_SIZE)]
        for m in (m16, m32):
            detect(m, chunk[:2], ecfg)                 # warm-up
        torch.cuda.synchronize()
        folder = tempfile.mkdtemp(prefix="chip_smoke_eval16_", dir=os.path.join(ROOT, "build"))
        ecfg.MISC.RESULT_FOLDER = folder
        ecfg.MISC.LOG_FILE = os.path.join(folder, "log.txt")
        api = COCO(dataset=data.coco_dataset())
        batches = math.ceil(data.num_images / ecfg.TEST.BATCH_SIZE)
        in_detect = []
        detect_fn = workflow.detect

        def timed_detect(*args, **kwargs):
            t0 = time.perf_counter()
            out = detect_fn(*args, **kwargs)
            in_detect.append(time.perf_counter() - t0)   # ends on a device-to-host copy
            return out

        prof = cProfile.Profile()
        cuda_build.launches.clear()
        workflow.detect = timed_detect
        try:
            with Recorder(roi_ops, "roi_align_fwd") as roi_rec, \
                    contextlib.redirect_stdout(io.StringIO()):
                t0 = time.perf_counter()
                prof.enable()
                stats = workflow.test_model(m16, ecfg, data, api, epoch=0, eval_masks=True)
                prof.disable()
                wall = time.perf_counter() - t0
        finally:
            workflow.detect = detect_fn
        launches = {k: cuda_build.launches[k] for k in ("roi_align_fwd", "nms_alive")}
        log(f"BF16 EVAL LAUNCHES {json.dumps(launches)} over {batches} batches; test_model "
            f"{wall:.2f} s, {data.num_images / wall:.2f} images/s; bbox "
            + " ".join(f"{v:.3f}" for v in stats))
        require(launches["roi_align_fwd"] == 2 * batches and launches["nms_alive"] >= 2 * batches,
                f"bf16 eval launches {launches}")
        with torch.inference_mode():
            err, _, _, _ = hold_k1_bf16(roi_rec.calls[:2], "BF16 EVAL")
        fold_err("roi_align_fwd", err)
        del roi_rec
        det_s = sum(in_detect)
        log(f"BF16 EVAL host profile (cProfile over test_model): {wall:.3f} s in all, "
            f"{det_s:.3f} s inside detect() ({len(in_detect)} calls: molding, forward, copy "
            f"back, unmolding), {wall - det_s:.3f} s outside it "
            f"({100 * (wall - det_s) / wall:.1f}%: RLE, results, COCOeval, the cache)")
        text = io.StringIO()
        pstats.Stats(prof, stream=text).sort_stats("tottime").print_stats(15)
        for line in text.getvalue().splitlines():
            if line.strip() and not line.lstrip().startswith(("Ordered", "List reduced")):
                log("    " + line.rstrip()[:150])
        shutil.rmtree(folder, ignore_errors=True)
        with torch.inference_mode():
            det_ms, runs = paired({"float32": lambda: detect(m32, chunk, ecfg),
                                   "bfloat16": lambda: detect(m16, chunk, ecfg)}, 2)
        log(f"BF16 EVAL detect() of a batch of {len(chunk)}, ms, medians of 4 in turns: "
            f"bfloat16 {det_ms['bfloat16']:.1f} (runs "
            f"{', '.join(f'{x:.1f}' for x in runs['bfloat16'])}), float32 "
            f"{det_ms['float32']:.1f} (runs {', '.join(f'{x:.1f}' for x in runs['float32'])})")
        for label, m in (("float32", m32), ("bfloat16", m16)):
            out = profile_by_family(torch, lambda m=m: detect(m, chunk, ecfg), 1, families)
            log_breakdown(f"BF16 EVAL BREAKDOWN detect() of {len(chunk)} {label}", *out)

    def bf16_reference():
        """A small model in bfloat16 on the card against the CPU from the same
        weights and inputs, each held to the CPU's own bfloat16 error (the
        CPU in bfloat16 against the CPU in float32): ``|card_bf16 - cpu_bf16|
        <= 2 e + 2^-8 m`` with ``e = |cpu_bf16 - cpu_f32|`` and ``m`` the
        float32 value's magnitude, on the pyramid and the second stage's
        class probabilities and box deltas fed the same proposals; then one
        train step (all parameters) from the same weights, batch, draws and
        proposals: each loss and the buffer likewise, and the parameters'
        updates in L2 over all parameters within 2 e."""
        import numpy as np
        from feature_intertwiner_tpu_torch.train.optim import set_trainable
        from feature_intertwiner_tpu_torch.train.step import create_train_state, train_step

        small_opts = list(FLAGSHIP_OVERRIDES) + [
            "MODEL.BACKBONE", "resnet50", "DATASET.NUM_CLASSES", "8",
            "DATA.IMAGE_MIN_DIM", "96", "DATA.IMAGE_MAX_DIM", "128",
            "RPN.ANCHOR_SCALES", "(8, 16, 32, 64, 128)", "RPN.PRE_NMS_LIMIT", "200",
            "RPN.POST_NMS_ROIS_INFERENCE", "48", "TEST.DET_MAX_INSTANCES", "8",
            "ROIS.TRAIN_ROIS_PER_IMAGE", "24", "ROIS.ASSIGN_ANCHOR_BASE", "56.0"]
        tsmall = build_config("smoke_small", "train", opts=small_opts)
        runs = {("cuda", torch.bfloat16): None, ("cpu", torch.bfloat16): None,
                ("cpu", torch.float32): None}
        models = {}
        for dev, dtype in runs:
            model = seeded_model(build_model, tsmall, seed=3, device=dev, dtype=dtype)
            biases = torch.Generator().manual_seed(4)
            with torch.no_grad():
                for name, p in model.named_parameters():
                    if name.endswith("bias"):
                        p.copy_(torch.randn(p.shape, generator=biases) * 0.005)
            models[(dev, dtype)] = temper_fpn(model)
        rng = np.random.RandomState(5)
        b, gt, size = 2, 5, 128
        images_np = rng.randn(b, size, size, 3) * 40
        card = models[("cuda", torch.bfloat16)]
        with torch.no_grad():
            x = torch.as_tensor(images_np, dtype=torch.float32)
            props = card.first_stage(x.cuda())[3].cpu()
            fwd = {}
            for (dev, dtype), m in models.items():
                pyr, _, _, _ = m.first_stage(x.to(dev))
                maps = m.dev_roi.pooling_maps(pyr[:4])
                pooled = m.dev_roi.pool(maps, props.to(dev), m.pool_size)
                _, probs, bbox, _ = m.classifier(pooled)
                fwd[(dev, dtype)] = [t.float().cpu() for t in (*pyr[:4], probs, bbox)]

        def held(label, got, cpu16, cpu32, scale=None):
            own = float((cpu16 - cpu32).abs().max())
            m = float(cpu32.abs().max()) if scale is None else scale
            diff = float((got - cpu16).abs().max())
            require(diff <= 2 * own + 2.0 ** -8 * m,
                    f"{label}: the card's bf16 differs from the CPU's by {diff} "
                    f"(the CPU's own bf16 error {own}, magnitude {m})")
            return diff / max(m, 1e-30), own / max(m, 1e-30)

        names = ["P2", "P3", "P4", "P5", "class probabilities", "box deltas"]
        line = []
        for name, g_, c16, c32 in zip(names, fwd[("cuda", torch.bfloat16)],
                                      fwd[("cpu", torch.bfloat16)], fwd[("cpu", torch.float32)]):
            d, own = held(name, g_, c16, c32)
            line.append(f"{name} {d:.3g} (CPU's own {own:.3g})")
        log("BF16 REFERENCE small model card vs CPU, of the largest value: " + "; ".join(line))

        boxes_np = np.zeros((b, gt, 4))
        area = (props[..., 2] - props[..., 0]) * (props[..., 3] - props[..., 1])
        for i in range(b):
            boxes_np[i, :3] = props[i, np.argsort(-area[i].numpy())[:3]].numpy() * size
        y1x1 = rng.uniform(4, 64, (b, 2, 2))
        boxes_np[:, 3:] = np.concatenate([y1x1, y1x1 + rng.uniform(16, 60, (b, 2, 2))], -1)
        batch_np = {"images": images_np, "gt_class_ids": rng.randint(1, 8, (b, gt)),
                    "gt_boxes": boxes_np, "gt_masks": rng.rand(b, gt, 14, 14) > 0.5}
        n_anchors = int(card.anchors.shape[0])
        draws_np = {"rpn": rng.rand(b, 2, n_anchors), "det": rng.rand(b, 2, 48)}
        before = {n: p.detach().cpu().clone() for n, p in card.named_parameters()}
        for (dev, dtype), model in models.items():
            st = create_train_state(tsmall, model)
            set_trainable(model, "all")
            batch = {k: torch.as_tensor(v).to(dev, torch.int32 if k == "gt_class_ids"
                                               else torch.float32)
                     for k, v in batch_np.items()}
            draws = {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
                     for k, v in draws_np.items()}
            model._propose = lambda *a, dev=dev: props.to(dev)
            metrics = train_step(st, tsmall, batch, 0.01, 1.0, draws=draws)
            runs[(dev, dtype)] = ({k: float(v) for k, v in metrics.items()},
                                  torch.cat([(p.detach().cpu().double() - before[n].double())
                                             .reshape(-1) for n, p in model.named_parameters()]),
                                  st.buffer.cpu())
        g16, c16, c32 = runs[("cuda", torch.bfloat16)], runs[("cpu", torch.bfloat16)], \
            runs[("cpu", torch.float32)]
        loss_line = []
        for k in sorted(k for k in c32[0] if k.endswith("_loss")):
            d, own = held(k, torch.tensor(g16[0][k]), torch.tensor(c16[0][k]),
                          torch.tensor(c32[0][k]))
            loss_line.append(f"{k.replace('_loss', '')} {d:.3g} ({own:.3g})")
        b_d, b_own = held("buffer", g16[2], c16[2], c32[2])
        upd = float((g16[1] - c16[1]).norm()) / float(c32[1].norm())
        upd_own = float((c16[1] - c32[1]).norm()) / float(c32[1].norm())
        log("BF16 REFERENCE train step card vs CPU, relative (CPU's own bf16 error): "
            + "; ".join(loss_line) + f"; buffer {b_d:.3g} ({b_own:.3g}); parameter updates, "
            f"L2 over all parameters {upd:.3g} ({upd_own:.3g}); positives "
            f"{g16[0]['positive_rois']:.0f}, meta {g16[0]['meta_loss']:.4g}")
        require(upd <= 2 * upd_own, "the card's bf16 parameter updates differ from the CPU's")
        require(g16[0]["positive_rois"] > 0 and g16[0]["meta_loss"] > 0,
                "the bf16 reference step had no positive RoI or no meta loss")

    phase("bf16_main_path", bf16_main_path)
    phase("bf16_train_path", bf16_train_path)
    phase("bf16_eval_path", bf16_eval_path)
    phase("bf16_reference", bf16_reference)

    # 16. the OT recipe: configs/104/meta_104_conv.yaml with the FPN OT -----------
    def ranged(cls, attr, name):
        """Wrap ``cls.attr`` in a ``torch.profiler`` range called ``name``."""
        from torch.profiler import record_function

        fn = getattr(cls, attr)

        def wrapped(*args, **kwargs):
            with record_function(name):
                return fn(*args, **kwargs)
        setattr(cls, attr, wrapped)
        return lambda: setattr(cls, attr, fn)

    def range_device_ms(fn, names):
        """The device time spanned by each named range in one call of
        ``fn`` (torch.profiler's ranges on the device's timeline), ms."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        out = {n: 0.0 for n in names}
        for e in prof.key_averages():
            if e.key in out and e.device_type == DeviceType.CUDA:
                out[e.key] += e.device_time_total / 1e3
        return out

    def ot_train_path():
        """configs/104/meta_104_conv.yaml (the flagship with the OT meta
        loss, conv form) with TRAIN.FPN_OT_LOSS on, at full width (R101-FPN,
        1024², batch 4, 200 RoIs per image, 81 classes, the seeded tempered
        weights) through Trainer/train_model: one 'all' stage of 2 steps in
        float32, then one in bfloat16, counted from 0: per step K1 2, K4 3,
        K3 2 and K2 at least 1 launches; every loss, the meta loss and the
        FPN OT loss finite, the FPN OT loss positive, the buffer moved; each
        K4 call bit-equal to its plain version. Then the 'all' step in
        float32 and bfloat16 in turns, and in bfloat16 with and without the
        FPN OT in turns (medians, CUDA events); each dtype's device time by
        family, with the OT modules' and the Sinkhorn loop's forward ranges
        as their own."""
        import shutil
        import tempfile

        from feature_intertwiner_tpu_torch.data import synthetic
        from feature_intertwiner_tpu_torch.data.loader import DetectionDataset, Loader
        from feature_intertwiner_tpu_torch.models import ot as ot_mod
        from feature_intertwiner_tpu_torch.train import workflow

        data = synthetic.generate(num_images=8, **TRAIN_DATA)
        trainers, loader = {}, None
        step_fn = workflow.train_step
        for dtype in (torch.float32, torch.bfloat16):
            label = str(dtype).split(".")[-1]
            ocfg = build_config("meta_104_conv", "train", opts=list(OT_RECIPE) + [
                "TRAIN.FPN_OT_LOSS", "True", "TRAIN.DO_VALIDATION", "False",
                "TRAIN.SCHEDULE", "[0, 0, 1]", "TRAIN.KEEP_CHECKPOINTS", "1",
                "CTRL.SHOW_INTERVAL", "1"])
            require(ocfg.DEV.LOSS_CHOICE == "ot" and ocfg.TRAIN.FPN_OT_LOSS
                    and ocfg.DATASET.NUM_CLASSES == 81 and ocfg.ROIS.TRAIN_ROIS_PER_IMAGE == 200
                    and ocfg.DATA.IMAGE_MAX_DIM == 1024 and ocfg.MODEL.BACKBONE == "resnet101",
                    "the OT recipe is not at full width")
            folder = tempfile.mkdtemp(prefix=f"chip_smoke_ot_{label}_",
                                      dir=os.path.join(ROOT, "build"))
            ocfg.MISC.RESULT_FOLDER = folder
            ocfg.MISC.LOG_FILE = os.path.join(folder, "log.txt")
            loader = Loader(DetectionDataset(data, ocfg, augment=True, seed=ocfg.MISC.SEED),
                            batch_size=ocfg.TRAIN.BATCH_SIZE, shuffle=True, seed=ocfg.MISC.SEED)
            model = temper_fpn(seeded_model(build_model, ocfg, seed=0, dtype=dtype))
            require(model.ot_loss is not None and model.fpn.fpn_ot_loss,
                    "the model has no OT modules")
            trainer = workflow.Trainer(model, ocfg).resume()
            buffer0 = trainer.state.buffer.clone()
            steps, k4_mism = [], []

            def recorded_step(st, cfg_, batch, lr, meta_gate, generator=None, draws=None, **kw):
                counts0 = dict(cuda_build.launches)
                k4_rec.calls.clear()
                t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                t0.record()
                metrics = step_fn(st, cfg_, batch, lr, meta_gate, generator, draws, **kw)
                t1.record()
                torch.cuda.synchronize()
                steps.append(dict({k: float(v) for k, v in metrics.items()},
                                  ms=t0.elapsed_time(t1), launches={
                                      k: cuda_build.launches[k] - counts0.get(k, 0)
                                      for k in TRAIN_KERNELS}))
                k4_mism.append(held_k4(k4_rec.calls))
                return metrics

            workflow.train_step = recorded_step
            try:
                with Recorder(roi_ops, "crop_and_resize_grouped") as k4_rec:
                    cuda_build.launches.clear()
                    workflow.train_model(trainer, loader, "all")
                    launches = {k: cuda_build.launches[k] for k in TRAIN_KERNELS}
            finally:
                workflow.train_step = step_fn
            del k4_rec
            log(f"OT TRAIN [{label}] LAUNCHES " + json.dumps(launches))
            for i, s_ in enumerate(steps):
                log(f"OT TRAIN [{label}] step {i + 1} ['all'] "
                    + " ".join(f"{k.replace('_loss', '')} {s_[k]:.5g}" for k in (
                        "total_loss", "rpn_class_loss", "rpn_bbox_loss", "mrcnn_class_loss",
                        "mrcnn_bbox_loss", "mrcnn_mask_loss", "meta_loss", "fpn_ot_loss"))
                    + f" | positives {s_['positive_rois']:.0f} | {s_['ms']:.1f} ms"
                    f" | launches {s_['launches']}")
            moved = not torch.equal(trainer.state.buffer, buffer0)
            log(f"OT TRAIN [{label}] K4 against its plain version on each step's tensors: "
                f"{sum(k4_mism)} values differ over {3 * len(steps)} calls; buffer moved {moved}")
            require(len(steps) == 2, f"{len(steps)} OT train steps, want 2")
            require(step_launches_ok(launches, len(steps)), f"OT train launches {launches}")
            for s_ in steps:
                require(step_launches_ok(s_["launches"], 1), f"OT step launches {s_['launches']}")
                require(all(math.isfinite(s_[k]) for k in s_ if k.endswith("_loss")),
                        "a non-finite loss in the OT recipe")
                require(s_["fpn_ot_loss"] > 0, "the FPN OT loss is zero")
            require(moved, "the OT recipe's buffer did not move")
            require(sum(k4_mism) == 0, "K4 differs from its plain version in the OT recipe")
            trainers[label] = trainer
            shutil.rmtree(folder, ignore_errors=True)

        batch = workflow.to_device(next(iter(loader)), "cuda")
        gen = torch.Generator(device="cuda")
        cfg_ot = trainers["float32"].cfg

        def one(t):
            gen.manual_seed(0)
            workflow.train_step(t.state, cfg_ot, batch, 1e-4, 1.0, gen)

        def no_fpn_ot(t):
            t.model.fpn.fpn_ot_loss = False
            try:
                one(t)
            finally:
                t.model.fpn.fpn_ot_loss = True

        t32, t16 = trainers["float32"], trainers["bfloat16"]
        step_ms, runs = paired({"float32": lambda: one(t32), "bfloat16": lambda: one(t16)}, 2,
                               events=True)
        log(f"OT TRAIN step ms ['all', meta OT and FPN OT], medians of 4 in turns (CUDA "
            f"events): float32 {step_ms['float32']:.2f} (runs "
            f"{', '.join(f'{x:.2f}' for x in runs['float32'])}), bfloat16 "
            f"{step_ms['bfloat16']:.2f} (runs {', '.join(f'{x:.2f}' for x in runs['bfloat16'])})")
        fpn_ms, runs = paired({"with": lambda: one(t16), "without": lambda: no_fpn_ot(t16)}, 2,
                              events=True)
        log(f"OT TRAIN bfloat16 step ms with and without the FPN OT, medians of 4 in turns "
            f"(CUDA events): {fpn_ms['with']:.2f} / {fpn_ms['without']:.2f} (runs "
            f"{', '.join(f'{x:.2f}' for x in runs['with'])} / "
            f"{', '.join(f'{x:.2f}' for x in runs['without'])})")
        names = ("OT: FPN OptTrans2D forward", "OT: meta OptTrans1D forward",
                 "OT: Sinkhorn divergence forward")
        undo = [ranged(ot_mod.OptTrans2D, "forward", names[0]),
                ranged(ot_mod.OptTrans1D, "forward", names[1]),
                ranged(ot_mod, "sinkhorn_divergence", names[2])]
        try:
            for label, t in (("float32", t32), ("bfloat16", t16)):
                out = profile_by_family(torch, lambda t=t: one(t), 1, families)
                log_breakdown(f"OT TRAIN BREAKDOWN one 'all' step {label}", *out)
                spans = range_device_ms(lambda t=t: one(t), names)
                log(f"OT TRAIN {label} device time spanned by the OT ranges of one step: "
                    + "; ".join(f"{n} {ms:.3f} ms" if ms > 0 else f"{n} not measured"
                                for n, ms in spans.items()))
        finally:
            for u in undo:
                u()
        del trainers, t32, t16

    def ot_reference():
        """A small model with the OT meta loss (conv and fc forms) and the FPN
        OT, one float32 train step on the card and on the CPU (plain
        versions) from the same weights, batch, draws and proposals: the
        losses within 1e-4 relative (the meta loss, a sum of debiased
        divergences, within 1e-4 of the sum of its terms' magnitudes), the
        parameters within 1e-5 of each tensor's largest magnitude plus what
        the meta loss's gradient moved it by (a CPU step with the meta loss
        gated off gives that): the OT meta loss reaches the network through
        the 1-D rows' normalisation, whose derivative is 0 but for rounding
        (ROADMAP "Not faults"), so the card and the CPU round it apart; the
        buffer within 1e-4."""
        import copy

        from feature_intertwiner_tpu_torch.ops import sinkhorn

        for form, fpn in (("conv", True), ("fc", False)):
            tsmall = build_config("smoke_small", "train", opts=list(small_opts) + [
                "ROIS.ASSIGN_ANCHOR_BASE", "56.0", "DEV.LOSS_CHOICE", "ot",
                "DEV.OT_ONE_DIM_FORM", form, "TRAIN.FPN_OT_LOSS", str(fpn)])

            def watch(model, runs, key):
                meta_ot = model.meta_ot
                runs[f"ot_{key}"] = copy.deepcopy(model.ot_loss).cpu()

                def recording(small, big, w):
                    runs[f"rows_{key}"] = (small.detach().cpu(), big.detach().cpu(), w.cpu())
                    return meta_ot(small, big, w)
                model.meta_ot = recording

            runs = small_step_card_and_cpu(tsmall, watch, meta_free=True)
            (mg, pg, bg, cg), (mc, pc, bc, cc) = runs["cuda"], runs["cpu"]
            quiet = runs["cpu_meta_free"][1]
            small, big, w = runs["rows_cpu"]
            with torch.no_grad():
                ot = runs["ot_cpu"]
                cx, cy = ot.embed(ot.G_net(small[:, :, None])), ot.embed(big[:, :, None])
                terms = sum(sinkhorn.sinkhorn_ot(a, b).abs() for a, b in
                            ((cx, cy), (cx, cy), (cx, cx), (cy, cy)))
            scale = float((w * terms).sum())
            loss_rel = max(abs(mg[k] - mc[k]) / max(abs(mc[k]), 1e-6) for k in mc
                           if k.endswith("_loss") and k != "meta_loss")
            meta_err = abs(mg["meta_loss"] - mc["meta_loss"])
            param_rel, worst = max((float((pg[n] - pc[n]).abs().max()
                                          / pc[n].abs().max().clamp_min(1e-12)), n) for n in pc)
            excess, over = max((float((pg[n] - pc[n]).abs().max() - 1e-5 * pc[n].abs().max()
                                      - (pc[n] - quiet[n]).abs().max()), n) for n in pc)
            buf_err = max(float((bg - bc).abs().max()), float((cg - cc).abs().max()))
            log(f"OT REFERENCE ot/{form}{' + FPN OT' if fpn else ''} train step card vs CPU: "
                f"losses rel err {loss_rel:.3g}; meta {mg['meta_loss']:.6g} / "
                f"{mc['meta_loss']:.6g}, err {meta_err:.3g} against its terms' {scale:.4g}; "
                f"fpn_ot {mg['fpn_ot_loss']:.6g} / {mc['fpn_ot_loss']:.6g}; parameters rel err "
                f"{param_rel:.3g} ({worst}), past 1e-5 plus the meta loss's move "
                f"{max(excess, 0.0):.3g} ({over}); buffer err {buf_err:.3g}; "
                f"positives {mg['positive_rois']:.0f}")
            require(loss_rel <= 1e-4 and meta_err <= 1e-4 * scale and excess <= 0
                    and buf_err <= 1e-4,
                    "the card's OT train step differs from the CPU's")
            require(mg["positive_rois"] > 0 and (mg["fpn_ot_loss"] > 0) == fpn,
                    "the OT reference step had no positives or a wrong FPN OT loss")

    phase("ot_train_path", ot_train_path)
    phase("ot_reference", ot_reference)

    # 18. the make-up layer at UPSAMPLE_FAC 2 and CLS_MERGE_FEAT ------------------------
    up2_opts = list(FLAGSHIP_OVERRIDES) + ["DEV.UPSAMPLE_FAC", "2.0", "DEV.CLS_MERGE_FEAT",
                                           "True"]

    def hold_k1(calls, label):
        """Each recorded K1 call bit-equal to its plain version on its own
        tensors and over two launches, timed beside its float32 bound, its
        plain version and ``grid_sample`` over P2; returns the calls' (crop,
        boxes, ms, bound ms, plain ms, grid_sample ms) rows."""
        rows = []
        for args, kwargs in calls:
            feats, boxes, bidx, lidx, crop = args[:5]
            got = roi_ops.roi_align_fwd(*args, **kwargs)
            again = roi_ops.roi_align_fwd(*args, **kwargs)
            want = roi_ops.multilevel_gather_plain(*args, **kwargs)
            torch.cuda.synchronize()
            require(torch.equal(got, want) and torch.equal(got, again),
                    f"{label}: K1 differs from its plain version or itself (n={boxes.shape[0]}, "
                    f"crop={tuple(crop)})")
            k_ms = cuda_ms(torch, lambda: roi_ops.roi_align_fwd(*args, **kwargs), 10)
            p_ms = cuda_ms(torch, lambda: roi_ops.multilevel_gather_plain(*args, **kwargs), 3)
            p2 = feats[0].permute(0, 3, 1, 2)
            grid = profile_roi.box_grid(boxes, crop, p2.shape[0]).to(p2.dtype)
            l_ms = cuda_ms(torch, lambda: torch.nn.functional.grid_sample(
                p2, grid, mode="bilinear", padding_mode="zeros", align_corners=True), 10)
            nbytes, taps, n_ops = k1_work(torch, roi_ops, feats, boxes, bidx, lidx, crop)
            b_ms = max(nbytes / H100_BYTES_PER_S, n_ops / H100_FP32_OPS_PER_S) * 1e3
            rows.append((tuple(crop), boxes.shape[0], k_ms, b_ms, p_ms, l_ms))
            log(f"  {label} roi_align_fwd {str(feats[0].dtype).split('.')[-1]} n={boxes.shape[0]} "
                f"crop={tuple(crop)} maps {[tuple(f.shape[1:3]) for f in feats]}: bit-equal to "
                f"plain and over two launches, {k_ms:.4f} ms, float32 bound {b_ms:.6f} ms "
                f"({taps} tap rows), plain {p_ms:.4f} ms, grid_sample over P2 {l_ms:.4f} ms")
        return rows

    def up2_inference(model, icfg):
        """``detect()`` of the factor-2 merge model in its dtype, counted
        from 0: K1 3 (7² classifier, 14² critic, 14² mask), K2 at least 2;
        the outputs; each K1 call held by :func:`hold_k1`. Returns the molded
        images and their windows."""
        label = f"UP2 MAIN [{str(model.dtype).split('.')[-1]}]"
        detect(model, images, icfg)                    # warm-up
        torch.cuda.synchronize()
        cuda_build.launches.clear()
        with Recorder(roi_ops, "roi_align_fwd") as roi_rec, \
                Recorder(nms_ops, "nms_alive") as nms_rec:
            results = detect(model, images, icfg)
        launches = {k: cuda_build.launches[k] for k in ("roi_align_fwd", "nms_alive")}
        log(f"{label} LAUNCHES " + json.dumps(launches))
        require(launches["roi_align_fwd"] == 3 and launches["nms_alive"] >= 2,
                f"{label} launches {launches}: want K1 3, K2 at least 2")
        molded, windows = mold_inputs(images, icfg, "cuda")
        with torch.inference_mode():
            out = model.forward_inference(molded, windows)
        det, masks = out["detections"], out["masks"]
        require(det.shape == (2, 100, 6) and masks.shape == (2, 100, 28, 28)
                and bool(torch.isfinite(det).all() and torch.isfinite(masks).all())
                and bool(((masks >= 0) & (masks <= 1)).all()), f"{label} outputs")
        n_det = [int((det[i, :, 5] > 0).sum()) for i in range(2)]
        require(min(n_det) > 0, f"{label}: no detections {n_det}")
        log(f"{label} detections per image {n_det}; "
            f"{sum(len(r['class_ids']) for r in results)} after unmolding")
        with torch.inference_mode():
            rows = hold_k1(roi_rec.calls, label)
            mism = sum(int((nms_ops.nms_alive(*a, **k) != nms_ops.greedy_alive_sorted_plain(
                *a, **k)).sum()) for a, k in nms_rec.calls)
        require(mism == 0, f"{label}: K2 differs from its plain version")
        require(sorted(r[0] for r in rows) == [(7, 7), (14, 14), (14, 14)],
                f"{label}: K1 crops {[r[0] for r in rows]}")
        log(f"{label} K1 per forward {sum(r[2] for r in rows):.4f} ms over 3 launches, float32 "
            f"bound {sum(r[3] for r in rows):.6f} ms, plain {sum(r[4] for r in rows):.4f} ms, "
            f"grid_sample {sum(r[5] for r in rows):.4f} ms")
        return molded, windows

    def up2_train(dtype):
        """One 'all' stage of 2 steps of the factor-2 merge recipe through
        Trainer/train_model in ``dtype``, counted from 0: per step K1 2, K4
        3, K3 2, K2 at least 1; finite losses; the critic and the make-up
        transposed conv moved; K1 and K4 bit-equal to their plain versions;
        K3 on the last step's cotangents (widened to float32) held and timed
        by :func:`check_bwd`, and as the step calls it in ``dtype``. Returns
        the trainer and the loader."""
        import shutil
        import tempfile

        from feature_intertwiner_tpu_torch.data import synthetic
        from feature_intertwiner_tpu_torch.data.loader import DetectionDataset, Loader
        from feature_intertwiner_tpu_torch.train import workflow

        label = f"UP2 TRAIN [{str(dtype).split('.')[-1]}]"
        tcfg = build_config("meta_105_quick_1", "train", opts=up2_opts + [
            "TRAIN.DO_VALIDATION", "False", "TRAIN.SCHEDULE", "[0, 0, 1]",
            "TRAIN.KEEP_CHECKPOINTS", "1", "CTRL.SHOW_INTERVAL", "1"])
        require(tcfg.TRAIN.BATCH_SIZE == 4 and tcfg.ROIS.TRAIN_ROIS_PER_IMAGE == 200
                and tcfg.DATA.IMAGE_MAX_DIM == 1024 and tcfg.DATASET.NUM_CLASSES == 81,
                "the factor-2 recipe is not at full width")
        folder = tempfile.mkdtemp(prefix="chip_smoke_up2_", dir=os.path.join(ROOT, "build"))
        tcfg.MISC.RESULT_FOLDER = folder
        tcfg.MISC.LOG_FILE = os.path.join(folder, "log.txt")
        data = synthetic.generate(num_images=8, **TRAIN_DATA)
        loader = Loader(DetectionDataset(data, tcfg, augment=True, seed=tcfg.MISC.SEED),
                        batch_size=tcfg.TRAIN.BATCH_SIZE, shuffle=True, seed=tcfg.MISC.SEED)
        trainer = workflow.Trainer(temper_fpn(seeded_model(build_model, tcfg, seed=0,
                                                           dtype=dtype)), tcfg).resume()
        watched = ("dev_roi.feat_extract.0.weight", "dev_roi.upsample.0.0.weight")
        before = {n: p.detach().clone() for n, p in trainer.model.named_parameters()
                  if n in watched}
        steps, k4_mism, step_fn = [], [], workflow.train_step

        def recorded_step(st, cfg_, batch, lr, meta_gate, generator=None, draws=None, **kw):
            counts0 = dict(cuda_build.launches)
            for rec in (bwd_rec, fwd_rec, k4_rec):
                rec.calls.clear()               # the last step's calls only
            metrics = step_fn(st, cfg_, batch, lr, meta_gate, generator, draws, **kw)
            torch.cuda.synchronize()
            steps.append(dict({k: float(v) for k, v in metrics.items()}, launches={
                k: cuda_build.launches[k] - counts0.get(k, 0) for k in TRAIN_KERNELS}))
            k4_mism.append(held_k4(k4_rec.calls))
            return metrics

        workflow.train_step = recorded_step
        try:
            with Recorder(roi_ops, "roi_align_bwd") as bwd_rec, \
                    Recorder(roi_ops, "roi_align_fwd") as fwd_rec, \
                    Recorder(roi_ops, "crop_and_resize_grouped") as k4_rec:
                cuda_build.launches.clear()
                workflow.train_model(trainer, loader, "all")
                launches = {k: cuda_build.launches[k] for k in TRAIN_KERNELS}
        finally:
            workflow.train_step = step_fn
        log(f"{label} LAUNCHES " + json.dumps(launches))
        for i, s_ in enumerate(steps):
            log(f"{label} step {i + 1} ['all'] "
                + " ".join(f"{k.replace('_loss', '')} {s_[k]:.5g}" for k in (
                    "total_loss", "rpn_class_loss", "rpn_bbox_loss", "mrcnn_class_loss",
                    "mrcnn_bbox_loss", "mrcnn_mask_loss", "meta_loss"))
                + f" | positives {s_['positive_rois']:.0f} | launches {s_['launches']}")
        require(len(steps) == 2 and step_launches_ok(launches, 2), f"{label} launches {launches}")
        for s_ in steps:
            require(step_launches_ok(s_["launches"], 1), f"{label} step launches {s_['launches']}")
            require(all(math.isfinite(s_[k]) for k in s_ if k.endswith("_loss")),
                    f"{label}: a non-finite loss")
        require(any(s_["positive_rois"] > 0 and s_["meta_loss"] > 0 for s_ in steps),
                f"{label}: no step had positive RoIs and a non-zero meta loss")
        after = dict(trainer.model.named_parameters())
        moved = {n: not torch.equal(after[n].detach(), p) for n, p in before.items()}
        log(f"{label} moved: {moved}; K4 against its plain version on each step's tensors: "
            f"{sum(k4_mism)} values differ over {3 * len(steps)} calls")
        require(all(moved.values()), f"{label}: the critic or the make-up layer did not move")
        require(sum(k4_mism) == 0, f"{label}: K4 differs from its plain version")
        with torch.no_grad():
            k1_rows = hold_k1(fwd_rec.calls, label)
            require(len(k1_rows) == 2, f"{label}: {len(k1_rows)} K1 calls in the last step")
            k3 = dict(abs=0.0, ms=0.0, plain_ms=0.0, lib_ms=0.0, bytes=0, ms_entry=0.0,
                      bytes_entry=0)
            for args, kwargs in bwd_rec.calls:
                g, shapes = args[0], args[1]
                r = check_bwd(label, g.float(), *args[1:6], shapes[0][0])
                for key in ("ms", "plain_ms", "lib_ms", "bytes"):
                    k3[key] += r[key]
                k3["abs"] = max(k3["abs"], r["abs"])
                k3["ms_entry"] += cuda_ms(torch, lambda: roi_ops.roi_align_bwd(*args, **kwargs), 10)
                k3["bytes_entry"] += r["bytes"] * g.element_size() // 4
            require(len(bwd_rec.calls) == 2, f"{label}: {len(bwd_rec.calls)} K3 calls")
        fold_err("roi_align_bwd", k3["abs"])
        log(f"{label} per step: K1 {sum(r[2] for r in k1_rows):.4f} ms (float32 bound "
            f"{sum(r[3] for r in k1_rows):.6f}, plain {sum(r[4] for r in k1_rows):.4f}, "
            f"grid_sample {sum(r[5] for r in k1_rows):.4f}); K3 float32 kernel {k3['ms']:.4f} "
            f"ms, bound {k3['bytes'] / H100_BYTES_PER_S * 1e3:.6f} ms ({k3['bytes']} bytes), "
            f"plain {k3['plain_ms']:.4f}, grid_sample backward {k3['lib_ms']:.4f}; K3 as the "
            f"step calls it {k3['ms_entry']:.4f} ms, bound "
            f"{k3['bytes_entry'] / H100_BYTES_PER_S * 1e3:.6f} ms ({k3['bytes_entry']} bytes)")
        del bwd_rec, fwd_rec, k4_rec
        shutil.rmtree(folder, ignore_errors=True)
        return trainer, loader

    def dev_up2_merge_path():
        """The flagship with ``DEV.UPSAMPLE_FAC 2.0 DEV.CLS_MERGE_FEAT True``
        (the make-up layer a 3x3 stride-2 transposed conv; the critic's
        vectors added to the classifier, simple_add) at full width:
        ``detect()`` in float32 and bfloat16 (:func:`up2_inference`), its
        forward paired with the factor-1 flagship's in turns; one 'all'
        stage of 2 steps in bfloat16 (:func:`up2_train`), its step paired
        with the factor-1 flagship's; then two small models card against
        CPU, the second stage on the same proposals and one float32 train
        step as in ``reference``: ``MULTI_UPSAMPLER`` + ``UPSAMPLE_RESIDUAL``
        + ``UPSAMPLE_INIT identity`` + linear_add at factor 2, and
        ``DIS_UPSAMPLER`` with the merge."""
        from feature_intertwiner_tpu_torch.train import workflow

        t0 = time.perf_counter()
        icfg = build_config("meta_105_quick_1", "inference", opts=up2_opts)
        m2, m1 = seeded_model(build_model, icfg, seed=0), seeded_model(build_model, cfg, seed=0)
        require(m2.classifier.merge_feat and m2.dev_roi.upsample[0][0].stride == (2, 2),
                "the model has no factor-2 make-up layer or no merge")
        for dtype in (torch.float32, torch.bfloat16):
            m1.dtype = m2.dtype = dtype                # re-typed, the same parameters
            molded, windows = up2_inference(m2, icfg)
            with torch.inference_mode():
                ms, runs = paired({"factor 1": lambda: m1.forward_inference(molded, windows),
                                   "factor 2": lambda: m2.forward_inference(molded, windows)},
                                  3, events=True)
            with torch.inference_mode():
                out = profile_by_family(torch, lambda: m2.forward_inference(molded, windows), 3,
                                        families)
                log_breakdown(f"UP2 BREAKDOWN forward {str(dtype).split('.')[-1]}", *out)
                log("UP2 the aten ops of that forward with the most device time:")
                for ms_, n_, op, shapes in top_ops(
                        torch, lambda: m2.forward_inference(molded, windows), 6):
                    log(f"    {ms_:9.3f} ms  {n_:4d} calls  {op}  {str(shapes)[:110]}")
            log(f"UP2 forward_inference ms [{str(dtype).split('.')[-1]}], medians of 6 in turns "
                f"(CUDA events): factor 2 with the merge {ms['factor 2']:.2f} (runs "
                f"{', '.join(f'{x:.2f}' for x in runs['factor 2'])}), factor 1 "
                f"{ms['factor 1']:.2f} (runs {', '.join(f'{x:.2f}' for x in runs['factor 1'])})")
        del m1, m2
        log(f"UP2 inference in both dtypes, paired: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        t2, loader = up2_train(torch.bfloat16)
        log(f"UP2 the bfloat16 stage and its checks: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        tcfg1 = build_config("meta_105_quick_1", "train", opts=list(FLAGSHIP_OVERRIDES))
        t1 = workflow.Trainer(temper_fpn(seeded_model(build_model, tcfg1, seed=0,
                                                      dtype=torch.bfloat16)), tcfg1)
        batch = workflow.to_device(next(iter(loader)), "cuda")
        gen = torch.Generator(device="cuda")
        for t in (t1, t2):
            workflow.set_trainable(t.model, "all")

        def one(t):
            gen.manual_seed(0)
            workflow.train_step(t.state, t.cfg, batch, 1e-4, 1.0, gen)

        one(t1)
        step_ms, runs = paired({"factor 1": lambda: one(t1), "factor 2": lambda: one(t2)}, 2,
                               events=True)
        log(f"UP2 TRAIN step ms ['all', bfloat16], medians of 4 in turns (CUDA events): factor "
            f"2 with the merge {step_ms['factor 2']:.2f} (runs "
            f"{', '.join(f'{x:.2f}' for x in runs['factor 2'])}), factor 1 "
            f"{step_ms['factor 1']:.2f} (runs {', '.join(f'{x:.2f}' for x in runs['factor 1'])})")
        out = profile_by_family(torch, lambda: one(t2), 1, families)
        log_breakdown("UP2 TRAIN BREAKDOWN one 'all' step bfloat16", *out)
        del t1, t2, batch
        log(f"UP2 the step paired with factor 1: {time.perf_counter() - t0:.1f} s")

        for name, variant in (
                ("multi + residual + identity + linear_add, factor 2",
                 ["DEV.UPSAMPLE_FAC", "2.0", "DEV.MULTI_UPSAMPLER", "True",
                  "DEV.UPSAMPLE_RESIDUAL", "True", "DEV.UPSAMPLE_INIT", "identity",
                  "DEV.CLS_MERGE_FEAT", "True", "DEV.CLS_MERGE_MANNER", "linear_add"]),
                ("dis_upsampler + simple_add", ["DEV.DIS_UPSAMPLER", "True",
                                                "DEV.CLS_MERGE_FEAT", "True"])):
            small = build_config("smoke_small", "inference", opts=small_opts + variant)
            require(small.DEV.CLS_MERGE_FEAT, f"UP2 REFERENCE {name}: no merge")
            small_second_stage(small, f"UP2 REFERENCE {name}")
            small_step_checked(small_opts + variant, f"UP2 REFERENCE {name}")

    phase("dev_up2_merge_path", dev_up2_merge_path)

    # 19. the training options of ROADMAP A5 ------------------------------------------
    def options_launches_ok(name, launches, steps):
        """Per train step: K1 2, K2 at least 1, and under A K4 3 and K3 5
        (3 of them the big-set gradients in the ``xla`` mode), under B (no
        critic) K4 0 and K3 2."""
        big = name == "A"
        return (launches["roi_align_fwd"] == 2 * steps and launches["nms_alive"] >= steps
                and launches["crop_and_resize_grouped"] == (3 if big else 0) * steps
                and launches["roi_align_bwd"] == (5 if big else 2) * steps
                and launches["roi_align_bwd_xla"] == (3 if big else 0) * steps)

    def options_train(name):
        """One 'all' stage of 2 steps of the flagship recipe under option set
        ``name`` through Trainer/train_model in bfloat16, counted from 0:
        launches by :func:`options_launches_ok`; finite losses; under A the
        big loss on, big_fc seeded from the classifier and every BN's
        statistics moved, under B the regression losses 0; every K4 call
        bit-equal to its plain version; the peak memory. Returns the
        trainer, the loader, the launches, the last step's K3 ``xla`` calls
        and the peak memory in GiB."""
        import shutil
        import tempfile

        from feature_intertwiner_tpu_torch.data import synthetic
        from feature_intertwiner_tpu_torch.data.loader import DetectionDataset, Loader
        from feature_intertwiner_tpu_torch.train import workflow

        label = f"OPTIONS {name} TRAIN [bfloat16]"
        tcfg = build_config("meta_105_quick_1", "train", opts=list(FLAGSHIP_OVERRIDES)
                            + OPTION_SETS[name] + [
                                "TRAIN.DO_VALIDATION", "False", "TRAIN.SCHEDULE", "[0, 0, 1]",
                                "TRAIN.KEEP_CHECKPOINTS", "1", "CTRL.SHOW_INTERVAL", "1"])
        require(tcfg.TRAIN.BATCH_SIZE == 4 and tcfg.ROIS.TRAIN_ROIS_PER_IMAGE == 200
                and tcfg.DATA.IMAGE_MAX_DIM == 1024 and tcfg.DATASET.NUM_CLASSES == 81
                and tcfg.MODEL.BACKBONE == "resnet101" and tcfg.TPU.COMPUTE_DTYPE == "bfloat16",
                f"{label}: the recipe is not at full width in bfloat16")
        folder = tempfile.mkdtemp(prefix=f"chip_smoke_options{name}_",
                                  dir=os.path.join(ROOT, "build"))
        tcfg.MISC.RESULT_FOLDER = folder
        tcfg.MISC.LOG_FILE = os.path.join(folder, "log.txt")
        data = synthetic.generate(num_images=8, **TRAIN_DATA)
        loader = Loader(DetectionDataset(data, tcfg, augment=True, seed=tcfg.MISC.SEED),
                        batch_size=tcfg.TRAIN.BATCH_SIZE, shuffle=True, seed=tcfg.MISC.SEED)
        model = temper_fpn(seeded_model(build_model, tcfg, seed=0, dtype=torch.bfloat16))
        trainer = workflow.Trainer(model, tcfg).resume()
        if name == "A":
            require(torch.equal(model.dev_roi.big_fc_layer.weight,
                                model.classifier.linear_class.weight),
                    f"{label}: DEV.BIG_FC_INIT coco_pretrain did not seed big_fc")
        stats0 = {k: v.clone() for k, v in model.state_dict().items()
                  if k.endswith(("running_mean", "running_var"))}
        steps, k4_mism, step_fn = [], [], workflow.train_step
        counters = TRAIN_KERNELS + ("roi_align_bwd_xla",)

        def recorded_step(st, cfg_, batch, lr, meta_gate, generator=None, draws=None, **kw):
            counts0 = dict(cuda_build.launches)
            for rec in (bwd_rec, k4_rec):
                rec.calls.clear()               # the last step's calls only
            metrics = step_fn(st, cfg_, batch, lr, meta_gate, generator, draws, **kw)
            torch.cuda.synchronize()
            steps.append(dict({k: float(v) for k, v in metrics.items()}, launches={
                k: cuda_build.launches[k] - counts0.get(k, 0) for k in counters}))
            k4_mism.append(held_k4(k4_rec.calls))
            return metrics

        workflow.train_step = recorded_step
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        try:
            with Recorder(roi_ops, "roi_align_bwd") as bwd_rec, \
                    Recorder(roi_ops, "crop_and_resize_grouped") as k4_rec:
                cuda_build.launches.clear()
                workflow.train_model(trainer, loader, "all")
                launches = {k: cuda_build.launches[k] for k in counters}
        finally:
            workflow.train_step = step_fn
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"{label} LAUNCHES " + json.dumps(launches))
        for i, s_ in enumerate(steps):
            log(f"{label} step {i + 1} ['all'] "
                + " ".join(f"{k.replace('_loss', '')} {s_[k]:.5g}" for k in (
                    "total_loss", "rpn_class_loss", "rpn_bbox_loss", "mrcnn_class_loss",
                    "mrcnn_bbox_loss", "mrcnn_mask_loss", "meta_loss", "big_loss"))
                + f" | positives {s_['positive_rois']:.0f} | launches {s_['launches']}")
        require(len(steps) == 2 and options_launches_ok(name, launches, 2),
                f"{label} launches {launches}")
        for s_ in steps:
            require(options_launches_ok(name, s_["launches"], 1),
                    f"{label} step launches {s_['launches']}")
            require(all(math.isfinite(s_[k]) for k in s_ if k.endswith("_loss")),
                    f"{label}: a non-finite loss")
        if name == "A":
            require(all(s_["big_loss"] > 0 for s_ in steps), f"{label}: no big loss")
            moved = [k for k, v in stats0.items() if not torch.equal(model.state_dict()[k], v)]
            require(len(moved) == len(stats0), f"{label}: {len(stats0) - len(moved)} BN "
                    "statistics did not move")
        else:
            require(all(s_[k] == 0.0 for s_ in steps for k in (
                "rpn_bbox_loss", "mrcnn_bbox_loss", "mrcnn_mask_loss")),
                f"{label}: a regression loss is not 0 under DEV.DIS_REG_LOSS")
            require(model.dev_roi.upsample is not None
                    and not hasattr(model.dev_roi, "feat_extract"),
                    f"{label}: the baseline has a critic or no make-up layer")
        require(sum(k4_mism) == 0, f"{label}: K4 differs from its plain version")
        require(all(m.training is False for m in model.modules()),
                f"{label}: the model left the step in training mode")
        xla_calls = [(a, k) for a, k in bwd_rec.calls if k.get("xla")]
        log(f"{label} peak memory {peak_gb:.2f} GiB (torch.cuda.max_memory_allocated); K4 "
            f"against its plain version on each step's tensors: {sum(k4_mism)} values differ")
        del bwd_rec, k4_rec
        shutil.rmtree(folder, ignore_errors=True)
        return trainer, loader, launches, xla_calls, peak_gb

    def hold_k3_xla(calls):
        """K3's ``xla`` mode on the last step's three big-set cotangents,
        widened to float32: :func:`check_bwd` (within 1e-5 of its plain
        version in float64, two launches bit-equal, the plain plan, timed
        beside its plain version, its bytes bound and grid_sample's
        backward), and within 1e-5 of the largest gradient of the autograd
        of ``crop_and_resize_grouped_plain(..., positions="xla")`` in
        float64; timed too as the step calls it (bfloat16). Returns the
        three calls' sums."""
        k3 = dict(abs=0.0, ms=0.0, plain_ms=0.0, lib_ms=0.0, bytes=0, ops=0, ms_entry=0.0,
                  autograd=0.0)
        require(len(calls) == 3, f"OPTIONS A: {len(calls)} K3 xla calls in the last step")
        for args, kwargs in calls:
            g, shapes, boxes, bidx, lidx, crop = args[:6]
            b, h, w, c = shapes[0]
            r = check_bwd(f"xla mode, big set {h}x{w}", g.float(), shapes, boxes, bidx, lidx,
                          crop, b, xla=True)
            for key in ("ms", "plain_ms", "lib_ms", "bytes"):
                k3[key] += r[key]
            k3["abs"] = max(k3["abs"], r["abs"])
            k3["ms_entry"] += cuda_ms(torch, lambda: roi_ops.roi_align_bwd(*args, **kwargs), 10)
            _, _, _, valid = roi_ops.tap_rows(shapes, boxes, bidx, lidx, crop, xla=True)
            k3["ops"] += int(valid.sum()) * c * ROI_BWD_OPS_PER_VALUE
            got = roi_ops.roi_align_bwd(g.float(), shapes, boxes, bidx, lidx, crop, xla=True)[0]
            with torch.enable_grad():
                image = torch.zeros(shapes[0], dtype=torch.float64, device="cuda",
                                    requires_grad=True)
                nb = boxes.shape[0] // b
                out = roi_ops.crop_and_resize_grouped_plain(image, boxes.view(b, nb, 4), crop,
                                                            positions="xla")
                (want,) = torch.autograd.grad(out, image, g.double().view(out.shape))
            err = float((got.double() - want).abs().max() / want.abs().max())
            k3["autograd"] = max(k3["autograd"], err)
            log(f"  roi_align_bwd xla mode {h}x{w}: against the autograd of the plain crop "
                f"{err:.3g} of its largest gradient")
            require(err <= 1e-5, f"K3's xla mode differs from the autograd of the plain crop "
                    f"by {err} ({h}x{w})")
        return k3

    def options_small(name):
        """Option set ``name`` on a small float32 model, one train step card
        against CPU (:func:`small_step_card_and_cpu`): losses within 1e-4
        relative, the buffer within 1e-4, BN running statistics within 1e-4
        of each tensor's largest magnitude, the card's parameters within
        1e-5 of those the CPU's optimizer gives from the card's gradients;
        under B the optimizer's ``mu`` and ``nu`` (as its root) within 1e-5
        of the CPU's; under A, where BN learning makes those gradients
        ill-conditioned at this size (ROADMAP §C), ``mu`` and ``nu`` as one
        vector within 1e-5 of its norm plus four times the CPU's own float32
        error (its distance from a CPU step of float64 batch moments)."""
        from feature_intertwiner_tpu_torch.models import common
        from feature_intertwiner_tpu_torch.train.optim import (OptaxChain, moment_slots,
                                                              within_own_error)

        label = f"OPTIONS {name} REFERENCE"
        tsmall = build_config("smoke_small", "train", opts=small_opts + OPTION_SETS[name] + [
            "ROIS.ASSIGN_ANCHOR_BASE", "56.0"])
        runs = small_step_card_and_cpu(tsmall)
        (mg, _, bg, cg), (mc, _, bc, cc) = runs["cuda"], runs["cpu"]
        sg, sc = runs["cuda_state"], runs["cpu_state"]
        loss_rel = max(abs(mg[k] - mc[k]) / max(abs(mc[k]), 1e-6) for k in mc
                       if k.endswith("_loss"))
        buf_err = max(float((bg - bc).abs().max()), float((cg - cc).abs().max()))
        sdg, sdc = sg.model.state_dict(), sc.model.state_dict()
        stat_rel = max([float((sdg[k].cpu() - sdc[k]).abs().max()
                              / sdc[k].abs().max().clamp_min(1e-12))
                        for k in sdc if k.endswith(("running_mean", "running_var"))])
        # the CPU's optimizer, from the same starting weights, on the card's gradients
        start = seeded_model(build_model, tsmall, seed=3, device="cpu")
        biases = torch.Generator().manual_seed(4)
        with torch.no_grad():
            for n_, p in start.named_parameters():
                if n_.endswith("bias"):
                    p.copy_(torch.randn(p.shape, generator=biases) * 0.005)
        temper_fpn(start)
        ref_params = [p.detach().clone().requires_grad_() for p in start.parameters()]
        for p, q in zip(ref_params, sg.model.parameters()):
            p.grad = q.grad.cpu()
        ref = OptaxChain(ref_params, tsmall.TRAIN.OPTIM_METHOD, tsmall.TRAIN.WEIGHT_DECAY,
                         tsmall.TRAIN.MOMENTUM)
        ref.param_groups[0]["lr"] = 0.01
        ref.step()
        opt_rel, worst = max((float((q.detach().cpu() - p.detach()).abs().max()
                                    / p.detach().abs().max().clamp_min(1e-12)), n_)
                             for (n_, q), p in zip(sg.model.named_parameters(), ref_params))
        moments = []
        for (n_, p), q in zip(sg.model.named_parameters(), sc.model.parameters()):
            for slot in ("mu", "nu"):
                a, b = sg.optimizer.state[p][slot].cpu(), sc.optimizer.state[q][slot]
                if slot == "nu":
                    a, b = a.sqrt(), b.sqrt()
                moments.append((float((a - b).abs().max() / b.abs().max().clamp_min(1e-12)),
                                f"{slot} {n_}"))
        mom_rel, mom_worst = max(moments)
        held, gap, floor, size = True, 0.0, 0.0, 0.0
        if name == "A":
            with common.float64_moments():
                s64 = small_step_card_and_cpu(tsmall)["cpu_state"]
            cpu = moment_slots(sc.model, sc.optimizer)
            held, gap, floor, size = within_own_error(
                moment_slots(sg.model, sg.optimizer), cpu,
                moment_slots(s64.model, s64.optimizer), cpu)
        log(f"{label} train step card vs CPU: losses rel err {loss_rel:.3g}; buffer err "
            f"{buf_err:.3g}; BN statistics rel err {stat_rel:.3g}; parameters against the CPU "
            f"optimizer on the card's gradients {opt_rel:.3g} ({worst}); optimizer moments "
            f"against the CPU's {mom_rel:.3g} ({mom_worst}); positives {mg['positive_rois']:.0f}"
            + (f"; moments as one vector: {gap:.4g} from the CPU's, whose own float32 error is "
               f"{floor:.4g} (norm {size:.4g})" if name == "A" else ""))
        require(loss_rel <= 1e-4 and buf_err <= 1e-4 and stat_rel <= 1e-4 and opt_rel <= 1e-5,
                f"{label}: the card's train step differs from the CPU's")
        require(mom_rel <= 1e-5 if name == "B" else held,
                f"{label}: the card's gradients differ from the CPU's")
        require(mg["positive_rois"] > 0, f"{label}: no positives")

    def train_options_path():
        """The flagship under option sets A and B at full width in bfloat16
        (:func:`options_train`), K3's ``xla`` mode held and timed on set A's
        big-set cotangents (:func:`hold_k3_xla`), each set's step paired with
        the flagship's SGD step in turns and its device time by family, then
        each set on a small model card against CPU (:func:`options_small`)."""
        from feature_intertwiner_tpu_torch.train import workflow

        t0 = time.perf_counter()
        trainers, peaks = {}, {}
        for name in ("A", "B"):
            trainer, loader, launches, xla_calls, peaks[name] = options_train(name)
            trainers[name] = trainer
            if name == "A":
                a_launches = launches
                with torch.no_grad():
                    k3 = hold_k3_xla(xla_calls)
                del xla_calls
        k3_bytes = k3["bytes"] / H100_BYTES_PER_S * 1e3
        k3_ops = k3["ops"] / H100_FP32_OPS_PER_S * 1e3
        log(f"OPTIONS A per step: K3 xla mode float32 kernel {k3['ms']:.4f} ms over 3 launches, "
            f"plain {k3['plain_ms']:.4f}, grid_sample backward {k3['lib_ms']:.4f}; bound "
            f"{k3['bytes']} bytes -> {k3_bytes:.6f} ms, {k3['ops']} fp32 ops -> {k3_ops:.6f} ms; "
            f"as the step calls it (bfloat16 cotangents) {k3['ms_entry']:.4f} ms")
        fold_err("roi_align_bwd", k3["abs"])
        kernels.append({
            "name": "roi_align_bwd_xla", "route": "cuda",
            "source": "feature_intertwiner_tpu_torch/csrc/roi_align_bwd.cu",
            "replaces": "feature_intertwiner_tpu/ops/roi_align_window_bwd.py:106",
            "launches": a_launches["roi_align_bwd_xla"], "max_abs_err": k3["abs"],
            "ms": k3["ms"], "plain_ms": k3["plain_ms"], "bound_ms": max(k3_bytes, k3_ops),
            "bound_by": "bytes" if k3_bytes >= k3_ops else "operations",
            "library_ms": k3["lib_ms"]})
        log(f"OPTIONS the two stages and their checks: {time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        tcfg1 = build_config("meta_105_quick_1", "train", opts=list(FLAGSHIP_OVERRIDES))
        t1 = workflow.Trainer(temper_fpn(seeded_model(build_model, tcfg1, seed=0,
                                                      dtype=torch.bfloat16)), tcfg1)
        batch = workflow.to_device(next(iter(loader)), "cuda")
        gen = torch.Generator(device="cuda")
        for t in (t1, *trainers.values()):
            workflow.set_trainable(t.model, "all")

        def one(t):
            gen.manual_seed(0)
            workflow.train_step(t.state, t.cfg, batch, 1e-4, 1.0, gen)

        one(t1)
        step_ms, runs = paired({"flagship SGD": lambda: one(t1),
                                "set A": lambda: one(trainers["A"]),
                                "set B": lambda: one(trainers["B"])}, 2, events=True)
        log("OPTIONS TRAIN step ms ['all', bfloat16], medians of 4 in turns (CUDA events): "
            + "; ".join(f"{k} {v:.2f} (runs {', '.join(f'{x:.2f}' for x in runs[k])})"
                        for k, v in step_ms.items())
            + f"; peak memory of each set's stage: A {peaks['A']:.2f} GiB, B {peaks['B']:.2f} GiB")
        for name in ("A", "B"):
            out = profile_by_family(torch, lambda: one(trainers[name]), 1, families)
            log_breakdown(f"OPTIONS TRAIN BREAKDOWN one 'all' step of set {name} bfloat16", *out)
        del t1, trainers, batch
        log(f"OPTIONS the steps paired with the flagship's: {time.perf_counter() - t0:.1f} s")
        for name in ("A", "B"):
            options_small(name)

    phase("train_options_path", train_options_path)

    def assign_launches_ok(name, launches):
        """One train step's launches: under C K1 2, K4 4 (the big-set crops of
        P2-P5), K3 2, K2 at least 1; under D (RoIPool, plain PyTorch) K1, K4
        and K3 none, K2 at least 1."""
        c = name == "C"
        return (launches["roi_align_fwd"] == (2 if c else 0)
                and launches["crop_and_resize_grouped"] == (4 if c else 0)
                and launches["roi_align_bwd"] == (2 if c else 0)
                and launches["nms_alive"] >= 1)

    def hold_k3_bf16(calls, label):
        """Each recorded bfloat16 K3 call within one bfloat16 rounding of its
        plain version and bit-equal over two launches; returns the largest
        difference over the largest gradient."""
        rel = 0.0
        for args, kwargs in calls:
            require(args[0].dtype == torch.bfloat16, f"{label}: K3's cotangent is not bfloat16")
            got = roi_ops.roi_align_bwd(*args, **kwargs)
            again = roi_ops.roi_align_bwd(*args, **kwargs)
            want = roi_ops.multilevel_gather_bwd_plain(*args, **kwargs)
            torch.cuda.synchronize()
            for a, b, c in zip(got, again, want):
                require(a.dtype == torch.bfloat16 and torch.equal(a, b),
                        f"{label}: two bf16 K3 launches differ")
                tol = 2.0 ** -7 * c.float().abs() + 1e-5 * c.float().abs().max()
                require(float(((a.float() - c.float()).abs() - tol).max()) <= 0,
                        f"{label}: bf16 K3 beyond one rounding of its plain version")
                rel = max(rel, float((a.float() - c.float()).abs().max()
                                     / c.float().abs().max().clamp_min(1e-30)))
        return rel

    def assign_detect(name):
        """``detect()`` of the two images by the flagship under set ``name`` in
        bfloat16, counted from 0: K1 2 under C (7² classifier, 14² mask,
        level 6 on P5) and 0 under D, K2 at least 2; finite outputs of the
        main path's shapes; K1 and K2 bit-equal to their plain versions; its
        peak memory. Returns a call of it and the peak memory in GiB."""
        label = f"ASSIGN {name} MAIN [bfloat16]"
        icfg = build_config("meta_105_quick_1", "inference",
                            opts=list(FLAGSHIP_OVERRIDES) + ASSIGN_SETS[name])
        model = seeded_model(build_model, icfg, seed=0, dtype=torch.bfloat16)
        detect(model, images, icfg)                    # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda_build.launches.clear()
        with Recorder(roi_ops, "roi_align_fwd") as roi_rec, \
                Recorder(nms_ops, "nms_alive") as nms_rec:
            results = detect(model, images, icfg)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        launches = {k: cuda_build.launches[k] for k in TRAIN_KERNELS}
        log(f"{label} LAUNCHES " + json.dumps(launches))
        require(launches["roi_align_fwd"] == (2 if name == "C" else 0)
                and launches["nms_alive"] >= 2 and launches["crop_and_resize_grouped"] == 0
                and launches["roi_align_bwd"] == 0, f"{label} launches {launches}")
        molded, windows = mold_inputs(images, icfg, "cuda")
        with torch.inference_mode():
            out = model.forward_inference(molded, windows)
            rows = hold_k1(roi_rec.calls, label)
            mism = sum(int((nms_ops.nms_alive(*a, **k) != nms_ops.greedy_alive_sorted_plain(
                *a, **k)).sum()) for a, k in nms_rec.calls)
        det, masks = out["detections"], out["masks"]
        require(det.shape == (2, 100, 6) and masks.shape == (2, 100, 28, 28)
                and bool(torch.isfinite(det).all() and torch.isfinite(masks).all())
                and bool(((masks >= 0) & (masks <= 1)).all()), f"{label} outputs")
        n_det = [int((det[i, :, 5] > 0).sum()) for i in range(2)]
        require(sum(n_det) > 0 and mism == 0, f"{label}: detections {n_det}, K2 differs "
                f"from its plain version in {mism} values")
        log(f"{label} detections per image {n_det}, {sum(len(r['class_ids']) for r in results)} "
            f"after unmolding; peak memory {peak:.2f} GiB (torch.cuda.max_memory_allocated); "
            f"K1 {[r[0] for r in rows]} bit-equal to its plain version")
        return (lambda: detect(model, images, icfg)), peak

    def assign_loader(tcfg):
        """The train path's 8 synthetic 1024² images at ``tcfg``'s batch."""
        from feature_intertwiner_tpu_torch.data import synthetic
        from feature_intertwiner_tpu_torch.data.loader import DetectionDataset, Loader

        data = synthetic.generate(num_images=8, **TRAIN_DATA)
        return Loader(DetectionDataset(data, tcfg, augment=True, seed=tcfg.MISC.SEED),
                      batch_size=tcfg.TRAIN.BATCH_SIZE, shuffle=True, seed=tcfg.MISC.SEED)

    def assign_train(name):
        """One 'all' train step of the flagship recipe under set ``name`` at
        full width in bfloat16 (R101-FPN, 1024², batch 4, 200 RoIs per image),
        counted from 0 (:func:`assign_launches_ok`), finite losses, its peak
        memory; under C every K4 call bit-equal to its plain version, the P5
        call (the reliable set of meta level 5) timed beside its plain
        version and bound, K3 within one bfloat16 rounding. Returns a call
        of the step (on the same batch) and the peak memory in GiB."""
        from feature_intertwiner_tpu_torch.train import workflow

        label = f"ASSIGN {name} TRAIN [bfloat16]"
        tcfg = build_config("meta_105_quick_1", "train",
                            opts=list(FLAGSHIP_OVERRIDES) + ASSIGN_SETS[name])
        require(tcfg.TRAIN.BATCH_SIZE == 4 and tcfg.ROIS.TRAIN_ROIS_PER_IMAGE == 200
                and tcfg.DATA.IMAGE_MAX_DIM == 1024 and tcfg.MODEL.BACKBONE == "resnet101"
                and tcfg.TPU.COMPUTE_DTYPE == "bfloat16", f"{label}: not at full width")
        trainer = workflow.Trainer(temper_fpn(seeded_model(build_model, tcfg, seed=0,
                                                           dtype=torch.bfloat16)), tcfg)
        workflow.set_trainable(trainer.model, "all")
        batch = workflow.to_device(next(iter(assign_loader(tcfg))), "cuda")
        gen = torch.Generator(device="cuda")
        dev = trainer.model.dev_roi
        require(dev.meta_levels == ((2, 3, 4, 5) if name == "C" else (2, 3, 4))
                and dev.roi_method == ("roi_align" if name == "C" else "roi_pool")
                and trainer.model.rpn.conv_shared.stride == ((2, 2) if name == "C" else (1, 1)),
                f"{label}: the model is not the option set's")

        def one():
            gen.manual_seed(0)
            return workflow.train_step(trainer.state, tcfg, batch, 1e-4, 1.0, gen)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with Recorder(roi_ops, "roi_align_bwd") as bwd_rec, \
                Recorder(roi_ops, "crop_and_resize_grouped") as k4_rec:
            cuda_build.launches.clear()
            metrics = {k: float(v) for k, v in one().items()}
            torch.cuda.synchronize()
            launches = {k: cuda_build.launches[k] for k in TRAIN_KERNELS}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"{label} LAUNCHES per step " + json.dumps(launches) + " | "
            + " ".join(f"{k.replace('_loss', '')} {metrics[k]:.5g}" for k in (
                "total_loss", "rpn_class_loss", "rpn_bbox_loss", "mrcnn_class_loss",
                "mrcnn_bbox_loss", "mrcnn_mask_loss", "meta_loss"))
            + f" | positives {metrics['positive_rois']:.0f} | small RoIs per meta level "
            + "/".join(f"{metrics[f'small_rois_p{lv}']:.0f}" for lv in dev.meta_levels))
        require(assign_launches_ok(name, launches), f"{label} launches {launches}")
        require(all(math.isfinite(v) for k, v in metrics.items() if k.endswith("_loss")),
                f"{label}: a non-finite loss")
        extra = ""
        if name == "C":
            require(held_k4(k4_rec.calls) == 0, f"{label}: K4 differs from its plain version")
            p5 = [(a, k) for a, k in k4_rec.calls if a[0].shape[1] == 1024 // 32]
            require(len(p5) == 1, f"{label}: {len(p5)} K4 calls on P5")
            (args, kwargs), = p5
            image, boxes, crop = args[0], args[1], args[2]
            with torch.no_grad():
                k_ms = cuda_ms(torch, lambda: k4_wrapper(*args, **kwargs), 10)
                wide = (image.float(),) + tuple(args[1:])
                k32_ms = cuda_ms(torch, lambda: k4_wrapper(*wide, **kwargs), 10)
                p_ms = cuda_ms(torch, lambda: roi_ops.crop_and_resize_grouped_plain(
                    *args, **kwargs), 3)
                nbytes, rows_, ops, b_ms = k45_bound(torch, roi_ops, image.float(), boxes,
                                                     tuple(crop), positions="xla")
                k3_rel = hold_k3_bf16(bwd_rec.calls, label)
            cuda_build.launches["crop_and_resize_grouped"] = launches["crop_and_resize_grouped"]
            require(len(bwd_rec.calls) == 2, f"{label}: {len(bwd_rec.calls)} K3 calls")
            extra = (f"; K4 on P5 {tuple(image.shape)} {str(image.dtype).split('.')[-1]}, "
                     f"{boxes.shape[0] * boxes.shape[1]} boxes at {tuple(crop)}: bit-equal to "
                     f"its plain version, {k_ms:.4f} ms (the float32 kernel on the widened map "
                     f"{k32_ms:.4f} ms), float32 bound {b_ms:.6f} ms ({nbytes} "
                     f"bytes, {rows_} tap rows, {ops} ops), plain {p_ms:.4f} ms; K3 within one "
                     f"bfloat16 rounding, largest difference {k3_rel:.3g} of the largest "
                     f"gradient")
        del bwd_rec, k4_rec
        log(f"{label} peak memory of the counted step {peak:.2f} GiB "
            f"(torch.cuda.max_memory_allocated)" + extra)
        return one, peak

    def assign_roipool_path():
        """ROADMAP A6 and A7 at full width in bfloat16: set C
        (``DEV.ASSIGN_BOX_ON_ALL_SCALE`` with ``RPN.ANCHOR_STRIDE 2``) and
        set D (``ROIS.METHOD roi_pool``), each ``detect()`` of the two images
        (:func:`assign_detect`) and one 'all' train step
        (:func:`assign_train`); both paired in turns with the flagship's
        (medians of 4), with their and the flagship's peak memory, and set
        D's step by kernel family and aten op; then each set on a small
        model card against CPU: the second stage on the same proposals and
        one float32 train step, at the tolerances of ``reference``."""
        from feature_intertwiner_tpu_torch.train import workflow

        t0 = time.perf_counter()
        detects, steps, peaks = {}, {}, {}
        for name in ("C", "D"):
            detects[name], peaks[f"{name} detect()"] = assign_detect(name)
            steps[name], peaks[f"{name} step"] = assign_train(name)
        icfg = build_config("meta_105_quick_1", "inference", opts=list(FLAGSHIP_OVERRIDES))
        flagship = seeded_model(build_model, icfg, seed=0, dtype=torch.bfloat16)
        detects["flagship"] = lambda: detect(flagship, images, icfg)
        detects["flagship"]()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        detects["flagship"]()
        torch.cuda.synchronize()
        peaks["flagship detect()"] = torch.cuda.max_memory_allocated() / 2 ** 30
        detect_ms, detect_runs = paired(detects, 2)
        tcfg = build_config("meta_105_quick_1", "train", opts=list(FLAGSHIP_OVERRIDES))
        t1 = workflow.Trainer(temper_fpn(seeded_model(build_model, tcfg, seed=0,
                                                      dtype=torch.bfloat16)), tcfg)
        workflow.set_trainable(t1.model, "all")
        gen = torch.Generator(device="cuda")
        batch = workflow.to_device(next(iter(assign_loader(tcfg))), "cuda")

        def flagship_step():
            gen.manual_seed(0)
            workflow.train_step(t1.state, tcfg, batch, 1e-4, 1.0, gen)

        steps["flagship"] = flagship_step
        flagship_step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        flagship_step()
        torch.cuda.synchronize()
        peaks["flagship step"] = torch.cuda.max_memory_allocated() / 2 ** 30
        step_ms, step_runs = paired(steps, 2, events=True)
        for what, ms, runs in (("detect() of 2 (host clock)", detect_ms, detect_runs),
                               ("'all' step (CUDA events)", step_ms, step_runs)):
            log(f"ASSIGN {what} ms [bfloat16], medians of 4 in turns: " + "; ".join(
                f"{k} {v:.2f} (runs {', '.join(f'{x:.2f}' for x in runs[k])})"
                for k, v in ms.items()))
        log("ASSIGN peak memory [bfloat16] (torch.cuda.max_memory_allocated, GiB): "
            + ", ".join(f"{k} {v:.2f}" for k, v in peaks.items())
            + f"; {time.perf_counter() - t0:.1f} s")
        # where set D's time goes: RoIPool is plain PyTorch
        log_breakdown("ASSIGN D TRAIN BREAKDOWN one 'all' step bfloat16",
                      *profile_by_family(torch, steps["D"], 1, families))
        log("ASSIGN D TRAIN the aten ops of one 'all' step with the most device time:")
        for ms_, n_, op, shapes in top_ops(torch, steps["D"]):
            log(f"    {ms_:9.3f} ms  {n_:4d} calls  {op}  {str(shapes)[:110]}")
        del detects, steps, flagship, t1, batch
        torch.cuda.empty_cache()
        for name in ("C", "D"):
            small_second_stage(build_config("smoke_small", "inference",
                                            opts=small_opts + ASSIGN_SETS[name]),
                               f"ASSIGN {name} REFERENCE")
            small_step_checked(small_opts + ASSIGN_SETS[name], f"ASSIGN {name} REFERENCE")

    phase("assign_roipool_path", assign_roipool_path)

    # 21. the visualize phase and pretrained files ---------------------------------
    def hold_visualize_kernels(roi_calls, nms_calls, launches):
        """The K1 and K2 calls of one float32 visualize batch, each against
        its plain version (K1 within 1e-5, K2 bit for bit) and bit-equal over
        two launches, timed beside its plain version, its bound and (K1)
        grid_sample over P2; their entries in the kernel line, ``launches``
        from the command line's run."""
        k1 = dict(err=0.0, ms=0.0, plain=0.0, lib=0.0, bytes=0, ops=0)
        for args, kwargs in roi_calls:
            feats, boxes, bidx, lidx, crop = args[:5]
            got = roi_ops.roi_align_fwd(*args, **kwargs)
            again = roi_ops.roi_align_fwd(*args, **kwargs)
            want = roi_ops.multilevel_gather_plain(*args, **kwargs)
            require(torch.equal(got, again), "two K1 launches differ on the visualize batch")
            k1["err"] = max(k1["err"], float((got - want).abs().max()))
            k1["ms"] += cuda_ms(torch, lambda: roi_ops.roi_align_fwd(*args, **kwargs), 20)
            k1["plain"] += cuda_ms(torch, lambda: roi_ops.multilevel_gather_plain(*args, **kwargs), 5)
            p2, grid = feats[0].permute(0, 3, 1, 2), profile_roi.box_grid(boxes, crop, feats[0].shape[0])
            k1["lib"] += cuda_ms(torch, lambda: torch.nn.functional.grid_sample(
                p2, grid, mode="bilinear", padding_mode="zeros", align_corners=True), 20)
            nbytes, _, n_ops = k1_work(torch, roi_ops, feats, boxes, bidx, lidx, crop)
            k1["bytes"], k1["ops"] = k1["bytes"] + nbytes, k1["ops"] + n_ops
        require(k1["err"] <= 1e-5, f"K1 differs from its plain version by {k1['err']} (visualize)")
        mism, k2_ms, k2_plain, needed = 0, 0.0, 0.0, []
        for args, kwargs in nms_calls:
            got = nms_ops.nms_alive(*args, **kwargs)
            require(torch.equal(got, nms_ops.nms_alive(*args, **kwargs)),
                    "two K2 launches differ on the visualize batch")
            want = nms_ops.greedy_alive_sorted_plain(*args, **kwargs)
            mism += int((got != want).sum())
            k2_ms += cuda_ms(torch, lambda: nms_ops.nms_alive(*args, **kwargs), 20)
            k2_plain += cuda_ms(torch, lambda: nms_ops.greedy_alive_sorted_plain(*args, **kwargs), 2)
            needed.append((*args[:2], want, args[2], call_opts(args, kwargs)))
        require(mism == 0, f"K2 differs from its plain version in {mism} rows (visualize)")
        _, _, _, t_ops, t_bytes = nms_bound(nms_ops, needed)
        k1_tb, k1_to = k1["bytes"] / H100_BYTES_PER_S * 1e3, k1["ops"] / H100_FP32_OPS_PER_S * 1e3
        log(f"VISUALIZE kernels on one float32 batch of 2: roi_align_fwd {len(roi_calls)} call(s) "
            f"(n={[int(a[1].shape[0]) for a, _ in roi_calls]}), err {k1['err']:.3g}, "
            f"{k1['ms']:.4f} ms, plain {k1['plain']:.4f} ms, grid_sample {k1['lib']:.4f} ms, bound "
            f"{max(k1_tb, k1_to):.6f} ms; nms_alive {len(nms_calls)} calls "
            f"(shapes {[tuple(a[0].shape) for a, _ in nms_calls]}), {mism} mismatches, "
            f"{k2_ms:.4f} ms, plain {k2_plain:.4f} ms, bound {max(t_ops, t_bytes):.6f} ms")
        kernels.append({
            "name": "roi_align_fwd_visualize", "route": "cuda",
            "source": "feature_intertwiner_tpu_torch/csrc/roi_align_fwd.cu",
            "replaces": "feature_intertwiner_tpu/ops/roi_align_window.py:64",
            "launches": launches["roi_align_fwd"], "max_abs_err": k1["err"], "ms": k1["ms"],
            "plain_ms": k1["plain"], "bound_ms": max(k1_tb, k1_to),
            "bound_by": "bytes" if k1_tb >= k1_to else "operations", "library_ms": k1["lib"]})
        kernels.append({
            "name": "nms_alive_visualize", "route": "cuda",
            "source": "feature_intertwiner_tpu_torch/csrc/nms.cu",
            "replaces": "feature_intertwiner_tpu/ops/nms_pallas.py:47",
            "launches": launches["nms_alive"], "max_abs_err": float(mism > 0), "ms": k2_ms,
            "plain_ms": k2_plain, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes", "library_ms": None})

    def resume_equal(path, model, molded, windows, folder, keep=()):
        """A fresh flagship model (torch's default initialisation) started on
        the card from ``path`` through ``Trainer.resume``: every tensor and
        the forward's detections equal to ``model``'s. ``keep``: name
        prefixes the file does not hold, copied from ``model`` first.
        Returns the trainer and its log."""
        from feature_intertwiner_tpu_torch.train import workflow

        tcfg = build_config("meta_105_quick_1", "train", opts=list(FLAGSHIP_OVERRIDES))
        tcfg.MODEL.INIT_FILE_CHOICE = path
        tcfg.MISC.RESULT_FOLDER = os.path.join(folder, "resume_" + os.path.basename(path))
        tcfg.MISC.LOG_FILE = os.path.join(tcfg.MISC.RESULT_FOLDER, "log.txt")
        os.makedirs(tcfg.MISC.RESULT_FOLDER)
        fresh = build_model(tcfg)
        want = model.state_dict()
        fresh.load_state_dict({k: v for k, v in want.items() if k.startswith(keep)}, strict=False)
        t0 = time.perf_counter()
        trainer = workflow.Trainer(fresh, tcfg).resume()
        dt = time.perf_counter() - t0
        got = fresh.state_dict()
        bad = [k for k in want if not torch.equal(got[k], want[k])]
        require(not bad, f"{path}: {len(bad)} tensors differ after resume, e.g. {bad[:3]}")
        with torch.inference_mode():
            a = fresh.forward_inference(molded, windows, with_masks=False)["detections"]
            b = model.forward_inference(molded, windows, with_masks=False)["detections"]
        require(torch.equal(a, b), f"{path}: the resumed model's detections differ")
        with open(tcfg.MISC.LOG_FILE) as f:
            text = f.read()
        overlay = [line for line in text.splitlines() if line.startswith(("[params]", "[batch_stats]"))]
        log(f"VISUALIZE resumed from {os.path.basename(path)} ({os.path.getsize(path) / 2 ** 20:.0f} "
            f"MiB) in {dt:.2f} s: {len(want)} tensors equal, detections equal; " + "; ".join(overlay))
        return trainer, text

    def visualize_pretrained_path():
        """ROADMAP A8 and A9 at flagship width: pretrained files written from
        the seeded model (a reference ``.pth`` payload, the converter's npz,
        a keras ``.h5`` where h5py is present); ``--phase visualize
        --synthetic_data`` in bfloat16 started from the npz, its launches
        counted from 0 (K1 1 and K2 at least 2 per image) and its
        ``features.npz`` checked; in float32 the visualize detections equal
        ``detect()``'s, and one batch's K1 and K2 calls held against their
        plain versions (their entries in the kernel line); the visualize
        forward and ``detect()`` of one image paired in bfloat16 and float32;
        a fresh model resumed from each file equal to the seeded one;
        ``TEST.SAVE_IM`` on 2 images where matplotlib is present; and the
        time of ``tsne_embed`` over the dumped features."""
        import contextlib
        import importlib.util
        import io
        import re
        import shutil
        import tempfile

        import numpy as np
        from feature_intertwiner_tpu_torch import main as port_main
        from feature_intertwiner_tpu_torch.data import synthetic
        from feature_intertwiner_tpu_torch.evaluation import COCO
        from feature_intertwiner_tpu_torch.inference import unmold_detections, visualize
        from feature_intertwiner_tpu_torch.train import workflow
        from feature_intertwiner_tpu_torch.utils import convert_weights as cw
        from feature_intertwiner_tpu_torch.utils.tsne import joint_affinities, tsne_embed

        present = {m: importlib.util.find_spec(m) is not None for m in ("matplotlib", "h5py", "PIL")}
        log("VISUALIZE importlib.util.find_spec: " + json.dumps(present))
        folder = tempfile.mkdtemp(prefix="chip_smoke_vis_", dir=os.path.join(ROOT, "build"))
        cwd = os.getcwd()
        try:
            icfg = build_config("meta_105_quick_1", "inference", opts=list(FLAGSHIP_OVERRIDES))
            model = seeded_model(build_model, icfg, seed=0)
            sd = model.state_dict()
            g = torch.Generator().manual_seed(5)
            buffer = torch.randn((1, 1024, 81), generator=g)
            buffer_cnt = torch.randint(0, 4, (1, 1, 81), generator=g).float()
            pth, npz = os.path.join(folder, "reference.pth"), os.path.join(folder, "converted.npz")
            torch.save({"state_dict": {f"module.{k}": v.cpu() for k, v in sd.items()},
                        "epoch": 2, "iter": 7, "buffer": buffer, "buffer_cnt": buffer_cnt}, pth)
            cw.main(["--input", pth, "--format", "reference", "--arch", "resnet101",
                     "--output", npz])

            # the command line in bfloat16, started from the npz
            os.chdir(folder)
            cuda_build.launches.clear()
            t0 = time.perf_counter()
            path = port_main.main(["--phase", "visualize", "--synthetic_data", "--config_name",
                                   "vis", *FLAGSHIP_OVERRIDES, "MODEL.INIT_FILE_CHOICE", npz])
            wall = time.perf_counter() - t0
            launches = {k: cuda_build.launches[k] for k in ("roi_align_fwd", "nms_alive")}
            with np.load(path) as data:
                dumped = {k: data[k] for k in data.files}
            with open(os.path.join(os.path.dirname(path), "log.txt")) as f:
                cli_log = f.read()
            os.chdir(cwd)
            n = dumped["detections"].shape[0]
            valid = dumped["detections"][..., 5] > 0
            log(f"VISUALIZE --phase visualize [bfloat16] on {n} images in {wall:.2f} s: launches "
                f"{json.dumps(launches)} ({launches['roi_align_fwd'] / n:g} K1 and "
                f"{launches['nms_alive'] / n:g} K2 per image); features.npz "
                f"{ {k: (v.shape, str(v.dtype)) for k, v in dumped.items()} }, detections per "
                f"image {valid.sum(1).tolist()}")
            require(sorted(dumped) == ["detections", "features"] and n == 8
                    and dumped["features"].shape == (8, 100, 1024)
                    and dumped["detections"].shape == (8, 100, 6)
                    and all(v.dtype == np.float32 for v in dumped.values()),
                    "features.npz has not the JAX phase's keys, shapes and dtypes")
            require(all(np.isfinite(v).all() for v in dumped.values()), "non-finite features.npz")
            require(valid.any() and not dumped["features"][~valid].any()
                    and (np.abs(dumped["features"][valid]).max(-1) > 0).all(),
                    "no detections, or features not zero on exactly the padding rows")
            require(launches["roi_align_fwd"] == n and launches["nms_alive"] >= 2 * n,
                    f"launches {launches} over {n} images")
            require("initialized from pretrained weights" in cli_log, "the run did not start "
                    "from the npz")

            # float32: visualize against detect(), and one batch's kernels
            molded, windows = mold_inputs(images, icfg, "cuda")
            with Recorder(roi_ops, "roi_align_fwd") as roi_rec, \
                    Recorder(nms_ops, "nms_alive") as nms_rec:
                vis = visualize(model, images, icfg)
            dets = detect(model, images, icfg)
            for i, (v, d, img) in enumerate(zip(vis, dets, images)):
                boxes, class_ids, scores, _ = unmold_detections(
                    v["detections"], None, img.shape, windows[i].cpu().numpy())
                require(np.array_equal(boxes, d["rois"]) and np.array_equal(class_ids, d["class_ids"])
                        and np.array_equal(scores, d["scores"]),
                        f"image {i}: the visualize detections differ from detect()'s")
                keep = v["detections"][:, 5] > 0
                require(np.isfinite(v["features"]).all() and not v["features"][~keep].any(),
                        f"image {i}: features non-finite or not zero on the padding rows")
            log(f"VISUALIZE float32: the visualize detections equal detect()'s on both images "
                f"({[len(d['scores']) for d in dets]} detections)")
            with torch.inference_mode():
                hold_visualize_kernels(roi_rec.calls, nms_rec.calls, launches)
            del roi_rec, nms_rec

            # the visualize forward and detect() of one image, in turns
            one = images[:1]

            def typed(fn, dtype):
                def run():
                    model.dtype = dtype
                    fn(model, one, icfg)
                return run

            fns = {f"{name} {label}": typed(fn, dtype)
                   for label, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32))
                   for name, fn in (("visualize", visualize), ("detect()", detect))}
            for fn in fns.values():
                fn()
            ms, runs = paired(fns, 3)
            model.dtype = torch.float32
            log("VISUALIZE ms per image (host clock, one 480x640 image molded to 1024², medians "
                "of 6 in turns): " + "; ".join(
                    f"{k} {v:.2f} (runs {', '.join(f'{x:.2f}' for x in runs[k])})"
                    for k, v in ms.items()))

            # pretrained files: a fresh model resumed from each
            trainer, text = resume_equal(pth, model, molded, windows, folder)
            require(torch.equal(trainer.state.buffer.cpu(), buffer)
                    and torch.equal(trainer.state.buffer_cnt.cpu(), buffer_cnt)
                    and (trainer.epoch, trainer.iter) == (2, 8),
                    "the payload's buffer or counters were not restored")
            del trainer
            resume_equal(npz, model, molded, windows, folder)
            ran = ["pth", "npz"]
            if present["h5py"]:
                h5 = os.path.join(folder, "keras.h5")
                cw.write_keras_h5(h5, *cw.convert_reference_state_dict(
                    {k: v.cpu().numpy() for k, v in sd.items()}, "resnet101", strict=True),
                    arch="resnet101")
                # the keras file holds no Dev: its layers start as the seeded model's
                _, text = resume_equal(h5, model, molded, windows, folder, keep=("dev_roi.",))
                scratch = re.search(r"\[params\] loaded \d+, from-scratch (\d+)", text)
                require(scratch and int(scratch.group(1)) > 0,
                        "the keras file should leave the Dev from scratch")
                ran.append("h5")
            else:
                log("VISUALIZE h5py is missing: the .h5 start was not run (it raises ImportError)")
            if present["matplotlib"]:
                data = synthetic.generate(num_images=2)
                ecfg = build_config("meta_105_quick_1", "inference", opts=list(FLAGSHIP_OVERRIDES))
                ecfg.DATASET.NUM_CLASSES = data.num_classes
                ecfg.TEST.SAVE_IM = True
                ecfg.MISC.RESULT_FOLDER = os.path.join(folder, "save_im")
                ecfg.MISC.LOG_FILE = os.path.join(ecfg.MISC.RESULT_FOLDER, "log.txt")
                small = seeded_model(build_model, ecfg, seed=0)
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(io.StringIO()):     # COCOeval's tables
                    workflow.test_model(small, ecfg, data, COCO(dataset=data.coco_dataset()))
                pngs = sorted(os.listdir(os.path.join(ecfg.MISC.RESULT_FOLDER, "images")))
                log(f"VISUALIZE TEST.SAVE_IM on 2 images: {pngs} in {time.perf_counter() - t0:.2f} s")
                require(pngs == [f"det_{i['id']}.png" for i in data.image_info],
                        f"TEST.SAVE_IM wrote {pngs}")
                del small
                ran.append("TEST.SAVE_IM")
            else:
                log("VISUALIZE matplotlib is missing: TEST.SAVE_IM was not run (it raises "
                    "ImportError)")
            log(f"VISUALIZE ran: {', '.join(ran)}")

            # t-SNE over the dumped features of the 8 images
            feats = dumped["features"][valid]
            tsne_embed(feats[:64], n_iter=2)                        # warm-up
            t0 = time.perf_counter()
            joint_affinities(feats, 30.0)
            host_ms = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            emb = tsne_embed(feats)
            total_ms = (time.perf_counter() - t0) * 1e3
            require(emb.shape == (len(feats), 2) and np.isfinite(emb).all(), "t-SNE output")
            log(f"VISUALIZE tsne_embed of {len(feats)} rows x 1024 (150 iterations, perplexity "
                f"30): {total_ms:.1f} ms, of which the host affinities {host_ms:.1f} ms")
        finally:
            os.chdir(cwd)
            shutil.rmtree(folder, ignore_errors=True)

    phase("visualize_pretrained_path", visualize_pretrained_path)

    def timed_epoch(loader):
        """One epoch of ``loader``: (its batches, ms to the first batch, ms
        in all; host clock, the consumer doing nothing)."""
        loader.set_epoch(1)
        t0 = time.perf_counter()
        out, first = [], None
        for batch in loader:
            out.append(batch)
            first = first or (time.perf_counter() - t0) * 1e3
        return out, first, (time.perf_counter() - t0) * 1e3

    def coco_disk_path():
        """ROADMAP A10's reader, loader workers and phase timer at flagship
        width: the synthetic set written to disk in the COCO layout by the
        port's writer (8 1024² images, minival and a train split of the same
        images); the in-process ``Loader`` and the thread and process
        loaders' batches bit-equal; ``python -m ... main --phase train
        --data_root`` in bfloat16, one 'all' stage of 2 steps at batch 4 on
        two process workers under ``CTRL.PROFILE_ANALYSIS``, started from a
        ``.pth`` of the tempered seeded model and counted from 0 (per step K1
        2, K4 3, K3 2, K2 at least 1); its losses finite, its ``[profile]``
        fetch and step totals logged; ``--phase inference --data_root`` from
        its checkpoint over the 8 minival images (K1 1 and K2 at least 2 per
        batch of 8, detections, 12 finite stats); then the loaders' ms per
        1024² batch of 4 over a 16-image set: in process, and 2 workers of
        each mode."""
        import contextlib
        import glob
        import io
        import shutil
        import tempfile

        import numpy as np
        from feature_intertwiner_tpu_torch import main as port_main
        from feature_intertwiner_tpu_torch.data import synthetic
        from feature_intertwiner_tpu_torch.data.coco_dataset import get_data
        from feature_intertwiner_tpu_torch.data.loader import Loader, PrefetchLoader

        folder = tempfile.mkdtemp(prefix="chip_smoke_coco_", dir=os.path.join(ROOT, "build"))
        cwd = os.getcwd()
        try:
            def write(name, n, seed):
                """A COCO root: minival, and a train split of the same images."""
                root = os.path.join(folder, name)
                ann = synthetic.write_coco(root, num_images=n, seed=seed,
                                           size=TRAIN_DATA["size"],
                                           max_instances=TRAIN_DATA["max_instances"])
                shutil.copytree(os.path.join(root, "val2014"), os.path.join(root, "train2014"))
                shutil.copy(ann, os.path.join(root, "annotations", "instances_train2014.json"))
                return root

            t0 = time.perf_counter()
            root = write("coco", 8, TRAIN_DATA["seed"])
            log(f"COCO wrote 8 1024² images with their COCO annotations in "
                f"{time.perf_counter() - t0:.2f} s")
            flag = list(FLAGSHIP_OVERRIDES)
            dcfg = build_config("meta_105_quick_1", "train", opts=flag)

            # the loaders on one epoch of the train split: bit-equal batches
            loader, val, _ = get_data(dcfg, data_root=root)
            ds = loader.dataset
            ref, _, _ = timed_epoch(Loader(ds, dcfg.TRAIN.BATCH_SIZE, seed=dcfg.MISC.SEED))
            for mode in ("thread", "process"):
                got, _, _ = timed_epoch(PrefetchLoader(
                    ds, dcfg.TRAIN.BATCH_SIZE, num_workers=2, seed=dcfg.MISC.SEED,
                    worker_mode=mode, stall_timeout=120))
                require(len(got) == len(ref) == 2 and all(
                    g.keys() == r.keys() and all(np.array_equal(g[k], r[k]) for k in g)
                    for g, r in zip(got, ref)), f"the {mode} loader's batches differ from Loader's")
            log(f"COCO loader batches bit-equal to the in-process Loader's over one epoch "
                f"({len(ref)} batches of {dcfg.TRAIN.BATCH_SIZE}): thread x2, process x2; "
                f"{val.num_classes - 1} categories, instances per image "
                f"{[int(n) for r in ref for n in (r['gt_class_ids'] > 0).sum(1)]}")

            # the flagship's tempered seeded model as a reference .pth
            tcfg = build_config("meta_105_quick_1", "train", opts=flag + [
                "DATASET.NUM_CLASSES", str(val.num_classes)])
            model = temper_fpn(seeded_model(build_model, tcfg, seed=0))
            pth = os.path.join(folder, "tempered.pth")
            torch.save({"state_dict": {f"module.{k}": v.cpu()
                                       for k, v in model.state_dict().items()}}, pth)
            del model
            torch.cuda.empty_cache()

            os.chdir(folder)
            base = ["--data_root", root, "--config_name", "coco_disk", *flag]
            cuda_build.launches.clear()
            t0 = time.perf_counter()
            trainer = port_main.main([
                "--phase", "train", *base, "TRAIN.DO_VALIDATION", "False",
                "TRAIN.SCHEDULE", "[0, 0, 1]", "TRAIN.KEEP_CHECKPOINTS", "1",
                "CTRL.SHOW_INTERVAL", "1", "CTRL.PROFILE_ANALYSIS", "True",
                "DATA.LOADER_WORKER_MODE", "process", "DATA.LOADER_WORKER_NUM", "2",
                "MODEL.INIT_FILE_CHOICE", pth])
            train_s = time.perf_counter() - t0
            launches = {k: cuda_build.launches[k] for k in TRAIN_KERNELS}
            steps = trainer.state.step
            train_dir = os.path.join(folder, "results", "coco_disk", "train")
            with open(os.path.join(train_dir, "log.txt")) as f:
                train_log = f.read().splitlines()
            with open(os.path.join(train_dir, "metrics.jsonl")) as f:
                lines = [json.loads(x) for x in f]
            losses = [r for r in lines if "total_loss" in r]
            profile = [x for x in train_log if x.startswith("[profile] ")]
            log(f"COCO --phase train from disk [bfloat16, 'all' stage, process workers x2] in "
                f"{train_s:.2f} s: {steps} steps, launches {json.dumps(launches)}")
            for r in losses:
                log(f"COCO train iter {r['iter']:.0f}: " + " ".join(
                    f"{k.replace('_loss', '')} {r[k]:.4f}" for k in (
                        "total_loss", "rpn_class_loss", "rpn_bbox_loss", "mrcnn_class_loss",
                        "mrcnn_bbox_loss", "mrcnn_mask_loss", "meta_loss")))
            log(f"COCO PROFILE ({smi}): " + "; ".join(profile[-2:]))
            require("initialized from pretrained weights" in "\n".join(train_log),
                    "the run did not start from the .pth")
            require(steps == 2 and step_launches_ok(launches, steps),
                    f"{steps} steps, launches {launches}")
            require(len(losses) == 2 and all(math.isfinite(r[k]) for r in losses for k in r
                                             if k.endswith("_loss")), "non-finite losses")
            require(any(x.startswith("[profile] fetch: ") and " over 2 calls " in x
                        for x in profile)
                    and any(x.startswith("[profile] step: ") and " over 2 calls " in x
                            for x in profile), f"no [profile] totals of 2 steps: {profile}")
            require(os.path.exists(os.path.join(train_dir, "dashboard.html")), "no dashboard")
            del trainer
            torch.cuda.empty_cache()

            cuda_build.launches.clear()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()) as out:
                stats = port_main.main(["--phase", "inference", *base])
            eval_s = time.perf_counter() - t0
            launches = {k: cuda_build.launches[k] for k in ("roi_align_fwd", "nms_alive")}
            cache = glob.glob(os.path.join(folder, "results", "coco_disk", "inference",
                                           "det_result_ep*_n8.json"))
            with open(cache[0]) as f:
                n_det = len(json.load(f))
            log(f"COCO --phase inference from disk [bfloat16] over 8 images in {eval_s:.2f} s: "
                f"launches {json.dumps(launches)}, {n_det} detections, bbox "
                + " ".join(f"{v:.3f}" for v in stats))
            require(len(stats) == 12 and np.isfinite(stats).all() and n_det > 0
                    and out.getvalue().count("Average Precision") == 6,
                    "no detections or not 12 finite stats")
            require(launches["roi_align_fwd"] == 1 and launches["nms_alive"] >= 2,
                    f"inference launches {launches} for one batch of 8")
            os.chdir(cwd)

            # loader time per 1024² batch of 4 over a 16-image set
            lroot = write("coco16", 16, 1)
            lds = get_data(dcfg, data_root=lroot)[0].dataset
            bs = dcfg.TRAIN.BATCH_SIZE
            rows = {"Loader": Loader(lds, bs, seed=dcfg.MISC.SEED)}
            for mode in ("thread", "process"):
                rows[f"{mode} x2"] = PrefetchLoader(lds, bs, num_workers=2, seed=dcfg.MISC.SEED,
                                                    worker_mode=mode, stall_timeout=120)
            ms = {}
            for name, ldr in rows.items():
                batches, first, total = timed_epoch(ldr)
                require(len(batches) == 4, f"{name}: {len(batches)} batches")
                ms[name] = (total / 4, first, (total - first) / 3)
            log(f"LOADER ms per 1024² batch of 4 (16 images, one epoch of 4 batches, host "
                f"clock, {os.cpu_count()} host cores; {smi}): " + "; ".join(
                    f"{k} {v[0]:.1f} (first batch {v[1]:.1f}, then {v[2]:.1f} per batch)"
                    for k, v in ms.items()))
        finally:
            os.chdir(cwd)
            shutil.rmtree(folder, ignore_errors=True)

    phase("coco_disk_path", coco_disk_path)

    def data_parallel_path():
        """The JAX ``shard_map`` step's port over ``torch.distributed``
        (``parallel/data_parallel.py``), at flagship width in bfloat16, 'all'
        stage, 2 steps of a global batch of 4 over the train path's 8
        synthetic 1024² images written as COCO files, from a ``.pth`` of the
        tempered seeded model: (1) ``torchrun --nproc_per_node 1`` of ``main
        --phase train --data_root`` on NCCL, counted from 0 per step (K1 2, K4 3, K3 2, K2 at least 1), its
        weights, BN statistics and buffer bit-equal to the same two steps
        without a group; (2) two gloo ranks sharing the card, 2 images each:
        each rank's launches as in (1), finite losses, both ranks' state
        bit-equal; rank 0's last K3 calls within one bfloat16 rounding of
        their plain version; each rank's step ms, gradient all-reduce ms and
        peak memory; (3) in the same two ranks, the small model's step over
        the ranks on the card against the same on the CPU, to the
        tolerances of 8."""
        import io
        import shutil
        import tempfile

        from feature_intertwiner_tpu_torch import main as port_main
        from feature_intertwiner_tpu_torch.data import synthetic
        from feature_intertwiner_tpu_torch.data.coco_dataset import get_data

        folder = tempfile.mkdtemp(prefix="chip_smoke_dp_", dir=os.path.join(ROOT, "build"))
        cwd = os.getcwd()
        try:
            # the train path's synthetic set (1024², up to 24 instances, so
            # that the steps have positives and a meta loss), as COCO files
            root = os.path.join(folder, "coco")
            synthetic.write_coco(root, num_images=8, seed=TRAIN_DATA["seed"],
                                 size=TRAIN_DATA["size"],
                                 max_instances=TRAIN_DATA["max_instances"])
            flag = list(FLAGSHIP_OVERRIDES) + ["CTRL.QUICK_VERIFY", "True"]
            n_classes = get_data(build_config("meta_105_quick_1", "train", opts=flag),
                                 data_root=root)[1].num_classes
            tcfg = build_config("meta_105_quick_1", "train", opts=flag + [
                "DATASET.NUM_CLASSES", str(n_classes)])
            model = temper_fpn(seeded_model(build_model, tcfg, seed=0))
            pth = os.path.join(folder, "tempered.pth")
            torch.save({"state_dict": {f"module.{k}": v.cpu()
                                       for k, v in model.state_dict().items()}}, pth)
            del model
            torch.cuda.empty_cache()

            def argv(name):
                return ["--phase", "train", "--data_root", root, "--config_name", name, *flag,
                        "TRAIN.DO_VALIDATION", "False", "TRAIN.SCHEDULE", "[0, 0, 1]",
                        "TRAIN.KEEP_CHECKPOINTS", "1", "CTRL.SHOW_INTERVAL", "1",
                        "MODEL.INIT_FILE_CHOICE", pth]

            def ranks(task, n):
                out = os.path.join(folder, task)
                os.makedirs(out)
                t0 = time.perf_counter()
                rc, text = run_group(
                    [sys.executable, "-m", "torch.distributed.run", "--standalone",
                     "--nproc_per_node", str(n), os.path.join(ROOT, "chip_smoke.py"),
                     "--dp-worker", task, out, "--", *argv(f"dp_{task}")],
                    cwd=folder, timeout=420)
                wall = time.perf_counter() - t0
                require(rc == 0, f"torchrun {task} x{n} exited {rc}:\n{text[-6000:]}")
                results = []
                for r in range(n):
                    with open(os.path.join(out, f"rank{r}.json")) as f:
                        results.append(json.load(f))
                return results, wall

            def check_rank(label, res):
                steps = res["steps"]
                for s in steps:
                    require(step_launches_ok(s["launches"], 1),
                            f"{label} rank {res['rank']} step launches {s['launches']}")
                    require(all(math.isfinite(s[k]) for k in s if k.endswith("_loss")),
                            f"{label} rank {res['rank']}: a non-finite loss")
                require(len(steps) == 2 and len(res["reduce_ms"]) == 2,
                        f"{label} rank {res['rank']}: {len(steps)} steps")
                log(f"DP {label} rank {res['rank']}/{res['world']} [{res['backend']}, "
                    f"{res['device']}]: step ms {[round(s['ms'], 2) for s in steps]}, "
                    f"gradient all-reduce ms {[round(m, 2) for m, _ in res['reduce_ms']]} "
                    f"over {res['reduce_ms'][0][1]} float32 gradients, peak "
                    f"{res['peak_gb']:.2f} GiB, launches per step "
                    f"{[s['launches'] for s in steps]}; losses " + "; ".join(
                        " ".join(f"{k.replace('_loss', '')} {s[k]:.4f}" for k in (
                            "total_loss", "meta_loss")) + f" positives {s['positive_rois']:.0f}"
                        for s in steps))

            # (1) one NCCL rank through torchrun, against no group
            (one,), wall = ranks("nccl", 1)
            check_rank("NCCL x1", one)
            require(one["backend"] == "nccl", f"backend {one['backend']}")
            os.chdir(folder)
            cuda_build.launches.clear()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()), \
                    step_records(torch) as (alone_steps, _):
                trainer = port_main.main(argv("dp_nogroup"))
            alone_s = time.perf_counter() - t0
            require(len(alone_steps) == 2, f"{len(alone_steps)} steps without a group")
            os.chdir(cwd)
            st = trainer.state
            alone = state_digest(torch, st.model, st.buffer, st.buffer_cnt)
            log(f"DP torchrun x1 (NCCL) in {wall:.1f} s; the same run without a group in "
                f"process {alone_s:.1f} s; state digests {one['digest'][:12]} / {alone[:12]}")
            require(trainer.state.step == 2, f"{trainer.state.step} steps without a group")
            require(one["digest"] == alone,
                    "the NCCL group of one rank left another state than no group")
            del trainer, st
            torch.cuda.empty_cache()

            # (2) two gloo ranks on the card; (3) the small model over them
            pair, wall = ranks("gloo", 2)
            for res in pair:
                check_rank("gloo x2", res)
            require(pair[0]["digest"] == pair[1]["digest"],
                    "the two gloo ranks hold different states")
            k3 = pair[0]["k3"]
            log(f"DP gloo x2 in {wall:.1f} s, both ranks' states bit-equal "
                f"({pair[0]['digest'][:12]}); rank 0's last K3 calls: {k3}")
            require(k3["calls"] == 2 and k3["dtype"] == "torch.bfloat16" and k3["excess"] <= 0
                    and k3["two_launches_equal"],
                    "K3 on a gloo rank beyond one bfloat16 rounding of its plain version")
            for res in (one, *pair):
                bk = res["bucket"]
                log(f"DP gradient bucket {res['backend']} x{res['world']} rank {res['rank']} "
                    f"({bk['tensors']} tensors, {bk['mb']:.1f} MB; {smi}; host clock, ms to "
                    f"issue / to finish from a synchronised start): " + ", ".join(
                        f"{k} {bk[k][0]:.2f} / {bk[k][1]:.2f}"
                        for k in ("cat", "all_reduce", "div", "copy_back")))
            log(f"DP second step per rank, ms ({smi}; host clock, synchronised): NCCL x1 "
                f"batch 4 {one['steps'][1]['ms']:.2f}, its gradient all-reduce "
                f"{one['reduce_ms'][1][0]:.2f}; the same step without a group "
                f"{alone_steps[1]['ms']:.2f} (steps {[round(s['ms'], 2) for s in alone_steps]})"
                f"; gloo x2 batch 2 each "
                + ", ".join(f"{r['steps'][1]['ms']:.2f}" for r in pair)
                + ", their gradient all-reduce "
                + ", ".join(f"{r['reduce_ms'][1][0]:.2f}" for r in pair))
            for res in pair:
                sm = res["small"]
                log(f"DP small model step over 2 gloo ranks card vs CPU, rank {res['rank']}: "
                    f"losses rel err {sm['loss_rel']:.3g}, parameters rel err "
                    f"{sm['param_rel']:.3g}, buffer err {sm['buf_err']:.3g}, positives "
                    f"{sm['metrics']['positive_rois']:.0f}, meta {sm['metrics']['meta_loss']:.4g}")
                require(sm["loss_rel"] <= 1e-4 and sm["param_rel"] <= 1e-5
                        and sm["buf_err"] <= 1e-4,
                        f"rank {res['rank']}: the small step over ranks differs card vs CPU")
                require(sm["metrics"]["positive_rois"] > 0 and sm["metrics"]["meta_loss"] > 0,
                        "the small step over ranks had no positive RoI or no meta loss")
        finally:
            os.chdir(cwd)
            shutil.rmtree(folder, ignore_errors=True)

    phase("data_parallel_path", data_parallel_path)

    if failures:
        log("FAILED phases: " + ", ".join(failures))
        return 1
    log(json.dumps({"kernels": kernels}))
    log(f"nvidia-smi: {smi}")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-worker"]:
        # one rank of data_parallel_path: --dp-worker TASK OUT_DIR -- MAIN ARGS
        sys.exit(dp_worker(sys.argv[2], sys.argv[3], sys.argv[5:]))
    sys.exit(main())
