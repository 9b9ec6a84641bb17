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
   tensors: RoIAlign within 1e-5, NMS bit for bit (plus tie-heavy and
   padded NMS cases); each is timed beside its plain version, its bound and
   a PyTorch yardstick;
5. breakdown: the forward's device time by kernel family (torch.profiler)
   and the device's busy share, reported and not checked;
6. reference: a small model runs on the card and on the CPU (plain
   versions) from the same weights and inputs; the pyramid, and the
   detections of the second stage fed the same proposals, must agree.

Float32 throughout: TF32 is switched off for cuDNN convolutions and for
matmuls. The last three lines are a JSON object with one entry per kernel,
the card's name and power limit from ``nvidia-smi``, and
``{"ok": true, "device": {...}}``. Any failed phase exits non-zero without
them.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))

H100_BYTES_PER_S = 3.35e12      # HBM3, SXM data sheet
H100_FP32_OPS_PER_S = 67e12     # fp32 outside the tensor cores
# fp32 operations of greedy NMS, counted on ops/nms.py::_pairwise_iou with
# each box's area computed once: per pair 4 max/min, 4 sub/add (the two
# extents), 2 clamps, 1 mul (intersection), 2 add/sub (union), 1 div and the
# threshold compare; per box 2 sub, 2 add and 1 mul (its area)
IOU_OPS_PER_PAIR = 4 + 4 + 2 + 1 + 2 + 1 + 1
AREA_OPS_PER_BOX = 2 + 2 + 1
ROI_OPS_PER_VALUE = 6           # three lerps of one pooled value


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


def seeded_model(build_model, cfg, seed, device=None):
    """The port's seeded random weights (Xavier-uniform convs, N(0, 0.01)
    dense, BN at identity), tempered so that the proposals fall on the
    images as a trained model's do: the last BN scale of every bottleneck is
    0.1 (with BN at identity nothing normalises the residual stack), and the
    RPN's class and box convs are scaled by 0.1. Untempered, the saturated
    random objectness ranks the constant padding band of the molded 1024²
    canvas first, every proposal lies there, every detection is clipped to
    zero area by the image window, and the mask pass pools nothing."""
    import torch
    from feature_intertwiner_tpu_torch.models.resnet import Bottleneck

    model = build_model(cfg, device=device, seed=seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, Bottleneck):
                m.bn3.weight.fill_(0.1)
        model.rpn.conv_class.weight.mul_(0.1)
        model.rpn.conv_bbox.weight.mul_(0.1)
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


class Recorder:
    """Wrap a module-level kernel wrapper so the main path's calls are kept
    (their arguments), while the original wrapper still launches and counts."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.original = getattr(module, name)
        self.calls = []

    def __enter__(self):
        def recording(*args, **kwargs):
            self.calls.append((args, kwargs))
            return self.original(*args, **kwargs)
        setattr(self.module, self.name, recording)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.original)
        return False


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

    def roi_kernel():
        calls = state["roi_calls"]
        err, ms, plain_ms, lib_ms, bound_bytes, ops = 0.0, 0.0, 0.0, 0.0, 0, 0
        for args, kwargs in calls:
            feats, boxes, bidx, lidx, crop = args[:5]
            extrap = args[5] if len(args) > 5 else kwargs.get("extrapolation_value", 0.0)
            got = roi_ops.roi_align_fwd(feats, boxes, bidx, lidx, crop, extrap)
            want = roi_ops.multilevel_gather_plain(feats, boxes, bidx, lidx, crop, extrap)
            torch.cuda.synchronize()
            e = float((got - want).abs().max())
            err = max(err, e)
            k_ms = cuda_ms(torch, lambda: roi_ops.roi_align_fwd(feats, boxes, bidx, lidx, crop, extrap), 20)
            p_ms = cuda_ms(torch, lambda: roi_ops.multilevel_gather_plain(feats, boxes, bidx, lidx, crop, extrap), 5)
            # yardstick: one grid_sample over P2 for every box of the call
            p2 = feats[0].permute(0, 3, 1, 2)
            b = p2.shape[0]
            n, (ch, cw) = boxes.shape[0], crop
            ys = torch.linspace(0, 1, ch, device=boxes.device)
            xs = torch.linspace(0, 1, cw, device=boxes.device)
            by = boxes[:, 0:1] + (boxes[:, 2:3] - boxes[:, 0:1]) * ys
            bx = boxes[:, 1:2] + (boxes[:, 3:4] - boxes[:, 1:2]) * xs
            grid = torch.stack([bx[:, None, :].expand(n, ch, cw),
                                by[:, :, None].expand(n, ch, cw)], dim=-1) * 2 - 1
            grid = grid.reshape(b, n // b * ch, cw, 2)
            l_ms = cuda_ms(torch, lambda: torch.nn.functional.grid_sample(
                p2, grid, mode="bilinear", padding_mode="zeros", align_corners=True), 20)
            # least bytes: the distinct tap rows that valid samples read,
            # the boxes and indices, and the crops written once
            taps, _, _, valid = roi_ops.tap_rows(feats, boxes, bidx, lidx, crop)
            rows = torch.cat([t[valid] for t in taps]).unique().numel()
            c = feats[0].shape[3]
            nbytes = rows * c * 4 + n * 24 + n * ch * cw * c * 4
            bound_bytes += nbytes
            ops += n * ch * cw * c * ROI_OPS_PER_VALUE
            ms, plain_ms, lib_ms = ms + k_ms, plain_ms + p_ms, lib_ms + l_ms
            log(f"  roi_align_fwd n={n} crop={crop}: err {e:.3g}, {k_ms:.4f} ms, "
                f"plain {p_ms:.4f} ms, grid_sample {l_ms:.4f} ms, {rows} tap rows, "
                f"{nbytes} bytes")
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
        mism, ms, plain_ms, pairs, n_valid, nbytes = 0, 0.0, 0.0, 0, 0, 0
        for args, kwargs, label in cases:
            boxes, valid = args[0], args[1]
            thr = args[2]
            opts = dict(zip(("plus_one", "strict"), args[3:]))
            opts.update(kwargs)
            got = nms_ops.nms_alive(boxes, valid, thr, **opts)
            want = nms_ops.greedy_alive_sorted_plain(boxes, valid, thr, **opts)
            bad = int((got != want).sum())
            mism += bad
            line = f"  nms_alive {label} {tuple(boxes.shape)}: {bad} mismatches, kept {int(got.sum())}"
            if label == "main path":
                k_ms = cuda_ms(torch, lambda: nms_ops.nms_alive(boxes, valid, thr, **opts), 20)
                p_ms = cuda_ms(torch, lambda: nms_ops.greedy_alive_sorted_plain(boxes, valid, thr, **opts), 2)
                p = greedy_pairs(nms_ops, boxes, valid, got, thr, **opts)
                pairs += p
                n_valid += int(valid.sum())
                nbytes += boxes.numel() * 4 + valid.numel() * 2
                ms, plain_ms = ms + k_ms, plain_ms + p_ms
                line += f", {k_ms:.4f} ms, plain {p_ms:.2f} ms, {p} IoU pairs needed"
            log(line)
        if mism:
            raise AssertionError(f"NMS kernel differs from its plain version in {mism} rows")
        n_ops = pairs * IOU_OPS_PER_PAIR + n_valid * AREA_OPS_PER_BOX
        t_ops = n_ops / H100_FP32_OPS_PER_S * 1e3
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        log(f"  nms_alive bound: {pairs} IoU pairs x {IOU_OPS_PER_PAIR} ops + {n_valid} valid "
            f"boxes x {AREA_OPS_PER_BOX} ops = {n_ops} fp32 ops -> {t_ops:.6f} ms at "
            f"{H100_FP32_OPS_PER_S:.3g}/s; {nbytes} bytes -> {t_bytes:.6f} ms at "
            f"{H100_BYTES_PER_S:.3g} B/s")
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
    def breakdown():
        """Device time of three forwards by kernel family (torch.profiler),
        and the device's busy share of their wall time. Informational: a
        profiler that sees no device time is reported, not failed."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        model, molded, windows = state["model"], state["molded"], state["windows"]
        reps = 3
        with torch.inference_mode():
            model.forward_inference(molded, windows)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(reps):
                    model.forward_inference(molded, windows)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3 / reps
        kernels_us = {}
        for e in prof.key_averages():
            # device kernels only: the aten ops above them, and their ranges
            # on the device's timeline, carry the same time again
            if (e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False)
                    or e.key.startswith("aten::")):
                continue
            us = e.self_device_time_total
            if us > 0:
                kernels_us[e.key] = kernels_us.get(e.key, 0) + us
        total_ms = sum(kernels_us.values()) / 1e3 / reps
        families = {"convolution": ("conv", "gemm", "xmma", "cudnn", "sm90_", "sm80_", "winograd"),
                    "roi_align_fwd (K1)": ("roi_align_fwd",), "nms (K2)": ("nms_mask", "nms_sweep"),
                    "sort": ("sort", "radix"), "batch norm / elementwise": (
                        "batch_norm", "elementwise", "vectorized", "bn_", "relu")}
        by_family = {}
        for name, us in kernels_us.items():
            low = name.lower()
            fam = next((f for f, keys in families.items() if any(k in low for k in keys)), "other")
            by_family[fam] = by_family.get(fam, 0) + us / 1e3 / reps
        top = sorted(kernels_us.items(), key=lambda kv: -kv[1])[:12]
        if total_ms == 0:
            log("BREAKDOWN not measured: the profiler saw no device time")
        else:
            log(f"BREAKDOWN forward wall {wall_ms:.2f} ms under the profiler, device busy "
                f"{total_ms:.2f} ms ({100 * total_ms / wall_ms:.1f}%)")
            for fam, ms in sorted(by_family.items(), key=lambda kv: -kv[1]):
                log(f"  {fam:26s} {ms:8.3f} ms  {100 * ms / total_ms:5.1f}%")
            for name, us in top:
                log(f"    {us / 1e3 / reps:8.3f} ms  {name[:90]}")

    if "main_path" not in failures:
        phase("breakdown", breakdown)

    # 6. card against CPU on a small model ------------------------------------
    def reference():
        small = build_config("smoke_small", "inference", opts=list(FLAGSHIP_OVERRIDES) + [
            "MODEL.BACKBONE", "resnet50", "DATASET.NUM_CLASSES", "8",
            "DATA.IMAGE_MIN_DIM", "96", "DATA.IMAGE_MAX_DIM", "128",
            "RPN.ANCHOR_SCALES", "(8, 16, 32, 64, 128)", "RPN.PRE_NMS_LIMIT", "200",
            "RPN.POST_NMS_ROIS_INFERENCE", "48", "TEST.DET_MAX_INSTANCES", "8"])
        gpu = seeded_model(build_model, small, seed=3)
        cpu = seeded_model(build_model, small, seed=3, device="cpu")
        imgs = [im[::4, ::4].copy() for im in images]
        m_gpu, w_gpu = mold_inputs(imgs, small, "cuda")
        m_cpu, w_cpu = m_gpu.cpu(), w_gpu.cpu()
        with torch.inference_mode():
            pyr_g, _, _, props = gpu.first_stage(m_gpu)
            pyr_c, _, _, _ = cpu.first_stage(m_cpu)
            rel = max(float((a.cpu() - b).abs().max() / b.abs().max())
                      for a, b in zip(pyr_g, pyr_c))
            out_g = gpu.second_stage(pyr_g[:4], props, w_gpu)
            out_c = cpu.second_stage([p.cpu() for p in pyr_g[:4]], props.cpu(), w_cpu)
        dg, dc = out_g["detections"].cpu(), out_c["detections"]
        same_count = bool(((dg[..., 5] > 0).sum(1) == (dc[..., 5] > 0).sum(1)).all())
        box_err = float((dg[..., :4] - dc[..., :4]).abs().max())
        score_err = float((dg[..., 5] - dc[..., 5]).abs().max())
        cls_same = bool((dg[..., 4] == dc[..., 4]).all())
        # masks pool at the detection boxes: compared where the boxes agree
        same_box = (dg[..., :4] == dc[..., :4]).all(-1)
        mask_err = float((out_g["masks"].cpu() - out_c["masks"]).abs()[same_box].max())
        log(f"REFERENCE small model card vs CPU: pyramid rel err {rel:.3g}, detections "
            f"count equal {same_count}, classes equal {cls_same}, box err {box_err} px, "
            f"score err {score_err:.3g}, mask err {mask_err:.3g}")
        require(rel <= 1e-4 and same_count and cls_same,
                "the card's pyramid or detections differ from the CPU's")
        require(box_err <= 1.0 and score_err <= 1e-4 and mask_err <= 1e-4,
                "the card's boxes, scores or masks differ from the CPU's")

    phase("reference", reference)

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
    sys.exit(main())
