"""Entry points: build the model, and detect objects in images.

``build_model(cfg)`` and ``detect(model, images, cfg)`` are what a user
calls. They run on the card (``"cuda"``) unless the caller asks for
``device="cpu"``, and raise when no card is present.

The host steps around the model are ports of the JAX package's
``train/workflow.py::mold_inputs``/``unmold_detections`` and
``data/transforms.py::resize_image``/``unmold_mask``, resizing as the
port's ``data/transforms.py`` does (torch's half-pixel bilinear in place of
OpenCV's).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .data.transforms import bilinear, resize_scale
from .models.common import init_weights
from .models.detector import InterNet


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else
    ``"cuda"``. Raises when that is a CUDA device and none is present; the
    port never moves to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the GPU by "
            "default. Pass device='cpu' to run on the CPU.")
    return dev


COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build_model(cfg, device=None, seed: Optional[int] = None,
                dtype: torch.dtype = torch.float32) -> InterNet:
    """InterNet in eval mode on ``device`` (default ``"cuda"``),
    channels-last, computing in ``dtype`` with float32 parameters (the
    default float32, as JAX ``InterNet.from_config``; the command line
    passes ``TPU.COMPUTE_DTYPE``). ``seed`` draws random weights from a CPU
    generator (the JAX package's initialisers); without it the weights are
    torch's defaults, to be replaced by ``load_state_dict``."""
    dev = resolve_device(device)
    model = InterNet.from_config(cfg, dtype=dtype)
    if seed is not None:
        init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(device=dev, memory_format=torch.channels_last).eval()


def mold_inputs(images: Sequence[np.ndarray], cfg, device=None, min_dim: Optional[int] = None,
                max_dim: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Resize (aspect kept), centre-pad to IMAGE_MAX_DIM², subtract the mean
    pixel, on ``device`` (default ``"cuda"``). ``min_dim``/``max_dim``
    replace the config's sizes (multi-scale testing). Returns (molded
    [B, S, S, 3] float32, windows [B, 4] float32: each image's un-padded
    region as pixel (y1, x1, y2, x2))."""
    device = resolve_device(device)
    s = int(max_dim or cfg.DATA.IMAGE_MAX_DIM)
    mean = torch.as_tensor(np.asarray(cfg.DATA.MEAN_PIXEL, np.float32), device=device)
    molded, windows = [], []
    for img in images:
        h, w = img.shape[:2]
        t = torch.from_numpy(np.ascontiguousarray(img)).to(device)
        scale = resize_scale(h, w, min_dim or cfg.DATA.IMAGE_MIN_DIM, s)
        if scale != 1.0:
            r = bilinear(t, (round(h * scale), round(w * scale)))
            # OpenCV returns the input's type: round back to uint8 pixels
            t = r.round().clamp(0, 255).to(t.dtype) if img.dtype == np.uint8 else r
        h2, w2 = t.shape[:2]
        window = (0, 0, h2, w2)
        if cfg.DATA.IMAGE_PADDING:
            top, left = (s - h2) // 2, (s - w2) // 2
            t = F.pad(t.permute(2, 0, 1), (left, s - w2 - left, top, s - h2 - top))
            t = t.permute(1, 2, 0)
            window = (top, left, h2 + top, w2 + left)
        molded.append(t.float() - mean)
        windows.append(window)
    return (torch.stack(molded),
            torch.tensor(windows, dtype=torch.float32, device=device))


def unmold_mask(mask: np.ndarray, bbox, image_shape) -> np.ndarray:
    """A 28² float mask and its pixel box -> full-size binary uint8 mask."""
    y1, x1, y2, x2 = [int(v) for v in bbox]
    h, w = max(y2 - y1, 1), max(x2 - x1, 1)
    m = bilinear(torch.from_numpy(np.ascontiguousarray(mask, np.float32)), (h, w))
    m = (m >= 0.5).to(torch.uint8).numpy()
    full = np.zeros(image_shape[:2], np.uint8)
    y2c, x2c = min(y1 + h, image_shape[0]), min(x1 + w, image_shape[1])
    if y1 < y2c and x1 < x2c:
        full[y1:y2c, x1:x2c] = m[: y2c - y1, : x2c - x1]
    return full


def unmold_detections(detections: np.ndarray, masks: Optional[np.ndarray],
                      original_shape, window):
    """One image's detections [M, 6] and own-class masks [M, mh, mw] ->
    (boxes [n, 4] int32 in original pixels, class_ids, scores, full-size
    masks), dropping the zero-score padding."""
    valid = detections[:, 5] > 0
    det = detections[valid]
    boxes = det[:, :4].copy()
    class_ids = det[:, 4].astype(np.int32)
    scores = det[:, 5]

    wy1, wx1, wy2, wx2 = window
    shift = np.array([wy1, wx1, wy1, wx1])
    hs = original_shape[0] / max(wy2 - wy1, 1)
    ws = original_shape[1] / max(wx2 - wx1, 1)
    boxes = (boxes - shift) * np.array([hs, ws, hs, ws])
    boxes = np.round(boxes).astype(np.int32)
    boxes[:, 0::2] = np.clip(boxes[:, 0::2], 0, original_shape[0])
    boxes[:, 1::2] = np.clip(boxes[:, 1::2], 0, original_shape[1])

    if masks is None:
        full_masks = [None] * len(det)
    else:
        own = masks[valid]
        full_masks = [unmold_mask(own[i], boxes[i], original_shape)
                      for i in range(len(det))]
    return boxes, class_ids, scores, full_masks


def detect(model: InterNet, images: Sequence[np.ndarray], cfg,
           with_masks: bool = True, min_dim: Optional[int] = None,
           max_dim: Optional[int] = None) -> List[Dict[str, object]]:
    """Images (H×W×3 arrays) in, per-image detections out: ``rois``
    [n, 4] int32 pixel boxes, ``class_ids``, ``scores`` and ``masks`` (a
    full-size binary mask per detection, or None). ``min_dim``/``max_dim``
    mold at another scale than the config's; the model then runs at
    ``max_dim``² (``InterNet.forward_inference``'s ``image_size``)."""
    device = next(model.parameters()).device
    molded, windows = mold_inputs(images, cfg, device, min_dim, max_dim)
    with torch.inference_mode():
        out = model.forward_inference(molded, windows, with_masks=with_masks, image_size=max_dim)
        dets = out["detections"].cpu().numpy()
        masks = out["masks"].cpu().numpy() if with_masks else None
    wins = windows.cpu().numpy()
    results = []
    for i, img in enumerate(images):
        boxes, class_ids, scores, full = unmold_detections(
            dets[i], None if masks is None else masks[i], img.shape, wins[i])
        results.append({"rois": boxes, "class_ids": class_ids,
                        "scores": scores, "masks": full})
    return results
