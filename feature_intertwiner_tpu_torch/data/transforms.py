"""Host-side image and mask preprocessing for fixed-shape batches.

Port of ``feature_intertwiner_tpu/data/transforms.py`` without OpenCV: the
JAX package resizes with ``cv2.resize(INTER_LINEAR)``; the port with
``torch.nn.functional.interpolate(mode="bilinear", align_corners=False)``,
the same half-pixel bilinear rule. A uint8 image differs by at most one grey
level (OpenCV's fixed-point arithmetic), a thresholded mask at a few border
pixels.

- :func:`resize_image`: aspect kept (smallest side at least ``min_dim``,
  longest at most ``max_dim``, never below scale 1), centre zero-pad to
  ``max_dim``²;
- :func:`resize_mask`, :func:`minimize_mask`: instance masks resized,
  mini-masks of each instance's box, thresholded at 0.5;
- :func:`extract_bboxes`: tight boxes of the masks;
- :func:`load_image_and_gt`: the per-image training pipeline (resize, pad,
  random horizontal flip, boxes from masks, mini-masks).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def compose_image_meta(image_id, image_shape, window, active_class_ids,
                       coco_image_id) -> np.ndarray:
    return np.array([image_id] + list(image_shape) + list(window)
                    + list(active_class_ids) + [coco_image_id], dtype=np.float32)


def resize_scale(h: int, w: int, min_dim, max_dim) -> float:
    """The scale :func:`resize_image` applies to an ``h`` x ``w`` image."""
    scale = 1.0
    if min_dim:
        scale = max(1.0, min_dim / min(h, w))
    if max_dim and round(max(h, w) * scale) > max_dim:
        scale = max_dim / max(h, w)
    return scale


def bilinear(image: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """[H, W] or [H, W, C] -> resized to ``size`` (h, w), half-pixel
    bilinear, float32."""
    x = image.float()
    x = x[None, None] if x.dim() == 2 else x.permute(2, 0, 1)[None]
    x = F.interpolate(x, size=size, mode="bilinear", align_corners=False)[0]
    return x[0] if image.dim() == 2 else x.permute(1, 2, 0)


def resize_image(image: np.ndarray, min_dim: Optional[int] = None,
                 max_dim: Optional[int] = None, padding: bool = True):
    """Returns (image, window (y1, x1, y2, x2), scale, padding spec); a
    uint8 image stays uint8 (rounded, as OpenCV returns the input's type)."""
    h, w = image.shape[:2]
    window = (0, 0, h, w)
    scale = resize_scale(h, w, min_dim, max_dim)
    if scale != 1.0:
        r = bilinear(torch.from_numpy(np.ascontiguousarray(image)),
                     (round(h * scale), round(w * scale)))
        if image.dtype == np.uint8:
            r = r.round().clamp(0, 255).to(torch.uint8)
        image = r.numpy()
    pad_spec = [(0, 0), (0, 0), (0, 0)]
    if padding:
        h2, w2 = image.shape[:2]
        top = (max_dim - h2) // 2
        left = (max_dim - w2) // 2
        pad_spec = [(top, max_dim - h2 - top), (left, max_dim - w2 - left), (0, 0)]
        image = np.pad(image, pad_spec[:image.ndim], mode="constant")
        window = (top, left, h2 + top, w2 + left)
    return image, window, scale, pad_spec


def resize_mask(mask: np.ndarray, scale: float, pad_spec) -> np.ndarray:
    """mask [H, W, N] -> resized and padded, bool."""
    if scale != 1.0:
        h, w = mask.shape[:2]
        size = (round(h * scale), round(w * scale))
        if mask.size:
            mask = bilinear(torch.from_numpy(mask.astype(np.float32)), size).numpy() >= 0.5
        else:
            mask = np.zeros(size + (mask.shape[-1],), bool)
    mask = np.pad(mask, pad_spec[:mask.ndim], mode="constant")
    return mask.astype(bool)


def extract_bboxes(mask: np.ndarray) -> np.ndarray:
    """[H, W, N] -> [N, (y1, x1, y2, x2)] tight int32 boxes (exclusive
    end); an empty mask gives a zero box."""
    boxes = np.zeros((mask.shape[-1], 4), np.int32)
    for i in range(mask.shape[-1]):
        xs = np.where(mask[:, :, i].any(axis=0))[0]
        ys = np.where(mask[:, :, i].any(axis=1))[0]
        if len(xs):
            boxes[i] = [ys[0], xs[0], ys[-1] + 1, xs[-1] + 1]
    return boxes


def minimize_mask(bbox: np.ndarray, mask: np.ndarray,
                  mini_shape: Tuple[int, int]) -> np.ndarray:
    """Each instance cropped to its box and resized to ``mini_shape``,
    thresholded at 0.5: [mh, mw, N] bool."""
    n = mask.shape[-1]
    mini = np.zeros(tuple(mini_shape) + (n,), bool)
    for i in range(n):
        y1, x1, y2, x2 = bbox[i][:4]
        m = mask[y1:y2, x1:x2, i]
        if m.size == 0:
            continue
        r = bilinear(torch.from_numpy(m.astype(np.float32)), tuple(mini_shape))
        mini[:, :, i] = r.numpy() >= 0.5
    return mini


def load_image_and_gt(dataset, config, image_id: int, augment: bool = False,
                      use_mini_mask: bool = False,
                      rng: Optional[np.random.RandomState] = None):
    """The per-image training pipeline. ``dataset`` has ``load_image``,
    ``load_mask``, ``num_classes``, ``image_info`` and
    ``source_class_ids``. Returns (image, meta, class_ids, bbox, mask)."""
    rng = rng or np.random
    image = dataset.load_image(image_id)
    mask, class_ids = dataset.load_mask(image_id)
    min_dim = config.DATA.IMAGE_MIN_DIM
    scales = list(config.DATA.get("MULTISCALE_MIN_DIMS", []) or [])
    if augment and scales:
        min_dim = int(scales[rng.randint(0, len(scales))])
    image, window, scale, pad_spec = resize_image(
        image, min_dim=min_dim, max_dim=config.DATA.IMAGE_MAX_DIM,
        padding=config.DATA.IMAGE_PADDING)
    mask = resize_mask(mask, scale, pad_spec)
    if augment and rng.randint(0, 2):
        image = np.fliplr(image)
        mask = np.fliplr(mask)
    bbox = extract_bboxes(mask)
    active_class_ids = np.zeros([dataset.num_classes], np.int32)
    active_class_ids[dataset.source_class_ids[dataset.image_info[image_id]["source"]]] = 1
    if use_mini_mask:
        mask = minimize_mask(bbox, mask, tuple(config.MRCNN.MINI_MASK_SHAPE))
    meta = compose_image_meta(image_id, image.shape, window, active_class_ids,
                              dataset.image_info[image_id]["id"])
    return image, meta, class_ids, bbox, mask
