"""Synthetic detection datasets: built in memory, or written to disk in the
COCO layout.

Port of ``feature_intertwiner_tpu/data/synthetic.py``. One random stream
(:func:`_draw`) draws the canvases and instances (filled rectangles,
ellipses, thin stripes in three classes) that the JAX ``generate`` draws
with the same arguments; two consumers take them:

- :func:`generate` keeps each image and each instance's mask as arrays
  (:class:`InMemoryDataset`). A mask is the painted region itself; the JAX
  package rasterises a polygon (a 24-gon for an ellipse), so the two masks
  differ at a few border pixels. :meth:`InMemoryDataset.coco_dataset` gives
  the ground truth in COCO format for the evaluation: the images,
  categories, boxes and areas of the JAX set (the drawn box of each
  instance, its area ``w h``), with each mask as an RLE;
- :func:`write_coco` writes what the JAX ``generate(root)`` writes:
  ``<root>/annotations/instances_<split><year>.json`` with polygon
  segmentations, and ``<root>/val<year>/*.png``.

:func:`generate_rich` writes the JAX package's 8-class held-out set (shapes
with class-correlated colours, a skewed small-object mix, exact RLE
segmentations). PIL is imported only by the two writers.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterator, List, Tuple

import numpy as np

CATEGORIES = [
    {"id": 1, "name": "box", "supercategory": "shape"},
    {"id": 2, "name": "disk", "supercategory": "shape"},
    {"id": 3, "name": "stripe", "supercategory": "shape"},
]

# The 8-class shape set of the held-out benchmark: each class occurs at
# large and small scales, with a base colour per class jittered per
# instance (identity cued by shape and appearance).
RICH_NAMES = ["box", "disk", "stripe", "triangle", "ring", "cross", "diamond", "checker"]
RICH_CATEGORIES = [{"id": i + 1, "name": n, "supercategory": "shape"}
                   for i, n in enumerate(RICH_NAMES)]
RICH_COLORS = np.array([
    [205, 45, 45],    # box: red
    [45, 185, 65],    # disk: green
    [225, 205, 45],   # stripe: yellow
    [55, 85, 225],    # triangle: blue
    [205, 65, 205],   # ring: magenta
    [45, 205, 205],   # cross: cyan
    [235, 140, 35],   # diamond: orange
    [135, 65, 225],   # checker: purple
], np.int32)


def require_pil(what: str):
    """``PIL.Image``, or ``ImportError`` naming PIL and ``what`` needs it."""
    try:
        from PIL import Image
    except ImportError as exc:
        raise ImportError(f"{what} needs PIL (Pillow), which is not installed") from exc
    return Image


class InMemoryDataset:
    """Images and instance masks held in memory, with the registry the
    training pipeline reads (``data/transforms.py::load_image_and_gt``):
    ``num_classes`` (background included), ``class_names``, ``image_info``
    and ``source_class_ids``; and what the evaluation reads:
    ``image_ids``, each ``image_info[i]["id"]`` (the COCO image id),
    :meth:`get_source_class_id` and :meth:`coco_dataset`. Its classes are
    COCO categories, as the JAX package loads its synthetic set through
    ``load_coco``: internal class ``k`` is category ``k``."""

    source = "coco"

    def __init__(self, images: List[np.ndarray], masks: List[np.ndarray],
                 class_ids: List[np.ndarray], boxes: List[List[List[float]]]):
        self.images, self.masks, self.class_ids, self.boxes = images, masks, class_ids, boxes
        self.class_names = ["BG"] + [c["name"] for c in CATEGORIES]
        self.num_classes = len(self.class_names)
        self.num_images = len(images)
        self.image_ids = np.arange(self.num_images)
        self.image_info = [{"id": i + 1, "source": self.source} for i in range(self.num_images)]
        self.source_class_ids = {self.source: list(range(self.num_classes))}

    def get_source_class_id(self, class_id: int, source: str) -> int:
        """The category id of internal class ``class_id`` (1 and up)."""
        if source != self.source or not 1 <= class_id < self.num_classes:
            raise ValueError(f"no {source} category for class {class_id}")
        return CATEGORIES[class_id - 1]["id"]

    def coco_dataset(self) -> Dict[str, list]:
        """The ground truth as a COCO-format dict (for ``evaluation.COCO``):
        one image record per image, one annotation per instance with its
        drawn box ``[x, y, w, h]``, area ``w h`` and mask as a compressed RLE."""
        from ..evaluation.rle import RLE

        images, annotations = [], []
        for i, (image, masks, cls, boxes) in enumerate(
                zip(self.images, self.masks, self.class_ids, self.boxes)):
            h, w = image.shape[:2]
            images.append({"id": self.image_info[i]["id"], "height": h, "width": w,
                           "file_name": f"synthetic_{i + 1:06d}.png"})
            for k, box in enumerate(boxes):
                annotations.append({
                    "id": len(annotations) + 1, "image_id": self.image_info[i]["id"],
                    "category_id": self.get_source_class_id(int(cls[k]), self.source),
                    "bbox": [float(v) for v in box], "area": float(box[2] * box[3]),
                    "iscrowd": 0, "segmentation": RLE.encode(masks[..., k]).to_coco()})
        return {"images": images, "annotations": annotations,
                "categories": [dict(c) for c in CATEGORIES]}

    def load_image(self, image_id: int) -> np.ndarray:
        return self.images[image_id]

    def load_mask(self, image_id: int) -> Tuple[np.ndarray, np.ndarray]:
        """(mask [H, W, N] bool, class_ids [N] int32)."""
        return self.masks[image_id], self.class_ids[image_id]


def _draw(num_images: int, size: Tuple[int, int], seed: int, max_instances: int,
          small_frac: float, medium_frac: float) -> Iterator[Tuple[np.ndarray, list]]:
    """The JAX ``generate``'s random stream: per image its painted uint8
    canvas and its instances, each ``(category, x0, y0, w, h, mask)`` with
    the drawn box (a stripe's height already cut to its 12-row floor and the
    canvas) and the painted region."""
    rng = np.random.RandomState(seed)
    h, w = size
    yy, xx = np.mgrid[0:h, 0:w]
    for _ in range(num_images):
        canvas = rng.randint(0, 60, (h, w, 3)).astype(np.uint8)
        instances = []
        for _ in range(rng.randint(1, max_instances + 1)):
            cat = int(rng.randint(1, len(CATEGORIES) + 1))
            # sizes adapt to small canvases: the floor stays under w // 2,
            # so that the position draw below stays valid
            lo_w = max(2, min(30, w // 4, w // 2 - 1))
            lo_h = max(2, min(30, h // 4, h // 2 - 1))
            u = rng.rand()
            if small_frac and u < small_frac:
                bw = int(rng.randint(10, min(32, w // 2)))
                bh = int(rng.randint(10, min(32, h // 2)))
            elif medium_frac and u < small_frac + medium_frac:
                bw = int(rng.randint(34, min(91, w // 2)))
                bh = int(rng.randint(34, min(91, h // 2)))
            else:
                bw = int(rng.randint(lo_w, max(w // 2, lo_w + 1)))
                bh = int(rng.randint(lo_h, max(h // 2, lo_h + 1)))
            x0 = int(rng.randint(0, max(w - bw, 1)))
            y0 = int(rng.randint(0, max(h - bh, 1)))
            color = rng.randint(90, 255, 3)
            if cat == 2:      # ellipse
                cy, cx = y0 + bh / 2, x0 + bw / 2
                m = ((xx - cx) / (bw / 2)) ** 2 + ((yy - cy) / (bh / 2)) ** 2 <= 1
            else:             # filled rectangle, or a thin stripe
                if cat == 3:
                    bh = min(max(12, bh // 3), h - y0)
                m = (xx >= x0) & (xx < x0 + bw) & (yy >= y0) & (yy < y0 + bh)
            canvas[m] = color
            instances.append((cat, x0, y0, bw, bh, m))
        yield canvas, instances


def generate(num_images: int = 8, size: Tuple[int, int] = (240, 320), seed: int = 0,
             max_instances: int = 4, small_frac: float = 0.0,
             medium_frac: float = 0.0) -> InMemoryDataset:
    """The dataset the JAX ``generate`` writes with the same arguments, in
    memory.

    ``small_frac`` / ``medium_frac``: fractions of instances drawn inside the
    COCO 'small' (sides 10-31 px) and 'medium' (sides 34-90 px) area
    buckets; the rest are 30 px to half the canvas."""
    images, masks, class_ids, boxes = [], [], [], []
    for canvas, instances in _draw(num_images, size, seed, max_instances, small_frac,
                                   medium_frac):
        images.append(canvas)
        masks.append(np.stack([m for *_, m in instances], -1))
        class_ids.append(np.asarray([inst[0] for inst in instances], np.int32))
        boxes.append([[float(v) for v in inst[1:5]] for inst in instances])
    return InMemoryDataset(images, masks, class_ids, boxes)


def _polygon(cat: int, x0: int, y0: int, bw: int, bh: int) -> List[float]:
    """The JAX writer's polygon of an instance: a rectangle's four corners
    (pixel centres), or an ellipse's 24-gon half a pixel inside its box."""
    if cat == 2:
        cy, cx = y0 + bh / 2, x0 + bw / 2
        t = np.linspace(0, 2 * np.pi, 24, endpoint=False)
        return np.stack([cx + (bw / 2 - 0.5) * np.cos(t),
                         cy + (bh / 2 - 0.5) * np.sin(t)], 1).reshape(-1).tolist()
    return [x0, y0, x0 + bw - 1, y0, x0 + bw - 1, y0 + bh - 1, x0, y0 + bh - 1]


def write_coco(root: str, num_images: int = 8, size: Tuple[int, int] = (240, 320),
               year: str = "2014", split: str = "minival", seed: int = 0,
               max_instances: int = 4, small_frac: float = 0.0,
               medium_frac: float = 0.0) -> str:
    """Write the JAX ``generate(root, ...)``'s dataset with the same
    arguments: the PNGs under ``<root>/val<year>/`` and the annotations,
    polygon segmentations, under ``<root>/annotations/``. Returns the
    annotation json path."""
    Image = require_pil("write_coco")
    img_dir = os.path.join(root, f"val{year}")
    ann_dir = os.path.join(root, "annotations")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(ann_dir, exist_ok=True)
    images, annotations = [], []
    h, w = size
    draws = _draw(num_images, size, seed, max_instances, small_frac, medium_frac)
    for img_id, (canvas, instances) in enumerate(draws, start=1):
        for cat, x0, y0, bw, bh, _ in instances:
            annotations.append({
                "id": len(annotations) + 1, "image_id": img_id, "category_id": cat,
                "bbox": [float(x0), float(y0), float(bw), float(bh)],
                "area": float(bw * bh), "iscrowd": 0,
                "segmentation": [list(map(float, _polygon(cat, x0, y0, bw, bh)))],
            })
        fname = f"synthetic_{img_id:06d}.png"
        Image.fromarray(canvas).save(os.path.join(img_dir, fname))
        images.append({"id": img_id, "file_name": fname, "height": h, "width": w})
    ann_path = os.path.join(ann_dir, f"instances_{split}{year}.json")
    with open(ann_path, "w") as f:
        json.dump({"images": images, "annotations": annotations, "categories": CATEGORIES}, f)
    return ann_path


# --- the held-out 8-class set ------------------------------------------------------------
def _shape_mask(name: str, h: int, w: int, x0: int, y0: int, bw: int, bh: int) -> np.ndarray:
    """Boolean [h, w] mask of one instance of class ``name``."""
    yy, xx = np.mgrid[0:h, 0:w]
    in_box = (xx >= x0) & (xx < x0 + bw) & (yy >= y0) & (yy < y0 + bh)
    cy, cx = y0 + bh / 2.0, x0 + bw / 2.0
    ry, rx = max(bh / 2.0, 1.0), max(bw / 2.0, 1.0)
    ell = ((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2
    if name == "box":
        return in_box
    if name == "disk":
        return ell <= 1.0
    if name == "stripe":
        t = max(2, bh // 4)
        return in_box & (yy >= cy - t / 2.0) & (yy < cy + t / 2.0)
    if name == "triangle":
        return in_box & ((xx - x0) / max(bw, 1) + (yy - y0) / max(bh, 1) <= 1.0)
    if name == "ring":
        inner = ((xx - cx) / (rx * 0.55)) ** 2 + ((yy - cy) / (ry * 0.55)) ** 2
        return (ell <= 1.0) & (inner > 1.0)
    if name == "cross":
        tv, th = max(2, bw // 3), max(2, bh // 3)
        vert = in_box & (xx >= cx - tv / 2.0) & (xx < cx + tv / 2.0)
        horz = in_box & (yy >= cy - th / 2.0) & (yy < cy + th / 2.0)
        return vert | horz
    if name == "diamond":
        return (np.abs(xx - cx) / rx + np.abs(yy - cy) / ry) <= 1.0
    if name == "checker":
        cell_w, cell_h = max(2, bw // 4), max(2, bh // 4)
        par = ((xx - x0) // cell_w + (yy - y0) // cell_h) % 2 == 0
        return in_box & par
    raise ValueError(name)


def _box_iou(a, b) -> float:
    y1, x1 = max(a[0], b[0]), max(a[1], b[1])
    y2, x2 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(y2 - y1, 0) * max(x2 - x1, 0)
    ua = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / max(ua, 1e-9)


def generate_rich(root: str, num_images: int, size: Tuple[int, int] = (320, 320),
                  year: str = "2014", split: str = "minival", seed: int = 0,
                  num_classes: int = 8, small_frac: float = 0.55,
                  min_instances: int = 2, max_instances: int = 6,
                  color_mode: str = "class") -> str:
    """Write a split of the 8-class shape set; returns the annotation path.

    ``small_frac`` of the instances have a COCO-'small' footprint (mask area
    under 32² px), the rest are large. Instances overlap at IoU 0.25 at most.
    ``split='train'`` writes the images under ``train<year>/`` (``get_data``'s
    layout), any other under ``val<year>/``. Segmentations are exact RLEs of
    the drawn masks. ``color_mode`` 'class' gives each class its base colour;
    'paired' gives classes 2k-1 and 2k one colour family, so that only their
    shape tells them apart."""
    from ..evaluation.rle import RLE

    Image = require_pil("generate_rich")
    rng = np.random.RandomState(seed)
    h, w = size
    cats = RICH_CATEGORIES[:num_classes]
    img_dir = os.path.join(root, f"train{year}" if split == "train" else f"val{year}")
    ann_dir = os.path.join(root, "annotations")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(ann_dir, exist_ok=True)

    images, annotations = [], []
    for img_id in range(1, num_images + 1):
        canvas = rng.randint(0, 60, (h, w, 3)).astype(np.uint8)
        placed = []
        for _ in range(rng.randint(min_instances, max_instances + 1)):
            cat = int(rng.randint(1, len(cats) + 1))
            name = cats[cat - 1]["name"]
            if rng.rand() < small_frac:
                bw = int(rng.randint(10, 30))
                bh = int(rng.randint(10, min(29, max(11, 1300 // bw))))
            else:
                bw = int(rng.randint(48, max(50, min(w // 2, 170)) + 1))
                bh = int(rng.randint(48, max(50, min(h // 2, 170)) + 1))
            box = None
            for _try in range(12):
                x0 = int(rng.randint(0, max(w - bw, 1)))
                y0 = int(rng.randint(0, max(h - bh, 1)))
                cand = (y0, x0, y0 + bh, x0 + bw)
                if all(_box_iou(cand, p) <= 0.25 for p in placed):
                    box = cand
                    break
            if box is None:
                continue
            placed.append(box)
            mask = _shape_mask(name, h, w, x0, y0, bw, bh)
            area = int(mask.sum())
            if area < 8:
                continue
            color_id = cat - 1 if color_mode == "class" else ((cat - 1) // 2) * 2
            canvas[mask] = np.clip(RICH_COLORS[color_id] + rng.randint(-40, 41, 3), 25, 255)
            ys, xs = np.nonzero(mask)
            bx0, by0 = int(xs.min()), int(ys.min())
            bx1, by1 = int(xs.max()) + 1, int(ys.max()) + 1
            annotations.append({
                "id": len(annotations) + 1, "image_id": img_id, "category_id": cat,
                "bbox": [float(bx0), float(by0), float(bx1 - bx0), float(by1 - by0)],
                "area": float(area), "iscrowd": 0,
                "segmentation": RLE.encode(mask).to_coco(),
            })
        fname = f"rich_{split}_{img_id:06d}.png"
        Image.fromarray(canvas).save(os.path.join(img_dir, fname))
        images.append({"id": img_id, "file_name": fname, "height": h, "width": w})

    ann_path = os.path.join(ann_dir, f"instances_{split}{year}.json")
    with open(ann_path, "w") as f:
        json.dump({"images": images, "annotations": annotations, "categories": cats}, f)
    return ann_path
