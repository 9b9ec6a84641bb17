"""A synthetic detection dataset, built in memory.

Port of ``feature_intertwiner_tpu/data/synthetic.py::generate``: the same
random stream draws the same canvases and instances (filled rectangles,
ellipses, thin stripes in three classes), but instead of writing PNGs and
COCO polygons the port keeps each image and each instance's mask as arrays.
A mask is the painted region itself; the JAX package rasterises a polygon
(a 24-gon for an ellipse), so the two masks differ at a few border pixels.

:meth:`InMemoryDataset.coco_dataset` gives the ground truth in COCO format
for the evaluation: the JAX set's images, categories, boxes and areas (the
drawn box of each instance, its area ``w h``), with each mask as an RLE.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

CATEGORIES = [
    {"id": 1, "name": "box"},
    {"id": 2, "name": "disk"},
    {"id": 3, "name": "stripe"},
]


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
                "categories": [dict(c, supercategory="shape") for c in CATEGORIES]}

    def load_image(self, image_id: int) -> np.ndarray:
        return self.images[image_id]

    def load_mask(self, image_id: int) -> Tuple[np.ndarray, np.ndarray]:
        """(mask [H, W, N] bool, class_ids [N] int32)."""
        return self.masks[image_id], self.class_ids[image_id]


def generate(num_images: int = 8, size: Tuple[int, int] = (240, 320), seed: int = 0,
             max_instances: int = 4, small_frac: float = 0.0,
             medium_frac: float = 0.0) -> InMemoryDataset:
    """The dataset the JAX ``generate`` writes with the same arguments.

    ``small_frac`` / ``medium_frac``: fractions of instances drawn inside the
    COCO 'small' (sides 10-31 px) and 'medium' (sides 34-90 px) area
    buckets; the rest are 30 px to half the canvas."""
    rng = np.random.RandomState(seed)
    h, w = size
    yy, xx = np.mgrid[0:h, 0:w]
    images, masks, class_ids, boxes = [], [], [], []
    for _ in range(num_images):
        canvas = rng.randint(0, 60, (h, w, 3)).astype(np.uint8)
        inst, cls, drawn = [], [], []
        for _ in range(rng.randint(1, max_instances + 1)):
            cat = int(rng.randint(1, len(CATEGORIES) + 1))
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
            inst.append(m)
            cls.append(cat)
            drawn.append([float(x0), float(y0), float(bw), float(bh)])
        images.append(canvas)
        masks.append(np.stack(inst, -1))
        class_ids.append(np.asarray(cls, np.int32))
        boxes.append(drawn)
    return InMemoryDataset(images, masks, class_ids, boxes)
