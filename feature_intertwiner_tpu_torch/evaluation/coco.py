"""COCO annotation index.

Port of ``feature_intertwiner_tpu/evaluation/coco.py``, the
``pycocotools.coco.COCO`` surface the evaluation reads: a COCO-format
dataset (a json file, or a dict already in memory) indexed into
anns/imgs/cats, the getAnnIds/getCatIds/getImgIds/loadAnns/loadImgs/
loadCats queries, ``annToRLE``/``annToMask``, and ``loadRes`` for a results
COCO built from detections; RLE operations through ``evaluation/rle.py``.
"""

from __future__ import annotations

import copy
import json
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from .rle import RLE


def _as_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple, set, np.ndarray)) else [x]


class COCO:
    def __init__(self, annotation_file: Optional[str] = None, dataset: Optional[dict] = None):
        """Index a json file, or a ``dataset`` dict (images, annotations,
        categories) given in memory, or nothing (an empty index)."""
        if annotation_file is not None and dataset is not None:
            raise ValueError("COCO takes an annotation file or a dataset dict, not both")
        self.dataset: dict = {}
        self.anns: Dict[int, dict] = {}
        self.imgs: Dict[int, dict] = {}
        self.cats: Dict[int, dict] = {}
        self.img_to_anns: Dict[int, List[dict]] = defaultdict(list)
        self.cat_to_imgs: Dict[int, List[int]] = defaultdict(list)
        if annotation_file is not None:
            t0 = time.time()
            with open(annotation_file) as f:
                self.dataset = json.load(f)
            self.create_index()
            print(f"COCO index built in {time.time() - t0:.2f}s")
        elif dataset is not None:
            self.dataset = dataset
            self.create_index()

    # -- index ----------------------------------------------------------
    def create_index(self):
        self.anns, self.imgs, self.cats = {}, {}, {}
        self.img_to_anns, self.cat_to_imgs = defaultdict(list), defaultdict(list)
        for img in self.dataset.get("images", []):
            self.imgs[img["id"]] = img
        for cat in self.dataset.get("categories", []):
            self.cats[cat["id"]] = cat
        for ann in self.dataset.get("annotations", []):
            self.anns[ann["id"]] = ann
            self.img_to_anns[ann["image_id"]].append(ann)
            if "category_id" in ann:
                self.cat_to_imgs[ann["category_id"]].append(ann["image_id"])

    # -- queries (pycocotools API surface) -------------------------------
    def getAnnIds(self, imgIds=None, catIds=None, areaRng=None, iscrowd=None):
        img_ids, cat_ids = _as_list(imgIds), _as_list(catIds)
        if img_ids:
            anns = [a for i in img_ids for a in self.img_to_anns.get(i, [])]
        else:
            anns = list(self.anns.values())
        if cat_ids:
            cat_set = set(cat_ids)
            anns = [a for a in anns if a.get("category_id") in cat_set]
        if areaRng:
            anns = [a for a in anns
                    if areaRng[0] < a.get("area", 0) < areaRng[1]]
        if iscrowd is not None:
            anns = [a for a in anns if a.get("iscrowd", 0) == iscrowd]
        return [a["id"] for a in anns]

    def getCatIds(self, catNms=None, supNms=None, catIds=None):
        cats = list(self.cats.values())
        for key, vals in (("name", _as_list(catNms)),
                          ("supercategory", _as_list(supNms)),
                          ("id", _as_list(catIds))):
            if vals:
                vs = set(vals)
                cats = [c for c in cats if c.get(key) in vs]
        return sorted(c["id"] for c in cats)

    def getImgIds(self, imgIds=None, catIds=None):
        img_ids = set(_as_list(imgIds)) or set(self.imgs.keys())
        cat_ids = _as_list(catIds)
        if cat_ids:
            with_cats = None
            for c in cat_ids:
                s = set(self.cat_to_imgs.get(c, []))
                with_cats = s if with_cats is None else (with_cats & s)
            img_ids &= with_cats or set()
        return sorted(img_ids)

    def loadAnns(self, ids):
        return [self.anns[i] for i in _as_list(ids)]

    def loadImgs(self, ids):
        return [self.imgs[i] for i in _as_list(ids)]

    def loadCats(self, ids):
        return [self.cats[i] for i in _as_list(ids)]

    # -- masks -----------------------------------------------------------
    def annToRLE(self, ann) -> RLE:
        img = self.imgs[ann["image_id"]]
        return RLE.from_coco(ann["segmentation"], img["height"], img["width"])

    def annToMask(self, ann) -> np.ndarray:
        return self.annToRLE(ann).decode()

    # -- results ---------------------------------------------------------
    def loadRes(self, results: Union[str, Sequence[dict]]) -> "COCO":
        """Build a results COCO from a list of detection dicts (or json path).

        Each result: {image_id, category_id, bbox [x,y,w,h] or segmentation,
        score}."""
        if isinstance(results, str):
            with open(results) as f:
                results = json.load(f)
        res = COCO()
        res.dataset = {
            "images": [copy.deepcopy(self.imgs[i]) for i in
                       sorted({r["image_id"] for r in results})],
            "categories": copy.deepcopy(list(self.cats.values())),
            "annotations": [],
        }
        for idx, r in enumerate(results):
            ann = dict(r)
            ann["id"] = idx + 1
            ann.setdefault("iscrowd", 0)
            if "bbox" in ann and "area" not in ann:
                # bbox area even when a segmentation is present — exact
                # pycocotools semantics (the bbox branch wins; reference
                # coco.py:323-331 sets area = bb[2]*bb[3] there too)
                ann["area"] = float(ann["bbox"][2] * ann["bbox"][3])
            if "segmentation" in ann and "bbox" not in ann:
                img = self.imgs[ann["image_id"]]
                rle = RLE.from_coco(ann["segmentation"], img["height"],
                                    img["width"])
                ann["bbox"] = rle.bbox().tolist()
                ann.setdefault("area", rle.area())
            res.dataset["annotations"].append(ann)
        res.create_index()
        return res
