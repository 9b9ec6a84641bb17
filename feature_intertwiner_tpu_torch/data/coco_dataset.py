"""COCO-format data on disk: the class and image registry, the image and
mask reader, and the train loader.

Port of ``feature_intertwiner_tpu/data/coco_dataset.py``:

- :class:`Dataset`: the registry (``add_class``, ``add_image``,
  ``prepare``, source-namespaced class ids); :meth:`Dataset.load_coco`
  fills it from a COCO annotation file through the port's
  ``evaluation/coco.py::COCO``, optionally for some categories only;
  :meth:`Dataset.auto_download` fetches COCO's zips where the image or
  annotation folder is missing;
- :meth:`Dataset.load_image` reads an image with PIL as RGB, and
  :meth:`Dataset.load_mask` decodes each instance's polygons or RLE through
  ``evaluation/rle.py`` (crowds get negative class ids; a crowd RLE smaller
  than its image becomes a full-image mask, as the reference does);
- ``CocoDetectionDataset`` is ``data/loader.py::DetectionDataset``;
- :func:`get_data` returns (train loader, val :class:`Dataset`, val COCO):
  minival for validation; train, plus valminusminival where that file
  exists, for training; minival for training under ``CTRL.QUICK_VERIFY``.
  The loader is a ``PrefetchLoader`` on ``DATA.LOADER_WORKER_NUM`` workers
  of ``DATA.LOADER_WORKER_MODE``.

PIL is imported only where an image is read: without it :func:`get_data`
raises ``ImportError`` naming PIL before it reads anything.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..evaluation.coco import COCO
from ..evaluation.rle import RLE
from .loader import DetectionDataset, PrefetchLoader
from .synthetic import require_pil

CocoDetectionDataset = DetectionDataset


class Dataset:
    """A detection dataset's registry of classes (source-namespaced ids)
    and images."""

    def __init__(self):
        self._image_ids: List[int] = []
        self.image_info: List[dict] = []
        self.class_info: List[dict] = [{"source": "", "id": 0, "name": "BG"}]
        self.source_class_ids: Dict[str, List[int]] = {}

    def add_class(self, source: str, class_id: int, class_name: str) -> None:
        for info in self.class_info:
            if info["source"] == source and info["id"] == class_id:
                return
        self.class_info.append({"source": source, "id": class_id, "name": class_name})

    def add_image(self, source: str, image_id, path: Optional[str], **kwargs) -> None:
        info = {"id": image_id, "source": source, "path": path}
        info.update(kwargs)
        self.image_info.append(info)

    def prepare(self) -> None:
        self.num_classes = len(self.class_info)
        self.class_ids = np.arange(self.num_classes)
        self.class_names = [c["name"] for c in self.class_info]
        self.num_images = len(self.image_info)
        self._image_ids = np.arange(self.num_images)
        self.class_from_source_map = {f"{c['source']}.{c['id']}": i
                                      for i, c in enumerate(self.class_info)}
        self.sources = list({c["source"] for c in self.class_info if c["source"]})
        self.source_class_ids = {}
        for source in self.sources + [""]:
            self.source_class_ids[source] = [i for i, c in enumerate(self.class_info)
                                             if c["source"] == source or i == 0]

    @property
    def image_ids(self) -> np.ndarray:
        return self._image_ids

    def map_source_class_id(self, source_class_id: str) -> int:
        return self.class_from_source_map[source_class_id]

    def get_source_class_id(self, class_id: int, source: str) -> int:
        info = self.class_info[class_id]
        assert info["source"] == source
        return info["id"]

    # -- COCO -------------------------------------------------------------------------------
    @staticmethod
    def auto_download(data_dir: str, split: str, year: str = "2014") -> None:
        """Download and unzip COCO's ``<split><year>`` images and its
        annotations where their folder is missing; a folder that exists is
        left alone. A failed download raises ``RuntimeError``."""
        import urllib.request
        import zipfile

        urls = {
            "images": f"http://images.cocodataset.org/zips/{split}{year}.zip",
            "annotations": ("http://images.cocodataset.org/annotations/"
                            f"annotations_trainval{year}.zip"),
        }
        img_dir = os.path.join(data_dir, f"{split}{year}")
        ann_dir = os.path.join(data_dir, "annotations")
        for name, url in urls.items():
            target = img_dir if name == "images" else ann_dir
            if os.path.exists(target):
                continue
            os.makedirs(data_dir, exist_ok=True)
            zip_path = os.path.join(data_dir, os.path.basename(url))
            try:
                print(f"downloading {url} ...")
                urllib.request.urlretrieve(url, zip_path)
            except OSError as exc:
                raise RuntimeError(f"auto_download failed ({exc}); place COCO under {data_dir} "
                                   "by hand, or write a synthetic set "
                                   "(data/synthetic.py::write_coco)") from exc
            with zipfile.ZipFile(zip_path) as zf:
                zf.extractall(data_dir)
            os.remove(zip_path)

    def load_coco(self, annotation_file: str, image_dir: str,
                  class_ids: Optional[List[int]] = None, return_coco: bool = False,
                  auto_download: bool = False):
        """Register the images and categories of ``annotation_file`` (only
        the images of ``class_ids``, where given); returns its COCO index
        with ``return_coco``."""
        if auto_download:
            split = os.path.basename(image_dir).rstrip("0123456789")
            year = os.path.basename(image_dir)[len(split):]
            self.auto_download(os.path.dirname(image_dir), split, year)
        coco = COCO(annotation_file)
        if class_ids:
            image_ids = []
            for cid in class_ids:
                image_ids.extend(coco.getImgIds(catIds=[cid]))
            image_ids = list(set(image_ids))
        else:
            class_ids = sorted(coco.getCatIds())
            image_ids = list(coco.imgs.keys())
        for cid in class_ids:
            self.add_class("coco", cid, coco.loadCats(cid)[0]["name"])
        for iid in image_ids:
            self.add_image(
                "coco", image_id=iid,
                path=os.path.join(image_dir, coco.imgs[iid]["file_name"]),
                width=coco.imgs[iid]["width"], height=coco.imgs[iid]["height"],
                annotations=coco.loadAnns(coco.getAnnIds(imgIds=[iid], iscrowd=None)))
        if return_coco:
            return coco

    # -- per image --------------------------------------------------------------------------
    def load_image(self, image_id: int) -> np.ndarray:
        """The image as uint8 RGB [H, W, 3]."""
        Image = require_pil("reading COCO images")
        with Image.open(self.image_info[image_id]["path"]) as img:
            return np.array(img.convert("RGB"))

    def load_mask(self, image_id: int) -> Tuple[np.ndarray, np.ndarray]:
        """(mask [H, W, N] bool, class_ids [N] int32; crowds negative).
        Instances of unregistered categories and empty masks are skipped."""
        info = self.image_info[image_id]
        if info["source"] != "coco":
            return (np.zeros((info.get("height", 1), info.get("width", 1), 0), bool),
                    np.zeros((0,), np.int32))
        masks, class_ids = [], []
        h, w = info["height"], info["width"]
        for ann in info["annotations"]:
            cid = self.class_from_source_map.get(f"coco.{ann['category_id']}")
            if cid is None:
                continue
            m = RLE.from_coco(ann["segmentation"], h, w).decode().astype(bool)
            if m.sum() < 1:
                continue
            if ann.get("iscrowd", 0):
                cid = -cid
                # a crowd RLE may carry a size smaller than its image (real
                # COCO-2014 data): the reference takes a full-image mask
                if m.shape != (h, w):
                    m = np.ones((h, w), bool)
            masks.append(m)
            class_ids.append(cid)
        if not masks:
            return np.zeros((h, w, 0), bool), np.zeros((0,), np.int32)
        return np.stack(masks, -1), np.asarray(class_ids, np.int32)


def annotation_path(root: str, split: str, year: str) -> str:
    return os.path.join(root, "annotations", f"instances_{split}{year}.json")


def get_data(config, data_root: Optional[str] = None, rank: int = 0, world: int = 1):
    """(train loader, val :class:`Dataset`, val COCO index) of the COCO
    layout under ``data_root`` (default ``DATASET.PATH``); the loader gives
    rank ``rank``'s rows of each batch with ``world`` > 1. Raises
    ``ImportError`` without PIL and ``FileNotFoundError`` naming an
    annotation file that is missing, before reading anything."""
    require_pil("reading a COCO dataset")
    root = data_root or config.DATASET.PATH
    year = config.DATASET.YEAR
    val_dir = os.path.join(root, f"val{year}")
    if config.CTRL.QUICK_VERIFY:
        train_sets = [(annotation_path(root, "minival", year), val_dir)]
    else:
        train_sets = [(annotation_path(root, "train", year), os.path.join(root, f"train{year}"))]
        vmm = annotation_path(root, "valminusminival", year)
        if os.path.exists(vmm):
            train_sets.append((vmm, val_dir))
    for path in [annotation_path(root, "minival", year)] + [p for p, _ in train_sets]:
        if not os.path.exists(path):
            raise FileNotFoundError(f"no COCO annotation file {path} (point --data_root or "
                                    "DATASET.PATH at a COCO layout, or pass --synthetic_data "
                                    "to write one there)")

    val = Dataset()
    val_api = val.load_coco(annotation_path(root, "minival", year), val_dir, return_coco=True)
    val.prepare()
    train = Dataset()
    for path, image_dir in train_sets:
        train.load_coco(path, image_dir)
    train.prepare()
    return make_loader(train, config, rank, world), val, val_api


def make_loader(dataset, config, rank: int = 0, world: int = 1) -> PrefetchLoader:
    """The shuffled, augmented train loader of a registry on
    ``DATA.LOADER_WORKER_NUM`` workers of ``DATA.LOADER_WORKER_MODE``; with
    ``world`` > 1, rank ``rank``'s rows of each ``TRAIN.BATCH_SIZE`` batch."""
    ds = DetectionDataset(dataset, config, augment=True, seed=config.MISC.SEED)
    return PrefetchLoader(ds, batch_size=config.TRAIN.BATCH_SIZE, shuffle=True,
                          num_workers=config.DATA.LOADER_WORKER_NUM, seed=config.MISC.SEED,
                          worker_mode=config.DATA.LOADER_WORKER_MODE, rank=rank, world=world)
