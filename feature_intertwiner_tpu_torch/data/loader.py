"""Fixed-shape training samples and batches, built in process.

Port of the sample builder of ``feature_intertwiner_tpu/data/coco_dataset.py``
(``CocoDetectionDataset.__getitem__``) and of the batch order of
``data/loader.py::PrefetchLoader``. The JAX package prefetches on worker
threads or processes; the port's loader builds each batch when the trainer
asks for it, in the same order.

- :class:`DetectionDataset` runs ``load_image_and_gt`` on one image with a
  ``RandomState`` seeded from (seed, epoch, index), subtracts the mean pixel
  and pads the ground truth to ``DATA.MAX_GT_INSTANCES`` (class 0 rows);
- :class:`Loader` shuffles the indices with ``RandomState(seed + epoch)``
  and stacks ``batch_size`` samples per batch, dropping the ragged tail.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

from . import transforms as T


class DetectionDataset:
    """Indexable training samples of a dataset registry (see
    ``data/synthetic.py::InMemoryDataset``)."""

    def __init__(self, dataset, config, augment: bool = True, seed: int = 0):
        self.dataset = dataset
        self.config = config
        self.augment = augment
        self.seed = seed
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """A fresh augmentation stream (the flips) for each epoch."""
        self._epoch = epoch

    def __len__(self) -> int:
        return self.dataset.num_images

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        cfg = self.config
        rng = np.random.RandomState((self.seed * 100003 + self._epoch * 7919 + idx) % (2 ** 31))
        image, meta, class_ids, bbox, mask = T.load_image_and_gt(
            self.dataset, cfg, int(idx), augment=self.augment,
            use_mini_mask=cfg.MRCNN.USE_MINI_MASK, rng=rng)
        image = image.astype(np.float32) - np.asarray(cfg.DATA.MEAN_PIXEL, np.float32)

        g = int(cfg.DATA.MAX_GT_INSTANCES)
        n = min(len(class_ids), g)
        mh, mw = cfg.MRCNN.MINI_MASK_SHAPE if cfg.MRCNN.USE_MINI_MASK else image.shape[:2]
        gt_cls = np.zeros((g,), np.int32)
        gt_boxes = np.zeros((g, 4), np.float32)
        gt_masks = np.zeros((g, mh, mw), np.float32)
        gt_cls[:n] = class_ids[:n]
        gt_boxes[:n] = bbox[:n].astype(np.float32)
        if mask.size:
            gt_masks[:n] = np.transpose(mask[:, :, :n], (2, 0, 1))
        return {"images": image, "gt_class_ids": gt_cls, "gt_boxes": gt_boxes,
                "gt_masks": gt_masks, "image_meta": meta}


class Loader:
    """Batches of a :class:`DetectionDataset`: dicts of stacked arrays."""

    def __init__(self, dataset: DetectionDataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self._epoch = 0

    def __len__(self) -> int:
        return len(self.dataset) // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch
        self.dataset.set_epoch(epoch)

    def index_batches(self):
        """The epoch's batches of dataset indices."""
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self._epoch).shuffle(order)
        stop = len(self) * self.batch_size
        return [order[i:i + self.batch_size] for i in range(0, stop, self.batch_size)]

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        for idxs in self.index_batches():
            samples = [self.dataset[int(i)] for i in idxs]
            yield {k: np.stack([s[k] for s in samples]) for k in samples[0]}
