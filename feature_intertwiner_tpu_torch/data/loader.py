"""Fixed-shape training samples, and their batches built in process or
prefetched by thread or process workers.

Port of the sample builder of ``feature_intertwiner_tpu/data/coco_dataset.py``
(``CocoDetectionDataset.__getitem__``) and of ``data/loader.py``:

- :class:`DetectionDataset` (also ``data/coco_dataset.py::CocoDetectionDataset``)
  runs ``load_image_and_gt`` on one image with a ``RandomState`` seeded from
  (seed, epoch, index), subtracts the mean pixel and pads the ground truth
  to ``DATA.MAX_GT_INSTANCES`` (class 0 rows);
- :func:`index_batches` is the epoch's order: the indices shuffled with
  ``RandomState(seed + epoch)``, cut into batches, the ragged tail dropped
  with ``drop_last``;
- :class:`Loader` builds each batch when the trainer asks for it;
- :class:`PrefetchLoader` builds them on ``num_workers`` threads or spawned
  processes (``worker_mode``), at most ``max(prefetch, num_workers)``
  batches in flight or undelivered, and yields them in the same order.

Both loaders give the same batches, bit for bit: a sample depends only on
(seed, epoch, index). Over ranks (``rank``, ``world``) the batches are the
same global batches, of which each rank collates only its rows
``[r·B/N, (r+1)·B/N)`` (``parallel/data_parallel.py::shard_rows``), so
that the ranks' shards make up the single process's batch, in order.
Batches stay numpy on the host; no worker touches CUDA (the trainer copies
a batch to the card, ``train/workflow.py::to_device``).

``worker_mode``:

- ``'thread'``: the handoff costs nothing; PNG decoding and torch's resize
  release the GIL, the numpy glue does not;
- ``'process'``: spawned worker processes, the whole ``__getitem__`` in
  parallel, at one pickle copy per batch and a spawn per epoch. Spawn, not
  fork: the parent may hold the CUDA context and threads whose locks a fork
  would copy. Each worker runs torch on :func:`worker_threads` threads, so
  that the workers do not each start a pool the size of the host, and so
  that it resizes as the parent does.

A worker's exception is raised in the consumer. A stall watchdog raises
when no batch arrives for ``stall_timeout`` seconds.
"""

from __future__ import annotations

import multiprocessing
import queue
import threading
import time
import traceback
from typing import Dict, Iterator, List

import numpy as np
import torch

from ..parallel.data_parallel import shard_rows
from . import transforms as T


class DetectionDataset:
    """Indexable training samples of a dataset registry
    (``data/coco_dataset.py::Dataset`` or ``data/synthetic.py::InMemoryDataset``)."""

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


def index_batches(n: int, batch_size: int, shuffle: bool, seed: int, epoch: int,
                  drop_last: bool = True) -> List[np.ndarray]:
    """An epoch's batches of dataset indices."""
    order = np.arange(n)
    if shuffle:
        np.random.RandomState(seed + epoch).shuffle(order)
    stop = (n // batch_size) * batch_size if drop_last else n
    return [order[i:i + batch_size] for i in range(0, stop, batch_size)]


def collate(dataset, idxs) -> Dict[str, np.ndarray]:
    """One batch: the samples of ``idxs`` stacked key by key."""
    samples = [dataset[int(i)] for i in idxs]
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def rank_rows(batches: List[np.ndarray], batch_size: int, rank: int,
              world: int) -> List[np.ndarray]:
    """Each batch's rows of ``rank`` of ``world`` (the whole batch at
    ``world`` 1)."""
    if world == 1:
        return batches
    rows = shard_rows(batch_size, rank, world)
    return [idxs[rows] for idxs in batches]


class Loader:
    """Batches of a :class:`DetectionDataset`, each built when asked for;
    this rank's rows of each with ``world`` > 1."""

    def __init__(self, dataset: DetectionDataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, rank: int = 0, world: int = 1):
        shard_rows(batch_size, rank, world)       # raises where world does not divide it
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.rank, self.world = rank, world
        self._epoch = 0

    def __len__(self) -> int:
        return len(self.dataset) // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch
        self.dataset.set_epoch(epoch)

    def index_batches(self) -> List[np.ndarray]:
        """The epoch's batches of dataset indices (this rank's rows)."""
        return rank_rows(index_batches(len(self.dataset), self.batch_size, self.shuffle,
                                       self.seed, self._epoch),
                         self.batch_size, self.rank, self.world)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        for idxs in self.index_batches():
            yield collate(self.dataset, idxs)


def worker_threads(parent_threads: int) -> int:
    """Torch threads of a process worker whose parent runs on
    ``parent_threads``: 2, or 1 where the parent runs on 1. PyTorch's CPU
    bilinear resize takes another kernel on one thread (two separable passes,
    which round differently in the last bit), and gives the same bits on any
    two or more."""
    return 1 if parent_threads <= 1 else 2


def _proc_worker(dataset, task_q, result_q, threads: int) -> None:
    """A worker process: build batches until the sentinel arrives."""
    torch.set_num_threads(threads)
    while True:
        task = task_q.get()
        if task is None:
            return
        bi, idxs = task
        try:
            result_q.put((bi, collate(dataset, idxs), None))
        except Exception:
            result_q.put((bi, None, traceback.format_exc()))
            return


class PrefetchLoader:
    """Batches of a dataset built ahead by ``num_workers`` thread or process
    workers (``worker_mode``), in :class:`Loader`'s order; this rank's rows
    of each with ``world`` > 1 (which needs ``drop_last``)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, num_workers: int = 4,
                 seed: int = 0, drop_last: bool = True, prefetch: int = 4,
                 worker_mode: str = "thread", stall_timeout: float = 300.0,
                 rank: int = 0, world: int = 1):
        if worker_mode not in ("thread", "process"):
            raise ValueError(f"worker_mode {worker_mode!r}")
        shard_rows(batch_size, rank, world)       # raises where world does not divide it
        if world > 1 and not drop_last:
            raise ValueError("a loader sharded over ranks drops the ragged last batch")
        self.rank, self.world = rank, world
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.worker_mode = worker_mode
        self.stall_timeout = stall_timeout
        self._epoch = 0
        self._peak_outstanding = 0      # the most batches built and not yet delivered

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def _index_batches(self) -> List[np.ndarray]:
        return rank_rows(index_batches(len(self.dataset), self.batch_size, self.shuffle,
                                       self.seed, self._epoch, self.drop_last),
                         self.batch_size, self.rank, self.world)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if self.worker_mode == "process":
            return self._iter_process()
        return self._iter_thread()

    def _stalled(self, last_progress: float, what: str, pending: int, total: int) -> None:
        if time.monotonic() - last_progress > self.stall_timeout:
            raise RuntimeError(f"loader stalled: no batch for {self.stall_timeout:.0f}s with "
                               f"{what} (batch {pending}/{total} pending)")

    def _iter_process(self) -> Iterator[Dict[str, np.ndarray]]:
        """Spawned workers with the thread path's bound: a slot is taken
        before a task is queued, so at most ``max(prefetch, num_workers)``
        batches are in flight or undelivered, and the earliest pending
        batch always holds a slot."""
        batches = self._index_batches()
        ctx = multiprocessing.get_context("spawn")
        task_q, result_q = ctx.Queue(), ctx.Queue()
        nw = self.num_workers
        threads = worker_threads(torch.get_num_threads())
        procs = [ctx.Process(target=_proc_worker,
                             args=(self.dataset, task_q, result_q, threads), daemon=True)
                 for _ in range(nw)]
        for p in procs:
            p.start()
        slots = threading.Semaphore(max(self.prefetch, nw))
        stop_event = threading.Event()

        def feeder():
            for bi, idxs in enumerate(batches):
                while not slots.acquire(timeout=0.1):
                    if stop_event.is_set():
                        return
                if stop_event.is_set():
                    return
                task_q.put((bi, np.asarray(idxs)))
            for _ in range(nw):
                task_q.put(None)

        feed = threading.Thread(target=feeder, daemon=True)
        feed.start()
        self._peak_outstanding = 0
        results = {}
        poll = min(5.0, self.stall_timeout)
        try:
            next_bi, last_progress = 0, time.monotonic()
            while next_bi < len(batches):
                if next_bi not in results:
                    try:
                        bi, batch, err = result_q.get(timeout=poll)
                    except queue.Empty:
                        if not any(p.is_alive() for p in procs):
                            raise RuntimeError("all loader worker processes died without "
                                               "delivering output") from None
                        self._stalled(last_progress,
                                      f"{sum(p.is_alive() for p in procs)} live workers",
                                      next_bi, len(batches))
                        continue
                    last_progress = time.monotonic()
                    if err is not None:
                        raise RuntimeError(f"loader worker failed on batch {bi}:\n{err}")
                    results[bi] = batch
                    self._peak_outstanding = max(self._peak_outstanding, len(results))
                    continue
                batch = results.pop(next_bi)
                slots.release()
                yield batch
                next_bi += 1
                last_progress = time.monotonic()
        finally:
            stop_event.set()
            for p in procs:
                p.terminate()
            for p in procs:
                p.join(timeout=2)
            feed.join(timeout=2)
            for q in (task_q, result_q):
                q.close()

    def _iter_thread(self) -> Iterator[Dict[str, np.ndarray]]:
        batches = self._index_batches()
        task_q: "queue.Queue" = queue.Queue()
        for bi, idxs in enumerate(batches):
            task_q.put((bi, idxs))
        results, errors = {}, []
        lock = threading.Lock()
        stop_event = threading.Event()
        # Backpressure: a slot is taken before a task is pulled, so the slot
        # holders are always the earliest pending batches: the consumer's
        # next batch is among them and the pipeline cannot deadlock.
        slots = threading.Semaphore(max(self.prefetch, self.num_workers))
        self._peak_outstanding = 0

        def worker():
            while not stop_event.is_set():
                if not slots.acquire(timeout=0.1):
                    continue
                try:
                    bi, idxs = task_q.get_nowait()
                except queue.Empty:
                    slots.release()
                    return
                try:
                    batch = collate(self.dataset, idxs)
                except Exception as exc:    # raised in the consumer
                    with lock:
                        errors.append(exc)
                    stop_event.set()
                    return
                with lock:
                    results[bi] = batch
                    self._peak_outstanding = max(self._peak_outstanding, len(results))

        threads = [threading.Thread(target=worker, daemon=True) for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            next_bi, last_progress = 0, time.monotonic()
            while next_bi < len(batches):
                with lock:
                    if errors:
                        raise errors[0]
                    batch = results.pop(next_bi, None)
                if batch is None:
                    self._stalled(last_progress,
                                  f"{sum(t.is_alive() for t in threads)} live worker threads",
                                  next_bi, len(batches))
                    time.sleep(0.002)
                    continue
                slots.release()
                yield batch
                next_bi += 1
                last_progress = time.monotonic()
        finally:
            stop_event.set()
            for t in threads:
                t.join(timeout=2)
