"""The port's prefetching loader (``data/loader.py::PrefetchLoader``) on the
CPU, against the port's in-process ``Loader`` and the JAX package's loader.

- Thread and process workers give the in-process ``Loader``'s batches bit
  for bit, in its order, over two epochs, on the in-memory synthetic set
  and on the same set read from disk (the spawn pickles the config, the
  registry and the per-sample pipeline); and the bound on batches built and not
  yet delivered, ``max(prefetch, num_workers)``, holds.
- The epoch's batches of indices are the JAX loader's (one shuffle
  ``RandomState(seed + epoch)``, ``drop_last``), and ``Loader`` and
  ``PrefetchLoader`` share them.
- A worker's error is raised in the consumer; a worker that blocks (an
  image path that is a FIFO nobody writes) trips the stall watchdog.
- PyTorch's bilinear resize gives the same bits on any two threads or more
  and other bits on one, so a process worker runs torch on 2 threads (1
  where its parent runs on 1) and builds the parent's samples.

Process-mode tests use two workers and a few images; each is bounded by the
loader's ``stall_timeout`` and its workers' join timeout.
"""

import test_torch_workers  # noqa: F401  (first: sizes this xdist worker's thread pools)

import multiprocessing
import os
import pickle
import time

import numpy as np
import pytest
import torch

from feature_intertwiner_tpu.data.loader import PrefetchLoader as JPrefetchLoader
from feature_intertwiner_tpu_torch.config import build_config
from feature_intertwiner_tpu_torch.data import synthetic, transforms
from feature_intertwiner_tpu_torch.data.coco_dataset import Dataset, get_data
from feature_intertwiner_tpu_torch.data.loader import (
    DetectionDataset, Loader, PrefetchLoader, index_batches, worker_threads)

OPTS = ["DATA.IMAGE_MIN_DIM", "64", "DATA.IMAGE_MAX_DIM", "96", "DATA.MAX_GT_INSTANCES", "4",
        "TRAIN.BATCH_SIZE", "2", "CTRL.QUICK_VERIFY", "True"]
SYNTH = dict(num_images=6, size=(72, 100), seed=2, max_instances=3)


@pytest.fixture(scope="module")
def cfg():
    return build_config(opts=OPTS)


@pytest.fixture(scope="module")
def sources(tmp_path_factory, cfg):
    """The same synthetic set in memory and read from disk."""
    root = tmp_path_factory.mktemp("prefetch")
    synthetic.write_coco(str(root), **SYNTH)
    _, disk, _ = get_data(cfg, data_root=str(root))
    return {"memory": synthetic.generate(**SYNTH), "disk": disk, "root": root}


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            assert x[k].dtype == y[k].dtype
            np.testing.assert_array_equal(x[k], y[k])


@pytest.mark.parametrize("source", ["memory", "disk"])
@pytest.mark.parametrize("mode", ["thread", "process"])
def test_prefetch_gives_the_loaders_batches_bit_for_bit(sources, cfg, mode, source):
    ds = DetectionDataset(sources[source], cfg, augment=True, seed=5)
    ref = Loader(DetectionDataset(sources[source], cfg, augment=True, seed=5), 2, seed=5)
    loader = PrefetchLoader(ds, 2, shuffle=True, num_workers=2, seed=5, prefetch=2,
                            worker_mode=mode, stall_timeout=60)
    assert len(loader) == len(ref) == 3
    for epoch in (1, 2):
        loader.set_epoch(epoch)
        ref.set_epoch(epoch)
        _equal(list(loader), list(ref))
        assert 1 <= loader._peak_outstanding <= 2
        assert multiprocessing.active_children() == []     # the epoch's workers ended


def test_index_batches_are_the_jax_loaders_and_shared():
    class Sized:
        def __init__(self, n):
            self.n = n

        def __len__(self):
            return self.n

    for n, bs, shuffle, drop_last in ((10, 3, True, True), (10, 3, True, False),
                                      (7, 2, False, True), (8, 4, True, True)):
        for epoch in (0, 1, 3):
            jl = JPrefetchLoader(Sized(n), bs, shuffle=shuffle, seed=7, drop_last=drop_last)
            jl.set_epoch(epoch)
            pl = PrefetchLoader(Sized(n), bs, shuffle=shuffle, seed=7, drop_last=drop_last)
            pl.set_epoch(epoch)
            want = [list(b) for b in jl._index_batches()]
            assert [list(b) for b in pl._index_batches()] == want
            assert [list(b) for b in index_batches(n, bs, shuffle, 7, epoch, drop_last)] == want
            assert len(pl) == len(jl) == len(want)
            if drop_last:
                loader = Loader(Sized(n), bs, shuffle=shuffle, seed=7)
                loader._epoch = epoch
                assert [list(b) for b in loader.index_batches()] == want


def test_slow_consumer_keeps_the_prefetch_bound(sources, cfg):
    """A consumer slower than the workers: at most max(prefetch, workers)
    batches are built and not yet delivered, and they arrive in order."""
    ds = DetectionDataset(sources["memory"], cfg, augment=False)
    loader = PrefetchLoader(ds, 1, shuffle=False, num_workers=3, prefetch=2, stall_timeout=60)
    seen = []
    for batch in loader:
        seen.append(batch["image_meta"][0, -1])
        time.sleep(0.05)
    assert seen == [i["id"] for i in sources["memory"].image_info]
    assert loader._peak_outstanding <= 3


def _broken(sources, cfg, name, make=None):
    """The disk set, its second image's path replaced by ``name`` under the
    set's root, made by ``make`` where given."""
    ds = pickle.loads(pickle.dumps(sources["disk"]))
    path = os.path.join(str(sources["root"]), name)
    if make:
        make(path)
    ds.image_info[1]["path"] = path
    return DetectionDataset(ds, cfg, augment=False), path


@pytest.mark.parametrize("mode", ["thread", "process"])
def test_a_workers_error_is_raised_in_the_consumer(sources, cfg, mode):
    ds, _ = _broken(sources, cfg, "missing.png")
    loader = PrefetchLoader(ds, 2, shuffle=False, num_workers=2, worker_mode=mode,
                            stall_timeout=60)
    err = FileNotFoundError if mode == "thread" else RuntimeError
    with pytest.raises(err, match="missing.png"):
        for _ in loader:
            pass
    assert multiprocessing.active_children() == []


@pytest.mark.parametrize("mode", ["thread", "process"])
def test_a_blocked_worker_trips_the_stall_watchdog(sources, cfg, mode):
    ds, path = _broken(sources, cfg, f"blocked_{mode}.png", os.mkfifo)
    loader = PrefetchLoader(ds, 2, shuffle=False, num_workers=2, worker_mode=mode,
                            stall_timeout=1.5)
    t0 = time.monotonic()
    try:
        with pytest.raises(RuntimeError, match="loader stalled"):
            for _ in loader:
                pass
    finally:
        # a thread worker is still blocked opening the FIFO: open its other
        # end and close it, so that its read ends
        fd = os.open(path, os.O_WRONLY | os.O_NONBLOCK) if mode == "thread" else None
        if fd is not None:
            os.close(fd)
        os.unlink(path)
    assert time.monotonic() - t0 < 30
    assert multiprocessing.active_children() == []


def test_spawn_pickles_the_config_and_the_registry(sources, cfg):
    for obj in (cfg, sources["disk"], DetectionDataset(sources["disk"], cfg, seed=3)):
        back = pickle.loads(pickle.dumps(obj))
        assert type(back) is type(obj)
    again = pickle.loads(pickle.dumps(cfg))
    assert again.to_dict() == cfg.to_dict() and again.TRAIN.BATCH_SIZE == 2
    ds = DetectionDataset(sources["disk"], cfg, seed=3)
    back = pickle.loads(pickle.dumps(ds))
    for k, v in ds[1].items():
        np.testing.assert_array_equal(back[1][k], v)
    assert isinstance(back.dataset, Dataset)


def test_bilinear_gives_one_result_on_two_threads_or_more_and_another_on_one():
    """Why a process worker runs torch on 2 threads (1 where its parent runs
    on 1, ``data/loader.py::worker_threads``): PyTorch's CPU bilinear resize
    gives the same bits on any thread count from 2 up, and takes another
    kernel on one thread, whose results differ in the last bit."""
    rng = np.random.RandomState(0)
    image = torch.from_numpy(rng.randint(0, 256, (72, 100, 3)).astype(np.uint8))
    mask = torch.from_numpy(rng.rand(97, 131) > 0.5)
    before = torch.get_num_threads()
    out = {}
    try:
        for threads in (1, 2, 3, 4):
            torch.set_num_threads(threads)
            out[threads] = (transforms.bilinear(image, (69, 96)),
                            transforms.bilinear(mask, (64, 88)))
    finally:
        torch.set_num_threads(before)
    for threads in (3, 4):
        for a, b in zip(out[2], out[threads]):
            assert torch.equal(a, b)
    assert not torch.equal(out[1][0], out[2][0])
    assert (out[1][0] - out[2][0]).abs().max() < 1e-4
    assert [worker_threads(n) for n in (1, 2, 8)] == [1, 2, 2]
