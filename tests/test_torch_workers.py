"""Size each pytest-xdist worker's thread pools to its share of the cores.

Why this module exists: under ``-n 6`` every worker would otherwise start
torch's intra-op pool and XLA's CPU pools at the width of the whole
machine, six workers of eight and more threads each on eight cores. The
heavy port tests then ran up to 20x slower than alone and 8x slower than on
one thread, and the suite neared its time limit. Every port test file
imports this module first, so the cap holds in every worker before any test
runs and before any test module builds XLA's CPU client. A pytest process
without xdist keeps every thread.

- torch: ``set_num_threads`` (and the inter-op pool, where it is not
  started yet) to ``worker_threads()``, but never below
  ``TORCH_MIN_THREADS``: at one thread PyTorch's CPU convolution leaves
  oneDNN for 1x1 kernels at batch < 16 (``at::get_num_threads() > 1`` is
  one of its conditions), whose other rounding took
  ``test_torch_train.py::test_first_train_step_matches_jax``'s tempered
  ``fpn.P2_conv2.1.weight`` to 3.2 times its bound from JAX's (0.017 times
  at 2, 4 and 8 threads; ROADMAP §C).
- XLA: its CPU client sizes its pools from the CPUs the process may run on
  when they are first used, and takes no setting for it. So the worker runs
  a small jitted program while its affinity is cut to ``worker_threads()``
  CPUs, then gives every thread of the process its whole CPU set back: the
  pools keep their size, and no thread stays pinned.
"""

import os

import pytest
import torch

TORCH_MIN_THREADS = 2


def worker_threads(environ=os.environ, cpus=None):
    """Threads for one xdist worker: its share of the CPUs, at least 1;
    None outside xdist."""
    workers = environ.get("PYTEST_XDIST_WORKER_COUNT")
    if not workers:
        return None
    cpus = len(os.sched_getaffinity(0)) if cpus is None else cpus
    return max(1, cpus // int(workers))


def worker_cpus(threads, worker, allowed):
    """The ``threads`` CPUs of ``allowed`` that worker ``gw<i>`` starts XLA's
    pools on, spread over the workers."""
    allowed = sorted(allowed)
    i = int(worker[2:]) if worker and worker.startswith("gw") else 0
    return {allowed[(i * threads + k) % len(allowed)] for k in range(threads)}


def _set_all_threads_affinity(cpus):
    for tid in os.listdir("/proc/self/task"):
        try:
            os.sched_setaffinity(int(tid), cpus)
        except (ProcessLookupError, PermissionError):
            pass  # the thread ended meanwhile


def _start_xla_pools():
    import jax
    import jax.numpy as jnp

    x = jnp.ones((2, 8, 8, 16), jnp.float32)
    w = jnp.ones((3, 3, 16, 16), jnp.float32)
    conv = jax.jit(lambda x, w: jax.lax.conv_general_dilated(
        x, w, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC")))
    y = conv(x, w).reshape(-1, 16)
    jax.jit(lambda a: a.T @ a)(y).block_until_ready()


def cap_worker_threads():
    threads = worker_threads()
    if threads is None:
        return None
    torch.set_num_threads(max(threads, TORCH_MIN_THREADS))
    try:
        torch.set_num_interop_threads(max(threads, TORCH_MIN_THREADS))
    except RuntimeError:
        pass  # inter-op work already started the pool
    allowed = os.sched_getaffinity(0)
    os.sched_setaffinity(0, worker_cpus(threads, os.environ.get("PYTEST_XDIST_WORKER"), allowed))
    try:
        _start_xla_pools()
    finally:
        _set_all_threads_affinity(allowed)
    return threads


THREADS = cap_worker_threads()


def test_worker_threads_share_the_cpus():
    assert worker_threads({}, cpus=8) is None
    assert worker_threads({"PYTEST_XDIST_WORKER_COUNT": "6"}, cpus=8) == 1
    assert worker_threads({"PYTEST_XDIST_WORKER_COUNT": "3"}, cpus=8) == 2
    assert worker_threads({"PYTEST_XDIST_WORKER_COUNT": "16"}, cpus=8) == 1
    assert worker_threads({"PYTEST_XDIST_WORKER_COUNT": "1"}, cpus=8) == 8


@pytest.mark.parametrize("threads,worker,expect", [
    (1, "gw0", {0}), (1, "gw5", {5}), (2, "gw1", {2, 3}), (2, "gw3", {6, 7}),
    (2, "gw4", {0, 1}), (3, None, {0, 1, 2})])
def test_worker_cpus_spread_the_workers(threads, worker, expect):
    assert worker_cpus(threads, worker, range(8)) == expect


def test_this_worker_keeps_its_cap_and_every_cpu():
    if THREADS is None:
        assert os.environ.get("PYTEST_XDIST_WORKER_COUNT") is None
        return
    assert torch.get_num_threads() == max(THREADS, TORCH_MIN_THREADS)
    # No thread of the process stays pinned to the cut set.
    allowed = os.sched_getaffinity(0)
    for tid in os.listdir("/proc/self/task"):
        try:
            assert os.sched_getaffinity(int(tid)) == allowed
        except ProcessLookupError:
            pass
