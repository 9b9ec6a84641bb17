"""Phase timing, traces and a memory probe.

Port of ``feature_intertwiner_tpu/utils/profiling.py``:

- :class:`PhaseTimer`: host wall-clock per named phase, reported as the
  JAX package's ``[profile] <name>: total ... over n calls (... avg)`` lines
  (``CTRL.PROFILE_ANALYSIS``: the train loop's "fetch" and "step");
- :func:`trace`: a ``torch.profiler`` trace of the CPU and, where there is
  one, the card, written as a Chrome trace into ``log_dir`` when the
  context ends;
- :func:`annotate`: a named span inside a traced region
  (``torch.profiler.record_function``);
- :func:`memory_probe`: run a step a few times, then log the card's memory
  in use, its peak and its total in GiB.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str, enabled: bool = True):
    """Profile the region; writes ``trace_<pid>_<ns>.json`` into ``log_dir``
    (open it in chrome://tracing or Perfetto)."""
    if not enabled:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name: str):
    """Named span inside a traced region."""
    return torch.profiler.record_function(name)


class PhaseTimer:
    """Accumulates wall-clock per phase; prints the reference-style report."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self, log_fn: Callable[[str], None] = print) -> None:
        for name, total in sorted(self.totals.items()):
            n = self.counts[name]
            log_fn(f"[profile] {name}: total {total:.3f}s over {n} calls "
                   f"({total / n:.4f}s avg)")


def memory_probe(step_fn: Callable, *args, iters: int = 3,
                 log_fn: Callable[[str], None] = print, device="cuda") -> Optional[dict]:
    """Run ``step_fn(*args)`` ``iters`` times, then report the memory of
    ``device`` (``bytes_in_use``, ``peak_bytes_in_use``, ``bytes_limit``, the
    card's total); a CPU device has no such statistics and gives None."""
    device = torch.device(device)
    for _ in range(iters):
        step_fn(*args)
    if device.type != "cuda":
        log_fn("[memory] device memory stats unavailable on this backend")
        return None
    torch.cuda.synchronize(device)
    mem = torch.cuda.memory_stats(device)
    stats = {"bytes_in_use": mem.get("allocated_bytes.all.current", 0),
             "peak_bytes_in_use": mem.get("allocated_bytes.all.peak", 0),
             "bytes_limit": torch.cuda.get_device_properties(device).total_memory}
    log_fn(f"[memory] in_use {stats['bytes_in_use'] / 2 ** 30:.2f} GiB, peak "
           f"{stats['peak_bytes_in_use'] / 2 ** 30:.2f} GiB, limit "
           f"{stats['bytes_limit'] / 2 ** 30:.2f} GiB")
    return stats
