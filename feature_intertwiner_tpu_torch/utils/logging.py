"""Console and file logging, the JSONL metrics stream, the loss line.

A copy of ``feature_intertwiner_tpu/utils/logging.py`` without the
metrics reader of its dashboard (the port imports nothing of the JAX
package).
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional


def print_log(message: str, file: Optional[str] = None,
              init: bool = False, quiet_terminal: bool = False) -> None:
    """Print, and append to ``file`` (truncate it first with ``init``)."""
    if not quiet_terminal:
        print(message)
    if file:
        os.makedirs(os.path.dirname(file) or ".", exist_ok=True)
        with open(file, "w" if init else "a") as f:
            f.write(str(message) + "\n")


def compute_eta(seconds_per_iter: float, iters_left: int) -> str:
    total = seconds_per_iter * max(iters_left, 0)
    h, rem = divmod(int(total), 3600)
    m, s = divmod(rem, 60)
    return f"{h:d}:{m:02d}:{s:02d}"


class MetricsLogger:
    """Append-only JSONL metrics stream."""

    def __init__(self, path: Optional[str]):
        self.path = path
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def log(self, **metrics) -> None:
        if not self.path:
            return
        rec = {"time": time.time()}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")


def format_loss_line(stage: str, epoch_str: str, iter_ind: int,
                     total_iter: int, lr: float, metrics: dict,
                     iter_time: float) -> str:
    """The console loss line."""
    eta = compute_eta(iter_time, total_iter - iter_ind)
    parts = [
        f"[{stage}]{epoch_str}[iter {iter_ind:04d}/{total_iter}]",
        f"lr {lr:.5f}",
        f"time {iter_time:.2f}s eta {eta}",
        f"total {float(metrics.get('total_loss', 0)):.4f}",
    ]
    for key in ("rpn_class_loss", "rpn_bbox_loss", "mrcnn_class_loss",
                "mrcnn_bbox_loss", "mrcnn_mask_loss", "meta_loss",
                "big_loss", "fpn_ot_loss"):
        if key in metrics:
            parts.append(f"{key.replace('_loss', '')} {float(metrics[key]):.4f}")
    return " | ".join(parts)
