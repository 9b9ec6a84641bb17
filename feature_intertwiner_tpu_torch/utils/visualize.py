"""Drawing: detections on an image, and training curves.

Port of ``feature_intertwiner_tpu/utils/visualize.py``: ``display_instances``
draws an image's boxes, captions and optional masks to a PNG
(``TEST.SAVE_IM``), ``plot_loss_curves`` the losses of the JSONL metrics
stream. ``matplotlib`` is imported inside the functions that draw (the
card's machine may lack it): :func:`require_matplotlib` raises
``ImportError`` naming the package and the option that needs it. Figures
are drawn on matplotlib's Agg canvas without ``pyplot``, so no global
backend is switched. The mask composite :func:`apply_mask` is numpy.

``random_colors`` shuffles with an explicit ``random.Random`` (seeded 0 by
default), where the JAX package shuffles with the global ``random``
state: ``random.Random(s).shuffle`` draws the order that ``random.seed(s);
random.shuffle`` draws, so the two packages draw the same picture.
"""

from __future__ import annotations

import colorsys
import os
import random
from typing import List, Optional, Sequence

import numpy as np


def require_matplotlib(option: str):
    """``matplotlib``, or ``ImportError`` naming it and ``option``."""
    try:
        import matplotlib
    except ImportError as exc:
        raise ImportError(f"{option} needs matplotlib, which is not installed") from exc
    return matplotlib


def new_figure(figsize, option: str = "drawing"):
    """A matplotlib ``Figure`` on an Agg canvas, and its one axes."""
    require_matplotlib(option)
    from matplotlib.backends.backend_agg import FigureCanvasAgg
    from matplotlib.figure import Figure

    fig = Figure(figsize=figsize)
    FigureCanvasAgg(fig)
    return fig, fig.subplots(1)


def random_colors(n: int, bright: bool = True,
                  rng: Optional[random.Random] = None) -> List[tuple]:
    """``n`` colours evenly spaced in hue, shuffled by ``rng`` (default
    ``random.Random(0)``)."""
    brightness = 1.0 if bright else 0.7
    colors = [colorsys.hsv_to_rgb(i / n, 1, brightness) for i in range(n)]
    (rng or random.Random(0)).shuffle(colors)
    return colors


def apply_mask(image: np.ndarray, mask: np.ndarray, color, alpha: float = 0.5) -> np.ndarray:
    """Blend ``color`` (RGB in [0, 1]) into ``image`` where ``mask`` is 1,
    in place; returns ``image``."""
    for c in range(3):
        image[:, :, c] = np.where(mask == 1,
                                  image[:, :, c] * (1 - alpha) + alpha * color[c] * 255,
                                  image[:, :, c])
    return image


def display_instances(image, boxes, class_ids, class_names, scores=None, masks=None,
                      title: str = "", save_path: Optional[str] = None, figsize=(12, 12),
                      rng: Optional[random.Random] = None):
    """Draw detections: boxes [N, (y1, x1, y2, x2)] in pixels, class_ids
    [N], captions ``<class name> <score>``, masks [N, H, W] optional.
    Writes a PNG to ``save_path`` and returns the path, else returns the
    figure. ``rng`` shuffles the colours (:func:`random_colors`)."""
    from matplotlib import patches

    n = len(boxes)
    colors = random_colors(max(n, 1), rng=rng)
    fig, ax = new_figure(figsize, "display_instances")
    canvas = image.astype(np.float32).copy()
    for i in range(n):
        color = colors[i % len(colors)]
        y1, x1, y2, x2 = boxes[i]
        ax.add_patch(patches.Rectangle((x1, y1), x2 - x1, y2 - y1, linewidth=2, alpha=0.7,
                                       edgecolor=color, facecolor="none"))
        label = class_names[int(class_ids[i])] if class_names else str(int(class_ids[i]))
        caption = f"{label} {scores[i]:.3f}" if scores is not None else label
        ax.text(x1, max(y1 - 2, 0), caption, color="w", size=11, backgroundcolor="none")
        if masks is not None:
            canvas = apply_mask(canvas, masks[i], color)
    ax.imshow(canvas.astype(np.uint8))
    ax.set_title(title)
    ax.axis("off")
    if not save_path:
        return fig
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    fig.savefig(save_path, bbox_inches="tight")
    return save_path


def plot_loss_curves(metrics: Sequence[dict], save_path: str,
                     keys: Optional[Sequence[str]] = None) -> Optional[str]:
    """The losses of the JSONL metrics stream (every ``*_loss`` key of the
    first record, or ``keys``) against the logged step, as a PNG at
    ``save_path``; None for no records."""
    if not metrics:
        return None
    keys = keys or [k for k in metrics[0] if k.endswith("_loss") or k == "total_loss"]
    fig, ax = new_figure((10, 6), "plot_loss_curves")
    xs = np.arange(len(metrics))
    for k in keys:
        ax.plot(xs, [m.get(k, np.nan) for m in metrics], label=k)
    ax.set_xlabel("logged step")
    ax.set_ylabel("loss")
    ax.legend(loc="upper right", fontsize=8)
    ax.grid(alpha=0.3)
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    fig.savefig(save_path, bbox_inches="tight")
    return save_path
