"""t-SNE of the visualize phase's detection features.

Port of ``feature_intertwiner_tpu/utils/tsne.py``. The joint affinities
(each row's Gaussian matched to the perplexity by bisection, then
symmetrised) are a host numpy float64 computation, as there. The gradient
descent, a jitted ``lax.fori_loop`` of dense [N, N] updates there, is a
torch loop here, in float32 on an explicit device (the card unless the
caller asks for the CPU): the Student-t kernel, ×12 exaggeration for the
first quarter of the iterations, the gains rule, momentum 0.5 then 0.8,
and re-centring. The start comes from ``np.random.RandomState(seed)``, as
in JAX. ``plot_embedding`` draws the embedding by class (``matplotlib``,
imported when it draws).
"""

from __future__ import annotations

import numpy as np
import torch

from ..inference import resolve_device


def _pairwise_sq_dists(x: np.ndarray, metric: str = "euclidean") -> np.ndarray:
    """Squared distances [N, N]; 'cosine' puts the rows on the unit sphere."""
    if metric == "cosine":
        x = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
    sq = np.sum(x * x, axis=1)
    d = sq[:, None] + sq[None, :] - 2.0 * (x @ x.T)
    np.fill_diagonal(d, 0.0)
    return np.maximum(d, 0.0)


def _conditional_p(dists_row: np.ndarray, beta: float) -> np.ndarray:
    p = np.exp(-dists_row * beta)
    s = p.sum()
    return p / s if s > 0 else p


def joint_affinities(features: np.ndarray, perplexity: float = 30.0,
                     metric: str = "euclidean", tol: float = 1e-5,
                     max_iter: int = 50) -> np.ndarray:
    """The symmetrised joint P [N, N] (float64), each row's beta matched to
    the perplexity (clamped to what N rows can reach, as sklearn does)."""
    n = features.shape[0]
    d = _pairwise_sq_dists(features.astype(np.float64), metric)
    perplexity = min(perplexity, max((n - 1) / 3.0, 2.0))
    target = np.log(perplexity)
    P = np.zeros((n, n), np.float64)
    for i in range(n):
        row = np.delete(d[i], i)
        beta, lo, hi = 1.0, 0.0, np.inf
        for _ in range(max_iter):
            p = _conditional_p(row, beta)
            h = -np.sum(p * np.log(np.maximum(p, 1e-30)))
            if abs(h - target) < tol:
                break
            if h > target:                          # too flat: sharpen
                lo, beta = beta, beta * 2 if hi == np.inf else (beta + hi) / 2
            else:
                hi, beta = beta, beta / 2 if lo == 0.0 else (beta + lo) / 2
        P[i, np.arange(n) != i] = _conditional_p(row, beta)
    P = (P + P.T) / (2.0 * n)
    return np.maximum(P, 1e-12)


def tsne_step(i: int, y: torch.Tensor, vel: torch.Tensor, gains: torch.Tensor, P: torch.Tensor,
              lr: float, exaggeration_end: int):
    """Iteration ``i`` of the descent (the body of the JAX ``fori_loop``):
    returns (y, vel, gains, grad), y re-centred."""
    n = y.shape[0]
    sq = torch.sum(y * y, dim=1)
    num = 1.0 / (1.0 + sq[:, None] + sq[None, :] - 2.0 * (y @ y.T))
    num = num * (1.0 - torch.eye(n, dtype=y.dtype, device=y.device))
    Q = torch.clamp(num / torch.sum(num), min=1e-12)
    early = i < exaggeration_end
    W = ((P * 12.0 if early else P) - Q) * num
    grad = 4.0 * ((torch.diag(torch.sum(W, dim=1)) - W) @ y)
    gains = torch.where(torch.sign(grad) != torch.sign(vel), gains + 0.2, gains * 0.8)
    gains = torch.clamp(gains, min=0.01)
    vel = (0.5 if early else 0.8) * vel - lr * gains * grad
    y = y + vel
    return y - torch.mean(y, dim=0), vel, gains, grad


def tsne_start(features: np.ndarray, perplexity: float = 30.0, metric: str = "euclidean",
               n_components: int = 2, n_iter: int = 150, learning_rate: float | None = None,
               seed: int = 0, device=None):
    """What the descent starts from: (P [N, N], y, vel, gains [N,
    n_components], learning rate, exaggeration end), the tensors float32 on
    ``device`` (default ``"cuda"``)."""
    dev = resolve_device(device)
    n = features.shape[0]
    P = torch.as_tensor(joint_affinities(features, perplexity, metric), dtype=torch.float32,
                        device=dev)
    lr = float(learning_rate) if learning_rate else max(n / 12.0, 50.0)
    rng = np.random.RandomState(seed)
    y = torch.from_numpy(rng.randn(n, n_components).astype(np.float32) * 1e-2).to(dev)
    return P, y, torch.zeros_like(y), torch.ones_like(y), lr, max(n_iter // 4, 1)


def tsne_embed(features: np.ndarray, perplexity: float = 30.0, metric: str = "euclidean",
               n_components: int = 2, n_iter: int = 150, learning_rate: float | None = None,
               seed: int = 0, device=None) -> np.ndarray:
    """Embed [N, D] features to [N, n_components] (float32) by ``n_iter``
    steps of gradient descent on ``device`` (default ``"cuda"``)."""
    n = features.shape[0]
    if n <= 1:              # the Student-t kernel has no off-diagonal mass
        return np.zeros((n, n_components), np.float32)
    P, y, vel, gains, lr, exaggeration_end = tsne_start(
        features, perplexity, metric, n_components, n_iter, learning_rate, seed, device)
    for i in range(n_iter):
        y, vel, gains, _ = tsne_step(i, y, vel, gains, P, lr, exaggeration_end)
    return y.cpu().numpy()


def plot_embedding(emb: np.ndarray, class_ids: np.ndarray, class_names=None,
                   out_path: str = "tsne.png", ellipse: bool = True,
                   title: str = "t-SNE of features") -> str:
    """Scatter the embedding coloured by class, with each class's 1-sigma
    covariance ellipse (3 points or more); a PNG at ``out_path``."""
    from .visualize import new_figure

    fig, ax = new_figure((9, 9), "plot_embedding")
    import matplotlib
    from matplotlib.patches import Ellipse

    cmap = matplotlib.colormaps["tab20"]
    for k, c in enumerate(np.unique(class_ids)):
        sel = class_ids == c
        color = cmap(k % 20)
        label = (class_names[int(c)] if class_names is not None and int(c) < len(class_names)
                 else str(int(c)))
        ax.scatter(emb[sel, 0], emb[sel, 1], s=9, color=color, label=label, alpha=0.7,
                   linewidths=0)
        if ellipse and sel.sum() >= 3:
            pts = emb[sel]
            mu, cov = pts.mean(0), np.cov(pts.T)
            vals, vecs = np.linalg.eigh(cov)
            ang = np.degrees(np.arctan2(vecs[1, -1], vecs[0, -1]))
            w, h = 2 * np.sqrt(np.maximum(vals, 0))
            ax.add_patch(Ellipse(mu, w, h, angle=ang, facecolor="none", edgecolor=color,
                                 lw=1.2, alpha=0.9))
    ax.legend(loc="best", fontsize=7, ncol=2, markerscale=2)
    ax.set_title(title)
    ax.set_xticks([]), ax.set_yticks([])
    fig.tight_layout()
    fig.savefig(out_path, dpi=130)
    return out_path
