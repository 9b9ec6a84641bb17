"""Entropic optimal transport (Sinkhorn) for the OT meta loss and the FPN OT
loss.

Port of ``feature_intertwiner_tpu/ops/sinkhorn.py``. The cost is ``1 -
cosine`` over L2-normalised rows (or the pairwise L2 distance), the kernel
``K = exp(-epsilon C)``, the marginals uniform (or the given row weights),
then ``iters`` updates ``a = m / (K b)``, ``b = m / (Kᵀ a)``. The plan ``P =
a K bᵀ`` pairs the last in-loop ``a`` with the final ``b`` and is detached
before the loss ``<P, C>``; the debiased divergence is ``2 OT(x, y) - OT(x,
x) - OT(y, y)``.

Every function takes a batch: rows ``[B, n, d]``, one problem per sample,
the updates as batched products over ``[B, n, n]``. They compute in the
rows' dtype; the callers pass float32, as the JAX modules cast.

One difference from the JAX functions: the gradient of a row's norm at a
zero row is 0 here (PyTorch's subgradient) where ``jnp.linalg.norm`` gives
NaN. A zero row of weight 0 then gets a zero gradient, not NaN.
"""

from __future__ import annotations

from typing import Optional

import torch

EPS = 1e-20


def cost_matrix(x: torch.Tensor, y: torch.Tensor, form: str = "cosine") -> torch.Tensor:
    """Pairwise cost between the rows of x [..., n, d] and y [..., m, d]:
    [..., n, m]."""
    if form == "cosine":
        xn = x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + EPS)
        yn = y / (torch.linalg.vector_norm(y, dim=-1, keepdim=True) + EPS)
        return 1.0 - xn @ yn.transpose(-1, -2)
    if form == "l2":
        d2 = ((x[..., :, None, :] - y[..., None, :, :]) ** 2).sum(-1)
        return torch.sqrt(d2.clamp_min(0.0) + EPS)
    raise ValueError(f"unknown cost form {form!r}")


def sinkhorn_ot(x: torch.Tensor, y: torch.Tensor, epsilon: float = 1.0, iters: int = 5,
                cost_form: str = "cosine", stop_grad_plan: bool = True,
                weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``<P, C>`` after ``iters`` Sinkhorn updates: x, y [B, n, d] -> [B].

    ``weights`` [B, n] (optional) replaces the uniform ``1/n`` marginals;
    rows of weight 0 drop out of the plan."""
    b, n = x.shape[:2]
    c = cost_matrix(x, y, cost_form)
    if weights is None:
        marg = torch.full((b, n, 1), 1.0 / n, dtype=x.dtype, device=x.device)
    else:
        marg = weights.reshape(b, n, 1).to(x.dtype)
    with torch.set_grad_enabled(torch.is_grad_enabled() and not stop_grad_plan):
        k = torch.exp(-epsilon * c)
        a, v = marg, marg
        for _ in range(iters):
            a = marg / (k @ v + EPS)
            v = marg / (k.transpose(-1, -2) @ a + EPS)
        plan = a * k * v.transpose(-1, -2)
    return (plan * c).sum((-2, -1))


def sinkhorn_divergence(x: torch.Tensor, y: torch.Tensor, epsilon: float = 1.0,
                        iters: int = 5, cost_form: str = "cosine",
                        stop_grad_plan: bool = True, debiased: bool = True,
                        weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The batched OT loss: x, y [B, n, d] -> [B]; ``2 OT(x, y) - OT(x, x) -
    OT(y, y)`` when ``debiased`` (the default), else ``OT(x, y)``."""
    def ot(p, q):
        return sinkhorn_ot(p, q, epsilon, iters, cost_form, stop_grad_plan, weights)

    if not debiased:
        return ot(x, y)
    return 2.0 * ot(x, y) - ot(x, x) - ot(y, y)
