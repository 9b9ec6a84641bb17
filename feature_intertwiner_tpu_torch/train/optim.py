"""The optimizers, the learning-rate schedule, stage freezing and the
gradient clip.

Port of ``feature_intertwiner_tpu/train/optim.py``:

- ``sgd``: ``torch.optim.SGD`` with momentum 0.9, no dampening, no
  Nesterov: the velocity takes the raw gradient plus weight decay and the
  learning rate scales it afterwards, the order the JAX chain
  ``add_decayed_weights -> trace -> -lr`` has; weight decay skips BatchNorm
  parameters, unless ``TRAIN.BN_LEARN`` (then it covers every parameter);
- ``adam`` and ``rmsprop``: :class:`OptaxChain`, the JAX package's optax
  chains written out as tensor code (``add_decayed_weights ->
  scale_by_adam(0.9, 0.999, eps 1e-8)`` and ``add_decayed_weights ->
  scale_by_stddev(0.9)`` (centred, eps inside the square root) ``->
  trace(MOMENTUM)``), weight decay on every parameter. Not
  ``torch.optim.Adam``/``RMSprop``: optax keeps one step count for the
  whole model, which advances on every step (frozen parameters too, JAX
  ``freeze_opt_state``), where torch counts per parameter from its first
  gradient, and torch's RMSprop adds eps outside the square root;
- the stage regexes (``LAYER_REGEX``) are the JAX package's, applied to
  each port parameter's flax path (``utils/convert_weights.py``): the port's
  names follow the reference checkpoints, where the backbone lives under
  ``fpn.C1``-``fpn.C5``, so the regex ``fpn/.*`` read over port names would
  train the backbone in the ``heads`` stage. BatchNorm parameters are
  recognised the same way, by a flax path containing ``bn``;
- a frozen parameter has ``requires_grad`` off: autograd gives it no
  gradient, so no optimizer decays or moves it, and it keeps its momentum
  (its moments and trace), as the JAX step's masks do.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, List, Set

import numpy as np
import torch
from torch import nn

from ..utils.convert_weights import flax_leaves

# Stage-wise trainable-parameter regexes over flax parameter paths, a copy
# of the JAX package's config.LAYER_REGEX.
LAYER_REGEX = {
    "heads": r"(fpn/.*)|(rpn/.*)|(classifier/.*)|(mask/.*)|(dev/.*)|(ot_loss/.*)|(fpn_ot/.*)",
    "3+": r"(backbone/c3.*)|(backbone/c4.*)|(backbone/c5.*)|(fpn/.*)|(rpn/.*)|"
          r"(classifier/.*)|(mask/.*)|(dev/.*)|(ot_loss/.*)|(fpn_ot/.*)",
    "4+": r"(backbone/c4.*)|(backbone/c5.*)|(fpn/.*)|(rpn/.*)|"
          r"(classifier/.*)|(mask/.*)|(dev/.*)|(ot_loss/.*)|(fpn_ot/.*)",
    "5+": r"(backbone/c5.*)|(fpn/.*)|(rpn/.*)|(classifier/.*)|(mask/.*)|(dev/.*)|"
          r"(ot_loss/.*)|(fpn_ot/.*)",
    "all": r".*",
}


def flax_paths(model: nn.Module) -> Dict[str, str]:
    """Port parameter name -> the JAX package's flax parameter path
    (``fpn.C1.1.weight`` -> ``backbone/c1_bn/BatchNorm_0/scale``,
    ``dev_roi.upsample.0.gate`` -> ``dev/upsample0/gate``)."""
    return {name: path for name, (tree, path) in flax_leaves(model).items() if tree == "params"}


def trainable_names(model: nn.Module, layers: str) -> Set[str]:
    """The parameters a stage trains: ``layers`` is a LAYER_REGEX key or a
    raw regex, matched in full against the flax path."""
    pattern = re.compile(LAYER_REGEX.get(layers, layers))
    return {name for name, path in flax_paths(model).items() if pattern.fullmatch(path)}


def set_trainable(model: nn.Module, layers: str) -> None:
    """Turn ``requires_grad`` on for the stage's parameters and off for the
    rest."""
    names = trainable_names(model, layers)
    for name, p in model.named_parameters():
        p.requires_grad_(name in names)


def decay_names(model: nn.Module, exclude_bn: bool = True) -> Set[str]:
    """The parameters under weight decay: all but BatchNorm's (a flax path
    that contains ``bn``, the JAX ``bn_mask``); every one without
    ``exclude_bn``."""
    return {name for name, path in flax_paths(model).items()
            if not exclude_bn or "bn" not in path.lower()}


OPTIM_STATE = {"sgd": ("momentum_buffer",), "adam": ("mu", "nu"),
               "rmsprop": ("mu", "nu", "trace")}


class OptaxChain(torch.optim.Optimizer):
    """Adam or centred RMSprop as the JAX package's optax chains compute
    them, over one parameter group whose ``count`` is optax's single step
    count: it advances on every :meth:`step`, whichever parameters train.
    Each parameter keeps ``mu`` and ``nu`` (and ``trace`` for RMSprop), zero
    at the start; one without a gradient (frozen) keeps them unchanged and
    does not move. With ``g = grad + wd · p``:

    - ``adam``: ``mu = 0.1 g + 0.9 mu``, ``nu = 0.001 g² + 0.999 nu``,
      ``p -= lr · (mu / (1 - 0.9^count)) / (sqrt(nu / (1 - 0.999^count)) +
      1e-8)``;
    - ``rmsprop``: ``mu = 0.1 g + 0.9 mu``, ``nu = 0.1 g² + 0.9 nu``,
      ``trace = g · rsqrt(nu - mu² + 1e-8) + momentum · trace``,
      ``p -= lr · trace``.

    Each ``a · b + c`` is one fused multiply-add (``torch.add`` with
    ``alpha``, ``torch.addcmul``: fused on the CPU and on the card) on the
    product XLA fuses when it compiles the optax chain, and Adam's update is
    ``mu / (c1 · (sqrt(nu / c2) + eps))``, the form XLA simplifies it to:
    centred RMSprop under a steady gradient subtracts two nearly equal
    moments, and other roundings there move the update by 1e-4 of itself
    against the JAX step's."""

    def __init__(self, params, method: str, weight_decay: float, momentum: float = 0.9):
        if method not in ("adam", "rmsprop"):
            raise ValueError(f"OptaxChain: adam or rmsprop, got {method!r}")
        super().__init__(params, dict(lr=0.0, method=method, weight_decay=weight_decay,
                                      momentum=momentum, count=0))
        if len(self.param_groups) != 1:
            raise ValueError("OptaxChain keeps one step count: one parameter group")
        for p in self.param_groups[0]["params"]:
            for slot in OPTIM_STATE[method]:
                self.state[p][slot] = torch.zeros_like(p, memory_format=torch.preserve_format)

    @torch.no_grad()
    def step(self, closure=None):
        group = self.param_groups[0]
        group["count"] += 1
        lr, wd, count = group["lr"], group["weight_decay"], group["count"]
        adam = group["method"] == "adam"
        b1, b2 = (0.9, 0.999) if adam else (0.9, 0.9)
        if adam:
            # optax's bias corrections 1 - decay^count, in float32
            t = torch.tensor(float(count), dtype=torch.float32)
            c1 = float(1.0 - torch.tensor(b1, dtype=torch.float32) ** t)
            c2 = float(1.0 - torch.tensor(b2, dtype=torch.float32) ** t)
        for p in group["params"]:
            if p.grad is None:
                continue
            st = self.state[p]
            g = torch.add(p.grad, p, alpha=wd)
            mu = st["mu"].copy_(torch.add(b1 * st["mu"], g, alpha=1 - b1))
            if adam:
                nu = st["nu"].copy_(torch.add((1 - b2) * (g * g), st["nu"], alpha=b2))
                update = mu / (c1 * (torch.sqrt(nu / c2) + 1e-8))
            else:
                nu = st["nu"].copy_(torch.add(b2 * st["nu"], g * g, alpha=1 - b2))
                scale = torch.rsqrt(torch.addcmul(nu, mu, mu, value=-1.0) + 1e-8)
                update = st["trace"].copy_(torch.addcmul(group["momentum"] * st["trace"],
                                                         g, scale))
            p.add_(update, alpha=-lr)


def make_optimizer(cfg, model: nn.Module) -> torch.optim.Optimizer:
    """``TRAIN.OPTIM_METHOD``'s optimizer over every parameter: SGD in a
    group with weight decay and one without (the BN parameters, but under
    ``TRAIN.BN_LEARN``), Adam or RMSprop (:class:`OptaxChain`) with decay
    on all. The learning rate is set before each step."""
    method = cfg.TRAIN.OPTIM_METHOD
    params = list(model.named_parameters())
    if method in ("adam", "rmsprop"):
        return OptaxChain([p for _, p in params], method, cfg.TRAIN.WEIGHT_DECAY,
                          cfg.TRAIN.MOMENTUM)
    if method != "sgd":
        raise ValueError(f"unknown optimizer {method!r}")
    decay = decay_names(model, exclude_bn=not cfg.TRAIN.BN_LEARN)
    groups = [
        {"params": [p for n, p in params if n in decay],
         "weight_decay": cfg.TRAIN.WEIGHT_DECAY},
        {"params": [p for n, p in params if n not in decay], "weight_decay": 0.0},
    ]
    return torch.optim.SGD([g for g in groups if g["params"]], lr=cfg.TRAIN.INIT_LR,
                           momentum=cfg.TRAIN.MOMENTUM, dampening=0.0, nesterov=False)


def learning_rate(cfg, epoch: int, iter_in_epoch: int) -> float:
    """The learning rate at a 1-based epoch and iteration: the epoch-1
    linear warm-up when on, then ``GAMMA`` per stage boundary passed."""
    t = cfg.TRAIN
    if t.LR_WARM_UP and epoch == 1 and iter_in_epoch <= t.LR_WP_ITER:
        if t.LR_WP_ITER <= 1:
            return t.INIT_LR
        a = t.INIT_LR * (1 - t.LR_WP_FACTOR) / (t.LR_WP_ITER - 1)
        b = t.INIT_LR * t.LR_WP_FACTOR - a
        return a * iter_in_epoch + b
    boundaries = np.cumsum(t.SCHEDULE)
    decay = t.GAMMA ** int(np.sum(epoch > boundaries))
    return t.INIT_LR * decay


def clip_global_norm(grads: Iterable[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place by ``min(1, max_norm / (norm + 1e-6))`` of
    their global norm; returns the norm (a tensor, no host sync)."""
    grads: List[torch.Tensor] = list(grads)
    norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
    factor = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    for g in grads:
        g.mul_(factor.to(g.dtype))
    return norm


def moment_slots(model: nn.Module, optimizer: torch.optim.Optimizer
                 ) -> Dict[str, Dict[str, torch.Tensor]]:
    """An :class:`OptaxChain`'s ``mu`` and ``nu`` by parameter name, on the
    CPU: ``{slot: {name: tensor}}``, the layout of
    ``utils/convert_weights.py::from_jax_train_state``'s ``optim``."""
    return {slot: {n: optimizer.state[p][slot].detach().cpu() for n, p in model.named_parameters()}
            for slot in ("mu", "nu")}


def within_own_error(got, want, own, own_ref, rel: float = 1e-5, times: float = 4.0):
    """Optimizer moments ``got`` against ``want`` (each :func:`moment_slots`'
    layout), every tensor of both slots as one float64 vector: held when
    ``|got - want| <= rel |want| + times |own_ref - own|``, the last the
    float32 error of a step measured by its distance from the same step
    run with float64 batch moments (``models/common.py::float64_moments``).
    Returns (held, |got - want|, |own_ref - own|, |want|)."""
    def norm(a, b=None):
        return float(torch.cat([(a[s][n].double() - (0.0 if b is None else b[s][n].double()))
                                .reshape(-1) for s in a for n in a[s]]).norm())

    gap, floor, size = norm(got, want), norm(own_ref, own), norm(want)
    return gap <= rel * size + times * floor, gap, floor, size
