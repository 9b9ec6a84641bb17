"""SGD, the learning-rate schedule, stage freezing and the gradient clip.

Port of ``feature_intertwiner_tpu/train/optim.py``:

- ``torch.optim.SGD`` with momentum 0.9, no dampening, no Nesterov: the
  velocity takes the raw gradient plus weight decay and the learning rate
  scales it afterwards, the order the JAX chain ``add_decayed_weights ->
  trace -> -lr`` has; weight decay skips BatchNorm parameters;
- the stage regexes (``LAYER_REGEX``) are the JAX package's, applied to
  each port parameter's flax path (``utils/convert_weights.py``): the port's
  names follow the reference checkpoints, where the backbone lives under
  ``fpn.C1``-``fpn.C5``, so the regex ``fpn/.*`` read over port names would
  train the backbone in the ``heads`` stage. BatchNorm parameters are
  recognised the same way, by a flax path containing ``bn``;
- a frozen parameter has ``requires_grad`` off: autograd gives it no
  gradient, so SGD neither decays nor moves it and keeps its momentum, as
  the JAX step's masks do.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, List, Set

import numpy as np
import torch
from torch import nn

from ..utils.convert_weights import flax_module_path

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
    out = {}
    for mod_name, mod in model.named_modules():
        bn = isinstance(mod, nn.BatchNorm2d)
        transposed = isinstance(mod, nn.ConvTranspose2d)
        for leaf, _ in mod.named_parameters(recurse=False):
            if bn:
                flax_leaf = {"weight": "BatchNorm_0/scale", "bias": "BatchNorm_0/bias"}[leaf]
            else:
                flax_leaf = {"weight": "kernel", "bias": "bias", "gate": "gate"}[leaf]
            out[f"{mod_name}.{leaf}"] = f"{flax_module_path(mod_name, transposed)}/{flax_leaf}"
    return out


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


def decay_names(model: nn.Module) -> Set[str]:
    """The parameters under weight decay: all but BatchNorm's (a flax path
    that contains ``bn``, the JAX ``bn_mask``)."""
    return {name for name, path in flax_paths(model).items() if "bn" not in path.lower()}


def make_optimizer(cfg, model: nn.Module) -> torch.optim.SGD:
    """SGD over every parameter, in two groups: with and without weight
    decay. The learning rate is set before each step."""
    if cfg.TRAIN.OPTIM_METHOD != "sgd":
        raise NotImplementedError(f"TRAIN.OPTIM_METHOD {cfg.TRAIN.OPTIM_METHOD}")
    if cfg.TRAIN.BN_LEARN:
        raise NotImplementedError("TRAIN.BN_LEARN")
    decay = decay_names(model)
    params = list(model.named_parameters())
    groups = [
        {"params": [p for n, p in params if n in decay],
         "weight_decay": cfg.TRAIN.WEIGHT_DECAY},
        {"params": [p for n, p in params if n not in decay], "weight_decay": 0.0},
    ]
    return torch.optim.SGD(groups, lr=cfg.TRAIN.INIT_LR, momentum=cfg.TRAIN.MOMENTUM,
                           dampening=0.0, nesterov=False)


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
