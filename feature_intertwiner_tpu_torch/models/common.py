"""Shared building blocks: BN per site, TF-"SAME" padding, weight init.

The modules are NCHW; the model keeps its activations in
``torch.channels_last`` memory, so an NHWC view of a map is free.

BatchNorm epsilons per site, as in the JAX package (``models/common.py``):
1e-3 for the backbone, FPN, classifier and mask head, 1e-5 for the Dev
upsampler and critic. Momenta are torch's for the same sites (0.01 and 0.1);
inference reads only the running statistics.

Padding: flax ``padding='SAME'`` is symmetric for odd kernels at stride 1
(plain ``padding=k // 2``), but for stride 2 on an even input it pads
(0, 1); :class:`SamePad2d` does that explicitly.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-3        # backbone, FPN, classifier, mask head
DEV_BN_EPS = 1e-5    # Dev upsampler and critic


def batch_norm(channels: int, eps: float = BN_EPS, momentum: float = 0.01) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(channels, eps=eps, momentum=momentum)


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """TF/flax SAME padding (before, after) along one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class SamePad2d(nn.Module):
    """Pad an NCHW map so that a ``kernel``/``stride`` window gives the TF
    "SAME" output; ``value`` fills the border (``-inf`` before a max-pool)."""

    def __init__(self, kernel: int, stride: int, value: float = 0.0):
        super().__init__()
        self.kernel, self.stride, self.value = kernel, stride, value

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        top, bottom = same_padding(x.shape[-2], self.kernel, self.stride)
        left, right = same_padding(x.shape[-1], self.kernel, self.stride)
        if top == bottom == left == right == 0:
            return x
        return F.pad(x, (left, right, top, bottom), value=self.value)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights as the JAX package initialises them:
    Xavier-uniform convolutions, N(0, 0.01) dense layers, zero biases, BN at
    identity (scale 1, bias 0, running statistics (0, 1)). The generator is
    a CPU generator; initialise before moving the model."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            w = m.weight
            # fan_in + fan_out, the same for a conv and its transpose
            fans = (w.shape[0] + w.shape[1]) * w[0, 0].numel()
            bound = math.sqrt(6.0 / fans)
            w.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Linear):
            m.weight.normal_(0.0, 0.01, generator=generator)
            m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
    return model
