"""Second-stage heads: box classifier/regressor and mask branch.

Port of ``feature_intertwiner_tpu/models/heads.py``. Inputs and outputs keep
the JAX layouts (pooled ``[N, P, P, C]``, masks ``[N, 28, 28, K]``); inside,
the convs run on NCHW views of channels-last memory.

The mask upsample is the JAX package's flax ``ConvTranspose`` 2×2/2 SAME,
which does not flip its kernel; the torch ``ConvTranspose2d`` here holds
that kernel spatially flipped (``utils/convert_weights.py``).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from .common import Conv2d, ConvTranspose2d, Linear, batch_norm


class BoxHead(nn.Module):
    """Pooled [N, P, P, C] -> (logits [N, K], probs [N, K], deltas [N, K, 4],
    the 1024-d penultimate feature [N, 1024])."""

    def __init__(self, num_classes: int, pool_size: int = 7, depth: int = 256):
        super().__init__()
        self.num_classes = num_classes
        # fc1 is a conv whose kernel is the pool size, VALID: an FC as a conv
        self.conv1 = Conv2d(depth, 1024, pool_size)
        self.bn1 = batch_norm(1024)
        self.conv2 = Conv2d(1024, 1024, 1)
        self.bn2 = batch_norm(1024)
        self.linear_class = Linear(1024, num_classes)
        self.linear_bbox = Linear(1024, num_classes * 4)
        self.relu = nn.ReLU(inplace=True)

    def forward(self, pooled) -> Tuple[torch.Tensor, ...]:
        n = pooled.shape[0]
        x = pooled.permute(0, 3, 1, 2)
        x = self.relu(self.bn1(self.conv1(x)))
        x = self.relu(self.bn2(self.conv2(x)))
        feat = x.reshape(n, 1024)
        logits = self.linear_class(feat).float()
        probs = torch.softmax(logits, dim=-1)
        bbox = self.linear_bbox(feat).reshape(n, self.num_classes, 4).float()
        return logits, probs, bbox, feat.float()


class MaskHead(nn.Module):
    """Pooled [N, 14, 14, C] -> per-class masks [N, 28, 28, K] (sigmoid)."""

    def __init__(self, num_classes: int, depth: int = 256):
        super().__init__()
        for i in range(1, 5):
            setattr(self, f"conv{i}", Conv2d(depth if i == 1 else 256, 256, 3, padding=1))
            # eps 1e-3 with torch's default momentum, as the JAX package has it
            setattr(self, f"bn{i}", batch_norm(256, momentum=0.1))
        self.deconv = ConvTranspose2d(256, 256, 2, stride=2)
        self.conv5 = Conv2d(256, num_classes, 1)
        self.relu = nn.ReLU(inplace=True)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        for i in range(1, 5):
            x = self.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))
        x = self.relu(self.deconv(x))
        x = self.conv5(x)
        return torch.sigmoid(x.float()).permute(0, 2, 3, 1)
