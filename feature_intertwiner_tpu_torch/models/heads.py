"""Second-stage heads: box classifier/regressor and mask branch.

Port of ``feature_intertwiner_tpu/models/heads.py``. Inputs and outputs keep
the JAX layouts (pooled ``[N, P, P, C]``, masks ``[N, 28, 28, K]``); inside,
the convs run on NCHW views of channels-last memory.

The mask upsample is the JAX package's flax ``ConvTranspose`` 2×2/2 SAME,
which does not flip its kernel; the torch ``ConvTranspose2d`` here holds
that kernel spatially flipped (``utils/convert_weights.py``).

With ``CLS_MERGE_FEAT`` the classifier adds the critic's 1024-d vectors
(``Dev``, float32, in RoI order) to its ``fc1`` feature after BN and ReLU,
on the RoIs whose ``small_gt`` is positive: ``simple_add`` adds them,
``linear_add`` mixes ``(1 − w)·x + w·small`` with ``w = CLS_MERGE_FAC``. The
sum promotes to float32 as in JAX, and goes back to the compute dtype
before ``fc2``, as flax's ``fc2`` casts its input.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from .common import Conv2d, ConvTranspose2d, Linear, batch_norm


class BoxHead(nn.Module):
    """Pooled [N, P, P, C] (and, with ``merge_feat``, the critic's
    small_feat [N, 1024] and small_gt [N]) -> (logits [N, K], probs [N, K],
    deltas [N, K, 4], the 1024-d penultimate feature [N, 1024])."""

    def __init__(self, num_classes: int, pool_size: int = 7, depth: int = 256,
                 merge_feat: bool = False, merge_manner: str = "simple_add",
                 merge_fac: float = 0.5):
        super().__init__()
        if merge_feat and merge_manner not in ("simple_add", "linear_add"):
            raise ValueError(f"DEV.CLS_MERGE_MANNER {merge_manner}")
        self.num_classes = num_classes
        self.merge_feat = merge_feat
        self.merge_manner = merge_manner
        self.merge_fac = merge_fac
        # fc1 is a conv whose kernel is the pool size, VALID: an FC as a conv
        self.conv1 = Conv2d(depth, 1024, pool_size)
        self.bn1 = batch_norm(1024)
        self.conv2 = Conv2d(1024, 1024, 1)
        self.bn2 = batch_norm(1024)
        self.linear_class = Linear(1024, num_classes)
        self.linear_bbox = Linear(1024, num_classes * 4)
        self.relu = nn.ReLU(inplace=True)

    def forward(self, pooled, small_feat: Optional[torch.Tensor] = None,
                small_gt: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, ...]:
        n = pooled.shape[0]
        x = pooled.permute(0, 3, 1, 2)
        x = self.relu(self.bn1(self.conv1(x)))
        if self.merge_feat and small_feat is not None:
            gate = (small_gt > 0).to(x.dtype).reshape(n, 1, 1, 1)
            small = small_feat.reshape(n, -1, 1, 1)
            if self.merge_manner == "simple_add":
                merged = x + small * gate
            else:
                w = gate * self.merge_fac
                merged = (1.0 - w) * x + w * small
            x = merged.to(x.dtype)
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
