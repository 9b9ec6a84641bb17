"""Feature Pyramid Network over ResNet C2 to C5, NCHW.

Port of ``feature_intertwiner_tpu/models/fpn.py`` without its optimal
transport branch (a training loss): 1×1 laterals, nearest 2× top-down
merge, 3×3 output convs, P6 as ``P5[..., ::2, ::2]``.

As in the reference checkpoints, the FPN module holds the backbone's stages
(``fpn.C1`` to ``fpn.C5``), and each 3×3 output conv sits at index 1 of a
``Sequential`` whose index 0 is the SAME padding (``fpn.P2_conv2.1``).
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from .common import Conv2d, SamePad2d
from .resnet import ResNet


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> [B, C, 2H, 2W], nearest."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class FPN(nn.Module):
    def __init__(self, backbone: ResNet, out_channels: int = 256):
        super().__init__()
        self.C1, self.C2, self.C3, self.C4, self.C5 = (
            backbone.C1, backbone.C2, backbone.C3, backbone.C4, backbone.C5)
        for level, cin in ((5, 2048), (4, 1024), (3, 512), (2, 256)):
            setattr(self, f"P{level}_conv1", Conv2d(cin, out_channels, 1))
            setattr(self, f"P{level}_conv2", nn.Sequential(
                SamePad2d(3, 1), Conv2d(out_channels, out_channels, 3)))

    # the stages are this module's own C1..C5, so ResNet's forward applies
    bottom_up = ResNet.forward

    def top_down(self, c2, c3, c4, c5) -> List[torch.Tensor]:
        """[p2, p3, p4, p5, p6]."""
        p5 = self.P5_conv1(c5)
        p4 = self.P4_conv1(c4) + upsample2x_nearest(p5)
        p3 = self.P3_conv1(c3) + upsample2x_nearest(p4)
        p2 = self.P2_conv1(c2) + upsample2x_nearest(p3)
        p5 = self.P5_conv2(p5)
        p4 = self.P4_conv2(p4)
        p3 = self.P3_conv2(p3)
        p2 = self.P2_conv2(p2)
        p6 = p5[:, :, ::2, ::2]
        return [p2, p3, p4, p5, p6]

    def forward(self, x) -> List[torch.Tensor]:
        return self.top_down(*self.bottom_up(x))
