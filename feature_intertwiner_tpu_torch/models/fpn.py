"""Feature Pyramid Network over ResNet C2 to C5, NCHW.

Port of ``feature_intertwiner_tpu/models/fpn.py``: 1×1 laterals, nearest 2×
top-down merge, 3×3 output convs, P6 as ``P5[..., ::2, ::2]``, and in
training with ``fpn_ot_loss`` (``TRAIN.FPN_OT_LOSS``) the OT loss between
adjacent levels before each top-down add: ``p4_ot(P5, L4)``, ``p3_ot(P4,
L3)`` and ``p2_ot(P3, L2)`` (:class:`models.ot.OptTrans2D`; L the lateral,
P the merged map).

As in the reference checkpoints, the FPN module holds the backbone's stages
(``fpn.C1`` to ``fpn.C5``), and each 3×3 output conv sits at index 1 of a
``Sequential`` whose index 0 is the SAME padding (``fpn.P2_conv2.1``).
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .common import Conv2d, SamePad2d
from .ot import OptTrans2D
from .resnet import ResNet


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> [B, C, 2H, 2W], nearest."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class FPN(nn.Module):
    def __init__(self, backbone: ResNet, out_channels: int = 256, fpn_ot_loss: bool = False):
        super().__init__()
        self.C1, self.C2, self.C3, self.C4, self.C5 = (
            backbone.C1, backbone.C2, backbone.C3, backbone.C4, backbone.C5)
        for level, cin in ((5, 2048), (4, 1024), (3, 512), (2, 256)):
            setattr(self, f"P{level}_conv1", Conv2d(cin, out_channels, 1))
            setattr(self, f"P{level}_conv2", nn.Sequential(
                SamePad2d(3, 1), Conv2d(out_channels, out_channels, 3)))
        self.fpn_ot_loss = fpn_ot_loss
        if fpn_ot_loss:
            self.p4_ot, self.p3_ot, self.p2_ot = (OptTrans2D(out_channels) for _ in range(3))

    # the stages are this module's own C1..C5, so ResNet's forward applies
    bottom_up = ResNet.forward

    def merge(self, c2, c3, c4, c5, with_ot: bool = False
              ) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """([p2, p3, p4, p5, p6], the OT loss [B, 3] float32: P4, P3, P2's,
        zeros unless ``with_ot`` and the module has the OT branch)."""
        use_ot = with_ot and self.fpn_ot_loss
        ot = []
        p5 = self.P5_conv1(c5)
        l4 = self.P4_conv1(c4)
        if use_ot:
            ot.append(self.p4_ot(p5, l4))
        p4 = l4 + upsample2x_nearest(p5)
        l3 = self.P3_conv1(c3)
        if use_ot:
            ot.append(self.p3_ot(p4, l3))
        p3 = l3 + upsample2x_nearest(p4)
        l2 = self.P2_conv1(c2)
        if use_ot:
            ot.append(self.p2_ot(p3, l2))
        p2 = l2 + upsample2x_nearest(p3)
        p5 = self.P5_conv2(p5)
        p4 = self.P4_conv2(p4)
        p3 = self.P3_conv2(p3)
        p2 = self.P2_conv2(p2)
        p6 = p5[:, :, ::2, ::2]
        ot = torch.stack(ot, 1) if use_ot else torch.zeros((c2.shape[0], 3), device=c2.device)
        return [p2, p3, p4, p5, p6], ot

    def top_down(self, c2, c3, c4, c5) -> List[torch.Tensor]:
        """[p2, p3, p4, p5, p6]."""
        return self.merge(c2, c3, c4, c5)[0]

    def forward(self, x) -> List[torch.Tensor]:
        return self.top_down(*self.bottom_up(x))

    def forward_train(self, x) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """The pyramid and the OT loss [B, 3] of a training forward."""
        return self.merge(*self.bottom_up(x), with_ot=True)
