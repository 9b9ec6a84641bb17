"""Region Proposal Network head, shared across FPN levels.

Port of ``feature_intertwiner_tpu/models/rpn.py``: a shared 3×3/512 conv
(stride ``RPN.ANCHOR_STRIDE``, flax's SAME padding) and ReLU, then 1×1
class (2 per anchor) and box (4 per anchor) convs. The maps are permuted to
NHWC before the ``[B, H·W·A, 2]`` reshape, so the anchor order is the JAX
package's (cells row-major, anchor fastest). The convs run in the input's
dtype; the softmax runs in fp32, and the proposal layer and the losses take
the logits and deltas to fp32 (JAX ``models/detector.py``,
``train/losses.py``).
"""

from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn

from .common import Conv2d, SameConv2d


class RPNHead(nn.Module):
    def __init__(self, anchors_per_location: int = 3, anchor_stride: int = 1,
                 depth: int = 256):
        super().__init__()
        a = anchors_per_location
        # flax's SAME: one cell each side at stride 1; at stride 2 (0, 1) on
        # an even side and (1, 1) on an odd one (common.same_padding)
        self.conv_shared = (Conv2d(depth, 512, 3, padding=1) if anchor_stride == 1
                            else SameConv2d(depth, 512, 3, stride=anchor_stride))
        self.conv_class = Conv2d(512, 2 * a, 1)
        self.conv_bbox = Conv2d(512, 4 * a, 1)
        self.relu = nn.ReLU(inplace=True)

    def forward(self, x) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        b = x.shape[0]
        shared = self.relu(self.conv_shared(x))
        logits = self.conv_class(shared).permute(0, 2, 3, 1).reshape(b, -1, 2)
        probs = torch.softmax(logits.float(), dim=-1)
        bbox = self.conv_bbox(shared).permute(0, 2, 3, 1).reshape(b, -1, 4)
        return logits, probs, bbox


def run_rpn_over_pyramid(rpn: RPNHead, feature_maps: List[torch.Tensor]):
    """The shared head per level, concatenated along the anchor axis."""
    outs = [rpn(p) for p in feature_maps]
    return tuple(torch.cat([o[k] for o in outs], dim=1) for k in range(3))
