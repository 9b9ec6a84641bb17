"""ResNet-50/101 backbone (stages C1 to C5), NCHW.

Port of ``feature_intertwiner_tpu/models/resnet.py``: caffe-style
bottlenecks (the stride sits on the 1×1 ``conv1``), BN eps 1e-3, stage
widths 64/128/256/512 with expansion 4, depths [3, 4, 6, 3] (R50) and
[3, 4, 23, 3] (R101). The stem is a 7×7/2 conv padded by 3 on every side,
BN, ReLU, then a 3×3/2 max-pool with TF "SAME" padding (on an even input:
pad (0, 1) with -inf). Module names follow the reference checkpoints
(``C1.0`` conv, ``C1.1`` BN, ``C2.0.conv1``, ``C2.0.downsample.0``, ...).
"""

from __future__ import annotations

from torch import nn

from .common import Conv2d, SamePad2d, batch_norm

STAGE_DEPTHS = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3)}


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 projection: bool = False):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 1, stride=stride)
        self.bn1 = batch_norm(planes)
        self.conv2 = Conv2d(planes, planes, 3, padding=1)
        self.bn2 = batch_norm(planes)
        self.conv3 = Conv2d(planes, planes * 4, 1)
        self.bn3 = batch_norm(planes * 4)
        self.downsample = (nn.Sequential(
            Conv2d(inplanes, planes * 4, 1, stride=stride),
            batch_norm(planes * 4)) if projection else None)
        self.relu = nn.ReLU(inplace=True)

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return self.relu(y + residual)


def make_stage(inplanes: int, planes: int, blocks: int, stride: int) -> nn.Sequential:
    layers = [Bottleneck(inplanes, planes, stride, projection=True)]
    layers += [Bottleneck(planes * 4, planes) for _ in range(1, blocks)]
    return nn.Sequential(*layers)


class ResNet(nn.Module):
    """``forward(images NCHW)`` returns (c2, c3, c4, c5) at strides 4 to 32."""

    def __init__(self, architecture: str = "resnet101"):
        super().__init__()
        depths = STAGE_DEPTHS[architecture]
        self.C1 = nn.Sequential(
            Conv2d(3, 64, 7, stride=2, padding=3),
            batch_norm(64),
            nn.ReLU(inplace=True),
            SamePad2d(3, 2, value=float("-inf")),
            nn.MaxPool2d(3, stride=2),
        )
        self.C2 = make_stage(64, 64, depths[0], 1)
        self.C3 = make_stage(256, 128, depths[1], 2)
        self.C4 = make_stage(512, 256, depths[2], 2)
        self.C5 = make_stage(1024, 512, depths[3], 2)

    def forward(self, x):
        c2 = self.C2(self.C1(x))
        c3 = self.C3(c2)
        c4 = self.C4(c3)
        c5 = self.C5(c4)
        return c2, c3, c4, c5
