"""Dev, the Feature Intertwiner RoI stage, at inference.

Port of ``feature_intertwiner_tpu/models/intertwiner.py`` for the flagship
inference path: ``structure beta``, RoIAlign pooling and ``UPSAMPLE_FAC``
1.0. With the intertwiner on, one shared make-up block (3×3 conv, BN eps
1e-5, ReLU) runs over P2 to P5 and every RoI pools from the upsampled map of
its FPN level; with it off, RoIs pool from P2 to P5 directly. Both use the
FPN equation-1 level.

The JAX package runs the make-up block on each Dev call, once for the
classifier pooling and once for the mask pooling; the port runs it once per
forward (:meth:`Dev.pooling_maps`) and pools twice from the result. The
numbers are the same.

The critic (``feat_extract``) is ported with its weights. At inference it
feeds only ``CLS_MERGE_FEAT``, which this slice does not port, so the
inference path does not run it. Each variant outside the slice raises
``NotImplementedError`` naming itself.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.roi_align import multilevel_crop_and_resize
from .common import DEV_BN_EPS, batch_norm, same_padding


class UpsampleBlock(nn.Sequential):
    """The make-up layer at ``UPSAMPLE_FAC`` 1.0: 3×3 conv, BN, ReLU."""

    def __init__(self, channels: int, factor: float = 1.0):
        if factor != 1.0:
            raise NotImplementedError(
                f"DEV.UPSAMPLE_FAC {factor}: only 1.0 is ported")
        super().__init__(
            nn.Conv2d(channels, channels, 3, padding=1),
            batch_norm(channels, eps=DEV_BN_EPS, momentum=0.1),
            nn.ReLU(inplace=True),
        )


class Critic(nn.Sequential):
    """``feat_extract``: three convs from a pooled [N, fp, fp, C] RoI to a
    1024-d vector (before the last op). The first conv is 3×3/2 with TF
    "SAME" padding, (0, 1) on the 14² input."""

    def __init__(self, channels: int = 256, feat_pool_size: int = 14):
        k = feat_pool_size // 2
        super().__init__(
            nn.Conv2d(channels, 512, 3, stride=2),
            batch_norm(512, eps=DEV_BN_EPS, momentum=0.1),
            nn.ReLU(inplace=True),
            nn.Conv2d(512, 1024, k),
            batch_norm(1024, eps=DEV_BN_EPS, momentum=0.1),
            nn.ReLU(inplace=True),
            nn.Conv2d(1024, 1024, 1),
            batch_norm(1024, eps=DEV_BN_EPS, momentum=0.1),
            nn.ReLU(inplace=True),
        )

    def forward(self, pooled):
        x = pooled.permute(0, 3, 1, 2)
        top, bottom = same_padding(x.shape[-2], 3, 2)
        left, right = same_padding(x.shape[-1], 3, 2)
        x = super().forward(F.pad(x, (left, right, top, bottom)))
        return x.reshape(x.shape[0], 1024)


class Dev(nn.Module):
    def __init__(
        self,
        channels: int = 256,
        image_size: int = 1024,
        assign_base: float = 224.0,
        use_dev: bool = True,
        structure: str = "beta",
        roi_method: str = "roi_align",
        upsample_fac: float = 2.0,
        upsample_residual: bool = False,
        multi_upsampler: bool = False,
        dis_upsampler: bool = False,
        assign_all_scale: bool = False,
        feat_pool_size: int = 14,
    ):
        super().__init__()
        if roi_method != "roi_align":
            raise NotImplementedError(f"ROIS.METHOD {roi_method}")
        if use_dev:
            if structure != "beta":
                raise NotImplementedError(f"DEV.STRUCTURE {structure}")
            if multi_upsampler:
                raise NotImplementedError("DEV.MULTI_UPSAMPLER")
            if dis_upsampler:
                raise NotImplementedError("DEV.DIS_UPSAMPLER")
            if assign_all_scale:
                raise NotImplementedError("DEV.ASSIGN_BOX_ON_ALL_SCALE")
            if upsample_residual:
                raise NotImplementedError("DEV.UPSAMPLE_RESIDUAL")
            self.upsample = nn.ModuleList([UpsampleBlock(channels, upsample_fac)])
            self.feat_extract = Critic(channels, feat_pool_size)
        self.use_dev = use_dev
        self.image_size = image_size
        self.assign_base = assign_base

    def pooling_maps(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """P2..P5 (NCHW) -> the maps RoIs pool from, as contiguous NHWC."""
        maps = [self.upsample[0](f) for f in feats] if self.use_dev else feats
        return [m.permute(0, 2, 3, 1).contiguous() for m in maps]

    def pool(self, maps: Sequence[torch.Tensor], rois: torch.Tensor,
             crop: int) -> torch.Tensor:
        """rois [B, R, 4] normalised -> pooled [B·R, crop, crop, C]."""
        b, r, _ = rois.shape
        flat = rois.reshape(-1, 4)
        box_idx = torch.arange(b, dtype=torch.int32, device=rois.device)
        box_idx = box_idx.repeat_interleave(r)
        return multilevel_crop_and_resize(
            maps, flat, box_idx, (crop, crop), (self.image_size, self.image_size),
            assign_base=self.assign_base)
