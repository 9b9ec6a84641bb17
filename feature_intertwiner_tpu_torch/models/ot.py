"""OptTrans: a learned generator and critic around the Sinkhorn divergence.

Port of ``feature_intertwiner_tpu/models/ot.py``. The generator ``G_net``
maps the less reliable ("small") set into the reliable one's space, a
shared ``critic`` embeds both sets, and the loss is the debiased Sinkhorn
divergence of the two embeddings (``ops/sinkhorn.py``, at its defaults:
epsilon 1, 5 iterations, the cosine cost), in float32.

- :class:`OptTrans1D`, the OT meta loss (``DEV.LOSS_CHOICE ot``) over
  per-class 1024-d vectors [n, ch]: ``G_net`` a Conv1d k3 pad 1 over a
  length-1 axis (only its centre tap sees data) + ReLU; the critic a Conv1d
  to ch/4 + ReLU (``OT_ONE_DIM_FORM conv``) or a Linear to ch/8 (``fc``).
  The OT of each sample runs over the critic's ch/4 (ch/8) outputs as rows
  of dimension 1; the per-sample divergences are weighted and summed.
- :class:`OptTrans2D`, the FPN OT loss (``TRAIN.FPN_OT_LOSS``) between two
  NCHW maps, x at half y's size: ``G_net`` a flax-SAME 3×3 transposed conv
  at stride 2 + BN + ReLU; the critic two SAME 3×3 stride-2 convs to ch/2
  and ch/4, each with BN + ReLU. Rows are the critic's channels, their
  dimension the flattened space. Returns [B].

Module names are the reference checkpoints' (``G_net.0``, ``critic.0``,
...). Both compute in their inputs' dtype, as the model's layers do; the
caller casts the 1-D sets to the model's dtype.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.sinkhorn import sinkhorn_divergence
from .common import DEV_BN_EPS, Conv1d, Linear, SameConv2d, SameConvTranspose2d, batch_norm

ONE_DIM_FORMS = ("conv", "fc")


class OptTrans1D(nn.Module):
    def __init__(self, channels: int = 1024, one_dim_form: str = "conv"):
        super().__init__()
        if one_dim_form not in ONE_DIM_FORMS:
            raise ValueError(f"DEV.OT_ONE_DIM_FORM must be one of {ONE_DIM_FORMS}, "
                             f"got {one_dim_form!r}")
        self.G_net = nn.Sequential(Conv1d(channels, channels, 3, padding=1), nn.ReLU(inplace=True))
        if one_dim_form == "conv":
            self.critic = nn.Sequential(Conv1d(channels, channels // 4, 3, padding=1),
                                        nn.ReLU(inplace=True))
        else:
            self.critic = Linear(channels, channels // 8)
        self.one_dim_form = one_dim_form

    def embed(self, z: torch.Tensor) -> torch.Tensor:
        """[n, ch, 1] -> the critic's [n, ch', 1] in float32."""
        if self.one_dim_form == "conv":
            return self.critic(z).float()
        return self.critic(z[:, :, 0])[:, :, None].float()

    def forward(self, x: torch.Tensor, y: torch.Tensor,
                row_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x, y [n, ch] (the small and the big per-class vectors) -> the sum
        of the per-sample divergences, each times its ``row_weights`` [n]
        entry (0 drops an absent class)."""
        cx = self.embed(self.G_net(x[:, :, None]))
        cy = self.embed(y[:, :, None])
        per_sample = sinkhorn_divergence(cx, cy)
        if row_weights is not None:
            per_sample = per_sample * row_weights.to(per_sample.dtype)
        return per_sample.sum()


class OptTrans2D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.G_net = nn.Sequential(
            SameConvTranspose2d(channels, channels, 3, 2),
            batch_norm(channels, eps=DEV_BN_EPS, momentum=0.1),
            nn.ReLU(inplace=True))
        self.critic = nn.Sequential(
            SameConv2d(channels, channels // 2, 3, stride=2),
            batch_norm(channels // 2, eps=DEV_BN_EPS, momentum=0.1),
            nn.ReLU(inplace=True),
            SameConv2d(channels // 2, channels // 4, 3, stride=2),
            batch_norm(channels // 4, eps=DEV_BN_EPS, momentum=0.1),
            nn.ReLU(inplace=True))

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """x [B, C, H, W], y [B, C, 2H, 2W] -> [B] float32."""
        cx = self.critic(self.G_net(x))
        cy = self.critic(y)
        b, c = cx.shape[:2]
        return sinkhorn_divergence(cx.reshape(b, c, -1).float(), cy.reshape(b, c, -1).float())
