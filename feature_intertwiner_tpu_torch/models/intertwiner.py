"""Dev, the Feature Intertwiner RoI stage.

Port of ``feature_intertwiner_tpu/models/intertwiner.py`` for ``structure
beta``. With the intertwiner on, the make-up layer (:class:`UpsampleBlock`)
runs over P2 to P5 and every RoI pools from the made-up map of its level;
with it off, or under ``DIS_UPSAMPLER``, RoIs pool from P2 to P5 directly.
The level is the FPN equation-1 level (2-5), or under
``ASSIGN_BOX_ON_ALL_SCALE`` (:func:`assign_all_scale_levels`) the lowest
level whose raw map holds the RoI in ``FEAT_BRANCH_POOL_SIZE`` cells a
side, 6 where none does (pooled from P5). RoIs pool by RoIAlign (K1 on the
card), or under ``ROIS.METHOD roi_pool`` with the intertwiner on by
RoIPool (``ops/roi_pool.py``, plain PyTorch: the JAX function is no
kernel), each RoI at its own level. The layer is one block shared by the
four levels, or one per level under ``MULTI_UPSAMPLER``; at
``UPSAMPLE_FAC`` 2 (the default) a made-up map has twice the side of its
level.

The JAX package runs the make-up layer on each Dev call, once for the
classifier pooling and once for the mask pooling; the port runs it once per
forward (:meth:`Dev.pooling_maps`) and pools from the result as often as it
needs. The numbers are the same.

The critic (``feat_extract``) turns an RoI's 14² pooling into a 1024-d
vector (sigmoid for the L1/L2 meta loss, softmax for KL, none for OT). In
training (:meth:`Dev.forward_train`), per meta level l in (2, 3, 4), or
(2, 3, 4, 5) under ``ASSIGN_BOX_ON_ALL_SCALE``, the small set is the RoIs
assigned to l, and the reliable ("big") set the RoIs of the levels above
it (6 included), pooled 14² from the raw map P_l by the single-level
grouped crop (:func:`~..ops.roi_align.crop_and_resize_fused`: K4 forward,
K3 backward) with the sample positions of the jitted JAX
``crop_and_resize`` (``positions="xla"``), or by RoIPool, and run through
the critic; under ``ASSIGN_BOX_ON_ALL_SCALE`` the level-6 RoIs' head
poolings are zero in training, the critic's input included. Both
are reduced to per-class means (:func:`class_mean`). A level without small
RoIs has its big statistics zeroed. The big side is computed without
gradient (``BIG_FEAT_DETACH``, the default) unless ``BIG_SUPERVISE`` or
``BIG_FEAT_DETACH False`` asks for it: then the gradient reaches the raw maps
through ``big_fc``'s cross-entropy (``BIG_SUPERVISE``: per meta level the
mean over the big set's RoIs of the cross-entropy of ``big_fc`` (1024 to K)
on the critic's raw vector, against the RoI's class) and, without the
detach, through the big class means. ``BASELINE`` runs the make-up layer
and the poolings but builds no critic and returns no statistics. At
inference the critic runs only for
``CLS_MERGE_FEAT`` (:meth:`Dev.small_features`), on the 14² pooling of every
proposal (level 6 counting as a meta level there); the classifier adds its
vectors in RoI order.

The make-up layer, the poolings and the critic run in the maps' dtype
(bfloat16 in a bfloat16 model); the critic's vectors go to float32 before
the last op, and the class means and the meta loss are float32, as in JAX.

``DEV.STRUCTURE`` other than beta raises ``NotImplementedError``, as in
JAX; every other option of the config builds.
Under ``TRAIN.BN_LEARN`` the train step runs :meth:`Dev.forward_train` with
BN learning (``models/common.py::bn_learning``): the shared make-up block
updates its running statistics once per level, P2 to P5, and the critic
once per set, small set first and then the big sets of the meta levels,
the order of the JAX package's calls.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.roi_align import assign_fpn_level, crop_and_resize_fused, multilevel_crop_and_resize
from ..ops.roi_pool import make_roi_pool_input, roi_pool
from .common import DEV_BN_EPS, Conv2d, Linear, SameConv2d, SameConvTranspose2d, batch_norm

META_LEVELS = (2, 3, 4)
# the meta levels under DEV.ASSIGN_BOX_ON_ALL_SCALE; level 6 holds the RoIs
# too big for every level, which only the reliable set of level 5 reads
ALL_SCALE_META_LEVELS = (2, 3, 4, 5)


def class_mean(vecs: torch.Tensor, gts: torch.Tensor, mask: torch.Tensor,
               num_classes: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-class masked mean as one product: vecs [N, D], gts [N] int,
    mask [N] bool -> (feat [D, K], cnt [1, K]); the background (class 0) is
    left out and absent classes give zero columns."""
    onehot = F.one_hot(gts.to(torch.int64), num_classes).to(vecs.dtype)
    onehot = onehot * mask.to(vecs.dtype)[:, None]
    onehot[:, 0] = 0.0
    cnt = onehot.sum(0)
    sums = vecs.T @ onehot
    feat = torch.where(cnt[None, :] > 0, sums / cnt.clamp_min(1.0)[None, :],
                       sums.new_zeros(()))
    return feat, cnt[None, :]


def assign_all_scale_levels(flat_rois: torch.Tensor, widths: Sequence[int],
                            feat_pool_size: int) -> torch.Tensor:
    """``DEV.ASSIGN_BOX_ON_ALL_SCALE``'s level of each normalised box [N, 4]:
    the lowest level l in 2-5 whose raw map, ``widths[l - 2]`` cells wide,
    holds the box in at most ``feat_pool_size`` cells a side (normalised
    area ``<= (feat_pool_size / W_l)²``, the threshold in float32 as JAX
    compares it), else 6; int32."""
    h = flat_rois[:, 2] - flat_rois[:, 0]
    w = flat_rois[:, 3] - flat_rois[:, 1]
    area = h * w
    lvl = torch.full(area.shape, 6, dtype=torch.int32, device=area.device)
    for i, width in reversed(list(enumerate(widths))):
        thres = torch.tensor((feat_pool_size / width) ** 2, dtype=area.dtype,
                             device=area.device)
        lvl = torch.where(area <= thres, torch.full_like(lvl, i + 2), lvl)
    return lvl


class UpsampleBlock(nn.Sequential):
    """The make-up layer: at ``UPSAMPLE_FAC`` 1.0 a 3×3 conv, at 2.0 a 3×3
    stride-2 transposed conv (flax ``ConvTranspose`` SAME), then BN (eps
    1e-5) and ReLU; children ``0`` and ``1`` as in the reference
    checkpoints. ``init_mode`` is ``DEV.UPSAMPLE_INIT``: ``xavier`` (the
    reference) or ``identity``, under which ``init_weights`` gives the conv
    the delta kernel and the transposed conv the bilinear one, so that the
    block starts as ``relu(x)`` or ``relu(bilinear2×(x))``. With
    ``residual`` (``DEV.UPSAMPLE_RESIDUAL``) it returns ``base + gate·(y −
    base)`` around that, with a per-channel float32 ``gate``, zero at init,
    and ``base`` x or its bilinear 2× upsample, in ``y``'s dtype."""

    def __init__(self, channels: int, factor: float = 1.0, init_mode: str = "xavier",
                 residual: bool = False):
        if init_mode not in ("xavier", "identity"):
            raise ValueError(f"UPSAMPLE_INIT must be xavier|identity, got {init_mode}")
        if factor == 1.0:
            conv = Conv2d(channels, channels, 3, padding=1)
        elif factor == 2.0:
            conv = SameConvTranspose2d(channels, channels, 3, 2)
        else:
            raise ValueError(f"UPSAMPLE_FAC must be 1 or 2, got {factor}")
        conv.identity_init = init_mode == "identity"
        super().__init__(
            conv,
            batch_norm(channels, eps=DEV_BN_EPS, momentum=0.1),
            nn.ReLU(inplace=True),
        )
        self.factor = factor
        self.gate = nn.Parameter(torch.zeros(channels)) if residual else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = super().forward(x)
        if self.gate is None:
            return y
        base = x if self.factor == 1.0 else F.interpolate(
            x, scale_factor=2, mode="bilinear", align_corners=False).to(y.dtype)
        return base + self.gate.to(y.dtype)[:, None, None] * (y - base)


class Critic(nn.Sequential):
    """``feat_extract``: three convs from a pooled [N, fp, fp, C] RoI to a
    1024-d vector (before the last op). The first conv is 3×3/2 with TF
    "SAME" padding, (0, 1) on the 14² input."""

    def __init__(self, channels: int = 256, feat_pool_size: int = 14):
        k = feat_pool_size // 2
        super().__init__(
            SameConv2d(channels, 512, 3, stride=2),
            batch_norm(512, eps=DEV_BN_EPS, momentum=0.1),
            nn.ReLU(inplace=True),
            Conv2d(512, 1024, k),
            batch_norm(1024, eps=DEV_BN_EPS, momentum=0.1),
            nn.ReLU(inplace=True),
            Conv2d(1024, 1024, 1),
            batch_norm(1024, eps=DEV_BN_EPS, momentum=0.1),
            nn.ReLU(inplace=True),
        )

    def forward(self, pooled):
        x = super().forward(pooled.permute(0, 3, 1, 2))
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
        upsample_init: str = "xavier",
        upsample_residual: bool = False,
        multi_upsampler: bool = False,
        dis_upsampler: bool = False,
        assign_all_scale: bool = False,
        feat_pool_size: int = 14,
        window_cap: int = 8,
        num_classes: int = 81,
        loss_choice: str = "l1",
        baseline: bool = False,
        big_supervise: bool = False,
        big_feat_detach: bool = True,
    ):
        super().__init__()
        if roi_method not in ("roi_align", "roi_pool"):
            raise ValueError(roi_method)
        self.upsample = None
        if use_dev:
            if structure != "beta":
                raise NotImplementedError(f"DEV.STRUCTURE {structure}")
            if not dis_upsampler:
                self.upsample = nn.ModuleList([
                    UpsampleBlock(channels, upsample_fac, upsample_init, upsample_residual)
                    for _ in range(4 if multi_upsampler else 1)])
            if not baseline:
                self.feat_extract = Critic(channels, feat_pool_size)
                if big_supervise:
                    self.big_fc_layer = Linear(1024, num_classes)
        self.use_dev = use_dev
        # both act only with the intertwiner on; off, RoIs pool by RoIAlign
        # at their FPN level, as in JAX
        self.roi_method = roi_method if use_dev else "roi_align"
        self.assign_all_scale = assign_all_scale and use_dev
        self.meta_levels = ALL_SCALE_META_LEVELS if self.assign_all_scale else META_LEVELS
        self.window_cap = window_cap
        self.image_size = image_size
        self.assign_base = assign_base
        self.feat_pool_size = feat_pool_size
        self.num_classes = num_classes
        self.loss_choice = loss_choice
        self.baseline = baseline
        self.big_supervise = big_supervise
        self.big_feat_detach = big_feat_detach

    def pooling_maps(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """P2..P5 (NCHW) -> the maps RoIs pool from, as contiguous NHWC: the
        make-up layer's (block i on level i, or the shared block on every
        level), or the levels themselves."""
        maps = feats
        ups = self.upsample
        if ups is not None:
            maps = [ups[i if len(ups) > 1 else 0](f) for i, f in enumerate(feats)]
        return [m.permute(0, 2, 3, 1).contiguous() for m in maps]

    def levels(self, rois: torch.Tensor, widths: Optional[Sequence[int]] = None,
               image_size: Optional[int] = None) -> torch.Tensor:
        """rois [B, R, 4] normalised -> [B·R] int32 levels: the FPN
        equation-1 level (2-5) of each RoI's size in an ``image_size``²
        image (default the configured size), or under
        ``ASSIGN_BOX_ON_ALL_SCALE`` the level in 2-6 that
        :func:`assign_all_scale_levels` gives from ``widths``, the widths of
        the raw P2-P5 maps (not of the make-up maps)."""
        flat = rois.reshape(-1, 4)
        if self.assign_all_scale:
            if widths is None:
                raise ValueError("ASSIGN_BOX_ON_ALL_SCALE assigns by the raw maps' widths")
            return assign_all_scale_levels(flat, widths, self.feat_pool_size)
        size = image_size or self.image_size
        return assign_fpn_level(flat, (size, size), base=self.assign_base)

    def pool_cap(self, cells: int, pooled: int) -> int:
        """RoIPool's window bound: ``ROIS.WINDOW_CAP``, or at 0 the widest bin
        of a whole-map RoI (JAX ``Dev._pool_cap``)."""
        return self.window_cap if self.window_cap else cells // pooled + 2

    def pool(self, maps: Sequence[torch.Tensor], rois: torch.Tensor,
             crop: int, image_size: Optional[int] = None,
             lvl: Optional[torch.Tensor] = None) -> torch.Tensor:
        """rois [B, R, 4] normalised -> pooled [B·R, crop, crop, C], each
        RoI from the map of its level ``lvl`` (default :meth:`levels`; level
        6 pools from P5) in an ``image_size``² image (default the configured
        size): by RoIAlign, or by RoIPool under ``ROIS.METHOD roi_pool``."""
        b, r, _ = rois.shape
        flat = rois.reshape(-1, 4)
        box_idx = torch.arange(b, dtype=torch.int32, device=rois.device)
        box_idx = box_idx.repeat_interleave(r)
        size = image_size or self.image_size
        if lvl is None:
            lvl = self.levels(rois, None, size)
        level_idx = lvl.clamp(2, 5) - 2
        if self.roi_method == "roi_pool":
            return self._roi_pool_levels(maps, flat, box_idx, level_idx, crop, size)
        return multilevel_crop_and_resize(
            maps, flat, box_idx, (crop, crop), (size, size), level_idx=level_idx)

    def _roi_pool_levels(self, maps, flat, box_idx, level_idx, crop: int, size: int):
        """RoIPool of each RoI at its own level, in RoI order. (JAX pools
        every RoI at all four levels and keeps one by a one-hot product: the
        same values where the maps are finite.)"""
        rois_px = make_roi_pool_input(flat, box_idx, float(size))
        order, pooled = [], []
        for i, m in enumerate(maps):
            sel = torch.nonzero(level_idx == i)[:, 0]
            order.append(sel)
            pooled.append(roi_pool(m, rois_px[sel], m.shape[1] / size, (crop, crop),
                                   self.pool_cap(m.shape[1], crop)))
        pooled = torch.cat(pooled)
        out = pooled.new_zeros((flat.shape[0],) + pooled.shape[1:])
        return out.index_copy(0, torch.cat(order), pooled)

    def last_op(self, x: torch.Tensor) -> torch.Tensor:
        """The critic's last op for the meta loss (none for OT)."""
        if self.loss_choice in ("l1", "l2"):
            return torch.sigmoid(x)
        if self.loss_choice == "kl":
            return torch.softmax(x, dim=1)
        if self.loss_choice == "ot":
            return x
        raise ValueError(f"DEV.LOSS_CHOICE {self.loss_choice}")

    def small_features(self, pooled: torch.Tensor, rois: torch.Tensor,
                       image_size: Optional[int] = None, lvl: Optional[torch.Tensor] = None,
                       train: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """The critic's vectors (in training, and at inference for
        ``CLS_MERGE_FEAT``): pooled [B·R, F, F, C] (each RoI's 14² pooling
        from the make-up maps) and rois [B, R, 4] -> (small_out [B·R, 1024]
        float32, the vectors after the last op, zero off the meta levels;
        [B·R], 1.0 on a meta level), at the levels ``lvl`` (default
        :meth:`levels` in an ``image_size``² image). Under
        ``ASSIGN_BOX_ON_ALL_SCALE`` inference counts level 6 as a meta level
        too, as JAX merges it into level 5's small set there."""
        if lvl is None:
            lvl = self.levels(rois, None, image_size)
        meta = (lvl >= self.meta_levels[0]) & (lvl <= self.meta_levels[-1])
        if self.assign_all_scale and not train:
            meta = meta | (lvl == 6)
        act = self.last_op(self.feat_extract(pooled).float())
        return torch.where(meta[:, None], act, act.new_zeros(())), meta.float()

    def forward_train(self, feats: Sequence[torch.Tensor], rois: torch.Tensor,
                      roi_gt: torch.Tensor, pool_size: int = 7,
                      mask_pool_size: int = 14
                      ) -> Tuple[torch.Tensor, torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
        """P2..P5 (NCHW), sampled rois [B, R, 4] normalised and their
        classes [B, R] -> (pooled_cls [B·R, P, P, C], pooled_mask
        [B·R, M, M, C], stats); the critic reads pooled_mask. Under
        ``ASSIGN_BOX_ON_ALL_SCALE`` both poolings are zero for RoIs of
        level 6. With the intertwiner on, stats holds, over the S meta
        levels (3, or 4 under ``ASSIGN_BOX_ON_ALL_SCALE``),
        big_feat and small_feat [S, 1024, K], big_cnt and small_cnt
        [S, 1, K], big_loss [S], small_out [B·R, 1024] (the critic's
        vectors of meta-level RoIs, in RoI order) and small_gt [B·R]; it is
        None with the intertwiner off or under ``BASELINE``. ``big_loss``
        holds the ``BIG_SUPERVISE`` cross-entropy per meta level (zeros
        without it)."""
        b, r, _ = rois.shape
        flat = rois.reshape(-1, 4)
        lvl = self.levels(rois, [f.shape[3] for f in feats])
        maps = self.pooling_maps(feats)
        pooled_cls = self.pool(maps, rois, pool_size, lvl=lvl)
        pooled_mask = self.pool(maps, rois, mask_pool_size, lvl=lvl)
        if self.assign_all_scale:
            # RoIs too big for every level get no small pooling in training
            gate = (lvl <= 5)[:, None, None, None].to(pooled_cls.dtype)
            pooled_cls, pooled_mask = pooled_cls * gate, pooled_mask * gate
        if not self.use_dev or self.baseline:
            return pooled_cls, pooled_mask, None

        k = self.num_classes
        # the critic's vectors, zero off the meta levels, whose rows no small
        # set holds
        small_out, on_meta = self.small_features(pooled_mask, rois, lvl=lvl, train=True)
        flat_gt = roi_gt.reshape(-1).to(torch.int64)
        box_idx = torch.arange(b, dtype=torch.int32, device=rois.device).repeat_interleave(r)
        # the big side carries a gradient only for big_fc or the attached means
        big_grad = torch.is_grad_enabled() and (self.big_supervise or not self.big_feat_detach)
        stats = {key: [] for key in ("small_feat", "small_cnt", "big_feat", "big_cnt",
                                     "big_loss")}
        for level_id in self.meta_levels:
            small = lvl == level_id
            feat, cnt = class_mean(small_out, flat_gt, small, k)
            stats["small_feat"].append(feat)
            stats["small_cnt"].append(cnt)
            with torch.set_grad_enabled(big_grad):
                raw = feats[level_id - 2].permute(0, 2, 3, 1).contiguous()
                if self.roi_method == "roi_pool":
                    pooled_big = roi_pool(
                        raw, make_roi_pool_input(flat, box_idx, float(self.image_size)),
                        raw.shape[1] / self.image_size, (self.feat_pool_size,) * 2,
                        self.pool_cap(raw.shape[1], self.feat_pool_size))
                else:
                    pooled_big = crop_and_resize_fused(raw, rois.contiguous(),
                                                       (self.feat_pool_size,) * 2,
                                                       positions="xla")
                    pooled_big = pooled_big.reshape(b * r, *pooled_big.shape[2:])
                big_raw = self.feat_extract(pooled_big)
                # the reliable set: every RoI of a higher level (6 only under
                # ASSIGN_BOX_ON_ALL_SCALE)
                b_mask = lvl > level_id
                feat, cnt = class_mean(self.last_op(big_raw.float()), flat_gt, b_mask, k)
                has_small = small.any().float()
                feat = feat * has_small
                stats["big_feat"].append(feat.detach() if self.big_feat_detach else feat)
                stats["big_cnt"].append(cnt * has_small)
                if self.big_supervise:
                    logits = self.big_fc_layer(big_raw).float()
                    ce = -torch.log_softmax(logits, dim=-1).gather(1, flat_gt[:, None])[:, 0]
                    w = b_mask.float() * has_small
                    stats["big_loss"].append((ce * w).sum() / w.sum().clamp_min(1.0))
                else:
                    stats["big_loss"].append(small_out.new_zeros(()))
        out = {key: torch.stack(v) for key, v in stats.items()}
        out["small_out"] = small_out
        out["small_gt"] = torch.where(on_meta > 0, flat_gt, 0).float()
        return pooled_cls, pooled_mask, out
