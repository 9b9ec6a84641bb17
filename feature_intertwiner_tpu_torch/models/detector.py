"""InterNet: the two-stage detector with the Feature Intertwiner.

Port of ``feature_intertwiner_tpu/models/detector.py``
(``InterNet.from_config``, ``forward_inference`` with its visualize mode,
and ``forward_train``): ResNet-FPN backbone, RPN, proposal layer, Dev,
classifier, detection layer, then the mask pass on the detections (in
visualize mode each detection's classifier feature instead); in training,
the RPN and second-stage targets and the five losses in place of the
detection layer.

Training follows the JAX package's ``strict_quirks`` (SURVEY §3.5 #1): it
proposes ``POST_NMS_ROIS_INFERENCE`` boxes (``POST_NMS_ROIS_TRAINING`` with
``MODEL.STRICT_QUIRKS`` off) and BN stays in eval mode, its running
statistics frozen; the caller keeps the model in ``eval()``. With
``train_bn`` (``TRAIN.BN_LEARN``) every BN of the forward learns batch
statistics instead, as the JAX ``train_bn=True`` with a mutable
``batch_stats`` (``models/common.py::bn_learning``), and goes back to its
mode after it. Under ``DEV.BASELINE`` the classifier gets no critic
vectors, in training and at inference.

``dtype`` is the compute dtype (JAX ``InterNet.dtype``): the images are
cast to it before the backbone and every layer after computes in it
(``models/common.py``), with float32 parameters. The proposal layer, the
detection layer and the losses take float32 inputs, cast where the JAX
package casts. Re-typing a model (``model.dtype = torch.float32``, JAX
``model.clone(dtype=...)``) keeps its parameters.

The top-level module names follow the reference checkpoints: ``fpn`` (with
the backbone stages inside), ``rpn``, ``dev_roi``, ``classifier`` and
``mask``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ..ops.anchors import generate_pyramid_anchors
from ..ops.detection import detection_layer
from ..ops.proposals import proposal_layer
from ..ops.targets import detection_targets, rpn_targets
from ..train import losses as L
from .common import bn_learning
from .fpn import FPN
from .heads import BoxHead, MaskHead
from .intertwiner import Dev
from .ot import OptTrans1D
from .resnet import ResNet
from .rpn import RPNHead, run_rpn_over_pyramid


class InterNet(nn.Module):
    def __init__(
        self,
        backbone: str = "resnet101",
        num_classes: int = 81,
        image_size: int = 1024,
        fpn_channels: int = 256,
        anchor_scales: tuple = (32, 64, 128, 256, 512),
        anchor_ratios: tuple = (0.5, 1.0, 2.0),
        anchor_stride: int = 1,
        strides: tuple = (4, 8, 16, 32, 64),
        rpn_nms_threshold: float = 0.7,
        pre_nms_limit: int = 6000,
        post_nms_inference: int = 1000,
        pool_size: int = 7,
        mask_pool_size: int = 14,
        mask_shape: tuple = (28, 28),
        assign_base: float = 224.0,
        roi_method: str = "roi_align",
        roi_pool_window_cap: int = 8,
        bbox_std: tuple = (0.1, 0.1, 0.2, 0.2),
        det_max_instances: int = 100,
        det_nms_threshold: float = 0.3,
        det_min_confidence: float = 0.0,
        dev_switch: bool = False,
        dev_structure: str = "beta",
        dev_upsample_fac: float = 2.0,
        dev_upsample_init: str = "xavier",
        dev_upsample_residual: bool = False,
        dev_multi_upsampler: bool = False,
        dev_dis_upsampler: bool = False,
        dev_assign_all_scale: bool = False,
        dev_feat_pool_size: int = 14,
        cls_merge_feat: bool = False,
        cls_merge_manner: str = "simple_add",
        cls_merge_fac: float = 0.5,
        post_nms_train: int = 2000,
        train_anchors_per_image: int = 256,
        rpn_pos_thresh: float = 0.7,
        rpn_neg_thresh: float = 0.3,
        rois_per_image: int = 200,
        positive_ratio: float = 0.33,
        use_mini_mask: bool = True,
        strict_quirks: bool = True,
        dev_loss_choice: str = "l1",
        dev_baseline: bool = False,
        dev_big_supervise: bool = False,
        dev_big_feat_detach: bool = True,
        dev_ot_one_dim_form: str = "conv",
        fpn_ot_loss: bool = False,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute dtype float32 or bfloat16, got {dtype}")
        self.dtype = dtype
        if tuple(mask_shape) != (2 * mask_pool_size, 2 * mask_pool_size):
            raise ValueError("MRCNN.MASK_SHAPE must be twice MASK_POOL_SIZE")
        self.num_classes = num_classes
        self.image_size = image_size
        self.rpn_nms_threshold = rpn_nms_threshold
        self.pre_nms_limit = pre_nms_limit
        self.post_nms_inference = post_nms_inference
        self.pool_size = pool_size
        self.mask_pool_size = mask_pool_size
        self.mask_shape = tuple(mask_shape)
        self.det_max_instances = det_max_instances
        self.det_nms_threshold = det_nms_threshold
        self.det_min_confidence = det_min_confidence
        self.post_nms_train = post_nms_train
        self.train_anchors_per_image = train_anchors_per_image
        self.rpn_pos_thresh = rpn_pos_thresh
        self.rpn_neg_thresh = rpn_neg_thresh
        self.rois_per_image = rois_per_image
        self.positive_ratio = positive_ratio
        self.use_mini_mask = use_mini_mask
        self.strict_quirks = strict_quirks

        self.fpn = FPN(ResNet(backbone), fpn_channels, fpn_ot_loss=fpn_ot_loss)
        self.rpn = RPNHead(len(anchor_ratios), anchor_stride, fpn_channels)
        self.dev_roi = Dev(
            channels=fpn_channels, image_size=image_size,
            assign_base=assign_base, use_dev=dev_switch,
            structure=dev_structure, roi_method=roi_method,
            window_cap=roi_pool_window_cap,
            upsample_fac=dev_upsample_fac,
            upsample_init=dev_upsample_init,
            upsample_residual=dev_upsample_residual,
            multi_upsampler=dev_multi_upsampler,
            dis_upsampler=dev_dis_upsampler,
            assign_all_scale=dev_assign_all_scale,
            feat_pool_size=dev_feat_pool_size,
            num_classes=num_classes, loss_choice=dev_loss_choice,
            baseline=dev_baseline, big_supervise=dev_big_supervise,
            big_feat_detach=dev_big_feat_detach)
        # the critic's vectors join the classifier (JAX detector.py:206-209)
        self.classifier = BoxHead(
            num_classes, pool_size, fpn_channels,
            merge_feat=dev_switch and cls_merge_feat and dev_structure == "beta",
            merge_manner=cls_merge_manner, merge_fac=cls_merge_fac)
        self.mask = MaskHead(num_classes, fpn_channels)
        # the OT meta loss's generator and critic, run by the train step
        # through meta_ot
        self.ot_loss = (OptTrans1D(1024, dev_ot_one_dim_form)
                        if dev_switch and dev_loss_choice == "ot" else None)

        self._anchor_spec = (tuple(anchor_scales), tuple(anchor_ratios), tuple(strides),
                             anchor_stride)
        self.register_buffer("anchors", self._anchors(image_size), persistent=False)
        self._scale_anchors: Dict[tuple, torch.Tensor] = {}
        self.register_buffer("bbox_std", torch.tensor(bbox_std, dtype=torch.float32),
                             persistent=False)

    def _anchors(self, image_size: int) -> torch.Tensor:
        scales, ratios, strides, stride = self._anchor_spec
        shapes = [[int(math.ceil(image_size / s))] * 2 for s in strides]
        return torch.from_numpy(generate_pyramid_anchors(scales, ratios, shapes, strides, stride))

    def anchors_for(self, image_size: int) -> torch.Tensor:
        """The anchors of images molded to ``image_size``² (multi-scale
        testing): the model's own buffer at its configured size, else built
        once per size and device."""
        if image_size == self.image_size:
            return self.anchors
        key = (image_size, self.anchors.device)
        if key not in self._scale_anchors:
            self._scale_anchors[key] = self._anchors(image_size).to(self.anchors.device)
        return self._scale_anchors[key]

    @classmethod
    def from_config(cls, cfg, dtype: torch.dtype = torch.float32) -> "InterNet":
        """Build from a finalized Config (config.py), computing in ``dtype``."""
        return cls(
            backbone=cfg.MODEL.BACKBONE,
            num_classes=cfg.DATASET.NUM_CLASSES,
            image_size=int(cfg.DATA.IMAGE_MAX_DIM),
            anchor_scales=tuple(cfg.RPN.ANCHOR_SCALES),
            anchor_ratios=tuple(cfg.RPN.ANCHOR_RATIOS),
            anchor_stride=cfg.RPN.ANCHOR_STRIDE,
            strides=tuple(cfg.MODEL.BACKBONE_STRIDES),
            rpn_nms_threshold=cfg.RPN.NMS_THRESHOLD,
            pre_nms_limit=cfg.RPN.PRE_NMS_LIMIT,
            post_nms_inference=cfg.RPN.POST_NMS_ROIS_INFERENCE,
            pool_size=cfg.MRCNN.POOL_SIZE,
            mask_pool_size=cfg.MRCNN.MASK_POOL_SIZE,
            mask_shape=tuple(cfg.MRCNN.MASK_SHAPE),
            assign_base=cfg.ROIS.ASSIGN_ANCHOR_BASE,
            roi_method=cfg.ROIS.METHOD,
            roi_pool_window_cap=cfg.ROIS.WINDOW_CAP,
            bbox_std=tuple(float(x) for x in cfg.DATA.BBOX_STD_DEV),
            det_max_instances=cfg.TEST.DET_MAX_INSTANCES,
            det_nms_threshold=cfg.TEST.DET_NMS_THRESHOLD,
            det_min_confidence=float(cfg.TEST.DET_MIN_CONFIDENCE),
            dev_switch=cfg.DEV.SWITCH,
            dev_structure=cfg.DEV.STRUCTURE,
            dev_upsample_fac=cfg.DEV.UPSAMPLE_FAC,
            dev_upsample_init=cfg.DEV.UPSAMPLE_INIT,
            dev_upsample_residual=cfg.DEV.UPSAMPLE_RESIDUAL,
            dev_multi_upsampler=cfg.DEV.MULTI_UPSAMPLER,
            dev_dis_upsampler=cfg.DEV.DIS_UPSAMPLER,
            dev_assign_all_scale=cfg.DEV.ASSIGN_BOX_ON_ALL_SCALE,
            dev_feat_pool_size=cfg.DEV.FEAT_BRANCH_POOL_SIZE,
            cls_merge_feat=cfg.DEV.CLS_MERGE_FEAT,
            cls_merge_manner=cfg.DEV.CLS_MERGE_MANNER,
            cls_merge_fac=cfg.DEV.CLS_MERGE_FAC,
            post_nms_train=cfg.RPN.POST_NMS_ROIS_TRAINING,
            train_anchors_per_image=cfg.RPN.TRAIN_ANCHORS_PER_IMAGE,
            rpn_pos_thresh=cfg.RPN.TARGET_POS_THRES,
            rpn_neg_thresh=cfg.RPN.TARGET_NEG_THRES,
            rois_per_image=cfg.ROIS.TRAIN_ROIS_PER_IMAGE,
            positive_ratio=cfg.ROIS.ROI_POSITIVE_RATIO,
            use_mini_mask=cfg.MRCNN.USE_MINI_MASK,
            strict_quirks=bool(cfg.MODEL.STRICT_QUIRKS),
            dev_loss_choice=cfg.DEV.LOSS_CHOICE,
            dev_baseline=cfg.DEV.BASELINE,
            dev_big_supervise=cfg.DEV.BIG_SUPERVISE,
            dev_big_feat_detach=cfg.DEV.BIG_FEAT_DETACH,
            dev_ot_one_dim_form=cfg.DEV.OT_ONE_DIM_FORM,
            fpn_ot_loss=cfg.TRAIN.FPN_OT_LOSS,
            dtype=dtype,
        )

    def meta_ot(self, small: torch.Tensor, big: torch.Tensor,
                row_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The OT meta loss between the small and big per-class 1024-d sets
        [K, 1024] (float32), computed in the model's dtype: a scalar."""
        return self.ot_loss(small.to(self.dtype), big.to(self.dtype), row_weights)

    def _propose(self, rpn_probs, rpn_deltas, count: int,
                 image_size: Optional[int] = None) -> torch.Tensor:
        size = image_size or self.image_size
        return proposal_layer(
            rpn_probs.float(), rpn_deltas.float(), self.anchors_for(size), self.bbox_std,
            (size, size),
            pre_nms_limit=self.pre_nms_limit, proposal_count=count,
            nms_threshold=self.rpn_nms_threshold)

    def first_stage(self, images: torch.Tensor,
                    image_size: Optional[int] = None) -> Tuple[List[torch.Tensor], ...]:
        """images [B, S, S, 3] NHWC -> (pyramid [P2..P6] NCHW in the compute
        dtype, rpn_probs [B, A, 2] float32, rpn_deltas [B, A, 4], proposals
        [B, R, 4] normalised). ``image_size`` is S where it is not the
        configured size."""
        pyramid = self.fpn(images.to(self.dtype).permute(0, 3, 1, 2))
        _, rpn_probs, rpn_deltas = run_rpn_over_pyramid(self.rpn, pyramid)
        proposals = self._propose(rpn_probs, rpn_deltas, self.post_nms_inference, image_size)
        return pyramid, rpn_probs, rpn_deltas, proposals

    def second_stage(self, feats: List[torch.Tensor], proposals: torch.Tensor,
                     windows: torch.Tensor, with_masks: bool = True,
                     image_size: Optional[int] = None,
                     with_features: bool = False) -> Dict[str, torch.Tensor]:
        """P2..P5 (NCHW) and proposals -> {detections [B, M, 6],
        masks [B, M, 28, 28]} (masks: each detection's own class). With
        ``CLS_MERGE_FEAT`` every proposal is also pooled 14² for the critic,
        whose vectors join the classifier. ``with_features`` (the JAX
        ``mode="visualize"``) returns {detections, features [B, M, 1024]}
        in place of the masks: each detection's 1024-d penultimate
        classifier feature in float32, zero on the padding rows."""
        b, r, _ = proposals.shape
        size = image_size or self.image_size
        dev = self.dev_roi
        widths = [f.shape[3] for f in feats]
        maps = dev.pooling_maps(feats)
        lvl = dev.levels(proposals, widths, size)
        pooled = dev.pool(maps, proposals, self.pool_size, size, lvl)
        small = ()
        if self.classifier.merge_feat and not dev.baseline:
            small = dev.small_features(
                dev.pool(maps, proposals, self.mask_pool_size, size, lvl), proposals, size, lvl)
        _, probs, bbox, cls_feat = self.classifier(pooled, *small)
        detections, keep_idx, keep_valid = detection_layer(
            proposals, probs.reshape(b, r, self.num_classes),
            bbox.reshape(b, r, self.num_classes, 4), windows.float(),
            self.bbox_std, (size, size),
            max_instances=self.det_max_instances,
            nms_threshold=self.det_nms_threshold,
            min_confidence=self.det_min_confidence)
        if with_features:
            feat = cls_feat.reshape(b, r, -1)
            feat = torch.gather(feat, 1, keep_idx[..., None].expand(-1, -1, feat.shape[-1]))
            return {"detections": detections,
                    "features": feat * keep_valid[..., None].to(feat.dtype)}
        if not with_masks:
            return {"detections": detections}

        det_boxes = detections[..., :4] / float(size)
        masks = self.mask(dev.pool(maps, det_boxes, self.mask_pool_size, size,
                                   dev.levels(det_boxes, widths, size)))
        mh, mw = self.mask_shape
        masks = masks.reshape(b, self.det_max_instances, mh, mw, self.num_classes)
        # each detection's own class, selected on the device
        cls = detections[..., 4].to(torch.int64)[:, :, None, None, None]
        masks = torch.gather(masks, 4, cls.expand(-1, -1, mh, mw, 1))[..., 0]
        return {"detections": detections, "masks": masks}

    def forward_inference(self, images: torch.Tensor, windows: torch.Tensor,
                          with_masks: bool = True,
                          image_size: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """images [B, S, S, 3] molded NHWC; windows [B, 4] pixel
        (y1, x1, y2, x2) of each un-padded image. ``image_size`` is S for
        images molded to another size than the configured one (multi-scale
        testing, the JAX package's ``model.clone(image_size=...)``): that
        size's anchors, clipping and RoI levels, the same parameters."""
        pyramid, _, _, proposals = self.first_stage(images, image_size)
        return self.second_stage(pyramid[:4], proposals, windows, with_masks, image_size)

    def forward_visualize(self, images: torch.Tensor, windows: torch.Tensor,
                          image_size: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """The JAX ``mode="visualize"``: the inference forward without the
        mask pass, returning {detections [B, M, 6], features [B, M, 1024]
        float32} (:meth:`second_stage` with ``with_features``). The JAX
        package also runs the critic here when ``CLS_MERGE_FEAT`` is off,
        and its classifier discards the result; the port skips it."""
        pyramid, _, _, proposals = self.first_stage(images, image_size)
        return self.second_stage(pyramid[:4], proposals, windows, False, image_size,
                                 with_features=True)

    forward = forward_inference

    def forward_train(self, images: torch.Tensor, gt_class_ids: torch.Tensor,
                      gt_boxes: torch.Tensor, gt_masks: torch.Tensor,
                      generator: Optional[torch.Generator] = None,
                      draws: Optional[Dict[str, torch.Tensor]] = None,
                      train_bn: bool = False) -> Dict[str, torch.Tensor]:
        """images [B, S, S, 3] molded NHWC; gt_class_ids [B, G] (0 pad,
        < 0 crowd); gt_boxes [B, G, 4] pixels; gt_masks [B, G, mh, mw]
        (mini-masks or full).

        The targets' random subsets come from ``generator``, or from
        ``draws`` ({"rpn": [B, 2, A], "det": [B, 2, P]} uniform scores).
        ``train_bn``: BN learns batch statistics (module docstring).
        Returns the five losses, ``fpn_ot_loss`` [B, 3] (zeros without
        ``fpn_ot_loss``), ``positive_rois`` (sampled positives in the batch)
        and, with the intertwiner on, ``intertwiner`` (the Dev statistics,
        see :meth:`Dev.forward_train`); the buffer update and the meta loss
        are the train step's (``train/step.py``)."""
        with bn_learning(self, train_bn):
            return self._forward_train(images, gt_class_ids, gt_boxes, gt_masks, generator,
                                       draws)

    def _forward_train(self, images, gt_class_ids, gt_boxes, gt_masks, generator, draws):
        b = images.shape[0]
        pyramid, fpn_ot = self.fpn.forward_train(images.to(self.dtype).permute(0, 3, 1, 2))
        rpn_logits, rpn_probs, rpn_deltas = run_rpn_over_pyramid(self.rpn, pyramid)
        count = self.post_nms_inference if self.strict_quirks else self.post_nms_train
        draws = draws or {}
        with torch.no_grad():
            proposals = self._propose(rpn_probs, rpn_deltas, count)
            rpn_t = rpn_targets(
                self.anchors, gt_class_ids, gt_boxes, self.bbox_std,
                self.train_anchors_per_image, self.rpn_pos_thresh,
                self.rpn_neg_thresh, generator=generator, draws=draws.get("rpn"))
            det_t = detection_targets(
                proposals, gt_class_ids, gt_boxes / float(self.image_size),
                gt_masks, self.bbox_std, self.rois_per_image,
                self.positive_ratio, self.mask_shape, self.use_mini_mask,
                generator=generator, draws=draws.get("det"))

        pooled_cls, pooled_mask, stats = self.dev_roi.forward_train(
            pyramid[:4], det_t.rois, det_t.class_ids, self.pool_size,
            self.mask_pool_size)
        small = (stats["small_out"], stats["small_gt"]) if stats is not None else ()
        logits, _, bbox, _ = self.classifier(pooled_cls, *small)
        masks = self.mask(pooled_mask)
        r, k = self.rois_per_image, self.num_classes
        mh, mw = self.mask_shape
        out = {
            "rpn_class_loss": L.rpn_class_loss(rpn_t.match, rpn_logits),
            "rpn_bbox_loss": L.rpn_bbox_loss(rpn_t.deltas, rpn_t.match, rpn_deltas),
            "mrcnn_class_loss": L.mrcnn_class_loss(det_t.class_ids, logits.reshape(b, r, k)),
            "mrcnn_bbox_loss": L.mrcnn_bbox_loss(
                det_t.deltas, det_t.class_ids, bbox.reshape(b, r, k, 4)),
            "mrcnn_mask_loss": L.mrcnn_mask_loss(
                det_t.masks, det_t.class_ids, masks.reshape(b, r, mh, mw, k)),
            "fpn_ot_loss": fpn_ot,
            "positive_rois": det_t.pos_mask.sum(),
        }
        if stats is not None:
            out["intertwiner"] = stats
        return out

