"""InterNet at inference: the two-stage detector with the Feature Intertwiner.

Port of ``feature_intertwiner_tpu/models/detector.py``
(``InterNet.from_config`` and ``forward_inference``): ResNet-FPN backbone,
RPN, proposal layer, Dev, classifier, detection layer, then the mask pass
on the detections. The top-level module names follow the reference
checkpoints: ``fpn`` (with the backbone stages inside), ``rpn``,
``dev_roi``, ``classifier`` and ``mask``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
from torch import nn

from ..ops.anchors import generate_pyramid_anchors
from ..ops.detection import detection_layer
from ..ops.proposals import proposal_layer
from .fpn import FPN
from .heads import BoxHead, MaskHead
from .intertwiner import Dev
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
        bbox_std: tuple = (0.1, 0.1, 0.2, 0.2),
        det_max_instances: int = 100,
        det_nms_threshold: float = 0.3,
        det_min_confidence: float = 0.0,
        dev_switch: bool = False,
        dev_structure: str = "beta",
        dev_upsample_fac: float = 2.0,
        dev_upsample_residual: bool = False,
        dev_multi_upsampler: bool = False,
        dev_dis_upsampler: bool = False,
        dev_assign_all_scale: bool = False,
        dev_feat_pool_size: int = 14,
        cls_merge_feat: bool = False,
    ):
        super().__init__()
        if dev_switch and cls_merge_feat and dev_structure == "beta":
            raise NotImplementedError("DEV.CLS_MERGE_FEAT")
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

        self.fpn = FPN(ResNet(backbone), fpn_channels)
        self.rpn = RPNHead(len(anchor_ratios), anchor_stride, fpn_channels)
        self.dev_roi = Dev(
            channels=fpn_channels, image_size=image_size,
            assign_base=assign_base, use_dev=dev_switch,
            structure=dev_structure, roi_method=roi_method,
            upsample_fac=dev_upsample_fac,
            upsample_residual=dev_upsample_residual,
            multi_upsampler=dev_multi_upsampler,
            dis_upsampler=dev_dis_upsampler,
            assign_all_scale=dev_assign_all_scale,
            feat_pool_size=dev_feat_pool_size)
        self.classifier = BoxHead(num_classes, pool_size, fpn_channels)
        self.mask = MaskHead(num_classes, fpn_channels)

        shapes = [[int(math.ceil(image_size / s))] * 2 for s in strides]
        anchors = generate_pyramid_anchors(anchor_scales, anchor_ratios, shapes,
                                           strides, anchor_stride)
        self.register_buffer("anchors", torch.from_numpy(anchors), persistent=False)
        self.register_buffer("bbox_std", torch.tensor(bbox_std, dtype=torch.float32),
                             persistent=False)

    @classmethod
    def from_config(cls, cfg) -> "InterNet":
        """Build from a finalized Config (config.py)."""
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
            bbox_std=tuple(float(x) for x in cfg.DATA.BBOX_STD_DEV),
            det_max_instances=cfg.TEST.DET_MAX_INSTANCES,
            det_nms_threshold=cfg.TEST.DET_NMS_THRESHOLD,
            det_min_confidence=float(cfg.TEST.DET_MIN_CONFIDENCE),
            dev_switch=cfg.DEV.SWITCH,
            dev_structure=cfg.DEV.STRUCTURE,
            dev_upsample_fac=cfg.DEV.UPSAMPLE_FAC,
            dev_upsample_residual=cfg.DEV.UPSAMPLE_RESIDUAL,
            dev_multi_upsampler=cfg.DEV.MULTI_UPSAMPLER,
            dev_dis_upsampler=cfg.DEV.DIS_UPSAMPLER,
            dev_assign_all_scale=cfg.DEV.ASSIGN_BOX_ON_ALL_SCALE,
            dev_feat_pool_size=cfg.DEV.FEAT_BRANCH_POOL_SIZE,
            cls_merge_feat=cfg.DEV.CLS_MERGE_FEAT,
        )

    def first_stage(self, images: torch.Tensor) -> Tuple[List[torch.Tensor], ...]:
        """images [B, S, S, 3] NHWC -> (pyramid [P2..P6] NCHW, rpn_probs
        [B, A, 2], rpn_deltas [B, A, 4], proposals [B, R, 4] normalised)."""
        pyramid = self.fpn(images.permute(0, 3, 1, 2))
        _, rpn_probs, rpn_deltas = run_rpn_over_pyramid(self.rpn, pyramid)
        proposals = proposal_layer(
            rpn_probs.float(), rpn_deltas.float(), self.anchors, self.bbox_std,
            (self.image_size, self.image_size),
            pre_nms_limit=self.pre_nms_limit,
            proposal_count=self.post_nms_inference,
            nms_threshold=self.rpn_nms_threshold)
        return pyramid, rpn_probs, rpn_deltas, proposals

    def second_stage(self, feats: List[torch.Tensor], proposals: torch.Tensor,
                     windows: torch.Tensor,
                     with_masks: bool = True) -> Dict[str, torch.Tensor]:
        """P2..P5 (NCHW) and proposals -> {detections [B, M, 6],
        masks [B, M, 28, 28]} (masks: each detection's own class)."""
        b, r, _ = proposals.shape
        maps = self.dev_roi.pooling_maps(feats)
        pooled = self.dev_roi.pool(maps, proposals, self.pool_size)
        _, probs, bbox, _ = self.classifier(pooled)
        detections, _, _ = detection_layer(
            proposals, probs.reshape(b, r, self.num_classes),
            bbox.reshape(b, r, self.num_classes, 4), windows.float(),
            self.bbox_std, (self.image_size, self.image_size),
            max_instances=self.det_max_instances,
            nms_threshold=self.det_nms_threshold,
            min_confidence=self.det_min_confidence)
        if not with_masks:
            return {"detections": detections}

        det_boxes = detections[..., :4] / float(self.image_size)
        masks = self.mask(self.dev_roi.pool(maps, det_boxes, self.mask_pool_size))
        mh, mw = self.mask_shape
        masks = masks.reshape(b, self.det_max_instances, mh, mw, self.num_classes)
        # each detection's own class, selected on the device
        cls = detections[..., 4].to(torch.int64)[:, :, None, None, None]
        masks = torch.gather(masks, 4, cls.expand(-1, -1, mh, mw, 1))[..., 0]
        return {"detections": detections, "masks": masks}

    def forward_inference(self, images: torch.Tensor, windows: torch.Tensor,
                          with_masks: bool = True) -> Dict[str, torch.Tensor]:
        """images [B, S, S, 3] molded NHWC; windows [B, 4] pixel
        (y1, x1, y2, x2) of each un-padded image."""
        pyramid, _, _, proposals = self.first_stage(images)
        return self.second_stage(pyramid[:4], proposals, windows, with_masks)

    forward = forward_inference

