"""Pseudo-ground-truth from teacher predictions, in fixed shapes on the
device (port of mm_distillnet_tpu/distill/pseudo_labels.py).

  per teacher: decode + clip + conf/class filter + per-class NMS
               -> (B, max_det, 6) padded detections
  fusion:      concat across teachers -> class-AGNOSTIC NMS at IoU 0.5 (the
               cross-teacher fusion in the reference is plain nms over all
               boxes regardless of class, train_methods.py:139-143)
               -> drop scores -> (B, max_gt, 5) [x1,y1,x2,y2,label], padded
               with label -1.

Coordinates are floor()-truncated like the reference's int() conversion in
logits_to_ground_truth (src/utils/utils.py:286-318). `nms_fixed` is batched
over images, so the fusion needs no per-image map.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Sequence, Tuple

import torch

from .nms import _take, nms_fixed
from .postprocess import (Detections, detections_to_labels,
                               postprocess_detections)


class PseudoLabelConfig(NamedTuple):
    image_size: int
    conf_threshold: float = 0.3
    nms_threshold: float = 0.5
    fusion_iou: float = 0.5       # hardcoded 0.5 in the reference fusion
    num_candidates: int = 512
    max_det_per_teacher: int = 32
    max_gt: int = 64


def teacher_detections(classification: torch.Tensor, regression: torch.Tensor,
                       anchors: torch.Tensor, class_valid: torch.Tensor,
                       cfg: PseudoLabelConfig) -> Detections:
    return postprocess_detections(
        classification, regression, anchors, class_valid,
        image_size=cfg.image_size, conf_threshold=cfg.conf_threshold,
        nms_threshold=cfg.nms_threshold, num_candidates=cfg.num_candidates,
        max_detections=cfg.max_det_per_teacher)


def fuse_teacher_labels(per_teacher_labels: Sequence[torch.Tensor],
                        cfg: PseudoLabelConfig) -> torch.Tensor:
    """Fuse per-teacher padded label tensors into pseudo-ground-truth.

    per_teacher_labels: list of (B, max_det, 6) [x1,y1,x2,y2,score,label]
    with label -1 padding (from ops.postprocess.detections_to_labels).
    Returns (B, max_gt, 5) [x1,y1,x2,y2,label], label -1 padded, ordered by
    descending score among kept boxes."""
    cat = torch.cat(list(per_teacher_labels), dim=1)   # (B, T*max_det, 6)
    labels = cat[..., 5]
    idx, _, out_valid = nms_fixed(cat[..., :4], cat[..., 4], labels != -1,
                                  cfg.fusion_iou, cfg.max_gt)
    kept = _take(cat, idx)
    boxes = torch.where(out_valid[..., None], kept[..., :4],
                        torch.zeros_like(kept[..., :4]))
    lab = torch.where(out_valid, kept[..., 5],
                      torch.full_like(kept[..., 5], -1.0))
    return torch.cat([boxes, lab[..., None]], dim=-1)


def build_pseudo_labels(
        teacher_outputs: Dict[str, Tuple[torch.Tensor, torch.Tensor]],
        anchors: torch.Tensor, class_valid: torch.Tensor,
        pred_to_label: torch.Tensor, cfg: PseudoLabelConfig) -> torch.Tensor:
    """teacher_outputs: {modality: (classification, regression)}.
    Returns fused (B, max_gt, 5) pseudo-ground-truth."""
    per_teacher = []
    for cls_t, reg_t in teacher_outputs.values():
        dets = teacher_detections(cls_t, reg_t, anchors, class_valid, cfg)
        per_teacher.append(detections_to_labels(
            dets, pred_to_label, cfg.image_size, include_scores=True))
    return fuse_teacher_labels(per_teacher, cfg)
