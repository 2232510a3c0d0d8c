"""Box decode, clipping and IoU (port of mm_distillnet_tpu/ops/boxes.py).

Decode matches YetAnotherEfficientDetBBoxTransform (reference
src/YetAnotherEfficientDet.py:574-602): anchors [y1,x1,y2,x2] + deltas
(dy, dx, dh, dw) -> [xmin, ymin, xmax, ymax]; clip keeps mins >= 0 and maxes
<= image_size (reference src/utils/utils.py:134-141).
"""
from __future__ import annotations

import torch


def decode_boxes(anchors: torch.Tensor, regression: torch.Tensor
                 ) -> torch.Tensor:
    """anchors (..., N, 4) [y1,x1,y2,x2]; regression (..., N, 4)
    -> (..., N, 4) [xmin, ymin, xmax, ymax]."""
    y_ctr_a = (anchors[..., 0] + anchors[..., 2]) / 2
    x_ctr_a = (anchors[..., 1] + anchors[..., 3]) / 2
    ha = anchors[..., 2] - anchors[..., 0]
    wa = anchors[..., 3] - anchors[..., 1]

    w = torch.exp(regression[..., 3]) * wa
    h = torch.exp(regression[..., 2]) * ha
    y_ctr = regression[..., 0] * ha + y_ctr_a
    x_ctr = regression[..., 1] * wa + x_ctr_a
    return torch.stack([x_ctr - w / 2., y_ctr - h / 2.,
                        x_ctr + w / 2., y_ctr + h / 2.], dim=-1)


def clip_boxes(boxes: torch.Tensor, image_size: float) -> torch.Tensor:
    """Clip xyxy boxes to [0, image_size]."""
    return torch.stack([
        boxes[..., 0].clamp(min=0.0),
        boxes[..., 1].clamp(min=0.0),
        boxes[..., 2].clamp(max=float(image_size)),
        boxes[..., 3].clamp(max=float(image_size)),
    ], dim=-1)


UNION_EPS = 1e-8   # pairwise_iou_xyxy's floor on the union


def pairwise_iou_xyxy(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU between xyxy boxes a (..., N, 4) and b (..., M, 4) -> (..., N, M)."""
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / union.clamp(min=UNION_EPS)


def iou_anchors_vs_gt(anchors_yxyx: torch.Tensor, gt_xyxy: torch.Tensor
                      ) -> torch.Tensor:
    """IoU between anchors (N, 4) in [y1,x1,y2,x2] and gt boxes (..., G, 4)
    in [x1,y1,x2,y2] -> (..., N, G). Matches calc_iou of the reference
    (src/loss/YetAnotherFocalLoss.py:6-20; union clamped at 1e-8)."""
    a = anchors_yxyx
    b = gt_xyxy[..., None, :, :]                              # (..., 1, G, 4)
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    iw = torch.minimum(a[:, 3, None], b[..., 2]) - \
        torch.maximum(a[:, 1, None], b[..., 0])
    ih = torch.minimum(a[:, 2, None], b[..., 3]) - \
        torch.maximum(a[:, 0, None], b[..., 1])
    iw = iw.clamp(min=0)
    ih = ih.clamp(min=0)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    union = (area_a[:, None] + area_b - iw * ih).clamp(min=1e-8)
    return iw * ih / union
