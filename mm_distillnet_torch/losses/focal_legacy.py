"""Legacy focal-loss variant (port of mm_distillnet_tpu/losses/focal_legacy.py;
reference src/loss/FocalLoss.py:41-179).

It differs from the active YetAnotherFocalLoss (losses/focal.py): anchors
come in [x1, y1, x2, y2], regression targets are (dx, dy, dw, dh) divided by
the std table [0.1, 0.1, 0.2, 0.2], each anchor's GT row is gathered, and
the call returns (loss, regression_loss, classification_loss). The shipped
recipe uses losses.focal.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..ops.boxes import pairwise_iou_xyxy

ALPHA, GAMMA = 0.25, 2.0
STD = (0.1, 0.1, 0.2, 0.2)


def _per_image(classification, regression, annotations, anchors):
    """Batched over B: (B, N, C), (B, N, 4), (B, G, 5), anchors (N, 4)."""
    num_classes = classification.shape[-1]
    gt_valid = annotations[..., 4] != -1
    has_gt = gt_valid.any(dim=1)
    cls = classification.clamp(1e-4, 1.0 - 1e-4)

    neg_only = ((1.0 - ALPHA) * torch.pow(cls, GAMMA) *
                -torch.log(1.0 - cls)).sum(dim=(1, 2))

    iou = pairwise_iou_xyxy(anchors, annotations[..., :4])      # (B, N, G)
    iou = torch.where(gt_valid[:, None, :], iou, torch.full_like(iou, -1.0))
    iou_max = iou.amax(dim=2)
    assigned = torch.take_along_dim(annotations,
                                    iou.argmax(dim=2)[..., None], dim=1)
    positive = iou_max >= 0.5
    negative = iou_max < 0.4
    num_pos = positive.sum(dim=1).float()

    labels = assigned[..., 4].to(torch.int64).clamp(0, num_classes - 1)
    one_hot = torch.nn.functional.one_hot(labels, num_classes).float()
    targets = torch.where(positive[..., None], one_hot, 0.0)
    care = (positive | negative)[..., None]
    af = torch.where(targets == 1.0, ALPHA, 1.0 - ALPHA)
    fw = torch.where(targets == 1.0, 1.0 - cls, cls)
    bce = -(targets * torch.log(cls) + (1.0 - targets) * torch.log(1.0 - cls))
    cls_loss = torch.where(care, af * torch.pow(fw, GAMMA) * bce,
                           0.0).sum(dim=(1, 2))
    cls_loss = cls_loss / num_pos.clamp(min=1.0)

    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    acx = anchors[:, 0] + 0.5 * aw
    acy = anchors[:, 1] + 0.5 * ah
    gw = (assigned[..., 2] - assigned[..., 0]).clamp(min=1.0)
    gh = (assigned[..., 3] - assigned[..., 1]).clamp(min=1.0)
    gcx = assigned[..., 0] + 0.5 * (assigned[..., 2] - assigned[..., 0])
    gcy = assigned[..., 1] + 0.5 * (assigned[..., 3] - assigned[..., 1])
    std = torch.tensor(STD, device=anchors.device)
    t = torch.stack([(gcx - acx) / aw, (gcy - acy) / ah,
                     torch.log(gw / aw), torch.log(gh / ah)], dim=-1) / std
    diff = (t - regression).abs()
    rl = torch.where(diff <= 1.0 / 9.0, 0.5 * 9.0 * diff * diff,
                     diff - 0.5 / 9.0)
    reg_loss = torch.where(positive[..., None], rl, 0.0).sum(dim=(1, 2)) / \
        (num_pos * 4.0).clamp(min=1.0)
    reg_loss = torch.where(num_pos > 0, reg_loss, 0.0)
    return (torch.where(has_gt, reg_loss, 0.0),
            torch.where(has_gt, cls_loss, neg_only), has_gt)


def focal_loss_legacy(classification, regression, annotations, anchors_xyxy
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (loss, regression_loss, classification_loss)."""
    reg, cls, has = _per_image(classification.float(), regression.float(),
                               annotations.float(), anchors_xyxy.float())
    any_gt = has.any()
    reg_l = torch.where(any_gt, reg.mean(), 0.0)
    cls_l = torch.where(any_gt, cls.mean(), 0.0)
    return reg_l + cls_l, reg_l, cls_l
