"""Focal detection loss, batched over the images in fixed shapes (port of
mm_distillnet_tpu/losses/focal.py).

Semantics of YetAnotherFocalLoss (reference
src/loss/YetAnotherFocalLoss.py:23-190) on a dense (B, MAX_GT, 5)
annotation tensor padded with label -1 rows:

- IoU bands: positive >= 0.5, ignore (0.4, 0.5), negative < 0.4;
- alpha 0.25, gamma 2 focal BCE on sigmoid scores clamped to
  [1e-4, 1 - 1e-4]; the classification sum is divided by clamp(num_pos, 1);
- an image without annotations gets the negatives-only classification loss
  (sum over all anchors and classes of (1 - alpha) p^gamma -log(1 - p)) and
  zero regression loss;
- regression: smooth-L1 (beta 1/9) on (dy, dx, dh, dw) targets against the
  anchors, gt w/h clamped to >= 1, averaged over the positive anchors;
- batch reduction: the mean over images; both losses are exactly 0 when no
  image of the batch has an annotation.

Each anchor's GT row is selected by a one-hot (N, G) x (G, 5) contraction
in fp32, not a gather, as in the JAX package. With `logits=` the
classification term is computed in logit space through the softplus
identity -log(sigmoid(-y)) = softplus(y): the same values inside the clamp
band. The chain runs in fp32 whatever the model's dtype.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from .boxes import iou_anchors_vs_gt

ALPHA = 0.25
GAMMA = 2.0
CLS_CLAMP = 1e-4
# the probability clamp in logit space: clamp(sigmoid(x), c, 1 - c) ==
# sigmoid(clamp(x, -X, X)) with X = logit(1 - c)
LOGIT_CLAMP = float(math.log((1.0 - CLS_CLAMP) / CLS_CLAMP))
SMOOTH_L1_BETA = 1.0 / 9.0


def _pow_gamma(x: torch.Tensor) -> torch.Tensor:
    """x ** GAMMA, a plain product for the shipped gamma 2."""
    return x * x if GAMMA == 2.0 else torch.pow(x, GAMMA)


def _smooth_l1(diff: torch.Tensor) -> torch.Tensor:
    ad = diff.abs()
    return torch.where(ad <= SMOOTH_L1_BETA, 0.5 * 9.0 * ad * ad,
                       ad - 0.5 / 9.0)


def _per_image_loss(cls_in: torch.Tensor, regression: torch.Tensor,
                    annotations: torch.Tensor, anchors: torch.Tensor,
                    from_logits: bool
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """cls_in (B, N, C) sigmoid scores, or pre-sigmoid logits when
    from_logits; regression (B, N, 4); annotations (B, G, 5)
    [x1,y1,x2,y2,label] with label -1 padding; anchors (N, 4) [y1,x1,y2,x2].
    Returns per-image (reg_loss, cls_loss, has_annotations), each (B,)."""
    num_classes = cls_in.shape[-1]
    gt_valid = annotations[..., 4] != -1                       # (B, G)
    has_gt = gt_valid.any(dim=1)

    if from_logits:
        x = cls_in.clamp(-LOGIT_CLAMP, LOGIT_CLAMP)
        neg_only = ((1.0 - ALPHA) * _pow_gamma(torch.sigmoid(x)) *
                    F.softplus(x)).sum(dim=(1, 2))
    else:
        p = cls_in.clamp(CLS_CLAMP, 1.0 - CLS_CLAMP)
        neg_only = ((1.0 - ALPHA) * _pow_gamma(p) * -torch.log(1.0 - p)
                    ).sum(dim=(1, 2))

    iou = iou_anchors_vs_gt(anchors, annotations[..., :4])    # (B, N, G)
    # invalid gt rows never win the argmax
    iou = torch.where(gt_valid[:, None, :], iou, torch.full_like(iou, -1.0))
    iou_max = iou.amax(dim=2)
    iou_argmax = iou.argmax(dim=2)      # the first maximum, as jnp.argmax
    assign_oh = F.one_hot(iou_argmax, annotations.shape[1]).float()
    assigned = torch.bmm(assign_oh, annotations)              # (B, N, 5)
    positive = iou_max >= 0.5
    negative = iou_max < 0.4
    num_pos = positive.sum(dim=1).float().clamp(min=1.0)

    labels = assigned[..., 4].to(torch.int32).clamp(0, num_classes - 1)
    class_iota = torch.arange(num_classes, dtype=torch.int32,
                              device=cls_in.device)
    target_is_one = positive[..., None] & (labels[..., None] == class_iota)
    care = (positive | negative)[..., None]
    alpha_factor = torch.where(target_is_one, ALPHA, 1.0 - ALPHA)
    if from_logits:
        y = torch.where(target_is_one, -x, x)
        cls_each = alpha_factor * _pow_gamma(torch.sigmoid(y)) * \
            F.softplus(y)
    else:
        targets = target_is_one.float()
        focal_weight = torch.where(target_is_one, 1.0 - p, p)
        bce = -(targets * torch.log(p) + (1.0 - targets) * torch.log(1.0 - p))
        cls_each = alpha_factor * _pow_gamma(focal_weight) * bce
    cls_full = torch.where(care, cls_each, 0.0).sum(dim=(1, 2)) / num_pos

    anchor_h = anchors[:, 2] - anchors[:, 0]
    anchor_w = anchors[:, 3] - anchors[:, 1]
    anchor_cy = anchors[:, 0] + 0.5 * anchor_h
    anchor_cx = anchors[:, 1] + 0.5 * anchor_w
    gt_w = (assigned[..., 2] - assigned[..., 0]).clamp(min=1.0)
    gt_h = (assigned[..., 3] - assigned[..., 1]).clamp(min=1.0)
    gt_cx = assigned[..., 0] + 0.5 * (assigned[..., 2] - assigned[..., 0])
    gt_cy = assigned[..., 1] + 0.5 * (assigned[..., 3] - assigned[..., 1])
    reg_targets = torch.stack([(gt_cy - anchor_cy) / anchor_h,
                               (gt_cx - anchor_cx) / anchor_w,
                               torch.log(gt_h / anchor_h),
                               torch.log(gt_w / anchor_w)], dim=-1)
    reg_each = _smooth_l1(reg_targets - regression).sum(dim=-1) / 4.0
    reg_full = torch.where(positive, reg_each, 0.0).sum(dim=1) / num_pos
    reg_full = torch.where(positive.any(dim=1), reg_full, 0.0)

    cls_loss = torch.where(has_gt, cls_full, neg_only)
    reg_loss = torch.where(has_gt, reg_full, 0.0)
    return reg_loss, cls_loss, has_gt


def focal_loss(classification: torch.Tensor, regression: torch.Tensor,
               annotations: torch.Tensor, anchors: torch.Tensor,
               logits: Optional[torch.Tensor] = None,
               reduce_any: Optional[Callable[[torch.Tensor],
                                             torch.Tensor]] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """classification (B, N, C) sigmoid scores, regression (B, N, 4),
    annotations (B, MAX_GT, 5) padded with -1 labels, anchors (N, 4). With
    `logits` (the pre-sigmoid scores) the classification term comes from
    them and `classification` is not read. Returns (regression_loss,
    classification_loss), batch means, exactly 0 when no image has an
    annotation. A batch split over processes passes `reduce_any`
    (parallel.mesh.global_any): "no image has an annotation" is then
    decided over the whole batch, as for one batch on one device."""
    from_logits = logits is not None
    cls_in = (logits if from_logits else classification).float()
    reg, cls, has_gt = _per_image_loss(
        cls_in, regression.float(), annotations.float(), anchors.float(),
        from_logits)
    any_gt = has_gt.any()
    if reduce_any is not None:
        any_gt = reduce_any(any_gt)
    return (torch.where(any_gt, reg.mean(), 0.0),
            torch.where(any_gt, cls.mean(), 0.0))
