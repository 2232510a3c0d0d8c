"""Fixed-shape greedy NMS, batched over images (port of
mm_distillnet_tpu/ops/nms.py).

Sort by score (stable, as `jnp.argsort` is), compute the KxK IoU matrix
once, then run the sequential greedy suppression as a loop over rows; each
step is one (B, K) vector op for the whole batch. Selection order matches
torchvision's `nms` for the top-K candidates. Inputs may be (K, ...) or
(B, K, ...); outputs follow.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..utils.profiling import span
from .boxes import pairwise_iou_xyxy

NEG_INF = -1e30


def _greedy_suppress(iou: torch.Tensor, valid: torch.Tensor,
                     iou_threshold: float) -> torch.Tensor:
    """Greedy NMS over boxes already sorted by descending score.

    iou (..., K, K); valid (..., K). Returns the keep mask (..., K)."""
    k = iou.shape[-1]
    later = torch.ones(k, k, dtype=torch.bool, device=iou.device).triu(1)
    over = (iou > iou_threshold) & later      # row i suppresses later rows
    keep = valid.clone()
    for i in range(k):
        # keep[i] implies valid[i]: keep starts at valid and only loses rows
        keep &= ~(over[..., i, :] & keep[..., i, None])
    return keep


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, K, ...) gathered along dim 1 by idx (B, M)."""
    if x.dim() == 2:
        return torch.gather(x, 1, idx)
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def nms_fixed(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
              iou_threshold: float, max_out: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Class-agnostic NMS with fixed output size.

    boxes (B?, K, 4) xyxy, scores (B?, K), valid (B?, K) bool. Returns
    (indices (B?, max_out), keep_scores, out_valid), indices into the
    inputs sorted by descending score."""
    if boxes.dim() == 2:
        out = nms_fixed(boxes[None], scores[None], valid[None],
                        iou_threshold, max_out)
        return tuple(o[0] for o in out)
    with span('mmd.nms'):
        masked = torch.where(valid, scores,
                             torch.full_like(scores, NEG_INF))
        order = torch.sort(-masked, dim=-1, stable=True).indices
        b = _take(boxes, order)
        v = _take(valid, order)
        keep = _greedy_suppress(pairwise_iou_xyxy(b, b), v, iou_threshold)

        keep_scores = torch.where(keep, _take(masked, order),
                                  torch.full_like(masked, NEG_INF))
        sel = torch.sort(-keep_scores, dim=-1,
                         stable=True).indices[:, :max_out]
        kscores = _take(keep_scores, sel)
        return _take(order, sel), kscores, kscores > NEG_INF / 2


def batched_class_nms_fixed(boxes: torch.Tensor, scores: torch.Tensor,
                            classes: torch.Tensor, valid: torch.Tensor,
                            iou_threshold: float, max_out: int,
                            coord_bound: float
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-class NMS via the class-offset trick (torchvision batched_nms
    semantics). coord_bound must exceed any box coordinate."""
    offsets = classes.to(boxes.dtype)[..., None] * coord_bound
    return nms_fixed(boxes + offsets, scores, valid, iou_threshold, max_out)
