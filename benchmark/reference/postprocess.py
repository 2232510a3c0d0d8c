"""Fixed-shape detection post-processing (port of
mm_distillnet_tpu/ops/postprocess.py, the packed path).

Decode deltas against the anchors, clip to the image, per-anchor confidence
filter, class-validity mask, per-class NMS; the result is (B, max_det)
tensors plus a validity mask. The per-anchor (score, class) pair is packed
into one int32 (quantised score in the high 24 bits, class id in the low
5), so one max and one sort select the candidates, and candidate anchors
are computed from their indices.

Candidate selection is exact: the packed keys, biased by 2^23 and bit-cast
to float32 (order-preserving), go through a stable descending sort, which
breaks ties toward the lower index as `jax.lax.top_k` does. The reference's
`approx=True` routes the same biased keys through `jax.lax.approx_max_k`,
which is approximate on a TPU only: elsewhere it computes the exact top-k
(its values and indices equal `lax.top_k`'s), so here `approx=True` takes
the exact selection.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from .anchors import anchors_from_indices
from .boxes import clip_boxes, decode_boxes
from .nms import NEG_INF, _take, batched_class_nms_fixed


class Detections(NamedTuple):
    """Boxes xyxy in pixels, prediction-space class ids, validity mask."""
    boxes: torch.Tensor    # (B, max_det, 4)
    scores: torch.Tensor   # (B, max_det)
    classes: torch.Tensor  # (B, max_det) int32
    valid: torch.Tensor    # (B, max_det) bool


def class_validity_table(num_classes: int,
                         valid_prediction_ids: Sequence[int],
                         ignore_labels: Sequence[int] = ()) -> np.ndarray:
    """Boolean LUT over class ids (reference src/utils/utils.py:196-204)."""
    table = np.zeros((num_classes,), dtype=bool)
    for cid in valid_prediction_ids:
        table[cid] = True
    for cid in ignore_labels:
        table[cid] = False
    return table


_SCORE_BITS = 24
_CLASS_BITS = 5  # up to 32 classes packed below the quantised score
_BIAS = 1 << 23


def postprocess_detections(classification: torch.Tensor,
                           regression: torch.Tensor,
                           anchors: torch.Tensor,
                           class_valid: torch.Tensor,
                           *,
                           image_size: int,
                           conf_threshold: float = 0.3,
                           nms_threshold: float = 0.5,
                           num_candidates: int = 512,
                           max_detections: int = 100,
                           approx: bool = False) -> Detections:
    """classification (B, N, C) sigmoid scores; regression (B, N, 4);
    anchors (N, 4) [y1,x1,y2,x2] (kept for the reference's signature: the
    packed path computes candidate anchors from indices); class_valid (C,)
    bool LUT. `approx` is the reference's switch to `approx_max_k`, exact
    off the TPU: both values select the same candidates here."""
    del approx
    classification = classification.float()
    regression = regression.float()
    n_cls = classification.shape[-1]
    if n_cls > (1 << _CLASS_BITS):
        raise ValueError(f'packed post-processing takes <= 32 classes, '
                         f'got {n_cls}')
    csize = float(image_size)
    dev = classification.device

    # float -> int32 truncates toward zero, as astype does
    q = (classification * float(1 << _SCORE_BITS)).to(torch.int32)
    cls_ids = torch.arange(n_cls, dtype=torch.int32, device=dev)
    packed = (q << _CLASS_BITS) | cls_ids                 # (B, N, C)
    overall = packed.amax(dim=-1)                         # (B, N)
    ok = (classification > conf_threshold) & class_valid.to(dev, torch.bool)
    minus1 = torch.full_like(packed, -1)
    best_ok = torch.where(ok, packed, minus1).amax(dim=-1)
    # the anchor is dropped, never reassigned, when its overall winner is
    # below the threshold or class-invalid
    masked = torch.where(best_ok == overall, best_ok, torch.full_like(best_ok, -1))

    shifted = torch.where(masked >= 0, masked + _BIAS,
                          torch.zeros_like(masked))
    as_f32 = shifted.view(torch.float32)
    top_f, top_idx = torch.sort(as_f32, dim=-1, descending=True, stable=True)
    top_biased = top_f[:, :num_candidates].contiguous().view(torch.int32)
    top_idx = top_idx[:, :num_candidates]
    cand_valid = top_biased >= _BIAS
    top_packed = torch.where(cand_valid, top_biased - _BIAS,
                             torch.zeros_like(top_biased))
    top_scores = (top_packed >> _CLASS_BITS).float() / float(1 << _SCORE_BITS)
    top_scores = torch.where(cand_valid, top_scores,
                             torch.full_like(top_scores, NEG_INF))
    top_classes = torch.where(cand_valid,
                              top_packed & ((1 << _CLASS_BITS) - 1),
                              torch.zeros_like(top_packed))
    cand_anchors = anchors_from_indices(top_idx, image_size)

    boxes = clip_boxes(decode_boxes(cand_anchors, _take(regression, top_idx)),
                       csize)
    sel, kscores, kvalid = batched_class_nms_fixed(
        boxes, top_scores, top_classes, cand_valid, nms_threshold,
        max_detections, coord_bound=csize + 1.0)
    out_scores = torch.where(kvalid, kscores, torch.zeros_like(kscores))
    out_classes = torch.where(kvalid, _take(top_classes, sel),
                              torch.full_like(sel, -1).to(torch.int32))
    return Detections(_take(boxes, sel), out_scores,
                      out_classes.to(torch.int32), kvalid)


def detections_to_labels(dets: Detections, pred_to_label: torch.Tensor,
                         image_size: int,
                         include_scores: bool = True) -> torch.Tensor:
    """Padded pseudo-ground-truth rows (reference src/utils/utils.py:286-318):
    coordinates floor-truncated and re-clipped, prediction-space classes
    mapped to label space by `pred_to_label` (a (C,) int LUT), invalid rows
    zeroed with label -1. Returns (B, max_det, 6) [x1, y1, x2, y2, score,
    label], or (B, max_det, 5) without the score."""
    b = torch.floor(dets.boxes)
    cols = [b[..., i].clamp(0, image_size) for i in range(4)]
    if include_scores:
        cols.append(dets.scores)
    safe_cls = dets.classes.clamp(0, pred_to_label.shape[0] - 1).long()
    labels = pred_to_label.to(dets.boxes.device)[safe_cls].float()
    cols.append(torch.where(dets.valid, labels, torch.full_like(labels, -1.)))
    out = torch.stack(cols, dim=-1)
    pad = torch.zeros_like(out)
    pad[..., -1] = -1.0
    return torch.where(dets.valid[..., None], out, pad)
