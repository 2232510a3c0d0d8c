"""The comparisons that decide `correct`: what the timed path produced,
judged against the plain reference (PERF.md, "How correct is decided").

Detections (served, or a teacher's pseudo-label rows) are judged by one
number, `score_gap`, in the sigmoid's units: the larger of two means, one
for each direction of the comparison,

- over the judged detections: how far each score lies from the
  reference's, for its class, at the anchor whose reference box lies
  nearest to it;
- over the reference's detections: how far each score lies above the best
  score of the judged detections of its class that are near it (`near`),
  but no further than the reference's own distance to a decision that
  would drop it: the confidence threshold; where the judged list is full,
  its lowest score (the cap); where the judged frame has any detection,
  the anchor's best other class (only an anchor whose best class is valid
  is kept) and the candidate cut (only the `num_candidates` best anchors
  enter NMS).

It stays small where a rounding tips one of the post-process's decisions
the other way, where a count of matches would not; a lower precision moves
every score, and a detection that is missing, altered or another frame's
moves its own. Boxes clipped whole outside the frame are left out on both
sides.

A training step is judged by its losses, its first gradient and its
parameters' change, leaf by leaf, by the gap of norms.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, List, Mapping, Sequence, Tuple

import torch

from .reference.boxes import pairwise_iou_xyxy

MATCH_IOU = 0.4
# boxes whose IoU rounding tips are also near where every coordinate is
# within this share of the larger side (at least MIN_SIDE px)
NEAR_SHARE = 0.1
MIN_SIDE = 16.0
TIE_PX = 1.0
# a leaf whose first reference gradient is below this share of the median
# leaf's is nought to rounding (a bias that a train-mode BN cancels): its
# change under Adam is round-off, and it is left out of the leaf gaps
NOUGHT_SHARE = 1e-3


def near(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, M) bool: boxes a (N, 4) and b (M, 4) that describe one object,
    at IoU MATCH_IOU or more, or with every coordinate within NEAR_SHARE
    of b's larger side."""
    side = torch.maximum((b[:, 2] - b[:, 0]).abs(), (b[:, 3] - b[:, 1]).abs())
    tol = NEAR_SHARE * side.clamp(min=MIN_SIDE)
    close = (a[:, None] - b[None]).abs().amax(-1) <= tol[None]
    return close | (pairwise_iou_xyxy(a, b) >= MATCH_IOU)


def has_area(boxes: torch.Tensor) -> torch.Tensor:
    """Boxes (..., 4) xyxy that cover some of the image. One that the
    post-process clipped whole (a maximum at or below its minimum) lies
    outside the frame and says nothing about it: the gaps leave it out."""
    return (boxes[..., 2] > boxes[..., 0]) & (boxes[..., 3] > boxes[..., 1])


def detection_gaps(boxes: torch.Tensor, scores: torch.Tensor,
                   classes: torch.Tensor, valid: torch.Tensor,
                   ref_scores: torch.Tensor, ref_boxes: torch.Tensor,
                   ref_dets, class_valid: torch.Tensor,
                   conf_threshold: float, num_candidates: int, max_det: int
                   ) -> Dict[str, float]:
    """`score_gap` over frames, with diagnostics beside it. boxes (N, K,
    4) xyxy, scores (N, K), classes (N, K) prediction ids, valid (N, K):
    the judged detections.
    ref_scores (N, A, C), ref_boxes (N, A, 4): the reference's scores and
    decoded boxes at every anchor; ref_dets: its post-processed
    detections, (boxes, scores, classes, valid) as above; class_valid
    (C,) bool."""
    ref_boxes_all, ref_scores_all, ref_classes_all, ref_valid = ref_dets
    class_valid = class_valid.bool()
    overs, misses, anchor_gaps, frame_gaps = [], [], [], []
    for n in range(boxes.shape[0]):
        frame_served = frame_missed = None
        full = int(valid[n].sum()) >= max_det
        v = valid[n].bool() & has_area(boxes[n])
        b, s, c = boxes[n][v].float(), scores[n][v].float(), \
            classes[n][v].long()
        anchors_s = ref_scores[n].float()                       # (A, C)
        anchors_b = ref_boxes[n].float()                        # (A, 4)
        if b.shape[0]:
            cls_scores = anchors_s[:, c].T                      # (K, A)
            support = torch.where(near(b, anchors_b), cls_scores,
                                  torch.zeros_like(cls_scores)).amax(1)
            overs.append(s - support)
            # the score against the reference's at the anchor whose
            # reference box lies nearest (within TIE_PX of the nearest: the
            # closest score, as floor()ed label rows tie)
            dist = (anchors_b[None] - b[:, None]).abs().amax(-1)   # (K, A)
            tied = dist <= dist.amin(1, keepdim=True) + TIE_PX
            diff = (s[:, None] - cls_scores).abs()
            frame_served = torch.where(
                tied, diff, torch.full_like(diff, float('inf'))).amin(1)
            anchor_gaps.append(frame_served)
        rv = ref_valid[n].bool() & has_area(ref_boxes_all[n])
        rb, rs, rc = ref_boxes_all[n][rv].float(), \
            ref_scores_all[n][rv].float(), ref_classes_all[n][rv].long()
        if rb.shape[0] == 0:
            frame_gaps.append(_frame_gap(frame_served, frame_missed))
            continue
        floor = conf_threshold
        if full:
            floor = max(floor, float(scores[n][valid[n].bool()].min()))
        support = torch.full_like(rs, floor)
        if b.shape[0]:
            match = near(b, rb).T & (rc[:, None] == c[None])    # (R, K)
            found = torch.where(match, s[None].expand_as(match),
                                torch.zeros_like(s)[None].expand_as(match))
            support = torch.maximum(support, found.amax(1))
        # the reference's own distance to a decision that drops r
        at = (anchors_b[None] - rb[:, None]).abs().amax(-1).argmin(1)
        own = anchors_s[at]                                      # (R, C)
        others = own.scatter(1, rc[:, None], float('-inf')).amax(1)
        best = anchors_s.amax(1)
        winner_ok = class_valid[anchors_s.argmax(1)] & \
            (best > conf_threshold)
        kept = torch.where(winner_ok, best, torch.zeros_like(best))
        cut = torch.topk(kept, min(num_candidates, kept.numel())).values[-1]
        frame_missed = rs - support
        if b.shape[0]:
            # rounding that tips a decision puts another detection in r's
            # place; a frame answered with none has no such decision
            frame_missed = torch.minimum(
                frame_missed, torch.minimum(rs - others, rs - cut))
        misses.append(frame_missed)
        frame_gaps.append(_frame_gap(frame_served, frame_missed))
    served, missed = _cat(anchor_gaps), _cat(misses).clamp(min=0)
    served_mean = float(served.mean()) if served.numel() else 0.0
    missed_mean = float(missed.mean()) if missed.numel() else 0.0
    over = _cat(overs)
    return {'score_gap': max(served_mean, missed_mean),
            'served_mean': served_mean, 'missed_mean': missed_mean,
            'over_max': float(over.max()) if over.numel() else 0.0,
            'missed_max': float(missed.max()) if missed.numel() else 0.0,
            'frame_gaps': frame_gaps}


def _frame_gap(served, missed) -> float:
    """One frame's score_gap: the larger of its two means."""
    out = 0.0
    if served is not None and served.numel():
        out = float(served.mean())
    if missed is not None and missed.numel():
        out = max(out, float(missed.clamp(min=0).mean()))
    return out


def _cat(vals: List[torch.Tensor]) -> torch.Tensor:
    return torch.cat(vals) if vals else torch.zeros(0)


def leaf_gap(side: Mapping[str, float], ref: Mapping[str, float],
             leaves: Sequence[str]) -> float:
    """The worst leaf's gap of norms: |side - ref| over the larger of the
    reference's norm of that leaf and of the median leaf. A leaf the side
    does not report reads 0 (an optimizer that never stepped)."""
    median = statistics.median(ref[k] for k in leaves)
    return max(abs(side.get(k, 0.0) - ref[k]) / max(ref[k], median, 1e-30)
               for k in leaves)


def median_leaf_gap(side: Mapping[str, float], ref: Mapping[str, float],
                    leaves: Sequence[str]) -> float:
    """The median over leaves of leaf_gap's ratio: steady where single
    small leaves are not (a leaf whose gradient changes sign from step to
    step has an Adam update that rounding moves by a fifth)."""
    median = statistics.median(ref[k] for k in leaves)
    return statistics.median(
        abs(side.get(k, 0.0) - ref[k]) / max(ref[k], median, 1e-30)
        for k in leaves)


def moving_leaves(ref_grad_norms: Mapping[str, float]) -> List[str]:
    """The leaves whose first reference gradient is not nought to
    rounding (NOUGHT_SHARE of the median leaf's)."""
    median = statistics.median(ref_grad_norms.values())
    return [k for k, g in ref_grad_norms.items() if g >= NOUGHT_SHARE * median]


def norms(tensors: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(t.double().norm()) for k, t in tensors.items()}


def label_rows_as_detections(rows: torch.Tensor, label_to_pred: Mapping):
    """(boxes, scores, classes, valid) of padded label rows (B, K, 6). A
    row whose box has no area (clamped to the image edge whole) is left
    out by detection_gaps: no anchor overlaps it, so the focal loss assigns
    it nothing."""
    labels = rows[..., 5].long()
    pred = torch.full_like(labels, 0)
    for label, pid in label_to_pred.items():
        pred = torch.where(labels == label, torch.full_like(labels, pid),
                           pred)
    return rows[..., :4], rows[..., 4], pred, labels >= 0


def judge(values: Mapping[str, float], limits: Mapping[str, float]
          ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """(correct, {name: {'value', 'limit'}}): every number finite and at
    or under its limit. A number without a limit is printed, not held."""
    out, ok = {}, True
    for name, value in values.items():
        limit = limits.get(name)
        out[name] = {'value': value, 'limit': limit}
        if not math.isfinite(value):
            ok = False
        elif limit is not None and value > limit:
            ok = False
    return ok, out
