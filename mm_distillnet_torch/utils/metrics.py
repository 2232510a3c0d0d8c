"""Evaluation metrics (port of mm_distillnet_tpu/utils/metrics.py;
host-side numpy). `get_batch_statistics` assigns the true positives of an
image with [x1, y1, x2, y2, score, label] rows through the native host
kernel (utils/native.py); `get_batch_statistics_reference` is its numpy
route, the plain version.

Same semantics as the reference's YOLOv3-style metric stack
(reference src/utils/utils.py:993-1280):
- get_batch_statistics: per-sample TP assignment at an IoU threshold, with
  the +1 pixel convention in bbox_iou (utils.py:1139-1185) and the
  greedy first-come matching over score-ordered predictions;
- ap_per_class / compute_ap: PR-curve envelope AP per class
  (utils.py:1188-1280);
- get_batch_central_distances: CDx/CDy greedy closest-point matching on
  (width, height) vectors per arXiv:1910.11760 (utils.py:993-1055).

Inputs are per-image lists of [x1, y1, x2, y2, score, label] (predictions)
and [x1, y1, x2, y2, label] (targets): the shapes the fixed-size device
detections are unpadded into on the host.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def bbox_iou_plus1(box: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """IoU of one box vs many with the reference's +1 area convention."""
    x1 = np.maximum(box[0], boxes[:, 0])
    y1 = np.maximum(box[1], boxes[:, 1])
    x2 = np.minimum(box[2], boxes[:, 2])
    y2 = np.minimum(box[3], boxes[:, 3])
    inter = np.clip(x2 - x1 + 1, 0, None) * np.clip(y2 - y1 + 1, 0, None)
    area1 = (box[2] - box[0] + 1) * (box[3] - box[1] + 1)
    area2 = (boxes[:, 2] - boxes[:, 0] + 1) * (boxes[:, 3] - boxes[:, 1] + 1)
    return inter / (area1 + area2 - inter + 1e-16)


def get_batch_statistics(outputs: Sequence, targets: Sequence,
                         iou_threshold: float) -> List:
    """Returns per-image [true_positives, scores, pred_labels] triples; the
    TP assignment of prediction rows with scores runs natively."""
    return _batch_statistics(outputs, targets, iou_threshold, True)


def get_batch_statistics_reference(outputs: Sequence, targets: Sequence,
                                   iou_threshold: float) -> List:
    """`get_batch_statistics` in numpy only (the plain version)."""
    return _batch_statistics(outputs, targets, iou_threshold, False)


def _batch_statistics(outputs: Sequence, targets: Sequence,
                      iou_threshold: float, use_native: bool) -> List:
    from . import native

    batch_metrics = []
    for sample_i in range(len(outputs)):
        output = np.asarray(outputs[sample_i], dtype=np.float64)
        if output.size == 0:
            continue
        target = np.asarray(targets[sample_i], dtype=np.float64)
        if target.size == 0:
            continue
        if use_native and output.ndim == 2 and output.shape[1] >= 6:
            tp = native.batch_statistics_tp(output, target[:, :5],
                                            iou_threshold)
            batch_metrics.append([tp.astype(np.float64), output[:, 4],
                                  output[:, -1]])
            continue
        pred_boxes = output[:, :4]
        pred_scores = output[:, 4]
        pred_labels = output[:, -1]
        target_boxes = target[:, :4]
        target_labels = target[:, -1]

        true_positives = np.zeros(len(pred_boxes))
        detected = []
        for pred_i in range(len(pred_boxes)):
            if len(detected) == len(target_boxes):
                break
            if pred_labels[pred_i] not in target_labels:
                continue
            ious = bbox_iou_plus1(pred_boxes[pred_i], target_boxes)
            box_index = int(np.argmax(ious))
            if ious[box_index] >= iou_threshold and box_index not in detected:
                true_positives[pred_i] = 1
                detected.append(box_index)
        batch_metrics.append([true_positives, pred_scores, pred_labels])
    return batch_metrics


def compute_ap(recall: np.ndarray, precision: np.ndarray) -> float:
    """Precision-envelope AP (reference src/utils/utils.py:1255-1280)."""
    mrec = np.concatenate(([0.0], recall, [1.0]))
    mpre = np.concatenate(([0.0], precision, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = np.maximum(mpre[i - 1], mpre[i])
    i = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[i + 1] - mrec[i]) * mpre[i + 1]))


def ap_per_class(tp: np.ndarray, conf: np.ndarray, pred_cls: np.ndarray,
                 target_cls: np.ndarray):
    """Returns (p, r, ap, f1, unique_classes, pred_to_gt_ratio)."""
    order = np.argsort(-conf)
    tp, conf, pred_cls = tp[order], conf[order], pred_cls[order]
    unique_classes = np.unique(target_cls)

    ap, p, r = [], [], []
    total_gt, total_p = 0.0, 0.0
    for c in unique_classes:
        sel = pred_cls == c
        n_gt = int((target_cls == c).sum())
        n_p = int(sel.sum())
        total_gt += n_gt
        total_p += n_p
        if n_p == 0 and n_gt == 0:
            continue
        if n_p == 0 or n_gt == 0:
            ap.append(0.0)
            r.append(0.0)
            p.append(0.0)
            continue
        fpc = (1 - tp[sel]).cumsum()
        tpc = tp[sel].cumsum()
        recall_curve = tpc / (n_gt + 1e-16)
        precision_curve = tpc / (tpc + fpc)
        r.append(recall_curve[-1])
        p.append(precision_curve[-1])
        ap.append(compute_ap(recall_curve, precision_curve))

    p, r, ap = np.array(p), np.array(r), np.array(ap)
    f1 = 2 * p * r / (p + r + 1e-16)
    ratio = total_p / total_gt if total_gt else 0.0
    return p, r, ap, f1, unique_classes.astype('int32'), ratio


def _closest_point(point: np.ndarray, candidates: np.ndarray) -> int:
    d = np.sum((candidates - point) ** 2, axis=1)
    return int(np.argmin(d))


def get_batch_central_distances(outputs: Sequence, targets: Sequence,
                                width: float, height: float
                                ) -> Tuple[List[float], List[float]]:
    """CDx/CDy: normalized distance between predicted and target (w, h)
    vectors, greedy closest-point matching per class; an unmatched target
    contributes its own size (the zero-prediction penalty)."""
    cd_x, cd_y = [], []
    for sample_i in range(len(outputs)):
        target = np.asarray(targets[sample_i], dtype=np.float64)
        if target.size == 0:
            continue
        target_point = target[:, 2:4] - target[:, 0:2]
        target_labels = target[:, -1]

        output = np.asarray(outputs[sample_i], dtype=np.float64)
        if output.size == 0:
            pred_labels = np.zeros_like(target_labels)
            output_point = np.zeros_like(target_point)
        else:
            pred_labels = output[:, -1].copy()
            output_point = output[:, 2:4] - output[:, 0:2]

        dx, dy = [], []
        for i in range(len(target_point)):
            label = target_labels[i]
            mask = pred_labels == label
            valid_points = output_point[mask]
            orig_idx = np.arange(len(pred_labels))[mask]
            if len(valid_points) < 1:
                dx.append(target_point[i, 0])
                dy.append(target_point[i, 1])
            else:
                j = _closest_point(target_point[i], valid_points)
                pred_labels[orig_idx[j]] = -1  # consume the match
                dx.append(abs(target_point[i, 0] - valid_points[j, 0]))
                dy.append(abs(target_point[i, 1] - valid_points[j, 1]))
        cd_x.append(float(np.mean(dx)) / width)
        cd_y.append(float(np.mean(dy)) / height)
    return cd_x, cd_y


def detections_to_lists(boxes: np.ndarray, scores: np.ndarray,
                        classes: np.ndarray, valid: np.ndarray
                        ) -> List[List[List[float]]]:
    """(B, K, ...) fixed-shape device detections -> per-image ragged lists
    [x1, y1, x2, y2, score, label] for the metric stack."""
    out = []
    for i in range(boxes.shape[0]):
        rows = []
        for k in range(boxes.shape[1]):
            if not valid[i, k]:
                continue
            rows.append([float(boxes[i, k, 0]), float(boxes[i, k, 1]),
                         float(boxes[i, k, 2]), float(boxes[i, k, 3]),
                         float(scores[i, k]), float(classes[i, k])])
        out.append(rows)
    return out


def labels_to_lists(labels: np.ndarray) -> List[List[List[float]]]:
    """(B, G, 5) padded labels (label -1 padding) -> ragged per-image lists."""
    out = []
    for i in range(labels.shape[0]):
        rows = [row.tolist() for row in labels[i] if row[4] != -1]
        out.append(rows)
    return out
