"""Prediction-statistics miner (port of mm_distillnet_tpu/utils/statistics.py;
reference src/utils/utils.py:2490-2564): per-frame comparison of student
predictions against teacher pseudo-GT, missing / excess box counts and the
size distribution of missed objects.

Operates on per-frame dicts {frame_id: (n, >=5) array of [x1, y1, x2, y2,
(score,) label]}. Without pandas: the table comes back as a dict of
equal-length numpy columns, with the JAX package's DataFrame column names
in its order (no column at all when no frame has a teacher box, as an
empty DataFrame has none).
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from .metrics import bbox_iou_plus1

COLUMNS = ('id', 'expected_bboxes', 'is_day', 'is_night', 'predicted_bboxes',
           'missing_bboxes', 'excess_bboxes', 'smallest_bbox_missed',
           'biggest_bbox_missed', 'avg_bbox_missed',
           'predominating_area_missing')


def bboxes_to_area(bboxes: np.ndarray) -> np.ndarray:
    return ((bboxes[:, 2] - bboxes[:, 0]) *
            (bboxes[:, 3] - bboxes[:, 1])).astype(np.float64)


def _frame_row(frame_id: str, teacher_bboxes: np.ndarray,
               student: np.ndarray, iou_threshold: float) -> dict:
    areas = bboxes_to_area(teacher_bboxes)
    is_day = 'day' in frame_id
    row = {'id': frame_id, 'expected_bboxes': int(teacher_bboxes.shape[0]),
           'is_day': is_day, 'is_night': not is_day}
    if student.size == 0:
        return {**row, 'predicted_bboxes': 0,
                'missing_bboxes': int(teacher_bboxes.shape[0]),
                'excess_bboxes': 0,
                'smallest_bbox_missed': float(areas.min()),
                'biggest_bbox_missed': float(areas.max()),
                'avg_bbox_missed': float(areas.mean()),
                'predominating_area_missing': 'ALL'}
    matched = np.zeros(len(teacher_bboxes), bool)
    used_student = np.zeros(len(student), bool)
    for si in np.argsort(-student[:, 4] if student.shape[1] >= 6
                         else np.zeros(len(student))):
        ious = bbox_iou_plus1(student[si, :4], teacher_bboxes[:, :4])
        ti = int(np.argmax(ious))
        if ious[ti] >= iou_threshold and not matched[ti]:
            matched[ti] = True
            used_student[si] = True
    missed = areas[~matched]
    return {**row, 'predicted_bboxes': int(len(student)),
            'missing_bboxes': int((~matched).sum()),
            'excess_bboxes': int((~used_student).sum()),
            'smallest_bbox_missed': float(missed.min()) if missed.size
            else 0.,
            'biggest_bbox_missed': float(missed.max()) if missed.size
            else 0.,
            'avg_bbox_missed': float(missed.mean()) if missed.size else 0.,
            'predominating_area_missing':
                ('small' if missed.mean() < np.median(areas) else 'large')
                if missed.size else 'none'}


def collect_prediction_statistics(
        student_predictions: Dict[str, np.ndarray],
        teacher_predictions: Dict[str, np.ndarray],
        iou_threshold: float = 0.5) -> Dict[str, np.ndarray]:
    """One row per teacher-annotated frame with counts and missed-box area
    statistics, as columns; a frame the student missed entirely has
    predominating_area_missing 'ALL'."""
    rows = []
    for frame_id, teacher_bboxes in teacher_predictions.items():
        teacher_bboxes = np.asarray(teacher_bboxes, np.float64)
        if teacher_bboxes.size == 0:
            continue
        student = np.asarray(student_predictions.get(frame_id,
                                                     np.zeros((0, 6))),
                             np.float64)
        rows.append(_frame_row(frame_id, teacher_bboxes, student,
                               iou_threshold))
    if not rows:
        return {}
    return {c: np.asarray([r[c] for r in rows]) for c in COLUMNS}
