"""ctypes bindings to the repo's native host kernels (port of
mm_distillnet_tpu/utils/native.py).

The source is the repo's `native/mmdt_native.cpp`, read in place and built
by ops/cuda_build.py's host path (`$CXX` or `c++`, `-O3 -shared -fPIC
-ffp-contract=off`) into `build/mm_distillnet_torch/` at first use; nothing
is written into `native/`. A failed build raises: the JAX package falls
back to numpy when its library is missing, the port does not. The numpy
versions stay beside the bindings as the plain versions (`nms_reference`
here, `utils.metrics.get_batch_statistics_reference`), which the tests
hold the native ones to.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from ..ops import cuda_build

_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = cuda_build.load('mmdt_native')
        f32p = np.ctypeslib.ndpointer(np.float32, flags='C_CONTIGUOUS')
        i32p = np.ctypeslib.ndpointer(np.int32, flags='C_CONTIGUOUS')
        lib.mmdt_nms.restype = ctypes.c_int
        lib.mmdt_nms.argtypes = [f32p, f32p, ctypes.c_int, ctypes.c_float,
                                 i32p]
        lib.mmdt_batch_statistics.restype = None
        lib.mmdt_batch_statistics.argtypes = [
            f32p, ctypes.c_int, ctypes.c_int, f32p, ctypes.c_int,
            ctypes.c_float, f32p]
        lib.mmdt_central_distances.restype = None
        lib.mmdt_central_distances.argtypes = [
            f32p, ctypes.c_int, ctypes.c_int, f32p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float)]
        _LIB = lib
    return _LIB


def nms(boxes: np.ndarray, scores: np.ndarray,
        iou_threshold: float) -> np.ndarray:
    """Greedy class-agnostic NMS over xyxy boxes; the kept indices in
    selection order (int32)."""
    n = len(boxes)
    if n == 0:
        return np.zeros(0, np.int32)
    boxes = np.ascontiguousarray(boxes, np.float32)
    scores = np.ascontiguousarray(scores, np.float32)
    keep = np.zeros(n, np.int32)
    n_keep = _lib().mmdt_nms(boxes, scores, n, iou_threshold, keep)
    return keep[:n_keep].copy()


def nms_reference(boxes: np.ndarray, scores: np.ndarray,
                  iou_threshold: float) -> np.ndarray:
    """The plain version of `nms`, in numpy."""
    order = np.argsort(-scores, kind='stable')
    keep = []
    suppressed = np.zeros(len(boxes), bool)
    areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    for i in order:
        if suppressed[i]:
            continue
        keep.append(int(i))
        x1 = np.maximum(boxes[i, 0], boxes[:, 0])
        y1 = np.maximum(boxes[i, 1], boxes[:, 1])
        x2 = np.minimum(boxes[i, 2], boxes[:, 2])
        y2 = np.minimum(boxes[i, 3], boxes[:, 3])
        inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
        iou = inter / np.clip(areas[i] + areas - inter, 1e-8, None)
        suppressed |= iou > iou_threshold
        suppressed[i] = True
    return np.asarray(keep, np.int32)


def batch_statistics_tp(preds: np.ndarray, targets: np.ndarray,
                        iou_threshold: float) -> np.ndarray:
    """True positives of one image's score-ordered predictions (n, >= 6)
    against its targets (m, 5), the reference's +1-pixel IoU (fp32)."""
    preds = np.ascontiguousarray(preds, np.float32)
    targets = np.ascontiguousarray(targets, np.float32)
    tp = np.zeros(len(preds), np.float32)
    _lib().mmdt_batch_statistics(preds, len(preds), preds.shape[1], targets,
                                 len(targets), iou_threshold, tp)
    return tp


def central_distances(preds: np.ndarray,
                      targets: np.ndarray) -> Tuple[float, float]:
    """CDx / CDy of one image (utils.metrics.get_batch_central_distances
    at unit width and height)."""
    preds = np.ascontiguousarray(preds, np.float32)
    targets = np.ascontiguousarray(targets, np.float32)
    dx = ctypes.c_float()
    dy = ctypes.c_float()
    _lib().mmdt_central_distances(preds, len(preds),
                                  preds.shape[1] if preds.size else 6,
                                  targets, len(targets), ctypes.byref(dx),
                                  ctypes.byref(dy))
    return float(dx.value), float(dy.value)
