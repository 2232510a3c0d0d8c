"""Serving surface (port of mm_distillnet_tpu/serving.py): a weight-baked
predictor and fixed-batch micro-batching.

`make_serving_fn` folds the weights once and returns images (B, H, W, C)
-> Detections: the fused forward (MBConv blocks as CUDA kernels by
default, models/fused_forward.py) then decode + packed top-k + per-class
NMS (ops/postprocess.py). `serve_many` chunks any number of images into
the predictor's batch, zero-pads the tail and returns the real rows.

A compact-audio batch (80 mel rows instead of `image_size`) is stretched
on the device first (ops/resize.py); any other height raises. With a
`mesh` (parallel.mesh.create_mesh: a tuple of devices) the predictor
keeps one replica per device, pads the batch to the mesh, runs a part on
each device and returns the real rows on the first (the JAX package's
batch-sharded serving over a `data` mesh). Not ported yet: the
export/load of a predictor.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .device import resolve_device
from .models.fused_forward import make_fused_predictor
from .ops.anchors import anchor_table
from .ops.postprocess import (Detections, class_validity_table,
                              postprocess_detections)
from .ops.resize import maybe_stretch_mel_axis
from .parallel.mesh import over_mesh

__all__ = ['make_serving_fn', 'serve_many']


def make_serving_fn(model, state_dict, image_size: int, *,
                    conf_threshold: float = 0.3,
                    nms_threshold: float = 0.5,
                    num_candidates: int = 512,
                    max_detections: int = 100,
                    approx: bool = False,
                    valid_prediction_ids: Optional[Sequence[int]] = None,
                    num_classes: int = 20,
                    plan_spec: Optional[str] = None,
                    dtype: torch.dtype = torch.bfloat16,
                    mesh=None,
                    device='cuda') -> Callable[..., Detections]:
    """Predictor images (B, H, W, C) -> Detections on `device`.

    Thresholds are the shipped eval defaults (reference
    configs/mm-distillnet.cfg:117-119); valid_prediction_ids defaults to
    [6] ('car'). `plan_spec` and `dtype` go to make_fused_predictor. With
    `mesh` (a tuple of devices; `device` is then not read) any batch is
    split over one replica per device and the Detections come back on
    mesh[0]."""
    if approx:
        raise NotImplementedError('approx top-k is TPU-only; not ported')
    if mesh is not None:
        replicas = [make_serving_fn(
            model, state_dict, image_size, conf_threshold=conf_threshold,
            nms_threshold=nms_threshold, num_candidates=num_candidates,
            max_detections=max_detections,
            valid_prediction_ids=valid_prediction_ids,
            num_classes=num_classes, plan_spec=plan_spec, dtype=dtype,
            device=d) for d in mesh]
        return over_mesh(mesh, replicas)
    dev = resolve_device(device)
    forward = make_fused_predictor(model, state_dict, image_size,
                                   plan_spec=plan_spec, dtype=dtype,
                                   device=dev)
    anchors = torch.as_tensor(anchor_table(image_size), device=dev)
    if valid_prediction_ids is None:
        valid_prediction_ids = [6]  # 'car', the shipped target class
    class_valid = torch.as_tensor(
        class_validity_table(num_classes, list(valid_prediction_ids)),
        device=dev)

    @torch.no_grad()
    def predict(x) -> Detections:
        x = torch.as_tensor(x, device=dev)
        out = forward(maybe_stretch_mel_axis(x, image_size))
        return postprocess_detections(
            out.classification, out.regression, anchors, class_valid,
            image_size=image_size, conf_threshold=conf_threshold,
            nms_threshold=nms_threshold, num_candidates=num_candidates,
            max_detections=max_detections)

    predict.forward = forward
    return predict


def serve_many(predict_fn, images: np.ndarray,
               batch_size: int) -> Detections:
    """Run any number of images through a fixed-batch predictor: chunk to
    `batch_size`, zero-pad the tail chunk, concatenate the real rows back
    out (numpy arrays)."""
    n = images.shape[0]
    outs = []
    for start in range(0, n, batch_size):
        chunk = images[start:start + batch_size]
        real = chunk.shape[0]
        if real < batch_size:
            pad = np.zeros((batch_size - real,) + chunk.shape[1:],
                           chunk.dtype)
            chunk = np.concatenate([chunk, pad], axis=0)
        dets = predict_fn(chunk)
        outs.append([t[:real].cpu().numpy() for t in dets])
    return Detections(*(np.concatenate([o[i] for o in outs], axis=0)
                        for i in range(len(Detections._fields))))
