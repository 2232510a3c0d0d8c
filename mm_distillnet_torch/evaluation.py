"""Evaluation: mAP sweep + central distances + CSV artifacts (port of
mm_distillnet_tpu/evaluation.py).

Mirrors the reference evaluate() (reference src/utils/utils.py:2018-2181)
and its prediction loops (get_predictions_multiteacher utils.py:1720-1890):

- when all of rgb/thermal/depth are enabled the testing point is 'ALL'
  (teachers fused by NMS into pseudo-ground-truth); otherwise one testing
  point per enabled teacher modality;
- student predictions come from the audio branch, decoded + NMS'd on the
  device in fixed shapes;
- metrics: AP@0.5:0.05:0.95 sweep (ap_per_class), CDx/CDy at IoU=0.5;
- artifacts: `{exp_name}/results.{rank}.csv` with columns
  [exp_name, modality, AP@Ave, AP@0.5, AP@0.75, CDx, CDy] and
  `{exp_name}/resources.{rank}.csv` with [model, Time2Predict, TotalParams,
  TrainParams, Frames, FramesPerSec], written with the `csv` module; the
  table comes back as a list of dicts;
- optional persistence of fused labels to
  `{data_path}/{drive}/annotations/{ts}.all.txt` (utils.py:1878-1888).

Weights are state_dicts (convert/weights.py carries them over from the
reference's variable trees). With config `fused_inference=True` the
student's and every teacher's backbone run the hand-written MBConv kernels
through models/fused_forward.py (a generator teacher's, each of its
per-modality backbones). With a `mesh` (parallel.mesh.create_mesh: a tuple
of devices) the predictor and the teacher function keep one replica per
device (folded weights and kernels included), pad the batch to the mesh
(`pad_batch_to_devices`), run each part on its device and gather the real
rows on the first; `evaluate` builds one from config `eval_devices`,
capped at the process's own devices (the JAX package's SPMD eval over
the local devices). With config `quant_inference=True` `evaluate`
calibrates the int8 pack (quant.py) on the first min(len, 8) test frames
and the student predicts through it; config `approx_topk=True` selects
candidates as the JAX package's `approx_max_k` does off the TPU: exactly.
"""
from __future__ import annotations

import copy
import csv
import logging
import os
import time
from collections import deque
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from .config import (compute_dtype_from, student_input_key,
                     transfer_dtype_from)
from .data.loader import DataLoader
from .device import resolve_device
from .distill.pseudo_labels import fuse_teacher_labels, teacher_detections
from .models.efficientdet_generator import EfficientDetGenerator
from .models.fused_forward import eval_module, make_fused_predictor
from .ops.anchors import anchor_table
from .ops.postprocess import detections_to_labels, postprocess_detections
from .ops.resize import maybe_stretch_mel_axis
from .parallel import mesh as meshes
from .quant import build_quant_pack, pack_to, quantized_apply
from .train.trainer import distill_config_from, label_tables
from .utils.metrics import (ap_per_class, get_batch_central_distances,
                            get_batch_statistics, labels_to_lists)

logger = logging.getLogger(__name__)

_BUFFER_SUFFIXES = ('running_mean', 'running_var', 'num_batches_tracked')


def count_params(variables) -> int:
    """Trainable values of a module or of its state_dict (BatchNorm
    statistics are not parameters)."""
    if isinstance(variables, torch.nn.Module):
        return int(sum(p.numel() for p in variables.parameters()))
    return int(sum(v.numel() for k, v in variables.items()
                   if not k.endswith(_BUFFER_SUFFIXES)))


def _eval_forward(model, variables, image_size: int, config, dev,
                  quant_pack=None):
    """fn(variables, x) -> DetectorOutput in eval mode. With `quant_pack`
    a copy of `model` on `dev`, holding the state_dict it was last called
    with, runs the int8 path (quant.quantized_apply; the MBConv kernels are
    bypassed, as in the JAX package). Else, with `variables` given and
    config `fused_inference=True`, the weights are folded once and the
    backbone runs the MBConv kernels; otherwise the copy runs its fp
    forward."""
    dtype = compute_dtype_from(config)
    if quant_pack is None and variables is not None and \
            config.getboolean('fused_inference', fallback=False):
        fused = make_fused_predictor(model, variables, image_size,
                                     dtype=dtype, device=dev)
        return lambda _variables, x: fused(x)
    net = copy.deepcopy(model).to(dev, dtype).eval()
    loaded = None
    if variables is not None:
        net.load_state_dict(variables)
        loaded = variables
    run = net
    if quant_pack is not None:
        pack = pack_to(quant_pack, dev)

        def run(x):
            return quantized_apply(net, pack, x)

    def forward(vs, x):
        nonlocal loaded
        if vs is not None and vs is not loaded:
            net.load_state_dict(vs)
            loaded = vs
        return run(x)

    return forward


def make_predict_fn(model, image_size: int, config, variables=None,
                    mesh=None, quant_pack=None, device='cuda'):
    """fn(variables, x, class_valid, pred_to_label) -> (padded label rows
    [x1,y1,x2,y2,score,label] (B, max_det, 6), BiFPN features).

    `variables` is a state_dict. With config `fused_inference=True` (and
    `variables` given here) the backbone runs through the fused MBConv path
    (models.fused_forward) with the weights folded once; the `variables`
    of a call are then not looked at. With `quant_pack`
    (quant.build_quant_pack) the forward runs the int8 path instead. A
    compact-audio input (80 mel rows) is stretched on the device first.

    With `mesh` (a tuple of devices; `device` is then not read) the batch
    is split over one replica per device and the rows and features come
    back on mesh[0]."""
    if mesh is not None:
        return meshes.over_mesh(mesh, [
            make_predict_fn(model, image_size, config, variables,
                            quant_pack=quant_pack, device=d) for d in mesh],
            batch_arg=1)
    dev = resolve_device(device)
    anchors = torch.as_tensor(anchor_table(image_size), device=dev)
    conf = config.getfloat('conf_threshold', fallback=0.3)
    nms_thr = config.getfloat('nms_threshold', fallback=0.5)
    cands = config.getint('nms_candidates', fallback=512)
    max_det = config.getint('max_detections', fallback=100)
    approx = config.getboolean('approx_topk', fallback=False)
    forward = _eval_forward(model, variables, image_size, config, dev,
                            quant_pack)

    @torch.no_grad()
    def predict(variables, x, class_valid, pred_to_label):
        x = maybe_stretch_mel_axis(torch.as_tensor(x, device=dev), image_size)
        out = forward(variables, x)
        dets = postprocess_detections(
            out.classification, out.regression, anchors,
            torch.as_tensor(class_valid, device=dev),
            image_size=image_size, conf_threshold=conf,
            nms_threshold=nms_thr, num_candidates=cands,
            max_detections=max_det, approx=approx)
        labels = detections_to_labels(
            dets, torch.as_tensor(pred_to_label, device=dev), image_size,
            include_scores=True)
        return labels, out.features

    return predict


def make_fused_teacher_fn(teacher_models: Dict[str, Any], image_size: int,
                          config, mesh=None,
                          teacher_variables: Optional[Mapping] = None,
                          device='cuda'):
    """fn(teacher_variables, batch, class_valid, pred_to_label) -> fused
    pseudo-GT label rows (B, max_gt, 5).

    teacher_models: {modality: module}; the variables are {modality:
    state_dict}. With config `fused_inference=True` give `teacher_variables`
    here: each teacher's weights are folded once and its forward runs the
    MBConv kernels. A generator teacher reads a dict of its modalities,
    the compact audio stretched first. With `mesh` (a tuple of devices;
    `device` is then not read) the batch is split over one replica per
    device and the rows come back on mesh[0]."""
    if mesh is not None:
        return meshes.over_mesh(mesh, [
            make_fused_teacher_fn(teacher_models, image_size, config,
                                  teacher_variables=teacher_variables,
                                  device=d) for d in mesh], batch_arg=1)
    dev = resolve_device(device)
    if teacher_variables is None and \
            config.getboolean('fused_inference', fallback=False):
        raise ValueError('fused_inference folds the weights once: pass '
                         'teacher_variables to make_fused_teacher_fn')
    cfg = distill_config_from(config, image_size)
    anchors = torch.as_tensor(anchor_table(image_size), device=dev)
    forwards = {
        m: _eval_forward(model, None if teacher_variables is None
                         else teacher_variables[m], image_size, config, dev)
        for m, model in teacher_models.items()}

    @torch.no_grad()
    def fused(teacher_variables, batch, class_valid, pred_to_label):
        class_valid = torch.as_tensor(class_valid, device=dev)
        pred_to_label = torch.as_tensor(pred_to_label, device=dev)
        per_teacher = []
        for modality, forward in forwards.items():
            model = teacher_models[modality]
            if isinstance(model, EfficientDetGenerator):
                x = {m: torch.as_tensor(batch[m], device=dev)
                     for m in model.modalities}
                if 'audio' in x:
                    x['audio'] = maybe_stretch_mel_axis(x['audio'],
                                                        image_size)
            else:
                x = torch.as_tensor(batch[modality], device=dev)
            out = forward(None if teacher_variables is None
                          else teacher_variables[modality], x)
            dets = teacher_detections(out.classification, out.regression,
                                      anchors, class_valid, cfg.pl)
            per_teacher.append(detections_to_labels(
                dets, pred_to_label, image_size, include_scores=True))
        return fuse_teacher_labels(per_teacher, cfg.pl)

    return fused


def _rows_with_scores_to_lists(rows: np.ndarray) -> List[List[List[float]]]:
    return [[r.tolist() for r in rows[i] if r[5] != -1]
            for i in range(rows.shape[0])]


def _save_fused_annotations(config, ids, fused_rows):
    data_path = config.get('data_path', 'data')
    for frame_id, rows in zip(ids, labels_to_lists(fused_rows)):
        try:
            drive, ts = frame_id.split('/')
        except ValueError:
            continue
        ann_dir = os.path.join(data_path, drive, 'annotations')
        os.makedirs(ann_dir, exist_ok=True)
        with open(os.path.join(ann_dir, f'{ts}.all.txt'), 'w') as f:
            for r in rows:
                f.write(' '.join(str(int(v)) for v in r[:4]) +
                        f' {int(r[4])}\n')


def _write_csv(path: str, rows: List[Dict[str, Any]]) -> None:
    with open(path, 'w', newline='') as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)


def _to_host(t) -> np.ndarray:
    return t.float().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def evaluate(teacher_models: Dict[str, Tuple[Any, Any]],
             student_model: Tuple[Any, Any],
             test_set, config, device='cuda') -> List[Dict[str, Any]]:
    """teacher_models: {modality: (module, state_dict)}; student_model:
    (module, state_dict). Returns the AP table, one dict per testing point,
    and writes the results and resources CSV files."""
    logger.warning('Beginning evaluation of student model performance')
    dev = resolve_device(device)
    rank = meshes.config_rank(config)
    image_size = config.getint('image_size')
    s_module, s_vars = student_model
    num_classes = s_module.num_classes

    class_valid, pred_to_label = label_tables(test_set, num_classes, dev)

    # the batch over `eval_devices` of this process's devices (all when
    # unset), the first being `dev`; one device runs without a mesh
    available = [dev] + [d for d in meshes.local_devices(dev.type)
                         if d != dev]
    n_eval = config.getint('eval_devices', fallback=-1) or -1
    n_eval = len(available) if n_eval <= 0 else min(n_eval, len(available))
    mesh = meshes.create_mesh(n_eval, available) if n_eval > 1 else None

    student_key = student_input_key(config)
    quant_pack = None
    if config.getboolean('quant_inference', fallback=False):
        # int8 PTQ: calibrate on the first frames of the test set, as the
        # student will see them (compact audio stretched first)
        n_cal = min(len(test_set), 8)
        calib = maybe_stretch_mel_axis(torch.as_tensor(np.stack(
            [np.asarray(test_set[i][student_key]) for i in range(n_cal)]),
            device=dev), image_size)
        net = eval_module(s_module, s_vars, dev, compute_dtype_from(config))
        quant_pack = build_quant_pack(net, calib, [calib], state_dict=s_vars)
    predict = make_predict_fn(s_module, image_size, config, variables=s_vars,
                              mesh=mesh, quant_pack=quant_pack, device=dev)
    testing_points = list(teacher_models.keys())
    if (config.getboolean('use_thermal', fallback=False)
            and config.getboolean('use_depth', fallback=False)
            and config.getboolean('use_rgb', fallback=True)
            and len(teacher_models) > 1):
        testing_points = ['ALL']

    # eval_batch_size decouples the inference batch from the training
    # batch_size (the reference evaluates at the training batch,
    # utils.py:2018-2030, kept as the default)
    eval_batch = config.getint('eval_batch_size',
                               fallback=config.getint('batch_size'))
    loader = DataLoader(test_set, eval_batch,
                        shuffle=False, drop_last=False,
                        num_workers=config.getint('num_workers', fallback=4))
    fast_run = config.getboolean('fast_run', fallback=False)
    save_ann = config.getboolean('save_fused_annotations', fallback=False)
    use_labels = config.getboolean('use_labels', fallback=False)
    # how many batches' device work stays in flight before the host reads
    # results back
    depth = max(1, config.getint('eval_pipeline_depth', fallback=2))
    tdtype = transfer_dtype_from(config)
    exp_name = config.get('exp_name', 'run')

    ap_table = []
    for modality in testing_points:
        members = list(teacher_models) if modality == 'ALL' else [modality]
        t_vars = {m: teacher_models[m][1] for m in members}
        fused_fn = make_fused_teacher_fn(
            {m: teacher_models[m][0] for m in members}, image_size, config,
            mesh=mesh, teacher_variables=t_vars, device=dev)

        all_predictions, all_labels = [], []
        target_classes: List[float] = []
        n_frames = 0
        start_time = time.time()

        def _drain(entry):
            # host reads happen here, after the next batches' device work
            # has been queued
            nonlocal n_frames
            batch, n, pred_rows, fused = entry
            preds = _rows_with_scores_to_lists(_to_host(pred_rows)[:n])
            fused = _to_host(fused)[:n]
            labels = labels_to_lists(fused)
            all_predictions.append(preds)
            all_labels.append(labels)
            for img_labels in labels:
                target_classes.extend([r[4] for r in img_labels])
            n_frames += n
            if save_ann:
                _save_fused_annotations(config, batch['id'], fused)

        pending = deque()
        for bi, batch in enumerate(loader):
            arrays = {m: torch.from_numpy(batch[m])
                      for m in ('rgb', 'thermal', 'depth', 'audio')
                      if m in batch}
            if tdtype is not None:  # cast before the copy to the device
                arrays = {m: a.to(tdtype) for m, a in arrays.items()}
            n_real = arrays[student_key].shape[0]
            dev_inputs = {m: a.to(dev, non_blocking=True)
                          for m, a in arrays.items()}
            pred_rows, _ = predict(s_vars, dev_inputs[student_key],
                                   class_valid, pred_to_label)
            if use_labels and 'label' in batch and \
                    (batch['label'][..., 4] != -1).any():
                fused = batch['label']
            else:
                fused = fused_fn(t_vars, dev_inputs, class_valid,
                                 pred_to_label)
            pending.append((batch, n_real, pred_rows, fused))
            while len(pending) > depth:
                _drain(pending.popleft())
            if fast_run and bi >= 1:
                break
        while pending:
            _drain(pending.popleft())
        elapsed = time.time() - start_time

        total_params = count_params(s_vars)
        os.makedirs(exp_name, exist_ok=True)
        # written inside the per-modality loop on purpose, as the reference
        # does (utils.py:2086-2095): with several testing points the last
        # one's timing wins there too
        _write_csv(os.path.join(exp_name, f'resources.{rank}.csv'), [{
            'model': config.get('student', 'student'),
            'Time2Predict': elapsed,
            'TotalParams': total_params,
            'TrainParams': total_params,
            'Frames': n_frames,
            'FramesPerSec': n_frames / elapsed if elapsed > 0 else 0.0,
        }])

        ap_modality = {'exp_name': exp_name, 'modality': modality,
                       'AP@Ave': 0., 'AP@0.5': 0., 'AP@0.75': 0.,
                       'CDx': 0., 'CDy': 0.}
        ap_record = []
        target_cls_arr = np.asarray(target_classes)
        for iou in np.around(np.arange(0.5, 0.95, 0.05), 2):
            sample_metrics = []
            cd_x, cd_y = [], []
            for preds, labels in zip(all_predictions, all_labels):
                sample_metrics += get_batch_statistics(preds, labels, iou)
                cdx, cdy = get_batch_central_distances(
                    preds, labels, image_size, image_size)
                cd_x.extend(cdx)
                cd_y.extend(cdy)
            if not any(np.asarray(m[0]).size for m in sample_metrics):
                mean = 0.0
                if iou == 0.5:
                    ap_modality['CDx'] = 100.
                    ap_modality['CDy'] = 100.
            else:
                tps, scores, pls = [np.concatenate(x, 0)
                                    for x in zip(*sample_metrics)]
                _, _, ap, _, _, _ = ap_per_class(tps, scores, pls,
                                                 target_cls_arr)
                mean = float(ap.mean()) if ap.size else 0.0
                if iou == 0.5:
                    ap_modality['AP@0.5'] = mean * 100
                    ap_modality['CDx'] = float(np.mean(cd_x)) * 100 \
                        if cd_x else 100.
                    ap_modality['CDy'] = float(np.mean(cd_y)) * 100 \
                        if cd_y else 100.
                if iou == 0.75:
                    ap_modality['AP@0.75'] = mean * 100
            ap_record.append(mean)
        ap_modality['AP@Ave'] = float(np.mean(ap_record)) * 100
        ap_table.append(ap_modality)
        logger.warning('modality %s: %s', modality, ap_modality)

    _write_csv(os.path.join(exp_name, f'results.{rank}.csv'), ap_table)
    return ap_table
