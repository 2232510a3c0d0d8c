"""Dataset base: class vocabularies and label-mapping dictionaries (port
of mm_distillnet_tpu/data/base.py; numpy only, `refine_ids` runs the port's
predictor).

Mirrors BaseDataset (reference src/datasets/BaseDataset.py:44-310): the
4-way `valid_classes_dict` (labels<->ids in dataset label space,
predictions<->ids in teacher/VOC prediction space), restricted to the
configured `valid_labels` (shipped config: 'car').
"""
from __future__ import annotations

import csv
import os
import re
from typing import Dict, List, Optional, Sequence

import numpy as np

VOC_CLASSES = (
    'aeroplane', 'bicycle', 'bird', 'boat', 'bottle', 'bus', 'car', 'cat',
    'chair', 'cow', 'diningtable', 'dog', 'horse', 'motorbike', 'person',
    'pottedplant', 'sheep', 'sofa', 'train', 'tvmonitor')

# VOC prediction-id table (reference src/datasets/BaseDataset.py:142-165)
VOC_PREDICTION_IDS = {name: i for i, name in enumerate(VOC_CLASSES)}
COCO_PREDICTION_IDS = {'car': 2}


def build_valid_classes_dict(classes: Sequence[str], config,
                             prediction_ids: Optional[Dict[str, int]] = None
                             ) -> Dict[str, Dict]:
    """Reference src/datasets/BaseDataset.py:127-138."""
    if prediction_ids is None:
        prediction_ids = VOC_PREDICTION_IDS
    valid = None
    if config is not None and 'valid_labels' in config:
        valid = set(config['valid_labels'].split(','))
    d = {'labels_i2txt': {}, 'labels_txt2i': {},
         'predictions_txt2i': {}, 'predictions_i2txt': {}}
    for i, name in enumerate(classes):
        if valid is not None and name not in valid:
            continue
        d['labels_txt2i'][name] = i
        d['labels_i2txt'][i] = name
        d['predictions_txt2i'][name] = prediction_ids[name]
        d['predictions_i2txt'][prediction_ids[name]] = name
    return d


def prediction_to_label_lut(valid_classes_dict: Dict, num_classes: int
                            ) -> np.ndarray:
    """(num_classes,) int LUT: prediction-space id -> label-space id
    (the remap in logits_to_ground_truth, reference
    src/utils/utils.py:297-300); unmapped ids -> -1."""
    lut = -np.ones((num_classes,), dtype=np.int32)
    for pid, name in valid_classes_dict['predictions_i2txt'].items():
        lut[pid] = valid_classes_dict['labels_txt2i'][name]
    return lut


def valid_prediction_ids(valid_classes_dict: Dict) -> List[int]:
    return sorted(valid_classes_dict['predictions_txt2i'].values())


def filter_labels(labels: np.ndarray, valid_classes_dict: Dict) -> np.ndarray:
    """Keep rows whose label id is valid (reference BaseDataset.py:186-189)."""
    if labels.size == 0:
        return labels
    mask = np.isin(labels[:, 4],
                   list(valid_classes_dict['labels_txt2i'].values()))
    return labels[mask]


class BaseDataset:
    """Minimal common behavior: config extraction + class maps + id lists."""

    classes: Sequence[str] = VOC_CLASSES

    def __init__(self, config, mode: str):
        self.config = config
        self.mode = mode
        self.data_path = config.get('data_path', 'data')
        self.drive_type = ('_' + config['drive_type']
                           if config.get('drive_type') else '')
        self.daytime = ('_' + config['daytime']
                        if config.get('daytime') else '')
        self.image_size = config.getint('image_size')
        # Compact audio ingest (see ops/resize.stretch_mel_axis): the host
        # pipeline stretches only the spectrogram's time axis; the 80-mel
        # axis is stretched on the device.
        self.device_audio_resize = config.getboolean(
            'device_audio_resize', fallback=False) or False
        self.use_thermal = config.getboolean('use_thermal')
        self.use_depth = config.getboolean('use_depth')
        self.use_rgb = config.getboolean('use_rgb', fallback=True)
        self.normalize = config.getboolean('normalize')
        self.valid_classes_dict = build_valid_classes_dict(
            self.classes, config)

    def __len__(self):
        return self.num_images

    @property
    def num_classes(self) -> int:
        return len(self.classes)

    def refine_ids(self, model, config, device='cuda') -> None:
        """Prune the id list to frames the RGB teacher can confidently
        predict on (reference src/datasets/BaseDataset.py:190-310): runs
        the teacher once per frame, caches
        `{data_path}/{teacher}_{mode}{drive_type}_predictions.csv` with
        (id, num_predictions, max_confidence) rows, then keeps ids whose
        best score exceeds 0.40 (EfficientDet threshold).

        `model` is a (module, state_dict) pair; the predictions run on
        `device`. With use_labels=True the pruning uses dataset annotations
        instead (frames with >1 valid label)."""
        if getattr(self, 'use_labels', False):
            valid = []
            for frame_id in self.ids:
                labels = self.get_annotations(frame_id)
                if len(labels) < 1:
                    continue
                if len(filter_labels(np.asarray(labels),
                                     self.valid_classes_dict)) > 1:
                    valid.append(frame_id)
            self.ids = sorted(set(self.ids) & set(valid))
            self.num_images = len(self.ids)
            return

        teacher = config.get('teacher', 'YetAnotherEfficientDet_D2')
        pred_file = (f"{self.data_path}/{teacher}_{self.mode}"
                     f"{self.drive_type}_predictions.csv")
        if not os.path.exists(pred_file):
            import torch

            from ..evaluation import make_predict_fn
            from ..ops.postprocess import class_validity_table

            module, state_dict = model
            predict = make_predict_fn(module, self.image_size, config,
                                      variables=state_dict, device=device)
            class_valid = torch.as_tensor(class_validity_table(
                module.num_classes,
                valid_prediction_ids(self.valid_classes_dict)))
            p2l = torch.as_tensor(prediction_to_label_lut(
                self.valid_classes_dict, module.num_classes))
            with open(pred_file, 'w', newline='') as f:
                writer = csv.writer(f)
                for i, frame_id in enumerate(self.ids):
                    rgb = self[i]['rgb'][None]
                    pred_rows, _ = predict(state_dict, rgb, class_valid, p2l)
                    pr = pred_rows[0].cpu().numpy()
                    valid_rows = pr[pr[:, 5] != -1]
                    max_conf = float(valid_rows[:, 4].max()) \
                        if len(valid_rows) else 0.0
                    writer.writerow([frame_id, len(valid_rows), max_conf])

        minconf = 0.40  # EfficientDet teacher threshold
        with open(pred_file, newline='') as f:
            valid_ids = [row[0] for row in csv.reader(f)
                         if row and np.float32(row[2]) > minconf]
        id_filter = config.get('id_filter', 'None')
        if 'None' not in id_filter:
            r = re.compile(id_filter)
            valid_ids = [v for v in valid_ids if r.match(v)]
        self.ids = sorted(set(self.ids) & set(valid_ids))
        self.num_images = len(self.ids)
