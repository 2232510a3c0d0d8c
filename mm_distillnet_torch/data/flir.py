"""FLIR ADAS dataset: RGB + thermal pairs with COCO-json thermal labels
(port of mm_distillnet_tpu/data/flir.py; no cv2).

Capability match for reference src/datasets/FLIRDataset.py:44-209:
- ids from `{data_path}/{mode}/RGB/*.jpg`;
- thermal 8-bit jpegs min-max normalized; RGB resized to the thermal size
  (uint8 INTER_LINEAR, within 1 LSB of cv2: `data/imgproc.py`);
- `thermal_annotations.json` (COCO) converted once to a `labels.json` cache
  of per-image [x1, y1, x2, y2, class] rows (xywh -> xyxy, category names
  matched to the VOC class list).
"""
from __future__ import annotations

import glob
import json
import logging
import os
from typing import Dict, List

import numpy as np

from .base import BaseDataset, VOC_CLASSES
from .decode import IMREAD_ANYDEPTH, imread
from .imgproc import bgr_to_rgb, normalize_minmax, resize_linear
from .transforms import build_transformations

logger = logging.getLogger(__name__)


class FLIRDataset(BaseDataset):
    classes = VOC_CLASSES

    def __init__(self, config, mode: str):
        super().__init__(config, mode)
        self.use_labels = config.getboolean('use_labels', fallback=False)
        self.transformations = build_transformations(
            config.get(f'{"train" if mode == "train" else "val"}'
                       '_transformations', 'Normalizer,Resizer'),
            self.image_size)
        self.ids = self.get_id_list()
        self.num_images = len(self.ids)
        self.id2label = self.gen_id2label_file()

    def get_id_list(self) -> List[str]:
        paths = glob.glob(f'{self.data_path}/{self.mode}/RGB/*.jpg')
        if len(paths) < 1:
            raise FileNotFoundError(f'No data on {self.data_path}!')
        return sorted(os.path.splitext(os.path.basename(p))[0]
                      for p in paths)

    def get_paths(self, frame_id: str):
        rgb = os.path.join(self.data_path, self.mode, f'RGB/{frame_id}.jpg')
        thermal = os.path.join(self.data_path, self.mode,
                               f'thermal_8_bit/{frame_id}.jpeg')
        return rgb, thermal, None, None, \
            f'{self.data_path}/{self.mode}/labels.json'

    def gen_id2label_file(self) -> Dict[str, List]:
        label_file = f'{self.data_path}/{self.mode}/labels.json'
        if not os.path.exists(label_file):
            ann_file = f'{self.data_path}/{self.mode}/thermal_annotations.json'
            with open(ann_file) as f:
                ann = json.load(f)
            id2file = {img['id']: os.path.splitext(
                os.path.basename(img['file_name']))[0]
                for img in ann['images']}
            cat_map = {c['id']: self.classes.index(c['name'])
                       for c in ann['categories']
                       if c['name'] in self.classes}
            id2label: Dict[str, List] = {}
            for a in ann['annotations']:
                if a['category_id'] not in cat_map:
                    continue
                x, y, w, h = a['bbox']
                id2label.setdefault(id2file[a['image_id']], []).append(
                    [x, y, x + w, y + h, cat_map[a['category_id']]])
            with open(label_file, 'w') as f:
                json.dump(id2label, f, indent=4, sort_keys=True)
            logger.info('%d labels cached to %s', len(id2label), label_file)
        with open(label_file) as f:
            return json.load(f)

    def get_annotations(self, frame_id: str) -> np.ndarray:
        if frame_id not in self.id2label:
            return np.zeros((0, 5), np.float32)
        return np.asarray(self.id2label[frame_id], np.float32)

    def __getitem__(self, item: int) -> Dict:
        frame_id = self.ids[item]
        rgb_p, th_p, _, _, _ = self.get_paths(frame_id)
        rgb = bgr_to_rgb(imread(rgb_p))
        thermal = normalize_minmax(imread(th_p, IMREAD_ANYDEPTH), 0, 255
                                   ).astype(np.float32)
        h, w = thermal.shape
        rgb = resize_linear(rgb, w, h)
        if self.normalize:
            rgb = rgb.astype(np.float32) / 255.
            thermal = thermal / 255.
        label = self.get_annotations(frame_id) if self.use_labels else None
        sample = {'rgb': rgb, 'thermal': thermal, 'depth': None,
                  'audio': None, 'label': label, 'id': frame_id}
        sample = self.transformations(sample)
        if sample['thermal'] is not None:
            sample['thermal'] = sample['thermal'][..., None]
        return sample
