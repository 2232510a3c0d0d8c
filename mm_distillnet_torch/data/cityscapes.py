"""CityScapes dataset: RGB + disparity with txt annotations (port of
mm_distillnet_tpu/data/cityscapes.py; no cv2).

Capability match for reference src/datasets/CityScapesDataset.py:49-202:
ids from `annotations/{mode}/{city}/*`; disparity is a 16-bit PNG read
unchanged and decoded as (d - 1) / 256 for d > 0, clamped at 192.
"""
from __future__ import annotations

import glob
import os
from typing import Dict, List

import numpy as np

from .base import BaseDataset, VOC_CLASSES
from .decode import IMREAD_UNCHANGED, imread
from .imgproc import bgr_to_rgb
from .transforms import build_transformations

DEPTH_MAX = 192


class CityScapesDataset(BaseDataset):
    classes = VOC_CLASSES

    def __init__(self, config, mode: str):
        super().__init__(config, mode)
        self.transformations = build_transformations(
            config.get(f'{"train" if mode == "train" else "val"}'
                       '_transformations', 'Normalizer,Resizer'),
            self.image_size)
        self.ids = self.get_id_list()
        self.num_images = len(self.ids)

    def get_id_list(self) -> List[str]:
        ids = []
        for path in glob.glob(os.path.join(self.data_path, 'annotations',
                                           self.mode, '*', '*')):
            city = os.path.basename(os.path.dirname(path))
            name, _ = os.path.splitext(os.path.basename(path))
            ids.append(f"{city}/{name.replace('_annotations', '')}")
        if not ids:
            raise FileNotFoundError(f'No data on {self.data_path}!')
        return sorted(ids)

    def get_paths(self, frame_id: str):
        city, name = frame_id.split('/')
        return (os.path.join(self.data_path, 'leftImg8bit', self.mode, city,
                             f'{name}_leftImg8bit.png'),
                None,
                os.path.join(self.data_path, 'disparity', self.mode, city,
                             f'{name}_disparity.png'),
                None,
                os.path.join(self.data_path, 'annotations', self.mode, city,
                             f'{name}_annotations.txt'))

    def get_annotations(self, frame_id: str) -> np.ndarray:
        _, _, _, _, label_p = self.get_paths(frame_id)
        label = np.loadtxt(label_p)
        if label.ndim < 2:
            label = label.reshape(1, 5)
        return label.astype(np.float32)

    def filter_labels(self, labels):
        return labels  # reference keeps all (CityScapesDataset.py:160-161)

    def __getitem__(self, item: int) -> Dict:
        frame_id = self.ids[item]
        rgb_p, _, depth_p, _, _ = self.get_paths(frame_id)
        rgb = bgr_to_rgb(imread(rgb_p))
        depth = None
        if self.use_depth:
            depth = imread(depth_p, IMREAD_UNCHANGED).astype(np.float32)
            depth[depth > 0] = (depth[depth > 0] - 1) / 256
            depth[depth > DEPTH_MAX] = DEPTH_MAX
        if self.normalize:
            rgb = rgb.astype(np.float32) / 255.
        label = self.get_annotations(frame_id)
        sample = {'rgb': rgb, 'thermal': None, 'depth': depth,
                  'audio': None, 'label': label, 'id': frame_id}
        sample = self.transformations(sample)
        if sample['depth'] is not None and sample['depth'].ndim == 2:
            sample['depth'] = sample['depth'][..., None]
        return sample
