"""Argoverse dataset: RGB + stereo-depth (.pfm -> log-jet colormap) (port
of mm_distillnet_tpu/data/argoverse.py; no cv2).

Capability match for reference src/datasets/ArgoverseDataset.py:48-178 plus
its pmf/colormap helpers (reference src/utils/utils.py:1494-1553).
"""
from __future__ import annotations

import glob
import os
from typing import Dict, List

import numpy as np

from .base import BaseDataset, VOC_CLASSES
from .decode import imread, read_pmf
from .imgproc import apply_colormap_jet, bgr_to_rgb
from .transforms import build_transformations


def apply_log_jet_colormap(img: np.ndarray, log_scale: bool = False,
                           max_value: float = 0) -> np.ndarray:
    """Depth -> jet colormap uint8 BGR (reference utils.py:1526-1553); the
    uint8 cast wraps as numpy's does in the JAX package."""
    if max_value == 0:
        max_value = img.max()
    cm = img / max_value * 255
    if log_scale:
        cm = np.clip(cm, 1, None)
        cm = np.log(cm)
        cm = cm / cm.max() * 255
    return apply_colormap_jet(cm.astype(np.uint8))


class ArgoverseDataset(BaseDataset):
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

    def get_id_list(self) -> List[str]:
        paths = glob.glob(f'{self.data_path}/{self.mode}/*/'
                          'stereo_front_left/*.resized.jpg')
        if len(paths) < 1:
            raise FileNotFoundError(f'No data on {self.data_path}!')
        ids = []
        for p in paths:
            log_name = os.path.basename(os.path.dirname(os.path.dirname(p)))
            ts = os.path.basename(p).replace('stereo_front_left_', '') \
                .replace('.resized.jpg', '')
            ids.append(f'{log_name}/{ts}')
        return sorted(ids)

    def get_paths(self, frame_id: str):
        log_name, ts = frame_id.split('/')
        base = os.path.join(self.data_path, self.mode, log_name)
        return (os.path.join(base, 'stereo_front_left',
                             f'stereo_front_left_{ts}.resized.jpg'),
                None,
                os.path.join(base, 'stereo_depth', f'stereo_depth_{ts}.pfm'),
                None,
                os.path.join(base, 'annotations',
                             f'stereo_front_left_{ts}.txt'))

    def get_annotations(self, frame_id: str) -> np.ndarray:
        _, _, depth_p, _, label_p = self.get_paths(frame_id)
        if not os.path.exists(label_p) or not os.path.exists(depth_p):
            return np.zeros((0, 5), np.float32)
        label = np.loadtxt(label_p, delimiter=',')
        if label.ndim < 2:
            label = label.reshape(1, 5)
        # labels are annotated at full resolution; images are half-size
        # (reference ArgoverseDataset.py:170-177)
        label[:, 0] *= 1232 / 2464
        label[:, 2] *= 1232 / 2464
        label[:, 1] *= 1028 / 2056
        label[:, 3] *= 1028 / 2056
        return label.astype(np.float32)

    def __getitem__(self, item: int) -> Dict:
        frame_id = self.ids[item]
        rgb_p, _, depth_p, _, _ = self.get_paths(frame_id)
        rgb = bgr_to_rgb(imread(rgb_p))
        depth = apply_log_jet_colormap(read_pmf(depth_p))
        if self.normalize:
            rgb = rgb.astype(np.float32) / 255.
            depth = depth.astype(np.float32) / 255.
        label = self.get_annotations(frame_id) if self.use_labels else None
        sample = {'rgb': rgb, 'thermal': None, 'depth': depth,
                  'audio': None, 'label': label, 'id': frame_id}
        return self.transformations(sample)
