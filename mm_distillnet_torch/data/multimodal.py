"""MultimodalDetection: the Freiburg 113k-frame multimodal dataset loader
(port of mm_distillnet_tpu/data/multimodal.py; no cv2: images through
`data/decode.py` and `data/imgproc.py`).

Host-side re-implementation of reference
src/datasets/MultimodalDetection.py:49-367:
- id lists from `{mode}{daytime}{drive_type}.txt`, timestamp-sorted
  (ids are `drive/secs_nsecs_code` strings);
- per frame: RGB jpg (BGR->RGB, crop cols 200:1720), thermal 16-bit "jpg"
  (PNG data under that name, read by content) clamped to [21800, 25000]
  then min-max normalized to [0,255], depth jpg (kept BGR, as the
  reference reads it), 8 per-mic log-mel pickles stacked to (80, T, 8);
- optional /255 normalization, then the configured transformations
  (Normalizer + Resizer) producing image_size x image_size NHWC arrays.

Samples are dicts (NHWC host arrays): rgb (S,S,3), thermal (S,S,1),
depth (S,S,3), audio (S,S,8) or (80,S,8) with the compact ingest,
label None, id.
"""
from __future__ import annotations

import os
import pickle
import re
from typing import Dict, List, Optional

import numpy as np
import torch

from ..ops.audio import decode_audio, melspectrogram
from .base import BaseDataset, VOC_CLASSES
from .decode import IMREAD_ANYDEPTH, imread
from .imgproc import bgr_to_rgb, normalize_minmax, stretch_bicubic
from .transforms import build_transformations

CROP_LEFT, CROP_RIGHT = 200, 1720
IR_MINVAL, IR_MAXVAL = 21800, 25000


def _timestamp_key(frame_id: str):
    """Sort key: integer concat of secs+nsecs (reference
    MultimodalDetection.py:121-140 sorts by pandas datetime of that
    concatenation, then by id — equivalent ordering)."""
    _, ts = frame_id.split('/')
    secs, nsecs, _code = ts.split('_')
    return (int(str(secs) + str(nsecs)), frame_id)


def clip_thermal(thermal: np.ndarray, path: str) -> np.ndarray:
    """np.clip to [IR_MINVAL, IR_MAXVAL]. The bounds do not fit 8 bits: on
    an 8-bit frame numpy 2 raises OverflowError in the JAX package, and so
    does this, naming the frame."""
    if thermal.dtype != np.uint16:
        raise OverflowError(
            f'{path}: thermal frame is {thermal.dtype}; the Freiburg thermal '
            f'frames are 16-bit, clipped to [{IR_MINVAL}, {IR_MAXVAL}]')
    return np.clip(thermal, IR_MINVAL, IR_MAXVAL)


class MultimodalDetection(BaseDataset):
    classes = VOC_CLASSES

    def __init__(self, config, mode: str):
        super().__init__(config, mode)
        self.transformations = build_transformations(
            config.get(f'{"train" if mode == "train" else "val"}'
                       '_transformations', 'Normalizer,Resizer'),
            self.image_size, audio_time_only=self.device_audio_resize)
        self.ids = self.get_id_list()
        self.num_images = len(self.ids)
        # yield_batch's partner draws (the JAX package draws from an
        # unseeded default_rng)
        self.mix_rng = np.random.default_rng(
            config.getint('seed', fallback=0))

    def get_id_list(self) -> List[str]:
        path = os.path.join(self.data_path, "{}{}{}.txt".format(
            self.mode, self.daytime, self.drive_type))
        with open(path) as f:
            ids = [line.strip() for line in f if line.strip()]
        id_filter = self.config.get('id_filter', 'None')
        if 'None' not in id_filter:
            r = re.compile(id_filter)
            ids = [i for i in ids if r.match(i)]
        # Skip bogus timestamps (nsecs shorter than 9 digits,
        # reference MultimodalDetection.py:126-129)
        ids = [i for i in ids if len(i.split('/')[1].split('_')[1]) >= 9]
        ids.sort(key=_timestamp_key)
        return ids

    def get_paths(self, frame_id: str):
        drive, ts = frame_id.split('/')
        rgb = os.path.join(self.data_path, drive, 'fl_rgb',
                           f'fl_rgb_{ts}.jpg')
        thermal = os.path.join(self.data_path, drive, 'fl_ir_aligned',
                               f'fl_ir_aligned_{ts}.jpg')
        depth = os.path.join(self.data_path, drive, 'fl_rgb_depth',
                             f'fl_rgb_{ts}.jpg')
        audio = [os.path.join(self.data_path, drive, 'audio',
                              f'audio_{i}_{ts}.pkl') for i in range(8)]
        return rgb, thermal, depth, audio, None

    def _load_raw(self, frame_id: str) -> Dict:
        rgb_p, th_p, dp_p, audio_p, _ = self.get_paths(frame_id)
        rgb = bgr_to_rgb(imread(rgb_p))[:, CROP_LEFT:CROP_RIGHT, :]

        thermal = None
        if self.use_thermal:
            thermal = imread(th_p, IMREAD_ANYDEPTH)[:, CROP_LEFT:CROP_RIGHT]
            thermal = normalize_minmax(clip_thermal(thermal, th_p), 0, 255
                                       ).astype(np.float32)

        depth = None
        if self.use_depth:
            depth = imread(dp_p)[:, CROP_LEFT:CROP_RIGHT, :]

        audios = []
        for p in audio_p:
            with open(p, 'rb') as f:
                audios.append(pickle.load(f, encoding='latin1'))
        audio = np.transpose(np.stack(audios), (1, 2, 0))  # (80, T, 8)
        return {'rgb': rgb, 'thermal': thermal, 'depth': depth,
                'audio': audio, 'label': None, 'id': frame_id}

    def merge_audios(self, id1: str, id2: str) -> np.ndarray:
        """Mix two frames' audio at the waveform level and recompute the
        stretched spectrogram (reference MultimodalDetection.merge_audios,
        src/datasets/MultimodalDetection.py:329-353: librosa-load both mp3
        sets, average waveforms, melspectrogram, bicubic stretch to
        image_size x image_size). Requires decodable audio files (mp3 via
        ffmpeg / wav natively); the mel power spectrogram runs on the CPU."""
        _, _, _, paths1, _ = self.get_paths(id1)
        _, _, _, paths2, _ = self.get_paths(id2)
        specs = []
        for p1, p2 in zip(paths1, paths2):
            for ext in ('.mp3', '.wav'):
                c1 = p1.replace('.pkl', ext)
                c2 = p2.replace('.pkl', ext)
                if os.path.exists(c1) and os.path.exists(c2):
                    break
            a1 = decode_audio(c1)
            a2 = decode_audio(c2)
            n = min(len(a1), len(a2))
            mixed = (a1[:n] + a2[:n]) / 2
            specs.append(melspectrogram(torch.from_numpy(mixed[None]))[0]
                         .numpy())
        spec = np.transpose(np.stack(specs), (1, 2, 0))
        return stretch_bicubic(spec, self.image_size, self.image_size)

    def yield_batch(self, batch_size: int, ids,
                    rng: Optional[np.random.Generator] = None):
        """Random day-frame audio mixing for traditional_nms_kdlist_augmented
        (reference MultimodalDetection.py:355-367): returns (labels, audio)
        where each batch element's audio is mixed with a random other
        frame, drawn from `rng` (the dataset's seeded generator when None)."""
        rng = self.mix_rng if rng is None else rng
        audios, labels = [], []
        for i in range(batch_size):
            other = self.ids[int(rng.integers(0, len(self.ids)))]
            audios.append(self.merge_audios(ids[i], other))
            labels.append(None)
        return labels, np.stack(audios)

    def __getitem__(self, item: int) -> Dict:
        sample = self._load_raw(self.ids[item])
        if self.normalize:
            sample['rgb'] = sample['rgb'].astype(np.float32) / 255.
            if sample['thermal'] is not None:
                sample['thermal'] = sample['thermal'].astype(np.float32) / 255.
            if sample['depth'] is not None:
                sample['depth'] = sample['depth'].astype(np.float32) / 255.
        sample = self.transformations(sample)
        if sample['thermal'] is not None:
            sample['thermal'] = sample['thermal'][..., None]
        return sample
