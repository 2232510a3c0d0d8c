"""Synthetic multimodal dataset: deterministic frames with planted objects
(port of mm_distillnet_tpu/data/synthetic.py; numpy only, the same frames
from the same seeds).

Used by tests, the GPU smoke run and CLI smoke runs when the real Freiburg dataset
is absent (it is not redistributable with the repo). Frames contain bright
rectangles ("cars") on structured noise so that detector training has
learnable signal; every modality renders the same geometry, and the audio
channel is a synthetic log-mel-like pattern whose energy correlates with
object position — a stand-in for the real dataset's cross-modal
correspondence.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from .base import BaseDataset, VOC_CLASSES


def _cache_budget_bytes() -> int:
    """Cache budget: half of currently-available host RAM (the loader's
    ThreadPoolExecutor shares one cache, and a full-size D2@768 synthetic
    epoch must leave room for collated batches). Falls
    back to a conservative 4 GiB if /proc/meminfo is unreadable."""
    try:
        with open('/proc/meminfo') as f:
            for line in f:
                if line.startswith('MemAvailable:'):
                    return int(line.split()[1]) * 1024 // 2
    except OSError:
        pass
    return 4 * 2 ** 30


class SyntheticMultimodal(BaseDataset):
    classes = VOC_CLASSES

    def __init__(self, config, mode: str, num_images: Optional[int] = None):
        super().__init__(config, mode)
        self.num_images = num_images if num_images is not None else \
            config.getint('synthetic_size', fallback=64)
        self.seed = {'train': 0, 'val': 10_000, 'test': 20_000}.get(mode, 0)
        self.ids = [f'synthetic_drive/{i:06d}_{900000000 + i:09d}_v'
                    for i in range(self.num_images)]
        self.car_label = self.valid_classes_dict['labels_txt2i'].get('car', 6)
        # In-memory sample cache: frame generation is ~12 size^2 RNG draws
        # per frame, which dominates end-to-end wall time on small hosts.
        # Samples are deterministic in
        # (seed, item), so caching is semantics-free. Gated by a byte
        # estimate so huge synthetic_size x image_size combos don't eat
        # the host (15 f32 planes per frame: rgb3+thermal1+depth3+audio8).
        est_bytes = self.num_images * self.image_size ** 2 * 15 * 4
        cache_on = config.getboolean('synthetic_cache', fallback=True)
        self._cache: Optional[Dict[int, Dict]] = \
            {} if cache_on and est_bytes < _cache_budget_bytes() else None

    def _boxes_for(self, rng: np.random.Generator, size: int) -> np.ndarray:
        n = rng.integers(1, 4)
        boxes = []
        for _ in range(n):
            w = rng.uniform(0.1, 0.35) * size
            h = rng.uniform(0.08, 0.25) * size
            x1 = rng.uniform(0, size - w)
            y1 = rng.uniform(0, size - h)
            boxes.append([x1, y1, x1 + w, y1 + h, self.car_label])
        return np.asarray(boxes, np.float32)

    def get_annotations(self, frame_id: str) -> np.ndarray:
        item = self.ids.index(frame_id)
        rng = np.random.default_rng(self.seed + item)
        return self._boxes_for(rng, self.image_size)

    def yield_batch(self, batch_size: int, ids):
        """Audio-mix machinery for traditional_nms_kdlist_augmented: mixes
        each frame's audio with a random other frame (labels become the
        union), mirroring MultimodalDetection.yield_batch."""
        rng = np.random.default_rng(self.seed + 777)
        audios, labels = [], []
        for i in range(batch_size):
            a = self[self.ids.index(ids[i])] if ids[i] in self.ids else \
                self[i % self.num_images]
            b = self[int(rng.integers(0, self.num_images))]
            audios.append((a['audio'] + b['audio']) / 2)
            labels.append(np.concatenate([a['label'], b['label']], axis=0))
        return labels, np.stack(audios)

    def __getitem__(self, item: int) -> Dict:
        if self._cache is not None:
            hit = self._cache.get(item)
            if hit is not None:
                return dict(hit)  # shallow dict copy; arrays are frozen
            sample = self._generate(item)
            for v in sample.values():  # freeze: an in-place transform on a
                if isinstance(v, np.ndarray):  # cached array must raise, not
                    v.flags.writeable = False  # corrupt all later epochs
            self._cache[item] = sample
            return dict(sample)
        return self._generate(item)

    def _generate(self, item: int) -> Dict:
        size = self.image_size
        rng = np.random.default_rng(self.seed + item)
        boxes = self._boxes_for(rng, size)

        yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
        base = 0.1 * np.sin(8 * np.pi * xx) * np.cos(6 * np.pi * yy)
        rgb = np.stack([base + 0.05 * rng.standard_normal((size, size))
                        for _ in range(3)], axis=-1).astype(np.float32)
        thermal = (base + 0.05 * rng.standard_normal((size, size))
                   )[..., None].astype(np.float32)
        depth = rgb[..., ::-1].copy()
        # Compact audio ingest (device_audio_resize): render the same
        # audio geometry on an 80-row mel grid — what the real dataset's
        # (80, T, 8) spectrogram stack looks like after the host-side
        # time-only stretch; the device stretches the mel axis to `size`
        # (ops/resize.stretch_mel_axis).
        mel_rows = 80 if self.device_audio_resize else size
        ay = (np.arange(mel_rows, dtype=np.float32) / mel_rows)[:, None]
        audio = np.repeat(
            (0.2 * np.sin(20 * np.pi * ay) * np.ones((1, size),
                                                     np.float32))[..., None],
            8, axis=-1).astype(np.float32)
        audio += 0.05 * rng.standard_normal(
            (mel_rows, size, 8)).astype(np.float32)
        row_scale = mel_rows / size

        for (x1, y1, x2, y2, _lab) in boxes:
            sl = np.s_[int(y1):int(y2), int(x1):int(x2)]
            rgb[sl] += 1.0
            thermal[sl] += 1.5
            depth[sl] += 0.8
            # audio energy band at the object's horizontal position, plus a
            # weaker full-extent response: a stand-in for the inter-mic
            # time/level differences that localize sources in the real
            # 8-mic log-mel stack — without it the audio modality carries
            # no vertical information and detection is unlearnable.
            audio[:, int(x1):int(x2), :] += 0.5
            if row_scale == 1.0:  # full-size path
                audio[sl] += 0.8
            else:
                audio[int(y1 * row_scale):int(np.ceil(y2 * row_scale)),
                      int(x1):int(x2), :] += 0.8

        return {'rgb': rgb, 'thermal': thermal, 'depth': depth,
                'audio': audio, 'label': boxes, 'id': self.ids[item]}
