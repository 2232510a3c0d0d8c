"""Host-side per-frame transformations, numpy and the port's imgproc (port of
mm_distillnet_tpu/data/transforms.py; no cv2).

Mirrors the active reference transforms
(reference src/datasets/transformations.py):
- Normalizer: ImageNet mean/std on RGB only (:315-330)
- Resizer: aspect-preserving INTER_LINEAR resize + zero-pad bottom/right to
  common_size for rgb/thermal/depth; full bicubic stretch for the audio
  spectrogram (:407-467); label boxes scaled by the same factor.

The bicubic stretch is `ops/resize.py`'s cv2-compatible matrix
(`imgproc.stretch_bicubic`). HSVAdjust and HorizontalFlip draw from a
`numpy.random.RandomState` they are given (the JAX transforms draw from
the global legacy stream: the same seed gives the same draws).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.audio import log_mel_batch
from .imgproc import hsv_to_rgb, resize_linear, rgb_to_hsv, stretch_bicubic

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


class Normalizer:
    def __init__(self, mean=IMAGENET_MEAN, std=IMAGENET_STD):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, sample: dict) -> dict:
        sample = dict(sample)
        sample['rgb'] = ((sample['rgb'].astype(np.float32) - self.mean)
                         / self.std)
        return sample


class Resizer:
    """aspect-preserving resize + zero-pad for images; bicubic stretch for
    the audio spectrogram (reference transformations.py:407-467).

    audio_time_only (config device_audio_resize): stretch only the time
    axis of the (80, T, M) spectrogram to common_size and leave the 80-mel
    axis for the device (ops/resize.stretch_mel_axis)."""

    def __init__(self, common_size: int = 768, audio_time_only: bool = False):
        self.common_size = common_size
        self.audio_time_only = audio_time_only

    def __call__(self, sample: dict) -> dict:
        sample = dict(sample)
        cs = self.common_size
        rgb = sample['rgb']
        h, w = rgb.shape[:2]
        if h > w:
            scale = cs / h
            rh, rw = cs, int(w * scale)
        else:
            scale = cs / w
            rh, rw = int(h * scale), cs

        def pad_to(img, channels):
            out = np.zeros((cs, cs, channels) if channels else (cs, cs),
                           np.float32)
            out[:img.shape[0], :img.shape[1]] = img
            return out

        sample['rgb'] = pad_to(
            resize_linear(rgb.astype(np.float32), rw, rh), 3)
        if sample.get('thermal') is not None:
            sample['thermal'] = pad_to(resize_linear(
                sample['thermal'].astype(np.float32), rw, rh), 0)
        if sample.get('depth') is not None:
            sample['depth'] = pad_to(resize_linear(
                sample['depth'].astype(np.float32), rw, rh), 3)
        if sample.get('audio') is not None:
            audio = sample['audio']
            out_h = audio.shape[0] if self.audio_time_only else cs
            sample['audio'] = stretch_bicubic(audio, out_h, cs)
        if sample.get('label') is not None and len(sample['label']):
            lab = np.asarray(sample['label'], np.float32).copy()
            lab[:, :4] *= scale
            sample['label'] = lab
        return sample


class HSVAdjust:
    """Random hue/saturation/value jitter on RGB (available-but-inactive in
    the reference, src/datasets/transformations.py HSVAdjust)."""

    def __init__(self, hue: float = 0.5, saturation: float = 1.5,
                 value: float = 1.5, prob: float = 0.5,
                 rng: Optional[np.random.RandomState] = None):
        self.hue, self.saturation, self.value = hue, saturation, value
        self.prob = prob
        self.rng = rng if rng is not None else np.random.RandomState()

    def __call__(self, sample: dict) -> dict:
        if self.rng.uniform() > self.prob:
            return sample
        sample = dict(sample)
        rgb = np.clip(sample['rgb'].astype(np.float32), 0, 1)
        hsv = rgb_to_hsv(rgb)
        hsv[..., 0] = (hsv[..., 0] +
                       self.rng.uniform(-self.hue, self.hue) * 360) % 360
        hsv[..., 1] *= self.rng.uniform(1 / self.saturation, self.saturation)
        hsv[..., 2] *= self.rng.uniform(1 / self.value, self.value)
        hsv[..., 1:] = np.clip(hsv[..., 1:], 0, 1)
        sample['rgb'] = hsv_to_rgb(hsv)
        return sample


class HorizontalFlip:
    """Random horizontal flip of all image modalities + label boxes
    (RGBFlip in the reference transform set)."""

    def __init__(self, prob: float = 0.5,
                 rng: Optional[np.random.RandomState] = None):
        self.prob = prob
        self.rng = rng if rng is not None else np.random.RandomState()

    def __call__(self, sample: dict) -> dict:
        if self.rng.uniform() > self.prob:
            return sample
        sample = dict(sample)
        width = sample['rgb'].shape[1]
        for key in ('rgb', 'thermal', 'depth'):
            if sample.get(key) is not None:
                sample[key] = np.ascontiguousarray(sample[key][:, ::-1])
        if sample.get('label') is not None and len(sample['label']):
            lab = np.asarray(sample['label'], np.float32).copy()
            x1 = lab[:, 0].copy()
            lab[:, 0] = width - lab[:, 2]
            lab[:, 2] = width - x1
            sample['label'] = lab
        return sample


class Compose:
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, sample):
        for t in self.transforms:
            sample = t(sample)
        return sample


class Audio2Spectogram:
    """Waveform -> stacked log-mel spectrograms (reference
    src/datasets/transformations.py:251-266, used when samples carry raw
    multi-mic PCM instead of precomputed pickles), through the port's
    frontend on the CPU."""

    def __call__(self, sample: dict) -> dict:
        audio = sample.get('audio')
        if audio is None or audio.ndim != 2:  # already a spectrogram stack
            return sample
        sample = dict(sample)
        out = log_mel_batch(torch.from_numpy(
            np.ascontiguousarray(audio, np.float32))[None])  # (1, 80, T, M)
        sample['audio'] = out[0].numpy()
        return sample


class AudioAugmenter:
    """Pass-through, matching the reference where every audio augmentation
    is commented out (src/datasets/transformations.py:470-522)."""

    def __call__(self, sample: dict) -> dict:
        return sample


TRANSFORM_REGISTRY = {
    'Normalizer': Normalizer,
    'Resizer': Resizer,
    'HSVAdjust': HSVAdjust,
    'HorizontalFlip': HorizontalFlip,
    'Audio2Spectogram': Audio2Spectogram,
    'AudioAugmenter': AudioAugmenter,
}


def build_transformations(names: str, image_size: int,
                          audio_time_only: bool = False,
                          rng: Optional[np.random.RandomState] = None
                          ) -> Compose:
    """From a config string like 'Normalizer,Resizer'; the random
    transforms share `rng` (a fresh RandomState when None)."""
    rng = rng if rng is not None else np.random.RandomState()
    ts = []
    for name in names.split(','):
        name = name.strip()
        if not name or name == 'None':
            continue
        cls = TRANSFORM_REGISTRY[name]
        if name == 'Resizer':
            ts.append(cls(common_size=image_size,
                          audio_time_only=audio_time_only))
        elif name in ('HSVAdjust', 'HorizontalFlip'):
            ts.append(cls(rng=rng))
        else:
            ts.append(cls())
    return Compose(ts)
