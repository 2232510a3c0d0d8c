"""Separable bicubic resize as two matrix products (port of
mm_distillnet_tpu/ops/resize.py; cv2.INTER_CUBIC-compatible).

OpenCV's bicubic kernel uses A = -0.75 with half-pixel centres and
replicated borders. The (out, in) interpolation matrix of each axis is built
once in float64 with numpy and applied as a dense fp32 product. The
reference does the same with an einsum outside any kernel, so this is plain
`torch.einsum`.

`stretch_mel_axis` is the device half of the compact audio ingest: the host
stretches only the spectrogram's time axis, and the 80 mel rows are
stretched to the image height on the device.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

_A = -0.75  # OpenCV's bicubic coefficient


def _cubic_kernel(x: np.ndarray) -> np.ndarray:
    ax = np.abs(x)
    ax2 = ax * ax
    ax3 = ax2 * ax
    return np.where(
        ax <= 1.0,
        (_A + 2.0) * ax3 - (_A + 3.0) * ax2 + 1.0,
        np.where(ax < 2.0,
                 _A * ax3 - 5.0 * _A * ax2 + 8.0 * _A * ax - 4.0 * _A,
                 0.0))


@functools.lru_cache(maxsize=None)
def resize_matrix(out_size: int, in_size: int) -> np.ndarray:
    """(out_size, in_size) bicubic interpolation matrix with half-pixel
    centres and clamped (replicated) borders, matching cv2.resize."""
    scale = in_size / out_size
    dst = np.arange(out_size, dtype=np.float64)
    src = (dst + 0.5) * scale - 0.5
    base = np.floor(src).astype(np.int64)
    frac = src - base
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    for tap in (-1, 0, 1, 2):
        w = _cubic_kernel(tap - frac)
        idx = np.clip(base + tap, 0, in_size - 1)
        np.add.at(mat, (dst.astype(np.int64), idx), w)
    return mat.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _matrix_on(out_size: int, in_size: int,
               device: torch.device) -> torch.Tensor:
    """The matrix on `device`, copied there once."""
    return torch.from_numpy(resize_matrix(out_size, in_size)).to(device)


def resize_bicubic(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """(..., H, W, C) -> (..., out_h, out_w, C) bicubic resize, fp32."""
    h, w = img.shape[-3], img.shape[-2]
    x = img.float()
    x = torch.einsum('oh,...hwc->...owc', _matrix_on(out_h, h, x.device), x)
    return torch.einsum('pw,...owc->...opc', _matrix_on(out_w, w, x.device),
                        x)


def stretch_mel_axis(x: torch.Tensor, out_h: int) -> torch.Tensor:
    """(..., H_mel, W, C) -> (..., out_h, W, C), in x's dtype (the product
    runs in fp32). No-op when the input is already at out_h."""
    h = x.shape[-3]
    if h == out_h:
        return x
    y = torch.einsum('oh,...hwc->...owc', _matrix_on(out_h, h, x.device),
                     x.float())
    return y.to(x.dtype)


# The dataset's mel frontend produces exactly this many mel bins (reference
# src/utils/post_processing.py, librosa n_mels=80): the compact ingest ships
# (B, 80, S, M) stacks, so 80 is the only height besides image_size that a
# well-formed batch can carry.
MEL_BINS = 80


def maybe_stretch_mel_axis(x: torch.Tensor, image_size: int) -> torch.Tensor:
    """Dispatch by shape for the compact audio ingest: full-size batches
    pass through untouched; (B, 80, S, M) compact stacks get the mel-axis
    stretch; anything else is a malformed batch and raises."""
    h = x.shape[-3]
    if h == image_size:
        return x
    if h != MEL_BINS:
        raise ValueError(
            f'batch height {h} is neither image_size={image_size} nor the '
            f'compact-ingest mel-bin count {MEL_BINS}; refusing to resize a '
            f'malformed input (shape {tuple(x.shape)})')
    return stretch_mel_axis(x, image_size)
