"""Anchor table (port of mm_distillnet_tpu/ops/anchors.py).

5 pyramid levels (P3..P7, strides 8..128), 3 scales x 3 ratios = 9 anchors
per cell, [y1, x1, y2, x2] in input pixels, cell-major (row-major y, x),
anchor index = scale*len(ratios) + ratio. 110,484 rows at 768x768.
"""
from __future__ import annotations

import functools
import itertools
from typing import Sequence, Tuple

import numpy as np
import torch

DEFAULT_PYRAMID_LEVELS = (3, 4, 5, 6, 7)
DEFAULT_SCALES = (2 ** 0, 2 ** (1.0 / 3.0), 2 ** (2.0 / 3.0))
DEFAULT_RATIOS = ((1.0, 1.0), (1.4, 0.7), (0.7, 1.4))


@functools.lru_cache(maxsize=None)
def anchor_table(image_size: int, anchor_scale: float = 4.0,
                 pyramid_levels: Tuple[int, ...] = DEFAULT_PYRAMID_LEVELS,
                 scales: Tuple[float, ...] = DEFAULT_SCALES,
                 ratios: Tuple[Tuple[float, float], ...] = DEFAULT_RATIOS,
                 ) -> np.ndarray:
    """Returns (N, 4) float32 anchors [y1, x1, y2, x2] (numpy, built once)."""
    strides = [2 ** lvl for lvl in pyramid_levels]
    boxes_all = []
    for stride in strides:
        if image_size % stride != 0:
            raise ValueError('input size must be divided by the stride.')
        boxes_level = []
        for scale, ratio in itertools.product(scales, ratios):
            base = anchor_scale * stride * scale
            ax2 = base * ratio[0] / 2.0
            ay2 = base * ratio[1] / 2.0
            x = np.arange(stride / 2, image_size, stride)
            y = np.arange(stride / 2, image_size, stride)
            xv, yv = np.meshgrid(x, y)
            xv, yv = xv.reshape(-1), yv.reshape(-1)
            boxes = np.stack([yv - ay2, xv - ax2, yv + ay2, xv + ax2], axis=1)
            boxes_level.append(boxes[:, None, :])
        boxes_level = np.concatenate(boxes_level, axis=1)  # (HW, 9, 4)
        boxes_all.append(boxes_level.reshape(-1, 4))
    return np.vstack(boxes_all).astype(np.float32)


def num_anchors(image_size: int,
                pyramid_levels: Sequence[int] = DEFAULT_PYRAMID_LEVELS,
                num_per_cell: int = 9) -> int:
    return sum((image_size // 2 ** lvl) ** 2 * num_per_cell
               for lvl in pyramid_levels)


@functools.lru_cache(maxsize=None)
def anchor_index_tables(image_size: int, anchor_scale: float = 4.0,
                        pyramid_levels: Tuple[int, ...] = DEFAULT_PYRAMID_LEVELS,
                        scales: Tuple[float, ...] = DEFAULT_SCALES,
                        ratios: Tuple[Tuple[float, float], ...] = DEFAULT_RATIOS):
    """Per-level (start offset, stride, grid width) plus the 9 per-cell
    half-sizes (ay2, ax2) per level, for computing anchors from indices."""
    n_per = len(scales) * len(ratios)
    starts, strides, widths, half_sizes = [], [], [], []
    off = 0
    for lvl in pyramid_levels:
        stride = 2 ** lvl
        w = image_size // stride
        starts.append(off)
        strides.append(stride)
        widths.append(w)
        half_sizes.append([(anchor_scale * stride * scale * ratio[1] / 2.0,
                            anchor_scale * stride * scale * ratio[0] / 2.0)
                           for scale in scales for ratio in ratios])
        off += w * w * n_per
    return (np.asarray(starts, np.int32), np.asarray(strides, np.float32),
            np.asarray(widths, np.int32),
            np.asarray(half_sizes, np.float32), n_per)


_DEVICE_TABLES: dict = {}


def _tables_on(image_size: int, anchor_scale: float, dev: torch.device):
    """anchor_index_tables as tensors on `dev`, made once per device (a
    copy from the host in every call could not be captured in a CUDA
    graph); not kept while torch.export traces, where they are the
    program's constants."""
    key = (image_size, anchor_scale, dev)
    tables = _DEVICE_TABLES.get(key)
    if tables is None:
        *arrays, n_per = anchor_index_tables(image_size, anchor_scale)
        tables = (*(torch.as_tensor(a, device=dev) for a in arrays), n_per)
        if not torch.compiler.is_exporting():
            _DEVICE_TABLES[key] = tables
    return tables


def anchors_from_indices(idx: torch.Tensor, image_size: int,
                         anchor_scale: float = 4.0) -> torch.Tensor:
    """[y1, x1, y2, x2] anchors for flat anchor indices `idx` (any shape),
    from small tables instead of a gather over the whole table. The float32
    arithmetic is the reference's, so results are bit-equal to
    mm_distillnet_tpu's anchors_from_indices (and within 1e-4 of the
    float64-built table)."""
    starts_t, strides_t, widths_t, hs, n_per = _tables_on(
        image_size, anchor_scale, idx.device)                # hs (L, 9, 2)

    idx = idx.to(torch.int32)
    level = (idx[..., None] >= starts_t).sum(-1) - 1
    local = idx - starts_t[level]
    cell = torch.div(local, n_per, rounding_mode='floor')
    k = local - cell * n_per
    w = widths_t[level]
    row = torch.div(cell, w, rounding_mode='floor')
    cy = row.to(torch.float32)
    cx = (cell - row * w).to(torch.float32)
    stride = strides_t[level]
    yc = (cy + 0.5) * stride
    xc = (cx + 0.5) * stride
    sz = hs[level, k]                                        # (..., 2)
    ay2, ax2 = sz[..., 0], sz[..., 1]
    return torch.stack([yc - ay2, xc - ax2, yc + ay2, xc + ax2], dim=-1)
