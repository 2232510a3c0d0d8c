"""Image operations without cv2: the port's copies of the cv2 calls the
datasets and transforms make (mm_distillnet_tpu/data/*.py), in numpy.

- `bgr_to_rgb`: cv2.cvtColor(COLOR_BGR2RGB) and back; exact.
- `normalize_minmax`: cv2.normalize(src, None, alpha, beta, NORM_MINMAX)
  for an integer image. cv2 keeps the source dtype: it takes scale and
  shift in float64, casts them to float32 and runs convertTo, whose SIMD
  loop computes fma(x, scale, shift) in float32 and rounds half to even.
  Repeated here exactly (the float32 product of a 16-bit sample is exact in
  float64); bit-equal to cv2.
- `stretch_bicubic`: the audio spectrogram's bicubic stretch with
  `ops/resize.py`'s cv2-compatible matrix (INTER_CUBIC's kernel), applied
  as its 4 taps per output row.
- `resize_linear`: cv2.resize(INTER_LINEAR), half-pixel centres, clamped
  borders, no area filter when downscaling. cv2 runs images of up to 4
  channels through its IPP HAL, which takes each tap's fraction in
  float64, and wider ones through its own loop, which takes it in
  float32; so does this. float32 images: the
  horizontal then the vertical 2-tap pass in float32, within 1 ulp of cv2
  (the HAL's own order of operations is not public). uint8 images: cv2's
  11-bit fixed-point coefficients and the rounding of its vertical pass;
  within 1 LSB of cv2.
- `rgb_to_hsv` / `hsv_to_rgb`: cv2.cvtColor(COLOR_RGB2HSV / HSV2RGB) for
  float32 images, H in [0, 360), S and V in [0, 1]; OpenCV's formulas in
  float32.
- `apply_colormap_jet`: cv2.applyColorMap(COLORMAP_JET) as its 256-entry
  BGR table, taken from cv2 once and held to it by the tests.

The float32 passes run in csrc/image_decode.cpp (`filter_cols`,
`filter_rows`), which releases the interpreter lock, so the loader's
threads resample in parallel; a multithreaded BLAS under six loader
threads was slower than one thread.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np

from ..ops.resize import resize_matrix
from .decode import native

_FLT_EPSILON = np.float32(np.finfo(np.float32).eps)


def bgr_to_rgb(img: np.ndarray) -> np.ndarray:
    """Swap the first and third channels (cv2.COLOR_BGR2RGB, RGB2BGR)."""
    return np.ascontiguousarray(img[..., ::-1])


def normalize_minmax(src: np.ndarray, alpha: float = 0.0,
                     beta: float = 255.0) -> np.ndarray:
    """cv2.normalize(src, None, alpha, beta, cv2.NORM_MINMAX) for an
    integer or float32 image: the result keeps src's dtype (a float32
    product is not exact in float64, so there the result may sit 1 ulp
    from cv2's)."""
    if src.dtype not in (np.uint8, np.uint16, np.float32):
        raise ValueError(f'normalize_minmax takes uint8, uint16 or float32, '
                         f'not {src.dtype}')
    smin, smax = float(src.min()), float(src.max())
    dmin, dmax = min(alpha, beta), max(alpha, beta)
    eps = float(np.finfo(np.float64).eps)
    scale = (dmax - dmin) * (1.0 / (smax - smin) if smax - smin > eps
                             else 0.0)
    shift = dmin - smin * scale
    # fma in float32: the float64 product is exact, one rounding to float32
    t = (src.astype(np.float64) * float(np.float32(scale))
         + float(np.float32(shift))).astype(np.float32)
    if src.dtype == np.float32:
        return t
    info = np.iinfo(src.dtype)
    return np.clip(np.rint(t), info.min, info.max).astype(src.dtype)


@functools.lru_cache(maxsize=64)
def _taps(dst: int, src: int, clamp_fraction: bool, hal: bool
          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Source indices and float32 weights of the two taps of each output
    sample. Columns (clamp_fraction) move a tap that falls outside to the
    edge with weight 0, as cv2's xofs/alpha; rows keep their fraction and
    clamp the row index, as cv2's row fetch. `hal`: the fraction in float64
    (cv2's IPP HAL, up to 4 channels), else in float32 (cv2's own loop)."""
    scale = 1.0 / (dst / src)
    f = (np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5
    if not hal:
        f = f.astype(np.float32)
    s = np.floor(f)
    frac = (f - s).astype(np.float32)
    s = s.astype(np.int64)
    if clamp_fraction:
        out = (s < 0) | (s >= src - 1)
        frac[out] = 0
        s = np.clip(s, 0, src - 1)
    i0 = np.clip(s, 0, src - 1)
    i1 = np.clip(s + 1, 0, src - 1)
    return i0, i1, np.float32(1) - frac, frac


def filter_cols(img: np.ndarray, idx: np.ndarray, w: np.ndarray
                ) -> np.ndarray:
    """(rows, cols_in, C) float32 -> (rows, len(idx), C): output column x
    is sum_t w[x, t] * img[:, idx[x, t]], in tap order."""
    img = np.ascontiguousarray(img, np.float32)
    idx = np.ascontiguousarray(idx, np.int64)
    w = np.ascontiguousarray(w, np.float32)
    rows, cols_in, channels = img.shape
    if idx.shape != w.shape or idx.ndim != 2 or idx.size == 0 or \
            idx.min() < 0 or idx.max() >= cols_in:
        raise ValueError(f'filter_cols: taps {idx.shape} outside {cols_in}')
    out = np.empty((rows, idx.shape[0], channels), np.float32)
    native().mmdt_filter_cols(img.ctypes.data, out.ctypes.data, rows,
                              cols_in, idx.shape[0], channels, idx.shape[1],
                              idx.ctypes.data, w.ctypes.data)
    return out


def filter_rows(x: np.ndarray, idx: np.ndarray, w: np.ndarray
                ) -> np.ndarray:
    """(rows_in, ...) float32 -> (len(idx), ...): output row r is
    sum_t w[r, t] * x[idx[r, t]], in tap order."""
    x = np.ascontiguousarray(x, np.float32)
    idx = np.ascontiguousarray(idx, np.int64)
    w = np.ascontiguousarray(w, np.float32)
    if idx.shape != w.shape or idx.ndim != 2 or idx.size == 0 or \
            idx.min() < 0 or idx.max() >= x.shape[0]:
        raise ValueError(f'filter_rows: taps {idx.shape} outside '
                         f'{x.shape[0]}')
    out = np.empty((idx.shape[0],) + x.shape[1:], np.float32)
    native().mmdt_filter_rows(x.ctypes.data, out.ctypes.data, idx.shape[0],
                              x[0].size, idx.shape[1], idx.ctypes.data,
                              w.ctypes.data)
    return out


@functools.lru_cache(maxsize=16)
def _cubic_taps(out_size: int, in_size: int) -> Tuple[np.ndarray,
                                                      np.ndarray]:
    """The (at most 4) nonzero columns of each row of resize_matrix and
    their weights, padded with weight 0."""
    mat = resize_matrix(out_size, in_size)
    idx = np.zeros((out_size, 4), np.int64)
    w = np.zeros((out_size, 4), np.float32)
    for r in range(out_size):
        cols = np.nonzero(mat[r])[0]
        idx[r, :len(cols)] = cols
        w[r, :len(cols)] = mat[r, cols]
    return idx, w


def stretch_bicubic(spec: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """(H, W, C) -> (out_h, out_w, C) bicubic (cv2.INTER_CUBIC's kernel,
    `ops/resize.py` resize_matrix), float32; an axis already at its size is
    left as it is."""
    x = np.ascontiguousarray(spec, np.float32)
    h, w = x.shape[:2]
    if w != out_w:
        x = filter_cols(x, *_cubic_taps(out_w, w))
    if h != out_h:
        x = filter_rows(x, *_cubic_taps(out_h, h))
    return x


def resize_linear(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """cv2.resize(img, (width, height)) with INTER_LINEAR, for float32 or
    uint8 images of shape (H, W) or (H, W, C); like cv2, (H, W, 1) comes
    back as (height, width)."""
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    h_in, w_in = img.shape[:2]
    hal = img.ndim == 2 or img.shape[2] <= 4
    x0, x1, a0, a1 = _taps(width, w_in, True, hal)
    y0, y1, b0, b1 = _taps(height, h_in, False, hal)
    if img.dtype == np.float32:
        # the horizontal pass on the rows the vertical pass reads only
        rows, inv = np.unique(np.concatenate([y0, y1]), return_inverse=True)
        part = img[rows] if len(rows) < h_in else img
        if part.ndim == 2:
            part = part[..., None]
        tmp = filter_cols(part, np.stack([x0, x1], 1), np.stack([a0, a1], 1))
        out = filter_rows(tmp, np.stack([inv[:height], inv[height:]], 1),
                          np.stack([b0, b1], 1))
        return out[..., 0] if img.ndim == 2 else out
    if img.dtype != np.uint8:
        raise ValueError(f'resize_linear takes float32 or uint8, not '
                         f'{img.dtype}')
    col = (1, -1) + (1,) * (img.ndim - 2)
    row = (-1, 1) + (1,) * (img.ndim - 2)
    one = np.float32(1 << 11)   # INTER_RESIZE_COEF_SCALE
    ia0, ia1, ib0, ib1 = (np.rint(c * one).astype(np.int32)
                          for c in (a0, a1, b0, b1))
    src = img.astype(np.int32)
    tmp = src[:, x0] * ia0.reshape(col) + src[:, x1] * ia1.reshape(col)
    s0, s1 = tmp[y0] >> 4, tmp[y1] >> 4
    # cv2's vertical pass: 16-bit high products, then (x + 2) >> 2
    out = ((s0 * ib0.reshape(row)) >> 16) + ((s1 * ib1.reshape(row)) >> 16)
    return np.clip((out + 2) >> 2, 0, 255).astype(np.uint8)


def rgb_to_hsv(rgb: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(rgb, COLOR_RGB2HSV) for float32: H in [0, 360)."""
    rgb = rgb.astype(np.float32, copy=False)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    v = np.maximum(np.maximum(r, g), b)
    vmin = np.minimum(np.minimum(r, g), b)
    diff = v - vmin
    s = diff / (np.abs(v) + _FLT_EPSILON)
    k = (np.float32(60.0) / (diff + _FLT_EPSILON)).astype(np.float32)
    h = np.where(v == r, (g - b) * k,
                 np.where(v == g, (b - r) * k + np.float32(120.0),
                          (r - g) * k + np.float32(240.0)))
    h = np.where(h < 0, h + np.float32(360.0), h)
    return np.stack([h, s, v], axis=-1).astype(np.float32)


# sector -> (b, g, r) index into (v, v(1-s), v(1-sh), v(1-s(1-h)))
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3],
                     [2, 1, 0]])


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(hsv, COLOR_HSV2RGB) for float32, H in degrees."""
    hsv = hsv.astype(np.float32, copy=False)
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    h = np.fmod(h * np.float32(6.0 / 360.0), np.float32(6.0))
    h = np.where(h < 0, h + np.float32(6.0), h)
    sector = np.floor(h).astype(np.int64)
    h = h - sector.astype(np.float32)
    bad = (sector < 0) | (sector >= 6)
    sector = np.where(bad, 0, sector)
    h = np.where(bad, np.float32(0), h)
    one = np.float32(1.0)
    tab = np.stack([v, v * (one - s), v * (one - s * h),
                    v * (one - s * (one - h))], axis=-1)
    idx = _SECTORS[sector]                       # (..., 3): b, g, r
    bgr = np.take_along_axis(tab, idx, axis=-1)
    rgb = bgr[..., ::-1]
    grey = (s == 0)[..., None]
    return np.where(grey, v[..., None], rgb).astype(np.float32)


# cv2.applyColorMap(np.arange(256, dtype=np.uint8), cv2.COLORMAP_JET): the
# 256 BGR entries, row by row
_JET_HEX = (
    '8000008400008800008c00009000009400009800009c0000a00000a40000a80000ac0000'
    'b00000b40000b80000bc0000c00000c40000c80000cc0000d00000d40000d80000dc0000'
    'e00000e40000e80000ec0000f00000f40000f80000fc0000ff0000ff0400ff0800ff0c00'
    'ff1000ff1400ff1800ff1c00ff2000ff2400ff2800ff2c00ff3000ff3400ff3800ff3c00'
    'ff4000ff4400ff4800ff4c00ff5000ff5400ff5800ff5c00ff6000ff6400ff6800ff6c00'
    'ff7000ff7400ff7800ff7c00ff8000ff8400ff8800ff8c00ff9000ff9400ff9800ff9c00'
    'ffa000ffa400ffa800ffac00ffb000ffb400ffb800ffbc00ffc000ffc400ffc800ffcc00'
    'ffd000ffd400ffd800ffdc00ffe000ffe400ffe800ffec00fff000fff400fff800fffc00'
    'feff02faff06f6ff0af2ff0eeeff12eaff16e6ff1ae2ff1edeff22daff26d6ff2ad2ff2e'
    'ceff32caff36c6ff3ac2ff3ebeff42baff46b6ff4ab2ff4eaeff52aaff56a6ff5aa2ff5e'
    '9eff629aff6696ff6a92ff6e8eff728aff7686ff7a82ff7e7eff827aff8676ff8a72ff8e'
    '6eff926aff9666ff9a62ff9e5effa25affa656ffaa52ffae4effb24affb646ffba42ffbe'
    '3effc23affc636ffca32ffce2effd22affd626ffda22ffde1effe21affe616ffea12ffee'
    '0efff20afff606fffa01fffe00fcff00f8ff00f4ff00f0ff00ecff00e8ff00e4ff00e0ff'
    '00dcff00d8ff00d4ff00d0ff00ccff00c8ff00c4ff00c0ff00bcff00b8ff00b4ff00b0ff'
    '00acff00a8ff00a4ff00a0ff009cff0098ff0094ff0090ff008cff0088ff0084ff0080ff'
    '007cff0078ff0074ff0070ff006cff0068ff0064ff0060ff005cff0058ff0054ff0050ff'
    '004cff0048ff0044ff0040ff003cff0038ff0034ff0030ff002cff0028ff0024ff0020ff'
    '001cff0018ff0014ff0010ff000cff0008ff0004ff0000ff0000fc0000f80000f40000f0'
    '0000ec0000e80000e40000e00000dc0000d80000d40000d00000cc0000c80000c40000c0'
    '0000bc0000b80000b40000b00000ac0000a80000a40000a000009c000098000094000090'
    '00008c000088000084000080'
)
JET_BGR = np.frombuffer(bytes.fromhex(''.join(_JET_HEX)),
                        np.uint8).reshape(256, 3)


def apply_colormap_jet(grey: np.ndarray) -> np.ndarray:
    """cv2.applyColorMap(grey, COLORMAP_JET): uint8 (H, W) -> BGR
    (H, W, 3)."""
    if grey.dtype != np.uint8:
        raise ValueError(f'apply_colormap_jet takes uint8, not {grey.dtype}')
    return JET_BGR[grey]
