"""Visual verification utilities (port of mm_distillnet_tpu/utils/plotting.py;
reference src/utils/utils.py:625-955, 2214-2414): prediction overlays on
images and spectrograms, attention-map dumps, written as PNG files.

Without cv2: the PNG writer is the standard library's zlib (the counterpart
of data/decode.py's reader), the colour maps are OpenCV's tables (JET in
data/imgproc.py, HOT and VIRIDIS in utils/plot_tables.py), min-max
normalisation is data/imgproc.normalize_minmax. Boxes are drawn as OpenCV
draws a 2-pixel rectangle (a 3-pixel band centred on each edge); labels
with a table of OpenCV's FONT_HERSHEY_SIMPLEX glyphs at scale 0.5
(scripts/torch_make_plot_tables.py), placed glyph by glyph, so text is
close to OpenCV's and not equal to it.
"""
from __future__ import annotations

import os
import struct
import zlib
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.imgproc import JET_BGR, normalize_minmax
from . import plot_tables

# deterministic box colour palette (the JAX package's)
_PALETTE = [(np.array([37 * (i + 1) % 256, 17 * (i + 3) % 256,
                       29 * (i + 7) % 256])).tolist() for i in range(64)]
HOT_BGR = np.frombuffer(bytes.fromhex(''.join(plot_tables.HOT_HEX)),
                        np.uint8).reshape(256, 3)
VIRIDIS_BGR = np.frombuffer(bytes.fromhex(''.join(plot_tables.VIRIDIS_HEX)),
                            np.uint8).reshape(256, 3)


def _glyph_offsets() -> Dict[str, Tuple[float, np.ndarray]]:
    out = {}
    for c, (adv, pts) in plot_tables.GLYPHS.items():
        xy = np.array([p.split(',') for p in pts.split()], np.int64) \
            if pts else np.zeros((0, 2), np.int64)
        out[c] = (adv, xy.reshape(-1, 2))
    return out


_GLYPHS = _glyph_offsets()


def write_png(path: str, img: np.ndarray) -> None:
    """Write a uint8 image (H, W) grey or (H, W, 3) BGR, as cv2.imwrite
    takes it, to an 8-bit PNG (RGB for colour)."""
    if img.dtype != np.uint8:
        raise ValueError(f'write_png takes uint8, not {img.dtype}')
    if img.ndim == 2:
        colour, data = 0, img
    elif img.ndim == 3 and img.shape[2] == 3:
        colour, data = 2, img[..., ::-1]
    else:
        raise ValueError(f'write_png takes (H, W) or (H, W, 3), not '
                         f'{img.shape}')
    h, w = data.shape[:2]
    rows = np.ascontiguousarray(data).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)

    def chunk(kind: bytes, payload: bytes) -> bytes:
        return (struct.pack('>I', len(payload)) + kind + payload
                + struct.pack('>I', zlib.crc32(kind + payload) & 0xffffffff))

    with open(path, 'wb') as f:
        f.write(b'\x89PNG\r\n\x1a\n')
        f.write(chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, 8, colour, 0, 0,
                                           0)))
        f.write(chunk(b'IDAT', zlib.compress(raw.tobytes(), 6)))
        f.write(chunk(b'IEND', b''))


def apply_colormap(grey: np.ndarray, table: np.ndarray) -> np.ndarray:
    """cv2.applyColorMap with one of the 256-entry BGR tables: uint8
    (H, W) -> BGR (H, W, 3)."""
    if grey.dtype != np.uint8:
        raise ValueError(f'apply_colormap takes uint8, not {grey.dtype}')
    return table[grey]


def _fill(img: np.ndarray, x0: int, y0: int, x1: int, y1: int,
          color) -> None:
    """Set the pixels of [x0, x1] x [y0, y1], clipped to the image."""
    h, w = img.shape[:2]
    x0, y0 = max(x0, 0), max(y0, 0)
    x1, y1 = min(x1, w - 1), min(y1, h - 1)
    if x0 <= x1 and y0 <= y1:
        img[y0:y1 + 1, x0:x1 + 1] = color


def draw_rectangle(img: np.ndarray, p0: Tuple[int, int],
                   p1: Tuple[int, int], color) -> None:
    """cv2.rectangle(img, p0, p1, color, 2): each edge as a 3-pixel band
    centred on it between its end points (OpenCV's thick line of width 2),
    the round caps of radius 1 leaving the four outer corner pixels
    unset."""
    (x1, y1), (x2, y2) = p0, p1
    xa, xb = min(x1, x2), max(x1, x2)
    ya, yb = min(y1, y2), max(y1, y2)
    for y in (ya, yb):
        _fill(img, xa, y - 1, xb, y + 1, color)
    for x in (xa, xb):
        _fill(img, x - 1, ya, x + 1, yb, color)


def draw_text(img: np.ndarray, text: str, org: Tuple[int, int],
              color) -> None:
    """cv2.putText(img, text, org, FONT_HERSHEY_SIMPLEX, 0.5, color, 1),
    glyph by glyph from the table (close to OpenCV's, not equal)."""
    h, w = img.shape[:2]
    x = 0.0
    for c in text:
        adv, xy = _GLYPHS.get(c, _GLYPHS['?'])
        px = xy[:, 0] + org[0] + int(np.floor(x))
        py = xy[:, 1] + org[1]
        keep = (px >= 0) & (px < w) & (py >= 0) & (py < h)
        img[py[keep], px[keep]] = color
        x += adv


def draw_predictions(image: np.ndarray, rows: Sequence[Sequence[float]],
                     class_names: Optional[Sequence[str]] = None
                     ) -> np.ndarray:
    """rows: [x1, y1, x2, y2, (score,) label]. Returns a uint8 BGR image
    with boxes and labels drawn."""
    img = image.copy()
    if img.dtype != np.uint8:
        lo, hi = float(img.min()), float(img.max())
        img = ((img - lo) / (hi - lo + 1e-9) * 255).astype(np.uint8)
    if img.ndim == 2 or img.shape[-1] == 1:
        img = np.repeat(img.reshape(img.shape[0], img.shape[1], 1), 3, -1)
    elif img.shape[-1] > 3:
        img = np.repeat(img[..., :1], 3, -1)
    img = np.ascontiguousarray(img)
    for row in rows:
        label = int(row[-1])
        color = _PALETTE[label % len(_PALETTE)]
        x1, y1, x2, y2 = (int(v) for v in row[:4])
        draw_rectangle(img, (x1, y1), (x2, y2), color)
        text = (class_names[label] if class_names and
                0 <= label < len(class_names) else str(label))
        if len(row) == 6:
            text += f' {row[4]:.2f}'
        draw_text(img, text, (x1, max(y1 - 4, 10)), color)
    return img


def save_attention_map(feature: np.ndarray, path: str, p: float = 2.0):
    """Dump the MTA spatial attention map of an NHWC feature as a JET
    heatmap (reference plot_audio_predictions, utils.py:2276-2282)."""
    att = np.mean(np.power(feature, p), axis=-1)
    att = (att - att.min()) / (att.max() - att.min() + 1e-9)
    write_png(path, apply_colormap((att * 255).astype(np.uint8), JET_BGR))


def plot_audio_predictions(teacher_models: Dict[str, Tuple[Any, Any]],
                           student_model: Tuple[Any, Any], dataset, config,
                           frame_id: str, out_dir: Optional[str] = None,
                           device='cuda'):
    """Render the debug-plot set for one frame (--just_plot of the evaluate
    CLI), as the JAX package does (reference utils.py:2214-2414):

    - per-level attention maps of the student's BiFPN features
      (`<id>.activation_<H>.png`);
    - the student's predictions over the spectrogram, rgb, thermal (HOT
      map) and depth renders;
    - the fused teachers' pseudo-GT over the rgb render, when there is any;
    - one VIRIDIS spectrogram image per microphone (`<id>.specshow_<m>.png`).

    The networks run their unfused eval forward, as the JAX package's do
    here whatever `fused_inference` says. Returns the student's rows."""
    from ..config import config_from_dict
    from ..data.base import prediction_to_label_lut, valid_prediction_ids
    from ..evaluation import make_fused_teacher_fn, make_predict_fn
    from ..ops.postprocess import class_validity_table

    config = config_from_dict({**dict(config), 'fused_inference': False})
    out_dir = out_dir or config.get('exp_name', 'run')
    os.makedirs(out_dir, exist_ok=True)
    idx = dataset.ids.index(frame_id) if frame_id in dataset.ids else 0
    sample = dataset[idx]
    image_size = config.getint('image_size')
    num_classes = student_model[0].num_classes
    names = list(dataset.classes)
    safe_id = frame_id.replace('/', '_')

    vcd = dataset.valid_classes_dict
    class_valid = class_validity_table(num_classes, valid_prediction_ids(vcd))
    pred_to_label = prediction_to_label_lut(vcd, num_classes)

    predict = make_predict_fn(student_model[0], image_size, config,
                              device=device)
    rows, features = predict(student_model[1],
                             torch.tensor(sample['audio'][None]),
                             class_valid, pred_to_label)
    rows = [r.tolist() for r in rows.cpu().numpy()[0] if r[5] != -1]

    for feature in features:
        f = feature[0].float().cpu().numpy()
        save_attention_map(
            f, os.path.join(out_dir, f'{safe_id}.activation_{f.shape[0]}.png'))

    fused_rows = []
    if teacher_models:
        fused_fn = make_fused_teacher_fn(
            {m: mv[0] for m, mv in teacher_models.items()}, image_size,
            config, device=device)
        inputs = {m: torch.tensor(np.asarray(sample[m])[None])
                  for m in ('rgb', 'thermal', 'depth', 'audio')
                  if sample.get(m) is not None}
        fused = fused_fn({m: mv[1] for m, mv in teacher_models.items()},
                         inputs, class_valid, pred_to_label)
        fused_rows = [r.tolist() for r in fused.cpu().numpy()[0]
                      if r[-1] != -1]

    write_png(os.path.join(out_dir, f'{safe_id}.student.png'),
              draw_predictions(sample['audio'][..., 0], rows, names))
    rgb = sample.get('rgb')
    if rgb is not None:
        write_png(os.path.join(out_dir, f'{safe_id}.rgb.png'),
                  draw_predictions(rgb, rows, names))
        if fused_rows:
            write_png(
                os.path.join(out_dir, f'{safe_id}.rgb.fused_teachers.png'),
                draw_predictions(rgb, fused_rows, names))
    thermal = sample.get('thermal')
    if thermal is not None:
        t8 = normalize_minmax(thermal.reshape(thermal.shape[0],
                                              thermal.shape[1]), 0, 255)
        hot = apply_colormap(t8.astype(np.uint8), HOT_BGR)
        write_png(os.path.join(out_dir, f'{safe_id}.thermal.png'),
                  draw_predictions(hot, rows, names))
    depth = sample.get('depth')
    if depth is not None:
        write_png(os.path.join(out_dir, f'{safe_id}.depth.png'),
                  draw_predictions(depth, rows, names))

    for mic in range(sample['audio'].shape[-1]):
        ch = sample['audio'][..., mic]
        lo, hi = float(ch.min()), float(ch.max())
        ch8 = ((ch - lo) / (hi - lo + 1e-9) * 255).astype(np.uint8)
        write_png(os.path.join(out_dir, f'{safe_id}.specshow_{mic}.png'),
                  apply_colormap(ch8, VIRIDIS_BGR))
    return rows
