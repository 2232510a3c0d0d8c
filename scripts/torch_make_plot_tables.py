#!/usr/bin/env python3
"""Write mm_distillnet_torch/utils/plot_tables.py: the tables the port's
plotting (utils/plotting.py) needs from OpenCV, which the port does not
import.

    python scripts/torch_make_plot_tables.py

- HOT and VIRIDIS: cv2.applyColorMap(np.arange(256, dtype=np.uint8),
  COLORMAP_HOT / COLORMAP_VIRIDIS), the 256 BGR entries as hex;
- GLYPHS: for each printable ASCII character, what cv2.putText(img, c,
  org, FONT_HERSHEY_SIMPLEX, 0.5, 255, 1) sets, as (dx, dy) offsets from
  `org`, and its advance in pixels (measured from getTextSize over a run
  of the character). cv2 places Hershey strokes at half-pixel steps, so a
  string drawn glyph by glyph from this table is close to cv2's, not equal.

Needs cv2, which the port itself does not import.
"""
from __future__ import annotations

import os

import cv2
import numpy as np

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'mm_distillnet_torch', 'utils', 'plot_tables.py')
FONT = cv2.FONT_HERSHEY_SIMPLEX
SCALE = 0.5


def _lut_hex(cmap: int) -> list:
    lut = cv2.applyColorMap(np.arange(256, dtype=np.uint8).reshape(1, -1),
                            cmap).reshape(-1)
    h = lut.tobytes().hex()
    return [h[i:i + 72] for i in range(0, len(h), 72)]


def _glyph(c: str):
    canvas = np.zeros((64, 64), np.uint8)
    org = (16, 40)
    cv2.putText(canvas, c, org, FONT, SCALE, 255, 1)
    ys, xs = np.nonzero(canvas)
    pts = ' '.join(f'{x - org[0]},{y - org[1]}' for y, x in zip(ys, xs))
    one = cv2.getTextSize(c, FONT, SCALE, 1)[0][0]
    many = cv2.getTextSize(c * 11, FONT, SCALE, 1)[0][0]
    return (many - one) / 10.0, pts


def main() -> None:
    lines = ['"""Tables of OpenCV\'s colour maps and Hershey glyphs for '
             'utils/plotting.py.', '',
             'Generated by scripts/torch_make_plot_tables.py from cv2; do '
             'not edit.', '"""', '', '# cv2.applyColorMap(np.arange(256, '
             'dtype=np.uint8), COLORMAP_*): 256 BGR entries']
    for name, cmap in (('HOT', cv2.COLORMAP_HOT),
                       ('VIRIDIS', cv2.COLORMAP_VIRIDIS)):
        lines.append(f'{name}_HEX = (')
        lines += [f"    '{row}'" for row in _lut_hex(cmap)]
        lines.append(')')
    lines += ['', '# FONT_HERSHEY_SIMPLEX at scale 0.5, thickness 1: char -> '
              '(advance px, "dx,dy ..." pixels set from the origin)',
              'GLYPHS = {']
    for code in range(32, 127):
        c = chr(code)
        adv, pts = _glyph(c)
        lines.append(f'    {c!r}: ({adv}, {pts!r}),')
    lines.append('}')
    with open(OUT, 'w') as f:
        f.write('\n'.join(lines) + '\n')
    print(f'wrote {OUT}')


if __name__ == '__main__':
    main()
