#!/usr/bin/env python3
"""Write the committed image fixtures of the port's decoder, with cv2 as the
reference:

    python scripts/torch_make_data_fixtures.py [--out tests/fixtures/torch_data]

Files, at the Freiburg frames' size (1920 x 1080), textured so that the
entropy decoder does real work (seeded, so a rerun writes the same bytes):
  rgb.jpg      colour JPEG as cv2 writes it (baseline, 4:2:0, quality 95);
  depth.jpg    colour JPEG of a smooth depth-like field (4:2:0, quality 95);
  thermal.jpg  16-bit grey PNG data under a .jpg name, values in
               [21800, 25000], as the multimodal dataset reads its thermal
               frames (IMREAD_ANYDEPTH picks the format by content);
  hashes.json  per file and per imread flag the datasets use, the SHA-256
               of cv2.imread's array (shape and dtype beside it).

chip_smoke.py and tests/test_torch_decode.py decode the files with the
port's decoder and hold the arrays to these hashes. Needs cv2; the port
itself never imports it.
"""
from __future__ import annotations

import argparse
import hashlib
import json
from pathlib import Path

import cv2
import numpy as np

FLAGS = {'IMREAD_COLOR': cv2.IMREAD_COLOR,
         'IMREAD_ANYDEPTH': cv2.IMREAD_ANYDEPTH,
         'IMREAD_UNCHANGED': cv2.IMREAD_UNCHANGED}
WIDTH, HEIGHT = 1920, 1080


def array_digest(a: np.ndarray) -> dict:
    a = np.ascontiguousarray(a)
    return {'sha256': hashlib.sha256(a.tobytes()).hexdigest(),
            'shape': list(a.shape), 'dtype': str(a.dtype)}


def textured(rng: np.random.Generator) -> np.ndarray:
    """A street-like frame: gradients, edges, blocks and sensor noise."""
    yy, xx = np.mgrid[0:HEIGHT, 0:WIDTH].astype(np.float32)
    img = np.empty((HEIGHT, WIDTH, 3), np.float32)
    for c in range(3):
        img[..., c] = (110 + 60 * np.sin(xx / (23 + 7 * c))
                       * np.cos(yy / (31 - 5 * c)) + 30 * (yy / HEIGHT))
    for _ in range(40):                       # boxes with sharp edges
        x0, y0 = rng.integers(0, WIDTH - 200), rng.integers(0, HEIGHT - 120)
        w, h = rng.integers(30, 200), rng.integers(20, 120)
        img[y0:y0 + h, x0:x0 + w] = rng.uniform(0, 255, 3)
    img += rng.normal(0, 5, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--out', default=str(Path(__file__).resolve().parents[1]
                                        / 'tests' / 'fixtures' / 'torch_data'))
    args = p.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(20240601)

    jpeg = [cv2.IMWRITE_JPEG_QUALITY, 95, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420]
    cv2.imwrite(str(out / 'rgb.jpg'), textured(rng), jpeg)

    yy, xx = np.mgrid[0:HEIGHT, 0:WIDTH].astype(np.float32)
    near = np.clip(255 * (yy / HEIGHT) ** 1.5 + rng.normal(0, 2, yy.shape),
                   0, 255)
    depth = cv2.applyColorMap(near.astype(np.uint8), cv2.COLORMAP_JET)
    cv2.imwrite(str(out / 'depth.jpg'), depth, jpeg)

    heat = (23400 + 900 * np.sin(xx / 97) * np.cos(yy / 53)
            + 700 * (yy / HEIGHT) + rng.normal(0, 0.8, yy.shape))
    thermal = np.clip(heat, 21800, 25000).astype(np.uint16)
    ok, png = cv2.imencode('.png', thermal)
    assert ok
    (out / 'thermal.jpg').write_bytes(png.tobytes())   # PNG under .jpg

    hashes = {}
    for name in ('rgb.jpg', 'depth.jpg', 'thermal.jpg'):
        path = out / name
        hashes[name] = {'bytes': path.stat().st_size}
        for flag, value in FLAGS.items():
            hashes[name][flag] = array_digest(cv2.imread(str(path), value))
    (out / 'hashes.json').write_text(json.dumps(hashes, indent=1) + '\n')
    for name, h in hashes.items():
        print(f'{name}: {h["bytes"]} bytes')
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
