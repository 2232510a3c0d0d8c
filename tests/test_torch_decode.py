"""The port's image decoder (mm_distillnet_torch/data/decode.py +
csrc/image_decode.cpp, built with the host C++ compiler) against
cv2.imread, bit-equal, on files cv2 writes here: baseline JPEG at three
qualities and three samplings, grey, with restart intervals and with
optimised Huffman tables, each read with the three flags the datasets use;
PNG at 8 and 16 bits, grey / RGB / RGBA, every row filter; a 16-bit PNG
under a .jpg name; Exif orientations; PFM against the JAX reader. The
committed fixtures (scripts/torch_make_data_fixtures.py) are held to the
cv2 hashes recorded beside them, the check chip_smoke.py makes on the card.
"""
import hashlib
import json
import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import cv2
import numpy as np
import pytest

from mm_distillnet_tpu.data.argoverse import read_pmf as jax_read_pmf
from mm_distillnet_torch.data import decode

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        'fixtures', 'torch_data')
FLAGS = (cv2.IMREAD_COLOR, cv2.IMREAD_ANYDEPTH, cv2.IMREAD_UNCHANGED)
SIZES = [(37, 53), (64, 96), (130, 70)]
SAMPLING = {'444': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            '422': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            '420': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420}


def textured(shape, seed, hi=256, dtype=np.uint8):
    """Waves, edges and noise: every block carries AC energy."""
    rng = np.random.default_rng(seed)
    h, w = shape[:2]
    yy, xx = np.mgrid[0:h, 0:w]
    base = (np.sin(xx / 3.0) * np.cos(yy / 5.0) + 1) * (hi / 3)
    img = base.reshape(h, w, *([1] * (len(shape) - 2))) + \
        rng.integers(0, hi // 3, shape)
    img[h // 3:h // 2, w // 4:w // 2] = hi - 1       # a sharp box
    return np.clip(img, 0, hi - 1).astype(dtype)


def assert_same_as_cv2(data: bytes, flags=FLAGS):
    for flag in flags:
        want = cv2.imdecode(np.frombuffer(data, np.uint8), flag)
        got = decode.imdecode(data, flag)
        assert got.dtype == want.dtype and got.shape == want.shape, flag
        np.testing.assert_array_equal(got, want, err_msg=f'flag {flag}')


def jpeg_bytes(img, *params):
    ok, buf = cv2.imencode('.jpg', img, list(params))
    assert ok
    return buf.tobytes()


@pytest.mark.parametrize('sampling', sorted(SAMPLING))
@pytest.mark.parametrize('quality', [50, 75, 95])
@pytest.mark.parametrize('size', SIZES)
def test_colour_jpeg_is_bit_equal_to_cv2(size, quality, sampling):
    data = jpeg_bytes(textured(size + (3,), quality + size[0]),
                      cv2.IMWRITE_JPEG_QUALITY, quality,
                      cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling])
    assert_same_as_cv2(data)


@pytest.mark.parametrize('kind', ['grey', 'restart', 'optimized'])
@pytest.mark.parametrize('size', SIZES)
def test_grey_restart_and_optimized_jpeg(size, kind):
    if kind == 'grey':
        data = jpeg_bytes(textured(size, 7), cv2.IMWRITE_JPEG_QUALITY, 80)
    elif kind == 'restart':
        data = jpeg_bytes(textured(size + (3,), 8),
                          cv2.IMWRITE_JPEG_RST_INTERVAL, 2)
        assert b'\xff\xdd' in data and b'\xff\xd1' in data
    else:
        data = jpeg_bytes(textured(size + (3,), 9),
                          cv2.IMWRITE_JPEG_OPTIMIZE, 1,
                          cv2.IMWRITE_JPEG_QUALITY, 90)
        assert data != jpeg_bytes(textured(size + (3,), 9),
                                  cv2.IMWRITE_JPEG_QUALITY, 90)
    assert_same_as_cv2(data)


@pytest.mark.parametrize('size', [(1, 1), (2, 3), (9, 17), (16, 16)])
def test_tiny_and_mcu_edge_jpegs(size):
    """Sizes below and at the MCU: the chroma edge cases (box upsampling
    for planes of width <= 2)."""
    for sampling in SAMPLING.values():
        assert_same_as_cv2(jpeg_bytes(
            textured(size + (3,), 3), cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
            sampling))


def _without_jfif(data: bytes) -> bytes:
    assert data[2:4] == b'\xff\xe0'                 # cv2 writes APP0 first
    return data[:2] + data[4 + struct.unpack('>H', data[4:6])[0]:]


@pytest.mark.parametrize('kind', ['adobe-rgb', 'adobe-ycc', 'no-marker',
                                  'rgb-ids'])
def test_jpeg_colour_space_markers(kind):
    """libjpeg's choice of colour space without a JFIF marker: the Adobe
    transform flag, else the component ids ('R', 'G', 'B' means RGB)."""
    data = _without_jfif(jpeg_bytes(textured((40, 56, 3), 12),
                                    cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                    SAMPLING['444']))
    if kind.startswith('adobe'):
        body = b'Adobe' + bytes([0, 100, 0, 0, 0, 0,
                                 int(kind == 'adobe-ycc')])
        data = data[:2] + b'\xff\xee' + struct.pack('>H', 2 + len(body)) \
            + body + data[2:]
    elif kind == 'rgb-ids':
        sof = data.index(b'\xff\xc0')
        frame = bytearray(data)
        for c, ident in enumerate(b'RGB'):
            frame[sof + 10 + 3 * c] = ident
        sos = data.index(b'\xff\xda')
        for c, ident in enumerate(b'RGB'):
            frame[sos + 5 + 2 * c] = ident
        data = bytes(frame)
    assert_same_as_cv2(data)


@pytest.mark.parametrize('marker,mode', [(0xC2, 'progressive'),
                                         (0xC3, 'lossless'),
                                         (0xC9, 'arithmetic'),
                                         (0xC5, 'hierarchical')])
def test_unsupported_jpeg_modes_raise_with_their_name(marker, mode):
    if marker == 0xC2:
        data = jpeg_bytes(textured((30, 40, 3), 1),
                          cv2.IMWRITE_JPEG_PROGRESSIVE, 1)
    else:   # the frame header's marker rewritten: raised before decoding
        data = jpeg_bytes(textured((30, 40, 3), 1)).replace(
            b'\xff\xc0', bytes([0xFF, marker]), 1)
    with pytest.raises(ValueError, match=mode):
        decode.imdecode(data)


def test_twelve_bit_and_corrupt_jpegs_raise():
    data = jpeg_bytes(textured((30, 40, 3), 2))
    sof = data.index(b'\xff\xc0')
    twelve = data[:sof + 4] + b'\x0c' + data[sof + 5:]
    with pytest.raises(ValueError, match='12-bit'):
        decode.imdecode(twelve)
    with pytest.raises(ValueError, match='truncated|Huffman|no end'):
        decode.imdecode(data[:len(data) // 3])
    with pytest.raises(ValueError, match='not a JPEG or PNG'):
        decode.imdecode(b'GIF89a' + data)
    with pytest.raises(FileNotFoundError):
        decode.imread('/nonexistent/frame.jpg')
    with pytest.raises(ValueError, match='flags'):
        decode.imdecode(data, 17)


@pytest.mark.parametrize('level', [0, 1, 9])
@pytest.mark.parametrize('channels', [1, 3, 4])
@pytest.mark.parametrize('depth', [8, 16])
def test_png_is_bit_equal_to_cv2(depth, channels, level):
    hi, dtype = (256, np.uint8) if depth == 8 else (65536, np.uint16)
    shape = (37, 53) if channels == 1 else (37, 53, channels)
    img = textured(shape, depth + channels, hi, dtype)
    ok, buf = cv2.imencode('.png', img, [cv2.IMWRITE_PNG_COMPRESSION, level])
    flags = FLAGS if channels == 1 else (cv2.IMREAD_COLOR,
                                         cv2.IMREAD_UNCHANGED)
    assert_same_as_cv2(buf.tobytes(), flags)


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack('>I', len(body)) + kind + body + \
        struct.pack('>I', zlib.crc32(kind + body) & 0xFFFFFFFF)


def _filter_row(kind, row, prev, bpp):
    """PNG row filter `kind` of one row (the encoder's side)."""
    row, prev = row.astype(np.int64), prev.astype(np.int64)
    left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
    upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
    if kind == 0:
        pred = np.zeros_like(row)
    elif kind == 1:
        pred = left
    elif kind == 2:
        pred = prev
    elif kind == 3:
        pred = (left + prev) // 2
    else:
        p = left + prev - upleft
        pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
        pred = np.where((pa <= pb) & (pa <= pc), left,
                        np.where(pb <= pc, prev, upleft))
    return ((row - pred) % 256).astype(np.uint8)


@pytest.mark.parametrize('depth,color_type', [(8, 0), (8, 2), (16, 0),
                                              (16, 6)])
@pytest.mark.parametrize('kind', [0, 1, 2, 3, 4])
def test_every_png_row_filter(kind, depth, color_type):
    """A PNG written by hand with row filter `kind` on every row (mixed
    with the other filters on odd rows), read by cv2 and by the port."""
    channels = {0: 1, 2: 3, 6: 4}[color_type]
    h, w = 23, 31
    hi, dtype = (256, np.uint8) if depth == 8 else (65536, np.uint16)
    img = textured((h, w, channels), kind + depth, hi, dtype)
    rows = img.astype('>u2').view(np.uint8) if depth == 16 else img
    rows = rows.reshape(h, -1)
    bpp = channels * depth // 8
    raw = bytearray()
    prev = np.zeros(rows.shape[1], np.uint8)
    for y in range(h):
        k = kind if y % 2 == 0 else (kind + y) % 5
        raw += bytes([k]) + _filter_row(k, rows[y], prev, bpp).tobytes()
        prev = rows[y]
    data = decode.PNG_SIGNATURE + _png_chunk(
        b'IHDR', struct.pack('>IIBBBBB', w, h, depth, color_type, 0, 0, 0)) \
        + _png_chunk(b'IDAT', zlib.compress(bytes(raw))) \
        + _png_chunk(b'IEND', b'')
    flags = FLAGS if channels == 1 else (cv2.IMREAD_COLOR,
                                         cv2.IMREAD_UNCHANGED)
    assert_same_as_cv2(data, flags)


def test_sixteen_bit_png_under_a_jpg_name(tmp_path):
    """The Freiburg thermal frames' case: picked by content, read as 16
    bits with IMREAD_ANYDEPTH."""
    thermal = textured((40, 60), 5, 65536, np.uint16)
    path = str(tmp_path / 'fl_ir_aligned_1_000000001_a.jpg')
    assert cv2.imwrite(path.replace('.jpg', '.png'), thermal)
    os.rename(path.replace('.jpg', '.png'), path)
    for flag in FLAGS:
        want = cv2.imread(path, flag)
        got = decode.imread(path, flag)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert decode.imread(path, decode.IMREAD_ANYDEPTH).dtype == np.uint16


def test_grey_read_of_a_colour_png_raises():
    ok, buf = cv2.imencode('.png', textured((20, 30, 3), 4))
    with pytest.raises(ValueError, match='grey read of a colour PNG'):
        decode.imdecode(buf.tobytes(), decode.IMREAD_ANYDEPTH)


@pytest.mark.parametrize('orientation', range(1, 9))
def test_exif_orientation_as_cv2(orientation):
    data = jpeg_bytes(textured((30, 40, 3), 6))
    tiff = b'II*\x00' + struct.pack('<IH', 8, 1) + \
        struct.pack('<HHII', 0x0112, 3, 1, orientation) + \
        struct.pack('<I', 0)
    app1 = b'\xff\xe1' + struct.pack('>H', 8 + len(tiff)) + \
        b'Exif\x00\x00' + tiff
    assert_same_as_cv2(data[:2] + app1 + data[2:])


@pytest.mark.parametrize('scale', [-1.0, 1.0])
def test_pfm_matches_the_jax_reader(tmp_path, scale):
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 300, (12, 17)).astype(np.float32)
    img[3, 4] = np.inf
    path = str(tmp_path / 'd.pfm')
    with open(path, 'wb') as f:
        f.write(b'Pf\n17 12\n' + f'{scale}\n'.encode())
        f.write(img.astype('<f4' if scale < 0 else '>f4').tobytes())
    np.testing.assert_array_equal(decode.read_pmf(path), jax_read_pmf(path))
    with open(path, 'r+b') as f:
        f.write(b'PF')
    with pytest.raises(ValueError, match='grayscale'):
        decode.read_pmf(path)


def _fixture_cases():
    with open(os.path.join(FIXTURES, 'hashes.json')) as f:
        hashes = json.load(f)
    return [(name, flag) for name in sorted(hashes)
            for flag in ('IMREAD_COLOR', 'IMREAD_ANYDEPTH',
                         'IMREAD_UNCHANGED')]


@pytest.mark.parametrize('name,flag', _fixture_cases())
def test_committed_fixtures_match_their_cv2_hashes(name, flag):
    with open(os.path.join(FIXTURES, 'hashes.json')) as f:
        want = json.load(f)[name][flag]
    got = decode.imread(os.path.join(FIXTURES, name), getattr(decode, flag))
    assert [list(got.shape), str(got.dtype)] == [want['shape'],
                                                 want['dtype']]
    assert hashlib.sha256(got.tobytes()).hexdigest() == want['sha256']
    # and cv2 of this machine still agrees with the recorded hash
    again = cv2.imread(os.path.join(FIXTURES, name), getattr(cv2, flag))
    assert hashlib.sha256(again.tobytes()).hexdigest() == want['sha256']


def test_threads_decode_in_parallel_and_alike():
    """The loader's threads share one library (built once, under a lock)."""
    data = [jpeg_bytes(textured((48, 64, 3), i)) for i in range(8)]
    with ThreadPoolExecutor(4) as pool:
        got = list(pool.map(decode.imdecode, data * 4))
    for i, g in enumerate(got):
        np.testing.assert_array_equal(
            g, cv2.imdecode(np.frombuffer(data[i % 8], np.uint8), 1))
