"""Image decoding without cv2: the port's counterpart of `cv2.imread` with
the flags the datasets use, and the PFM reader.

    imread(path)                   # IMREAD_COLOR: uint8 BGR, (H, W, 3)
    imread(path, IMREAD_ANYDEPTH)  # one channel, 8 or 16 bits
    imread(path, IMREAD_UNCHANGED) # the file's own channels and depth

The format is picked by the file's content, never by its name, as
cv2.imread does (the Freiburg thermal frames are 16-bit PNG data under a
`.jpg` name). Output is bit-equal to cv2.imread (libjpeg-turbo, libpng):

- JPEG: sequential Huffman-coded 8-bit files (SOF0/SOF1), 1 or 3
  components at any integral sampling (4:4:4, 4:2:2, 4:2:0, ...), restart
  intervals, any Huffman tables. Decoded by `csrc/image_decode.cpp`, built
  with the host C++ compiler at first use and called through ctypes, which
  releases the interpreter lock: the loader's threads decode in parallel.
  Progressive, lossless, 12-bit, hierarchical and arithmetic-coded files
  raise with the mode's name.
- PNG: 8- and 16-bit grey, RGB and RGBA, not interlaced. Inflated by the
  standard library's zlib (which also releases the lock), unfiltered in
  the C++ source. Interlaced, palette, grey + alpha, sub-byte and tRNS
  files raise. cv2 returns the high byte of a 16-bit sample on an 8-bit
  read and drops alpha on a colour read; so does this. A grey read of a
  colour PNG raises: cv2 5.0 with libpng 1.6 returns values that follow
  no weighting of the channels, and no dataset reads a colour PNG so.
- An Exif orientation (JPEG APP1, PNG eXIf) is applied except under
  IMREAD_UNCHANGED, as cv2.imread applies it.

A missing file raises FileNotFoundError where cv2.imread returns None.
"""
from __future__ import annotations

import ctypes
import struct
import zlib
from typing import Optional

import numpy as np

from ..ops import cuda_build

IMREAD_UNCHANGED = -1
IMREAD_COLOR = 1
IMREAD_ANYDEPTH = 2
_FLAGS = (IMREAD_UNCHANGED, IMREAD_COLOR, IMREAD_ANYDEPTH)

PNG_SIGNATURE = b'\x89PNG\r\n\x1a\n'
JPEG_SIGNATURE = b'\xff\xd8'
_ERR_LEN = 512


def native() -> ctypes.CDLL:
    """csrc/image_decode.cpp, built at first use, its functions typed."""
    lib = cuda_build.load('image_decode')
    if not getattr(lib, '_mmdt_typed', False):
        ptr, i64 = ctypes.c_void_p, ctypes.c_int64
        err = [ctypes.c_char_p, ctypes.c_int]
        for fn, args in ((lib.mmdt_jpeg_info, [ptr, i64, ptr] + err),
                         (lib.mmdt_jpeg_decode,
                          [ptr, i64, ctypes.c_int, ptr] + err),
                         (lib.mmdt_png_unfilter,
                          [ptr, i64, ptr, i64, i64, i64] + err),
                         (lib.mmdt_filter_cols,
                          [ptr, ptr, i64, i64, i64, i64, i64, ptr, ptr]),
                         (lib.mmdt_filter_rows,
                          [ptr, ptr, i64, i64, i64, ptr, ptr])):
            fn.argtypes = args
            fn.restype = ctypes.c_int if err[0] in args else None
        lib._mmdt_typed = True
    return lib


def _check(rc: int, err: ctypes.Array, path: str) -> None:
    if rc != 0:
        raise ValueError(f'{path}: {err.value.decode(errors="replace")}')


def imread(path: str, flags: int = IMREAD_COLOR) -> np.ndarray:
    """Decode the image file at `path` as cv2.imread(path, flags) does."""
    with open(path, 'rb') as f:
        data = f.read()
    return imdecode(data, flags, name=str(path))


def imdecode(data: bytes, flags: int = IMREAD_COLOR,
             name: str = '<bytes>') -> np.ndarray:
    """Decode an encoded image held in memory (cv2.imdecode's semantics)."""
    if flags not in _FLAGS:
        raise ValueError(f'unsupported imread flags {flags} (one of {_FLAGS})')
    if data[:2] == JPEG_SIGNATURE:
        img, exif = _decode_jpeg(data, flags, name)
    elif data[:8] == PNG_SIGNATURE:
        img, exif = _decode_png(data, flags, name)
    else:
        raise ValueError(f'{name}: not a JPEG or PNG file (by its content)')
    if exif is not None and flags != IMREAD_UNCHANGED:
        img = _apply_orientation(img, _exif_orientation(exif))
    return img


def _decode_jpeg(data: bytes, flags: int, name: str):
    lib = native()
    buf = np.frombuffer(data, np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    info = np.zeros(6, np.int64)
    _check(lib.mmdt_jpeg_info(buf.ctypes.data, buf.size, info.ctypes.data,
                              err, _ERR_LEN), err, name)
    width, height, ncomp, _space, exif_at, exif_len = (int(v) for v in info)
    grey = flags == IMREAD_ANYDEPTH or \
        (flags == IMREAD_UNCHANGED and ncomp == 1)
    out = np.empty((height, width) if grey else (height, width, 3), np.uint8)
    _check(lib.mmdt_jpeg_decode(buf.ctypes.data, buf.size, int(grey),
                                out.ctypes.data, err, _ERR_LEN), err, name)
    exif = data[exif_at:exif_at + exif_len] if exif_at >= 0 else None
    return out, exif


def _png_chunks(data: bytes, name: str):
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack('>I4s', data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError(f'{name}: truncated PNG chunk {kind!r}')
        yield kind, body
        if kind == b'IEND':
            return
        pos += 12 + length
    raise ValueError(f'{name}: truncated PNG file (no IEND)')


_PNG_CHANNELS = {0: 1, 2: 3, 6: 4}   # grey, RGB, RGBA


def _decode_png(data: bytes, flags: int, name: str):
    header, idat, exif = None, [], None
    for kind, body in _png_chunks(data, name):
        if kind == b'IHDR':
            header = struct.unpack('>IIBBBBB', body)
        elif kind == b'IDAT':
            idat.append(body)
        elif kind == b'eXIf':
            exif = body
        elif kind == b'tRNS':
            raise ValueError(f'{name}: PNG with a tRNS chunk is not supported')
    if header is None:
        raise ValueError(f'{name}: PNG without IHDR')
    width, height, depth, color_type, _comp, _filt, interlace = header
    if interlace:
        raise ValueError(f'{name}: interlaced PNG is not supported')
    if color_type not in _PNG_CHANNELS or depth not in (8, 16):
        raise ValueError(f'{name}: PNG colour type {color_type} at '
                         f'{depth} bits is not supported (8 or 16 bits)')
    channels = _PNG_CHANNELS[color_type]
    bpp = channels * depth // 8
    raw = np.frombuffer(zlib.decompress(b''.join(idat)), np.uint8)
    rows = np.empty((height, width * bpp), np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    _check(native().mmdt_png_unfilter(raw.ctypes.data, raw.size,
                                      rows.ctypes.data, height, width * bpp,
                                      bpp, err, _ERR_LEN), err, name)
    img = rows.view('>u2').astype(np.uint16) if depth == 16 else rows
    img = img.reshape(height, width, channels)
    return _png_convert(img, flags, name), exif


def _png_convert(img: np.ndarray, flags: int, name: str) -> np.ndarray:
    channels = img.shape[2]
    if flags == IMREAD_ANYDEPTH and channels > 1:
        raise ValueError(f'{name}: a grey read of a colour PNG is not '
                         'supported')
    if flags != IMREAD_COLOR:
        if channels == 1:
            return np.ascontiguousarray(img[..., 0])
        order = [2, 1, 0, 3][:channels]           # RGB(A) -> BGR(A)
        return np.ascontiguousarray(img[..., order])
    if img.dtype == np.uint16:                     # IMREAD_COLOR: 8 bits
        img = (img >> 8).astype(np.uint8)
    if channels == 1:
        return np.ascontiguousarray(np.repeat(img, 3, axis=2))
    return np.ascontiguousarray(img[..., [2, 1, 0]])


def _exif_orientation(exif: bytes) -> int:
    """The TIFF orientation tag (0x0112) of IFD0, 1 when absent."""
    if len(exif) < 8 or exif[:2] not in (b'II', b'MM'):
        return 1
    e = '<' if exif[:2] == b'II' else '>'
    ifd = struct.unpack(e + 'I', exif[4:8])[0]
    if ifd + 2 > len(exif):
        return 1
    count = struct.unpack(e + 'H', exif[ifd:ifd + 2])[0]
    for i in range(count):
        at = ifd + 2 + 12 * i
        if at + 12 > len(exif):
            break
        tag, kind = struct.unpack(e + 'HH', exif[at:at + 4])
        if tag == 0x0112 and kind == 3:
            return struct.unpack(e + 'H', exif[at + 8:at + 10])[0]
    return 1


def _apply_orientation(img: np.ndarray, orientation: int) -> np.ndarray:
    """cv2's ExifTransform: orientations 2-8 as flips and transposes."""
    if orientation in (5, 6, 7, 8):
        img = np.swapaxes(img, 0, 1)
    flip: Optional[tuple] = {2: (1,), 3: (0, 1), 4: (0,), 6: (1,),
                             7: (0, 1), 8: (0,)}.get(orientation)
    if flip:
        img = np.flip(img, axis=flip)
    return np.ascontiguousarray(img)


def read_pmf(filepath: str, max_value: float = 192) -> np.ndarray:
    """Middlebury .pfm ('Pf' grayscale) reader, (H, W) float32, +inf -> 0,
    clipped at max_value (mm_distillnet_tpu/data/argoverse.py read_pmf;
    reference utils.py:1494-1523)."""
    with open(filepath, 'rb') as f:
        img_type = f.readline().decode('utf-8').rstrip()
        if img_type != 'Pf':
            raise ValueError(f'{filepath}: pfm file not grayscale')
        width, height = (int(v) for v in f.readline().split())
        scale = float(f.readline().rstrip())
        endian = '<' if scale < 0 else '>'
        data = np.fromfile(f, endian + 'f')
    img = np.reshape(data, (height, width))
    img[img == np.inf] = 0
    img[img >= max_value] = max_value
    return img
