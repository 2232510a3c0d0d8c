"""int8 x int8 -> int32 convolution: the plain versions, the launch plan and
the card routes of the quantized forward (quant.py).

The JAX package computes this convolution with XLA, outside any Pallas
kernel (mm_distillnet_tpu/quant.py:209-223). PyTorch has no int8
convolution on CUDA, and an fp32 cuDNN convolution of integer values is not
exact in general (Winograd or FFT algorithms; above about 1,040 taps the
sums leave fp32's exact integer range). So a quantized conv takes one of two
routes, decided by the shape of each call (`route`):

  'int_mm'       a 1x1, stride-1, ungrouped conv with no padding whose Cin
                 and Cout are multiples of 8, on more than 16 rows (B*H*W):
                 served by the hand-written s8 GEMM of csrc/int8_gemm.cuh
                 (ops/int8_gemm.py `quantized_conv1x1`, the quantize
                 prologue and dequantize epilogue inside); the int32 sums
                 alone go through torch._int_mm (cuBLASLt's s8 GEMM, whose
                 limits these are), the plain version's card route and the
                 GEMM's yardstick;
  'int8_conv2d'  every other conv (depthwise, the stem, any 1x1 the GEMM
                 refuses): the hand-written CUDA kernels of
                 csrc/int8_conv.cu.

csrc/int8_conv.cu has two entry points over the same tile loops:
`int8_conv2d` (int8 in, the exact int32 sums out) and `quantized_conv2d`
(the layer's bf16, fp16 or fp32 input in, quantized as the tile is loaded;
the sums dequantized, biased and rounded as quant.py's torch sequence does
before the store). `launch_plan` decides each call's path (depthwise halo
tiles, the dp4a stem, or the general one-thread-per-output loop), tile,
channel block, threads, grid and shared memory; the launchers use it and
nothing else, and `int8_conv2d_tiled_reference` walks the same plan tile by
tile on the CPU.

Plain versions: `int8_conv2d_reference`, an fp64 F.conv2d of the int8
values rounded back to int32, exact because |acc| <= 127^2 K is far below
2^53; `quantized_conv2d_reference`, the unfused torch sequence (quantize,
the route's int32 sums, rescale, bias, round), from the helpers `_quantize`
and `_dequantize`. On a CPU tensor every wrapper runs its plain version; a
CUDA tensor launches the kernel (or, for `int_mm`, the library GEMM) or
raises. quant.py's `fused_conv` sends a call to its route's fused kernel
(`quantized_conv2d` or ops/int8_gemm.py `quantized_conv1x1`). `launches`
counts the card's launches of each kernel and of `int_mm`;
`layout_copies` the inputs the fused wrappers had to copy into NHWC.

Layout: activations NHWC (the kernels'), weights OIHW (the port's
state_dict layout), padding as ((top, bottom), (left, right)) zeros.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Iterator, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from . import cuda_build

launches = {'int8_conv2d': 0, 'int_mm': 0, 'quantized_conv2d': 0,
            'quantized_conv1x1': 0}
# inputs of the fused kernels that were not NHWC in memory (one copy each)
layout_copies = {'quantized_conv2d': 0, 'quantized_conv1x1': 0}

# the largest tap count whose int32 sums cannot overflow (127^2 K < 2^31)
MAX_TAPS = (2 ** 31 - 1) // (127 * 127)
INT_MM_MIN_ROWS = 17
SMEM_LIMIT = 232448      # shared memory a CTA may opt in to on an H100
MAX_THREADS = 512        # the tile kernels' CTA (csrc kMaxThreads)
SPW = 8                  # depthwise outputs a thread along W (csrc kSpw)
SMS = 132                # an H100 SXM's SMs: the plan's parallelism target
CTA_THREADS = 256        # a depthwise CTA's target threads

Pads = Tuple[Tuple[int, int], Tuple[int, int]]

# the kernels' int arguments, in the order of csrc/int8_conv.cu `Args`
ARGS = ('B', 'H', 'W', 'cin', 'ho', 'wo', 'cout', 'kh', 'kw', 'sh', 'sw',
        'pt', 'pl', 'groups',
        'path', 'threads', 'gx', 'gy', 'gz', 'smem',
        'cb', 'vec', 'th', 'tw', 'spw', 'rpt', 'halo_h', 'halo_w', 'pitch',
        'cblocks',
        'in_dtype', 'bias_dtype', 'compute_dtype')
PATHS = {'depthwise': 0, 'stem': 1, 'general': 2}
# csrc Dtype; 0 is also "no bias"
DTYPES = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2,
          torch.float16: 3}
FLOATS = (torch.bfloat16, torch.float16, torch.float32)


def reset_launches() -> None:
    """Every launch count and layout-copy count to 0."""
    for k in launches:
        launches[k] = 0
    for k in layout_copies:
        layout_copies[k] = 0


def output_hw(h: int, w: int, kernel: Tuple[int, int],
              stride: Tuple[int, int], padding: Pads) -> Tuple[int, int]:
    (pt, pb), (pl, pr) = padding
    return ((h + pt + pb - kernel[0]) // stride[0] + 1,
            (w + pl + pr - kernel[1]) // stride[1] + 1)


def route(qx_shape, qw_shape, stride: Tuple[int, int], padding: Pads,
          groups: int) -> str:
    """The route of a call on qx (B, H, W, Cin) and qw (Cout, Cin/groups,
    kh, kw): 'int_mm' where cuBLASLt's s8 GEMM takes it (a 1x1, stride-1,
    ungrouped conv without padding, Cin and Cout multiples of 8, more than
    16 rows; served by the fused s8 GEMM of csrc/int8_gemm.cuh), else
    'int8_conv2d'."""
    b, h, w, cin = qx_shape
    cout = qw_shape[0]
    if (tuple(qw_shape[2:]) == (1, 1) and tuple(stride) == (1, 1)
            and groups == 1 and padding == ((0, 0), (0, 0))
            and cin % 8 == 0 and cout % 8 == 0
            and b * h * w >= INT_MM_MIN_ROWS):
        return 'int_mm'
    return 'int8_conv2d'


# ---- the launch plan ----

class Plan(NamedTuple):
    """One launch of csrc/int8_conv.cu. path 'depthwise': a CTA per
    (image, th x tw output tile, cb channels), threads = cb/4 x tw/spw x
    th/rpt, the halo halo_h rows x halo_w columns as slots of 4 columns x
    cb channels (`pitch` bytes) loaded in vectors of `vec` channels;
    'stem': a CTA per (image, th x tw tile), cout/8 threads a pixel of rpt
    rows, the halo as pitch/4 words a position; 'general': a thread per
    output, grid (wo*cout / threads, ho, B)."""
    path: str
    threads: int
    grid: Tuple[int, int, int]
    smem: int
    cb: int = 0
    vec: int = 0
    th: int = 0
    tw: int = 0
    spw: int = 0
    rpt: int = 0
    halo_h: int = 0
    halo_w: int = 0
    pitch: int = 0
    cblocks: int = 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round16(n: int) -> int:
    return (n + 15) & ~15


def _vec(c: int, cb: int, in_bytes: int) -> int:
    """Channels a halo load: 16 bytes of input where the channel count and
    block allow it."""
    return max(v for v in (16, 8, 4)
               if v * in_bytes <= 16 and c % v == 0 and cb % v == 0)


def _channel_block(c: int, in_bytes: int) -> int:
    """Channels a depthwise CTA: a divisor of c (no ragged block), at least
    32 where c allows it, then the widest loads, then the largest; 64 and
    a ragged last block where c > 64 has no divisor of 16 or more."""
    divisors = [cb for cb in range(4, min(c, 64) + 1, 4) if c % cb == 0]
    best = max(divisors, key=lambda cb: (cb >= min(32, c),
                                         _vec(c, cb, in_bytes), cb))
    return 64 if best < 16 and c > 64 else best   # a ragged last block


def _bank_conflicts(nq: int, nsx: int, rpt: int, s: int, ncg: int,
                    cbp: int, threads: int) -> int:
    """Summed over the quarter-warps of a depthwise CTA, the most distinct
    16-byte chunks one group of 4 banks serves for a thread's first halo
    read (a 16-byte read of 4 channels' words: [row][column group][cbp
    channel words])."""
    total = 0
    for p0 in range(0, threads, 8):
        quads = {}
        for t in range(p0, min(p0 + 8, threads)):
            q, strip = t % nq, t // nq
            sy, sxi = divmod(strip, nsx)
            word = (sy * rpt * s * ncg + sxi * 2 * s) * cbp + 4 * q
            quads.setdefault(word // 4 % 8, set()).add(word)
        total += max(len(v) for v in quads.values())
    return total


def _depthwise_plan(b, ho, wo, c, k, s, in_bytes) -> Plan:
    cb = _channel_block(c, in_bytes)
    nq = cb // 4
    cblocks = _cdiv(c, cb)
    nsx = min(4, _cdiv(wo, SPW))
    nsy = max(1, CTA_THREADS // (nq * nsx))
    rpt = 2 if ho >= 4 * nsy else 1
    nsy = min(nsy, _cdiv(ho, rpt))

    def ctas():
        return b * _cdiv(ho, nsy * rpt) * _cdiv(wo, nsx * SPW) * cblocks

    # small maps: smaller tiles until about two CTAs an SM, keeping two
    # warps a CTA
    while ctas() < 2 * SMS:
        if rpt > 1:
            rpt = 1
        elif nsy > 1 and nq * nsx * _cdiv(nsy, 2) >= 64:
            nsy = _cdiv(nsy, 2)
        elif nsx > 1 and nq * (nsx // 2) * nsy >= 64:
            nsx //= 2
        else:
            break
    # the same number of tiles, balanced (less of a ragged last tile)
    nsy = _cdiv(_cdiv(ho, rpt), _cdiv(ho, nsy * rpt))
    nsx = _cdiv(_cdiv(wo, SPW), _cdiv(wo, nsx * SPW))
    th, tw = nsy * rpt, nsx * SPW
    halo_h, halo_w = (th - 1) * s + k, (tw - 1) * s + k
    ncg = _cdiv(halo_w, 4)     # column groups: a word is 4 columns
    vec = _vec(c, cb, in_bytes)
    # threads: the strips', and on small maps (few CTAs) more, up to one
    # load each of the halo's vectors (the loader uses them all; the rest
    # return)
    threads = nq * nsx * nsy
    if threads < 128 and ctas() < 2 * SMS:
        unit = 32 * (cb // vec) // math.gcd(32, cb // vec)
        more = _cdiv(min(256, halo_h * ncg * (cb // vec)), unit) * unit
        if threads < more <= MAX_THREADS:
            threads = more
    cbp = min(range(cb, cb + 32, 4), key=lambda w: _bank_conflicts(
        nq, nsx, rpt, s, ncg, w, threads))
    pitch = 4 * cbp            # bytes a (row, column group) slot
    smem = _round16(halo_h * ncg * pitch) + k * k * cb
    if smem > SMEM_LIMIT:
        raise ValueError(f'a {halo_h}x{halo_w}x{cb} halo exceeds the '
                         'shared memory of a CTA')
    return Plan('depthwise', threads, (_cdiv(wo, tw), _cdiv(ho, th),
                                       b * cblocks), smem,
                cb=cb, vec=vec, th=th, tw=tw, spw=SPW,
                rpt=rpt, halo_h=halo_h, halo_w=halo_w, pitch=pitch,
                cblocks=cblocks)


def _stem_plan(b, ho, wo, cin, cout, kh, kw, sh, sw) -> Optional[Plan]:
    cw = _cdiv(cin, 4)
    groups8 = cout // 8
    tw = min(16, wo)
    rpt = 4 if ho >= 64 else 1
    nty = max(1, min(256 // (groups8 * tw), _cdiv(ho, rpt)))
    threads = groups8 * nty * tw
    th = nty * rpt
    halo_h, halo_w = (th - 1) * sh + kh, (tw - 1) * sw + kw
    smem = _round16(halo_h * halo_w * cw * 4) + kh * kw * cw * cout * 4
    if threads % cw or threads > MAX_THREADS or smem > SMEM_LIMIT:
        return None
    return Plan('stem', threads, (_cdiv(wo, tw), _cdiv(ho, th), b), smem,
                cb=4 * cw, vec=4, th=th, tw=tw, rpt=rpt, halo_h=halo_h,
                halo_w=halo_w, pitch=4 * cw)


@functools.lru_cache(maxsize=None)
def launch_plan(x_shape: Tuple[int, ...], w_shape: Tuple[int, ...],
                stride: Tuple[int, int], padding: Pads, groups: int,
                in_bytes: int = 1) -> Plan:
    """The launch of csrc/int8_conv.cu for a call on x (B, H, W, Cin) of
    `in_bytes` an element (int8 1, bf16 / fp16 2, fp32 4) and w (Cout, Cin/groups,
    kh, kw): the depthwise tile kernel for groups == Cin == Cout with Cin %
    4 == 0, a 3x3 or 5x5 square kernel and stride 1 or 2; the dp4a stem
    kernel for an ungrouped conv with Cout % 8 == 0 and at most 64 words of
    taps an output (kh*kw*ceil(Cin/4)); else the general kernel."""
    b, h, w, cin = x_shape
    cout, _, kh, kw = w_shape
    ho, wo = output_hw(h, w, (kh, kw), stride, padding)
    sh, sw = stride
    if (groups == cin == cout and cin % 4 == 0 and kh == kw in (3, 5)
            and sh == sw in (1, 2)):
        return _depthwise_plan(b, ho, wo, cin, kh, sh, in_bytes)
    if groups == 1 and cout % 8 == 0 and kh * kw * _cdiv(cin, 4) <= 64:
        plan = _stem_plan(b, ho, wo, cin, cout, kh, kw, sh, sw)
        if plan is not None:
            return plan
    threads = 256
    return Plan('general', threads, (_cdiv(wo * cout, threads), ho, b), 0)


def call_class(x_shape, w_shape, stride: Tuple[int, int], padding: Pads,
               groups: int) -> str:
    """A call's class for per-class sums: 'dw{k}s{s}' on the depthwise
    path, else the plan's path ('stem', 'general')."""
    plan = launch_plan(tuple(x_shape), tuple(w_shape), tuple(stride), padding,
                       groups)
    if plan.path == 'depthwise':
        return f'dw{w_shape[2]}s{stride[0]}'
    return plan.path


class Tile(NamedTuple):
    """One CTA's outputs [oy0, oy1) x [ox0, ox1) x channels [c0, c1) and
    its input halo: hh x hw positions from (iy0, ix0) of channels [ci0,
    ci1) (zeros outside the input)."""
    oy0: int
    oy1: int
    ox0: int
    ox1: int
    c0: int
    c1: int
    iy0: int
    ix0: int
    hh: int
    hw: int
    ci0: int
    ci1: int


def plan_tiles(plan: Plan, x_shape, w_shape, stride: Tuple[int, int],
               padding: Pads) -> Iterator[Tile]:
    """Every CTA of `plan` (the general path: one per output row), as the
    kernels index them."""
    b, h, w, cin = x_shape
    cout, _, kh, kw = w_shape
    ho, wo = output_hw(h, w, (kh, kw), stride, padding)
    (pt, _), (pl, _) = padding
    sh, sw = stride
    if plan.path == 'general':
        for oy in range(ho):
            yield Tile(oy, oy + 1, 0, wo, 0, cout, oy * sh - pt, -pl, kh,
                       (wo - 1) * sw + kw, 0, cin)
        return
    gx, gy, _ = plan.grid
    for cbk in range(plan.cblocks if plan.path == 'depthwise' else 1):
        for ty in range(gy):
            for tx in range(gx):
                oy0, ox0 = ty * plan.th, tx * plan.tw
                if plan.path == 'depthwise':
                    c0, c1 = cbk * plan.cb, min((cbk + 1) * plan.cb, cout)
                    ci0, ci1 = c0, c1
                else:
                    c0, c1, ci0, ci1 = 0, cout, 0, cin
                yield Tile(oy0, min(oy0 + plan.th, ho), ox0,
                           min(ox0 + plan.tw, wo), c0, c1, oy0 * sh - pt,
                           ox0 * sw - pl, plan.halo_h, plan.halo_w, ci0, ci1)


# ---- plain versions ----

def int8_conv2d_reference(qx: torch.Tensor, qw: torch.Tensor,
                          stride: Tuple[int, int], padding: Pads,
                          groups: int) -> torch.Tensor:
    """qx (B, H, W, Cin) int8, qw (Cout, Cin/groups, kh, kw) int8 -> the
    int32 accumulators (B, Ho, Wo, Cout): an fp64 convolution of the int8
    values, exact, rounded back to int32."""
    (pt, pb), (pl, pr) = padding
    x = F.pad(qx.permute(0, 3, 1, 2).double(), (pl, pr, pt, pb))
    acc = F.conv2d(x, qw.double(), stride=tuple(stride), groups=groups)
    return torch.round(acc).to(torch.int32).permute(0, 2, 3, 1).contiguous()


def int8_conv2d_tiled_reference(qx: torch.Tensor, qw: torch.Tensor,
                                stride: Tuple[int, int], padding: Pads,
                                groups: int) -> torch.Tensor:
    """The kernel's tiling on the CPU: for every CTA of `launch_plan`, the
    plain version on the CTA's halo (zeros outside the input) and its
    block's weights, the CTA's outputs kept. Equal to
    int8_conv2d_reference when the plan's index arithmetic is right."""
    stride = tuple(stride)
    plan = launch_plan(tuple(qx.shape), tuple(qw.shape), stride, padding,
                       groups)
    b, h, w, _ = qx.shape
    ho, wo = output_hw(h, w, tuple(qw.shape[2:]), stride, padding)
    out = torch.zeros((b, ho, wo, qw.shape[0]), dtype=torch.int32)
    for t in plan_tiles(plan, tuple(qx.shape), tuple(qw.shape), stride,
                        padding):
        halo = torch.zeros((b, t.hh, t.hw, t.ci1 - t.ci0), dtype=torch.int8)
        y0, y1 = max(t.iy0, 0), min(t.iy0 + t.hh, h)
        x0, x1 = max(t.ix0, 0), min(t.ix0 + t.hw, w)
        if y1 > y0 and x1 > x0:
            halo[:, y0 - t.iy0:y1 - t.iy0, x0 - t.ix0:x1 - t.ix0] = \
                qx[:, y0:y1, x0:x1, t.ci0:t.ci1]
        g = t.c1 - t.c0 if plan.path == 'depthwise' else groups
        acc = int8_conv2d_reference(halo, qw[t.c0:t.c1], stride,
                                    ((0, 0), (0, 0)), g)
        out[:, t.oy0:t.oy1, t.ox0:t.ox1, t.c0:t.c1] = \
            acc[:, :t.oy1 - t.oy0, :t.ox1 - t.ox0]
    return out


def _quantize(x: torch.Tensor, ascale: torch.Tensor) -> torch.Tensor:
    """The torch prologue: clamp(round_half_even(x / ascale), -127, 127)
    as int8."""
    return torch.clamp(torch.round(x.float() / ascale), -127, 127).to(
        torch.int8)


def _dequantize(acc: torch.Tensor, wscale: torch.Tensor,
                ascale: torch.Tensor, bias: Optional[torch.Tensor],
                compute_dtype: torch.dtype, dtype: torch.dtype
                ) -> torch.Tensor:
    """The torch epilogue: acc * (ascale * wscale) + bias in fp32,
    rounded through compute_dtype to dtype."""
    y = acc.float() * (ascale * wscale)
    if bias is not None:
        y = y + bias.float()
    return y.to(compute_dtype).to(dtype)


def quantized_conv2d_reference(x: torch.Tensor, qw: torch.Tensor,
                               wscale: torch.Tensor, ascale: torch.Tensor,
                               bias: Optional[torch.Tensor],
                               stride: Tuple[int, int], padding: Pads,
                               groups: int,
                               compute_dtype: torch.dtype = torch.bfloat16
                               ) -> torch.Tensor:
    """The plain version of quantized_conv2d, the unfused sequence of a
    quantized conv: x (B, H, W, Cin) -> (B, Ho, Wo, Cout) in x's dtype.
    The prologue to int8; the int32 sums by route (conv_int32); the
    epilogue in fp32, rounded through compute_dtype."""
    acc = conv_int32(_quantize(x, ascale), qw, stride, padding, groups)
    return _dequantize(acc, wscale, ascale, bias, compute_dtype, x.dtype)


# ---- the card ----

def _check(qx: torch.Tensor, qw: torch.Tensor, groups: int) -> None:
    if qx.dtype != torch.int8 or qw.dtype != torch.int8:
        raise ValueError(f'int8 operands expected, got {qx.dtype} and '
                         f'{qw.dtype}')
    _check_shapes(qx, qw, groups)


def _check_shapes(x: torch.Tensor, qw: torch.Tensor, groups: int) -> None:
    if x.dim() != 4 or qw.dim() != 4:
        raise ValueError('x is (B, H, W, Cin) and qw (Cout, Cin/g, kh, kw)')
    if x.shape[-1] != qw.shape[1] * groups or qw.shape[0] % groups:
        raise ValueError(f'{x.shape[-1]} input channels, weight '
                         f'{tuple(qw.shape)}, groups {groups}')
    if x.device != qw.device:
        raise ValueError(f'x on {x.device}, qw on {qw.device}')
    taps = qw.shape[1] * qw.shape[2] * qw.shape[3]
    if taps > MAX_TAPS:
        raise ValueError(f'{taps} taps can overflow the int32 sums')


def _check_fused(x, qw, wscale, ascale, bias, groups, compute_dtype) -> None:
    if x.dtype not in FLOATS:
        raise ValueError(f'x in bf16, fp16 or fp32 expected, got {x.dtype}')
    if qw.dtype != torch.int8:
        raise ValueError(f'int8 weights expected, got {qw.dtype}')
    _check_shapes(x, qw, groups)
    cout = qw.shape[0]
    if (wscale.dtype != torch.float32 or wscale.numel() != cout
            or ascale.dtype != torch.float32 or ascale.numel() != 1):
        raise ValueError('fp32 scales expected: wscale (Cout,), ascale ()')
    if bias is not None and (bias.dtype not in FLOATS
                             or bias.numel() != cout):
        raise ValueError(f'a (Cout,) bf16, fp16 or fp32 bias expected, got '
                         f'{bias.dtype} {tuple(bias.shape)}')
    if not (wscale.is_contiguous() and (bias is None
                                        or bias.is_contiguous())):
        raise ValueError('contiguous scales and bias expected')
    if compute_dtype not in FLOATS:
        raise ValueError(f'compute dtype bf16, fp16 or fp32, got '
                         f'{compute_dtype}')
    if any(t.device != x.device for t in (wscale, ascale) +
           ((bias,) if bias is not None else ())):
        raise ValueError('x, the scales and the bias on different devices')


def _out_hw(x: torch.Tensor, qw: torch.Tensor, stride, padding):
    b, h, w, cin = x.shape
    ho, wo = output_hw(h, w, tuple(qw.shape[2:]), stride, padding)
    if ho < 1 or wo < 1:
        raise ValueError(f'no output for a {h}x{w} input')
    if h * w * cin >= 2 ** 31 or ho * wo * qw.shape[0] >= 2 ** 31:
        raise ValueError('an image of 2^31 elements or more')
    return ho, wo


@functools.lru_cache(maxsize=None)
def _launch_args(x_shape, w_shape, stride, padding, groups, in_dtype: int,
                 bias_dtype: int, compute_dtype: int):
    """The kernels' int arguments (ARGS) as a C array; the dtypes as
    DTYPES codes."""
    plan = launch_plan(x_shape, w_shape, stride, padding, groups,
                       (1, 2, 4, 2)[in_dtype])
    b, h, w, cin = x_shape
    cout, _, kh, kw = w_shape
    ho, wo = output_hw(h, w, (kh, kw), stride, padding)
    values = (b, h, w, cin, ho, wo, cout, kh, kw, stride[0], stride[1],
              padding[0][0], padding[1][0], groups,
              PATHS[plan.path], plan.threads, *plan.grid, plan.smem,
              plan.cb, plan.vec, plan.th, plan.tw, plan.spw, plan.rpt,
              plan.halo_h, plan.halo_w, plan.pitch, plan.cblocks,
              in_dtype, bias_dtype, compute_dtype)
    assert len(values) == len(ARGS)
    return (ctypes.c_int * len(values))(*values)


_FNS = {}


def _kernel(name: str):
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(cuda_build.load('int8_conv'), name)
        pointers = 3 if name == 'int8_conv2d' else 6
        fn.argtypes = [ctypes.c_void_p] * pointers + \
            [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def int8_conv2d(qx: torch.Tensor, qw: torch.Tensor, stride: Tuple[int, int],
                padding: Pads, groups: int) -> torch.Tensor:
    """The kernel: qx (B, H, W, Cin) int8, qw (Cout, Cin/groups, kh, kw)
    int8 -> int32 (B, Ho, Wo, Cout). A CPU tensor takes the plain version."""
    _check(qx, qw, groups)
    if qx.device.type == 'cpu':
        return int8_conv2d_reference(qx, qw, stride, padding, groups)
    stride = tuple(stride)
    ho, wo = _out_hw(qx, qw, stride, padding)
    qx = qx.contiguous()
    qw = qw.contiguous()
    out = torch.empty((qx.shape[0], ho, wo, qw.shape[0]), dtype=torch.int32,
                      device=qx.device)
    args = _launch_args(tuple(qx.shape), tuple(qw.shape), stride, padding,
                        groups, 0, 0, 0)
    with torch.cuda.device(qx.device):
        err = _kernel('int8_conv2d')(
            qx.data_ptr(), qw.data_ptr(), out.data_ptr(), args, len(ARGS),
            torch.cuda.current_stream(qx.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f'int8_conv2d launch failed with CUDA error {err}')
    launches['int8_conv2d'] += 1
    return out


def quantized_conv2d(x: torch.Tensor, qw: torch.Tensor,
                     wscale: torch.Tensor, ascale: torch.Tensor,
                     bias: Optional[torch.Tensor], stride: Tuple[int, int],
                     padding: Pads, groups: int,
                     compute_dtype: torch.dtype = torch.bfloat16
                     ) -> torch.Tensor:
    """The fused kernel: x (B, H, W, Cin) bf16, fp16 or fp32 (any strides;
    an input that is not NHWC in memory is copied and counted in
    `layout_copies`), qw (Cout, Cin/groups, kh, kw) int8, wscale (Cout,)
    and ascale () fp32, bias (Cout,) or None, compute_dtype bf16, fp16 or
    fp32 -> (B, Ho, Wo, Cout) in x's dtype, equal to
    quantized_conv2d_reference bit for bit. A CPU tensor takes the plain
    version."""
    _check_fused(x, qw, wscale, ascale, bias, groups, compute_dtype)
    if x.device.type == 'cpu':
        return quantized_conv2d_reference(x, qw, wscale, ascale, bias,
                                          stride, padding, groups,
                                          compute_dtype)
    stride = tuple(stride)
    ho, wo = _out_hw(x, qw, stride, padding)
    if not x.is_contiguous():
        x = x.contiguous()
        layout_copies['quantized_conv2d'] += 1
    qw = qw.contiguous()
    out = torch.empty((x.shape[0], ho, wo, qw.shape[0]), dtype=x.dtype,
                      device=x.device)
    args = _launch_args(tuple(x.shape), tuple(qw.shape), stride, padding,
                        groups, DTYPES[x.dtype],
                        0 if bias is None else DTYPES[bias.dtype],
                        DTYPES[compute_dtype])
    with torch.cuda.device(x.device):
        err = _kernel('quantized_conv2d')(
            x.data_ptr(), qw.data_ptr(), ascale.data_ptr(),
            wscale.data_ptr(), None if bias is None else bias.data_ptr(),
            out.data_ptr(), args, len(ARGS),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f'quantized_conv2d launch failed with CUDA error '
                           f'{err}')
    launches['quantized_conv2d'] += 1
    return out


def int_mm(qx: torch.Tensor, qw: torch.Tensor) -> torch.Tensor:
    """A 1x1 conv's int32 sums as the library's s8 GEMM (torch._int_mm): qx
    (B, H, W, Cin) int8, qw (Cout, Cin, 1, 1) int8 -> int32 (B, H, W,
    Cout). The plain version's card route on the 'int_mm' route and the
    yardstick of int8_gemm's kernel; no forward launches it. A CPU tensor
    takes the plain version; a CUDA call needs more than 16 rows."""
    _check(qx, qw, 1)
    if qx.device.type == 'cpu':
        return int8_conv2d_reference(qx, qw, (1, 1), ((0, 0), (0, 0)), 1)
    b, h, w, cin = qx.shape
    cout = qw.shape[0]
    if qw.shape[2:] != (1, 1) or cin % 8 or cout % 8:
        raise ValueError(f'the s8 GEMM takes 1x1 convs with Cin and Cout '
                         f'multiples of 8, got {tuple(qw.shape)}')
    m = b * h * w
    if m < INT_MM_MIN_ROWS:
        raise ValueError(f'the s8 GEMM needs more than 16 rows, got {m}')
    acc = torch._int_mm(qx.reshape(m, cin).contiguous(),
                        qw.reshape(cout, cin).t())
    launches['int_mm'] += 1
    return acc.reshape(b, h, w, cout)


def conv_int32(qx: torch.Tensor, qw: torch.Tensor, stride: Tuple[int, int],
               padding: Pads, groups: int) -> torch.Tensor:
    """The int32 accumulators of a quantized conv by its route."""
    if route(qx.shape, qw.shape, stride, padding, groups) == 'int_mm':
        return int_mm(qx, qw)
    return int8_conv2d(qx, qw, stride, padding, groups)


def bound_ms(x_shape, qw_shape, out_shape, in_bytes: int = 1,
             out_bytes: int = 4) -> Tuple[float, str]:
    """Least time on an H100 SXM for one call: the input (int8, or the
    fused kernel's bf16 / fp16 / fp32), the int8 weights and the output
    (int32, or x's dtype) moved once at 3.35 TB/s, or the multiply-adds at the int8
    tensor-core rate (1,979 TOPS dense), the larger."""
    b, h, w, cin = x_shape
    cout, cin_g, kh, kw = qw_shape
    ob, ho, wo, oc = out_shape
    nbytes = (b * h * w * cin * in_bytes + cout * cin_g * kh * kw
              + ob * ho * wo * oc * out_bytes)
    ops = 2.0 * ob * ho * wo * oc * cin_g * kh * kw
    t_bytes, t_ops = nbytes / 3.35e12, ops / 1979e12
    return (max(t_bytes, t_ops) * 1e3,
            'bytes' if t_bytes >= t_ops else 'operations')
