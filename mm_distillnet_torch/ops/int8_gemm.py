"""The quantized forward's 1x1 convs as one kernel: quantize, s8 GEMM and
dequantize in csrc/int8_gemm.cuh (the 'int_mm' route of ops/int8_conv.py;
built as csrc/int8_gemm_{bf16,fp16,fp32}.cu, one library per input dtype).

`quantized_conv1x1(x, qw, wscale, ascale, bias, compute_dtype)` takes x (B,
H, W, Cin) bf16, fp16 or fp32 and a (Cout, Cin, 1, 1) int8 kernel with Cin
and Cout multiples of 8, and returns (B, H, W, Cout) in x's dtype, bit for
bit the unfused sequence `int8_conv.quantized_conv2d_reference` computes on
this route (torch's prologue, the exact int32 sums, torch's epilogue). On a
CPU tensor it runs that plain version; a CUDA tensor launches the kernel or
raises.

The kernel reads the weights repacked once into the core-matrix order its
tensor-core instruction reads (`pack_weights`: [Cout/8][Cin16/16][8][16]
bytes, Cin padded to 16). `packed_weights` keeps one repack per weight
tensor; `prepare` fills it before a forward (quant.quantized_apply does),
so that a call inside a CUDA-graph capture allocates nothing. `launch_plan`
decides tiles, the column split, stages, grid and shared memory; the
launcher uses it and nothing else, and `quantized_conv1x1_tiled_reference`
walks the same plan tile by tile on the CPU.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Iterable, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakTensorKeyDictionary

from . import cuda_build, int8_conv

SMS = int8_conv.SMS
SMEM_LIMIT = int8_conv.SMEM_LIMIT
SM_SMEM = 233472           # shared memory of an SM, 1,024 bytes a CTA reserved
BM = 64                    # rows a consumer warpgroup (csrc BM)
BOX_BYTES = BM * 128       # a 64-row x 128-byte box of x
MAX_STAGES = 6
HEADER = 128 + 2 * 256 * 4  # barriers, column scales and biases
# accumulator widths of the kernel's instantiations (csrc launch_nt)
NT_WIDTHS = (16, 32, 64, 96, 128, 192, 256)
MIN_COLS = 16              # the narrowest column split

# the kernel's int arguments, in the order of csrc/int8_gemm.cuh `Args`
ARGS = ('M', 'K', 'N', 'in_dtype', 'bias_dtype', 'compute_dtype',
        'nt', 'nwg', 'cols', 'row_ctas', 'col_ctas', 'stages', 'smem')
Z = ((0, 0), (0, 0))


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(v: int, m: int) -> int:
    return _cdiv(v, m) * m


def block_k(in_bytes: int) -> int:
    """K values a stage: two 128-byte boxes of x."""
    return 256 // in_bytes


def stage_bytes(nt: int, nwg: int, in_bytes: int) -> int:
    return _round_up(nwg * 2 * BOX_BYTES + nt * block_k(in_bytes), 1024)


def smem_bytes(nt: int, nwg: int, in_bytes: int, stages: int) -> int:
    """csrc gemm_smem: header, alignment slack and the ring."""
    return HEADER + 1024 + stages * stage_bytes(nt, nwg, in_bytes)


def ctas_per_sm(nt: int, nwg: int) -> int:
    """csrc ctas_per_sm: two CTAs an SM for one consumer warpgroup with an
    accumulator of at most 128 columns, else one."""
    return 2 if nwg == 1 and nt <= 128 else 1


class Plan(NamedTuple):
    """One launch of csrc/int8_gemm.cuh: CTAs of nwg consumer warpgroups (64
    rows each) and a producer warpgroup, grid (row_ctas, col_ctas); CTA
    (x, y) walks the row tiles x, x + row_ctas, ... of 64 nwg rows and
    computes output columns [y cols, (y + 1) cols) in an accumulator nt
    wide; a ring of `stages` stages of bk K values."""
    nt: int
    nwg: int
    cols: int
    row_ctas: int
    col_ctas: int
    stages: int
    smem: int
    bk: int


@functools.lru_cache(maxsize=None)
def launch_plan(m: int, k: int, n: int, in_bytes: int) -> Plan:
    """The launch for x (m, k) of `in_bytes` an element (bf16 / fp16 2,
    fp32 4) and n output columns: at most 256 columns a CTA, split further
    (down to MIN_COLS) where the 64-row tiles do not fill the SMs; two
    consumer warpgroups where the 128-row tiles still do; the deepest ring
    (up to MAX_STAGES) that fits; a persistent grid of at most
    ctas_per_sm CTAs an SM (two for one warpgroup and at most 128 columns,
    each then in half the SM's shared memory)."""
    row_tiles = _cdiv(m, BM)
    splits = _cdiv(n, 256)
    cols = _round_up(_cdiv(n, splits), 8)
    while row_tiles * _cdiv(n, cols) < SMS and cols > MIN_COLS:
        splits += 1
        cols = max(MIN_COLS, _round_up(_cdiv(n, splits), 8))
    col_ctas = _cdiv(n, cols)
    nt = min(w for w in NT_WIDTHS if w >= cols)
    nwg = 2 if _cdiv(m, 2 * BM) * col_ctas >= SMS else 1
    while True:
        per_sm = ctas_per_sm(nt, nwg)
        limit = SMEM_LIMIT if per_sm == 1 else SM_SMEM // per_sm - 1024
        stages = max((s for s in range(2, MAX_STAGES + 1)
                      if smem_bytes(nt, nwg, in_bytes, s) <= limit),
                     default=0)
        if stages or nwg == 1:
            break
        nwg = 1
    if not stages:
        raise ValueError(f'no ring of two stages fits a {nt}-wide tile')
    row_ctas = min(_cdiv(m, BM * nwg), max(1, per_sm * SMS // col_ctas))
    return Plan(nt, nwg, cols, row_ctas, col_ctas, stages,
                smem_bytes(nt, nwg, in_bytes, stages), block_k(in_bytes))


# ---- the weights ----

def pack_weights(qw: torch.Tensor) -> torch.Tensor:
    """qw (Cout, Cin, 1, 1) int8 -> (Cout/8, Cin16/16, 8, 16) int8 with Cin
    zero-padded to Cin16, a multiple of 16: the core matrices (8 output
    channels x 16 input channels, row by row) that wgmma reads, K-major."""
    n, k = qw.shape[:2]
    w = qw.reshape(n, k)
    k16 = _round_up(k, 16)
    if k16 != k:
        w = F.pad(w, (0, k16 - k))
    return w.reshape(n // 8, 8, k16 // 16, 16).permute(0, 2, 1, 3).contiguous()


def unpack_piece(piece: torch.Tensor) -> torch.Tensor:
    """A box of the packed order, (groups, kblocks, 8, 16), back to (8
    groups, 16 kblocks) = (rows, K) as wgmma reads it."""
    g, kb = piece.shape[:2]
    return piece.permute(0, 2, 1, 3).reshape(8 * g, 16 * kb)


_PACKED = WeakTensorKeyDictionary()


def packed_weights(qw: torch.Tensor) -> torch.Tensor:
    """The repack of qw, made once (and again if qw was changed in place).
    Inside a CUDA-graph capture a weight that was not prepared raises: the
    repack would be captured, not made."""
    hit = _PACKED.get(qw)
    if hit is not None and hit[0] == qw._version:
        return hit[1]
    if qw.is_cuda and torch.cuda.is_current_stream_capturing():
        raise RuntimeError('quantized_conv1x1: weights not prepared before a '
                           'CUDA-graph capture (int8_gemm.prepare)')
    packed = pack_weights(qw)
    _PACKED[qw] = (qw._version, packed)
    return packed


def takes(qw_shape) -> bool:
    """Whether the kernel takes a conv of these weights: a 1x1 with Cin and
    Cout multiples of 8."""
    cout, cin, kh, kw = qw_shape
    return (kh, kw) == (1, 1) and cin % 8 == 0 and cout % 8 == 0


def prepare(qkernels: Iterable[torch.Tensor]) -> None:
    """The repack of every CUDA 1x1 kernel the kernel takes, made now."""
    for qw in qkernels:
        if qw.is_cuda and qw.dim() == 4 and takes(tuple(qw.shape)):
            packed_weights(qw)


# ---- plain versions ----

def quantized_conv1x1_reference(x: torch.Tensor, qw: torch.Tensor,
                                wscale: torch.Tensor, ascale: torch.Tensor,
                                bias: Optional[torch.Tensor],
                                compute_dtype: torch.dtype = torch.bfloat16
                                ) -> torch.Tensor:
    """The plain version: the unfused sequence of a 1x1 quantized conv
    (int8_conv.quantized_conv2d_reference at stride 1, no padding)."""
    return int8_conv.quantized_conv2d_reference(
        x, qw, wscale, ascale, bias, (1, 1), Z, 1, compute_dtype)


def quantized_conv1x1_tiled_reference(x: torch.Tensor, qw: torch.Tensor,
                                      wscale: torch.Tensor,
                                      ascale: torch.Tensor,
                                      bias: Optional[torch.Tensor],
                                      compute_dtype: torch.dtype =
                                      torch.bfloat16) -> torch.Tensor:
    """The kernel's tiling on the CPU: for every CTA of `launch_plan` and
    each of its row tiles, the K-blocks of the tile's x (zeros past M and
    K, quantized) against the box of packed weights the CTA loads (zeros
    past Cout and K), summed exactly, then the CTA's columns dequantized.
    Equal to the plain version when the plan and the pack are right."""
    b, h, w, k = x.shape
    n = qw.shape[0]
    m = b * h * w
    plan = launch_plan(m, k, n, x.element_size())
    packed = pack_weights(qw)
    rows = x.reshape(m, k)
    kpad = _round_up(k, 32)
    bmt = BM * plan.nwg
    row_tiles = _cdiv(m, bmt)
    out = torch.zeros((m, n), dtype=x.dtype)
    for by in range(plan.col_ctas):
        n0 = by * plan.cols
        ncols = min(plan.cols, n - n0)
        groups = plan.nt // 8
        for bx in range(plan.row_ctas):
            for tile in range(bx, row_tiles, plan.row_ctas):
                m0 = tile * bmt
                acc = torch.zeros((bmt, plan.nt), dtype=torch.float64)
                for k0 in range(0, kpad, plan.bk):
                    bk = min(plan.bk, kpad - k0)
                    a = torch.zeros((bmt, bk), dtype=x.dtype)
                    blk = rows[m0:m0 + bmt, k0:k0 + bk]
                    a[:blk.shape[0], :blk.shape[1]] = blk
                    qa = int8_conv._quantize(a, ascale)
                    box = torch.zeros((groups, plan.bk // 16, 8, 16),
                                      dtype=torch.int8)
                    src = packed[n0 // 8:n0 // 8 + groups,
                                 k0 // 16:(k0 + plan.bk) // 16]
                    box[:src.shape[0], :src.shape[1]] = src
                    wb = unpack_piece(box)[:, :bk]
                    acc += qa.double() @ wb.double().t()
                got = int8_conv._dequantize(
                    torch.round(acc[:, :ncols]).to(torch.int32),
                    wscale[n0:n0 + ncols], ascale,
                    None if bias is None else bias[n0:n0 + ncols],
                    compute_dtype, x.dtype)
                keep = min(bmt, m - m0)
                out[m0:m0 + keep, n0:n0 + ncols] = got[:keep]
    return out.reshape(b, h, w, n)


# ---- the card ----

@functools.lru_cache(maxsize=None)
def _launch_args(m: int, k: int, n: int, in_dtype: int, bias_dtype: int,
                 compute_dtype: int):
    """The kernel's int arguments (ARGS) as a C array; the dtypes as
    int8_conv.DTYPES codes."""
    plan = launch_plan(m, k, n, (1, 2, 4, 2)[in_dtype])
    values = (m, k, n, in_dtype, bias_dtype, compute_dtype, plan.nt,
              plan.nwg, plan.cols, plan.row_ctas, plan.col_ctas, plan.stages,
              plan.smem)
    assert len(values) == len(ARGS)
    return (ctypes.c_int * len(values))(*values)


_FNS = {}
# the library of each input dtype (csrc/int8_gemm_{bf16,fp16,fp32}.cu)
LIBS = {torch.bfloat16: 'int8_gemm_bf16', torch.float16: 'int8_gemm_fp16',
        torch.float32: 'int8_gemm_fp32'}


def _kernel(dtype: torch.dtype):
    fn = _FNS.get(dtype)
    if fn is None:
        fn = cuda_build.load(LIBS[dtype]).quantized_conv1x1
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_void_p, ctypes.c_int,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FNS[dtype] = fn
    return fn


def quantized_conv1x1(x: torch.Tensor, qw: torch.Tensor,
                      wscale: torch.Tensor, ascale: torch.Tensor,
                      bias: Optional[torch.Tensor],
                      compute_dtype: torch.dtype = torch.bfloat16
                      ) -> torch.Tensor:
    """The kernel: x (B, H, W, Cin) bf16, fp16 or fp32 (any strides; an
    input that is not NHWC in memory is copied and counted in
    int8_conv.layout_copies), qw (Cout, Cin, 1, 1) int8 with Cin and Cout
    multiples of 8, wscale (Cout,) and ascale () fp32, bias (Cout,) or
    None -> (B, H, W, Cout) in x's dtype, equal to
    quantized_conv1x1_reference bit for bit. A CPU tensor takes the plain
    version."""
    int8_conv._check_fused(x, qw, wscale, ascale, bias, 1, compute_dtype)
    if not takes(tuple(qw.shape)):
        raise ValueError(f'a 1x1 conv with Cin and Cout multiples of 8 '
                         f'expected, got weights {tuple(qw.shape)}')
    if x.device.type == 'cpu':
        return quantized_conv1x1_reference(x, qw, wscale, ascale, bias,
                                           compute_dtype)
    b, h, w, k = x.shape
    n = qw.shape[0]
    m = b * h * w
    if m >= 2 ** 31:
        raise ValueError(f'{m} rows: 2^31 or more')
    if not x.is_contiguous():
        x = x.contiguous()
        int8_conv.layout_copies['quantized_conv1x1'] += 1
    packed = packed_weights(qw)
    out = torch.empty((b, h, w, n), dtype=x.dtype, device=x.device)
    dt = int8_conv.DTYPES
    args = _launch_args(m, k, n, dt[x.dtype],
                        0 if bias is None else dt[bias.dtype],
                        dt[compute_dtype])
    with torch.cuda.device(x.device):
        err = _kernel(x.dtype)(
            x.data_ptr(), packed.data_ptr(), ascale.data_ptr(),
            wscale.data_ptr(), None if bias is None else bias.data_ptr(),
            out.data_ptr(), args, len(ARGS),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f'quantized_conv1x1 launch failed with CUDA error '
                           f'{err}')
    int8_conv.launches['quantized_conv1x1'] += 1
    return out
