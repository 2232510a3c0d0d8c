"""int8 x int8 -> int32 convolution: the plain version and the two card
routes of the quantized forward (quant.py).

The JAX package computes this convolution with XLA, outside any Pallas
kernel (mm_distillnet_tpu/quant.py:209-223). PyTorch has no int8
convolution on CUDA, and an fp32 cuDNN convolution of integer values is not
exact (Winograd or FFT algorithms; above about 1,040 taps the sums leave
fp32's exact integer range). So a quantized conv takes one of two routes,
decided by the shape of each call (`route`):

  'int_mm'       a 1x1, stride-1, ungrouped conv with no padding whose Cin
                 and Cout are multiples of 8, on more than 16 rows (B*H*W):
                 the NHWC input as (B*H*W, Cin) through torch._int_mm
                 (cuBLASLt's s8 GEMM, TN layout), whose limits these are;
  'int8_conv2d'  every other conv (depthwise, the stem, any 1x1 the GEMM
                 refuses): the hand-written CUDA kernel csrc/int8_conv.cu.

Both return the exact int32 accumulators. `int8_conv2d_reference` is the
plain version: an fp64 F.conv2d of the int8 values rounded back to int32,
exact because |acc| <= 127^2 K is far below 2^53. On a CPU tensor both
routes run it; a CUDA tensor launches the kernel (or the GEMM) or raises.
`launches` counts the card's launches of each route.

Layout: activations NHWC (the kernel's), weights OIHW (the port's
state_dict layout), padding as ((top, bottom), (left, right)) zeros.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from . import cuda_build

launches = {'int8_conv2d': 0, 'int_mm': 0}

# the largest tap count whose int32 sums cannot overflow (127^2 K < 2^31)
MAX_TAPS = (2 ** 31 - 1) // (127 * 127)
INT_MM_MIN_ROWS = 17

Pads = Tuple[Tuple[int, int], Tuple[int, int]]


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


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
    16 rows), else 'int8_conv2d'."""
    b, h, w, cin = qx_shape
    cout = qw_shape[0]
    if (tuple(qw_shape[2:]) == (1, 1) and tuple(stride) == (1, 1)
            and groups == 1 and padding == ((0, 0), (0, 0))
            and cin % 8 == 0 and cout % 8 == 0
            and b * h * w >= INT_MM_MIN_ROWS):
        return 'int_mm'
    return 'int8_conv2d'


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


def _check(qx: torch.Tensor, qw: torch.Tensor, groups: int) -> None:
    if qx.dtype != torch.int8 or qw.dtype != torch.int8:
        raise ValueError(f'int8 operands expected, got {qx.dtype} and '
                         f'{qw.dtype}')
    if qx.dim() != 4 or qw.dim() != 4:
        raise ValueError('qx is (B, H, W, Cin) and qw (Cout, Cin/g, kh, kw)')
    if qx.shape[-1] != qw.shape[1] * groups or qw.shape[0] % groups:
        raise ValueError(f'{qx.shape[-1]} input channels, weight '
                         f'{tuple(qw.shape)}, groups {groups}')
    if qx.device != qw.device:
        raise ValueError(f'qx on {qx.device}, qw on {qw.device}')
    taps = qw.shape[1] * qw.shape[2] * qw.shape[3]
    if taps > MAX_TAPS:
        raise ValueError(f'{taps} taps can overflow the int32 sums')


_FN = None


def _kernel():
    global _FN
    if _FN is None:
        fn = cuda_build.load('int8_conv').int8_conv2d
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 14 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def int8_conv2d(qx: torch.Tensor, qw: torch.Tensor, stride: Tuple[int, int],
                padding: Pads, groups: int) -> torch.Tensor:
    """The kernel: qx (B, H, W, Cin) int8, qw (Cout, Cin/groups, kh, kw)
    int8 -> int32 (B, Ho, Wo, Cout). A CPU tensor takes the plain version."""
    _check(qx, qw, groups)
    if qx.device.type == 'cpu':
        return int8_conv2d_reference(qx, qw, stride, padding, groups)
    b, h, w, cin = qx.shape
    cout, _, kh, kw = qw.shape
    ho, wo = output_hw(h, w, (kh, kw), stride, padding)
    if ho < 1 or wo < 1:
        raise ValueError(f'no output for a {h}x{w} input')
    qx = qx.contiguous()
    qw = qw.contiguous()
    out = torch.empty((b, ho, wo, cout), dtype=torch.int32, device=qx.device)
    with torch.cuda.device(qx.device):
        err = _kernel()(qx.data_ptr(), qw.data_ptr(), out.data_ptr(), b, h, w,
                        cin, ho, wo, cout, kh, kw, stride[0], stride[1],
                        padding[0][0], padding[1][0], groups,
                        torch.cuda.current_stream(qx.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f'int8_conv2d launch failed with CUDA error {err}')
    launches['int8_conv2d'] += 1
    return out


def int_mm(qx: torch.Tensor, qw: torch.Tensor) -> torch.Tensor:
    """A 1x1 conv as the s8 GEMM: qx (B, H, W, Cin) int8, qw (Cout, Cin, 1,
    1) int8 -> int32 (B, H, W, Cout). A CPU tensor takes the plain
    version; a CUDA call needs more than 16 rows."""
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


def bound_ms(qx_shape, qw_shape, out_shape) -> Tuple[float, str]:
    """Least time on an H100 SXM for one call: the int8 input and weights
    read once and the int32 output written once at 3.35 TB/s, or the
    multiply-adds at the int8 tensor-core rate (1,979 TOPS dense), the
    larger."""
    b, h, w, cin = qx_shape
    cout, cin_g, kh, kw = qw_shape
    ob, ho, wo, oc = out_shape
    nbytes = b * h * w * cin + cout * cin_g * kh * kw + ob * ho * wo * oc * 4
    ops = 2.0 * ob * ho * wo * oc * cin_g * kh * kw
    t_bytes, t_ops = nbytes / 3.35e12, ops / 1979e12
    return (max(t_bytes, t_ops) * 1e3,
            'bytes' if t_bytes >= t_ops else 'operations')
