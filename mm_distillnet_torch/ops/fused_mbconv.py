"""Fused eval-mode MBConv block: BN folding, the plain PyTorch version, and
the wrappers of the hand-written CUDA kernels in csrc/mbconv.cu.

Counterpart of mm_distillnet_tpu/ops/pallas_mbconv.py: `_mbconv_kernel`
(launched by `mbconv_fused`) runs a whole MBConv block per image out of
VMEM. On Hopper the block is three kernels (see csrc/mbconv.cu):

  (a) `expand_dw`  expand 1x1 + swish + depthwise kxk + swish, 8x8 output
                   tiles with the expand recomputed on the halo; bf16 output
                   plus fp32 per-tile channel sums;
  (b) `se_gate`    tile sums -> mean -> SE GEMVs -> fp32 gate;
  (c) `project`    gated project GEMM + bias + identity skip, bf16 out.

What bounds them and why the design is so is noted in the CUDA source.

Each wrapper runs its kernel for a CUDA tensor and counts the launch in
`launches`; for a CPU tensor it runs the plain version (`*_reference`),
which repeats the kernel's arithmetic and rounding points in torch:
the expanded activation is rounded to bf16 before the taps, the depthwise
accumulates in fp32 from the bias, the SE mean is taken over the fp32
depthwise output before its bf16 rounding, the gate is applied in fp32 and
rounded to bf16 before the project, the skip is added in fp32.
There is no fallback: a CUDA tensor launches the kernel or raises.

Layout: NHWC activations; expanded channels padded to a multiple of 32
(`CHANNEL_ALIGN`, the channel chunk of kernel (a)); padded channels carry
zero weights and stay exact zeros end to end.
"""
from __future__ import annotations

import ctypes
from typing import Mapping, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..models.efficientnet import BlockArgs, has_se
from ..models.layers import BN_EPS, same_pad_amounts, swish
from . import cuda_build

CHANNEL_ALIGN = 32        # expanded channels per block of kernel (a)
TILE = 8                  # output tile side of kernel (a)
MAX_SMEM_BYTES = 232448   # dynamic shared memory one H100 block may use

launches = {'mbconv_expand_dw': 0, 'mbconv_se': 0, 'mbconv_project': 0}


class FoldedMBConv(NamedTuple):
    """BN-folded MBConv weights; expanded channels padded to CeP. A block
    without expand (expand_ratio 1) has w_exp = b_exp = None."""
    w_exp: Optional[torch.Tensor]   # (Cin, CeP) bf16
    b_exp: Optional[torch.Tensor]   # (CeP,) f32
    w_dw: torch.Tensor              # (k, k, CeP) f32
    b_dw: torch.Tensor              # (CeP,) f32
    w_se1: torch.Tensor             # (Cs, CeP) f32, row j reduces into j
    b_se1: torch.Tensor             # (Cs,) f32
    w_se2: torch.Tensor             # (Cs, CeP) f32
    b_se2: torch.Tensor             # (CeP,) f32
    w_prj: torch.Tensor             # (CeP, Co) bf16
    b_prj: torch.Tensor             # (Co,) f32


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _fold_conv_bn(weight: torch.Tensor, sd: Mapping[str, torch.Tensor],
                  bn: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """OIHW conv weight and BN `bn` -> folded (weight, bias), fp32."""
    scale = sd[f'{bn}.weight'].float() / torch.sqrt(
        sd[f'{bn}.running_var'].float() + BN_EPS)
    k = weight.float() * scale.reshape(-1, *([1] * (weight.dim() - 1)))
    b = sd[f'{bn}.bias'].float() - sd[f'{bn}.running_mean'].float() * scale
    return k, b


def _pad_cols(a: torch.Tensor, size: int) -> torch.Tensor:
    return F.pad(a, (0, size - a.shape[-1]))


def fold_mbconv(sd: Mapping[str, torch.Tensor], args: BlockArgs,
                device=None) -> FoldedMBConv:
    """sd: one block's state_dict (keys `_expand_conv.conv.weight`,
    `_bn0.running_var`, ...). Raises for a block the kernels cannot take."""
    if not has_se(args):
        raise ValueError('the fused MBConv kernels need a squeeze-excite')
    ce = args.input_filters * args.expand_ratio
    cep = _round_up(ce, CHANNEL_ALIGN)
    if args.expand_ratio != 1:
        k, b = _fold_conv_bn(sd['_expand_conv.conv.weight'], sd, '_bn0')
        w_exp = _pad_cols(k[:, :, 0, 0].t(), cep).to(torch.bfloat16)
        b_exp = _pad_cols(b, cep)
    else:
        w_exp = b_exp = None
    k, b = _fold_conv_bn(sd['_depthwise_conv.conv.weight'], sd, '_bn1')
    w_dw = _pad_cols(k[:, 0].permute(1, 2, 0), cep)
    b_dw = _pad_cols(b, cep)
    k, b = _fold_conv_bn(sd['_project_conv.conv.weight'], sd, '_bn2')
    w_prj = F.pad(k[:, :, 0, 0].t(), (0, 0, 0, cep - ce)).to(torch.bfloat16)
    w_se1 = _pad_cols(sd['_se_reduce.conv.weight'][:, :, 0, 0].float(), cep)
    b_se1 = sd['_se_reduce.conv.bias'].float()
    w_se2 = _pad_cols(sd['_se_expand.conv.weight'][:, :, 0, 0].float().t(),
                      cep)
    b_se2 = _pad_cols(sd['_se_expand.conv.bias'].float(), cep)
    tensors = (w_exp, b_exp, w_dw, b_dw, w_se1, b_se1, w_se2, b_se2,
               w_prj, b)
    return FoldedMBConv(*(None if t is None else t.contiguous().to(device)
                          for t in tensors))


def has_skip(args: BlockArgs) -> bool:
    return (args.id_skip and args.stride == 1
            and args.input_filters == args.output_filters)


def output_hw(h: int, w: int, args: BlockArgs) -> Tuple[int, int]:
    """(Ho, Wo) = (H/s, W/s). Odd sizes at stride 2 raise: there the TPU
    kernel emits floor(H/2) rows and flax 'SAME' ceil(H/2)."""
    s = args.stride
    if s == 2 and (h % 2 or w % 2):
        raise ValueError(f'stride-2 MBConv needs even H and W, got {h}x{w}')
    return h // s, w // s


def num_tiles(ho: int, wo: int) -> int:
    return -(-ho // TILE) * -(-wo // TILE)


def expand_dw_smem_bytes(args: BlockArgs) -> int:
    """Shared memory that kernel (a) needs for this block (csrc/mbconv.cu
    expand_dw_smem): the fp32 expanded tile (pixels padded to 40 floats),
    depthwise weights and biases, and for an expand the bf16 input halo and
    w_exp chunk (rows of round_up(cin, 16) + 8)."""
    k, s, cin = args.kernel_size, args.stride, args.input_filters
    np_ = ((TILE - 1) * s + k) ** 2
    n = (np_ * (CHANNEL_ALIGN + 8) + k * k * CHANNEL_ALIGN
         + 10 * CHANNEL_ALIGN) * 4
    if args.expand_ratio != 1:
        n += (CHANNEL_ALIGN + np_) * (_round_up(cin, 16) + 8) * 2
    return n


def check_kernel_fits(args: BlockArgs) -> None:
    """Raise for a block the CUDA kernels cannot take."""
    if args.kernel_size not in (3, 5) or args.stride not in (1, 2):
        raise ValueError(f'no MBConv kernel for k={args.kernel_size} '
                         f's={args.stride}')
    if not has_se(args):
        raise ValueError('the fused MBConv kernels need a squeeze-excite')
    if args.expand_ratio != 1 and args.input_filters % 8:
        raise ValueError('the expand kernel reads the input 8 channels at a '
                         f'time; got {args.input_filters} channels')
    if args.output_filters % 2:
        raise ValueError('the project kernel writes channel pairs; got '
                         f'{args.output_filters} output channels')
    smem = expand_dw_smem_bytes(args)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f'MBConv block {args} needs {smem} B of shared '
                         f'memory, more than {MAX_SMEM_BYTES}')


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def expand_dw_reference(x: torch.Tensor, f: FoldedMBConv, args: BlockArgs
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, H, W, Cin) bf16 -> (d (B, Ho, Wo, CeP) bf16, sums (B, 1, CeP) f32)."""
    b, h, w, cin = x.shape
    k, s = args.kernel_size, args.stride
    ho, wo = output_hw(h, w, args)
    cep = f.w_dw.shape[-1]
    xf = x.float()
    if f.w_exp is not None:
        e = swish(xf @ f.w_exp.float() + f.b_exp)
    else:
        e = _pad_cols(xf, cep)
    e = e.to(torch.bfloat16).float()
    pt, pb = same_pad_amounts(h, s, k)
    pl, pr = same_pad_amounts(w, s, k)
    e = F.pad(e, (0, 0, pl, pr + s - 1, pt, pb + s - 1))  # zeros: TF-SAME
    acc = f.b_dw.expand(b, ho, wo, cep)
    for dy in range(k):
        for dx in range(k):
            win = e[:, dy:dy + s * (ho - 1) + 1:s, dx:dx + s * (wo - 1) + 1:s]
            acc = acc + win * f.w_dw[dy, dx]
    dv = swish(acc)
    return dv.to(torch.bfloat16), dv.sum(dim=(1, 2))[:, None, :]


def se_gate_reference(sums: torch.Tensor, f: FoldedMBConv,
                      hw: int) -> torch.Tensor:
    """sums (B, T, CeP) per-tile channel sums -> gate (B, CeP) f32."""
    m = sums.sum(dim=1) / hw
    s1 = swish(m @ f.w_se1.t() + f.b_se1)
    return torch.sigmoid(s1 @ f.w_se2 + f.b_se2)


def project_reference(d: torch.Tensor, gate: torch.Tensor, f: FoldedMBConv,
                      skip: Optional[torch.Tensor]) -> torch.Tensor:
    """d (B, Ho, Wo, CeP) bf16, gate (B, CeP) -> (B, Ho, Wo, Co) bf16."""
    a = (d.float() * gate[:, None, None, :]).to(torch.bfloat16).float()
    out = a @ f.w_prj.float() + f.b_prj
    if skip is not None:
        out = out + skip.float()
    return out.to(torch.bfloat16)


def mbconv_fused_reference(x: torch.Tensor, f: FoldedMBConv,
                           args: BlockArgs) -> torch.Tensor:
    """The whole block in plain torch: x (B, H, W, Cin) -> (B, Ho, Wo, Co) bf16."""
    x = x.to(torch.bfloat16)
    d, sums = expand_dw_reference(x, f, args)
    gate = se_gate_reference(sums, f, d.shape[1] * d.shape[2])
    return project_reference(d, gate, f, x if has_skip(args) else None)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    'mbconv_expand_dw': [_P] * 7 + [_I] * 9 + [_P],
    'mbconv_se': [_P] * 6 + [_I] * 5 + [_P],
    'mbconv_project': [_P] * 6 + [_I] * 4 + [_P],
}


_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    """csrc/mbconv.cu, built at first use, with its C signatures set."""
    global _LIB
    if _LIB is None:
        lib = cuda_build.load('mbconv')
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check(t: torch.Tensor, dtype: torch.dtype, shape, device, name: str):
    if t.device != device:
        raise ValueError(f'{name} is on {t.device}, expected {device}')
    if t.dtype != dtype:
        raise ValueError(f'{name} is {t.dtype}, expected {dtype}')
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f'{name} has shape {tuple(t.shape)}, expected '
                         f'{tuple(shape)}')
    if not t.is_contiguous():
        raise ValueError(f'{name} must be contiguous')


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f'{name} launch failed with CUDA error {err}')


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def expand_dw(x: torch.Tensor, f: FoldedMBConv, args: BlockArgs
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel (a): x (B, H, W, Cin) bf16 -> (d (B, Ho, Wo, CeP) bf16,
    per-tile sums (B, T, CeP) f32)."""
    if x.device.type == 'cpu':
        return expand_dw_reference(x, f, args)
    b, h, w, cin = x.shape
    k, s = args.kernel_size, args.stride
    ho, wo = output_hw(h, w, args)
    cep = f.w_dw.shape[-1]
    dev = x.device
    check_kernel_fits(args)
    _check(x, torch.bfloat16, (b, h, w, args.input_filters), dev, 'x')
    if x.data_ptr() % 16:
        raise ValueError('x must start on a 16-byte boundary')
    if f.w_exp is not None:
        _check(f.w_exp, torch.bfloat16, (cin, cep), dev, 'w_exp')
        _check(f.b_exp, torch.float32, (cep,), dev, 'b_exp')
    elif args.expand_ratio != 1:
        raise ValueError('folded weights lack the expand conv')
    _check(f.w_dw, torch.float32, (k, k, cep), dev, 'w_dw')
    _check(f.b_dw, torch.float32, (cep,), dev, 'b_dw')
    d = torch.empty((b, ho, wo, cep), dtype=torch.bfloat16, device=dev)
    sums = torch.empty((b, num_tiles(ho, wo), cep), dtype=torch.float32,
                       device=dev)
    pt, _ = same_pad_amounts(h, s, k)
    pl, _ = same_pad_amounts(w, s, k)
    err = _lib().mbconv_expand_dw(
        _ptr(x), _ptr(f.w_exp), _ptr(f.b_exp), _ptr(f.w_dw), _ptr(f.b_dw),
        _ptr(d), _ptr(sums), b, h, w, cin, cep, k, s, pt, pl, _stream(dev))
    _raise_on(err, 'mbconv_expand_dw')
    launches['mbconv_expand_dw'] += 1
    return d, sums


def se_gate(sums: torch.Tensor, f: FoldedMBConv, hw: int) -> torch.Tensor:
    """Kernel (b): per-tile sums (B, T, CeP) -> gate (B, CeP) f32."""
    if sums.device.type == 'cpu':
        return se_gate_reference(sums, f, hw)
    b, t, cep = sums.shape
    cs = f.w_se1.shape[0]
    dev = sums.device
    _check(sums, torch.float32, (b, t, cep), dev, 'sums')
    _check(f.w_se1, torch.float32, (cs, cep), dev, 'w_se1')
    _check(f.b_se1, torch.float32, (cs,), dev, 'b_se1')
    _check(f.w_se2, torch.float32, (cs, cep), dev, 'w_se2')
    _check(f.b_se2, torch.float32, (cep,), dev, 'b_se2')
    gate = torch.empty((b, cep), dtype=torch.float32, device=dev)
    err = _lib().mbconv_se(_ptr(sums), _ptr(f.w_se1), _ptr(f.b_se1),
                           _ptr(f.w_se2), _ptr(f.b_se2), _ptr(gate), b, t,
                           cep, cs, hw, _stream(dev))
    _raise_on(err, 'mbconv_se')
    launches['mbconv_se'] += 1
    return gate


def project(d: torch.Tensor, gate: torch.Tensor, f: FoldedMBConv,
            skip: Optional[torch.Tensor]) -> torch.Tensor:
    """Kernel (c): bf16(d * gate) @ w_prj + b_prj (+ skip) -> bf16."""
    if d.device.type == 'cpu':
        return project_reference(d, gate, f, skip)
    b, ho, wo, cep = d.shape
    co = f.w_prj.shape[1]
    dev = d.device
    _check(d, torch.bfloat16, (b, ho, wo, cep), dev, 'd')
    _check(gate, torch.float32, (b, cep), dev, 'gate')
    _check(f.w_prj, torch.bfloat16, (cep, co), dev, 'w_prj')
    _check(f.b_prj, torch.float32, (co,), dev, 'b_prj')
    if skip is not None:
        _check(skip, torch.bfloat16, (b, ho, wo, co), dev, 'skip')
    out = torch.empty((b, ho, wo, co), dtype=torch.bfloat16, device=dev)
    err = _lib().mbconv_project(_ptr(d), _ptr(gate), _ptr(f.w_prj),
                                _ptr(f.b_prj), _ptr(skip), _ptr(out),
                                b * ho * wo, ho * wo, cep, co, _stream(dev))
    _raise_on(err, 'mbconv_project')
    launches['mbconv_project'] += 1
    return out


def mbconv_fused(x: torch.Tensor, f: FoldedMBConv,
                 args: BlockArgs) -> torch.Tensor:
    """One eval MBConv block: x (B, H, W, Cin) bf16 -> (B, H/s, W/s, Co) bf16.
    CUDA tensors run kernels (a)-(c); CPU tensors their plain versions."""
    output_hw(x.shape[1], x.shape[2], args)
    d, sums = expand_dw(x, f, args)
    gate = se_gate(sums, f, d.shape[1] * d.shape[2])
    return project(d, gate, f, x if has_skip(args) else None)


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _bound_ms(nbytes: float, ops: Mapping[str, float]) -> Tuple[float, str]:
    """Least time on an H100 SXM (3.35 TB/s; 989 TFLOP/s bf16 tensor core,
    67 TFLOP/s fp32): the larger of the byte time and the op time."""
    peak = {'bf16': 989e12, 'fp32': 67e12}
    t_bytes = nbytes / 3.35e12
    t_ops = sum(n / peak[kind] for kind, n in ops.items())
    return (max(t_bytes, t_ops) * 1e3,
            'bytes' if t_bytes >= t_ops else 'operations')


def bounds(args: BlockArgs, batch: int, h: int, w: int) -> dict:
    """Per-kernel least times (ms) for one block at this shape: each input
    read once and each output written once, at the block's own expanded
    width Ce (the kernels' padding of Ce to CHANNEL_ALIGN is their cost,
    not the function's), expand and project as bf16 GEMMs on the tensor
    cores, the depthwise and SE in fp32."""
    k, s, cin, co = (args.kernel_size, args.stride, args.input_filters,
                     args.output_filters)
    ho, wo = output_hw(h, w, args)
    ce = cin * args.expand_ratio
    cs = max(1, int(cin * args.se_ratio))
    t = num_tiles(ho, wo)
    x_b = batch * h * w * cin * 2
    d_b = batch * ho * wo * ce * 2
    out_b = batch * ho * wo * co * 2
    sums_b = batch * t * ce * 4
    expand = args.expand_ratio != 1
    a_bytes = (x_b + d_b + sums_b + (k * k + 1) * ce * 4
               + ((cin * ce * 2 + ce * 4) if expand else 0))
    a_ops = {'bf16': 2.0 * batch * h * w * cin * ce if expand else 0.0,
             'fp32': 2.0 * batch * ho * wo * ce * k * k}
    b_bytes = sums_b + (2 * cs * ce + cs + ce) * 4 + batch * ce * 4
    b_ops = {'fp32': 4.0 * batch * cs * ce}
    c_bytes = (d_b + batch * ce * 4 + ce * co * 2 + co * 4 + out_b
               + (out_b if has_skip(args) else 0))
    c_ops = {'bf16': 2.0 * batch * ho * wo * ce * co}
    return {'mbconv_expand_dw': _bound_ms(a_bytes, a_ops),
            'mbconv_se': _bound_ms(b_bytes, b_ops),
            'mbconv_project': _bound_ms(c_bytes, c_ops)}
