"""Post-training int8 quantization (port of mm_distillnet_tpu/quant.py).

The same module tree runs fp or int8 by context: inside `quantized_apply`
every `nn.Conv2d` the pack holds computes int8 x int8 -> int32 and every
other op (BN, swish, SE gating, pooling, fast attention, the convs the pack
leaves out) keeps its fp semantics. The JAX package intercepts flax's
`nn.Conv.__call__`; here the interception point is the forward of each
`nn.Conv2d` (`Conv2dSame` pads in fp before its inner conv, and a zero pads
to the quantized zero), replaced for the length of a context and restored
after it. The module tree and its weights are not modified.

- Static symmetric scheme: per-tensor activation scales from the absmax of
  each conv's input over calibration batches, per-output-channel weight
  scales (absmax / 127), both as the JAX package computes them.
- The int8 convolution runs by route (ops/int8_conv.py), each through a
  CUDA kernel that fuses the prologue and epilogue below: 1x1 stride-1
  ungrouped convs through the s8 GEMM `quantized_conv1x1`
  (ops/int8_gemm.py, its weights repacked once per pack before the
  forward), all others through `quantized_conv2d`; on the CPU, the exact
  plain version. The route is decided by the shape of each call
  (`int8_conv.route`): a conv's row count, and so whether the GEMM takes
  it, depends on the batch.
- Prologue `clamp(round_half_even(x / sx), -127, 127)`, epilogue
  `acc * (sx * wscale) + bias` in fp32, rounded through `compute_dtype`
  (bf16 by default, as in the JAX package) and returned in the input's
  dtype (flax promotes a bf16 conv output against fp32 BN parameters; a
  torch BatchNorm2d refuses a dtype other than its own).
- Policy: the SE convs and the heads' final pointwise convs (the JAX
  package's `header_pointwise`, here `header.pointwise_conv`) stay fp;
  depthwise convs are switchable.
- Calibration keeps the JAX package's per-batch overwrite: a conv called
  several times in one forward (the heads' convs, shared across the five
  pyramid levels) records the absmax of its LAST call in a batch (P7's);
  only across batches is the maximum taken.

Pack keys are the port's module names of the `nn.Conv2d`s
(`backbone_net.model._blocks.0._expand_conv.conv`); the weights of a key
are `state_dict[key + '.weight']`, OIHW.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Any, Callable, Dict, Iterable, Mapping, NamedTuple, \
    Optional, Tuple

import numpy as np
import torch
from torch import nn

from .ops import int8_conv, int8_gemm

__all__ = ['QuantPolicy', 'QuantPack', 'collect_conv_specs',
           'calibrate_activations', 'quantize_weights', 'build_quant_pack',
           'quantized_apply', 'pack_to']


class QuantPolicy(NamedTuple):
    """Which convs quantize. Paths are the port's '.'-joined module names."""
    quantize_depthwise: bool = True
    skip_substrings: Tuple[str, ...] = ('_se_reduce', '_se_expand',
                                        'header.pointwise_conv')

    def wants(self, path: str, groups: int) -> bool:
        if any(s in path for s in self.skip_substrings):
            return False
        if groups > 1 and not self.quantize_depthwise:
            return False
        return True


class QuantPack(NamedTuple):
    """Everything the quantized forward needs beyond the fp module.

    qkernels: path -> int8 (out, in_per_group, kh, kw)
    wscales:  path -> fp32 (out,)  weight dequant scale (absmax / 127)
    ascales:  path -> fp32 ()      input activation scale (absmax / 127)
    """
    qkernels: Dict[str, torch.Tensor]
    wscales: Dict[str, torch.Tensor]
    ascales: Dict[str, torch.Tensor]


def _padding(conv: nn.Conv2d) -> int8_conv.Pads:
    if conv.padding_mode != 'zeros' or tuple(conv.dilation) != (1, 1):
        raise ValueError(f'no int8 route for padding_mode '
                         f'{conv.padding_mode!r}, dilation {conv.dilation}')
    if isinstance(conv.padding, str):
        if conv.padding != 'valid':
            raise ValueError(f'padding {conv.padding!r}: give the amounts')
        return (0, 0), (0, 0)
    ph, pw = conv.padding
    return (ph, ph), (pw, pw)


def conv_spec(conv: nn.Conv2d) -> Dict[str, Any]:
    """The static facts of one conv."""
    return dict(kernel_size=tuple(conv.kernel_size),
                strides=tuple(conv.stride), groups=conv.groups,
                use_bias=conv.bias is not None, padding=_padding(conv))


@contextlib.contextmanager
def _intercepted(model: nn.Module,
                 call: Callable[[str, nn.Conv2d, torch.Tensor],
                                torch.Tensor]):
    """Within the context every nn.Conv2d of `model` runs
    call(path, conv, x); `conv_forward(conv, x)` is its own forward."""
    convs = [(p, m) for p, m in model.named_modules()
             if isinstance(m, nn.Conv2d)]
    for path, m in convs:
        m.forward = functools.partial(call, path, m)
    try:
        yield
    finally:
        for _, m in convs:
            del m.forward


def conv_forward(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    return type(conv).forward(conv, x)


def _device_of(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def _as_input(model: nn.Module, x) -> torch.Tensor:
    return torch.as_tensor(x, device=_device_of(model))


@torch.no_grad()
def collect_conv_specs(model: nn.Module, example_input,
                       policy: QuantPolicy = QuantPolicy(),
                       **forward_kwargs) -> Dict[str, Dict[str, Any]]:
    """One forward pass recording every nn.Conv2d the policy selects, in
    call order: path -> {kernel_size, strides, groups, use_bias,
    padding}."""
    specs: Dict[str, Dict[str, Any]] = {}

    def call(path, conv, x):
        if path not in specs and policy.wants(path, conv.groups):
            specs[path] = conv_spec(conv)
        return conv_forward(conv, x)

    with _intercepted(model, call):
        model(_as_input(model, example_input), **forward_kwargs)
    return specs


@torch.no_grad()
def calibrate_activations(model: nn.Module, batches: Iterable,
                          policy: QuantPolicy = QuantPolicy(),
                          **forward_kwargs) -> Dict[str, float]:
    """Per-conv-input absmax over calibration batches (path -> float). A
    conv called more than once in a batch keeps its last call's absmax."""
    absmax: Dict[str, float] = {}
    for batch in batches:
        stats: Dict[str, torch.Tensor] = {}

        def call(path, conv, x):
            if policy.wants(path, conv.groups):
                stats[path] = x.float().abs().amax()
            return conv_forward(conv, x)

        with _intercepted(model, call):
            model(_as_input(model, batch), **forward_kwargs)
        if stats:
            values = torch.stack(list(stats.values())).cpu().tolist()
            for path, v in zip(stats, values):
                absmax[path] = max(absmax.get(path, 0.0), float(v))
    return absmax


def quantize_weights(state_dict: Mapping[str, torch.Tensor],
                     specs: Mapping[str, Any], device=None
                     ) -> Tuple[Dict[str, torch.Tensor],
                                Dict[str, torch.Tensor]]:
    """Symmetric per-output-channel int8 weights, on the host in fp32 numpy
    (the JAX package's arithmetic, so its qkernels and wscales come out
    bit-equal), then on `device`."""
    qkernels: Dict[str, torch.Tensor] = {}
    wscales: Dict[str, torch.Tensor] = {}
    for path in specs:
        kernel = state_dict[path + '.weight'].detach().float().cpu().numpy()
        absmax = np.max(np.abs(kernel), axis=(1, 2, 3))
        scale = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
        q = np.clip(np.rint(kernel / scale[:, None, None, None]), -127,
                    127).astype(np.int8)
        qkernels[path] = torch.from_numpy(q).to(device)
        wscales[path] = torch.from_numpy(scale).to(device)
    return qkernels, wscales


def build_quant_pack(model: nn.Module, example_input,
                     calibration_batches: Iterable,
                     policy: QuantPolicy = QuantPolicy(),
                     state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                     **forward_kwargs) -> QuantPack:
    """Calibrate + quantize, the one-call offline step. `model` runs the
    passes on its own device and dtype (eval mode is the caller's); the
    weights are quantized from `state_dict` (default: the model's), whose
    fp32 values the JAX package would quantize."""
    specs = collect_conv_specs(model, example_input, policy,
                               **forward_kwargs)
    absmax = calibrate_activations(model, calibration_batches, policy,
                                   **forward_kwargs)
    dev = _device_of(model)
    qkernels, wscales = quantize_weights(
        model.state_dict() if state_dict is None else state_dict, specs, dev)
    ascales = {p: torch.tensor(np.float32(max(absmax.get(p, 0.0), 1e-12)
                                          / 127.0), device=dev)
               for p in specs}
    return QuantPack(qkernels, wscales, ascales)


def pack_to(pack: QuantPack, device) -> QuantPack:
    """The pack with its tensors on `device`."""
    return QuantPack(*({p: t.to(device) for p, t in d.items()}
                       for d in pack))


def fused_conv(x: torch.Tensor, qw: torch.Tensor, wscale: torch.Tensor,
               ascale: torch.Tensor, bias: Optional[torch.Tensor],
               stride: Tuple[int, int], padding: int8_conv.Pads, groups: int,
               compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """A quantized conv on x (B, H, W, Cin) through its route's fused
    kernel (int8_conv.route): an 'int8_conv2d' call through
    int8_conv.quantized_conv2d, an 'int_mm' call through
    int8_gemm.quantized_conv1x1; on the CPU both give the plain version's
    result."""
    if int8_conv.route(x.shape, qw.shape, stride, padding,
                       groups) == 'int8_conv2d':
        return int8_conv.quantized_conv2d(x, qw, wscale, ascale, bias, stride,
                                          padding, groups, compute_dtype)
    return int8_gemm.quantized_conv1x1(x, qw, wscale, ascale, bias,
                                       compute_dtype)


def quantized_conv(conv: nn.Conv2d, x: torch.Tensor, qkernel: torch.Tensor,
                   wscale: torch.Tensor, ascale: torch.Tensor,
                   compute_dtype: torch.dtype = torch.bfloat16
                   ) -> torch.Tensor:
    """One conv of the module tree as int8 x int8 -> int32: x (B, C, H, W)
    -> (B, O, Ho, Wo) in x's dtype (NHWC in memory), by route
    (fused_conv: the route's fused kernel on the card, the plain version
    on the CPU)."""
    y = fused_conv(x.permute(0, 2, 3, 1), qkernel, wscale, ascale, conv.bias,
                   tuple(conv.stride), _padding(conv), conv.groups,
                   compute_dtype)
    return y.permute(0, 3, 1, 2)


@torch.no_grad()
def quantized_apply(model: nn.Module, pack: QuantPack, x,
                    compute_dtype: torch.dtype = torch.bfloat16,
                    **forward_kwargs):
    """model(x) with every packed conv run as int8 x int8 -> int32. Convs
    not in the pack (policy-skipped, or newly added modules) run their own
    fp forward. The 1x1 kernels' repacks are made before the forward, so
    the forward allocates none (a CUDA-graph capture of it may run)."""
    int8_gemm.prepare(pack.qkernels.values())

    def call(path, conv, inp):
        if path not in pack.qkernels:
            return conv_forward(conv, inp)
        return quantized_conv(conv, inp, pack.qkernels[path],
                              pack.wscales[path], pack.ascales[path],
                              compute_dtype)

    with _intercepted(model, call):
        return model(_as_input(model, x), **forward_kwargs)
