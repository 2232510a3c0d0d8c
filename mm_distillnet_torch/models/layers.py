"""Shared layers with TF-SAME semantics (port of mm_distillnet_tpu/models/layers.py).

Modules compute in NCHW (PyTorch idiom; tensors made from NHWC arrays by
`permute(0, 3, 1, 2)` are channels_last in memory, so no copy is made).
The plain functions that the reference exposes in NHWC (`max_pool_same`,
`upsample_nearest_2x`) keep NHWC at their boundary; their `_nchw` twins are
what the modules call.

TF-SAME padding is explicit `F.pad` with the reference's amounts: torch's
`padding='same'` refuses stride 2 and splits odd padding the other way.
Max-pool pads with ZEROS, not -inf (reference
src/YetAnotherEfficientNet.py:90-103).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# BatchNorm constants of every model in the reference (momentum 0.01, eps
# 1e-3, reference src/YetAnotherEfficientDet.py:176); torch momentum is the
# weight of the new batch (flax's 0.99 decay).
BN_MOMENTUM = 0.01
BN_EPS = 1e-3


def swish(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x)."""
    return x * torch.sigmoid(x)


def same_pad_amounts(size: int, stride: int, kernel: int) -> Tuple[int, int]:
    """TF-SAME padding (lo, hi) for one spatial dim: extra =
    (ceil(s/stride)-1)*stride - s + k, low = extra//2, high = the rest."""
    extra = max((math.ceil(size / stride) - 1) * stride - size + kernel, 0)
    lo = extra // 2
    return lo, extra - lo


def pad_same_nchw(x: torch.Tensor, stride: int, kernel: int) -> torch.Tensor:
    """Zero-pad an NCHW tensor by the TF-SAME amounts of its H and W."""
    ph = same_pad_amounts(x.shape[-2], stride, kernel)
    pw = same_pad_amounts(x.shape[-1], stride, kernel)
    if ph == (0, 0) and pw == (0, 0):
        return x
    return F.pad(x, (pw[0], pw[1], ph[0], ph[1]))


def max_pool_same_nchw(x: torch.Tensor, kernel: int = 3,
                       stride: int = 2) -> torch.Tensor:
    return F.max_pool2d(pad_same_nchw(x, stride, kernel), kernel, stride)


def max_pool_same(x: torch.Tensor, kernel: int = 3,
                  stride: int = 2) -> torch.Tensor:
    """Zero-padded TF-SAME max pool, NHWC."""
    return max_pool_same_nchw(x.permute(0, 3, 1, 2), kernel,
                              stride).permute(0, 2, 3, 1)


def upsample_nearest_2x_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample, NHWC."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


class BatchNorm2d(nn.BatchNorm2d):
    """nn.BatchNorm2d whose train-mode update of the running variance takes
    the biased batch variance, as flax's BatchNorm does (and so the JAX
    package); torch takes the unbiased one, n/(n-1) times larger, with n =
    B*H*W (the reference PyTorch code therefore differs from both here).
    Normalisation itself uses the biased variance in all three."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        old = self.running_var.clone()
        y = super().forward(x)
        n = x.numel() // x.shape[1]
        m = self.momentum
        if m is None:   # cumulative average, as torch defines it
            m = 1.0 / float(self.num_batches_tracked)
        # torch wrote (1-m) old + m v n/(n-1); keep (1-m) old + m v. Through
        # .data: the op saved running_var for its backward, which in train
        # mode does not read it, and a version bump would refuse the backward
        self.running_var.data.lerp_(old.mul_(1.0 - m), 1.0 / n)
        return y


def batch_norm(channels: int) -> BatchNorm2d:
    return BatchNorm2d(channels, eps=BN_EPS, momentum=BN_MOMENTUM)


class Conv2dSame(nn.Module):
    """Conv2d with TF-SAME padding; the conv sits under `.conv` as in the
    reference's Conv2dStaticSamePadding (src/YetAnotherEfficientNet.py:27-65),
    so state_dict keys end in `.conv.weight`."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, groups: int = 1,
                 bias: bool = True):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size, stride,
                              padding=0, groups=groups, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(pad_same_nchw(x, self.stride, self.kernel_size))


class SeparableConvBlock(nn.Module):
    """Depthwise 3x3 (no bias) + pointwise 1x1 (bias) [+ BN] [+ swish]
    (reference src/YetAnotherEfficientDet.py:154-192)."""

    def __init__(self, in_channels: int, out_channels: int,
                 norm: bool = True, activation: bool = False):
        super().__init__()
        self.depthwise_conv = Conv2dSame(in_channels, in_channels, 3,
                                         groups=in_channels, bias=False)
        self.pointwise_conv = Conv2dSame(in_channels, out_channels, 1)
        self.norm = norm
        if norm:
            self.bn = batch_norm(out_channels)
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.pointwise_conv(self.depthwise_conv(x))
        if self.norm:
            x = self.bn(x)
        if self.activation:
            x = swish(x)
        return x


def drop_connect(x: torch.Tensor, rate: float, training: bool,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Per-sample stochastic depth (reference
    src/YetAnotherEfficientNet.py:176-186). The mask is drawn from
    `generator`, which train mode with a non-zero rate requires."""
    if not training or rate == 0.0:
        return x
    if generator is None:
        raise ValueError('drop_connect draws its mask from an explicit '
                         'torch.Generator; pass generator=')
    keep = 1.0 - rate
    u = torch.rand((x.shape[0], 1, 1, 1), generator=generator,
                   device=x.device)
    return x / keep * torch.floor(keep + u).to(x.dtype)
