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
import torch.distributed as dist
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


def _all_reduce_sum_(t: torch.Tensor) -> torch.Tensor:
    if dist.is_available() and dist.is_initialized():
        dist.all_reduce(t)
    return t


def _per_channel(v: torch.Tensor) -> torch.Tensor:
    return v[None, :, None, None]


class _SyncBatchNormFn(torch.autograd.Function):
    """Train-mode batch norm over the batch of every rank: the forward's
    statistics and the backward's two reductions are each one fp32
    `all_reduce` of per-channel sums."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        c = x.shape[1]
        xf = x.float()
        stats = _all_reduce_sum_(torch.cat([
            xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3)),
            xf.new_full((1,), x.numel() // c)]))
        n = stats[-1]
        mean = stats[:c] / n
        # E[x^2] - E[x]^2, floored at 0, as flax's BatchNorm computes it
        var = (stats[c:2 * c] / n - mean * mean).clamp(min=0.0)
        invstd = torch.rsqrt(var + eps)
        y = ((xf - _per_channel(mean)) * _per_channel(invstd * weight)
             + _per_channel(bias)).to(x.dtype)
        ctx.save_for_backward(x, weight, mean, invstd, n)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, invstd, n = ctx.saved_tensors
        c = x.shape[1]
        dyf = dy.float()
        xmu = x.float() - _per_channel(mean)
        local = torch.cat([dyf.sum((0, 2, 3)), (dyf * xmu).sum((0, 2, 3))])
        total = _all_reduce_sum_(local.clone())
        dx = (dyf - _per_channel(total[:c] / n)
              - xmu * _per_channel(invstd * invstd * total[c:] / n)) \
            * _per_channel(invstd * weight)
        # the parameters' gradients are this rank's; the train step
        # averages every gradient over the ranks
        return dx.to(x.dtype), local[c:] * invstd, local[:c], None


class SyncBatchNorm2d(BatchNorm2d):
    """BatchNorm2d whose train-mode statistics are those of the batches of
    every rank together (flax's BatchNorm under an SPMD mesh, the JAX
    package's bn_mode='sync'): biased variance E[x^2] - E[x]^2 in fp32 for
    the normalisation and the running update, one `all_reduce` of (sum,
    sum of squares, count) in the forward and one of the two gradient
    sums in the backward. torch.nn.SyncBatchNorm is not used: it gathers
    (gloo on CUDA tensors has no all_gather) and keeps the unbiased
    running variance. Outside a process group the batch is this process's.
    No state of its own: `use_sync_batch_norm` switches modules in place."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        y, mean, var = _SyncBatchNormFn.apply(x, self.weight, self.bias,
                                              self.eps)
        self.num_batches_tracked.add_(1)
        m = self.momentum
        if m is None:   # cumulative average, as torch defines it
            m = 1.0 / float(self.num_batches_tracked)
        with torch.no_grad():
            self.running_mean.lerp_(mean, m)
            self.running_var.lerp_(var, m)
        return y


def use_sync_batch_norm(module: nn.Module) -> nn.Module:
    """Every BatchNorm2d of `module` made a SyncBatchNorm2d, in place;
    parameters, buffers and state_dict keys stay as they are."""
    for m in module.modules():
        if isinstance(m, BatchNorm2d):
            m.__class__ = SyncBatchNorm2d
    return module


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
