"""BiFPN: weighted bidirectional feature pyramid (port of
mm_distillnet_tpu/models/bifpn.py), NCHW inside.

8 separable-conv nodes per cell, fast-normalised attention weights (ReLU +
normalise, eps 1e-4), nearest 2x upsample, zero-padded stride-2 max pool.
The first cell down-channels backbone P3/P4/P5 and makes
P6 = maxpool(conv(P5)), P7 = maxpool(P6). Keys follow the reference:
`bifpn.0.conv6_up.depthwise_conv.conv.weight`, `bifpn.0.p5_to_p6.0.conv.weight`,
`bifpn.0.p6_w1`.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from .layers import (Conv2dSame, SeparableConvBlock, batch_norm,
                     max_pool_same_nchw, swish, upsample_nearest_2x_nchw)

_FUSE_WEIGHTS = (('p6_w1', 2), ('p5_w1', 2), ('p4_w1', 2), ('p3_w1', 2),
                 ('p4_w2', 3), ('p5_w2', 3), ('p6_w2', 3), ('p7_w2', 2))
_NODES = ('conv6_up', 'conv5_up', 'conv4_up', 'conv3_up',
          'conv4_down', 'conv5_down', 'conv6_down', 'conv7_down')


def _down_channel(in_channels: int, out_channels: int) -> nn.Sequential:
    """1x1 conv + BN (reference src/YetAnotherEfficientDet.py:238-266)."""
    return nn.Sequential(Conv2dSame(in_channels, out_channels, 1),
                         batch_norm(out_channels))


def _fuse2(w, a, b, eps):
    w = torch.relu(w)
    w = w / (torch.sum(w) + eps)
    return w[0] * a + w[1] * b


def _fuse3(w, a, b, c, eps):
    w = torch.relu(w)
    w = w / (torch.sum(w) + eps)
    return w[0] * a + w[1] * b + w[2] * c


class BiFPNCell(nn.Module):
    """One BiFPN cell with fast attention
    (reference src/YetAnotherEfficientDet.py:320-392)."""

    def __init__(self, num_channels: int,
                 conv_channels: Tuple[int, int, int] = (),
                 first_time: bool = False, epsilon: float = 1e-4,
                 attention: bool = True):
        super().__init__()
        self.first_time = first_time
        self.epsilon = epsilon
        self.attention = attention
        for name in _NODES:
            setattr(self, name, SeparableConvBlock(num_channels, num_channels))
        if first_time:
            c3, c4, c5 = conv_channels
            self.p5_to_p6 = _down_channel(c5, num_channels)
            self.p3_down_channel = _down_channel(c3, num_channels)
            self.p4_down_channel = _down_channel(c4, num_channels)
            self.p5_down_channel = _down_channel(c5, num_channels)
            self.p4_down_channel_2 = _down_channel(c4, num_channels)
            self.p5_down_channel_2 = _down_channel(c5, num_channels)
        if attention:
            for name, n in _FUSE_WEIGHTS:
                setattr(self, name, nn.Parameter(torch.ones(n)))

    def _fuse(self, name, *xs):
        if not self.attention:
            return sum(xs[1:], xs[0])
        w = getattr(self, name)
        if len(xs) == 2:
            return _fuse2(w, *xs, self.epsilon)
        return _fuse3(w, *xs, self.epsilon)

    def forward(self, inputs: Sequence[torch.Tensor]):
        up = upsample_nearest_2x_nchw
        pool = max_pool_same_nchw
        if self.first_time:
            p3, p4, p5 = inputs
            p6_in = pool(self.p5_to_p6(p5))
            p7_in = pool(p6_in)
            p3_in = self.p3_down_channel(p3)
            p4_in = self.p4_down_channel(p4)
            p5_in = self.p5_down_channel(p5)
        else:
            p3_in, p4_in, p5_in, p6_in, p7_in = inputs

        # top-down pathway
        p6_up = self.conv6_up(swish(self._fuse('p6_w1', p6_in, up(p7_in))))
        p5_up = self.conv5_up(swish(self._fuse('p5_w1', p5_in, up(p6_up))))
        p4_up = self.conv4_up(swish(self._fuse('p4_w1', p4_in, up(p5_up))))
        p3_out = self.conv3_up(swish(self._fuse('p3_w1', p3_in, up(p4_up))))

        if self.first_time:
            p4_in = self.p4_down_channel_2(inputs[1])
            p5_in = self.p5_down_channel_2(inputs[2])

        # bottom-up pathway
        p4_out = self.conv4_down(swish(self._fuse(
            'p4_w2', p4_in, p4_up, pool(p3_out))))
        p5_out = self.conv5_down(swish(self._fuse(
            'p5_w2', p5_in, p5_up, pool(p4_out))))
        p6_out = self.conv6_down(swish(self._fuse(
            'p6_w2', p6_in, p6_up, pool(p5_out))))
        p7_out = self.conv7_down(swish(self._fuse(
            'p7_w2', p7_in, pool(p6_out))))
        return p3_out, p4_out, p5_out, p6_out, p7_out


class BiFPN(nn.Sequential):
    """Stack of BiFPN cells, the first with `first_time=True`; children are
    named `0`, `1`, ... as in the reference's nn.Sequential."""

    def __init__(self, num_channels: int, num_repeats: int,
                 conv_channels: Tuple[int, int, int], attention: bool = True):
        super().__init__(*(
            BiFPNCell(num_channels, conv_channels, first_time=(i == 0),
                      attention=attention)
            for i in range(num_repeats)))

    def forward(self, features):
        for cell in self:
            features = cell(features)
        return features
