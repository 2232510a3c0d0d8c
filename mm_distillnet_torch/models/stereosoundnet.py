"""StereoSoundNet: the YOLOv2 / Darknet-19-style 8-channel audio baseline
(port of mm_distillnet_tpu/models/stereosoundnet.py; reference
src/StereoSoundNet.py:10-204).

13 Darknet conv stages, a passthrough branch with the space-to-depth reorg
(2x2 -> channels), concatenation, and a detection head of 5 anchors x
(5 + num_classes) outputs. NHWC at the boundary, NCHW inside; forward
returns (output, features) like the reference. Keys follow the JAX
package's variable names through the reference converter's rule:
`stage1_conv1.conv.weight`, `stage1_conv1.bn.running_mean`,
`stage3_conv2.weight`. Its BatchNorm is flax's default (eps 1e-5, torch
momentum 0.1), with the biased running variance of `layers.BatchNorm2d`.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .efficientdet import nchw, nhwc
from .layers import BatchNorm2d

YOLO_ANCHORS = ((1.3221, 1.73145), (3.19275, 4.00944), (5.05587, 8.09892),
                (9.47112, 4.84053), (11.2364, 10.0071))
_STAGE1 = ((32, 3, True), (64, 3, True), (128, 3, False), (64, 1, False),
           (128, 3, True), (256, 3, False), (128, 1, False),
           (256, 3, True), (512, 3, False), (256, 1, False),
           (512, 3, False), (256, 1, False), (512, 3, False))
_STAGE2_A = ((1024, 3), (512, 1), (1024, 3), (512, 1), (1024, 3),
             (1024, 3), (1024, 3))


class _ConvBNLeaky(nn.Module):
    """Conv (3x3 SAME or 1x1, no bias) + BN + leaky ReLU 0.1 [+ 2x2 max
    pool]."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3,
                 pool: bool = False):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, features, kernel,
                              padding=kernel // 2, bias=False)
        self.bn = BatchNorm2d(features, eps=1e-5, momentum=0.1)
        self.pool = pool

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.leaky_relu(self.bn(self.conv(x)), 0.1)
        return F.max_pool2d(x, 2, 2) if self.pool else x


def space_to_depth_2x(x: torch.Tensor) -> torch.Tensor:
    """The YOLOv2 passthrough reorg, NHWC: (B, H, W, C) -> (B, H/2, W/2,
    4C) in the reference's channel order (src/StereoSoundNet.py:180-193),
    a flat reinterpretation of the NCHW buffer as (C/4, H, 2, W, 2)."""
    b, h, w, c = x.shape
    v = nchw(x).contiguous().view(b, c // 4, h, 2, w, 2)
    v = v.permute(0, 3, 5, 1, 2, 4).contiguous().view(b, -1, h // 2, w // 2)
    return nhwc(v)


class StereoSoundNet(nn.Module):

    def __init__(self, num_classes: int = 20, in_channels: int = 8):
        super().__init__()
        self.num_classes = num_classes
        self.in_channels = in_channels
        ch = in_channels
        for i, (f, k, p) in enumerate(_STAGE1):
            setattr(self, f'stage1_conv{i + 1}', _ConvBNLeaky(ch, f, k, p))
            ch = f
        for i, (f, k) in enumerate(_STAGE2_A):
            setattr(self, f'stage2_a_conv{i + 1}', _ConvBNLeaky(ch, f, k))
            ch = f
        self.stage2_b_conv = _ConvBNLeaky(_STAGE1[-1][0], 64, 1)
        self.stage3_conv1 = _ConvBNLeaky(ch + 4 * 64, 1024, 3)
        self.stage3_conv2 = nn.Conv2d(1024, len(YOLO_ANCHORS) *
                                      (5 + num_classes), 1, bias=False)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x (B, H, W, C) -> (output (B, H/32, W/32, 5 * (5 + classes))
        fp32, features (B, H/32, W/32, 1024))."""
        x = nchw(x.to(self.stage3_conv2.weight.dtype))
        for i in range(len(_STAGE1)):
            x = getattr(self, f'stage1_conv{i + 1}')(x)
        residual = x
        y = F.max_pool2d(x, 2, 2)
        for i in range(len(_STAGE2_A)):
            y = getattr(self, f'stage2_a_conv{i + 1}')(y)
        z = nchw(space_to_depth_2x(nhwc(self.stage2_b_conv(residual))))
        features = self.stage3_conv1(torch.cat([y, z], dim=1))
        out = self.stage3_conv2(features)
        return nhwc(out).float(), nhwc(features)
