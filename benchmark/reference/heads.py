"""Box-regression and classification heads (port of
mm_distillnet_tpu/models/heads.py), NCHW inside.

A tower of `num_layers` separable convs shared across pyramid levels with
per-(level, layer) BatchNorm, then a separable-conv header. Keys follow the
reference: `regressor.conv_list.0.pointwise_conv.conv.bias`,
`classifier.bn_list.2.1.running_var`, `regressor.header.depthwise_conv...`.

The header output (B, A*K, H, W) is permuted to (B, H, W, A*K) before the
reshape to (B, H*W*A, K), so the (row-major cell, anchor) order matches the
anchor table (reference src/YetAnotherEfficientDet.py:480-486).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
from torch import nn

from .layers import SeparableConvBlock, batch_norm, swish


class _Tower(nn.Module):
    """Shared-conv / per-level-BN tower + header."""

    def __init__(self, in_channels: int, header_features: int,
                 num_layers: int, num_levels: int = 5):
        super().__init__()
        self.conv_list = nn.ModuleList(
            SeparableConvBlock(in_channels, in_channels, norm=False)
            for _ in range(num_layers))
        self.bn_list = nn.ModuleList(
            nn.ModuleList(batch_norm(in_channels) for _ in range(num_layers))
            for _ in range(num_levels))
        self.header = SeparableConvBlock(in_channels, header_features,
                                         norm=False)

    def tower(self, inputs: Sequence[torch.Tensor], k: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        outputs: List[torch.Tensor] = []
        align = None
        for level, feat in enumerate(inputs):
            for conv, bn in zip(self.conv_list, self.bn_list[level]):
                feat = swish(bn(conv(feat)))
            align = feat  # pre-header feature; the last level's survives
            out = self.header(feat).permute(0, 2, 3, 1)
            outputs.append(out.reshape(out.shape[0], -1, k))
        return torch.cat(outputs, dim=1), align


class Regressor(_Tower):
    """Box head: (B, total_anchors, 4) deltas (dy, dx, dh, dw)
    (reference src/YetAnotherEfficientDet.py:445-487)."""

    def __init__(self, in_channels: int, num_anchors: int, num_layers: int,
                 num_levels: int = 5):
        super().__init__(in_channels, num_anchors * 4, num_layers, num_levels)

    def forward(self, inputs):
        return self.tower(inputs, 4)


class Classifier(_Tower):
    """Class head: (B, total_anchors, num_classes) sigmoid scores, the
    pre-sigmoid logits, and the alignment feature
    (reference src/YetAnotherEfficientDet.py:490-532).

    The sigmoid is taken in the compute dtype, as in the JAX package."""

    def __init__(self, in_channels: int, num_anchors: int, num_classes: int,
                 num_layers: int, num_levels: int = 5):
        super().__init__(in_channels, num_anchors * num_classes, num_layers,
                         num_levels)
        self.num_classes = num_classes

    def forward(self, inputs):
        logits, align = self.tower(inputs, self.num_classes)
        return torch.sigmoid(logits), logits, align
