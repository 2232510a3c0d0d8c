"""EfficientNet backbone (port of mm_distillnet_tpu/models/efficientnet.py).

Stem conv s2 -> MBConv blocks (expand / depthwise / SE / project) ->
feature taps before each stride-2 block. NCHW inside. Attribute names
follow the reference torch layout (`model._conv_stem.conv.weight`,
`model._blocks.3._expand_conv.conv.weight`, ...).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2dSame, batch_norm, drop_connect, swish


@dataclass(frozen=True)
class BlockArgs:
    kernel_size: int
    num_repeat: int
    input_filters: int
    output_filters: int
    expand_ratio: int
    stride: int
    se_ratio: float = 0.25
    id_skip: bool = True


# EfficientNet-B0 stage table (reference src/YetAnotherEfficientNet.py:321-326)
BASE_BLOCKS: Tuple[BlockArgs, ...] = (
    BlockArgs(3, 1, 32, 16, 1, 1),
    BlockArgs(3, 2, 16, 24, 6, 2),
    BlockArgs(5, 2, 24, 40, 6, 2),
    BlockArgs(3, 3, 40, 80, 6, 2),
    BlockArgs(5, 3, 80, 112, 6, 1),
    BlockArgs(5, 4, 112, 192, 6, 2),
    BlockArgs(3, 1, 192, 320, 6, 1),
)

# width, depth, resolution, dropout. Key -1 is the TEST-TINY profile (same
# topology, ~10x fewer channels, one block per stage); not a reference
# configuration.
EFFICIENTNET_PARAMS = {
    -1: (0.25, 0.1, 64, 0.0),
    0: (1.0, 1.0, 224, 0.2),
    1: (1.0, 1.1, 240, 0.2),
    2: (1.1, 1.2, 260, 0.3),
    3: (1.2, 1.4, 300, 0.3),
    4: (1.4, 1.8, 380, 0.4),
    5: (1.6, 2.2, 456, 0.4),
    6: (1.8, 2.6, 528, 0.5),
    7: (2.0, 3.1, 600, 0.5),
}


def round_filters(filters: int, width: float, divisor: int = 8) -> int:
    """Reference src/YetAnotherEfficientNet.py:150-162."""
    if not width:
        return filters
    filters *= width
    new_filters = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new_filters < 0.9 * filters:
        new_filters += divisor
    return int(new_filters)


def round_repeats(repeats: int, depth: float) -> int:
    """Reference src/YetAnotherEfficientNet.py:165-170."""
    if not depth:
        return repeats
    return int(math.ceil(depth * repeats))


def expand_block_args(compound_coef: int) -> List[BlockArgs]:
    """One BlockArgs per MBConv block after width/depth scaling; the first
    block of each stage carries the stage stride."""
    width, depth, _, _ = EFFICIENTNET_PARAMS[compound_coef]
    blocks: List[BlockArgs] = []
    for args in BASE_BLOCKS:
        inp = round_filters(args.input_filters, width)
        out = round_filters(args.output_filters, width)
        reps = round_repeats(args.num_repeat, depth)
        blocks.append(BlockArgs(args.kernel_size, 1, inp, out,
                                args.expand_ratio, args.stride,
                                args.se_ratio, args.id_skip))
        for _ in range(reps - 1):
            blocks.append(BlockArgs(args.kernel_size, 1, out, out,
                                    args.expand_ratio, 1,
                                    args.se_ratio, args.id_skip))
    return blocks


def se_squeeze_width(args: BlockArgs) -> int:
    """SE squeeze channels come from the *input* filters
    (reference src/YetAnotherEfficientNet.py:440-443)."""
    return max(1, int(args.input_filters * args.se_ratio))


def has_se(args: BlockArgs) -> bool:
    return bool(args.se_ratio) and 0 < args.se_ratio <= 1


class MBConvBlock(nn.Module):
    """Mobile inverted bottleneck: expand 1x1 -> depthwise kxk -> SE ->
    project 1x1, swish, drop-connect on the skip (reference
    src/YetAnotherEfficientNet.py:402-489). The unfused module, NCHW."""

    def __init__(self, args: BlockArgs, drop_connect_rate: float = 0.0):
        super().__init__()
        self.args = args
        self.drop_connect_rate = drop_connect_rate
        a = args
        oup = a.input_filters * a.expand_ratio
        if a.expand_ratio != 1:
            self._expand_conv = Conv2dSame(a.input_filters, oup, 1, bias=False)
            self._bn0 = batch_norm(oup)
        self._depthwise_conv = Conv2dSame(oup, oup, a.kernel_size, a.stride,
                                          groups=oup, bias=False)
        self._bn1 = batch_norm(oup)
        if has_se(a):
            sq = se_squeeze_width(a)
            self._se_reduce = Conv2dSame(oup, sq, 1)
            self._se_expand = Conv2dSame(sq, oup, 1)
        self._project_conv = Conv2dSame(oup, a.output_filters, 1, bias=False)
        self._bn2 = batch_norm(a.output_filters)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """`generator` draws the drop-connect masks in train mode."""
        a = self.args
        inputs = x
        if a.expand_ratio != 1:
            x = swish(self._bn0(self._expand_conv(x)))
        x = swish(self._bn1(self._depthwise_conv(x)))
        if has_se(a):
            s = x.mean(dim=(2, 3), keepdim=True)
            s = self._se_expand(swish(self._se_reduce(s)))
            x = torch.sigmoid(s) * x
        x = self._bn2(self._project_conv(x))
        if a.id_skip and a.stride == 1 and a.input_filters == a.output_filters:
            x = drop_connect(x, self.drop_connect_rate, self.training,
                             generator)
            x = x + inputs
        return x


class SpaceToDepthStem(nn.Module):
    """The 3x3 stride-2 stem conv computed as a 2x2 stride-1 conv over a
    2x2 space-to-depth rearrangement of the input (port of the JAX
    package's `_SpaceToDepthStem`, models/efficientnet.py:155-200).

    With TF-SAME on an even input (pad (0, 1)), y[i, j] = sum over di, dj
    < 3 of w[di, dj] x[2i + di, 2j + dj]; writing 2i + di = 2(i + p) + a
    puts tap (di, dj) at block offset (p, q) and in-block offset (a, b),
    a 2x2 kernel over 4C channels, zero where 2p + a > 2. The parameter
    keeps its key `.conv.weight` and its (O, I, 3, 3) shape, so a state
    dict of the standard stem loads unchanged. The TPU's reason for it is
    lane width; on a GPU it is the same math by another road."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, 3, 2, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        if h % 2 or w % 2:
            raise ValueError(f's2d stem needs even input dims, got {h}x{w}')
        # channel (2a + b) * C + c holds x[2i + a, 2j + b, c]
        xs = (x.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 3, 5, 1, 2, 4)
              .reshape(b, 4 * c, h // 2, w // 2))
        k = self.conv.weight                        # (O, C, 3, 3)
        k = F.pad(k, (0, 1, 0, 1))                  # taps 3 are zero
        k = (k.reshape(k.shape[0], c, 2, 2, 2, 2)   # (O, C, p, a, q, b)
             .permute(0, 3, 5, 1, 2, 4).reshape(k.shape[0], 4 * c, 2, 2))
        return F.conv2d(F.pad(xs, (0, 1, 0, 1)), k.to(xs.dtype))


class EfficientNet(nn.Module):
    """Stem + MBConv blocks; forward returns the pyramid taps [P1..P5].
    `s2d_stem` runs the stem as SpaceToDepthStem (same parameters)."""

    def __init__(self, compound_coef: int = 2, in_channels: int = 3,
                 drop_connect_rate: float = 0.2, s2d_stem: bool = False):
        super().__init__()
        width, _, _, _ = EFFICIENTNET_PARAMS[compound_coef]
        self.block_args = expand_block_args(compound_coef)
        stem = round_filters(32, width)
        self._conv_stem = (SpaceToDepthStem(in_channels, stem) if s2d_stem
                           else Conv2dSame(in_channels, stem, 3, 2,
                                           bias=False))
        self._bn0 = batch_norm(stem)
        n = len(self.block_args)
        self._blocks = nn.ModuleList(
            MBConvBlock(a, drop_connect_rate * float(i) / n)
            for i, a in enumerate(self.block_args))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> List[torch.Tensor]:
        x = swish(self._bn0(self._conv_stem(x)))
        feature_maps = []
        last_x = None
        n = len(self._blocks)
        for idx, block in enumerate(self._blocks):
            if block.args.stride == 2:
                feature_maps.append(last_x)
            x = block(x, generator)
            if idx == n - 1:
                feature_maps.append(x)
            last_x = x
        return feature_maps


class EfficientNetFeatures(nn.Module):
    """Backbone feature extractor returning [P2, P3, P4, P5] (the first tap
    is dropped, reference src/YetAnotherEfficientDet.py:550-572). The body
    sits under `.model` as in the reference's EfficientNet wrapper."""

    def __init__(self, compound_coef: int = 2, in_channels: int = 3,
                 drop_connect_rate: float = 0.2, s2d_stem: bool = False):
        super().__init__()
        self.compound_coef = compound_coef
        self.model = EfficientNet(compound_coef, in_channels,
                                  drop_connect_rate, s2d_stem)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> List[torch.Tensor]:
        return self.model(x, generator)[1:]


def backbone_feature_channels(compound_coef: int) -> Tuple[int, int, int]:
    """Channels of P3/P4/P5 (reference src/YetAnotherEfficientDet.py:625-634)."""
    width, _, _, _ = EFFICIENTNET_PARAMS[compound_coef]
    return (round_filters(40, width), round_filters(112, width),
            round_filters(320, width))
