"""The benchmark's own count of operations and bytes, from the published
EfficientDet architecture (Tan et al., arXiv:1911.09070) as the plain
reference builds it, at a cell's shapes; and the table of peaks.

- `forward_flops`: 2 x the multiply-adds of every convolution and linear
  layer of one eval forward, counted by running the reference detector on
  the meta device (shapes only, no data) with a hook on each layer. Adds
  of biases, BatchNorm, activations, resizes and the post-process are not
  counted.
- `mbconv_cost`: one MBConv block's operations and its least bytes: its
  input read once, its weights read once, its output written once, all
  in bf16; the expanded map in between is not counted, so the bound holds
  whatever implements the block.
"""
from __future__ import annotations

import functools
from pathlib import Path
from typing import List, Tuple

import torch
from torch import nn

from .common import read_json
from .reference.efficientdet import BACKBONE_COEF, EfficientDet
from .reference.efficientnet import BlockArgs, expand_block_args, has_se, \
    se_squeeze_width

PEAKS = read_json(Path(__file__).resolve().parent / 'peaks.json')
BF16_BYTES = 2


def conv_flops(module: nn.Module, out: torch.Tensor) -> int:
    """2 x multiply-adds of one call of a Conv2d or Linear layer."""
    if isinstance(module, nn.Conv2d):
        kh, kw = module.kernel_size
        per_out = module.in_channels // module.groups * kh * kw
        return 2 * out.numel() * per_out
    return 2 * out.numel() * module.in_features


@functools.lru_cache(maxsize=None)
def forward_flops(compound_coef: int, num_classes: int, in_channels: int,
                  batch: int, image_size: int) -> int:
    """FLOPs of one eval forward of the detector on (batch, image_size,
    image_size, in_channels)."""
    with torch.device('meta'):
        model = EfficientDet(num_classes, compound_coef, in_channels).eval()
    total = [0]

    def hook(module, _inputs, out):
        total[0] += conv_flops(module, out)

    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            m.register_forward_hook(hook)
    with torch.no_grad():
        model(torch.empty((batch, image_size, image_size, in_channels),
                          device='meta'))
    return total[0]


def mbconv_cost(args: BlockArgs, batch: int, h: int, w: int
                ) -> Tuple[int, int]:
    """(FLOPs, bytes) of one MBConv block on (batch, h, w, cin)."""
    cin, co, k, s = (args.input_filters, args.output_filters,
                     args.kernel_size, args.stride)
    ce = cin * args.expand_ratio
    ho, wo = -(-h // s), -(-w // s)
    macs = batch * ho * wo * ce * k * k + batch * ho * wo * ce * co
    weights = ce * k * k + ce + ce * co + co
    if args.expand_ratio != 1:
        macs += batch * h * w * cin * ce
        weights += cin * ce + ce
    if has_se(args):
        cs = se_squeeze_width(args)
        macs += batch * 2 * ce * cs
        weights += 2 * ce * cs + cs + ce
    nbytes = BF16_BYTES * (batch * h * w * cin + batch * ho * wo * co
                           + weights)
    return 2 * macs, nbytes


def mbconv_blocks(compound_coef: int, image_size: int
                  ) -> List[Tuple[BlockArgs, int, int]]:
    """(args, h, w) of every MBConv block at its input."""
    out, h = [], -(-image_size // 2)
    for args in expand_block_args(BACKBONE_COEF[compound_coef]):
        out.append((args, h, h))
        h = -(-h // args.stride)
    return out


def bound_s(flops: float, nbytes: float) -> float:
    """The least time on the card: operations at the bf16 peak or bytes
    at the memory's, the larger."""
    return max(flops / PEAKS['bf16_flops_per_s'],
               nbytes / PEAKS['hbm_bytes_per_s'])


@functools.lru_cache(maxsize=None)
def mbconv_bound_s(compound_coef: int, image_size: int, batch: int) -> float:
    """Sum over the backbone's MBConv blocks of each block's bound, for one
    forward at `batch`."""
    return sum(bound_s(*mbconv_cost(a, batch, h, w))
               for a, h, w in mbconv_blocks(compound_coef, image_size))
