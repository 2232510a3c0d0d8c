"""Weights and frames made from the run's seed, on the card.

A network's weights are one draw of the generator for all its leaves,
scaled per leaf to torch's default bounds (U(-1/sqrt(fan_in),
1/sqrt(fan_in)) for a convolution's weight and bias), BiFPN's fusion
weights at their published ones, BatchNorm at weight 1 and bias 0. Its
BatchNorm statistics then come from one train-mode pass of the plain
reference, in fp32, over the frames it will see, so that eval activations
keep their scale through the depth and the post-process finds scores above
its threshold. The state_dict that results is handed to the program and to
the reference alike.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from .reference.efficientdet import EfficientDet
from .reference.run import fp32_exact


def seed_of(*parts: int) -> int:
    """A generator seed from the run's seed and a purpose, any size of
    either: torch takes seeds below 2**64."""
    acc = 0
    for p in parts:
        acc = (acc * 1_000_003 + int(p)) % (1 << 63)
    return acc


def sync(device) -> None:
    """Wait for the card's queue (nothing to wait for on the CPU)."""
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize(device)


def detector(config: dict, in_channels: int, device=None) -> EfficientDet:
    """The plain reference's detector of `config`, uninitialised where
    `device` is 'meta'."""
    with torch.device(device or 'meta'):
        return EfficientDet(config['num_classes'], config['compound_coef'],
                            in_channels)


def seeded_state(config: dict, in_channels: int, seed: int, device
                 ) -> Dict[str, torch.Tensor]:
    """A detector's state_dict from `seed`, before its BN statistics."""
    shell = detector(config, in_channels)
    leaves, bounds = [], []
    ones, zeros = [], []
    for mname, module in shell.named_modules():
        prefix = f'{mname}.' if mname else ''
        if isinstance(module, nn.BatchNorm2d):
            ones.append(prefix + 'weight')
            zeros += [prefix + 'bias', prefix + 'running_mean']
            ones.append(prefix + 'running_var')
            zeros.append(prefix + 'num_batches_tracked')
        elif isinstance(module, nn.Conv2d):
            w = module.weight
            fan_in = w.shape[1] * w.shape[2] * w.shape[3]
            for leaf in ('weight', 'bias'):
                if getattr(module, leaf) is not None:
                    leaves.append(prefix + leaf)
                    bounds.append(fan_in ** -0.5)
    shapes = {k: v.shape for k, v in shell.state_dict().items()}
    sizes = [shapes[k].numel() for k in leaves]
    g = torch.Generator(device=device).manual_seed(seed_of(seed))
    flat = torch.rand(sum(sizes), generator=g, device=device) * 2 - 1
    flat *= torch.repeat_interleave(
        torch.tensor(bounds, device=device),
        torch.tensor(sizes, device=device))
    state = {k: v.view(shapes[k])
             for k, v in zip(leaves, torch.split(flat, sizes))}
    for k in ones:
        state[k] = torch.ones(shapes[k], device=device)
    for k in zeros:
        state[k] = torch.zeros(shapes[k], device=device,
                               dtype=torch.long if k.endswith('tracked')
                               else torch.float32)
    for k, shape in shapes.items():     # BiFPN's fusion weights
        if k not in state:
            state[k] = torch.ones(shape, device=device)
    return state


@torch.no_grad()
def calibrated_state(config: dict, in_channels: int, seed: int,
                     frames: torch.Tensor) -> Dict[str, torch.Tensor]:
    """seeded_state with BN running statistics from one no-grad
    train-mode pass of the reference over `frames` (B, H, W, C) at the
    model's image size: momentum None, so the statistics are the pass's
    own. Drop-connect masks of the pass come from the seed too."""
    dev = frames.device
    state = seeded_state(config, in_channels, seed, dev)
    model = detector(config, in_channels, dev)
    model.load_state_dict(state)
    for m in model.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.momentum = None
    model.train()
    with fp32_exact():
        model(frames.float(), generator=torch.Generator(device=dev)
              .manual_seed(seed_of(seed, 1)))
    return {k: v.detach().clone() for k, v in model.state_dict().items()}
