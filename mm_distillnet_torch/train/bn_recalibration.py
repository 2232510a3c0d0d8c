"""Exact BatchNorm running-statistics recalibration (port of
mm_distillnet_tpu/train/bn_recalibration.py).

Running statistics decay toward the activations' statistics at the BN
momentum per step (0.01 here). Short runs leave them blended with their
init, which collapses the eval-mode forward toward an input-independent
output. This recomputes them: one train-mode forward per batch from the
original statistics; since the update is `new = (1 - m) old + m batch`,
the raw batch statistics are `(new - (1 - m) old) / m`; their mean over
the batches replaces the running statistics (the standard BN
re-estimation pass). The variance is the biased one, as the port's
`BatchNorm2d` and flax keep it.
"""
from __future__ import annotations

from typing import Iterable, Optional

import torch
from torch import nn

from ..models.layers import BN_MOMENTUM


def _norms(model: nn.Module):
    return [m for m in model.modules()
            if isinstance(m, nn.modules.batchnorm._BatchNorm)
            and m.track_running_stats]


@torch.no_grad()
def recalibrate_batch_stats(model: nn.Module, batches: Iterable,
                            momentum: float = BN_MOMENTUM,
                            generator: Optional[torch.Generator] = None
                            ) -> nn.Module:
    """Replace the running statistics of every BatchNorm of `model` with
    the mean raw batch statistics over `batches` (model inputs: tensors,
    or a generator's dicts of them), in place. `momentum` is the BN
    layers' torch momentum; `generator` draws drop-connect masks
    (`model(x, generator=generator)`). The model's train / eval mode is
    restored; without BatchNorm or batches nothing changes."""
    norms = _norms(model)
    if not norms:
        return model
    old = [(n.running_mean.clone(), n.running_var.clone(),
            n.num_batches_tracked.clone(), n.momentum) for n in norms]
    acc = [(torch.zeros_like(n.running_mean), torch.zeros_like(n.running_var))
           for n in norms]
    was_training = model.training
    model.train()
    count = 0
    try:
        for x in batches:
            for n, (mean, var, _, _) in zip(norms, old):
                n.momentum = momentum
                n.running_mean.copy_(mean)
                n.running_var.copy_(var)
            if generator is None:
                model(x)
            else:
                model(x, generator=generator)
            for n, (mean, var, _, _), (am, av) in zip(norms, old, acc):
                am.add_((n.running_mean - (1.0 - momentum) * mean) / momentum)
                av.add_((n.running_var - (1.0 - momentum) * var) / momentum)
            count += 1
    finally:
        # on an error, or without batches, the old statistics come back
        model.train(was_training)
        for n, (mean, var, tracked, m) in zip(norms, old):
            n.momentum = m
            n.num_batches_tracked.copy_(tracked)
            n.running_mean.copy_(mean)
            n.running_var.copy_(var)
    if count:
        for n, (am, av) in zip(norms, acc):
            n.running_mean.copy_(am / count)
            n.running_var.copy_(av / count)
    return model
