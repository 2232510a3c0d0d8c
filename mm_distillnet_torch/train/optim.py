"""Optimizers (torch.optim) and host-side learning-rate schedulers (port of
mm_distillnet_tpu/train/optim.py; reference
src/optimization/train_methods.py:818-878):

- SGD(lr, momentum, weight_decay) / Adam(lr, b1, b2, eps 1e-8) /
  AdamW(lr, b1, b2, weight_decay 1e-2): torch.optim's update rules are
  optax's for these three;
- optional clipping by the global gradient norm before the update, as
  optax computes it (`clip_by_global_norm_`); the threshold rides in the
  param group as 'grad_clip', so `apply_gradients` finds it and it is
  saved with the optimizer's state;
- StepLR(step_size, gamma) / ReduceLROnPlateau(patience 3, factor 0.1) /
  CosineAnnealingWarmRestarts(T_0 10), stepped once per epoch on the host;
  the trainer writes their learning rate into the param groups.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterable, List, Optional

import torch

from ..device import resolve_device


def build_optimizer(config, params: Iterable[torch.nn.Parameter],
                    device='cuda') -> torch.optim.Optimizer:
    """The optimizer config names, over `params`, which must live on
    `device`."""
    dev = resolve_device(device)
    params = list(params)
    elsewhere = [p.device for p in params if p.device.type != dev.type]
    if elsewhere:
        raise ValueError(f'parameters on {elsewhere[0]}, not on {dev}')
    name = config.get('optimizer', 'Adam')
    lr = config.getfloat('lr')
    grad_clip = config.getfloat('grad_clip', fallback=-1.0)
    groups = [{'params': params,
               'grad_clip': grad_clip if grad_clip and grad_clip > 0
               else None}]
    betas = (config.getfloat('b1', fallback=0.9),
             config.getfloat('b2', fallback=0.999))
    if name == 'SGD':
        wd = config.getfloat('weight_decay', fallback=0.0) or 0.0
        return torch.optim.SGD(groups, lr=lr,
                               momentum=config.getfloat('momentum'),
                               weight_decay=max(wd, 0.0))
    if name == 'Adam':
        return torch.optim.Adam(groups, lr=lr, betas=betas, eps=1e-8)
    if name == 'AdamW':
        return torch.optim.AdamW(groups, lr=lr, betas=betas, eps=1e-8,
                                 weight_decay=1e-2)  # torch AdamW default
    raise ValueError(f'Unsupported optimizer {name}')


def _grads(optimizer: torch.optim.Optimizer) -> List[torch.Tensor]:
    return [p.grad for g in optimizer.param_groups for p in g['params']
            if p.grad is not None]


def clip_by_global_norm_(grads: List[torch.Tensor],
                         max_norm: float) -> torch.Tensor:
    """Scale `grads` in place by max_norm / max(||g||, max_norm), ||g|| the
    norm of all of them together: optax.clip_by_global_norm, which leaves
    the gradients alone below the threshold (torch's clip_grad_norm_
    divides by ||g|| + 1e-6 instead). Returns ||g||, without a host sync."""
    norm = torch.linalg.vector_norm(
        torch.stack(torch._foreach_norm(grads)))
    torch._foreach_mul_(grads, max_norm / norm.clamp(min=max_norm))
    return norm


def apply_gradients(optimizer: torch.optim.Optimizer,
                    reduce: Optional[Callable[[List[torch.Tensor]], None]]
                    = None) -> None:
    """One update from the parameters' .grad: `reduce` (in a process
    group, parallel.mesh.all_reduce_mean_: the gradients averaged over the
    ranks, in place), then the clip the param group carries (reference
    src/optimization/traditional.py:184-189), which so sees the reduced
    gradient, then the optimizer's step."""
    if reduce is not None:
        reduce(_grads(optimizer))
    clip = optimizer.param_groups[0].get('grad_clip')
    if clip:
        clip_by_global_norm_(_grads(optimizer), clip)
    optimizer.step()


def set_learning_rate(optimizer: torch.optim.Optimizer,
                      lr: float) -> torch.optim.Optimizer:
    for group in optimizer.param_groups:
        group['lr'] = lr
    return optimizer


def get_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]['lr'])


class StepLR:
    """lr = lr0 * gamma^(epoch // step_size)."""

    def __init__(self, lr0: float, step_size: int, gamma: float):
        self.lr0, self.step_size, self.gamma = lr0, step_size, gamma
        self.epoch = 0
        self.lr = lr0

    def step(self, metric: float = None) -> float:
        self.epoch += 1
        self.lr = self.lr0 * (self.gamma ** (self.epoch // self.step_size))
        return self.lr

    def state_dict(self) -> Dict[str, Any]:
        return {'epoch': self.epoch, 'lr': self.lr}

    def load_state_dict(self, d):
        self.epoch, self.lr = d['epoch'], d['lr']


class ReduceLROnPlateau:
    """Torch-semantics plateau scheduler (mode 'min', factor 0.1, patience
    as configured; the reference uses patience 3,
    src/optimization/train_methods.py:866-871)."""

    def __init__(self, lr0: float, patience: int = 3, factor: float = 0.1,
                 threshold: float = 1e-4, min_lr: float = 0.0):
        self.lr = lr0
        self.patience, self.factor = patience, factor
        self.threshold, self.min_lr = threshold, min_lr
        self.best = math.inf
        self.num_bad = 0

    def step(self, metric: float) -> float:
        if metric < self.best * (1 - self.threshold):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.num_bad = 0
        return self.lr

    def state_dict(self):
        return {'lr': self.lr, 'best': self.best, 'num_bad': self.num_bad}

    def load_state_dict(self, d):
        self.lr, self.best, self.num_bad = d['lr'], d['best'], d['num_bad']


class CosineAnnealingWarmRestarts:
    """lr = eta_min + (lr0 - eta_min) * (1 + cos(pi * T_cur / T_i)) / 2,
    restarting every T_0 epochs (T_mult 1; the reference uses T_0 10)."""

    def __init__(self, lr0: float, T_0: int = 10, eta_min: float = 0.0):
        self.lr0, self.T_0, self.eta_min = lr0, T_0, eta_min
        self.epoch = 0
        self.lr = lr0

    def step(self, metric: float = None) -> float:
        self.epoch += 1
        t_cur = self.epoch % self.T_0
        self.lr = self.eta_min + (self.lr0 - self.eta_min) * \
            (1 + math.cos(math.pi * t_cur / self.T_0)) / 2
        return self.lr

    def state_dict(self):
        return {'epoch': self.epoch, 'lr': self.lr}

    def load_state_dict(self, d):
        self.epoch, self.lr = d['epoch'], d['lr']


def build_scheduler(config):
    name = config.get('scheduler', 'ReduceLROnPlateau')
    lr0 = config.getfloat('lr')
    if name == 'StepLR':
        return StepLR(lr0, config.getint('step_size'),
                      config.getfloat('gamma'))
    if name == 'ReduceLROnPlateau':
        return ReduceLROnPlateau(lr0, patience=3)
    if name == 'CosineAnnealingWarmRestarts':
        return CosineAnnealingWarmRestarts(lr0, T_0=10)
    raise ValueError(f'Unsupported scheduler {name}')
