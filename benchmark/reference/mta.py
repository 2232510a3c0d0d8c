"""MTA (Multi-Teacher Alignment) attention-distillation loss (port of
mm_distillnet_tpu/losses/mta.py; reference src/loss/MTALoss.py:9-77):

  at(f) = L2-normalize(flatten(mean_over_channels(f^p)))      (p = 2)
  several teachers: the elementwise product of their attention maps,
                    L1-normalised;
  loss = KL(softmax(at_s / T) || softmax(at_t / T)), batchmean, T = 9.

`parity_mode=True` (the default) keeps the reference's quirk: it passes
softmax, not log_softmax, as the input of F.kl_div, which expects
log-probabilities, so the loss is sum(target * (log(target) - softmax(s/T)))
/ B. That is the trained behaviour; the MTA of identical features is then
non-zero and may be negative. `parity_mode=False` is the textbook KL.

Feature maps are NHWC: the channel mean is over the last axis and the
flattened spatial order (row-major H, W) is the reference's NCHW flatten.
"""
from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.nn.functional as F


def attention_map(f: torch.Tensor, p: float = 2.0) -> torch.Tensor:
    """(B, H, W, C) -> (B, H*W) L2-normalised spatial attention, in fp32
    (F.normalize's norm is clamped at 1e-12)."""
    a = f.float().pow(p).mean(dim=-1).flatten(1)
    return F.normalize(a, p=2.0, dim=1, eps=1e-12)


def _kl_batchmean(inp: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """F.kl_div(inp, target, reduction='batchmean') with `inp` taken as
    log-probabilities: sum(target * (log(target) - inp)) / batch."""
    safe = torch.where(target > 0,
                       target * (torch.log(target.clamp(min=1e-38)) - inp),
                       0.0)
    return safe.sum() / inp.shape[0]


def mta_loss_single(f_s: torch.Tensor,
                    f_t: Union[torch.Tensor, Sequence[torch.Tensor]],
                    T: float = 9.0, p: float = 2.0,
                    parity_mode: bool = True) -> torch.Tensor:
    """MTA loss of one pyramid level: the student's map against one
    teacher's map, or against the product of several teachers' maps."""
    at_s = attention_map(f_s, p)
    if isinstance(f_t, (list, tuple)):
        prod = attention_map(f_t[0], p)
        if len(f_t) > 1:
            for t in f_t[1:]:
                prod = prod * attention_map(t, p)
            l1 = prod.abs().sum(dim=1, keepdim=True)
            prod = prod / l1.clamp(min=1e-12)
        at_t = prod
    else:
        at_t = attention_map(f_t, p)
    target = torch.softmax(at_t / T, dim=1)
    inp = (torch.softmax(at_s / T, dim=1) if parity_mode
           else torch.log_softmax(at_s / T, dim=1))
    return _kl_batchmean(inp, target)


def mta_loss(g_s: Sequence[torch.Tensor], g_t: Sequence,
             T: float = 9.0, p: float = 2.0,
             parity_mode: bool = True) -> torch.Tensor:
    """Multi-level MTA loss (reference src/loss/MTALoss.py:15-34).

    g_s: the student's pyramid features. g_t: one teacher's features (a
    list as long as g_s), or a list of per-teacher feature lists (kdlist:
    the multi-teacher attention product per level). Returns a
    (num_levels,) vector."""
    if isinstance(g_t[0], (list, tuple)):
        losses = [mta_loss_single(g_s[i], [ft[i] for ft in g_t], T, p,
                                  parity_mode)
                  for i in range(len(g_s))]
    else:
        losses = [mta_loss_single(fs, ft, T, p, parity_mode)
                  for fs, ft in zip(g_s, g_t)]
    return torch.stack(losses)
