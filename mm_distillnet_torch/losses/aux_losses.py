"""Auxiliary distillation losses (port of
mm_distillnet_tpu/losses/aux_losses.py):

- DistillKL: Hinton KD (reference src/loss/DistillKL.py:17-31);
- AttentionLoss: Zagoruyko attention transfer, the mean squared difference
  of attention maps after an adaptive pool to the smaller size (reference
  src/loss/AttentionLoss.py:17-40).
"""
from __future__ import annotations

from typing import Sequence

import torch

from .mta import attention_map


def distill_kl(logits_s: torch.Tensor, logits_t: torch.Tensor,
               T: float = 4.0, axis: int = 1) -> torch.Tensor:
    """KL(log_softmax(s/T) || softmax(t/T)) * T^2 / B. axis=1 is the class
    axis of (B, C) classifier logits; detector callers pass axis=-1 so the
    softmax stays over the classes of (B, N_anchors, C) logits."""
    log_p_s = torch.log_softmax(logits_s / T, dim=axis)
    p_t = torch.softmax(logits_t / T, dim=axis)
    kl = (p_t * (torch.log(p_t.clamp(min=1e-38)) - log_p_s)).sum()
    return kl * (T ** 2) / logits_s.shape[0]


def _adaptive_avg_pool_hw(x: torch.Tensor, out_hw: int) -> torch.Tensor:
    """NHWC adaptive average pool to (out_hw, out_hw); pyramid levels are
    integer multiples of each other, so a reshape-mean is exact."""
    b, h, w, c = x.shape
    x = x.reshape(b, out_hw, h // out_hw, out_hw, w // out_hw, c)
    return x.mean(dim=(2, 4))


def attention_transfer_loss(g_s: Sequence[torch.Tensor],
                            g_t: Sequence[torch.Tensor],
                            p: float = 2.0) -> torch.Tensor:
    """Per level, the mean squared difference of the attention maps; the
    smaller map's size wins. Returns (num_levels,) losses."""
    losses = []
    for f_s, f_t in zip(g_s, g_t):
        hs, ht = f_s.shape[1], f_t.shape[1]
        if hs > ht:
            f_s = _adaptive_avg_pool_hw(f_s, ht)
        elif ht > hs:
            f_t = _adaptive_avg_pool_hw(f_t, hs)
        losses.append(((attention_map(f_s, p) -
                        attention_map(f_t, p)) ** 2).mean())
    return torch.stack(losses)
