"""Checkpoint and resume with the reference's state contract (port of
mm_distillnet_tpu/train/checkpoint.py).

As save_checkpoint / resume_from_checkpoint of the reference
(src/optimization/train_methods.py:1188-1254): one `torch.save` per rank of
{epoch, state_dict, best_loss, best_epoch, optimizer, scheduler} (plus the
step count) to `{exp_name}/checkpoint.{rank}`, copied to `best.{rank}` when
validation improves, with the parameters-only `only_parameters_student_best
.{rank}` beside it (train_methods.py:1028-1034). Every file is written to a
temporary name and renamed, so a reader never sees half of one. In a
process group `save_checkpoint` returns after every rank has written its
files (a barrier), so rank 0 may read them all.
"""
from __future__ import annotations

import math
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import torch

from ..distill.train_step import TrainState
from ..parallel.mesh import barrier


def _ckpt_path(config, name: str, rank: int) -> str:
    exp_name = config.get('exp_name', 'run')
    os.makedirs(exp_name, exist_ok=True)
    return os.path.abspath(os.path.join(exp_name, f'{name}.{rank}'))


def _atomic(write, path: str) -> None:
    tmp = path + '.tmp'
    write(tmp)
    os.replace(tmp, path)


def save_checkpoint(config, state: TrainState, epoch: int, best_loss: float,
                    best_epoch: int, scheduler_state: Dict[str, Any],
                    rank: int = 0, is_best: bool = False) -> str:
    model_state = state.model.state_dict()
    payload = {'epoch': epoch, 'state_dict': model_state,
               'best_loss': best_loss, 'best_epoch': best_epoch,
               'optimizer': state.optimizer.state_dict(),
               'scheduler': dict(scheduler_state), 'step': state.step}
    path = _ckpt_path(config, 'checkpoint', rank)
    _atomic(lambda p: torch.save(payload, p), path)
    if is_best:
        _atomic(lambda p: shutil.copyfile(path, p),
                _ckpt_path(config, 'best', rank))
        _atomic(lambda p: torch.save({'state_dict': model_state}, p),
                _ckpt_path(config, 'only_parameters_student_best', rank))
    barrier()
    return path


def restore_checkpoint(config, state: TrainState, scheduler, rank: int = 0,
                       name: str = 'checkpoint'
                       ) -> Tuple[TrainState, int, float, int]:
    """Loads `{name}.{rank}` into state (model, optimizer, step) and the
    scheduler, in place. Returns (state, start_epoch, best_loss,
    best_epoch); without a checkpoint, (state, 0, inf, 0) (reference
    resume_from_checkpoint, train_methods.py:1188-1236)."""
    path = _ckpt_path(config, name, rank)
    if not os.path.exists(path):
        return state, 0, math.inf, 0
    device = next(state.model.parameters()).device
    ckpt = torch.load(path, map_location=device, weights_only=True)
    state.model.load_state_dict(ckpt['state_dict'])
    state.optimizer.load_state_dict(ckpt['optimizer'])
    state.step = int(ckpt['step'])
    scheduler.load_state_dict(ckpt['scheduler'])
    return (state, int(ckpt['epoch']) + 1, float(ckpt['best_loss']),
            int(ckpt['best_epoch']))


def load_student_params(config, rank: int = 0, name: str = 'best'
                        ) -> Optional[Dict[str, torch.Tensor]]:
    """The student's state_dict from `{name}.{rank}` (a full checkpoint or
    the parameters-only file), or None when there is none."""
    path = _ckpt_path(config, name, rank)
    if not os.path.exists(path):
        return None
    return torch.load(path, map_location='cpu',
                      weights_only=True)['state_dict']
