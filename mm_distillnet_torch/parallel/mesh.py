"""Multi-process set-up (port of the first part of
mm_distillnet_tpu/parallel/mesh.py).

Only `distributed_init_if_needed` is ported: a single-process run goes on,
and a configured multi-process world raises until the DDP port (ROADMAP
Queue 1 item 13), rather than training on one process's share of the data
while reporting success.
"""
from __future__ import annotations

import os


def _more_than_one(value) -> bool:
    try:
        return int(value) > 1
    except (TypeError, ValueError):
        return False


def distributed_init_if_needed(config=None) -> None:
    """No-op for one process. Raises NotImplementedError when a
    multi-process world is configured: config `coordinator_address`, or
    `num_processes` or `nodes` above 1; the JAX package's environment
    (JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES above 1); or torch's
    WORLD_SIZE above 1."""
    env = os.environ
    reasons = []
    if env.get('JAX_COORDINATOR_ADDRESS'):
        reasons.append('JAX_COORDINATOR_ADDRESS')
    if _more_than_one(env.get('JAX_NUM_PROCESSES')):
        reasons.append('JAX_NUM_PROCESSES')
    if _more_than_one(env.get('WORLD_SIZE')):
        reasons.append('WORLD_SIZE')
    if config is not None:
        if config.get('coordinator_address', fallback=None):
            reasons.append('coordinator_address')
        for key in ('num_processes', 'nodes'):
            if _more_than_one(config.get(key, fallback=None)):
                reasons.append(key)
    if reasons:
        raise NotImplementedError(
            f'a multi-process world is configured ({", ".join(reasons)}); '
            'torch.distributed training waits for the DDP port (ROADMAP '
            'Queue 1 item 13)')
