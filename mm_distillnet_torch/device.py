"""Device selection for the port's entry points: CUDA unless asked."""
from __future__ import annotations

import torch


def resolve_device(device='cuda') -> torch.device:
    """torch.device for `device` ('cpu', 'cuda' or 'cuda:N'); raises if
    CUDA is asked for and absent, or card N is not there. A plain 'cuda'
    is the current card, which a formed process group has set to the
    rank's (parallel/mesh.py).

    Entry points never fall back to the CPU on their own: a caller that
    wants the CPU (the tests) passes device='cpu'."""
    dev = torch.device(device)
    if dev.type != 'cuda':
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    if dev.index is None:
        return torch.device('cuda', torch.cuda.current_device())
    if dev.index >= torch.cuda.device_count():
        raise RuntimeError(f'{dev} asked for, {torch.cuda.device_count()} '
                           'cards visible')
    return dev
