"""Device selection for the port's entry points: CUDA unless asked."""
from __future__ import annotations

import torch


def resolve_device(device='cuda') -> torch.device:
    """torch.device for `device`; raises if CUDA is asked for and absent.

    Entry points never fall back to the CPU on their own: a caller that
    wants the CPU (the tests) passes device='cpu'."""
    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
