"""Run reproducibility (port of mm_distillnet_tpu/utils/reproducibility.py;
reference src/utils/utils.py:593-613).

The port's own random draws take explicit generators; this seeds what
draws from the global ones: python's and numpy's (data shuffling,
augmentation choices) and torch's.
"""
from __future__ import annotations

import os
import random

import numpy as np
import torch


def make_reproducible_run(seed: int) -> None:
    if seed is None or seed < 0:
        return
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    os.environ['PYTHONHASHSEED'] = str(seed)
