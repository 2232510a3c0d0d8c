"""Logging and scalar records (port of
mm_distillnet_tpu/utils/logging_utils.py).

The reference's channels (SURVEY.md section 5): python logging with a
per-run, per-rank DEBUG file `{exp_name}/{exp_name}.{rank}.log` (reference
train.py:283-292), and scalars under the reference's tensorboard tags
(Train/Total_loss, Train/Class_loss, ...; reference
src/optimization/traditional.py:210-236) kept in `all_logs.{rank}.json`
(train_methods.py:1067) and, when tensorboardX is installed, written there
too.
"""
from __future__ import annotations

import json
import logging
import os
from typing import Dict


def setup_run_logging(config, rank: int = 0) -> logging.Logger:
    exp_name = config.get('exp_name', 'run')
    path = os.path.join(exp_name, f'{exp_name}.{rank}.log')
    # exp_name may itself hold a path separator: make the whole chain
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    logger = logging.getLogger('mm_distillnet_torch')
    logger.setLevel(logging.DEBUG)
    # one run file per process at a time: a process that drives several
    # runs drops the handlers of other run files and keeps this one's
    abspath = os.path.abspath(path)
    for h in list(logger.handlers):
        if isinstance(h, logging.FileHandler) and \
                getattr(h, 'baseFilename', '') != abspath:
            logger.removeHandler(h)
            h.close()
    if not any(isinstance(h, logging.FileHandler) and
               getattr(h, 'baseFilename', '') == abspath
               for h in logger.handlers):
        fh = logging.FileHandler(path)
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(logging.Formatter(
            '%(asctime)s %(levelname)s %(name)s: %(message)s'))
        logger.addHandler(fh)
    return logger


class ScalarWriter:
    """Per-rank scalar record: a tensorboardX writer when the package is
    there, and always the JSON file `all_logs.{rank}.json`."""

    def __init__(self, config, rank: int = 0):
        self.rank = rank
        self.scalars: Dict[str, Dict[int, float]] = {}
        self.exp_name = config.get('exp_name', 'run')
        os.makedirs(self.exp_name, exist_ok=True)
        self._tb = None
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            return
        log_path = config.get('log_path', 'tensorboard')
        os.makedirs(log_path, exist_ok=True)
        self._tb = SummaryWriter(logdir=os.path.join(log_path, f'rank{rank}'))

    def add_scalar(self, tag: str, value: float, step: int):
        value = float(value)
        self.scalars.setdefault(tag, {})[int(step)] = value
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def export_json(self):
        path = os.path.join(self.exp_name, f'all_logs.{self.rank}.json')
        with open(path, 'w') as f:
            json.dump(self.scalars, f)

    def close(self):
        self.export_json()
        if self._tb is not None:
            self._tb.close()
