#!/usr/bin/env python3
"""Measure how far the port's evaluate() and evaluate CLI stray from the
JAX package's on the CPU, over several weight seeds, at the settings of
tests/test_torch_evaluation.py and tests/test_torch_cli.py (test-tiny,
128 px, six synthetic frames, fp32):

    JAX_PLATFORMS=cpu python scripts/torch_eval_parity_seeds.py [--seeds 5]

Prints, per column of the AP table, the largest |port - JAX| over the
seeds, for evaluate() and for the two CLIs. The tests' parity bounds rest
on these readings. Needs the JAX package (and cv2 for its datasets).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402

jax.config.update('jax_platforms', 'cpu')

import jax.numpy as jnp  # noqa: E402
from mm_distillnet_tpu import evaluation as jax_eval  # noqa: E402
from mm_distillnet_tpu import config as jax_config  # noqa: E402
from mm_distillnet_tpu.data import synthetic as jax_synthetic  # noqa: E402
from mm_distillnet_tpu.models import registry as jax_registry  # noqa: E402
from mm_distillnet_tpu.models import efficientdet as jax_det  # noqa: E402
from mm_distillnet_torch import evaluation as ev  # noqa: E402
from mm_distillnet_torch.cli import evaluate as cli_evaluate  # noqa: E402
from mm_distillnet_torch.config import default_config  # noqa: E402
from mm_distillnet_torch.convert import weights  # noqa: E402
from mm_distillnet_torch.data.synthetic import \
    SyntheticMultimodal  # noqa: E402
from mm_distillnet_torch.models.efficientdet import EfficientDet  # noqa: E402
from tests import test_torch_cli as cli_test  # noqa: E402
from tests.test_torch_evaluation import (CHANNELS, COLUMNS,  # noqa: E402
                                         SETTINGS, SIZE)
from tests.test_torch_helpers import (filled_variables,  # noqa: E402
                                      nhwc_input, to_jax)

JaxDet = jax_det.EfficientDet


def evaluate_diffs(offset: int) -> dict:
    """evaluate() in both packages, test_torch_evaluation's setup with the
    weight seeds moved by `offset` (offset 0 is the test's own)."""
    nets = {}
    for seed, (m, ch) in enumerate(CHANNELS.items()):
        jmod = JaxDet(num_classes=20, compound_coef=-1, dtype=jnp.float32)
        v = filled_variables(jmod, 10 + seed + offset,
                             nhwc_input(0, (1, SIZE, SIZE, ch)))
        nets[m] = (jmod, v, EfficientDet(20, -1, ch),
                   weights.state_dict_from_flax(v))
    jcfg = jax_config.default_config(exp_name='eval-jax', **SETTINGS)
    tcfg = default_config(exp_name='eval-torch', **SETTINGS)
    teachers = ('rgb', 'thermal', 'depth')
    want = jax_eval.evaluate(
        {m: (nets[m][0], to_jax(nets[m][1])) for m in teachers},
        (nets['audio'][0], to_jax(nets['audio'][1])),
        jax_synthetic.SyntheticMultimodal(jcfg, 'test'), jcfg)
    got = ev.evaluate({m: (nets[m][2], nets[m][3]) for m in teachers},
                      (nets['audio'][2], nets['audio'][3]),
                      SyntheticMultimodal(tcfg, 'test'), tcfg, device='cpu')
    return {c: abs(got[0][c] - float(want[c][0])) for c in COLUMNS[2:]}


def cli_diffs(offset: int, root: str) -> dict:
    """The two evaluate CLIs, test_torch_cli's files with the weight seeds
    moved by `offset`."""
    os.chdir(root)
    models = os.path.join(root, 'trained_models')
    os.makedirs(models, exist_ok=True)
    for seed, (m, ch) in enumerate(cli_test.CHANNELS.items()):
        jmod = JaxDet(num_classes=20, compound_coef=-1, dtype=jnp.float32)
        cli_test._write_pth(
            filled_variables(jmod, 50 + seed + offset,
                             nhwc_input(0, (1, 128, 128, ch))),
            os.path.join(models, f'yet-another-efficientdet-d2-{m}.pth'))
    student = os.path.join(root, 'student.pth')
    cli_test._write_pth(filled_variables(
        JaxDet(num_classes=20, compound_coef=-1, dtype=jnp.float32),
        60 + offset, nhwc_input(0, (1, 128, 128, 8))), student)
    jax_registry.init_variables = cli_test._fast_jax_init
    args = ['--config_file', cli_test.CONFIG, '--checkpoint', student]
    over = dict(cli_test.TINY, saved_path=models)
    got = cli_evaluate.main(args + ['--device', 'cpu', '--overwrite',
                                    json.dumps(dict(over, exp_name='t'))])
    cli_test._import_root('evaluate').main(args + ['--overwrite', json.dumps(
        dict(over, exp_name='j'))])
    want = cli_test._read_csv('j/results.0.csv')
    return {c: abs(got[0][c] - float(want[0][c])) for c in COLUMNS[2:]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--seeds', type=int, default=5)
    args = p.parse_args(argv)
    worst = {'evaluate': {}, 'cli': {}}
    for offset in range(args.seeds):
        for kind, fn in (('evaluate', evaluate_diffs),
                         ('cli', lambda o: cli_diffs(
                             o, tempfile.mkdtemp(prefix='parity')))):
            with tempfile.TemporaryDirectory() as d:
                os.chdir(d)
                diffs = fn(offset)
            print(kind, 'seed offset', offset, json.dumps(diffs), flush=True)
            for c, v in diffs.items():
                worst[kind][c] = max(worst[kind].get(c, 0.0), v)
    print('largest |port - JAX| over the seeds:', json.dumps(worst))
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
