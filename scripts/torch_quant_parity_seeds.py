#!/usr/bin/env python3
"""Measure how far the port's int8 path (mm_distillnet_torch/quant.py)
strays from the JAX package's on the CPU, over several seeds, at the
settings of tests/test_torch_quant.py (test-tiny backbone at 64 px and
test-tiny detector at 128 px, fp32 models, one pack in both packages):

    JAX_PLATFORMS=cpu python scripts/torch_quant_parity_seeds.py [--seeds 5]

Prints, per model and compute dtype of the quantized convs, the share of
int8 conv inputs that differ and the outputs' largest relative L2, per
seed and at most; then the quantized evaluate() against the JAX one
(|port - JAX| per AP-table column, per seed and at most over the seeds),
with the port running the JAX evaluate()'s pack ('one_pack') and its own
('own_pack'), and the one-pack run's student outputs against the JAX
quantized_apply ('forward_rel_l2'). torch runs on one thread, as in the
tests. The tests' bounds rest on these readings. Needs the JAX package.
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

import torch  # noqa: E402

from tests import test_torch_quant as tq  # noqa: E402


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--seeds', type=int, default=5)
    a = p.parse_args()
    torch.set_num_threads(1)    # as the tests run (one_torch_thread)
    result = {}
    for kind in ('backbone', 'detector'):
        for dtype in ('float32', 'bfloat16'):
            rows = [tq.measure_parity(kind, s, dtype)
                    for s in range(a.seeds)]
            result[f'{kind}/{dtype}'] = {
                'int8_flip_share': [r[0] for r in rows],
                'output_rel_l2': [r[1] for r in rows],
                'max': [max(r[0] for r in rows), max(r[1] for r in rows)]}
            print(kind, dtype, json.dumps(result[f'{kind}/{dtype}']),
                  flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)     # evaluate() writes its tables under the cwd
        gaps = [tq.measure_evaluate(s) for s in range(a.seeds)]
    for g in gaps:
        print('evaluate', json.dumps(g), flush=True)
    result['evaluate'] = {
        'forward_rel_l2': max(g['forward_rel_l2'] for g in gaps),
        **{k: {c: max(g[k][c] for g in gaps) for c in gaps[0][k]}
           for k in ('own_pack', 'one_pack')}}
    print('evaluate', json.dumps(result['evaluate']), flush=True)


if __name__ == '__main__':
    main()
