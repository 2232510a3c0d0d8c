#!/usr/bin/env python3
"""Sweep of kernel (b) `mbconv_se` over its launch plans at the 23 MBConv
block shapes of EfficientDet-D2 at 768 px, batch 8.

    python3 scripts/torch_sweep_se_plan.py [--seed N] [--blocks 0,8,22]

For every block and every plan that `make_se_plan` accepts (clusters of 1,
2, 4 and 8 CTAs; tiles or channels split over them; 256, 512 or 1024
threads) the gate is held against `se_gate_reference` (rtol = atol = 1e-4),
two launches must be bit-equal, and two device times are taken, each as
CUDA events around replays of a CUDA graph:

  b     20 launches of (b) alone. (b) is launched as a programmatic
        dependent, so each launch's prologue overlaps the launch before;
  bc-c  20 x [(b), (c)] minus 20 x (c): what (b) adds to a stream in which
        it stands between two other kernels, as in the backbone.

`block_ms` is the whole block, 20 x [(a), (b), (c)]. Needs one NVIDIA GPU
and nvcc. Prints the card, one JSON line per block with every plan's
times and the plan `se_plan` chooses, and writes all of it to
chiprun_out/se_sweep.json.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from mm_distillnet_torch.models.efficientnet import (MBConvBlock,  # noqa: E402
                                                     expand_block_args)
from mm_distillnet_torch.ops import cuda_build  # noqa: E402
from mm_distillnet_torch.ops import fused_mbconv as fm  # noqa: E402


def graph_ms(fn, reps=20, replays=5):
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def candidates(t, cep, cs):
    for ranks in (1, 2, 4, 8):
        for split_tiles in (True, False):
            for threads in (256, 512, 1024):
                if split_tiles and ranks > t:
                    continue
                try:
                    yield fm.make_se_plan(t, cep, cs, ranks, split_tiles,
                                          threads)
                except ValueError:
                    continue


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--blocks', default='')
    a = p.parse_args()
    if not torch.cuda.is_available():
        print('no CUDA device', file=sys.stderr)
        return 1
    only = {int(v) for v in a.blocks.split(',') if v}
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    device = torch.device('cuda', 0)
    cuda_build.build_all()
    for line in cuda_build.build_logs.get('mbconv', '').splitlines():
        if any(w in line for w in ('Used', 'spill', 'error', 'warning')):
            print('  nvcc mbconv:', line.strip(), flush=True)
    rows, failures = [], []
    h = 384
    for i, args in enumerate(expand_block_args(2)):
        hin, h = h, h // args.stride
        if only and i not in only:
            continue
        torch.manual_seed(a.seed + i)
        block = MBConvBlock(args).to(device).eval()
        f = fm.fold_mbconv(block.state_dict(), args, device)
        x = torch.randn((8, hin, hin, args.input_filters),
                        device=device).to(torch.bfloat16)
        skip = x if fm.has_skip(args) else None
        d, sums = fm.expand_dw(x, f, args)
        hw = d.shape[1] * d.shape[2]
        _, t, cep = sums.shape
        cs = f.w_se1.shape[0]
        want = fm.se_gate_reference(sums, f, hw)
        gate = fm.se_gate(sums, f, hw)
        c_ms = graph_ms(lambda: fm.project(d, gate, f, skip))
        chosen = fm.se_plan(t, cep, cs)
        plans = []
        for plan in candidates(t, cep, cs):
            got = fm.se_gate(sums, f, hw, plan)
            again = fm.se_gate(sums, f, hw, plan)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            ok = torch.allclose(got, want, rtol=1e-4, atol=1e-4)
            same = torch.equal(got, again)
            if not (ok and same):
                failures.append((i, tuple(plan), err, same))
            b_ms = graph_ms(lambda: fm.se_gate(sums, f, hw, plan))

            def pair():
                g = fm.se_gate(sums, f, hw, plan)
                fm.project(d, g, f, skip)
            plans.append({'plan': list(plan), 'b_ms': round(b_ms, 5),
                          'bc_minus_c_ms': round(graph_ms(pair) - c_ms, 5),
                          'max_abs_err': err, 'chosen': plan == chosen})
        best = min(plans, key=lambda r: r['bc_minus_c_ms'])
        mine = next(r for r in plans if r['chosen'])
        row = {'block': i, 't': t, 'cep': cep, 'cs': cs, 'c_ms': round(c_ms, 5),
               'chosen': mine, 'best': best, 'plans': plans}
        row['block_ms'] = graph_ms(lambda: fm.mbconv_fused(x, f, args))
        rows.append(row)
        print(json.dumps({k: v for k, v in row.items() if k != 'plans'}),
              flush=True)
        for r in sorted(plans, key=lambda r: r['bc_minus_c_ms'])[:6]:
            print('   ', json.dumps(r), flush=True)
    sums_ms = {'chosen_b': sum(r['chosen']['b_ms'] for r in rows),
               'chosen_bc_minus_c': sum(r['chosen']['bc_minus_c_ms']
                                        for r in rows),
               'best_bc_minus_c': sum(r['best']['bc_minus_c_ms']
                                      for r in rows),
               'block': sum(r['block_ms'] for r in rows)}
    print(json.dumps({'sum_ms': sums_ms}))
    out = ROOT / 'chiprun_out'
    out.mkdir(exist_ok=True)
    (out / 'se_sweep.json').write_text(json.dumps(
        {'card': card, 'seed': a.seed, 'blocks': rows, 'sum_ms': sums_ms},
        indent=1))
    if failures:
        print('FAILED plans:', failures, file=sys.stderr)
        return 1
    return 0


if __name__ == '__main__':
    sys.exit(main())
