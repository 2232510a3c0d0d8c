#!/usr/bin/env python3
"""Readings that set a cell's limits: the check's numbers for sound runs
of the program, for the control and for planted faults, at the cell's own
size on the card, many seeds in one process (no benchmark run calls it).

    python3 benchmark/control.py --workload NAME --seeds 1,2,3 \\
        [--variant int8|fp8] [--fault NAME] [--calls N]

`--variant int8` serves the program's int8 path (the serve cells'
control); `--variant fp8` puts the reference, computed in fp8, in the
train step's place (the train cell's control). `--fault` plants one of
faults.py's faults. A serve cell runs `--calls` calls (default: the
traffic's `distinct_calls`) and judges the sampled frames; a train cell
judges its first steps. One JSON line per seed.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', required=True)
    p.add_argument('--variant', default=None)
    p.add_argument('--fault', default=None)
    p.add_argument('--calls', type=int, default=None)
    args = p.parse_args(argv)
    import importlib

    import torch

    from benchmark import faults
    from benchmark.common import benchmark_spec, find_cell
    spec = find_cell(benchmark_spec(ROOT), args.workload)
    kind_name = spec['traffic']['kind']
    kind = importlib.import_module(f'benchmark.kinds.{kind_name}')
    dev = torch.device('cuda', 0)
    fault = None
    if args.fault:
        fault = (faults.SERVE if kind_name == 'serve'
                 else faults.TRAIN)[args.fault]
    for seed in (int(s) for s in args.seeds.split(',')):
        t = time.perf_counter()
        cell = kind.Cell(spec, seed, dev, variant=args.variant, fault=fault)
        if kind_name == 'serve':
            cell.warm()
            for i in range(args.calls or spec['traffic']['distinct_calls']):
                cell.call(i)
        cell.free_program()
        explain = {}
        values = cell.check(explain)
        print(json.dumps({'workload': args.workload, 'seed': seed,
                          'variant': args.variant, 'fault': args.fault,
                          'values': values, 'explain': explain,
                          'seconds': time.perf_counter() - t}), flush=True)
        del cell
        torch.cuda.empty_cache()
    return 0


if __name__ == '__main__':
    sys.exit(main())
