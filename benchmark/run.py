#!/usr/bin/env python3
"""One run of one cell of the benchmark of `mm_distillnet_torch` on the
card, from the root of a checkout:

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

The cell's entry in BENCHMARK.json names its configuration
(`configs/<name>.json`), its traffic (`traffic/<name>.json`, whose `kind`
names the module `kinds/<kind>.py` that runs it) and its limits
(`workloads/<name>.json`).
Set-up makes the weights and frames from the seed on the card, builds the
program's step or predictor and warms every shape the window uses; then
the window runs calls for S seconds. `--trace 0` prints the cell's
end-to-end metrics; `--trace 1` runs the same window and then the
traffic's `trace_calls` calls under torch.profiler, and prints its
per-layer metrics, each from its reader `metrics/<name>.py`, which is
handed both: the traced calls' trace and counters, and the untraced
window's time and counters. After the window the served outputs are
judged against the plain reference (`check.py`), and the last line of
standard output is the result as one JSON object.

Exit codes: 2 without enough CUDA cards, 3 if JAX or the JAX package is
loaded once the check is done, 1 on any other failure; no result is
printed then.
"""
import time

START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every cache at a fixed place inside the checkout, and no JAX by way of a
# library that would load it
os.environ['TORCH_EXTENSIONS_DIR'] = str(ROOT / 'build' / 'torch_extensions')
os.environ['TRITON_CACHE_DIR'] = str(ROOT / 'build' / 'triton')
os.environ['USE_FLAX'] = '0'
os.environ['USE_JAX'] = '0'
sys.path.insert(0, str(ROOT))

PERCENTILE = re.compile(r'_p(\d+)_ms$')


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def card_line() -> str:
    """The card's name, power limit and clocks, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit,clocks.sm,'
             'clocks.max.sm,temperature.gpu', '--format=csv,noheader'],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return 'nvidia-smi unavailable'


def end_to_end(name: str, setup_s: float, frames: int, window_s: float,
               latencies_ms) -> float:
    """An end-to-end metric by the rule its name states: `setup_s`; a
    name ending in `_frames_per_s`, every frame of the window over the
    window's time; a name ending in `_p<NN>_ms`, that percentile of every
    call's latency."""
    from benchmark.common import percentile
    if name == 'setup_s':
        return setup_s
    if name.endswith('_frames_per_s'):
        return frames / window_s
    m = PERCENTILE.search(name)
    if m:
        return percentile(latencies_ms, float(m.group(1)))
    raise KeyError(f'no rule for the end-to-end metric {name!r}')


def window(cell, seconds: float):
    """Calls for `seconds` seconds: (calls, window s, latencies ms). The
    window ends with a synchronize."""
    import torch
    latencies = []
    t0 = now = time.perf_counter()
    i = 0
    while now - t0 < seconds:
        cell.call(i)
        i += 1
        t = time.perf_counter()
        latencies.append((t - now) * 1e3)
        now = t
    torch.cuda.synchronize()
    return i, time.perf_counter() - t0, latencies


def traced(cell, calls: int, seconds: float, first: int):
    """Up to `calls` calls (and at most `seconds` s) under torch.profiler,
    numbered on from call `first`: (calls, Trace)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchmark.common import WINDOW, trace_from_profiler
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(WINDOW):
            t0 = time.perf_counter()
            i = 0
            while i < calls and (i == 0 or
                                 time.perf_counter() - t0 < seconds):
                cell.call(first + i)
                i += 1
            torch.cuda.synchronize()
    return i, trace_from_profiler(prof)


def run(args) -> int:
    from benchmark import check
    from benchmark.common import (benchmark_spec, find_cell,
                                  forbidden_loaded, metric_reader,
                                  metrics_of)
    spec = benchmark_spec(ROOT)
    cell_spec = find_cell(spec, args.workload)
    import torch
    chips = cell_spec['entry']['chips']
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f'the cell {args.workload} needs {chips} CUDA card(s); this '
              f'machine has {torch.cuda.device_count()}', file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    dev = torch.device('cuda')
    card = card_line()
    print(f'card: {card}; torch {torch.__version__}, CUDA '
          f'{torch.version.cuda}', flush=True)
    kind = importlib.import_module(
        f'benchmark.kinds.{cell_spec["traffic"]["kind"]}')
    torch.cuda.reset_peak_memory_stats()
    cell = kind.Cell(cell_spec, args.seed, dev)
    cell.warm()
    setup_s = time.perf_counter() - START
    print(f'set-up {setup_s:.3f} s: {json.dumps(cell.setup_parts)}',
          flush=True)

    device = {'platform': 'gpu', 'kind': torch.cuda.get_device_name(),
              'count': chips}
    calls, window_s, latencies = window(cell, args.seconds)
    frames = cell.frames(calls)
    print(f'window: {calls} calls, {frames} frames in {window_s:.4f} s',
          flush=True)
    attempted, breakdown = calls, None
    if args.trace:
        n, trace = traced(cell, cell_spec['traffic']['trace_calls'],
                          args.seconds, calls)
        attempted += n
        readings = {'trace': trace, 'counters': cell.counters(n),
                    'window': {'seconds': window_s,
                               'counters': cell.counters(calls)}}
        metrics = {}
        for m in metrics_of(spec, args.workload, 'per_layer'):
            value = metric_reader(m['name']).read(readings)
            if value is not None:
                metrics[m['name']] = {'value': value, 'unit': m['unit']}
        device.update(busy_s=trace.busy_s(), window_s=trace.window_s)
        breakdown = {'device_ops': trace.device_ops(),
                     'idle_gaps': trace.idle_gaps()}
        print(f'traced {n} calls: {trace.launches} device operations, '
              f'busy {trace.busy_s():.4f} s of {trace.window_s:.4f} s',
              flush=True)
    else:
        metrics = {m['name']: {'value': end_to_end(m['name'], setup_s,
                                                   frames, window_s,
                                                   latencies),
                               'unit': m['unit']}
                   for m in metrics_of(spec, args.workload, 'end_to_end')}
    device['memory_peak_bytes'] = torch.cuda.max_memory_allocated()
    print(f'peak device memory {device["memory_peak_bytes"] / 2**30:.3f} '
          f'GiB; card: {card_line()}', flush=True)

    cell.free_program()
    t = time.perf_counter()
    values = cell.check()
    correct, checks = check.judge(values, cell_spec['cell']['limits'])
    print(f'check {time.perf_counter() - t:.2f} s', flush=True)
    for name, c in checks.items():
        print(f'{name} {c["value"]!r} limit {c["limit"]!r}', file=sys.stderr)
    # the last step before the result, so that what the check loaded counts
    found = forbidden_loaded()
    if found:
        print(f'loaded in this process: {", ".join(found)}', file=sys.stderr)
        return 3
    result = {'correct': correct, 'attempted': attempted, 'failed': 0,
              'metrics': metrics, 'device': device}
    if breakdown is not None:
        result['breakdown'] = breakdown
    result['checks'] = checks
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def main(argv=None) -> int:
    return run(parse(argv))


if __name__ == '__main__':
    sys.exit(main())
