#!/usr/bin/env python3
"""Device time of the three MBConv kernels of mm_distillnet_torch at the 23
block shapes of EfficientDet-D2 at 768 px, batch 8, for one checkout.

    python3 scripts/torch_time_mbconv_kernels.py [--tree PATH] [--seed N]

PATH is the root of a checkout of the port (default: the one this script
lies in), so that two commits can be timed in turns inside one run:
unpack the other with `git archive <commit> | tar -x -C PATH`. Each kernel
is timed as CUDA events around three replays of a CUDA graph of 20
launches, which leaves the host's launch rate out; `block` is the three in
a row, 20 x [(a), (b), (c)], so it also holds what their boundaries cost.
Needs one NVIDIA GPU and nvcc. Prints the card, one JSON line per block and one of sums.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch


def graph_ms(fn, reps=20, replays=3):
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


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--tree', default=str(Path(__file__).resolve().parents[1]))
    p.add_argument('--seed', type=int, default=0)
    a = p.parse_args()
    if not torch.cuda.is_available():
        print('no CUDA device', file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(a.tree).resolve()))
    from mm_distillnet_torch.models.efficientnet import (MBConvBlock,
                                                         expand_block_args)
    from mm_distillnet_torch.ops import fused_mbconv as fm

    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip(), '|', a.tree)
    device = torch.device('cuda', 0)
    sums = {'a': 0.0, 'b': 0.0, 'c': 0.0, 'block': 0.0}
    h = 384
    for i, args in enumerate(expand_block_args(2)):
        torch.manual_seed(a.seed + i)
        block = MBConvBlock(args).to(device).eval()
        f = fm.fold_mbconv(block.state_dict(), args, device)
        x = torch.randn((8, h, h, args.input_filters),
                        device=device).to(torch.bfloat16)
        skip = x if fm.has_skip(args) else None
        d, tile_sums = fm.expand_dw(x, f, args)
        hw = d.shape[1] * d.shape[2]
        gate = fm.se_gate(tile_sums, f, hw)
        row = {'block': i,
               'a': graph_ms(lambda: fm.expand_dw(x, f, args)),
               'b': graph_ms(lambda: fm.se_gate(tile_sums, f, hw)),
               'c': graph_ms(lambda: fm.project(d, gate, f, skip)),
               'block': graph_ms(lambda: fm.mbconv_fused(x, f, args))}
        for k in sums:
            sums[k] += row[k]
        print(json.dumps({k: round(v, 5) for k, v in row.items()}))
        h //= args.stride
    print(json.dumps({'sum_ms': sums}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
