#!/usr/bin/env python3
"""Where kernel (b) `mbconv_se` spends its time, by letting it end early.

    python3 scripts/torch_probe_se_phases.py [--seed N]

The script builds `csrc/mbconv.cu` as it is and with one textual patch each
that makes every thread return at a point further down the kernel:

  launch    right after the grid dependency resolves: what a dependent
            cluster launch costs with nothing in it;
  loads     after the tile sums are read and the group sums stored;
  partials  after the channel sums (and, where the channels are split, the
            mean, the wait for the weights and the first GEMV), with the
            parts stored in this CTA only: everything before the exchange;
  exchange  after the parts are pushed to every CTA and the cluster's
            barrier is passed;
  gemv1     before the second GEMV;
  full      the kernel as it is.

Each variant is timed at D2@768 blocks 0, 8, 12, 17 and 22, batch 8, at the
plan `se_plan` chooses, as CUDA events around replays of a CUDA graph of 20
launches of (b). A cut variant computes garbage; only its time is read, and
the difference of two neighbours is what the phase between them costs.
Needs one NVIDIA GPU and nvcc. Prints the card and one JSON line per block
(ms).
"""
import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from mm_distillnet_torch.models.efficientnet import (MBConvBlock,  # noqa: E402
                                                     expand_block_args)
from mm_distillnet_torch.ops import cuda_build  # noqa: E402
from mm_distillnet_torch.ops import fused_mbconv as fm  # noqa: E402

_RETURN = '  if (hw > 0) return;\n'
_BARRIER = '    cluster_arrive();\n    cluster_wait();\n'
_LOCAL_PUSH = (
    '  auto push = [&](int slot, float v) {\n'
    '    for (int q = 0; q < ranks; ++q)\n'
    '      st_shared_cluster(map_shared_rank(part_a + slot * 4, q), v);\n'
    '  };',
    '  auto push = [&](int slot, float v) { part[rank * L.pw + slot] = v; };')
# variant -> [(text, replacement, times the text occurs)]
CUTS = {
    'launch': [('  griddep_wait();\n', '  griddep_wait();\n' + _RETURN, 1)],
    'loads': [('  __syncthreads();\n\n  // the G group sums',
               '  __syncthreads();\n' + _RETURN + '\n  // the G group sums',
               1)],
    'partials': [(*_LOCAL_PUSH, 1),
                 (_BARRIER, '  ' + _RETURN + _BARRIER, 2)],
    'exchange': [(_BARRIER, _BARRIER + '  ' + _RETURN, 2)],
    'gemv1': [('  // ---- expand GEMV + sigmoid',
               _RETURN + '  // ---- expand GEMV + sigmoid', 1)],
    'full': [],
}
BLOCKS = (0, 8, 12, 17, 22)


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


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--seed', type=int, default=0)
    a = p.parse_args()
    if not torch.cuda.is_available():
        print('no CUDA device', file=sys.stderr)
        return 1
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    device = torch.device('cuda', 0)
    blocks = expand_block_args(2)
    cases = {}
    h = 384
    for i, args in enumerate(blocks):
        hin, h = h, h // args.stride
        if i not in BLOCKS:
            continue
        torch.manual_seed(a.seed + i)
        f = fm.fold_mbconv(MBConvBlock(args).eval().state_dict(), args,
                           device)
        x = torch.randn((8, hin, hin, args.input_filters),
                        device=device).to(torch.bfloat16)
        d, sums = fm.expand_dw(x, f, args)
        cases[i] = (sums, f, d.shape[1] * d.shape[2])
    torch.cuda.synchronize()

    csrc = cuda_build.CSRC
    source = (csrc / 'mbconv.cu').read_text()
    times = {i: {} for i in BLOCKS}
    for name, cuts in CUTS.items():
        text = source
        for old, new, count in cuts:
            if text.count(old) != count:
                raise SystemExit(f'{name}: patch target not found {count}x')
            text = text.replace(old, new)
        tmp = Path(tempfile.mkdtemp(prefix=f'probe_se_{name}_'))
        for other in csrc.iterdir():      # the other sources and headers
            if other.name != 'mbconv.cu':
                (tmp / other.name).write_text(other.read_text())
        (tmp / 'mbconv.cu').write_text(text)
        cuda_build.CSRC = tmp
        cuda_build.BUILD_DIR = tmp
        cuda_build._LIBS.clear()
        fm._FUNCTIONS.clear()             # the wrappers' cached handles
        for i, (sums, f, hw) in cases.items():
            times[i][name] = graph_ms(lambda: fm.se_gate(sums, f, hw))
    for i in BLOCKS:
        sums, f, _ = cases[i]
        plan = fm.se_plan(sums.shape[1], sums.shape[2], f.w_se1.shape[0])
        print(json.dumps({'block': i, 'plan': list(plan),
                          **{k: round(v, 5) for k, v in times[i].items()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
