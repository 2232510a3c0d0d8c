#!/usr/bin/env python3
"""Where kernel (a) `mbconv_expand_dw` spends its time, by cutting one phase
out at a time.

    python3 scripts/torch_probe_expand_dw_phases.py --tree PATH [--design D]

`--design first` probes the first (mma.sync, 8x8 tile, 32-channel CTA)
version: PATH is a checkout of the commit that holds it (`git archive
d255ba9 | tar -x -C PATH`), the source `csrc/mbconv.cu`, the cuts the weight
transpose + halo load, the expand MMAs with their epilogue, and the
depthwise taps. `--design hopper` (PATH defaults to this checkout) probes
`csrc/mbconv_expand_dw.cu`: the cuts are the swish of the expand epilogue,
the whole epilogue, the depthwise, the copy-out, and all of them (what is
left is loads, GEMM and barriers). The script builds the source as it is and
with each cut made by a textual patch, and times kernel (a) with CUDA events
at D2@768 blocks 2, 3, 6, 13, 17 and 22, batch 8. A cut variant computes
garbage; only its time is read. full - variant is what the phase costs on
top of the others. Needs one NVIDIA GPU and nvcc. Prints one JSON line per
block.
"""
import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

_NO_SWISH = [(
    'v = pack_bf16(swish_f(acc[gi][4 * jn + 2 * h] + bias.x),\n'
    '                          swish_f(acc[gi][4 * jn + 2 * h + 1] + bias.y));',
    'v = pack_bf16(acc[gi][4 * jn + 2 * h] + bias.x,\n'
    '                          acc[gi][4 * jn + 2 * h + 1] + bias.y);')]
_NO_EPILOGUE = [('      wgmma_wait();\n      epilogue(j);\n',
                 '      wgmma_wait();\n')]
_NO_DW = [('         item < G::NITEMS; item += THREADS) {',
           '         item < (int)(x == nullptr); item += THREADS) {')]
_NO_COPY = [('    if (i > 0) copy_out(i - 1);\n', '')]
HOPPER_CUTS = {
    'full': [],
    'no_swish': _NO_SWISH,
    'no_epilogue': _NO_EPILOGUE,
    'no_dw': _NO_DW,
    'no_copy': _NO_COPY,
    'no_work': _NO_EPILOGUE + _NO_DW + _NO_COPY,
}
CUTS = {
    'full': [],
    'no_setup': [('for (int i = tid; i < kp * CC; i += THREADS) {',
                  'for (int i = tid; i < 0; i += THREADS) {'),
                 ('for (int i = tid; i < NP * vec; i += THREADS) {',
                  'for (int i = tid; i < 0; i += THREADS) {')],
    'no_mma': [('for (int p0 = warp * 16; p0 < NP; p0 += 16 * (THREADS / 32)) {',
                'for (int p0 = warp * 16; p0 < 0; p0 += 16) {')],
    'no_dw': [('  for (int dy = 0; dy < K; ++dy) {\n    const float* row',
               '  for (int dy = 0; dy < (int)(b_dw == nullptr); ++dy) {\n'
               '    const float* row')],
}
BLOCKS = (2, 3, 6, 13, 17, 22)


def time_ms(fn, reps=20, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--tree', default=str(Path(__file__).resolve().parents[1]))
    p.add_argument('--design', choices=('first', 'hopper'), default='hopper')
    a = p.parse_args()
    if not torch.cuda.is_available():
        print('no CUDA device', file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(a.tree).resolve()))
    from mm_distillnet_torch.models.efficientnet import (MBConvBlock,
                                                         expand_block_args)
    from mm_distillnet_torch.ops import cuda_build
    from mm_distillnet_torch.ops import fused_mbconv as fm

    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip())
    stem = 'mbconv' if a.design == 'first' else 'mbconv_expand_dw'
    cuts_by_name = CUTS if a.design == 'first' else HOPPER_CUTS
    csrc = Path(a.tree) / 'mm_distillnet_torch/csrc'
    source = (csrc / f'{stem}.cu').read_text()
    device = torch.device('cuda', 0)
    blocks = expand_block_args(2)
    shapes = {}
    h = 384
    for i, args in enumerate(blocks):
        shapes[i] = h
        h //= args.stride
    times = {i: {} for i in BLOCKS}
    for name, cuts in cuts_by_name.items():
        text = source
        for old, new in cuts:
            if text.count(old) != 1:
                raise SystemExit(f'{name}: patch target not found once')
            text = text.replace(old, new)
        tmp = Path(tempfile.mkdtemp(prefix=f'probe_{name}_'))
        for other in csrc.iterdir():      # the other sources and headers
            if other.name != f'{stem}.cu':
                (tmp / other.name).write_text(other.read_text())
        (tmp / f'{stem}.cu').write_text(text)
        cuda_build.CSRC = tmp
        cuda_build.BUILD_DIR = tmp
        cuda_build._LIBS.clear()
        fm._LIB = None                    # the wrappers' cached handles
        getattr(fm, '_FUNCTIONS', {}).clear()
        for i in BLOCKS:
            args = blocks[i]
            torch.manual_seed(i)
            block = MBConvBlock(args).to(device).eval()
            f = fm.fold_mbconv(block.state_dict(), args, device)
            x = torch.randn((8, shapes[i], shapes[i], args.input_filters),
                            device=device).to(torch.bfloat16)
            times[i][name] = time_ms(lambda: fm.expand_dw(x, f, args))
    for i in BLOCKS:
        t = times[i]
        print(json.dumps({'block': i, **{k: round(v, 4) for k, v in t.items()},
                          **{f'cost_{k[3:]}': round(t['full'] - v, 4)
                             for k, v in t.items() if k != 'full'}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
