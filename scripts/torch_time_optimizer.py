#!/usr/bin/env python3
"""Device time of one optimizer update over the EfficientDet-D2 audio
student's parameters, for each of torch.optim's implementations.

    python3 scripts/torch_time_optimizer.py [--optimizer Adam] [--reps 20]

Builds the student (8 input channels, 20 classes) on the card in fp32,
fills every .grad from a seeded generator, and for each implementation
('foreach': a multi-tensor kernel per elementwise step; 'fused': one
kernel for the whole update) times `reps` updates with CUDA events after
two warm-ups, and counts the kernels of one update with torch.profiler.
Prints one JSON line beside the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from mm_distillnet_torch.models.efficientdet import EfficientDet  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--optimizer', default='Adam', choices=['Adam', 'AdamW'])
    p.add_argument('--reps', type=int, default=20)
    a = p.parse_args()
    if not torch.cuda.is_available():
        print('needs a CUDA device', file=sys.stderr)
        return 1
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True).stdout.strip()
    torch.manual_seed(0)
    model = EfficientDet(20, 2, 8).cuda()
    params = list(model.parameters())
    g = torch.Generator(device='cuda').manual_seed(1)
    for q in params:
        q.grad = torch.randn(q.shape, generator=g, device='cuda') * 1e-3
    n = sum(q.numel() for q in params)
    out = {'card': card, 'optimizer': a.optimizer, 'tensors': len(params),
           'values': n}
    cls = getattr(torch.optim, a.optimizer)
    for impl in ('foreach', 'fused'):
        opt = cls(params, lr=1e-4, **{impl: True})
        for _ in range(2):
            opt.step()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(a.reps):
            opt.step()
        end.record()
        torch.cuda.synchronize()
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            opt.step()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        out[impl] = {'ms': start.elapsed_time(end) / a.reps,
                     'launches': sum(e.count for e in kernels),
                     'top': sorted(((e.key[:60], e.count,
                                     e.self_device_time_total / 1e3)
                                    for e in kernels),
                                   key=lambda r: -r[2])[:5]}
    # bytes one update must move: p, grad, m, v read; p, m, v written
    out['bound_ms'] = 7 * 4 * n / 3.35e12 * 1e3
    print(json.dumps(out))
    return 0


if __name__ == '__main__':
    sys.exit(main())
