#!/usr/bin/env python3
"""Smoke run of the PyTorch port (mm_distillnet_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--batch N]

Phases, each of which fails the run on any error:
  1. environment: the card's name and power limit (nvidia-smi), versions;
  2. build: nvcc of every mm_distillnet_torch/csrc/*.cu, one process each,
     all started together (timed);
  3. kernels: at each of the 23 MBConv block shapes of EfficientDet-D2 at
     768 px, at the serving batch, with seeded folded weights, each CUDA
     kernel (expand+depthwise, SE, project) and the whole block are held
     against their plain PyTorch versions on the same inputs (bf16 outputs
     at rtol = atol = 2e-2 and correlation > 0.9999; the fp32 SE gate at
     rtol = atol = 1e-4; the tile sums and the gates of two launches
     bit-equal) and timed
     beside their bound: device time, CUDA events around replays of a CUDA
     graph of 20 launches, so that the host's launch rate (about 20 us a
     launch) does not floor the reading;
  4. slice: a D2 audio student (8 channels, 20 classes, seeded weights, BN
     statistics from one train-mode pass) served at 768 px through
     make_serving_fn / serve_many (requests of 8 and 13 images at batch
     8). With every launch count set to 0 just before and read just after,
     each kernel must have run 23 times per batch; outputs must be finite
     with at least one valid detection. The kernel plan must agree with
     the same predictor running the blocks' plain versions (correlation >
     0.999 on every output, > 0.998 on the bf16 scores, >= 90% of
     detections within 1 px, same class). Against the unfused fp32 plan
     it must correlate at least as well as the unfused bf16 plan
     ('flax:0-22') and match at least 95% as many detections. Serving
     time at the batch is measured, and torch.profiler gives the kernel
     time by name and the device's busy share for the serve, the forward
     and the backbone, and the backbone device time of the unfused bf16
     plan (a sequence of cuDNN and elementwise library calls per block;
     the port never routes through it) as a yardstick for the whole block.
  5. teachers: three seeded D2 teachers (rgb 3, thermal 1, depth 3 input
     channels) and the seeded student (each with BN statistics from the
     frames it will see) at 768 px, batch 8, config
     fused_inference=True, on a SyntheticMultimodal of 16 frames with the
     compact audio ingest (80 mel rows, stretched on the card). One call of
     make_fused_teacher_fn's function must launch each kernel 69 times,
     one call of make_predict_fn's 23 times (counts set to 0 just before,
     read just after). The fused labels must be (8, 64, 5), finite, with
     integer coordinates in [0, 768], label -1 and zero boxes on padded
     rows and at least one valid row. Every block of every network is
     held against its plain version on the activations it meets on this
     path (the kernel phase's gates). The synthetic frames are smooth and
     seeded detectors score whole neighbourhoods alike, so two bf16 paths
     share few label rows to the pixel and an absolute gate on the labels
     cannot hold: the kernel plan must agree with the plain-version plan
     (correlation of the outputs; fused rows found within 1 px and at IoU
     0.5, same label) at least as well as the unfused bf16 modules do.
     evaluate() runs end to end, writes
     both CSV files and returns finite numbers. Host ms, device ms,
     launches and busy share of one teacher-function call and of one
     evaluate batch, and evaluate()'s frames/s, are printed beside the
     card's name and power limit.
  6. train: the shipped recipe (configs/mm-distillnet.cfg:
     traditional_nms_augmented, MTALoss, w_kd 0.005, T 9, p 2, Adam at lr
     1e-4) at D2@768, batch 8, fused_inference=True, bf16 compute: three
     seeded teachers and the seeded student on a fixed batch of
     SyntheticMultimodal frames (compact audio). One step must launch each
     kernel 69 times (counts set to 0 just before, read just after); over 8
     steps of Adam every loss is finite, the student's parameters change
     and the last total loss is below the first; the MTA loss from the
     kernel plan's teacher features must agree with the plain-version
     plan's (relative MTA_RTOL). Host ms, device busy ms, launches and busy
     share of the step, of its teacher half, of the student's forward +
     losses + backward and of the optimizer, and the step's peak device
     memory, are printed beside the card's name and power limit. train()
     then runs one fast-run epoch (2 steps, 2 validation batches, 69
     launches of each kernel per batch) and writes a checkpoint under
     chiprun_out/train_smoke/, which must restore the epoch, the best
     loss, the scheduler's state and the student;
  7. report: one JSON line of kernel results (launches summed over the
     serving, teacher and train phases), then as the last line
     {"ok": true, "device": {...}}.

Per-block numbers go to chiprun_out/chip_smoke.json. Without a CUDA device
the script exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import csv
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from mm_distillnet_torch.config import (compute_dtype_from, config_from_dict,
                                        default_config, load_config,
                                        transfer_dtype_from)
from mm_distillnet_torch.data.base import (prediction_to_label_lut,
                                           valid_prediction_ids)
from mm_distillnet_torch.data.loader import collate
from mm_distillnet_torch.data.synthetic import SyntheticMultimodal
from mm_distillnet_torch.distill import train_step as ts
from mm_distillnet_torch.evaluation import (evaluate, make_fused_teacher_fn,
                                            make_predict_fn)
from mm_distillnet_torch.losses.mta import attention_map, mta_loss
from mm_distillnet_torch.models import fused_forward
from mm_distillnet_torch.models.efficientdet import EfficientDet
from mm_distillnet_torch.models.efficientnet import (MBConvBlock,
                                                     expand_block_args)
from mm_distillnet_torch.ops import cuda_build
from mm_distillnet_torch.ops.boxes import pairwise_iou_xyxy
from mm_distillnet_torch.ops import fused_mbconv as fm
from mm_distillnet_torch.ops.anchors import anchor_table
from mm_distillnet_torch.ops.postprocess import class_validity_table
from mm_distillnet_torch.ops.resize import maybe_stretch_mel_axis
from mm_distillnet_torch.serving import make_serving_fn, serve_many
from mm_distillnet_torch.train import checkpoint, trainer
from mm_distillnet_torch.train.optim import apply_gradients, build_scheduler

IMAGE_SIZE = 768
IN_CHANNELS = 8
NUM_CLASSES = 20
TEACHERS = ('rgb', 'thermal', 'depth')
BLOCKS = 23   # MBConv blocks of EfficientDet-D2: launches per forward
SOURCES = {'mbconv_expand_dw': 'mm_distillnet_torch/csrc/mbconv_expand_dw.cu',
           'mbconv_se': 'mm_distillnet_torch/csrc/mbconv.cu',
           'mbconv_project': 'mm_distillnet_torch/csrc/mbconv_project.cu'}
REPLACES = 'mm_distillnet_tpu/ops/pallas_mbconv.py:137'
OUT_DIR = Path(__file__).resolve().parent / 'chiprun_out'
RECIPE = Path(__file__).resolve().parent / 'configs' / 'mm-distillnet.cfg'
# kernel plan against plain-version plan: the largest relative difference
# of one teacher's MTA loss at one level (seeds 0-2: 1.04e-7, 1.98e-7,
# 1.32e-7; PERF.md)
MTA_RTOL = 2e-6
# the kernels of csrc/mbconv*.cu by their names in a profiler trace
KERNEL_NAMES = {'mbconv_expand_dw': re.compile(r'\b(expand_dw_kernel|dw_only_kernel)\b'),
                'mbconv_se': re.compile(r'\bse_kernel\b'),
                'mbconv_project': re.compile(r'\bproject_kernel\b')}


def card_line() -> str:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of fn() over `reps` calls, with CUDA events."""
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


def graph_ms(fn, reps: int = 20, replays: int = 3) -> float:
    """Mean device time of fn(): a CUDA graph of `reps` calls, replayed."""
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


def host_ms(fn, reps: int) -> float:
    """Median host time of fn() ending in a synchronize."""
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def _union_us(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    busy, last_end = 0.0, float('-inf')
    for start, end in sorted(intervals):
        if end > last_end:
            busy += end - max(start, last_end)
            last_end = end
    return busy


def _on_device(event) -> bool:
    """A kernel or copy on the card; not a user annotation such as the
    optimizer's `Optimizer.step#Adam.step`, which the trace also places on
    the device's timeline, spanning the step's gaps."""
    return (event.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(event, 'is_user_annotation', False)
            and not event.key.startswith('Optimizer.'))


def device_breakdown(fn, reps: int = 3) -> dict:
    """CUDA kernel time over `reps` calls of fn (torch.profiler), per call:
    `busy_ms` is the time in which at least one kernel ran (the union of the
    kernels' intervals), `kernel_ms` the sum of their durations, also by
    name. A kernel launched as a programmatic dependent starts before the
    kernel ahead of it ends and waits for it, so its duration overlaps that
    kernel's and the sum exceeds the busy time. Without device events in
    the trace the result says so."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if _on_device(e)]
    sum_us = sum(e.self_device_time_total for e in kernels)
    if sum_us == 0:
        return {'measured': False}
    busy_us = _union_us(
        (e.time_range.start, e.time_range.end) for e in prof.events()
        if _on_device(e))
    by_kernel = {n: sum(e.self_device_time_total for e in kernels
                        if pat.search(e.key)) / reps / 1e3
                 for n, pat in KERNEL_NAMES.items()}
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    return {'measured': True,
            'busy_ms': busy_us / reps / 1e3,
            'kernel_ms': sum_us / reps / 1e3,
            'mbconv_kernel_ms': sum(by_kernel.values()),
            'by_kernel_ms': by_kernel,
            'launches': sum(e.count for e in kernels) / reps,
            'top': [{'name': e.key[:96],
                     'ms': e.self_device_time_total / reps / 1e3,
                     'launches': e.count / reps} for e in top]}


def corr(a: torch.Tensor, b: torch.Tensor) -> float:
    a = a.double().flatten()
    b = b.double().flatten()
    a = a - a.mean()
    b = b - b.mean()
    return float((a @ b) / (a.norm() * b.norm()))


def check_bf16(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2, msg=lambda m: f'{name}: {m}')
    c = corr(got, want)
    if not c > 0.9999:
        raise AssertionError(f'{name}: correlation {c} <= 0.9999')
    return float((got.float() - want.float()).abs().max())


def seeded_block(args, seed: int, device) -> MBConvBlock:
    """MBConvBlock with torch's default init from `seed` and non-trivial
    BN statistics, in eval mode."""
    torch.manual_seed(seed)
    block = MBConvBlock(args)
    g = torch.Generator().manual_seed(seed)
    for m in block.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            n = m.num_features
            m.running_mean.copy_(torch.randn(n, generator=g) * 0.1)
            m.running_var.copy_(torch.rand(n, generator=g) + 0.5)
            m.weight.data.copy_(torch.rand(n, generator=g) * 0.4 + 0.8)
            m.bias.data.copy_(torch.randn(n, generator=g) * 0.1)
    return block.to(device).eval()


def kernel_phase(batch: int, seed: int, device):
    """Each kernel against its plain version at the 23 D2@768 shapes."""
    names = list(fm.launches)
    totals = {n: {'ms': 0.0, 'plain_ms': 0.0, 'bound_ms': 0.0,
                  'bound_bytes_ms': 0.0, 'max_abs_err': 0.0} for n in names}
    rows = []
    h = IMAGE_SIZE // 2
    g = torch.Generator(device=device).manual_seed(seed)
    for i, args in enumerate(expand_block_args(2)):
        block = seeded_block(args, seed + i, device)
        f = fm.fold_mbconv(block.state_dict(), args, device)
        x = torch.randn((batch, h, h, args.input_filters), generator=g,
                        device=device).to(torch.bfloat16)
        skip = x if fm.has_skip(args) else None

        d, sums = fm.expand_dw(x, f, args)
        torch.cuda.synchronize()
        d_ref, sums_ref = fm.expand_dw_reference(x, f, args)
        hw = d.shape[1] * d.shape[2]
        err_a = check_bf16(f'block {i} expand_dw', d, d_ref)
        torch.testing.assert_close(sums.sum(1) / hw, sums_ref.sum(1) / hw,
                                   rtol=2e-2, atol=2e-2)
        d_again, sums_again = fm.expand_dw(x, f, args)
        if not (torch.equal(sums, sums_again) and torch.equal(d, d_again)):
            raise AssertionError(f'block {i}: two launches of expand_dw '
                                 'differ; the SE sums must be reproducible')
        gate = fm.se_gate(sums, f, hw)
        torch.cuda.synchronize()
        gate_ref = fm.se_gate_reference(sums, f, hw)
        torch.testing.assert_close(gate, gate_ref, rtol=1e-4, atol=1e-4)
        if not torch.equal(gate, fm.se_gate(sums, f, hw)):
            raise AssertionError(f'block {i}: two launches of se_gate '
                                 'differ; its sums have a fixed order')
        err_b = float((gate - gate_ref).abs().max())
        out = fm.project(d, gate, f, skip)
        torch.cuda.synchronize()
        err_c = check_bf16(f'block {i} project', out,
                           fm.project_reference(d, gate, f, skip))
        y = fm.mbconv_fused(x, f, args)
        y_ref = fm.mbconv_fused_reference(x, f, args)
        err_block = check_bf16(f'block {i} whole', y, y_ref)
        differ = float((y != y_ref).float().mean())

        ms = {'mbconv_expand_dw': graph_ms(lambda: fm.expand_dw(x, f, args)),
              'mbconv_se': graph_ms(lambda: fm.se_gate(sums, f, hw)),
              'mbconv_project': graph_ms(
                  lambda: fm.project(d, gate, f, skip))}
        plain = {
            'mbconv_expand_dw': time_ms(
                lambda: fm.expand_dw_reference(x, f, args), 5, 1),
            'mbconv_se': time_ms(
                lambda: fm.se_gate_reference(sums, f, hw), 5, 1),
            'mbconv_project': time_ms(
                lambda: fm.project_reference(d, gate, f, skip), 5, 1)}
        bounds = fm.bounds(args, batch, h, h)
        errs = {'mbconv_expand_dw': err_a, 'mbconv_se': err_b,
                'mbconv_project': err_c}
        for n in names:
            t = totals[n]
            t['ms'] += ms[n]
            t['plain_ms'] += plain[n]
            t['bound_ms'] += bounds[n][0]
            if bounds[n][1] == 'bytes':
                t['bound_bytes_ms'] += bounds[n][0]
            t['max_abs_err'] = max(t['max_abs_err'], errs[n])
        row = {'block': i, 'k': args.kernel_size, 's': args.stride,
               'cin': args.input_filters, 'co': args.output_filters,
               'ce': args.input_filters * args.expand_ratio, 'h': h,
               'ms': ms, 'plain_ms': plain,
               'bound_ms': {n: bounds[n][0] for n in names},
               'bound_by': {n: bounds[n][1] for n in names},
               'max_abs_err': errs, 'block_max_abs_err': err_block,
               'block_share_differing': differ}
        rows.append(row)
        print(f'block {i:2d} k{args.kernel_size} s{args.stride} '
              f'{args.input_filters:3d}->{args.output_filters:3d} '
              f'ce {row["ce"]:4d} h {h:3d} | '
              + ' '.join(f'{n[7:]} {ms[n]:.4f}/{bounds[n][0]:.4f}ms'
                         for n in names)
              + f' | err {err_block:.3g} differ {differ:.2e}', flush=True)
        h //= args.stride
    return totals, rows


def seeded_detector(seed: int, batch: int, device,
                    calib: torch.Tensor = None) -> EfficientDet:
    """D2 detector from `seed`; BN running statistics from one no-grad
    train-mode pass (momentum None: the pass's own statistics) over
    `calib`, a batch (B, H, W, C) of the inputs it will see, or, without
    one, over seeded noise with the audio student's 8 channels. So eval
    activations keep their scale through the depth."""
    torch.manual_seed(seed)
    in_channels = IN_CHANNELS if calib is None else calib.shape[-1]
    model = EfficientDet(NUM_CLASSES, 2, in_channels).to(device)
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    for m in bns:
        m.reset_running_stats()
        m.momentum = None
    if calib is None:
        g = torch.Generator(device=device).manual_seed(seed + 1)
        calib = torch.randn((batch, IMAGE_SIZE, IMAGE_SIZE, in_channels),
                            generator=g, device=device)
    x = calib.float()
    model.train()
    with torch.no_grad():
        model(x, generator=torch.Generator(device=device).manual_seed(seed))
    for m in bns:
        m.momentum = 0.01
    return model.eval()


def agreement(a, b) -> dict:
    """Correlation of two DetectorOutputs, field by field."""
    out = {f: corr(getattr(a, f), getattr(b, f))
           for f in ('classification', 'regression', 'logits')}
    out.update({f'feature_{i}': corr(u, v)
                for i, (u, v) in enumerate(zip(a.features, b.features))})
    return out


def match_detections(ref, got, tol_px: float = 1.0, min_iou=None):
    """(matched, total): ref's valid detections that got has with the same
    class and every box coordinate within tol_px (or, with min_iou, an IoU
    of at least min_iou)."""
    total = matched = 0
    for b in range(ref.valid.shape[0]):
        rv = ref.valid[b]
        gv = got.valid[b]
        rb, rc = ref.boxes[b][rv], ref.classes[b][rv]
        gb, gc = got.boxes[b][gv], got.classes[b][gv]
        total += rb.shape[0]
        if rb.shape[0] and gb.shape[0]:
            if min_iou is None:
                near = (rb[:, None] - gb[None]).abs().amax(-1) <= tol_px
            else:
                near = pairwise_iou_xyxy(rb, gb) >= min_iou
            matched += int((near & (rc[:, None] == gc[None])).any(1).sum())
    return matched, total


@contextlib.contextmanager
def plain_blocks():
    """Run the fused backbone's blocks through their plain version."""
    saved = fused_forward.mbconv_fused
    fused_forward.mbconv_fused = fm.mbconv_fused_reference
    try:
        yield
    finally:
        fused_forward.mbconv_fused = saved


def slice_phase(batch: int, seed: int, device):
    model = seeded_detector(seed, batch, device)
    sd = model.state_dict()
    t = time.perf_counter()
    serve = make_serving_fn(model, sd, IMAGE_SIZE, device=device)
    setup_s = time.perf_counter() - t
    rng = np.random.default_rng(seed + 2)
    images = rng.standard_normal(
        (13, IMAGE_SIZE, IMAGE_SIZE, IN_CHANNELS), dtype=np.float32)

    # the main path: every count 0 just before, read just after
    fm.reset_launches()
    first = serve(images[:batch])
    requests = {n: serve_many(serve, images[:n], batch) for n in (8, 13)}
    torch.cuda.synchronize()
    counts = dict(fm.launches)
    n_batches = 1 + sum(-(-n // batch) for n in requests)
    for name, c in counts.items():
        if c != BLOCKS * n_batches:
            raise AssertionError(f'{name} launched {c} times, expected '
                                 f'{BLOCKS} x {n_batches} batches')

    for n, dets in requests.items():
        assert dets.boxes.shape == (n, 100, 4), dets.boxes.shape
        assert np.isfinite(dets.boxes).all() and np.isfinite(dets.scores).all()
    assert torch.isfinite(first.boxes).all()
    n_valid = int(first.valid.sum())
    if n_valid == 0:
        raise AssertionError('no valid detection in the first batch')
    first_np = [t.cpu().numpy() for t in first]
    r13 = requests[13]
    np.testing.assert_array_equal(r13.valid[:batch], first_np[3])
    np.testing.assert_allclose(r13.boxes[:batch], first_np[0], atol=1e-3)

    x = torch.as_tensor(images[:batch], device=device)
    # (i) the kernel plan against the same predictor with each fused block
    # computed by its plain version on the card
    out_k = serve.forward(x)
    det_k = serve(x)
    with plain_blocks():
        out_p = serve.forward(x)
        det_p = serve(x)
    agree = agreement(out_k, out_p)
    matched = {'1px': match_detections(det_p, det_k),
               'iou0.5': match_detections(det_p, det_k, min_iou=0.5)}
    print(f'kernel vs plain-version plan: corr {json.dumps(agree)}; '
          f'detections matched {json.dumps(matched)}', flush=True)

    # (ii) against the unfused plan ('flax:0-22') in fp32, beside the
    # unfused plan in bf16: two bf16 paths through a seeded-weight D2 drift
    # apart with depth, so the unfused fp32 forward is the common reference
    serve_f32 = make_serving_fn(model, sd, IMAGE_SIZE, plan_spec='flax:0-22',
                                dtype=torch.float32, device=device)
    serve_f16 = make_serving_fn(model, sd, IMAGE_SIZE, plan_spec='flax:0-22',
                                device=device)
    out_f32 = serve_f32.forward(x)
    vs_f32 = {'kernel_bf16': agreement(out_k, out_f32),
              'unfused_bf16': agreement(serve_f16.forward(x), out_f32)}
    det_f32 = serve_f32(x)
    det_f16 = serve_f16(x)
    det_match = {'kernel_bf16': {
                     '1px': match_detections(det_f32, det_k),
                     'iou0.5': match_detections(det_f32, det_k, min_iou=0.5)},
                 'unfused_bf16': {
                     '1px': match_detections(det_f32, det_f16),
                     'iou0.5': match_detections(det_f32, det_f16,
                                                min_iou=0.5)}}
    print(f'against the unfused fp32 plan: corr {json.dumps(vs_f32)}; '
          f'detections matched {json.dumps(det_match)}', flush=True)

    # serving time at the batch, input already on the card
    timing = {
        'serve_ms': host_ms(lambda: serve(x), 3),
        'serve_host_input_ms': host_ms(lambda: serve(images[:batch]), 3),
        'forward_ms': host_ms(lambda: serve.forward(x), 3),
        'backbone_ms': host_ms(lambda: serve.forward.backbone(x), 5),
        'unfused_serve_ms': host_ms(lambda: serve_f16(x), 3),
        'unfused_backbone_ms': host_ms(
            lambda: serve_f16.forward.backbone(x), 3),
    }
    timing['postprocess_ms'] = timing['serve_ms'] - timing['forward_ms']
    timing['images_per_s'] = batch * 1e3 / timing['serve_ms']
    print('serving D2@768 batch %d: %s' % (batch, json.dumps(timing)),
          flush=True)
    # where the device time goes: kernel time per call against the
    # unprofiled host time of the same call gives the device's busy share
    profiled = {'serve': device_breakdown(lambda: serve(x), 2),
                'forward': device_breakdown(lambda: serve.forward(x), 2),
                'backbone': device_breakdown(
                    lambda: serve.forward.backbone(x)),
                # the unfused bf16 plan's blocks: cuDNN convolutions and
                # elementwise library calls, several per block
                'unfused_backbone': device_breakdown(
                    lambda: serve_f16.forward.backbone(x), 2)}
    for part, p in profiled.items():
        if p['measured']:
            p['busy_share'] = p['busy_ms'] / timing[f'{part}_ms']
        print(f'profile {part}: ' + json.dumps(
            {k: v for k, v in p.items() if k != 'top'}), flush=True)
    if profiled['serve']['measured']:
        for row in profiled['serve']['top']:
            print(f"  {row['ms']:9.4f} ms {row['launches']:7.1f} x "
                  f"{row['name']}")

    # (i): corr > 0.999 on every output but the scores, > 0.998 on the
    # scores, and >= 90% of the plain-version plan's detections found
    # within 1 px with the same class. (Blocks differ from their plain
    # versions in ~3e-4 of elements by one bf16 ulp; the seeded network
    # amplifies that with depth and reorders detections at the saturated
    # 100-detection cap. The scores are a bf16 sigmoid, in steps of
    # 2^-9..2^-8 around 0.5, where seeded weights put nearly all of them.)
    for f, c in agree.items():
        floor = 0.998 if f == 'classification' else 0.999
        if not c > floor:
            raise AssertionError(f'kernel plan vs plain-version plan: {f} '
                                 f'correlation {c} <= {floor}')
    got, total = matched['1px']
    if total == 0 or got < 0.9 * total:
        raise AssertionError(f'only {got}/{total} detections matched')
    # (ii): the kernel plan is at least as close to the fp32 unfused plan
    # as the bf16 unfused plan is in correlation, and finds at least 95% as
    # many of its detections (seeds 0-2: 1.00-1.02x as many)
    for f in ('classification', 'regression', 'logits'):
        k, u = vs_f32['kernel_bf16'][f], vs_f32['unfused_bf16'][f]
        if not k >= u:
            raise AssertionError(f'{f}: kernel plan corr {k} to fp32 is '
                                 f'below the unfused bf16 plan\'s {u}')
    k, u = (det_match[p]['1px'][0] for p in ('kernel_bf16', 'unfused_bf16'))
    if not k >= 0.95 * u:
        raise AssertionError(f'kernel plan matches {k} fp32 detections, '
                             f'the unfused bf16 plan {u}')
    return {'counts': counts, 'n_batches': n_batches,
            'valid_detections_first_batch': n_valid,
            'kernel_vs_plain_plan': {'corr': agree, 'matched': matched},
            'vs_unfused_fp32': {'corr': vs_f32, 'matched': det_match},
            'setup_s': setup_s, 'timing': timing, 'profile': profiled}


def blockwise_check(name: str, backbone, x: torch.Tensor) -> list:
    """Every MBConv block of a fused backbone, kernels against the plain
    version on the same input, along the kernel plan's own forward from
    the network input x (B, H, W, C). Returns the blocks' max |difference|.

    The gates are the kernel phase's (rtol = atol = 2e-2, correlation >
    0.9999), but at most one element in a million may lie outside, within
    four times that tolerance: on image-like inputs a depthwise output can
    be large (one bf16 ulp at 8 is 2^-4), and where one such value rounds
    the other way its ulp passes through w_prj into an output near zero
    (seen once in 18.9 million elements: 0.027 at an output of 0.26)."""
    x = backbone.stem(x)
    errs = []
    for i, (_, args, f) in enumerate(backbone.plan):
        x = x.to(torch.bfloat16).contiguous()
        y = fm.mbconv_fused(x, f, args)
        want = fm.mbconv_fused_reference(x, f, args).float()
        diff = (y.float() - want).abs()
        tol = 2e-2 + 2e-2 * want.abs()
        outside = float((diff > tol).float().mean())
        c = corr(y, want)
        if outside > 1e-6 or bool((diff > 4 * tol).any()) or not c > 0.9999:
            raise AssertionError(
                f'{name} block {i} on its own activations: {outside:.3g} of '
                f'the elements outside rtol = atol = 2e-2, max |difference| '
                f'{float(diff.max()):.4g}, correlation {c}')
        errs.append(float(diff.max()))
        x = y
    return errs


def match_label_rows(ref: torch.Tensor, got: torch.Tensor,
                     tol_px: float = 1.0, min_iou=None):
    """(matched, total): ref's valid label rows [x1, y1, x2, y2, label]
    that got has with the same label and every coordinate within tol_px
    (or, with min_iou, an IoU of at least min_iou)."""
    total = matched = 0
    for r, g in zip(ref, got):
        r = r[r[:, 4] != -1]
        g = g[g[:, 4] != -1]
        total += r.shape[0]
        if r.shape[0] and g.shape[0]:
            if min_iou is None:
                near = ((r[:, None, :4] - g[None, :, :4]).abs().amax(-1)
                        <= tol_px)
            else:
                near = pairwise_iou_xyxy(r[:, :4], g[:, :4]) >= min_iou
            matched += int((near & (r[:, None, 4] == g[None, :, 4]))
                           .any(1).sum())
    return matched, total


def check_fused_labels(fused: torch.Tensor, batch: int, max_gt: int) -> int:
    """The fused pseudo-labels' contract; returns the number of valid rows."""
    if tuple(fused.shape) != (batch, max_gt, 5):
        raise AssertionError(f'fused labels have shape {tuple(fused.shape)}')
    if not torch.isfinite(fused).all():
        raise AssertionError('fused labels are not finite')
    boxes, labels = fused[..., :4], fused[..., 4]
    if not (torch.equal(boxes, boxes.round()) and boxes.min() >= 0
            and boxes.max() <= IMAGE_SIZE):
        raise AssertionError('fused boxes are not integers in [0, size]')
    padded = labels == -1
    if not (boxes[padded] == 0).all():
        raise AssertionError('padded rows carry boxes')
    if not ((labels >= 0) | padded).all():
        raise AssertionError('a label is neither a class nor -1')
    n_valid = int((~padded).sum())
    if n_valid == 0:
        raise AssertionError('no valid fused label')
    return n_valid


def expect_launches(what: str, per_kernel: int) -> dict:
    counts = dict(fm.launches)
    for name, c in counts.items():
        if c != per_kernel:
            raise AssertionError(f'{what}: {name} launched {c} times, '
                                 f'expected {per_kernel}')
    return counts


def teacher_phase(batch: int, seed: int, device, card: str):
    """Teachers through the kernels -> pseudo-labels -> evaluate()."""
    frames = 2 * batch
    config = default_config(
        image_size=IMAGE_SIZE, batch_size=batch, synthetic_size=frames,
        fused_inference=True, device_audio_resize=True, num_workers=4,
        use_rgb=True, use_thermal=True, use_depth=True, eval_devices=1,
        exp_name=str(OUT_DIR / 'eval_smoke'), rank=0)
    dataset = SyntheticMultimodal(config, 'test')
    samples = [dataset[i] for i in range(frames)]   # also fills its cache
    if samples[0]['audio'].shape[0] != 80:
        raise AssertionError('the compact audio ingest is off')
    host = collate(samples[:batch])
    inputs = {m: torch.as_tensor(host[m], device=device).to(torch.bfloat16)
              for m in (*TEACHERS, 'audio')}
    # each network's BN statistics come from the inputs it will see here
    teachers = {m: seeded_detector(seed + 10 + i, batch, device, inputs[m])
                for i, m in enumerate(TEACHERS)}
    student = seeded_detector(
        seed, batch, device, maybe_stretch_mel_axis(inputs['audio'],
                                                    IMAGE_SIZE))
    t_vars = {m: t.state_dict() for m, t in teachers.items()}
    s_vars = student.state_dict()
    vcd = dataset.valid_classes_dict
    class_valid = torch.as_tensor(class_validity_table(
        NUM_CLASSES, valid_prediction_ids(vcd)), device=device)
    lut = torch.as_tensor(prediction_to_label_lut(vcd, NUM_CLASSES),
                          device=device)
    t = time.perf_counter()
    teacher_fn = make_fused_teacher_fn(teachers, IMAGE_SIZE, config,
                                       teacher_variables=t_vars,
                                       device=device)
    predict = make_predict_fn(student, IMAGE_SIZE, config, variables=s_vars,
                              device=device)
    setup_s = time.perf_counter() - t

    # the main path: every count 0 just before, read just after
    fm.reset_launches()
    fused = teacher_fn(t_vars, inputs, class_valid, lut)
    torch.cuda.synchronize()
    counts = expect_launches('teacher function',
                             BLOCKS * len(TEACHERS))
    fm.reset_launches()
    rows, _ = predict(s_vars, inputs['audio'], class_valid, lut)
    torch.cuda.synchronize()
    for name, c in expect_launches('predict function', BLOCKS).items():
        counts[name] += c
    max_gt = config.getint('max_gt')
    n_valid = check_fused_labels(fused, batch, max_gt)
    if tuple(rows.shape) != (batch, config.getint('max_detections'), 6) \
            or not torch.isfinite(rows).all():
        raise AssertionError(f'predict rows: shape {tuple(rows.shape)}')

    # The synthetic frames are smooth, so a seeded detector's outputs vary
    # little over an image (logits of standard deviation about 0.1) and
    # whole neighbourhoods of anchors score alike, in bf16 steps of 2^-8:
    # rounding differences are then of the signal's own size, and two bf16
    # paths through the same weights correlate at 0.97-0.998 and share few
    # label rows to the pixel. So the kernels are held to their plain
    # versions block by block on this path's own activations (i), and the
    # whole path to a yardstick: it must agree with the plain-version plan
    # at least as well as another bf16 path, the unfused modules, does
    # (ii, iii).
    # (i) every block of every network on the activations it meets here
    agree = {}
    for m, model in {**teachers, 'audio': student}.items():
        sd = model.state_dict()
        forward = fused_forward.make_fused_predictor(model, sd, IMAGE_SIZE,
                                                     device=device)
        x = maybe_stretch_mel_axis(inputs[m], IMAGE_SIZE)
        errs = blockwise_check(m, forward.backbone, x)
        # (ii) the outputs: kernel plan and unfused bf16 modules against
        # the plain-version plan
        out_k = forward(x)
        with plain_blocks():
            out_p = forward(x)
        out_u = fused_forward.make_fused_predictor(
            model, sd, IMAGE_SIZE, plan_spec=f'flax:0-{BLOCKS - 1}',
            device=device)(x)
        agree[m] = {'kernel': agreement(out_k, out_p),
                    'unfused_bf16': agreement(out_u, out_p),
                    'block_max_abs_err': max(errs)}
        print(f'{m}: against the plain-version plan: corr '
              + json.dumps(agree[m]), flush=True)
        for f in ('classification', 'regression', 'logits'):
            k, u = agree[m]['kernel'][f], agree[m]['unfused_bf16'][f]
            if not k >= u:
                raise AssertionError(
                    f'{m}: {f}: kernel plan corr {k} to the plain-version '
                    f'plan is below the unfused bf16 modules\' {u}')

    # (iii) the fused labels, by the same yardstick
    unfused = make_fused_teacher_fn(
        teachers, IMAGE_SIZE,
        config_from_dict({**dict(config), 'fused_inference': False}),
        teacher_variables=t_vars, device=device)
    with plain_blocks():
        fused_plain = teacher_fn(t_vars, inputs, class_valid, lut)
    fused_unfused = unfused(t_vars, inputs, class_valid, lut)
    check_fused_labels(fused_plain, batch, max_gt)
    labels_match = {
        'kernel': {'1px': match_label_rows(fused_plain, fused),
                   'iou0.5': match_label_rows(fused_plain, fused,
                                              min_iou=0.5)},
        'unfused_bf16': {'1px': match_label_rows(fused_plain, fused_unfused),
                         'iou0.5': match_label_rows(fused_plain,
                                                    fused_unfused,
                                                    min_iou=0.5)}}
    print(f'fused labels: {n_valid} valid rows; found among the '
          f'plain-version plan\'s: {json.dumps(labels_match)}', flush=True)
    for how in ('1px', 'iou0.5'):
        k, u = (labels_match[p][how][0] for p in ('kernel', 'unfused_bf16'))
        if k < u:
            raise AssertionError(
                f'fused labels ({how}): the kernel plan matches {k} rows of '
                f'the plain-version plan, the unfused bf16 path {u}')

    def eval_batch():
        predict(s_vars, inputs['audio'], class_valid, lut)
        teacher_fn(t_vars, inputs, class_valid, lut)

    parts = {'teacher_fn': lambda: teacher_fn(t_vars, inputs, class_valid,
                                              lut),
             'eval_batch': eval_batch}
    timing = {}
    for part, fn in parts.items():
        ms = host_ms(fn, 3)
        prof = device_breakdown(fn, 2)
        timing[part] = {'host_ms': ms, **{k: v for k, v in prof.items()
                                          if k != 'top'}}
        if prof['measured']:
            timing[part]['busy_share'] = prof['busy_ms'] / ms
        print(f'{card} | {part} D2@768 batch {batch}: '
              + json.dumps(timing[part]), flush=True)

    # evaluate() end to end: both CSV files, finite numbers
    fm.reset_launches()
    table = evaluate({m: (teachers[m], t_vars[m]) for m in teachers},
                     (student, s_vars), dataset, config, device=device)
    torch.cuda.synchronize()
    n_batches = frames // batch
    for name, c in expect_launches(
            'evaluate()',
            n_batches * BLOCKS * (len(TEACHERS) + 1)).items():
        counts[name] += c
    if [r['modality'] for r in table] != ['ALL']:
        raise AssertionError(f'testing points {table}')
    numbers = {k: v for k, v in table[0].items()
               if k not in ('exp_name', 'modality')}
    if not all(np.isfinite(v) for v in numbers.values()):
        raise AssertionError(f'evaluate() returned {table}')
    exp = Path(config['exp_name'])
    with open(exp / 'resources.0.csv', newline='') as f:
        resources = next(csv.DictReader(f))
    with open(exp / 'results.0.csv', newline='') as f:
        if next(csv.DictReader(f))['modality'] != 'ALL':
            raise AssertionError('results.0.csv lacks the ALL row')
    if int(resources['Frames']) != frames:
        raise AssertionError(f'evaluate() saw {resources["Frames"]} frames')
    fps = float(resources['FramesPerSec'])
    print(f'{card} | evaluate() on {frames} frames: {fps:.2f} frames/s, '
          + json.dumps(numbers), flush=True)
    return {'counts': counts, 'valid_fused_rows': n_valid,
            'kernel_vs_plain_plan': {'corr': agree, 'labels': labels_match},
            'setup_s': setup_s,
            'timing': timing, 'evaluate': {'frames_per_s': fps, **numbers}}


def train_phase(batch: int, seed: int, device, card: str):
    """The distillation step of the shipped recipe at D2@768, then train()
    end to end with a checkpoint and its restore."""
    t0 = time.perf_counter()
    exp = OUT_DIR / 'train_smoke'
    shutil.rmtree(exp, ignore_errors=True)   # resume=True must find none
    frames = 2 * batch
    config = load_config(str(RECIPE), extra=dict(
        image_size=IMAGE_SIZE, batch_size=batch, synthetic_size=frames,
        fused_inference=True,
        compute_dtype='bfloat16', device_audio_resize=True, num_workers=4,
        exp_name=str(exp), log_path=str(exp / 'tensorboard'), rank=0,
        seed=seed, fast_run=True, num_epoches=1, val_interval=1))
    cfg = trainer.distill_config_from(config, IMAGE_SIZE)
    recipe = (cfg.train_method, cfg.kd_loss, cfg.w_kd, cfg.T, cfg.p,
              config['optimizer'], config.getfloat('lr'))
    if recipe != ('traditional_nms_augmented', 'MTALoss', 0.005, 9.0, 2.0,
                  'Adam', 1e-4):
        raise AssertionError(f'not the shipped recipe: {recipe}')
    dtype = compute_dtype_from(config)
    train_set = SyntheticMultimodal(config, 'train')
    val_set = SyntheticMultimodal(config, 'val')
    host = collate([train_set[i] for i in range(batch)],
                   cfg.pl.max_gt)
    if host['audio'].shape[1] != 80:
        raise AssertionError('the compact audio ingest is off')
    inputs = trainer.device_batch(host, device, transfer_dtype_from(config))
    if inputs['audio'].dtype != torch.bfloat16:
        raise AssertionError('the modalities must travel in bf16')
    teachers = {m: seeded_detector(seed + 10 + i, batch, device, inputs[m])
                for i, m in enumerate(TEACHERS)}
    student = seeded_detector(
        seed, batch, device, maybe_stretch_mel_axis(inputs['audio'],
                                                    IMAGE_SIZE))
    anchors = torch.as_tensor(anchor_table(IMAGE_SIZE), device=device)
    class_valid, lut = trainer.label_tables(train_set, NUM_CLASSES, device)
    t = time.perf_counter()
    frozen = ts.make_teachers(teachers, image_size=IMAGE_SIZE, fused=True,
                              dtype=dtype, device=device)
    state = ts.init_train_state(copy.deepcopy(student), config,
                                device=device)
    step = ts.make_train_step(frozen, cfg, anchors, class_valid, lut,
                              compute_dtype=dtype, seed=seed, device=device)
    setup_s = time.perf_counter() - t
    params0 = [p.detach().clone() for p in state.model.parameters()]
    sections = {'setup': time.perf_counter() - t0}

    # the main path: every count 0 just before, read just after
    base_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fm.reset_launches()
    history = [step(state, inputs)]
    torch.cuda.synchronize()
    counts = expect_launches('train step', BLOCKS * len(TEACHERS))
    peak_bytes = torch.cuda.max_memory_allocated()
    # (3) 8 steps of Adam on the fixed batch
    history += [step(state, inputs) for _ in range(7)]
    losses = {k: [float(m[k]) for m in history] for k in ts.METRICS}
    print(f'train step losses over 8 steps: {json.dumps(losses)}',
          flush=True)
    if not all(np.isfinite(v).all() for v in losses.values()):
        raise AssertionError('a loss is not finite')
    if not losses['Total_loss'][-1] < losses['Total_loss'][0]:
        raise AssertionError('the total loss did not fall over 8 steps')
    moved = sum(not torch.equal(p, q) for p, q in
                zip(state.model.parameters(), params0))
    if moved < len(params0) // 2:
        raise AssertionError(f'only {moved} of {len(params0)} parameter '
                             'tensors changed')

    sections['8 steps'] = time.perf_counter() - t0
    # (2) MTA from the kernel plan's teacher features against the
    # plain-version plan's, same batch, same student features
    targets = ts.teacher_targets(frozen, inputs, cfg, anchors, class_valid,
                                 lut)
    with plain_blocks():
        targets_plain = ts.teacher_targets(frozen, inputs, cfg, anchors,
                                           class_valid, lut)
    state.model.eval()
    with torch.no_grad(), torch.autocast('cuda', dtype):
        feats_s = state.model.distill_features(
            state.model(targets.student_input))
    mta = {plan: torch.stack([mta_loss(feats_s, f, cfg.T, cfg.p,
                                       cfg.mta_parity)
                              for f in tg.features]).cpu()
           for plan, tg in (('kernel', targets), ('plain', targets_plain))}
    mta_rel = float(((mta['kernel'] - mta['plain']).abs() /
                     mta['plain'].abs().clamp(min=1e-6)).max())
    # at T = 9 the MTA of these maps sits near -log(H*W) whatever they
    # hold, so the maps themselves are compared too (a reading, no gate)
    at_rel = max(float((attention_map(k) - attention_map(q)).norm()
                       / attention_map(q).norm())
                 for fk, fq in zip(targets.features, targets_plain.features)
                 for k, q in zip(fk, fq))
    print(f'MTA per teacher and level, kernel plan {mta["kernel"].tolist()}'
          f', plain-version plan {mta["plain"].tolist()}: largest relative '
          f'difference {mta_rel:.3g} (gate {MTA_RTOL}); attention maps: '
          f'largest relative L2 difference {at_rel:.3g}', flush=True)
    if not mta_rel < MTA_RTOL:
        raise AssertionError(f'MTA of the kernel plan differs by {mta_rel}')

    sections['mta'] = time.perf_counter() - t0
    # readings: the step and its three parts
    gen = torch.Generator(device=device)

    def student_half():
        state.optimizer.zero_grad(set_to_none=True)
        loss, _ = ts.student_losses(state.model, targets, cfg, anchors,
                                    True, gen.manual_seed(seed), dtype)
        loss.backward()

    parts = {'step': lambda: step(state, inputs),
             'teacher_half': lambda: ts.teacher_targets(
                 frozen, inputs, cfg, anchors, class_valid, lut),
             'student_fwd_loss_bwd': student_half,
             'optimizer': lambda: apply_gradients(state.optimizer)}
    readings = {'peak_mib': peak_bytes / 2**20,
                'before_step_mib': base_bytes / 2**20}
    for part, fn in parts.items():
        fn()                                  # warm-up
        ms = host_ms(fn, 3)
        prof = device_breakdown(fn, 1)
        readings[part] = {'host_ms': ms, **prof}
        if prof['measured']:
            readings[part]['busy_share'] = prof['busy_ms'] / ms
        print(f'{card} | train {part} D2@768 batch {batch}: '
              + json.dumps({k: v for k, v in readings[part].items()
                            if k != 'top'}), flush=True)
    print(f'{card} | train step peak device memory '
          f'{readings["peak_mib"]:.1f} MiB ({readings["before_step_mib"]:.1f}'
          ' MiB allocated before the step)', flush=True)

    sections['readings'] = time.perf_counter() - t0
    # (4) train() end to end: two iterations, one validation, a checkpoint
    fm.reset_launches()
    final = trainer.train({m: (net, net.state_dict())
                           for m, net in teachers.items()},
                          (student, student.state_dict()), config, train_set,
                          val_set, device=device)
    torch.cuda.synchronize()
    # two train iterations and two validation batches, three teachers each
    for name, c in expect_launches('train()',
                                   4 * BLOCKS * len(TEACHERS)).items():
        counts[name] += c
    if final.step != 2:
        raise AssertionError(f'train() took {final.step} steps')
    for name in ('checkpoint.0', 'best.0', 'only_parameters_student_best.0',
                 'all_logs.0.json'):
        if not (exp / name).exists():
            raise AssertionError(f'train() wrote no {name}')
    logs = json.loads((exp / 'all_logs.0.json').read_text())
    val_loss = logs['Test/Total_loss']['0']
    fresh = ts.init_train_state(copy.deepcopy(student), config,
                                device=device)
    scheduler = build_scheduler(config)
    _, start, best, best_epoch = checkpoint.restore_checkpoint(
        config, fresh, scheduler)
    want = {'lr': 1e-4, 'best': logs['Train/Total_loss']['1'], 'num_bad': 0}
    if (start, best_epoch, fresh.step) != (1, 0, 2) or \
            not np.isclose(best, val_loss) or scheduler.state_dict() != want:
        raise AssertionError(f'restored epoch {start}, best {best} @ '
                             f'{best_epoch}, step {fresh.step}, scheduler '
                             f'{scheduler.state_dict()}; want best '
                             f'{val_loss}, scheduler {want}')
    if not all(torch.equal(v, final.model.state_dict()[k])
               for k, v in fresh.model.state_dict().items()):
        raise AssertionError('the restored student differs')
    print(f'train(): 2 steps, validation loss {val_loss:.4f}, checkpoint '
          'restored (epoch, best loss, scheduler, student)', flush=True)
    for name in ('checkpoint.0', 'best.0', 'only_parameters_student_best.0'):
        (exp / name).unlink()    # hundreds of MB; the logs stay
    sections['train()'] = time.perf_counter() - t0
    print(f'train phase seconds elapsed: {json.dumps(sections)}', flush=True)
    return {'counts': counts, 'setup_s': setup_s, 'losses': losses,
            'mta': {k: v.tolist() for k, v in mta.items()},
            'mta_max_rel_diff': mta_rel, 'attention_max_rel_diff': at_rel,
            'readings': readings,
            'train_val_loss': val_loss}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--batch', type=int, default=8)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    device = torch.device('cuda', 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f'torch {torch.__version__} cuda {torch.version.cuda} '
          f'python {sys.version.split()[0]}', flush=True)

    t = time.perf_counter()
    libs = cuda_build.build_all()
    build_s = time.perf_counter() - t
    print(f'built {libs} in {build_s:.1f} s', flush=True)
    for name, log in cuda_build.build_logs.items():
        lines = log.splitlines()
        # ptxas notes where it adds a wgmma fence or wait of its own
        injected = sum('is injected' in line for line in lines)
        for line in lines:
            if (any(w in line for w in ('Used', 'spill', 'error',
                                        'serialized'))
                    and 'bytes stack frame, 0 bytes spill' not in line):
                print(f'  nvcc {name}: {line.strip()}')
        if injected:
            print(f'  nvcc {name}: {injected} wgmma fences/waits injected '
                  'by ptxas')

    totals, rows = kernel_phase(a.batch, a.seed, device)
    served = slice_phase(a.batch, a.seed, device)
    taught = teacher_phase(a.batch, a.seed, device, card)
    trained = train_phase(a.batch, a.seed, device, card)

    kernels = []
    for name, t in totals.items():
        kernels.append({
            'name': name, 'route': 'cuda', 'source': SOURCES[name],
            'replaces': REPLACES,
            'launches': (served['counts'][name] + taught['counts'][name]
                         + trained['counts'][name]),
            'max_abs_err': t['max_abs_err'], 'ms': t['ms'],
            'plain_ms': t['plain_ms'], 'bound_ms': t['bound_ms'],
            'bound_by': ('bytes' if t['bound_bytes_ms'] * 2 >= t['bound_ms']
                         else 'operations'),
            'library_ms': None})
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / 'chip_smoke.json').write_text(json.dumps({
        'card': card, 'kind': kind, 'torch': torch.__version__,
        'cuda': torch.version.cuda, 'batch': a.batch, 'seed': a.seed,
        'build_s': build_s, 'kernels': kernels, 'blocks': rows,
        'slice': served, 'teachers': taught, 'train': trained}, indent=1))
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
