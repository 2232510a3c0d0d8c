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
     8). The predictor's first call (the eager pass and the capture of its
     CUDA graph) must count each kernel 46 times and the NMS kernel twice
     on the wrappers' counters; then, over the replays, the counters must
     stay at 0 and a device trace must hold each kernel 23 times per batch
     and the NMS kernel once; outputs must be finite with at least one
     valid detection. The kernel plan must agree with a predictor of the
     same weights built and first called with the blocks' plain versions
     in place, so that its CUDA graph holds them (its replay, traced: no
     MBConv kernel, one NMS kernel; correlation >
     0.999 on every output, > 0.998 on the bf16 scores, >= 90% of
     detections within 1 px, same class). A mesh (card, card) predictor's
     first call must count 92 launches of each kernel and 4 NMS (each
     replica's eager pass and capture), its replay, traced, 46 and 2; an
     int8 predictor's first call twice INT8_PER_FORWARD and 2 NMS, its
     replay, traced, the int8 kernels' calls a forward, one NMS kernel
     and no MBConv kernel. These replays are traced here because later in
     the run every trace misses a few device records (PERF.md); later
     phases check their predictors' first calls on the counters and that
     the counters stay at 0 over replays. Against the unfused fp32 plan
     it must correlate at least as well as the unfused bf16 plan
     ('flax:0-22') and match at least 95% as many detections. Serving
     time at the batch is measured, and torch.profiler gives the kernel
     time by name and the device's busy share for the serve, the forward
     and the backbone, and the backbone device time of the unfused bf16
     plan (a sequence of cuDNN and elementwise library calls per block;
     the port never routes through it) as a yardstick for the whole block.
     Each serving predictor's CUDA graph captures and replays are
     reported beside the launch counts, here and in phases 9-11.
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
  7. cli: the port's command-line entry points as a user runs them.
     Seeded D2 teachers (rgb 3, thermal 1, depth 3 channels, BN
     statistics from one train-mode pass over the frames they will see)
     and a seeded 8-channel student are written as reference-layout .pth
     files ('state_dict' wrapper, 'module.' prefix) under
     chiprun_out/cli/; the rgb teacher carries a marker value in
     bifpn.0.p6_w1. mm_distillnet_torch.cli.train.main runs the shipped
     config (configs/mm-distillnet.cfg) with dataset Synthetic (16
     frames), fast_run, one epoch, validation every epoch, batch and
     eval batch 8, fused_inference, resume off and pretrain_checkpoint =
     the student file: D2 at 768 px, full width. With every launch count
     set to 0 just before and read just after, each kernel must have run
     69 times per train and validation step and 92 per evaluate batch
     (the total derived from the loaders' lengths and fast_run); the
     teachers must hold the files' tensors (marker included);
     checkpoint.0 and best.0 must exist and the AP table be finite.
     mm_distillnet_torch.cli.evaluate.main then scores best.0 on the same
     frames (eval_split val): 92 launches of each kernel per batch, and
     the same AP table within CLI_AP_TOL. mm_distillnet_torch.cli
     .mp3_to_pkl.main converts seeded .wav clips (layout
     */audio/*.wav) on the card: every pickle (80, 1 + n // 256), finite,
     and within CLI_DB_TOL dB of the port's own CPU run of the frontend.
     The wall seconds of the train CLI and its parts (model loading with
     the .pth reads, the teachers' folding, train(), the final
     evaluate), the evaluate CLI's seconds and FramesPerSec and
     mp3_to_pkl's clips per second are printed beside the card's name and
     power limit;
  8. data: the real-dataset path without cv2. The port's host decoder
     (csrc/image_decode.cpp, built with the host C++ compiler beside the
     kernels) decodes the committed fixtures (tests/fixtures/torch_data:
     1920x1080 JPEGs at 4:2:0 and a 16-bit PNG under a .jpg name), each
     array held to the SHA-256 of cv2.imread's recorded beside them (any
     mismatch fails the run), and times 20 decodes of each. A tree in the
     Freiburg layout (16 frames per split, the fixtures hard-linked, 8
     seeded (80, 173) pickles and 1 s .wav clips per frame) is written
     under build/; MultimodalDetection.__getitem__ is timed per frame, the
     loader's frames/s over 32 frames (batch 8, the config's 6 workers),
     the same frames one per task on 6 threads, and one batch's collate.
     The train CLI runs the shipped config with its own dataset
     on that tree (fast_run, batch 8, fused_inference): exactly 460
     launches of each kernel, derived as in phase 7; the evaluate CLI on
     its best.0 (test split): 184. Two steps of
     traditional_nms_kdlist_augmented then run on loader batches whose
     audio yield_batch mixed (merge_audios of the .wav clips): 138
     launches of each kernel. Decode ms, __getitem__ ms, loader frames/s,
     the CLIs' seconds by part and FramesPerSec, and the kdlist mix's ms
     per batch and the steps' seconds are printed beside the card's name
     and power limit;
  9. dist: multi-process training over torch.distributed and batch-sharded
     inference on the card, each held against one process computing the
     same frames (gates DIST_METRIC_RTOL and DIST_UPDATE_RTOL; the compared
     steps run the student in fp32, the timed ones in the recipe's bf16).
     (a) An NCCL world of one process, formed here from torchrun's
     variables: two steps of the shipped recipe at D2@768, batch 8,
     teachers on the kernels, the student's BN as SyncBatchNorm2d, against
     the same two steps without a process group (the gap: SyncBatchNorm2d's
     E[x^2] - E[x]^2 against BatchNorm2d); 69 launches of each kernel per
     step. (b) A gloo world of two processes (this script with
     --dist-worker steps) on the one card, batch 4 per rank, stochastic
     depth off: two steps of bn_mode 'sync' against the plain student
     half on the 8 frames in this process (the teachers run per rank's
     half, as the ranks run them), and of 'per_replica' against the
     ranks' halves in turn here (gradients averaged, rank 0's statistics
     kept);
     both ranks must hold the same student; 69 launches per step per rank,
     reported back and added in. (c) The train CLI on two gloo ranks on the
     card (--dist-worker cli), phase 7's Synthetic shipped config,
     fast_run, 32 frames: 460 launches of each kernel per rank; both ranks
     exit 0 with equal checkpoints and their own results.{rank}.csv. (d)
     make_serving_fn and make_predict_fn over the mesh (card, card) on an
     odd batch of 7, padded, split and gathered, against the unsharded
     call: the first serve call 92 launches of each kernel on the
     counters (each replica's eager pass and capture), a replay none of
     its own, a predict call 46. Per-rank bf16 step host
     ms, all_reduce ms, peak memory per rank and the phase's seconds are
     printed beside the card's name and power limit. Two ranks on one
     card measure the path, not multi-card speed;
  10. quant: the int8 PTQ path (quant.py) of the slice phase's seeded
     student at D2@768, batch 8. build_quant_pack on the batch through the
     bf16 module tree; one recorded forward: every 'int8_conv2d'-route
     call runs the fused kernel (csrc/int8_conv.cu `quantized_conv2d`) and
     every 1x1 ('int_mm'-route) call the fused s8 GEMM (csrc/int8_gemm.cuh
     `quantized_conv1x1`): INT8_PER_FORWARD calls, torch._int_mm none.
     Each fused output must equal the unfused torch sequence's
     (int8_conv.quantized_conv2d_reference, torch._int_mm for the 1x1
     sums) bit for bit; on each call's quantized input the int32
     accumulators of `int8_conv2d` and, on the 1x1s, of torch._int_mm must
     equal the plain version's (an fp64 conv of the int8 values). Each
     call is timed (CUDA-graph replays) beside its plain version and its
     bound, per kernel and per class (dw3s1, dw5s1, dw3s2, dw5s2, stem;
     pw384 ... pw6 for the 1x1s by map size), with the fp32 cuDNN
     convolution of the same int8 values (channels_last, TF32 off; timed
     only) and the calls on which it is exact, and torch._int_mm as the
     1x1s' library
     yardstick. make_serving_fn(quant_pack=)'s first call (the eager pass
     and the capture) must count each route's calls per forward twice,
     and copies the fused wrappers had to make into NHWC are counted;
     then three batches are replayed with the counters at 0. Against the
     bf16 fused predictor on the same batch the outputs must correlate above
     QUANT_CORR_FLOOR and at least QUANT_MATCH_FLOOR of its detections be
     found at IoU 0.5 with the same class. Host ms, device busy ms and
     launches of a serve call; then evaluate() with quant_inference=True
     on a Freiburg tree (16 test frames, the shipped config, teachers on
     the MBConv kernels: 69 launches of each per batch, the fused
     kernels' calls per batch), frames/s;
  11. export: the slice phase's student served by make_serving_fn (bf16,
     the MBConv kernels) is exported with export_predictor on the card
     (seconds, file size) and replayed by load_predictor in a fresh
     process (this script with --export-worker): its Detections must
     equal the live predictor's bit for bit, with 23 launches of each
     kernel per call. A predictor built on the CPU and exported with
     platforms=('cuda',) is loaded on the card and must find 90% of the
     card's detections within 1 px (the slice phase's gate). The serve
     call's device time from utils.profiling.device_time (a CUDA graph of
     the call) beside graph_ms and the host clock;
  12. nms: the greedy NMS kernel (csrc/nms.cu, ops/nms.py nms_fixed) at
     the main path's shapes, (B, K) = (1, 512) and (32, 512) (serving),
     (8, 512) (the teachers) and (8, 192) and (8, 96) (the label fusion),
     on seeded overlapping boxes with class offsets and tied scores: its
     three outputs must equal the plain version's on the card bit for
     bit, one call must be one launch, and the kernel is timed alone
     (CUDA-graph replays: device time) beside the host time of one call,
     its bound and the plain version's time (CUDA events around eager
     calls: its launches). `--nms-kernel` runs this phase alone
     (chiprun_out/nms_kernel_s{seed}.json, no result line). Every
     main-path run of the phases above also counts the NMS kernel's
     launches: one a predictor call, NMS_PER_LABELS a teacher group's
     labels (a train or validation step), NMS_PER_EVAL_BATCH an evaluated
     batch;
  13. report: one JSON line of kernel results (launches summed over the
     serving, teacher, train, cli, data, dist, quant and export phases;
     int8_conv2d's, quantized_conv2d's and quantized_conv1x1's over the
     slice phase's traced int8 replay and the quant phase's serving and
     evaluate(), their ms, plain ms and bound
     summed over one forward's calls, int8_conv2d's library_ms the fp32
     cuDNN yardstick, quantized_conv1x1's torch._int_mm's; nms_fixed's
     max_abs_err the largest difference from the plain version over the
     nms phase's outputs, its ms, plain ms and bound summed over one train
     step's calls, NMS_STEP; each shape's under "nms" in the JSON file),
     then as the last line {"ok": true, "device": {...}}.

Per-block numbers go to chiprun_out/chip_smoke.json. Without a CUDA device
the script exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import csv
import hashlib
import io
import json
import math
import os
import pickle
import re
import shutil
import socket
import statistics
import subprocess
import sys
import time
import wave
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from mm_distillnet_torch.config import (compute_dtype_from, config_from_dict,
                                        default_config, load_config,
                                        transfer_dtype_from)
from mm_distillnet_torch.data import decode
from mm_distillnet_torch.data.base import (prediction_to_label_lut,
                                           valid_prediction_ids)
from mm_distillnet_torch.data.loader import DataLoader, collate
from mm_distillnet_torch.data.multimodal import MultimodalDetection
from mm_distillnet_torch.data.synthetic import SyntheticMultimodal
from mm_distillnet_torch.distill import train_step as ts
from mm_distillnet_torch.evaluation import (evaluate, make_fused_teacher_fn,
                                            make_predict_fn)
from mm_distillnet_torch.losses.mta import attention_map, mta_loss
from mm_distillnet_torch.models import fused_forward
from mm_distillnet_torch.models.efficientdet import EfficientDet
from mm_distillnet_torch.models.efficientnet import (MBConvBlock,
                                                     expand_block_args)
from mm_distillnet_torch.models.layers import SyncBatchNorm2d
from mm_distillnet_torch.ops import cuda_build
from mm_distillnet_torch.ops.boxes import pairwise_iou_xyxy
from mm_distillnet_torch.ops import fused_mbconv as fm
from mm_distillnet_torch.ops.anchors import anchor_table
from mm_distillnet_torch.ops.postprocess import class_validity_table
from mm_distillnet_torch.ops.resize import maybe_stretch_mel_axis
from mm_distillnet_torch.parallel import mesh
from mm_distillnet_torch.serving import (export_predictor, load_predictor,
                                         make_serving_fn, serve_many)
from mm_distillnet_torch.cli import evaluate as cli_evaluate
from mm_distillnet_torch.cli import mp3_to_pkl as cli_mp3_to_pkl
from mm_distillnet_torch.cli import train as cli_train
from mm_distillnet_torch.train import checkpoint, trainer
from mm_distillnet_torch.train.optim import apply_gradients, build_scheduler
from mm_distillnet_torch import quant
from mm_distillnet_torch.ops import int8_conv, int8_gemm, nms
from mm_distillnet_torch.utils import profiling
from mm_distillnet_torch.utils.profiling import graph_ms

IMAGE_SIZE = 768
IN_CHANNELS = 8
NUM_CLASSES = 20
TEACHERS = ('rgb', 'thermal', 'depth')
BLOCKS = 23   # MBConv blocks of EfficientDet-D2: launches per forward
# NMS kernel launches: a teacher group's labels take one per teacher and
# one for the fusion; an evaluated batch adds the student's detections
NMS_PER_LABELS = len(TEACHERS) + 1
NMS_PER_EVAL_BATCH = NMS_PER_LABELS + 1
SOURCES = {'mbconv_expand_dw': 'mm_distillnet_torch/csrc/mbconv_expand_dw.cu',
           'mbconv_se': 'mm_distillnet_torch/csrc/mbconv.cu',
           'mbconv_project': 'mm_distillnet_torch/csrc/mbconv_project.cu'}
REPLACES = 'mm_distillnet_tpu/ops/pallas_mbconv.py:137'
# the int8 conv has no Pallas kernel to replace: the JAX package's s8 x s8
# -> s32 lax.conv_general_dilated
INT8_REPLACES = 'mm_distillnet_tpu/quant.py:209'
INT8_SOURCES = {'int8_conv2d': 'mm_distillnet_torch/csrc/int8_conv.cu',
                'quantized_conv2d': 'mm_distillnet_torch/csrc/int8_conv.cu',
                'quantized_conv1x1': 'mm_distillnet_torch/csrc/int8_gemm.cuh'}
ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / 'chiprun_out'
RECIPE = ROOT / 'configs' / 'mm-distillnet.cfg'
FIXTURES = ROOT / 'tests' / 'fixtures' / 'torch_data'
# how the multimodal dataset reads each kind of frame
DATASET_READS = {'rgb.jpg': 'IMREAD_COLOR', 'depth.jpg': 'IMREAD_COLOR',
                 'thermal.jpg': 'IMREAD_ANYDEPTH'}
SPLIT_FRAMES = 16   # frames per split of the data phase's tree
# kernel plan against plain-version plan: the largest relative difference
# of one teacher's MTA loss at one level (seeds 0-2: 1.04e-7, 1.98e-7,
# 1.32e-7; PERF.md)
MTA_RTOL = 2e-6
# the evaluate CLI on the train CLI's best.0 against the train CLI's own
# final evaluate of it: the same frames and weights, so the tables agree
# up to run-to-run rounding (AP and CD points)
CLI_AP_TOL = 0.5
# mp3_to_pkl on the card against the same frontend on the CPU, fp32 GEMMs
# both (dB); the CPU run is within 2.7e-5 dB of the JAX package's
CLI_DB_TOL = 1e-3
# the kernels of csrc/mbconv*.cu by their names in a profiler trace
KERNEL_NAMES = {'mbconv_expand_dw': re.compile(r'\b(expand_dw_kernel|dw_only_kernel)\b'),
                'mbconv_se': re.compile(r'\bse_kernel\b'),
                'mbconv_project': re.compile(r'\bproject_kernel\b')}
# each launch counter's kernels by their names in a device trace
TRACED_NAMES = {**KERNEL_NAMES, 'nms_fixed': re.compile(r'\bnms_kernel\b'),
                'quantized_conv2d': re.compile(
                    r'\b(dw|stem|general)_kernel\b'),
                'quantized_conv1x1': re.compile(r'\bconv1x1_kernel\b')}


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

    # the key's first call: the eager pass and the capture, each counted
    # by the kernels' wrappers
    reset_launches()
    serve(images[:batch])
    torch.cuda.synchronize()
    expect_launches('serving, the first call', 2 * BLOCKS, 2)
    # the main path, replays: each kernel counted as it ran on the card
    n_batches = 1 + sum(-(-n // batch) for n in (8, 13))
    (first, requests), traced = traced_launches(
        f'serving, {n_batches} batches',
        lambda: (serve(images[:batch]),
                 {n: serve_many(serve, images[:n], batch) for n in (8, 13)}))
    counts = expect_traced(f'serving, {n_batches} batches', traced,
                           BLOCKS * n_batches, n_batches)

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
    # (i) the kernel plan against a predictor of the same weights with
    # each fused block computed by its plain version on the card: built
    # and first called inside plain_blocks(), so that its CUDA graph holds
    # the plain blocks (a replay of `serve`'s graph would hold the
    # kernels); its replay, outside, runs no MBConv kernel
    out_k = serve.forward(x)
    det_k = serve(x)
    with plain_blocks():
        serve_p = make_serving_fn(model, sd, IMAGE_SIZE, device=device)
        out_p = serve_p.forward(x)
        reset_launches()
        serve_p(x)
        torch.cuda.synchronize()
        expect_launches('the plain-block predictor, its first call', 0, 2)
    det_p, traced = traced_launches('the plain-block predictor',
                                    lambda: serve_p(x))
    expect_traced('the plain-block predictor, a replay', traced, 0, 1)
    # (iii) the mesh (card, card) and int8 predictors' replays, traced here
    # (the dist and quant phases check their first calls and outputs):
    # later in this script's run every trace, of the eager sequence too,
    # misses a few of its device records (PERF.md)
    serve_m = make_serving_fn(model, sd, IMAGE_SIZE, mesh=(device, device))
    reset_launches()
    serve_m(x)
    torch.cuda.synchronize()
    expect_launches('the mesh predictor, its first call (each replica\'s '
                    'eager pass and capture)', 4 * BLOCKS, 4)
    _, traced = traced_launches('the mesh predictor', lambda: serve_m(x))
    for name, c in expect_traced('the mesh predictor, a replay', traced,
                                 2 * BLOCKS, 2).items():
        counts[name] += c
    net = fused_forward.eval_module(model, sd, device, torch.bfloat16)
    serve_q = make_serving_fn(
        model, sd, IMAGE_SIZE, device=device,
        quant_pack=quant.build_quant_pack(net, x, [x], state_dict=sd))
    int8_conv.reset_launches()
    reset_launches()
    serve_q(x)
    torch.cuda.synchronize()
    expect_int8('the int8 predictor, its first call',
                {r: 2 * n for r, n in INT8_PER_FORWARD.items()})
    expect_launches('the int8 predictor, its first call', 0, 2)
    _, traced = traced_launches('the int8 predictor', lambda: serve_q(x))
    counts['nms_fixed'] += expect_traced('the int8 predictor, a replay',
                                         traced, 0, 1)['nms_fixed']
    int8_counts = {'quantized_conv2d': traced['quantized_conv2d'],
                   'quantized_conv1x1': traced['quantized_conv1x1']}
    expect_traced_int8('the int8 predictor, a replay', int8_counts, 1)
    del net, serve_q
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
        'serve_eager_ms': host_ms(lambda: serve.run(x), 3),
        'serve_host_input_ms': host_ms(lambda: serve(images[:batch]), 3),
        'forward_ms': host_ms(lambda: serve.forward(x), 3),
        'backbone_ms': host_ms(lambda: serve.forward.backbone(x), 5),
        'unfused_serve_ms': host_ms(lambda: serve_f16(x), 3),
        'unfused_backbone_ms': host_ms(
            lambda: serve_f16.forward.backbone(x), 3),
    }
    timing['postprocess_ms'] = timing['serve_eager_ms'] - \
        timing['forward_ms']
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
    graphs = graph_counts(serve=serve, plain_blocks=serve_p, mesh=serve_m,
                          unfused_fp32=serve_f32, unfused_bf16=serve_f16)
    print(f'serving predictors\' CUDA graphs [captures, replays]: '
          f'{json.dumps(graphs)}', flush=True)
    return {'counts': counts, 'int8_counts': int8_counts, 'graphs': graphs,
            'n_batches': n_batches,
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


def reset_launches() -> None:
    fm.reset_launches()
    nms.reset_launches()


def launch_counts() -> dict:
    """The MBConv kernels' launches and the NMS kernel's."""
    return {**fm.launches, **nms.launches}


def expect_counts(what: str, counts: dict, per_kernel: int,
                  nms_calls: int) -> dict:
    """Each MBConv kernel launched per_kernel times, the NMS kernel
    nms_calls times."""
    for name, c in counts.items():
        want = nms_calls if name in nms.launches else per_kernel
        if c != want:
            raise AssertionError(f'{what}: {name} launched {c} times, '
                                 f'expected {want}')
    return counts


def expect_launches(what: str, per_kernel: int, nms_calls: int) -> dict:
    return expect_counts(what, launch_counts(), per_kernel, nms_calls)


def graph_counts(**predictors) -> dict:
    """[captures, replays] of each make_serving_fn predictor's CUDA
    graphs."""
    return {name: [p.captures, p.replays] for name, p in predictors.items()}


def traced_launches(what: str, fn):
    """fn()'s result and each launch counter's kernels that ran on the
    card in it, counted by their names in a device trace (torch.profiler).
    A make_serving_fn predictor's replay runs its graph's kernels, which
    the counters (the wrappers' own launches) do not see: they must read
    0 after it. `quantized_conv2d` counts every csrc/int8_conv.cu kernel,
    `int8_conv2d`'s too."""
    from torch.profiler import ProfilerActivity, profile
    reset_launches()
    int8_conv.reset_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    host = {**launch_counts(), **int8_conv.launches}
    if any(host.values()):
        raise AssertionError(f'{what}: the counters read {host} over '
                             'replays')
    names = [e.name for e in prof.events() if _on_device(e)]
    if not names:
        raise AssertionError(f'{what}: no kernel in the device trace')
    counts = {k: sum(bool(p.search(n)) for n in names)
              for k, p in TRACED_NAMES.items()}
    print(f'{what}: {len(names)} device operations traced, '
          f'{json.dumps(counts)}', flush=True)
    return out, counts


def expect_traced(what: str, traced: dict, per_kernel: int,
                  nms_calls: int) -> dict:
    """expect_counts on the MBConv and NMS kernels of a device trace."""
    return expect_counts(what, {k: traced[k] for k in launch_counts()},
                         per_kernel, nms_calls)


def expect_traced_int8(what: str, ran: dict, forwards: int) -> None:
    """The int8 kernels of `forwards` forwards in a device trace:
    csrc/int8_conv.cu's (int8_conv2d's calls and quantized_conv2d's) and
    the 1x1s' s8 GEMM."""
    want = {'quantized_conv2d': forwards * (
                INT8_PER_FORWARD['quantized_conv2d']
                + INT8_PER_FORWARD['int8_conv2d']),
            'quantized_conv1x1': forwards *
            INT8_PER_FORWARD['quantized_conv1x1']}
    if ran != want:
        raise AssertionError(f'{what}: the trace holds {ran}, expected '
                             f'{want}')


def expect_replays(what: str, fn):
    """fn()'s result; fn only replays make_serving_fn graphs, so the
    kernels' counters (their wrappers' launches) must stay at 0 (the slice
    phase counts replayed kernels in a device trace)."""
    reset_launches()
    int8_conv.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    host = {**launch_counts(), **int8_conv.launches}
    if any(host.values()):
        raise AssertionError(f'{what}: the counters read {host} over '
                             'replays')
    return out


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
    reset_launches()
    fused = teacher_fn(t_vars, inputs, class_valid, lut)
    torch.cuda.synchronize()
    counts = expect_launches('teacher function',
                             BLOCKS * len(TEACHERS), NMS_PER_LABELS)
    reset_launches()
    rows, _ = predict(s_vars, inputs['audio'], class_valid, lut)
    torch.cuda.synchronize()
    for name, c in expect_launches('predict function', BLOCKS, 1).items():
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
    reset_launches()
    table = evaluate({m: (teachers[m], t_vars[m]) for m in teachers},
                     (student, s_vars), dataset, config, device=device)
    torch.cuda.synchronize()
    n_batches = frames // batch
    for name, c in expect_launches(
            'evaluate()', n_batches * BLOCKS * (len(TEACHERS) + 1),
            n_batches * NMS_PER_EVAL_BATCH).items():
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
    reset_launches()
    history = [step(state, inputs)]
    torch.cuda.synchronize()
    counts = expect_launches('train step', BLOCKS * len(TEACHERS),
                             NMS_PER_LABELS)
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
    reset_launches()
    final = trainer.train({m: (net, net.state_dict())
                           for m, net in teachers.items()},
                          (student, student.state_dict()), config, train_set,
                          val_set, device=device)
    torch.cuda.synchronize()
    # two train iterations and two validation batches, three teachers each
    for name, c in expect_launches('train()', 4 * BLOCKS * len(TEACHERS),
                                   4 * NMS_PER_LABELS).items():
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


@contextlib.contextmanager
def timed_calls(module, name: str, seconds: dict, calls: list = None):
    """Wrap module.name: its wall seconds add up in seconds[name], and each
    call's (args, result) is appended to `calls`."""
    original = getattr(module, name)

    def wrapper(*args, **kwargs):
        t = time.perf_counter()
        out = original(*args, **kwargs)
        seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t
        if calls is not None:
            calls.append((args, out))
        return out

    setattr(module, name, wrapper)
    try:
        yield
    finally:
        setattr(module, name, original)


@contextlib.contextmanager
def timed_products(module, name: str, seconds: dict, key: str):
    """Wrap the factory module.name: every function it makes has its wall
    seconds, from a synchronize before to one after each call, added up in
    seconds[key] (and its calls counted in seconds[key + '_calls'])."""
    original = getattr(module, name)

    def factory(*args, **kwargs):
        fn = original(*args, **kwargs)

        def timed(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            seconds[key] = seconds.get(key, 0.0) + time.perf_counter() - t
            seconds[key + '_calls'] = seconds.get(key + '_calls', 0) + 1
            return out
        return timed

    setattr(module, name, factory)
    try:
        yield
    finally:
        setattr(module, name, original)


def write_reference_pth(model: torch.nn.Module, path: Path) -> dict:
    """The model's weights in the reference's .pth layout ('state_dict'
    wrapper, DataParallel's 'module.' prefix); returns the state_dict."""
    sd = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    torch.save({'epoch': 0, 'state_dict': {f'module.{k}': v
                                           for k, v in sd.items()}},
               str(path))
    return sd


def write_wav(path: Path, pcm: np.ndarray, rate: int) -> None:
    with wave.open(str(path), 'wb') as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes((np.clip(pcm, -1, 1) * 32767).astype(np.int16)
                      .tobytes())


def write_seeded_networks(dataset, models: Path, student_path: Path,
                          batch: int, seed: int, device):
    """Seeded D2 teachers and student, BN statistics from the dataset's
    first batch, written in the reference's .pth layout (teachers under
    `models` as the registry names them; the rgb teacher carries a marker
    value in bifpn.0.p6_w1). Returns the teachers' state_dicts, the
    student's and the networks by modality ('audio' for the student)."""
    host = collate([dataset[i] for i in range(batch)])
    inputs = trainer.device_batch(host, device, None)
    files, nets = {}, {}
    for i, m in enumerate(TEACHERS):
        nets[m] = net = seeded_detector(seed + 10 + i, batch, device,
                                        inputs[m])
        if m == 'rgb':
            with torch.no_grad():
                net.bifpn[0].p6_w1.copy_(torch.tensor([0.625, 0.375]))
        files[m] = write_reference_pth(
            net, models / f'yet-another-efficientdet-d2-{m}.pth')
    nets['audio'] = seeded_detector(seed, batch, device,
                                    maybe_stretch_mel_axis(inputs['audio'],
                                                           IMAGE_SIZE))
    return files, write_reference_pth(nets['audio'], student_path), nets


def cli_phase(batch: int, seed: int, device, card: str):
    """The train, evaluate and mp3_to_pkl CLIs as a user runs them."""
    t0 = time.perf_counter()
    root = OUT_DIR / 'cli'
    shutil.rmtree(root, ignore_errors=True)
    models = root / 'trained_models'
    models.mkdir(parents=True)
    frames = 2 * batch
    overwrite = dict(
        dataset='Synthetic', synthetic_size=frames, fast_run=True,
        num_epoches=1, val_interval=1, batch_size=batch,
        eval_batch_size=batch, fused_inference=True, resume=False,
        exp_name=str(root / 'exp'), saved_path=str(models),
        log_path=str(root / 'tensorboard'),
        pretrain_checkpoint=str(root / 'student.pth'))
    config = load_config(str(RECIPE), json.dumps(overwrite))

    # (1) the files: seeded D2 networks, BN statistics from the frames
    # each will see, in the reference's .pth layout
    train_set = SyntheticMultimodal(config, 'train')
    files, student_sd, nets = write_seeded_networks(
        train_set, models, root / 'student.pth', batch, seed, device)
    del nets
    sections = {'files': time.perf_counter() - t0}

    # (2) the train CLI; its parts timed through the functions it calls
    args = ['--config_file', str(RECIPE), '--overwrite',
            json.dumps(overwrite)]
    seconds, loads = {}, []
    steps = min(2, math.ceil(frames / batch))   # fast_run: two batches
    expected = 2 * steps * BLOCKS * len(TEACHERS) \
        + steps * BLOCKS * (len(TEACHERS) + 1)
    expected_nms = 2 * steps * NMS_PER_LABELS + steps * NMS_PER_EVAL_BATCH
    with timed_calls(cli_train, 'load_model', seconds, loads), \
            timed_calls(cli_train, 'get_dataset', seconds), \
            timed_calls(trainer, 'make_teachers', seconds), \
            timed_products(trainer, 'make_train_step', seconds, 'steps'), \
            timed_products(trainer, 'make_eval_loss_step', seconds,
                           'validation_steps'), \
            timed_calls(trainer, 'save_checkpoint', seconds), \
            timed_calls(cli_train, 'train', seconds), \
            timed_calls(cli_train, 'evaluate', seconds):
        torch.cuda.synchronize()
        reset_launches()       # the main path: counts 0 just before
        t = time.perf_counter()
        table = cli_train.main(args)
        torch.cuda.synchronize()
        seconds['train_cli'] = time.perf_counter() - t
        counts = expect_launches('train CLI', expected, expected_nms)
    teachers = {args_[2]: out[1] for args_, out in loads
                if args_[2] != 'audio_student'}
    if sorted(teachers) != sorted(TEACHERS):
        raise AssertionError(f'the train CLI loaded {sorted(teachers)}')
    for m, sd in teachers.items():
        for k, v in files[m].items():
            if not torch.equal(sd[k], v):
                raise AssertionError(f'teacher {m}: {k} is not the file\'s')
    if teachers['rgb']['bifpn.0.p6_w1'].tolist() != [0.625, 0.375]:
        raise AssertionError('the rgb teacher lacks the file\'s marker')
    exp = Path(config['exp_name'])
    for name in ('checkpoint.0', 'best.0'):
        if not (exp / name).exists():
            raise AssertionError(f'the train CLI wrote no {name}')
    numbers = {k: v for k, v in table[0].items()
               if k not in ('exp_name', 'modality')}
    if [r['modality'] for r in table] != ['ALL'] or \
            not all(np.isfinite(v) for v in numbers.values()):
        raise AssertionError(f'train CLI AP table {table}')
    in_train = ('make_teachers', 'steps', 'validation_steps',
                'save_checkpoint')
    train_cli = {'seconds': seconds['train_cli'],
                 'load_models_s': seconds['load_model'],
                 'datasets_s': seconds['get_dataset'],
                 'train_s': seconds['train'],
                 'fold_teachers_s': seconds['make_teachers'],
                 'train_steps_s': seconds['steps'],
                 'train_steps': seconds['steps_calls'],
                 'validation_steps_s': seconds['validation_steps'],
                 'validation_steps': seconds['validation_steps_calls'],
                 'save_checkpoint_s': seconds['save_checkpoint'],
                 'train_rest_s': seconds['train']
                 - sum(seconds[k] for k in in_train),
                 'final_evaluate_s': seconds['evaluate'],
                 'launches_per_kernel': expected, 'ap_table': numbers}
    print(f'{card} | train CLI D2@768 batch {batch} ({steps} steps, {steps} '
          f'validation and {steps} evaluate batches): '
          + json.dumps(train_cli), flush=True)
    sections['train CLI'] = time.perf_counter() - t0

    # (3) the evaluate CLI on best.0, the same frames
    eval_over = dict(overwrite, eval_split='val',
                     exp_name=str(root / 'exp_eval'))
    torch.cuda.synchronize()
    reset_launches()
    t = time.perf_counter()
    scored = cli_evaluate.main(['--config_file', str(RECIPE),
                                '--checkpoint', str(exp / 'best.0'),
                                '--overwrite', json.dumps(eval_over)])
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t
    for name, c in expect_launches(
            'evaluate CLI', steps * BLOCKS * (len(TEACHERS) + 1),
            steps * NMS_PER_EVAL_BATCH).items():
        counts[name] += c
    diff = max(abs(scored[0][k] - v) for k, v in numbers.items())
    if not diff <= CLI_AP_TOL:
        raise AssertionError(f'evaluate CLI on best.0 {scored} against the '
                             f'train CLI\'s {table}')
    with open(Path(eval_over['exp_name']) / 'resources.0.csv',
              newline='') as f:
        fps = float(next(csv.DictReader(f))['FramesPerSec'])
    evaluate_cli = {'seconds': eval_s, 'frames_per_s': fps,
                    'max_diff_to_train_cli': diff}
    print(f'{card} | evaluate CLI D2@768 batch {batch} on best.0: '
          + json.dumps(evaluate_cli), flush=True)
    for name in ('checkpoint.0', 'best.0', 'only_parameters_student_best.0'):
        (exp / name).unlink()          # hundreds of MB; logs and CSVs stay
    shutil.rmtree(models)
    (root / 'student.pth').unlink()
    del teachers, files, student_sd, loads
    sections['evaluate CLI'] = time.perf_counter() - t0

    # (4) mp3_to_pkl on the card, held to the same frontend on the CPU
    rng = np.random.default_rng(seed)
    clips = root / 'audio_ds'
    lengths = []
    for i in range(32):
        n = int(rng.integers(44100, 2 * 44100)) | 1
        folder = clips / f'drive_{i % 4}' / 'audio'
        folder.mkdir(parents=True, exist_ok=True)
        tt = np.arange(n) / 44100.0
        write_wav(folder / f'{i:04d}.wav',
                  0.3 * np.sin(2 * np.pi * (200 + 40 * i) * tt)
                  * (1 + 0.5 * np.sin(tt * 7)) + 0.05 * rng.standard_normal(n),
                  44100)
        lengths.append(n)
    # the CLI reads a directory holding 'drive' as one drive (audio/*):
    # where the checkout's own path holds the word, drive by drive
    dirs = [str(clips)] if 'drive' not in str(clips) else \
        sorted(str(d) for d in clips.iterdir())
    t = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):   # a line per file
        written = [w for d in dirs
                   for w in cli_mp3_to_pkl.main(['--dir', d])]
    torch.cuda.synchronize()
    mp3_s = time.perf_counter() - t
    if len(written) != len(lengths):
        raise AssertionError(f'mp3_to_pkl wrote {len(written)} pickles')
    on_card = {}
    for path in written:
        with open(path, 'rb') as f:
            on_card[path] = pickle.load(f)
        n = len(cli_mp3_to_pkl.decode_audio(path[:-4] + '.wav'))
        got = on_card[path]
        if got.shape != (80, 1 + n // 256) or not np.isfinite(got).all():
            raise AssertionError(f'{path}: shape {got.shape}')
    # the same frontend on the CPU, writing over the same pickles
    with contextlib.redirect_stdout(io.StringIO()):
        cli_mp3_to_pkl.process_files(
            sorted(p[:-4] + '.wav' for p in written), device='cpu')
    worst = 0.0
    for path, got in on_card.items():
        with open(path, 'rb') as f:
            worst = max(worst, float(np.abs(got - pickle.load(f)).max()))
    if not worst <= CLI_DB_TOL:
        raise AssertionError(f'mp3_to_pkl: card and CPU differ by {worst} dB')
    shutil.rmtree(clips)
    mp3 = {'clips': len(lengths), 'seconds': mp3_s,
           'clips_per_s': len(lengths) / mp3_s,
           'audio_s': sum(lengths) / 44100.0,
           'max_abs_db_diff_to_cpu': worst}
    print(f'{card} | mp3_to_pkl on the card: ' + json.dumps(mp3), flush=True)
    sections['mp3_to_pkl'] = time.perf_counter() - t0
    print(f'cli phase seconds elapsed: {json.dumps(sections)}', flush=True)
    return {'counts': counts, 'train_cli': train_cli,
            'evaluate_cli': evaluate_cli, 'mp3_to_pkl': mp3,
            'sections': sections}

def write_freiburg_tree(root: Path, images: dict, frames: int, seed: int,
                        clip_s: float = 1.0) -> dict:
    """A tree in the Freiburg dataset's layout under `root`: per split
    (train, val, test) `frames` ids `drive_k/secs_nsecs_code` (nine-digit
    nsecs) in `{split}_all.txt`, listed out of time order with one id whose
    nsecs are too short (the dataset skips it); per frame the files of
    `images` (modality -> list of paths; frame i takes path i % len)
    hard-linked (copied across file systems) as fl_rgb, fl_ir_aligned and
    fl_rgb_depth, and for each of the 8 microphones a seeded .wav clip of
    `clip_s` s at 44.1 kHz and the (80, 1 + n // 256) float32 log-mel
    pickle that stands for it. Returns split -> the valid ids."""
    rng = np.random.default_rng(seed)
    n = int(clip_s * 44100)
    tt = np.arange(n) / 44100.0
    folders = {'rgb': ('fl_rgb', 'fl_rgb_{}.jpg'),
               'thermal': ('fl_ir_aligned', 'fl_ir_aligned_{}.jpg'),
               'depth': ('fl_rgb_depth', 'fl_rgb_{}.jpg')}
    ids, k = {}, 0
    for split in ('train', 'val', 'test'):
        ids[split] = []
        for i in range(frames):
            drive = f'drive_{k % 3}'
            ts = f'{1500000000 + k // 2}_{100000000 + 37 * k:09d}_{k:x}'
            frame_id = f'{drive}/{ts}'
            for m, (folder, name) in folders.items():
                dst = root / drive / folder / name.format(ts)
                dst.parent.mkdir(parents=True, exist_ok=True)
                src = images[m][i % len(images[m])]
                try:
                    os.link(src, dst)
                except OSError:
                    shutil.copyfile(src, dst)
            audio = root / drive / 'audio'
            audio.mkdir(parents=True, exist_ok=True)
            for mic in range(8):
                pcm = 0.3 * np.sin(2 * np.pi * (180 + 25 * mic + 3 * k) * tt) \
                    + 0.05 * rng.standard_normal(n)
                write_wav(audio / f'audio_{mic}_{ts}.wav', pcm, 44100)
                spec = rng.normal(-40, 15, (80, 1 + n // 256)).clip(-80, 0)
                with open(audio / f'audio_{mic}_{ts}.pkl', 'wb') as f:
                    pickle.dump(spec.astype(np.float32), f, protocol=2)
            ids[split].append(frame_id)
            k += 1
        listed = list(reversed(ids[split])) + [f'drive_0/1400000000_12345_x']
        (root / f'{split}_all.txt').write_text('\n'.join(listed) + '\n')
    return ids


def decoder_checks(card: str, reps: int = 20) -> dict:
    """The committed fixtures through the port's decoder: each array's
    SHA-256 against the one cv2.imread gave (hashes.json), then the median
    ms of `reps` decodes of each file as the multimodal dataset reads it."""
    with open(FIXTURES / 'hashes.json') as f:
        hashes = json.load(f)
    for name, by_flag in hashes.items():
        for flag in ('IMREAD_COLOR', 'IMREAD_ANYDEPTH', 'IMREAD_UNCHANGED'):
            got = decode.imread(str(FIXTURES / name), getattr(decode, flag))
            digest = hashlib.sha256(got.tobytes()).hexdigest()
            want = by_flag[flag]
            if (digest != want['sha256'] or list(got.shape) != want['shape']
                    or str(got.dtype) != want['dtype']):
                raise AssertionError(f'decoder: {name} {flag} is not '
                                     'cv2.imread\'s array')
    times = {}
    for name, flag in DATASET_READS.items():
        path, value = str(FIXTURES / name), getattr(decode, flag)
        decode.imread(path, value)
        ms = []
        for _ in range(reps):
            t = time.perf_counter()
            decode.imread(path, value)
            ms.append((time.perf_counter() - t) * 1e3)
        times[name] = {'flag': flag, 'bytes': hashes[name]['bytes'],
                       'median_ms': statistics.median(ms)}
    print(f'{card} | decoder: 9 arrays equal to cv2.imread\'s (SHA-256); '
          f'median ms of {reps} decodes: ' + json.dumps(times), flush=True)
    return times


def data_phase(batch: int, seed: int, device, card: str):
    """The real-dataset path: the decoder, a Freiburg-layout tree, the
    dataset and loader, the train and evaluate CLIs on the shipped config
    with its own dataset, and two kdlist steps with the dataset's mix."""
    t0 = time.perf_counter()
    decode_ms = decoder_checks(card)
    sections = {'decoder': time.perf_counter() - t0}

    # (2) the tree: 16 frames per split, the fixtures hard-linked
    work = ROOT / 'build' / 'data_smoke'
    shutil.rmtree(work, ignore_errors=True)
    tree = work / 'freiburg'
    images = {m: [FIXTURES / f'{m}.jpg'] for m in TEACHERS}
    ids = write_freiburg_tree(tree, images, SPLIT_FRAMES, seed)
    sections['tree'] = time.perf_counter() - t0

    # (3) the dataset and the loader on the shipped config
    out = OUT_DIR / 'data'
    shutil.rmtree(out, ignore_errors=True)
    models = work / 'trained_models'
    models.mkdir(parents=True)
    overwrite = dict(
        data_path=str(tree), fast_run=True, num_epoches=1, val_interval=1,
        batch_size=batch, eval_batch_size=batch, fused_inference=True,
        resume=False, exp_name=str(out / 'exp'), saved_path=str(models),
        log_path=str(out / 'tensorboard'),
        pretrain_checkpoint=str(work / 'student.pth'))
    config = load_config(str(RECIPE), json.dumps(overwrite))
    if config['dataset'] != 'MultimodalDetection':
        raise AssertionError(f'the shipped dataset is {config["dataset"]}')
    train_set = MultimodalDetection(config, 'train')
    if train_set.ids != sorted(ids['train'], key=lambda i: (
            int(''.join(i.split('/')[1].split('_')[:2])), i)):
        raise AssertionError('the dataset did not sort and filter the ids')
    item_ms = []
    for i in range(len(train_set)):
        t = time.perf_counter()
        sample = train_set[i]
        item_ms.append((time.perf_counter() - t) * 1e3)
        for m, c in (('rgb', 3), ('thermal', 1), ('depth', 3), ('audio', 8)):
            if sample[m].shape != (IMAGE_SIZE, IMAGE_SIZE, c) or \
                    not np.isfinite(sample[m]).all():
                raise AssertionError(f'{m} of {sample["id"]}: '
                                     f'{sample[m].shape}')
    loader = DataLoader(train_set, batch, shuffle=True,
                        num_workers=config.getint('num_workers'))
    t = time.perf_counter()
    seen = 0
    for epoch in range(2):                     # 32 frames
        loader.set_epoch(epoch)
        seen += sum(len(b['id']) for b in loader)
    loader_s = time.perf_counter() - t
    # what bounds the loader: the same 32 frames one per task on as many
    # threads (the loader runs a batch's frames on one thread and keeps
    # prefetch + 1 batches in flight), and one batch's collate
    workers = config.getint('num_workers')
    t = time.perf_counter()
    with ThreadPoolExecutor(workers) as pool:
        first = [s for i, s in enumerate(pool.map(
            train_set.__getitem__, list(range(len(train_set))) * 2))
            if i < batch]
    threaded_s = time.perf_counter() - t
    t = time.perf_counter()
    collate(first)
    collate_ms = (time.perf_counter() - t) * 1e3
    dataset = {'getitem_ms_median': statistics.median(item_ms),
               'getitem_ms': item_ms,
               'loader_frames': seen, 'loader_s': loader_s,
               'loader_frames_per_s': seen / loader_s,
               'frame_tasks_frames_per_s': 2 * len(train_set) / threaded_s,
               'collate_ms': collate_ms,
               'num_workers': workers, 'batch': batch}
    print(f'{card} | MultimodalDetection D2@768 (1920x1080 JPEG rgb and '
          'depth, 16-bit PNG thermal, 8 pickles of (80, 173)): '
          + json.dumps({k: v for k, v in dataset.items()
                        if k != 'getitem_ms'}), flush=True)
    sections['dataset and loader'] = time.perf_counter() - t0

    # (4) the train CLI with the shipped dataset, then the evaluate CLI
    files, _, nets = write_seeded_networks(
        train_set, models, work / 'student.pth', batch, seed, device)
    args = ['--config_file', str(RECIPE), '--overwrite',
            json.dumps(overwrite)]
    seconds = {}
    steps = min(2, SPLIT_FRAMES // batch)    # fast_run: two batches
    expected = 2 * steps * BLOCKS * len(TEACHERS) \
        + steps * BLOCKS * (len(TEACHERS) + 1)
    expected_nms = 2 * steps * NMS_PER_LABELS + steps * NMS_PER_EVAL_BATCH
    with timed_calls(cli_train, 'load_model', seconds), \
            timed_calls(cli_train, 'get_dataset', seconds), \
            timed_calls(trainer, 'make_teachers', seconds), \
            timed_products(trainer, 'make_train_step', seconds, 'steps'), \
            timed_products(trainer, 'make_eval_loss_step', seconds,
                           'validation_steps'), \
            timed_calls(trainer, 'save_checkpoint', seconds), \
            timed_calls(cli_train, 'train', seconds), \
            timed_calls(cli_train, 'evaluate', seconds):
        torch.cuda.synchronize()
        reset_launches()       # the main path: counts 0 just before
        t = time.perf_counter()
        table = cli_train.main(args)
        torch.cuda.synchronize()
        seconds['train_cli'] = time.perf_counter() - t
        counts = expect_launches('train CLI on the Freiburg tree',
                                 expected, expected_nms)
    numbers = {k: v for k, v in table[0].items()
               if k not in ('exp_name', 'modality')}
    if not all(np.isfinite(v) for v in numbers.values()):
        raise AssertionError(f'train CLI AP table {table}')
    exp = Path(config['exp_name'])
    in_train = ('make_teachers', 'steps', 'validation_steps',
                'save_checkpoint')
    train_cli = {'seconds': seconds['train_cli'],
                 'load_models_s': seconds['load_model'],
                 'datasets_s': seconds['get_dataset'],
                 'train_s': seconds['train'],
                 'fold_teachers_s': seconds['make_teachers'],
                 'train_steps_s': seconds['steps'],
                 'validation_steps_s': seconds['validation_steps'],
                 'save_checkpoint_s': seconds['save_checkpoint'],
                 'train_rest_s': seconds['train']
                 - sum(seconds[k] for k in in_train),
                 'final_evaluate_s': seconds['evaluate'],
                 'launches_per_kernel': expected, 'ap_table': numbers}
    print(f'{card} | train CLI, shipped config and dataset, D2@768 batch '
          f'{batch} on the Freiburg tree: ' + json.dumps(train_cli),
          flush=True)
    sections['train CLI'] = time.perf_counter() - t0

    torch.cuda.synchronize()
    reset_launches()
    t = time.perf_counter()
    scored = cli_evaluate.main(['--config_file', str(RECIPE),
                                '--checkpoint', str(exp / 'best.0'),
                                '--overwrite', json.dumps(dict(
                                    overwrite,
                                    exp_name=str(out / 'exp_eval')))])
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t
    eval_launches = steps * BLOCKS * (len(TEACHERS) + 1)
    for name, c in expect_launches('evaluate CLI on the Freiburg tree',
                                   eval_launches,
                                   steps * NMS_PER_EVAL_BATCH).items():
        counts[name] += c
    if not all(np.isfinite(v) for k, v in scored[0].items()
               if k not in ('exp_name', 'modality')):
        raise AssertionError(f'evaluate CLI AP table {scored}')
    with open(out / 'exp_eval' / 'resources.0.csv', newline='') as f:
        fps = float(next(csv.DictReader(f))['FramesPerSec'])
    evaluate_cli = {'seconds': eval_s, 'frames_per_s': fps,
                    'launches_per_kernel': eval_launches}
    print(f'{card} | evaluate CLI on best.0, test split of the Freiburg '
          'tree: ' + json.dumps(evaluate_cli), flush=True)
    for name in ('checkpoint.0', 'best.0', 'only_parameters_student_best.0'):
        (exp / name).unlink()          # hundreds of MB; logs and CSVs stay
    sections['evaluate CLI'] = time.perf_counter() - t0

    # (5) traditional_nms_kdlist_augmented: the dataset's audio mix on a
    # loader batch (merge_audios of the .wav clips), then the step
    kd_config = load_config(str(RECIPE), json.dumps(dict(
        overwrite, train_method='traditional_nms_kdlist_augmented')))
    cfg = trainer.distill_config_from(kd_config, IMAGE_SIZE)
    dtype = compute_dtype_from(kd_config)
    anchors = torch.as_tensor(anchor_table(IMAGE_SIZE), device=device)
    class_valid, lut = trainer.label_tables(train_set, NUM_CLASSES, device)
    frozen = ts.make_teachers({m: nets[m] for m in TEACHERS},
                              image_size=IMAGE_SIZE, fused=True, dtype=dtype,
                              device=device)
    state = ts.init_train_state(nets['audio'], kd_config, device=device)
    step = ts.make_train_step(frozen, cfg, anchors, class_valid, lut,
                              compute_dtype=dtype, seed=seed, device=device)
    mix_rng = np.random.default_rng(seed)
    kd = {'mix_ms_per_batch': [], 'mix_ms_per_frame': [], 'step_s': [],
          'losses': []}
    reset_launches()
    for host, _ in zip(DataLoader(train_set, batch, shuffle=True,
                                  num_workers=6), range(2)):
        t = time.perf_counter()
        labels, audio = train_set.yield_batch(len(host['id']), host['id'],
                                              mix_rng)
        kd['mix_ms_per_batch'].append((time.perf_counter() - t) * 1e3)
        kd['mix_ms_per_frame'].append(
            kd['mix_ms_per_batch'][-1] / len(host['id']))
        if audio.shape != host['audio'].shape or labels != [None] * batch:
            raise AssertionError(f'yield_batch gave {audio.shape}')
        host['audio'] = audio.astype(np.float32)
        torch.cuda.synchronize()
        t = time.perf_counter()
        metrics = step(state, trainer.device_batch(
            host, device, transfer_dtype_from(kd_config)))
        torch.cuda.synchronize()
        kd['step_s'].append(time.perf_counter() - t)
        kd['losses'].append({k: float(v) for k, v in metrics.items()})
    for name, c in expect_launches('kdlist steps',
                                   2 * BLOCKS * len(TEACHERS),
                                   2 * NMS_PER_LABELS).items():
        counts[name] += c
    if not all(np.isfinite(list(m.values())).all() for m in kd['losses']):
        raise AssertionError(f'kdlist losses {kd["losses"]}')
    kd['launches_per_kernel'] = 2 * BLOCKS * len(TEACHERS)
    print(f'{card} | traditional_nms_kdlist_augmented, 2 steps on '
          f'yield_batch mixes, D2@768 batch {batch}: ' + json.dumps(kd),
          flush=True)
    del nets, frozen, state, step, files
    shutil.rmtree(work)
    sections['kdlist'] = time.perf_counter() - t0
    print(f'data phase seconds elapsed: {json.dumps(sections)}', flush=True)
    return {'counts': counts, 'decode': decode_ms, 'dataset': dataset,
            'train_cli': train_cli, 'evaluate_cli': evaluate_cli,
            'kdlist': kd, 'sections': sections}


# ---- phase 9: dist ----

DIST_DIR = ROOT / 'build' / 'dist_smoke'
DIST_TIMEOUT_S = 480       # each world of worker processes
# The compared steps of phase 9 run the student in fp32 (the teachers on
# the kernels, in bf16, as always): in bf16 the gradients of two BN
# implementations, or of one on two batch splits, differ as much as bf16
# and fp32 gradients do (relative L2 about 1.1 at D2, 128 px on the CPU),
# so a bf16 comparison would measure rounding. The timed steps run the
# shipped recipe's bf16. The gates, relative to one process computing the
# same frames (compare_runs), about 2.5x the largest gap of seeds 0, 1, 2
# on an H100 (PERF.md): 'per_replica' computes what one process
# computes, in another order; 'sync' and the NCCL world of one normalise
# with SyncBatchNorm2d's E[x^2] - E[x]^2 (flax's) where one process has
# cuDNN's BatchNorm, and Adam turns the rounding of a gradient near zero
# into a step of lr either way.
DIST_METRIC_RTOL = {'nccl_world_of_1': 5e-2, 'sync': 1e-2,
                    'per_replica': 1e-5}
DIST_UPDATE_RTOL = {'nccl_world_of_1': 1.0, 'sync': 0.5,
                    'per_replica': 0.05}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _sync(device) -> None:
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize()


def detector_from(sd: dict, in_channels: int, device,
                  drop_connect_rate: float = 0.2) -> EfficientDet:
    net = EfficientDet(NUM_CLASSES, 2, in_channels,
                       drop_connect_rate=drop_connect_rate)
    net.load_state_dict(sd)
    return net.to(device).eval()


def run_world(args: list, world: int) -> list:
    """`world` processes of `python3 chip_smoke.py *args`, one per rank,
    in one gloo world on a free local port (torchrun's variables; every
    rank on the current card, LOCAL_RANK 0); their outputs. Any rank that
    fails or outlives DIST_TIMEOUT_S fails the phase, and every process is
    stopped."""
    port = _free_port()
    procs = []
    for rank in range(world):
        env_r = dict(os.environ, MASTER_ADDR='127.0.0.1',
                     MASTER_PORT=str(port), WORLD_SIZE=str(world),
                     RANK=str(rank), LOCAL_RANK='0')
        procs.append(subprocess.Popen(
            [sys.executable, str(ROOT / 'chip_smoke.py'), *args],
            cwd=ROOT, env=env_r, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    deadline = time.monotonic() + DIST_TIMEOUT_S
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f'rank {rank} of {args} exited '
                                 f'{p.returncode}:\n{out[-6000:]}')
    return outs


def _step_metrics(metrics: dict) -> dict:
    return {k: float(v) for k, v in metrics.items()}


def _updates(model, params0) -> torch.Tensor:
    """The parameters' change since params0, flattened, fp32."""
    return torch.cat([(p.detach() - q).float().flatten()
                      for p, q in zip(model.parameters(), params0)])


def compare_runs(name: str, got_metrics: list, want_metrics: list,
                 got_update: torch.Tensor, want_update: torch.Tensor) -> dict:
    """Every metric of every step within DIST_METRIC_RTOL[name] (relative,
    floor 1e-6) of the single-process run's, and the update of the
    parameters over the steps within DIST_UPDATE_RTOL[name] (relative L2):
    Adam moves a parameter by about lr whatever its gradient's size, so a
    gradient that BN's rounding or a reduction's order moves across zero
    flips its step; the update's relative L2 counts such flips."""
    by_step = []
    for step, (g, w) in enumerate(zip(got_metrics, want_metrics)):
        rel = {k: abs(g[k] - w[k]) / max(abs(w[k]), 1e-6) for k in ts.METRICS}
        by_step.append(rel)
        for k, r in rel.items():
            if not r <= DIST_METRIC_RTOL[name]:
                raise AssertionError(
                    f'{name}: step {step + 1} {k} {g[k]} against {w[k]} '
                    f'(relative {r:.3g}, gate {DIST_METRIC_RTOL[name]})')
    upd = float((got_update - want_update).norm()
                / want_update.norm().clamp(min=1e-30))
    if not upd <= DIST_UPDATE_RTOL[name]:
        raise AssertionError(f'{name}: parameter update differs by {upd:.3g}'
                             f' (relative L2, gate {DIST_UPDATE_RTOL[name]})')
    return {'metric_max_rel_diff': max(max(r.values()) for r in by_step),
            'metric_rel_diff_by_step': by_step, 'update_rel_l2_diff': upd,
            'update_max_abs_diff': float(
                (got_update - want_update).abs().max())}


def _reset_peak(device) -> None:
    if torch.device(device).type == 'cuda':
        torch.cuda.reset_peak_memory_stats()


def _peak_mib(device) -> float:
    if torch.device(device).type != 'cuda':
        return float('nan')
    return torch.cuda.max_memory_allocated() / 2**20


def all_reduce_ms(model, device, reps: int = 3) -> float:
    """Median host ms of the step's gradient reduction (one flat
    all_reduce of the student's fp32 gradients) in the current world."""
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    times = []
    for _ in range(reps):
        _sync(device)
        t = time.perf_counter()
        mesh.all_reduce_mean_(grads)
        _sync(device)
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def sync_reference(student_sd: dict, frozen, inputs: dict, cfg, tables,
                   config, dtype, seed: int, ranks: int, device,
                   steps: int = 2):
    """bn_mode 'sync' of `ranks` ranks computed in one process: the
    teacher half on each rank's share of the batch (as each rank runs it:
    the teachers' outputs may move by a rounding with the batch they run
    at, and the pseudo-labels of these smooth frames move with them), the
    targets concatenated, then the plain step's student half on the whole
    batch. Returns (state, params before, per-step metrics)."""
    state = ts.init_train_state(detector_from(student_sd, IN_CHANNELS,
                                              device, 0.0), config,
                                device=device)
    params0 = [p.detach().clone() for p in state.model.parameters()]
    per = inputs['audio'].shape[0] // ranks
    parts = [ts.teacher_targets(frozen, {k: v[r * per:(r + 1) * per]
                                         for k, v in inputs.items()},
                                cfg, *tables) for r in range(ranks)]
    targets = ts.TeacherTargets(
        torch.cat([p.student_input for p in parts]),
        [torch.cat(a) for a in zip(*(p.annotations for p in parts))],
        [[torch.cat(lv) for lv in zip(*fs)]
         for fs in zip(*(p.features for p in parts))],
        [torch.cat(lg) for lg in zip(*(p.logits for p in parts))])
    gen = torch.Generator(device=device)
    history = []
    for _ in range(steps):
        state.optimizer.zero_grad(set_to_none=True)
        loss, m = ts.student_losses(
            state.model, targets, cfg, tables[0], True,
            gen.manual_seed(ts._step_seed(seed, state.step)), dtype)
        loss.backward()
        apply_gradients(state.optimizer)
        state.step += 1
        history.append(_step_metrics(m))
    return state, params0, history


def per_replica_reference(student_sd: dict, frozen, inputs: dict, cfg,
                          tables, config, dtype, seed: int, ranks: int,
                          device, steps: int = 2):
    """make_train_step_per_replica_bn of `ranks` ranks computed in one
    process: per step, each rank's share of the batch through its own
    forward and backward from the same BN statistics, the gradients
    summed and divided by `ranks`, the metrics averaged, rank 0's running
    statistics kept. Returns (state, params before, per-step metrics)."""
    state = ts.init_train_state(detector_from(student_sd, IN_CHANNELS,
                                              device, 0.0), config,
                                device=device)
    params0 = [p.detach().clone() for p in state.model.parameters()]
    gen = torch.Generator(device=device)
    per = inputs['audio'].shape[0] // ranks
    history = []
    for _ in range(steps):
        state.optimizer.zero_grad(set_to_none=True)
        buffers = list(state.model.buffers())
        start = [b.clone() for b in buffers]
        kept, parts = None, []
        for r in range(ranks):
            for b, s in zip(buffers, start):
                b.copy_(s)
            part = {k: v[r * per:(r + 1) * per] for k, v in inputs.items()}
            loss, m = ts.compute_distill_losses(
                state.model, frozen, part, cfg, *tables, train=True,
                generator=gen.manual_seed(ts._step_seed(seed, state.step,
                                                        r)),
                compute_dtype=dtype)
            loss.backward()
            parts.append(_step_metrics(m))
            if r == 0:
                kept = [b.clone() for b in buffers]
        grads = [p.grad for p in state.model.parameters()
                 if p.grad is not None]
        torch._foreach_div_(grads, float(ranks))
        for b, s in zip(buffers, kept):
            b.copy_(s)
        apply_gradients(state.optimizer)
        state.step += 1
        history.append({k: float(np.mean([m[k] for m in parts]))
                        for k in ts.METRICS})
    return state, params0, history


def dist_steps_worker(spec: dict) -> None:
    """A rank of phase 9's gloo world: per bn mode, two steps with the
    student in fp32 on its share of the batch, the state written for the
    parent, then two bf16 steps timed (the shipped recipe's dtype) and the
    gradient all_reduce timed."""
    dev = torch.device(spec['device'])
    mesh.distributed_init_if_needed(device=dev, backend='gloo')
    rank, world = mesh.process_index(), mesh.process_count()
    if dev.type == 'cuda':
        dev = torch.device('cuda', torch.cuda.current_device())
    d = Path(spec['dir'])
    config = load_config(spec['recipe'], extra=spec['config'])
    size = spec['image_size']
    cfg = trainer.distill_config_from(config, size)
    dtype = compute_dtype_from(config)
    per = spec['per_rank']
    data = np.load(d / 'batch.npz')
    host = {k: data[k][rank * per:(rank + 1) * per] for k in data.files}
    inputs = trainer.device_batch(host, dev, transfer_dtype_from(config))
    tables_np = np.load(d / 'tables.npz')
    tables = (torch.as_tensor(anchor_table(size), device=dev),
              torch.as_tensor(tables_np['class_valid'], device=dev),
              torch.as_tensor(tables_np['lut'], device=dev))
    nets = torch.load(d / 'nets.pt', map_location='cpu', weights_only=True)
    frozen = ts.make_teachers(
        {m: detector_from(nets[m], inputs[m].shape[-1], dev)
         for m in TEACHERS}, image_size=size, fused=True, dtype=dtype,
        device=dev)
    report = {'rank': rank, 'world': world, 'modes': {}}
    for mode in ('sync', 'per_replica'):
        state = ts.init_train_state(
            detector_from(nets['audio'], IN_CHANNELS, dev, 0.0), config,
            device=dev)
        steps = {dt: ts.make_train_step(frozen, cfg, *tables,
                                        compute_dtype=dt, seed=spec['seed'],
                                        bn_mode=mode, device=dev)
                 for dt in (torch.float32, dtype)}
        reset_launches()
        metrics = [_step_metrics(steps[torch.float32](state, inputs))
                   for _ in range(2)]
        torch.save({k: v.cpu() for k, v in state.model.state_dict().items()},
                   d / f'student.{mode}.{rank}.pt')
        _sync(dev)
        _reset_peak(dev)
        step_ms = []
        for _ in range(2):
            t = time.perf_counter()
            steps[dtype](state, inputs)
            _sync(dev)
            step_ms.append((time.perf_counter() - t) * 1e3)
        report['modes'][mode] = {
            'metrics': metrics, 'bf16_step_ms': step_ms,
            'launches': launch_counts(), 'peak_mib': _peak_mib(dev),
            'all_reduce_ms': all_reduce_ms(state.model, dev),
            'grad_mib': sum(p.numel() for p in state.model.parameters())
            * 4 / 2**20}
    (d / f'steps.{rank}.json').write_text(json.dumps(report))
    mesh.barrier()
    dist.destroy_process_group()


def dist_cli_worker(spec: dict) -> None:
    """A rank of phase 9's train CLI: cli.train.main with the phase's
    arguments; its launches and AP table written for the parent."""
    reset_launches()
    t = time.perf_counter()
    table = cli_train.main(spec['cli_args'])
    _sync(spec['device'])
    rank = mesh.process_index()
    Path(spec['dir'], f'cli.{rank}.json').write_text(json.dumps({
        'rank': rank, 'world': mesh.process_count(),
        'seconds': time.perf_counter() - t, 'launches': launch_counts(),
        'table': table}))
    mesh.barrier()
    dist.destroy_process_group()


def dist_phase(batch: int, seed: int, device, card: str):
    """Multi-process training over torch.distributed and batch-sharded
    inference, each held against one process computing the same frames."""
    t0 = time.perf_counter()
    root = DIST_DIR
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    extra = dict(image_size=IMAGE_SIZE, batch_size=batch,
                 synthetic_size=2 * batch, fused_inference=True,
                 compute_dtype='bfloat16', device_audio_resize=True,
                 num_workers=4, exp_name=str(root / 'exp'),
                 log_path=str(root / 'tensorboard'), seed=seed)
    config = load_config(str(RECIPE), extra=extra)
    cfg = trainer.distill_config_from(config, IMAGE_SIZE)
    dtype = compute_dtype_from(config)
    train_set = SyntheticMultimodal(config, 'train')
    host = collate([train_set[i] for i in range(batch)], cfg.pl.max_gt)
    inputs = trainer.device_batch(host, device, transfer_dtype_from(config))
    teachers = {m: seeded_detector(seed + 10 + i, batch, device, inputs[m])
                for i, m in enumerate(TEACHERS)}
    student = seeded_detector(
        seed, batch, device, maybe_stretch_mel_axis(inputs['audio'],
                                                    IMAGE_SIZE))
    sd = {k: v.detach().clone() for k, v in student.state_dict().items()}
    class_valid, lut = trainer.label_tables(train_set, NUM_CLASSES, device)
    tables = (torch.as_tensor(anchor_table(IMAGE_SIZE), device=device),
              class_valid, lut)
    frozen = ts.make_teachers(teachers, image_size=IMAGE_SIZE, fused=True,
                              dtype=dtype, device=device)
    counts = {k: 0 for k in launch_counts()}
    per_step = BLOCKS * len(TEACHERS)

    def add(what, per_kernel, nms_calls):
        for name, c in expect_launches(what, per_kernel, nms_calls).items():
            counts[name] += c

    readings = {}
    sections = {'setup': time.perf_counter() - t0}

    # (1) an NCCL world of one process (torchrun's variables), here: two
    # steps of the shipped recipe (stochastic depth on: rank 0 draws the
    # plain step's masks; the student in fp32, see DIST_METRIC_RTOL)
    # against the same two steps without a group, then a bf16 step of each
    # timed
    cmp = torch.float32
    plain = ts.init_train_state(copy.deepcopy(student), config,
                                device=device)
    params0 = [p.detach().clone() for p in plain.model.parameters()]
    plain_step, plain_bf16 = (
        ts.make_train_step(frozen, cfg, *tables, compute_dtype=dt,
                           seed=seed, device=device) for dt in (cmp, dtype))
    want = [_step_metrics(plain_step(plain, inputs)) for _ in range(2)]
    want_update = _updates(plain.model, params0)
    plain_bf16(plain, inputs)
    plain_ms = host_ms(lambda: plain_bf16(plain, inputs), 1)
    saved_env = {k: os.environ.get(k) for k in
                 ('MASTER_ADDR', 'MASTER_PORT', 'WORLD_SIZE', 'RANK',
                  'LOCAL_RANK')}
    os.environ.update(MASTER_ADDR='127.0.0.1', MASTER_PORT=str(_free_port()),
                      WORLD_SIZE='1', RANK='0', LOCAL_RANK='0')
    try:
        mesh.distributed_init_if_needed(device=device)
        backend = dist.get_backend()
        group = ts.init_train_state(copy.deepcopy(student), config,
                                    device=device)
        group_step, group_bf16 = (
            ts.make_train_step(frozen, cfg, *tables, compute_dtype=dt,
                               seed=seed, device=device)
            for dt in (cmp, dtype))
        reset_launches()
        got = [_step_metrics(group_step(group, inputs)) for _ in range(2)]
        _sync(device)
        gap = compare_runs('nccl_world_of_1', got, want,
                           _updates(group.model, params0), want_update)
        if not any(isinstance(m, SyncBatchNorm2d)
                   for m in group.model.modules()):
            raise AssertionError('the group step kept BatchNorm2d')
        _reset_peak(device)
        group_bf16(group, inputs)
        nccl = {'backend': backend, 'world': mesh.process_count(),
                'plain_bf16_step_ms': plain_ms,
                'group_bf16_step_ms': host_ms(
                    lambda: group_bf16(group, inputs), 1),
                'peak_mib': _peak_mib(device),
                'all_reduce_ms': all_reduce_ms(group.model, device),
                'grad_mib': sum(p.numel() for p in group.model.parameters())
                * 4 / 2**20, 'gap': gap}
        add('NCCL world of one, 4 steps', 4 * per_step, 4 * NMS_PER_LABELS)
        dist.destroy_process_group()
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    readings['nccl_world_of_1'] = nccl
    print(f'{card} | dist NCCL world of 1 D2@768 batch {batch} (shipped '
          'recipe, 2 steps against the same steps without a group): '
          + json.dumps(nccl), flush=True)
    del plain, group, plain_step, group_step, plain_bf16, group_bf16
    sections['nccl world of 1'] = time.perf_counter() - t0

    # (2) the references of the gloo world, one process, the whole batch:
    # 'sync' the plain student half on all frames, 'per_replica' the
    # ranks' shares in turn (stochastic depth off: one draw over all
    # frames and one per rank give other masks)
    ranks = 2
    ref = {}
    for mode, fn in (('sync', sync_reference),
                     ('per_replica', per_replica_reference)):
        st, p0, hist = fn(sd, frozen, inputs, cfg, tables, config, cmp,
                          seed, ranks, device)
        ref[mode] = (hist, st.model, p0)
    sections['references'] = time.perf_counter() - t0

    # (3) the gloo world: two processes on this card, batch / 2 each
    torch.save({m: net.state_dict() for m, net in
                {**teachers, 'audio': student}.items()}, root / 'nets.pt')
    np.savez(root / 'batch.npz', **{k: host[k] for k in
                                    ('rgb', 'thermal', 'depth', 'audio',
                                     'label')})
    np.savez(root / 'tables.npz', class_valid=class_valid.cpu().numpy(),
             lut=lut.cpu().numpy())
    spec = {'dir': str(root), 'recipe': str(RECIPE), 'config': extra,
            'image_size': IMAGE_SIZE, 'per_rank': batch // ranks,
            'seed': seed, 'device': str(device)}
    (root / 'steps.json').write_text(json.dumps(spec))
    if torch.device(device).type == 'cuda':
        torch.cuda.empty_cache()     # the ranks share this card
    t = time.perf_counter()
    run_world(['--dist-worker', 'steps', '--spec', str(root / 'steps.json')],
              ranks)
    world_s = time.perf_counter() - t
    reports = [json.loads((root / f'steps.{r}.json').read_text())
               for r in range(ranks)]
    gloo = {'seconds': world_s}
    for mode in ('sync', 'per_replica'):
        want_metrics, model, p0 = ref[mode]
        want_update = _updates(model, p0)
        states = [torch.load(root / f'student.{mode}.{r}.pt',
                             map_location=device, weights_only=True)
                  for r in range(ranks)]
        for k, v in states[0].items():
            if not torch.equal(v, states[1][k]):
                raise AssertionError(f'{mode}: the ranks hold other {k}')
        model.load_state_dict(states[0])
        gloo[mode] = compare_runs(mode, reports[0]['modes'][mode]['metrics'],
                                  want_metrics, _updates(model, p0),
                                  want_update)
        for r, rep in enumerate(reports):
            got = rep['modes'][mode]
            if rep['modes'][mode]['metrics'] != \
                    reports[0]['modes'][mode]['metrics']:
                raise AssertionError(f'{mode}: rank {r} logged other metrics')
            for name, c in expect_counts(f'gloo world {mode} rank {r}',
                                         got['launches'], 4 * per_step,
                                         4 * NMS_PER_LABELS).items():
                counts[name] += c
            gloo[mode][f'rank{r}'] = {k: got[k] for k in
                                      ('bf16_step_ms', 'all_reduce_ms',
                                       'peak_mib', 'grad_mib')}
        print(f'{card} | dist gloo world of {ranks} on one card D2@768 batch '
              f'{batch // ranks} per rank, bn_mode {mode} (against one '
              f'process on the {batch} frames): ' + json.dumps(gloo[mode]),
              flush=True)
    readings['gloo_world_of_2'] = gloo
    del ref, st, model, states
    sections['gloo world'] = time.perf_counter() - t0

    # (4) the train CLI on two gloo ranks on this card, phase 7's config
    models = root / 'trained_models'
    models.mkdir()
    for m, net in teachers.items():
        write_reference_pth(net, models / f'yet-another-efficientdet-d2-{m}'
                            '.pth')
    write_reference_pth(student, root / 'student.pth')
    frames = 4 * batch           # two batches per rank
    overwrite = dict(
        dataset='Synthetic', synthetic_size=frames, fast_run=True,
        num_epoches=1, val_interval=1, batch_size=batch,
        eval_batch_size=batch, fused_inference=True, resume=False,
        exp_name=str(root / 'cli_exp'), saved_path=str(models),
        log_path=str(root / 'cli_tensorboard'), dist_backend='gloo',
        pretrain_checkpoint=str(root / 'student.pth'))
    cli_spec = {'dir': str(root), 'device': str(device), 'cli_args': [
        '--config_file', str(RECIPE), '--overwrite', json.dumps(overwrite)]
        + (['--device', 'cpu'] if torch.device(device).type == 'cpu'
           else [])}
    (root / 'cli.json').write_text(json.dumps(cli_spec))
    del frozen, teachers
    if torch.device(device).type == 'cuda':
        torch.cuda.empty_cache()
    t = time.perf_counter()
    run_world(['--dist-worker', 'cli', '--spec', str(root / 'cli.json')],
              ranks)
    cli_s = time.perf_counter() - t
    steps = min(2, math.ceil(frames // ranks / batch))
    expected = 2 * steps * per_step + steps * BLOCKS * (len(TEACHERS) + 1)
    expected_nms = 2 * steps * NMS_PER_LABELS + steps * NMS_PER_EVAL_BATCH
    clis = [json.loads((root / f'cli.{r}.json').read_text())
            for r in range(ranks)]
    for rep in clis:
        for name, c in expect_counts(f'train CLI rank {rep["rank"]}',
                                     rep['launches'], expected,
                                     expected_nms).items():
            counts[name] += c
        if rep['world'] != ranks or not all(
                np.isfinite(v) for row in rep['table'] for v in row.values()
                if isinstance(v, float)):
            raise AssertionError(f'train CLI rank {rep["rank"]}: {rep}')
    exp = root / 'cli_exp'
    ckpts = [torch.load(exp / f'checkpoint.{r}', map_location='cpu',
                        weights_only=True) for r in range(ranks)]
    for k, v in ckpts[0]['state_dict'].items():
        if not torch.equal(v, ckpts[1]['state_dict'][k]):
            raise AssertionError(f'train CLI: checkpoint.1 differs in {k}')
    for r in range(ranks):
        if not (exp / f'results.{r}.csv').exists():
            raise AssertionError(f'train CLI wrote no results.{r}.csv')
    cli = {'seconds': cli_s, 'launches_per_kernel_per_rank': expected,
           'rank_seconds': [rep['seconds'] for rep in clis],
           'steps_per_rank': ckpts[0]['step']}
    readings['train_cli'] = cli
    print(f'{card} | dist train CLI, {ranks} gloo ranks on one card, D2@768 '
          f'batch {batch} per rank: ' + json.dumps(cli), flush=True)
    del ckpts
    sections['train CLI'] = time.perf_counter() - t0

    # (5) batch-sharded serving and prediction over (card, card): an odd
    # batch padded, split, run by one replica each, gathered; against the
    # unsharded call
    odd = batch - 1
    pair = (torch.device(device), torch.device(device))
    rng = np.random.default_rng(seed + 7)
    x = torch.as_tensor(rng.standard_normal(
        (odd, IMAGE_SIZE, IMAGE_SIZE, IN_CHANNELS)).astype(np.float32),
        device=device)
    serve1 = make_serving_fn(student, sd, IMAGE_SIZE, device=device)
    serve2 = make_serving_fn(student, sd, IMAGE_SIZE, mesh=pair)
    want_d = serve1(x)
    reset_launches()
    serve2(x)
    _sync(device)
    add('sharded serve, the first call (each replica\'s eager pass and '
        'capture)', 4 * BLOCKS, 4)
    got_d = expect_replays('sharded serve, a replay', lambda: serve2(x))
    matched, total = match_detections(want_d, got_d)
    pcfg = load_config(str(RECIPE), extra=dict(extra, max_detections=100))
    predict1 = make_predict_fn(student, IMAGE_SIZE, pcfg, variables=sd,
                               device=device)
    predict2 = make_predict_fn(student, IMAGE_SIZE, pcfg, variables=sd,
                               mesh=pair)
    audio = inputs['audio'][:odd]
    rows1, feats1 = predict1(None, audio, class_valid, lut)
    reset_launches()
    rows2, feats2 = predict2(None, audio, class_valid, lut)
    _sync(device)
    add('sharded predict', 2 * BLOCKS, 2)
    feat_corr = min(corr(a, b) for a, b in zip(feats1, feats2))
    same_rows = float((rows1 == rows2).all(-1).float().mean())
    sharded = {'serve_batch': odd, 'detections_matched': matched,
               'detections': total, 'predict_feature_corr': feat_corr,
               'predict_rows_equal_share': same_rows,
               'serve_equal': all(torch.equal(a, b)
                                  for a, b in zip(want_d, got_d)),
               'serve_graphs': graph_counts(unsharded=serve1,
                                            sharded=serve2)}
    # each image meets the same kernels in both calls; cuDNN may take
    # another algorithm at another batch, so the gates leave room for a
    # rounding (measured on an H100: equal to the bit, PERF.md)
    if got_d.valid.shape[0] != odd or rows2.shape[0] != odd or \
            not total or matched < 0.9 * total or not feat_corr > 0.999 \
            or not same_rows >= 0.99:
        raise AssertionError(f'sharded inference: {sharded}')
    readings['sharded'] = sharded
    print(f'{card} | dist mesh (card, card) serve and predict, batch {odd}: '
          + json.dumps(sharded), flush=True)
    shutil.rmtree(root, ignore_errors=True)
    sections['sharded'] = time.perf_counter() - t0
    print(f'dist phase seconds elapsed: {json.dumps(sections)}', flush=True)
    return {'counts': counts, 'readings': readings, 'sections': sections}


# ---- phase 10: quant ----

QUANT_DIR = ROOT / 'build' / 'quant_smoke'
# the int8 path against the bf16 fused predictor on the same seeded
# student and batch. The seeded detector scores whole neighbourhoods of
# anchors alike (see the teacher phase), so the int8 error reorders them
# and moves many boxes by more than a pixel: detections are matched at IoU
# 0.5 with the same class, the outputs by correlation. Seeds 0-2 on an
# H100 (PERF.md): 44.6-57.4% matched; correlation 0.974-0.986 (scores),
# 0.986-0.992 (regression), 0.976-0.989 (logits).
QUANT_MATCH_FLOOR = 0.3
QUANT_CORR_FLOOR = 0.95


INT8_ROUTES = ('int8_conv2d', 'int_mm', 'quantized_conv2d',
               'quantized_conv1x1')
# the calls of one D2@768 forward: every conv through a fused kernel
INT8_PER_FORWARD = {'int8_conv2d': 0, 'int_mm': 0, 'quantized_conv2d': 104,
                    'quantized_conv1x1': 120}
FUSED = ('quantized_conv2d', 'quantized_conv1x1')


@contextlib.contextmanager
def recorded_int8_calls(calls: list):
    """Every quantized conv of a forward, with its operands and result,
    appended to `calls` while the context lasts: the fused calls of
    quantized_conv2d (route 'quantized_conv2d', which takes every
    'int8_conv2d'-route call) and of quantized_conv1x1 (every 'int_mm'-route
    call), and any call of the s8 GEMM int8_conv.int_mm (route 'int_mm';
    a forward makes none)."""
    saved_mm, saved_fused = int8_conv.int_mm, int8_conv.quantized_conv2d
    saved_1x1 = int8_gemm.quantized_conv1x1

    def record_mm(qx, qw):
        out = saved_mm(qx, qw)
        calls.append(dict(route='int_mm', qx=qx, qw=qw, stride=(1, 1),
                          padding=((0, 0), (0, 0)), groups=1, out=out))
        return out

    def record_fused(x, qw, wscale, ascale, bias, stride, padding, groups,
                     compute_dtype=torch.bfloat16):
        out = saved_fused(x, qw, wscale, ascale, bias, stride, padding,
                          groups, compute_dtype)
        calls.append(dict(route='quantized_conv2d', x=x, qw=qw,
                          wscale=wscale, ascale=ascale, bias=bias,
                          stride=tuple(stride), padding=padding,
                          groups=groups, compute_dtype=compute_dtype,
                          out=out))
        return out

    def record_1x1(x, qw, wscale, ascale, bias, compute_dtype=torch.bfloat16):
        out = saved_1x1(x, qw, wscale, ascale, bias, compute_dtype)
        calls.append(dict(route='quantized_conv1x1', x=x, qw=qw,
                          wscale=wscale, ascale=ascale, bias=bias,
                          stride=(1, 1), padding=((0, 0), (0, 0)), groups=1,
                          compute_dtype=compute_dtype, out=out))
        return out

    int8_conv.int_mm = record_mm
    int8_conv.quantized_conv2d = record_fused
    int8_gemm.quantized_conv1x1 = record_1x1
    try:
        yield
    finally:
        int8_conv.int_mm = saved_mm
        int8_conv.quantized_conv2d = saved_fused
        int8_gemm.quantized_conv1x1 = saved_1x1


def library_conv(qx: torch.Tensor, qw: torch.Tensor, stride, padding,
                 groups: int) -> torch.Tensor:
    """The yardstick of int8_conv2d, timed only (the port never calls it):
    one fp32 cuDNN convolution of the int8 values, channels_last, TF32 off
    (main() turns it off)."""
    (pt, pb), (pl, pr) = padding
    x = qx.permute(0, 3, 1, 2).float()
    if (pt, pb, pl, pr) != (0, 0, 0, 0):
        x = F.pad(x, (pl, pr, pt, pb))
    w = qw.float().contiguous(memory_format=torch.channels_last)
    return F.conv2d(x, w, stride=stride, groups=groups)


def _equal_or_fail(name: str, call: dict, got, want) -> int:
    """The largest |got - want|; raises unless the two are equal."""
    e = float((got.double() - want.double()).abs().max().item())
    if not torch.equal(got, want):
        shape = tuple(call['qw'].shape)
        raise AssertionError(f'{name} {shape} stride {call["stride"]}: '
                             f'differs from its plain version by {e}')
    return e


def fused_class(call: dict) -> str:
    """A fused call's class: quantized_conv2d's by its plan's path
    (int8_conv.call_class), a 1x1's 'pw{H}' by its map size."""
    if call['route'] == 'quantized_conv1x1':
        return f'pw{call["x"].shape[1]}'
    return int8_conv.call_class(tuple(call['x'].shape),
                                tuple(call['qw'].shape), call['stride'],
                                call['padding'], call['groups'])


def check_int8_calls(calls: list) -> dict:
    """Each recorded call against the plain versions, bit for bit: a fused
    call's output against the unfused torch sequence
    (quantized_conv2d_reference, whose 1x1 sums are torch._int_mm's), then
    on its quantized input the int32 accumulators of int8_conv2d (and, on
    a 1x1, of the s8 GEMM int_mm) against the fp64 conv. Per kernel and,
    for the fused calls, per class: the summed device ms (CUDA-graph
    replays), plain ms, bounds and calls of one forward; the 1x1s' library
    yardstick (int_mm's ms); the fp32 cuDNN yardstick's ms and the calls on
    which it is exact."""
    keys = {'calls': 0, 'ms': 0.0, 'plain_ms': 0.0, 'bound_ms': 0.0,
            'bound_bytes_ms': 0.0, 'max_abs_err': 0.0}
    totals = {r: dict(keys) for r in INT8_ROUTES}
    totals['int8_conv2d'].update(library_ms=0.0, library_exact=0)
    totals['quantized_conv1x1'].update(library_ms=0.0)
    classes = {}
    shapes = []

    def add(route, ms, plain, bound, by, err, cls=None):
        for t in (totals[route],) + ((classes.setdefault(cls, {}).setdefault(
                route, dict(keys)),) if cls else ()):
            t['calls'] += 1
            t['ms'] += ms
            t['plain_ms'] += plain
            t['bound_ms'] += bound
            t['bound_bytes_ms'] += bound if by == 'bytes' else 0.0
            t['max_abs_err'] = max(t['max_abs_err'], err)

    for c in calls:
        stride, padding, groups, qw = (c['stride'], c['padding'],
                                       c['groups'], c['qw'])
        cls, row = None, None
        if c['route'] in FUSED:
            x = c['x']
            fused = (x, qw, c['wscale'], c['ascale'], c['bias'], stride,
                     padding, groups, c['compute_dtype'])
            want = int8_conv.quantized_conv2d_reference(*fused)
            if c['route'] == 'quantized_conv1x1':
                args = (x, qw, c['wscale'], c['ascale'], c['bias'],
                        c['compute_dtype'])
                kernel = lambda: int8_gemm.quantized_conv1x1(*args)
            else:
                kernel = lambda: int8_conv.quantized_conv2d(*fused)
            err = _equal_or_fail(c['route'], c, c['out'], want)
            _equal_or_fail(c['route'], c, kernel(), want)
            cls = fused_class(c)
            bound, by = int8_conv.bound_ms(tuple(x.shape), tuple(qw.shape),
                                           tuple(want.shape),
                                           x.element_size(),
                                           want.element_size())
            ms = graph_ms(kernel, 5, 2)
            plain = graph_ms(
                lambda: int8_conv.quantized_conv2d_reference(*fused), 5, 2)
            add(c['route'], ms, plain, bound, by, err, cls)
            row = {'route': c['route'], 'class': cls, 'x': list(x.shape),
                   'dtype': str(x.dtype), 'contiguous': x.is_contiguous(),
                   'w': list(qw.shape), 'stride': list(stride),
                   'groups': groups, 'ms': ms, 'plain_ms': plain,
                   'bound_ms': bound, 'bound_by': by}
            shapes.append(row)
            qx = int8_conv._quantize(x, c['ascale'])
        else:
            qx = c['qx']
        # the int32 accumulators: int8_conv2d's and, on a 1x1, the s8
        # GEMM's, against the fp64 conv
        want = int8_conv.int8_conv2d_reference(qx, qw, stride, padding,
                                               groups)
        got = {'int8_conv2d': int8_conv.int8_conv2d(qx, qw, stride, padding,
                                                    groups)}
        gemm = int8_conv.route(qx.shape, qw.shape, stride, padding,
                               groups) == 'int_mm'
        if gemm:
            got['int_mm'] = c['out'] if c['route'] == 'int_mm' else \
                int8_conv.int_mm(qx, qw)
        for r, g in got.items():
            totals[r]['max_abs_err'] = max(totals[r]['max_abs_err'],
                                           _equal_or_fail(r, c, g, want))
        timed = 'int_mm' if gemm else 'int8_conv2d'
        if timed == 'int_mm':
            ms = graph_ms(lambda: int8_conv.int_mm(qx, qw), 5, 2)
        else:
            ms = graph_ms(lambda: int8_conv.int8_conv2d(
                qx, qw, stride, padding, groups), 5, 2)
        plain = time_ms(lambda: int8_conv.int8_conv2d_reference(
            qx, qw, stride, padding, groups), 2, 1)
        bound, by = int8_conv.bound_ms(tuple(qx.shape), tuple(qw.shape),
                                       tuple(want.shape))
        add(timed, ms, plain, bound, by, 0.0, cls)
        sums = {'route': timed, 'class': cls, 'x': list(qx.shape),
                'w': list(qw.shape), 'stride': list(stride),
                'groups': groups, 'ms': ms, 'plain_ms': plain,
                'bound_ms': bound, 'bound_by': by}
        if timed == 'int_mm' and c['route'] == 'quantized_conv1x1':
            totals['quantized_conv1x1']['library_ms'] += ms
            lc = classes[cls]['quantized_conv1x1']
            lc['library_ms'] = lc.get('library_ms', 0.0) + ms
        if timed == 'int8_conv2d':
            lib = library_conv(qx, qw, stride, padding, groups)
            exact = bool(torch.equal(lib, lib.round()) and torch.equal(
                lib.round().to(torch.int32).permute(0, 2, 3, 1), want))
            lib_ms = graph_ms(lambda: library_conv(qx, qw, stride, padding,
                                                   groups), 5, 2)
            totals['int8_conv2d']['library_ms'] += lib_ms
            totals['int8_conv2d']['library_exact'] += exact
            lc = classes.setdefault(cls, {}).setdefault(
                'library', {'ms': 0.0, 'exact': 0})
            lc['ms'] += lib_ms
            lc['exact'] += exact
            sums.update(library_ms=lib_ms, library_exact=exact)
        shapes.append(sums)
    return {'totals': totals, 'classes': classes, 'shapes': shapes}


def expect_int8(what: str, per_route: dict) -> dict:
    counts = dict(int8_conv.launches)
    if counts != per_route:
        raise AssertionError(f'{what}: int8 routes launched {counts}, '
                             f'expected {per_route}')
    return counts


def quant_phase(batch: int, seed: int, device, card: str,
                kernels_only: bool = False):
    """The int8 PTQ path of the shipped student at D2@768: the pack, both
    int8 routes against the plain version on every quantized conv's own
    input, make_serving_fn(quant_pack=) against the bf16 fused predictor,
    and evaluate() with quant_inference=True on a Freiburg tree. With
    `kernels_only` (`--int8-kernels`) only the pack and the recorded
    forward's checks and timings."""
    t0 = time.perf_counter()
    sections = {}
    model = seeded_detector(seed, batch, device)
    sd = model.state_dict()
    rng = np.random.default_rng(seed + 2)
    images = rng.standard_normal(
        (batch, IMAGE_SIZE, IMAGE_SIZE, IN_CHANNELS), dtype=np.float32)
    x = torch.as_tensor(images, device=device)

    # (1) the pack, calibrated on the batch through the module tree the
    # serving function runs (bf16)
    net = fused_forward.eval_module(model, sd, device, torch.bfloat16)
    t = time.perf_counter()
    pack = quant.build_quant_pack(net, x, [x], state_dict=sd)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t

    # (2) one forward recorded: every call's operands through both routes
    calls = []
    int8_conv.reset_launches()
    with recorded_int8_calls(calls):
        quant.quantized_apply(net, pack, x)
    torch.cuda.synchronize()
    per_forward = {r: sum(c['route'] == r for c in calls)
                   for r in INT8_ROUTES}
    # int8_conv2d is recorded 0 times: a launch of it fails here
    expect_int8('the recorded forward', per_forward)
    if per_forward != INT8_PER_FORWARD:
        raise AssertionError(f'one forward made the int8 calls {per_forward}'
                             f', expected {INT8_PER_FORWARD}')
    fused_inputs = {r: {'calls': per_forward[r],
                        'not NHWC in memory': sum(
                            not c['x'].is_contiguous() for c in calls
                            if c['route'] == r),
                        'dtypes': sorted({str(c['x'].dtype) for c in calls
                                          if c['route'] == r})}
                    for r in FUSED}
    checked = check_int8_calls(calls)
    del calls
    sections['pack and routes'] = time.perf_counter() - t0
    print(f'{card} | int8 pack of D2@768: {len(pack.qkernels)} convs '
          f'built in {pack_s:.2f} s; one '
          f'forward: {json.dumps(per_forward)} calls, every fused output '
          'equal to the unfused sequence\'s and every int32 accumulator '
          'equal to the plain version\'s; fused inputs: '
          + json.dumps(fused_inputs), flush=True)
    for r, t in checked['totals'].items():
        print(f'{card} | {r}, one forward: ' + json.dumps(t), flush=True)
    for cls, t in sorted(checked['classes'].items()):
        print(f'{card} | class {cls}: ' + json.dumps(t), flush=True)
    if kernels_only:
        return checked

    # (3) make_serving_fn(quant_pack=): the first call (the eager pass and
    # the capture) on the wrappers' counters, then three replays, which
    # launch nothing of their own (the slice phase traces a replay's
    # kernels)
    serve = make_serving_fn(model, sd, IMAGE_SIZE, quant_pack=pack,
                            device=device)
    torch.cuda.synchronize()
    int8_conv.reset_launches()
    reset_launches()
    serve(x)
    torch.cuda.synchronize()
    counts = expect_int8('quantized serving, the first call',
                         {r: 2 * n for r, n in per_forward.items()})
    copies = dict(int8_conv.layout_copies)
    counts.update(expect_launches('quantized serving, the first call '
                                  '(no MBConv kernel)', 0, 2))
    first, again = expect_replays(
        'quantized serving, three replays',
        lambda: (serve(x), serve_many(
            serve, np.concatenate([images, images[:3]]), batch)))
    if not (torch.isfinite(first.boxes).all() and np.isfinite(
            again.scores).all()):
        raise AssertionError('quantized serving: non-finite detections')
    np.testing.assert_array_equal(again.valid[:batch],
                                  first.valid.cpu().numpy())

    # (4) against the bf16 fused predictor (the kernels) on the same batch
    fused = make_serving_fn(model, sd, IMAGE_SIZE, device=device)
    reset_launches()
    det_f = fused(x)
    out_f = fused.forward(x)
    torch.cuda.synchronize()
    for name, c in expect_launches('bf16 fused predictor, its first call '
                                   '(the eager pass and the capture) and '
                                   'a forward', 3 * BLOCKS, 2).items():
        counts[name] += c
    out_q = serve.forward(x)
    agree = agreement(out_q, out_f)
    matched = {'1px': match_detections(det_f, first),
               'iou0.5': match_detections(det_f, first, min_iou=0.5)}
    share = matched['iou0.5'][0] / max(matched['iou0.5'][1], 1)
    print(f'{card} | int8 against the bf16 fused predictor: corr '
          f'{json.dumps(agree)}; detections matched {json.dumps(matched)}, '
          f'share at IoU 0.5 {share:.4f}', flush=True)

    # (5) time: host ms, device busy ms and launches of a serve call
    timing = {'serve_ms': host_ms(lambda: serve(x), 3),
              'forward_ms': host_ms(lambda: serve.forward(x), 3),
              'bf16_fused_serve_ms': host_ms(lambda: fused(x), 3)}
    for part, fn in (('serve', lambda: serve(x)),
                     ('forward', lambda: serve.forward(x))):
        prof = device_breakdown(fn, 2)
        timing[part] = {k: v for k, v in prof.items() if k != 'top'}
        if prof['measured']:
            timing[part]['busy_share'] = prof['busy_ms'] / \
                timing[f'{part}_ms']
    timing['layout_copies_first_call'] = copies
    timing['serve_graphs'] = graph_counts(int8=serve, bf16_fused=fused)
    print(f'{card} | quantized serving D2@768 batch {batch}: '
          + json.dumps(timing), flush=True)
    sections['serving'] = time.perf_counter() - t0

    # (6) evaluate() with quant_inference=True on a Freiburg tree: the
    # teachers on the MBConv kernels, the student on the int8 path
    shutil.rmtree(QUANT_DIR, ignore_errors=True)
    tree = QUANT_DIR / 'freiburg'
    write_freiburg_tree(tree, {m: [FIXTURES / f'{m}.jpg'] for m in TEACHERS},
                        SPLIT_FRAMES, seed)
    config = load_config(str(RECIPE), json.dumps(dict(
        data_path=str(tree), batch_size=batch, eval_batch_size=batch,
        fused_inference=True, quant_inference=True, eval_devices=1,
        exp_name=str(OUT_DIR / 'quant_eval'))))
    test_set = MultimodalDetection(config, 'test')
    teachers = {}
    for i, m in enumerate(TEACHERS):
        g = torch.Generator(device=device).manual_seed(seed + 20 + i)
        calib = torch.randn((batch, IMAGE_SIZE, IMAGE_SIZE,
                             {'thermal': 1}.get(m, 3)), generator=g,
                            device=device)
        t_model = seeded_detector(seed + 10 + i, batch, device, calib)
        teachers[m] = (t_model, t_model.state_dict())
    n_batches = -(-len(test_set) // batch)
    torch.cuda.synchronize()
    int8_conv.reset_launches()
    reset_launches()
    table = evaluate(teachers, (model, sd), test_set, config, device=device)
    torch.cuda.synchronize()
    got = expect_int8('quantized evaluate()',
                      {r: n_batches * n for r, n in per_forward.items()})
    for name, c in expect_launches('quantized evaluate() teachers',
                                   n_batches * BLOCKS * len(TEACHERS),
                                   n_batches * NMS_PER_EVAL_BATCH).items():
        counts[name] += c
    for r, c in got.items():
        counts[r] += c
    numbers = {k: v for k, v in table[0].items()
               if k not in ('exp_name', 'modality')}
    if not all(np.isfinite(v) for v in numbers.values()):
        raise AssertionError(f'quantized evaluate() returned {table}')
    with open(OUT_DIR / 'quant_eval' / 'resources.0.csv', newline='') as f:
        fps = float(next(csv.DictReader(f))['FramesPerSec'])
    print(f'{card} | evaluate() with quant_inference=True on '
          f'{len(test_set)} Freiburg frames: {fps:.2f} frames/s, '
          + json.dumps(numbers), flush=True)
    shutil.rmtree(QUANT_DIR)
    sections['evaluate'] = time.perf_counter() - t0
    print(f'quant phase seconds elapsed: {json.dumps(sections)}', flush=True)

    # gates: the int8 path stays near the bf16 one (see QUANT_*_FLOOR)
    if not share >= QUANT_MATCH_FLOOR:
        raise AssertionError(f'int8 detections: {share:.3f} of the bf16 '
                             f'predictor\'s matched at IoU 0.5, below '
                             f'{QUANT_MATCH_FLOOR}')
    for f in ('classification', 'regression', 'logits'):
        if not agree[f] > QUANT_CORR_FLOOR:
            raise AssertionError(f'int8 {f} correlation {agree[f]} to the '
                                 f'bf16 predictor <= {QUANT_CORR_FLOOR}')
    return {'counts': counts, 'pack_s': pack_s, 'convs': len(pack.qkernels),
            'per_forward': per_forward, 'fused_inputs': fused_inputs,
            'int8': checked,
            'vs_bf16': {'corr': agree, 'matched': matched,
                        'share_iou0.5': share},
            'timing': timing,
            'evaluate': {'frames_per_s': fps, **numbers},
            'sections': sections}


# ---- phase 11: export ----

EXPORT_DIR = ROOT / 'build' / 'export_smoke'
EXPORT_TIMEOUT_S = 600


def export_worker(spec: dict) -> None:
    """The fresh process of phase 11: load the artifact (no model is
    built), run it on the saved batch twice, save its Detections and the
    launches of each call."""
    predict = load_predictor(spec['path'], device=spec['device'])
    x = torch.load(spec['x'], map_location=spec['device'])
    launches = []
    for _ in range(2):
        reset_launches()
        dets = predict(x)
        _sync(spec['device'])
        launches.append(launch_counts())
    torch.save({'detections': [t.cpu() for t in dets],
                'launches': launches}, spec['out'])


def export_phase(batch: int, seed: int, device, card: str):
    """export_predictor / load_predictor at D2@768: the card's predictor
    exported and replayed bit for bit in a fresh process, a CPU
    predictor's export moved to the card, the serve call's device time."""
    t0 = time.perf_counter()
    sections = {}
    model = seeded_detector(seed, batch, device)
    sd = model.state_dict()
    rng = np.random.default_rng(seed + 2)
    x = torch.as_tensor(rng.standard_normal(
        (batch, IMAGE_SIZE, IMAGE_SIZE, IN_CHANNELS), dtype=np.float32),
        device=device)
    serve = make_serving_fn(model, sd, IMAGE_SIZE, device=device)
    want = serve(x)
    shutil.rmtree(EXPORT_DIR, ignore_errors=True)
    EXPORT_DIR.mkdir(parents=True)

    # (1) export on the card
    path = EXPORT_DIR / 'predictor.pt2'
    t = time.perf_counter()
    export_predictor(serve, batch, IMAGE_SIZE, IN_CHANNELS, str(path))
    export_s = time.perf_counter() - t
    size_mb = path.stat().st_size / 2 ** 20
    sections['export'] = time.perf_counter() - t0

    # (2) replay in a fresh process: bit for bit, 23 launches a call
    torch.save(x.cpu(), EXPORT_DIR / 'x.pt')
    spec = {'path': str(path), 'x': str(EXPORT_DIR / 'x.pt'),
            'out': str(EXPORT_DIR / 'replayed.pt'), 'device': str(device)}
    (EXPORT_DIR / 'spec.json').write_text(json.dumps(spec))
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, str(ROOT / 'chip_smoke.py'), '--export-worker',
         '--spec', str(EXPORT_DIR / 'spec.json')], cwd=str(ROOT),
        capture_output=True, text=True, timeout=EXPORT_TIMEOUT_S)
    replay_s = time.perf_counter() - t
    if proc.returncode != 0:
        raise AssertionError(f'the replay process failed:\n{proc.stdout}\n'
                             f'{proc.stderr[-4000:]}')
    replayed = torch.load(EXPORT_DIR / 'replayed.pt')
    for field, got, w in zip(want._fields, replayed['detections'], want):
        if not torch.equal(got, w.cpu()):
            raise AssertionError(f'the replayed artifact\'s {field} differ '
                                 'from make_serving_fn\'s')
    counts = {n: 0 for n in launch_counts()}
    for i, c in enumerate(replayed['launches']):
        for name, n in expect_counts(f'replayed artifact, call {i}', c,
                                     BLOCKS, 1).items():
            counts[name] += n
    sections['replay'] = time.perf_counter() - t0

    # (3) a CPU predictor exported for the card (platforms=('cuda',)),
    # loaded here: phase 4's detection-match gate against the card's own
    cpu_model = copy.deepcopy(model).cpu()
    cpu_serve = make_serving_fn(cpu_model, cpu_model.state_dict(),
                                IMAGE_SIZE, device='cpu')
    path_cpu = EXPORT_DIR / 'predictor_from_cpu.pt2'
    t = time.perf_counter()
    export_predictor(cpu_serve, batch, IMAGE_SIZE, IN_CHANNELS,
                     str(path_cpu), platforms=(device.type,))
    export_cpu_s = time.perf_counter() - t
    moved = load_predictor(str(path_cpu), device=device)
    reset_launches()
    det_m = moved(x)
    torch.cuda.synchronize()
    for name, c in expect_launches('CPU export on the card',
                                   BLOCKS, 1).items():
        counts[name] += c
    got, total = match_detections(want, det_m)
    bit_equal = all(torch.equal(a, b) for a, b in zip(det_m, want))
    if total == 0 or got < 0.9 * total:
        raise AssertionError(f'CPU export on the card: {got}/{total} '
                             'detections matched within 1 px')
    sections['cpu export'] = time.perf_counter() - t0
    result = {'export_s': export_s, 'file_mb': size_mb,
              'replay_process_s': replay_s, 'export_from_cpu_s': export_cpu_s,
              'cpu_export_matched_1px': [got, total],
              'cpu_export_bit_equal': bit_equal,
              'serve_graphs': graph_counts(serve=serve)}
    print(f'{card} | export D2@768 batch {batch}: ' + json.dumps(result),
          flush=True)
    shutil.rmtree(EXPORT_DIR)

    # (4) the serve call's device time: utils.profiling.device_time (a
    # CUDA graph of the call, replayed) beside graph_ms and the host clock
    timing = {
        'device_time_ms': profiling.device_time(serve, (x,), iters=3) * 1e3,
        'graph_ms': graph_ms(lambda: serve(x), 3, 1),
        'host_ms': host_ms(lambda: serve(x), 3)}
    result.update(timing)
    print(f'{card} | serve call D2@768 batch {batch}: ' + json.dumps(timing),
          flush=True)
    sections['device time'] = time.perf_counter() - t0
    print(f'export phase seconds elapsed: {json.dumps(sections)}',
          flush=True)
    return {'counts': counts, **result, 'sections': sections}


# the NMS kernel's shapes on the main path: (B, K, max_out)
NMS_SHAPES = {'serve_b1': (1, 512, 100), 'serve_b32': (32, 512, 100),
              'teachers': (8, 512, 32), 'fusion_mix': (8, 192, 64),
              'fusion': (8, 96, 64)}
# one train step's NMS calls at batch 8 (three teachers, the fusion under
# the audio mix): the report's ms, plain_ms and bound_ms sum over them
NMS_STEP = {'teachers': len(TEACHERS), 'fusion_mix': 1}
# operations of one IoU test, as ops/boxes.py pairwise_iou_xyxy computes
# it and the threshold decides it: the second box's area (2 subs, a mul),
# 4 max / min, 2 subs, 2 clamps, the intersection's mul, an add, a sub, the
# union's clamp, a division and the comparison
NMS_IOU_OPS = 17


def nms_inputs(seed: int, b: int, k: int):
    """Candidates as the post-process hands them over: boxes of 8-160 px
    crowded into a quarter of the image so that many overlap, offset by
    class (batched_class_nms_fixed's coord_bound 769), scores on 64 levels
    (ties), 80% valid."""
    g = torch.Generator().manual_seed(seed)
    corner = torch.rand(b, k, 2, generator=g) * (IMAGE_SIZE / 4)
    size = 8 + 152 * torch.rand(b, k, 2, generator=g)
    cls = torch.randint(0, NUM_CLASSES, (b, k, 1), generator=g)
    boxes = torch.cat([corner, corner + size], -1) + cls * (IMAGE_SIZE + 1.0)
    scores = torch.randint(0, 64, (b, k), generator=g) / 64.0
    return boxes, scores, torch.rand(b, k, generator=g) < 0.8


def nms_phase(seed: int, device, card: str) -> dict:
    """The NMS kernel against the plain version, bit for bit, and timed
    alone at each of NMS_SHAPES."""
    rows, max_err = {}, 0.0
    for name, (b, k, max_out) in NMS_SHAPES.items():
        args = [t.to(device) for t in nms_inputs(seed + k + b, b, k)]

        def kernel():
            return nms.nms_fixed(*args, 0.5, max_out)

        def plain():
            return nms.nms_fixed_reference(*args, 0.5, max_out)

        reset_launches()
        got = kernel()
        torch.cuda.synchronize()
        expect_launches(f'nms {name}', 0, 1)
        want = plain()
        for g, w in zip(got, want):
            max_err = max(max_err, float((g.double() - w.double()).abs()
                                         .max()))
            if g.dtype == torch.float32:
                g, w = g.view(torch.int32), w.view(torch.int32)
            if not torch.equal(g, w):
                raise RuntimeError(f'nms {name}: the kernel differs from the '
                                   'plain version')
        m = got[0].shape[1]
        # each input read once, each output written once; the fp32 IoU
        # tests of the K (K - 1) / 2 pairs
        t_bytes = (b * k * (16 + 4 + 1) + b * m * (8 + 4 + 1)) / 3.35e12
        t_ops = NMS_IOU_OPS * b * k * (k - 1) / 2 / 67e12
        r = rows[name] = {
            'b': b, 'k': k, 'max_out': max_out, 'kept': int(got[2].sum()),
            'ms': graph_ms(kernel), 'host_ms': host_ms(kernel, 20),
            'plain_ms': time_ms(plain, 5),
            'bound_ms': max(t_bytes, t_ops) * 1e3,
            'bound_bytes_ms': t_bytes * 1e3}
        print(f"{card} | nms {name} (B {b}, K {k}): {r['ms']:.4f} ms "
              f"device, {r['host_ms']:.3f} ms host a call, bound "
              f"{r['bound_ms']:.5f} ms, plain {r['plain_ms']:.2f} ms; "
              'bit-equal, 1 launch', flush=True)
    step = {f: sum(n * rows[s][f] for s, n in NMS_STEP.items())
            for f in ('ms', 'plain_ms', 'bound_ms', 'bound_bytes_ms')}
    return {'shapes': rows, 'max_abs_err': max_err, 'step': step}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--batch', type=int, default=8)
    p.add_argument('--dist-worker', choices=('steps', 'cli'),
                   help='run as a rank of phase 9 (started by the phase)')
    p.add_argument('--export-worker', action='store_true',
                   help='run as the replay process of phase 11')
    p.add_argument('--spec', help="a worker's JSON spec (phases 9, 11)")
    p.add_argument('--int8-kernels', action='store_true',
                   help="only phase 10's checks and timings of the int8 "
                   'kernels on one forward (no result line)')
    p.add_argument('--nms-kernel', action='store_true',
                   help="only phase 12's checks and timings of the NMS "
                   'kernel (no result line)')
    a = p.parse_args(argv)
    if a.export_worker:
        export_worker(json.loads(Path(a.spec).read_text()))
        return 0
    if a.dist_worker:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        spec = json.loads(Path(a.spec).read_text())
        {'steps': dist_steps_worker, 'cli': dist_cli_worker}[
            a.dist_worker](spec)
        return 0
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

    if a.nms_kernel:
        OUT_DIR.mkdir(exist_ok=True)
        (OUT_DIR / f'nms_kernel_s{a.seed}.json').write_text(json.dumps(
            {'card': card, 'build_s': build_s,
             **nms_phase(a.seed, device, card)}, indent=1))
        return 0
    if a.int8_kernels:
        checked = quant_phase(a.batch, a.seed, device, card,
                              kernels_only=True)
        OUT_DIR.mkdir(exist_ok=True)
        (OUT_DIR / f'int8_kernels_s{a.seed}.json').write_text(json.dumps(
            {'card': card, 'build_s': build_s, **checked}, indent=1,
            default=str))
        return 0
    totals, rows = kernel_phase(a.batch, a.seed, device)
    results = {'slice': slice_phase(a.batch, a.seed, device),
               'teachers': teacher_phase(a.batch, a.seed, device, card),
               'train': train_phase(a.batch, a.seed, device, card),
               'cli': cli_phase(a.batch, a.seed, device, card),
               'data': data_phase(a.batch, a.seed, device, card),
               'dist': dist_phase(a.batch, a.seed, device, card),
               'quant': quant_phase(a.batch, a.seed, device, card),
               'export': export_phase(a.batch, a.seed, device, card)}
    nms_checked = nms_phase(a.seed, device, card)

    kernels = []
    for name, t in totals.items():
        kernels.append({
            'name': name, 'route': 'cuda', 'source': SOURCES[name],
            'replaces': REPLACES,
            'launches': sum(r['counts'][name] for r in results.values()),
            'max_abs_err': t['max_abs_err'], 'ms': t['ms'],
            'plain_ms': t['plain_ms'], 'bound_ms': t['bound_ms'],
            'bound_by': ('bytes' if t['bound_bytes_ms'] * 2 >= t['bound_ms']
                         else 'operations'),
            'library_ms': None})
    int8_totals = results['quant']['int8']['totals']
    for name, lib in (('int8_conv2d', 'library_ms'),
                      ('quantized_conv2d', None),
                      ('quantized_conv1x1', 'library_ms')):
        t = int8_totals[name]
        kernels.append({
            'name': name, 'route': 'cuda', 'source': INT8_SOURCES[name],
            'replaces': INT8_REPLACES,
            'launches': results['quant']['counts'][name]
            + results['slice']['int8_counts'].get(name, 0),
            'max_abs_err': t['max_abs_err'], 'ms': t['ms'],
            'plain_ms': t['plain_ms'], 'bound_ms': t['bound_ms'],
            'bound_by': ('bytes' if t['bound_bytes_ms'] * 2 >= t['bound_ms']
                         else 'operations'),
            'library_ms': t[lib] if lib else None})
    t = nms_checked['step']
    kernels.append({
        'name': 'nms_fixed', 'route': 'cuda',
        'source': 'mm_distillnet_torch/csrc/nms.cu',
        'replaces': 'mm_distillnet_tpu/ops/nms.py:_greedy_suppress',
        'launches': sum(r['counts']['nms_fixed'] for r in results.values()),
        'max_abs_err': nms_checked['max_abs_err'], 'ms': t['ms'],
        'plain_ms': t['plain_ms'], 'bound_ms': t['bound_ms'],
        'bound_by': ('bytes' if t['bound_bytes_ms'] * 2 >= t['bound_ms']
                     else 'operations'),
        'library_ms': None})
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / 'chip_smoke.json').write_text(json.dumps({
        'card': card, 'kind': kind, 'torch': torch.__version__,
        'cuda': torch.version.cuda, 'batch': a.batch, 'seed': a.seed,
        'build_s': build_s, 'kernels': kernels, 'blocks': rows,
        **results, 'nms': nms_checked}, indent=1, default=str))
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
