"""A closed loop of one client over `make_serving_fn`'s predictor: each
call hands over a batch of compact-audio frames (80 mel rows x image size
x the student's channels, fp32) from pinned host memory and waits for the
detections, so the copy to the card, the mel stretch, the fused forward
and the post-process are all inside the timed call.

Traffic keys: `frames_per_call`, `distinct_calls` (the loop cycles over
that many seeded batches), `check_frames` (served frames sampled from the
seed and judged after the window), `trace_calls` (calls in a traced run).
"""
from __future__ import annotations

import random
import time
from typing import Dict, List, Optional

import torch

from .. import flops
from ..check import detection_gaps
from ..reference import run as reference
from ..reference.resize import maybe_stretch_mel_axis
from ..seeded import calibrated_state, seed_of, sync

CALIBRATION_FRAMES = 8


class Cell:
    """One served configuration under one traffic mix, built from the
    seed. `variant='int8'` serves the program's int8 path instead (the
    control), and `fault` breaks the predictor underneath
    (benchmark/faults.py): neither in a benchmark run."""

    def __init__(self, spec: dict, seed: int, device,
                 variant: Optional[str] = None, fault=None):
        t = time.perf_counter()
        cfg, traffic = spec['config'], spec['traffic']
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.dev = device
        self.batch = traffic['frames_per_call']
        self.channels = cfg['student_channels']
        size = cfg['image_size']
        g = torch.Generator(device=device).manual_seed(seed_of(seed, 2))
        frames = torch.randn(
            (traffic['distinct_calls'], self.batch, cfg['mel_bins'], size,
             self.channels), generator=g, device=device)
        calib = frames.flatten(0, 1)[:CALIBRATION_FRAMES]
        self.state = calibrated_state(
            cfg, self.channels, seed,
            maybe_stretch_mel_axis(calib, size))
        pinned = device.type == 'cuda'
        self.inputs = [f.cpu().pin_memory() if pinned else f.cpu()
                       for f in frames]
        self.judge_frames = frames      # the reference reads them later
        sync(device)
        self.setup_parts = {'weights_and_frames_s': time.perf_counter() - t}
        t = time.perf_counter()
        self.predict = self._program(variant, calib)
        sync(device)
        self.setup_parts['program_s'] = time.perf_counter() - t
        if fault is not None:
            self.predict = fault(self.predict)
        self.outputs: List = []

    def _program(self, variant, calib):
        from mm_distillnet_torch.models.efficientdet import EfficientDet
        from mm_distillnet_torch.serving import make_serving_fn
        cfg, recipe = self.cfg, self.cfg['recipe']
        with torch.device(self.dev):
            shell = EfficientDet(cfg['num_classes'], cfg['compound_coef'],
                                 self.channels)
        pack = None
        if variant == 'int8':
            from mm_distillnet_torch.models.fused_forward import eval_module
            from mm_distillnet_torch.ops.resize import \
                maybe_stretch_mel_axis as stretch
            from mm_distillnet_torch.quant import build_quant_pack
            x = stretch(calib, cfg['image_size'])
            net = eval_module(shell, self.state, self.dev, torch.bfloat16)
            pack = build_quant_pack(net, x, [x], state_dict=self.state)
        elif variant is not None:
            raise ValueError(f'unknown variant {variant!r}')
        return make_serving_fn(
            shell, self.state, cfg['image_size'],
            conf_threshold=recipe['conf_threshold'],
            nms_threshold=recipe['nms_threshold'],
            num_candidates=recipe['num_candidates'],
            max_detections=recipe['max_detections'],
            valid_prediction_ids=cfg['valid_prediction_ids'],
            num_classes=cfg['num_classes'], dtype=torch.bfloat16,
            quant_pack=pack, device=self.dev)

    # ------------------------------------------------------------ the loop

    def warm(self) -> None:
        """Every shape of the window: the cell's batch, from pinned
        memory."""
        for i in range(2):
            self.predict(self.inputs[i % len(self.inputs)])
        sync(self.dev)

    def call(self, i: int) -> None:
        """Call i of the window: hand-off to detections after a
        synchronize. The detections are kept for the check."""
        dets = self.predict(self.inputs[i % len(self.inputs)])
        sync(self.dev)
        self.outputs.append(dets)

    def frames(self, calls: int) -> int:
        return calls * self.batch

    def counters(self, calls: int) -> Dict:
        """What the per-layer readers need of `calls` calls."""
        cfg = self.cfg
        fwd = flops.forward_flops(cfg['compound_coef'], cfg['num_classes'],
                                  self.channels, self.batch,
                                  cfg['image_size'])
        return {'frames': self.frames(calls), 'calls': calls,
                'model_flops': calls * fwd,
                'mbconv_forwards': [(self.batch, calls)],
                'compound_coef': cfg['compound_coef'],
                'image_size': cfg['image_size']}

    def free_program(self) -> None:
        self.predict = None
        self.inputs = None
        if self.dev.type == 'cuda':
            torch.cuda.empty_cache()

    # ------------------------------------------------------------ the check

    def sample(self) -> List:
        """(call index, row) of the served frames the check judges: every
        row of the batch in turn, each from a call drawn from the seed
        among every call of the run, so that a fault in one row of every
        batch is judged as often as the sample meets the batch."""
        calls = len(self.outputs)
        rng = random.Random(seed_of(self.seed, 4))
        k = min(self.traffic['check_frames'], calls * self.batch)
        picks = set()
        while len(picks) < k:
            row = len(picks) % self.batch
            picks.add((rng.randrange(calls), row))
        return sorted(picks)

    def check(self, explain: Optional[dict] = None) -> Dict[str, float]:
        """The served detections of the sampled frames against the
        reference's forward and post-process of the same frames, by
        check.detection_gaps' `score_gap` beyond the same gap of the
        reference run in the configuration's precision, over all judged
        frames and on the worst of them: a sound bf16 program reads about
        0 or below, whatever the seed's weights make of rounding."""
        cfg, recipe = self.cfg, self.cfg['recipe']
        picks = self.sample()
        got = [torch.stack([self.outputs[i][f][r] for i, r in picks])
               for f in range(4)]
        pool = len(self.judge_frames)
        frames = torch.stack([self.judge_frames[i % pool][r]
                              for i, r in picks])
        model = reference.detector(cfg, self.channels, self.state, self.dev)
        raw = reference.raw_detections(model, frames, cfg['image_size'])
        class_valid, _ = reference.class_tables(cfg, self.dev)
        ref = reference.post_process(raw, cfg['image_size'], class_valid,
                                     recipe, recipe['max_detections'])
        judge = (raw['scores'], raw['boxes'], ref, class_valid,
                 recipe['conf_threshold'], recipe['num_candidates'],
                 recipe['max_detections'])
        gaps = detection_gaps(*got, *judge)
        # the yardstick: the same gap of the reference itself, run in the
        # precision the configuration states, on the same frames
        low = getattr(torch, cfg['compute_dtype'])
        del model
        model = reference.detector(cfg, self.channels, self.state,
                                   self.dev).to(low)
        raw_low = reference.raw_detections(model, frames, cfg['image_size'],
                                           dtype=low)
        own = reference.post_process(raw_low, cfg['image_size'],
                                     class_valid, recipe,
                                     recipe['max_detections'])
        yard = detection_gaps(*own, *judge)
        print(f'detections per judged frame: served '
              f'{float(got[3].float().sum(1).mean()):.2f}, reference '
              f'{float(ref.valid.float().sum(1).mean()):.2f}; score gap '
              f'{gaps["score_gap"]:.6f}, the reference in {low} '
              f'{yard["score_gap"]:.6f}', flush=True)
        if explain is not None:
            explain.update(gaps)
            explain['yard'] = yard
        # and the worst judged frame, where a wrong row of a batch shows
        # undiluted by the rest
        worst = max(a - b for a, b in zip(gaps['frame_gaps'],
                                          yard['frame_gaps']))
        return {'det_gap_beyond_bf16': gaps['score_gap'] - yard['score_gap'],
                'det_worst_frame_beyond_bf16': worst}
