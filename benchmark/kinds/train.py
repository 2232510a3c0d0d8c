"""A closed loop of `make_train_step` steps of the shipped distillation
recipe: three frozen teachers on the MBConv kernels
(`make_teachers(fused=True)`), the student's train-mode forward and
backward in bf16, its losses and Adam (`init_train_state`). The loop
cycles over `distinct_calls` seeded batches staged on the card in the
transfer dtype that `train()` uses (bf16): rgb, thermal and depth at the
image size, the audio as the compact ingest, stretched inside the step.

Set-up builds the step once and drives it through its first
`check_steps` steps, the window's own call on batches that all differ;
those steps are what the check judges, and the window continues the same
object. During those steps a spy on the step's label fusion keeps its
input (each teacher's label rows) and output (the fused pseudo-labels),
which the reference follows and judges (PERF.md); the window runs without
it.

Traffic keys: `frames_per_call` (the batch), `distinct_calls`,
`check_steps`, `trace_calls`.
"""
from __future__ import annotations

import configparser
import time
from typing import Dict, Optional

import torch

from .. import flops
from ..check import (detection_gaps, label_rows_as_detections, leaf_gap,
                     median_leaf_gap, moving_leaves, norms)
from ..reference import run as reference
from ..reference.resize import maybe_stretch_mel_axis
from ..seeded import calibrated_state, seed_of, sync


def recipe_section(recipe: dict) -> configparser.SectionProxy:
    """The recipe as the config section the program's trainer reads."""
    keys = {'train_method': recipe['train_method'],
            'kd_loss': recipe['kd_loss'], 'div_loss': 'None',
            'w_main': recipe['w_main'], 'w_kd': recipe['w_kd'],
            'T': recipe['T'], 'p': recipe['p'],
            'optimizer': recipe['optimizer'], 'lr': recipe['lr'],
            'b1': recipe['b1'], 'b2': recipe['b2'], 'grad_clip': -1,
            'conf_threshold': recipe['conf_threshold'],
            'nms_threshold': recipe['nms_threshold'],
            'nms_candidates': recipe['num_candidates'],
            'max_det_per_teacher': recipe['max_det_per_teacher'],
            'max_gt': recipe['max_gt'], 'student_modality': 'audio',
            'use_labels': False, 'audio_augmentation_merge': False,
            'compute_dtype': 'bfloat16'}
    parser = configparser.ConfigParser()
    parser.read_dict({'DEFAULT': {k: str(v) for k, v in keys.items()}})
    return parser['DEFAULT']


class Cell:
    """The train step of one configuration under one traffic mix, built
    from the seed. `fault` breaks the step underneath (benchmark/faults.py;
    never in a benchmark run)."""

    def __init__(self, spec: dict, seed: int, device,
                 variant: Optional[str] = None, fault=None):
        if variant not in (None, 'fp8'):
            raise ValueError(f'unknown variant {variant!r}')
        t = time.perf_counter()
        cfg, traffic = spec['config'], spec['traffic']
        self.cfg, self.traffic, self.seed, self.dev = cfg, traffic, seed, \
            device
        self.batch = traffic['frames_per_call']
        size = cfg['image_size']
        g = torch.Generator(device=device).manual_seed(seed_of(seed, 3))
        shapes = {m: (self.batch, size, size, c)
                  for m, c in cfg['teachers'].items()}
        shapes['audio'] = (self.batch, cfg['mel_bins'], size,
                           cfg['student_channels'])
        self.batches = [{m: torch.randn(s, generator=g, device=device,
                                        dtype=torch.bfloat16)
                         for m, s in shapes.items()}
                        for _ in range(traffic['distinct_calls'])]
        first = self.batches[0]
        self.teacher_states = {
            m: calibrated_state(cfg, c, seed_of(seed, 10 + i), first[m])
            for i, (m, c) in enumerate(cfg['teachers'].items())}
        self.student_state = calibrated_state(
            cfg, cfg['student_channels'], seed,
            maybe_stretch_mel_axis(first['audio'].float(), size))
        sync(device)
        self.setup_parts = {'weights_and_frames_s': time.perf_counter() - t}
        if variant == 'fp8':
            self._reference_in_fp8()
        else:
            self._build(fault)

    def _reference_in_fp8(self) -> None:
        """The control: the reference in the program's place, computed
        in fp8, with its own pseudo-labels."""
        steps = self.traffic['check_steps']
        ref = reference.train_steps(self.cfg, self.teacher_states,
                                    self.student_state, self.batches[:steps],
                                    self.seed, steps, lowp=True)
        self.readings = {
            'losses': ref['losses'], 'grad_norms': norms(ref['grads']),
            'update_norms': norms({k: p - self.student_state[k]
                                   for k, p in ref['params'].items()}),
            'rows': ref['teacher_rows'], 'fused': ref['fused']}
        self.state = self.step_fn = None

    def _build(self, fault) -> None:
        from mm_distillnet_torch.distill import train_step as ts
        from mm_distillnet_torch.models.efficientdet import EfficientDet
        from mm_distillnet_torch.ops.anchors import anchor_table
        from mm_distillnet_torch.train.trainer import distill_config_from
        cfg = self.cfg
        section = recipe_section(cfg['recipe'])
        with torch.device(self.dev):
            nets = {m: EfficientDet(cfg['num_classes'], cfg['compound_coef'],
                                    c) for m, c in cfg['teachers'].items()}
            student = EfficientDet(cfg['num_classes'], cfg['compound_coef'],
                                   cfg['student_channels'])
        frozen = ts.make_teachers(nets, self.teacher_states,
                                  image_size=cfg['image_size'], fused=True,
                                  dtype=torch.bfloat16, device=self.dev)
        self.state = ts.init_train_state(student, section,
                                         variables=self.student_state,
                                         device=self.dev)
        class_valid, lut = reference.class_tables(cfg, self.dev)
        self.step_fn = ts.make_train_step(
            frozen, distill_config_from(section, cfg['image_size']),
            anchor_table(cfg['image_size']), class_valid, lut,
            compute_dtype=torch.bfloat16, seed=self.seed, device=self.dev)
        if fault is not None:
            self.step_fn = fault(self.step_fn, ts)
        self._ts = ts
        sync(self.dev)
        t = time.perf_counter()
        self.readings = self._first_steps()
        sync(self.dev)
        self.setup_parts['first_steps_s'] = time.perf_counter() - t

    def _first_steps(self) -> dict:
        """The first `check_steps` steps, with the fusion spied on; the
        readings the check judges."""
        ts = self._ts
        fuse = ts.fuse_teacher_labels
        rows, fused = [], []

        def spy(per_teacher, pl_cfg):
            out = fuse(per_teacher, pl_cfg)
            rows.append([r.detach().clone() for r in per_teacher])
            fused.append(out.detach().clone())
            return out

        params = dict(self.state.model.named_parameters())
        p0 = {k: p.detach().clone() for k, p in params.items()}
        losses, grad_norms = [], None
        b1 = self.cfg['recipe']['b1']
        ts.fuse_teacher_labels = spy
        try:
            for k in range(self.traffic['check_steps']):
                metrics = self.step_fn(self.state, self.batches[k])
                losses.append(float(metrics['Total_loss']))
                if k == 0:
                    grad_norms = norms({
                        n: self.state.optimizer.state[p]['exp_avg'] / (1 - b1)
                        for n, p in params.items()
                        if p in self.state.optimizer.state})
        finally:
            ts.fuse_teacher_labels = fuse
        update_norms = norms({k: p.detach() - p0[k]
                              for k, p in params.items()})
        return {'losses': losses, 'grad_norms': grad_norms or {},
                'update_norms': update_norms, 'rows': rows, 'fused': fused}

    # ------------------------------------------------------------ the loop

    def warm(self) -> None:
        """The first steps, in set-up, warmed every shape of the window."""
        sync(self.dev)

    def call(self, i: int) -> None:
        """Step i of the window, on the next batch of the cycle; no
        synchronize (the window ends with one)."""
        k = (i + self.traffic['check_steps']) % len(self.batches)
        self.step_fn(self.state, self.batches[k])

    def frames(self, calls: int) -> int:
        return calls * self.batch

    def counters(self, calls: int) -> Dict:
        cfg = self.cfg
        size, cc, nc = cfg['image_size'], cfg['compound_coef'], \
            cfg['num_classes']
        step = sum(flops.forward_flops(cc, nc, c, self.batch, size)
                   for c in cfg['teachers'].values())
        # the student's forward, and its backward at twice the forward
        step += 3 * flops.forward_flops(cc, nc, cfg['student_channels'],
                                        self.batch, size)
        return {'frames': self.frames(calls), 'calls': calls,
                'model_flops': calls * step,
                'mbconv_forwards': [(self.batch,
                                     calls * len(cfg['teachers']))],
                'compound_coef': cc, 'image_size': size}

    def free_program(self) -> None:
        self.state = self.step_fn = None
        if self.dev.type == 'cuda':
            torch.cuda.empty_cache()

    # ------------------------------------------------------------ the check

    def check(self, explain: Optional[dict] = None) -> Dict[str, float]:
        return judge_steps(self.cfg, self.teacher_states, self.student_state,
                           self.batches, self.seed, self.readings, explain)


def pad_frames(labels: torch.Tensor, frames: int) -> torch.Tensor:
    """Label rows (B, G, 5) for `frames` frames: frames the side gave no
    rows for get none (label -1)."""
    if labels.shape[0] >= frames:
        return labels
    pad = torch.zeros((frames - labels.shape[0],) + labels.shape[1:],
                      dtype=labels.dtype, device=labels.device)
    pad[..., 4] = -1.0
    return torch.cat([labels, pad])


def judge_steps(cfg: dict, teacher_states, student_state, batches,
                seed: int, side: dict, explain: Optional[dict] = None
                ) -> Dict[str, float]:
    """A side's first steps (the program's, or the control's) against the
    reference's steps from the same state on the same batches, following
    the side's fused labels. `side`: 'losses', 'grad_norms' (first step,
    by leaf), 'update_norms' (after the steps, by leaf), 'rows' and
    'fused' (per step: each teacher's label rows, the fused labels)."""
    recipe = cfg['recipe']
    steps = len(side['losses'])
    frames = batches[0]['audio'].shape[0]
    ref = reference.train_steps(cfg, teacher_states, student_state,
                                batches[:steps], seed, steps,
                                labels=[pad_frames(f, frames)
                                        for f in side['fused']])
    ref_grads = norms(ref['grads'])
    ref_updates = norms({k: p - student_state[k]
                         for k, p in ref['params'].items()})
    leaves = moving_leaves(ref_grads)
    if explain is not None:
        # the worst leaves, where rounding dominates (PERF.md)
        explain['grad_gap'] = leaf_gap(side['grad_norms'], ref_grads, leaves)
        explain['update_gap'] = leaf_gap(side['update_norms'], ref_updates,
                                         leaves)
        for what, got, want in (('grad', side['grad_norms'], ref_grads),
                                ('update', side['update_norms'],
                                 ref_updates)):
            explain[what] = sorted(
                ([k, got.get(k, 0.0), want[k]] for k in leaves),
                key=lambda r: -abs(r[1] - r[2]) / max(r[2], 1e-30))[:6]
        explain['leaves'] = [len(leaves), len(ref_grads)]
    loss_gap = max(abs(a - b) / abs(b)
                   for a, b in zip(side['losses'], ref['losses']))
    label_to_pred = dict(zip(cfg['valid_label_ids'],
                             cfg['valid_prediction_ids']))
    class_valid, _ = reference.class_tables(cfg, batches[0]['audio'].device)
    labels = {}
    mismatch = 0
    for k in range(steps):
        for t, m in enumerate(cfg['teachers']):
            raw = ref['teacher_raw'][k][m]
            ref_rows = ref['teacher_rows'][k][t]
            got = label_rows_as_detections(side['rows'][k][t], label_to_pred)
            # label rows hold floor()ed coordinates clamped to the image
            boxes = torch.floor(raw['boxes']).clamp(0, cfg['image_size'])
            gaps = detection_gaps(*got, raw['scores'], boxes,
                                  label_rows_as_detections(ref_rows,
                                                           label_to_pred),
                                  class_valid, recipe['conf_threshold'],
                                  recipe['num_candidates'],
                                  recipe['max_det_per_teacher'])
            gaps.pop('frame_gaps')
            for name, v in gaps.items():
                labels[name] = max(labels.get(name, 0.0), v)
        again = reference.fuse(side['rows'][k], recipe)
        mismatch += int((again != side['fused'][k]).any(-1).sum())
    if explain is not None:
        explain['labels'] = labels
        # read, not compared: neither the control nor a fault reads ten
        # times its sound readings (PERF.md)
        explain['grad_gap_median'] = median_leaf_gap(side['grad_norms'],
                                                     ref_grads, leaves)
    return {'loss_gap': loss_gap,
            'update_gap_median': median_leaf_gap(side['update_norms'],
                                                 ref_updates, leaves),
            'label_score_gap': labels['score_gap'],
            'fusion_rows_differing': float(mismatch)}
