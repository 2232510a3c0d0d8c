"""The plain reference's entry points: the detector's forward and
post-process, the teachers' pseudo-labels and the shipped recipe's train
step with Adam, all in fp32 with TF32 off.

The modules beside this file are a frozen copy of the port's plain
modules (its models, post-process, losses and label fusion), so that no
later change to the program moves the yardstick. Nothing here imports the
program. `fp8_rounding` computes the same in the next precision below the
configuration's bf16, for the control (PERF.md).
"""
from __future__ import annotations

import contextlib
from typing import List, Mapping, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .anchors import anchor_table
from .boxes import clip_boxes, decode_boxes
from .efficientdet import EfficientDet
from .focal import focal_loss
from .mta import mta_loss
from .postprocess import (Detections, class_validity_table,
                          detections_to_labels, postprocess_detections)
from .pseudo_labels import PseudoLabelConfig, fuse_teacher_labels
from .resize import maybe_stretch_mel_axis


@contextlib.contextmanager
def fp32_exact():
    """fp32 matrix products and convolutions without TF32."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


FP8_MAX = 448.0   # largest float8_e4m3fn


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8_e4m3fn under one per-tensor scale, back in its
    own dtype; the gradient passes straight through."""
    scale = t.detach().abs().amax().clamp(min=1e-12) / FP8_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
    return t + (q - t.detach())


@contextlib.contextmanager
def fp8_rounding():
    """Every convolution and linear layer's input and weight rounded to
    fp8 (e4m3, a scale per tensor), the products in fp32: the reference
    in the precision below the configuration's bf16."""
    conv, linear = F.conv2d, F.linear

    def conv8(x, w, b=None, *args, **kwargs):
        return conv(_fp8(x), _fp8(w), b, *args, **kwargs)

    def linear8(x, w, b=None):
        return linear(_fp8(x), _fp8(w), b)

    F.conv2d, F.linear = conv8, linear8
    try:
        yield
    finally:
        F.conv2d, F.linear = conv, linear


def detector(config: dict, in_channels: int,
             state: Mapping[str, torch.Tensor], device) -> EfficientDet:
    """The reference detector of `config` holding `state`, fp32."""
    with torch.device(device):
        model = EfficientDet(config['num_classes'], config['compound_coef'],
                             in_channels)
    model.load_state_dict(state)
    return model.float()


def anchors_on(image_size: int, device) -> torch.Tensor:
    return torch.as_tensor(anchor_table(image_size), dtype=torch.float32,
                           device=device)


class RawOutput(dict):
    """scores (B, A, C) sigmoid, regression (B, A, 4), boxes (B, A, 4)
    xyxy decoded and clipped."""


@torch.no_grad()
def raw_detections(model: EfficientDet, frames: torch.Tensor,
                   image_size: int, block: int = 8,
                   dtype: torch.dtype = torch.float32) -> RawOutput:
    """The detector's eval forward over `frames` (B, H, W, C; compact
    audio is stretched first), in blocks of `block` frames, with the
    model and its input in `dtype` (the model's own, fp32 as a rule)."""
    model.eval()
    anchors = anchors_on(image_size, frames.device)
    scores, regression = [], []
    with fp32_exact():
        for i in range(0, frames.shape[0], block):
            x = maybe_stretch_mel_axis(frames[i:i + block].float(),
                                       image_size)
            out = model(x.to(dtype))
            scores.append(out.classification.float())
            regression.append(out.regression.float())
    scores = torch.cat(scores)
    regression = torch.cat(regression)
    boxes = clip_boxes(decode_boxes(anchors, regression), float(image_size))
    return RawOutput(scores=scores, regression=regression, boxes=boxes)


def post_process(raw: RawOutput, image_size: int, class_valid: torch.Tensor,
                 recipe: dict, max_detections: int) -> Detections:
    anchors = anchors_on(image_size, raw['scores'].device)
    return postprocess_detections(
        raw['scores'], raw['regression'], anchors, class_valid,
        image_size=image_size, conf_threshold=recipe['conf_threshold'],
        nms_threshold=recipe['nms_threshold'],
        num_candidates=recipe['num_candidates'],
        max_detections=max_detections)


def class_tables(config: dict, device):
    """(class_valid, pred_to_label) of the configuration's valid classes."""
    valid = class_validity_table(config['num_classes'],
                                 config['valid_prediction_ids'])
    lut = torch.full((config['num_classes'],), -1, dtype=torch.int32)
    for pid, label in zip(config['valid_prediction_ids'],
                          config['valid_label_ids']):
        lut[pid] = label
    return torch.as_tensor(valid, device=device), lut.to(device)


# ------------------------------------------------------------ train step

def step_seed(seed: int, step: int) -> int:
    """The seed of step `step`'s drop-connect generator: the recipe's
    per-step stream, (seed mod 2**31) * 2**32 + step."""
    return ((seed % (1 << 31)) * (1 << 32) + step) % (1 << 64)


class Adam:
    """Adam (Kingma and Ba), fp32: m and v from zero, bias-corrected."""

    def __init__(self, params: Sequence[torch.Tensor], lr: float,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.params = list(params)
        self.lr, self.betas, self.eps = lr, betas, eps
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        self.t += 1
        b1, b2 = self.betas
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            p.sub_(self.lr * (m / c1) / ((v / c2).sqrt() + self.eps))


def teacher_pass(teachers: Mapping[str, EfficientDet],
                 batch: Mapping[str, torch.Tensor], image_size: int):
    """{modality: (raw detections, BiFPN features)} of the frozen
    teachers' eval forwards."""
    anchors = anchors_on(image_size, next(iter(batch.values())).device)
    out = {}
    with torch.no_grad():
        for m, net in teachers.items():
            net.eval()
            o = net(batch[m].float())
            boxes = clip_boxes(decode_boxes(anchors, o.regression.float()),
                               float(image_size))
            out[m] = (RawOutput(scores=o.classification.float(),
                                regression=o.regression.float(),
                                boxes=boxes),
                      [f.float() for f in o.features])
    return out


def teacher_labels(raw: RawOutput, image_size: int, class_valid,
                   pred_to_label, recipe: dict) -> torch.Tensor:
    """One teacher's padded label rows (B, max_det, 6) with scores."""
    dets = post_process(raw, image_size, class_valid, recipe,
                        recipe['max_det_per_teacher'])
    return detections_to_labels(dets, pred_to_label, image_size,
                                include_scores=True)


def fuse(per_teacher: Sequence[torch.Tensor], recipe: dict) -> torch.Tensor:
    """The cross-teacher label fusion (B, max_gt, 5)."""
    return fuse_teacher_labels(per_teacher, PseudoLabelConfig(
        image_size=0, fusion_iou=recipe['fusion_iou'],
        max_gt=recipe['max_gt']))


def student_loss(student: EfficientDet, x: torch.Tensor,
                 annotations: torch.Tensor, teacher_features,
                 anchors: torch.Tensor, recipe: dict,
                 generator: torch.Generator) -> torch.Tensor:
    """The shipped recipe's loss: w_main (focal regression + class) +
    w_kd sum over the teachers of MTA(student, teacher) features."""
    student.train()
    out = student(x, generator=generator)
    reg, cls = focal_loss(out.classification, out.regression, annotations,
                          anchors)
    kd = torch.stack([mta_loss(list(out.features), ft, recipe['T'],
                               recipe['p'], True)
                      for ft in teacher_features]).sum()
    return recipe['w_main'] * (reg + cls) + recipe['w_kd'] * kd


def train_steps(config: dict, teacher_states: Mapping[str, Mapping],
                student_state: Mapping, batches: List[Mapping],
                seed: int, steps: int,
                labels: Optional[List[torch.Tensor]] = None,
                lowp: bool = False) -> dict:
    """`steps` steps of the recipe from `student_state` on `batches` (one
    per step). With `labels` (one (B, max_gt, 5) tensor per step: the
    judged side's fused pseudo-labels) the student's focal loss follows
    those; without, the reference's own. Returns the losses, the first
    step's gradients, the parameters after the last step, and per step the
    teachers' raw detections and label rows. `lowp`: in fp8 (the
    control)."""
    recipe = config['recipe']
    size = config['image_size']
    dev = next(iter(batches[0].values())).device
    rounding = fp8_rounding() if lowp else contextlib.nullcontext()
    teachers = {m: detector(config, config['teachers'][m], sd, dev)
                .requires_grad_(False)
                for m, sd in teacher_states.items()}
    student = detector(config, config['student_channels'], student_state,
                       dev)
    names = [n for n, _ in student.named_parameters()]
    params = [p for _, p in student.named_parameters()]
    opt = Adam(params, recipe['lr'], (recipe['b1'], recipe['b2']))
    anchors = anchors_on(size, dev)
    class_valid, lut = class_tables(config, dev)
    gen = torch.Generator(device=dev)
    out = {'losses': [], 'teacher_raw': [], 'teacher_rows': [],
           'fused': []}
    with fp32_exact(), rounding:
        for k in range(steps):
            batch = batches[k]
            t = teacher_pass(teachers, batch, size)
            rows = [teacher_labels(raw, size, class_valid, lut, recipe)
                    for raw, _ in t.values()]
            fused = fuse(rows, recipe)
            ann = fused if labels is None else labels[k]
            x = maybe_stretch_mel_axis(batch['audio'].float(), size)
            loss = student_loss(student, x, ann, [f for _, f in t.values()],
                                anchors, recipe,
                                gen.manual_seed(step_seed(seed, k)))
            grads = torch.autograd.grad(loss, params)
            if k == 0:
                out['grads'] = dict(zip(names, (g.detach() for g in grads)))
            opt.step(grads)
            out['losses'].append(float(loss.detach()))
            out['teacher_raw'].append({m: raw for m, (raw, _) in t.items()})
            out['teacher_rows'].append(rows)
            out['fused'].append(fused)
            del t, loss, grads
    out['params'] = {n: p.detach() for n, p in zip(names, params)}
    return out
