"""The multi-teacher distillation step (port of
mm_distillnet_tpu/distill/train_step.py).

One step: the frozen teachers' eval forwards -> decode + NMS pseudo-label
fusion on the device -> the student's train-mode forward -> focal + KD
losses -> backward -> optimizer update (reference
src/optimization/train_methods.py:50-762 and traditional.py:92-207).

The step is split where the gradient starts: `teacher_targets` is the
teacher half (no grad: the student's input, the teachers' features and
logits, the focal loss's annotations) and `student_losses` the student's
forward and losses; `compute_distill_losses` chains them. With
`make_teachers(..., fused=True)` every teacher's backbone runs the MBConv
kernels (models/fused_forward.py), weights folded once; otherwise the
port's eval-mode modules run it, as the JAX package's `model.apply(...,
train=False)` does.

Train methods (reference train_methods.py:899-942):
  traditional                     per-teacher labels, losses averaged
  traditional_nms                 NMS-fused labels, per-teacher MTA
  traditional_nms_augmented       + audio-mix augmentation (shipped default)
  traditional_nms_kdlist          fused labels, multi-teacher MTA product
  traditional_nms_kdlist_augmented

Loss weighting (traditional.py:171-181):
  loss = w_main * (mean(reg_losses) + mean(cls_losses))
         + w_div * div + w_kd * sum(stack(kd_losses)).
div_loss=DistillKL is live, as in the JAX package: w_div * sum over the
teachers of KL(student || teacher) over the pre-sigmoid class logits.

Parameters stay in fp32; the student computes in `compute_dtype` (bf16 by
default, through torch.autocast), the split of flax's fp32 params and bf16
activations. The losses run in fp32 outside the autocast region. Random
draws (stochastic depth) come from a generator seeded by the step's seed
and step number. `bn_mode='per_replica'` (DataParallel statistics) waits
for the DDP port and raises.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..device import resolve_device
from ..losses.aux_losses import attention_transfer_loss, distill_kl
from ..losses.focal import focal_loss
from ..losses.mta import mta_loss
from ..models.efficientdet_generator import EfficientDetGenerator
from ..models.fused_forward import make_eval_forward
from ..ops.postprocess import detections_to_labels
from ..ops.resize import maybe_stretch_mel_axis
from ..train.optim import apply_gradients, build_optimizer
from .pseudo_labels import (PseudoLabelConfig, fuse_teacher_labels,
                            teacher_detections)

METRICS = ('Total_loss', 'Regression_loss', 'Class_loss', 'KLDiv', 'KD')


class DistillConfig(NamedTuple):
    train_method: str = 'traditional_nms_augmented'
    w_main: float = 1.0
    w_div: float = 1.0
    w_kd: float = 0.005
    T: float = 9.0
    p: float = 2.0
    mta_parity: bool = True
    audio_augmentation_merge: bool = False
    pl: PseudoLabelConfig = PseudoLabelConfig(image_size=768)
    # criterion selection (reference extract_criterions_from_config,
    # src/utils/utils.py:1556-1668): main_loss is YetAnotherFocalLoss;
    # kd_loss in {MTALoss, AttentionLoss, None}; div_loss in {DistillKL, None}
    kd_loss: str = 'MTALoss'
    div_loss: str = 'None'
    # use_labels=True trains against the dataset's ground-truth annotations
    # instead of teacher pseudo-labels (only the 'traditional' method)
    use_labels: bool = False
    # which batch key feeds the trained network (default: the audio student)
    student_input: str = 'audio'


@dataclass
class TrainState:
    """The step count, the student (fp32 parameters, BN statistics as
    buffers) and its optimizer."""
    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer


class Teacher(NamedTuple):
    """A frozen teacher: its eval forward, which features it hands to the
    KD loss and, for a generator, the modalities it reads (a plain teacher
    reads its own modality)."""
    forward: Any
    features_from: str
    modalities: Optional[Tuple[str, ...]] = None


class TeacherTargets(NamedTuple):
    """What the teacher half hands to the student half."""
    student_input: torch.Tensor       # (B, S, S, C), after stretch and mix
    annotations: List[torch.Tensor]   # focal-loss targets, (B, G, 5) each
    features: List[List[torch.Tensor]]  # per teacher, its KD features
    logits: List[torch.Tensor]        # per teacher, pre-sigmoid class logits


def make_teachers(teacher_models: Mapping[str, nn.Module],
                  teacher_variables: Optional[Mapping] = None, *,
                  image_size: int, fused: bool,
                  dtype: torch.dtype = torch.bfloat16,
                  device='cuda') -> Dict[str, Teacher]:
    """{modality: Teacher}: each teacher frozen once, in eval mode. Its
    weights are `teacher_variables[modality]` (a state_dict) or, without
    them, the module's own. With `fused` its backbone (each of a
    generator's backbones) runs the MBConv kernels."""
    teachers = {}
    for m, model in teacher_models.items():
        sd = model.state_dict() if teacher_variables is None \
            else teacher_variables[m]
        teachers[m] = Teacher(
            make_eval_forward(model, sd, image_size, fused, dtype, device),
            model.features_from,
            tuple(model.modalities)
            if isinstance(model, EfficientDetGenerator) else None)
    return teachers


def merge_audio_batch01(audio: torch.Tensor) -> torch.Tensor:
    """Audio-mix augmentation: batch element 1 becomes the log-domain "sum"
    of elements 0 and 1 (reference train_methods.py:289-308), with its
    quirk: a^10 + b^10 (torch.pow(audio, 10)), not 10^a + 10^b. Computed in
    the batch's own dtype as the JAX package computes it: the power by
    repeated squaring (XLA's integer_pow), log10 as log(x) * 1/ln(10)
    rounded to the dtype. Returns a new tensor."""
    def pow10(x):
        x2 = x * x
        x4 = x2 * x2
        return x2 * (x4 * x4)
    merged = (pow10(audio[0]) + pow10(audio[1])).clamp(min=1e-7)
    merged = torch.log(merged) * torch.tensor(0.4342944819032518,
                                              dtype=audio.dtype,
                                              device=audio.device)
    out = audio.clone()
    out[1] = merged
    return out


def average_teacher_features_batch01(features: List[torch.Tensor]
                                     ) -> List[torch.Tensor]:
    """Companion of the audio merge: per pyramid level, feature batch
    element 1 becomes the mean of elements 0 and 1 (reference
    train_methods.py:276-287)."""
    out = []
    for f in features:
        f = f.clone()
        f[1] = (f[0] + f[1]) / 2
        out.append(f)
    return out


def _teacher_forward(teachers: Mapping[str, Teacher],
                     batch: Mapping[str, torch.Tensor]):
    """{modality: (classification, regression, features, logits)} of the
    frozen teachers' eval forwards (reference train_methods.py:891-893); a
    generator teacher reads a dict of its modalities."""
    outs = {}
    for modality, teacher in teachers.items():
        x = batch[modality] if teacher.modalities is None \
            else {m: batch[m] for m in teacher.modalities}
        o = teacher.forward(x)
        feats = (list(o.features) if teacher.features_from == 'efficientnet'
                 else [o.align_features])
        outs[modality] = (o.classification, o.regression, feats, o.logits)
    return outs


def _labels_per_teacher(t_outs, anchors, class_valid, pred_to_label,
                        cfg: DistillConfig) -> List[torch.Tensor]:
    """Per-teacher padded label rows (B, max_det, 6) with scores."""
    return [detections_to_labels(
                teacher_detections(cls_t, reg_t, anchors, class_valid,
                                   cfg.pl),
                pred_to_label, cfg.pl.image_size, include_scores=True)
            for (cls_t, reg_t, _, _) in t_outs.values()]


def _augment_label_union(per_teacher_labels: List[torch.Tensor]
                         ) -> List[torch.Tensor]:
    """Under the audio mix the reference adds image 0's labels to image 1's
    candidates before the fusion NMS (train_methods.py:384-390): in fixed
    shapes, each teacher's image-0 rows come again as an extra 'teacher'
    that has rows for image 1 only."""
    extras = []
    for lab in per_teacher_labels:
        ghost = torch.zeros_like(lab)
        ghost[..., 5] = -1.0            # all-invalid rows
        ghost[1] = lab[0]               # image 1 sees image 0's rows
        extras.append(ghost)
    return per_teacher_labels + extras


@torch.no_grad()
def teacher_targets(teachers: Mapping[str, Teacher],
                    batch: Mapping[str, torch.Tensor], cfg: DistillConfig,
                    anchors: torch.Tensor, class_valid: torch.Tensor,
                    pred_to_label: torch.Tensor) -> TeacherTargets:
    """The teacher half of the step, without grad: the compact audio's
    mel stretch, the audio mix, the teachers' forwards and the focal
    loss's annotations (ground truth, per-teacher labels or the fused
    pseudo-labels, by method)."""
    key = cfg.student_input
    x = maybe_stretch_mel_axis(batch[key], cfg.pl.image_size)
    augment = cfg.audio_augmentation_merge and \
        'augmented' in cfg.train_method
    if augment:
        x = merge_audio_batch01(x)
    t_outs = _teacher_forward(teachers, {**batch, key: x})
    if augment:
        t_outs = {m: (c, r, average_teacher_features_batch01(f), lg)
                  for m, (c, r, f, lg) in t_outs.items()}

    method = cfg.train_method
    if cfg.use_labels and method == 'traditional':
        # supervised (reference ModelWithLoss with use_labels,
        # train_methods.py:557-558): the reference's per-teacher focal
        # losses on the same labels are equal, so one suffices
        annotations = [batch['label']]
    else:
        per_teacher = _labels_per_teacher(t_outs, anchors, class_valid,
                                          pred_to_label, cfg)
        if method == 'traditional':
            # per-teacher labels, no fusion (train_methods.py:520-584)
            annotations = [torch.cat([lab[..., :4], lab[..., 5:6]], dim=-1)
                           for lab in per_teacher]
        else:
            if augment:
                per_teacher = _augment_label_union(per_teacher)
            annotations = [fuse_teacher_labels(per_teacher, cfg.pl)]
    return TeacherTargets(
        x, annotations, [f for (_, _, f, _) in t_outs.values()],
        [lg for (_, _, _, lg) in t_outs.values() if lg is not None])


def _autocast(device: torch.device, dtype: torch.dtype):
    if dtype == torch.float32:
        return contextlib.nullcontext()
    return torch.autocast(device.type, dtype=dtype)


def student_losses(student_model: nn.Module, targets: TeacherTargets,
                   cfg: DistillConfig, anchors: torch.Tensor, train: bool,
                   generator: Optional[torch.Generator] = None,
                   compute_dtype: torch.dtype = torch.float32
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The student's forward (train or eval mode, in `compute_dtype`) and
    its losses (fp32). Returns (loss, metrics) with the reference's logged
    quantities."""
    student_model.train(train)
    x = targets.student_input
    with _autocast(x.device, compute_dtype):
        out = student_model(x, generator=generator)
    feats_s = student_model.distill_features(out)

    reg_losses, cls_losses = [], []
    for ann in targets.annotations:
        r, c = focal_loss(out.classification, out.regression, ann, anchors)
        reg_losses.append(r)
        cls_losses.append(c)

    teacher_feats = targets.features
    if not teacher_feats or cfg.kd_loss in (None, 'None'):
        kd_losses = [torch.zeros(1, device=x.device)]
    elif cfg.kd_loss == 'AttentionLoss':
        kd_losses = [attention_transfer_loss(feats_s, ft, cfg.p)
                     for ft in teacher_feats]
    elif 'kdlist' in cfg.train_method:
        kd_losses = [mta_loss(feats_s, teacher_feats, cfg.T, cfg.p,
                              cfg.mta_parity)]
    else:
        kd_losses = [mta_loss(feats_s, ft, cfg.T, cfg.p, cfg.mta_parity)
                     for ft in teacher_feats]

    if cfg.div_loss not in (None, 'None', 'DistillKL'):
        # the reference's factory rejects it loudly (utils.py:1592)
        raise ValueError(f'Unsupported DIV Loss {cfg.div_loss}')
    loss_div = torch.zeros((), device=x.device)
    if cfg.div_loss == 'DistillKL' and out.logits is not None:
        for logits_t in targets.logits:
            # class-axis softmax over (B, N_anchors, C) logits
            loss_div = loss_div + distill_kl(out.logits, logits_t.float(),
                                             T=4.0, axis=-1)

    loss_regression = torch.stack(reg_losses).mean()
    loss_cls = torch.stack(cls_losses).mean()
    loss_kd = torch.stack(kd_losses).sum()
    loss = (cfg.w_main * (loss_regression + loss_cls)
            + cfg.w_div * loss_div + cfg.w_kd * loss_kd)
    values = (loss, loss_regression, loss_cls, loss_div, loss_kd)
    return loss, {k: v.detach() for k, v in zip(METRICS, values)}


def compute_distill_losses(student_model: nn.Module,
                           teachers: Mapping[str, Teacher],
                           batch: Mapping[str, torch.Tensor],
                           cfg: DistillConfig, anchors, class_valid,
                           pred_to_label, train: bool,
                           generator: Optional[torch.Generator] = None,
                           compute_dtype: torch.dtype = torch.float32):
    """Shared loss computation of the train and validation steps: (loss,
    metrics). In train mode the student's BN statistics are updated in
    place."""
    targets = teacher_targets(teachers, batch, cfg, anchors, class_valid,
                              pred_to_label)
    return student_losses(student_model, targets, cfg, anchors, train,
                          generator, compute_dtype)


def _step_seed(seed: int, step: int) -> int:
    """The seed of step `step`'s generator: reproducible per step."""
    return (seed % (1 << 31)) * (1 << 32) + step


def _on(dev, anchors, class_valid, pred_to_label):
    return (torch.as_tensor(anchors, dtype=torch.float32, device=dev),
            torch.as_tensor(class_valid, device=dev),
            torch.as_tensor(pred_to_label, device=dev))


def make_train_step(teachers: Mapping[str, Teacher], cfg: DistillConfig,
                    anchors, class_valid, pred_to_label, *,
                    compute_dtype: torch.dtype = torch.bfloat16,
                    seed: int = 0, bn_mode: str = 'sync', device='cuda'):
    """fn(state, batch) -> metrics: one step on the batch (a dict of
    tensors on `device`), updating state.model, state.optimizer and
    state.step in place. The metrics are 0-dim tensors on the device."""
    if bn_mode == 'per_replica':
        raise NotImplementedError(
            "bn_mode='per_replica' keeps DataParallel's per-replica BN "
            'statistics; it waits for the DDP port (ROADMAP Queue 1 item 13)')
    dev = resolve_device(device)
    anchors, class_valid, pred_to_label = _on(dev, anchors, class_valid,
                                              pred_to_label)
    generator = torch.Generator(device=dev)

    def train_step(state: TrainState, batch: Mapping[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
        generator.manual_seed(_step_seed(seed, state.step))
        state.optimizer.zero_grad(set_to_none=True)
        loss, metrics = compute_distill_losses(
            state.model, teachers, batch, cfg, anchors, class_valid,
            pred_to_label, train=True, generator=generator,
            compute_dtype=compute_dtype)
        loss.backward()
        apply_gradients(state.optimizer)
        state.step += 1
        return metrics

    return train_step


def make_eval_loss_step(teachers: Mapping[str, Teacher], cfg: DistillConfig,
                        anchors, class_valid, pred_to_label, *,
                        compute_dtype: torch.dtype = torch.bfloat16,
                        device='cuda'):
    """fn(state, batch) -> metrics: the validation loss (reference
    validate(), train_methods.py:1083-1185), the same computation without
    grad and with the student in eval mode. The state is not changed."""
    dev = resolve_device(device)
    anchors, class_valid, pred_to_label = _on(dev, anchors, class_valid,
                                              pred_to_label)

    def eval_step(state: TrainState, batch: Mapping[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
        was_training = state.model.training
        with torch.no_grad():
            _, metrics = compute_distill_losses(
                state.model, teachers, batch, cfg, anchors, class_valid,
                pred_to_label, train=False, compute_dtype=compute_dtype)
        state.model.train(was_training)
        return metrics

    return eval_step


def init_train_state(student_model: nn.Module, config, variables=None,
                     device='cuda') -> TrainState:
    """The student on `device` in fp32 (with `variables`, a state_dict,
    loaded first) and the optimizer that config names."""
    dev = resolve_device(device)
    if variables is not None:
        student_model.load_state_dict(variables)
    model = student_model.to(dev, torch.float32)
    return TrainState(step=0, model=model,
                      optimizer=build_optimizer(config, model.parameters(),
                                                device=dev))

