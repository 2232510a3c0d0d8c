"""The distillation step's configuration (port of the `DistillConfig` of
mm_distillnet_tpu/distill/train_step.py). The step itself, its losses and
optimizer state wait for the training slice."""
from __future__ import annotations

from typing import NamedTuple

from .pseudo_labels import PseudoLabelConfig


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
