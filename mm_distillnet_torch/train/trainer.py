"""Config -> `DistillConfig` (port of `distill_config_from` of
mm_distillnet_tpu/train/trainer.py). The epoch loop, validation and
checkpointing wait for the training slice."""
from __future__ import annotations

from ..config import student_input_key
from ..distill.pseudo_labels import PseudoLabelConfig
from ..distill.train_step import DistillConfig


def distill_config_from(config, image_size: int) -> DistillConfig:
    return DistillConfig(
        train_method=config.get('train_method', 'traditional_nms_augmented'),
        w_main=config.getfloat('w_main', fallback=1.0),
        w_div=config.getfloat('w_div', fallback=1.0),
        w_kd=config.getfloat('w_kd', fallback=0.005),
        T=config.getfloat('T', fallback=9.0),
        p=config.getfloat('p', fallback=2.0),
        mta_parity=config.getboolean('mta_parity_mode', fallback=True),
        kd_loss=config.get('kd_loss', 'MTALoss'),
        div_loss=config.get('div_loss', fallback='None') or 'None',
        use_labels=config.getboolean('use_labels', fallback=False) or False,
        student_input=student_input_key(config),
        audio_augmentation_merge=config.getboolean(
            'audio_augmentation_merge', fallback=False) or False,
        pl=PseudoLabelConfig(
            image_size=image_size,
            conf_threshold=config.getfloat('conf_threshold', fallback=0.3),
            nms_threshold=config.getfloat('nms_threshold', fallback=0.5),
            num_candidates=config.getint('nms_candidates', fallback=512),
            max_det_per_teacher=config.getint('max_det_per_teacher',
                                              fallback=32),
            max_gt=config.getint('max_gt', fallback=64)),
    )
