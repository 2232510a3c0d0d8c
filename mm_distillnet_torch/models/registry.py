"""Model registry: a name -> (module, state_dict), checkpoint-aware (port of
mm_distillnet_tpu/models/registry.py; reference src/utils/utils.py:441-590).

The reference's model-type strings resolve to EfficientDet-D2 modules with
modality-specific input channels (rgb 3 / thermal 1 / depth 3 / audio 8)
and checkpoint files under `saved_path`. A checkpoint is a reference .pth
or .pth.tar, or one of the port's own `checkpoint.{rank}` / `best.{rank}`
files; without one the module keeps its seeded random init (the audio
student trains from scratch). The port's module names are the reference's
torch key layout, so the files load without transposes
(convert/weights.py). Parameters stay fp32: callers run the modules in
`config.compute_dtype_from(config)` (autocast, or the folded eval path).
"""
from __future__ import annotations

import logging
import os
import zipfile
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..convert.weights import (convert_reference_state_dict,
                               load_zoo_backbone, read_torch_checkpoint)
from .efficientdet import EfficientDet
from .efficientdet_generator import EfficientDetGenerator
from .stereosoundnet import StereoSoundNet

logger = logging.getLogger(__name__)

MODALITY_CHANNELS = {'rgb': 3, 'thermal': 1, 'depth': 3, 'audio': 8,
                     'audio_static': 8, 'audio_student': 8}

MODALITY_CHECKPOINTS = {
    'rgb': 'yet-another-efficientdet-d2-rgb.pth',
    'thermal': 'yet-another-efficientdet-d2-thermal.pth',
    'depth': 'yet-another-efficientdet-d2-depth.pth',
    'audio_static': 'yet-another-efficientdet-d2-audio.pth',
    'audio_student': None,  # the student trains from scratch
}
EMBEDDING_CHECKPOINT = 'yet-another-efficientdet-d2-embedding.pth'

KNOWN_MODEL_TYPES = (
    'YetAnotherEfficientDet_D2',
    'YetAnotherEfficientDet_D2_embedding',
    'YetAnotherEfficientDet_D2_input8',
    'YetAnotherEfficientDet_D2_input1',
    'YetAnotherEfficientDetGenerator_D2',
    'YetAnotherEfficientDetGenerator_D2_STATIC',
    'YetAnotherEfficientDet_D2_audio',
    'StereoSoundNet',
)


def _unquote(value: Optional[str]) -> Optional[str]:
    return value.strip('"\'') if isinstance(value, str) else value


def get_data_dim_from_config(config) -> Dict[str, int]:
    """Modality -> input channels from the config's use_* flags (reference
    get_data_dim_from_config, utils.py:414-438); sizes the generator's
    per-modality stacks."""
    out: Dict[str, int] = {}
    if config is not None:
        if config.getboolean('use_thermal', fallback=False):
            out['thermal'] = 1
        if config.getboolean('use_depth', fallback=False):
            out['depth'] = 3
        if config.getboolean('use_audio', fallback=False):
            out['audio'] = 8
        if config.getboolean('use_rgb', fallback=True):
            out['rgb'] = 3
    if not out:
        out['rgb'] = 3
    return out


def _is_generator_type(model_type: str) -> bool:
    """'YetAnotherEfficientDetGenerator_D2' and
    'YetAnotherEfficientDet_D2_audio' build the generator, while
    'YetAnotherEfficientDetGenerator_D2_STATIC' builds the PLAIN detector:
    the static-audio checkpoint is a single-modality export (reference
    utils.py:551-555)."""
    if model_type == 'YetAnotherEfficientDetGenerator_D2_STATIC':
        return False
    return ('Generator' in model_type
            or model_type == 'YetAnotherEfficientDet_D2_audio')


def _compound_coef(config) -> int:
    """The registry's names are all D2 (the reference hard-codes
    compound_coef=2); the config key `compound_coef` lets tests and
    synthetic runs use smaller profiles (-1: the test-tiny profile)."""
    if config is None:
        return 2
    return config.getint('compound_coef', fallback=2)


def build_model(model_type: str, config, num_classes: int = 20,
                in_channels: int = 3) -> nn.Module:
    """The module for a registry name, with its random init (fp32)."""
    if 'StereoSoundNet' in model_type:
        return StereoSoundNet(num_classes, in_channels)
    if 'YetAnotherEfficientDet' not in model_type:
        raise ValueError(f'Unsupported model type {model_type} provided')
    if _is_generator_type(model_type):
        dims = get_data_dim_from_config(config)
        # the shipped config quotes its value: integration_mode='concat'
        mode = _unquote(config.get('integration_mode', 'concat')
                        if config is not None else None) or 'concat'
        return EfficientDetGenerator(
            modalities=tuple(sorted(dims)), num_classes=num_classes,
            compound_coef=_compound_coef(config), integration_mode=mode,
            in_channels=dims)
    features_from = (config.get('features_from', 'efficientnet')
                     if config is not None else 'efficientnet')
    return EfficientDet(num_classes, _compound_coef(config), in_channels,
                        features_from=features_from)


def load_model(model_type: str, config, modality: Optional[str] = None,
               num_classes: int = 20, seed: int = 0
               ) -> Tuple[nn.Module, Dict[str, torch.Tensor]]:
    """(module, state_dict) on the CPU; the module holds the state_dict.
    The modality decides the input channels and the checkpoint file, as
    in the reference (utils.py:540-558). The random init draws from torch
    seeded with `seed`, without touching the global generator."""
    if model_type not in KNOWN_MODEL_TYPES and \
            'YetAnotherEfficientDet' not in model_type:
        raise ValueError(f'Unsupported model type {model_type} provided')
    in_channels = 3
    ckpt_name = None
    if modality is not None:
        if modality not in MODALITY_CHANNELS:
            raise ValueError(f'Unsupported modality={modality} on load model')
        in_channels = MODALITY_CHANNELS[modality]
        ckpt_name = MODALITY_CHECKPOINTS.get(modality)
    if model_type.endswith('_input8'):
        in_channels = 8
    elif model_type.endswith('_input1'):
        in_channels = 1
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = build_model(model_type, config, num_classes, in_channels)
    state = model.state_dict()

    saved_path = _unquote(config.get('saved_path', 'trained_models')
                          if config is not None else 'trained_models')
    # ImageNet-pretrained backbone (config `backbone_pretrained`: a model-zoo
    # EfficientNet .pth), applied BEFORE the task checkpoint so a full task
    # load overrides it (reference src/YetAnotherEfficientNet.py:596-604)
    zoo_path = (config.get('backbone_pretrained', fallback=None)
                if config is not None else None)
    if zoo_path and str(zoo_path).lower() not in ('none', 'false', ''):
        if not os.path.exists(zoo_path):
            raise FileNotFoundError(
                f'backbone_pretrained={zoo_path} does not exist')
        state, report = load_zoo_backbone(zoo_path, state, strict=True)
        logger.info('backbone bootstrapped from %s (stem_swapped=%s)',
                    zoo_path, report['stem_swapped'])

    if ckpt_name is not None:
        # a teacher loads completely: a partly random teacher would poison
        # every pseudo-label. The student's '_embedding' update is the one
        # partial load (reference utils.py:585-589)
        state = maybe_load_checkpoint(os.path.join(saved_path, ckpt_name),
                                      state, strict=True)
        if 'embedding' in model_type:
            state = maybe_load_checkpoint(
                os.path.join(saved_path, EMBEDDING_CHECKPOINT), state,
                strict=False)
    model.load_state_dict(state)
    return model, model.state_dict()


def _refuse_jax_checkpoint(path: str) -> None:
    if os.path.isdir(path):
        raise ValueError(
            f'{path} is a directory (an orbax checkpoint of the JAX '
            'package); the port reads .pth files and its own checkpoint '
            'files only')
    if zipfile.is_zipfile(path):
        with zipfile.ZipFile(path) as z:
            names = z.namelist()
        if names and all(n.endswith('.npy') for n in names):
            raise ValueError(
                f'{path} is an .npz checkpoint of the JAX package; the port '
                'reads .pth files and its own checkpoint files only')


def maybe_load_checkpoint(path: str, variables: Dict[str, torch.Tensor],
                          strict: bool = False) -> Dict[str, torch.Tensor]:
    """`variables` (a state_dict) filled from the checkpoint at `path`: a
    reference .pth / .pth.tar or the port's `checkpoint.{rank}` /
    `best.{rank}`. Without a file, `variables` unchanged (random init),
    logged. A JAX checkpoint (orbax directory, .npz) raises.

    `strict=True` raises if a parameter or running statistic has no match
    in the file (teacher loads)."""
    if not (path and os.path.exists(path)):
        logger.info('checkpoint %s absent; using random init', path)
        return variables
    _refuse_jax_checkpoint(path)
    variables, report = convert_reference_state_dict(
        read_torch_checkpoint(path), variables, strict=strict)
    if report['missing']:
        logger.warning('checkpoint %s: %d tensors unmatched', path,
                       len(report['missing']))
    return variables
