"""Train the audio student by multi-teacher distillation (port of the root
train.py; reference train.py:223-316):

    python -m mm_distillnet_torch.cli.train --config_file configs/mm-distillnet.cfg \\
        [--overwrite '{"key": "value"}'] [--rank N] [--local_rank N] \\
        [--nodes N] [--device cuda|cpu]

`--device` (default cuda) is the counterpart of the JAX CLIs'
MMDT_PLATFORM switch; without a card the run raises unless given
`--device cpu`. One process per card, as torchrun starts them:

    torchrun --nproc_per_node N -m mm_distillnet_torch.cli.train \\
        --config_file configs/mm-distillnet.cfg

The world comes from torchrun's environment (or the JAX package's, or the
config keys coordinator_address / num_processes / process_id;
parallel/mesh.py); each rank trains on its card (`--local_rank`, else
LOCAL_RANK) and writes its own checkpoint.{rank} and results.{rank}.csv.
`--rank`, when given, must be the process group's rank. `--nodes` is read
and ignored, as by the JAX package's CLI (the world size says it).
"""
from __future__ import annotations

import argparse
import logging
import os

from ..config import load_config
from ..data.factory import get_dataset
from ..device import resolve_device
from ..evaluation import evaluate
from ..models.registry import load_model, maybe_load_checkpoint
from ..parallel import mesh
from ..train.checkpoint import load_student_params
from ..train.trainer import train
from ..utils.logging_utils import setup_run_logging
from ..utils.reproducibility import make_reproducible_run

logger = logging.getLogger(__name__)


def load_teachers(config):
    """{modality: (module, state_dict)} in the reference's order and
    classes (reference train.py:122-134, evaluate.py:104-118): rgb, audio,
    depth, thermal. The audio teacher is built from config['teacher'] with
    the 'audio_static' modality, so the shipped teacher string gives a
    plain 8-channel D2 reading yet-another-efficientdet-d2-audio.pth."""
    teachers = {}
    teacher_type = config.get('teacher', 'YetAnotherEfficientDet_D2')
    for flag, modality, registry_modality, default in (
            ('use_rgb', 'rgb', 'rgb', True),
            ('use_audio', 'audio', 'audio_static', False),
            ('use_depth', 'depth', 'depth', False),
            ('use_thermal', 'thermal', 'thermal', False)):
        if config.getboolean(flag, fallback=default):
            teachers[modality] = load_model(teacher_type, config,
                                            registry_modality)
    return teachers


def pretrain(teacher_models, student_model, config, train_set, val_set,
             device='cuda'):
    """The stage before distillation (reference train.py:47-102). The
    `pretrain` key doubles as a value: an existing checkpoint path (or
    `pretrain_checkpoint`, which takes precedence) is loaded into the
    student; a true boolean runs a `traditional` stage into
    `{exp_name}/pretrain` whose weights the student keeps."""
    module, variables = student_model
    value = config.get('pretrain', fallback='False') or 'False'
    path = config.get('pretrain_checkpoint', fallback='') or value
    if path and os.path.exists(path):
        logger.warning('Pretrain from %s', path)
        return module, maybe_load_checkpoint(path, variables)
    try:
        enabled = config.getboolean('pretrain', fallback=False)
    except ValueError:
        enabled = False   # neither a boolean nor an existing path
    if not enabled:
        return module, variables
    old_exp_name = config.get('exp_name', 'run')
    config['exp_name'] = f'{old_exp_name}/pretrain'
    os.makedirs(config['exp_name'], exist_ok=True)
    logger.warning('Pretrain stage on %s', config['exp_name'])
    state = train(teacher_models, (module, variables), config, train_set,
                  val_set, method='traditional', device=device)
    config['exp_name'] = old_exp_name
    return module, state.model.state_dict()


def join_world(config, device):
    """Forms the process group the config or the environment describes,
    then fixes the config's rank (the group's when not given) and the
    rank's device. Returns the device."""
    mesh.distributed_init_if_needed(config, device=device)
    config['rank'] = str(mesh.config_rank(config))
    dev = resolve_device(device)
    setup_run_logging(config, int(config['rank']))
    return dev


def train_multimodal_detection(config, device='cuda'):
    """Load the teachers and the student, pretrain, distil, then evaluate
    the best checkpoint (or the trained weights without one). Returns the
    AP table."""
    dev = join_world(config, device)
    make_reproducible_run(config.getint('seed', fallback=-1))

    teacher_models = load_teachers(config)
    training_set = get_dataset(config, 'train')
    val_set = get_dataset(config, 'val')
    student_model = load_model(config.get('student'), config,
                               'audio_student')
    student_model = pretrain(teacher_models, student_model, config,
                             training_set, val_set, device=dev)
    state = train(teacher_models, student_model, config, training_set,
                  val_set, method=config.get('train_method'), device=dev)

    # the trained weights go to the final evaluation, unless a best
    # checkpoint was saved (reference train.py:199-213)
    best = load_student_params(config, config.getint('rank'), 'best')
    student_model = (student_model[0],
                     best if best is not None else state.model.state_dict())
    return evaluate(teacher_models, student_model, val_set, config,
                    device=dev)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description='Train MM-DistillNet (PyTorch port)')
    parser.add_argument('--config_file', required=True)
    parser.add_argument('--overwrite', default=None,
                        help='JSON dict of config overrides')
    parser.add_argument('--rank', type=int, default=None,
                        help="this process's rank (default: the process "
                        "group's, 0 without one)")
    parser.add_argument('--local_rank', type=int, default=None,
                        help="this process's card (default: LOCAL_RANK)")
    parser.add_argument('--nodes', type=int, default=1)
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)
    resolve_device(args.device)
    extra = {'nodes': args.nodes}
    for key in ('rank', 'local_rank'):
        if getattr(args, key) is not None:
            extra[key] = getattr(args, key)
    config = load_config(args.config_file, args.overwrite, extra=extra)
    return train_multimodal_detection(config, args.device)


if __name__ == '__main__':
    logging.basicConfig(level=logging.WARNING)
    main()
