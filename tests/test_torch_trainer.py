"""The port's trainer end to end on the CPU (test-tiny profile, 128 px,
the synthetic dataset): a fast run writes its checkpoint and scalar log and
resumes from them; and the port of the reference's loss-decrease smoke
(tests/test_convergence.py): 30 supervised steps cut the loss by > 40%."""
import json
import math
import os

import numpy as np
import pytest
import torch

from mm_distillnet_torch.config import default_config
from mm_distillnet_torch.data.loader import collate
from mm_distillnet_torch.data.synthetic import SyntheticMultimodal
from mm_distillnet_torch.distill import train_step as ts
from mm_distillnet_torch.distill.pseudo_labels import PseudoLabelConfig
from mm_distillnet_torch.models.efficientdet import EfficientDet
from mm_distillnet_torch.ops.anchors import anchor_table
from mm_distillnet_torch.ops.postprocess import class_validity_table
from mm_distillnet_torch.train import checkpoint, trainer
from mm_distillnet_torch.train.optim import build_scheduler

from .test_torch_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread')

SIZE = 128
CHANNELS = {'rgb': 3, 'thermal': 1, 'depth': 3}


def _seeded(seed, channels):
    torch.manual_seed(seed)
    return EfficientDet(20, -1, channels)


@pytest.fixture
def run(tmp_path):
    config = default_config(
        exp_name=str(tmp_path / 'run'), log_path=str(tmp_path / 'tb'),
        image_size=SIZE, synthetic_size=4, batch_size=2, num_workers=1,
        fast_run=True, num_epoches=3, val_interval=1, resume=True,
        compute_dtype='float32', max_gt=16, nms_candidates=64,
        max_det_per_teacher=8, lr='1e-3', rank=0, seed=3)
    teachers = {m: (net, net.state_dict()) for m, net in
                ((m, _seeded(10 + i, c).eval())
                 for i, (m, c) in enumerate(CHANNELS.items()))}
    student = _seeded(1, 8)
    train_set = SyntheticMultimodal(config, 'train')
    val_set = SyntheticMultimodal(config, 'val')
    return config, teachers, (student, student.state_dict()), train_set, \
        val_set


def test_fast_run_writes_checkpoint_and_logs_and_resumes(run):
    config, teachers, student, train_set, val_set = run
    before = {k: v.clone() for k, v in student[0].state_dict().items()}
    state = trainer.train(teachers, student, config, train_set, val_set,
                          device='cpu')
    assert state.step == 2                       # fast_run: two iterations
    for k, v in student[0].state_dict().items():  # the caller's copy stays
        assert torch.equal(v, before[k]), k
    exp = config['exp_name']
    for name in ('checkpoint.0', 'best.0', 'only_parameters_student_best.0',
                 'all_logs.0.json'):
        assert os.path.exists(os.path.join(exp, name)), name
    # `{exp_name}/{exp_name}.{rank}.log`: beside the run for an absolute
    # exp_name, as in the reference package
    assert os.path.getsize(exp + '.0.log') > 0
    with open(os.path.join(exp, 'all_logs.0.json')) as f:
        logs = json.load(f)
    for tag in ('Train/Total_loss', 'Train_/Regression_loss',
                'Train/Class_loss', 'Train/KLDiv', 'Train/KD',
                'Test/Total_loss'):
        assert tag in logs, tag
    val_loss = logs['Test/Total_loss']['0']
    assert math.isfinite(val_loss)

    # the checkpoint gives back the epoch, the best loss, the scheduler
    fresh = ts.init_train_state(_seeded(2, 8), config, device='cpu')
    scheduler = build_scheduler(config)
    _, start, best, best_epoch = checkpoint.restore_checkpoint(
        config, fresh, scheduler)
    assert (start, best_epoch, fresh.step) == (1, 0, 2)
    assert best == pytest.approx(val_loss)
    assert scheduler.state_dict() == {'lr': 1e-3, 'best': logs[
        'Train/Total_loss']['1'], 'num_bad': 0}
    for k, v in state.model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[k], v), k
    assert checkpoint.load_student_params(config).keys() == \
        state.model.state_dict().keys()

    # resume: the next run starts at epoch 1 from the saved step
    resumed = trainer.train(teachers, student, config, train_set, val_set,
                            device='cpu')
    assert resumed.step == 4
    with open(os.path.join(exp, 'all_logs.0.json')) as f:
        logs = json.load(f)
    assert set(logs['Test/Total_loss']) == {'1'}


def test_train_raises_without_a_card_unless_asked(run):
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    config, teachers, student, train_set, val_set = run
    with pytest.raises(RuntimeError, match='CUDA'):
        trainer.train(teachers, student, config, train_set, val_set)


def test_loss_decreases_under_training():
    """30 supervised full-batch steps at lr 5e-3 (Adam) on the planted
    rectangles cut the total loss by more than 40% (the mean of the last
    three steps against the first three)."""
    size, batch_n = SIZE, 4
    config = default_config(image_size=size, synthetic_size=batch_n,
                            lr='5e-3', optimizer='Adam')
    ds = SyntheticMultimodal(config, 'train')
    batch = collate([ds[i] for i in range(batch_n)], 16)
    batch = {k: torch.from_numpy(v) for k, v in batch.items() if k != 'id'}
    state = ts.init_train_state(_seeded(0, 3), config, device='cpu')
    cfg = ts.DistillConfig(train_method='traditional', use_labels=True,
                           kd_loss='None', student_input='rgb',
                           pl=PseudoLabelConfig(image_size=size, max_gt=16))
    step = ts.make_train_step({}, cfg, anchor_table(size),
                              class_validity_table(20, list(range(20))),
                              np.arange(20), compute_dtype=torch.float32,
                              seed=7, device='cpu')
    losses = [float(step(state, batch)['Total_loss']) for _ in range(30)]
    assert np.isfinite(losses).all()
    first, last = np.mean(losses[:3]), np.mean(losses[-3:])
    assert last < 0.6 * first, (first, last)
