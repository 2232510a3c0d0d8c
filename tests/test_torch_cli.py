"""The port's train and evaluate CLIs (python -m
mm_distillnet_torch.cli.{train,evaluate}) against the root train.py /
evaluate.py, on the CPU (--device cpu): the shipped config
(configs/mm-distillnet.cfg) cut to the test-tiny profile at 128 px on the
synthetic dataset, seeded teachers and student written as reference-layout
.pth files ('state_dict' wrapper, 'module.' prefix) under saved_path.

The evaluate CLIs of both packages score the same files within the
bound of test_torch_evaluation.py::test_evaluate_matches_reference
(PARITY_ATOL on every AP and CD value). The reference registry's
jitted random init is replaced by a numpy fill of the same tree
(tests/helpers.py `fast_init`): every tensor compared here comes from the
files, and the package is not changed.
"""
import csv
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm_distillnet_tpu.config import load_config as jax_load_config
from mm_distillnet_tpu.models import registry as jax_registry
from mm_distillnet_tpu.models.efficientdet import EfficientDet as JaxDet
from mm_distillnet_torch.cli import evaluate as cli_evaluate
from mm_distillnet_torch.cli import train as cli_train
from mm_distillnet_torch.config import load_config
from mm_distillnet_torch.convert.weights import (flatten_variables,
                                                 state_dict_from_flax,
                                                 torch_key_for)
from mm_distillnet_torch.data import factory
from mm_distillnet_torch.parallel.mesh import distributed_init_if_needed

from .helpers import fast_init
from .test_torch_evaluation import PARITY_ATOL
from .test_torch_helpers import filled_variables, nhwc_input
from .test_torch_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread')

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, 'configs', 'mm-distillnet.cfg')
SIZE = 128
CHANNELS = {'rgb': 3, 'thermal': 1, 'depth': 3}
COLUMNS = ['exp_name', 'modality', 'AP@Ave', 'AP@0.5', 'AP@0.75', 'CDx',
           'CDy']
TINY = dict(dataset='Synthetic', synthetic_size=6, image_size=SIZE,
            compound_coef=-1, batch_size=2, eval_batch_size=2,
            num_workers=1, compute_dtype='float32', max_gt=16,
            nms_candidates=64, max_det_per_teacher=8, max_detections=16,
            eval_devices=1, device_audio_resize=True, resume=False,
            num_epoches=1, val_interval=1, seed=3)


def _write_pth(variables, path):
    """The reference's .pth layout from a JAX variable tree."""
    sd = {}
    for coll in variables:
        for p, leaf in flatten_variables(variables[coll]):
            arr = np.asarray(leaf, np.float32)
            if arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            sd['module.' + torch_key_for(p, coll)] = torch.from_numpy(
                np.ascontiguousarray(arr))
    torch.save({'epoch': 0, 'state_dict': sd}, str(path))


def _import_root(name):
    """A root CLI imported by path; the XLA cache setting its import makes
    is put back."""
    cache = jax.config.jax_compilation_cache_dir
    spec = importlib.util.spec_from_file_location(
        f'mmdt_{name}_cli', os.path.join(REPO, f'{name}.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    jax.config.update('jax_compilation_cache_dir', cache)
    return mod


def _fast_jax_init(model, in_channels, image_size, seed=0, config=None):
    return fast_init(model, seed,
                     jnp.zeros((1, image_size, image_size, in_channels)))


def _read_csv(path):
    with open(path, newline='') as f:
        return list(csv.DictReader(f))


@pytest.fixture(scope='module')
def files(tmp_path_factory):
    """Seeded teacher and student files; the working directory is the
    test's own, where the runs write their exp_name directories."""
    root = tmp_path_factory.mktemp('cli')
    os.chdir(root)
    models = root / 'trained_models'
    models.mkdir()
    for seed, (m, ch) in enumerate(CHANNELS.items()):
        jmod = JaxDet(num_classes=20, compound_coef=-1, dtype=jnp.float32)
        _write_pth(filled_variables(jmod, 50 + seed,
                                    nhwc_input(0, (1, SIZE, SIZE, ch))),
                   models / f'yet-another-efficientdet-d2-{m}.pth')
    student = filled_variables(
        JaxDet(num_classes=20, compound_coef=-1, dtype=jnp.float32), 60,
        nhwc_input(0, (1, SIZE, SIZE, 8)))
    _write_pth(student, root / 'student.pth')
    return dict(root=root, models=str(models),
                student=str(root / 'student.pth'), student_vars=student)


def _overwrite(files, **extra):
    return json.dumps(dict(TINY, saved_path=files['models'], **extra))


@pytest.fixture(scope='module')
def trained(files):
    """The train CLI: pretrain_checkpoint = the student file, one fast-run
    epoch (2 steps, 2 validation batches), a torch.profiler trace, then
    the final evaluate of best.0."""
    table = cli_train.main([
        '--config_file', CONFIG, '--device', 'cpu', '--overwrite',
        _overwrite(files, exp_name='train-torch', fast_run=True,
                   log_path='tb', profile_dir='train-profile',
                   pretrain_checkpoint=files['student'])])
    return table


def test_evaluate_cli_matches_the_reference_cli(files, monkeypatch, capsys):
    monkeypatch.setattr(jax_registry, 'init_variables', _fast_jax_init)
    args = ['--config_file', CONFIG, '--checkpoint', files['student']]
    table = cli_evaluate.main(args + ['--device', 'cpu', '--overwrite',
                                      _overwrite(files,
                                                 exp_name='eval-torch')])
    printed = capsys.readouterr().out
    _import_root('evaluate').main(args + ['--overwrite', _overwrite(
        files, exp_name='eval-jax')])
    assert [r['modality'] for r in table] == ['ALL']
    assert printed.split('\n')[0].split() == COLUMNS
    got = _read_csv('eval-torch/results.0.csv')
    want = _read_csv('eval-jax/results.0.csv')
    assert list(got[0]) == COLUMNS
    assert [r['modality'] for r in want] == ['ALL']
    for col in COLUMNS[2:]:
        g, w = float(got[0][col]), float(want[0][col])
        assert np.isfinite(g) and g == table[0][col]
        assert abs(g - w) <= PARITY_ATOL, (col, g, w)
    resources = _read_csv('eval-torch/resources.0.csv')
    assert int(resources[0]['Frames']) == 6
    assert list(resources[0]) == \
        list(_read_csv('eval-jax/resources.0.csv')[0])


def test_train_cli_writes_checkpoints_a_trace_and_scores_them(files,
                                                              trained):
    """checkpoint.0 and best.0 exist, the final AP table is finite, the
    trace is a Chrome trace; the evaluate CLI on best.0 (eval_split val and
    fast_run: the frames the train CLI scored) gives the same table."""
    for name in ('checkpoint.0', 'best.0', 'only_parameters_student_best.0'):
        assert os.path.exists(os.path.join('train-torch', name)), name
    assert [r['modality'] for r in trained] == ['ALL']
    assert all(np.isfinite(trained[0][c]) for c in COLUMNS[2:])
    with open('train-profile/trace.0.json') as f:
        assert json.load(f)['traceEvents']
    again = cli_evaluate.main([
        '--config_file', CONFIG, '--device', 'cpu',
        '--checkpoint', 'train-torch/best.0', '--overwrite',
        _overwrite(files, exp_name='eval-best', eval_split='val',
                   fast_run=True)])
    for col in COLUMNS[2:]:
        assert again[0][col] == trained[0][col], col


def test_pretrain_checkpoint_loads_the_student_as_the_reference(
        files, monkeypatch):
    """train.pretrain's checkpoint branch in both packages: the same
    student tensors from the same file (pretrain_checkpoint takes
    precedence over a pretrain value)."""
    overwrite = _overwrite(files, pretrain='elsewhere.pth',
                           pretrain_checkpoint=files['student'])
    config = load_config(CONFIG, overwrite)
    jconfig = jax_load_config(CONFIG, overwrite)
    module, sd = cli_train.load_model(config.get('student'), config,
                                      'audio_student')
    _, got = cli_train.pretrain({}, (module, sd), config, None, None,
                                device='cpu')
    jmod = JaxDet(num_classes=20, compound_coef=-1, dtype=jnp.float32)
    jvars = fast_init(jmod, 0, jnp.zeros((1, SIZE, SIZE, 8)))
    _, want = _import_root('train').pretrain({}, (jmod, jvars), jconfig,
                                             None, None)
    want = state_dict_from_flax(want)
    for k, v in want.items():
        if not k.endswith('num_batches_tracked'):
            np.testing.assert_array_equal(got[k].numpy(), v.numpy(),
                                          err_msg=k)
    expected = state_dict_from_flax(files['student_vars'])
    k = 'classifier.header.pointwise_conv.conv.bias'
    np.testing.assert_array_equal(got[k].numpy(), expected[k].numpy())
    # pretrain False and no file: the student is handed back unchanged
    off = load_config(CONFIG, _overwrite(files))
    assert cli_train.pretrain({}, (module, sd), off, None, None,
                              device='cpu')[1] is sd


def test_pretrain_true_runs_a_traditional_stage(files):
    """pretrain=True: a 'traditional' training stage into
    {exp_name}/pretrain whose weights the student keeps; exp_name is put
    back."""
    config = load_config(CONFIG, _overwrite(
        files, exp_name='pre-torch', pretrain=True, fast_run=True,
        log_path='tb'))
    teachers = cli_train.load_teachers(config)
    assert list(teachers) == ['rgb', 'depth', 'thermal']
    module, sd = cli_train.load_model(config.get('student'), config,
                                      'audio_student')
    ds = factory.get_dataset(config, 'train')
    _, trained = cli_train.pretrain(teachers, (module, sd), config, ds, ds,
                                    device='cpu')
    assert config['exp_name'] == 'pre-torch'
    assert os.path.exists('pre-torch/pretrain/checkpoint.0')
    k = 'classifier.header.pointwise_conv.conv.bias'
    assert not torch.equal(trained[k], sd[k])


def test_teachers_load_from_the_files(files):
    """The teachers of the CLIs are the files' tensors, in the reference's
    order (rgb, audio, depth, thermal)."""
    config = load_config(CONFIG, _overwrite(files, use_audio=False))
    teachers = cli_train.load_teachers(config)
    assert list(teachers) == ['rgb', 'depth', 'thermal']
    for m, (module, sd) in teachers.items():
        ckpt = torch.load(os.path.join(
            files['models'], f'yet-another-efficientdet-d2-{m}.pth'),
            weights_only=True)['state_dict']
        for k, v in sd.items():
            if not k.endswith('num_batches_tracked'):
                assert torch.equal(v, ckpt['module.' + k]), (m, k)
        assert module.in_channels == CHANNELS[m]


@pytest.mark.parametrize('extra,env,match', [
    (dict(num_processes=2), {}, 'item 13'),
    (dict(coordinator_address='localhost:1234'), {}, 'item 13'),
    (dict(), {'WORLD_SIZE': '2'}, 'WORLD_SIZE'),
    (dict(), {'JAX_NUM_PROCESSES': '4'}, 'JAX_NUM_PROCESSES')])
def test_train_cli_refuses_what_is_not_ported(files, monkeypatch, extra,
                                              env, match):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(NotImplementedError, match=match):
        cli_train.main(['--config_file', CONFIG, '--device', 'cpu',
                        '--overwrite', _overwrite(files, exp_name='refused',
                                                  **extra)])


def test_nodes_and_single_process_worlds(files, monkeypatch):
    monkeypatch.delenv('WORLD_SIZE', raising=False)
    distributed_init_if_needed(None)
    distributed_init_if_needed(load_config(CONFIG, _overwrite(files)))
    monkeypatch.setenv('WORLD_SIZE', '1')
    distributed_init_if_needed(None)
    with pytest.raises(NotImplementedError, match='nodes'):
        cli_train.main(['--config_file', CONFIG, '--device', 'cpu',
                        '--nodes', '2', '--overwrite',
                        _overwrite(files, exp_name='refused')])


def test_datasets_and_just_plot(files):
    config = load_config(CONFIG, _overwrite(files))
    assert len(factory.get_dataset(config, 'val')) == 6
    config['dataset'] = 'SyntheticMultimodal'
    assert len(factory.get_dataset(config, 'test')) == 6
    config['dataset'] = 'CarsAugmented'
    with pytest.raises(ValueError, match='Unsupported dataset'):
        factory.get_dataset(config, 'train')
    with pytest.raises(NotImplementedError, match='item 14'):
        cli_evaluate.main(['--config_file', CONFIG, '--device', 'cpu',
                           '--just_plot', 'drive/1', '--overwrite',
                           _overwrite(files, exp_name='plot')])


def test_clis_raise_without_a_card_unless_asked(files):
    if torch.cuda.is_available():
        pytest.skip('this machine has CUDA')
    for main, args in ((cli_train.main, ['--config_file', CONFIG]),
                       (cli_evaluate.main, ['--config_file', CONFIG])):
        with pytest.raises(RuntimeError, match='CUDA'):
            main(args + ['--overwrite', _overwrite(files,
                                                   exp_name='nocard')])
    assert not os.path.exists('nocard')
