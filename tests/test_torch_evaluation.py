"""The port's evaluation path (predict function, fused teacher function,
evaluate()) against the reference's on shared fp32 weights at the test-tiny
profile, 128 px, on the synthetic dataset with the compact audio ingest."""
import csv
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm_distillnet_tpu import evaluation as jax_eval
from mm_distillnet_tpu.config import default_config as jax_default_config
from mm_distillnet_tpu.data.base import (
    prediction_to_label_lut as jax_lut,
    valid_prediction_ids as jax_valid_ids)
from mm_distillnet_tpu.data.synthetic import \
    SyntheticMultimodal as JaxSynthetic
from mm_distillnet_tpu.models.efficientdet import EfficientDet as JaxDet
from mm_distillnet_tpu.ops.postprocess import \
    class_validity_table as jax_class_table
from mm_distillnet_torch import evaluation as ev
from mm_distillnet_torch.config import default_config
from mm_distillnet_torch.convert.weights import state_dict_from_flax
from mm_distillnet_torch.data.loader import collate
from mm_distillnet_torch.data.synthetic import SyntheticMultimodal
from mm_distillnet_torch.models.efficientdet import EfficientDet
from mm_distillnet_torch.models.efficientdet_generator import \
    EfficientDetGenerator
from mm_distillnet_torch.ops import fused_mbconv

from .test_torch_helpers import corr, filled_variables, nhwc_input, to_jax

SIZE = 128
CHANNELS = {'rgb': 3, 'thermal': 1, 'depth': 3, 'audio': 8}
SETTINGS = dict(
    image_size=SIZE, synthetic_size=6, batch_size=2, num_workers=1,
    fast_run=False, use_rgb=True, use_thermal=True, use_depth=True,
    max_gt=16, nms_candidates=64, max_det_per_teacher=8, max_detections=16,
    compute_dtype='float32', rank=0, eval_devices=1,
    device_audio_resize=True)
COLUMNS = ['exp_name', 'modality', 'AP@Ave', 'AP@0.5', 'AP@0.75', 'CDx',
           'CDy']
# |port - JAX| bound on every AP and CD value of evaluate() and of the
# evaluate CLIs: measured 0.0 over five weight seeds
# (scripts/torch_eval_parity_seeds.py)
PARITY_ATOL = 1e-9


@pytest.fixture(scope='module')
def setup(tmp_path_factory):
    os.chdir(tmp_path_factory.mktemp('eval'))
    nets = {}
    for seed, (m, ch) in enumerate(CHANNELS.items()):
        jmod = JaxDet(num_classes=20, compound_coef=-1, dtype=jnp.float32)
        v = filled_variables(jmod, 10 + seed,
                             nhwc_input(0, (1, SIZE, SIZE, ch)))
        nets[m] = (jmod, v, EfficientDet(20, -1, ch),
                   state_dict_from_flax(v))
    jcfg = jax_default_config(exp_name='eval-jax', **SETTINGS)
    tcfg = default_config(exp_name='eval-torch', **SETTINGS)
    jset = JaxSynthetic(jcfg, 'test')
    tset = SyntheticMultimodal(tcfg, 'test')
    vcd = tset.valid_classes_dict
    assert vcd == jset.valid_classes_dict
    class_valid = jax_class_table(20, jax_valid_ids(vcd))
    lut = jax_lut(vcd, 20)
    batch = collate([tset[i] for i in range(2)])
    return dict(nets=nets, jcfg=jcfg, tcfg=tcfg, jset=jset, tset=tset,
                class_valid=class_valid, lut=lut, batch=batch)


def _same_rows(got, want, min_valid=1):
    """Label rows of both packages: the same valid rows with the same
    labels, boxes within 1 px (floor()-ed fp32 coordinates may fall on
    either side of an integer), scores within 1e-4."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    valid = want[..., -1] != -1
    assert valid.sum() >= min_valid, 'the comparison needs valid rows'
    np.testing.assert_array_equal(got[..., -1], want[..., -1])
    np.testing.assert_allclose(got[..., :4], want[..., :4], atol=1.0)
    if got.shape[-1] == 6:
        np.testing.assert_allclose(got[..., 4], want[..., 4], atol=1e-4)


def test_count_params_equals_reference(setup):
    _, v, module, sd = setup['nets']['audio']
    want = jax_eval.count_params(v)
    assert ev.count_params(sd) == want
    module.load_state_dict(sd)
    assert ev.count_params(module) == want


def test_predict_fn_matches_reference(setup):
    """The student's predict function on a compact-audio batch (80 mel
    rows): the stretch, the forward, the post-process and the label rows."""
    jmod, v, module, sd = setup['nets']['audio']
    audio = setup['batch']['audio']
    assert audio.shape == (2, 80, SIZE, 8)
    want_rows, want_feats = jax_eval.make_predict_fn(
        jmod, SIZE, setup['jcfg'])(to_jax(v), jnp.asarray(audio),
                                   jnp.asarray(setup['class_valid']),
                                   jnp.asarray(setup['lut']))
    predict = ev.make_predict_fn(module, SIZE, setup['tcfg'], variables=sd,
                                 device='cpu')
    rows, feats = predict(sd, audio, setup['class_valid'], setup['lut'])
    assert tuple(rows.shape) == (2, 16, 6)
    _same_rows(rows.numpy(), want_rows)
    for g, w in zip(feats, want_feats):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-3,
                                   atol=1e-4)
    # the variables of a call are loaded when none were given at the start
    late = ev.make_predict_fn(module, SIZE, setup['tcfg'], device='cpu')
    rows2, _ = late(sd, audio, setup['class_valid'], setup['lut'])
    assert torch.equal(rows, rows2)


def test_fused_teacher_fn_matches_reference(setup):
    nets, batch = setup['nets'], setup['batch']
    teachers = ('rgb', 'thermal', 'depth')
    want = jax_eval.make_fused_teacher_fn(
        {m: nets[m][0] for m in teachers}, SIZE, setup['jcfg'])(
            {m: to_jax(nets[m][1]) for m in teachers},
            {m: jnp.asarray(batch[m]) for m in CHANNELS},
            jnp.asarray(setup['class_valid']), jnp.asarray(setup['lut']))
    fn = ev.make_fused_teacher_fn({m: nets[m][2] for m in teachers}, SIZE,
                                  setup['tcfg'], device='cpu')
    got = fn({m: nets[m][3] for m in teachers}, batch, setup['class_valid'],
             setup['lut'])
    assert tuple(got.shape) == (2, 16, 5)
    _same_rows(got.numpy(), want, min_valid=2)


def test_fused_inference_runs_the_plain_version_plan(setup):
    """fused_inference=True on the CPU: every block through the kernels'
    plain versions (bf16 between blocks), held against the port's unfused
    path at the gates of tests/test_torch_fused_forward.py; no kernel is
    counted."""
    nets, batch = setup['nets'], setup['batch']
    fcfg = default_config(exp_name='eval-torch', fused_inference=True,
                          **SETTINGS)
    _, _, module, sd = nets['audio']
    fused_mbconv.reset_launches()
    fused = ev.make_predict_fn(module, SIZE, fcfg, variables=sd,
                               device='cpu')
    plain = ev.make_predict_fn(module, SIZE, setup['tcfg'], variables=sd,
                               device='cpu')
    args = (None, batch['audio'], setup['class_valid'], setup['lut'])
    rows_f, feats_f = fused(*args)
    rows_p, feats_p = plain(*args)
    assert rows_f.shape == rows_p.shape
    for g, w in zip(feats_f, feats_p):
        assert g.shape == w.shape and corr(g, w) > 0.999
    teachers = ('rgb', 'thermal', 'depth')
    t_vars = {m: nets[m][3] for m in teachers}
    t_mods = {m: nets[m][2] for m in teachers}
    with pytest.raises(ValueError, match='teacher_variables'):
        ev.make_fused_teacher_fn(t_mods, SIZE, fcfg, device='cpu')
    got = ev.make_fused_teacher_fn(t_mods, SIZE, fcfg,
                                   teacher_variables=t_vars, device='cpu')(
        t_vars, batch, setup['class_valid'], setup['lut'])
    want = ev.make_fused_teacher_fn(t_mods, SIZE, setup['tcfg'],
                                    device='cpu')(
        t_vars, batch, setup['class_valid'], setup['lut'])
    assert got.shape == want.shape and (got[..., 4] != -1).any()
    assert all(n == 0 for n in fused_mbconv.launches.values())


def _read_csv(path):
    with open(path, newline='') as f:
        return list(csv.DictReader(f))


def test_evaluate_matches_reference(setup):
    """evaluate() end to end in both packages: three teachers fused into
    the 'ALL' testing point, six synthetic frames with the compact audio
    ingest. The detections agree to within 1 px (see _same_rows), so a
    match could cross an IoU threshold of the sweep; measured over five
    weight seeds (scripts/torch_eval_parity_seeds.py) every AP and CD
    value was equal to the last digit, so the bound is PARITY_ATOL, just
    above 0 (AP@0.5 17.6 at this seed)."""
    nets = setup['nets']
    teachers = ('rgb', 'thermal', 'depth')
    want = jax_eval.evaluate(
        {m: (nets[m][0], to_jax(nets[m][1])) for m in teachers},
        (nets['audio'][0], to_jax(nets['audio'][1])), setup['jset'],
        setup['jcfg'])
    got = ev.evaluate({m: (nets[m][2], nets[m][3]) for m in teachers},
                      (nets['audio'][2], nets['audio'][3]), setup['tset'],
                      setup['tcfg'], device='cpu')
    assert [r['modality'] for r in got] == list(want['modality']) == ['ALL']
    assert list(got[0]) == COLUMNS
    assert set(want.columns) >= set(COLUMNS)
    for col in COLUMNS[2:]:
        g, w = got[0][col], float(want[col][0])
        assert np.isfinite(g)
        assert abs(g - w) <= PARITY_ATOL, (col, g, w)
    results = _read_csv('eval-torch/results.0.csv')
    assert list(results[0]) == COLUMNS
    assert float(results[0]['AP@0.5']) == got[0]['AP@0.5']
    assert list(results[0]) == list(_read_csv('eval-jax/results.0.csv')[0])
    resources = _read_csv('eval-torch/resources.0.csv')
    assert list(resources[0]) == \
        list(_read_csv('eval-jax/resources.0.csv')[0])
    assert int(resources[0]['Frames']) == 6
    assert int(resources[0]['TotalParams']) == \
        jax_eval.count_params(nets['audio'][1])


def test_evaluate_options(setup, tmp_path):
    """Per-modality testing points without depth, eval_batch_size,
    fast_run (two batches), eval_pipeline_depth, dataset labels and the
    saved fused annotations."""
    nets = setup['nets']
    cfg = default_config(
        exp_name='eval-options', data_path=str(tmp_path),
        **{**SETTINGS, 'use_depth': False, 'fast_run': True,
           'eval_batch_size': 1, 'eval_pipeline_depth': 1,
           'save_fused_annotations': True})
    tset = SyntheticMultimodal(cfg, 'test')
    teachers = {m: (nets[m][2], nets[m][3]) for m in ('rgb', 'thermal')}
    student = (nets['audio'][2], nets['audio'][3])
    table = ev.evaluate(teachers, student, tset, cfg, device='cpu')
    assert [r['modality'] for r in table] == ['rgb', 'thermal']
    assert all(np.isfinite(r[c]) for r in table for c in COLUMNS[2:])
    assert int(_read_csv('eval-options/resources.0.csv')[0]['Frames']) == 2
    saved = sorted(os.listdir(tmp_path / 'synthetic_drive' / 'annotations'))
    assert len(saved) == 2 and saved[0].endswith('.all.txt')
    cfg['use_labels'] = 'True'
    table = ev.evaluate(teachers, student, tset, cfg, device='cpu')
    assert all(np.isfinite(r['AP@Ave']) for r in table)


@pytest.mark.parametrize('key,match', [('quant_inference', 'quant'),
                                       ('approx_topk', 'approx')])
def test_unported_options_raise(setup, key, match):
    _, _, module, sd = setup['nets']['audio']
    cfg = default_config(**{**SETTINGS, key: True})
    with pytest.raises(NotImplementedError, match=match):
        ev.make_predict_fn(module, SIZE, cfg, variables=sd, device='cpu')


def test_generator_teacher_and_multi_device_eval_raise(setup):
    """A generator teacher runs (tests/test_torch_generator.py holds it to
    the reference) and reads every one of its modalities: a batch without
    one raises. Multi-device evaluation still raises."""
    nets = setup['nets']
    generator = EfficientDetGenerator(('rgb', 'sonar'), 20, -1,
                                      in_channels={'sonar': 2})
    fn = ev.make_fused_teacher_fn({'rgb': generator}, SIZE, setup['tcfg'],
                                  device='cpu')
    with pytest.raises(KeyError, match='sonar'):
        fn({'rgb': generator.state_dict()}, setup['batch'],
           setup['class_valid'], setup['lut'])
    cfg = default_config(**{**SETTINGS, 'eval_devices': 2})
    with pytest.raises(NotImplementedError, match='eval_devices'):
        ev.evaluate({'rgb': (nets['rgb'][2], nets['rgb'][3])},
                    (nets['audio'][2], nets['audio'][3]), setup['tset'],
                    cfg, device='cpu')
    with pytest.raises(NotImplementedError, match='mesh'):
        ev.make_predict_fn(nets['audio'][2], SIZE, setup['tcfg'],
                           mesh=object(), device='cpu')


def test_default_device_raises_without_cuda(setup):
    if torch.cuda.is_available():
        pytest.skip('this machine has CUDA')
    _, _, module, sd = setup['nets']['audio']
    with pytest.raises(RuntimeError, match='CUDA'):
        ev.make_predict_fn(module, SIZE, setup['tcfg'], variables=sd)
    with pytest.raises(RuntimeError, match='CUDA'):
        ev.make_fused_teacher_fn({'rgb': setup['nets']['rgb'][2]}, SIZE,
                                 setup['tcfg'])
