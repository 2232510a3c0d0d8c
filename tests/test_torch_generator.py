"""The port's multi-modal generator and StereoSoundNet against the
reference's on shared fp32 weights (test-tiny profile, 128 px): the
generator's eval forward in its three integration modes, train-mode
switch / zeroout with the drawn modality set by the test, its fused eval
path, a generator teacher in the distillation step and in the fused
teacher function (mirroring tests/test_generator_wiring.py), the
StereoSoundNet forward and its space-to-depth reorg, and the BatchNorm
recalibration (tests/test_bn_recalibration.py).

Stochastic depth cannot draw the same masks in two frameworks: the
reference's `drop_connect` is patched to the identity in train mode and the
port's networks are built with rate 0, as in test_torch_train_step.py.
Tolerances: forwards at rtol = atol = 1e-4 (test_torch_detector.py), loss
metrics at rtol 1e-4 / atol 1e-6 (test_torch_train_step.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from mm_distillnet_tpu import evaluation as jax_eval
from mm_distillnet_tpu.config import default_config as jax_default_config
from mm_distillnet_tpu.distill import train_step as jts
from mm_distillnet_tpu.distill.pseudo_labels import \
    PseudoLabelConfig as JaxPLConfig
from mm_distillnet_tpu.models import efficientdet_generator as jax_gen_mod
from mm_distillnet_tpu.models import efficientnet as jax_efficientnet
from mm_distillnet_tpu.models.efficientdet import EfficientDet as JaxDet
from mm_distillnet_tpu.models.efficientdet_generator import \
    EfficientDetGenerator as JaxGenerator
from mm_distillnet_tpu.models.layers import BN_EPS as JAX_BN_EPS
from mm_distillnet_tpu.models.layers import BN_MOMENTUM as JAX_BN_MOMENTUM
from mm_distillnet_tpu.models.stereosoundnet import \
    StereoSoundNet as JaxStereoSoundNet
from mm_distillnet_tpu.models.stereosoundnet import \
    space_to_depth_2x as jax_space_to_depth
from mm_distillnet_tpu.ops.anchors import anchor_table
from mm_distillnet_tpu.ops.postprocess import class_validity_table
from mm_distillnet_tpu.train.bn_recalibration import \
    recalibrate_batch_stats as jax_recalibrate
from mm_distillnet_torch import evaluation as ev
from mm_distillnet_torch.config import default_config
from mm_distillnet_torch.convert.weights import state_dict_from_flax
from mm_distillnet_torch.distill import train_step as ts
from mm_distillnet_torch.distill.pseudo_labels import PseudoLabelConfig
from mm_distillnet_torch.models.efficientdet import EfficientDet
from mm_distillnet_torch.models.efficientdet_generator import \
    EfficientDetGenerator
from mm_distillnet_torch.models.fused_forward import make_fused_predictor
from mm_distillnet_torch.models.layers import BN_EPS, batch_norm
from mm_distillnet_torch.models.stereosoundnet import (StereoSoundNet,
                                                       space_to_depth_2x)
from mm_distillnet_torch.ops import fused_mbconv
from mm_distillnet_torch.train.bn_recalibration import \
    recalibrate_batch_stats

from .test_torch_helpers import corr, filled_variables, nhwc_input, to_jax
from .test_torch_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread')

SIZE = 128
TOL = dict(rtol=1e-4, atol=1e-4)
MODS = ('audio', 'rgb', 'thermal')
CHANNELS = {'audio': 8, 'rgb': 3, 'thermal': 1}
FIELDS = ('classification', 'regression', 'logits', 'align_features')
PL = dict(image_size=SIZE, conf_threshold=0.3, num_candidates=64,
          max_det_per_teacher=8, max_gt=16)


def _inputs(batch=2):
    return {m: nhwc_input(i, (batch, SIZE, SIZE, CHANNELS[m]))
            for i, m in enumerate(MODS)}


def _jax_in(x):
    return {m: jnp.asarray(a) for m, a in x.items()}


def _port_in(x):
    return {m: torch.from_numpy(a) for m, a in x.items()}


@pytest.fixture(scope='module')
def generators():
    """{mode: (flax module, variables, port module in eval mode)}."""
    out = {}
    for seed, mode in enumerate(('concat', 'switch', 'zeroout')):
        jmod = JaxGenerator(modalities=MODS, num_classes=20, compound_coef=-1,
                            integration_mode=mode, dtype=jnp.float32)
        v = filled_variables(jmod, 20 + seed, _inputs(1))
        port = EfficientDetGenerator(MODS, 20, -1, mode, in_channels=CHANNELS,
                                     drop_connect_rate=0.0)
        port.load_state_dict(state_dict_from_flax(v), strict=True)
        out[mode] = (jmod, v, port.eval())
    return out


def _assert_outputs(got, want, tol=TOL):
    for f in FIELDS:
        np.testing.assert_allclose(getattr(got, f).detach().numpy(),
                                   np.asarray(getattr(want, f)), **tol,
                                   err_msg=f)
    assert len(got.features) == len(want.features) == 5
    for g, w in zip(got.features, want.features):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **tol)


@pytest.mark.parametrize('mode', ['concat', 'switch', 'zeroout'])
def test_generator_eval_forward_matches_flax(generators, mode):
    """Eval mode: concat and zeroout concatenate every modality's maps
    (heads 3x wider); switch reads the first modality only."""
    jmod, v, port = generators[mode]
    x = _inputs()
    want = jmod.apply(to_jax(v), _jax_in(x), train=False)
    with torch.no_grad():
        got = port(_port_in(x))
    _assert_outputs(got, want)
    width = 16 if mode == 'switch' else 48
    assert got.features[0].shape[-1] == width


@pytest.mark.parametrize('mode,choice', [('switch', 0), ('switch', 2),
                                         ('zeroout', 1)])
def test_generator_train_mode_with_a_set_modality_matches_flax(
        generators, monkeypatch, mode, choice):
    """Train mode with the drawn modality set on both sides: switch keeps
    that modality's maps, zeroout forwards a zero input through its
    backbone. Outputs and the updated BN statistics agree, at rtol = atol
    = 1e-4; zeroout at rtol 1e-3 / atol 1e-2: the zero input leaves nearly
    constant maps whose train-mode BN divides rounding noise by
    sqrt(var + 1e-3), so each fp32 run drifts from the exact result
    (measured against the port's float64 run: the reference's fp32
    features by up to 4.8e-3, the port's by 5.0e-4)."""
    jmod, v, port = generators[mode]
    monkeypatch.setattr(jax_efficientnet, 'drop_connect',
                        lambda x, rate, deterministic, rng: x)
    monkeypatch.setattr(jax_gen_mod.jax.random, 'randint',
                        lambda *args, **kwargs: jnp.asarray(choice))
    x = _inputs()
    want, mutated = jmod.apply(to_jax(v), _jax_in(x), train=True,
                               mutable=['batch_stats'],
                               rngs={'integration': jax.random.PRNGKey(0)})
    net = EfficientDetGenerator(MODS, 20, -1, mode, in_channels=CHANNELS,
                                drop_connect_rate=0.0)
    net.load_state_dict(port.state_dict())
    net.train()
    with torch.no_grad():
        got = net(_port_in(x), choice=choice)
    tol = dict(rtol=1e-3, atol=1e-2) if mode == 'zeroout' else TOL
    _assert_outputs(got, want, tol)
    stats = state_dict_from_flax({'batch_stats': mutated['batch_stats']})
    sd = net.state_dict()
    for k, want_stat in stats.items():
        if k.endswith('running_var') or k.endswith('running_mean'):
            np.testing.assert_allclose(sd[k].numpy(), want_stat.numpy(),
                                       **tol, err_msg=k)


def test_generator_draws_its_modality_from_the_generator(generators):
    _, _, port = generators['switch']
    net = EfficientDetGenerator(MODS, 20, -1, 'switch', in_channels=CHANNELS,
                                drop_connect_rate=0.0)
    net.load_state_dict(port.state_dict())
    net.train()
    x = _port_in(_inputs())
    draws = [net.draw(torch.Generator().manual_seed(s), 'cpu')
             for s in range(12)]
    assert set(draws) == {0, 1, 2}
    with torch.no_grad():
        got = net(x, generator=torch.Generator().manual_seed(5))
        want = net(x, choice=draws[5])
    np.testing.assert_array_equal(got.logits.numpy(), want.logits.numpy())
    with pytest.raises(ValueError, match='generator'):
        net(x)
    with pytest.raises(ValueError, match='missing modality input: thermal'):
        generators['concat'][2]({m: x[m] for m in ('audio', 'rgb')})


@pytest.mark.parametrize('mode', ['concat', 'switch'])
def test_fused_generator_runs_the_plain_version_plan(generators, mode):
    """On the CPU the fused predictor of a generator folds each backbone
    its eval forward runs (all three, or switch's first) and runs their
    blocks through the kernels' plain versions (bf16 between blocks); the
    outputs agree with the unfused module at the gates of
    tests/test_torch_fused_forward.py, and no kernel is counted."""
    _, _, port = generators[mode]
    fused_mbconv.reset_launches()
    fused = make_fused_predictor(port, port.state_dict(), SIZE,
                                 dtype=torch.float32, device='cpu')
    assert tuple(fused.backbones) == (('audio',) if mode == 'switch'
                                      else MODS)
    x = _port_in(_inputs())
    got = fused(x)
    with torch.no_grad():
        want = port(x)
    for f in FIELDS:
        assert corr(getattr(got, f), getattr(want, f)) > 0.999, f
    assert all(n == 0 for n in fused_mbconv.launches.values())


@pytest.fixture(scope='module')
def step_setup():
    """An rgb teacher, an audio-static generator teacher over (audio, rgb,
    thermal) and the student, as tests/test_generator_wiring.py's
    distillation step, with shared weights and a compact-audio batch."""
    x = _inputs()
    batch = {**x, 'audio': x['audio'][:, :80]}
    jteachers = {'rgb': JaxDet(num_classes=20, compound_coef=-1,
                               dtype=jnp.float32),
                 'audio': JaxGenerator(modalities=MODS, num_classes=20,
                                       compound_coef=-1,
                                       integration_mode='concat',
                                       dtype=jnp.float32)}
    jstudent = JaxDet(num_classes=20, compound_coef=-1, dtype=jnp.float32)
    tvars = {'rgb': filled_variables(jteachers['rgb'], 31, x['rgb']),
             'audio': filled_variables(jteachers['audio'], 32, x)}
    svars = filled_variables(jstudent, 33, x['audio'])
    teachers = {'rgb': EfficientDet(20, -1, 3),
                'audio': EfficientDetGenerator(MODS, 20, -1,
                                               in_channels=CHANNELS)}
    for m, net in teachers.items():
        net.load_state_dict(state_dict_from_flax(tvars[m]), strict=True)
    student = EfficientDet(20, -1, 8, drop_connect_rate=0.0)
    student.load_state_dict(state_dict_from_flax(svars), strict=True)
    return dict(batch=batch, jteachers=jteachers, jstudent=jstudent,
                tvars=tvars, svars=svars, teachers=teachers,
                student=student)


def test_generator_teacher_distill_step_matches_reference(step_setup,
                                                          monkeypatch):
    """The losses of a traditional_nms step with the generator teacher
    reading the stretched compact audio, rgb and thermal; the teachers
    frozen by make_teachers, unfused and fused (the plain-version plan on
    the CPU)."""
    s = step_setup
    monkeypatch.setattr(jax_efficientnet, 'drop_connect',
                        lambda x, rate, deterministic, rng: x)
    jcfg = jts.DistillConfig(train_method='traditional_nms',
                             pl=JaxPLConfig(**PL))
    anchors = anchor_table(SIZE)
    class_valid = class_validity_table(20, list(range(20)))
    _, aux = jax.jit(lambda p, bs, b: jts.compute_distill_losses(
        s['jstudent'], p, bs, s['jteachers'],
        {m: to_jax(v) for m, v in s['tvars'].items()}, b, jcfg,
        jnp.asarray(anchors), jnp.asarray(class_valid), jnp.arange(20),
        train=True))(to_jax(s['svars']['params']),
                     to_jax(s['svars']['batch_stats']),
                     _jax_in(s['batch']))
    want = jax.device_get(aux['metrics'])
    cfg = ts.DistillConfig(train_method='traditional_nms',
                           pl=PseudoLabelConfig(**PL))
    tables = (torch.as_tensor(anchors), torch.as_tensor(class_valid),
              torch.arange(20))
    for fused in (False, True):
        teachers = ts.make_teachers(s['teachers'], image_size=SIZE,
                                    fused=fused, dtype=torch.float32,
                                    device='cpu')
        assert teachers['audio'].modalities == MODS
        assert teachers['rgb'].modalities is None
        student = EfficientDet(20, -1, 8, drop_connect_rate=0.0)
        student.load_state_dict(s['student'].state_dict())
        _, got = ts.compute_distill_losses(
            student, teachers, _port_in(s['batch']), cfg, *tables,
            train=True)
        if fused:   # bf16 between the blocks: the losses move a little
            for k in ts.METRICS:
                np.testing.assert_allclose(float(got[k]), float(want[k]),
                                           rtol=2e-2, atol=1e-3, err_msg=k)
            continue
        for k in ts.METRICS:
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=1e-4, atol=1e-6, err_msg=k)
    assert float(want['KD']) != 0.0


def test_generator_teacher_in_the_fused_teacher_fn_matches_reference(
        step_setup):
    """make_fused_teacher_fn with the generator teacher (compact audio
    stretched for it): the fused label rows of both packages, as in
    test_torch_evaluation.py (same valid rows and labels, boxes within 1
    px)."""
    s = step_setup
    config = default_config(image_size=SIZE, compute_dtype='float32',
                            max_gt=16, nms_candidates=64,
                            max_det_per_teacher=8, eval_devices=1)
    jcfg = jax_default_config(image_size=SIZE, compute_dtype='float32',
                              max_gt=16, nms_candidates=64,
                              max_det_per_teacher=8, eval_devices=1)
    class_valid = class_validity_table(20, list(range(20)))
    want = jax_eval.make_fused_teacher_fn(s['jteachers'], SIZE, jcfg)(
        {m: to_jax(v) for m, v in s['tvars'].items()},
        _jax_in(s['batch']), jnp.asarray(class_valid), jnp.arange(20))
    got = ev.make_fused_teacher_fn(s['teachers'], SIZE, config,
                                   device='cpu')(
        {m: net.state_dict() for m, net in s['teachers'].items()},
        s['batch'], class_valid, np.arange(20))
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape == (2, 16, 5)
    np.testing.assert_array_equal(got[..., 4], want[..., 4])
    np.testing.assert_allclose(got[..., :4], want[..., :4], atol=1.0)


def test_stereosoundnet_forward_matches_flax():
    jmod = JaxStereoSoundNet(num_classes=20, dtype=jnp.float32)
    x = nhwc_input(3, (2, 64, 64, 8))
    v = filled_variables(jmod, 40, x)
    want_out, want_feats = jmod.apply(to_jax(v), jnp.asarray(x))
    port = StereoSoundNet(20, 8).eval()
    port.load_state_dict(state_dict_from_flax(v), strict=True)
    with torch.no_grad():
        out, feats = port(torch.from_numpy(x))
    assert tuple(out.shape) == (2, 2, 2, 125)
    assert tuple(feats.shape) == (2, 2, 2, 1024)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), **TOL)
    np.testing.assert_allclose(feats.numpy(), np.asarray(want_feats), **TOL)


def test_space_to_depth_matches_the_reference_reorg():
    x = np.random.default_rng(0).normal(size=(2, 8, 6, 64)).astype(
        np.float32)
    got = space_to_depth_2x(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got,
                                  np.asarray(jax_space_to_depth(
                                      jnp.asarray(x))))
    t = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    b, c, h, w = t.shape
    # the reference's own sequence (src/StereoSoundNet.py:180-193)
    t2 = t.view(b, c // 4, h, 2, w, 2).permute(0, 3, 5, 1, 2, 4)
    want = t2.contiguous().view(b, -1, h // 2, w // 2).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got, want.numpy())


class _JaxBN(fnn.Module):
    @fnn.compact
    def __call__(self, x, train: bool = False):
        return fnn.BatchNorm(use_running_average=not train,
                             momentum=JAX_BN_MOMENTUM, epsilon=JAX_BN_EPS)(x)


def test_bn_recalibration_matches_reference():
    """The reference test's data (8 batches of 64 samples, mean 3, std 2,
    4 channels): the recalibrated statistics equal the reference's to fp32
    rounding (rtol 1e-5), recover the population's, and the eval forward
    then normalises; the train / eval mode and the BN momentum survive."""
    rng = np.random.default_rng(0)
    batches = [rng.normal(3.0, 2.0, size=(64, 4)).astype(np.float32)
               for _ in range(8)]
    jmod = _JaxBN()
    variables = jmod.init(jax.random.PRNGKey(0), jnp.zeros((8, 4)))

    def apply_fn(variables, x, rng):
        _, mutated = jmod.apply(variables, x, train=True,
                                mutable=['batch_stats'])
        return mutated['batch_stats']

    want = jax_recalibrate(jmod, variables, [jnp.asarray(b) for b in batches],
                           apply_fn=apply_fn)['batch_stats']['BatchNorm_0']
    bn = batch_norm(4).eval()
    assert bn.eps == BN_EPS
    recalibrate_batch_stats(bn, [torch.from_numpy(b)[:, :, None, None]
                                 for b in batches])
    assert not bn.training and bn.momentum == 0.01
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(want['mean']), rtol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(want['var']), rtol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(), 3.0, atol=0.4)
    np.testing.assert_allclose(bn.running_var.numpy(), 4.0, atol=1.0)
    with torch.no_grad():
        y = bn(torch.from_numpy(batches[0])[:, :, None, None])
    assert abs(float(y.mean())) < 0.2 and abs(float(y.std()) - 1.0) < 0.2
    # no batches: the statistics stay
    before = bn.running_mean.clone()
    recalibrate_batch_stats(bn, [])
    assert torch.equal(bn.running_mean, before)
    assert recalibrate_batch_stats(torch.nn.ReLU(), batches) is not None


def test_bn_recalibration_of_a_detector_with_drop_connect():
    """A train-mode forward with stochastic depth needs its generator:
    recalibrate_batch_stats passes it; every BN's statistics move and the
    eval forward stays finite."""
    torch.manual_seed(0)
    net = EfficientDet(20, -1, 8).eval()
    before = {k: v.clone() for k, v in net.state_dict().items()}
    batches = [torch.randn(2, SIZE, SIZE, 8) for _ in range(2)]
    recalibrate_batch_stats(net, batches,
                            generator=torch.Generator().manual_seed(1))
    after = net.state_dict()
    moved = [k for k in after if k.endswith('running_var')
             and not torch.equal(after[k], before[k])]
    assert len(moved) == sum(k.endswith('running_var') for k in after)
    assert not net.training
    with torch.no_grad():
        assert torch.isfinite(net(batches[0]).classification).all()
