"""The port's distillation step against the reference's on shared fp32
weights: the test-tiny profile at 128 px, two teachers (rgb, thermal) and
batch 2, the shapes of the reference's own train-step tests
(tests/test_train_step.py `_setup`).

Stochastic depth cannot draw the same masks in two frameworks, so it is off
on both sides: the reference's `drop_connect` is patched to the identity
here (the package itself is not changed) and the port's student is built
with rate 0. The reference's models are called through jitted wrappers so
that the one program holding every loss variant traces each network once.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mm_distillnet_tpu.config import default_config as jax_default_config
from mm_distillnet_tpu.distill import train_step as jts
from mm_distillnet_tpu.distill.pseudo_labels import \
    PseudoLabelConfig as JaxPLConfig
from mm_distillnet_tpu.distill.pseudo_labels import \
    fuse_teacher_labels as jax_fuse
from mm_distillnet_tpu.models import efficientnet as jax_efficientnet
from mm_distillnet_tpu.models.efficientdet import EfficientDet as JaxDet
from mm_distillnet_tpu.ops.anchors import anchor_table
from mm_distillnet_tpu.ops.postprocess import class_validity_table
from mm_distillnet_tpu.train.optim import build_optimizer as jax_optimizer
from mm_distillnet_torch.config import default_config
from mm_distillnet_torch.convert.weights import state_dict_from_flax
from mm_distillnet_torch.distill import train_step as ts
from mm_distillnet_torch.distill.pseudo_labels import PseudoLabelConfig
from mm_distillnet_torch.models.efficientdet import EfficientDet

from .test_torch_helpers import filled_variables, nhwc_input
from .test_torch_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread')

SIZE = 128
CHANNELS = {'rgb': 3, 'thermal': 1, 'audio': 8}
PL = dict(image_size=SIZE, conf_threshold=0.3, num_candidates=64,
          max_det_per_teacher=8, max_gt=16)
METHODS = ('traditional', 'traditional_nms', 'traditional_nms_augmented',
           'traditional_nms_kdlist', 'traditional_nms_kdlist_augmented')
# every train method (the audio mix on where the method has it), the other
# kd_loss values, the live DistillKL and the supervised path
CASES = {m: dict(train_method=m,
                 audio_augmentation_merge='augmented' in m)
         for m in METHODS}
CASES.update({'AttentionLoss': dict(kd_loss='AttentionLoss'),
              'kd_None': dict(kd_loss='None'),
              'DistillKL': dict(div_loss='DistillKL'),
              'use_labels': dict(train_method='traditional',
                                 use_labels=True)})
SGD = dict(optimizer='SGD', lr='1e-2')    # momentum 0.9, weight decay 5e-4


class _Jitted:
    """A reference model whose apply is one jitted function, so that each
    network is traced once however often the losses call it."""

    def __init__(self, model):
        self.features_from = model.features_from
        self._apply = jax.jit(model.apply,
                              static_argnames=('train', 'mutable'))

    def apply(self, variables, x, train=False, mutable=False, rngs=None):
        if isinstance(mutable, list):
            mutable = tuple(mutable)
        return self._apply(variables, x, train=train, mutable=mutable,
                           rngs=rngs)


class _Fixed:
    """A reference teacher whose eval forward was computed beforehand."""
    features_from = 'efficientnet'

    def __init__(self, out):
        self.out = out

    def apply(self, variables, x, train=False):
        return self.out


def _labels():
    """Two annotations on image 0, none on image 1."""
    lab = np.full((2, 16, 5), -1.0, np.float32)
    lab[..., :4] = 0.0
    lab[0, 0] = [10, 12, 60, 50, 6]
    lab[0, 1] = [70, 64, 120, 100, 6]
    return lab


def _jax_cfg(**kw):
    return jts.DistillConfig(pl=JaxPLConfig(**PL), **kw)


@pytest.fixture(scope='module')
def ref():
    """The reference's numbers for every case, and the shared inputs."""
    batch = {m: nhwc_input(i, (2, SIZE, SIZE, c))
             for i, (m, c) in enumerate(CHANNELS.items())}
    batch['label'] = _labels()
    jmods = {m: JaxDet(num_classes=20, compound_coef=-1, dtype=jnp.float32)
             for m in CHANNELS}
    jvars = {m: filled_variables(jmods[m], 20 + i,
                                 batch[m][:1])
             for i, m in enumerate(CHANNELS)}
    wrapped = {m: _Jitted(jmods[m]) for m in CHANNELS}
    teachers = {m: wrapped[m] for m in ('rgb', 'thermal')}
    t_vars = {m: jvars[m] for m in teachers}
    s_vars = jvars['audio']
    anchors = jnp.asarray(anchor_table(SIZE))
    class_valid = jnp.asarray(class_validity_table(20, list(range(20))))
    lut = jnp.arange(20)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    rng = jax.random.PRNGKey(3)

    # the teachers' forwards and their per-teacher label rows once, handed
    # to every case through stand-ins
    t_outs = jax.jit(lambda: {m: teachers[m].apply(t_vars[m], jbatch[m])
                              for m in teachers})()
    fixed = {m: _Fixed(t_outs[m]) for m in teachers}
    per = jax.jit(lambda: jts._labels_per_teacher(
        jts._teacher_forward(fixed, t_vars, jbatch), anchors, class_valid,
        lut, _jax_cfg()))()

    def losses(params, batch_stats, cfg, train):
        return jts.compute_distill_losses(
            wrapped['audio'], params, batch_stats, fixed, t_vars, jbatch,
            cfg, anchors, class_valid, lut, train=train, dropout_rng=rng)

    def every_case(params, batch_stats):
        metrics = {name: losses(params, batch_stats, _jax_cfg(**kw),
                                True)[1]['metrics']
                   for name, kw in CASES.items()}
        metrics['eval'] = losses(params, batch_stats, _jax_cfg(),
                                 False)[1]['metrics']
        # the focal loss's targets: per-teacher rows, fused rows (with the
        # label union of the audio mix)
        labels = {'per_teacher': per,
                  'fused': jax_fuse(per, _jax_cfg().pl),
                  'fused_union': jax_fuse(jts._augment_label_union(per),
                                          _jax_cfg().pl)}
        return metrics, labels

    # the reference's train step (make_train_step's body), which also
    # hands out the gradients
    tx = jax_optimizer(jax_default_config(**SGD))

    def sgd_step(params, batch_stats):
        (_, aux), grads = jax.value_and_grad(
            lambda p: losses(p, batch_stats, _jax_cfg(), True),
            has_aux=True)(params)
        updates, _ = tx.update(grads, tx.init(params), params)
        return (optax.apply_updates(params, updates), aux['batch_stats'],
                aux['metrics'], grads)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_efficientnet, 'drop_connect',
                   lambda x, rate, deterministic, rng: x)
        mp.setattr(jts, '_labels_per_teacher', lambda *args: per)
        metrics, labels = jax.device_get(jax.jit(every_case)(
            s_vars['params'], s_vars['batch_stats']))
        params, stats, step_metrics, grads = jax.device_get(jax.jit(
            sgd_step)(s_vars['params'], s_vars['batch_stats']))
    return dict(batch=batch, jvars=jvars, metrics=metrics, labels=labels,
                stepped={'params': params, 'batch_stats': stats},
                step_metrics=step_metrics, grads=grads)


def _port(ref, **overrides):
    """The port's student (stochastic depth off) and frozen teachers on the
    CPU, from the reference's weights."""
    nets = {m: EfficientDet(20, -1, c, drop_connect_rate=0.0)
            for m, c in CHANNELS.items()}
    for m, net in nets.items():
        net.load_state_dict(state_dict_from_flax(ref['jvars'][m]))
    teachers = ts.make_teachers({m: nets[m] for m in ('rgb', 'thermal')},
                                image_size=SIZE, fused=False,
                                dtype=torch.float32, device='cpu')
    state = ts.init_train_state(nets['audio'], default_config(**overrides),
                                device='cpu')
    batch = {k: torch.from_numpy(v) for k, v in ref['batch'].items()}
    return teachers, state, batch


def _cfg(**kw):
    return ts.DistillConfig(pl=PseudoLabelConfig(**PL), **kw)


TABLES = (torch.as_tensor(anchor_table(SIZE)),
          torch.as_tensor(class_validity_table(20, list(range(20)))),
          torch.arange(20))


def _close(got, want):
    for k in ts.METRICS:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize('case', list(CASES))
def test_distill_losses_match_reference(ref, case):
    """Every metric of the train-mode losses within rtol 1e-4 / atol 1e-6,
    after the focal loss's targets are found equal row for row."""
    teachers, state, batch = _port(ref)
    cfg = _cfg(**CASES[case])
    anchors, class_valid, lut = TABLES
    targets = ts.teacher_targets(teachers, batch, cfg, anchors, class_valid,
                                 lut)
    labels = ref['labels']
    if cfg.use_labels:
        want = [ref['batch']['label']]
    elif cfg.train_method == 'traditional':
        want = [np.concatenate([lab[..., :4], lab[..., 5:6]], -1)
                for lab in labels['per_teacher']]
    else:
        want = [labels['fused_union' if cfg.audio_augmentation_merge
                       else 'fused']]
    assert len(targets.annotations) == len(want)
    for got, w in zip(targets.annotations, want):
        assert (w[..., 4] != -1).any()
        np.testing.assert_array_equal(got.numpy(), w)
    _, metrics = ts.student_losses(state.model, targets, cfg, anchors, True)
    _close(metrics, ref['metrics'][case])


def test_default_method_gradients_match_reference(ref):
    """Per tensor: ||g_port - g_ref|| <= 1e-3 ||g_ref|| + 1e-7. A bias that
    a train-mode BatchNorm cancels (a conv's bias or a BN's shift feeding
    one through a linear map) has a zero gradient in exact arithmetic and
    carries rounding noise in both frameworks (norms up to 1.5e-6 here,
    the largest gradient's norm being 6.3): such a tensor is held to that,
    both norms under 1e-6 of the largest."""
    teachers, state, batch = _port(ref)
    loss, _ = ts.compute_distill_losses(state.model, teachers, batch,
                                        _cfg(), *TABLES, train=True)
    loss.backward()
    want = state_dict_from_flax({'params': jax.tree_util.tree_map(
        np.array, ref['grads'])})
    got = {k: p.grad for k, p in state.model.named_parameters()}
    assert set(got) == set(want)
    top = max(float(w.norm()) for w in want.values())
    noise = []
    for k, g in got.items():
        w = want[k]
        if float((g - w).norm()) <= 1e-3 * float(w.norm()) + 1e-7:
            continue
        assert k.endswith('bias'), k
        assert max(float(g.norm()), float(w.norm())) <= 1e-6 * top, k
        noise.append(k)
    assert len(noise) < len(got) // 4, noise
    assert sum(float(g.norm()) > 0 for g in got.values()) > len(got) // 2


def test_sgd_step_matches_reference(ref):
    """One SGD step (momentum 0.9, weight decay 5e-4, lr 1e-2): the metrics,
    the parameters (rtol 1e-5 / atol 1e-6) and the BN running statistics
    (rtol 1e-4 / atol 1e-6) of the reference's step."""
    teachers, state, batch = _port(ref, **SGD)
    step = ts.make_train_step(teachers, _cfg(), *TABLES,
                              compute_dtype=torch.float32, device='cpu')
    metrics = step(state, batch)
    assert state.step == 1
    _close(metrics, ref['step_metrics'])
    want = state_dict_from_flax(ref['stepped'])
    got = state.model.state_dict()
    for k, w in want.items():
        if k.endswith('num_batches_tracked'):
            continue
        stat = k.endswith(('running_mean', 'running_var'))
        np.testing.assert_allclose(got[k].numpy(), w.numpy(),
                                   rtol=1e-4 if stat else 1e-5, atol=1e-6,
                                   err_msg=k)


def test_eval_loss_step_leaves_the_state_alone(ref):
    teachers, state, batch = _port(ref)
    state.model.train()
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    step = ts.make_eval_loss_step(teachers, _cfg(), *TABLES,
                                  compute_dtype=torch.float32, device='cpu')
    metrics = step(state, batch)
    _close(metrics, ref['metrics']['eval'])
    assert state.step == 0 and state.model.training
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert all(p.grad is None for p in state.model.parameters())


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_merge_audio_batch01_matches_reference(dtype):
    """bf16: bit-equal. fp32: the power, the sum and the clamp are
    bit-equal (XLA's integer_pow is repeated squaring), but XLA:CPU's f32
    log is a polynomial of its own, not torch's, so a few percent of the
    merged values differ, by at most two ulps (the log's and the product's
    rounding); two XLA compilations of the reference differ as much."""
    a = (nhwc_input(5, (2, 16, 16, 8)) * 0.6).astype(np.float32)
    jdt = {'float32': jnp.float32, 'bfloat16': jnp.bfloat16}[dtype]
    tdt = getattr(torch, dtype)
    want = np.asarray(jts.merge_audio_batch01(
        jnp.asarray(a).astype(jdt)).astype(jnp.float32))
    x = torch.from_numpy(a).to(tdt)
    got = ts.merge_audio_batch01(x).float().numpy()
    np.testing.assert_array_equal(got[0], want[0])
    assert torch.equal(x.float(), torch.from_numpy(a).to(tdt).float())
    if dtype == 'bfloat16':
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_array_max_ulp(got[1], want[1], maxulp=2)


def test_per_replica_bn_mode_is_not_ported_yet(ref):
    """bn_mode='per_replica' is ported (tests/test_torch_distributed.py
    holds two ranks to JAX make_train_step_per_replica_bn). In one
    process it is the plain step: the reference's SGD step at the bounds
    of test_sgd_step_matches_reference. An unknown mode raises."""
    teachers, state, batch = _port(ref, **SGD)
    step = ts.make_train_step_per_replica_bn(
        teachers, _cfg(), *TABLES, compute_dtype=torch.float32,
        device='cpu')
    _close(step(state, batch), ref['step_metrics'])
    want = state_dict_from_flax(ref['stepped'])
    got = state.model.state_dict()
    for k, w in want.items():
        if k.endswith('num_batches_tracked'):
            continue
        stat = k.endswith(('running_mean', 'running_var'))
        np.testing.assert_allclose(got[k].numpy(), w.numpy(),
                                   rtol=1e-4 if stat else 1e-5, atol=1e-6,
                                   err_msg=k)
    with pytest.raises(ValueError, match='per_replica'):
        ts.make_train_step({}, _cfg(), *TABLES, bn_mode='replica',
                           device='cpu')


def test_entry_points_default_to_the_card():
    """Without a card, the step builders and the optimizer raise unless
    asked for the CPU."""
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    with pytest.raises(RuntimeError, match='CUDA'):
        ts.make_train_step({}, _cfg(), *TABLES)
    with pytest.raises(RuntimeError, match='CUDA'):
        ts.make_eval_loss_step({}, _cfg(), *TABLES)
    with pytest.raises(RuntimeError, match='CUDA'):
        ts.init_train_state(EfficientDet(20, -1, 8), default_config())
