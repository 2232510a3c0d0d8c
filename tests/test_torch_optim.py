"""The port's optimizers and schedulers against the reference's (optax and
its host-side schedulers): three updates from a fixed gradient tree, the
learning rate changed between the second and the third, and 25 epochs of
each scheduler."""
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mm_distillnet_tpu.config import default_config as jax_default_config
from mm_distillnet_tpu.train import optim as joptim
from mm_distillnet_torch.config import default_config
from mm_distillnet_torch.train import optim

from .test_torch_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread')

SHAPES = {'conv': (8, 4, 3, 3), 'bias': (8,), 'scale': (16,),
          'dense': (20, 12)}


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (scale * rng.uniform(0.5, 1.5, s) *
                rng.choice([-1.0, 1.0], s)).astype(np.float32)
            for k, s in SHAPES.items()}


PARAMS = _tree(0)
GRADS = [_tree(1 + i, scale=0.3) for i in range(3)]   # global norm ~3
SETTINGS = {'SGD': dict(optimizer='SGD', lr='1e-2', momentum='0.9',
                        weight_decay='5e-4'),
            'Adam': dict(optimizer='Adam', lr='1e-3', b1='0.9', b2='0.999'),
            'AdamW': dict(optimizer='AdamW', lr='1e-3', b1='0.8',
                          b2='0.99')}


def _reference(settings):
    tx = joptim.build_optimizer(jax_default_config(**settings))
    params = {k: jnp.asarray(v) for k, v in PARAMS.items()}
    state = tx.init(params)
    for i, g in enumerate(GRADS):
        if i == 2:
            state = joptim.set_learning_rate(state, 3e-3)
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   state, params)
        params = optax.apply_updates(params, updates)
    return params


def _port(settings, state_dict_after=None):
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for k, v in PARAMS.items()}
    opt = optim.build_optimizer(default_config(**settings), params.values(),
                                device='cpu')
    for i, g in enumerate(GRADS):
        if i == 2:
            optim.set_learning_rate(opt, 3e-3)
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k])
        optim.apply_gradients(opt)
        if i == state_dict_after:
            # a fresh optimizer from the state_dict carries on alike
            fresh = optim.build_optimizer(default_config(**settings),
                                          params.values(), device='cpu')
            fresh.load_state_dict(opt.state_dict())
            opt = fresh
    return params, opt


@pytest.mark.parametrize('clip', [None, '0.5'], ids=['no_clip', 'clip'])
@pytest.mark.parametrize('name', list(SETTINGS))
def test_optimizer_matches_optax(name, clip):
    settings = dict(SETTINGS[name], **({'grad_clip': clip} if clip else {}))
    want = _reference(settings)
    got, opt = _port(settings)
    assert optim.get_learning_rate(opt) == 3e-3
    for k, p in got.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=0, err_msg=k)


@pytest.mark.parametrize('name', list(SETTINGS))
def test_optimizer_state_dict_round_trip(name):
    settings = dict(SETTINGS[name], grad_clip='0.5')
    want, _ = _port(settings)
    got, opt = _port(settings, state_dict_after=0)
    assert opt.param_groups[0]['grad_clip'] == 0.5
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_clip_is_optax_global_norm_clip():
    """Below the threshold the gradients stay bit-equal; above it they are
    scaled to the threshold's norm."""
    grads = [torch.from_numpy(v.copy()) for v in GRADS[0].values()]
    norm = float(torch.linalg.vector_norm(torch.cat([g.flatten()
                                                     for g in grads])))
    kept = [g.clone() for g in grads]
    optim.clip_by_global_norm_(kept, norm * 1.01)
    assert all(torch.equal(a, b) for a, b in zip(kept, grads))
    clipped = [g.clone() for g in grads]
    got = optim.clip_by_global_norm_(clipped, 0.5)
    np.testing.assert_allclose(float(got), norm, rtol=1e-6)
    new_norm = float(torch.linalg.vector_norm(torch.cat(
        [g.flatten() for g in clipped])))
    np.testing.assert_allclose(new_norm, 0.5, rtol=1e-6)


SCHEDULERS = {'StepLR': dict(scheduler='StepLR', step_size='4',
                             gamma='0.5'),
              'ReduceLROnPlateau': dict(scheduler='ReduceLROnPlateau'),
              'CosineAnnealingWarmRestarts': dict(
                  scheduler='CosineAnnealingWarmRestarts')}
# an epoch loss that falls, stalls and falls again: the plateau rule fires
LOSSES = [10.0 / (1 + e) if e < 8 or e > 16 else 1.2 for e in range(25)]


@pytest.mark.parametrize('name', list(SCHEDULERS))
def test_scheduler_matches_reference(name):
    settings = dict(SCHEDULERS[name], lr='1e-3')
    want = joptim.build_scheduler(jax_default_config(**settings))
    got = optim.build_scheduler(default_config(**settings))
    lrs = []
    for e, loss in enumerate(LOSSES):
        lr = got.step(loss)
        assert lr == want.step(loss), e
        lrs.append(lr)
        if e == 12:
            # a fresh scheduler from the state_dict carries on alike
            fresh = optim.build_scheduler(default_config(**settings))
            fresh.load_state_dict(got.state_dict())
            assert fresh.state_dict() == got.state_dict()
            got = fresh
    assert got.state_dict() == want.state_dict()
    assert len(set(lrs)) > 1


def test_unknown_names_raise():
    with pytest.raises(ValueError, match='optimizer'):
        optim.build_optimizer(default_config(optimizer='Lion'), [],
                              device='cpu')
    with pytest.raises(ValueError, match='scheduler'):
        optim.build_scheduler(default_config(scheduler='OneCycle'))
