"""Shared inputs for the port's parity tests, and checks of them.

`filled_variables` builds a reference variable tree without compiling
`module.init` (jax.eval_shape + a numpy fill, as helpers.fast_init does),
but with non-trivial BatchNorm statistics (mean ~ N(0, 0.1), var in
[0.5, 1.5], scale in [0.8, 1.2]) and fan-in-scaled kernels, so BN folding
and eval-mode normalisation are exercised and activations do not decay.
The same numpy arrays go to both packages.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm_distillnet_tpu.models.efficientnet import BlockArgs as JaxBlockArgs
from mm_distillnet_tpu.models.efficientnet import MBConvBlock as JaxMBConv
from mm_distillnet_torch.models.efficientnet import BlockArgs


@pytest.fixture(scope='module')
def one_torch_thread():
    """torch on one intra-op thread for a module, restored after it: the
    tests run several workers on a few cores, and torch's thread pool on
    every core of a busy machine made a tiny-model file 4-20x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def filled_variables(module, seed, *args, **kwargs):
    shapes = jax.eval_shape(functools.partial(module.init, **kwargs),
                            jax.random.PRNGKey(0), *args)
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key if hasattr(path[-1], 'key') else str(path[-1])
        shape = s.shape
        if name == 'scale':
            v = rng.uniform(0.8, 1.2, shape)
        elif name == 'var':
            v = rng.uniform(0.5, 1.5, shape)
        elif name in ('mean', 'bias'):
            v = rng.normal(0.0, 0.1, shape)
        elif name == 'kernel':
            fan_in = int(np.prod(shape[:-1]))
            v = rng.normal(0.0, 1.0 / np.sqrt(fan_in), shape)
        else:  # BiFPN fast-attention weights
            v = rng.uniform(0.5, 1.5, shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def nhwc_input(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def corr(a, b):
    return np.corrcoef(np.asarray(a, np.float64).ravel(),
                       np.asarray(b, np.float64).ravel())[0, 1]


def as_jax_args(args: BlockArgs) -> JaxBlockArgs:
    return JaxBlockArgs(**args.__dict__)


def test_filled_bn_stats_are_non_trivial():
    args = BlockArgs(3, 1, 16, 16, 6, 1)
    x = nhwc_input(0, (1, 8, 8, 16))
    v = filled_variables(JaxMBConv(as_jax_args(args), dtype=jnp.float32), 1,
                         x)
    stats = v['batch_stats']['_bn1']
    assert np.abs(stats['mean']).max() > 0.05
    assert stats['var'].min() >= 0.5 and stats['var'].max() <= 1.5
    assert not np.allclose(v['params']['_bn1']['scale'], 1.0)


def test_filled_variables_are_deterministic():
    args = BlockArgs(3, 1, 16, 24, 6, 2)
    x = nhwc_input(0, (1, 8, 8, 16))
    mod = JaxMBConv(as_jax_args(args), dtype=jnp.float32)
    a = filled_variables(mod, 3, x)
    b = filled_variables(mod, 3, x)
    for la, lb in zip(jax.tree_util.tree_leaves(a),
                      jax.tree_util.tree_leaves(b)):
        np.testing.assert_array_equal(la, lb)
    assert torch.from_numpy(jax.tree_util.tree_leaves(a)[0]).dtype == \
        torch.float32
