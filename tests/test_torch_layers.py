"""Port layers (mm_distillnet_torch.models.layers) against the reference's
models/layers.py, fp32 on the CPU, rtol = atol = 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm_distillnet_tpu.models import layers as jl
from mm_distillnet_torch.convert.weights import state_dict_from_flax
from mm_distillnet_torch.models import layers as tl

from .test_torch_helpers import filled_variables, nhwc_input, to_jax

TOL = dict(rtol=1e-5, atol=1e-5)


def _nchw(a):
    return torch.from_numpy(a).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def test_same_pad_amounts_match():
    for size in range(1, 40):
        for stride in (1, 2):
            for k in (1, 2, 3, 5):
                assert tl.same_pad_amounts(size, stride, k) == \
                    jl.same_pad_amounts(size, stride, k)


def test_bn_constants_match():
    assert tl.BN_EPS == jl.BN_EPS
    assert tl.BN_MOMENTUM == pytest.approx(1.0 - jl.BN_MOMENTUM)
    bn = tl.batch_norm(4)
    assert bn.eps == jl.BN_EPS and bn.momentum == pytest.approx(0.01)


def test_swish_matches():
    x = nhwc_input(0, (2, 5, 5, 3)) * 4
    np.testing.assert_allclose(tl.swish(torch.from_numpy(x)).numpy(),
                               np.asarray(jl.swish(jnp.asarray(x))), **TOL)


@pytest.mark.parametrize('size', [(8, 8), (9, 7), (15, 16)])
def test_max_pool_same_matches(size):
    x = nhwc_input(1, (2, *size, 3))
    np.testing.assert_allclose(
        tl.max_pool_same(torch.from_numpy(x)).numpy(),
        np.asarray(jl.max_pool_same(jnp.asarray(x))), **TOL)


def test_max_pool_same_pads_with_zeros_on_negative_borders():
    """All inputs negative: border windows that reach the padding must
    return 0 (zero padding), not the largest negative input."""
    x = -np.abs(nhwc_input(2, (1, 7, 7, 2))) - 0.5
    got = tl.max_pool_same(torch.from_numpy(x)).numpy()
    want = np.asarray(jl.max_pool_same(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, **TOL)
    assert (got[:, -1] == 0).all() and (got < 0).any()


def test_upsample_nearest_2x_matches():
    x = nhwc_input(3, (2, 3, 5, 4))
    np.testing.assert_array_equal(
        tl.upsample_nearest_2x(torch.from_numpy(x)).numpy(),
        np.asarray(jl.upsample_nearest_2x(jnp.asarray(x))))
    np.testing.assert_array_equal(
        _nhwc(tl.upsample_nearest_2x_nchw(_nchw(x))),
        np.asarray(jl.upsample_nearest_2x(jnp.asarray(x))))


@pytest.mark.parametrize('size,stride,k', [
    (16, 1, 3), (15, 1, 5), (16, 2, 3), (15, 2, 3), (16, 2, 5), (13, 2, 5)])
def test_conv2d_same_matches_flax_same(size, stride, k):
    x = nhwc_input(4, (2, size, size + 1, 3))
    mod = jl.ConvSame(5, k, stride, dtype=jnp.float32)
    v = filled_variables(mod, 5, x)
    want = np.asarray(mod.apply(to_jax(v), jnp.asarray(x)))
    conv = tl.Conv2dSame(3, 5, k, stride)
    conv.load_state_dict(state_dict_from_flax(v))
    with torch.no_grad():
        got = _nhwc(conv(_nchw(x)))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize('norm,activation', [
    (True, False), (True, True), (False, False)])
def test_separable_conv_block_matches(norm, activation):
    x = nhwc_input(6, (2, 9, 10, 6))
    mod = jl.SeparableConvBlock(7, norm=norm, activation=activation,
                                dtype=jnp.float32)
    v = filled_variables(mod, 7, x)
    want = np.asarray(mod.apply(to_jax(v), jnp.asarray(x)))
    block = tl.SeparableConvBlock(6, 7, norm=norm,
                                  activation=activation).eval()
    block.load_state_dict(state_dict_from_flax(v), strict=True)
    with torch.no_grad():
        got = _nhwc(block(_nchw(x)))
    np.testing.assert_allclose(got, want, **TOL)


def test_separable_conv_block_has_bias_only_on_pointwise():
    block = tl.SeparableConvBlock(4, 8)
    assert block.depthwise_conv.conv.bias is None
    assert block.pointwise_conv.conv.bias is not None


def test_drop_connect_is_identity_in_eval_and_scales_in_train():
    x = torch.ones(64, 2, 2, 2)
    assert tl.drop_connect(x, 0.5, training=False) is x
    y = tl.drop_connect(x, 0.5, training=True,
                        generator=torch.Generator().manual_seed(0))
    per_sample = y[:, 0, 0, 0]
    assert set(per_sample.unique().tolist()) <= {0.0, 2.0}
    assert (y == per_sample[:, None, None, None]).all()


def test_drop_connect_draws_from_its_generator():
    x = torch.ones(64, 1, 1, 1)

    def draw(seed):
        return tl.drop_connect(x, 0.5, True,
                               torch.Generator().manual_seed(seed))
    assert torch.equal(draw(3), draw(3))
    assert not torch.equal(draw(3), draw(4))
    with pytest.raises(ValueError, match='generator'):
        tl.drop_connect(x, 0.5, training=True)


def test_batch_norm_train_update_keeps_the_biased_variance_as_flax():
    """flax's running variance takes the biased batch variance; torch's
    nn.BatchNorm2d the unbiased one, n/(n-1) larger (n = B*H*W = 8 here).
    The port's BatchNorm2d updates as flax does; it normalises alike."""
    import flax.linen as fnn
    x = nhwc_input(2, (2, 2, 2, 4)) * 3.0 + 1.0
    mod = fnn.BatchNorm(use_running_average=False, momentum=jl.BN_MOMENTUM,
                        epsilon=jl.BN_EPS)
    v = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want, upd = mod.apply(v, jnp.asarray(x), mutable=['batch_stats'])
    bn = tl.batch_norm(4).train()
    got = bn(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), **TOL)
    stats = upd['batch_stats']
    np.testing.assert_allclose(bn.running_mean.numpy(), stats['mean'], **TOL)
    np.testing.assert_allclose(bn.running_var.numpy(), stats['var'], **TOL)
    plain = torch.nn.BatchNorm2d(4, eps=tl.BN_EPS, momentum=tl.BN_MOMENTUM)
    plain(_nchw(x))
    assert not np.allclose(plain.running_var.numpy(), stats['var'], **TOL)
    # momentum None (a cumulative average) keeps the biased one too
    calib = tl.batch_norm(4).train()
    calib.momentum = None
    calib(_nchw(x))
    np.testing.assert_allclose(
        calib.running_var.numpy(),
        _nchw(x).var(dim=(0, 2, 3), unbiased=False).numpy(), **TOL)
