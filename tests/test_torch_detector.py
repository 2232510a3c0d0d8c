"""The port's EfficientDet against the reference: the test-tiny forward on
carried weights, the full-width D2 parameter structure, and the weight
round trip through the reference converter."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm_distillnet_tpu.convert.torch_weights import convert_state_dict
from mm_distillnet_tpu.models.efficientdet import EfficientDet as JaxDet
from mm_distillnet_torch.convert.weights import (flatten_variables,
                                                 state_dict_from_flax,
                                                 torch_key_for)
from mm_distillnet_torch.models.efficientdet import EfficientDet

from .test_torch_helpers import corr, filled_variables, nhwc_input, to_jax

SIZE = 128
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope='module')
def tiny():
    model = JaxDet(num_classes=20, compound_coef=-1, dtype=jnp.float32)
    x = nhwc_input(0, (2, SIZE, SIZE, 8))
    v = filled_variables(model, 1, x)
    want = model.apply(to_jax(v), jnp.asarray(x), train=False)
    port = EfficientDet(20, -1, 8).eval()
    port.load_state_dict(state_dict_from_flax(v), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    return v, want, got, port


@pytest.mark.parametrize('field', ['classification', 'regression', 'logits',
                                   'align_features'])
def test_tiny_forward_matches_flax(tiny, field):
    _, want, got, _ = tiny
    np.testing.assert_allclose(getattr(got, field).numpy(),
                               np.asarray(getattr(want, field)), **TOL)


@pytest.mark.parametrize('level', range(5))
def test_tiny_features_match_flax(tiny, level):
    _, want, got, _ = tiny
    assert len(got.features) == len(want.features) == 5
    np.testing.assert_allclose(got.features[level].numpy(),
                               np.asarray(want.features[level]), **TOL)


def test_bf16_scores_are_a_bf16_sigmoid_as_in_flax(tiny):
    """In bf16 both packages take the class sigmoid in bf16: the scores lie
    on the bf16 grid and are the bf16 sigmoid of the logits (XLA's bf16
    sigmoid rounds differently from torch's, by at most one ulp)."""
    v = tiny[0]
    x = nhwc_input(0, (2, SIZE, SIZE, 8))
    want = JaxDet(num_classes=20, compound_coef=-1,
                  dtype=jnp.bfloat16).apply(to_jax(v), jnp.asarray(x),
                                            train=False)
    port = EfficientDet(20, -1, 8)
    port.load_state_dict(state_dict_from_flax(v), strict=True)
    port = port.to(torch.bfloat16).eval()
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    for scores, logits, ulps in ((np.asarray(want.classification),
                                  np.asarray(want.logits), 1),
                                 (got.classification.numpy(),
                                  got.logits.numpy(), 0)):
        assert scores.dtype == np.float32
        on_grid = torch.from_numpy(scores.copy()).to(torch.bfloat16).float()
        np.testing.assert_array_equal(scores, on_grid.numpy())
        bf16_sigmoid = torch.sigmoid(
            torch.from_numpy(logits.copy()).to(torch.bfloat16)).float()
        np.testing.assert_allclose(scores, bf16_sigmoid.numpy(), rtol=0,
                                   atol=ulps * 2.0 ** -8)
    assert corr(got.classification.numpy(), want.classification) > 0.99


def test_state_dict_round_trips_through_reference_converter(tiny):
    v, _, _, port = tiny
    filled, report = convert_state_dict(port.state_dict(), to_jax(v))
    assert report['missing'] == [] and report['unused'] == []
    for coll in ('params', 'batch_stats'):
        want = dict(flatten_variables(v[coll]))
        got = dict(flatten_variables(filled[coll]))
        assert want.keys() == got.keys()
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]), want[k])


def test_d2_structure_matches_reference_one_to_one():
    """jax.eval_shape of the D2 student's init (8 channels; no compute)
    mapped through the port's key rule equals the port D2 state_dict."""
    model = JaxDet(num_classes=20, compound_coef=2)
    shapes = jax.eval_shape(functools.partial(model.init),
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, 256, 256, 8), jnp.float32))
    mapped = {}
    for coll in ('params', 'batch_stats'):
        for path, leaf in flatten_variables(shapes[coll]):
            shape = tuple(leaf.shape)
            if len(shape) == 4:  # HWIO -> OIHW
                shape = (shape[3], shape[2], shape[0], shape[1])
            mapped[torch_key_for(path, coll)] = shape
    port = {k: tuple(t.shape)
            for k, t in EfficientDet(20, 2, 8).state_dict().items()
            if not k.endswith('num_batches_tracked')}
    assert len(mapped) == len(port)
    assert mapped == port
    assert 'backbone_net.model._blocks.3._expand_conv.conv.weight' in port
    assert 'bifpn.0.conv6_up.depthwise_conv.conv.weight' in port
    assert 'regressor.conv_list.0.pointwise_conv.conv.bias' in port
    assert 'classifier.bn_list.2.1.running_var' in port
    assert sum(1 for k in port if k.endswith('._depthwise_conv.conv.weight')
               and k.startswith('backbone_net')) == 23


def test_key_rule_exemplars():
    assert torch_key_for(('bifpn', 'cell_0', 'p5_to_p6', 'conv', 'kernel'),
                         'params') == 'bifpn.0.p5_to_p6.0.conv.weight'
    assert torch_key_for(('bifpn', 'cell_0', 'p5_to_p6', 'bn', 'mean'),
                         'batch_stats') == 'bifpn.0.p5_to_p6.1.running_mean'
    assert torch_key_for(('bifpn', 'cell_1', 'p6_w1'),
                         'params') == 'bifpn.1.p6_w1'
    assert torch_key_for(('classifier', 'tower', 'header_pointwise', 'bias'),
                         'params') == 'classifier.header.pointwise_conv.conv.bias'
