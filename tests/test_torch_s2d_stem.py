"""The port's space-to-depth stem (models/efficientnet.py SpaceToDepthStem)
against the standard stem and against the JAX package's s2d module
(tests/test_s2d_stem.py): the same parameters and state_dict keys."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm_distillnet_tpu.models.efficientdet import EfficientDet as JaxDet
from mm_distillnet_tpu.models.efficientnet import \
    EfficientNetFeatures as JaxFeatures
from mm_distillnet_torch.convert.weights import state_dict_from_flax
from mm_distillnet_torch.models.efficientdet import EfficientDet
from mm_distillnet_torch.models.efficientnet import (EfficientNetFeatures,
                                                     SpaceToDepthStem)
from mm_distillnet_torch.models.layers import Conv2dSame

from .test_torch_helpers import filled_variables, nhwc_input, to_jax
from .test_torch_helpers import one_torch_thread  # noqa: F401

# torch on one thread: the suite runs several workers on a few cores
pytestmark = pytest.mark.usefixtures('one_torch_thread')


@pytest.mark.parametrize('cin,size', [(8, 64), (3, 32), (1, 18)])
def test_s2d_stem_equals_the_standard_stem(cin, size):
    torch.manual_seed(cin)
    std = Conv2dSame(cin, 16, 3, 2, bias=False)
    s2d = SpaceToDepthStem(cin, 16)
    s2d.load_state_dict(std.state_dict())
    x = torch.from_numpy(nhwc_input(size, (2, size, size, cin))
                         ).permute(0, 3, 1, 2)
    with torch.no_grad():
        torch.testing.assert_close(s2d(x), std(x), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match='even'):
        s2d(x[..., :-1])


def test_s2d_backbone_matches_jax_and_keeps_the_keys():
    """The test-tiny backbone with the s2d stem against the JAX one with
    its s2d stem, from the same variables; the port's state_dict keys and
    shapes are those of the standard stem."""
    x = nhwc_input(0, (2, 64, 64, 8))
    jmod = JaxFeatures(compound_coef=-1, dtype=jnp.float32, s2d_stem=True)
    v = filled_variables(jmod, 1, x, train=False)
    want = jmod.apply(to_jax(v), jnp.asarray(x), train=False)
    port = EfficientNetFeatures(-1, 8, s2d_stem=True).eval()
    std = EfficientNetFeatures(-1, 8).eval()
    sd = {'model.' + k: t for k, t in state_dict_from_flax(v).items()}
    assert {k: t.shape for k, t in port.state_dict().items()} == \
        {k: t.shape for k, t in std.state_dict().items()}
    port.load_state_dict(sd)
    std.load_state_dict(sd)
    assert tuple(port.state_dict()['model._conv_stem.conv.weight'].shape) \
        == (8, 8, 3, 3)
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
        plain = std(torch.from_numpy(x).permute(0, 3, 1, 2))
    for g, p, w in zip(got, plain, want):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(w), rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(g, p, rtol=1e-4, atol=1e-5)


def test_s2d_detector_matches_jax():
    x = nhwc_input(3, (1, 128, 128, 8))
    jmod = JaxDet(num_classes=4, compound_coef=-1, dtype=jnp.float32,
                  s2d_stem=True)
    v = filled_variables(jmod, 4, x)
    want = jmod.apply(to_jax(v), jnp.asarray(x), train=False)
    port = EfficientDet(4, -1, 8, s2d_stem=True).eval()
    port.load_state_dict(state_dict_from_flax(v))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    for f in ('classification', 'regression'):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   rtol=1e-4, atol=1e-5)
