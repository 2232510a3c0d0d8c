"""The port's fused predictor: plan parsing, the all-kernel default plan,
and parity with the reference's fused predictor (Pallas in interpret mode)
on the test-tiny model, with the plain versions standing in for the CUDA
kernels on the CPU."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm_distillnet_tpu.models.efficientdet import EfficientDet as JaxDet
from mm_distillnet_tpu.models.fused_forward import \
    make_fused_predictor as jax_fused_predictor
from mm_distillnet_tpu.ops import pallas_mbconv
from mm_distillnet_torch.convert.weights import state_dict_from_flax
from mm_distillnet_torch.models.efficientdet import EfficientDet
from mm_distillnet_torch.models.fused_forward import (FusedBackbone,
                                                      _parse_plan,
                                                      make_fused_predictor)
from mm_distillnet_torch.ops import fused_mbconv

from .test_torch_helpers import corr, filled_variables, nhwc_input, to_jax

SIZE = 128


def test_parse_plan():
    assert _parse_plan('', 23) == {}
    assert _parse_plan('pallas:5,flax:6-7', 23) == {5: 'pallas', 6: 'flax',
                                                    7: 'flax'}
    assert _parse_plan('pallas:20-40', 23) == {i: 'pallas'
                                               for i in (20, 21, 22)}
    with pytest.raises(ValueError):
        _parse_plan('mystery:0-1', 23)
    with pytest.raises(ValueError):
        _parse_plan('tiled:0-1', 23)


@pytest.fixture(scope='module')
def tiny():
    model = JaxDet(num_classes=20, compound_coef=-1, dtype=jnp.float32)
    x = nhwc_input(0, (2, SIZE, SIZE, 8))
    v = filled_variables(model, 1, x)
    return model, v, x, state_dict_from_flax(v)


def test_default_plan_is_all_kernel(tiny):
    _, _, _, sd = tiny
    bb = FusedBackbone(sd, -1, SIZE, dtype=torch.float32, device='cpu')
    assert [k for k, _, _ in bb.plan] == ['pallas'] * len(bb.blocks)
    assert all(isinstance(p, fused_mbconv.FoldedMBConv)
               for _, _, p in bb.plan)


def test_plan_spec_overrides_blocks(tiny):
    _, _, _, sd = tiny
    bb = FusedBackbone(sd, -1, SIZE, dtype=torch.float32,
                       plan_spec='flax:1-2', device='cpu')
    kinds = [k for k, _, _ in bb.plan]
    assert kinds[1:3] == ['flax', 'flax']
    assert kinds[0] == 'pallas' and kinds[3:] == ['pallas'] * (len(kinds) - 3)


def test_kernel_plan_on_odd_stride2_size_raises(tiny):
    """At 36 px the third stride-2 block meets a 9x9 map: no kernel takes
    it (the reference kernel and flax disagree there), so the plan raises;
    the unfused block takes it."""
    _, _, _, sd = tiny
    with pytest.raises(ValueError, match='odd'):
        FusedBackbone(sd, -1, 36, dtype=torch.float32, device='cpu')
    FusedBackbone(sd, -1, 36, dtype=torch.float32, plan_spec='flax:0-99',
                  device='cpu')


def test_fused_predictor_matches_reference_fused_predictor(tiny,
                                                           monkeypatch):
    import jax.experimental.pallas as pl
    monkeypatch.setattr(pallas_mbconv.pl, 'pallas_call',
                        functools.partial(pl.pallas_call, interpret=True))
    model, v, x, sd = tiny
    want = jax_fused_predictor(model, to_jax(v), SIZE,
                               plan_spec='pallas:0-99')(jnp.asarray(x))
    port = make_fused_predictor(EfficientDet(20, -1, 8), sd, SIZE,
                                dtype=torch.float32, device='cpu')
    got = port(torch.from_numpy(x))
    for field in ('classification', 'regression', 'logits'):
        assert corr(getattr(got, field), getattr(want, field)) > 0.999
    for g, w in zip(got.features, want.features):
        assert g.shape == w.shape
        assert corr(g, w) > 0.999


def test_fused_predictor_flax_plan_matches_module_forward(tiny):
    _, _, x, sd = tiny
    model = EfficientDet(20, -1, 8).eval()
    model.load_state_dict(sd)
    with torch.no_grad():
        want = model(torch.from_numpy(x))
    got = make_fused_predictor(model, sd, SIZE, plan_spec='flax:0-99',
                               dtype=torch.float32, device='cpu')(
                                   torch.from_numpy(x))
    for field in ('classification', 'regression', 'logits'):
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   getattr(want, field).numpy(),
                                   rtol=1e-5, atol=1e-5)
