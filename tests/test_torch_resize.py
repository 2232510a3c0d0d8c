"""The port's bicubic resize and compact-audio stretch against the
reference's, and serving with an 80-row compact-audio batch."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm_distillnet_tpu.models.efficientdet import EfficientDet as JaxDet
from mm_distillnet_tpu.ops import resize as jax_resize
from mm_distillnet_tpu.serving import make_serving_fn as jax_serving_fn
from mm_distillnet_torch.convert.weights import state_dict_from_flax
from mm_distillnet_torch.models.efficientdet import EfficientDet
from mm_distillnet_torch.ops import resize
from mm_distillnet_torch.serving import make_serving_fn

from .test_torch_helpers import filled_variables, nhwc_input, to_jax

SIZE = 128


@pytest.mark.parametrize('out_size,in_size', [(768, 80), (128, 80),
                                              (80, 128), (64, 64), (7, 3)])
def test_resize_matrix_equals_reference(out_size, in_size):
    got = resize.resize_matrix(out_size, in_size)
    want = jax_resize.resize_matrix(out_size, in_size)
    assert got.dtype == np.float32 and got.shape == (out_size, in_size)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-6)


def test_mel_bins_constant():
    assert resize.MEL_BINS == jax_resize.MEL_BINS == 80


@pytest.mark.parametrize('shape,out_h', [((2, 80, 32, 8), 128),
                                         ((80, 16, 8), 768),
                                         ((1, 128, 16, 8), 128)],
                         ids=['batch', 'single_768', 'noop'])
def test_stretch_mel_axis_matches_reference(shape, out_h):
    """fp32 products of the same matrix: rtol 1e-5 covers the summation
    order of two matmul libraries over 80 terms."""
    x = nhwc_input(3, shape)
    got = resize.stretch_mel_axis(torch.from_numpy(x), out_h)
    want = np.asarray(jax_resize.stretch_mel_axis(jnp.asarray(x), out_h))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_stretch_keeps_the_input_dtype():
    x = torch.from_numpy(nhwc_input(4, (1, 80, 8, 8))).to(torch.bfloat16)
    got = resize.stretch_mel_axis(x, 128)
    assert got.dtype == torch.bfloat16 and got.shape == (1, 128, 8, 8)


def test_resize_bicubic_matches_reference():
    x = nhwc_input(5, (2, 20, 24, 3))
    got = resize.resize_bicubic(torch.from_numpy(x), 48, 40)
    want = np.asarray(jax_resize.resize_bicubic(jnp.asarray(x), 48, 40))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('height', [64, 81, 256])
def test_malformed_height_raises(height):
    x = torch.zeros((1, height, SIZE, 8))
    with pytest.raises(ValueError, match='neither image_size'):
        resize.maybe_stretch_mel_axis(x, SIZE)
    with pytest.raises(ValueError):
        jax_resize.maybe_stretch_mel_axis(jnp.zeros((1, height, SIZE, 8)),
                                          SIZE)


def test_maybe_stretch_passes_full_size_through():
    x = torch.zeros((1, SIZE, SIZE, 8))
    assert resize.maybe_stretch_mel_axis(x, SIZE) is x
    y = resize.maybe_stretch_mel_axis(torch.zeros((1, 80, SIZE, 8)), SIZE)
    assert y.shape == (1, SIZE, SIZE, 8)


def test_serving_with_compact_audio_matches_reference():
    """An 80-row batch through both serving functions on shared fp32
    weights: same valid rows and classes, boxes and scores as close as the
    full-size serving test asks."""
    kw = dict(num_candidates=64, max_detections=16)
    model = JaxDet(num_classes=20, compound_coef=-1, dtype=jnp.float32)
    v = filled_variables(model, 1, nhwc_input(0, (2, SIZE, SIZE, 8)))
    x = nhwc_input(9, (2, 80, SIZE, 8))
    want = jax_serving_fn(model, to_jax(v), SIZE, **kw)(jnp.asarray(x))
    port = make_serving_fn(EfficientDet(20, -1, 8), state_dict_from_flax(v),
                           SIZE, plan_spec='flax:0-99', dtype=torch.float32,
                           device='cpu', **kw)
    got = port(x)
    assert got.valid.any(), 'the comparison needs valid detections'
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.classes.numpy(),
                                  np.asarray(want.classes))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match='neither image_size'):
        port(np.zeros((1, 64, SIZE, 8), np.float32))
