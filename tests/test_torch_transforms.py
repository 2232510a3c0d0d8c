"""The port's host transforms (mm_distillnet_torch/data/transforms.py) and
image operations (data/imgproc.py) against the JAX transforms and cv2 on
the same arrays.

Tolerances: integer work is bit-equal (normalize_minmax, BGR<->RGB, the
JET table, flips, label scaling). Float work agrees within 1e-5 of the
array's range (REL): cv2 runs INTER_LINEAR and INTER_CUBIC through its IPP
HAL, whose float32 operation order is not public, and the port's bicubic
is a float32 matrix product; measured about 1.5e-7 of the range. uint8
INTER_LINEAR is within 1 LSB of cv2. The random transforms draw from the
RandomState they are given: seeded alike, they take the JAX transforms'
draws from the global legacy stream.
"""
import cv2
import jax.numpy as jnp  # noqa: F401  (JAX on the CPU, as conftest sets)
import numpy as np
import pytest

from mm_distillnet_tpu.data import transforms as jax_tf
from mm_distillnet_torch.data import imgproc, transforms

from .test_torch_helpers import one_torch_thread  # noqa: F401

REL = 1e-5
DB_ATOL = 1e-3   # tests/test_torch_audio.py: the log-mel frontend


def assert_close(got, want, rel=REL):
    assert got.shape == want.shape and got.dtype == want.dtype
    span = float(np.ptp(want)) or 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * span)


def frame(shape, seed, dtype=np.float32, hi=1.0):
    rng = np.random.default_rng(seed)
    return (rng.random(shape) * hi).astype(dtype)


@pytest.mark.parametrize('size,out', [((108, 152), (768, 545)),
                                      ((1080, 1520), (768, 545)),
                                      ((37, 53), (64, 45)),
                                      ((64, 96), (200, 300)),
                                      ((130, 70), (35, 130))])
@pytest.mark.parametrize('channels', [0, 1, 3, 8])
def test_resize_linear_float_matches_cv2(size, out, channels):
    shape = size + ((channels,) if channels else ())
    img = frame(shape, channels, hi=255.0)
    want = cv2.resize(img, out, interpolation=cv2.INTER_LINEAR)
    assert_close(imgproc.resize_linear(img, *out), want)


@pytest.mark.parametrize('size,out', [((512, 640), (768, 545)),
                                      ((37, 53), (64, 45)),
                                      ((64, 96), (31, 20)),
                                      ((130, 70), (140, 260))])
def test_resize_linear_uint8_within_one_lsb(size, out):
    img = frame(size + (3,), 1, np.uint8, 256)
    want = cv2.resize(img, out).astype(np.int32)
    got = imgproc.resize_linear(img, *out)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.abs(got.astype(np.int32) - want).max() <= 1


@pytest.mark.parametrize('dtype,lo,hi', [(np.uint16, 21800, 25001),
                                         (np.uint16, 0, 65536),
                                         (np.uint8, 0, 256),
                                         (np.uint8, 30, 41)])
@pytest.mark.parametrize('shape', [(5, 7), (32, 48), (1080, 1520)])
def test_normalize_minmax_is_bit_equal_to_cv2(dtype, lo, hi, shape):
    img = np.random.default_rng(hi).integers(lo, hi, shape).astype(dtype)
    want = cv2.normalize(img, np.zeros(img.shape), 0, 255, cv2.NORM_MINMAX)
    got = imgproc.normalize_minmax(img, 0, 255)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    flat = np.full(shape, lo, dtype)       # max == min: scale 0
    np.testing.assert_array_equal(
        imgproc.normalize_minmax(flat, 0, 255),
        cv2.normalize(flat, np.zeros(shape), 0, 255, cv2.NORM_MINMAX))


def test_colour_swaps_hsv_and_jet_match_cv2():
    img = frame((33, 47, 3), 2, np.uint8, 256)
    np.testing.assert_array_equal(imgproc.bgr_to_rgb(img),
                                  cv2.cvtColor(img, cv2.COLOR_BGR2RGB))
    grey = np.arange(256, dtype=np.uint8).reshape(16, 16)
    np.testing.assert_array_equal(imgproc.apply_colormap_jet(grey),
                                  cv2.applyColorMap(grey, cv2.COLORMAP_JET))
    rgb = frame((33, 47, 3), 3)
    rgb[0, :3] = [0.5, 0.5, 0.5]                  # grey pixels: s = 0
    hsv = cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV)
    assert_close(imgproc.rgb_to_hsv(rgb), hsv)
    hsv[..., 0] = (hsv[..., 0] + 217.0) % 360
    hsv[..., 1] *= 0.7
    assert_close(imgproc.hsv_to_rgb(hsv),
                 cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))


def _sample(h, w, seed, audio_t=173, label=True):
    rng = np.random.default_rng(seed)
    return {'rgb': rng.random((h, w, 3)).astype(np.float32),
            'thermal': (rng.random((h, w)) * 255).astype(np.float32),
            'depth': rng.integers(0, 256, (h, w, 3)).astype(np.uint8),
            'audio': rng.normal(-40, 20, (80, audio_t, 8)).astype(np.float32),
            'label': (np.array([[10, 20, 50, 60, 6], [0, 1, 5, 7, 6]],
                               np.float32) if label else None),
            'id': 'drive/1_000000001_a'}


def _assert_samples_close(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if v is None or k == 'id':
            assert got[k] == v
        elif k == 'label':
            np.testing.assert_array_equal(got[k], v)
        else:
            assert_close(got[k], v)


@pytest.mark.parametrize('audio_time_only', [False, True])
@pytest.mark.parametrize('hw', [(108, 152), (152, 108), (64, 64), (45, 30)])
def test_resizer_matches_the_jax_resizer(hw, audio_time_only):
    sample = _sample(*hw, seed=hw[0], label=hw[0] != 64)
    want = jax_tf.Resizer(64, audio_time_only)(sample)
    got = transforms.Resizer(64, audio_time_only)(sample)
    _assert_samples_close(got, want)


def test_normalizer_and_pipeline_match_the_jax_ones():
    sample = _sample(108, 152, 7)
    np.testing.assert_array_equal(transforms.Normalizer()(sample)['rgb'],
                                  jax_tf.Normalizer()(sample)['rgb'])
    names = 'Normalizer,Resizer,AudioAugmenter,None'
    got = transforms.build_transformations(names, 64, True)(sample)
    want = jax_tf.build_transformations(names, 64, True)(sample)
    _assert_samples_close(got, want)
    assert [type(t).__name__ for t in transforms.build_transformations(
        'Normalizer,HSVAdjust,HorizontalFlip,Audio2Spectogram', 32
    ).transforms] == ['Normalizer', 'HSVAdjust', 'HorizontalFlip',
                      'Audio2Spectogram']


@pytest.mark.parametrize('seed', range(6))
def test_random_transforms_match_the_jax_draws(seed):
    """HSVAdjust then HorizontalFlip, one RandomState shared as the JAX
    transforms share the global stream: the same flips and jitters."""
    sample = _sample(40, 56, seed)
    np.random.seed(seed)
    want = jax_tf.HorizontalFlip()(jax_tf.HSVAdjust()(sample))
    rng = np.random.RandomState(seed)
    got = transforms.HorizontalFlip(rng=rng)(
        transforms.HSVAdjust(rng=rng)(sample))
    _assert_samples_close(got, want)
    pipeline = transforms.build_transformations(
        'HSVAdjust,HorizontalFlip', 64, rng=np.random.RandomState(seed))
    np.random.seed(seed)
    _assert_samples_close(pipeline(sample), jax_tf.build_transformations(
        'HSVAdjust,HorizontalFlip', 64)(sample))


def test_audio2spectogram_matches_the_jax_one(one_torch_thread):  # noqa: F811
    pcm = np.random.default_rng(0).normal(0, 0.2, (8, 5000)).astype(
        np.float32)
    sample = {'audio': pcm, 'rgb': None}
    got = transforms.Audio2Spectogram()(sample)['audio']
    want = jax_tf.Audio2Spectogram()(sample)['audio']
    assert got.shape == want.shape == (80, 1 + 5000 // 256, 8)
    np.testing.assert_allclose(got, want, rtol=0, atol=DB_ATOL)
    stack = {'audio': want}
    assert transforms.Audio2Spectogram()(stack) is stack
    assert transforms.AudioAugmenter()(stack) is stack


def test_stretch_bicubic_matches_cv2_cubic():
    spec = np.random.default_rng(1).normal(0, 1e3, (80, 173, 8)).astype(
        np.float32)
    for out in ((64, 64), (80, 768), (768, 768)):
        want = cv2.resize(spec, (out[1], out[0]),
                          interpolation=cv2.INTER_CUBIC)
        assert_close(imgproc.stretch_bicubic(spec, *out), want)
    assert imgproc.stretch_bicubic(spec, 80, 173).dtype == np.float32
