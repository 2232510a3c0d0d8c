"""The port's --just_plot drawing (utils/plotting.py, no cv2) against the
JAX package's plot_audio_predictions (tests/test_plotting.py): the same
files for the same frame and weights, the colour-mapped images equal
within 1 LSB; the text glyphs are a table of OpenCV's and not held pixel
for pixel."""
import os

import cv2
import jax.numpy as jnp
import numpy as np
import pytest

from mm_distillnet_tpu.config import default_config as jax_default_config
from mm_distillnet_tpu.data.synthetic import \
    SyntheticMultimodal as JaxSynthetic
from mm_distillnet_tpu.models.efficientdet import EfficientDet as JaxDet
from mm_distillnet_tpu.utils.plotting import \
    plot_audio_predictions as jax_plot
from mm_distillnet_torch.config import default_config
from mm_distillnet_torch.convert.weights import state_dict_from_flax
from mm_distillnet_torch.data.synthetic import SyntheticMultimodal
from mm_distillnet_torch.models.efficientdet import EfficientDet
from mm_distillnet_torch.utils import plotting

from .test_torch_helpers import filled_variables, nhwc_input, to_jax
from .test_torch_helpers import one_torch_thread  # noqa: F401

# torch on one thread: the suite runs several workers on a few cores
pytestmark = pytest.mark.usefixtures('one_torch_thread')

SIZE = 128
SETTINGS = dict(image_size=SIZE, synthetic_size=2, max_detections=16,
                nms_candidates=64, compute_dtype='float32')


def _net(seed, ch):
    jmod = JaxDet(num_classes=20, compound_coef=-1, dtype=jnp.float32)
    v = filled_variables(jmod, seed, nhwc_input(0, (1, SIZE, SIZE, ch)))
    return (jmod, to_jax(v)), (EfficientDet(20, -1, ch),
                               state_dict_from_flax(v))


@pytest.fixture(scope='module')
def plots(tmp_path_factory, one_torch_thread):  # noqa: F811
    root = tmp_path_factory.mktemp('plots')
    (jt, pt), (js, ps) = _net(1, 3), _net(9, 8)
    jcfg = jax_default_config(exp_name=str(root / 'jax'), **SETTINGS)
    tcfg = default_config(exp_name=str(root / 'port'), **SETTINGS)
    jset, tset = JaxSynthetic(jcfg, 'val'), SyntheticMultimodal(tcfg, 'val')
    frame = tset.ids[0]
    assert frame == jset.ids[0]
    want = jax_plot({'rgb': jt}, js, jset, jcfg, frame)
    got = plotting.plot_audio_predictions({'rgb': pt}, ps, tset, tcfg, frame,
                                          device='cpu')
    return root, frame.replace('/', '_'), got, want


def _read(path):
    return cv2.imread(str(path), cv2.IMREAD_UNCHANGED).astype(np.int16)


def test_same_files_and_rows(plots):
    root, safe_id, got, want = plots
    names = sorted(os.listdir(root / 'jax'))
    assert sorted(os.listdir(root / 'port')) == names
    assert len([n for n in names if '.activation_' in n]) == 5
    assert len([n for n in names if '.specshow_' in n]) == 8
    for n in ('student', 'rgb', 'thermal', 'depth'):
        assert f'{safe_id}.{n}.png' in names
    assert len(got) == len(want)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-4)


def test_colour_mapped_images_match(plots):
    """Attention maps (JET) and spectrograms (VIRIDIS): within 1 LSB on at
    least 99.9% of pixels (measured: all equal)."""
    root, safe_id, _, _ = plots
    for name in sorted(os.listdir(root / 'jax')):
        if '.activation_' not in name and '.specshow_' not in name:
            continue
        a, b = _read(root / 'port' / name), _read(root / 'jax' / name)
        assert a.shape == b.shape, name
        close = (np.abs(a - b) <= 1).all(-1).mean()
        assert close >= 0.999, (name, close)


def _text_mask(shape, rows):
    """The pixels where a label of `rows` may be drawn: from 14 rows above
    its baseline to 6 below, 9 pixels a character."""
    mask = np.zeros(shape[:2], bool)
    for r in rows:
        x1, y1 = int(r[0]), int(r[1])
        yt = max(y1 - 4, 10)
        chars = 4 + len('car') + 5
        mask[max(yt - 14, 0):yt + 6, max(x1 - 2, 0):x1 + 9 * chars] = True
    return mask


def test_overlays_match_outside_the_text(plots):
    """The student, rgb, thermal (HOT) and depth overlays: the renders and
    the boxes as OpenCV draws them, within 1 LSB on at least 99.9% of the
    pixels outside the labels' text (measured: all)."""
    root, safe_id, got, _ = plots
    for n in ('student', 'rgb', 'thermal', 'depth'):
        a = _read(root / 'port' / f'{safe_id}.{n}.png')
        b = _read(root / 'jax' / f'{safe_id}.{n}.png')
        assert a.shape == b.shape and a.shape[-1] == 3, n
        keep = ~_text_mask(a.shape, got)
        assert keep.mean() > 0.3, n
        close = (np.abs(a - b) <= 1).all(-1)[keep].mean()
        assert close >= 0.999, (n, close)


def test_png_writer_and_colour_tables():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (7, 9, 3)).astype(np.uint8)
    grey = np.arange(256, dtype=np.uint8).reshape(16, 16)
    for cmap, table in ((cv2.COLORMAP_HOT, plotting.HOT_BGR),
                        (cv2.COLORMAP_VIRIDIS, plotting.VIRIDIS_BGR)):
        np.testing.assert_array_equal(plotting.apply_colormap(grey, table),
                                      cv2.applyColorMap(grey, cmap))


def test_png_round_trip(tmp_path):
    rng = np.random.default_rng(1)
    for shape in ((5, 11, 3), (6, 4)):
        img = rng.integers(0, 256, shape).astype(np.uint8)
        plotting.write_png(str(tmp_path / 'x.png'), img)
        np.testing.assert_array_equal(
            cv2.imread(str(tmp_path / 'x.png'), cv2.IMREAD_UNCHANGED), img)
    with pytest.raises(ValueError, match='uint8'):
        plotting.write_png(str(tmp_path / 'y.png'), img.astype(np.float32))
