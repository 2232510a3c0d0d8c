"""The port's bindings to the native host kernels (utils/native.py, built
from native/mmdt_native.cpp into build/) against their numpy plain
versions and the JAX package's (tests/test_native.py)."""
import numpy as np
import pytest

from mm_distillnet_tpu.utils import metrics as jax_metrics
from mm_distillnet_tpu.utils import native as jax_native
from mm_distillnet_torch.ops import cuda_build
from mm_distillnet_torch.utils import metrics, native


def _random_preds_targets(rng, n_pred=20, n_t=5):
    ctr = rng.uniform(20, 100, (n_pred, 2))
    wh = rng.uniform(5, 40, (n_pred, 2))
    boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], 1)
    scores = rng.uniform(0, 1, (n_pred, 1))
    labels = rng.integers(0, 3, (n_pred, 1)).astype(float)
    preds = np.concatenate([boxes, scores, labels], 1).astype(np.float32)
    preds = preds[np.argsort(-preds[:, 4], kind='stable')]
    tctr = rng.uniform(20, 100, (n_t, 2))
    twh = rng.uniform(5, 40, (n_t, 2))
    tboxes = np.concatenate([tctr - twh / 2, tctr + twh / 2], 1)
    tlabels = rng.integers(0, 3, (n_t, 1)).astype(float)
    targets = np.concatenate([tboxes, tlabels], 1).astype(np.float32)
    return preds, targets


def test_the_library_is_built_from_the_repo_source():
    assert cuda_build.HOST_SOURCES['mmdt_native'].name == 'mmdt_native.cpp'
    assert 'mmdt_native' in cuda_build.sources()
    assert native._lib() is not None
    path = cuda_build._lib_path('mmdt_native')
    assert path.exists() and path.parent == cuda_build.BUILD_DIR


@pytest.mark.parametrize('seed', range(3))
def test_native_nms_matches_numpy_and_jax(seed):
    rng = np.random.default_rng(seed)
    preds, _ = _random_preds_targets(rng, 64, 1)
    boxes, scores = preds[:, :4], preds[:, 4]
    got = native.nms(boxes, scores, 0.5)
    assert list(got) == list(native.nms_reference(boxes, scores, 0.5))
    assert list(got) == list(jax_native._np_nms(boxes, scores, 0.5))
    assert len(native.nms(boxes[:0], scores[:0], 0.5)) == 0


@pytest.mark.parametrize('seed', range(5))
def test_native_batch_statistics_matches_numpy_and_jax(seed):
    rng = np.random.default_rng(seed)
    preds, targets = _random_preds_targets(rng)
    for thr in (0.3, 0.5, 0.75):
        got = metrics.get_batch_statistics([preds.tolist()],
                                           [targets.tolist()], thr)
        plain = metrics.get_batch_statistics_reference(
            [preds.tolist()], [targets.tolist()], thr)
        want = jax_metrics.get_batch_statistics([preds.tolist()],
                                                [targets.tolist()], thr)
        for g, p, w in zip(got[0], plain[0], want[0]):
            np.testing.assert_array_equal(g, p)
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize('seed', range(5))
def test_native_central_distances_matches_numpy(seed):
    rng = np.random.default_rng(seed + 10)
    preds, targets = _random_preds_targets(rng)
    got = native.central_distances(preds, targets)
    cdx, cdy = metrics.get_batch_central_distances(
        [preds.tolist()], [targets.tolist()], 1.0, 1.0)
    np.testing.assert_allclose(got[0], cdx[0], rtol=1e-5)
    np.testing.assert_allclose(got[1], cdy[0], rtol=1e-5)
