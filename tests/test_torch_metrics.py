"""The port's metric stack (numpy) against the reference's on seeded lists.
The reference is called through its numpy route, which is the one ported."""
import numpy as np
import pytest

from mm_distillnet_tpu.utils import metrics as jm
from mm_distillnet_tpu.utils import native as jax_native
from mm_distillnet_torch.utils import metrics as tm


@pytest.fixture(autouse=True)
def _numpy_route(monkeypatch):
    monkeypatch.setattr(jax_native, 'available', lambda: False)


def _lists(seed, images=6, size=128):
    """Per-image ragged predictions [x1,y1,x2,y2,score,label] (sorted by
    score, some near a target, some not) and targets [x1,y1,x2,y2,label];
    one image without predictions and one without targets."""
    rng = np.random.default_rng(seed)
    preds, targets = [], []
    for i in range(images):
        nt = 0 if i == 1 else int(rng.integers(1, 5))
        t = []
        for _ in range(nt):
            x1, y1 = rng.integers(0, size - 40, 2)
            w, h = rng.integers(8, 40, 2)
            t.append([float(x1), float(y1), float(x1 + w), float(y1 + h),
                      float(rng.integers(0, 2))])
        p = []
        if i != 2:
            for row in t:
                if rng.random() < 0.8:
                    jitter = rng.integers(-4, 5, 4)
                    p.append([row[0] + jitter[0], row[1] + jitter[1],
                              row[2] + jitter[2], row[3] + jitter[3],
                              float(rng.uniform(0.3, 1.0)), row[4]])
            for _ in range(int(rng.integers(0, 3))):
                x1, y1 = rng.integers(0, size - 30, 2)
                p.append([float(x1), float(y1), float(x1 + 20),
                          float(y1 + 25), float(rng.uniform(0.3, 1.0)),
                          float(rng.integers(0, 3))])
        p.sort(key=lambda r: -r[4])
        preds.append(p)
        targets.append(t)
    return preds, targets


def test_bbox_iou_plus1_equals_reference():
    rng = np.random.default_rng(0)
    boxes = rng.uniform(0, 100, (20, 4))
    boxes[:, 2:] += boxes[:, :2]
    np.testing.assert_array_equal(tm.bbox_iou_plus1(boxes[0], boxes),
                                  jm.bbox_iou_plus1(boxes[0], boxes))


@pytest.mark.parametrize('seed', [0, 1, 2])
@pytest.mark.parametrize('iou', [0.5, 0.75])
def test_get_batch_statistics_equals_reference(seed, iou):
    preds, targets = _lists(seed)
    got = tm.get_batch_statistics(preds, targets, iou)
    want = jm.get_batch_statistics(preds, targets, iou)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    assert sum(g[0].sum() for g in got) > 0


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_ap_per_class_and_compute_ap_equal_reference(seed):
    preds, targets = _lists(seed, images=10)
    stats = tm.get_batch_statistics(preds, targets, 0.5)
    tps, scores, labels = [np.concatenate(x, 0) for x in zip(*stats)]
    target_cls = np.asarray([r[4] for t in targets for r in t])
    got = tm.ap_per_class(tps, scores, labels, target_cls)
    want = jm.ap_per_class(tps, scores, labels, target_cls)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert got[2].size and 0 < got[2].max() <= 1
    rec = np.linspace(0.1, 0.9, 7)
    prec = np.asarray([1.0, 0.9, 0.95, 0.7, 0.75, 0.6, 0.5])
    assert tm.compute_ap(rec, prec) == jm.compute_ap(rec, prec)


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_central_distances_equal_reference(seed):
    preds, targets = _lists(seed)
    got = tm.get_batch_central_distances(preds, targets, 128, 128)
    want = jm.get_batch_central_distances(preds, targets, 128, 128)
    assert got == want and len(got[0]) == 5   # one image has no target


def test_list_conversions_equal_reference():
    rng = np.random.default_rng(4)
    boxes = rng.uniform(0, 100, (2, 5, 4)).astype(np.float32)
    scores = rng.uniform(0, 1, (2, 5)).astype(np.float32)
    classes = rng.integers(0, 3, (2, 5)).astype(np.int32)
    valid = rng.random((2, 5)) < 0.6
    assert tm.detections_to_lists(boxes, scores, classes, valid) == \
        jm.detections_to_lists(boxes, scores, classes, valid)
    labels = np.concatenate([boxes, np.where(valid, 1.0, -1.0)[..., None]
                             .astype(np.float32)], axis=-1)
    got = tm.labels_to_lists(labels)
    assert got == jm.labels_to_lists(labels)
    assert [len(g) for g in got] == valid.sum(axis=1).tolist()
