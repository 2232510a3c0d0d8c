"""The port's pseudo-label fusion against the reference's on seeded label
rows (ties, an image with no valid row, more kept boxes than max_gt) and
from shared fp32 detector outputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm_distillnet_tpu.distill import pseudo_labels as jax_pl
from mm_distillnet_tpu.ops.anchors import anchor_table as jax_anchor_table
from mm_distillnet_torch.distill import pseudo_labels as pl
from mm_distillnet_torch.ops.anchors import anchor_table

SIZE = 128


def _label_rows(rng, batch, rows, n_valid, size=SIZE, score_steps=None):
    """(batch, rows, 6) padded label rows as detections_to_labels makes
    them: integer coordinates, label -1 and zeros on padded rows. With
    score_steps the scores come from a few values only, so ties abound."""
    out = np.zeros((batch, rows, 6), np.float32)
    out[..., 5] = -1.0
    for b in range(batch):
        n = n_valid[b]
        x1 = rng.integers(0, size - 20, n)
        y1 = rng.integers(0, size - 20, n)
        w = rng.integers(4, 40, n)
        h = rng.integers(4, 40, n)
        scores = rng.uniform(0.3, 1.0, n)
        if score_steps:
            scores = 0.3 + np.floor(scores * score_steps) / score_steps * 0.7
        out[b, :n, 0] = x1
        out[b, :n, 1] = y1
        out[b, :n, 2] = np.minimum(x1 + w, size)
        out[b, :n, 3] = np.minimum(y1 + h, size)
        out[b, :n, 4] = -np.sort(-scores)
        out[b, :n, 5] = rng.integers(0, 3, n)
    return out


def _both(per_teacher, cfg_kwargs):
    want = np.asarray(jax_pl.fuse_teacher_labels(
        [jnp.asarray(t) for t in per_teacher],
        jax_pl.PseudoLabelConfig(**cfg_kwargs)))
    got = pl.fuse_teacher_labels([torch.from_numpy(t) for t in per_teacher],
                                 pl.PseudoLabelConfig(**cfg_kwargs))
    return got.numpy(), want


def test_config_defaults_match_reference():
    assert pl.PseudoLabelConfig(768)._asdict() == \
        jax_pl.PseudoLabelConfig(768)._asdict()


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_fuse_equals_reference_with_ties(seed):
    """Three teachers, scores from eight values: equal scores within and
    across teachers, so the stable sort decides, as jnp.argsort does."""
    rng = np.random.default_rng(seed)
    per_teacher = [_label_rows(rng, 3, 16, [9, 16, 4], score_steps=8)
                   for _ in range(3)]
    got, want = _both(per_teacher, dict(image_size=SIZE, max_gt=24))
    assert got.shape == want.shape == (3, 24, 5)
    assert (want[..., 4] != -1).any()
    np.testing.assert_array_equal(got, want)


def test_fuse_same_boxes_from_every_teacher():
    """Every teacher reports the same boxes with the same scores: one copy
    of each survives, the first teacher's."""
    rng = np.random.default_rng(7)
    rows = _label_rows(rng, 2, 8, [5, 8])
    got, want = _both([rows, rows.copy(), rows.copy()],
                      dict(image_size=SIZE, max_gt=16))
    np.testing.assert_array_equal(got, want)
    assert ((got[..., 4] != -1).sum(axis=1) <= 8).all()


def test_fuse_image_without_valid_rows():
    rng = np.random.default_rng(3)
    per_teacher = [_label_rows(rng, 2, 8, [0, 6]) for _ in range(2)]
    got, want = _both(per_teacher, dict(image_size=SIZE, max_gt=8))
    np.testing.assert_array_equal(got, want)
    assert (got[0, :, 4] == -1).all() and (got[0, :, :4] == 0).all()
    assert (got[1, :, 4] != -1).any()


def test_fuse_more_kept_boxes_than_max_gt():
    """Small far-apart boxes: nothing is suppressed, 24 are kept, max_gt
    holds 10: the 10 best by score come out, in order."""
    per_teacher = []
    for t in range(2):
        rows = np.zeros((1, 12, 6), np.float32)
        for i in range(12):
            x = 10 * i + 1
            y = 40 * t + 5
            rows[0, i] = [x, y, x + 6, y + 6, 0.9 - 0.01 * i - 0.005 * t, 1.0]
        per_teacher.append(rows)
    got, want = _both(per_teacher, dict(image_size=SIZE, max_gt=10))
    np.testing.assert_array_equal(got, want)
    assert (got[0, :, 4] == 1.0).all()
    assert got[0, 0, 1] == 5 and got[0, 1, 1] == 45   # teachers alternate


def test_build_pseudo_labels_from_shared_outputs():
    """Seeded fp32 classification/regression of three teachers through
    decode, per-class NMS, label rows and fusion in both packages."""
    rng = np.random.default_rng(11)
    anchors = anchor_table(SIZE)
    np.testing.assert_array_equal(anchors, jax_anchor_table(SIZE))
    n = anchors.shape[0]
    outputs = {}
    for m in ('rgb', 'thermal', 'depth'):
        cls = rng.uniform(0.0, 0.2, (2, n, 20)).astype(np.float32)
        hot = rng.choice(n, 40, replace=False)
        cls[:, hot, 6] = rng.uniform(0.35, 0.95, (2, 40)).astype(np.float32)
        reg = (rng.standard_normal((2, n, 4)) * 0.2).astype(np.float32)
        outputs[m] = (cls, reg)
    class_valid = np.zeros(20, bool)
    class_valid[6] = True
    lut = -np.ones(20, np.int32)
    lut[6] = 6
    kw = dict(image_size=SIZE, num_candidates=64, max_det_per_teacher=16,
              max_gt=32)
    want = np.asarray(jax_pl.build_pseudo_labels(
        {m: (jnp.asarray(c), jnp.asarray(r)) for m, (c, r) in outputs.items()},
        jnp.asarray(anchors), jnp.asarray(class_valid), jnp.asarray(lut),
        jax_pl.PseudoLabelConfig(**kw)))
    got = pl.build_pseudo_labels(
        {m: (torch.from_numpy(c), torch.from_numpy(r))
         for m, (c, r) in outputs.items()},
        torch.from_numpy(anchors), torch.from_numpy(class_valid),
        torch.from_numpy(lut), pl.PseudoLabelConfig(**kw)).numpy()
    assert got.shape == want.shape == (2, 32, 5)
    valid = want[..., 4] != -1
    assert valid.sum() >= 4
    np.testing.assert_array_equal(got[..., 4], want[..., 4])
    # floor()-ed coordinates of fp32 decodes: equal, or one apart where a
    # coordinate sits within rounding of an integer
    np.testing.assert_allclose(got[..., :4], want[..., :4], atol=1.0)
    assert (got[..., :4] == want[..., :4]).mean() > 0.99
