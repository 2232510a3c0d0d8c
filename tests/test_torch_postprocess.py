"""Anchors, boxes, NMS and post-processing of the port against the
reference's ops, on the same numpy inputs (with deliberate score ties)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm_distillnet_tpu.ops import anchors as ja
from mm_distillnet_tpu.ops import boxes as jb
from mm_distillnet_tpu.ops import nms as jn
from mm_distillnet_tpu.ops import postprocess as jp
from mm_distillnet_torch.ops import anchors as ta
from mm_distillnet_torch.ops import boxes as tb
from mm_distillnet_torch.ops import nms as tn
from mm_distillnet_torch.ops import postprocess as tp

SIZE = 128


@pytest.mark.parametrize('size', [128, 768])
def test_anchor_table_matches(size):
    got = ta.anchor_table(size)
    np.testing.assert_array_equal(got, ja.anchor_table(size))
    assert got.shape[0] == ta.num_anchors(size)
    if size == 768:
        assert got.shape == (110484, 4)


@pytest.mark.parametrize('size', [128, 768])
def test_anchors_from_indices_bit_equal(size):
    n = ta.num_anchors(size)
    idx = np.arange(n, dtype=np.int32)
    if size == 768:
        idx = np.concatenate([idx[:5000], idx[-5000:],
                              np.random.default_rng(0).integers(0, n, 4000)
                              ]).astype(np.int32)
    got = ta.anchors_from_indices(torch.from_numpy(idx), size).numpy()
    want = np.asarray(ja.anchors_from_indices(jnp.asarray(idx), size))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, ta.anchor_table(size)[idx], rtol=0,
                               atol=1e-4)


def _boxes(rng, n):
    xy = rng.uniform(0, 100, (n, 2))
    wh = rng.uniform(2, 40, (n, 2))
    return np.concatenate([xy, xy + wh], axis=1).astype(np.float32)


def test_decode_clip_iou_match():
    rng = np.random.default_rng(1)
    anchors = ta.anchor_table(SIZE)[:500]
    reg = rng.normal(scale=0.5, size=(2, 500, 4)).astype(np.float32)
    got = tb.decode_boxes(torch.from_numpy(anchors), torch.from_numpy(reg))
    want = jb.decode_boxes(jnp.asarray(anchors), jnp.asarray(reg))
    # torch's and XLA's exp differ by an ulp; at coordinates ~100 px one
    # float32 ulp is 7.6e-6, so decoded boxes agree to 1e-5 absolute
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-5)
    np.testing.assert_allclose(
        tb.clip_boxes(got, float(SIZE)).numpy(),
        np.asarray(jb.clip_boxes(want, float(SIZE))), rtol=1e-6, atol=1e-5)
    same = jnp.asarray(got.numpy())  # clip alone on identical inputs
    np.testing.assert_array_equal(
        tb.clip_boxes(got, float(SIZE)).numpy(),
        np.asarray(jb.clip_boxes(same, float(SIZE))))
    a, b = _boxes(rng, 40), _boxes(rng, 30)
    np.testing.assert_allclose(
        tb.pairwise_iou_xyxy(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jb.pairwise_iou_xyxy(jnp.asarray(a), jnp.asarray(b))),
        rtol=1e-6, atol=1e-6)


def _nms_inputs(seed, k=96):
    rng = np.random.default_rng(seed)
    boxes = _boxes(rng, k)
    # coarse scores: many exact ties, broken by index in both packages
    scores = (rng.integers(0, 8, k) / 8.0).astype(np.float32)
    valid = rng.uniform(size=k) < 0.8
    classes = rng.integers(0, 3, k).astype(np.int32)
    return boxes, scores, valid, classes


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_nms_fixed_matches_with_ties(seed):
    boxes, scores, valid, _ = _nms_inputs(seed)
    got = tn.nms_fixed(torch.from_numpy(boxes), torch.from_numpy(scores),
                       torch.from_numpy(valid), 0.5, 40)
    want = jn.nms_fixed(jnp.asarray(boxes), jnp.asarray(scores),
                        jnp.asarray(valid), 0.5, 40)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize('seed', [3, 4])
def test_batched_class_nms_matches_with_ties(seed):
    boxes, scores, valid, classes = _nms_inputs(seed)
    got = tn.batched_class_nms_fixed(
        torch.from_numpy(boxes), torch.from_numpy(scores),
        torch.from_numpy(classes), torch.from_numpy(valid), 0.5, 40, 129.0)
    want = jn.batched_class_nms_fixed(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(classes),
        jnp.asarray(valid), 0.5, 40, 129.0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_nms_batches_images_like_a_loop():
    ins = [_nms_inputs(s) for s in (5, 6)]
    stacked = [torch.from_numpy(np.stack(a)) for a in zip(*ins)]
    got = tn.nms_fixed(stacked[0], stacked[1], stacked[2], 0.5, 30)
    for i, (boxes, scores, valid, _) in enumerate(ins):
        one = tn.nms_fixed(torch.from_numpy(boxes), torch.from_numpy(scores),
                           torch.from_numpy(valid), 0.5, 30)
        for g, o in zip(got, one):
            assert torch.equal(g[i], o)


@pytest.mark.parametrize('max_out', [40, 120])
def test_nms_op_cpu_matches_jax_with_ties(max_out):
    """The custom op `mm_distillnet::nms_fixed` on CPU tensors (its plain
    implementation), batched, against the JAX reference image by image;
    max_out below and above K gives max_out and K rows."""
    ins = [_nms_inputs(s) for s in (0, 1, 2)]
    stacked = [torch.from_numpy(np.stack(a)) for a in zip(*ins)]
    got = torch.ops.mm_distillnet.nms_fixed(*stacked[:3], 0.5, max_out)
    assert got[0].shape == (3, min(max_out, 96))
    for i, (boxes, scores, valid, _) in enumerate(ins):
        want = jn.nms_fixed(jnp.asarray(boxes), jnp.asarray(scores),
                            jnp.asarray(valid), 0.5, max_out)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(w))


@pytest.mark.parametrize('k,max_out', [(96, 40), (24, 40), (96, 0)])
def test_nms_op_fake_matches_cpu(k, max_out):
    """The fake implementation's shapes and dtypes are the CPU outputs',
    and the op passes torch.library's checks (schema, fake against CPU,
    dynamic shapes)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    ins = [torch.from_numpy(np.stack(a)) for a in
           zip(*[_nms_inputs(s, k)[:3] for s in (7, 8)])]
    want = torch.ops.mm_distillnet.nms_fixed(*ins, 0.5, max_out)
    with FakeTensorMode() as mode:
        got = torch.ops.mm_distillnet.nms_fixed(
            *[mode.from_tensor(t) for t in ins], 0.5, max_out)
    assert [(g.shape, g.dtype) for g in got] == \
        [(w.shape, w.dtype) for w in want]
    assert want[0].shape == (2, min(k, max_out))
    result = torch.library.opcheck(torch.ops.mm_distillnet.nms_fixed.default,
                                   (*ins, 0.5, max_out))
    assert set(result.values()) == {'SUCCESS'}, result


def _pp_inputs(seed, n_cls=20):
    rng = np.random.default_rng(seed)
    n = ta.num_anchors(SIZE)
    # quantised scores: many anchors share a packed key (ties toward the
    # lower index)
    cls = (rng.integers(0, 64, (2, n, n_cls)) / 64.0).astype(np.float32)
    reg = rng.normal(scale=0.2, size=(2, n, 4)).astype(np.float32)
    return cls, reg


@pytest.mark.parametrize('seed,conf,valid_ids', [
    (0, 0.3, [6]), (1, 0.5, [3, 6, 9]), (2, 0.9, list(range(20)))])
def test_postprocess_matches_reference(seed, conf, valid_ids):
    cls, reg = _pp_inputs(seed)
    kw = dict(image_size=SIZE, conf_threshold=conf, nms_threshold=0.5,
              num_candidates=64, max_detections=16)
    table = ta.anchor_table(SIZE)
    cv = tp.class_validity_table(20, valid_ids)
    got = tp.postprocess_detections(torch.from_numpy(cls),
                                    torch.from_numpy(reg),
                                    torch.from_numpy(table),
                                    torch.from_numpy(cv), **kw)
    want = jp.postprocess_detections(jnp.asarray(cls), jnp.asarray(reg),
                                     jnp.asarray(table), jnp.asarray(cv),
                                     **kw)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.classes.numpy(),
                                  np.asarray(want.classes))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=1e-5, atol=1e-5)
    assert got.valid.any()
    assert got.classes.dtype == torch.int32


def test_postprocess_approx_raises():
    """approx=True no longer raises: the JAX package's approx path
    (jax.lax.approx_max_k over the biased keys) is exact off the TPU, so
    the port's approx=True selects exactly, and both packages' approx=True
    give the port's approx=False detections."""
    cls, reg = _pp_inputs(0)
    kw = dict(image_size=SIZE, conf_threshold=0.3, nms_threshold=0.5,
              num_candidates=64, max_detections=16)
    table = ta.anchor_table(SIZE)
    cv = tp.class_validity_table(20, list(range(20)))
    got = tp.postprocess_detections(
        torch.from_numpy(cls), torch.from_numpy(reg), None,
        torch.from_numpy(cv), approx=True, **kw)
    exact = tp.postprocess_detections(
        torch.from_numpy(cls), torch.from_numpy(reg), None,
        torch.from_numpy(cv), **kw)
    want = jp.postprocess_detections(jnp.asarray(cls), jnp.asarray(reg),
                                     jnp.asarray(table), jnp.asarray(cv),
                                     approx=True, **kw)
    assert got.valid.any()
    for g, e, w in zip(got, exact, want):
        assert torch.equal(g, e)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_detections_to_labels_matches():
    cls, reg = _pp_inputs(3)
    kw = dict(image_size=SIZE, conf_threshold=0.3, num_candidates=64,
              max_detections=16)
    cv = tp.class_validity_table(20, [2, 6])
    table = ta.anchor_table(SIZE)
    got = tp.postprocess_detections(torch.from_numpy(cls),
                                    torch.from_numpy(reg),
                                    torch.from_numpy(table),
                                    torch.from_numpy(cv), **kw)
    want = jp.postprocess_detections(jnp.asarray(cls), jnp.asarray(reg),
                                     jnp.asarray(table), jnp.asarray(cv),
                                     **kw)
    lut = np.arange(20, dtype=np.int32)[::-1].copy()
    for include in (True, False):
        g = tp.detections_to_labels(got, torch.from_numpy(lut), SIZE,
                                    include_scores=include)
        w = jp.detections_to_labels(want, jnp.asarray(lut), SIZE,
                                    include_scores=include)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
