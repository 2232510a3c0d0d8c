"""The port's losses against the reference's on the same numpy inputs:
the focal loss (probability and logit paths; batches without, with some and
with all annotations), MTA (one teacher and kdlist, parity mode on and off),
DistillKL, attention transfer and the legacy focal loss, and the gradients
of focal and MTA against jax.grad."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm_distillnet_tpu.losses import aux_losses as jaux
from mm_distillnet_tpu.losses import focal as jfocal
from mm_distillnet_tpu.losses import focal_legacy as jlegacy
from mm_distillnet_tpu.losses import mta as jmta
from mm_distillnet_tpu.ops.anchors import anchor_table
from mm_distillnet_torch.losses import aux_losses, focal, focal_legacy, mta

from .test_torch_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread')

SIZE = 128
ANCHORS = anchor_table(SIZE).astype(np.float32)      # (3069, 4) [y1,x1,y2,x2]
TOL = dict(rtol=1e-5, atol=1e-6)


def _annotations(rng, batch, per_image):
    """(B, 8, 5) rows [x1,y1,x2,y2,label], label -1 padded; image i has
    per_image[i] boxes, some of them small enough to be clamped."""
    ann = np.full((batch, 8, 5), -1.0, np.float32)
    ann[..., :4] = 0.0
    for i, n in enumerate(per_image):
        for j in range(n):
            x1, y1 = rng.uniform(0, SIZE - 40, 2)
            w, h = rng.uniform(0.5, 60, 2)
            ann[i, j] = [x1, y1, x1 + w, y1 + h, rng.integers(0, 20)]
    return ann


def _detector_outputs(seed, batch=3):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0.0, 2.0, (batch, len(ANCHORS), 20)).astype(
        np.float32)
    regression = rng.normal(0.0, 0.5, (batch, len(ANCHORS), 4)).astype(
        np.float32)
    return rng, logits, regression


ANNOTATED = {'all_empty': (0, 0, 0), 'mixed_empty': (3, 0, 5),
             'regular': (2, 4, 8), 'regular_2': (1, 1, 6)}


@pytest.mark.parametrize('from_logits', [False, True],
                         ids=['probabilities', 'logits'])
@pytest.mark.parametrize('case', list(ANNOTATED))
def test_focal_loss_matches_reference(case, from_logits):
    rng, logits, regression = _detector_outputs(len(case))
    ann = _annotations(rng, 3, ANNOTATED[case])
    cls = 1.0 / (1.0 + np.exp(-logits))
    extra = {'logits': logits} if from_logits else {}
    want = jax.jit(jfocal.focal_loss)(
        cls, regression, ann, ANCHORS,
        **{k: jnp.asarray(v) for k, v in extra.items()})
    got = focal.focal_loss(
        torch.from_numpy(cls), torch.from_numpy(regression),
        torch.from_numpy(ann), torch.from_numpy(ANCHORS),
        **{k: torch.from_numpy(v) for k, v in extra.items()})
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), **TOL)
    if case == 'all_empty':
        assert float(got[0]) == 0.0 and float(got[1]) == 0.0
    else:
        assert float(got[0]) > 0.0 and float(got[1]) > 0.0


def test_focal_loss_computes_in_fp32_from_bf16_inputs():
    rng, logits, regression = _detector_outputs(7)
    ann = torch.from_numpy(_annotations(rng, 3, (2, 0, 1)))
    cls = torch.sigmoid(torch.from_numpy(logits)).to(torch.bfloat16)
    reg = torch.from_numpy(regression).to(torch.bfloat16)
    got = focal.focal_loss(cls, reg, ann, torch.from_numpy(ANCHORS))
    want = focal.focal_loss(cls.float(), reg.float(), ann,
                            torch.from_numpy(ANCHORS))
    assert all(g.dtype == torch.float32 for g in got)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def _pyramid(seed, batch=2, sizes=(16, 8, 4, 2, 1), channels=12):
    """NHWC maps whose energy varies over space, as a detector's does, so
    the attention maps are not flat."""
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((batch, s, s, channels)) *
             np.exp(rng.standard_normal((batch, s, s, 1)))).astype(np.float32)
            for s in sizes]


@pytest.mark.parametrize('parity_mode', [True, False])
@pytest.mark.parametrize('teachers', [1, 3], ids=['one_teacher', 'kdlist'])
def test_mta_loss_matches_reference(teachers, parity_mode):
    g_s = _pyramid(0)
    g_t = [_pyramid(1 + t) for t in range(teachers)]
    arg_t = g_t if teachers > 1 else g_t[0]
    want = jax.jit(jmta.mta_loss, static_argnums=(2, 3, 4))(
        [jnp.asarray(f) for f in g_s],
        jax.tree_util.tree_map(jnp.asarray, arg_t), 9.0, 2.0, parity_mode)
    got = mta.mta_loss([torch.from_numpy(f) for f in g_s],
                       [[torch.from_numpy(f) for f in ft] for ft in g_t]
                       if teachers > 1 else
                       [torch.from_numpy(f) for f in g_t[0]],
                       9.0, 2.0, parity_mode)
    assert got.shape == (5,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_mta_of_identical_features_is_nonzero_in_parity_mode():
    """The reference's kl_div(softmax, softmax) quirk, kept on purpose."""
    g = [torch.from_numpy(f) for f in _pyramid(4)]
    parity = mta.mta_loss(g, g, parity_mode=True)
    textbook = mta.mta_loss(g, g, parity_mode=False)
    assert (parity != 0).all()
    torch.testing.assert_close(textbook, torch.zeros(5), atol=1e-6,
                               rtol=0)


def test_distill_kl_matches_reference():
    rng = np.random.default_rng(5)
    s, t = (rng.normal(0, 3, (2, 50, 20)).astype(np.float32)
            for _ in range(2))
    for axis in (1, -1):
        want = jaux.distill_kl(jnp.asarray(s), jnp.asarray(t), 4.0, axis)
        got = aux_losses.distill_kl(torch.from_numpy(s), torch.from_numpy(t),
                                    4.0, axis)
        np.testing.assert_allclose(float(got), float(want), **TOL)


def test_attention_transfer_loss_matches_reference():
    """Student maps larger than the teacher's on some levels, smaller on
    others: both pooling directions."""
    g_s = _pyramid(6, sizes=(16, 4, 4, 2, 1))
    g_t = _pyramid(7, sizes=(8, 8, 4, 1, 1))
    want = jaux.attention_transfer_loss([jnp.asarray(f) for f in g_s],
                                        [jnp.asarray(f) for f in g_t])
    got = aux_losses.attention_transfer_loss(
        [torch.from_numpy(f) for f in g_s], [torch.from_numpy(f) for f in g_t])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize('case', ['all_empty', 'mixed_empty', 'regular'])
def test_focal_loss_legacy_matches_reference(case):
    rng, logits, regression = _detector_outputs(11)
    ann = _annotations(rng, 3, ANNOTATED[case])
    cls = 1.0 / (1.0 + np.exp(-logits))
    xyxy = ANCHORS[:, [1, 0, 3, 2]]
    want = jax.jit(jlegacy.focal_loss_legacy)(cls, regression, ann, xyxy)
    got = focal_legacy.focal_loss_legacy(
        torch.from_numpy(cls), torch.from_numpy(regression),
        torch.from_numpy(ann), torch.from_numpy(xyxy))
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), **TOL)


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got.double().numpy() - want) /
                 max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize('from_logits', [False, True],
                         ids=['probabilities', 'logits'])
def test_focal_loss_gradients_match_reference(from_logits):
    """d(reg + cls)/d(scores or logits) and d/d(regression): relative error
    per tensor <= 1e-4."""
    rng, logits, regression = _detector_outputs(13)
    ann = _annotations(rng, 3, (3, 0, 6))
    cls = (1.0 / (1.0 + np.exp(-logits))).astype(np.float32)
    x = logits if from_logits else cls

    def jax_total(x, r):
        kw = {'logits': x} if from_logits else {}
        reg, c = jfocal.focal_loss(x if not from_logits else
                                   jnp.asarray(cls), r, ann, ANCHORS, **kw)
        return reg + c

    want = jax.jit(jax.grad(jax_total, argnums=(0, 1)))(x, regression)
    xt = torch.from_numpy(x).requires_grad_()
    rt = torch.from_numpy(regression).requires_grad_()
    kw = {'logits': xt} if from_logits else {}
    reg, c = focal.focal_loss(xt if not from_logits else
                              torch.from_numpy(cls), rt, torch.from_numpy(ann),
                              torch.from_numpy(ANCHORS), **kw)
    (reg + c).backward()
    for g, w in ((xt.grad, want[0]), (rt.grad, want[1])):
        assert float(np.abs(np.asarray(w)).max()) > 0
        assert _rel(g, w) <= 1e-4


@pytest.mark.parametrize('teachers', [1, 3], ids=['one_teacher', 'kdlist'])
def test_mta_loss_gradients_match_reference(teachers):
    g_s = _pyramid(8)
    g_t = [_pyramid(9 + t) for t in range(teachers)]
    arg_t = [[jnp.asarray(f) for f in ft] for ft in g_t] if teachers > 1 \
        else [jnp.asarray(f) for f in g_t[0]]
    want = jax.jit(jax.grad(lambda fs: jnp.sum(jmta.mta_loss(fs, arg_t))))(
        [jnp.asarray(f) for f in g_s])
    fs = [torch.from_numpy(f).requires_grad_() for f in g_s]
    tt = [[torch.from_numpy(f) for f in ft] for ft in g_t] if teachers > 1 \
        else [torch.from_numpy(f) for f in g_t[0]]
    mta.mta_loss(fs, tt).sum().backward()
    for f, w in zip(fs, want):
        assert _rel(f.grad, w) <= 1e-4
