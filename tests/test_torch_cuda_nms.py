"""The NMS kernel (csrc/nms.cu, ops/nms.py `nms_fixed`) against its plain
version, bit for bit, on a card. Every test here is marked `cuda` and skips
without an NVIDIA GPU.

This file imports torch and the port only, so it collects wherever the
port runs:

    python -m pytest tests/test_torch_cuda_nms.py -q --noconftest
"""
import numpy as np
import pytest
import torch

from mm_distillnet_torch.ops import nms

pytestmark = pytest.mark.cuda

IMAGE = 768.0
# the callers' shapes: serving and the teachers at 512 candidates, the
# label fusion over 3 or 6 teachers' 32 detections
SHAPES = [(b, k) for b in (1, 8, 32) for k in (512, 192, 96)]
MAX_OUT = {512: 100, 192: 64, 96: 64}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU and nvcc')
    return torch.device('cuda', 0)


def _inputs(seed, b, k, levels=None, p_valid=0.8):
    """Boxes in clusters (as a detector's candidates lie), scores uniform or
    on `levels` levels (ties), valid with probability p_valid."""
    rng = np.random.default_rng(seed)
    n = max(1, k // 16)
    centre = rng.uniform(40, IMAGE - 40, (b, n, 2))
    size = rng.uniform(8, 160, (b, n, 2))
    pick = rng.integers(0, n, (b, k))
    rows = np.arange(b)[:, None]
    c = centre[rows, pick] + rng.normal(0, 6, (b, k, 2))
    s = size[rows, pick] * rng.uniform(0.8, 1.25, (b, k, 2))
    boxes = np.concatenate([c - s / 2, c + s / 2], -1).clip(0, IMAGE)
    if levels:
        scores = rng.integers(0, levels, (b, k)) / levels
    else:
        scores = rng.uniform(0, 1, (b, k))
    valid = rng.uniform(size=(b, k)) < p_valid
    return (torch.from_numpy(boxes.astype(np.float32)),
            torch.from_numpy(scores.astype(np.float32)),
            torch.from_numpy(valid))


def _on(device, *tensors):
    return [t.to(device) for t in tensors]


def _assert_same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        g, w = g.cpu(), w.cpu()
        if g.dtype == torch.float32:   # bit for bit, -0.0 and NaN included
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w)


def _against_plain(card, boxes, scores, valid, thr, max_out):
    """The kernel on the card against the plain version on the card and
    on the CPU."""
    args = _on(card, boxes, scores, valid)
    got = torch.ops.mm_distillnet.nms_fixed(*args, thr, max_out)
    torch.cuda.synchronize()
    _assert_same(got, nms.nms_fixed_reference(*args, thr, max_out))
    _assert_same(got, nms.nms_fixed_reference(boxes, scores, valid, thr,
                                              max_out))
    return got


@pytest.mark.parametrize('b,k', SHAPES, ids=[f'b{b}_k{k}' for b, k in SHAPES])
@pytest.mark.parametrize('levels', [None, 8], ids=['uniform', 'ties'])
def test_matches_plain(card, b, k, levels):
    got = _against_plain(card, *_inputs(b * 1000 + k, b, k, levels), 0.5,
                         MAX_OUT[k])
    assert got[2].any()


def test_signed_zeros_and_extreme_scores(card):
    """-0.0 ties +0.0; valid rows at NEG_INF, below it and at +-inf order
    as the two stable sorts order them."""
    boxes, scores, valid = _inputs(7, 4, 192, levels=4)
    special = torch.tensor([0.0, -0.0, nms.NEG_INF, -float('inf'),
                            float('inf'), -1e35, 1e30, -0.0])
    g = torch.Generator().manual_seed(7)
    at = torch.randint(0, special.numel(), scores.shape, generator=g)
    use = torch.rand(scores.shape, generator=g) < 0.5
    scores = torch.where(use, special[at], scores)
    _against_plain(card, boxes, scores, valid, 0.5, 160)


@pytest.mark.parametrize('thr', [0.5, 1 / 3, 0.25])
def test_iou_exactly_at_the_threshold(card, thr):
    """Pairs whose IoU is exactly fp32(thr) (not over it: kept) beside
    pairs one coordinate step over; the threshold is compared in fp32."""
    ratio = {0.5: 2, 1 / 3: 3, 0.25: 4}[thr]
    rng = np.random.default_rng(ratio)
    b, pairs = 8, 96
    # one pair in each 64 px cell of a 12 x 8 grid: no two pairs overlap
    cell = np.stack(np.meshgrid(np.arange(12), np.arange(8)), -1)
    xy = (cell.reshape(-1, 2) * 64 + rng.integers(0, 3, (b, pairs, 2))
          ).astype(np.float32)
    side = rng.integers(1, 16, (b, pairs, 1)).astype(np.float32)
    small = np.concatenate([xy, xy + side], -1)
    # the wide box holds the small one: IoU = side^2 / (ratio side^2)
    wide = small.copy()
    wide[..., 2] = xy[..., 0] + ratio * side[..., 0]
    over = rng.uniform(size=(b, pairs)) < 0.3
    wide[..., 2] -= over   # a pixel narrower: IoU over the threshold
    boxes = torch.from_numpy(np.concatenate([small, wide], 1))
    scores = torch.from_numpy(rng.uniform(size=(b, 2 * pairs))
                              .astype(np.float32))
    valid = torch.ones(b, 2 * pairs, dtype=torch.bool)
    got = _against_plain(card, boxes, scores, valid, thr, 2 * pairs)
    assert got[2].sum(1).tolist() == (2 * pairs - over.sum(1)).tolist()


def test_all_invalid_and_all_valid_rows(card):
    boxes, scores, valid = _inputs(11, 6, 512)
    valid[0] = False
    valid[1] = True
    valid[2] = False
    valid[2, 0] = True
    got = _against_plain(card, boxes, scores, valid, 0.5, 100)
    assert not got[2][0].any() and got[2][1].any()
    assert got[2][2].sum() == 1 and got[0][2, 0] == 0


@pytest.mark.parametrize('k,max_out', [(96, 120), (192, 192), (512, 0),
                                       (1, 5), (1000, 300), (1024, 1024)])
def test_output_rows(card, k, max_out):
    """max_out above K gives K rows, as `[:, :max_out]` does; K need not be
    a power of two, up to the kernel's largest."""
    got = _against_plain(card, *_inputs(k, 3, k), 0.5, max_out)
    assert got[0].shape == (3, min(k, max_out))


def test_class_offsets(card):
    """batched_class_nms_fixed's offset boxes, as the post-process builds
    them (coordinates up to 20 classes x 769)."""
    boxes, scores, valid = _inputs(13, 8, 512, levels=16)
    classes = torch.from_numpy(np.random.default_rng(13).integers(
        0, 20, (8, 512)).astype(np.int32))
    bound = IMAGE + 1.0
    got = nms.batched_class_nms_fixed(*_on(card, boxes, scores, classes,
                                           valid), 0.5, 100, bound)
    offset = boxes + classes.to(torch.float32)[..., None] * bound
    _assert_same(got, nms.nms_fixed_reference(offset, scores, valid, 0.5,
                                              100))


def test_strided_inputs(card):
    """The label fusion's views of one (B, K, 6) tensor and an unbatched
    call."""
    boxes, scores, valid = _inputs(17, 8, 192)
    cat = torch.cat([boxes, scores[..., None], valid[..., None].float()],
                    -1).to(card)
    got = nms.nms_fixed(cat[..., :4], cat[..., 4], cat[..., 5] > 0, 0.5, 64)
    _assert_same(got, nms.nms_fixed_reference(boxes, scores, valid, 0.5,
                                              64))
    one = nms.nms_fixed(cat[3, :, :4], cat[3, :, 4], cat[3, :, 5] > 0, 0.5,
                        64)
    _assert_same(one, [o[3] for o in got])


def test_one_launch_a_call(card):
    """A call is one kernel launch for the whole batch, and nothing else
    runs on the card."""
    args = _on(card, *_inputs(19, 32, 512))
    nms.nms_fixed(*args, 0.5, 100)
    torch.cuda.synchronize()
    nms.reset_launches()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        nms.nms_fixed(*args, 0.5, 100)
        torch.cuda.synchronize()
    assert nms.launches['nms_fixed'] == 1
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1 and 'nms_kernel' in kernels[0].name


def test_rejects_what_it_cannot_take(card):
    boxes, scores, valid = _on(card, *_inputs(23, 2, 1025))
    with pytest.raises(ValueError, match='at most 1024'):
        nms.nms_fixed(boxes, scores, valid, 0.5, 10)
    with pytest.raises(ValueError, match='float32'):
        nms.nms_fixed(boxes[:, :64].double(), scores[:, :64], valid[:, :64],
                      0.5, 10)
    with pytest.raises(ValueError, match='on cpu'):
        nms.nms_fixed(boxes[:, :64], scores[:, :64].cpu(), valid[:, :64],
                      0.5, 10)
