"""The int8 convolution of the quantized forward (ops/int8_conv.py): the
plain version against an int64 numpy derivation, exactly; torch._int_mm on
the CPU against it; on a card, the CUDA kernel and the s8 GEMM bit-equal to
it (marked `cuda`, skipped without one).

Imports torch, numpy and the port only, so it also collects on the machine
with the card: python -m pytest tests/test_torch_int8_conv.py -q --noconftest
"""
import itertools

import numpy as np
import pytest
import torch

from mm_distillnet_torch.ops import int8_conv

CIN = 8
CASES = [(s, k, g, size) for s, k, g, size in itertools.product(
    (1, 2), (1, 3, 5), (1, CIN), (9, 10))]


def _ids(case):
    s, k, g, size = case
    return f's{s}-k{k}-{"dw" if g > 1 else "g1"}-{size}'


def _same_pads(size, stride, k):
    extra = max((-(-size // stride) - 1) * stride - size + k, 0)
    return extra // 2, extra - extra // 2


def _operands(seed, size, k, groups, cout=16, clip=False):
    rng = np.random.default_rng(seed)
    qx = rng.integers(-127, 128, (2, size, size + 1, CIN)).astype(np.int8)
    if clip:   # every value at the clip limit: +127 in one image, -127 in
        qx[0], qx[1] = 127, -127    # the other
    cout = CIN if groups == CIN else cout
    qw = rng.integers(-127, 128, (cout, CIN // groups, k, k)).astype(np.int8)
    if clip:
        qw = np.full_like(qw, 127)
    return qx, qw


def _numpy_conv(qx, qw, stride, pads, groups):
    """int64 reference: NHWC x, OIHW w."""
    (pt, pb), (pl, pr) = pads
    x = np.pad(qx.astype(np.int64), ((0, 0), (pt, pb), (pl, pr), (0, 0)))
    cout, cin_g, kh, kw = qw.shape
    ho = (x.shape[1] - kh) // stride + 1
    wo = (x.shape[2] - kw) // stride + 1
    out = np.zeros((x.shape[0], ho, wo, cout), np.int64)
    per = cout // groups
    for o in range(cout):
        g = o // per
        w = qw[o].astype(np.int64)                  # (cin_g, kh, kw)
        for dy in range(kh):
            for dx in range(kw):
                patch = x[:, dy:dy + stride * (ho - 1) + 1:stride,
                          dx:dx + stride * (wo - 1) + 1:stride,
                          g * cin_g:(g + 1) * cin_g]
                out[..., o] += (patch * w[:, dy, dx]).sum(-1)
    return out


@pytest.mark.parametrize('case', CASES, ids=[_ids(c) for c in CASES])
def test_plain_version_is_exact(case):
    s, k, g, size = case
    qx, qw = _operands(sum(case), size, k, g)
    pads = (_same_pads(size, s, k), _same_pads(size + 1, s, k))
    got = int8_conv.int8_conv2d(torch.from_numpy(qx), torch.from_numpy(qw),
                                (s, s), pads, g)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  _numpy_conv(qx, qw, s, pads, g))


@pytest.mark.parametrize('k,groups', [(1, 1), (3, 1), (5, CIN)])
def test_at_the_clip_limit(k, groups):
    """|x| = |w| = 127 everywhere: the largest sums a conv can make."""
    qx, qw = _operands(3, 10, k, groups, clip=True)
    pads = (_same_pads(10, 1, k), _same_pads(11, 1, k))
    got = int8_conv.int8_conv2d(torch.from_numpy(qx), torch.from_numpy(qw),
                                (1, 1), pads, groups)
    want = _numpy_conv(qx, qw, 1, pads, groups)
    assert np.abs(want).max() == 127 * 127 * k * k * (CIN // groups)
    np.testing.assert_array_equal(got.numpy(), want)


def test_int_mm_equals_the_plain_version():
    """torch._int_mm (the 1x1 route) on the CPU gives the plain version's
    accumulators, and the wrapper of the route takes the plain version for
    a CPU tensor."""
    qx, qw = _operands(5, 9, 1, 1, cout=24)
    x, w = torch.from_numpy(qx), torch.from_numpy(qw)
    want = int8_conv.int8_conv2d_reference(x, w, (1, 1), ((0, 0), (0, 0)), 1)
    gemm = torch._int_mm(x.reshape(-1, CIN), w.reshape(24, CIN).t())
    np.testing.assert_array_equal(gemm.reshape(want.shape).numpy(),
                                  want.numpy())
    np.testing.assert_array_equal(int8_conv.int_mm(x, w).numpy(),
                                  want.numpy())


def test_routes_by_shape():
    """The route is decided by each call's shapes: the s8 GEMM takes a
    1x1, stride-1, ungrouped, unpadded conv with Cin and Cout multiples of
    8 on more than 16 rows; the kernel takes everything else."""
    z = ((0, 0), (0, 0))
    x = (2, 3, 3, 16)                       # 18 rows
    assert int8_conv.route(x, (24, 16, 1, 1), (1, 1), z, 1) == 'int_mm'
    assert int8_conv.route((2, 3, 3, 12), (24, 12, 1, 1), (1, 1), z,
                           1) == 'int8_conv2d'
    assert int8_conv.route(x, (20, 16, 1, 1), (1, 1), z, 1) == 'int8_conv2d'
    assert int8_conv.route(x, (24, 16, 1, 1), (2, 2), z, 1) == 'int8_conv2d'
    assert int8_conv.route(x, (16, 1, 3, 3), (1, 1), z, 16) == 'int8_conv2d'
    assert int8_conv.route(x, (24, 16, 1, 1), (1, 1), ((1, 1), (1, 1)),
                           1) == 'int8_conv2d'
    assert int8_conv.route((1, 4, 4, 16), (24, 16, 1, 1), (1, 1), z,
                           1) == 'int8_conv2d'     # 16 rows
    assert int8_conv.route((1, 1, 17, 16), (24, 16, 1, 1), (1, 1), z,
                           1) == 'int_mm'


def test_wrapper_refuses_what_it_cannot_sum():
    x = torch.zeros((1, 4, 4, CIN), dtype=torch.int8)
    with pytest.raises(ValueError, match='int8'):
        int8_conv.int8_conv2d(x.float(), torch.zeros((8, CIN, 1, 1)),
                              (1, 1), ((0, 0), (0, 0)), 1)
    with pytest.raises(ValueError, match='channels'):
        int8_conv.int8_conv2d(x, torch.zeros((8, 3, 1, 1), dtype=torch.int8),
                              (1, 1), ((0, 0), (0, 0)), 1)


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU and nvcc')
    return torch.device('cuda', 0)


@pytest.mark.cuda
@pytest.mark.parametrize('case', CASES, ids=[_ids(c) for c in CASES])
def test_card_routes_are_bit_equal(case, device):
    """On the card the kernel (and, for a 1x1, the s8 GEMM) gives the
    plain version's int32 accumulators bit for bit."""
    s, k, g, size = case
    qx, qw = _operands(sum(case), size, k, g)
    x = torch.from_numpy(qx).to(device)
    w = torch.from_numpy(qw).to(device)
    pads = (_same_pads(size, s, k), _same_pads(size + 1, s, k))
    want = int8_conv.int8_conv2d_reference(x, w, (s, s), pads, g)
    got = int8_conv.int8_conv2d(x, w, (s, s), pads, g)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  _numpy_conv(qx, qw, s, pads, g))
    launch = int8_conv.route(x.shape, w.shape, (s, s), pads, g)
    if launch == 'int_mm':
        assert torch.equal(int8_conv.int_mm(x, w), want)
    int8_conv.reset_launches()
    assert torch.equal(int8_conv.conv_int32(x, w, (s, s), pads, g), want)
    assert int8_conv.launches == {r: int(r == launch)
                                  for r in int8_conv.launches}
