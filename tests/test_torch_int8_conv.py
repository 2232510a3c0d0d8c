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

from mm_distillnet_torch import quant
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


# ---- the launch plan, its tiled CPU emulation and the fused plain version

Z = ((0, 0), (0, 0))
# the 'int8_conv2d'-route calls of a D2 forward at 768 px, batch 1, one per
# distinct shape: (x (B, H, W, Cin) as the conv receives it, already padded;
# w (Cout, Cin/g, kh, kw); stride). test_d2_shapes_are_the_forward_s checks
# the list against the port's module tree.
D2_CALLS = [
    ((1, 769, 769, 8), (32, 8, 3, 3), 2),
    ((1, 386, 386, 32), (32, 1, 3, 3), 1),
    ((1, 386, 386, 16), (16, 1, 3, 3), 1),
    ((1, 385, 385, 96), (96, 1, 3, 3), 2),
    ((1, 194, 194, 144), (144, 1, 3, 3), 1),
    ((1, 195, 195, 144), (144, 1, 5, 5), 2),
    ((1, 100, 100, 288), (288, 1, 5, 5), 1),
    ((1, 97, 97, 288), (288, 1, 3, 3), 2),
    ((1, 50, 50, 528), (528, 1, 3, 3), 1),
    ((1, 52, 52, 528), (528, 1, 5, 5), 1),
    ((1, 52, 52, 720), (720, 1, 5, 5), 1),
    ((1, 51, 51, 720), (720, 1, 5, 5), 2),
    ((1, 28, 28, 1248), (1248, 1, 5, 5), 1),
    ((1, 26, 26, 1248), (1248, 1, 3, 3), 1),
    ((1, 26, 26, 2112), (2112, 1, 3, 3), 1),
    ((1, 98, 98, 112), (112, 1, 3, 3), 1),
    ((1, 50, 50, 112), (112, 1, 3, 3), 1),
    ((1, 26, 26, 112), (112, 1, 3, 3), 1),
    ((1, 14, 14, 112), (112, 1, 3, 3), 1),
    ((1, 8, 8, 112), (112, 1, 3, 3), 1),
]
IN_BYTES = {'int8': 1, 'bf16': 2, 'fp32': 4}


def _groups(w_shape):
    return w_shape[0] if w_shape[1] == 1 else 1


def _d2_id(call):
    x, w, s = call
    return f'{x[1]}x{x[3]}-k{w[2]}s{s}-{"dw" if w[1] == 1 else "dense"}'


def test_d2_shapes_are_the_forward_s():
    """D2_CALLS are the distinct 'int8_conv2d'-route calls of the port's
    D2 at 768 px, batch 1 (a forward on the meta device: shapes only)."""
    from mm_distillnet_torch import quant
    from mm_distillnet_torch.models.efficientdet import EfficientDet
    with torch.device('meta'):
        model = EfficientDet(20, 2, 8).eval()
    seen = []
    policy = quant.QuantPolicy()

    def call(path, conv, x):
        if policy.wants(path, conv.groups):
            xs = tuple(x.permute(0, 2, 3, 1).shape)
            ws = tuple(conv.weight.shape)
            if int8_conv.route(xs, ws, conv.stride, quant._padding(conv),
                               conv.groups) == 'int8_conv2d':
                assert quant._padding(conv) == Z
                seen.append((xs, ws, conv.stride[0]))
        return quant.conv_forward(conv, x)

    with torch.no_grad(), quant._intercepted(model, call):
        model(torch.empty((1, 768, 768, 8), device='meta'))
    assert len(seen) == 104
    assert sorted(set(seen)) == sorted(D2_CALLS)


@pytest.mark.parametrize('dtype', list(IN_BYTES))
@pytest.mark.parametrize('call', D2_CALLS, ids=[_d2_id(c) for c in D2_CALLS])
def test_plan_covers_the_d2_calls(call, dtype):
    """Each CTA's outputs lie in exactly one tile, every halo holds the
    input its outputs need and lies inside the (padded) input, and the
    launch fits a CTA: shared memory <= 232,448 B, threads <= 1,024."""
    x, w, s = call
    g = _groups(w)
    plan = int8_conv.launch_plan(x, w, (s, s), Z, g, IN_BYTES[dtype])
    assert plan.path == ('stem' if g == 1 else 'depthwise')
    assert 32 <= plan.threads <= min(1024, int8_conv.MAX_THREADS)
    assert plan.smem <= int8_conv.SMEM_LIMIT
    assert plan.grid[1] <= 65535 and plan.grid[2] <= 65535
    assert plan.vec * IN_BYTES[dtype] <= 16
    _, h, wd, cin = x
    cout, _, kh, kw = w
    ho, wo = int8_conv.output_hw(h, wd, (kh, kw), (s, s), Z)
    if plan.path == 'depthwise':
        assert plan.threads >= (plan.cb // 4) * (plan.tw // plan.spw) * (
            plan.th // plan.rpt)
        assert plan.threads % (plan.cb // plan.vec) == 0
        assert plan.smem >= plan.halo_h * plan.halo_w * plan.cb + \
            kh * kw * plan.cb
    else:
        assert plan.threads == cout // 8 * (plan.th // plan.rpt) * plan.tw
    count = np.zeros((ho, wo, cout), np.int8)
    tiles = 0
    for t in int8_conv.plan_tiles(plan, x, w, (s, s), Z):
        tiles += 1
        count[t.oy0:t.oy1, t.ox0:t.ox1, t.c0:t.c1] += 1
        rows = (t.oy0 * s, (t.oy1 - 1) * s + kh)   # input the outputs need
        cols = (t.ox0 * s, (t.ox1 - 1) * s + kw)
        assert t.iy0 <= rows[0] and rows[1] <= t.iy0 + t.hh
        assert t.ix0 <= cols[0] and cols[1] <= t.ix0 + t.hw
        assert 0 <= rows[0] and rows[1] <= h and 0 <= cols[0] and cols[1] <= wd
        assert 0 <= t.ci0 < t.ci1 <= cin
    assert tiles == np.prod(plan.grid)
    assert (count == 1).all()


def _same(size, s, k):
    return _same_pads(size, s, k)


# 68 channels: no divisor of 68 is 16 or more, so the plan takes a block
# of 64 and a ragged last block of 4 channels
RAGGED = 68
TILED = [(k, s, c, b) for k, s, c, b in itertools.product(
    (3, 5), (1, 2), (20, 36, RAGGED, 112), (1, 2))]


def _depthwise_plan(qx_shape, qw_shape, s, pads, in_bytes=1):
    """The plan of a TILED case; RAGGED must have a ragged last block."""
    c = qx_shape[-1]
    plan = int8_conv.launch_plan(qx_shape, qw_shape, (s, s), pads, c,
                                 in_bytes)
    assert plan.path == 'depthwise'
    assert (plan.cblocks * plan.cb > c) == (c == RAGGED)
    return plan


@pytest.mark.parametrize('k,s,c,b', TILED,
                         ids=[f'dw{k}s{s}-c{c}-b{b}' for k, s, c, b in TILED])
def test_tiled_emulation_depthwise(k, s, c, b):
    """The kernel's tiling of a depthwise conv, walked on the CPU, gives
    the plain version's sums bit for bit: ragged tiles (a 23x37 input),
    channel counts the block does not divide into 16-byte loads, a ragged
    last channel block (RAGGED), TF-SAME padding."""
    rng = np.random.default_rng(k * 100 + s * 10 + c + b)
    qx = torch.from_numpy(rng.integers(-127, 128, (b, 23, 37, c)).astype(
        np.int8))
    qw = torch.from_numpy(rng.integers(-127, 128, (c, 1, k, k)).astype(
        np.int8))
    pads = (_same(23, s, k), _same(37, s, k))
    for in_bytes in (1, 2, 4):
        _depthwise_plan(tuple(qx.shape), tuple(qw.shape), s, pads, in_bytes)
    np.testing.assert_array_equal(
        int8_conv.int8_conv2d_tiled_reference(qx, qw, (s, s), pads,
                                              c).numpy(),
        int8_conv.int8_conv2d_reference(qx, qw, (s, s), pads, c).numpy())


STEM = [(cin, b) for cin in (8, 3) for b in (1, 2)]


@pytest.mark.parametrize('cin,b', STEM, ids=[f'cin{c}-b{b}' for c, b in STEM])
def test_tiled_emulation_stem(cin, b):
    """The stem's tiling (3x3 stride 2, 32 outputs; Cin 8 and a teacher's
    Cin 3, zero-padded to a word) against the plain version."""
    rng = np.random.default_rng(cin + b)
    qx = torch.from_numpy(rng.integers(-127, 128, (b, 41, 39, cin)).astype(
        np.int8))
    qw = torch.from_numpy(rng.integers(-127, 128, (32, cin, 3, 3)).astype(
        np.int8))
    pads = (_same(41, 2, 3), _same(39, 2, 3))
    plan = int8_conv.launch_plan(tuple(qx.shape), tuple(qw.shape), (2, 2),
                                 pads, 1)
    assert plan.path == 'stem'
    np.testing.assert_array_equal(
        int8_conv.int8_conv2d_tiled_reference(qx, qw, (2, 2), pads,
                                              1).numpy(),
        int8_conv.int8_conv2d_reference(qx, qw, (2, 2), pads, 1).numpy())


CLIP = [(16, 1, 3, 16), (16, 1, 5, 16), (32, 8, 3, 1), (24, 3, 3, 4)]


@pytest.mark.parametrize('cout,cin_g,k,groups', CLIP,
                         ids=['dw3', 'dw5', 'stem', 'general'])
def test_tiled_emulation_at_the_clip_limit(cout, cin_g, k, groups):
    """+-127 everywhere: the largest sums each path makes, tiled."""
    cin = cin_g * groups
    qx = np.full((2, 19, 21, cin), 127, np.int8)
    qx[1] = -127
    qw = torch.full((cout, cin_g, k, k), 127, dtype=torch.int8)
    x = torch.from_numpy(qx)
    pads = (_same(19, 1, k), _same(21, 1, k))
    want = int8_conv.int8_conv2d_reference(x, qw, (1, 1), pads, groups)
    assert int(want.abs().max()) == 127 * 127 * k * k * cin_g
    np.testing.assert_array_equal(
        int8_conv.int8_conv2d_tiled_reference(x, qw, (1, 1), pads,
                                              groups).numpy(), want.numpy())


def test_general_path_takes_the_rest():
    """A 1x1 the GEMM refuses (Cout % 8 != 0) and a grouped 3x3 go to the
    general kernel, whose per-row tiling equals the plain version."""
    rng = np.random.default_rng(7)
    qx = torch.from_numpy(rng.integers(-127, 128, (2, 5, 6, 12)).astype(
        np.int8))
    for w_shape, pads, g in (((20, 12, 1, 1), Z, 1),
                             ((24, 3, 3, 3), ((1, 1), (1, 1)), 4)):
        qw = torch.from_numpy(rng.integers(-127, 128, w_shape).astype(
            np.int8))
        plan = int8_conv.launch_plan(tuple(qx.shape), w_shape, (1, 1), pads,
                                     g)
        assert plan.path == 'general'
        np.testing.assert_array_equal(
            int8_conv.int8_conv2d_tiled_reference(qx, qw, (1, 1), pads,
                                                  g).numpy(),
            int8_conv.int8_conv2d_reference(qx, qw, (1, 1), pads, g).numpy())


def _fused_operands(seed, kind, dtype, bias, device='cpu'):
    """x (B, H, W, Cin) in dtype with a few values past the clip range,
    int8 weights, fp32 scales as a pack holds them, and a bias."""
    rng = np.random.default_rng(seed)
    cin, cout, k, s, g = {'dw3': (36, 36, 3, 1, 36), 'dw5': (20, 20, 5, 2, 20),
                          'stem': (8, 32, 3, 2, 1),
                          'int_mm': (16, 24, 1, 1, 1)}[kind]
    x = torch.from_numpy(rng.standard_normal((2, 13, 11, cin)).astype(
        np.float32) * 2.0).to(dtype)
    ascale = torch.tensor(np.float32(4.0 / 127.0))
    qw = torch.from_numpy(rng.integers(-127, 128, (cout, cin // g, k, k))
                          .astype(np.int8))
    wscale = torch.from_numpy(rng.uniform(1e-3, 2e-2, cout).astype(
        np.float32))
    b = torch.from_numpy(rng.standard_normal(cout).astype(np.float32)).to(
        dtype) if bias else None
    pads = (_same(13, s, k), _same(11, s, k)) if k > 1 else Z
    to = (lambda t: t if t is None else t.to(device))
    return (to(x), to(qw), to(wscale), to(ascale), to(b), (s, s), pads, g)


def _unfused(x, qw, wscale, ascale, bias, stride, padding, groups,
             compute_dtype):
    """quant.quantized_conv's torch sequence before the fused kernel."""
    qx = torch.clamp(torch.round(x.float() / ascale), -127, 127).to(
        torch.int8)
    acc = int8_conv.conv_int32(qx, qw, stride, padding, groups)
    y = acc.float() * (ascale * wscale)
    if bias is not None:
        y = y + bias.float()
    return y.to(compute_dtype).to(x.dtype)


FLOATS = (torch.bfloat16, torch.float16, torch.float32)
FUSED = [(kind, dtype, bias, cdt)
         for kind in ('dw3', 'dw5', 'stem', 'int_mm')
         for dtype in FLOATS
         for bias in (False, True)
         for cdt in FLOATS]


def _fused_id(case):
    kind, dtype, bias, cdt = case
    return (f'{kind}-x{str(dtype)[6:]}-{"bias" if bias else "nobias"}'
            f'-c{str(cdt)[6:]}')


@pytest.mark.parametrize('case', FUSED, ids=[_fused_id(c) for c in FUSED])
def test_fused_plain_version_is_the_unfused_sequence(case):
    """quantized_conv2d_reference, quantized_conv2d on a CPU tensor and the
    route dispatch quant.fused_conv equal the torch sequence that
    quant.quantized_conv ran before the fused kernel, bit for bit."""
    kind, dtype, bias, cdt = case
    args = _fused_operands(len(_fused_id(case)), kind, dtype, bias)
    want = _unfused(*args, cdt)
    assert want.dtype == dtype
    for fn in (int8_conv.quantized_conv2d_reference,
               int8_conv.quantized_conv2d, quant.fused_conv):
        got = fn(*args, cdt)
        assert got.dtype == dtype and got.shape == want.shape
        assert torch.equal(got, want), fn.__name__


@pytest.mark.parametrize('bias', [False, True])
def test_quant_conv_call_site_is_unchanged(bias):
    """quant.quantized_conv on an NCHW view of NHWC memory (what the module
    tree hands it) equals the unfused sequence and returns NHWC memory."""
    from mm_distillnet_torch import quant
    x, qw, wscale, ascale, b, stride, pads, g = _fused_operands(
        11, 'dw3', torch.bfloat16, bias)
    conv = torch.nn.Conv2d(36, 36, 3, 1, groups=36, bias=bias).to(
        torch.bfloat16)
    if bias:
        with torch.no_grad():
            conv.bias.copy_(b)
    xp = torch.nn.functional.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1))
    got = quant.quantized_conv(conv, xp, qw, wscale, ascale)
    want = _unfused(xp.permute(0, 2, 3, 1), qw, wscale, ascale,
                    conv.bias, (1, 1), Z, 36, torch.bfloat16)
    assert got.permute(0, 2, 3, 1).is_contiguous()
    assert torch.equal(got.permute(0, 2, 3, 1), want)


def test_fused_wrapper_refuses_what_the_kernel_does_not_take():
    x, qw, wscale, ascale, b, stride, pads, g = _fused_operands(
        3, 'dw3', torch.bfloat16, True)
    with pytest.raises(ValueError, match='bf16, fp16 or fp32'):
        int8_conv.quantized_conv2d(x.double(), qw, wscale, ascale, b, stride,
                                   pads, g)
    with pytest.raises(ValueError, match='scales'):
        int8_conv.quantized_conv2d(x, qw, wscale.double(), ascale, b,
                                   stride, pads, g)
    with pytest.raises(ValueError, match='compute dtype'):
        int8_conv.quantized_conv2d(x, qw, wscale, ascale, b, stride, pads,
                                   g, torch.float64)


@pytest.mark.cuda
@pytest.mark.parametrize('k,s,c,b', TILED,
                         ids=[f'dw{k}s{s}-c{c}-b{b}' for k, s, c, b in TILED])
def test_card_depthwise_tiles(k, s, c, b, device):
    """On the card the depthwise tile kernels give their plain versions'
    results bit for bit, on the emulation's cases (the ragged last channel
    block included): int8_conv2d's sums, and quantized_conv2d's output on
    bf16 and fp16 input with a bias."""
    rng = np.random.default_rng(k * 100 + s * 10 + c + b)
    qx = torch.from_numpy(rng.integers(-127, 128, (b, 23, 37, c)).astype(
        np.int8)).to(device)
    qw = torch.from_numpy(rng.integers(-127, 128, (c, 1, k, k)).astype(
        np.int8)).to(device)
    pads = (_same(23, s, k), _same(37, s, k))
    _depthwise_plan(tuple(qx.shape), tuple(qw.shape), s, pads)
    int8_conv.reset_launches()
    got = int8_conv.int8_conv2d(qx, qw, (s, s), pads, c)
    torch.cuda.synchronize()
    assert int8_conv.launches['int8_conv2d'] == 1
    assert torch.equal(got, int8_conv.int8_conv2d_reference(qx, qw, (s, s),
                                                            pads, c))
    wscale = torch.from_numpy(rng.uniform(1e-3, 2e-2, c).astype(
        np.float32)).to(device)
    ascale = torch.tensor(np.float32(3.0 / 127.0), device=device)
    for dtype in (torch.bfloat16, torch.float16):
        x = torch.from_numpy(rng.standard_normal((b, 23, 37, c)).astype(
            np.float32)).to(device, dtype)
        bias = torch.from_numpy(rng.standard_normal(c).astype(
            np.float32)).to(device, dtype)
        args = (x, qw, wscale, ascale, bias, (s, s), pads, c, dtype)
        got = int8_conv.quantized_conv2d(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, _unfused(*args)), dtype


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', FLOATS, ids=['bf16', 'fp16', 'fp32'])
@pytest.mark.parametrize('call', D2_CALLS, ids=[_d2_id(c) for c in D2_CALLS])
def test_card_kernels_at_the_d2_shapes(call, dtype, device):
    """Both kernels at each D2@768 call shape (batch 1): int8_conv2d equal
    to the plain version; quantized_conv2d on bf16, fp16 or fp32 input
    (computing in that dtype) equal to the unfused sequence."""
    x_shape, w_shape, s = call
    g = _groups(w_shape)
    rng = np.random.default_rng(sum(x_shape))
    x = torch.from_numpy(rng.standard_normal(x_shape).astype(
        np.float32)).to(device, dtype)
    qw = torch.from_numpy(rng.integers(-127, 128, w_shape).astype(
        np.int8)).to(device)
    wscale = torch.from_numpy(rng.uniform(1e-3, 2e-2, w_shape[0]).astype(
        np.float32)).to(device)
    ascale = torch.tensor(np.float32(3.0 / 127.0), device=device)
    qx = torch.clamp(torch.round(x.float() / ascale), -127, 127).to(
        torch.int8)
    assert torch.equal(int8_conv.int8_conv2d(qx, qw, (s, s), Z, g),
                       int8_conv.int8_conv2d_reference(qx, qw, (s, s), Z, g))
    got = int8_conv.quantized_conv2d(x, qw, wscale, ascale, None, (s, s), Z,
                                     g, dtype)
    torch.cuda.synchronize()
    assert torch.equal(got, _unfused(x, qw, wscale, ascale, None, (s, s), Z,
                                     g, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize('case', FUSED, ids=[_fused_id(c) for c in FUSED])
def test_card_fused_kernel_is_the_unfused_sequence(case, device):
    """On the card, quantized_conv2d (the 'int8_conv2d' route) or
    int8_gemm's quantized_conv1x1 (the 'int_mm' route) equals the unfused
    torch sequence bit for bit, and the route's fused kernel counts its
    launch (torch._int_mm none)."""
    kind, dtype, bias, cdt = case
    args = _fused_operands(len(_fused_id(case)), kind, dtype, bias, device)
    want = _unfused(*args, cdt)
    int8_conv.reset_launches()
    got = quant.fused_conv(*args, cdt)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    fused = kind != 'int_mm'
    assert int8_conv.launches['quantized_conv2d'] == int(fused)
    assert int8_conv.launches['quantized_conv1x1'] == int(not fused)
    assert int8_conv.launches['int_mm'] == 0


@pytest.mark.cuda
@pytest.mark.parametrize('cin,b', STEM, ids=[f'cin{c}-b{b}' for c, b in STEM])
def test_card_stem_kernel(cin, b, device):
    """The dp4a stem kernel (Cin 8 and 3) and the general kernel (a 1x1
    with Cout % 8 != 0) on the card equal the plain version."""
    rng = np.random.default_rng(cin + b)
    qx = torch.from_numpy(rng.integers(-127, 128, (b, 41, 39, cin)).astype(
        np.int8)).to(device)
    qw = torch.from_numpy(rng.integers(-127, 128, (32, cin, 3, 3)).astype(
        np.int8)).to(device)
    pads = (_same(41, 2, 3), _same(39, 2, 3))
    assert torch.equal(int8_conv.int8_conv2d(qx, qw, (2, 2), pads, 1),
                       int8_conv.int8_conv2d_reference(qx, qw, (2, 2), pads,
                                                       1))
    q1 = torch.from_numpy(rng.integers(-127, 128, (20, cin, 1, 1)).astype(
        np.int8)).to(device)
    assert torch.equal(int8_conv.int8_conv2d(qx, q1, (1, 1), Z, 1),
                       int8_conv.int8_conv2d_reference(qx, q1, (1, 1), Z, 1))


def _pr8_quantized_conv(conv, x, qkernel, wscale, ascale,
                        compute_dtype=torch.bfloat16):
    """quant.quantized_conv as it was before the fused kernel."""
    from mm_distillnet_torch import quant
    qx = torch.clamp(torch.round(x.float() / ascale), -127, 127).to(
        torch.int8)
    acc = int8_conv.conv_int32(qx.permute(0, 2, 3, 1), qkernel,
                               tuple(conv.stride), quant._padding(conv),
                               conv.groups)
    y = acc.float() * (ascale * wscale)
    if conv.bias is not None:
        y = y + conv.bias.float()
    return y.to(compute_dtype).to(x.dtype).permute(0, 3, 1, 2)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16,
                                   torch.float16],
                         ids=['fp32', 'bf16', 'fp16'])
def test_quantized_apply_is_unchanged_on_the_cpu(dtype, monkeypatch):
    """On the CPU, quantized_apply of a seeded test-tiny detector in the
    compute dtype (config compute_dtype: float32, bfloat16 or float16)
    gives the same outputs, bit for bit, as with quant.quantized_conv's
    sequence before the fused kernel."""
    from mm_distillnet_torch import quant
    from mm_distillnet_torch.models.efficientdet import EfficientDet
    torch.manual_seed(3)
    model = EfficientDet(20, -1, 8).eval().to(dtype)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 128, 128, 8)).astype(np.float32)).to(dtype)
    with torch.no_grad():
        pack = quant.build_quant_pack(model, x, [x])
        got = quant.quantized_apply(model, pack, x)
        monkeypatch.setattr(quant, 'quantized_conv', _pr8_quantized_conv)
        want = quant.quantized_apply(model, pack, x)
    flat = (lambda out: [t for f in out for t in (
        f if isinstance(f, (list, tuple)) else [f])])
    assert len(flat(got)) == len(flat(want)) > 3
    for g, w in zip(flat(got), flat(want)):
        assert torch.equal(g, w)


# ---- the fused kernel at the serving batch

TORCH_DT = {'bf16': torch.bfloat16, 'fp16': torch.float16,
            'fp32': torch.float32}
DW_D2 = [c for c in D2_CALLS if c[1][1] == 1]


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', ['bf16', 'fp16', 'fp32'])
@pytest.mark.parametrize('call', DW_D2, ids=[_d2_id(c) for c in DW_D2])
def test_card_kernels_at_the_d2_shapes_batch_8(call, dtype, device):
    """quantized_conv2d at the depthwise D2@768 shapes at the serving
    batch equals the unfused sequence bit for bit."""
    x_shape, w_shape, s = call
    x_shape = (8,) + x_shape[1:]
    rng = np.random.default_rng(sum(x_shape))
    x = torch.from_numpy(rng.standard_normal(x_shape).astype(
        np.float32)).to(device, TORCH_DT[dtype])
    qw = torch.from_numpy(rng.integers(-127, 128, w_shape).astype(
        np.int8)).to(device)
    wscale = torch.from_numpy(rng.uniform(1e-3, 2e-2, w_shape[0]).astype(
        np.float32)).to(device)
    ascale = torch.tensor(np.float32(3.0 / 127.0), device=device)
    args = (x, qw, wscale, ascale, None, (s, s), Z, w_shape[0],
            TORCH_DT[dtype])
    got = int8_conv.quantized_conv2d(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, _unfused(*args))


@pytest.mark.cuda
def test_card_fused_kernel_under_graph_capture(device):
    """quantized_conv2d captured in a CUDA graph and replayed on new input
    equals the unfused sequence."""
    x_shape, w_shape = (8, 194, 194, 144), (144, 1, 3, 3)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(x_shape).astype(
        np.float32)).to(device, torch.bfloat16)
    qw = torch.from_numpy(rng.integers(-127, 128, w_shape).astype(
        np.int8)).to(device)
    wscale = torch.from_numpy(rng.uniform(1e-3, 2e-2, 144).astype(
        np.float32)).to(device)
    ascale = torch.tensor(np.float32(3.0 / 127.0), device=device)
    static_x = x.clone()
    args = (static_x, qw, wscale, ascale, None, (1, 1), Z, 144)
    int8_conv.quantized_conv2d(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = int8_conv.quantized_conv2d(*args)
    static_x.copy_(x * 0.5)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, _unfused(*args, torch.bfloat16))
