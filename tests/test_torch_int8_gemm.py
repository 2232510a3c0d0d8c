"""The quantized forward's 1x1 convs as one kernel (ops/int8_gemm.py,
csrc/int8_gemm.cuh): the plain version against the unfused torch sequence
(torch._int_mm for the int32 sums), bit for bit, at the distinct 1x1 shapes
of a D2 forward; the launch plan at those shapes; the plan's tiled CPU
emulation against the plain version on ragged tails and at the clip limit;
the weight repack. On a card (marked `cuda`, skipped without one) the kernel
against its plain version at the D2@768 batch-8 shapes, on the same tails
and under a CUDA-graph capture.

Imports torch, numpy and the port only, so it also collects on the machine
with the card: python -m pytest tests/test_torch_int8_gemm.py -q --noconftest
"""
import numpy as np
import pytest
import torch

from mm_distillnet_torch import quant
from mm_distillnet_torch.ops import int8_conv, int8_gemm

FLOATS = (torch.bfloat16, torch.float16, torch.float32)
DT_IDS = {torch.bfloat16: 'bf16', torch.float16: 'fp16',
          torch.float32: 'fp32'}

# the distinct 1x1 'int_mm'-route calls of a D2 forward at 768 px, batch 1:
# (H, W, Cin, Cout, bias). test_d2_shapes_are_the_forward_s checks the list
# against the port's module tree.
D2_1X1 = [
    (384, 384, 32, 16, False), (384, 384, 16, 16, False),
    (384, 384, 16, 96, False), (192, 192, 144, 24, False),
    (192, 192, 96, 24, False), (192, 192, 24, 144, False),
    (96, 96, 288, 48, False), (96, 96, 144, 48, False),
    (96, 96, 48, 288, False), (96, 96, 48, 112, True),
    (96, 96, 112, 112, True), (48, 48, 720, 120, False),
    (48, 48, 528, 88, False), (48, 48, 528, 120, False),
    (48, 48, 288, 88, False), (48, 48, 120, 720, False),
    (48, 48, 120, 112, True), (48, 48, 112, 112, True),
    (48, 48, 88, 528, False), (24, 24, 2112, 352, False),
    (24, 24, 1248, 208, False), (24, 24, 1248, 352, False),
    (24, 24, 720, 208, False), (24, 24, 352, 2112, False),
    (24, 24, 352, 112, True), (24, 24, 208, 1248, False),
    (24, 24, 112, 112, True), (12, 12, 112, 112, True),
    (6, 6, 112, 112, True),
]


def _d2_id(s):
    h, w, k, n, bias = s
    return f'{h}x{k}-{n}{"-bias" if bias else ""}'


def _operands(seed, shape, dtype, bias, device='cpu', clip=False):
    """x (B, H, W, K) in dtype with values past the clip range, int8
    weights, fp32 scales as a pack holds them, a bias in dtype (or None).
    With clip: x / ascale at the clip limit and on and near half-integers,
    a quarter of the values each."""
    b, h, w, k, n = shape
    rng = np.random.default_rng(seed)
    ascale = np.float32(4.0 / 127.0)
    x = rng.standard_normal((b, h, w, k)).astype(np.float32) * 2.0
    if clip:
        q = rng.integers(-130, 131, x.shape).astype(np.float32)
        ties = (q + 0.5) * ascale
        kind = rng.integers(0, 4, x.shape)
        x = np.where(kind == 0, np.float32(127.5) * ascale * np.sign(x + .1),
                     np.where(kind == 1, ties, np.where(
                         kind == 2, np.nextafter(ties, np.float32(0)), x)))
    x = torch.from_numpy(x.astype(np.float32)).to(dtype)
    qw = torch.from_numpy(rng.integers(-127, 128, (n, k, 1, 1)).astype(
        np.int8))
    if clip:
        qw[:n // 2] = 127
    wscale = torch.from_numpy(rng.uniform(1e-3, 2e-2, n).astype(np.float32))
    bvec = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(
        dtype) if bias else None
    to = (lambda t: t if t is None else t.to(device))
    return to(x), to(qw), to(wscale), to(torch.tensor(ascale)), to(bvec)


def _unfused(x, qw, wscale, ascale, bias, compute_dtype):
    """The 'int_mm' route's torch sequence before the fused kernel: the
    prologue, torch._int_mm, the epilogue."""
    b, h, w, k = x.shape
    n = qw.shape[0]
    qx = torch.clamp(torch.round(x.float() / ascale), -127, 127).to(
        torch.int8)
    acc = torch._int_mm(qx.reshape(-1, k), qw.reshape(n, k).t())
    y = acc.reshape(b, h, w, n).float() * (ascale * wscale)
    if bias is not None:
        y = y + bias.float()
    return y.to(compute_dtype).to(x.dtype)


def _cut(s, m_rows):
    """A D2 shape cut to about m_rows rows (batch 1), keeping K, N and the
    bias; at least 17 rows (torch._int_mm's limit)."""
    h, w, k, n, bias = s
    side = max(5, min(h, int(m_rows ** 0.5)))
    return (1, side, side + (side % 2 == 0), k, n), bias


def test_d2_shapes_are_the_forward_s():
    """D2_1X1 are the distinct 'int_mm'-route calls of the port's D2 at 768
    px, batch 1 (a forward on the meta device: shapes only), 120 of them."""
    from mm_distillnet_torch import quant
    from mm_distillnet_torch.models.efficientdet import EfficientDet
    with torch.device('meta'):
        model = EfficientDet(20, 2, 8).eval()
    seen = []
    policy = quant.QuantPolicy()

    def call(path, conv, x):
        if policy.wants(path, conv.groups):
            _, c, h, w = x.shape
            ws = tuple(conv.weight.shape)
            if int8_conv.route((1, h, w, c), ws, conv.stride,
                               quant._padding(conv),
                               conv.groups) == 'int_mm':
                assert int8_gemm.takes(ws)
                seen.append((h, w, c, ws[0], conv.bias is not None))
        return quant.conv_forward(conv, x)

    with torch.no_grad(), quant._intercepted(model, call):
        model(torch.empty((1, 768, 768, 8), device='meta'))
    assert len(seen) == 120
    assert sorted(set(seen)) == sorted(D2_1X1)


@pytest.mark.parametrize('dtype', FLOATS, ids=DT_IDS.get)
@pytest.mark.parametrize('shape', D2_1X1, ids=[_d2_id(s) for s in D2_1X1])
def test_plain_version_is_the_unfused_sequence(shape, dtype):
    """At each D2 1x1 shape (K 16-2,112, N 16-2,112; cut to a map of about
    40 rows at batch 1, odd widths: M never a multiple of 64), the wrapper
    on a CPU tensor, its plain version and the route dispatch equal the
    torch sequence around torch._int_mm bit for bit, computing in x's
    dtype."""
    cut, bias = _cut(shape, 40)
    x, qw, wscale, ascale, b = _operands(sum(cut), cut, dtype, bias)
    want = _unfused(x, qw, wscale, ascale, b, dtype)
    assert x.shape[0] * x.shape[1] * x.shape[2] % 64
    for got in (int8_gemm.quantized_conv1x1_reference(x, qw, wscale, ascale,
                                                      b, dtype),
                int8_gemm.quantized_conv1x1(x, qw, wscale, ascale, b, dtype),
                quant.fused_conv(x, qw, wscale, ascale, b, (1, 1), int8_gemm.Z,
                                 1, dtype)):
        assert got.dtype == dtype and torch.equal(got, want)


CDT = [(xd, bias, cd) for xd in FLOATS for bias in (False, True)
       for cd in FLOATS]


@pytest.mark.parametrize('case', CDT, ids=[
    f'x{DT_IDS[x]}-{"bias" if b else "nobias"}-c{DT_IDS[c]}'
    for x, b, c in CDT])
@pytest.mark.parametrize('shape', [(1, 6, 6, 16, 96), (1, 4, 9, 24, 144)],
                         ids=['M36-K16', 'M36-K24'])
def test_plain_version_in_every_dtype(shape, case):
    """M = 36 rows (a 6x6 map's), K = 16 and 24: every input dtype, with and
    without a bias, through every compute dtype."""
    dtype, bias, cdt = case
    x, qw, wscale, ascale, b = _operands(7, shape, dtype, bias)
    want = _unfused(x, qw, wscale, ascale, b, cdt)
    got = int8_gemm.quantized_conv1x1(x, qw, wscale, ascale, b, cdt)
    assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.parametrize('dtype', FLOATS, ids=DT_IDS.get)
@pytest.mark.parametrize('shape', D2_1X1, ids=[_d2_id(s) for s in D2_1X1])
def test_plan_at_the_d2_shapes(shape, dtype):
    """The launch of each D2@768 batch-8 call: an instantiated accumulator
    width holding the CTA's columns, the columns covered once, shared
    memory within a CTA's and, at two CTAs an SM, within half an SM's, no
    more CTAs than the SMs hold at once, a ring of 2-6 stages."""
    h, w, k, n, _ = shape
    m = 8 * h * w
    e = torch.tensor([], dtype=dtype).element_size()
    plan = int8_gemm.launch_plan(m, k, n, e)
    assert plan.nt in int8_gemm.NT_WIDTHS and 8 <= plan.cols <= plan.nt
    assert plan.cols % 8 == 0 and plan.col_ctas == -(-n // plan.cols)
    assert (plan.col_ctas - 1) * plan.cols < n
    assert plan.smem == int8_gemm.smem_bytes(plan.nt, plan.nwg, e,
                                             plan.stages)
    per_sm = int8_gemm.ctas_per_sm(plan.nt, plan.nwg)
    assert plan.smem <= int8_gemm.SMEM_LIMIT
    assert per_sm * (plan.smem + 1024) <= int8_gemm.SM_SMEM
    assert 2 <= plan.stages <= int8_gemm.MAX_STAGES and plan.nwg in (1, 2)
    row_tiles = -(-m // (64 * plan.nwg))
    assert 1 <= plan.row_ctas <= row_tiles
    assert plan.row_ctas * plan.col_ctas <= max(per_sm * int8_gemm.SMS,
                                                plan.col_ctas)
    assert plan.bk * e == 256


# ragged M, N and K tails: (B, H, W, K, N). Row counts past the SMs' 64-row
# tiles give wide accumulators, persistent CTAs and two warpgroups; K = 16
# and 24 pad a k32 step, 88 and 2,112 end a K-block early; N = 24, 144 and
# 2,112 leave a CTA's accumulator or the last column block part empty.
TAILS = [(1, 97, 89, 24, 144), (1, 5, 7, 16, 24), (2, 3, 7, 88, 528),
         (1, 6, 6, 2112, 352), (1, 6, 6, 352, 2112), (1, 93, 95, 48, 112),
         (3, 55, 57, 120, 720), (1, 2, 9, 112, 16), (1, 130, 130, 16, 96)]
TAIL_IDS = [f'{b * h * w}x{k}x{n}' for b, h, w, k, n in TAILS]


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32],
                         ids=['bf16', 'fp32'])
@pytest.mark.parametrize('shape', TAILS, ids=TAIL_IDS)
def test_tiled_emulation_on_ragged_tails(shape, dtype):
    """The plan walked tile by tile on the CPU (the packed weights' boxes,
    zeros past M, N and K) equals the plain version bit for bit."""
    x, qw, wscale, ascale, b = _operands(sum(shape), shape, dtype, True)
    want = int8_gemm.quantized_conv1x1_reference(x, qw, wscale, ascale, b,
                                                 torch.bfloat16)
    got = int8_gemm.quantized_conv1x1_tiled_reference(
        x, qw, wscale, ascale, b, torch.bfloat16)
    assert torch.equal(got, want)


@pytest.mark.parametrize('dtype', FLOATS, ids=DT_IDS.get)
def test_tiled_emulation_at_the_clip_limit(dtype):
    """|x / ascale| at 127.5, on half-integers and one float below them,
    and int8 weights of 127: the emulation equals the plain version, whose
    int32 sums reach 127^2 K on the clipped rows."""
    shape = (1, 93, 91, 112, 112)
    x, qw, wscale, ascale, b = _operands(3, shape, dtype, True, clip=True)
    want = int8_gemm.quantized_conv1x1_reference(x, qw, wscale, ascale, b,
                                                 dtype)
    got = int8_gemm.quantized_conv1x1_tiled_reference(x, qw, wscale, ascale,
                                                      b, dtype)
    assert torch.equal(got, want)
    qx = int8_conv._quantize(x, ascale)
    assert int(qx.abs().max()) == 127


@pytest.mark.parametrize('k,n', [(16, 24), (24, 144), (88, 528),
                                 (2112, 352)])
def test_pack_weights_is_the_core_matrix_order(k, n):
    """Weight (o, c) lies at [o / 8][c / 16][o % 8][c % 16]; the columns
    past K are zeros; unpack_piece inverts it."""
    qw = torch.from_numpy(np.random.default_rng(k + n).integers(
        -127, 128, (n, k, 1, 1)).astype(np.int8))
    p = int8_gemm.pack_weights(qw)
    k16 = -(-k // 16) * 16
    assert p.shape == (n // 8, k16 // 16, 8, 16) and p.is_contiguous()
    o, c = n - 3, k - 5
    assert p[o // 8, c // 16, o % 8, c % 16] == qw[o, c, 0, 0]
    full = int8_gemm.unpack_piece(p)
    assert torch.equal(full[:, :k], qw.reshape(n, k))
    assert not full[:, k:].any()


def test_packed_weights_are_kept_and_remade_after_a_change():
    qw = torch.ones((16, 24, 1, 1), dtype=torch.int8)
    first = int8_gemm.packed_weights(qw)
    assert int8_gemm.packed_weights(qw) is first
    qw.add_(1)
    again = int8_gemm.packed_weights(qw)
    assert again is not first and int(again[0, 0, 0, 0]) == 2


def test_wrapper_refuses_what_the_kernel_does_not_take():
    x, qw, wscale, ascale, b = _operands(1, (1, 5, 5, 16, 24),
                                         torch.bfloat16, True)
    with pytest.raises(ValueError, match='1x1'):
        int8_gemm.quantized_conv1x1(x, qw.expand(24, 16, 3, 3), wscale,
                                    ascale, b)
    with pytest.raises(ValueError, match='1x1'):
        int8_gemm.quantized_conv1x1(x[..., :12], qw[:, :12], wscale, ascale,
                                    b)
    with pytest.raises(ValueError, match='bf16, fp16 or fp32'):
        int8_gemm.quantized_conv1x1(x.double(), qw, wscale, ascale, b)


# ---- on the card

@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU and nvcc')
    return torch.device('cuda', 0)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', FLOATS, ids=DT_IDS.get)
@pytest.mark.parametrize('shape', D2_1X1, ids=[_d2_id(s) for s in D2_1X1])
def test_card_kernel_at_the_d2_shapes(shape, dtype, device):
    """The kernel at each D2@768 batch-8 call shape equals the torch
    sequence around torch._int_mm bit for bit, in each input dtype
    (computing in it), and counts one launch."""
    h, w, k, n, bias = shape
    x, qw, wscale, ascale, b = _operands(k + n, (8, h, w, k, n), dtype,
                                         bias, device)
    want = _unfused(x, qw, wscale, ascale, b, dtype)
    int8_conv.reset_launches()
    got = int8_gemm.quantized_conv1x1(x, qw, wscale, ascale, b, dtype)
    torch.cuda.synchronize()
    assert int8_conv.launches['quantized_conv1x1'] == 1
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize('case', CDT, ids=[
    f'x{DT_IDS[x]}-{"bias" if b else "nobias"}-c{DT_IDS[c]}'
    for x, b, c in CDT])
@pytest.mark.parametrize('shape', TAILS, ids=TAIL_IDS)
def test_card_kernel_on_ragged_tails(shape, case, device):
    """Every input and compute dtype, with and without a bias, on the
    ragged tails of the emulation, and at the clip limit."""
    dtype, bias, cdt = case
    for clip in (False, True):
        args = _operands(sum(shape), shape, dtype, bias, device, clip)
        got = int8_gemm.quantized_conv1x1(*args, cdt)
        torch.cuda.synchronize()
        assert torch.equal(got, _unfused(*args, cdt)), clip


@pytest.mark.cuda
def test_card_kernel_under_graph_capture(device):
    """Prepared weights, the call captured in a CUDA graph and replayed on
    new input, equal to the plain version; an unprepared weight inside a
    capture raises."""
    shape = (8, 48, 48, 112, 112)
    x, qw, wscale, ascale, b = _operands(5, shape, torch.bfloat16, True,
                                         device)
    int8_gemm.prepare([qw])
    static_x = x.clone()
    int8_gemm.quantized_conv1x1(static_x, qw, wscale, ascale, b)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = int8_gemm.quantized_conv1x1(static_x, qw, wscale, ascale, b)
    static_x.copy_(x * 0.5)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, _unfused(static_x, qw, wscale, ascale, b,
                                     torch.bfloat16))
    fresh = qw.clone()
    graph2 = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match='prepared'):
        with torch.cuda.graph(graph2):
            int8_gemm.quantized_conv1x1(static_x, fresh, wscale, ascale, b)
