"""The benchmark's own arithmetic: the FLOP and byte counter against hand
counts, the statistics and the interval arithmetic of the trace."""
import re
import statistics

import pytest
import torch

from benchmark import flops
from benchmark.common import Trace, gaps, percentile, union_length
from benchmark.reference.efficientnet import BlockArgs


def test_mbconv_block_against_a_hand_count():
    # D2's block 1 at 768 px: 3x3 depthwise, stride 2, 16 -> 24, expand 6
    args = BlockArgs(3, 1, 16, 24, 6, 2, 0.25, True)
    b, h = 2, 384
    ce, cs, ho = 96, 4, 192
    macs = (b * h * h * 16 * ce            # expand 1x1
            + b * ho * ho * ce * 9         # depthwise 3x3
            + b * 2 * ce * cs              # SE reduce and expand
            + b * ho * ho * ce * 24)       # project 1x1
    weights = (16 * ce + ce) + (9 * ce + ce) + (2 * ce * cs + cs + ce) \
        + (ce * 24 + 24)
    nbytes = 2 * (b * h * h * 16 + b * ho * ho * 24 + weights)
    assert flops.mbconv_cost(args, b, h, h) == (2 * macs, nbytes)


def test_mbconv_block_without_expansion():
    args = BlockArgs(3, 1, 32, 16, 1, 1, 0.25, True)
    macs = 4 * 4 * 32 * 9 + 4 * 4 * 32 * 16 + 2 * 32 * 8
    weights = 32 * 9 + 32 + 2 * 32 * 8 + 8 + 32 + 32 * 16 + 16
    assert flops.mbconv_cost(args, 1, 4, 4) == \
        (2 * macs, 2 * (16 * 32 + 16 * 16 + weights))


def test_d2_has_23_blocks_and_a_bound_that_grows_with_the_batch():
    blocks = flops.mbconv_blocks(2, 768)
    assert len(blocks) == 23
    assert blocks[0][1] == 384 and blocks[-1][1] == 24
    one, eight = flops.mbconv_bound_s(2, 768, 1), flops.mbconv_bound_s(
        2, 768, 8)
    assert one < eight < 8 * one


def test_bifpn_node_against_a_hand_count():
    # one BiFPN node of D2 (112 channels) on a 12x12 map: a depthwise 3x3
    # and a pointwise 112 x 112, the separable convolution of each node
    from benchmark.reference.layers import SeparableConvBlock
    node = SeparableConvBlock(112, 112, norm=True, activation=False)
    total = []
    for m in node.modules():
        if isinstance(m, torch.nn.Conv2d):
            m.register_forward_hook(
                lambda mod, _i, out: total.append(flops.conv_flops(mod, out)))
    node(torch.zeros(1, 112, 12, 12))
    assert sum(total) == 2 * (12 * 12 * 112 * 9 + 12 * 12 * 112 * 112)


def test_d2_forward_is_about_eleven_billion_multiply_adds():
    # the paper's 11B FLOPs for D2 are multiply-adds (Table 2)
    fwd = flops.forward_flops(2, 20, 3, 1, 768)
    assert 2 * 9.5e9 < fwd < 2 * 11.5e9
    assert flops.forward_flops(2, 20, 3, 4, 768) == 4 * fwd


def test_percentile_matches_linear_interpolation():
    xs = [5.0, 1.0, 4.0, 2.0, 3.0]
    assert percentile(xs, 50) == 3.0
    assert percentile(xs, 95) == pytest.approx(4.8)
    assert percentile(xs, 100) == 5.0
    assert percentile([7.0], 95) == 7.0
    many = [float(i) for i in range(101)]
    assert percentile(many, 95) == 95.0
    assert statistics.quantiles(many, n=100,
                                method='inclusive')[94] == 95.0


def test_interval_union_and_gaps():
    spans = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.7)]
    assert union_length(spans) == 4.0
    assert gaps(spans, -1.0, 8.0) == [(-1.0, 0.0), (3.0, 5.0), (6.0, 8.0)]
    assert gaps([], 0.0, 1.0) == [(0.0, 1.0)]


def test_trace_readings():
    kernels = [('expand_dw_kernel<1>', 0.0, 1.0), ('se_kernel', 0.5, 1.5),
               ('gemm', 2.0, 3.0)]
    host = [('aten::nonzero', 1.4, 2.1), ('aten::outer', 1.0, 2.5)]
    t = Trace(kernels, host, (0.0, 4.0))
    assert t.launches == 3
    assert t.busy_s() == 2.5
    assert t.busy_s(re.compile(r'\b(expand_dw_kernel|se_kernel)\b')) == 1.5
    assert t.idle_gaps() == [['no host operator', 1.0],
                             ['aten::nonzero', 0.5]]
    assert t.device_ops()[0] == ['expand_dw_kernel<1>', 1.0]


@pytest.mark.parametrize('kind', ['train', 'serve'])
def test_shares_read_the_untraced_window(kind):
    from benchmark.common import metric_reader
    # 2 traced calls busy 0.3 s in all, the untraced window 10 calls in 5 s
    trace = Trace([('k', 0.0, 0.1), ('k', 1.0, 1.2)], [], (0.0, 4.0))
    flop = 10 * 1e12
    run = {'trace': trace, 'counters': {'calls': 2, 'model_flops': 2e12},
           'window': {'seconds': 5.0,
                      'counters': {'calls': 10, 'model_flops': flop}}}
    idle = metric_reader(f'device_idle_share.{kind}').read(run)
    assert idle == pytest.approx(1 - 0.15 / 0.5)
    mfu = metric_reader(f'mfu.{kind}').read(run)
    assert mfu == pytest.approx(100 * flop / 5.0
                                / flops.PEAKS['bf16_flops_per_s'])
    assert metric_reader(f'mfu.{kind}').read(dict(run, window=None)) is None
