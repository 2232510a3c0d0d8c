"""The port's int8 post-training quantization (quant.py) against the JAX
package's (mm_distillnet_tpu/quant.py, mirroring tests/test_quant.py).

Both packages run ONE pack (the JAX package's, carried over by
convert/weights.quant_pack_from_jax) on the same weights and inputs. Where
the fp parts of the two forwards differ by rounding, an input lying at a
rounding boundary of the quantizer may land one int8 step apart; the
model-level bounds below are what five seeds measured
(scripts/torch_quant_parity_seeds.py), with room.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from mm_distillnet_tpu import quant as jq
from mm_distillnet_tpu.config import default_config as jax_default_config
from mm_distillnet_tpu.data.synthetic import \
    SyntheticMultimodal as JaxSynthetic
from mm_distillnet_tpu.evaluation import evaluate as jax_evaluate
from mm_distillnet_tpu.models.efficientdet import EfficientDet as JaxDet
from mm_distillnet_tpu.models.efficientnet import \
    EfficientNetFeatures as JaxFeatures
from mm_distillnet_tpu.models.efficientnet import MBConvBlock as JaxMBConv
from mm_distillnet_tpu.ops.resize import maybe_stretch_mel_axis as jax_stretch
from mm_distillnet_tpu.serving import make_serving_fn as jax_serving_fn
from mm_distillnet_torch import evaluation, quant
from mm_distillnet_torch.config import default_config
from mm_distillnet_torch.convert.weights import (port_module_name,
                                                 quant_pack_from_jax,
                                                 state_dict_from_flax)
from mm_distillnet_torch.data.synthetic import SyntheticMultimodal
from mm_distillnet_torch.evaluation import evaluate
from mm_distillnet_torch.models.efficientdet import EfficientDet
from mm_distillnet_torch.models.efficientnet import (BlockArgs,
                                                     EfficientNetFeatures,
                                                     MBConvBlock)
from mm_distillnet_torch.models.layers import Conv2dSame, same_pad_amounts
from mm_distillnet_torch.serving import make_serving_fn

from .test_torch_evaluation import CHANNELS, COLUMNS, PARITY_ATOL, SETTINGS
from .test_torch_helpers import (as_jax_args, filled_variables, nhwc_input,
                                 to_jax)
from .test_torch_helpers import one_torch_thread  # noqa: F401

# torch on one thread: the suite runs several workers on a few cores
pytestmark = pytest.mark.usefixtures('one_torch_thread')

# Measured over seeds 0-4 (scripts/torch_quant_parity_seeds.py, on a
# CPU): the share of int8 conv inputs that differ and the
# outputs' largest relative L2, per model and compute dtype of the
# quantized convs. Most seeds give no flip at all; one flip on a rounding
# boundary (fp32 rounding differs between XLA and torch) cascades through
# the later convs of that forward (seed 0: 1.6e-3 to 4.4e-3 of the
# inputs). Bounds: about twice the largest reading.
#   backbone fp32 1.62e-3 / 2.29e-3, bf16 2.96e-3 / 2.60e-3;
#   detector fp32 4.35e-3 / 3.85e-3, bf16 2.92e-6 / 7.97e-8.
INT8_FLIP_SHARE = {('backbone', 'float32'): 4e-3,
                   ('backbone', 'bfloat16'): 6e-3,
                   ('detector', 'float32'): 1e-2,
                   ('detector', 'bfloat16'): 1e-5}
OUTPUT_REL_L2 = {('backbone', 'float32'): 5e-3,
                 ('backbone', 'bfloat16'): 6e-3,
                 ('detector', 'float32'): 8e-3,
                 ('detector', 'bfloat16'): 2e-7}
# The quantized evaluate() against the JAX one run op by op, both on the
# JAX evaluate()'s pack, over seeds 0-4 (scripts/torch_quant_parity_seeds.py,
# torch on one thread): the student's outputs inside evaluate() within
# 7.8e-8 relative L2 of the JAX quantized_apply, but for seed 4, where one
# int8 value flips at a rounding boundary (3.39e-3); the AP table equal
# at seeds 0-3, and at seed 4 AP@Ave 0.0071 and AP@0.5 0.0213 points
# apart. Bounds about twice that; a column that never moved keeps the
# fp32 evaluate's PARITY_ATOL. With each package calibrating its own pack
# (printed, not gated) the tables differ by up to 1.02 AP@0.5 points: the
# absmax of a conv's input differs by an ulp, and every int8 value of
# that conv moves with its scale.
EVAL_FORWARD_REL_L2 = 7e-3
EVAL_ATOL = {'AP@Ave': 0.015, 'AP@0.5': 0.05, 'AP@0.75': PARITY_ATOL,
             'CDx': PARITY_ATOL, 'CDy': PARITY_ATOL}
DTYPES = {'float32': (jnp.float32, torch.float32),
          'bfloat16': (jnp.bfloat16, torch.bfloat16)}


class _Backbone(torch.nn.Module):
    """The port's backbone under the detector's name, so that its modules
    carry the names `quant_pack_from_jax` gives the JAX paths."""

    def __init__(self):
        super().__init__()
        self.backbone_net = EfficientNetFeatures(-1, 3)

    def forward(self, x):
        return [f.permute(0, 2, 3, 1)
                for f in self.backbone_net(x.permute(0, 3, 1, 2))]


def _nest(v, name):
    return {c: {name: t} for c, t in v.items()}


@functools.lru_cache(maxsize=None)
def _networks(kind, seed):
    """(JAX module, variables, port module, input): 'backbone' is the
    test-tiny EfficientNet at 64 px (3 channels), 'detector' the test-tiny
    EfficientDet at 128 px (8 channels), fp32 both."""
    if kind == 'backbone':
        jmod = JaxFeatures(compound_coef=-1, dtype=jnp.float32)
        x = (np.random.default_rng(seed).random((2, 64, 64, 3)) * 2 - 1
             ).astype(np.float32)
        v = filled_variables(jmod, seed, x, train=False)
        port = _Backbone()
        port.load_state_dict(state_dict_from_flax(_nest(v, 'backbone_net')))
    else:
        jmod = JaxDet(num_classes=20, compound_coef=-1, dtype=jnp.float32)
        x = nhwc_input(seed, (2, 128, 128, 8))
        v = filled_variables(jmod, seed, x)
        port = EfficientDet(20, -1, 8)
        port.load_state_dict(state_dict_from_flax(v))
    return jmod, v, port.eval(), x


def _jax_pack(jmod, v, x, policy=jq.QuantPolicy()):
    return jq.build_quant_pack(jmod, to_jax(v), jnp.asarray(x), [x], policy,
                               train=False)


def _prefixed(pack, prefix):
    """The JAX pack with `prefix` before every path."""
    return jq.QuantPack(*({prefix + k: t for k, t in d.items()}
                          for d in pack))


def _outputs(kind, out):
    if kind == 'backbone':
        return [np.asarray(o, np.float32) for o in out]
    return [np.asarray(getattr(out, f), np.float32)
            for f in ('classification', 'regression')]


def measure_parity(kind: str, seed: int, dtype: str):
    """One pack, two forwards: (share of int8 conv inputs that differ,
    largest relative L2 over the outputs), the JAX quantized_apply at
    compute dtype `dtype` against the port's."""
    jdtype, tdtype = DTYPES[dtype]
    jmod, v, port, x = _networks(kind, seed)
    # the bare JAX backbone's paths lack the detector's 'backbone_net'
    prefix = 'backbone_net/' if kind == 'backbone' else ''
    jpack = _jax_pack(jmod, v, x)
    specs = quant.collect_conv_specs(port, x)
    pack = quant_pack_from_jax(_prefixed(jpack, prefix), specs)

    jax_inputs = {}

    def capture(next_fun, args, kwargs, context):
        mod = context.module
        if isinstance(mod, nn.Conv) and context.method_name == '__call__':
            path = jq._path_str(mod)
            if path in jpack.qkernels:
                jax_inputs.setdefault(port_module_name(prefix + path),
                                      []).append(np.asarray(args[0],
                                                            np.float32))
        return next_fun(*args, **kwargs)

    with nn.intercept_methods(capture):
        want = jq.quantized_apply(jmod, to_jax(v), jpack, jnp.asarray(x),
                                  compute_dtype=jdtype, train=False)

    port_inputs = {}
    saved = quant.quantized_conv

    def recording(conv, inp, qkernel, wscale, ascale, *rest):
        name = next(n for n, q in pack.qkernels.items() if q is qkernel)
        port_inputs.setdefault(name, []).append(
            (inp.permute(0, 2, 3, 1).float().numpy(), conv.stride[0],
             conv.kernel_size[0]))
        return saved(conv, inp, qkernel, wscale, ascale, *rest)

    quant.quantized_conv = recording
    try:
        got = quant.quantized_apply(port, pack, torch.from_numpy(x),
                                    compute_dtype=tdtype)
    finally:
        quant.quantized_conv = saved

    flips = total = 0
    assert set(port_inputs) == set(jax_inputs) == set(pack.qkernels)
    for name, calls in port_inputs.items():
        sx = np.float32(pack.ascales[name])
        assert len(calls) == len(jax_inputs[name])
        for (a, stride, k), b in zip(calls, jax_inputs[name]):
            # the port's conv sees the TF-SAME padded input
            pt, _ = same_pad_amounts(b.shape[1], stride, k)
            pl, _ = same_pad_amounts(b.shape[2], stride, k)
            a = a[:, pt:pt + b.shape[1], pl:pl + b.shape[2]]
            qa = np.clip(np.round(a / sx), -127, 127)
            qb = np.clip(np.round(b / sx), -127, 127)
            flips += int((qa != qb).sum())
            total += qa.size
    rel = max(float(np.linalg.norm(g - w) / np.linalg.norm(w))
              for g, w in zip(_outputs(kind, got), _outputs(kind, want)))
    return flips / total, rel


def measure_evaluate(offset: int) -> dict:
    """evaluate() with quant_inference=True in both packages, at
    tests/test_torch_evaluation.py's settings (three teachers, the 'ALL'
    testing point, six synthetic frames with the compact audio ingest),
    the weight seeds moved by `offset`, the JAX one op by op. The port's
    evaluate() runs twice: with its own calibration ('own_pack') and with
    the pack the JAX evaluate() calibrated ('one_pack'). Returns |port -
    JAX| per column of each run's table, and 'forward_rel_l2': the largest
    relative L2 of the one-pack run's student outputs, taken inside
    evaluate(), against the JAX quantized_apply (eager) of that pack on
    the same inputs; the student's inputs there must equal the JAX
    stretched test frames."""
    nets = {}
    for seed, (m, ch) in enumerate(CHANNELS.items()):
        jmod = JaxDet(num_classes=20, compound_coef=-1, dtype=jnp.float32)
        v = filled_variables(jmod, 10 + seed + offset,
                             nhwc_input(0, (1, 128, 128, ch)))
        nets[m] = (jmod, v, EfficientDet(20, -1, ch),
                   state_dict_from_flax(v))
    settings = dict(SETTINGS, quant_inference=True)
    jcfg = jax_default_config(exp_name='quant-jax', **settings)
    tcfg = default_config(exp_name='quant-torch', **settings)
    teachers = ('rgb', 'thermal', 'depth')
    jax_set = JaxSynthetic(jcfg, 'test')
    jax_packs = []
    jax_build = jq.build_quant_pack

    def recording(*args, **kwargs):
        jax_packs.append(jax_build(*args, **kwargs))
        return jax_packs[-1]

    jq.build_quant_pack = recording
    try:
        # op by op: XLA's fusions under jit round the fp32 parts of the
        # quantized forward and of the calibration differently, which flips
        # int8 values (AP@0.5 up to 1.7 points apart at one seed of five)
        with jax.disable_jit():
            want = jax_evaluate(
                {m: (nets[m][0], to_jax(nets[m][1])) for m in teachers},
                (nets['audio'][0], to_jax(nets['audio'][1])), jax_set, jcfg)
    finally:
        jq.build_quant_pack = jax_build
    assert len(jax_packs) == 1

    def port_evaluate():
        got = evaluate({m: (nets[m][2], nets[m][3]) for m in teachers},
                       (nets['audio'][2], nets['audio'][3]),
                       SyntheticMultimodal(tcfg, 'test'), tcfg,
                       device='cpu')
        assert list(got[0]) == COLUMNS
        return {c: abs(got[0][c] - float(want[c][0])) for c in COLUMNS[2:]}

    def the_jax_pack(net, calib, batches, **kwargs):
        return quant_pack_from_jax(jax_packs[0],
                                   quant.collect_conv_specs(net, calib))

    student = []

    def recorded_apply(net, pack, x, **kwargs):
        out = own_apply(net, pack, x, **kwargs)
        student.append((x.numpy().copy(), out))
        return out

    gaps = {'own_pack': port_evaluate()}
    own_build, own_apply = evaluation.build_quant_pack, \
        evaluation.quantized_apply
    evaluation.build_quant_pack = the_jax_pack
    evaluation.quantized_apply = recorded_apply
    try:
        gaps['one_pack'] = port_evaluate()
    finally:
        evaluation.build_quant_pack = own_build
        evaluation.quantized_apply = own_apply

    frames = np.stack([np.asarray(jax_set[i]['audio'])
                       for i in range(len(jax_set))])
    np.testing.assert_array_equal(
        np.concatenate([x for x, _ in student]),
        np.asarray(jax_stretch(jnp.asarray(frames), SETTINGS['image_size'])))
    rel = []
    for x, out in student:
        ref = jq.quantized_apply(nets['audio'][0], to_jax(nets['audio'][1]),
                                 jax_packs[0], jnp.asarray(x), train=False)
        for f in ('classification', 'regression'):
            w = np.asarray(getattr(ref, f), np.float32)
            rel.append(float(np.linalg.norm(getattr(out, f).numpy() - w)
                             / np.linalg.norm(w)))
    gaps['forward_rel_l2'] = max(rel)
    return gaps


@pytest.mark.parametrize('groups,features,bias', [(1, 8, True),
                                                  (4, 4, False)])
def test_quantized_conv_matches_numpy_int8_math(groups, features, bias):
    """One 3x3 stride-2 conv: the port's int8 path equals an int64 numpy
    derivation of the same static symmetric scheme exactly (fp32 compute:
    the epilogue's products and sums are single fp32 operations)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 9, 4)).astype(np.float32)
    conv = Conv2dSame(4, features, 3, 2, groups=groups, bias=bias)
    with torch.no_grad():
        conv.conv.weight.copy_(torch.from_numpy(rng.standard_normal(
            tuple(conv.conv.weight.shape)).astype(np.float32) * 0.3))
    model = torch.nn.Sequential(conv)
    nchw = torch.from_numpy(x).permute(0, 3, 1, 2)
    pack = quant.build_quant_pack(model, nchw, [nchw])
    assert list(pack.qkernels) == ['0.conv']
    got = quant.quantized_apply(model, pack, nchw,
                                compute_dtype=torch.float32)
    got = got.permute(0, 2, 3, 1).numpy()

    sx = np.float32(pack.ascales['0.conv'])
    qx = np.clip(np.round(x / sx), -127, 127).astype(np.int64)
    qw = pack.qkernels['0.conv'].numpy().astype(np.int64)    # OIHW
    sw = pack.wscales['0.conv'].numpy()
    xp = np.pad(qx, ((0, 0), (1, 1), (1, 1), (0, 0)))   # TF-SAME 9/2/3
    cin_g = 4 // groups
    acc = np.zeros(got.shape, np.int64)
    for o in range(features):
        g = o // (features // groups)
        for i in range(got.shape[1]):
            for j in range(got.shape[2]):
                patch = xp[:, 2 * i:2 * i + 3, 2 * j:2 * j + 3,
                           g * cin_g:(g + 1) * cin_g]
                acc[:, i, j, o] = np.sum(
                    patch * qw[o].transpose(1, 2, 0)[None], axis=(1, 2, 3))
    want = acc.astype(np.float32) * (sx * sw)
    if bias:
        want = want + conv.conv.bias.detach().numpy()
    np.testing.assert_array_equal(got, want)


class _OneConv1x1(nn.Module):
    """One 1x1 conv with a bias: the 'int_mm' route's single call."""
    features: int

    @nn.compact
    def __call__(self, x):
        return nn.Conv(self.features, (1, 1), use_bias=True, name='conv')(x)


ONE_1X1 = [(k, n, dt) for k, n in ((16, 96), (24, 144), (112, 112),
                                   (352, 2112))
           for dt in ('float32', 'bfloat16')]


@pytest.mark.parametrize('k,n,dtype', ONE_1X1,
                         ids=[f'{k}-{n}-{d}' for k, n, d in ONE_1X1])
def test_one_1x1_conv_under_one_pack_matches_jax(k, n, dtype):
    """A one-conv 1x1 flax module through the JAX package's
    quantized_apply, and its pack through the port's fused 1x1 wrapper
    (int8_gemm.quantized_conv1x1, the plain version on the CPU): the same
    values, bit for bit, in both compute dtypes (the JAX ops run one by
    one, so no fusion rounds differently)."""
    from mm_distillnet_torch.ops import int8_gemm
    jdtype, tdtype = DTYPES[dtype]
    jmod = _OneConv1x1(n)
    x = nhwc_input(k + n, (2, 7, 9, k)) * 3.0
    v = filled_variables(jmod, k + n, x)
    jpack = jq.build_quant_pack(jmod, to_jax(v), jnp.asarray(x), [x])
    (path,) = jpack.qkernels
    want = jq.quantized_apply(jmod, to_jax(v), jpack, jnp.asarray(x),
                              compute_dtype=jdtype)
    qw = torch.from_numpy(np.ascontiguousarray(np.asarray(
        jpack.qkernels[path], np.int8).transpose(3, 2, 0, 1)))
    got = int8_gemm.quantized_conv1x1(
        torch.from_numpy(x), qw,
        torch.from_numpy(np.asarray(jpack.wscales[path], np.float32).copy()),
        torch.tensor(np.float32(jpack.ascales[path])),
        torch.from_numpy(np.asarray(v['params']['conv']['bias'])), tdtype)
    assert got.dtype == torch.float32 and got.shape == (2, 7, 9, n)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_policy_selects_the_jax_set():
    """The port's policy picks the JAX policy's convs (mapped to the port's
    names), on one MBConv block and on the detector, with and without the
    depthwise convs; the SE convs and the header pointwise stay fp."""
    args = BlockArgs(3, 1, 8, 8, 6, 1)
    x = nhwc_input(0, (1, 16, 16, 8))
    jblock = JaxMBConv(as_jax_args(args), dtype=jnp.float32)
    v = filled_variables(jblock, 0, x)
    specs = quant.collect_conv_specs(
        torch.nn.Sequential(MBConvBlock(args)).eval(),
        torch.from_numpy(x).permute(0, 3, 1, 2))
    assert set(specs) == {'0._expand_conv.conv', '0._depthwise_conv.conv',
                          '0._project_conv.conv'}
    assert specs['0._depthwise_conv.conv']['groups'] == 48
    assert specs['0._expand_conv.conv']['kernel_size'] == (1, 1)
    assert specs['0._depthwise_conv.conv']['kernel_size'] == (3, 3)

    jmod, v, port, x = _networks('detector', 0)
    for dw in (True, False):
        jspecs = jq.collect_conv_specs(
            jmod, to_jax(v), jnp.asarray(x),
            jq.QuantPolicy(quantize_depthwise=dw), train=False)
        pspecs = quant.collect_conv_specs(
            port, x, quant.QuantPolicy(quantize_depthwise=dw))
        assert {port_module_name(p) for p in jspecs} == set(pspecs)
        assert not any('header.pointwise_conv' in p or '_se_' in p
                       for p in pspecs)
        assert any('header.depthwise_conv' in p for p in pspecs) == dw
    assert not quant.QuantPolicy().wants('classifier.header.pointwise_conv'
                                         '.conv', 1)
    assert not quant.QuantPolicy().wants('_blocks.3._se_reduce.conv', 1)


def test_quantize_weights_is_bit_equal():
    jmod, v, port, x = _networks('detector', 1)
    jspecs = jq.collect_conv_specs(jmod, to_jax(v), jnp.asarray(x),
                                   train=False)
    jk, jw = jq.quantize_weights(to_jax(v), jspecs)
    pk, pw = quant.quantize_weights(state_dict_from_flax(v),
                                    quant.collect_conv_specs(port, x))
    assert len(pk) == len(jk) > 20
    for path in jk:
        name = port_module_name(path)
        np.testing.assert_array_equal(
            pk[name].numpy(), np.asarray(jk[path]).transpose(3, 2, 0, 1))
        assert pw[name].dtype == torch.float32
        np.testing.assert_array_equal(pw[name].numpy(), np.asarray(jw[path]))


def test_calibration_keeps_the_shared_head_overwrite():
    """Each shared head conv keeps the absmax of its last call in a batch
    (P7's), as the JAX package's calibration does, not the largest over the
    five levels; across batches the maximum is taken. The port's absmax
    matches the JAX one conv for conv."""
    jmod, v, port, x = _networks('detector', 2)
    x2 = x * 2.0
    want = jq.calibrate_activations(jmod, to_jax(v), [x, x2], train=False)
    got = quant.calibrate_activations(port, [x, x2])
    assert {port_module_name(p) for p in want} == set(got)
    for path, a in want.items():
        assert got[port_module_name(path)] == pytest.approx(a, rel=1e-5)

    every_call = {}

    def call(path, conv, inp):
        every_call.setdefault(path, []).append(float(inp.abs().max()))
        return quant.conv_forward(conv, inp)

    with torch.no_grad(), quant._intercepted(port, call):
        port(torch.from_numpy(x2))
    one = quant.calibrate_activations(port, [x2])
    head = 'classifier.conv_list.0.depthwise_conv.conv'
    assert len(every_call[head]) == 5       # one call per pyramid level
    assert one[head] == every_call[head][-1]
    assert one[head] < max(every_call[head])
    assert got[head] == max(quant.calibrate_activations(port, [x])[head],
                            one[head])


@pytest.mark.parametrize('kind,dtype', [('backbone', 'float32'),
                                        ('backbone', 'bfloat16'),
                                        ('detector', 'float32'),
                                        ('detector', 'bfloat16')])
def test_model_under_one_pack_matches_jax(kind, dtype):
    flips, rel = measure_parity(kind, 0, dtype)
    print(f'{kind} {dtype}: int8 flips {flips:.3g}, rel L2 {rel:.3g}')
    assert flips <= INT8_FLIP_SHARE[kind, dtype]
    assert rel <= OUTPUT_REL_L2[kind, dtype]


def test_unpacked_convs_fall_through():
    """A conv missing from the pack runs its fp forward, and leaving the
    context restores every conv's own forward."""
    model = torch.nn.Sequential(Conv2dSame(4, 8, 3, 2)).eval()
    x = torch.from_numpy(nhwc_input(0, (1, 8, 8, 4))).permute(0, 3, 1, 2)
    empty = quant.QuantPack({}, {}, {})
    got = quant.quantized_apply(model, empty, x, compute_dtype=torch.float32)
    with torch.no_grad():
        torch.testing.assert_close(got, model(x), rtol=0, atol=0)
    assert 'forward' not in vars(model[0].conv)


def test_serving_fn_quantized_matches_jax():
    """make_serving_fn(quant_pack=) on one pack in both packages, fp32
    models, the default bf16 compute of the quantized convs."""
    jmod, v, port, x = _networks('detector', 3)
    kw = dict(num_classes=20, valid_prediction_ids=[0, 1, 2, 3, 6],
              num_candidates=64, max_detections=16)
    jpack = _jax_pack(jmod, v, x)
    want = jax_serving_fn(jmod, to_jax(v), 128, quant_pack=jpack,
                          **kw)(jnp.asarray(x))
    pack = quant_pack_from_jax(jpack, quant.collect_conv_specs(port, x))
    got = make_serving_fn(EfficientDet(20, -1, 8), state_dict_from_flax(v),
                          128, quant_pack=pack, dtype=torch.float32,
                          device='cpu', **kw)(x)
    assert got.valid.any()
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.classes.numpy(),
                                  np.asarray(want.classes))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes),
                               atol=1e-3)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               atol=1e-5)


def test_evaluate_quantized_matches_jax(tmp_path, monkeypatch):
    """evaluate() with quant_inference=True: the int8 pack calibrated on
    the first frames, then the student's predictions through it, against
    the JAX evaluate() (eval_devices=1) run op by op. The gate runs the
    JAX evaluate()'s pack in both and holds the student's outputs inside
    evaluate() and the AP table; the port's own calibration differs from
    the JAX one by an ulp of absmax, which flips int8 values and reorders
    the detections of a random-weight student, so its gaps are printed,
    not gated."""
    monkeypatch.chdir(tmp_path)
    gaps = measure_evaluate(0)
    print(f'evaluate gaps: {gaps}')
    assert gaps['forward_rel_l2'] <= EVAL_FORWARD_REL_L2
    for col, gap in gaps['one_pack'].items():
        assert gap <= EVAL_ATOL[col], (col, gap)
