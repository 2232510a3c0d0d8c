"""The served predictor's CUDA graphs (serving.py `_Graphs`: one graph a
key, replayed at every call) against the eager sequence of the same
predictor, on a card. Every test here is marked `cuda` and skips without
an NVIDIA GPU.

This file imports torch and the port only, so it collects wherever the
port runs:

    python -m pytest tests/test_torch_serving_graph.py -q --noconftest

The predictors keep every class and no confidence floor, so that all 512
candidates reach the NMS kernel whatever the seeded weights score.
"""
import re

import pytest
import torch

from mm_distillnet_torch.models.efficientdet import EfficientDet
from mm_distillnet_torch.models.fused_forward import eval_module
from mm_distillnet_torch.ops import fused_mbconv as fm
from mm_distillnet_torch.ops import int8_conv, nms
from mm_distillnet_torch.quant import build_quant_pack
from mm_distillnet_torch.serving import export_predictor, make_serving_fn

pytestmark = pytest.mark.cuda

SIZE = 256          # D2's last map is then 8x8, the project kernel's least
MEL = 80            # compact-audio rows, stretched on the card
MODELS = {'tiny': -1, 'd2': 2}
KW = dict(conf_threshold=0.0, valid_prediction_ids=list(range(20)))
# each launch counter's kernels by their names in a device trace
KERNELS = {'mbconv_expand_dw': re.compile(r'\b(expand_dw|dw_only)_kernel\b'),
           'mbconv_se': re.compile(r'\bse_kernel\b'),
           'mbconv_project': re.compile(r'\bproject_kernel\b'),
           'nms_fixed': re.compile(r'\bnms_kernel\b'),
           'quantized_conv2d': re.compile(r'\b(dw|stem|general)_kernel\b'),
           'quantized_conv1x1': re.compile(r'\bconv1x1_kernel\b')}


@pytest.fixture(scope='module')
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU and nvcc')
    return torch.device('cuda', 0)


def _model(name):
    torch.manual_seed(0)
    return EfficientDet(20, MODELS[name], 8).eval()


def _predictor(name, kind, card, **kw):
    """A fresh fused or int8 (`quant_pack`) predictor of model `name`."""
    model = _model(name)
    sd = model.state_dict()
    pack = None
    if kind == 'int8':
        g = torch.Generator(device=card).manual_seed(9)
        calib = torch.randn((4, SIZE, SIZE, 8), generator=g, device=card)
        net = eval_module(model, sd, card, torch.bfloat16)
        pack = build_quant_pack(net, calib, [calib], state_dict=sd)
    return make_serving_fn(model, sd, SIZE, quant_pack=pack, device=card,
                           **KW, **kw)


def _frames(seed, batch, card, rows=MEL):
    g = torch.Generator(device=card).manual_seed(seed)
    return torch.randn((batch, rows, SIZE, 8), generator=g, device=card)


def _eager(serve, x):
    with torch.no_grad():
        return serve.run(x)


def _equal(got, want):
    for field, a, b in zip(got._fields, got, want):
        assert torch.equal(a, b), field


def _counts():
    return {**fm.launches, **nms.launches, **int8_conv.launches}


def _reset():
    fm.reset_launches()
    nms.reset_launches()
    int8_conv.reset_launches()


def _traced(fn) -> dict:
    """The hand-written kernels that ran on the card in fn(), by their
    names in a device trace (a graph's replayed kernels included)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    return {k: sum(bool(p.search(n)) for n in names)
            for k, p in KERNELS.items()}


@pytest.mark.parametrize('kind', ['fused', 'int8'])
@pytest.mark.parametrize('name', list(MODELS))
def test_replays_equal_the_eager_sequence(name, kind, card):
    """Three distinct inputs at B 1 and at B 8: each replay's Detections
    equal the eager sequence's bit for bit; one capture a batch."""
    serve = _predictor(name, kind, card)
    for batch in (1, 8):
        for seed in range(3):
            x = _frames(100 * batch + seed, batch, card)
            got = serve(x)
            torch.cuda.synchronize()
            _equal(got, _eager(serve, x))
            assert got.valid.any()
    assert (serve.captures, serve.replays) == (2, 6)


def test_a_call_keeps_its_detections_after_the_next(card):
    """Call i's tensors are its own: call i + 1 on other frames leaves
    them as they were, and they differ from call i + 1's."""
    serve = _predictor('tiny', 'fused', card)
    first = serve(_frames(1, 2, card))
    kept = [t.clone() for t in first]
    second = serve(_frames(2, 2, card))
    torch.cuda.synchronize()
    for a, b in zip(first, kept):
        assert torch.equal(a, b)
    assert not torch.equal(first.boxes, second.boxes)
    assert first.boxes.data_ptr() != second.boxes.data_ptr()


def test_a_second_shape_makes_a_second_capture(card):
    """A full-size input after a compact one is a second key, captured
    into the same memory pool; both keys replay in turn, and each replay
    equals the eager sequence."""
    serve = _predictor('tiny', 'fused', card)
    a, b = _frames(3, 2, card), _frames(4, 2, card, rows=SIZE)
    _equal(serve(a), _eager(serve, a))
    assert (serve.captures, serve.replays) == (1, 1)
    _equal(serve(b), _eager(serve, b))
    assert (serve.captures, serve.replays) == (2, 2)
    a2 = _frames(5, 2, card)
    _equal(serve(a2), _eager(serve, a2))
    assert (serve.captures, serve.replays) == (2, 3)
    b2 = _frames(6, 2, card, rows=SIZE)
    _equal(serve(b2), _eager(serve, b2))
    assert (serve.captures, serve.replays) == (2, 4)
    assert len(serve.replicas[0].graphs.graphs) == 2


@pytest.mark.parametrize('kind', ['fused', 'int8'])
def test_counters_count_launches_a_trace_counts_replays(kind, card):
    """The kernels' counters count what their wrappers launch: a key's
    first call two calls' worth (the eager pass and the capture), a
    replay nothing. A device trace of each replay holds every hand-written
    kernel as often as the eager call launches it."""
    serve = _predictor('d2', kind, card)
    x = _frames(6, 1, card)
    _reset()
    _eager(serve, x)
    torch.cuda.synchronize()
    per_call = _counts()
    if kind == 'fused':
        assert per_call == {**{k: 23 for k in fm.launches}, 'nms_fixed': 1,
                            **{k: 0 for k in int8_conv.launches}}
    else:
        assert not any(per_call[k] for k in fm.launches)
        assert per_call['nms_fixed'] == 1
        assert per_call['quantized_conv2d'] and \
            per_call['quantized_conv1x1']
    eager = _traced(lambda: _eager(serve, x))
    assert eager == {k: per_call[k] for k in KERNELS}
    _reset()
    serve(x)
    torch.cuda.synchronize()
    assert _counts() == {k: 2 * n for k, n in per_call.items()}
    assert (serve.captures, serve.replays) == (1, 1)
    for calls in (2, 3):
        _reset()
        assert _traced(lambda: serve(x)) == eager
        assert not any(_counts().values())
        assert (serve.captures, serve.replays) == (1, calls)


def test_export_after_replays_writes_the_same_program(card, monkeypatch):
    """export_predictor traces the eager sequence: a predictor that has
    replayed writes the op list of a fresh one, and the export neither
    captures nor replays."""
    saved = []
    monkeypatch.setattr(torch.export, 'save',
                        lambda program, path: saved.append(program))

    def targets(program):
        return [str(n.target) for n in program.graph.nodes
                if n.op == 'call_function']

    fresh = _predictor('tiny', 'fused', card)
    export_predictor(fresh, 1, SIZE, 8, 'unused.pt2')
    used = _predictor('tiny', 'fused', card)
    x = torch.randn((1, SIZE, SIZE, 8), device=card)
    for _ in range(2):
        used(x)
    export_predictor(used, 1, SIZE, 8, 'unused.pt2')
    assert (fresh.captures, fresh.replays) == (0, 0)
    assert (used.captures, used.replays) == (1, 2)
    assert targets(saved[0]) and targets(saved[0]) == targets(saved[1])
    assert any('mbconv' in t for t in targets(saved[1]))


@pytest.mark.parametrize('replicas', [1, 2])
def test_a_mesh_over_one_card_replays(replicas, card):
    """make_serving_fn over (card,) and (card, card): each replica
    captures its own graph, and the gathered Detections equal the eager
    sequence of a one-card predictor on each replica's rows."""
    model = _model('tiny')
    sd = model.state_dict()
    mesh = (card,) * replicas
    sharded = make_serving_fn(model, sd, SIZE, mesh=mesh, **KW)
    single = make_serving_fn(model, sd, SIZE, device=card, **KW)
    x = _frames(7, 2, card)
    for _ in range(2):
        got = sharded(x)
    torch.cuda.synchronize()
    assert (sharded.captures, sharded.replays) == (replicas, 2 * replicas)
    assert got.valid.device == card and got.valid.shape[0] == 2
    rows = 2 // replicas
    for i in range(replicas):
        part = slice(i * rows, (i + 1) * rows)
        want = _eager(single, x[part])
        _equal(type(got)(*(t[part] for t in got)), want)


def test_inside_a_callers_capture_the_sequence_runs_eagerly(card):
    """A caller that captures the predictor in a graph of its own (as
    utils.profiling.device_time does) records the eager sequence: its
    replay equals the eager call, and the predictor neither captures nor
    replays a graph of its own."""
    serve = _predictor('tiny', 'fused', card)
    x = _frames(8, 2, card)
    static = x.clone()
    serve(static)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = serve(static)
    static.copy_(_frames(9, 2, card))
    graph.replay()
    torch.cuda.synchronize()
    _equal(out, _eager(serve, static))
    assert (serve.captures, serve.replays) == (1, 1)
