"""The program's spans (utils/profiling.span) on the CPU at the TEST-TINY
size: none is entered without a profiler; under one, the train step's and
the predictors' layers nest as the trace's readers expect; the outputs do
not change; an exported predictor holds no profiler op; and the trainer's
`profile_dir` traces a bounded window of steps."""
import copy
import json
import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mm_distillnet_torch.config import default_config
from mm_distillnet_torch.data.synthetic import SyntheticMultimodal
from mm_distillnet_torch.distill import train_step as ts
from mm_distillnet_torch.models.efficientdet import EfficientDet
from mm_distillnet_torch.models.fused_forward import eval_module
from mm_distillnet_torch.ops.anchors import anchor_table
from mm_distillnet_torch.ops.postprocess import class_validity_table
from mm_distillnet_torch.ops.resize import maybe_stretch_mel_axis
from mm_distillnet_torch.quant import build_quant_pack
from mm_distillnet_torch.serving import export_predictor, make_serving_fn
from mm_distillnet_torch.train import trainer
from mm_distillnet_torch.utils import profiling

from .test_torch_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread')

SIZE = 128
TEACHERS = {'rgb': 3, 'thermal': 1, 'depth': 3}
KW = dict(num_candidates=64, max_detections=16)
CPU = torch.device('cpu')


def _seeded(seed, channels):
    torch.manual_seed(seed)
    return EfficientDet(20, -1, channels).eval()


def _config(**kw):
    return default_config(image_size=SIZE, nms_candidates=64,
                          max_det_per_teacher=8, max_gt=16,
                          compute_dtype='float32', **kw)


@pytest.fixture(scope='module')
def step_parts():
    """Fused teachers, a student, a step function and a batch."""
    nets = {m: _seeded(10 + i, c) for i, (m, c) in enumerate(TEACHERS.items())}
    frozen = ts.make_teachers(nets, image_size=SIZE, fused=True,
                              dtype=torch.float32, device='cpu')
    config = _config()
    step = ts.make_train_step(
        frozen, trainer.distill_config_from(config, SIZE),
        anchor_table(SIZE), torch.as_tensor(class_validity_table(20, [6])),
        torch.arange(20), compute_dtype=torch.float32, seed=0, device='cpu')
    g = torch.Generator().manual_seed(0)
    batch = {m: torch.randn(2, SIZE, SIZE, c, generator=g)
             for m, c in {**TEACHERS, 'audio': 8}.items()}
    return config, _seeded(1, 8), step, batch


def _state(step_parts):
    config, student, _, _ = step_parts
    return ts.init_train_state(copy.deepcopy(student), config, device='cpu')


@pytest.fixture(scope='module')
def predictors():
    """The fused predictor, the int8 predictor and one over a mesh of two
    CPU replicas, on the same weights, and a compact-audio batch."""
    model = _seeded(1, 8)
    sd = model.state_dict()
    x = torch.randn(2, 80, SIZE, 8, generator=torch.Generator().manual_seed(1))
    net = eval_module(model, sd, CPU)
    stretched = maybe_stretch_mel_axis(x, SIZE)
    pack = build_quant_pack(net, stretched, [stretched], state_dict=sd)
    make = dict(dtype=torch.float32, device='cpu', **KW)
    return {'fused': make_serving_fn(model, sd, SIZE, **make),
            'int8': make_serving_fn(model, sd, SIZE, quant_pack=pack, **make),
            'mesh': make_serving_fn(model, sd, SIZE, mesh=(CPU, CPU),
                                    **make)}, x


def _ns(event, which):
    get = getattr(event, f'{which}_ns', None)
    return get() if get is not None else 1000 * getattr(event,
                                                        f'{which}_us')()


def _spans(prof):
    """(name, start, end) of every `mmd.*` span the profiler recorded."""
    return [(e.name(), _ns(e, 'start'), _ns(e, 'end'))
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith('mmd.')]


def _named(spans, name):
    return [s for s in spans if s[0] == name]


def _inside(child, parent):
    return parent[1] <= child[1] and child[2] <= parent[2]


def _profiled(fn, *args):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn(*args)
    return out, _spans(prof)


@pytest.fixture
def entered(monkeypatch):
    """The names of every RecordFunction entered while the test runs."""
    names = []
    enter = torch.autograd.profiler.record_function.__enter__

    def spy(self):
        names.append(self.name)
        return enter(self)

    monkeypatch.setattr(torch.autograd.profiler.record_function,
                        '__enter__', spy)
    return names


def test_no_span_is_entered_without_a_profiler(step_parts, predictors,
                                               entered):
    _, _, step, batch = step_parts
    preds, x = predictors
    step(_state(step_parts), batch)
    for predict in preds.values():
        predict(x)
    assert not [n for n in entered if n.startswith('mmd.')]
    # the spy sees the spans once a profiler records
    _profiled(preds['fused'], x)
    assert 'mmd.serve' in entered


def test_train_step_spans_nest(step_parts):
    _, _, step, batch = step_parts
    _, spans = _profiled(step, _state(step_parts), batch)
    (root,) = _named(spans, 'mmd.train_step')
    for name in ('mmd.teachers', 'mmd.pseudo_labels', 'mmd.student',
                 'mmd.backward', 'mmd.optimizer'):
        assert _named(spans, name), name
        assert all(_inside(s, root) for s in _named(spans, name)), name
    (teachers,) = _named(spans, 'mmd.teachers')
    (labels,) = _named(spans, 'mmd.pseudo_labels')
    # one NMS per teacher and one for the fusion; one forward per teacher
    nms = _named(spans, 'mmd.nms')
    assert len(nms) == len(TEACHERS) + 1
    assert all(_inside(s, labels) for s in nms)
    for name in ('mmd.backbone', 'mmd.bifpn_heads'):
        assert len(_named(spans, name)) == len(TEACHERS)
        assert all(_inside(s, teachers) for s in _named(spans, name))
    # the layers follow one another
    order = [_named(spans, n)[0][1] for n in
             ('mmd.teachers', 'mmd.pseudo_labels', 'mmd.student',
              'mmd.backward')]
    assert order == sorted(order)


@pytest.mark.parametrize('kind', ['fused', 'int8', 'mesh'])
def test_predictor_spans_nest(predictors, kind):
    preds, x = predictors
    _, spans = _profiled(preds[kind], x)
    (root,) = _named(spans, 'mmd.serve')
    replicas = 2 if kind == 'mesh' else 1
    post = _named(spans, 'mmd.postprocess')
    assert len(post) == replicas
    nms = _named(spans, 'mmd.nms')
    assert len(nms) == replicas
    assert all(any(_inside(n, p) for p in post) for n in nms)
    forward = [s for s in spans
               if s[0] in ('mmd.backbone', 'mmd.bifpn_heads')]
    if kind == 'int8':
        # the int8 forward has no backbone / heads split
        assert not forward
    else:
        assert len(forward) == 2 * replicas
    assert all(_inside(s, root) for s in spans)


def test_outputs_are_the_same_under_the_profiler(step_parts, predictors):
    _, _, step, batch = step_parts
    plain_state, traced_state = _state(step_parts), _state(step_parts)
    plain = step(plain_state, batch)
    traced, _ = _profiled(step, traced_state, batch)
    for k in ts.METRICS:
        assert torch.equal(plain[k], traced[k]), k
    traced_params = dict(traced_state.model.named_parameters())
    for k, p in plain_state.model.named_parameters():
        assert torch.equal(p, traced_params[k]), k
    preds, x = predictors
    for predict in preds.values():
        dets, _ = _profiled(predict, x)
        for a, b in zip(predict(x), dets):
            assert torch.equal(a, b)


def test_exported_predictor_holds_no_profiler_op(predictors, monkeypatch):
    """The program export_predictor would save (taken at the save)."""
    preds, _ = predictors
    saved = []
    monkeypatch.setattr(torch.export, 'save',
                        lambda program, path: saved.append(program))
    export_predictor(preds['fused'], 1, SIZE, 8, 'unused.pt2')
    targets = [str(n.target) for n in saved[0].graph.nodes
               if n.op == 'call_function']
    assert targets
    assert not [t for t in targets if 'profiler' in t]


def test_profile_dir_traces_a_bounded_window(tmp_path):
    """Eight steps (two an epoch, one teacher) with `profile_dir`: the
    trace holds the five after the first two, and the loader's spans
    around them."""
    config = _config(
        exp_name=str(tmp_path / 'run'), log_path=str(tmp_path / 'tb'),
        synthetic_size=4, batch_size=2, num_workers=1, num_epoches=4,
        val_interval=100, rank=0, seed=3,
        profile_dir=str(tmp_path / 'profile'))
    rgb = _seeded(10, 3)
    student = _seeded(1, 8)
    state = trainer.train({'rgb': (rgb, rgb.state_dict())},
                          (student, student.state_dict()), config,
                          SyntheticMultimodal(config, 'train'), None,
                          device='cpu')
    assert state.step == 8
    with open(os.path.join(config['profile_dir'], 'trace.0.json')) as f:
        events = json.load(f)['traceEvents']
    names = [e['name'] for e in events if e.get('cat') == 'user_annotation']
    assert names.count('mmd.train_step') == trainer.PROFILE_STEPS
    assert names.count('mmd.h2d') >= trainer.PROFILE_STEPS
    assert names.count('mmd.loader_wait') >= trainer.PROFILE_STEPS


def test_span_is_a_shared_no_op_without_a_profiler():
    assert profiling.span('a') is profiling.span('b')
    with profile(activities=[ProfilerActivity.CPU]):
        assert isinstance(profiling.span('a'),
                          torch.profiler.record_function)
