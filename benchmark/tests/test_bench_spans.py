"""The readers of the program's layer spans (benchmark/spans.py and the ten
`*_ms.*` / `*_launches.*` metrics) on hand-built traces with spans and
runtime launch calls at known times."""
import pytest

from benchmark.common import Trace, benchmark_spec, metric_reader
from benchmark.spans import LAUNCH, intervals, launches_in, span_s

# (name, start, end) on the host, seconds; two calls of each
TRAIN_HOST = [
    ('mmd.train_step', 1.0, 10.0),
    ('mmd.optimizer', 1.1, 1.2),
    ('mmd.teachers', 1.2, 3.2),
    ('mmd.backbone', 1.3, 2.0),
    ('mmd.pseudo_labels', 3.2, 5.2),
    ('mmd.nms', 3.5, 4.5),
    ('mmd.student', 5.2, 6.2),
    ('mmd.backward', 6.2, 8.7),
    ('mmd.optimizer', 8.7, 9.3),
    ('mmd.train_step', 11.0, 20.0),
    ('mmd.teachers', 11.0, 13.0),
    ('mmd.pseudo_labels', 13.0, 15.0),
    ('mmd.student', 15.0, 16.0),
    ('mmd.backward', 16.0, 18.0),
    ('mmd.optimizer', 18.0, 19.0),
]
TRAIN_LAUNCHES = [
    ('cudaLaunchKernel', 1.5),          # teachers (backbone)
    ('cudaLaunchKernelExC', 2.5),       # teachers
    ('cudaMemsetAsync', 3.3),           # pseudo_labels
    ('cudaLaunchKernel', 3.6),          # nms, inside pseudo_labels
    ('cuLaunchKernel', 4.0),            # nms
    ('cudaMemcpyAsync', 4.4),           # nms
    ('cudaLaunchKernel', 13.5),         # pseudo_labels of call 2
    ('cudaLaunchKernel', 16.5),         # backward
    ('cudaLaunchKernel', 10.5),         # between the steps
]
NOT_LAUNCHES = [('cudaStreamSynchronize', 3.4), ('aten::mul', 3.7),
                ('cudaEventRecord', 14.0)]


def _trace(host, calls=(), kernels=(), window=(0.0, 21.0)):
    """`host` spans and operators, and short host `calls` at their
    starts."""
    events = list(host) + [(n, t, t + 0.01) for n, t in calls]
    return Trace(list(kernels), events, window)


def _run(trace, calls=2):
    return {'trace': trace, 'counters': {'calls': calls},
            'window': {'seconds': 1.0, 'counters': {'calls': calls}}}


def _read(name, run):
    return metric_reader(name).read(run)


def test_launch_names():
    for name in ('cudaLaunchKernel', 'cudaLaunchKernelExC', 'cuLaunchKernel',
                 'cuLaunchKernelEx', 'cudaMemcpyAsync', 'cudaMemcpy2DAsync',
                 'cudaMemsetAsync', 'cudaMemsetD32Async'):
        assert LAUNCH.match(name), name
    for name in ('cudaStreamSynchronize', 'cudaMemcpy', 'cudaEventRecord',
                 'aten::mul', 'mmd.nms'):
        assert not LAUNCH.match(name), name


@pytest.mark.parametrize('name, want', [
    ('teachers_ms.train', 1e3 * (2.0 + 2.0) / 2),
    ('pseudo_labels_ms.train', 1e3 * (2.0 + 2.0) / 2),
    ('student_ms.train', 1e3 * (1.0 + 1.0) / 2),
    ('backward_ms.train', 1e3 * (2.5 + 2.0) / 2),
    ('optimizer_ms.train', 1e3 * (0.1 + 0.6 + 1.0) / 2),
    # 4 launches in call 1 (3 of them inside mmd.nms), 1 in call 2
    ('pseudo_labels_launches.train', 5 / 2),
])
def test_train_readers(name, want):
    run = _run(_trace(TRAIN_HOST, TRAIN_LAUNCHES + NOT_LAUNCHES))
    assert _read(name, run) == pytest.approx(want)


SERVE_HOST = [
    ('mmd.serve', 0.0, 10.0),
    ('mmd.backbone', 1.0, 3.0),
    ('mmd.bifpn_heads', 3.0, 4.0),
    ('mmd.postprocess', 4.0, 9.0),
    ('mmd.nms', 5.0, 8.5),
]
SERVE_LAUNCHES = [('cudaLaunchKernel', 2.0), ('cudaLaunchKernel', 3.5),
                  ('cudaLaunchKernel', 4.5), ('cudaMemcpyAsync', 6.0),
                  ('cudaLaunchKernel', 7.0), ('cudaLaunchKernel', 8.0),
                  ('cudaLaunchKernel', 9.5)]


@pytest.mark.parametrize('name, want', [
    ('backbone_ms.serve', 2e3 / 4),
    ('bifpn_heads_ms.serve', 1e3 / 4),
    ('postprocess_ms.serve', 5e3 / 4),
    ('postprocess_launches.serve', 4 / 4),
])
def test_serve_readers(name, want):
    run = _run(_trace(SERVE_HOST, SERVE_LAUNCHES), calls=4)
    assert _read(name, run) == pytest.approx(want)


def test_launches_in_a_child_count_toward_its_parent():
    trace = _trace(SERVE_HOST, SERVE_LAUNCHES)
    assert launches_in(trace, 'mmd.nms') == 3
    assert launches_in(trace, 'mmd.postprocess') == 4
    assert launches_in(trace, 'mmd.serve') == 7


def test_a_span_nested_in_its_own_name_counts_once():
    trace = _trace([('mmd.serve', 0.0, 10.0), ('mmd.serve', 2.0, 4.0)],
                   SERVE_LAUNCHES)
    assert intervals(trace, 'mmd.serve') == [(0.0, 10.0)]
    assert span_s(trace, 'mmd.serve') == pytest.approx(10.0)
    assert launches_in(trace, 'mmd.serve') == 7


def test_every_span_reader_reads_none_without_its_span():
    """A program without spans (the parent of this metric) reports
    nothing, and the readers raise nothing."""
    names = [m['name'] for m in benchmark_spec()['per_layer']
             if m['source'] == 'program_span']
    assert len(names) == 10
    bare = _run(_trace([('aten::mul', 1.0, 2.0)], SERVE_LAUNCHES))
    for name in names:
        assert _read(name, bare) is None, name
    no_calls = _run(_trace(SERVE_HOST + TRAIN_HOST, SERVE_LAUNCHES), 0)
    for name in names:
        assert _read(name, no_calls) is None, name


def test_idle_gaps_name_a_span_where_no_operator_is_open():
    """The device idles in 2-5 and 6-8: at 3.5 only `mmd.postprocess` is
    open on the host, at 7 `aten::mul` inside it."""
    trace = _trace([('mmd.serve', 0.0, 10.0), ('mmd.postprocess', 2.0, 9.0),
                    ('aten::mul', 6.5, 7.5)],
                   kernels=[('k', 0.0, 2.0), ('k', 5.0, 6.0),
                            ('k', 8.0, 10.0)], window=(0.0, 10.0))
    assert dict(trace.idle_gaps()) == {'mmd.postprocess': pytest.approx(3.0),
                                       'aten::mul': pytest.approx(2.0)}
