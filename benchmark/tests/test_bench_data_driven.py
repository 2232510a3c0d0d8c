"""The harness finds a configuration, a traffic mix, a workload and a
per-layer metric by file name alone: a later change adds a file under
configs/, traffic/, workloads/ or metrics/ and an entry in BENCHMARK.json,
and edits no file that is there."""
import json
import shutil
from pathlib import Path

import pytest

from benchmark.common import (benchmark_spec, find_cell, metric_reader,
                              metrics_of)

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent


def test_every_cell_and_metric_of_the_benchmark_resolves():
    spec = benchmark_spec(ROOT)
    for w in spec['workloads']:
        cell = find_cell(spec, w['name'])
        assert cell['traffic']['kind'] in ('serve', 'train')
        assert (HERE / 'kinds' / f'{cell["traffic"]["kind"]}.py').exists()
        assert metrics_of(spec, w['name'], 'per_layer')
        e2e = [m['name'] for m in metrics_of(spec, w['name'], 'end_to_end')]
        assert 'setup_s' in e2e and len(e2e) >= 2
    for m in spec['per_layer']:
        assert callable(metric_reader(m['name']).read)


def test_a_new_cell_and_metric_need_only_new_files(tmp_path):
    here = tmp_path / 'benchmark'
    shutil.copytree(HERE, here, ignore=shutil.ignore_patterns(
        '__pycache__', 'tests'))
    before = {p: p.read_bytes() for p in here.rglob('*') if p.is_file()}
    spec = benchmark_spec(ROOT)
    # a new configuration, traffic mix, cell and metric, by files alone
    cfg = json.loads((here / 'configs' / 'audio-student-d2-768.json')
                     .read_text())
    cfg.update(name='audio-student-d0-512', compound_coef=0,
               image_size=512)
    (here / 'configs' / 'audio-student-d0-512.json').write_text(
        json.dumps(cfg))
    (here / 'traffic' / 'closed-one-client-b4.json').write_text(json.dumps(
        {'kind': 'serve', 'frames_per_call': 4, 'distinct_calls': 8,
         'check_frames': 8, 'trace_calls': 8}))
    (here / 'workloads' / 'serve-d0-b4.json').write_text(json.dumps(
        {'config': 'audio-student-d0-512',
         'traffic': 'closed-one-client-b4', 'why': 'a test',
         'limits': {'det_gap_beyond_bf16': 0.1}}))
    (here / 'metrics' / 'calls_seen.serve.py').write_text(
        'def read(run):\n    return run["counters"].get("calls")\n')
    spec['configs'].append({'name': 'audio-student-d0-512',
                            'source': 'https://arxiv.org/abs/1911.09070',
                            'file': 'benchmark/configs/'
                                    'audio-student-d0-512.json',
                            'reduced': [], 'why': 'a test'})
    spec['workloads'].append({'name': 'serve-d0-b4',
                              'config': 'audio-student-d0-512',
                              'traffic': 'closed-one-client-b4', 'chips': 1,
                              'why': 'a test'})
    spec['per_layer'].append({'name': 'calls_seen.serve', 'unit': 'calls',
                              'better': 'higher',
                              'source': 'program_counter', 'layer': 'test',
                              'moves': 'serve_frames_per_s',
                              'workloads': ['serve-d0-b4']})
    cell = find_cell(spec, 'serve-d0-b4', here)
    assert cell['config']['compound_coef'] == 0
    assert cell['traffic']['frames_per_call'] == 4
    assert cell['cell']['limits']['det_gap_beyond_bf16'] == 0.1
    names = [m['name'] for m in metrics_of(spec, 'serve-d0-b4',
                                           'per_layer')]
    assert names == ['calls_seen.serve']
    assert metric_reader('calls_seen.serve', here).read(
        {'counters': {'calls': 3}}) == 3
    # every file that was there is unchanged
    assert all(p.read_bytes() == b for p, b in before.items())


def test_a_cell_whose_files_disagree_is_refused(tmp_path):
    spec = benchmark_spec(ROOT)
    spec['workloads'][0] = dict(spec['workloads'][0],
                                traffic='closed-one-client-b1')
    with pytest.raises(ValueError):
        find_cell(spec, spec['workloads'][0]['name'])
    with pytest.raises(KeyError):
        find_cell(spec, 'no-such-cell')
