"""A whole run of `benchmark/run.py` on the CPU, past its look for a card:
the serve cell at the TEST-TINY size, with the card's calls stood in for.
A run whose predictor is broken underneath prints `correct` false, and a
run in which JAX is loaded while the check runs prints no result."""
import json
import sys
import types

import pytest
import torch

from benchmark import faults
from benchmark.kinds import serve
from benchmark.tests.test_bench_faults import fp32_predictor  # noqa: F401
from benchmark.tests.tiny import CPU, tiny_cell

SEED = 2 ** 34 + 5
WORKLOAD = 'serve-d2-b32'


@pytest.fixture
def harness(monkeypatch):
    """benchmark.run with the card's calls stood in for, on a machine
    that has none."""
    for key in ('TORCH_EXTENSIONS_DIR', 'TRITON_CACHE_DIR', 'USE_FLAX',
                'USE_JAX'):
        monkeypatch.delenv(key, raising=False)
    from benchmark import run
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
    monkeypatch.setattr(torch.cuda, 'synchronize', lambda *a: None)
    monkeypatch.setattr(torch.cuda, 'reset_peak_memory_stats', lambda: None)
    monkeypatch.setattr(torch.cuda, 'max_memory_allocated', lambda: 0)
    monkeypatch.setattr(torch.cuda, 'get_device_name', lambda: 'stand-in')
    monkeypatch.setattr(run, 'card_line', lambda: 'stand-in')
    n = torch.get_num_threads()
    yield run
    torch.set_num_threads(n)


def tiny_cells(monkeypatch, fault=None, during_check=None):
    """serve.Cell as run() builds it, made at the TEST-TINY size on the
    CPU, with `fault` planted and `during_check` called as the check
    starts."""
    make = serve.Cell

    class Tiny(make):
        def __init__(self, spec, seed, device):
            super().__init__(tiny_cell(WORKLOAD), seed, CPU, fault=fault)

        def check(self, explain=None):
            if during_check is not None:
                during_check()
            return super().check(explain)
    monkeypatch.setattr(serve, 'Cell', Tiny)


def result_line(out: str):
    lines = [ln for ln in out.splitlines() if ln.startswith('{')]
    return json.loads(lines[-1]) if lines else None


def args(run):
    return run.parse(['--workload', WORKLOAD, '--seed', str(SEED),
                      '--seconds', '0.5', '--trace', '0'])


def test_a_sound_run_is_correct(harness, monkeypatch, capsys,
                                fp32_predictor):  # noqa: F811
    tiny_cells(monkeypatch)
    assert harness.run(args(harness)) == 0
    result = result_line(capsys.readouterr().out)
    assert result['correct'] is True
    assert set(result['metrics']) == {'serve_frames_per_s', 'serve_p95_ms',
                                      'setup_s'}


def test_a_run_with_a_broken_predictor_is_not_correct(
        harness, monkeypatch, capsys, fp32_predictor):  # noqa: F811
    tiny_cells(monkeypatch, fault=faults.SERVE['half_batch'])
    assert harness.run(args(harness)) == 0
    result = result_line(capsys.readouterr().out)
    assert result['correct'] is False


def test_jax_loaded_by_the_check_prints_no_result(harness, monkeypatch,
                                                  capsys):
    tiny_cells(monkeypatch, during_check=lambda: monkeypatch.setitem(
        sys.modules, 'jax', types.ModuleType('jax')))
    assert harness.run(args(harness)) == 3
    out = capsys.readouterr()
    assert result_line(out.out) is None
    assert 'jax' in out.err
