"""What every run of the benchmark shares: finding a cell's files by name,
the statistics, the reading of a torch.profiler trace, and the check that
no JAX module was loaded.

Nothing here imports the program (`mm_distillnet_torch`); the kinds under
`kinds/` do.
"""
from __future__ import annotations

import heapq
import importlib.util
import json
import math
import sys
from pathlib import Path
from typing import Dict, Iterable, List, Sequence, Tuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names that may not be loaded in a run's process
FORBIDDEN_MODULES = ('jax', 'jaxlib', 'flax', 'mm_distillnet_tpu')
# the host span around a traced run's calls
WINDOW = 'benchmark_window'


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """Import the Python file at `path` as a module called `name`."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def benchmark_spec(root: Path = ROOT) -> dict:
    return read_json(root / 'BENCHMARK.json')


def find_cell(spec: dict, workload: str, here: Path = HERE) -> dict:
    """The cell `workload` with its files read: BENCHMARK.json's entry,
    `workloads/<name>.json` (limits), `traffic/<traffic>.json` and the
    configuration file that BENCHMARK.json names."""
    entries = {w['name']: w for w in spec['workloads']}
    if workload not in entries:
        raise KeyError(f'no workload {workload!r} in BENCHMARK.json; it has '
                       f'{sorted(entries)}')
    entry = entries[workload]
    configs = {c['name']: c for c in spec['configs']}
    config = read_json(here.parent / configs[entry['config']]['file'])
    cell = read_json(here / 'workloads' / f'{workload}.json')
    traffic = read_json(here / 'traffic' / f'{entry["traffic"]}.json')
    if cell.get('config') != entry['config'] or \
            cell.get('traffic') != entry['traffic']:
        raise ValueError(f'workloads/{workload}.json names '
                         f'{cell.get("config")}/{cell.get("traffic")}, '
                         f'BENCHMARK.json {entry["config"]}/'
                         f'{entry["traffic"]}')
    return {'name': workload, 'entry': entry, 'cell': cell,
            'config': config, 'traffic': traffic}


def metrics_of(spec: dict, workload: str, key: str) -> List[dict]:
    """The metrics under `key` ('end_to_end' or 'per_layer') that this
    cell reports: those whose `workloads` list names it, or that have no
    such list."""
    return [m for m in spec[key]
            if 'workloads' not in m or workload in m['workloads']]


def metric_reader(name: str, here: Path = HERE):
    """The reader of per-layer metric `name`: `metrics/<name>.py`."""
    path = here / 'metrics' / f'{name}.py'
    return load_module(path, 'benchmark_metric_' + name.replace('.', '_'))


def forbidden_loaded(modules: Iterable[str] = None) -> List[str]:
    """Top-level names in `modules` (default sys.modules) that are JAX or
    the JAX package, compared whole."""
    names = sys.modules if modules is None else modules
    tops = {m.split('.', 1)[0] for m in names}
    return sorted(tops.intersection(FORBIDDEN_MODULES))


# ---------------------------------------------------------------- statistics

def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0-100) of `values`, interpolated linearly
    between the two nearest ranks (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError('percentile of no values')
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def union_length(intervals: Iterable[Tuple[float, float]]) -> float:
    """Total length of the union of (start, end) intervals."""
    busy, last_end = 0.0, float('-inf')
    for start, end in sorted(intervals):
        if end > last_end:
            busy += end - max(start, last_end)
            last_end = end
    return busy


def gaps(intervals: Iterable[Tuple[float, float]], lo: float, hi: float
         ) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    out, cursor = [], lo
    for start, end in sorted(intervals):
        if start > cursor:
            out.append((cursor, min(start, hi)))
        cursor = max(cursor, end)
        if cursor >= hi:
            break
    if cursor < hi:
        out.append((cursor, hi))
    return [(a, b) for a, b in out if b > a]


# --------------------------------------------------------------- the trace

class Trace:
    """The device's work in a torch.profiler window, in seconds.

    `kernels` are (name, start, end) of every operation on the device: a
    kernel, copy or set, but not a user annotation such as the
    optimizer's `Optimizer.step#Adam.step`, which the trace also places on
    the device's timeline across the step's gaps. `host` are (name, start,
    end) of the host's operators. Times share the profiler's clock."""

    def __init__(self, kernels: List[Tuple[str, float, float]],
                 host: List[Tuple[str, float, float]],
                 window: Tuple[float, float]):
        self.kernels = kernels
        self.host = host
        self.window = window

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def launches(self) -> int:
        return len(self.kernels)

    def busy_s(self, pattern=None) -> float:
        """Seconds in which at least one operation (whose name matches the
        compiled regex `pattern`, if given) ran on the device."""
        return union_length((s, e) for n, s, e in self.kernels
                            if pattern is None or pattern.search(n))

    def by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for n, s, e in self.kernels:
            out[n] = out.get(n, 0.0) + (e - s)
        return out

    def idle_gaps(self, top: int = 10) -> List[List]:
        """The device's idle time in the window, by the innermost host
        operator that ran at each gap's middle (of those open then, the
        one that started last), the largest first."""
        lo, hi = self.window
        by_what: Dict[str, float] = {}
        host = sorted(self.host, key=lambda h: h[1])
        heap: List = []             # open operators, the latest start first
        nxt = 0
        for a, b in gaps(((s, e) for _, s, e in self.kernels), lo, hi):
            mid = (a + b) / 2
            while nxt < len(host) and host[nxt][1] <= mid:
                heapq.heappush(heap, (-host[nxt][1], nxt))
                nxt += 1
            while heap and host[heap[0][1]][2] < mid:
                heapq.heappop(heap)
            what = host[heap[0][1]][0] if heap else 'no host operator'
            by_what[what] = by_what.get(what, 0.0) + (b - a)
        ranked = sorted(by_what.items(), key=lambda kv: -kv[1])[:top]
        return [[n, s] for n, s in ranked]

    def device_ops(self, top: int = 10) -> List[List]:
        ranked = sorted(self.by_name().items(), key=lambda kv: -kv[1])[:top]
        return [[n, s] for n, s in ranked]


def _ns(event, which: str) -> int:
    """An event's start or end in ns (torch names the getters by unit)."""
    get = getattr(event, f'{which}_ns', None)
    return get() if get is not None else 1000 * getattr(event,
                                                        f'{which}_us')()


def trace_from_profiler(prof) -> Trace:
    """A Trace from a finished torch.profiler.profile whose calls ran
    inside `record_function(WINDOW)`: the window is that span on the host,
    and the host operators are those inside it. It reads the profiler's
    raw events (`kineto_results`): building its FunctionEvent tree takes
    minutes for a few train steps."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    spans = [e for e in events
             if e.name() == WINDOW and e.device_type() != cuda]
    if len(spans) != 1:
        raise ValueError(f'the trace holds {len(spans)} {WINDOW!r} spans')
    lo, hi = _ns(spans[0], 'start') / 1e9, _ns(spans[0], 'end') / 1e9
    kernels, host = [], []
    for e in events:
        name = e.name()
        start, end = _ns(e, 'start') / 1e9, _ns(e, 'end') / 1e9
        if e.device_type() == cuda:
            if e.is_user_annotation() or name.startswith('Optimizer.'):
                continue
            kernels.append((name, start, end))
        elif name != WINDOW and lo <= start and end <= hi:
            host.append((name, start, end))
    return Trace(kernels, host, (lo, hi))
