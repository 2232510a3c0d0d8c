"""The program's layer spans in a Trace: `mmd.*` host spans, which
`mm_distillnet_torch.utils.profiling.span` opens as
`torch.profiler.record_function` while the profiler records, so that they
share the trace's clock with the device's work.

A span's time is the union of its intervals in the window: the host's time
in that layer, profiler's cost per event included, so it is compared only
between traced runs. A span's launches are the host's runtime calls that
put an operation on the device (`LAUNCH`) and start inside one of its
intervals: a child span's launches count toward its parent. Both read
None where the trace holds no such span, as a program without spans
gives.
"""
from __future__ import annotations

import bisect
import re
from typing import List, Optional, Tuple

from benchmark.common import Trace, union_length

# the runtime calls that queue a kernel, copy or set on the device
LAUNCH = re.compile(r'^(cudaLaunchKernel|cuLaunchKernel|cudaMemcpy\w*Async'
                    r'|cudaMemset\w*Async)')


def intervals(trace: Trace, name: str) -> List[Tuple[float, float]]:
    """The intervals of span `name` in the window, merged where they
    overlap (a span nested in one of its own name), in order."""
    merged: List[Tuple[float, float]] = []
    for start, end in sorted((s, e) for n, s, e in trace.host if n == name):
        if merged and start <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], end))
        else:
            merged.append((start, end))
    return merged


def span_s(trace: Trace, name: str) -> Optional[float]:
    """Seconds of the window inside span `name`, or None without one."""
    spans = intervals(trace, name)
    return union_length(spans) if spans else None


def launches_in(trace: Trace, name: str) -> Optional[int]:
    """Runtime launch calls that start inside span `name`, or None
    without one."""
    spans = intervals(trace, name)
    if not spans:
        return None
    starts = sorted(s for n, s, _ in trace.host if LAUNCH.match(n))
    return sum(bisect.bisect_right(starts, b) - bisect.bisect_left(starts, a)
               for a, b in spans)


def per_call(run: dict, value: Optional[float]) -> Optional[float]:
    """`value` over the traced calls, or None."""
    calls = run['counters'].get('calls')
    if value is None or not calls:
        return None
    return value / calls


def span_ms_per_call(run: dict, name: str) -> Optional[float]:
    seconds = span_s(run['trace'], name)
    return per_call(run, None if seconds is None else 1e3 * seconds)


def launches_per_call(run: dict, name: str) -> Optional[float]:
    return per_call(run, launches_in(run['trace'], name))
