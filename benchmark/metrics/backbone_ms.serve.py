"""Milliseconds a serve call inside `mmd.backbone`: the stem and the 23
MBConv blocks on their kernels;
the host time of the traced calls, the profiler's cost per event
included, so it is compared only between traced runs (benchmark/spans.py).
None where the program opens no such span."""
from benchmark.spans import span_ms_per_call


def read(run):
    return span_ms_per_call(run, 'mmd.backbone')
