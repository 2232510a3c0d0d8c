"""Milliseconds a serve call inside `mmd.postprocess`: decode, top-k and
the per-class NMS;
the host time of the traced calls, the profiler's cost per event
included, so it is compared only between traced runs (benchmark/spans.py).
None where the program opens no such span."""
from benchmark.spans import span_ms_per_call


def read(run):
    return span_ms_per_call(run, 'mmd.postprocess')
