"""Milliseconds a train step inside `mmd.pseudo_labels`: each teacher's
decode, top-k and per-class NMS, and the fusion NMS of their labels;
the host time of the traced calls, the profiler's cost per event
included, so it is compared only between traced runs (benchmark/spans.py).
None where the program opens no such span."""
from benchmark.spans import span_ms_per_call


def read(run):
    return span_ms_per_call(run, 'mmd.pseudo_labels')
