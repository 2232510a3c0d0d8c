"""Milliseconds a train step inside `mmd.optimizer`: zero_grad and the
Adam update;
the host time of the traced calls, the profiler's cost per event
included, so it is compared only between traced runs (benchmark/spans.py).
None where the program opens no such span."""
from benchmark.spans import span_ms_per_call


def read(run):
    return span_ms_per_call(run, 'mmd.optimizer')
