"""Device operations a serve call launches inside `mmd.postprocess`: the
host's runtime launch calls (kernels, copies, sets) that start in the span,
most of them the greedy NMS loop's, about 3 a candidate row (512 rows at
the shipped recipe, whatever the batch). Read from the same trace as the
device's own count; None where the program opens no such span."""
from benchmark.spans import launches_per_call


def read(run):
    return launches_per_call(run, 'mmd.postprocess')
