"""Device operations a train step launches inside `mmd.pseudo_labels`:
the host's runtime launch calls (kernels, copies, sets) that start in the
span, most of them the NMS loops' (each teacher's and the fusion's greedy
loop launches about 3 a row). Read from the same trace as the device's
own count; None where the program opens no such span."""
from benchmark.spans import launches_per_call


def read(run):
    return launches_per_call(run, 'mmd.pseudo_labels')
