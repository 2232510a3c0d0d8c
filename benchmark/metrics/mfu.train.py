"""The whole train step's share of the card's bf16 peak, in %: the model FLOPs
of the untraced window (flops.forward_flops: 2 x the multiply-adds of every
convolution and linear layer; the teachers forward, the student forward
and a backward of twice its forward, recomputation not counted) over the
window's host time and 989 TFLOP/s, NVIDIA's dense bf16 rate at 700 W (peaks.json). The window is
the one that `--trace 0` times, run ahead of the traced calls, so the
profiler's cost on the host does not enter it."""
from benchmark import flops


def read(run):
    window = run.get('window')
    if not window or window['seconds'] <= 0 or \
            not window['counters'].get('model_flops'):
        return None
    return 100.0 * window['counters']['model_flops'] / window['seconds'] \
        / flops.PEAKS['bf16_flops_per_s']
