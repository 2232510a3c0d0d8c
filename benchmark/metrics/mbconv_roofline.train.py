"""The MBConv kernels' share of their roofline, in %, over the traced window of
the train steps (the teachers' forwards): the block-level bound
(flops.mbconv_cost: each block's FLOPs at the bf16 peak or its input,
weights and output read or written once at the memory's peak, the larger;
summed over the 23 blocks of every forward the kernels ran) over the device
time in which a kernel of csrc/mbconv*.cu ran (the union of their intervals:
kernel (b) starts as a programmatic dependent of (a), so their durations
overlap)."""
import re

from benchmark import flops

KERNELS = re.compile(r'\b(expand_dw_kernel|dw_only_kernel|se_kernel|'
                     r'project_kernel)\b')


def read(run):
    trace, counters = run['trace'], run['counters']
    busy = trace.busy_s(KERNELS)
    if busy <= 0:
        return None
    bound = sum(n * flops.mbconv_bound_s(counters['compound_coef'],
                                         counters['image_size'], batch)
                for batch, n in counters['mbconv_forwards'])
    return 100.0 * bound / busy
