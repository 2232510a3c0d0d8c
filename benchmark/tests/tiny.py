"""The benchmark's cells at the TEST-TINY size (EfficientDet's compound
coefficient -1, 128 px), on the CPU: what the tests drive."""
import torch

from benchmark.common import ROOT, benchmark_spec, find_cell

TRAFFIC = {'serve': dict(frames_per_call=4, distinct_calls=2, check_frames=6,
                         trace_calls=2),
           'train': dict(frames_per_call=4, distinct_calls=4, check_steps=3,
                         trace_calls=2)}
CPU = torch.device('cpu')


def tiny_cell(name: str) -> dict:
    c = find_cell(benchmark_spec(ROOT), name)
    c['config'] = dict(c['config'], compound_coef=-1, image_size=128)
    c['traffic'] = dict(c['traffic'], **TRAFFIC[c['traffic']['kind']])
    return c


def served(cell, calls: int = 3):
    """Run `calls` calls of a serve Cell and free the program."""
    cell.warm()
    for i in range(calls):
        cell.call(i)
    cell.free_program()
    return cell
