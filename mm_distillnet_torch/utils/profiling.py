"""Device-time measurement (port of mm_distillnet_tpu/utils/profiling.py).

The JAX package times `iters` calls inside one compiled program (lax.scan)
and reads the host clock around it. Here a call on a card is captured in a
CUDA graph and the graph is replayed between two CUDA events, so neither
the host's launch rate nor Python's dispatch enters the reading; on the
CPU the host clock (`time.perf_counter`) times the calls.

    seconds = device_time(fn, args, iters=20)

`span(name)` marks a layer of the program in a torch.profiler trace: a
`record_function` while a profiler records (the span then shares the
profiler's clock with the device's events), and nothing otherwise.

    with span('mmd.postprocess'):
        ...
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Sequence

import torch

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context that marks `name` in a torch.profiler trace: a
    `torch.profiler.record_function(name)` while a profiler records, else
    one shared no-op context that enters no RecordFunction, so the spans
    cost a flag test when no one profiles. The profiler keeps the spans
    until it stops; nothing is kept here."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


def graph_ms(fn: Callable[[], Any], reps: int = 20, replays: int = 3,
             warmup: bool = True) -> float:
    """Mean device time (ms) of fn() on the current card: a CUDA graph of
    `reps` calls, replayed `replays` times between two CUDA events (after
    one warm replay when `warmup`). One call runs before the capture
    (first-use set-up: builds, library handles)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    if warmup:
        graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def device_time(fn: Callable, args: Sequence[Any], iters: int = 20,
                warmup: bool = True) -> float:
    """Seconds per call of fn(*args). With a CUDA tensor among `args`, on
    its card: a CUDA graph of `iters` calls replayed once between CUDA
    events (after a warm replay when `warmup`); otherwise the host clock
    around `iters` calls (after one warm call when `warmup`)."""
    card = next((a.device for a in args
                 if isinstance(a, torch.Tensor) and a.is_cuda), None)
    if card is not None:
        with torch.cuda.device(card):
            return graph_ms(lambda: fn(*args), iters, 1, warmup) / 1e3
    if warmup:
        fn(*args)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    return (time.perf_counter() - t0) / iters
