"""The port's device-time helper (utils/profiling.py) on the CPU route,
beside the JAX package's device_time on the same work."""
import jax.numpy as jnp
import pytest
import torch

from mm_distillnet_tpu.utils.profiling import device_time as jax_device_time
from mm_distillnet_torch.utils import profiling


def test_cpu_route_times_the_calls():
    calls = []

    def fn(x):
        calls.append(1)
        return x @ x

    x = torch.randn(64, 64)
    t = profiling.device_time(fn, (x,), iters=5)
    assert t > 0
    assert len(calls) == 6            # one warm call, then five timed
    calls.clear()
    profiling.device_time(fn, (x,), iters=3, warmup=False)
    assert len(calls) == 3


def test_seconds_per_call_like_the_jax_helper():
    """Both return seconds per iteration for the same product; on this
    CPU the readings are of one order (a loose check of the unit, not of
    speed)."""
    x = torch.randn(256, 256)
    t_port = profiling.device_time(torch.matmul, (x, x), iters=10)
    t_jax = jax_device_time(jnp.matmul, (jnp.asarray(x.numpy()),) * 2,
                            iters=10)
    assert 0 < t_port < 1 and 0 < t_jax < 1
    assert t_port / t_jax < 1e3 and t_jax / t_port < 1e3


def test_graph_ms_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip('this machine has CUDA')
    with pytest.raises((RuntimeError, AssertionError)):
        profiling.graph_ms(lambda: None, 2, 1)
