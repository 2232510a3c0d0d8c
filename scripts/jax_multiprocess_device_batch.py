#!/usr/bin/env python3
"""Two CPU processes of the JAX package: what global batch does the JAX
trainer's `_device_batch` build from each process's own `batch_size`
frames?

    python scripts/jax_multiprocess_device_batch.py [--batch 4] [--devices 2]

The script starts itself twice under jax.distributed (a local coordinator,
`--devices` virtual CPU devices per process). Each process holds a batch
of `--batch` frames whose values say which process and row they come from
(100 * process + row) and passes it to
`mm_distillnet_tpu.train.trainer._device_batch` over the global `data`
mesh (`create_mesh()`), as `train()` does, then the same frames on every
process. Each process prints one JSON line: the global array's shape and
rows, or the error the call raised. The reference's DDP steps on the concatenation of every rank's
frames: world x batch rows, each rank's own.
"""
import argparse
import json
import os
import socket
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def worker(batch: int, devices: int) -> None:
    import jax
    jax.config.update('jax_platforms', 'cpu')
    jax.config.update('jax_num_cpu_devices', devices)
    sys.path.insert(0, ROOT)
    import numpy as np
    from jax.experimental import multihost_utils

    from mm_distillnet_tpu.parallel.mesh import (create_mesh,
                                                 distributed_init_if_needed)
    from mm_distillnet_tpu.train.trainer import _device_batch

    distributed_init_if_needed()
    pid = jax.process_index()
    mesh = create_mesh()
    report = {'process': pid, 'processes': jax.process_count(),
              'jax': jax.__version__,
              'global_devices': int(mesh.devices.size), 'local_batch': batch}

    def global_rows(owner):
        """_device_batch of frames 100 * owner + row; the global array's
        shape and rows."""
        rows = 100.0 * owner + np.arange(batch, dtype=np.float32)
        host = {'audio': np.repeat(rows[:, None], 3, axis=1),
                'id': list(range(batch))}
        dev, _ = _device_batch(host, mesh, mesh.devices.size)
        arr = dev['audio']
        whole = multihost_utils.process_allgather(arr, tiled=True)[:, 0]
        return {'global_shape': list(arr.shape),
                'global_rows': [float(v) for v in whole]}

    # (1) as train() calls it: each process its own frames
    try:
        report['own_frames'] = global_rows(pid)
    except Exception as e:     # noqa: BLE001 - the finding is the error
        report['own_frames'] = {'raised': type(e).__name__,
                                'message': str(e)[:110]}
    # (2) the same frames on every process, as device_put asks
    report['same_frames'] = global_rows(0)
    print(json.dumps(report), flush=True)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--batch', type=int, default=4)
    p.add_argument('--devices', type=int, default=2)
    p.add_argument('--worker', action='store_true')
    a = p.parse_args()
    if a.worker:
        worker(a.batch, a.devices)
        return 0
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        port = s.getsockname()[1]
    procs = []
    for pid in range(2):
        env = dict(os.environ, JAX_COORDINATOR_ADDRESS=f'127.0.0.1:{port}',
                   JAX_NUM_PROCESSES='2', JAX_PROCESS_ID=str(pid))
        env.pop('XLA_FLAGS', None)
        procs.append(subprocess.Popen(
            [sys.executable, __file__, '--worker', '--batch', str(a.batch),
             '--devices', str(a.devices)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    rc = 0
    for p_ in procs:
        out, err = p_.communicate(timeout=600)
        sys.stdout.write(out)
        if p_.returncode:
            sys.stderr.write(err[-3000:])
            rc = 1
    return rc


if __name__ == '__main__':
    sys.exit(main())
