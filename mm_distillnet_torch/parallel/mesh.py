"""Multi-process and multi-device runs over torch.distributed (port of
mm_distillnet_tpu/parallel/mesh.py).

The reference trains with one process per card (DistributedDataParallel
over NCCL, reference train.py:294-313); the JAX package replaces that with
`jax.distributed` and an SPMD `data` mesh. Here:

- a process group, one process per card (`distributed_init_if_needed`),
  with the collectives the train step needs built from `all_reduce` and
  `broadcast` only (gloo on CUDA tensors offers no `all_gather`):
  `all_reduce_mean_`, `broadcast_`, `global_any`, `barrier`;
- a "mesh" inside one process: a tuple of devices (`create_mesh`) over
  which an eval batch is padded (`pad_batch_to_devices`), split
  (`shard_batch`), run by one replica per device and gathered back to the
  first device (`gather_batch`, `over_mesh`).

A configured world that cannot form raises; there is no quiet fall back to
one process.
"""
from __future__ import annotations

import datetime
import os
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

# seconds a process waits for the others at init (the counterpart of the
# JAX package's JAX_COORDINATOR_INIT_TIMEOUT, which is read too); it is
# also the group's timeout for each collective
INIT_TIMEOUT_ENV = 'MMDT_DIST_INIT_TIMEOUT'
DEFAULT_TIMEOUT_S = 600


def _first(*values):
    for v in values:
        if v not in (None, ''):
            return v
    return None


def _config_get(config, key: str):
    if config is None:
        return None
    return config.get(key, fallback=None)


def world_settings(config=None) -> Tuple[Optional[str], Optional[int],
                                         Optional[int], Optional[int]]:
    """(address 'host:port', world size, rank, local rank) of the world the
    config and the environment describe, each None where nothing says.

    Config keys `coordinator_address`, `num_processes`, `process_id` and
    `local_rank` win (as in the JAX package); then torch's launcher
    environment (MASTER_ADDR + MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK,
    as torchrun sets them); then the JAX package's (JAX_COORDINATOR_ADDRESS,
    JAX_NUM_PROCESSES, JAX_PROCESS_ID), so that one launch script serves
    both packages."""
    env = os.environ
    torch_addr = None
    if env.get('MASTER_ADDR') and env.get('MASTER_PORT'):
        torch_addr = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    addr = _first(_config_get(config, 'coordinator_address'), torch_addr,
                  env.get('JAX_COORDINATOR_ADDRESS'))
    size = _first(_config_get(config, 'num_processes'),
                  env.get('WORLD_SIZE'), env.get('JAX_NUM_PROCESSES'))
    rank = _first(_config_get(config, 'process_id'), env.get('RANK'),
                  env.get('JAX_PROCESS_ID'))
    local = _first(_config_get(config, 'local_rank'), env.get('LOCAL_RANK'))
    as_int = lambda v: None if v is None else int(v)   # noqa: E731
    return addr, as_int(size), as_int(rank), as_int(local)


def init_timeout_s() -> float:
    return float(_first(os.environ.get(INIT_TIMEOUT_ENV),
                        os.environ.get('JAX_COORDINATOR_INIT_TIMEOUT'),
                        DEFAULT_TIMEOUT_S))


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def distributed_init_if_needed(config=None, device=None,
                               backend: Optional[str] = None) -> None:
    """Forms the process group that the config or the environment
    describes (`world_settings`); a no-op without one, and on re-entry.

    The backend is `backend`, else config `dist_backend`, else NCCL for a
    CUDA `device` and gloo for the CPU (two ranks on one card need gloo:
    NCCL refuses them). On CUDA the rank's card (`local_rank`, else the
    rank modulo the visible cards) becomes the current device first.
    Raises when the world cannot form: an address without a world size or
    rank, a world size above 1 without an address, or a coordinator that
    does not answer within `init_timeout_s()`."""
    if is_initialized():
        return
    addr, size, rank, local = world_settings(config)
    if addr is None:
        if size is not None and size > 1:
            raise ValueError(
                f'a world of {size} processes is configured without an '
                'address: set coordinator_address, MASTER_ADDR and '
                'MASTER_PORT, or JAX_COORDINATOR_ADDRESS')
        return
    if size is None or rank is None:
        raise ValueError(
            f'the coordinator {addr} is configured without a world size '
            'and a rank (num_processes / WORLD_SIZE / JAX_NUM_PROCESSES, '
            'process_id / RANK / JAX_PROCESS_ID)')
    if not 0 <= rank < size:
        raise ValueError(f'rank {rank} is outside a world of {size}')
    dev_type = torch.device(device).type if device is not None else (
        'cuda' if torch.cuda.is_available() else 'cpu')
    backend = backend or _config_get(config, 'dist_backend') or (
        'nccl' if dev_type == 'cuda' else 'gloo')
    if dev_type == 'cuda':
        torch.cuda.set_device(local if local is not None else
                              rank % torch.cuda.device_count())
    dist.init_process_group(
        backend=backend, init_method=f'tcp://{addr}', world_size=size,
        rank=rank, timeout=datetime.timedelta(seconds=init_timeout_s()))


def process_index() -> int:
    return dist.get_rank() if is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def config_rank(config) -> int:
    """The rank that names this process's files (`checkpoint.{rank}`,
    `results.{rank}.csv`): config `rank` when set, else the process
    group's. Raises where the config's rank and the group's differ: two
    processes would write the same files."""
    value = _config_get(config, 'rank')
    if value in (None, ''):
        return process_index()
    rank = int(value)
    if is_initialized() and rank != process_index():
        raise ValueError(
            f'config rank {rank} is not the process group\'s rank '
            f'{process_index()}: both processes would write checkpoint.'
            f'{rank}; drop --rank or give each process its own')
    return rank


def barrier() -> None:
    if is_initialized():
        dist.barrier()


def _buckets(tensors: Sequence[torch.Tensor]):
    """The tensors grouped by (device, dtype), in order."""
    groups = {}
    for t in tensors:
        groups.setdefault((t.device, t.dtype), []).append(t)
    return groups.values()


def all_reduce_mean_(tensors: Sequence[torch.Tensor]) -> None:
    """Every tensor replaced, in place, by its mean over the ranks: one
    flat `all_reduce` per dtype. A no-op outside a world."""
    if not is_initialized():
        return
    n = dist.get_world_size()
    for group in _buckets(tensors):
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat)
        flat.div_(n)
        for t, v in zip(group, flat.split([t.numel() for t in group])):
            t.copy_(v.view_as(t))


def broadcast_(tensors: Sequence[torch.Tensor], src: int = 0) -> None:
    """Every tensor overwritten, in place, by rank `src`'s: one flat
    `broadcast` per dtype. A no-op outside a world."""
    if not is_initialized():
        return
    for group in _buckets(tensors):
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.broadcast(flat, src)
        for t, v in zip(group, flat.split([t.numel() for t in group])):
            t.copy_(v.view_as(t))


def global_any(flag: torch.Tensor) -> torch.Tensor:
    """A 0-dim bool: whether `flag` holds on any rank (one `all_reduce`
    of a count)."""
    if not is_initialized():
        return flag
    count = flag.to(torch.float32).reshape(1)
    dist.all_reduce(count)
    return count[0] > 0


def broadcast_module_(module: torch.nn.Module, src: int = 0) -> None:
    """Rank `src`'s parameters and buffers on every rank."""
    broadcast_([t.data for t in module.parameters()] +
               [t for t in module.buffers()], src)


# ---- a batch over several devices of one process ----

def local_devices(device_type: str = 'cuda') -> List[torch.device]:
    """The devices of this process: the CPU; in a formed world on CUDA the
    rank's card (the current device since init); otherwise every visible
    card."""
    if device_type == 'cpu':
        return [torch.device('cpu')]
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    if is_initialized():
        return [torch.device('cuda', torch.cuda.current_device())]
    return [torch.device('cuda', i) for i in range(torch.cuda.device_count())]


def create_mesh(num_devices: int = -1,
                devices: Optional[Sequence[Any]] = None
                ) -> Tuple[torch.device, ...]:
    """A tuple of devices to split a batch over: `devices`, or the local
    cards; the first `num_devices` of them (-1: all)."""
    devices = local_devices('cuda') if devices is None else devices
    devices = tuple(torch.device(d) for d in devices)
    if num_devices > 0:
        devices = devices[:num_devices]
    if not devices:
        raise ValueError('a mesh needs at least one device')
    return devices


def _tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, '_fields'):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree) -> list:
    out = []
    _tree_map(out.append, tree)
    return out


def pad_batch_to_devices(arrays, n_devices: int):
    """The leading dim of every array (numpy or torch) padded to a multiple
    of n_devices by repeating the last element; returns (padded tree,
    original batch size)."""
    def pad(x):
        rem = (-x.shape[0]) % n_devices
        if rem == 0:
            return x
        if isinstance(x, torch.Tensor):
            return torch.cat([x, x[-1:].expand(rem, *x.shape[1:])])
        return np.concatenate([x, np.repeat(x[-1:], rem, axis=0)])

    return _tree_map(pad, arrays), _leaves(arrays)[0].shape[0]


def shard_batch(mesh: Sequence[torch.device], tree) -> list:
    """One tree per device: the leading dim of every array cut into
    len(mesh) equal parts, part i on mesh[i]."""
    n = len(mesh)

    def part(i):
        def cut(x):
            if x.shape[0] % n:
                raise ValueError(f'a batch of {x.shape[0]} does not split '
                                 f'over {n} devices; pad it first')
            k = x.shape[0] // n
            return torch.as_tensor(x[i * k:(i + 1) * k], device=mesh[i])
        return _tree_map(cut, tree)

    return [part(i) for i in range(n)]


def replicate(mesh: Sequence[torch.device], tree) -> list:
    """One copy of the tree's tensors per device."""
    return [_tree_map(lambda x: torch.as_tensor(x, device=d), tree)
            for d in mesh]


def gather_batch(parts: Sequence, device, n: Optional[int] = None):
    """The per-device trees concatenated along dim 0 on `device`, cut to
    the first n rows."""
    flat = [_leaves(p) for p in parts]
    joined = [torch.cat([f[j].to(device) for f in flat])[:n]
              for j in range(len(flat[0]))]
    it = iter(joined)
    return _tree_map(lambda _: next(it), parts[0])


def over_mesh(mesh: Sequence[torch.device], fns: Sequence[Callable],
              batch_arg: int = 0) -> Callable:
    """fn(*args) that pads argument `batch_arg` (a tensor, an array or a
    dict of them) to the mesh, splits it, calls fns[i] (the replica on
    mesh[i]) with part i and the other arguments as they are, and gathers
    the outputs' real rows on mesh[0]. The replicas are called in turn
    from this thread; each one's work is queued on its own device."""
    def call(*args):
        padded, n = pad_batch_to_devices(args[batch_arg], len(mesh))
        outs = [fn(*args[:batch_arg], part, *args[batch_arg + 1:])
                for fn, part in zip(fns, shard_batch(mesh, padded))]
        return gather_batch(outs, mesh[0], n)

    return call
