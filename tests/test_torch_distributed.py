"""The port's multi-process paths (torch.distributed, gloo, two processes
on the CPU) against the JAX package on a 2-device mesh of the conftest's
virtual CPU devices.

The workers are this file run as a module (`python -m
tests.test_torch_distributed CASE DIR [CONFIG]`, torch and the port only),
two at a time, each on a free port with its own time limit; a world that
hangs is killed and fails the test. What they check (the loader's
shares, the per-rank checkpoints, the collectives) they assert
themselves; what they compute (SyncBatchNorm2d, two train steps per case)
they write to DIR, and the tests hold it against the JAX side computed
here, in the pytest process, while the workers run:

- SyncBatchNorm2d over 2 ranks x 2 frames against flax's BatchNorm on
  the concatenated batch: output, running statistics, gradients with
  respect to the input, the scale and the bias;
- one and two steps of the distillation step at test-tiny (128 px, rgb
  and thermal teachers, SGD with the global-norm clip) on 2 ranks x batch
  2 against JAX `make_train_step` (bn_mode 'sync') on the global batch of
  4 sharded over `create_mesh(2)`, and against
  `make_train_step_per_replica_bn` ('per_replica'): parameters, BN
  statistics on every rank, metrics. Data 'A' gives every frame
  pseudo-labels; in data 'B' rank 1's frames have none (the focal loss's
  "no annotation" switch is the global batch's under 'sync'). One sync
  case has the audio mix on, which merges global frames 0 and 1 (rank 0's).

Stochastic depth is off on both sides (the JAX `drop_connect` patched to
the identity here, the port's student built with rate 0), as in
tests/test_torch_train_step.py. Bounds are that file's: parameters rtol 1e-5 /
atol 1e-6, BN statistics rtol 1e-4 / atol 1e-6, metrics rtol 1e-4 / atol
1e-6; SyncBatchNorm2d's output at the parameters' bound, its gradients at
the statistics'.
"""
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from mm_distillnet_torch.config import default_config
from mm_distillnet_torch.data.loader import DataLoader
from mm_distillnet_torch.distill import train_step as ts
from mm_distillnet_torch.distill.pseudo_labels import PseudoLabelConfig
from mm_distillnet_torch.models.efficientdet import EfficientDet
from mm_distillnet_torch.models.layers import (BN_EPS, BN_MOMENTUM,
                                               SyncBatchNorm2d)
from mm_distillnet_torch.ops.anchors import anchor_table
from mm_distillnet_torch.ops.postprocess import class_validity_table
from mm_distillnet_torch.parallel import mesh
from mm_distillnet_torch.train.checkpoint import (restore_checkpoint,
                                                  save_checkpoint)
from mm_distillnet_torch.train.optim import StepLR

REPO = Path(__file__).resolve().parents[1]
CONFIG = str(REPO / 'configs' / 'mm-distillnet.cfg')
SIZE = 128
CHANNELS = {'rgb': 3, 'thermal': 1, 'audio': 8}
# a teacher detection needs a score above 0.65: the seeded teachers score
# the 10x-noise frames of data A above it and data B's constant frames
# (rank 1's) below it, with margins above 0.01
PL = dict(image_size=SIZE, conf_threshold=0.65, num_candidates=64,
          max_det_per_teacher=8, max_gt=16)
SGD = dict(optimizer='SGD', lr='1e-2', grad_clip='1.0')
# (bn_mode, data, audio mix)
CASES = [('sync', 'A', False), ('sync', 'B', False), ('sync', 'A', True),
         ('per_replica', 'A', False), ('per_replica', 'B', False)]
BN_SHAPE = (4, 5, 7, 6)        # NHWC, 2 frames per rank
WORLD_ENV = ('MASTER_ADDR', 'MASTER_PORT', 'WORLD_SIZE', 'RANK',
             'LOCAL_RANK', 'JAX_COORDINATOR_ADDRESS', 'JAX_NUM_PROCESSES',
             'JAX_PROCESS_ID', 'XLA_FLAGS')
WORKER_TIMEOUT_S = 300


def _case_name(mode, data, mix):
    return f'{mode}-{data}' + ('-mix' if mix else '')


def _cfg(mix=False):
    return ts.DistillConfig(pl=PseudoLabelConfig(**PL),
                            audio_augmentation_merge=mix)


def _tables():
    return (torch.as_tensor(anchor_table(SIZE)),
            torch.as_tensor(class_validity_table(20, list(range(20)))),
            torch.arange(20))


# ---- the workers (torch and the port only) ----

class _Frames:
    """16 (or n) frames whose rgb plane holds the frame's index."""

    def __init__(self, n=16):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {'rgb': np.full((4, 4, 3), float(i), np.float32),
                'label': np.array([[0., 0., 1., 1., 2.]], np.float32),
                'id': str(i)}


class _Stamped(torch.nn.Module):
    def __init__(self, w, rank):
        super().__init__()
        self.w = torch.nn.Parameter(torch.as_tensor(w))
        self.rank_stamp = torch.nn.Parameter(torch.full((2,), float(rank)))
        self.register_buffer('mean', torch.ones(2))


def _world(out: Path, config) -> dict:
    """The world forms, re-entry is a no-op, the collectives, the
    loader's shares and the per-rank checkpoints."""
    assert not mesh.is_initialized()
    mesh.distributed_init_if_needed(config, device='cpu')
    mesh.distributed_init_if_needed(config, device='cpu')   # no-op
    r, n = mesh.process_index(), mesh.process_count()
    assert n == 2 and dist.get_backend() == 'gloo'

    t = torch.tensor([float(r), 10.0 * r])
    mesh.all_reduce_mean_([t])
    assert t.tolist() == [0.5, 5.0]
    b = torch.full((3,), float(r) + 1)
    mesh.broadcast_([b])
    assert b.tolist() == [1.0] * 3
    assert bool(mesh.global_any(torch.tensor(r == 1)))
    assert not bool(mesh.global_any(torch.tensor(False)))

    # DistributedSampler's shares: rank r draws shuffled[r::2]; an odd
    # dataset gives both ranks the same number of frames
    for size in (16, 17):
        loader = DataLoader(_Frames(size), batch_size=4, shuffle=True,
                            num_workers=1, seed=7, process_index=r,
                            process_count=n)
        loader.set_epoch(3)
        got = [int(i) for batch in loader for i in batch['id']]
        idx = np.arange(size)
        np.random.default_rng(7 + 3).shuffle(idx)
        assert got == [int(x) for x in idx[r::2][:8]], (size, got)
        assert len(loader) == 2

    # each rank writes and restores its own files; after the barrier in
    # save_checkpoint rank 0 sees both ranks'
    cfg = default_config(exp_name=str(out / 'ckpt'))
    model = _Stamped([1.5, -2.0], r)
    state = ts.TrainState(step=3, model=model, optimizer=torch.optim.SGD(
        model.parameters(), lr=0.1))
    sched = StepLR(1e-3, step_size=2, gamma=0.5)
    for _ in range(3):
        sched.step()
    save_checkpoint(cfg, state, 7, 0.25, 5, sched.state_dict(), rank=r,
                    is_best=True)
    if r == 0:
        for rank in range(2):
            for name in ('checkpoint', 'best',
                         'only_parameters_student_best'):
                assert (out / 'ckpt' / f'{name}.{rank}').exists()
    fresh = _Stamped([0.0, 0.0], -1)
    fresh_state = ts.TrainState(step=0, model=fresh, optimizer=torch.optim
                                .SGD(fresh.parameters(), lr=0.1))
    sched2 = StepLR(1e-3, step_size=2, gamma=0.5)
    _, start, best, best_epoch = restore_checkpoint(cfg, fresh_state,
                                                    sched2, rank=r)
    assert (start, best, best_epoch, fresh_state.step) == (8, 0.25, 5, 3)
    assert fresh.rank_stamp.tolist() == [float(r)] * 2
    assert fresh.w.tolist() == [1.5, -2.0]
    assert sched2.state_dict() == sched.state_dict()
    return {'rank': r, 'world': n}


def _sync_bn(out: Path, r: int) -> None:
    """SyncBatchNorm2d on this rank's two frames; output, statistics and
    gradients of sum(y * g) written for the test."""
    data = np.load(out / 'bn.npz')
    part = slice(2 * r, 2 * r + 2)
    bn = SyncBatchNorm2d(BN_SHAPE[-1], eps=BN_EPS, momentum=BN_MOMENTUM)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(data['scale']))
        bn.bias.copy_(torch.from_numpy(data['bias']))
        bn.running_mean.copy_(torch.from_numpy(data['mean']))
        bn.running_var.copy_(torch.from_numpy(data['var']))
    x = torch.from_numpy(data['x'][part]).permute(0, 3, 1, 2) \
        .requires_grad_()
    y = bn(x)
    (y * torch.from_numpy(data['g'][part]).permute(0, 3, 1, 2)).sum() \
        .backward()
    torch.save({'y': y.detach().permute(0, 2, 3, 1).numpy(),
                'dx': x.grad.permute(0, 2, 3, 1).numpy(),
                'dscale': bn.weight.grad.numpy(),
                'dbias': bn.bias.grad.numpy(),
                'mean': bn.running_mean.numpy(),
                'var': bn.running_var.numpy()}, out / f'bn.{r}.pt')


def _train(out: Path, r: int) -> None:
    """Two steps of every case on this rank's two frames."""
    weights = torch.load(out / 'weights.pt', weights_only=True)
    data = np.load(out / 'batch.npz')
    tables = _tables()
    for mode, which, mix in CASES:
        nets = {m: EfficientDet(20, -1, c, drop_connect_rate=0.0)
                for m, c in CHANNELS.items()}
        for m, net in nets.items():
            net.load_state_dict(weights[m])
        teachers = ts.make_teachers(
            {m: nets[m] for m in ('rgb', 'thermal')}, image_size=SIZE,
            fused=False, dtype=torch.float32, device='cpu')
        batch = {m: torch.from_numpy(data[f'{which}_{m}'][2 * r:2 * r + 2])
                 for m in CHANNELS}
        batch['label'] = torch.from_numpy(data['label'][2 * r:2 * r + 2])
        targets = ts.teacher_targets(teachers, batch, _cfg(), *tables)
        state = ts.init_train_state(nets['audio'], default_config(**SGD),
                                    device='cpu')
        step = ts.make_train_step(teachers, _cfg(mix), *tables,
                                  compute_dtype=torch.float32,
                                  bn_mode=mode, device='cpu')
        steps = []
        for _ in range(2):
            metrics = step(state, batch)
            steps.append({
                'metrics': {k: float(v) for k, v in metrics.items()},
                'state': {k: v.clone() for k, v in
                          state.model.state_dict().items()}})
        torch.save({'has_labels': bool(
            (targets.annotations[0][..., 4] != -1).any()), 'steps': steps},
            out / f'train.{_case_name(mode, which, mix)}.{r}.pt')


def _worker(case: str, out: Path, config_json: str) -> None:
    torch.set_num_threads(1)
    config = default_config(**json.loads(config_json)) if config_json \
        else None
    result = _world(out, config)
    if case == 'full':
        _sync_bn(out, result['rank'])
        _train(out, result['rank'])
    mesh.barrier()
    (out / f'world.{result["rank"]}.json').write_text(json.dumps(result))
    dist.destroy_process_group()


# ---- launching them ----

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _clean_env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items() if k not in WORLD_ENV}
    env.update(OMP_NUM_THREADS='1', MMDT_DIST_INIT_TIMEOUT='120', **extra)
    return env


def _world_env(style: str, port: int, rank: int) -> dict:
    if style == 'torch':
        return _clean_env(MASTER_ADDR='127.0.0.1', MASTER_PORT=str(port),
                          WORLD_SIZE='2', RANK=str(rank),
                          LOCAL_RANK=str(rank))
    if style == 'jax':
        return _clean_env(JAX_COORDINATOR_ADDRESS=f'127.0.0.1:{port}',
                          JAX_NUM_PROCESSES='2', JAX_PROCESS_ID=str(rank))
    return _clean_env()


def _start(args_for, style: str):
    """Two processes, args_for(rank) each, in the world `style` names."""
    port = _free_port()
    return [subprocess.Popen(args_for(rank, port),
                             env=_world_env(style, port, rank), cwd=REPO,
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for rank in range(2)]


def _wait(procs, timeout: float = WORKER_TIMEOUT_S):
    """Every process's output; all are killed if one fails or the time
    runs out."""
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f'rank {rank} failed:\n{out[-4000:]}'
    return outs


def _start_workers(case: str, out: Path, style: str):
    def args_for(rank, port):
        config = '' if style != 'config' else json.dumps(dict(
            coordinator_address=f'127.0.0.1:{port}', num_processes=2,
            process_id=rank))
        return [sys.executable, '-m', 'tests.test_torch_distributed', case,
                str(out), config]
    return _start(args_for, style)


# ---- the JAX side ----

def _inputs(out: Path) -> dict:
    """Weights (a filled flax tree per network, written as state_dicts
    for the workers), data A and B, and SyncBatchNorm's inputs."""
    import jax.numpy as jnp

    from mm_distillnet_tpu.models.efficientdet import EfficientDet as JaxDet
    from mm_distillnet_torch.convert.weights import state_dict_from_flax

    from .test_torch_helpers import filled_variables, nhwc_input

    jvars = {m: filled_variables(
        JaxDet(num_classes=20, compound_coef=-1, dtype=jnp.float32),
        20 + i, nhwc_input(i, (1, SIZE, SIZE, c)))
        for i, (m, c) in enumerate(CHANNELS.items())}
    torch.save({m: state_dict_from_flax(v) for m, v in jvars.items()},
               out / 'weights.pt')
    data = {}
    for i, (m, c) in enumerate(CHANNELS.items()):
        x = nhwc_input(30 + i, (4, SIZE, SIZE, c))
        if m == 'audio':
            data[f'A_{m}'] = data[f'B_{m}'] = x
            continue
        data[f'A_{m}'] = 10.0 * x
        data[f'B_{m}'] = np.concatenate(
            [10.0 * x[:2], np.full_like(x[2:], 10.0)])
    label = np.full((4, 16, 5), -1.0, np.float32)
    label[..., :4] = 0.0
    data['label'] = label
    np.savez(out / 'batch.npz', **data)
    rng = np.random.default_rng(5)
    bn = {'x': rng.normal(0.5, 2.0, BN_SHAPE), 'g': rng.normal(0, 1, BN_SHAPE),
          'scale': rng.uniform(0.8, 1.2, BN_SHAPE[-1]),
          'bias': rng.normal(0, 0.1, BN_SHAPE[-1]),
          'mean': rng.normal(0, 0.1, BN_SHAPE[-1]),
          'var': rng.uniform(0.5, 1.5, BN_SHAPE[-1])}
    bn = {k: np.asarray(v, np.float32) for k, v in bn.items()}
    np.savez(out / 'bn.npz', **bn)
    return {'jvars': jvars, 'data': data, 'bn': bn}


def _flax_batch_norm(bn: dict) -> dict:
    """flax's BatchNorm (the JAX package's constants) on the whole batch:
    output, new statistics and the gradients of sum(y * g)."""
    import flax.linen as nn
    import jax
    import jax.numpy as jnp

    layer = nn.BatchNorm(use_running_average=False, momentum=0.99,
                         epsilon=BN_EPS)
    params = {'scale': jnp.asarray(bn['scale']),
              'bias': jnp.asarray(bn['bias'])}
    stats = {'mean': jnp.asarray(bn['mean']), 'var': jnp.asarray(bn['var'])}

    def loss(params, x):
        y, upd = layer.apply({'params': params, 'batch_stats': stats}, x,
                             mutable=['batch_stats'])
        return jnp.sum(y * bn['g']), (y, upd['batch_stats'])

    (_, (y, new)), (dparams, dx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(bn['x']))
    return jax.tree_util.tree_map(np.asarray, {
        'y': y, 'dx': dx, 'dscale': dparams['scale'],
        'dbias': dparams['bias'], 'mean': new['mean'], 'var': new['var']})


def _jax_steps(inputs: dict) -> dict:
    """Two steps of every case on the global batch of 4 over
    create_mesh(2): {case: [(state_dict, metrics) after step 1, 2]}."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from mm_distillnet_tpu.config import default_config as jax_config
    from mm_distillnet_tpu.distill import train_step as jts
    from mm_distillnet_tpu.distill.pseudo_labels import \
        PseudoLabelConfig as JaxPL
    from mm_distillnet_tpu.models import efficientnet as jax_efficientnet
    from mm_distillnet_tpu.models.efficientdet import EfficientDet as JaxDet
    from mm_distillnet_tpu.parallel.mesh import create_mesh
    from mm_distillnet_tpu.train.optim import build_optimizer
    from mm_distillnet_torch.convert.weights import state_dict_from_flax

    jvars = inputs['jvars']
    mods = {m: JaxDet(num_classes=20, compound_coef=-1, dtype=jnp.float32)
            for m in CHANNELS}
    teachers = {m: mods[m] for m in ('rgb', 'thermal')}
    m2 = create_mesh(2)
    rep = NamedSharding(m2, P())
    shard = NamedSharding(m2, P('data'))
    tables = [jnp.asarray(np.asarray(t)) for t in _tables()]
    tx = build_optimizer(jax_config(**SGD))
    t_vars = jax.device_put({m: jvars[m] for m in teachers}, rep)
    rng = jax.device_put(jax.random.PRNGKey(0), rep)
    data = inputs['data']
    steps = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_efficientnet, 'drop_connect',
                   lambda x, rate, deterministic, rng: x)
        compiled = {}
        for mode, which, mix in CASES:
            cfg = jts.DistillConfig(pl=JaxPL(**PL),
                                    audio_augmentation_merge=mix)
            if (mode, mix) not in compiled:
                args = (mods['audio'], teachers, tx, cfg, *tables)
                compiled[mode, mix] = jax.jit(
                    jts.make_train_step(*args) if mode == 'sync'
                    else jts.make_train_step_per_replica_bn(*args, m2))
            batch = jax.device_put(
                {m: jnp.asarray(data[f'{which}_{m}']) for m in CHANNELS}
                | {'label': jnp.asarray(data['label'])}, shard)
            state = jax.device_put(jts.init_train_state(
                mods['audio'], None, None, tx, variables=jvars['audio']),
                rep)
            out = []
            for _ in range(2):
                state, metrics = compiled[mode, mix](state, t_vars, batch,
                                                     rng)
                host = jax.device_get(state)
                out.append((state_dict_from_flax(
                    {'params': host.params,
                     'batch_stats': host.batch_stats}),
                    {k: float(v) for k, v in metrics.items()}))
            steps[_case_name(mode, which, mix)] = out
    return steps


@pytest.fixture(scope='module')
def full(tmp_path_factory):
    """The two-rank world over torch's environment, started before the
    JAX side is computed here, then waited for."""
    out = tmp_path_factory.mktemp('dist')
    inputs = _inputs(out)
    procs = _start_workers('full', out, 'torch')
    try:
        ref = {'bn': _flax_batch_norm(inputs['bn']),
               'steps': _jax_steps(inputs)}
    finally:
        outs = _wait(procs)
    return out, ref, outs


def _load(path):
    return torch.load(path, weights_only=False)


# ---- the tests ----

@pytest.mark.parametrize('style', ['torch', 'jax', 'config'])
def test_world_forms_shards_and_checkpoints(full, tmp_path, style):
    """Two ranks form one world from torch's launcher environment, the
    JAX package's, or config keys; re-entry is a no-op; the collectives;
    the loader's shares (rank r draws shuffled[r::2], as
    tests/multihost_worker.py pins them); per-rank checkpoints round-trip
    with a rank stamp and rank 0 sees both after the barrier (all
    asserted in the workers)."""
    out = full[0]
    if style != 'torch':
        out = tmp_path
        _wait(_start_workers('world', out, style))
    for rank in range(2):
        assert json.loads((out / f'world.{rank}.json').read_text()) == \
            {'rank': rank, 'world': 2}


def test_sync_batch_norm_matches_flax_over_two_ranks(full):
    out, ref, _ = full
    want = ref['bn']
    got = [_load(out / f'bn.{r}.pt') for r in range(2)]
    np.testing.assert_allclose(np.concatenate([g['y'] for g in got]),
                               want['y'], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.concatenate([g['dx'] for g in got]),
                               want['dx'], rtol=1e-4, atol=1e-6)
    for k in ('dscale', 'dbias'):   # each rank's share of the sum
        np.testing.assert_allclose(got[0][k] + got[1][k], want[k],
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    for r in range(2):
        for k in ('mean', 'var'):
            np.testing.assert_allclose(got[r][k], want[k], rtol=1e-4,
                                       atol=1e-6, err_msg=(r, k))


@pytest.mark.parametrize('momentum', [BN_MOMENTUM, None])
def test_sync_batch_norm_equals_batch_norm_in_one_process(momentum):
    """Outside a process group SyncBatchNorm2d is BatchNorm2d (flax's
    biased running variance) to the step's bounds: output, gradients,
    running statistics, with torch's momentum and its cumulative mode."""
    import copy

    from mm_distillnet_torch.models.layers import (BatchNorm2d,
                                                   use_sync_batch_norm)

    rng = np.random.default_rng(9)
    bn = BatchNorm2d(6, eps=BN_EPS, momentum=momentum)
    with torch.no_grad():
        bn.weight.uniform_(0.8, 1.2)
        bn.bias.normal_(0, 0.1)
    sync = use_sync_batch_norm(torch.nn.Sequential(copy.deepcopy(bn)))[0]
    assert type(sync) is SyncBatchNorm2d
    x = torch.from_numpy(rng.normal(0.5, 2.0, (4, 6, 5, 7)).astype(
        np.float32))
    g = torch.from_numpy(rng.normal(0, 1, (4, 6, 5, 7)).astype(np.float32))
    outs = []
    for layer in (bn, sync):
        xi = x.clone().requires_grad_()
        y = layer(xi)
        (y * g).sum().backward()
        outs.append((y.detach(), xi.grad, layer.weight.grad, layer.bias.grad))
    for got, want in zip(outs[1], outs[0]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)
    for k in ('running_mean', 'running_var', 'num_batches_tracked'):
        torch.testing.assert_close(getattr(sync, k), getattr(bn, k),
                                   rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize('case', CASES, ids=[_case_name(*c) for c in CASES])
def test_train_steps_match_jax_on_a_two_device_mesh(full, case):
    out, ref, _ = full
    name = _case_name(*case)
    ranks = [_load(out / f'train.{name}.{r}.pt') for r in range(2)]
    assert ranks[0]['has_labels']
    assert ranks[1]['has_labels'] == (case[1] == 'A')
    for step, (want_sd, want_metrics) in enumerate(ref['steps'][name]):
        for r, got in enumerate(ranks):
            got = got['steps'][step]
            for k in ts.METRICS:
                np.testing.assert_allclose(
                    got['metrics'][k], want_metrics[k], rtol=1e-4,
                    atol=1e-6, err_msg=(name, step, r, k))
            for k, w in want_sd.items():
                if k.endswith('num_batches_tracked'):
                    continue
                stat = k.endswith(('running_mean', 'running_var'))
                np.testing.assert_allclose(
                    got['state'][k].numpy(), w.numpy(),
                    rtol=1e-4 if stat else 1e-5, atol=1e-6,
                    err_msg=(name, step, r, k))


def test_train_cli_on_two_ranks(tmp_path):
    """`python -m mm_distillnet_torch.cli.train --device cpu` twice, under
    torchrun's environment: both exit 0, their students (checkpoint.0 and
    checkpoint.1) are equal, and each rank scores it into its own
    results.{rank}.csv."""
    exp = tmp_path / 'exp'
    overwrite = json.dumps(dict(
        dataset='Synthetic', synthetic_size=8, image_size=SIZE,
        compound_coef=-1, batch_size=2, eval_batch_size=2, num_workers=1,
        compute_dtype='float32', max_gt=16, nms_candidates=64,
        max_det_per_teacher=8, max_detections=16, device_audio_resize=True,
        resume=False, num_epoches=1, val_interval=1, fast_run=True, seed=3,
        exp_name=str(exp), log_path=str(tmp_path / 'tb'),
        saved_path=str(tmp_path / 'no_models')))

    def args_for(rank, port):
        return [sys.executable, '-m', 'mm_distillnet_torch.cli.train',
                '--config_file', CONFIG, '--device', 'cpu', '--nodes', '1',
                '--overwrite', overwrite]

    _wait(_start(args_for, 'torch'))
    ckpts = [torch.load(exp / f'checkpoint.{r}', weights_only=True)
             for r in range(2)]
    assert ckpts[0]['step'] == ckpts[1]['step'] == 2
    for k, v in ckpts[0]['state_dict'].items():
        assert torch.equal(v, ckpts[1]['state_dict'][k]), k
    for r in range(2):
        assert (exp / f'results.{r}.csv').exists()
        assert (exp / f'best.{r}').exists()


def test_unreachable_coordinator_raises_within_its_timeout():
    """Rank 1 of 2 with nobody at the address: init raises after the 3 s
    timeout; nothing goes on as one process."""
    code = ('from mm_distillnet_torch.parallel import mesh\n'
            "mesh.distributed_init_if_needed(device='cpu')\n"
            "print('UNEXPECTED_SUCCESS')\n")
    env = _world_env('torch', _free_port(), 1)
    env['MMDT_DIST_INIT_TIMEOUT'] = '3'
    t = time.monotonic()
    p = subprocess.run([sys.executable, '-c', code], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0, p.stdout + p.stderr
    assert 'UNEXPECTED_SUCCESS' not in p.stdout
    assert time.monotonic() - t < 60


def test_no_configured_world_is_a_single_process_noop(monkeypatch):
    for k in WORLD_ENV:
        monkeypatch.delenv(k, raising=False)
    mesh.distributed_init_if_needed(None, device='cpu')
    monkeypatch.setenv('WORLD_SIZE', '1')
    mesh.distributed_init_if_needed(default_config(), device='cpu')
    assert not mesh.is_initialized()
    assert (mesh.process_index(), mesh.process_count()) == (0, 1)
    assert mesh.config_rank(default_config()) == 0
    assert mesh.config_rank(default_config(rank=3)) == 3
    monkeypatch.setenv('WORLD_SIZE', '2')
    with pytest.raises(ValueError, match='without an address'):
        mesh.distributed_init_if_needed(None, device='cpu')
    with pytest.raises(ValueError, match='without a world size'):
        mesh.distributed_init_if_needed(default_config(
            coordinator_address='127.0.0.1:1', num_processes=''),
            device='cpu')
    assert not mesh.is_initialized()


if __name__ == '__main__':
    _worker(sys.argv[1], Path(sys.argv[2]),
            sys.argv[3] if len(sys.argv) > 3 else '')
