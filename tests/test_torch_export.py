"""The port's exported predictor (serving.export_predictor / load_predictor
over torch.export and the MBConv kernels' custom ops) against the live
predictor and against the JAX package's exported artifact
(tests/test_serving.py:55,91)."""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm_distillnet_tpu.models.efficientdet import EfficientDet as JaxDet
from mm_distillnet_tpu.serving import export_predictor as jax_export
from mm_distillnet_tpu.serving import load_predictor as jax_load
from mm_distillnet_tpu.serving import make_serving_fn as jax_serving_fn
from mm_distillnet_torch.convert.weights import state_dict_from_flax
from mm_distillnet_torch.models.efficientdet import EfficientDet
from mm_distillnet_torch.models.efficientnet import BlockArgs, MBConvBlock
from mm_distillnet_torch.ops import fused_mbconv as fm
from mm_distillnet_torch.serving import (export_predictor, load_predictor,
                                         make_serving_fn)

from .test_torch_helpers import filled_variables, nhwc_input, to_jax
from .test_torch_helpers import one_torch_thread  # noqa: F401

# torch on one thread: the suite runs several workers on a few cores
pytestmark = pytest.mark.usefixtures('one_torch_thread')

SIZE = 128
BATCH = 2
KW = dict(num_candidates=64, max_detections=16)
REPO = Path(__file__).resolve().parents[1]

# run in a fresh interpreter: load the artifact (no model is built) and
# save its Detections. On the CPU some kernels' sums depend on the number
# of threads, so the replay takes the live predictor's.
_REPLAY = '''
import sys
import numpy as np
import torch
from mm_distillnet_torch.serving import load_predictor
torch.set_num_threads(int(sys.argv[4]))
predict = load_predictor(sys.argv[1], device='cpu')
x = np.load(sys.argv[2])
np.savez(sys.argv[3], *[t.numpy() for t in predict(x)])
'''


@pytest.fixture(scope='module')
def weights():
    model = JaxDet(num_classes=20, compound_coef=-1, dtype=jnp.float32)
    x = nhwc_input(0, (BATCH, SIZE, SIZE, 8))
    v = filled_variables(model, 1, x)
    return model, v, state_dict_from_flax(v), x


@pytest.fixture(scope='module')
def exported(weights, tmp_path_factory, one_torch_thread):  # noqa: F811
    _, _, sd, x = weights
    live = make_serving_fn(EfficientDet(20, -1, 8), sd, SIZE, device='cpu',
                           **KW)
    path = str(tmp_path_factory.mktemp('export') / 'predictor.pt2')
    export_predictor(live, BATCH, SIZE, 8, path)
    return live, path, x


def test_export_roundtrip_in_a_fresh_process(exported, tmp_path):
    """The artifact replays in a process that builds no model, and gives
    the live fused predictor's Detections bit for bit (CPU: the kernels'
    plain versions through the custom ops)."""
    live, path, x = exported
    assert os.path.getsize(path) > 0
    np.save(tmp_path / 'x.npy', x)
    out = subprocess.run(
        [sys.executable, '-c', _REPLAY, path, str(tmp_path / 'x.npy'),
         str(tmp_path / 'dets.npz'), str(torch.get_num_threads())],
        cwd=REPO, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    got = np.load(tmp_path / 'dets.npz')
    want = live(x)
    assert want.valid.any(), 'the comparison needs valid detections'
    for i, w in enumerate(want):
        np.testing.assert_array_equal(got[f'arr_{i}'], w.numpy())
    loaded = load_predictor(path, device='cpu')
    for g, w in zip(loaded(x), want):
        assert torch.equal(g, w)


def test_exported_nms_is_one_op(exported):
    """The exported predictor runs its per-class NMS as one node, the custom
    op `mm_distillnet::nms_fixed` (the CPU implementation on replay above),
    not as the plain version's loop of a few ops per candidate."""
    _, path, _ = exported
    graph = torch.export.load(path).graph
    calls = [n.target for n in graph.nodes if n.op == 'call_function']
    assert calls.count(torch.ops.mm_distillnet.nms_fixed.default) == 1
    assert len(calls) < 1000


def test_platforms(exported, tmp_path):
    live, _, x = exported
    path = str(tmp_path / 'cpu.pt2')
    export_predictor(live, BATCH, SIZE, 8, path, platforms=('cpu',))
    for g, w in zip(load_predictor(path, device='cpu')(x), live(x)):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match='platforms'):
        export_predictor(live, BATCH, SIZE, 8, str(tmp_path / 'tpu.pt2'),
                         platforms=('tpu',))
    assert not os.path.exists(tmp_path / 'tpu.pt2')
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA'):
            load_predictor(path)


def _block_operands():
    args = BlockArgs(3, 1, 16, 16, 6, 1)
    torch.manual_seed(0)
    block = MBConvBlock(args).eval()
    f = fm.fold_mbconv(block.state_dict(), args, 'cpu')
    x = torch.from_numpy(nhwc_input(3, (2, 8, 8, 16))).to(torch.bfloat16)
    return args, f, x


@pytest.mark.parametrize('op', ['mbconv_expand_dw', 'mbconv_se',
                                'mbconv_project'])
def test_custom_ops_pass_opcheck(op):
    """Schema, fake implementation against the CPU one, dynamic shapes."""
    args, f, x = _block_operands()
    d, sums = fm.expand_dw(x, f, args)
    gate = fm.se_gate(sums, f, 64)
    operands = {
        'mbconv_expand_dw': (x, f.w_exp, f.b_exp, f.w_dw, f.b_dw,
                             f.wexp_pack, f.dw_pack, *fm._args_tuple(args)),
        'mbconv_se': (sums, f.w_se1, f.b_se1, f.w_se2, f.b_se2, f.se_pack,
                      64, []),
        'mbconv_project': (d, gate, f.w_prj, f.b_prj, f.wprj_pack, x)}[op]
    result = torch.library.opcheck(getattr(torch.ops.mm_distillnet,
                                           op).default, operands)
    assert set(result.values()) == {'SUCCESS'}, result


def test_exported_matches_the_jax_artifact(weights, tmp_path):
    """The JAX package's exported StableHLO predictor and the port's
    exported program, on the same weights and images: the serving parity
    bounds of tests/test_torch_serving.py (the port's unfused fp32 plan,
    the JAX predictor's fp32 model)."""
    model, v, sd, x = weights
    jpath = str(tmp_path / 'predictor.stablehlo')
    jax_export(jax_serving_fn(model, to_jax(v), SIZE, **KW), BATCH, SIZE, 8,
               jpath)
    want = jax_load(jpath)(jnp.asarray(x))
    port = make_serving_fn(EfficientDet(20, -1, 8), sd, SIZE,
                           plan_spec='flax:0-99', dtype=torch.float32,
                           device='cpu', **KW)
    path = str(tmp_path / 'predictor.pt2')
    export_predictor(port, BATCH, SIZE, 8, path)
    got = load_predictor(path, device='cpu')(x)
    assert got.valid.any()
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.classes.numpy(),
                                  np.asarray(want.classes))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=1e-5, atol=1e-5)
