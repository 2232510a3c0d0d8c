"""The port's serving surface against the reference's, plus the package's
isolation from JAX and its refusal to fall back to the CPU silently."""
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm_distillnet_tpu.models.efficientdet import EfficientDet as JaxDet
from mm_distillnet_tpu.serving import make_serving_fn as jax_serving_fn
from mm_distillnet_torch.convert.weights import state_dict_from_flax
from mm_distillnet_torch.models.efficientdet import EfficientDet
from mm_distillnet_torch.models.fused_forward import make_fused_predictor
from mm_distillnet_torch.serving import make_serving_fn, serve_many

from .test_torch_helpers import filled_variables, nhwc_input, to_jax

SIZE = 128
BATCH = 2
KW = dict(num_candidates=64, max_detections=16)
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope='module')
def served():
    model = JaxDet(num_classes=20, compound_coef=-1, dtype=jnp.float32)
    x = nhwc_input(0, (BATCH, SIZE, SIZE, 8))
    v = filled_variables(model, 1, x)
    want = jax_serving_fn(model, to_jax(v), SIZE, **KW)(jnp.asarray(x))
    sd = state_dict_from_flax(v)
    port = make_serving_fn(EfficientDet(20, -1, 8), sd, SIZE,
                           plan_spec='flax:0-99', dtype=torch.float32,
                           device='cpu', **KW)
    return port, x, want


def test_serving_fn_matches_reference(served):
    port, x, want = served
    got = port(x)
    assert got.valid.any(), 'the comparison needs valid detections'
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.classes.numpy(),
                                  np.asarray(want.classes))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=1e-5, atol=1e-5)


def test_serve_many_pads_and_chunks(served):
    """5 images through a batch-2 predictor: 3 chunks, the tail padded;
    each row equals the direct prediction of its chunk."""
    port, _, _ = served
    images = nhwc_input(7, (5, SIZE, SIZE, 8))
    got = serve_many(port, images, BATCH)
    assert got.boxes.shape == (5, 16, 4) and got.valid.shape == (5, 16)
    for start in range(0, 5, BATCH):
        chunk = images[start:start + BATCH]
        real = chunk.shape[0]
        if real < BATCH:
            chunk = np.concatenate([chunk, np.zeros_like(chunk)], axis=0)
        direct = port(chunk)
        for field, d in zip(got, direct):
            np.testing.assert_array_equal(field[start:start + real],
                                          d[:real].numpy())


def test_serving_rejects_other_heights(served):
    port, _, _ = served
    # 80 mel rows are the compact-audio ingest and are stretched; any other
    # height is a malformed batch
    assert port(np.zeros((1, 80, SIZE, 8), np.float32)).boxes.shape[0] == 1
    with pytest.raises(ValueError, match='neither image_size'):
        port(np.zeros((1, 64, SIZE, 8), np.float32))


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip('this machine has CUDA')
    model = EfficientDet(20, -1, 8)
    sd = model.state_dict()
    with pytest.raises(RuntimeError, match='CUDA'):
        make_serving_fn(model, sd, SIZE)
    with pytest.raises(RuntimeError, match='CUDA'):
        make_fused_predictor(model, sd, SIZE)


def test_port_imports_nothing_of_jax():
    """Importing every module of the port (and chip_smoke) in a fresh
    interpreter leaves jax, flax, mm_distillnet_tpu, cv2 and PIL out of
    sys.modules: the machine with the card has neither cv2 nor PIL."""
    code = (
        'import importlib, pkgutil, sys\n'
        'import mm_distillnet_torch as p\n'
        'names = [m.name for m in pkgutil.walk_packages(p.__path__, '
        '"mm_distillnet_torch.")]\n'
        'for n in names: importlib.import_module(n)\n'
        'import chip_smoke\n'
        'bad = sorted(m for m in sys.modules if m.split(".")[0] in '
        '("jax", "jaxlib", "flax", "mm_distillnet_tpu", "cv2", "PIL"))\n'
        'print(len(names), bad)\n'
        'sys.exit(1 if bad or len(names) < 12 else 0)\n')
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip('this machine has CUDA')
    out = subprocess.run([sys.executable, 'chip_smoke.py'], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
