"""The port's batch sharding inside one process (parallel/mesh.py: a tuple
of devices, one replica per device) against the JAX package's SPMD `data`
mesh: `make_predict_fn`, `make_fused_teacher_fn` and `make_serving_fn`
with `mesh=(cpu, cpu)` and an odd batch against the JAX functions on
`create_mesh(2)` of the conftest's virtual CPU devices (the JAX side fed
the batch padded by its own `pad_batch_to_devices`, its rows cut back) and
against the port without a mesh; `evaluate(eval_devices=2)` capped to the
CPU's one device; and the mesh helpers themselves. Test-tiny profile, 128
px, fp32 weights shared through numpy."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from mm_distillnet_tpu import evaluation as jax_eval
from mm_distillnet_tpu.config import default_config as jax_default_config
from mm_distillnet_tpu.models.efficientdet import EfficientDet as JaxDet
from mm_distillnet_tpu.ops.postprocess import \
    class_validity_table as jax_class_table
from mm_distillnet_tpu.parallel import mesh as jax_mesh
from mm_distillnet_tpu.serving import make_serving_fn as jax_serving_fn
from mm_distillnet_torch import evaluation as ev
from mm_distillnet_torch.config import default_config
from mm_distillnet_torch.convert.weights import state_dict_from_flax
from mm_distillnet_torch.data.synthetic import SyntheticMultimodal
from mm_distillnet_torch.device import resolve_device
from mm_distillnet_torch.models.efficientdet import EfficientDet
from mm_distillnet_torch.ops import fused_mbconv
from mm_distillnet_torch.parallel import mesh
from mm_distillnet_torch.serving import make_serving_fn

from .test_torch_helpers import filled_variables, nhwc_input, to_jax
from .test_torch_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread')

SIZE = 128
BATCH = 3               # odd: the mesh of 2 pads it
CPU2 = (torch.device('cpu'), torch.device('cpu'))
CHANNELS = {'rgb': 3, 'thermal': 1, 'depth': 3, 'audio': 8}
TEACHERS = ('rgb', 'thermal', 'depth')
SETTINGS = dict(
    image_size=SIZE, synthetic_size=6, batch_size=2, num_workers=1,
    fast_run=False, use_rgb=True, use_thermal=True, use_depth=True,
    max_gt=16, nms_candidates=64, max_det_per_teacher=8, max_detections=16,
    compute_dtype='float32', rank=0, eval_devices=1,
    device_audio_resize=True)
SERVE = dict(num_candidates=64, max_detections=16)


@pytest.fixture(scope='module')
def nets():
    out = {}
    for seed, (m, ch) in enumerate(CHANNELS.items()):
        jmod = JaxDet(num_classes=20, compound_coef=-1, dtype=jnp.float32)
        v = filled_variables(jmod, 30 + seed,
                             nhwc_input(0, (1, SIZE, SIZE, ch)))
        out[m] = (jmod, v, EfficientDet(20, -1, ch),
                  state_dict_from_flax(v))
    batch = {m: nhwc_input(40 + i, (BATCH, SIZE, SIZE, c))
             for i, (m, c) in enumerate(CHANNELS.items())}
    # the compact audio ingest: 80 mel rows, stretched on the device
    batch['audio'] = nhwc_input(50, (BATCH, 80, SIZE, 8))
    return out, batch


def _jax_on_mesh(fn, x, *rest):
    """A JAX function jitted over create_mesh(2), fed the batch padded by
    the JAX package's own pad_batch_to_devices and placed on the data
    sharding; its first BATCH rows."""
    m2 = jax_mesh.create_mesh(2)
    padded, n = jax_mesh.pad_batch_to_devices(x, 2)
    assert n == BATCH
    data = NamedSharding(m2, P('data'))
    out = fn(m2)(*rest[:1], jax.device_put(padded, data), *rest[1:])
    return jax.tree_util.tree_map(lambda a: np.asarray(a)[:BATCH], out)


def _tables():
    return (jax_class_table(20, list(range(20))), np.arange(20))


def _equal_rows(got, want):
    """The same valid rows and labels, boxes within 1 px (floor()-ed fp32
    coordinates may fall on either side of an integer), scores within
    1e-4: the bounds of tests/test_torch_evaluation.py."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert (want[..., -1] != -1).sum() >= 1, 'the comparison needs rows'
    np.testing.assert_array_equal(got[..., -1], want[..., -1])
    np.testing.assert_allclose(got[..., :4], want[..., :4], atol=1.0)
    if got.shape[-1] == 6:
        np.testing.assert_allclose(got[..., 4], want[..., 4], atol=1e-4)


def test_sharded_predict_fn_matches_jax_and_the_unsharded_port(nets):
    nets, batch = nets
    jmod, v, module, sd = nets['audio']
    jcfg = jax_default_config(exp_name='mesh-jax', **SETTINGS)
    tcfg = default_config(exp_name='mesh-torch', **SETTINGS)
    class_valid, lut = _tables()
    want_rows, want_feats = _jax_on_mesh(
        lambda m2: jax_eval.make_predict_fn(jmod, SIZE, jcfg, mesh=m2),
        batch['audio'], to_jax(v), jnp.asarray(class_valid),
        jnp.asarray(lut))
    sharded = ev.make_predict_fn(module, SIZE, tcfg, variables=sd,
                                 mesh=CPU2)
    rows, feats = sharded(sd, batch['audio'], class_valid, lut)
    assert tuple(rows.shape) == (BATCH, 16, 6)
    _equal_rows(rows.numpy(), want_rows)
    for g, w in zip(feats, want_feats):
        assert g.shape[0] == BATCH
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-3, atol=1e-4)
    plain = ev.make_predict_fn(module, SIZE, tcfg, variables=sd,
                               device='cpu')
    rows1, feats1 = plain(sd, batch['audio'], class_valid, lut)
    _equal_rows(rows.numpy(), rows1.numpy())
    for g, w in zip(feats, feats1):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)


def test_sharded_fused_teacher_fn_matches_jax_and_the_unsharded_port(nets):
    nets, batch = nets
    jcfg = jax_default_config(exp_name='mesh-jax', **SETTINGS)
    tcfg = default_config(exp_name='mesh-torch', **SETTINGS)
    class_valid, lut = _tables()
    want = _jax_on_mesh(
        lambda m2: jax_eval.make_fused_teacher_fn(
            {m: nets[m][0] for m in TEACHERS}, SIZE, jcfg, mesh=m2),
        {m: batch[m] for m in TEACHERS},
        {m: to_jax(nets[m][1]) for m in TEACHERS}, jnp.asarray(class_valid),
        jnp.asarray(lut))
    t_vars = {m: nets[m][3] for m in TEACHERS}
    modules = {m: nets[m][2] for m in TEACHERS}
    sharded = ev.make_fused_teacher_fn(modules, SIZE, tcfg, mesh=CPU2,
                                       teacher_variables=t_vars)
    got = sharded(t_vars, batch, class_valid, lut)
    assert tuple(got.shape) == (BATCH, 16, 5)
    _equal_rows(got.numpy(), want)
    plain = ev.make_fused_teacher_fn(modules, SIZE, tcfg,
                                     teacher_variables=t_vars, device='cpu')
    assert torch.equal(got, plain(t_vars, batch, class_valid, lut))


def test_sharded_serving_fn_matches_jax_and_the_unsharded_port(nets):
    nets, batch = nets
    jmod, v, module, sd = nets['audio']
    x = nhwc_input(60, (BATCH, SIZE, SIZE, 8))
    want = _jax_on_mesh(lambda m2: jax_serving_fn(jmod, to_jax(v), SIZE,
                                                  mesh=m2, **SERVE), x)
    sharded = make_serving_fn(module, sd, SIZE, plan_spec='flax:0-99',
                              dtype=torch.float32, mesh=CPU2, **SERVE)
    got = sharded(x)
    assert got.valid.shape == (BATCH, 16) and bool(got.valid.any())
    np.testing.assert_array_equal(got.valid.numpy(), want.valid)
    np.testing.assert_array_equal(got.classes.numpy(), want.classes)
    np.testing.assert_allclose(got.boxes.numpy(), want.boxes, rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(got.scores.numpy(), want.scores, rtol=1e-5,
                               atol=1e-5)
    plain = make_serving_fn(module, sd, SIZE, plan_spec='flax:0-99',
                            dtype=torch.float32, device='cpu', **SERVE)
    for g, w in zip(got, plain(x)):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


def test_sharded_fused_inference_runs_every_replica(nets):
    """fused_inference=True over the mesh: each replica folds its weights
    and runs the blocks' plain versions on the CPU (no kernel counted);
    the rows equal the unsharded fused predictor's."""
    nets, batch = nets
    _, _, module, sd = nets['audio']
    tcfg = default_config(exp_name='mesh-fused', fused_inference=True,
                          **SETTINGS)
    class_valid, lut = _tables()
    fused_mbconv.reset_launches()
    sharded = ev.make_predict_fn(module, SIZE, tcfg, variables=sd,
                                 mesh=CPU2)
    rows, _ = sharded(None, batch['audio'], class_valid, lut)
    plain = ev.make_predict_fn(module, SIZE, tcfg, variables=sd,
                               device='cpu')
    want, _ = plain(None, batch['audio'], class_valid, lut)
    _equal_rows(rows.numpy(), want.numpy())
    assert all(v == 0 for v in fused_mbconv.launches.values())


def test_eval_devices_caps_at_the_process_devices(nets, tmp_path,
                                                  monkeypatch):
    """evaluate(eval_devices=2) on the CPU: one device, no mesh; the same
    table as eval_devices=1 (the JAX package caps at its local devices
    the same way)."""
    monkeypatch.chdir(tmp_path)
    nets, _ = nets
    built = []
    monkeypatch.setattr(ev.meshes, 'over_mesh',
                        lambda *a, **k: built.append(a) or None)
    tables = []
    for n in (1, 2):
        cfg = default_config(exp_name=f'cap{n}',
                             **{**SETTINGS, 'eval_devices': n})
        tables.append(ev.evaluate(
            {m: (nets[m][2], nets[m][3]) for m in TEACHERS},
            (nets['audio'][2], nets['audio'][3]),
            SyntheticMultimodal(cfg, 'test'), cfg, device='cpu'))
    assert not built
    assert [{k: v for k, v in r.items() if k != 'exp_name'}
            for r in tables[0]] == \
        [{k: v for k, v in r.items() if k != 'exp_name'} for r in tables[1]]


def test_pad_shard_and_gather():
    x = torch.arange(10.).reshape(5, 2)
    tree = {'a': x, 'b': [x.numpy() * 2]}
    padded, n = mesh.pad_batch_to_devices(tree, 2)
    assert n == 5 and padded['a'].shape == (6, 2)
    assert torch.equal(padded['a'][5], x[4])
    np.testing.assert_array_equal(padded['b'][0][5], x[4].numpy() * 2)
    parts = mesh.shard_batch(CPU2, padded)
    assert [p['a'].shape[0] for p in parts] == [3, 3]
    assert isinstance(parts[1]['b'][0], torch.Tensor)
    back = mesh.gather_batch(parts, 'cpu', n)
    assert torch.equal(back['a'], x)
    with pytest.raises(ValueError, match='pad it first'):
        mesh.shard_batch(CPU2, x)
    same, n = mesh.pad_batch_to_devices(x[:4], 2)
    assert n == 4 and same.shape[0] == 4
    copies = mesh.replicate(CPU2, {'w': np.ones(3, np.float32)})
    assert len(copies) == 2 and copies[1]['w'].dtype == torch.float32


def test_meshes_and_devices_on_the_cpu():
    assert mesh.create_mesh(devices=['cpu', 'cpu', 'cpu'], num_devices=2) \
        == CPU2
    assert mesh.local_devices('cpu') == [torch.device('cpu')]
    assert resolve_device('cpu') == torch.device('cpu')
    with pytest.raises(ValueError, match='at least one'):
        mesh.create_mesh(devices=[])
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    for fn in (mesh.create_mesh, lambda: resolve_device('cuda:1')):
        with pytest.raises(RuntimeError, match='CUDA'):
            fn()
