"""The port's model registry and checkpoint loading against the
reference's (mirroring tests/test_generator_wiring.py,
tests/test_zoo_bootstrap.py and tests/test_data_and_convert.py): module
keys and shapes for every registry name and modality, a reference-layout
.pth (in a 'state_dict' wrapper, keys prefixed 'module.') loaded by both
registries with the same forward (rtol = atol = 1e-4, the tolerance of
test_torch_detector.py), strict teacher loads, the generator <-> plain
alternate keys, the model-zoo bootstrap with and without the stem swap,
and the checkpoint formats the port reads and refuses.

The reference registry's random init is a jitted `model.init` (about a
minute per network on the CPU); its values are overwritten by the strict
loads compared here, so the tests fill the same tree from numpy instead
(tests/helpers.py `fast_init`); the package is not changed.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm_distillnet_tpu.config import default_config as jax_default_config
from mm_distillnet_tpu.convert import torch_weights as jax_tw
from mm_distillnet_tpu.models import registry as jax_registry
from mm_distillnet_tpu.models.efficientdet import EfficientDet as JaxDet
from mm_distillnet_tpu.models.efficientdet_generator import \
    EfficientDetGenerator as JaxGenerator
from mm_distillnet_torch.config import default_config
from mm_distillnet_torch.convert import weights
from mm_distillnet_torch.convert.weights import (flatten_variables,
                                                 state_dict_from_flax,
                                                 torch_key_for)
from mm_distillnet_torch.distill.train_step import TrainState
from mm_distillnet_torch.models import registry
from mm_distillnet_torch.models.efficientdet import EfficientDet
from mm_distillnet_torch.models.efficientdet_generator import \
    EfficientDetGenerator
from mm_distillnet_torch.models.stereosoundnet import StereoSoundNet
from mm_distillnet_torch.train.checkpoint import save_checkpoint

from .helpers import fast_init
from .test_torch_helpers import filled_variables, to_jax
from .test_torch_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread')

SIZE = 128
TOL = dict(rtol=1e-4, atol=1e-4)
MODALITIES = ('rgb', 'thermal', 'depth', 'audio_static', 'audio_student')
# the generator's modalities come from these flags: audio, rgb, thermal
FLAGS = dict(use_rgb=True, use_thermal=True, use_depth=False, use_audio=True)
SETTINGS = dict(image_size=SIZE, compound_coef=-1, compute_dtype='float32',
                **FLAGS)


def _configs(tmp, **extra):
    values = dict(SETTINGS, saved_path=str(tmp), **extra)
    return default_config(**values), jax_default_config(**values)


def _channels(model_type, modality):
    ch = registry.MODALITY_CHANNELS[modality]
    if model_type.endswith('_input8'):
        return 8
    if model_type.endswith('_input1'):
        return 1
    return ch


def _jax_dummy(module, channels, batch=1):
    if isinstance(module, JaxGenerator):
        dims = jax_registry.get_data_dim_from_config(
            jax_default_config(**SETTINGS))
        return {m: jnp.zeros((batch, SIZE, SIZE, c)) for m, c in dims.items()}
    return jnp.zeros((batch, SIZE, SIZE, channels))


def _jax_shapes(model_type, channels):
    """{torch key: shape} of the reference's variables, the 4-D kernels
    in torch's OIHW order."""
    if jax_registry._is_generator_type(model_type):
        return _shapes_of('generator', None)   # inputs from the config
    if 'StereoSoundNet' in model_type:
        return _shapes_of('StereoSoundNet', channels)
    return _shapes_of('YetAnotherEfficientDet_D2', channels)


@functools.lru_cache(maxsize=None)
def _shapes_of(kind, channels):
    module = jax_registry.build_model(
        'YetAnotherEfficientDet_D2_audio' if kind == 'generator' else kind,
        jax_default_config(**SETTINGS))
    tree = jax.eval_shape(module.init, jax.random.PRNGKey(0),
                          _jax_dummy(module, channels))
    out = {}
    for coll in tree:
        for path, leaf in flatten_variables(tree[coll]):
            shape = tuple(leaf.shape)
            if len(shape) == 4:
                shape = (shape[3], shape[2], shape[0], shape[1])
            out[torch_key_for(path, coll)] = shape
    return out


@pytest.mark.parametrize('modality', MODALITIES)
@pytest.mark.parametrize('model_type', registry.KNOWN_MODEL_TYPES)
def test_keys_and_shapes_match_the_reference(tmp_path, model_type,
                                             modality):
    """Without checkpoint files: the port's (module, state_dict) has the
    reference's torch keys and shapes (BatchNorm's num_batches_tracked
    aside), fp32 whatever the compute dtype, and the module holds it."""
    config, _ = _configs(tmp_path, compute_dtype='bfloat16')
    module, sd = registry.load_model(model_type, config, modality)
    got = {k: tuple(v.shape) for k, v in sd.items()
           if not k.endswith('num_batches_tracked')}
    assert got == _jax_shapes(model_type, _channels(model_type, modality))
    assert all(v.dtype in (torch.float32, torch.long) for v in sd.values())
    generator = jax_registry._is_generator_type(model_type)
    assert registry._is_generator_type(model_type) == generator
    assert isinstance(module, EfficientDetGenerator) == generator
    assert isinstance(module, StereoSoundNet) == \
        ('StereoSoundNet' in model_type)
    held = module.state_dict()
    assert all(torch.equal(v, held[k]) for k, v in sd.items())


def _reference_pth(variables, path, prefix='module.', wrap=True, shift=0.0):
    """A .pth in the reference's layout from a JAX variable tree: keys by
    the reference converter's rule, OIHW kernels, DataParallel prefix,
    {'state_dict': ..., 'epoch': ...} wrapper."""
    sd = {}
    for coll in variables:
        for path_, leaf in flatten_variables(variables[coll]):
            arr = np.asarray(leaf, np.float32) + shift
            if arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            key = jax_tw._torch_key_for(path_, coll)
            sd[prefix + key] = torch.from_numpy(np.ascontiguousarray(arr))
    torch.save({'epoch': 3, 'state_dict': sd} if wrap else sd, str(path))
    return sd


def _fast_jax_init(model, in_channels, image_size, seed=0, config=None):
    if isinstance(model, JaxGenerator):
        dims = jax_registry.get_data_dim_from_config(config)
        dummy = {m: jnp.zeros((1, image_size, image_size, c))
                 for m, c in dims.items()}
    else:
        dummy = jnp.zeros((1, image_size, image_size, in_channels))
    return fast_init(model, seed, dummy)


# a registry modality with a checkpoint file for each name
LOAD_CASES = (('YetAnotherEfficientDet_D2', 'rgb'),
              ('YetAnotherEfficientDet_D2_embedding', 'audio_static'),
              ('YetAnotherEfficientDet_D2_input8', 'rgb'),
              ('YetAnotherEfficientDet_D2_input1', 'depth'),
              ('YetAnotherEfficientDetGenerator_D2', 'thermal'),
              ('YetAnotherEfficientDetGenerator_D2_STATIC', 'audio_static'),
              ('YetAnotherEfficientDet_D2_audio', 'audio_static'),
              ('StereoSoundNet', 'audio_static'))


@pytest.mark.parametrize('model_type,modality', LOAD_CASES)
def test_reference_pth_loads_into_both_registries(tmp_path, monkeypatch,
                                                  model_type, modality):
    """A seeded reference-layout file under the registry's name is loaded
    strictly by both registries; the forwards agree. The embedding
    student also takes the partial embedding file (its classifier
    only)."""
    monkeypatch.setattr(jax_registry, 'init_variables', _fast_jax_init)
    config, jcfg = _configs(tmp_path)
    channels = _channels(model_type, modality)
    module = jax_registry.build_model(model_type, jcfg)
    seed = 100 + LOAD_CASES.index((model_type, modality))
    x = _jax_dummy(module, channels)
    variables = filled_variables(module, seed, x)
    name = registry.MODALITY_CHECKPOINTS[modality]
    _reference_pth(variables, tmp_path / name)
    if 'embedding' in model_type:
        emb = {k: v for k, v in _reference_pth(
            variables, tmp_path / 'scratch.pth', shift=0.5).items()
            if k.startswith('module.classifier.')}
        torch.save(emb, str(tmp_path / registry.EMBEDDING_CHECKPOINT))

    jmod, jvars = jax_registry.load_model(model_type, jcfg, modality)
    port, sd = registry.load_model(model_type, config, modality)
    want_sd = state_dict_from_flax(jvars)
    assert set(want_sd) == set(sd)
    for k, v in want_sd.items():
        np.testing.assert_array_equal(sd[k].numpy(), v.numpy(), err_msg=k)
    if 'embedding' in model_type:   # the partial load happened
        k = 'classifier.header.pointwise_conv.conv.bias'
        np.testing.assert_allclose(
            sd[k].numpy(),
            state_dict_from_flax(variables)[k].numpy() + 0.5, rtol=1e-6)

    rng = np.random.default_rng(seed)
    if isinstance(port, StereoSoundNet):    # a fully convolutional net
        x = x[:, :64, :64]
    if isinstance(x, dict):
        inputs = {m: rng.standard_normal((2,) + a.shape[1:]).astype(
            np.float32) for m, a in x.items()}
        jx = {m: jnp.asarray(a) for m, a in inputs.items()}
        tx = {m: torch.from_numpy(a) for m, a in inputs.items()}
    else:
        inputs = rng.standard_normal((2,) + x.shape[1:]).astype(np.float32)
        jx, tx = jnp.asarray(inputs), torch.from_numpy(inputs)
    want = jmod.apply(to_jax(jvars), jx, train=False)
    with torch.no_grad():
        got = port.eval()(tx)
    if isinstance(port, StereoSoundNet):
        pairs = list(zip(got, want))
    else:
        pairs = [(getattr(got, f), getattr(want, f))
                 for f in ('classification', 'regression', 'logits',
                           'align_features')]
    for g, w in pairs:
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_strict_teacher_load_raises(tmp_path):
    """A teacher file with a drifted key map fails hard in the port as in
    the reference; non-strict loads keep the lenient behaviour."""
    config, _ = _configs(tmp_path)
    _, sd = registry.load_model('YetAnotherEfficientDet_D2', config,
                                'audio_student')
    path = tmp_path / 'corrupt.pth'
    torch.save({'definitely_not_a_real_key': torch.zeros(3)}, str(path))
    with pytest.raises(ValueError, match='unmatched'):
        registry.maybe_load_checkpoint(str(path), sd, strict=True)
    assert registry.maybe_load_checkpoint(str(path), sd, strict=False) \
        is not None
    # a full teacher file less one tensor: the registry refuses the teacher
    # (the audio teacher has the student's 8 input channels)
    teacher_file = str(tmp_path / registry.MODALITY_CHECKPOINTS[
        'audio_static'])
    full = {f'module.{k}': v for k, v in sd.items()}
    del full['module.classifier.header.pointwise_conv.conv.bias']
    torch.save({'state_dict': full}, teacher_file)
    with pytest.raises(ValueError, match=r"\['classifier.header"):
        registry.load_model('YetAnotherEfficientDet_D2', config,
                            'audio_static')
    # num_batches_tracked is neither a parameter nor a statistic
    torch.save({k: v for k, v in sd.items()
                if not k.endswith('num_batches_tracked')}, teacher_file)
    _, loaded = registry.load_model('YetAnotherEfficientDet_D2', config,
                                    'audio_static')
    assert torch.equal(loaded['classifier.header.pointwise_conv.conv.bias'],
                       sd['classifier.header.pointwise_conv.conv.bias'])


def test_plain_checkpoint_fills_generator_slots():
    """A plain detector's backbone + BiFPN fill every per-modality slot of
    a generator (the reference's filter_model_dict), the same tensors as
    the reference converter picks; heads of other widths stay."""
    jgen = JaxGenerator(modalities=('audio', 'rgb'), num_classes=4,
                        compound_coef=-1, dtype=jnp.float32)
    inputs = {'rgb': jnp.zeros((1, SIZE, SIZE, 3)),
              'audio': jnp.zeros((1, SIZE, SIZE, 3))}
    variables = jax.tree_util.tree_map(np.asarray,
                                       fast_init(jgen, 0, inputs))
    plain = {}
    for coll in variables:
        for path, leaf in flatten_variables(variables[coll]):
            if path[0] not in ('backbone_net_rgb', 'bifpn_rgb'):
                continue
            key = torch_key_for(path, coll).replace(
                'model_backbones.rgb.', 'backbone_net.').replace(
                'model_necks.rgb.', 'bifpn.')
            arr = np.asarray(leaf, np.float64) + 0.25
            if arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            plain[key] = torch.tensor(arr)
    want, jreport = jax_tw.convert_state_dict(plain, variables, strict=False)
    port = EfficientDetGenerator(('audio', 'rgb'), 4, -1,
                                 in_channels={'audio': 3, 'rgb': 3})
    template = port.state_dict()
    got, report = weights.convert_reference_state_dict(plain, template,
                                                       strict=False)
    want_sd = state_dict_from_flax(want)
    for k, v in got.items():
        if k.endswith('num_batches_tracked'):
            continue
        if k.startswith(('model_backbones.', 'model_necks.')):
            np.testing.assert_allclose(v.numpy(), want_sd[k].numpy(),
                                       rtol=1e-6, err_msg=k)
        else:
            assert torch.equal(v, template[k]), k
    assert len(report['missing']) == len(jreport['missing'])
    with pytest.raises(ValueError, match='unmatched'):
        weights.convert_reference_state_dict(plain, template, strict=True)


def _zoo_state_dict(template, rng):
    """A zoo-layout checkpoint ('_conv_stem.weight', no '.conv' level)
    with the shapes of the template's backbone and fresh values, plus the
    zoo's classification head."""
    sd = {}
    for k, v in template.items():
        if not k.startswith('backbone_net.model.') or \
                k.endswith('num_batches_tracked'):
            continue
        zkey = k[len('backbone_net.model.'):].replace(
            '.conv.weight', '.weight').replace('.conv.bias', '.bias')
        sd[zkey] = rng.standard_normal(tuple(v.shape)).astype(np.float32)
    sd['_conv_head.weight'] = rng.standard_normal((1280, 320, 1, 1)).astype(
        np.float32)
    sd['_bn1.weight'] = rng.standard_normal((1280,)).astype(np.float32)
    sd['_fc.weight'] = rng.standard_normal((1000, 1280)).astype(np.float32)
    sd['_blocks.0._bn1.num_batches_tracked'] = np.asarray(7)
    return sd


@pytest.mark.parametrize('channels', [3, 1, 8])
def test_zoo_bootstrap_matches_the_reference(channels):
    """A 3-channel zoo file: every backbone tensor loads, BiFPN and heads
    keep their values, the zoo's head is ignored; 1- and 8-channel stems
    keep their init (the stem swap). The same tensors as the reference's
    bootstrap."""
    zoo = _zoo_state_dict(EfficientDet(20, -1, 3).state_dict(),
                          np.random.default_rng(42))
    torch.manual_seed(channels)
    template = EfficientDet(20, -1, channels).state_dict()
    got, report = weights.bootstrap_backbone_from_zoo(zoo, template)
    assert report['stem_swapped'] is (channels != 3)
    assert not report['backbone_missing']
    assert not any('_fc' in k or '_conv_head' in k or '_bn1.' in k
                   for k in report['unused']), report['unused']

    jmod = JaxDet(num_classes=20, compound_coef=-1)
    jvars = fast_init(jmod, 1, jnp.zeros((1, SIZE, SIZE, channels)))
    jvars = jax.tree_util.tree_map(np.asarray, jvars)
    want_vars, jreport = jax_tw.bootstrap_backbone_from_zoo(zoo, jvars)
    assert jreport['stem_swapped'] is report['stem_swapped']
    want = state_dict_from_flax(want_vars)
    stem = 'backbone_net.model._conv_stem.conv.weight'
    block = 'backbone_net.model._blocks.0._project_conv.conv.weight'
    for k, v in got.items():
        if k.endswith('num_batches_tracked'):
            continue
        loaded = k.startswith('backbone_net.') and \
            not (channels != 3 and k == stem)
        if loaded:
            np.testing.assert_array_equal(v.numpy(), want[k].numpy(),
                                          err_msg=k)
        else:
            assert torch.equal(v, template[k]), k
    np.testing.assert_array_equal(got[block].numpy(),
                                  zoo['_blocks.0._project_conv.weight'])
    assert got[stem].shape[1] == channels


def test_registry_backbone_pretrained(tmp_path):
    """backbone_pretrained=<zoo .pth> bootstraps the 8-channel student
    (stem swapped); a missing file raises."""
    zoo = _zoo_state_dict(EfficientDet(20, -1, 3).state_dict(),
                          np.random.default_rng(3))
    path = tmp_path / 'efficientnet-zoo.pth'
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in zoo.items()},
               str(path))
    config, _ = _configs(tmp_path, backbone_pretrained=str(path))
    _, sd = registry.load_model('YetAnotherEfficientDet_D2', config,
                                'audio_student')
    np.testing.assert_array_equal(
        sd['backbone_net.model._blocks.0._project_conv.conv.weight'].numpy(),
        zoo['_blocks.0._project_conv.weight'])
    assert sd['backbone_net.model._conv_stem.conv.weight'].shape[1] == 8
    bad, _ = _configs(tmp_path, backbone_pretrained='/nonexistent/b2.pth')
    with pytest.raises(FileNotFoundError):
        registry.load_model('YetAnotherEfficientDet_D2', bad,
                            'audio_student')


@pytest.mark.parametrize('flags', [
    dict(use_rgb=False, use_thermal=True, use_depth=True, use_audio=False),
    dict(use_rgb=False, use_thermal=False, use_depth=False,
         use_audio=False),
    dict(use_rgb=True, use_thermal=True, use_depth=True, use_audio=True),
    dict()])
def test_get_data_dim_from_config_matches_the_reference(flags):
    assert registry.get_data_dim_from_config(default_config(**flags)) == \
        jax_registry.get_data_dim_from_config(jax_default_config(**flags))
    assert registry.get_data_dim_from_config(None) == \
        jax_registry.get_data_dim_from_config(None)


def test_dispatch_and_unknown_names(tmp_path):
    """'_STATIC' builds the plain detector, '_audio' the generator; the
    shipped config's quoted integration_mode is read; unknown names and
    modalities raise."""
    config, _ = _configs(tmp_path, integration_mode="'switch'")
    assert isinstance(registry.build_model(
        'YetAnotherEfficientDetGenerator_D2_STATIC', config), EfficientDet)
    gen = registry.build_model('YetAnotherEfficientDet_D2_audio', config)
    assert isinstance(gen, EfficientDetGenerator)
    assert gen.integration_mode == 'switch'
    assert gen.ordered_modalities == ('audio', 'rgb', 'thermal')
    with pytest.raises(ValueError, match='Unsupported model type'):
        registry.load_model('ResNet50', config)
    with pytest.raises(ValueError, match='modality'):
        registry.load_model('YetAnotherEfficientDet_D2', config, 'sonar')
    # the seed decides the random init, the global generator is untouched
    state = torch.random.get_rng_state()
    a = registry.load_model('YetAnotherEfficientDet_D2', config, seed=1)[1]
    b = registry.load_model('YetAnotherEfficientDet_D2', config, seed=1)[1]
    c = registry.load_model('YetAnotherEfficientDet_D2', config, seed=2)[1]
    k = 'backbone_net.model._conv_stem.conv.weight'
    assert torch.equal(a[k], b[k]) and not torch.equal(a[k], c[k])
    assert torch.equal(state, torch.random.get_rng_state())


def test_wrappers_and_alternate_keys_match_the_reference():
    sd = {'module.backbone_net.x': 1, 'student_model.bifpn.y': 2,
          'model.module.classifier.z': 3}
    for wrap in ('state_dict', 'model', 'model_state_dict', None):
        ckpt = {wrap: sd, 'epoch': 1} if wrap else sd
        assert weights.strip_wrapper_prefixes(ckpt) == \
            jax_tw.strip_wrapper_prefixes(ckpt)
    for key in ('model_backbones.rgb.model._bn0.weight',
                'model_necks.audio.0.p6_w1', 'backbone_net.model._bn0.bias',
                'bifpn.1.conv6_up.bn.running_var', 'classifier.header.x'):
        assert weights.alternate_keys(key) == jax_tw._alternate_keys(key)


def test_port_and_reference_checkpoint_formats(tmp_path):
    """maybe_load_checkpoint reads a .pth.tar with a 'state_dict' wrapper
    and the port's own checkpoint.{rank} / best.{rank}; a JAX orbax
    directory or .npz file raises instead of leaving a random init; an
    absent file leaves the init."""
    torch.manual_seed(0)
    net = EfficientDet(20, -1, 8)
    fresh = EfficientDet(20, -1, 8).state_dict()
    config, _ = _configs(tmp_path, exp_name=str(tmp_path / 'run'))
    state = TrainState(0, net, torch.optim.SGD(net.parameters(), lr=0.1))
    save_checkpoint(config, state, 0, 1.0, 0, {}, rank=0, is_best=True)
    torch.save({'epoch': 7, 'state_dict': {f'module.{k}': v for k, v in
                                           net.state_dict().items()},
                'optimizer': {}}, str(tmp_path / 'checkpoint.0.pth.tar'))
    for name in ('run/checkpoint.0', 'run/best.0', 'checkpoint.0.pth.tar'):
        loaded = registry.maybe_load_checkpoint(str(tmp_path / name), fresh,
                                                strict=True)
        for k, v in net.state_dict().items():
            assert torch.equal(loaded[k], v), (name, k)
    # into a module in place
    other = EfficientDet(20, -1, 8)
    report = weights.load_reference_checkpoint(
        str(tmp_path / 'checkpoint.0.pth.tar'), other)
    assert report == {'missing': [], 'unused': []}
    for k, v in net.state_dict().items():
        assert torch.equal(other.state_dict()[k], v), k
    os.makedirs(tmp_path / 'orbax.pth')
    with pytest.raises(ValueError, match='orbax'):
        registry.maybe_load_checkpoint(str(tmp_path / 'orbax.pth'), fresh)
    with open(tmp_path / 'best.1', 'wb') as f:
        np.savez(f, **{"['params']['x']": np.zeros(3)})
    with pytest.raises(ValueError, match='npz'):
        registry.maybe_load_checkpoint(str(tmp_path / 'best.1'), fresh)
    assert registry.maybe_load_checkpoint(str(tmp_path / 'none.pth'),
                                          fresh) is fresh
