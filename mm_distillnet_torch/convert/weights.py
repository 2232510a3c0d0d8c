"""Carry weights into the port: from the JAX package's variable tree, from
the reference's .pth checkpoints and from model-zoo EfficientNet files.

`state_dict_from_flax` takes the reference's `{'params', 'batch_stats'}`
tree (nested mappings of numpy arrays) and returns a state_dict that the
port's `EfficientDet` loads with `strict=True`. The key translation is this
package's own copy of the reference converter's rule
(mm_distillnet_tpu/convert/torch_weights.py `_torch_key_for` /
`_module_path`), so a port state_dict also maps back through that converter.

The port's module names are the reference's torch key layout, so a
reference .pth loads without transposes (`convert_reference_state_dict`,
`load_reference_checkpoint`): only the wrappers' containers and prefixes,
the generator <-> plain alternate keys and the zoo layout
(`bootstrap_backbone_from_zoo`) need translating.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Iterator, List, Mapping, Tuple

import numpy as np
import torch


def torch_key_for(path: Tuple[str, ...], collection: str) -> str:
    """Translate a flax variable path to the reference torch key."""
    parts = list(path)
    leaf = parts.pop()
    segs = _module_path(parts)
    if re.fullmatch(r'p\d_w\d', leaf):  # bare BiFPN fast-attention weights
        return '.'.join(segs + [leaf])
    if collection == 'params':
        leaf_map = {'kernel': 'weight', 'bias': 'bias', 'scale': 'weight'}
    else:
        leaf_map = {'mean': 'running_mean', 'var': 'running_var'}
    return '.'.join(segs) + '.' + leaf_map[leaf]


_DOWN_CHANNELS = ('p3_down_channel', 'p4_down_channel', 'p5_down_channel',
                  'p4_down_channel_2', 'p5_down_channel_2', 'p5_to_p6')


def _module_path(parts: List[str]) -> List[str]:
    segs: List[str] = []
    i = 0
    while i < len(parts):
        p = parts[i]
        if p == 'backbone_net':
            segs += ['backbone_net', 'model']
        elif m := re.fullmatch(r'backbone_net_(\w+)', p):
            segs += ['model_backbones', m.group(1), 'model']
        elif m := re.fullmatch(r'bifpn_(\w+)', p):
            segs += ['model_necks', m.group(1)]
        elif m := re.fullmatch(r'_blocks_(\d+)', p):
            segs += ['_blocks', m.group(1)]
        elif m := re.fullmatch(r'cell_(\d+)', p):
            segs.append(m.group(1))
        elif p == 'tower':
            pass  # flax-only grouping level
        elif m := re.fullmatch(r'conv_(\d+)_depthwise', p):
            segs += ['conv_list', m.group(1), 'depthwise_conv', 'conv']
        elif m := re.fullmatch(r'conv_(\d+)_pointwise', p):
            segs += ['conv_list', m.group(1), 'pointwise_conv', 'conv']
        elif p == 'header_depthwise':
            segs += ['header', 'depthwise_conv', 'conv']
        elif p == 'header_pointwise':
            segs += ['header', 'pointwise_conv', 'conv']
        elif m := re.fullmatch(r'bn_(\d+)_(\d+)', p):
            segs += ['bn_list', m.group(1), m.group(2)]
        elif p in _DOWN_CHANNELS:
            # Sequential(conv, bn) in torch: conv -> .0.conv, bn -> .1
            nxt = parts[i + 1]
            segs += [p, '0', 'conv'] if nxt == 'conv' else [p, '1']
            i += 1  # the conv/bn level is consumed
        elif p in ('depthwise_conv', 'pointwise_conv'):
            segs += [p, 'conv']
        elif re.fullmatch(r'_conv_stem|_expand_conv|_depthwise_conv|'
                          r'_se_reduce|_se_expand|_project_conv', p):
            segs += [p, 'conv']
        else:  # 'conv', 'bn', '_bn0', '<name>' pass through
            segs.append(p)
        i += 1
    return segs


def flatten_variables(tree: Mapping, prefix: Tuple[str, ...] = ()
                      ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) pairs of a nested mapping, in sorted key order."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, Mapping):
            yield from flatten_variables(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def flax_to_torch_tensor(arr) -> torch.Tensor:
    """HWIO -> OIHW for 4-D kernels (depthwise (k,k,1,C) -> (C,1,k,k))."""
    a = np.asarray(arr, dtype=np.float32)
    if a.ndim == 4:
        a = a.transpose(3, 2, 0, 1)
    return torch.from_numpy(np.ascontiguousarray(a))


def state_dict_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """The port's state_dict for a reference `{'params', 'batch_stats'}` tree.

    Every BatchNorm also gets its `num_batches_tracked` buffer (0), which
    the flax tree does not carry, so `load_state_dict(strict=True)` holds."""
    out: Dict[str, torch.Tensor] = {}
    for coll in ('params', 'batch_stats'):
        for path, leaf in flatten_variables(variables.get(coll, {})):
            key = torch_key_for(path, coll)
            out[key] = flax_to_torch_tensor(leaf)
            if key.endswith('.running_mean'):
                out[key[:-len('running_mean')] + 'num_batches_tracked'] = \
                    torch.tensor(0, dtype=torch.long)
    return out


# ---------------------------------------------------------------------------
# Reference .pth checkpoints (the torch key layout is the port's own)
# ---------------------------------------------------------------------------

_MODALITIES = ('audio', 'thermal', 'depth', 'rgb')
# keys a detector never reads: the anchor buffer of some exports and the
# model zoo's classification head
_IGNORED_PREFIXES = ('anchors.', '_conv_head', '_bn1.', '_fc',
                     'backbone_net.model._conv_head',
                     'backbone_net.model._bn1.', 'backbone_net.model._fc')


def strip_wrapper_prefixes(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """Unwrap checkpoint containers ('state_dict', 'model',
    'model_state_dict') and strip the parallel wrappers' prefixes
    ('module.', 'student_model.', 'model.module.')."""
    for key in ('state_dict', 'model', 'model_state_dict'):
        if key in state_dict and isinstance(state_dict[key], Mapping):
            state_dict = state_dict[key]
    out = {}
    for k, v in state_dict.items():
        for prefix in ('module.', 'student_model.', 'model.module.'):
            if k.startswith(prefix):
                k = k[len(prefix):]
        out[k] = v
    return out


def alternate_keys(key: str) -> List[str]:
    """Keys to try when `key` is absent: a plain detector's backbone and
    BiFPN fill every per-modality slot of a generator, and a generator's
    slots fill a plain detector (the reference's filter_model_dict)."""
    if key.startswith('model_backbones.'):
        return [re.sub(r'^model_backbones\.\w+\.', 'backbone_net.', key)]
    if key.startswith('model_necks.'):
        return [re.sub(r'^model_necks\.\w+\.', 'bifpn.', key)]
    if key.startswith('backbone_net.'):
        return [key.replace('backbone_net.', f'model_backbones.{m}.', 1)
                for m in _MODALITIES]
    if key.startswith('bifpn.'):
        return [key.replace('bifpn.', f'model_necks.{m}.', 1)
                for m in _MODALITIES]
    return []


def _numel(v) -> int:
    return int(np.prod(np.shape(v)))


def convert_reference_state_dict(state_dict: Mapping[str, Any],
                                 template: Mapping[str, torch.Tensor],
                                 strict: bool = True
                                 ) -> Tuple[Dict[str, torch.Tensor], Dict]:
    """Fill `template` (a module's state_dict) from a reference checkpoint.

    Each template key takes the first of itself and its alternate keys
    that the checkpoint holds with as many values (a generator's wider
    heads skip a plain model's, as in the reference); a match of another
    shape raises. Keys not found keep the template's values. Returns
    (state_dict, {'missing': [...], 'unused': [...]}).

    `strict` means what the reference converter means: every parameter and
    running statistic is found, and extra keys are allowed. BatchNorm's
    `num_batches_tracked` is neither, so it never counts as missing."""
    sd = strip_wrapper_prefixes(state_dict)
    out: Dict[str, torch.Tensor] = {}
    used, missing = set(), []
    for key, want in template.items():
        match = next((a for a in [key] + alternate_keys(key)
                      if a in sd and _numel(sd[a]) == want.numel()), None)
        if match is None:
            if not key.endswith('num_batches_tracked'):
                missing.append(key)
            out[key] = want
            continue
        used.add(match)
        val = torch.as_tensor(np.asarray(sd[match])
                              if not isinstance(sd[match], torch.Tensor)
                              else sd[match])
        if tuple(val.shape) != tuple(want.shape):
            raise ValueError(f'{key}: shape mismatch: checkpoint '
                             f'{tuple(val.shape)} vs model '
                             f'{tuple(want.shape)}')
        out[key] = val.detach().to(want.dtype).clone()
    unused = [k for k in sd if k not in used
              and 'num_batches_tracked' not in k
              and not k.startswith(_IGNORED_PREFIXES)]
    if strict and missing:
        raise ValueError(f'unmatched parameters or statistics: '
                         f'{missing[:10]} ({len(missing)} total)')
    return out, {'missing': missing, 'unused': unused}


def read_torch_checkpoint(path: str) -> Dict[str, Any]:
    """torch.load a checkpoint file on the CPU, tensors and containers
    only (weights_only)."""
    return torch.load(path, map_location='cpu', weights_only=True)


def load_reference_checkpoint(path: str, model: torch.nn.Module,
                              strict: bool = True) -> Dict:
    """Load a reference .pth (or .pth.tar) into `model` in place; returns
    the report of `convert_reference_state_dict`."""
    sd, report = convert_reference_state_dict(read_torch_checkpoint(path),
                                              model.state_dict(), strict)
    model.load_state_dict(sd)
    return report


# ---------------------------------------------------------------------------
# ImageNet-pretrained backbone bootstrap (model-zoo layout)
# ---------------------------------------------------------------------------

# Conv submodules of the lukemelas EfficientNet zoo layout, whose
# Conv2dStaticSamePadding subclasses nn.Conv2d ('_conv_stem.weight'); the
# reference's wraps a conv ('_conv_stem.conv.weight').
_ZOO_CONV_MODULES = ('_conv_stem', '_expand_conv', '_depthwise_conv',
                     '_se_reduce', '_se_expand', '_project_conv',
                     '_conv_head')
_STEM_KEY = 'backbone_net.model._conv_stem.conv.weight'


def _is_zoo_layout(sd: Mapping[str, Any]) -> bool:
    return any(k.startswith(('_conv_stem.', '_blocks.')) for k in sd)


def _zoo_to_reference_keys(sd: Mapping[str, Any]) -> Dict[str, Any]:
    out = {}
    for k, v in sd.items():
        for conv in _ZOO_CONV_MODULES:
            for leaf in ('.weight', '.bias'):
                if k.endswith(conv + leaf):
                    k = k[: -len(leaf)] + '.conv' + leaf
                    break
        out['backbone_net.model.' + k] = v
    return out


def bootstrap_backbone_from_zoo(state_dict: Mapping[str, Any],
                                template: Mapping[str, torch.Tensor],
                                strict: bool = True
                                ) -> Tuple[Dict[str, torch.Tensor], Dict]:
    """Fill only the backbone of a detector's state_dict `template` from a
    model-zoo EfficientNet checkpoint (ImageNet weights), as the
    reference's `from_pretrained` does: every backbone tensor loads,
    except the stem conv when the model's input channels differ from the
    checkpoint's (the reference rebuilds the stem after loading). BiFPN
    and heads keep the template's values.

    Takes the zoo layout ('_conv_stem.weight', '_blocks.N....') or a
    backbone already in the reference layout. The report gains
    'stem_swapped' and 'backbone_missing'; with `strict` a backbone tensor
    other than a swapped stem that did not load raises."""
    sd = strip_wrapper_prefixes(state_dict)
    if _is_zoo_layout(sd):
        sd = _zoo_to_reference_keys(sd)
    stem_swapped = False
    if _STEM_KEY in sd and _STEM_KEY in template and \
            np.shape(sd[_STEM_KEY])[1] != template[_STEM_KEY].shape[1]:
        del sd[_STEM_KEY]
        stem_swapped = True
    out, report = convert_reference_state_dict(sd, template, strict=False)
    report['stem_swapped'] = stem_swapped
    bad = [k for k in report['missing'] if k.startswith('backbone_net.')
           and not (stem_swapped and '._conv_stem.' in k)]
    report['backbone_missing'] = bad
    if strict and bad:
        raise ValueError(f'pretrained backbone bootstrap failed to map '
                         f'{len(bad)} backbone tensors: {bad[:8]}')
    return out, report


def load_zoo_backbone(path: str, template: Mapping[str, torch.Tensor],
                      strict: bool = True
                      ) -> Tuple[Dict[str, torch.Tensor], Dict]:
    """Read a model-zoo EfficientNet .pth and bootstrap the backbone."""
    return bootstrap_backbone_from_zoo(read_torch_checkpoint(path),
                                       template, strict)


# ---------------------------------------------------------------------------
# The JAX package's int8 pack
# ---------------------------------------------------------------------------

def port_module_name(flax_path: str) -> str:
    """The port's name of the nn.Conv2d at a '/'-joined flax module path
    ('backbone_net/_blocks_0/_expand_conv' ->
    'backbone_net.model._blocks.0._expand_conv.conv')."""
    return '.'.join(_module_path(flax_path.split('/')))


def quant_pack_from_jax(pack, specs: Mapping[str, Mapping[str, Any]]):
    """The JAX package's QuantPack (mm_distillnet_tpu/quant.py) as the
    port's: flax paths -> the port's module names, HWIO int8 kernels ->
    OIHW, scales as fp32 tensors (CPU). `specs` is the port's
    collect_conv_specs of the same network; the two must select the same
    convs."""
    from ..quant import QuantPack
    names = {port_module_name(p): p for p in pack.qkernels}
    if set(names) != set(specs):
        raise ValueError(f'the packs select different convs: '
                         f'{sorted(set(names) ^ set(specs))[:8]}')
    qkernels, wscales, ascales = {}, {}, {}
    for name, path in names.items():
        q = np.asarray(pack.qkernels[path], np.int8).transpose(3, 2, 0, 1)
        qkernels[name] = torch.from_numpy(np.ascontiguousarray(q))
        wscales[name] = torch.from_numpy(
            np.asarray(pack.wscales[path], np.float32).copy())
        ascales[name] = torch.tensor(np.float32(pack.ascales[path]))
    return QuantPack(qkernels, wscales, ascales)
