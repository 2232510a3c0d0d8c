"""Carry weights from the JAX package's variable tree to the port.

`state_dict_from_flax` takes the reference's `{'params', 'batch_stats'}`
tree (nested mappings of numpy arrays) and returns a state_dict that the
port's `EfficientDet` loads with `strict=True`. The key translation is this
package's own copy of the reference converter's rule
(mm_distillnet_tpu/convert/torch_weights.py `_torch_key_for` /
`_module_path`), so a port state_dict also maps back through that converter.
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
