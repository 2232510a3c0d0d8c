"""Dataset dispatch by config['dataset'] (port of
mm_distillnet_tpu/data/factory.py; reference train.py:143-146 and
evaluate.py:133-146).

'Synthetic' / 'SyntheticMultimodal' give the port's synthetic dataset. The
real datasets (MultimodalDetection, FLIRDataset, ArgoverseDataset,
CityScapesDataset) decode and resize with cv2 in the JAX package; their
port waits for a decode path of its own and raises here.
"""
from __future__ import annotations

from .synthetic import SyntheticMultimodal

REAL_DATASETS = ('MultimodalDetection', 'FLIRDataset', 'ArgoverseDataset',
                 'CityScapesDataset')


def get_dataset(config, mode: str):
    name = config.get('dataset', 'MultimodalDetection')
    if name in ('Synthetic', 'SyntheticMultimodal'):
        return SyntheticMultimodal(config, mode)
    if name in REAL_DATASETS:
        raise NotImplementedError(
            f'dataset {name} is not ported yet (its decode and resize are '
            'cv2; ROADMAP Queue 1 item 11); use dataset=Synthetic')
    raise ValueError(f'Unsupported dataset {name}')
