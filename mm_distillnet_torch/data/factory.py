"""Dataset dispatch by config['dataset'] (port of
mm_distillnet_tpu/data/factory.py; reference train.py:143-146 and
evaluate.py:133-146 dispatch MultimodalDetection / FLIR / Argoverse /
CityScapes; CarsAugmented is import-dead in the reference and excluded).
'Synthetic' / 'SyntheticMultimodal' give the synthetic dataset used when
the Freiburg dataset is not on disk."""
from __future__ import annotations

from .multimodal import MultimodalDetection
from .synthetic import SyntheticMultimodal


def get_dataset(config, mode: str):
    name = config.get('dataset', 'MultimodalDetection')
    if name == 'MultimodalDetection':
        return MultimodalDetection(config, mode)
    if name in ('Synthetic', 'SyntheticMultimodal'):
        return SyntheticMultimodal(config, mode)
    if name == 'FLIRDataset':
        from .flir import FLIRDataset
        return FLIRDataset(config, mode)
    if name == 'ArgoverseDataset':
        from .argoverse import ArgoverseDataset
        return ArgoverseDataset(config, mode)
    if name == 'CityScapesDataset':
        from .cityscapes import CityScapesDataset
        return CityScapesDataset(config, mode)
    raise ValueError(f'Unsupported dataset {name}')
