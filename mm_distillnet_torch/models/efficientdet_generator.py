"""Multi-modal EfficientDet "generator": one backbone and one BiFPN per
modality, shared heads (port of
mm_distillnet_tpu/models/efficientdet_generator.py; reference
src/YetAnotherEfficientDet_generator.py:595-771).

Integration modes (reference :687-751, head widths :652-668):

  concat   heads `fpn_filters * n_modalities` wide; every modality's BiFPN
           maps concatenated along the channels.
  switch   heads `fpn_filters` wide: train mode uses ONE drawn modality's
           maps; eval mode the first modality (sorted order), as the
           reference breaks out of its eval loop after the first
           (:747-748), so only that modality's stack runs.
  zeroout  heads `fpn_filters * n_modalities` wide: train mode zeroes a
           drawn modality's INPUT and still runs its backbone (BN biases
           make the zero input's response non-zero); eval concatenates
           all.

Modalities run in sorted order (the reference's `ordered_models.sort()`).
The draw of train mode comes from an explicit `torch.Generator`, or the
caller names the modality (`choice=`). Inputs are a dict of NHWC tensors;
the output is a `DetectorOutput` as the plain detector's. Keys follow the
reference: `model_backbones.rgb.model._conv_stem.conv.weight`,
`model_necks.rgb.0.p6_w1`, `classifier.header...`.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from .bifpn import BiFPN
from .efficientdet import (BACKBONE_COEF, BOX_CLASS_REPEATS,
                           FPN_CELL_REPEATS, FPN_NUM_FILTERS,
                           NUM_ANCHORS_PER_CELL, DetectorOutput, nchw, nhwc)
from .efficientnet import EfficientNetFeatures, backbone_feature_channels
from .heads import Classifier, Regressor

INTEGRATION_MODES = ('concat', 'switch', 'zeroout')
# input channels of each modality (reference get_data_dim_from_config)
MODALITY_DIMS = {'rgb': 3, 'thermal': 1, 'depth': 3, 'audio': 8}


class EfficientDetGenerator(nn.Module):
    """`modalities` are the generator's inputs; `in_channels` maps each to
    its channels (default `MODALITY_DIMS`)."""

    def __init__(self, modalities: Sequence[str] = ('audio', 'depth', 'rgb',
                                                    'thermal'),
                 num_classes: int = 20, compound_coef: int = 2,
                 integration_mode: str = 'concat',
                 features_from: str = 'efficientnet',
                 in_channels: Optional[Mapping[str, int]] = None,
                 drop_connect_rate: float = 0.2):
        super().__init__()
        if integration_mode not in INTEGRATION_MODES:
            raise NotImplementedError(
                f'integration_mode {integration_mode!r}; one of '
                f'{INTEGRATION_MODES}')
        if features_from not in ('efficientnet', 'header'):
            raise NotImplementedError(features_from)
        cc = compound_coef
        self.modalities = tuple(modalities)
        self.ordered_modalities = tuple(sorted(modalities))
        self.num_classes = num_classes
        self.compound_coef = cc
        self.integration_mode = integration_mode
        self.features_from = features_from
        dims = dict(MODALITY_DIMS, **(in_channels or {}))
        fpn = FPN_NUM_FILTERS[cc]
        self.model_backbones = nn.ModuleDict({
            m: EfficientNetFeatures(BACKBONE_COEF[cc], dims[m],
                                    drop_connect_rate)
            for m in self.ordered_modalities})
        self.model_necks = nn.ModuleDict({
            m: BiFPN(fpn, FPN_CELL_REPEATS[cc],
                     backbone_feature_channels(BACKBONE_COEF[cc]),
                     attention=cc < 6)
            for m in self.ordered_modalities})
        n_mod = len(self.ordered_modalities)
        width = fpn if (integration_mode == 'switch' or n_mod == 1) \
            else fpn * n_mod
        self.regressor = Regressor(width, NUM_ANCHORS_PER_CELL,
                                   BOX_CLASS_REPEATS[cc])
        self.classifier = Classifier(width, NUM_ANCHORS_PER_CELL, num_classes,
                                     BOX_CLASS_REPEATS[cc])

    def _draws(self) -> bool:
        return self.integration_mode in ('switch', 'zeroout') and \
            len(self.ordered_modalities) > 1

    def active_modalities(self, train: bool) -> Tuple[str, ...]:
        """The modalities whose stacks run: all, except in eval-mode
        switch, where only the first does."""
        if self.integration_mode == 'switch' and not train:
            return self.ordered_modalities[:1]
        return self.ordered_modalities

    def draw(self, generator: Optional[torch.Generator], device) -> int:
        """The modality index that train-mode switch / zeroout uses."""
        if generator is None:
            raise ValueError(f'train-mode {self.integration_mode} draws a '
                             'modality from an explicit torch.Generator; '
                             'pass generator= or choice=')
        return int(torch.randint(len(self.ordered_modalities), (),
                                 generator=generator, device=device))

    def heads(self, pyramids: Mapping[str, Sequence[torch.Tensor]],
              train: bool = False, choice: Optional[int] = None
              ) -> DetectorOutput:
        """Integration + shared heads from each active modality's five NCHW
        BiFPN maps."""
        mods = self.active_modalities(train)
        if len(mods) == 1:
            features = list(pyramids[mods[0]])
        elif self.integration_mode == 'switch':   # train mode
            features = list(pyramids[mods[choice]])
        else:
            features = [torch.cat([pyramids[m][lvl] for m in mods], dim=1)
                        for lvl in range(5)]
        regression, align_reg = self.regressor(features)
        classification, logits, align_cls = self.classifier(features)
        align = torch.cat([align_reg, align_cls], dim=1)
        return DetectorOutput(
            classification=classification.float(),
            regression=regression.float(),
            features=tuple(nhwc(f) for f in features),
            align_features=nhwc(align),
            logits=logits.float())

    def forward(self, inputs: Mapping[str, torch.Tensor],
                generator: Optional[torch.Generator] = None,
                choice: Optional[int] = None) -> DetectorOutput:
        """inputs {modality: (B, H, W, C)}. In train mode `generator` draws
        the drop-connect masks and, for switch / zeroout, the modality,
        unless `choice` names its index in sorted order."""
        train = self.training
        mods = self.active_modalities(train)
        for m in mods:
            if m not in inputs:
                raise ValueError(f'missing modality input: {m}')
        if train and self._draws() and choice is None:
            choice = self.draw(generator, inputs[mods[0]].device)
        pyramids: Dict[str, List[torch.Tensor]] = {}
        for i, m in enumerate(mods):
            backbone = self.model_backbones[m]
            w = backbone.model._conv_stem.conv.weight
            x = nchw(inputs[m].to(w.dtype))
            if train and self.integration_mode == 'zeroout' and \
                    choice is not None and i == choice:
                x = torch.zeros_like(x)
            feats = backbone(x, generator)
            pyramids[m] = self.model_necks[m]((feats[1], feats[2], feats[3]))
        return self.heads(pyramids, train, choice)

    def distill_features(self, out: DetectorOutput) -> List[torch.Tensor]:
        if self.features_from == 'efficientnet':
            return list(out.features)
        return [out.align_features]
