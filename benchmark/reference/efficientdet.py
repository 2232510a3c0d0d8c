"""EfficientDet-D0..D7 assembly (port of mm_distillnet_tpu/models/efficientdet.py).

EfficientNet backbone -> BiFPN stack -> shared regressor/classifier heads.
The forward takes NHWC input and returns `DetectorOutput` with NHWC
features, like the reference package; inside it runs NCHW (the NHWC input
permuted is a channels_last NCHW view, so no copy is made).
"""
from __future__ import annotations

from typing import Any, List, NamedTuple, Optional, Tuple

import torch
from torch import nn

from .bifpn import BiFPN
from .efficientnet import EfficientNetFeatures, backbone_feature_channels
from .heads import Classifier, Regressor


# Per-coefficient scaling tables (reference src/YetAnotherEfficientDet.py:611-629);
# key -1 is the TEST-TINY profile, not a reference configuration.
def _coef_table(tiny, *d0_to_d7):
    table = dict(enumerate(d0_to_d7))
    table[-1] = tiny
    return table


BACKBONE_COEF = _coef_table(-1, 0, 1, 2, 3, 4, 5, 6, 6)
FPN_NUM_FILTERS = _coef_table(16, 64, 88, 112, 160, 224, 288, 384, 384)
FPN_CELL_REPEATS = _coef_table(1, 3, 4, 5, 6, 7, 7, 8, 8)
INPUT_SIZES = _coef_table(128, 512, 640, 768, 896, 1024, 1280, 1280, 1536)
BOX_CLASS_REPEATS = _coef_table(1, 3, 3, 3, 4, 4, 4, 5, 5)
ANCHOR_SCALE = _coef_table(4., 4., 4., 4., 4., 4., 4., 4., 5.)
NUM_ANCHORS_PER_CELL = 9  # 3 scales x 3 ratios


class DetectorOutput(NamedTuple):
    classification: torch.Tensor          # (B, N, num_classes) sigmoid scores
    regression: torch.Tensor              # (B, N, 4) deltas (dy, dx, dh, dw)
    features: Tuple[torch.Tensor, ...]    # 5 BiFPN maps, NHWC
    align_features: torch.Tensor          # head pre-header features, NHWC
    logits: Any = None                    # (B, N, num_classes) pre-sigmoid


def nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


class EfficientDet(nn.Module):
    """One parameterisation serves all four networks: RGB/depth teachers
    (3 input channels), thermal teacher (1), audio student (8).
    `features_from` picks the features the KD loss reads ('efficientnet':
    the five BiFPN maps; 'header': the heads' alignment feature);
    `drop_connect_rate` is the backbone's stochastic depth in train mode;
    `s2d_stem` runs the backbone's stem as the space-to-depth rewrite (same
    parameters; the fused predictor folds the standard stem either way, as
    the JAX package's fused forward does)."""

    def __init__(self, num_classes: int = 20, compound_coef: int = 2,
                 in_channels: int = 8, features_from: str = 'efficientnet',
                 drop_connect_rate: float = 0.2, s2d_stem: bool = False):
        super().__init__()
        if features_from not in ('efficientnet', 'header'):
            raise NotImplementedError(features_from)
        cc = compound_coef
        self.num_classes = num_classes
        self.compound_coef = cc
        self.in_channels = in_channels
        self.features_from = features_from
        fpn = FPN_NUM_FILTERS[cc]
        self.backbone_net = EfficientNetFeatures(BACKBONE_COEF[cc],
                                                 in_channels,
                                                 drop_connect_rate, s2d_stem)
        self.bifpn = BiFPN(fpn, FPN_CELL_REPEATS[cc],
                           backbone_feature_channels(BACKBONE_COEF[cc]),
                           attention=cc < 6)
        self.regressor = Regressor(fpn, NUM_ANCHORS_PER_CELL,
                                   BOX_CLASS_REPEATS[cc])
        self.classifier = Classifier(fpn, NUM_ANCHORS_PER_CELL, num_classes,
                                     BOX_CLASS_REPEATS[cc])

    def heads(self, p3, p4, p5) -> DetectorOutput:
        """BiFPN + heads from NCHW backbone features P3..P5."""
        features = self.bifpn((p3, p4, p5))
        regression, align_reg = self.regressor(features)
        classification, logits, align_cls = self.classifier(features)
        align = torch.cat([align_reg, align_cls], dim=1)
        return DetectorOutput(
            classification=classification.float(),
            regression=regression.float(),
            features=tuple(nhwc(f) for f in features),
            align_features=nhwc(align),
            logits=logits.float())

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> DetectorOutput:
        """x (B, H, W, C) NHWC. In train mode `generator` draws the
        backbone's drop-connect masks."""
        w = self.backbone_net.model._conv_stem.conv.weight
        feats = self.backbone_net(nchw(x.to(w.dtype)), generator)
        return self.heads(feats[1], feats[2], feats[3])

    def distill_features(self, out: DetectorOutput) -> List[torch.Tensor]:
        """The features handed to the KD loss, per `features_from`
        (reference src/YetAnotherEfficientDet.py:680-685)."""
        if self.features_from == 'efficientnet':
            return list(out.features)
        return [out.align_features]
