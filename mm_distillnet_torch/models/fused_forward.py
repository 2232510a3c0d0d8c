"""Fused inference forward: MBConv blocks as CUDA kernels + BiFPN/heads
(port of mm_distillnet_tpu/models/fused_forward.py).

The stem is a folded-BN conv; every MBConv block runs, by default, as the
hand-written kernels of ops/fused_mbconv.py (BN folded into the weights,
bf16 activations between blocks); BiFPN and heads are the port's modules.
Activations stay NHWC through the backbone, which is the kernels' layout.

Plan spec syntax is the reference's: 'pallas:0-15,flax:16-22'. The word
`pallas` is kept so plan strings carry over; here it means the Hopper
kernels. `flax` means the port's unfused `MBConvBlock`. The default sends
every block to the kernels; there is no VMEM-budget fallback (the kernels
tile space, so every D2@768 block fits), and a block the kernels cannot
take raises. A generator's per-modality backbones fold the same way, one
`FusedBackbone` each (`make_fused_predictor`).
"""
from __future__ import annotations

import copy
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.fused_mbconv import (PROJECT_BM, check_kernel_fits, fold_mbconv,
                                mbconv_fused)
from ..utils.profiling import span
from .efficientdet import BACKBONE_COEF, DetectorOutput, nchw, nhwc
from .efficientdet_generator import EfficientDetGenerator
from .efficientnet import BlockArgs, MBConvBlock, expand_block_args
from .layers import BN_EPS, pad_same_nchw, swish

_BACKBONE = 'backbone_net.model.'


def _parse_plan(spec: str, n_blocks: int) -> Dict[int, str]:
    """'pallas:6-10,flax:11-22' -> {block_index: kind}."""
    if not spec:
        return {}
    out = {}
    for part in spec.split(','):
        kind, _, rng = part.strip().partition(':')
        if kind not in ('pallas', 'flax'):
            raise ValueError(f'unknown fused-plan kind {kind!r}')
        lo, _, hi = rng.partition('-')
        lo = int(lo)
        hi = int(hi) if hi else lo
        for i in range(lo, min(hi, n_blocks - 1) + 1):
            out[i] = kind
    return out


def _sub_state(sd: Mapping[str, torch.Tensor], prefix: str
               ) -> Dict[str, torch.Tensor]:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


class FusedBackbone:
    """Folded weights + dispatch plan for one trained backbone.

    state_dict is the detector's; the backbone's keys start with `prefix`
    (`backbone_net.model.`, or a generator's
    `model_backbones.<modality>.model.`)."""

    def __init__(self, state_dict: Mapping[str, torch.Tensor],
                 compound_coef: int, image_size: int,
                 dtype: torch.dtype = torch.bfloat16,
                 plan_spec: Optional[str] = None, device='cuda',
                 prefix: str = _BACKBONE):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.blocks = expand_block_args(compound_coef)
        sd = _sub_state(state_dict, prefix)

        # stem: conv + folded BN
        scale = sd['_bn0.weight'].float() / torch.sqrt(
            sd['_bn0.running_var'].float() + BN_EPS)
        w = sd['_conv_stem.conv.weight'].float() * scale[:, None, None, None]
        self.stem_weight = w.to(self.device, dtype)
        self.stem_bias = (sd['_bn0.bias'].float()
                          - sd['_bn0.running_mean'].float() * scale
                          ).to(self.device, dtype)

        override = _parse_plan(plan_spec or '', len(self.blocks))
        spatial = -(-image_size // 2)
        self.plan: List[Tuple[str, BlockArgs, object]] = []
        for i, args in enumerate(self.blocks):
            bsd = _sub_state(sd, f'_blocks.{i}.')
            kind = override.get(i, 'pallas')
            if kind == 'pallas':
                check_kernel_fits(args)
                if args.stride == 2 and spatial % 2:
                    raise ValueError(f'block {i}: stride 2 on odd size '
                                     f'{spatial} has no kernel')
                out = spatial // args.stride
                if self.device.type == 'cuda' and out * out < PROJECT_BM:
                    raise ValueError(f'block {i}: the project kernel needs '
                                     f'{PROJECT_BM} pixels per image, the '
                                     f'map has {out}x{out}')
                payload = fold_mbconv(bsd, args, self.device)
            else:
                payload = MBConvBlock(args)
                payload.load_state_dict(bsd)
                payload = payload.to(self.device, dtype).eval()
            self.plan.append((kind, args, payload))
            spatial = -(-spatial // args.stride)

    @torch.no_grad()
    def stem(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, C) -> the first block's input (B, H/2, W/2, C0)."""
        x = nchw(x.to(self.device, self.dtype))
        x = F.conv2d(pad_same_nchw(x, 2, 3), self.stem_weight, stride=2)
        return nhwc(swish(x + self.stem_bias[:, None, None])).contiguous()

    @torch.no_grad()
    def __call__(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x (B, H, W, C) -> NHWC features [P2, P3, P4, P5]."""
        x = self.stem(x)

        feature_maps = []
        last_x = None
        n = len(self.plan)
        for i, (kind, args, payload) in enumerate(self.plan):
            if args.stride == 2:
                feature_maps.append(last_x)
            if kind == 'pallas':
                x = mbconv_fused(x.to(torch.bfloat16).contiguous(), payload,
                                 args)
            else:
                x = nhwc(payload(nchw(x.to(self.dtype)))).contiguous()
            if i == n - 1:
                feature_maps.append(x)
            last_x = x
        return feature_maps[1:]


def make_fused_predictor(model, state_dict: Mapping[str, torch.Tensor],
                         image_size: int, plan_spec: Optional[str] = None,
                         dtype: torch.dtype = torch.bfloat16,
                         device='cuda') -> Callable[..., DetectorOutput]:
    """fn(x) -> DetectorOutput through the fused backbone: x (B, H, W, C),
    or for an `EfficientDetGenerator` a dict {modality: (B, H, W, C)}.

    The backbone's weights are folded once (a generator's, one
    `FusedBackbone` per modality its eval forward runs); BiFPN and heads
    are a copy of `model` holding `state_dict`, on `device` in `dtype`.
    The function carries its backbone as `.backbone` (a generator's as
    `.backbones`, by modality)."""
    if isinstance(model, EfficientDetGenerator):
        return _fused_generator(model, state_dict, image_size, plan_spec,
                                dtype, device)
    dev = resolve_device(device)
    backbone = FusedBackbone(state_dict, BACKBONE_COEF[model.compound_coef],
                             image_size, dtype=dtype, plan_spec=plan_spec,
                             device=dev)
    head = copy.deepcopy(model)
    del head.backbone_net
    head.load_state_dict({k: v for k, v in state_dict.items()
                          if not k.startswith('backbone_net.')})
    head = head.to(dev, dtype).eval()

    @torch.no_grad()
    def forward(x: torch.Tensor) -> DetectorOutput:
        with span('mmd.backbone'):
            feats = backbone(x)
        with span('mmd.bifpn_heads'):
            return head.heads(*(nchw(f.to(dtype)) for f in feats[1:4]))

    forward.backbone = backbone
    return forward


def _fused_generator(model: EfficientDetGenerator,
                     state_dict: Mapping[str, torch.Tensor], image_size: int,
                     plan_spec: Optional[str], dtype: torch.dtype, device):
    dev = resolve_device(device)
    backbones = {
        m: FusedBackbone(state_dict, BACKBONE_COEF[model.compound_coef],
                         image_size, dtype=dtype, plan_spec=plan_spec,
                         device=dev, prefix=f'model_backbones.{m}.model.')
        for m in model.active_modalities(train=False)}
    head = copy.deepcopy(model)
    del head.model_backbones
    head.load_state_dict({k: v for k, v in state_dict.items()
                          if not k.startswith('model_backbones.')})
    head = head.to(dev, dtype).eval()

    @torch.no_grad()
    def forward(x: Mapping[str, torch.Tensor]) -> DetectorOutput:
        pyramids = {}
        for m, backbone in backbones.items():
            if m not in x:
                raise ValueError(f'missing modality input: {m}')
            feats = backbone(x[m])
            pyramids[m] = head.model_necks[m](
                tuple(nchw(f.to(dtype)) for f in feats[1:4]))
        return head.heads(pyramids)

    forward.backbones = backbones
    return forward


def eval_module(model, state_dict: Mapping[str, torch.Tensor], device,
                dtype: torch.dtype = torch.float32) -> torch.nn.Module:
    """A frozen copy of `model` holding `state_dict`, on `device` in
    `dtype`, in eval mode."""
    net = copy.deepcopy(model)
    net.load_state_dict(state_dict)
    return net.to(resolve_device(device), dtype).eval().requires_grad_(False)


def make_eval_forward(model,
                      state_dict: Mapping[str, torch.Tensor],
                      image_size: int, fused: bool,
                      dtype: torch.dtype = torch.bfloat16,
                      device='cuda') -> Callable[[torch.Tensor],
                                                 DetectorOutput]:
    """fn(x) -> DetectorOutput of a frozen network (a detector on (B, H, W,
    C), or a generator on a dict of them) in eval mode, without grad: with
    `fused`, through the fused backbone (the MBConv kernels, weights folded
    once); else a copy of `model` holding `state_dict`, on `device` in
    `dtype`."""
    if fused:
        return make_fused_predictor(model, state_dict, image_size,
                                    dtype=dtype, device=device)
    net = eval_module(model, state_dict, device, dtype)

    @torch.no_grad()
    def forward(x) -> DetectorOutput:
        return net(x)

    return forward
