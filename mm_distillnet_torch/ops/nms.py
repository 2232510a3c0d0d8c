"""Fixed-shape greedy NMS, batched over images (port of
mm_distillnet_tpu/ops/nms.py).

Sort by score (stable, as `jnp.argsort` is), test the IoU of every pair of
sorted boxes, then run the sequential greedy suppression over the rows.
Selection order matches torchvision's `nms` for the top-K candidates.
Inputs may be (K, ...) or (B, K, ...); outputs follow.

`nms_fixed` calls the torch.library custom op `mm_distillnet::nms_fixed`,
so the device of the tensors picks the implementation and torch.export can
trace a predictor through it. For a CUDA tensor the op launches the
hand-written kernel of csrc/nms.cu (one launch a call for the whole batch:
sort, gather, IoU, greedy scan and selection; counted in `launches`); for a
CPU tensor it runs the plain version, `nms_fixed_reference`, whose greedy
loop is one (B, K) vector op per row. The two give the same outputs bit for
bit. There is no fallback: a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from ..utils.profiling import span
from . import cuda_build
from .boxes import UNION_EPS, pairwise_iou_xyxy

NEG_INF = -1e30
MAX_K = 1024              # the most candidates an image the kernel takes

launches = {'nms_fixed': 0}


def _greedy_suppress(iou: torch.Tensor, valid: torch.Tensor,
                     iou_threshold: float) -> torch.Tensor:
    """Greedy NMS over boxes already sorted by descending score.

    iou (..., K, K); valid (..., K). Returns the keep mask (..., K)."""
    k = iou.shape[-1]
    later = torch.ones(k, k, dtype=torch.bool, device=iou.device).triu(1)
    over = (iou > iou_threshold) & later      # row i suppresses later rows
    keep = valid.clone()
    for i in range(k):
        # keep[i] implies valid[i]: keep starts at valid and only loses rows
        keep &= ~(over[..., i, :] & keep[..., i, None])
    return keep


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, K, ...) gathered along dim 1 by idx (B, M)."""
    if x.dim() == 2:
        return torch.gather(x, 1, idx)
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def nms_fixed_reference(boxes: torch.Tensor, scores: torch.Tensor,
                        valid: torch.Tensor, iou_threshold: float,
                        max_out: int
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version: boxes (B, K, 4), scores (B, K), valid (B, K)."""
    masked = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    order = torch.sort(-masked, dim=-1, stable=True).indices
    b = _take(boxes, order)
    v = _take(valid, order)
    keep = _greedy_suppress(pairwise_iou_xyxy(b, b), v, iou_threshold)

    keep_scores = torch.where(keep, _take(masked, order),
                              torch.full_like(masked, NEG_INF))
    sel = torch.sort(-keep_scores, dim=-1, stable=True).indices[:, :max_out]
    kscores = _take(keep_scores, sel)
    return _take(order, sel), kscores, kscores > NEG_INF / 2


def _out_rows(k: int, max_out: int) -> int:
    """The rows of `[:, :max_out]` over K columns."""
    return len(range(k)[:max_out])


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry point; csrc/nms.cu is built at first use."""
    fn = cuda_build.load('nms').nms_fixed
    # 6 tensors; B, K, m; 7 strides; thr, eps, NEG_INF, NEG_INF / 2; stream
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
                   + [ctypes.c_longlong] * 7 + [ctypes.c_float] * 4
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _nms_fixed_cuda(boxes: torch.Tensor, scores: torch.Tensor,
                    valid: torch.Tensor, iou_threshold: float, max_out: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's launch: any strides in, contiguous (B, M) out."""
    if (boxes.dim() != 3 or boxes.shape[2] != 4
            or scores.shape != boxes.shape[:2]
            or valid.shape != boxes.shape[:2]):
        raise ValueError(f'nms_fixed takes boxes (B, K, 4), scores and valid '
                         f'(B, K), got {tuple(boxes.shape)}, '
                         f'{tuple(scores.shape)}, {tuple(valid.shape)}')
    for name, t, dtype in (('boxes', boxes, torch.float32),
                           ('scores', scores, torch.float32),
                           ('valid', valid, torch.bool)):
        if t.device != boxes.device:
            raise ValueError(f'{name} is on {t.device}, expected '
                             f'{boxes.device}')
        if t.dtype != dtype:
            raise ValueError(f'{name} is {t.dtype}, expected {dtype}')
    b, k = boxes.shape[:2]
    if k > MAX_K:
        raise ValueError(f'the NMS kernel takes at most {MAX_K} candidates '
                         f'an image, got {k}')
    if b < 1:
        raise ValueError('the NMS kernel needs at least one image')
    m = _out_rows(k, max_out)
    dev = boxes.device
    idx = torch.empty((b, m), dtype=torch.int64, device=dev)
    kscores = torch.empty((b, m), dtype=torch.float32, device=dev)
    out_valid = torch.empty((b, m), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        err = _kernel()(
            boxes.data_ptr(), scores.data_ptr(), valid.data_ptr(),
            idx.data_ptr(), kscores.data_ptr(), out_valid.data_ptr(), b, k, m,
            *boxes.stride(), *scores.stride(), *valid.stride(),
            iou_threshold, UNION_EPS, NEG_INF, NEG_INF / 2,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f'nms_fixed launch failed with CUDA error {err}')
    launches['nms_fixed'] += 1
    return idx, kscores, out_valid


# the op: a CPU implementation (the plain version), a CUDA one (the kernel,
# counted in `launches`) and a fake one (shapes and dtypes), so that
# torch.export can trace a predictor that runs it
_LIB = torch.library.Library('mm_distillnet', 'FRAGMENT')
_LIB.define('nms_fixed(Tensor boxes, Tensor scores, Tensor valid, '
            'float iou_threshold, int max_out) -> (Tensor, Tensor, Tensor)')
_LIB.impl('nms_fixed', nms_fixed_reference, 'CPU')
_LIB.impl('nms_fixed', _nms_fixed_cuda, 'CUDA')


@torch.library.register_fake('mm_distillnet::nms_fixed')
def _nms_fixed_fake(boxes, scores, valid, iou_threshold, max_out):
    shape = (boxes.shape[0], _out_rows(boxes.shape[1], max_out))
    return (boxes.new_empty(shape, dtype=torch.int64),
            scores.new_empty(shape), valid.new_empty(shape))


def nms_fixed(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
              iou_threshold: float, max_out: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Class-agnostic NMS with fixed output size.

    boxes (B?, K, 4) xyxy, scores (B?, K), valid (B?, K) bool. Returns
    (indices (B?, max_out), keep_scores, out_valid), indices into the
    inputs sorted by descending score."""
    if boxes.dim() == 2:
        out = nms_fixed(boxes[None], scores[None], valid[None],
                        iou_threshold, max_out)
        return tuple(o[0] for o in out)
    with span('mmd.nms'):
        return torch.ops.mm_distillnet.nms_fixed(
            boxes, scores, valid, float(iou_threshold), int(max_out))


def reset_launches() -> None:
    launches['nms_fixed'] = 0


def batched_class_nms_fixed(boxes: torch.Tensor, scores: torch.Tensor,
                            classes: torch.Tensor, valid: torch.Tensor,
                            iou_threshold: float, max_out: int,
                            coord_bound: float
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-class NMS via the class-offset trick (torchvision batched_nms
    semantics). coord_bound must exceed any box coordinate."""
    offsets = classes.to(boxes.dtype)[..., None] * coord_bound
    return nms_fixed(boxes + offsets, scores, valid, iou_threshold, max_out)
