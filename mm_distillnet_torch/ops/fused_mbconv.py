"""Fused eval-mode MBConv block: BN folding, the plain PyTorch version, and
the wrappers of the hand-written CUDA kernels in csrc/mbconv*.cu.

Counterpart of mm_distillnet_tpu/ops/pallas_mbconv.py: `_mbconv_kernel`
(launched by `mbconv_fused`) runs a whole MBConv block per image out of
VMEM. On Hopper the block is three kernels:

  (a) `expand_dw`  csrc/mbconv_expand_dw.cu. One CTA per spatial output tile
                   (`tile_plan`: 16x8 at stride 1, 8x8 at stride 2, on small
                   maps and where 16x8 does not fit) walks over 48-channel
                   chunks: expand 1x1 on wgmma over the tile's input halo
                   (loaded once), bias + swish to a bf16 tile in shared
                   memory, depthwise kxk from a register window while the
                   next chunk's wgmma runs; bf16 output plus fp32 per-tile
                   channel sums. On-chip work bounds it (the swish of the
                   recomputed halo, the depthwise FMAs), not its bytes;
  (b) `se_gate`    csrc/mbconv.cu. Tile sums -> mean -> SE GEMVs -> fp32
                   gate. Latency-bound: a thread-block cluster per image
                   (`se_plan`: the tiles or the channels split over its
                   CTAs) exchanges partial sums through distributed shared
                   memory and adds them in rank order; launched as a
                   programmatic dependent of (a), it stages its weights
                   (`pack_se`) before (a) has ended;
  (c) `project`    csrc/mbconv_project.cu. Tiles of 64 rows per consumer
                   warpgroup x up to 256 output channels (`project_plan`);
                   a producer warp brings d (TMA boxes of a tensor map),
                   the gates and w_prj through a 2-4-stage ring; bf16(d *
                   gate) is formed in registers and fed to wgmma; bias +
                   identity skip in fp32, bf16 out. How fast an SM takes d
                   in, and each warp's own instruction chain, bound it.

The kernels read the weights in layouts made once at fold time
(`pack_expand`, `pack_project`, `pack_se`): K-major 8x8 core matrices as
wgmma reads them from shared memory, cut into the pieces one copy brings in. What
bounds each kernel and why its design is so is noted in its CUDA source.

Each wrapper calls its kernel's torch.library custom op
(`mm_distillnet::mbconv_expand_dw`, `::mbconv_se`, `::mbconv_project`), so
the device of the tensors picks the implementation and torch.export can
trace a forward through it. For a CUDA tensor the op runs the kernel, with
that tensor's card as the current device (the C side sets its shared-memory
limits per device), and counts the launch in `launches`; for a CPU tensor
it runs the plain version (`*_reference`),
which repeats the kernel's arithmetic and rounding points in torch:
the expanded activation is rounded to bf16 before the taps, the depthwise
accumulates in fp32 from the bias, the SE mean is taken over the fp32
depthwise output before its bf16 rounding, the gate is applied in fp32 and
rounded to bf16 before the project, the skip is added in fp32.
There is no fallback: a CUDA tensor launches the kernel or raises.

Layout: NHWC activations; expanded channels padded to CeP, a multiple of
48 (`CHUNK`, the channel chunk of kernel (a); 6 * Cin already is one for
every width that is a multiple of 8) or, in a block without expand, of 32;
padded channels carry zero weights and stay exact zeros end to end.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Mapping, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..models.efficientnet import BlockArgs, has_se
from ..models.layers import BN_EPS, same_pad_amounts, swish
from . import cuda_build

CHUNK = 48                # expanded channels per chunk of kernel (a)
NOEXPAND_ALIGN = 32       # channel alignment of a block without expand
PROJECT_BM = 64           # rows per CTA of kernel (c)
PROJECT_BK = 128          # K per pipeline stage of kernel (c)
PROJECT_WIDTHS = (16, 32, 64, 96, 128, 192, 256)   # (c)'s accumulator widths
# zero bytes behind pack_project's last value: the widest piece a CTA copies
PROJECT_SLACK = PROJECT_WIDTHS[-1] * PROJECT_BK * 2
NUM_SMS = 132
SE_PACK_RANKS = 8         # the cluster that `pack_se` lays w_se1, w_se2 out for
# kernel (b): from this many bytes of SE weights on, the cluster splits the
# channels; below, the tiles, each CTA reading about this many bytes of sums
SE_SPLIT_CHANNELS_BYTES = 16 * 1024
SE_TILE_BYTES_PER_RANK = 16 * 1024
MAX_SMEM_BYTES = 232448   # dynamic shared memory one H100 block may use

launches = {'mbconv_expand_dw': 0, 'mbconv_se': 0, 'mbconv_project': 0}


class FoldedMBConv(NamedTuple):
    """BN-folded MBConv weights; expanded channels padded to CeP. A block
    without expand (expand_ratio 1) has w_exp = b_exp = None."""
    w_exp: Optional[torch.Tensor]   # (Cin, CeP) bf16
    b_exp: Optional[torch.Tensor]   # (CeP,) f32
    w_dw: torch.Tensor              # (k, k, CeP) f32
    b_dw: torch.Tensor              # (CeP,) f32
    w_se1: torch.Tensor             # (Cs, CeP) f32, row j reduces into j
    b_se1: torch.Tensor             # (Cs,) f32
    w_se2: torch.Tensor             # (Cs, CeP) f32
    b_se2: torch.Tensor             # (CeP,) f32
    w_prj: torch.Tensor             # (CeP, Co) bf16
    b_prj: torch.Tensor             # (Co,) f32
    # the same weights as the kernels read them (pack_expand, pack_project)
    wexp_pack: Optional[torch.Tensor] = None   # uint8, chunks of w_exp+b_exp
    dw_pack: Optional[torch.Tensor] = None     # uint8, chunks of w_dw+b_dw
    wprj_pack: Optional[torch.Tensor] = None   # uint8, K-blocks of w_prj
    se_pack: Optional[torch.Tensor] = None     # f32, per-CTA w_se1 + w_se2


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _fold_conv_bn(weight: torch.Tensor, sd: Mapping[str, torch.Tensor],
                  bn: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """OIHW conv weight and BN `bn` -> folded (weight, bias), fp32."""
    scale = sd[f'{bn}.weight'].float() / torch.sqrt(
        sd[f'{bn}.running_var'].float() + BN_EPS)
    k = weight.float() * scale.reshape(-1, *([1] * (weight.dim() - 1)))
    b = sd[f'{bn}.bias'].float() - sd[f'{bn}.running_mean'].float() * scale
    return k, b


def _pad_cols(a: torch.Tensor, size: int) -> torch.Tensor:
    return F.pad(a, (0, size - a.shape[-1]))


def fold_mbconv(sd: Mapping[str, torch.Tensor], args: BlockArgs,
                device=None) -> FoldedMBConv:
    """sd: one block's state_dict (keys `_expand_conv.conv.weight`,
    `_bn0.running_var`, ...). Raises for a block the kernels cannot take."""
    if not has_se(args):
        raise ValueError('the fused MBConv kernels need a squeeze-excite')
    ce = args.input_filters * args.expand_ratio
    cep = _round_up(ce, CHUNK if args.expand_ratio != 1 else NOEXPAND_ALIGN)
    if args.expand_ratio != 1:
        k, b = _fold_conv_bn(sd['_expand_conv.conv.weight'], sd, '_bn0')
        w_exp = _pad_cols(k[:, :, 0, 0].t(), cep).to(torch.bfloat16)
        b_exp = _pad_cols(b, cep)
    else:
        w_exp = b_exp = None
    k, b = _fold_conv_bn(sd['_depthwise_conv.conv.weight'], sd, '_bn1')
    w_dw = _pad_cols(k[:, 0].permute(1, 2, 0), cep)
    b_dw = _pad_cols(b, cep)
    k, b = _fold_conv_bn(sd['_project_conv.conv.weight'], sd, '_bn2')
    w_prj = F.pad(k[:, :, 0, 0].t(), (0, 0, 0, cep - ce)).to(torch.bfloat16)
    w_se1 = _pad_cols(sd['_se_reduce.conv.weight'][:, :, 0, 0].float(), cep)
    b_se1 = sd['_se_reduce.conv.bias'].float()
    w_se2 = _pad_cols(sd['_se_expand.conv.weight'][:, :, 0, 0].float().t(),
                      cep)
    b_se2 = _pad_cols(sd['_se_expand.conv.bias'].float(), cep)
    wexp_pack = dw_pack = None
    if w_exp is not None:
        wexp_pack, dw_pack = pack_expand(w_exp, b_exp, w_dw, b_dw)
    tensors = (w_exp, b_exp, w_dw, b_dw, w_se1, b_se1, w_se2, b_se2,
               w_prj, b, wexp_pack, dw_pack, pack_project(w_prj),
               pack_se(w_se1, w_se2))
    return FoldedMBConv(*(None if t is None else t.contiguous().to(device)
                          for t in tensors))


def has_skip(args: BlockArgs) -> bool:
    return (args.id_skip and args.stride == 1
            and args.input_filters == args.output_filters)


def output_hw(h: int, w: int, args: BlockArgs) -> Tuple[int, int]:
    """(Ho, Wo) = (H/s, W/s). Odd sizes at stride 2 raise: there the TPU
    kernel emits floor(H/2) rows and flax 'SAME' ceil(H/2)."""
    s = args.stride
    if s == 2 and (h % 2 or w % 2):
        raise ValueError(f'stride-2 MBConv needs even H and W, got {h}x{w}')
    return h // s, w // s


# ---------------------------------------------------------------------------
# the weights as the kernels read them
# ---------------------------------------------------------------------------

def _core_matrices(w: torch.Tensor) -> torch.Tensor:
    """(N, K) -> the bytes of a K-major wgmma operand without swizzle: 8x8
    core matrices of 128 contiguous bytes, K fastest, then N."""
    n, k = w.shape
    return (w.reshape(n // 8, 8, k // 8, 8).permute(0, 2, 1, 3)
            .contiguous().view(torch.uint8).reshape(-1))


def _from_core_matrices(raw: torch.Tensor, n: int, k: int) -> torch.Tensor:
    return (raw.view(torch.bfloat16).reshape(n // 8, k // 8, 8, 8)
            .permute(0, 2, 1, 3).reshape(n, k))


def _f32_bytes(a: torch.Tensor) -> torch.Tensor:
    return a.contiguous().view(torch.uint8).reshape(a.shape[0], -1)


def pack_expand(w_exp: torch.Tensor, b_exp: torch.Tensor,
                w_dw: torch.Tensor, b_dw: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel (a)'s weights, one record per chunk of CHUNK channels.
    wexp_pack: w_exp transposed to (CHUNK, kpad) with K zero-padded to a
    multiple of 16, as core matrices, then the chunk's b_exp (fp32).
    dw_pack: the chunk's w_dw (k*k, CHUNK) then b_dw (CHUNK), fp32."""
    cin, cep = w_exp.shape
    kpad = _round_up(cin, 16)
    n = cep // CHUNK
    wt = F.pad(w_exp.t(), (0, kpad - cin)).reshape(n, CHUNK, kpad)
    w = torch.stack([_core_matrices(c) for c in wt])
    wexp_pack = torch.cat([w, _f32_bytes(b_exp.reshape(n, CHUNK))], dim=1)
    kk = w_dw.shape[0] * w_dw.shape[1]
    taps = w_dw.reshape(kk, n, CHUNK).permute(1, 0, 2).reshape(n, kk * CHUNK)
    dw_pack = torch.cat([_f32_bytes(taps),
                         _f32_bytes(b_dw.reshape(n, CHUNK))], dim=1)
    return wexp_pack.reshape(-1), dw_pack.reshape(-1)


def unpack_expand(wexp_pack: torch.Tensor, dw_pack: torch.Tensor, cin: int,
                  k: int):
    """Inverse of pack_expand: (w_exp, b_exp, w_dw, b_dw)."""
    kpad = _round_up(cin, 16)
    rec = wexp_pack.reshape(-1, CHUNK * kpad * 2 + CHUNK * 4)
    n = rec.shape[0]
    w = torch.stack([_from_core_matrices(r[:CHUNK * kpad * 2].contiguous(),
                                         CHUNK, kpad) for r in rec])
    w_exp = w.reshape(n * CHUNK, kpad)[:, :cin].t()
    b_exp = rec[:, CHUNK * kpad * 2:].contiguous().view(torch.float32)
    dw = dw_pack.reshape(n, -1).view(torch.float32).reshape(n, k * k + 1,
                                                            CHUNK)
    w_dw = dw[:, :-1].permute(1, 0, 2).reshape(k, k, n * CHUNK)
    return w_exp, b_exp.reshape(-1), w_dw, dw[:, -1].reshape(-1)


def pack_project(w_prj: torch.Tensor) -> torch.Tensor:
    """Kernel (c)'s w_prj: for each block of PROJECT_BK rows of K, the
    block transposed to (Co, bk) as core matrices, so that any range of
    output channels of a K-block is one contiguous piece. Behind the last
    value lies as much zero slack as the widest piece a CTA may copy."""
    cep, _ = w_prj.shape
    parts = [_core_matrices(w_prj[k0:k0 + PROJECT_BK].t())
             for k0 in range(0, cep, PROJECT_BK)]
    parts.append(torch.zeros(PROJECT_SLACK, dtype=torch.uint8,
                             device=w_prj.device))
    return torch.cat(parts)


def unpack_project(wprj_pack: torch.Tensor, cep: int, co: int) -> torch.Tensor:
    """Inverse of pack_project: w_prj (CeP, Co)."""
    rows, at = [], 0
    for k0 in range(0, cep, PROJECT_BK):
        bk = min(PROJECT_BK, cep - k0)
        rows.append(_from_core_matrices(wprj_pack[at:at + co * bk * 2], co,
                                        bk).t())
        at += co * bk * 2
    return torch.cat(rows)


def se_channels_per_rank(cep: int, ranks: int) -> int:
    """Channels of one CTA where kernel (b) splits them over `ranks` CTAs."""
    return _round_up(-(-cep // ranks), 4)


def pack_se(w_se1: torch.Tensor, w_se2: torch.Tensor) -> torch.Tensor:
    """Kernel (b)'s weights for a cluster of SE_PACK_RANKS CTAs that split
    the channels: for each rank one record, its columns of w_se1 (Cs, per)
    then of w_se2 (Cs, per), zero padded to per = se_channels_per_rank, so
    that one copy brings a CTA all it needs."""
    cs, cep = w_se1.shape
    per = se_channels_per_rank(cep, SE_PACK_RANKS)
    both = _pad_cols(torch.stack([w_se1, w_se2]), SE_PACK_RANKS * per)
    return (both.reshape(2, cs, SE_PACK_RANKS, per).permute(2, 0, 1, 3)
            .contiguous().reshape(-1))


def unpack_se(se_pack: torch.Tensor, cs: int, cep: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of pack_se: (w_se1, w_se2), each (Cs, CeP)."""
    per = se_channels_per_rank(cep, SE_PACK_RANKS)
    both = (se_pack.reshape(SE_PACK_RANKS, 2, cs, per).permute(1, 2, 0, 3)
            .reshape(2, cs, SE_PACK_RANKS * per)[..., :cep])
    return both[0], both[1]


# ---------------------------------------------------------------------------
# tile plans (mirrors of the kernels' geometry)
# ---------------------------------------------------------------------------

class TilePlan(NamedTuple):
    """Kernel (a)'s tiling of one block at one shape: th x tw output pixels
    per tile, and the chunks of a tile split over `nsplit` CTAs."""
    th: int
    tw: int
    nsplit: int


def num_tiles(ho: int, wo: int, th: int, tw: int) -> int:
    return -(-ho // th) * -(-wo // tw)


def _tile_row_stride(min_bytes: int, s: int) -> int:
    r = _round_up(min_bytes, 16)
    while (s * r) % 128 != 96:
        r += 16
    return r


@functools.lru_cache(maxsize=None)
def expand_dw_smem_bytes(args: BlockArgs, th: int = 8, tw: int = 8) -> int:
    """Shared memory that kernel (a) needs for this block with th x tw
    tiles (csrc/mbconv_expand_dw.cu `Geom::smem_bytes` and
    `launch_dw_only`). With an expand: the bf16 input halo in 64-row groups,
    two stages of chunk records, two bf16 expanded tiles (112 bytes a
    pixel, padded rows), two staged output chunks and their strip sums."""
    k, s, cin = args.kernel_size, args.stride, args.input_filters
    hph, hpw = (th - 1) * s + k, (tw - 1) * s + k
    if args.expand_ratio == 1:
        cep = _round_up(cin, NOEXPAND_ALIGN)
        return (_round_up(hph * hpw * (cep * 2 + 16), 128) + th * tw * cep * 2
                + th * (tw // 8) * cep * 4)
    kpad = _round_up(cin, 16)
    groups = -(-hph * hpw // 64)
    stage = _round_up(CHUNK * kpad * 2 + CHUNK * 4 + (k * k + 1) * CHUNK * 4,
                      128)
    etile = _round_up(hph * _tile_row_stride(hpw * (CHUNK * 2 + 16), s), 128)
    strips = th * tw // (8 if th * tw >= 128 or (k, s) == (5, 2) else 4)
    return (128 + groups * 64 * kpad * 2 + 2 * stage + 2 * etile
            + 2 * th * tw * CHUNK * 2 + 2 * strips * CHUNK * 4)


@functools.lru_cache(maxsize=None)
def tile_plan(args: BlockArgs, batch: int, ho: int, wo: int) -> TilePlan:
    """A static choice by shape. 16x8 tiles halve the halo recompute of 8x8
    ones; they are taken at stride 1 where they fit in shared memory and
    leave at least one CTA per SM. The chunks of a tile are split over up to
    8 CTAs where that shortens the schedule on NUM_SMS SMs, a wave costing
    its chunks plus about 1.5 chunks for the halo load and the first GEMM."""
    if args.expand_ratio == 1:
        return TilePlan(16, 8, 1)
    th = 8
    if (args.stride == 1 and expand_dw_smem_bytes(args, 16, 8) <= MAX_SMEM_BYTES
            and batch * num_tiles(ho, wo, 16, 8) >= NUM_SMS):
        th = 16
    ctas = batch * num_tiles(ho, wo, th, 8)
    chunks = args.input_filters * args.expand_ratio // CHUNK

    def cost(n):
        return -(-ctas * n // NUM_SMS) * (-(-chunks // n) + 1.5)
    nsplit = min(range(1, min(chunks, 8) + 1), key=cost)
    return TilePlan(th, 8, nsplit)


class ProjectPlan(NamedTuple):
    """Kernel (c)'s launch at one shape: output channels per CTA, CTAs that
    share the row tiles, consumer warpgroups per CTA (64 rows each) and the
    depth of the ring."""
    cols: int
    row_ctas: int
    nwg: int
    stages: int


def project_smem_bytes(cep: int, cols: int, nwg: int, stages: int,
                       alias_out: bool) -> int:
    """Shared memory of kernel (c) (csrc/mbconv_project.cu `project_smem`):
    barriers and alignment room, the ring (per warpgroup the 64x64 boxes of
    d and the gates of two images, and one w_prj piece), and the fp32 output
    tile, behind the ring or (one tile per CTA) over it."""
    nt = next(w for w in PROJECT_WIDTHS if w >= cols)
    kmax = min(PROJECT_BK, cep)
    stage = _round_up(nwg * (-(-kmax // 64) * PROJECT_BM * 128 + 2 * kmax * 4)
                      + nt * kmax * 2, 1024)
    out = nwg * PROJECT_BM * (nt + (40 - nt % 32) % 32) * 4
    ring = stages * stage
    return 2048 + (max(ring, out) if alias_out else ring + out)


def make_project_plan(m: int, cep: int, co: int, nwg: int, stages: int,
                      persistent: bool) -> ProjectPlan:
    """The plan with these choices: the column split that fills the SMs, and
    the CTA count (one CTA per row tile, or as many as the SMs hold at once,
    four at most each). Raises if the ring does not fit."""
    groups = co // 8
    row_tiles = -(-m // (PROJECT_BM * nwg))
    parts = [n for n in range(1, groups + 1)
             if groups % n == 0 and co // n <= PROJECT_WIDTHS[-1]]
    few = [n for n in parts if n <= max(2, parts[0])]
    filling = [n for n in few if row_tiles * n >= NUM_SMS]
    cols = co // (filling[0] if filling else few[-1])
    smem = project_smem_bytes(cep, cols, nwg, stages, not persistent)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f'the project kernel\'s ring of {stages} stages '
                         f'needs {smem} B of shared memory')
    row_ctas = row_tiles
    if persistent:   # an SM has 228 KB; each CTA reserves 1 KB more
        per_sm = min(4, 233472 // (smem + 1024))
        row_ctas = min(row_tiles, NUM_SMS * per_sm)
    return ProjectPlan(cols, row_ctas, nwg, stages)


@functools.lru_cache(maxsize=None)
def project_plan(m: int, cep: int, co: int) -> ProjectPlan:
    """A static choice by shape. Output channels per CTA: all of them where
    they fit one accumulator (256) and the row tiles fill the SMs; else Co is
    cut in two equal parts (or the fewest that fit), so that d is read twice
    at most at every EfficientDet-D2 shape."""
    nkb = -(-cep // PROJECT_BK)
    nwg = 2 if m >= 2 * PROJECT_BM else 1
    for stages in (4, 3, 2):
        try:
            return make_project_plan(m, cep, co, nwg, stages, nkb <= 2)
        except ValueError:
            continue
    raise ValueError(f'no ring of the project kernel fits Co = {co}')


class SePlan(NamedTuple):
    """Kernel (b)'s launch at one shape: the CTAs of an image's cluster, what
    they share out (the tiles of the reduction, or the channels), how many
    of those each CTA owns, and the threads of a CTA."""
    ranks: int
    split_tiles: bool
    per_rank: int
    threads: int


def se_smem_bytes(cep: int, cs: int, plan: SePlan) -> int:
    """Shared memory of one CTA of kernel (b) (csrc/mbconv.cu `se_layout`):
    the mbarrier, the staged rows of w_se1 and w_se2 (whole, or this CTA's
    channels), one float4 per thread for the reduction, the parts received
    from every CTA of the cluster, the mean, b_se2, b_se1 and s1."""
    ldw = cep if plan.split_tiles else plan.per_rank
    pw = cep if plan.split_tiles else cs
    floats = (4 + 2 * cs * ldw + plan.threads * 4
              + _round_up(plan.ranks * pw, 4) + 2 * ldw
              + 2 * _round_up(cs, 4))
    return floats * 4


def make_se_plan(n_tiles: int, cep: int, cs: int, ranks: int,
                 split_tiles: bool, threads: int) -> SePlan:
    """The plan with these choices: tiles, or channels in multiples of 4,
    dealt evenly over the CTAs. Raises for what the kernel does not take."""
    if ranks not in (1, 2, 4, 8):
        raise ValueError(f'a cluster of {ranks} CTAs is not portable')
    if threads % 32 or not 32 <= threads <= 1024:
        raise ValueError(f'{threads} threads per CTA')
    if cep % 16:
        raise ValueError(f'the SE kernel reads 16 channels at a time; got '
                         f'{cep}')
    if split_tiles:
        per_rank = -(-n_tiles // ranks)
        columns = cep // 4
    else:
        per_rank = se_channels_per_rank(cep, ranks)
        columns = per_rank // 4
        if 2 * cs * per_rank * 4 >= 1 << 20:
            raise ValueError('a CTA\'s weight slice exceeds what one '
                             'mbarrier counts')
    if columns > threads:
        raise ValueError(f'{threads} threads cannot hold {columns} float4 '
                         'columns')
    plan = SePlan(ranks, split_tiles, per_rank, threads)
    smem = se_smem_bytes(cep, cs, plan)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f'the SE kernel would need {smem} B of shared '
                         'memory')
    return plan


@functools.lru_cache(maxsize=None)
def se_plan(n_tiles: int, cep: int, cs: int) -> SePlan:
    """A static choice by shape, from a sweep over every plan at the D2@768
    shapes (scripts/torch_sweep_se_plan.py). Blocks whose SE weights are the
    larger part of the bytes split the channels over a cluster of 8, each
    CTA staging its record of `pack_se` in one copy; narrow blocks split the
    tiles, over as many CTAs as leaves each about 16 KB of tile sums to
    read. Few threads start and synchronise faster; the widest blocks need
    more for their GEMVs."""
    if 2 * cs * cep * 4 >= SE_SPLIT_CHANNELS_BYTES:
        threads = 256 if cep < 1024 else 512 if cep < 2048 else 1024
        return make_se_plan(n_tiles, cep, cs, SE_PACK_RANKS, False, threads)
    ranks = 1
    while ranks < 8 and n_tiles * cep * 4 > ranks * SE_TILE_BYTES_PER_RANK \
            and n_tiles >= 2 * ranks:
        ranks *= 2
    return make_se_plan(n_tiles, cep, cs, ranks, True, 256)


def check_kernel_fits(args: BlockArgs) -> None:
    """Raise for a block the CUDA kernels cannot take."""
    if args.kernel_size not in (3, 5) or args.stride not in (1, 2):
        raise ValueError(f'no MBConv kernel for k={args.kernel_size} '
                         f's={args.stride}')
    if not has_se(args):
        raise ValueError('the fused MBConv kernels need a squeeze-excite')
    if args.input_filters % 8:
        raise ValueError('the expand kernel reads the input 8 channels at a '
                         f'time; got {args.input_filters} channels')
    if args.output_filters % 8:
        raise ValueError('the project kernel writes 8 output channels at a '
                         f'time; got {args.output_filters}')
    smem = expand_dw_smem_bytes(args, 16 if args.expand_ratio == 1 else 8, 8)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f'MBConv block {args} needs {smem} B of shared '
                         f'memory, more than {MAX_SMEM_BYTES}')


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def expand_dw_reference(x: torch.Tensor, f: FoldedMBConv, args: BlockArgs
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, H, W, Cin) bf16 -> (d (B, Ho, Wo, CeP) bf16, sums (B, 1, CeP) f32)."""
    b, h, w, cin = x.shape
    k, s = args.kernel_size, args.stride
    ho, wo = output_hw(h, w, args)
    cep = f.w_dw.shape[-1]
    xf = x.float()
    if f.w_exp is not None:
        e = swish(xf @ f.w_exp.float() + f.b_exp)
    else:
        e = _pad_cols(xf, cep)
    e = e.to(torch.bfloat16).float()
    pt, pb = same_pad_amounts(h, s, k)
    pl, pr = same_pad_amounts(w, s, k)
    e = F.pad(e, (0, 0, pl, pr + s - 1, pt, pb + s - 1))  # zeros: TF-SAME
    acc = f.b_dw.expand(b, ho, wo, cep)
    for dy in range(k):
        for dx in range(k):
            win = e[:, dy:dy + s * (ho - 1) + 1:s, dx:dx + s * (wo - 1) + 1:s]
            acc = acc + win * f.w_dw[dy, dx]
    dv = swish(acc)
    return dv.to(torch.bfloat16), dv.sum(dim=(1, 2))[:, None, :]


def se_gate_reference(sums: torch.Tensor, f: FoldedMBConv,
                      hw: int) -> torch.Tensor:
    """sums (B, T, CeP) per-tile channel sums -> gate (B, CeP) f32."""
    m = sums.sum(dim=1) / hw
    s1 = swish(m @ f.w_se1.t() + f.b_se1)
    return torch.sigmoid(s1 @ f.w_se2 + f.b_se2)


def project_reference(d: torch.Tensor, gate: torch.Tensor, f: FoldedMBConv,
                      skip: Optional[torch.Tensor]) -> torch.Tensor:
    """d (B, Ho, Wo, CeP) bf16, gate (B, CeP) -> (B, Ho, Wo, Co) bf16."""
    a = (d.float() * gate[:, None, None, :]).to(torch.bfloat16).float()
    out = a @ f.w_prj.float() + f.b_prj
    if skip is not None:
        out = out + skip.float()
    return out.to(torch.bfloat16)


def mbconv_fused_reference(x: torch.Tensor, f: FoldedMBConv,
                           args: BlockArgs) -> torch.Tensor:
    """The whole block in plain torch: x (B, H, W, Cin) -> (B, Ho, Wo, Co) bf16."""
    x = x.to(torch.bfloat16)
    d, sums = expand_dw_reference(x, f, args)
    gate = se_gate_reference(sums, f, d.shape[1] * d.shape[2])
    return project_reference(d, gate, f, x if has_skip(args) else None)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
# entry point -> (its source in csrc/, its C argument types)
_SIGNATURES = {
    'mbconv_expand_dw': ('mbconv_expand_dw', [_P] * 7 + [_I] * 13 + [_P]),
    'mbconv_se': ('mbconv', [_P] * 7 + [_I] * 9 + [_P]),
    'mbconv_se_max_clusters': ('mbconv', [_I] * 7),
    'mbconv_project': ('mbconv_project', [_P] * 6 + [_I] * 8 + [_P]),
}
_FUNCTIONS: dict = {}


def _fn(name: str):
    """The C entry point `name`; its source is built at first use."""
    fn = _FUNCTIONS.get(name)
    if fn is None:
        source, argtypes = _SIGNATURES[name]
        fn = getattr(cuda_build.load(source), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FUNCTIONS[name] = fn
    return fn


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check(t: torch.Tensor, dtype: torch.dtype, shape, device, name: str):
    if t.device != device:
        raise ValueError(f'{name} is on {t.device}, expected {device}')
    if t.dtype != dtype:
        raise ValueError(f'{name} is {t.dtype}, expected {dtype}')
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f'{name} has shape {tuple(t.shape)}, expected '
                         f'{tuple(shape)}')
    if not t.is_contiguous():
        raise ValueError(f'{name} must be contiguous')


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f'{name} launch failed with CUDA error {err}')


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _expand_dw_cuda(x: torch.Tensor, f: FoldedMBConv, args: BlockArgs
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel (a)'s launch: x (B, H, W, Cin) bf16 -> (d (B, Ho, Wo, CeP)
    bf16, per-tile sums (B, T, CeP) f32)."""
    b, h, w, cin = x.shape
    k, s = args.kernel_size, args.stride
    ho, wo = output_hw(h, w, args)
    cep = f.w_dw.shape[-1]
    dev = x.device
    check_kernel_fits(args)
    _check(x, torch.bfloat16, (b, h, w, args.input_filters), dev, 'x')
    if x.data_ptr() % 16:
        raise ValueError('x must start on a 16-byte boundary')
    kpad = _round_up(cin, 16)
    if args.expand_ratio != 1:
        if f.wexp_pack is None:
            raise ValueError('folded weights lack the expand conv')
        n = cep // CHUNK
        _check(f.wexp_pack, torch.uint8,
               (n * (CHUNK * kpad * 2 + CHUNK * 4),), dev, 'wexp_pack')
        _check(f.dw_pack, torch.uint8, (n * (k * k + 1) * CHUNK * 4,), dev,
               'dw_pack')
    _check(f.w_dw, torch.float32, (k, k, cep), dev, 'w_dw')
    _check(f.b_dw, torch.float32, (cep,), dev, 'b_dw')
    plan = tile_plan(args, b, ho, wo)
    d = torch.empty((b, ho, wo, cep), dtype=torch.bfloat16, device=dev)
    sums = torch.empty((b, num_tiles(ho, wo, plan.th, plan.tw), cep),
                       dtype=torch.float32, device=dev)
    pt, _ = same_pad_amounts(h, s, k)
    pl, _ = same_pad_amounts(w, s, k)
    with torch.cuda.device(dev):
        err = _fn('mbconv_expand_dw')(
            _ptr(x), _ptr(f.wexp_pack), _ptr(f.dw_pack), _ptr(f.w_dw),
            _ptr(f.b_dw), _ptr(d), _ptr(sums), b, h, w, cin, kpad, cep, k, s,
            pt, pl, plan.th, plan.tw, plan.nsplit, _stream(dev))
    _raise_on(err, 'mbconv_expand_dw')
    launches['mbconv_expand_dw'] += 1
    return d, sums


@functools.lru_cache(maxsize=None)
def _check_clusters_fit(device_index: int, b: int, cep: int, cs: int,
                        plan: SePlan) -> None:
    """Once per card and launch shape: the card must hold at least one
    cluster of kernel (b) at this plan, or the launch would fail."""
    with torch.cuda.device(device_index):
        n = _fn('mbconv_se_max_clusters')(b, cep, cs, plan.ranks,
                                          int(plan.split_tiles),
                                          plan.per_rank, plan.threads)
    if n < 1:
        raise RuntimeError(
            f'the card holds no cluster of the SE kernel at {plan} '
            f'(cudaOccupancyMaxActiveClusters: {n})')


def _se_gate_cuda(sums: torch.Tensor, f: FoldedMBConv, hw: int,
                  plan: Optional[SePlan]) -> torch.Tensor:
    """Kernel (b)'s launch: per-tile sums (B, T, CeP) -> gate (B, CeP) f32."""
    b, t, cep = sums.shape
    cs = f.w_se1.shape[0]
    dev = sums.device
    if plan is None:
        plan = se_plan(t, cep, cs)
    _check(sums, torch.float32, (b, t, cep), dev, 'sums')
    _check(f.w_se1, torch.float32, (cs, cep), dev, 'w_se1')
    _check(f.b_se1, torch.float32, (cs,), dev, 'b_se1')
    _check(f.w_se2, torch.float32, (cs, cep), dev, 'w_se2')
    _check(f.b_se2, torch.float32, (cep,), dev, 'b_se2')
    for name in ('w_se1', 'w_se2'):
        if getattr(f, name).data_ptr() % 16:
            raise ValueError(f'{name} must start on a 16-byte boundary')
    packed = None
    if plan.ranks == SE_PACK_RANKS and not plan.split_tiles:
        packed = f.se_pack
        if packed is None:
            raise ValueError('folded weights lack se_pack')
        _check(packed, torch.float32, (SE_PACK_RANKS * 2 * cs * plan.per_rank,),
               dev, 'se_pack')
        if packed.data_ptr() % 16:
            raise ValueError('se_pack must start on a 16-byte boundary')
    _check_clusters_fit(dev.index, b, cep, cs, plan)
    gate = torch.empty((b, cep), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _fn('mbconv_se')(_ptr(sums), _ptr(f.w_se1), _ptr(f.b_se1),
                                _ptr(f.w_se2), _ptr(f.b_se2), _ptr(packed),
                                _ptr(gate), b, t, cep, cs, hw, plan.ranks,
                                int(plan.split_tiles), plan.per_rank,
                                plan.threads, _stream(dev))
    _raise_on(err, 'mbconv_se')
    launches['mbconv_se'] += 1
    return gate


def _project_cuda(d: torch.Tensor, gate: torch.Tensor, f: FoldedMBConv,
                  skip: Optional[torch.Tensor]) -> torch.Tensor:
    """Kernel (c)'s launch: bf16(d * gate) @ w_prj + b_prj (+ skip) -> bf16."""
    b, ho, wo, cep = d.shape
    co = f.w_prj.shape[1]
    dev = d.device
    _check(d, torch.bfloat16, (b, ho, wo, cep), dev, 'd')
    _check(gate, torch.float32, (b, cep), dev, 'gate')
    if f.w_prj.shape[0] != cep:
        raise ValueError(f'd has {cep} channels, w_prj {f.w_prj.shape[0]}')
    _check(f.wprj_pack, torch.uint8, (cep * co * 2 + PROJECT_SLACK,), dev,
           'wprj_pack')
    _check(f.b_prj, torch.float32, (co,), dev, 'b_prj')
    if skip is not None:
        _check(skip, torch.bfloat16, (b, ho, wo, co), dev, 'skip')
    out = torch.empty((b, ho, wo, co), dtype=torch.bfloat16, device=dev)
    if ho * wo < PROJECT_BM:
        raise ValueError(f'the project kernel needs at least {PROJECT_BM} '
                         f'pixels per image, got {ho}x{wo}')
    m = b * ho * wo
    plan = project_plan(m, cep, co)
    with torch.cuda.device(dev):
        err = _fn('mbconv_project')(_ptr(d), _ptr(gate), _ptr(f.wprj_pack),
                                    _ptr(f.b_prj), _ptr(skip), _ptr(out), m,
                                    ho * wo, cep, co, plan.cols,
                                    plan.row_ctas, plan.nwg, plan.stages,
                                    _stream(dev))
    _raise_on(err, 'mbconv_project')
    launches['mbconv_project'] += 1
    return out


# ---------------------------------------------------------------------------
# the kernels as torch.library custom ops (mm_distillnet::mbconv_*): a CPU
# implementation (the plain version), a CUDA one (the kernel, counted in
# `launches`) and a fake one (shapes and dtypes), so that torch.export and
# torch.compile can trace a forward that runs them and the device of the
# tensors picks the implementation
# ---------------------------------------------------------------------------

_ARGS_SCHEMA = ('int kernel_size, int stride, int input_filters, '
                'int output_filters, int expand_ratio, float se_ratio, '
                'bool id_skip')
_LIB = torch.library.Library('mm_distillnet', 'DEF')
_LIB.define('mbconv_expand_dw(Tensor x, Tensor? w_exp, Tensor? b_exp, '
            'Tensor w_dw, Tensor b_dw, Tensor? wexp_pack, Tensor? dw_pack, '
            f'{_ARGS_SCHEMA}) -> (Tensor, Tensor)')
_LIB.define('mbconv_se(Tensor sums, Tensor w_se1, Tensor b_se1, '
            'Tensor w_se2, Tensor b_se2, Tensor? se_pack, int hw, '
            'int[] plan) -> Tensor')
_LIB.define('mbconv_project(Tensor d, Tensor gate, Tensor w_prj, '
            'Tensor b_prj, Tensor wprj_pack, Tensor? skip) -> Tensor')


def _folded(**tensors) -> FoldedMBConv:
    """A FoldedMBConv holding only the tensors an op was given."""
    return FoldedMBConv(**{**{k: None for k in FoldedMBConv._fields},
                           **tensors})


def _args_tuple(args: BlockArgs) -> tuple:
    return (args.kernel_size, args.stride, args.input_filters,
            args.output_filters, args.expand_ratio, float(args.se_ratio),
            bool(args.id_skip))


def _block_args(k, s, cin, co, er, se_ratio, id_skip) -> BlockArgs:
    return BlockArgs(k, 1, cin, co, er, s, se_ratio, id_skip)


def _expand_dw_op(device_type: str):
    def impl(x, w_exp, b_exp, w_dw, b_dw, wexp_pack, dw_pack, *block):
        f = _folded(w_exp=w_exp, b_exp=b_exp, w_dw=w_dw, b_dw=b_dw,
                    wexp_pack=wexp_pack, dw_pack=dw_pack)
        run = expand_dw_reference if device_type == 'cpu' else _expand_dw_cuda
        return run(x, f, _block_args(*block))
    return impl


def _se_op(device_type: str):
    def impl(sums, w_se1, b_se1, w_se2, b_se2, se_pack, hw, plan):
        f = _folded(w_se1=w_se1, b_se1=b_se1, w_se2=w_se2, b_se2=b_se2,
                    se_pack=se_pack)
        if device_type == 'cpu':
            return se_gate_reference(sums, f, hw)
        return _se_gate_cuda(sums, f, hw,
                             SePlan(plan[0], bool(plan[1]), *plan[2:])
                             if plan else None)
    return impl


def _project_op(device_type: str):
    def impl(d, gate, w_prj, b_prj, wprj_pack, skip):
        f = _folded(w_prj=w_prj, b_prj=b_prj, wprj_pack=wprj_pack)
        run = project_reference if device_type == 'cpu' else _project_cuda
        return run(d, gate, f, skip)
    return impl


for _device, _key in (('cpu', 'CPU'), ('cuda', 'CUDA')):
    _LIB.impl('mbconv_expand_dw', _expand_dw_op(_device), _key)
    _LIB.impl('mbconv_se', _se_op(_device), _key)
    _LIB.impl('mbconv_project', _project_op(_device), _key)


@torch.library.register_fake('mm_distillnet::mbconv_expand_dw')
def _expand_dw_fake(x, w_exp, b_exp, w_dw, b_dw, wexp_pack, dw_pack, *block):
    args = _block_args(*block)
    b, h, w, _ = x.shape
    ho, wo = output_hw(h, w, args)
    cep = w_dw.shape[-1]
    # the plain version sums each image at once; the kernel per tile
    t = 1 if x.device.type == 'cpu' else num_tiles(
        ho, wo, *tile_plan(args, b, ho, wo)[:2])
    return (x.new_empty((b, ho, wo, cep), dtype=torch.bfloat16),
            x.new_empty((b, t, cep), dtype=torch.float32))


@torch.library.register_fake('mm_distillnet::mbconv_se')
def _se_fake(sums, w_se1, b_se1, w_se2, b_se2, se_pack, hw, plan):
    return sums.new_empty((sums.shape[0], sums.shape[2]),
                          dtype=torch.float32)


@torch.library.register_fake('mm_distillnet::mbconv_project')
def _project_fake(d, gate, w_prj, b_prj, wprj_pack, skip):
    return d.new_empty((*d.shape[:3], w_prj.shape[1]), dtype=torch.bfloat16)


def expand_dw(x: torch.Tensor, f: FoldedMBConv, args: BlockArgs
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel (a): x (B, H, W, Cin) bf16 -> (d (B, Ho, Wo, CeP) bf16,
    per-tile sums (B, T, CeP) f32); a CPU tensor runs the plain version
    (T = 1)."""
    return torch.ops.mm_distillnet.mbconv_expand_dw(
        x, f.w_exp, f.b_exp, f.w_dw, f.b_dw, f.wexp_pack, f.dw_pack,
        *_args_tuple(args))


def se_gate(sums: torch.Tensor, f: FoldedMBConv, hw: int,
            plan: Optional[SePlan] = None) -> torch.Tensor:
    """Kernel (b): per-tile sums (B, T, CeP) -> gate (B, CeP) f32. `plan`
    defaults to `se_plan` of the shape."""
    return torch.ops.mm_distillnet.mbconv_se(
        sums, f.w_se1, f.b_se1, f.w_se2, f.b_se2, f.se_pack, hw,
        [] if plan is None else [plan.ranks, int(plan.split_tiles),
                                 plan.per_rank, plan.threads])


def project(d: torch.Tensor, gate: torch.Tensor, f: FoldedMBConv,
            skip: Optional[torch.Tensor]) -> torch.Tensor:
    """Kernel (c): bf16(d * gate) @ w_prj + b_prj (+ skip) -> bf16."""
    return torch.ops.mm_distillnet.mbconv_project(
        d, gate, f.w_prj, f.b_prj, f.wprj_pack, skip)


def mbconv_fused(x: torch.Tensor, f: FoldedMBConv,
                 args: BlockArgs) -> torch.Tensor:
    """One eval MBConv block: x (B, H, W, Cin) bf16 -> (B, H/s, W/s, Co) bf16.
    CUDA tensors run kernels (a)-(c); CPU tensors their plain versions."""
    output_hw(x.shape[1], x.shape[2], args)
    d, sums = expand_dw(x, f, args)
    gate = se_gate(sums, f, d.shape[1] * d.shape[2])
    return project(d, gate, f, x if has_skip(args) else None)


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _bound_ms(nbytes: float, ops: Mapping[str, float]) -> Tuple[float, str]:
    """Least time on an H100 SXM (3.35 TB/s; 989 TFLOP/s bf16 tensor core,
    67 TFLOP/s fp32): the larger of the byte time and the op time."""
    peak = {'bf16': 989e12, 'fp32': 67e12}
    t_bytes = nbytes / 3.35e12
    t_ops = sum(n / peak[kind] for kind, n in ops.items())
    return (max(t_bytes, t_ops) * 1e3,
            'bytes' if t_bytes >= t_ops else 'operations')


def bounds(args: BlockArgs, batch: int, h: int, w: int) -> dict:
    """Per-kernel least times (ms) for one block at this shape: each input
    read once and each output written once, at the block's own expanded
    width Ce (the kernels' padding of Ce is their cost, not the
    function's), expand and project as bf16 GEMMs on the tensor cores, the
    depthwise and SE in fp32. The tile sums that (a) writes and (b) reads
    are counted by the tile count of `tile_plan`, so these two bounds move
    a little with the plan."""
    k, s, cin, co = (args.kernel_size, args.stride, args.input_filters,
                     args.output_filters)
    ho, wo = output_hw(h, w, args)
    ce = cin * args.expand_ratio
    cs = max(1, int(cin * args.se_ratio))
    plan = tile_plan(args, batch, ho, wo)
    t = num_tiles(ho, wo, plan.th, plan.tw)
    x_b = batch * h * w * cin * 2
    d_b = batch * ho * wo * ce * 2
    out_b = batch * ho * wo * co * 2
    sums_b = batch * t * ce * 4
    expand = args.expand_ratio != 1
    a_bytes = (x_b + d_b + sums_b + (k * k + 1) * ce * 4
               + ((cin * ce * 2 + ce * 4) if expand else 0))
    a_ops = {'bf16': 2.0 * batch * h * w * cin * ce if expand else 0.0,
             'fp32': 2.0 * batch * ho * wo * ce * k * k}
    b_bytes = sums_b + (2 * cs * ce + cs + ce) * 4 + batch * ce * 4
    b_ops = {'fp32': 4.0 * batch * cs * ce}
    c_bytes = (d_b + batch * ce * 4 + ce * co * 2 + co * 4 + out_b
               + (out_b if has_skip(args) else 0))
    c_ops = {'bf16': 2.0 * batch * ho * wo * ce * co}
    return {'mbconv_expand_dw': _bound_ms(a_bytes, a_ops),
            'mbconv_se': _bound_ms(b_bytes, b_ops),
            'mbconv_project': _bound_ms(c_bytes, c_ops)}
