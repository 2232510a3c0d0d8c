"""MBConv: the port's unfused block and the fused block's plain version
against the reference (flax MBConvBlock and the Pallas kernel in interpret
mode), plus the CUDA kernels against the plain version on a card."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm_distillnet_tpu.models.efficientnet import MBConvBlock as JaxMBConv
from mm_distillnet_tpu.ops import pallas_mbconv
from mm_distillnet_torch.convert.weights import state_dict_from_flax
from mm_distillnet_torch.models.efficientnet import (BlockArgs, MBConvBlock,
                                                     expand_block_args)
from mm_distillnet_torch.ops import fused_mbconv as fm

from .test_torch_helpers import (as_jax_args, corr, filled_variables,
                                 nhwc_input, to_jax)


@pytest.fixture
def _interpret(monkeypatch):
    """Run the reference's Pallas kernel in interpreter mode on the CPU."""
    import jax.experimental.pallas as pl
    orig = pl.pallas_call
    monkeypatch.setattr(pallas_mbconv.pl, 'pallas_call',
                        functools.partial(orig, interpret=True))


# the reference kernel test's five blocks (tests/test_pallas_mbconv.py),
# plus an odd stride-1 size
CASES = [
    (BlockArgs(3, 1, 16, 16, 6, 1), (16, 16)),   # expand + skip
    (BlockArgs(5, 1, 16, 24, 6, 1), (16, 16)),   # expand, no skip
    (BlockArgs(3, 1, 32, 16, 1, 1), (16, 16)),   # no expand (ratio 1)
    (BlockArgs(3, 1, 16, 24, 6, 2), (16, 16)),   # stride 2
    (BlockArgs(5, 1, 16, 24, 6, 2), (16, 16)),   # stride 2, k5
    (BlockArgs(5, 1, 16, 16, 6, 1), (15, 13)),   # odd size, stride 1
]
IDS = ['expand_skip', 'expand', 'no_expand', 's2', 's2_k5', 'odd_s1']


def _block(args, size, seed=0):
    x = nhwc_input(seed, (2, *size, args.input_filters))
    mod = JaxMBConv(as_jax_args(args), dtype=jnp.float32)
    v = filled_variables(mod, seed + 1, x)
    want = np.asarray(mod.apply(to_jax(v), jnp.asarray(x), train=False))
    return x, v, want


def _close_bf16(got, want):
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0.1, atol=0.05)
    assert corr(got, want) > 0.999


@pytest.mark.parametrize('args,size', CASES, ids=IDS)
def test_unfused_block_matches_flax(args, size):
    x, v, want = _block(args, size)
    block = MBConvBlock(args).eval()
    block.load_state_dict(state_dict_from_flax(v), strict=True)
    with torch.no_grad():
        got = block(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize('args,size', CASES, ids=IDS)
def test_fused_reference_matches_flax_and_pallas(args, size, _interpret):
    x, v, want = _block(args, size)
    folded = fm.fold_mbconv(state_dict_from_flax(v), args)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = fm.mbconv_fused_reference(xb, folded, args).float().numpy()
    _close_bf16(got, want)

    jfold = pallas_mbconv.fold_mbconv(to_jax(v['params']),
                                      to_jax(v['batch_stats']),
                                      as_jax_args(args))
    pallas = np.asarray(pallas_mbconv.mbconv_fused(
        jnp.asarray(x).astype(jnp.bfloat16), jfold, as_jax_args(args)),
        np.float32)
    _close_bf16(got, pallas)


def test_wrappers_on_cpu_run_the_plain_version_and_count_nothing():
    args, size = CASES[0]
    x, v, _ = _block(args, size)
    folded = fm.fold_mbconv(state_dict_from_flax(v), args)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    fm.reset_launches()
    got = fm.mbconv_fused(xb, folded, args)
    assert torch.equal(got, fm.mbconv_fused_reference(xb, folded, args))
    assert all(n == 0 for n in fm.launches.values())


@pytest.mark.parametrize('args,ce,cep', [
    (BlockArgs(3, 1, 16, 16, 1, 1), 16, 32),    # no expand: multiples of 32
    (BlockArgs(3, 1, 12, 16, 6, 1), 72, 96),    # expand: chunks of 48
], ids=['no_expand_16_to_32', 'expand_72_to_96'])
def test_padded_channels_stay_zero(args, ce, cep):
    x, v, _ = _block(args, (8, 8))
    f = fm.fold_mbconv(state_dict_from_flax(v), args)
    assert f.w_dw.shape[-1] == cep and (f.w_exp is None) == (ce == 16)
    assert (f.w_dw[..., ce:] == 0).all() and (f.w_prj[ce:] == 0).all()
    xb = torch.from_numpy(x).to(torch.bfloat16)
    d, sums = fm.expand_dw_reference(xb, f, args)
    assert (d[..., ce:] == 0).all() and (sums[..., ce:] == 0).all()
    # nothing of the padding reaches the output
    cut = f._replace(w_prj=f.w_prj[:ce])
    gate = fm.se_gate_reference(sums, f, 64)
    assert torch.equal(fm.project_reference(d, gate, f, None),
                       fm.project_reference(d[..., :ce], gate[:, :ce], cut,
                                            None))


def test_stride2_odd_size_raises():
    args = BlockArgs(3, 1, 16, 24, 6, 2)
    x, v, _ = _block(args, (16, 16))
    folded = fm.fold_mbconv(state_dict_from_flax(v), args)
    for shape in ((1, 15, 16, 16), (1, 16, 15, 16)):
        with pytest.raises(ValueError, match='even'):
            fm.mbconv_fused(torch.zeros(shape, dtype=torch.bfloat16),
                            folded, args)


def _shapes(coef, size):
    """(args, input H, output H) of every block of EfficientNet `coef`."""
    h = size // 2
    out = []
    for args in expand_block_args(coef):
        out.append((args, h, h // args.stride))
        h //= args.stride
    return out


def test_every_d2_block_fits_the_kernel():
    blocks = expand_block_args(2)
    assert len(blocks) == 23
    for args in blocks:
        fm.check_kernel_fits(args)
    b = fm.bounds(blocks[22], 8, 24, 24)
    assert set(b) == set(fm.launches)
    assert all(ms > 0 and by in ('bytes', 'operations')
               for ms, by in b.values())


@pytest.mark.parametrize('coef,size,batch', [(2, 768, 8), (0, 512, 8),
                                             (-1, 128, 2)],
                         ids=['d2_768', 'd0_512', 'tiny_128'])
def test_plans_fit_shared_memory(coef, size, batch):
    """The Python mirrors of the kernels' shared-memory layouts stay inside
    what one block may use, for every block at its planned tile and ring."""
    for args, h, ho in _shapes(coef, size):
        fm.check_kernel_fits(args)
        plan = fm.tile_plan(args, batch, ho, ho)
        assert (plan.th, plan.tw) in ((16, 8), (8, 8))
        assert fm.expand_dw_smem_bytes(args, plan.th, plan.tw) \
            <= fm.MAX_SMEM_BYTES
        if args.expand_ratio != 1:
            chunks = args.input_filters * args.expand_ratio // fm.CHUNK
            assert 1 <= plan.nsplit <= min(8, chunks)
        ce = args.input_filters * args.expand_ratio
        cep = ce if args.expand_ratio != 1 else -(-ce // 32) * 32
        if ho * ho < fm.PROJECT_BM:
            continue            # the wrapper refuses such a map
        m = batch * ho * ho
        pp = fm.project_plan(m, cep, args.output_filters)
        assert pp.cols % 8 == 0 and args.output_filters % pp.cols == 0
        assert pp.cols <= 256 and 2 <= pp.stages <= 6 and pp.nwg in (1, 2)
        row_tiles = -(-m // (fm.PROJECT_BM * pp.nwg))
        assert 1 <= pp.row_ctas <= row_tiles
        assert fm.project_smem_bytes(cep, pp.cols, pp.nwg, pp.stages,
                                     pp.row_ctas == row_tiles) \
            <= fm.MAX_SMEM_BYTES
        if coef == 2:           # d is read twice at most
            assert args.output_filters // pp.cols <= 2


@pytest.mark.parametrize('ho,wo,th,tw', [(24, 24, 16, 8), (15, 13, 8, 8),
                                         (21, 37, 16, 8), (48, 48, 16, 8)],
                         ids=['24_by_16x8', '15x13', '21x37', '48'])
def test_tile_plan_covers_every_pixel_once(ho, wo, th, tw):
    """Tiles as the kernel lays them (row-major, origin (ty*th, tx*tw),
    clipped at the border) cover each output pixel exactly once, ragged
    sizes and odd tile counts included."""
    tiles_x = -(-wo // tw)
    n = fm.num_tiles(ho, wo, th, tw)
    assert n == -(-ho // th) * tiles_x
    seen = np.zeros((ho, wo), np.int64)
    for tile in range(n):
        ty, tx = divmod(tile, tiles_x)
        seen[ty * th:(ty + 1) * th, tx * tw:(tx + 1) * tw] += 1
    assert (seen == 1).all()


_PACK_CASES = [c[0] for c in CASES[:5]] + [expand_block_args(2)[22]]


@pytest.mark.parametrize('args', _PACK_CASES, ids=IDS[:5] + ['d2_block22'])
def test_kernel_weight_layouts_round_trip(args):
    """The fold-time layouts the kernels read decode to the canonical
    w_exp / b_exp / w_dw / b_dw / w_prj, bit for bit."""
    torch.manual_seed(3)
    f = fm.fold_mbconv(MBConvBlock(args).eval().state_dict(), args)
    cep, co = f.w_prj.shape
    assert torch.equal(fm.unpack_project(f.wprj_pack, cep, co), f.w_prj)
    slack = fm.PROJECT_SLACK
    assert f.wprj_pack.numel() == cep * co * 2 + slack
    assert (f.wprj_pack[-slack:] == 0).all()
    if args.expand_ratio == 1:
        assert f.wexp_pack is None and f.dw_pack is None
        return
    w_exp, b_exp, w_dw, b_dw = fm.unpack_expand(
        f.wexp_pack, f.dw_pack, args.input_filters, args.kernel_size)
    assert torch.equal(w_exp, f.w_exp) and torch.equal(b_exp, f.b_exp)
    assert torch.equal(w_dw, f.w_dw) and torch.equal(b_dw, f.b_dw)
    # one value by the kernel's own address arithmetic (core_offset)
    kpad = -(-args.input_filters // 16) * 16
    rec = f.wexp_pack.reshape(cep // fm.CHUNK, -1)[-1]
    n, k = 13, args.input_filters - 3
    off = (n // 8) * kpad * 16 + (k // 8) * 128 + (n % 8) * 16 + (k % 8) * 2
    got = rec[off:off + 2].view(torch.bfloat16)[0]
    assert got == f.w_exp[k, cep - fm.CHUNK + n]


def test_bounds_count_the_unpadded_width():
    """Block 1 of D2 (Ce = 16, padded to 32 in the kernels): the bound of
    kernel (a) counts 16 channels of d and of the tile sums."""
    args = expand_block_args(2)[1]
    assert args.input_filters * args.expand_ratio == 16
    batch, h = 8, 384
    plan = fm.tile_plan(args, batch, h, h)
    tiles = fm.num_tiles(h, h, plan.th, plan.tw)
    assert tiles == (h // 16) * (h // 8)
    nbytes = (2 * batch * h * h * 16 * 2 + batch * tiles * 16 * 4
              + 10 * 16 * 4)
    ms, by = fm.bounds(args, batch, h, h)['mbconv_expand_dw']
    assert by == 'bytes'
    assert ms == pytest.approx(nbytes / 3.35e12 * 1e3, rel=1e-12)


@pytest.mark.parametrize('args,match', [
    (BlockArgs(3, 1, 12, 16, 6, 1), '8 channels'),   # 16-byte halo loads
    (BlockArgs(3, 1, 16, 15, 6, 1), '8 output channels'),
    (BlockArgs(7, 1, 16, 16, 6, 1), 'no MBConv kernel'),
    (BlockArgs(3, 1, 16, 16, 6, 1, se_ratio=0.0), 'squeeze-excite'),
], ids=['cin12', 'co15', 'k7', 'no_se'])
def test_kernels_refuse_shapes_they_cannot_take(args, match):
    with pytest.raises(ValueError, match=match):
        fm.check_kernel_fits(args)


@pytest.mark.cuda
@pytest.mark.parametrize('args,size', CASES, ids=IDS)
def test_cuda_kernels_match_plain_version(args, size):
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU and nvcc')
    x, v, _ = _block(args, size)
    folded = fm.fold_mbconv(state_dict_from_flax(v), args, 'cuda')
    xb = torch.from_numpy(x).to('cuda', torch.bfloat16)
    got = fm.mbconv_fused(xb, folded, args)
    torch.cuda.synchronize()
    want = fm.mbconv_fused_reference(xb, folded, args)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
