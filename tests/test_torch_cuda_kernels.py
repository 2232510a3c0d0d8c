"""The hand-written CUDA kernels against their plain PyTorch versions, on a
card. Every test here is marked `cuda` and skips without an NVIDIA GPU.

This file imports torch and the port only (no jax, nothing of the
reference package), so it collects wherever the port runs:

    python -m pytest tests/test_torch_cuda_kernels.py -q --noconftest

(`--noconftest` leaves out tests/conftest.py, which sets JAX up for the
other test files.)
"""
import pytest
import torch

from mm_distillnet_torch.models.efficientnet import (BlockArgs, MBConvBlock,
                                                     expand_block_args)
from mm_distillnet_torch.ops import fused_mbconv as fm

pytestmark = pytest.mark.cuda

CASES = [
    (BlockArgs(3, 1, 16, 16, 6, 1), (16, 16)),   # expand + skip
    (BlockArgs(5, 1, 16, 24, 6, 1), (16, 16)),   # expand, no skip
    (BlockArgs(3, 1, 32, 16, 1, 1), (16, 16)),   # no expand (ratio 1)
    (BlockArgs(3, 1, 16, 24, 6, 2), (16, 16)),   # stride 2
    (BlockArgs(5, 1, 16, 24, 6, 2), (16, 16)),   # stride 2, k5
    (BlockArgs(5, 1, 16, 16, 6, 1), (15, 13)),   # odd size, stride 1
    (BlockArgs(3, 1, 24, 24, 6, 1), (21, 37)),   # ragged tiles
    (BlockArgs(5, 1, 40, 40, 6, 1), (33, 19)),   # ragged, k5
    (BlockArgs(3, 1, 32, 16, 1, 1), (23, 41)),   # ragged, no expand
]
IDS = ['expand_skip', 'expand', 'no_expand', 's2', 's2_k5', 'odd_s1',
       'ragged_21x37', 'ragged_k5_33x19', 'ragged_no_expand']


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU and nvcc')
    return torch.device('cuda', 0)


def _seeded_block(args, seed, device):
    """MBConvBlock from `seed` with non-trivial BN statistics, eval mode."""
    torch.manual_seed(seed)
    block = MBConvBlock(args)
    g = torch.Generator().manual_seed(seed)
    for m in block.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            n = m.num_features
            m.running_mean.copy_(torch.randn(n, generator=g) * 0.1)
            m.running_var.copy_(torch.rand(n, generator=g) + 0.5)
            m.weight.data.copy_(torch.rand(n, generator=g) * 0.4 + 0.8)
            m.bias.data.copy_(torch.randn(n, generator=g) * 0.1)
    return block.to(device).eval()


def _block_against_plain(args, size, batch, device, seed=0):
    block = _seeded_block(args, seed, device)
    f = fm.fold_mbconv(block.state_dict(), args, device)
    g = torch.Generator(device=device).manual_seed(seed + 1)
    x = torch.randn((batch, *size, args.input_filters), generator=g,
                    device=device).to(torch.bfloat16)
    fm.reset_launches()
    got = fm.mbconv_fused(x, f, args)
    torch.cuda.synchronize()
    assert all(n == 1 for n in fm.launches.values())
    want = fm.mbconv_fused_reference(x, f, args)
    # bf16 outputs of the same arithmetic: one bf16 ulp at the values'
    # size (a few units) is 2^-6..2^-7
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize('args,size', CASES, ids=IDS)
def test_cuda_kernels_match_plain_version(args, size, device):
    _block_against_plain(args, size, 2, device)


@pytest.mark.parametrize('batch', [1, 2, 40])
def test_cuda_kernels_at_other_batches(batch, device):
    _block_against_plain(BlockArgs(5, 1, 48, 48, 6, 1), (24, 24), batch,
                         device)
    _block_against_plain(BlockArgs(3, 1, 48, 88, 6, 2), (24, 24), batch,
                         device)


def _se_case(t, cep, cs, batch, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)

    def rand(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=device) * scale
    sums = rand(batch, t, cep, scale=8.0)
    f = fm.FoldedMBConv(None, None, None, None, rand(cs, cep, scale=0.2),
                        rand(cs, scale=0.2), rand(cs, cep, scale=0.2),
                        rand(cep, scale=0.2), None, None)
    return sums, f._replace(se_pack=fm.pack_se(f.w_se1, f.w_se2))


# (tiles, CeP, Cs): D2@768 blocks 0, 2, 8, 12, 17 and 22, a test-tiny block
# and one whose channels do not fill the last CTA's slice
SE_SHAPES = [(1152, 32, 8), (576, 96, 4), (36, 288, 12), (18, 528, 22),
             (9, 1248, 52), (9, 2112, 88), (1, 48, 2), (5, 80, 3)]


@pytest.mark.parametrize('t,cep,cs', SE_SHAPES)
@pytest.mark.parametrize('batch', [1, 8])
def test_se_kernel_matches_plain_version_at_its_plan(t, cep, cs, batch,
                                                     device):
    """Kernel (b) at the plan `se_plan` chooses: the fp32 gate within 1e-4
    of the plain version (another order of fp32 sums), two launches
    bit-equal."""
    sums, f = _se_case(t, cep, cs, batch, device, seed=t + cep)
    hw = 16 * t
    got = fm.se_gate(sums, f, hw)
    again = fm.se_gate(sums, f, hw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, fm.se_gate_reference(sums, f, hw),
                               rtol=1e-4, atol=1e-4)
    assert torch.equal(got, again)


@pytest.mark.parametrize('t,cep,cs', SE_SHAPES)
def test_se_kernel_at_every_plan(t, cep, cs, device):
    """Every cluster size, both splits and three CTA sizes that
    `make_se_plan` accepts give the plain version's gate."""
    sums, f = _se_case(t, cep, cs, 4, device, seed=cs)
    hw = 16 * t
    want = fm.se_gate_reference(sums, f, hw)
    tried = 0
    for ranks in (1, 2, 4, 8):
        for split_tiles in (True, False):
            for threads in (64, 256, 1024):
                try:
                    plan = fm.make_se_plan(t, cep, cs, ranks, split_tiles,
                                           threads)
                except ValueError:
                    continue
                got = fm.se_gate(sums, f, hw, plan)
                torch.cuda.synchronize()
                torch.testing.assert_close(
                    got, want, rtol=1e-4, atol=1e-4,
                    msg=lambda m, plan=plan: f'{plan}: {m}')
                tried += 1
    assert tried >= 2   # the widest block fits two plans only


def test_se_kernel_under_graph_capture(device):
    """Clusters and the programmatic dependent launch inside a CUDA graph:
    (a), (b), (c) captured and replayed give the eager result."""
    args = expand_block_args(2)[17]
    block = _seeded_block(args, 3, device)
    f = fm.fold_mbconv(block.state_dict(), args, device)
    x = torch.randn((8, 24, 24, args.input_filters),
                    device=device).to(torch.bfloat16)
    eager = fm.mbconv_fused(x, f, args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = fm.mbconv_fused(x, f, args)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)


def test_wrappers_raise_on_what_the_kernels_do_not_take(device):
    sums, f = _se_case(9, 528, 22, 2, device, seed=1)
    with pytest.raises(ValueError, match='float32'):
        fm.se_gate(sums.double(), f, 144)
    with pytest.raises(ValueError, match='contiguous'):
        fm.se_gate(sums.transpose(0, 1).contiguous().transpose(0, 1), f, 144)
    with pytest.raises(ValueError, match='se_pack'):
        fm.se_gate(sums, f._replace(se_pack=f.se_pack[:-4]), 144)


def test_train_step_runs_the_teachers_on_the_kernels(device):
    """One distillation step at D2, 256 px, batch 2, fused_inference: 69
    launches of each kernel (three teachers x 23 blocks), finite losses,
    teacher outputs that need no grad, and two runs of the step from the
    same generator seeds give bit-equal losses."""
    import copy

    from mm_distillnet_torch.config import default_config
    from mm_distillnet_torch.distill import train_step as ts
    from mm_distillnet_torch.distill.pseudo_labels import PseudoLabelConfig
    from mm_distillnet_torch.models.efficientdet import EfficientDet
    from mm_distillnet_torch.ops.anchors import anchor_table
    from mm_distillnet_torch.ops.postprocess import class_validity_table

    size = 256
    channels = {'rgb': 3, 'thermal': 1, 'depth': 3}
    torch.manual_seed(0)
    teachers = {m: EfficientDet(20, 2, c).eval() for m, c in channels.items()}
    student = EfficientDet(20, 2, 8)
    g = torch.Generator(device=device).manual_seed(1)
    batch = {m: torch.randn((2, size, size, c), generator=g, device=device)
             .to(torch.bfloat16) for m, c in {**channels, 'audio': 8}.items()}
    cfg = ts.DistillConfig(pl=PseudoLabelConfig(image_size=size))
    tables = (torch.as_tensor(anchor_table(size), device=device),
              torch.as_tensor(class_validity_table(20, list(range(20))),
                              device=device),
              torch.arange(20, device=device))
    frozen = ts.make_teachers(teachers, image_size=size, fused=True,
                              device=device)
    out = frozen['rgb'].forward(batch['rgb'])
    assert not any(t.requires_grad for t in
                   (out.classification, out.regression, *out.features))
    losses = []
    for _ in range(2):
        state = ts.init_train_state(copy.deepcopy(student), default_config(),
                                    device=device)
        step = ts.make_train_step(frozen, cfg, *tables, seed=5,
                                  device=device)
        fm.reset_launches()
        metrics = step(state, batch)
        torch.cuda.synchronize()
        assert dict(fm.launches) == {n: 69 for n in fm.launches}
        losses.append(torch.stack([metrics[k] for k in ts.METRICS]))
    assert torch.isfinite(losses[0]).all()
    assert torch.equal(losses[0], losses[1])


@pytest.mark.parametrize('mode,backbones', [('concat', 3), ('switch', 1)])
def test_generator_teacher_backbones_run_the_kernels(mode, backbones,
                                                     device):
    """A generator teacher (audio, rgb, thermal) under fused_inference at
    D2, 256 px, batch 2: each backbone its eval forward runs folds into
    the kernels (23 launches of each kernel per backbone), and the outputs
    agree with the same predictor on the kernels' plain versions
    (correlation > 0.999, the serving path's gate in chip_smoke.py)."""
    from mm_distillnet_torch.models import fused_forward
    from mm_distillnet_torch.models.efficientdet_generator import \
        EfficientDetGenerator

    size = 256
    channels = {'audio': 8, 'rgb': 3, 'thermal': 1}
    torch.manual_seed(0)
    gen = EfficientDetGenerator(tuple(channels), 20, 2, mode,
                                in_channels=channels).eval()
    g = torch.Generator(device=device).manual_seed(1)
    x = {m: torch.randn((2, size, size, c), generator=g, device=device)
         for m, c in channels.items()}
    forward = fused_forward.make_fused_predictor(gen, gen.state_dict(), size,
                                                 device=device)
    fm.reset_launches()
    got = forward(x)
    torch.cuda.synchronize()
    assert dict(fm.launches) == {n: 23 * backbones for n in fm.launches}
    saved = fused_forward.mbconv_fused
    fused_forward.mbconv_fused = fm.mbconv_fused_reference
    try:
        want = forward(x)
    finally:
        fused_forward.mbconv_fused = saved
    for f in ('classification', 'regression', 'logits'):
        a = getattr(got, f).double().flatten()
        b = getattr(want, f).double().flatten()
        assert torch.isfinite(a).all()
        assert float(torch.corrcoef(torch.stack([a, b]))[0, 1]) > 0.999, f


@pytest.mark.parametrize('args,size', [CASES[0], CASES[3]],
                         ids=['expand_skip', 's2'])
def test_kernels_launch_on_every_card(args, size, device):
    """Each kernel launches on the card its tensors lie on, whatever the
    current device: every visible card, with the current device set to
    another one where there is one (the launchers keep their shared-memory
    limits per device). A one-card machine checks device 0 only."""
    n = torch.cuda.device_count()
    for i in range(n):
        card = torch.device('cuda', i)
        with torch.cuda.device((i + 1) % n):
            _block_against_plain(args, size, 2, card, seed=i)


def test_sharded_serving_runs_the_kernels_on_every_replica(device):
    """make_serving_fn over a mesh of every card, twice over (cuda:0,
    cuda:0 on one card), on an odd batch at D2, 256 px: 23 launches of
    each kernel per replica, and the Detections of the unsharded call
    (boxes within 1e-3 px, scores within 1e-3: each image meets the same
    kernels; cuDNN may take another algorithm at another batch)."""
    from mm_distillnet_torch.models.efficientdet import EfficientDet
    from mm_distillnet_torch.parallel.mesh import create_mesh
    from mm_distillnet_torch.serving import make_serving_fn

    size = 256
    torch.manual_seed(0)
    model = EfficientDet(20, 2, 8).eval()
    sd = model.state_dict()
    mesh = create_mesh() * 2
    g = torch.Generator(device=device).manual_seed(1)
    x = torch.randn((2 * len(mesh) - 1, size, size, 8), generator=g,
                    device=device)
    want = make_serving_fn(model, sd, size, device=device)(x)
    sharded = make_serving_fn(model, sd, size, mesh=mesh)
    fm.reset_launches()
    got = sharded(x)
    torch.cuda.synchronize()
    assert dict(fm.launches) == {k: 23 * len(mesh) for k in fm.launches}
    assert got.valid.device == mesh[0] and got.valid.shape[0] == x.shape[0]
    torch.testing.assert_close(got.valid, want.valid)
    torch.testing.assert_close(got.classes, want.classes)
    torch.testing.assert_close(got.boxes, want.boxes, rtol=0, atol=1e-3)
    torch.testing.assert_close(got.scores, want.scores, rtol=0, atol=1e-3)
