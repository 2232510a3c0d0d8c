"""The plain reference against the program at the TEST-TINY size on the
CPU: the same weights and frames give the same detector outputs, and the
program's step in fp32 follows the reference's."""
import pytest
import torch

from benchmark.kinds import serve, train
from benchmark.reference import run as reference
from benchmark.reference.resize import maybe_stretch_mel_axis
from benchmark.tests.tiny import CPU, served, tiny_cell


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_reference_forward_equals_the_programs_modules():
    from mm_distillnet_torch.models.efficientdet import EfficientDet
    c = tiny_cell('serve-d2-b32')
    cell = serve.Cell(c, 2 ** 40 + 3, CPU)
    cfg = c['config']
    frames = maybe_stretch_mel_axis(cell.judge_frames[0], 128)
    program = EfficientDet(cfg['num_classes'], -1, 8)
    program.load_state_dict(cell.state)
    program.eval()
    ref = reference.detector(cfg, 8, cell.state, CPU).eval()
    with torch.no_grad():
        a, b = program(frames), ref(frames)
    torch.testing.assert_close(a.classification, b.classification)
    torch.testing.assert_close(a.regression, b.regression)


def test_served_detections_agree_with_the_reference():
    spec = tiny_cell('serve-d2-b32')
    cell = served(serve.Cell(spec, 11, CPU))
    values = cell.check()
    assert values['det_gap_beyond_bf16'] < spec['cell']['limits'][
        'det_gap_beyond_bf16']


def test_the_programs_step_in_fp32_follows_the_reference(monkeypatch):
    from mm_distillnet_torch.distill import train_step as ts
    make_step, make_teachers = ts.make_train_step, ts.make_teachers
    monkeypatch.setattr(ts, 'make_train_step', lambda *a, **k: make_step(
        *a, **{**k, 'compute_dtype': torch.float32}))
    monkeypatch.setattr(ts, 'make_teachers', lambda *a, **k: make_teachers(
        *a, **{**k, 'dtype': torch.float32, 'fused': False}))
    explain = {}
    values = train.Cell(tiny_cell('train-d2-b8'), 12345678901, CPU).check(
        explain)
    # the step stretches the bf16 audio into bf16, the reference into fp32
    assert values['loss_gap'] < 1e-4
    assert explain['grad_gap_median'] < 0.01
    assert values['update_gap_median'] < 0.01
    assert values['label_score_gap'] == 0.0
    assert values['fusion_rows_differing'] == 0.0


def test_fp8_rounding_rounds_and_passes_the_gradient():
    x = torch.linspace(-3, 3, 101, requires_grad=True)
    y = reference._fp8(x)
    scale = 3.0 / reference.FP8_MAX
    want = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    torch.testing.assert_close(y.detach(), want)
    assert (y.detach() != x.detach()).any()
    y.sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x))
    conv = torch.nn.functional.conv2d
    with reference.fp8_rounding():
        assert torch.nn.functional.conv2d is not conv
    assert torch.nn.functional.conv2d is conv
