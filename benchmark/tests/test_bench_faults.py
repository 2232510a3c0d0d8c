"""The check catches what it is there to catch. At the TEST-TINY size on
the CPU, each cell's run is driven past its look for a chip with the
timed path broken underneath (faults.py), and the numbers that the fault
should move read far above a sound run's and above the cell's limits, so
`correct` comes out false; the control (the program's int8 path for
serving, the reference in fp8 in the train step's place) reads above a
sound run too. The readings at the cells' own size, on the card, that set
the limits come from control.py (PERF.md)."""
import pytest
import torch

from benchmark import check, faults
from benchmark.kinds import serve, train
from benchmark.tests.tiny import CPU, served, tiny_cell

SEED = 2 ** 33 + 17


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def serve_limit():
    return tiny_cell('serve-d2-b32')['cell']['limits']['det_gap_beyond_bf16']


def judged(name, values):
    return check.judge(values, tiny_cell(name)['cell']['limits'])


@pytest.fixture(scope='module')
def fp32_predictor():
    """The predictor in fp32 (the unfused blocks): at this size bf16's
    rounding moves the scores as much as the faults tested here."""
    from mm_distillnet_torch import serving
    make = serving.make_serving_fn
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(serving, 'make_serving_fn', lambda *a, **k: make(
            *a, **{**k, 'dtype': torch.float32, 'plan_spec': 'flax:0-22'}))
        yield


@pytest.fixture(scope='module')
def sound_serve(fp32_predictor):
    torch.set_num_threads(2)
    return served(serve.Cell(tiny_cell('serve-d2-b32'), SEED, CPU)).check()


@pytest.mark.parametrize('fault', ['half_batch', 'altered', 'stale',
                                   'one_slot'])
def test_a_broken_predictor_is_not_correct(sound_serve, fault):
    cell = served(serve.Cell(tiny_cell('serve-d2-b32'), SEED, CPU,
                             fault=faults.SERVE[fault]))
    values = cell.check()
    # the number is a gap beyond a yardstick: a sound run reads about 0
    # or below, so the fault has to move it by more than the limit
    assert values['det_gap_beyond_bf16'] > \
        sound_serve['det_gap_beyond_bf16'] + serve_limit()
    correct, _ = judged('serve-d2-b32', values)
    assert not correct


def test_the_int8_control_reads_above_a_sound_run(sound_serve):
    values = served(serve.Cell(tiny_cell('serve-d2-b32'), SEED, CPU,
                               variant='int8')).check()
    assert values['det_gap_beyond_bf16'] > \
        sound_serve['det_gap_beyond_bf16'] + serve_limit()


@pytest.fixture(scope='module')
def fp32_step():
    """The step in fp32: at this size bf16's rounding moves a leaf's
    gradient by up to half its norm, which would hide what is tested
    here."""
    from mm_distillnet_torch.distill import train_step as ts
    make_step, make_teachers = ts.make_train_step, ts.make_teachers
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ts, 'make_train_step', lambda *a, **k: make_step(
            *a, **{**k, 'compute_dtype': torch.float32}))
        mp.setattr(ts, 'make_teachers', lambda *a, **k: make_teachers(
            *a, **{**k, 'dtype': torch.float32}))
        yield


@pytest.fixture(scope='module')
def sound_train(fp32_step):
    torch.set_num_threads(2)
    return train.Cell(tiny_cell('train-d2-b8'), SEED, CPU).check()


@pytest.mark.parametrize('fault,number', [('unchanged', 'update_gap_median'),
                                          ('half_batch', 'loss_gap'),
                                          ('altered',
                                           'fusion_rows_differing')])
def test_a_broken_step_is_not_correct(sound_train, monkeypatch, fault,
                                      number):
    from mm_distillnet_torch.distill import train_step as ts
    monkeypatch.setattr(ts, 'fuse_teacher_labels', ts.fuse_teacher_labels)
    values = train.Cell(tiny_cell('train-d2-b8'), SEED, CPU,
                        fault=faults.TRAIN[fault]).check()
    assert values[number] > 5 * sound_train[number] or \
        values[number] > 0 == sound_train[number]
    correct, _ = judged('train-d2-b8', values)
    assert not correct


def test_the_fp8_control_reads_above_a_sound_run(sound_train):
    values = train.Cell(tiny_cell('train-d2-b8'), SEED, CPU,
                        variant='fp8').check()
    assert values['label_score_gap'] > 3 * sound_train['label_score_gap']
    assert values['label_score_gap'] > 0
