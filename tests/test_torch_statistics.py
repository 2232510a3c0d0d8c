"""The port's prediction-statistics miner (utils/statistics.py, no pandas)
against the JAX package's DataFrame, column by column."""
import numpy as np
import pytest

from mm_distillnet_tpu.utils.statistics import \
    collect_prediction_statistics as jax_collect
from mm_distillnet_torch.utils.statistics import (
    COLUMNS, bboxes_to_area, collect_prediction_statistics)


def _frames(seed):
    rng = np.random.default_rng(seed)
    teacher, student = {}, {}
    for i in range(12):
        fid = f'drive_{"day" if i % 3 else "night"}/{i:04d}'
        n_t = int(rng.integers(0, 5))
        xy = rng.uniform(0, 200, (n_t, 2))
        wh = rng.uniform(5, 60, (n_t, 2))
        teacher[fid] = np.concatenate(
            [xy, xy + wh, np.full((n_t, 1), 6.0)], 1)
        if i % 4 == 0:
            continue   # the student missed the frame
        n_s = int(rng.integers(0, 6))
        jitter = rng.normal(0, 4, (n_s, 4))
        pick = rng.integers(0, max(n_t, 1), n_s)
        base = teacher[fid][pick, :4] if n_t else rng.uniform(0, 200,
                                                              (n_s, 4))
        student[fid] = np.concatenate(
            [base + jitter, rng.uniform(0, 1, (n_s, 1)),
             np.full((n_s, 1), 6.0)], 1)
    return student, teacher


@pytest.mark.parametrize('seed', range(3))
def test_statistics_match_the_jax_dataframe(seed):
    student, teacher = _frames(seed)
    want = jax_collect(student, teacher)
    got = collect_prediction_statistics(student, teacher)
    assert list(got) == list(want.columns) == list(COLUMNS)
    for col in COLUMNS:
        assert len(got[col]) == len(want)
        w = want[col].to_numpy()
        if w.dtype == object or w.dtype.kind in 'OUS':
            assert got[col].tolist() == w.tolist(), col
        else:
            np.testing.assert_array_equal(got[col], w, err_msg=col)
            assert got[col].dtype.kind == w.dtype.kind, col


def test_statistics_miner_cases_and_empty():
    teacher = {'drive_day/0001': np.array([[10, 10, 50, 50, 6],
                                           [60, 60, 90, 90, 6]], float),
               'drive_night/0002': np.array([[5, 5, 25, 25, 6]], float),
               'drive_day/0003': np.zeros((0, 5))}
    student = {'drive_day/0001': np.array([[11, 11, 49, 49, 0.9, 6],
                                           [200, 200, 240, 230, 0.4, 6]],
                                          float)}
    got = collect_prediction_statistics(student, teacher)
    assert list(got['id']) == ['drive_day/0001', 'drive_night/0002']
    assert got['missing_bboxes'].tolist() == [1, 1]
    assert got['excess_bboxes'].tolist() == [1, 0]
    assert got['predominating_area_missing'].tolist() == ['small', 'ALL']
    assert got['is_night'].tolist() == [False, True]
    np.testing.assert_array_equal(bboxes_to_area(teacher['drive_day/0001']),
                                  [1600.0, 900.0])
    assert collect_prediction_statistics({}, {}) == {}
    assert len(jax_collect({}, {}).columns) == 0
