"""The comparison on hand-made answers: every kept answer is judged, a
wrong answer after a right one for the same slot included."""
import numpy as np
import pytest

from portbench import judge

STEP = np.array([0.5, 2.0])
REF = {0: np.array([[1.0, 2.0], [3.0, 4.0]]), 1: np.array([[0.0, 1.0]])}


def _reference(slot):
    return REF[slot]


def test_sound_answers_read_their_rounding():
    a = judge.Answers()
    a.add(0, REF[0].astype(np.float32))
    a.add(1, (REF[1] + [1e-6, 0]).astype(np.float32))
    assert a.count == 2
    assert judge.widest_gap(a, _reference, STEP) < 1e-5


def test_a_later_wrong_answer_is_judged():
    a = judge.Answers()
    a.add(0, REF[0].astype(np.float32))
    bad = REF[0].astype(np.float32)
    bad[1, 1] += 1.0
    a.add(0, REF[0].astype(np.float32))
    a.add(0, bad)
    assert len(a.kept[0]) == 2
    assert judge.widest_gap(a, _reference, STEP) == pytest.approx(0.5)


def test_answers_past_the_cap_are_bounded_by_their_drift():
    a = judge.Answers()
    for i in range(judge.CAP + 3):
        a.add(1, (REF[1] + [0.1 * i, 0]).astype(np.float32))
    assert len(a.kept[1]) == judge.CAP
    want = 0.1 * (judge.CAP + 2) / 0.5
    assert judge.widest_gap(a, _reference, STEP) == pytest.approx(want,
                                                                  rel=1e-5)


def test_missing_rows_and_nan_read_infinite():
    assert judge.gap(np.zeros((1, 2)), REF[0], STEP) == float("inf")
    nan = REF[0].copy()
    nan[0, 0] = np.nan
    assert judge.gap(nan, REF[0], STEP) == float("inf")
