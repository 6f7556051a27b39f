"""The first detection's segment number of ``check.compare`` on hand-made
answers: a near-tied candidate picked first passes, a shifted segment or a
candidate outside the tie does not, and float32 rounding of the seconds is
not counted."""

import numpy as np
import pytest

from portbench import check

STEP = 1.0


def reference(heads):
    heads = np.asarray(heads, np.float64)
    return {"segments": heads[:1, 1:], "scores": heads[:1, 0],
            "heads": heads}


def program(segment, score):
    return {"segments": np.asarray([segment], np.float64),
            "scores": np.asarray([score], np.float64)}


HEADS = [[0.80, 100.0, 110.0], [0.79, 200.0, 204.0], [0.50, 300.0, 310.0]]


def gap(prog, tie=0.02):
    return check.compare([(prog, reference(HEADS), STEP)], 1,
                         tie)["top_segment_gap"]


def test_the_best_candidate_read_back_is_no_gap():
    assert gap(program([100.0, 110.0], 0.80)) == 0.0


def test_a_near_tied_candidate_first_is_held_to_its_own_segment():
    assert gap(program([200.0, 204.0], 0.79)) == 0.0
    assert gap(program([200.4, 204.0], 0.79)) == pytest.approx(0.1, abs=1e-4)


def test_a_candidate_outside_the_tie_is_not_a_first_pick():
    assert gap(program([300.0, 310.0], 0.80)) > 1.0
    assert gap(program([200.0, 204.0], 0.79), tie=0.0) > 1.0


def test_a_segment_moved_by_one_step_reads_its_share_of_the_length():
    assert gap(program([101.0, 111.0], 0.80)) == pytest.approx(0.1, abs=1e-4)


def test_float32_rounding_of_the_seconds_is_not_counted():
    t = np.float32(30000.0)
    ulp = float(np.spacing(t))
    heads = [[0.8, float(t), float(t) + 1.0]]
    pairs = [(program([float(t) + check.ROUNDING_ULPS * ulp, float(t) + 1.0],
                      0.8), reference(heads), STEP)]
    assert check.compare(pairs, 1, 0.0)["top_segment_gap"] == 0.0
    pairs = [(program([float(t) + (check.ROUNDING_ULPS + 1) * ulp,
                       float(t) + 1.0], 0.8), reference(heads), STEP)]
    assert check.compare(pairs, 1, 0.0)["top_segment_gap"] > 0.0


def test_an_alternate_reference_answer_holds_the_nearer():
    ref = reference(HEADS)
    ref["alternates"] = [reference([[0.70, 150.0, 160.0]])]
    prog = program([150.0, 160.0], 0.70)
    numbers = check.compare([(prog, ref, STEP)], 1, 0.02)
    assert numbers["top_score_gap"] == 0.0
    assert numbers["top_segment_gap"] == 0.0
    numbers = check.compare([(program([150.0, 160.0], 0.80), ref, STEP)], 1,
                            0.02)
    assert numbers["top_segment_gap"] > 1.0
