"""The least work of an alignment: the per-level diagonal spans from the
penalties alone equal a direct enumeration of the cells a bidirectional
WFA holds, forward over the first half of the score and backward over
the rest; and a PAF CIGAR's score under the penalties."""

import numpy as np
import pytest

from gpubench import leastwork
from gpubench.reference import wfa
from gpubench.synth import MutationConfig, make_test_case

SCORES = ["0,5,8,2", "0,5,8,2,24,1"]


def _pairs(seed, n=3, length=400):
    tc = make_test_case(seed, n + 1, length, MutationConfig(snp_rate=0.03, insertion_rate=0.005,
                                                             deletion_rate=0.005))
    s = [x.seq for x in tc.sequences]
    return [(s[0], s[i]) for i in range(1, n + 1)]


def _enumerated_spans(pair, pen, levels):
    """Per level, the span (highest - lowest + 1) of the diagonals on
    which the WFA holds any valid offset."""
    b = wfa._Batch([pair], pen, "cpu")
    spans = []
    for s in range(levels + 1):
        b.level(s)
        klo, plane = b.history[-1]
        valid = (plane[:, 0, :] >= 0).any(0).nonzero().flatten()
        spans.append(int(valid.max() - valid.min() + 1) if valid.numel() else 0)
    return spans


@pytest.mark.parametrize("scores", SCORES)
@pytest.mark.parametrize("seed", [1, 2])
def test_cells_equal_bidirectional_enumeration(scores, seed):
    pen = wfa.penalties(scores)
    for p, t in _pairs(seed):
        score = wfa.align_batch([(p, t)], pen)[0][0]
        fwd = _enumerated_spans((p, t), pen, (score + 1) // 2)
        rev = _enumerated_spans((p[::-1], t[::-1]), pen, score // 2)
        hi = leastwork.reach_by_level(pen, score)
        assert leastwork.cells(hi, score, len(p), len(t)) == sum(fwd) + sum(rev)
        # every level's span from the penalties, level by level
        expect = [2 * h + 1 if h >= 0 else 0 for h in hi[: len(fwd)]]
        assert expect == fwd


def test_cells_clip_to_the_matrix():
    pen = wfa.penalties("0,5,8,2,24,1")
    hi = leastwork.reach_by_level(pen, 200)
    assert leastwork.cells(hi, 200, 10, 10) < leastwork.cells(hi, 200, 1000, 1000)
    assert leastwork.cells(hi, 0, 5, 5) == 2


@pytest.mark.parametrize("scores", SCORES)
def test_cigar_score_is_the_alignment_score(scores):
    pen = wfa.penalties(scores)
    from gpubench.judge import paf_line

    for p, t in _pairs(3, n=4, length=300):
        score, runs = wfa.align_batch([(p, t)], pen)[0]
        line = paf_line("q", len(p), "t", len(t), False, runs)
        assert leastwork.cigar_score(line.split("\t")[-1][5:], pen) == score
        lw = leastwork.LeastWork(pen)
        lw.add_record(line.split("\t"))
        assert lw.cells == leastwork.cells(leastwork.reach_by_level(pen, score), score, len(p), len(t))
        assert lw.bytes == len(p) + len(t) + len(line.split("\t")[-1]) - 5


def test_least_seconds_takes_the_larger_bound():
    pen = wfa.penalties("0,5,8,2")
    lw = leastwork.LeastWork(pen)
    lw.cells, lw.bytes = 10**9, 10
    pk = {"int32_ops_per_s": 1e12, "bytes_per_s": 1e9}
    assert lw.least_seconds(pk) == pytest.approx(9e-3)
    lw.cells, lw.bytes = 1, 10**9
    assert lw.least_seconds(pk) == pytest.approx(1.0)
    h100 = leastwork.peaks("NVIDIA H100 80GB HBM3")
    assert h100["int32_ops_per_s"] == 132 * 64 * 1980 * 10**6
