"""The plain reference against the program's own implementations on
small inputs: the same pairs, strands, scores, CIGARs and PAF lines. The
program's are read here only to cross-check; the reference imports none
of them."""

import os

import numpy as np
import pytest

os.environ.setdefault("ALLWAVE_PLATFORM", "cpu")

from gpubench import jobs, judge  # noqa: E402
from gpubench.reference import orient, pairs, wfa  # noqa: E402
from gpubench.synth import MutationConfig, make_test_case  # noqa: E402

PARAMS = {"n_sequences": 24, "length": 700, "snp_rate": 0.02, "insertion_rate": 0.002,
          "deletion_rate": 0.002, "max_indel": 10, "reverse_fraction": 0.5, "id_prefix": "gene"}


@pytest.mark.parametrize("spec_", ["none", "giant:0.99", "random:0.3", "auto"])
@pytest.mark.parametrize("n", [4, 37, 100])
def test_pairs_equal_the_programs(spec_, n):
    from allwave_tpu_torch.core.types import Sequence
    from allwave_tpu_torch.sparsify.pairs import build_pairs, parse_sparsification

    ids = [f"gene{i}" for i in range(n)]
    got = pairs.select_pairs(ids, spec_)
    want = build_pairs([Sequence(i, b"ACGT") for i in ids], parse_sparsification(spec_))
    assert np.array_equal(got, want)


def test_strands_equal_the_programs():
    from allwave_tpu_torch.core.types import Sequence
    from allwave_tpu_torch.orient.orientation import OrientationIndex

    seqs = jobs.make_job(PARAMS, 21, 0)
    pr = pairs.select_pairs([s.id for s in seqs], "none")
    got = orient.strands([s.seq for s in seqs], pr)
    idx = OrientationIndex([Sequence(s.id, s.seq) for s in seqs], device="cpu")
    assert np.array_equal(got, idx.orient_batch(pr))
    assert 0 < got.sum() < got.size


@pytest.mark.parametrize("scores", ["0,5,8,2", "0,5,8,2,24,1", "0,1,1,1", "0,4,6,2,26,1"])
def test_alignments_equal_the_scalar_oracle(scores):
    from allwave_tpu_torch.core.cigar import run_length_encode
    from allwave_tpu_torch.core.scores import parse_scores
    from allwave_tpu_torch.wfa.params import resolve_penalties
    from allwave_tpu_torch.wfa.reference_impl import wfa_align

    rng = np.random.RandomState(len(scores))
    cfg = MutationConfig(snp_rate=0.05, insertion_rate=0.02, deletion_rate=0.02, max_indel=12,
                         n_microsatellites=1)
    pen = wfa.penalties(scores)
    for _ in range(3):
        tc = make_test_case(int(rng.randint(1 << 30)), 4, int(rng.randint(5, 250)), cfg)
        s = [x.seq for x in tc.sequences]
        prs = [(s[i], s[j]) for i in range(4) for j in range(4) if i != j]
        for (p, t), (score, runs) in zip(prs, wfa.align_batch(prs, pen)):
            s2, cig = wfa_align(p, t, resolve_penalties(parse_scores(scores)))
            ops, cnt = run_length_encode(cig)
            assert (score, runs) == (s2, list(zip(ops.tolist(), cnt.tolist())))


def test_paf_line_equals_the_programs():
    from allwave_tpu_torch.core.paf import alignment_to_paf
    from allwave_tpu_torch.core.types import AlignmentResult, Sequence

    seqs = jobs.make_job({**PARAMS, "n_sequences": 3}, 2, 0)
    pen = wfa.penalties("0,5,8,2,24,1")
    q, t = seqs[0], seqs[1]
    rq = orient.reverse_complement(q.seq)
    score, runs = wfa.align_batch([(rq, t.seq)], pen)[0]
    ops = np.array([o for o, _ in runs], np.uint8)
    lens = np.array([n for _, n in runs], np.int64)
    cig = np.repeat(ops, lens)
    n = {c: int((cig == c).sum()) for c in (wfa.OP_M, wfa.OP_X, wfa.OP_I, wfa.OP_D)}
    res = AlignmentResult(query_idx=0, target_idx=1, query_start=0,
                          query_end=n[wfa.OP_M] + n[wfa.OP_X] + n[wfa.OP_D], target_start=0,
                          target_end=n[wfa.OP_M] + n[wfa.OP_X] + n[wfa.OP_I], is_reverse=True,
                          cigar_bytes=cig, score=score, num_matches=n[wfa.OP_M],
                          alignment_length=n[wfa.OP_M] + n[wfa.OP_X])
    want = alignment_to_paf(res, [Sequence(s.id, s.seq) for s in seqs])
    assert judge.paf_line(q.id, len(q.seq), t.id, len(t.seq), True, runs) == want


@pytest.mark.parametrize("cigar,query,target,ok", [
    ("2=1X1I1D", b"ACGT", b"ACTC", True),
    ("2=1X1I1D", b"ACGT", b"ACGC", False),  # X on equal bases
    ("3=", b"ACGT", b"ACG", False),         # the query is not walked to its end
    ("4=", b"ACGT", b"ACGA", False),        # = on different bases
    ("2=0X2=", b"ACGT", b"ACGT", False),    # a run of no length
    ("2=2Q", b"ACGT", b"ACGT", False),      # an op that is none of =XID
    ("1D4=", b"ACGT", b"TACGT", True),
])
def test_replays(cigar, query, target, ok):
    assert judge.replays(cigar, query, target) is ok


def test_every_record_is_held_to_its_bases_and_fields():
    """A record whose CIGAR does not walk its sequences, or whose other
    fields are not the ones its CIGAR gives, is invalid, whether or not
    its pair is in the sample."""
    seqs = jobs.make_job({**PARAMS, "n_sequences": 3}, 5, 0)
    params = {"scores": "0,5,8,2", "sparsification": "none"}
    jc = judge.JobCheck(seqs, params, 0, np.random.RandomState(0), [])
    recs = []
    for row, (q, t) in enumerate(jc.pairs.tolist()):
        score, runs = wfa.align_batch([jc.oriented(row)], jc.pen)[0]
        recs.append(judge.paf_line(seqs[q].id, len(seqs[q].seq), seqs[t].id, len(seqs[t].seq),
                                   bool(jc.strands[row]), runs).split("\t"))
    assert jc.sample == []
    assert jc.with_records(recs).counts({})["records_invalid"] == 0
    bad = [list(r) for r in recs]
    bad[1][9] = str(int(bad[1][9]) + 1)                   # the matches field
    bad[3][-1] = bad[3][-1].replace("X", "=", 1)          # a mismatch written as a match
    bad[4][4] = "+" if bad[4][4] == "-" else "-"          # the other strand's bases
    assert jc.with_records(bad).counts({})["records_invalid"] == 3


def test_control_band_breaks_the_exact_score():
    """The control (the reference confined to 8 diagonals beyond each
    pair's hull, no escalation) scores no pair better than the exact
    reference and some worse: it fails the score comparison."""
    from gpubench import harness

    pen = wfa.penalties("0,5,8,2")
    tc = make_test_case(5, 9, 600, MutationConfig(snp_rate=0.01, insertion_rate=0.01,
                                                    deletion_rate=0.01))
    s = [x.seq for x in tc.sequences]
    prs = [(s[0], x) for x in s[1:]]
    a = wfa.align_batch(prs, pen)
    b = wfa.align_batch(prs, pen, band=harness.CONTROL_BAND)
    assert all(x[0] <= y[0] for x, y in zip(a, b))
    assert sum(x[0] < y[0] for x, y in zip(a, b)) >= 1
