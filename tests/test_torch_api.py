"""The library facade, the validators and the WFA2 conformance goldens
on the port: tests/test_api_parity.py, tests/test_validation.py and
tests/test_conformance_wfa2.py with every name taken from
allwave_tpu_torch (`wfa/simple.py` and `validation.py` are byte copies
of the reference's), the same cases and the same `slow` marks."""

import numpy as np
import pytest

import allwave_tpu_torch as aw
from allwave_tpu_torch.core.cigar import (
    cigar_bytes_to_string,
    parse_cigar_lengths,
    validate_cigar,
)
from allwave_tpu_torch.core.paf import alignment_to_paf
from allwave_tpu_torch.core.scores import parse_scores
from allwave_tpu_torch.core.types import (
    OP_D,
    OP_I,
    OP_M,
    OP_X,
    AlignmentMode,
    AlignmentParams,
    Sequence,
)
from allwave_tpu_torch.validation import (
    AlignmentStats,
    PafRecord,
    calculate_alignment_stats,
    detect_large_indels,
    parse_cigar,
    validate_alignment,
    validate_paf_record,
    verify_cigar_alignment,
)
from allwave_tpu_torch.wfa.simple import (
    SimplePenalties,
    align_pair,
    align_sequences,
)


# -- tests/test_api_parity.py ------------------------------------------------


def test_facade_exports():
    for name in (
        "Sequence",
        "AlignmentParams",
        "AlignmentResult",
        "AlignmentError",
        "AlignmentMode",
        "alignment_to_paf",
        "cigar_bytes_to_string",
        "parse_scores",
        "reverse_complement",
        "process_alignments_with_callback",
        "AllPairIterator",
        "align_pair",
        "KmerSketch",
    ):
        assert hasattr(aw, name), name


def test_align_pair_forward():
    q = Sequence("q", b"ACGTACGTACGTACGTACGT")
    t = Sequence("t", b"ACGTACGTTCGTACGTACGT")
    res = align_pair(q, t, 0, 1, AlignmentParams.default())
    assert res.query_idx == 0 and res.target_idx == 1
    assert not res.is_reverse
    assert res.num_matches == 19
    assert res.alignment_length == 20
    assert res.query_end == 20 and res.target_end == 20


def test_align_pair_reverse_orientation():
    from allwave_tpu_torch.orient.orientation import reverse_complement

    rng = np.random.RandomState(0)
    t = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=400).tobytes()
    q = reverse_complement(t)
    res = align_pair(Sequence("q", q), Sequence("t", t), 0, 1, AlignmentParams.default())
    assert res.is_reverse
    assert res.num_matches == 400


def test_align_pair_wfa_orientation():
    from allwave_tpu_torch.orient.orientation import reverse_complement

    rng = np.random.RandomState(1)
    t = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=200).tobytes()
    q = reverse_complement(t)
    res = align_pair(
        Sequence("q", q),
        Sequence("t", t),
        0,
        1,
        AlignmentParams.default(),
        use_mash_orientation=False,
    )
    assert res.is_reverse


def test_align_sequences_legacy():
    pen = SimplePenalties(mismatch=5, gap_opening1=8, gap_extension1=2)
    res = align_sequences(
        b"ACGTACGTAC", b"ACGTTCGTAC", pen, AlignmentMode.SINGLE_PIECE_AFFINE
    )
    assert res.score == 5
    assert res.cigar == "4=1X5="
    assert res.matches == 9
    assert res.mismatches == 1
    assert res.alignment_length == 10


def test_align_sequences_standard_ins_del():
    pen = SimplePenalties(mismatch=5, gap_opening1=8, gap_extension1=2)
    # pattern longer => standard 'insertions' (consume query)
    res = align_sequences(
        b"ACGTAAACGT", b"ACGTCGT", pen, AlignmentMode.SINGLE_PIECE_AFFINE
    )
    assert res.insertions == 3
    assert res.deletions == 0


def test_all_pair_iterator_alias():
    seqs = [Sequence("a", b"ACGTACGTACGTACGT"), Sequence("b", b"ACGTACGTACGTACGT")]
    from allwave_tpu_torch.core.types import NoSparsification

    it = aw.AllPairIterator.with_options(
        seqs, AlignmentParams.edit_distance(), True, True, NoSparsification()
    )
    assert it.pair_count() == 2
    results = list(it)
    assert len(results) == 2
    for r in results:
        assert r.num_matches == 16
    # with_orientation_params chains
    it2 = aw.AllPairIterator.with_options(
        seqs, AlignmentParams.edit_distance(), True, True, NoSparsification()
    ).with_orientation_params(AlignmentParams.edit_distance())
    assert it2.pair_count() == 2


# -- tests/test_validation.py ------------------------------------------------


def test_parse_cigar():
    assert parse_cigar("4=") == [(4, "=")]
    assert parse_cigar("2=1X1=") == [(2, "="), (1, "X"), (1, "=")]
    assert parse_cigar("") == []
    with pytest.raises(ValueError):
        parse_cigar("4")
    with pytest.raises(ValueError):
        parse_cigar("=4")
    with pytest.raises(ValueError):
        parse_cigar("4=x")


def test_stats():
    s = calculate_alignment_stats("10=2X3I4D1I")
    assert s.matches == 10
    assert s.mismatches == 2
    assert s.insertions == 4
    assert s.deletions == 4
    assert s.gap_opens == 3  # I run, D run, I run
    assert abs(s.identity - 10 / 12) < 1e-12


def test_verify_micro_cases():
    # reference: validation_correct.rs:135-176
    verify_cigar_alignment("4=", b"ACGT", b"ACGT")
    verify_cigar_alignment("2=1X1=", b"ACGT", b"ACTT")
    verify_cigar_alignment("2=2D2=", b"ACGT", b"ACTTGT")  # D consumes target
    verify_cigar_alignment("2=2I2=", b"ACTTGT", b"ACGT")  # I consumes query
    with pytest.raises(ValueError):
        verify_cigar_alignment("4=", b"ACGT", b"ACTT")  # '=' over mismatch
    with pytest.raises(ValueError):
        verify_cigar_alignment("3=", b"ACGT", b"ACGT")  # under-consumption


def _mk_record(**kw):
    base = dict(
        query_name="q",
        query_len=4,
        query_start=0,
        query_end=4,
        strand="+",
        target_name="t",
        target_len=4,
        target_start=0,
        target_end=4,
        num_matches=4,
        block_len=4,
        mapq=60,
        identity=1.0,
        cigar="4=",
    )
    base.update(kw)
    return PafRecord(**base)


def test_validate_paf_record_ok():
    seqs = {"q": Sequence("q", b"ACGT"), "t": Sequence("t", b"ACGT")}
    validate_paf_record(_mk_record(), seqs)


def test_validate_paf_record_reverse():
    # '-' strand: coords refer to the RC'd query
    seqs = {"q": Sequence("q", b"ACGT"), "t": Sequence("t", b"ACGT")}
    validate_paf_record(_mk_record(strand="-"), seqs)  # rc(ACGT)=ACGT


def test_validate_paf_record_bad_matches():
    seqs = {"q": Sequence("q", b"ACGT"), "t": Sequence("t", b"ACGT")}
    with pytest.raises(ValueError, match="num_matches"):
        validate_paf_record(_mk_record(num_matches=3), seqs)


def test_validate_paf_record_parse_roundtrip():
    line = "q\t4\t0\t4\t+\tt\t4\t0\t4\t4\t4\t60\tgi:f:1.000000\tcg:Z:4="
    rec = PafRecord.parse(line)
    assert rec.query_name == "q"
    assert rec.identity == 1.0
    assert rec.cigar == "4="
    seqs = {"q": Sequence("q", b"ACGT"), "t": Sequence("t", b"ACGT")}
    validate_paf_record(rec, seqs)


def test_validate_alignment_coverage():
    seqs = {"q": Sequence("q", b"ACGTACGTAC"), "t": Sequence("t", b"ACGT")}
    rec = _mk_record(query_len=10, query_end=4)
    result = validate_alignment(rec, seqs, min_coverage=0.95)
    assert not result.valid
    assert any("coverage" in e for e in result.errors)
    assert abs(result.coverage - 0.4) < 1e-12


def test_detect_large_indels():
    assert detect_large_indels("100=2000D50=", min_len=1000) == [("D", 2000)]
    assert detect_large_indels("100=500D50=", min_len=1000) == []


# -- tests/test_conformance_wfa2.py ------------------------------------------

# The exact sequences used by the reference's debug bins.
SEQ12 = b"ACGTACGTACGT"  # debug_cigar.rs seq1 (12 bases)
SEQ10 = b"ACGTACGTAC"  # debug_cigar.rs seq2 (10 bases)
MM_Q = b"ACGTACGTACGT"  # check_wfa_ops.rs query
MM_T = b"ACGTACGTTCGT"  # check_wfa_ops.rs reference (A->T at pos 8)

TWO_PIECE = parse_scores("0,5,8,2,24,1")


def _bytes(res):
    return np.asarray(res.cigar_bytes, dtype=np.uint8)


class TestIDSwap:
    """debug_cigar.rs: 12bp query vs 10bp target, two-piece penalties
    (0,5,8,2,24,1). Global alignment must consume both fully; the two
    surplus QUERY bases are WFA2 'D' bytes, printed as standard 'I'."""

    def test_long_query_surplus_is_wfa2_D(self):
        res = align_pair(
            Sequence("q", SEQ12), Sequence("t", SEQ10), 0, 1, TWO_PIECE,
            use_mash_orientation=False,
        )
        c = _bytes(res)
        # full end-to-end consumption, exactly as debug_cigar.rs prints
        assert parse_cigar_lengths(c) == (12, 10)
        assert res.query_end == 12 and res.target_end == 10
        # surplus query bases -> 'D' bytes in WFA2 convention
        assert int(np.count_nonzero(c == OP_D)) == 2
        assert int(np.count_nonzero(c == OP_I)) == 0
        validate_cigar(c, SEQ12, SEQ10)
        # ... and the printed CIGAR swaps back to standard 'I'
        s = cigar_bytes_to_string(c)
        assert "I" in s and "D" not in s

    def test_long_target_surplus_is_wfa2_I(self):
        res = align_pair(
            Sequence("q", SEQ10), Sequence("t", SEQ12), 0, 1, TWO_PIECE,
            use_mash_orientation=False,
        )
        c = _bytes(res)
        assert parse_cigar_lengths(c) == (10, 12)
        assert int(np.count_nonzero(c == OP_I)) == 2
        assert int(np.count_nonzero(c == OP_D)) == 0
        validate_cigar(c, SEQ10, SEQ12)
        s = cigar_bytes_to_string(c)
        assert "D" in s and "I" not in s

    def test_paf_record_swaps_back(self):
        """The PAF cg:Z: tag is standard convention: 'I' consumes query.
        (lib.rs:71-112 + alignment.rs:347-376)."""
        res = align_pair(
            Sequence("q", SEQ12), Sequence("t", SEQ10), 0, 1, TWO_PIECE,
            use_mash_orientation=False,
        )
        paf = alignment_to_paf(
            res, [Sequence("q", SEQ12), Sequence("t", SEQ10)]
        )
        fields = paf.split("\t")
        assert fields[1] == "12" and fields[3] == "12"  # qlen, qend
        assert fields[6] == "10" and fields[8] == "10"  # tlen, tend
        cg = [f for f in fields if f.startswith("cg:Z:")][0][5:]
        # 10 matching bases + 2 query-only bases as standard 'I'
        assert "I" in cg and "D" not in cg
        tot_i = sum(
            int(n)
            for n, op in __import__("re").findall(r"(\d+)([=XID])", cg)
            if op == "I"
        )
        assert tot_i == 2


class TestOpCodes:
    """check_wfa_ops.rs: one substitution must appear as exactly one 'X'
    byte among 'M's — never a generic match op."""

    def test_single_mismatch_counts(self):
        res = align_pair(
            Sequence("q", MM_Q), Sequence("t", MM_T), 0, 1, TWO_PIECE,
            use_mash_orientation=False,
        )
        c = _bytes(res)
        assert int(np.count_nonzero(c == OP_M)) == 11
        assert int(np.count_nonzero(c == OP_X)) == 1
        assert int(np.count_nonzero(c == OP_I)) == 0
        assert int(np.count_nonzero(c == OP_D)) == 0
        # the X sits at position 8, as check_wfa_ops.rs's diagram shows
        assert int(np.flatnonzero(c == OP_X)[0]) == 8
        assert cigar_bytes_to_string(c) == "8=1X3="
        validate_cigar(c, MM_Q, MM_T)

    def test_identical_sequences_all_M(self):
        res = align_pair(
            Sequence("q", MM_Q), Sequence("t", MM_Q), 0, 1, TWO_PIECE,
            use_mash_orientation=False,
        )
        c = _bytes(res)
        assert np.all(c == OP_M) and c.size == 12
        assert res.score == 0


class TestParamOrder:
    """test_wfa_order.rs: align(seq1, seq2) treats seq1 as the
    pattern/query and seq2 as the text/target — swapping the arguments
    swaps which sequence the surplus ops consume."""

    @pytest.mark.parametrize(
        "q,t,wfa_op",
        [(SEQ12, SEQ10, OP_D), (SEQ10, SEQ12, OP_I)],
        ids=["q12_t10", "q10_t12"],
    )
    def test_order(self, q, t, wfa_op):
        res = align_sequences(
            q,
            t,
            SimplePenalties(5, 8, 2, 24, 1),
            AlignmentMode.TWO_PIECE_AFFINE,
        )
        # SimpleAlignmentResult reports standard-convention counts
        # (wfa.rs:84-103): insertions consume query.
        if wfa_op == OP_D:
            assert res.insertions == 2 and res.deletions == 0
        else:
            assert res.deletions == 2 and res.insertions == 0
        assert res.matches == 10 and res.mismatches == 0

    def test_lower_score_is_better(self):
        """types.rs:30: score is a penalty — 0 for identity, positive
        otherwise."""
        perfect = align_sequences(
            SEQ12, SEQ12, SimplePenalties(5, 8, 2), AlignmentMode.SINGLE_PIECE_AFFINE
        )
        gapped = align_sequences(
            SEQ12, SEQ10, SimplePenalties(5, 8, 2), AlignmentMode.SINGLE_PIECE_AFFINE
        )
        assert perfect.score == 0
        assert gapped.score > perfect.score


class TestPenaltyConstructors:
    """verify_memory_mode.rs:24-59: the 4-penalty constructor selects
    single-piece affine, the 6-penalty one two-piece; allwave's
    always-on Ultralow (biWFA) memory mode must not change results."""

    def test_mode_inference(self):
        assert (
            AlignmentMode.from_params(parse_scores("0,5,8,2"))
            == AlignmentMode.SINGLE_PIECE_AFFINE
        )
        assert (
            AlignmentMode.from_params(parse_scores("0,5,8,2,24,1"))
            == AlignmentMode.TWO_PIECE_AFFINE
        )
        assert (
            AlignmentMode.from_params(parse_scores("0,1,1,1"))
            == AlignmentMode.EDIT_DISTANCE
        )

    def test_two_piece_changes_long_gap_cost(self):
        """With (8,2) vs (24,1) pieces, a long gap's cost must follow the
        cheaper second piece: cost(n) = min(8+2n, 24+n)."""
        q = b"ACGT" * 12  # 48
        t = b"ACGT" * 6  # 24: one 24-base gap
        res1 = align_sequences(
            q, t, SimplePenalties(5, 8, 2), AlignmentMode.SINGLE_PIECE_AFFINE
        )
        res2 = align_sequences(
            q, t, SimplePenalties(5, 8, 2, 24, 1), AlignmentMode.TWO_PIECE_AFFINE
        )
        n = 24
        assert res1.score == 8 + 2 * n
        assert res2.score == min(8 + 2 * n, 24 + n)

    @pytest.mark.slow
    def test_segmented_low_memory_bit_equal(self):
        """The O(s)-memory segmented engine (the biWFA-Ultralow analog,
        SURVEY §5) returns the identical score and CIGAR bytes as the
        one-shot dense engine on the same pair."""
        from allwave_tpu_torch.wfa.batch import expand_runs
        from allwave_tpu_torch.wfa.dense_engine import DenseBandAligner
        from allwave_tpu_torch.wfa.segmented import SegmentedConfig, SegmentedDenseAligner
        from allwave_tpu_torch.wfa.params import resolve_penalties

        rng = np.random.RandomState(7)
        bases = np.frombuffer(b"ACGT", dtype=np.uint8)
        q = rng.choice(bases, 700).astype(np.uint8)
        t = q.copy()
        mut = rng.rand(700) < 0.05
        t[mut] = rng.choice(bases, int(mut.sum()))
        q_b, t_b = q.tobytes(), t.tobytes()
        pen = resolve_penalties(TWO_PIECE)
        dense = DenseBandAligner(pen).align_pairs([(q_b, t_b)])[0]
        seg = SegmentedDenseAligner(
            pen, SegmentedConfig(ckpt_every=256)
        ).align_pairs([(q_b, t_b)])[0]
        assert dense is not None and seg is not None
        assert dense[0] == seg[0]
        # runs may split at segment edges: compare them expanded
        np.testing.assert_array_equal(expand_runs(*dense[1]), expand_runs(*seg[1]))
