"""Single-pair convenience API — parity with the reference's per-pair
entry points (`align_pair`, alignment.rs:25-66, and the legacy
`align_sequences` wrapper, wfa.rs:178-258).

These run through the same engines as the batched pipeline; they exist
so library users of the reference find the same call shapes here.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.cigar import (
    cigar_bytes_to_string,
    count_cigar_operations,
    parse_cigar_lengths,
    validate_cigar,
)
from ..core.types import AlignmentMode, AlignmentParams, AlignmentResult, Sequence
from ..orient.orientation import determine_orientation_mash, reverse_complement
from .params import Penalties, resolve_penalties


def _align_oriented(query: bytes, target: bytes, params: AlignmentParams):
    """(score, cigar) via the native C++ oracle when available, else the
    NumPy oracle — the right tool for one-off pairs (no batching)."""
    pen = resolve_penalties(params)
    from .. import native

    if native.available():
        try:
            return native.wfa_align_native(query, target, pen)
        except RuntimeError:
            return None
    from .reference_impl import wfa_align

    try:
        return wfa_align(query, target, pen)
    except RuntimeError:
        return None


def align_pair(
    query: Sequence,
    target: Sequence,
    query_idx: int,
    target_idx: int,
    params: AlignmentParams,
    orientation_params: Optional[AlignmentParams] = None,
    use_mash_orientation: bool = True,
) -> AlignmentResult:
    """Reference: alignment.rs:25-66 — orientation + alignment + CIGAR
    post-processing for one directed pair; failures yield the zeroed
    result."""
    if orientation_params is None:
        orientation_params = AlignmentParams.edit_distance()
    if use_mash_orientation:
        oriented, is_rev = determine_orientation_mash(query.seq, target.seq)
    else:
        oriented, is_rev = _determine_orientation_wfa(
            query.seq, target.seq, orientation_params
        )
    res = _align_oriented(oriented, target.seq, params)
    if res is None:
        return AlignmentResult.failed(query_idx, target_idx, is_rev)
    score, cigar = res
    num_matches, alignment_length = count_cigar_operations(cigar)
    query_end, target_end = parse_cigar_lengths(cigar)
    return AlignmentResult(
        query_idx=query_idx,
        target_idx=target_idx,
        query_start=0,
        query_end=query_end,
        target_start=0,
        target_end=target_end,
        is_reverse=is_rev,
        cigar_bytes=cigar,
        score=score,
        num_matches=num_matches,
        alignment_length=alignment_length,
    )


def _determine_orientation_wfa(query, target, params):
    """Reference: alignment.rs:157-175 — edit-distance both orientations,
    compare X+I+D counts, ties forward."""
    rc = reverse_complement(query)
    fwd = _align_oriented(query, target, params)
    rev = _align_oriented(rc, target, params)
    fd = int(np.count_nonzero(fwd[1] != ord("M"))) if fwd is not None else 2**62
    rd = int(np.count_nonzero(rev[1] != ord("M"))) if rev is not None else 2**62
    if fd <= rd:
        return query, False
    return rc, True


# --- legacy wrapper parity (reference: wfa.rs) -----------------------------


@dataclass
class SimplePenalties:
    """Reference: wfa.rs:27-33."""

    mismatch: int
    gap_opening1: int
    gap_extension1: int
    gap_opening2: int = 0
    gap_extension2: int = 0


@dataclass
class SimpleAlignmentResult:
    """Reference: wfa.rs:35-47 (counts in STANDARD convention)."""

    score: int
    cigar: str
    matches: int
    mismatches: int
    insertions: int
    deletions: int
    alignment_length: int


def align_sequences(
    pattern: bytes,
    text: bytes,
    penalties: SimplePenalties,
    mode: AlignmentMode,
) -> SimpleAlignmentResult:
    """Reference: wfa.rs:178-258 — uncached single alignment with CIGAR
    validation. Raises AlignmentError-equivalent ValueError on failure."""
    if mode == AlignmentMode.EDIT_DISTANCE:
        params = AlignmentParams(
            match_score=0,
            mismatch_penalty=penalties.mismatch,
            gap_open=penalties.mismatch,
            gap_extend=penalties.mismatch,
            gap2_open=None,
            gap2_extend=None,
        )
    elif mode == AlignmentMode.SINGLE_PIECE_AFFINE:
        params = AlignmentParams(
            match_score=0,
            mismatch_penalty=penalties.mismatch,
            gap_open=penalties.gap_opening1,
            gap_extend=penalties.gap_extension1,
            gap2_open=None,
            gap2_extend=None,
        )
    else:
        params = AlignmentParams(
            match_score=0,
            mismatch_penalty=penalties.mismatch,
            gap_open=penalties.gap_opening1,
            gap_extend=penalties.gap_extension1,
            gap2_open=penalties.gap_opening2,
            gap2_extend=penalties.gap_extension2,
        )
    res = _align_oriented(pattern, text, params)
    if res is None:
        raise ValueError("Alignment failed")
    score, cigar = res
    validate_cigar(cigar, pattern, text)
    m = int(np.count_nonzero(cigar == ord("M")))
    x = int(np.count_nonzero(cigar == ord("X")))
    # standard convention: insertions consume query (WFA2 'D'), deletions
    # consume target (WFA2 'I') — reference: wfa.rs:84-103
    ins = int(np.count_nonzero(cigar == ord("D")))
    dels = int(np.count_nonzero(cigar == ord("I")))
    return SimpleAlignmentResult(
        score=score,
        cigar=cigar_bytes_to_string(cigar),
        matches=m,
        mismatches=x,
        insertions=ins,
        deletions=dels,
        alignment_length=m + x,
    )
