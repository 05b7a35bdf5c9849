"""PAF serialization — the byte-exactness contract.

Field-for-field replication of the reference's `alignment_to_paf`
(reference: /root/reference/src/lib.rs:71-112):

 1  query id
 2  query full length
 3  query_start (always 0: global alignment)
 4  query_end   (= #query bases consumed by the CIGAR)
 5  strand '+' / '-' ('-' iff query was reverse-complemented; coordinates
    refer to the RC'd query)
 6  target id
 7  target full length
 8  target_start (always 0)
 9  target_end  (= #target bases consumed)
10  num_matches (count of exact-match ops)
11  block_len = max(query_aligned_len, target_aligned_len)   <- NOT the
    SAM-style sum (reference: lib.rs:78-80)
12  mapq fixed 60
then tags: gi:f:<identity %.6f>  cg:Z:<run-length CIGAR, '='/'X'/'I'/'D'
after the WFA2 I/D swap>.

Identity = matches / (matches + mismatches), gaps excluded; 0 if the
alignment is empty (reference: lib.rs:83-87). Failed alignments still emit a
record with zero coords and an empty CIGAR.
"""

from __future__ import annotations

from typing import Sequence as PySequence

from .cigar import cigar_bytes_to_string, runs_to_cigar_string
from .types import AlignmentResult, Sequence


def alignment_to_paf(result: AlignmentResult, sequences: PySequence[Sequence]) -> str:
    query = sequences[result.query_idx]
    target = sequences[result.target_idx]

    query_aligned_len = result.query_end - result.query_start
    target_aligned_len = result.target_end - result.target_start
    block_len = max(target_aligned_len, query_aligned_len)

    if result.alignment_length > 0:
        identity = result.num_matches / result.alignment_length
    else:
        identity = 0.0

    runs = getattr(result, "cigar_runs", None)
    if runs is not None:
        cigar = runs_to_cigar_string(*runs)
    else:
        cigar = cigar_bytes_to_string(result.cigar_bytes)
    strand = "-" if result.is_reverse else "+"

    return (
        f"{query.id}\t{len(query.seq)}\t{result.query_start}\t{result.query_end}\t"
        f"{strand}\t{target.id}\t{len(target.seq)}\t{result.target_start}\t"
        f"{result.target_end}\t{result.num_matches}\t{block_len}\t60\t"
        f"gi:f:{identity:.6f}\tcg:Z:{cigar}"
    )
