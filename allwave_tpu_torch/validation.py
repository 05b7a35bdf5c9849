"""Alignment validators — API parity with the reference's validation
modules (/root/reference/src/validation.rs, validation_correct.rs,
validation_simple.rs).

All functions work on STANDARD-convention CIGAR strings as they appear
in PAF output ('='/'X'/'I'/'D' where I consumes query, D consumes
target), i.e. after the WFA2 I/D swap.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple


from .core.cigar import cigar_string_to_bytes, validate_cigar
from .core.types import Sequence

_CIGAR_RE = re.compile(r"(\d+)([=XIDM])")


def parse_cigar(cigar: str) -> List[Tuple[int, str]]:
    """CIGAR string -> [(count, op)] (reference: validation.rs:28-49)."""
    ops = []
    pos = 0
    for m in _CIGAR_RE.finditer(cigar):
        if m.start() != pos:
            raise ValueError(f"Invalid CIGAR at position {pos}: {cigar!r}")
        ops.append((int(m.group(1)), m.group(2)))
        pos = m.end()
    if pos != len(cigar):
        raise ValueError(f"Invalid CIGAR at position {pos}: {cigar!r}")
    return ops


@dataclass
class AlignmentStats:
    """Reference: validation.rs:52-83."""

    matches: int = 0
    mismatches: int = 0
    insertions: int = 0  # bases inserted in query (standard 'I')
    deletions: int = 0  # bases deleted from query (standard 'D')
    gap_opens: int = 0

    @property
    def identity(self) -> float:
        denom = self.matches + self.mismatches
        return self.matches / denom if denom else 0.0


def calculate_alignment_stats(cigar: str) -> AlignmentStats:
    stats = AlignmentStats()
    prev_op = None
    for count, op in parse_cigar(cigar):
        if op == "=" or op == "M":
            stats.matches += count
        elif op == "X":
            stats.mismatches += count
        elif op == "I":
            stats.insertions += count
            if prev_op != "I":
                stats.gap_opens += 1
        elif op == "D":
            stats.deletions += count
            if prev_op != "D":
                stats.gap_opens += 1
        prev_op = op
    return stats


def verify_cigar_alignment(cigar: str, query: bytes, target: bytes) -> None:
    """Replay with bounds + full-consumption + base-equality checks
    (reference: validation.rs:97-160, validation_correct.rs:4-119).
    Raises ValueError on inconsistency."""
    validate_cigar(cigar_string_to_bytes(cigar), query, target)


@dataclass
class PafRecord:
    """Parsed PAF line (fields per the §2.3 output contract)."""

    query_name: str
    query_len: int
    query_start: int
    query_end: int
    strand: str
    target_name: str
    target_len: int
    target_start: int
    target_end: int
    num_matches: int
    block_len: int
    mapq: int
    identity: Optional[float] = None
    cigar: Optional[str] = None

    @staticmethod
    def parse(line: str) -> "PafRecord":
        f = line.rstrip("\n").split("\t")
        if len(f) < 12:
            raise ValueError(f"PAF line has {len(f)} fields, expected >= 12")
        rec = PafRecord(
            query_name=f[0],
            query_len=int(f[1]),
            query_start=int(f[2]),
            query_end=int(f[3]),
            strand=f[4],
            target_name=f[5],
            target_len=int(f[6]),
            target_start=int(f[7]),
            target_end=int(f[8]),
            num_matches=int(f[9]),
            block_len=int(f[10]),
            mapq=int(f[11]),
        )
        for tag in f[12:]:
            if tag.startswith("gi:f:"):
                rec.identity = float(tag[5:])
            elif tag.startswith("cg:Z:"):
                rec.cigar = tag[5:]
        return rec


def validate_paf_record(
    record: PafRecord, sequences_by_id: Dict[str, Sequence]
) -> None:
    """Full PAF-line validation with base-equality inside '=' runs
    (reference: validation_simple.rs:73-161). The query is
    reverse-complemented first when strand is '-' (coords refer to the
    RC'd query, §2.3)."""
    from .orient.orientation import reverse_complement

    if record.query_name not in sequences_by_id:
        raise ValueError(f"unknown query {record.query_name}")
    if record.target_name not in sequences_by_id:
        raise ValueError(f"unknown target {record.target_name}")
    q = sequences_by_id[record.query_name].seq
    t = sequences_by_id[record.target_name].seq
    if record.query_len != len(q):
        raise ValueError("query length mismatch")
    if record.target_len != len(t):
        raise ValueError("target length mismatch")
    if record.cigar is None:
        raise ValueError("missing cg:Z tag")
    if record.strand == "-":
        q = reverse_complement(q)
    if record.cigar == "":
        if record.query_end != 0 or record.target_end != 0:
            raise ValueError("empty CIGAR with nonzero coordinates")
        return
    # bounds, consumption, and per-base agreement
    verify_cigar_alignment(
        record.cigar,
        q[record.query_start : record.query_end],
        t[record.target_start : record.target_end],
    )
    stats = calculate_alignment_stats(record.cigar)
    if stats.matches != record.num_matches:
        raise ValueError(
            f"num_matches {record.num_matches} != CIGAR matches {stats.matches}"
        )
    expected_block = max(
        record.query_end - record.query_start, record.target_end - record.target_start
    )
    if record.block_len != expected_block:
        raise ValueError("block_len mismatch")
    if record.identity is not None:
        denom = stats.matches + stats.mismatches
        expected = stats.matches / denom if denom else 0.0
        if abs(record.identity - expected) > 5e-7:
            raise ValueError(f"identity {record.identity} != {expected}")


@dataclass
class ValidationResult:
    """Reference: validation.rs:163-251."""

    valid: bool
    coverage: float
    identity: float
    errors: List[str]


def validate_alignment(
    record: PafRecord,
    sequences_by_id: Dict[str, Sequence],
    min_coverage: float = 0.95,
) -> ValidationResult:
    errors: List[str] = []
    try:
        validate_paf_record(record, sequences_by_id)
    except ValueError as e:
        errors.append(str(e))
    coverage = (
        (record.query_end - record.query_start) / record.query_len
        if record.query_len
        else 0.0
    )
    stats = calculate_alignment_stats(record.cigar or "")
    if coverage < min_coverage:
        errors.append(f"coverage {coverage:.3f} < {min_coverage}")
    return ValidationResult(
        valid=not errors,
        coverage=coverage,
        identity=stats.identity,
        errors=errors,
    )


def detect_large_indels(cigar: str, min_len: int = 1000) -> List[Tuple[str, int]]:
    """CNV-scale events = indel runs >= min_len
    (reference: validation.rs:254-284 uses 1000bp)."""
    out = []
    for count, op in parse_cigar(cigar):
        if op in ("I", "D") and count >= min_len:
            out.append((op, count))
    return out
