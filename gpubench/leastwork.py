"""The least work of an alignment, whatever implements it: the wavefront
cells an exact bidirectional gap-affine WFA needs at the pair's optimal
score s. The forward half runs score levels 0..ceil(s/2), the reverse
half 0..floor(s/2); a level's cells are the span of diagonals it can
hold, from the penalties alone (the WFA recursion on the reachable
diagonals, with no sequence). Each cell costs 9 int32 operations (a
lane-level); the bytes are the two sequences read once and the CIGAR
written once. No engine's band or launch count enters it."""

from __future__ import annotations

import json
import os
import re
from typing import Optional

import numpy as np

from .reference.wfa import Penalties

OPS_PER_CELL = 9
_PEAKS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "peaks.json")
_RUN = re.compile(r"(\d+)([=XID])")


def peaks(device_name: str) -> Optional[dict]:
    """int32 operations a second and bytes a second of the named card;
    None for a card the table lacks."""
    with open(_PEAKS) as f:
        row = json.load(f).get(device_name)
    if row is None:
        return None
    return {
        "int32_ops_per_s": row["sms"] * row["int32_lanes_per_sm"] * row["clock_hz"],
        "bytes_per_s": row["hbm_bytes_per_s"],
    }


def reach_by_level(pen: Penalties, levels: int) -> np.ndarray:
    """hi[l]: the highest diagonal any cell of score level l can hold
    (the lowest is -hi[l]); -1 where level l holds no cell."""
    none = -(1 << 40)
    m = np.full(levels + 1, none, dtype=np.int64)
    comps = [(pen.o1, pen.e1)] + ([(pen.o2, pen.e2)] if pen.two_piece else [])
    gaps = [np.full(levels + 1, none, dtype=np.int64) for _ in comps]
    m[0] = 0
    for lv in range(1, levels + 1):
        best = m[lv - pen.x] if lv >= pen.x else none
        for (o, e), g in zip(comps, gaps):
            src = max(m[lv - o - e] if lv >= o + e else none, g[lv - e] if lv >= e else none)
            if src > none // 2:
                g[lv] = src + 1
                best = max(best, g[lv])
        m[lv] = best
    return np.where(m > none // 2, m, -1)


def cells(hi: np.ndarray, score: int, plen: int, tlen: int) -> int:
    """Cells of both halves of a bidirectional WFA at this score, each
    level's span clipped to the matrix's diagonals [-plen, tlen]."""
    total = 0
    for half in ((score + 1) // 2, score // 2):
        h = hi[: half + 1]
        h = h[h >= 0]
        total += int((np.minimum(h, tlen) + np.minimum(h, plen) + 1).sum())
    return total


def cigar_score(cigar: str, pen: Penalties) -> int:
    """The score of a PAF CIGAR (=, X, I, D runs) under the penalties;
    adjacent gap runs of one op are one gap."""
    score = 0
    for n, op in _RUN.findall(cigar):
        if op == "X":
            score += pen.x * int(n)
        elif op in "ID":
            score += pen.gap_cost(int(n))
    return score


class LeastWork:
    """Sums the least work of PAF records."""

    def __init__(self, pen: Penalties):
        self.pen = pen
        self.hi = reach_by_level(pen, 1024)
        self.cells = 0
        self.bytes = 0

    def add_record(self, fields: list) -> None:
        """fields: a PAF line split on tabs (cg:Z: last)."""
        cigar = fields[-1][len("cg:Z:"):]
        s = cigar_score(cigar, self.pen)
        if s // 2 + 1 >= self.hi.size:
            self.hi = reach_by_level(self.pen, 2 * (s // 2 + 1))
        qlen, tlen = int(fields[1]), int(fields[6])
        self.cells += cells(self.hi, s, qlen, tlen)
        self.bytes += qlen + tlen + len(cigar)

    def least_seconds(self, peak: dict) -> float:
        return max(OPS_PER_CELL * self.cells / peak["int32_ops_per_s"],
                   self.bytes / peak["bytes_per_s"])
