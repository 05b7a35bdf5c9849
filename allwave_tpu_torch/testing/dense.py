"""Independent dense O(n*m) DP used ONLY to validate the wavefront
engines in tests.

Completely separate formulation from the wavefront oracle (classic
Gotoh-style row DP, minimization), so agreement between the two is strong
evidence of correctness. Supports gap-affine and two-piece-affine with the
same cost model: match 0, mismatch x, gap length l costs
min(o1 + l*e1, o2 + l*e2).
"""

from __future__ import annotations

import numpy as np

from ..wfa.params import Penalties

INF = np.int64(2**40)


def dense_score(pattern: bytes, text: bytes, pen: Penalties) -> int:
    """Optimal global alignment score (lower better)."""
    p = np.frombuffer(pattern, dtype=np.uint8)
    t = np.frombuffer(text, dtype=np.uint8)
    plen, tlen = p.size, t.size

    pieces = [(pen.o1, pen.e1)]
    if pen.two_piece:
        pieces.append((pen.o2, pen.e2))

    # One I and D matrix per gap piece. Row-wise DP over v (pattern).
    m_prev = np.full(tlen + 1, INF, dtype=np.int64)
    i_prev = [np.full(tlen + 1, INF, dtype=np.int64) for _ in pieces]
    d_prev = [np.full(tlen + 1, INF, dtype=np.int64) for _ in pieces]

    m_prev[0] = 0
    # Row 0: only insertions (consume text). Fold gap states into M as we
    # sweep so each piece's open sees the final M value at h-1.
    for h in range(1, tlen + 1):
        for gi, (o, e) in enumerate(pieces):
            i_prev[gi][h] = min(m_prev[h - 1] + o + e, i_prev[gi][h - 1] + e)
        m_prev[h] = min(ip[h] for ip in i_prev)

    for v in range(1, plen + 1):
        m_cur = np.full(tlen + 1, INF, dtype=np.int64)
        i_cur = [np.full(tlen + 1, INF, dtype=np.int64) for _ in pieces]
        d_cur = [np.full(tlen + 1, INF, dtype=np.int64) for _ in pieces]
        for gi, (o, e) in enumerate(pieces):
            d_cur[gi][0] = min(m_prev[0] + o + e, d_prev[gi][0] + e)
        m_cur[0] = min(dc[0] for dc in d_cur)
        for h in range(1, tlen + 1):
            sub = m_prev[h - 1] + (0 if p[v - 1] == t[h - 1] else pen.x)
            best = sub
            for gi, (o, e) in enumerate(pieces):
                i_cur[gi][h] = min(m_cur[h - 1] + o + e, i_cur[gi][h - 1] + e)
                d_cur[gi][h] = min(m_prev[h] + o + e, d_prev[gi][h] + e)
                best = min(best, i_cur[gi][h], d_cur[gi][h])
            m_cur[h] = best
        m_prev, i_prev, d_prev = m_cur, i_cur, d_cur

    return int(m_prev[tlen])


def cigar_score(cigar_bytes: np.ndarray, pen: Penalties) -> int:
    """Score a CIGAR (WFA2 convention) under the two-piece cost model.
    Each maximal gap run is charged min over pieces of (o + l*e)."""
    from ..core.cigar import run_length_encode
    from ..core.types import OP_D, OP_I, OP_X

    ops, counts = run_length_encode(np.asarray(cigar_bytes, dtype=np.uint8))
    score = 0
    pieces = [(pen.o1, pen.e1)]
    if pen.two_piece:
        pieces.append((pen.o2, pen.e2))
    for op, l in zip(ops.tolist(), counts.tolist()):
        if op == OP_X:
            score += pen.x * l
        elif op in (OP_I, OP_D):
            score += min(o + l * e for o, e in pieces)
    return score
