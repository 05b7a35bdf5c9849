"""Which directed pairs a job aligns, from the `-p` value and the
sequence ids alone: every ordered pair but self pairs, or those kept by
the hash filter of allwave's random and giant-component modes
(allwave iterator.rs:256-334)."""

from __future__ import annotations

import math

import numpy as np

from .siphash import pair_keep_mask


def keep_fraction(spec: str, n: int):
    """The hash filter's keep fraction for a `-p` value, or None for
    `none` (every pair)."""
    if spec == "none":
        return None
    kind, _, arg = spec.partition(":")
    if kind == "random":
        return float(arg)
    if kind in ("giant", "auto"):
        prob = float(arg) if kind == "giant" else 0.95
        if n <= 1:
            return 1.0
        if n <= 10:
            return {2: 1.0, 3: 0.8, 4: 0.7, 5: 0.6}.get(n, 0.5)
        x = min(max(prob, 0.001), 0.999)
        p = (math.log(n) - math.log(-math.log(x))) / n
        return min(max(p, 0.001), 1.0)
    raise ValueError(f"the reference has no pair selection for -p {spec!r}")


def select_pairs(ids: list, spec: str) -> np.ndarray:
    """(P, 2) int64 directed pairs (query, target), i-major."""
    n = len(ids)
    i = np.repeat(np.arange(n, dtype=np.int64), n)
    j = np.tile(np.arange(n, dtype=np.int64), n)
    off = i != j
    i, j = i[off], j[off]
    frac = keep_fraction(spec, n)
    if frac is not None:
        keep = pair_keep_mask(ids, i, j, frac)
        i, j = i[keep], j[keep]
    return np.stack([i, j], axis=1)
