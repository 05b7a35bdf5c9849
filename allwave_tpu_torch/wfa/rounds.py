"""What the three alignment engines share when they plan their rounds
(wfa/dense_engine.py, wfa/segmented.py, wfa/wf_segmented.py): the device
sequence pool their batches gather from, the band ladder with its
exit-and-return certificate, and the pooled-index form of a pair list.

The router (dense_engine.UnifiedAligner) makes one `SequencePool` on its
device and hands it to all three engines; each engine builds its own
`BandLadder` from its rungs, `k_initial` and optional `k_max`.
"""

from __future__ import annotations

from bisect import bisect_left
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.telemetry import counters
from .params import Penalties


def next_pow2(n: int) -> int:
    return 1 << max(n - 1, 1).bit_length() if n > 2 else max(n, 1)


def pool_pairs(pairs):
    """(pool_seqs, qidx, tidx) for a list of (query, target) byte pairs:
    each distinct sequence appears once in the pool."""
    n = len(pairs)
    pool_map: Dict[bytes, int] = {}
    for q, t in pairs:
        for sq in (q, t):
            if sq not in pool_map:
                pool_map[sq] = len(pool_map)
    qidx = np.fromiter((pool_map[q] for q, _ in pairs), dtype=np.int64, count=n)
    tidx = np.fromiter((pool_map[t] for _, t in pairs), dtype=np.int64, count=n)
    return list(pool_map), qidx, tidx


class SequencePool:
    """ONE device-resident (n_seqs, l_pad) uint8 sequence pool per
    (pool list, l_pad); batches gather their rows from it by index, so
    all-pairs workloads upload each sequence once. The pipeline hands the
    same pool list to every chunk and length bucket, and the router the
    same SequencePool to every engine, so it is uploaded once per run."""

    def __init__(self, device: torch.device):
        self.device = device
        #: (id(pool_seqs), l_pad) -> (pool_seqs, device pool); the strong
        #: list ref keeps the id() from being recycled
        self._cache: Dict[Tuple[int, int], Tuple[object, torch.Tensor]] = {}

    def rows(self, pool_seqs, l_pad: int) -> torch.Tensor:
        key = (id(pool_seqs), l_pad)
        hit = self._cache.get(key)
        if hit is not None and hit[0] is pool_seqs:
            return hit[1]
        pool_dev = self._upload(pool_seqs, l_pad)
        if len(self._cache) > 4:
            self._cache.clear()
        self._cache[key] = (pool_seqs, pool_dev)
        return pool_dev

    def _upload(self, pool_seqs, l_pad: int) -> torch.Tensor:
        with counters.span("engine.plan"):
            pool = np.zeros((max(len(pool_seqs), 1), l_pad), dtype=np.uint8)
            for r, sq in enumerate(pool_seqs):
                if len(sq) <= l_pad:
                    pool[r, : len(sq)] = np.frombuffer(sq, dtype=np.uint8)
            return torch.from_numpy(pool).to(self.device)


class BandLadder:
    """An engine's accepted band widths and the band a banded score
    certifies on them. `for_score` and `for_scores` give the smallest
    rung, at least `k_initial` and clamped at `k_max` when one is set,
    whose exit-and-return certificate holds for a banded score sigma;
    `round_many` and `for_scores` are their vectorised forms over int64
    arrays."""

    def __init__(self, pen: Penalties, rungs: Sequence[int], k_initial: int,
                 k_max: Optional[int] = None):
        self.pen = pen
        self.rungs: List[int] = sorted(rungs)
        self.k_initial = k_initial
        self.k_max = k_max
        self._rungs_np = np.asarray(self.rungs, dtype=np.int64)

    def round(self, k: int) -> int:
        """Smallest rung >= k (the top rung past the ladder)."""
        return self.rungs[min(bisect_left(self.rungs, k), len(self.rungs) - 1)]

    def round_many(self, k: np.ndarray) -> np.ndarray:
        idx = np.searchsorted(self._rungs_np, k).clip(0, self._rungs_np.size - 1)
        return self._rungs_np[idx]

    def _reach(self, sigma, kend_abs, maximum):
        """The unrounded band for a banded score sigma: the certificate's
        bound is 2*g(W+1) with g(n) = min(o1+n*e1, o2+n*e2), so W+1 is
        the minimal n with g(n) >= sigma//2 + 1 on BOTH pieces. `maximum`
        is max on ints and np.maximum on arrays."""
        pen = self.pen
        t = sigma // 2 + 1
        n = maximum(1, -(-(t - pen.o1) // pen.e1))
        if pen.two_piece:
            n = maximum(n, -(-(t - pen.o2) // pen.e2))
        return kend_abs + 2 * maximum(n - 1, 0) + 3

    def for_score(self, sigma: int, kend_abs: int) -> int:
        k = self.round(max(self._reach(sigma, kend_abs, max), self.k_initial))
        return k if self.k_max is None else min(k, self.k_max)

    def for_scores(self, sigma: np.ndarray, kend_abs: np.ndarray) -> np.ndarray:
        k = self.round_many(np.maximum(self._reach(sigma, kend_abs, np.maximum), self.k_initial))
        return k if self.k_max is None else np.minimum(k, self.k_max)
