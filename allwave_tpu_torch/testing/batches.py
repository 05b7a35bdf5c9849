"""Seeded random pair batches for holding the dense kernels against
their plain versions and the JAX reference."""

from __future__ import annotations

import numpy as np


def random_batch(rng, B: int, L: int, l_pad: int, div: float = 0.05, min_len=None):
    """(qs, ts, qlens, tlens) numpy arrays: B pairs whose query length
    is drawn from [min_len, L] (default L // 2), whose target differs
    from it by up to 6 bases of length and ~div substitutions, padded
    with zeros to l_pad columns."""
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    lo = L // 2 if min_len is None else min_len
    qlens = rng.randint(lo, L + 1, B).astype(np.int32)
    tlens = (qlens + rng.randint(-6, 7, B)).clip(8, L).astype(np.int32)
    qs = np.zeros((B, l_pad), np.uint8)
    ts = np.zeros((B, l_pad), np.uint8)
    for b in range(B):
        q = rng.choice(bases, qlens[b])
        if tlens[b] <= qlens[b]:
            t = q[: tlens[b]].copy()
        else:
            t = np.concatenate([q, rng.choice(bases, tlens[b] - qlens[b])])
        mut = rng.rand(tlens[b]) < div
        t[mut] = rng.choice(bases, mut.sum())
        qs[b, : qlens[b]] = q
        ts[b, : tlens[b]] = t
    return qs, ts, qlens, tlens
