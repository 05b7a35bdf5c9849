"""Seeded random pair batches for holding the kernels against their
plain versions and the JAX reference."""

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


def edge_batch(rng, B: int, l_pad: int, K: int, div: float = 0.05):
    """random_batch(rng, B, l_pad, l_pad, div) with its first rows
    replaced by the forward's edge pairs, as (qlen, tlen): (0, 0), (1, 1),
    (0, 3), (l_pad, l_pad); where l_pad >= K - 1 the band's edges
    |k_end| = K - 1 on both sides; and where l_pad >= K an infeasible
    pair, |k_end| = K. A target is its query's prefix, or the query and
    random bases, with ~div substitutions."""
    qs, ts, qlens, tlens = random_batch(rng, B, l_pad, l_pad, div)
    lens = [(0, 0), (1, 1), (0, 3), (l_pad, l_pad)]
    if l_pad >= K - 1:
        lens += [(l_pad, l_pad - (K - 1)), (l_pad - (K - 1), l_pad)]
    if l_pad >= K:
        lens.append((l_pad, l_pad - K))
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    for b, (ql, tl) in enumerate(lens[:B]):
        q = rng.choice(bases, ql)
        t = np.concatenate([q, rng.choice(bases, max(tl - ql, 0))])[:tl]
        mut = rng.rand(tl) < div
        t[mut] = rng.choice(bases, mut.sum())
        qs[b] = 0
        ts[b] = 0
        qs[b, :ql] = q
        ts[b, :tl] = t
        qlens[b], tlens[b] = ql, tl
    return qs, ts, qlens, tlens


def mutate(rng, q: np.ndarray, div: float, n_indel: int) -> np.ndarray:
    """A copy of q with ~div substitutions and n_indel indels of 1-3
    bases."""
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    t = q.copy()
    mut = rng.rand(t.size) < div
    t[mut] = rng.choice(bases, int(mut.sum()))
    for _ in range(n_indel):
        p = rng.randint(0, t.size)
        if rng.rand() < 0.5:
            t = np.delete(t, np.arange(p, min(p + rng.randint(1, 4), t.size)))
        else:
            t = np.insert(t, p, rng.choice(bases, rng.randint(1, 4)))
    return t


def wavefront_batch(rng, l_pad: int, K: int, div: float = 0.03, n_rand: int = 3):
    """(qs, ts, qlens, tlens) numpy arrays for the wavefront engine's
    edge cases: n_rand mutated pairs of ~0.9 l_pad, then an identical
    pair (done at score 0), a pair with tlen == l_pad, one whose length
    difference exceeds a band of K diagonals (infeasible), and a short
    pair whose band reaches past the matrix (h_max = -1 there)."""
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    pairs = []
    for _ in range(n_rand):
        q = rng.choice(bases, l_pad - 40 - rng.randint(0, 40))
        pairs.append((q, mutate(rng, q, div, 2)))
    q = rng.choice(bases, l_pad - 50)
    pairs.append((q, q.copy()))
    t = rng.choice(bases, l_pad)
    pairs.append((np.delete(mutate(rng, t, div, 0), [7, 100]), t))
    q = rng.choice(bases, l_pad - K - 10)
    pairs.append((q, np.concatenate([q, rng.choice(bases, K + 5)])))
    q = rng.choice(bases, 60)
    pairs.append((q, mutate(rng, q, 0.1, 1)))
    B = len(pairs)
    qs = np.zeros((B, l_pad), np.uint8)
    ts = np.zeros((B, l_pad), np.uint8)
    for b, (q, t) in enumerate(pairs):
        qs[b, : q.size] = q
        ts[b, : t.size] = t
    lens = np.array([[q.size, t.size] for q, t in pairs], np.int32)
    return qs, ts, lens[:, 0].copy(), lens[:, 1].copy()
