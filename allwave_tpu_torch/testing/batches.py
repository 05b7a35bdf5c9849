"""Seeded random pair batches for holding the kernels against their
plain versions and the JAX reference, and the strands that hold
orientation's sketch kernel to the host's sets."""

from __future__ import annotations

import numpy as np

from ..core.types import Sequence
from ..orient.orientation import OrientationIndex


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


def long_indel_batch(rng, B: int, L: int, l_pad: int, gap: int, div: float = 0.02):
    """(qs, ts, qlens, tlens) numpy arrays of B pairs of length L with
    ~div substitutions: pair b has a `gap`-base deletion from its target
    (b % 3 == 0), a `gap`-base insertion into it (b % 3 == 1) or neither,
    near the middle. A walk crosses the gap as one run of gap hops, its
    band column drifting by `gap`. Needs l_pad >= L + gap."""
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    qs = np.zeros((B, l_pad), np.uint8)
    ts = np.zeros((B, l_pad), np.uint8)
    qlens = np.full(B, L, np.int32)
    tlens = np.zeros(B, np.int32)
    for b in range(B):
        q = rng.choice(bases, L)
        t = mutate(rng, q, div, 0)
        at = L // 2 + 7 * b
        if b % 3 == 0:
            t = np.concatenate([t[:at], t[at + gap:]])
        elif b % 3 == 1:
            t = np.concatenate([t[:at], rng.choice(bases, gap), t[at:]])
        qs[b, :L] = q
        ts[b, : t.size] = t
        tlens[b] = t.size
    return qs, ts, qlens, tlens


def pair_batch(pairs, l_pad: int):
    """(q, t) byte pairs as batch arrays: (B, l_pad) uint8 queries and
    targets, zero-padded, and (B,) int32 lengths."""
    B = len(pairs)
    qs = np.zeros((B, l_pad), np.uint8)
    ts = np.zeros((B, l_pad), np.uint8)
    for b, (q, t) in enumerate(pairs):
        qs[b, : len(q)] = np.frombuffer(q, np.uint8)
        ts[b, : len(t)] = np.frombuffer(t, np.uint8)
    qlens = np.array([len(q) for q, _ in pairs], np.int32)
    tlens = np.array([len(t) for _, t in pairs], np.int32)
    return qs, ts, qlens, tlens


def sketch_strands(k: int):
    """Strands that break a wrong stranded MinHash set: lengths 0, k - 1,
    k, 300, 2,000, 5,000 and 100,000; lowercase bases, N, IUPAC codes
    and other bytes; fewer valid windows than a sketch, short and long
    (12 kb of N around a few islands of bases, as an assembly's gaps
    leave them); poly-A and short tandem repeats, short and long, whose
    equal hashes straddle the cut."""
    rng = np.random.RandomState(11)
    acgt = np.frombuffer(b"ACGT", np.uint8)

    def rand(n):
        return rng.choice(acgt, n).tobytes()

    seqs = [b"", rand(k - 1), rand(k)] + [rand(n) for n in (300, 2000, 5000, 100_000)]
    soft = np.frombuffer(rand(2000), np.uint8).copy()
    soft[500:1500] |= 0x20  # soft-masked: lowercase hashes differ
    seqs.append(soft.tobytes())
    noisy = np.frombuffer(rand(5000), np.uint8).copy()
    junk = np.frombuffer(b"NnRYKMSWBDHV-*.\x00\xff acgtu", np.uint8)
    at = rng.choice(noisy.size, 120, replace=False)
    noisy[at] = rng.choice(junk, at.size)
    seqs.append(noisy.tobytes())
    sparse = np.frombuffer(rand(3000), np.uint8).copy()
    sparse[::25] = ord("N")  # 10 windows of 15 between each N
    seqs.append(sparse.tobytes())
    seqs += [b"A" * 3000, b"A" * 10_000, b"CA" * 1500, b"ATTG" * 2500, b"GATA" * 30]
    mixed = bytearray(rand(6000))
    mixed[2000:3200] = b"TTAGGG" * 200  # a repeat tract amid random bases
    seqs.append(bytes(mixed))
    gappy = bytearray(b"N" * 12_000)  # 21 valid windows: 10, 10 (lowercase) and 1
    gappy[1000 : 1009 + k] = rand(k + 9)
    gappy[5000 : 5009 + k] = rand(k + 9).lower()
    gappy[9000 : 9000 + k] = rand(k)
    lone = bytearray(b"N" * 12_000)  # one valid window
    lone[7000 : 7000 + k] = rand(k)
    seqs += [bytes(gappy), bytes(lone)]
    return seqs


def host_stranded_sets(seqs, seq_idx, reverse, k: int, sketch_size: int):
    """The plain version of `sketch.device_sketch.stranded_sets`: each
    job's set (`seqs[seq_idx[j]]`, reverse complemented where
    `reverse[j]`) as a CPU `OrientationIndex` builds it, one at a time."""
    idx = OrientationIndex([Sequence(f"s{i}", s) for i, s in enumerate(seqs)], k, sketch_size,
                           device="cpu")
    return [idx._rev_set(i) if r else idx._fwd_set(i) for i, r in zip(seq_idx, reverse)]
