"""The dense traceback kernel's schedule (csrc/dense_traceback.cu, a warp
a pair that loads the cells a walk can reach next in one round trip),
emulated on the CPU by allwave_tpu_torch/wfa/dense.py
`dense_traceback_groups` over the plain walk's hops: its rows against the
plain walk + pack and against the JAX reference's `dense_align_packed`
(XLA on the CPU), its round trips and modeled sectors exactly.

Every comparison is exact. Inputs come from numpy seeds and go to both
packages as numpy arrays. The kernel's rows, hops and round trips are
held to this emulation on the card by tests/test_torch_kernels.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from allwave_tpu.core.scores import parse_scores
from allwave_tpu.wfa import dense as JD
from allwave_tpu.wfa.params import resolve_penalties
from allwave_tpu_torch.testing.batches import edge_batch, mutate, random_batch
from allwave_tpu_torch.wfa import dense as TD


def _pen(scores_str):
    return resolve_penalties(parse_scores(scores_str))


def _walks(pen, batch, K, l_pad, run_cap):
    """The emulation's rows and stats, the plain walk + pack's rows and
    the reference's dense_align_packed rows over one batch."""
    qs, ts, ql, tl = batch
    ta = tuple(map(torch.from_numpy, batch))
    s, c, p = TD.dense_forward_ref(*ta, pen, K, l_pad)
    rows, stats = TD.dense_traceback_groups(p, s, c, ta[2], ta[3], run_cap)
    plain = TD.pack_alignments(s, c, *TD.dense_traceback_ref(p, s, ta[2], ta[3], run_cap))
    B = qs.shape[0]
    pool = np.concatenate([qs, ts])
    qi = np.arange(B, dtype=np.int32)
    ti = np.arange(B, 2 * B, dtype=np.int32)
    ref = JD.dense_align_packed(*map(jnp.asarray, (pool, qi, ti, ql, tl)), pen, K, l_pad, run_cap)
    return rows, stats, plain, np.asarray(ref), s


def _snp_batch(rng, B, L, l_pad, div):
    """B pairs of equal length L with ~div substitutions and no indel."""
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    qs = np.zeros((B, l_pad), np.uint8)
    ts = np.zeros((B, l_pad), np.uint8)
    for b in range(B):
        q = rng.choice(bases, L)
        qs[b, :L] = q
        ts[b, :L] = mutate(rng, q, div, 0)
    lens = np.full(B, L, np.int32)
    return qs, ts, lens, lens.copy()


@pytest.mark.parametrize(
    "scores_str,K,l_pad,B,div,run_cap,edge",
    [
        ("0,5,8,2,24,1", 128, 128, 9, 0.05, 128, False),  # two-piece, 9 pairs: not 4 a block
        ("0,4,6,2", 128, 128, 7, 0.1, 128, False),  # one-piece
        ("0,5,8,2,24,1", 128, 128, 6, 0.1, 4, False),  # overflow: drops, nrun counts
        ("0,1,1,1", 192, 256, 7, 0.08, 37, False),  # an odd cap: a partly filled ops byte
        ("0,5,8,2,24,1", 127, 128, 7, 0.05, 128, True),  # edge pairs: lengths 0 and 1, |k_end| = K - 1
        ("0,4,6,2", 129, 128, 7, 0.05, 6, True),  # edge pairs, overflow
        ("0,5,8,2,24,1", 100, 128, 7, 0.05, 128, True),  # an infeasible pair (|k_end| = K)
    ],
)
def test_group_walk_matches_plain_and_xla(scores_str, K, l_pad, B, div, run_cap, edge):
    """The emulated schedule's packed rows equal the plain walk + pack's
    and the reference's, every byte; round trips never exceed hops."""
    pen = _pen(scores_str)
    rng = np.random.RandomState(K + run_cap)
    if edge:
        batch = edge_batch(rng, B, l_pad, K, div)
    else:
        batch = random_batch(rng, B, (3 * l_pad) // 4, l_pad, div)
    rows, stats, plain, ref, s = _walks(pen, batch, K, l_pad, run_cap)
    assert torch.equal(rows, plain)
    np.testing.assert_array_equal(ref, rows.numpy())
    hops, rounds, sectors = stats
    assert bool((sectors <= 8 * rounds).all())
    # a pair with no walk (infeasible, or length 0) takes no hop and no load
    walked = (s < TD.INF) & torch.from_numpy(batch[2] + batch[3] > 0)
    assert bool((rounds <= hops).all()) and bool((rounds[walked] >= 1).all())
    assert not bool(hops[~walked].any()) and not bool(rounds[~walked].any())
    if run_cap < 8:
        assert bool(rows[:, 12:16].contiguous().view(torch.int32).any())
    if K == 100:
        assert bool((s >= TD.INF).any())


@pytest.mark.parametrize("scores_str", ["0,5,8,2,24,1", "0,4,6,2"])
def test_group_walk_halves_round_trips_on_snp_pairs(scores_str):
    """On pairs with substitutions only, a mismatch and the match run
    after it come in one round trip: the round trips fall to about half
    the hops, and the rows still equal the reference's."""
    pen = _pen(scores_str)
    batch = _snp_batch(np.random.RandomState(5), 8, 240, 256, 0.03)
    rows, (hops, rounds, _), plain, ref, _ = _walks(pen, batch, 128, 256, 128)
    assert torch.equal(rows, plain)
    np.testing.assert_array_equal(ref, rows.numpy())
    assert bool((rounds < hops).all())
    assert int(rounds.sum()) * 10 < int(hops.sum()) * 6


def test_group_walk_counts_one_round_trip_a_short_edit():
    """Exact counts: one substitution is three hops (the run after it,
    the mismatch, the run before) in two round trips; a 1-base deletion
    four hops (a run, the gap's open, a gap hop, a run) in two; a 2-base
    one five hops in three (past the one chain cell an S round loads, the
    closing cell starts a round); a 6-base one nine hops in three (the
    gap round loads eight cells of the chain, its closing cell among
    them)."""
    pen = _pen("0,5,8,2,24,1")
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    q = np.random.RandomState(3).choice(bases, 100)
    snp = q.copy()
    snp[40] = bases[(np.flatnonzero(bases == q[40])[0] + 1) % 4]
    pairs = [(q, snp), (q, np.delete(q, [50])), (q, np.delete(q, [50, 51])),
             (q, np.delete(q, np.arange(50, 56)))]
    l_pad = 128
    qs = np.zeros((4, l_pad), np.uint8)
    ts = np.zeros((4, l_pad), np.uint8)
    for b, (a, t) in enumerate(pairs):
        qs[b, : a.size] = a
        ts[b, : t.size] = t
    batch = (qs, ts, np.array([a.size for a, _ in pairs], np.int32),
             np.array([t.size for _, t in pairs], np.int32))
    rows, (hops, rounds, sectors), plain, ref, _ = _walks(pen, batch, 128, l_pad, 128)
    assert torch.equal(rows, plain)
    np.testing.assert_array_equal(ref, rows.numpy())
    assert hops.tolist() == [3, 4, 5, 9] and rounds.tolist() == [2, 2, 3, 3]
    # an S round's four cells lie in three 32-byte sectors, or in four
    # where (d - 1, c - 1) and (d - 1, c + 1) straddle a 16-cell boundary
    # (c = 63 or 64: every round of the first two pairs, the last of the
    # third); a gap round's eight cells lie in eight plane rows
    assert sectors.tolist() == [8, 8, 10, 14]


def test_group_cells_are_distinct_and_start_at_the_walker():
    """Each round pattern loads distinct cells, lane 0 the cell the walker
    needs: an S round its X successor and the first cell of each gap
    chain, a gap round eight cells of its own chain."""
    s_cells, i_cells, d_cells = TD.WALK_CELLS
    for cells in TD.WALK_CELLS:
        assert len(cells) == len(set(cells)) and cells[0] == (0, 0)
    assert s_cells == ((0, 0), (2, 0), (1, -1), (1, 1))
    assert i_cells == tuple((j, -j) for j in range(8))
    assert d_cells == tuple((j, j) for j in range(8))


def test_cpu_traceback_refuses_stats():
    """The round-trip stats are the kernel's: the CPU wrapper refuses them."""
    pen = _pen("0,5,8,2,24,1")
    ta = tuple(map(torch.from_numpy, random_batch(np.random.RandomState(1), 2, 60, 64)))
    s, c, p = TD.dense_forward_ref(*ta, pen, 128, 64)
    with pytest.raises(ValueError):
        TD.dense_traceback(p, s, c, ta[2], ta[3], 16, stats=torch.zeros((2, 2), dtype=torch.int32))
