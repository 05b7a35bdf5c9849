"""Parity of the port's segmented (checkpoint-replay) engine
(allwave_tpu_torch/wfa/segmented.py, plain versions on the CPU) with the
JAX reference (allwave_tpu/wfa/segmented.py: the XLA span and walk, and
the Pallas span kernels in interpret mode).

Every comparison is exact: no tolerance. Inputs come from numpy seeds
and go to both packages as numpy arrays. The port's engine replays a
narrow per-pair sub-band whenever the band is wider than k_sub, while
the reference on the CPU replays the full band, so the engine-level
cases also hold the narrow replay's cone contract. The kernels are held
against these plain versions on the card by tests/test_torch_kernels.py.

This file also closes three TPU kernels by equivalence: the classic
`_forward_u` and the transposed, parity-compressed `_forward_t2`
against the port's forward, and the parity-compressed span engine
(`impl="c2"`) against the port's segmented engine."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from allwave_tpu.core.scores import parse_scores
from allwave_tpu.wfa import dense as JD
from allwave_tpu.wfa import dense_engine as JE
from allwave_tpu.wfa import segmented as JS
from allwave_tpu.wfa.params import resolve_penalties
from allwave_tpu_torch.testing.batches import random_batch
from allwave_tpu_torch.wfa import batch as TB
from allwave_tpu_torch.wfa import dense as TD
from allwave_tpu_torch.wfa import dense_engine as TE
from allwave_tpu_torch.wfa import segmented as TS
from torch_replay_emulation import replay_clusters

SCORE_SETS = ["0,5,8,2,24,1", "0,4,6,2", "0,1,1,1"]


@pytest.fixture(autouse=True)
def _single_device(monkeypatch):
    # the reference's shard_map over 8 virtual CPU devices gives the same
    # bytes; one device keeps its compile short
    monkeypatch.setenv("ALLWAVE_SINGLE_DEVICE", "1")


def _pen(scores_str):
    return resolve_penalties(parse_scores(scores_str))


def _eq(jax_arr, torch_t):
    np.testing.assert_array_equal(np.asarray(jax_arr), torch_t.numpy())


def _batch(seed, B, L, l_pad, div):
    arrays = random_batch(np.random.RandomState(seed), B, L, l_pad, div, min_len=(3 * L) // 4)
    return tuple(map(jnp.asarray, arrays)), tuple(map(torch.from_numpy, arrays))


def _state(ckpts_j, seg):
    """Segment seg of the reference's checkpoint tuple, as the port's
    (5, B, K) tensor."""
    return torch.from_numpy(np.stack([np.asarray(c[seg]) for c in ckpts_j]))


def _walk_from(walk_t, bufs_t):
    """The port's walk and buffers in the reference's tuple form."""
    w = walk_t.numpy()
    walk = (
        jnp.asarray(w[0]), jnp.asarray(w[1]), jnp.asarray(w[2]),
        jnp.asarray(w[3] != 0), jnp.asarray(w[4].astype(np.uint8)), jnp.asarray(w[5]),
    )
    return walk, tuple(jnp.asarray(b.numpy()) for b in bufs_t)


def _assert_walk_equal(walk_j, bufs_j, walk_t, bufs_t):
    for a, b in zip(walk_j, walk_t):
        np.testing.assert_array_equal(np.asarray(a).astype(np.int64), b.numpy().astype(np.int64))
    for a, b in zip(bufs_j, bufs_t):
        _eq(a, b)


# ---------------------------------------------------------------------------
# The span and the sweep
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scores_str", SCORE_SETS)
def test_sweep_and_span_match_xla(scores_str):
    """dense_sweep_ckpt: scores, certificates and every checkpoint equal
    the reference's; then one span from a JAX-made checkpoint at d_lo > 0
    gives the XLA span's state and both planes, every byte, reachable or
    not."""
    pen = _pen(scores_str)
    l_pad, K, C = 256, 384, 128
    ja, ta = _batch(3, 4, 240, l_pad, 0.1)
    s_j, c_j, ck_j = JS.dense_sweep_ckpt(*ja, pen, K, l_pad, C, impl="xla")
    s_t, c_t, ck_t = TS.dense_sweep_ckpt(*ta, pen, K, l_pad, C)
    _eq(s_j, s_t)
    _eq(c_j, c_t)
    assert tuple(ck_t.shape) == (5, (2 * l_pad) // C, 4, K)
    for comp in range(5):
        _eq(ck_j[comp], ck_t[comp])
    assert bool(c_t.all())

    seg = 2
    st_j, (ch_j, rn_j) = JS.dense_span_xla(
        *ja, pen, K, l_pad, jnp.int32(seg * C), C, tuple(c[seg] for c in ck_j), True
    )
    st_t, pl_t = TS.dense_span_ref(*ta, pen, K, l_pad, seg * C, C, _state(ck_j, seg), True)
    for comp in range(5):
        _eq(st_j[comp], st_t[comp])
    assert pl_t.dtype == torch.uint16 and tuple(pl_t.shape) == (C, 4, K)
    p = pl_t.to(torch.int32)
    _eq(ch_j, (p & 0xFF).to(torch.uint8))
    _eq(rn_j, (p >> 8).to(torch.uint8))


def _cluster_sweep(qs, ts, qlens, tlens, pen, K, l_pad, d_lo, n_steps, state, G,
                   c_lo=None, k_sub=None, stretch=32):
    """A plain emulation of csrc/dense_span.cu's sweep schedule
    (`dense_sweep_cluster_kernel`), to hold its index algebra on the CPU:
    the window of W lanes split into G blocks of Lb (even) lanes, each
    block's five bands parity-packed [band][lane parity][lane // 2] and
    updated in place, only the lanes of d's parity inside the matrix
    moving, a block's edge lanes reading the neighbour block's edge lane
    (INF past the window), the bases read from tables staged every
    `stretch` steps (the kernel's SW_STRETCH is 4096; a small one
    restages within a span here). Returns the (5, B, W) state."""
    INF = 2**29
    W = K if c_lo is None else k_sub
    B = qs.shape[0]
    Lb = -(-W // G)
    Lb += Lb & 1
    assert -(-W // Lb) == G, "every block holds lanes"
    Lh, tbl = Lb // 2, (stretch + Lb) // 2 + 2
    n = [min(Lb, W - r * Lb) for r in range(G)]
    out = torch.empty((5, B, W), dtype=torch.int32)
    for b in range(B):
        qlen, tlen = int(qlens[b]), int(tlens[b])
        k_end = tlen - qlen
        k0 = min(0, k_end) - ((K - 1 - abs(k_end)) >> 1)
        k0 -= k0 & 1
        col0 = 0 if c_lo is None else min(max(int(c_lo[b]), 0), K - W)
        packed = torch.full((G, 5, 2, Lh), -7, dtype=torch.int32)  # -7: never read
        for r in range(G):
            j = torch.arange(n[r])
            packed[r][:, j & 1, j >> 1] = state[:, b, col0 + r * Lb + j]
        q, t = qs[b].long(), ts[b].long()
        inf3 = torch.full((3,), INF, dtype=torch.int32)
        for s in range(n_steps):
            d = d_lo + 1 + s
            if s % stretch == 0:
                tables = []
                for r in range(G):
                    kb = k0 + col0 + r * Lb
                    vmin, hmin = (d - kb - (Lb - 1)) >> 1, (d + kb) >> 1
                    qi = (qlen - (vmin + torch.arange(tbl))).clamp(0, l_pad - 1)
                    qt = q[(qlen - 1 - qi).clamp(0, l_pad - 1)]
                    tt = t[(hmin + torch.arange(tbl) - 1).clamp(0, l_pad - 1)]
                    tables.append((vmin, hmin, qt, tt))
            for r in range(G):
                kb = k0 + col0 + r * Lb
                p = (d - kb) & 1
                cnt = (n[r] - p + 1) >> 1
                kmin, kmax = max(-d, d - 2 * qlen), min(d, 2 * tlen - d)
                i_lo, i_hi = max(0, (kmin - kb - p + 1) >> 1), min(cnt - 1, (kmax - kb - p) >> 1)
                if i_lo > i_hi:
                    continue
                i = torch.arange(i_lo, i_hi + 1)
                j = 2 * i + p
                oth, own = packed[r, :, 1 - p], packed[r, :, p]
                left_in, right_in = j > 0, j + 1 < n[r]
                li, ri = (i + p - 1).clamp(min=0), (i + p).clamp(max=Lh - 1)
                # the neighbours' edge lanes: the left block's last (odd,
                # the last of its half 1), the right block's first; this
                # step writes the other half, so the order of blocks
                # within a step does not matter
                halo_l = packed[r - 1, [0, 1, 3], 1, Lh - 1] if r > 0 else inf3
                halo_r = packed[r + 1, [0, 2, 4], 0, 0] if r < G - 1 else inf3
                s_l, i1_l, i2_l = (torch.where(left_in, oth[band, li], halo_l[x])
                                   for x, band in enumerate((0, 1, 3)))
                s_r, d1_r, d2_r = (torch.where(right_in, oth[band, ri], halo_r[x])
                                   for x, band in enumerate((0, 2, 4)))
                i1 = torch.minimum(s_l + (pen.o1 + pen.e1), i1_l + pen.e1)
                d1 = torch.minimum(s_r + (pen.o1 + pen.e1), d1_r + pen.e1)
                best = torch.minimum(i1, d1)
                if pen.two_piece:
                    i2 = torch.minimum(s_l + (pen.o2 + pen.e2), i2_l + pen.e2)
                    d2 = torch.minimum(s_r + (pen.o2 + pen.e2), d2_r + pen.e2)
                    best = torch.minimum(best, torch.minimum(i2, d2))
                else:
                    i2, d2 = own[3, i], own[4, i]
                vmin, hmin, qt, tt = tables[r]
                v, h = ((d - kb - p) >> 1) - i, ((d + kb + p) >> 1) + i
                assert int((v - vmin).min()) >= 0 and int((h - hmin).max()) < tbl
                match = qt[v - vmin] == tt[h - hmin]
                diag = torch.where((v > 0) & (h > 0), own[0, i] + torch.where(match, 0, pen.x), INF)
                new = [x.clamp(max=INF).to(torch.int32)
                       for x in (torch.minimum(diag, best), i1, d1, i2, d2)]
                for band in range(5):
                    own[band, i] = new[band]
        for r in range(G):
            j = torch.arange(n[r])
            out[:, b, r * Lb + j] = packed[r][:, j & 1, j >> 1]
    return out


@pytest.mark.parametrize(
    "scores_str,K,G,seg,n_steps,edge",
    [
        ("0,5,8,2,24,1", 201, 8, 2, 67, False),  # odd W, a short last block of 19
        ("0,4,6,2", 201, 3, 2, 64, False),  # one-piece: I2, D2 pass through
        ("0,1,1,1", 200, 1, 3, 33, False),  # one block
        ("0,5,8,2,24,1", 127, 3, 0, 97, True),  # edge pairs from d = 0
    ],
)
def test_cluster_sweep_schedule_matches_xla(scores_str, K, G, seg, n_steps, edge):
    """The sweep kernel's cluster schedule, emulated, gives the XLA
    span's end state exactly at full band, from a checkpoint of the
    reference's sweep: random pairs at d_lo > 0, and from d = 0 the edge
    pairs of testing.batches.edge_batch (lengths 0 and 1, |k_end| =
    K - 1 where the band clips, infeasible)."""
    from allwave_tpu_torch.testing.batches import edge_batch

    pen = _pen(scores_str)
    l_pad, C = 256, 64
    if edge:
        arrays = edge_batch(np.random.RandomState(K), 7, l_pad, K, 0.05)
        ja, ta = tuple(map(jnp.asarray, arrays)), tuple(map(torch.from_numpy, arrays))
    else:
        ja, ta = _batch(K + G, 4, 240, l_pad, 0.08)
    _, _, ck_j = JS.dense_sweep_ckpt(*ja, pen, K, l_pad, C, impl="xla")
    st_j, _ = JS.dense_span_xla(
        *ja, pen, K, l_pad, jnp.int32(seg * C), n_steps, tuple(c[seg] for c in ck_j), False
    )
    st_e = _cluster_sweep(*ta, pen, K, l_pad, seg * C, n_steps, _state(ck_j, seg), G)
    for comp in range(5):
        _eq(st_j[comp], st_e[comp])


@pytest.mark.parametrize(
    "scores_str,G,c_lo", [("0,5,8,2,24,1", 8, (0, 128, 183, 61)), ("0,4,6,2", 3, (7, 0, 100, 183))]
)
def test_cluster_sweep_schedule_window_matches_plain(scores_str, G, c_lo):
    """The emulated schedule on a window of k_sub = 201 lanes of a band of
    384 at per-pair offsets, odd ones included (the window's first lane
    then has odd k), over 65 steps: the end state equals dense_span_ref's
    (which dense_span_xla does not take) exactly."""
    pen = _pen(scores_str)
    l_pad, K, k_sub, C, seg = 256, 384, 201, 64, 2
    _, ta = _batch(G, 4, 250, l_pad, 0.1)
    _, _, ck = TS.dense_sweep_ckpt(*ta, pen, K, l_pad, C)
    c = torch.tensor(c_lo, dtype=torch.int32)
    st_p, _ = TS.dense_span_ref(*ta, pen, K, l_pad, seg * C, 65, ck[:, seg], False, c_lo=c, k_sub=k_sub)
    st_e = _cluster_sweep(*ta, pen, K, l_pad, seg * C, 65, ck[:, seg], G, c_lo=c, k_sub=k_sub)
    assert torch.equal(st_p, st_e)


@pytest.mark.parametrize(
    "scores_str,K,nw,lpt,warp,seg,n_steps,edge,G",
    [
        ("0,5,8,2,24,1", 201, 2, 4, 8, 2, 67, False, 4),  # odd W, a short last block of 9
        ("0,4,6,2", 201, 1, 8, 8, 2, 64, False, 4),  # one-piece, 8 lanes a thread
        ("0,1,1,1", 200, 4, 4, 16, 3, 33, False, 1),  # one block
        ("0,5,8,2,24,1", 127, 1, 4, 8, 0, 97, True, 4),  # edge pairs from d = 0
    ],
)
def test_cluster_replay_schedule_matches_xla(scores_str, K, nw, lpt, warp, seg, n_steps, edge, G):
    """The replay kernel's cluster schedule, emulated, gives the XLA
    span's end state and both planes exactly, every entry reachable or
    not, at full band, from a checkpoint of the reference's sweep: random
    pairs at d_lo > 0, and from d = 0 the edge pairs of
    testing.batches.edge_batch (lengths 0 and 1, |k_end| = K - 1 where the
    band clips, infeasible)."""
    from allwave_tpu_torch.testing.batches import edge_batch

    pen = _pen(scores_str)
    l_pad, C = 256, 64
    if edge:
        arrays = edge_batch(np.random.RandomState(K + 1), 7, l_pad, K, 0.05)
        ja, ta = tuple(map(jnp.asarray, arrays)), tuple(map(torch.from_numpy, arrays))
    else:
        ja, ta = _batch(K + nw, 4, 240, l_pad, 0.08)
    _, _, ck_j = JS.dense_sweep_ckpt(*ja, pen, K, l_pad, C, impl="xla")
    st_j, (ch_j, rn_j) = JS.dense_span_xla(
        *ja, pen, K, l_pad, jnp.int32(seg * C), n_steps, tuple(c[seg] for c in ck_j), True
    )
    st_e, pl_e, g = replay_clusters(*ta, pen, K, l_pad, seg * C, n_steps, _state(ck_j, seg),
                                    nw, lpt, warp=warp)
    assert g == G
    for comp in range(5):
        _eq(st_j[comp], st_e[comp])
    p = pl_e.to(torch.int32)
    _eq(ch_j, (p & 0xFF).to(torch.uint8))
    _eq(rn_j, (p >> 8).to(torch.uint8))


@pytest.mark.parametrize(
    "scores_str,nw,lpt,c_lo", [("0,5,8,2,24,1", 2, 4, (0, 128, 183, 61)),
                               ("0,4,6,2", 1, 8, (7, 0, 100, 183))]
)
def test_cluster_replay_schedule_window_matches_plain(scores_str, nw, lpt, c_lo):
    """The emulated replay on a window of k_sub = 201 lanes of a band of
    384 at per-pair offsets, odd ones included (the window's first lane
    then has odd k, and the moving registers change parity), over 65
    steps: the end state and every plane entry equal dense_span_ref's."""
    pen = _pen(scores_str)
    l_pad, K, k_sub, C, seg = 256, 384, 201, 64, 2
    _, ta = _batch(nw + lpt, 4, 250, l_pad, 0.1)
    _, _, ck = TS.dense_sweep_ckpt(*ta, pen, K, l_pad, C)
    c = torch.tensor(c_lo, dtype=torch.int32)
    st_p, pl_p = TS.dense_span_ref(*ta, pen, K, l_pad, seg * C, 65, ck[:, seg], True, c_lo=c, k_sub=k_sub)
    st_e, pl_e, g = replay_clusters(*ta, pen, K, l_pad, seg * C, 65, ck[:, seg], nw, lpt,
                                    c_lo=c, k_sub=k_sub, warp=8)
    assert g == 4
    assert torch.equal(st_p, st_e) and torch.equal(pl_p, pl_e)


def test_sweep_bound_and_infeasible():
    """A cut-short sweep (n_seg below the matrix) leaves long pairs
    infeasible; a band too narrow for the length difference gives INF."""
    pen = _pen("0,5,8,2,24,1")
    rng = np.random.RandomState(5)
    l_pad, K, C = 128, 128, 64
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    qs = np.zeros((3, l_pad), np.uint8)
    ts = np.zeros((3, l_pad), np.uint8)
    qs[0, :120] = rng.choice(bases, 120)
    ts[0, :120] = qs[0, :120]
    qs[1, :128] = rng.choice(bases, 128)  # |k_end| = 128 > K-1
    qs[2, :30] = rng.choice(bases, 30)
    ts[2, :28] = qs[2, :28]
    arrays = (qs, ts, np.array([120, 128, 30], np.int32), np.array([120, 0, 28], np.int32))
    ja, ta = tuple(map(jnp.asarray, arrays)), tuple(map(torch.from_numpy, arrays))
    for n_seg in (2, None):
        s_j, c_j, _ = JS.dense_sweep_ckpt(*ja, pen, K, l_pad, C, n_seg=n_seg)
        s_t, c_t, _ = TS.dense_sweep_ckpt(*ta, pen, K, l_pad, C, n_seg=n_seg)
        _eq(s_j, s_t)
        _eq(c_j, c_t)
    assert int(s_t[1]) >= TD.INF and int(s_t[2]) < TD.INF


def test_sub_span_matches_full_in_cone_and_pallas_sub():
    """The sub-band span (window [c_lo, c_lo + k_sub), INF inflow at its
    edges) equals the full-band span on every in-cone cell, and equals
    pallas_span.dense_span_pallas_sub (interpret mode) on the states and
    on a walk over its planes (mirrors tests/test_segmented_narrow.py)."""
    from allwave_tpu.wfa.pallas_span import dense_span_pallas_sub, make_group_streams

    pen = _pen("0,5,8,2,24,1")
    l_pad, K, k_sub, C, B = 1024, 1024, 512, 128, 2
    ja, ta = _batch(91, B, 1000, l_pad, 0.05)
    _, _, ck_j = JS.dense_sweep_ckpt(*ja, pen, K, l_pad, C, impl="xla")
    _, k0, _ = JD._band_geometry(ja[2], ja[3], K)
    gs = make_group_streams(*ja, K, l_pad)
    seg, c_lo_v = 7, (256, 384)
    state = _state(ck_j, seg)
    c_lo = torch.tensor(c_lo_v, dtype=torch.int32)
    _, full = TS.dense_span_ref(*ta, pen, K, l_pad, seg * C, C, state, True)
    st_t, sub = TS.dense_span_ref(
        *ta, pen, K, l_pad, seg * C, C, state, True, c_lo=c_lo, k_sub=k_sub
    )
    for j in range(C):
        lo, hi = j + 2, k_sub - 1 - (j + 2)  # the influence cone at level j
        for b in range(B):
            g0 = c_lo_v[b]
            assert torch.equal(sub[j, b, lo:hi], full[j, b, g0 + lo : g0 + hi])

    state_s = tuple(
        jnp.asarray(np.stack([state[comp, b, g : g + k_sub].numpy() for b, g in enumerate(c_lo_v)]))
        for comp in range(5)
    )
    st_p, planes_p = dense_span_pallas_sub(
        gs, ja[2], ja[3], k0, jnp.asarray(c_lo_v, jnp.int32), pen, K, k_sub,
        l_pad, jnp.int32(seg * C), C, state_s, True, interpret=True,
    )
    for comp in range(5):
        _eq(st_p[comp], st_t[comp])
    # walkers entering at the top of the segment on the main diagonal
    # (k = 0, well inside the window's cone), walked over both planes
    cap = 64
    c_rel = np.asarray(-k0, np.int32) - np.asarray(c_lo_v, np.int32)
    walk_t = TS.new_walk(
        torch.full((B,), (seg + 1) * C, dtype=torch.int32),
        torch.from_numpy(c_rel) + c_lo,
        torch.ones(B, dtype=torch.bool),
    )
    bufs_t = TS.new_bufs(B, cap, "cpu")
    walk_j, bufs_j = _walk_from(walk_t, bufs_t)
    walk_j = (walk_j[0], jnp.asarray(c_rel)) + walk_j[2:]
    walk_j, bufs_j = JS.traceback_segment(planes_p, jnp.int32(seg * C), walk_j, bufs_j, ja[2], ja[3], pen, cap)
    TS.traceback_segment_ref(sub, seg * C, walk_t, bufs_t, c_lo=c_lo)
    walk_j = (walk_j[0], walk_j[1] + jnp.asarray(c_lo_v, jnp.int32)) + walk_j[2:]
    _assert_walk_equal(walk_j, bufs_j, walk_t, bufs_t)
    assert int(bufs_t[2].min()) > 0


# ---------------------------------------------------------------------------
# The resumable walk
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "scores_str,run_cap", [("0,5,8,2,24,1", 64), ("0,4,6,2", 4), ("0,1,1,1", 2)]
)
def test_segment_walk_matches_xla(scores_str, run_cap):
    """Segment by segment from the end cell to the origin: the walk
    state and run buffers equal traceback_segment's after every
    segment, drops and overflow included."""
    pen = _pen(scores_str)
    l_pad, K, C = 256, 256, 64
    ja, ta = _batch(7, 5, 250, l_pad, 0.12)
    s_j, c_j, ck_j = JS.dense_sweep_ckpt(*ja, pen, K, l_pad, C, impl="xla")
    k_end, k0, _ = TD.band_geometry(ta[2], ta[3], K)
    d0 = ta[2] + ta[3]
    walk_t = TS.new_walk(d0, (k_end - k0).clamp(0, K - 1), torch.from_numpy(np.array(c_j)) & (d0 > 0))
    bufs_t = TS.new_bufs(5, run_cap, "cpu")
    walk_j, bufs_j = _walk_from(walk_t, bufs_t)
    for seg in range(int(d0.max() - 1) // C, -1, -1):
        state = tuple(c[seg] for c in ck_j)
        _, planes_j = JS.dense_span_xla(*ja, pen, K, l_pad, jnp.int32(seg * C), C, state, True)
        walk_j, bufs_j = JS.traceback_segment(planes_j, jnp.int32(seg * C), walk_j, bufs_j, ja[2], ja[3], pen, run_cap)
        _, planes_t = TS.dense_span_ref(*ta, pen, K, l_pad, seg * C, C, _state(ck_j, seg), True)
        TS.traceback_segment_ref(planes_t, seg * C, walk_t, bufs_t)
        _assert_walk_equal(walk_j, bufs_j, walk_t, bufs_t)
    assert bool(bufs_t[3].any()) == (run_cap < 8)


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


def _pairs(seed, n, L, div, indel=0.0):
    rng = np.random.RandomState(seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    out = []
    for _ in range(n):
        q = rng.choice(bases, L + rng.randint(0, 20))
        t = q.copy()
        mut = rng.rand(t.size) < div
        t[mut] = rng.choice(bases, mut.sum())
        if indel:
            t = t[rng.rand(t.size) >= indel]
        out.append((q.tobytes(), t.tobytes()))
    return out


def _norm(results):
    """(score, per-base cigar bytes) of each result, runs expanded: the
    port's runs may split at segment edges where the reference's do not."""
    return [None if r is None else
            (int(r[0]), np.asarray(TB.expand_runs(*r[1]) if isinstance(r[1], tuple) else r[1],
                                   np.uint8).tobytes())
            for r in results]


@pytest.fixture
def groups(monkeypatch):
    """(K, run_cap, n_pairs, narrow) of every group the port's engine runs."""
    seen = []
    orig = TS.SegmentedDenseAligner._run_group

    def spy(self, pool, group, results, k, l_pad, C, run_cap, full_cap, *rest):
        k_sub = min(k, -(-(2 * C + 320) // 128) * 128)
        seen.append((k, run_cap, len(group), k > k_sub))
        return orig(self, pool, group, results, k, l_pad, C, run_cap, full_cap, *rest)

    monkeypatch.setattr(TS.SegmentedDenseAligner, "_run_group", spy)
    return seen


def _segmented_both(pen, pairs, hint=None, **cfg):
    j = JS.SegmentedDenseAligner(pen, JS.SegmentedConfig(impl="xla", **cfg))
    t = TS.SegmentedDenseAligner(pen, TS.SegmentedConfig(**cfg), device="cpu")
    rj = j.align_pairs(pairs, sigma_hint=hint)
    rt = t.align_pairs(pairs, sigma_hint=hint)
    assert _norm(rt) == _norm(rj)
    return rt


@pytest.mark.parametrize("scores_str", ["0,5,8,2,24,1", "0,1,1,1"])
def test_engine_matches_xla_escalation_identical_unrelated(scores_str, groups):
    """No hints: every pair starts at K=128; the divergent and unrelated
    pairs escalate (the unrelated one to a band past k_sub, replayed
    narrow); the identical pair scores 0."""
    pen = _pen(scores_str)
    pairs = _pairs(31, 2, 220, 0.03, indel=0.01) + _pairs(32, 1, 220, 0.2)
    rng = np.random.RandomState(33)
    pairs.append((rng.choice(list(b"ACGT"), 236).astype(np.uint8).tobytes(),
                  rng.choice(list(b"ACGT"), 230).astype(np.uint8).tobytes()))
    pairs.append((pairs[0][0], pairs[0][0]))
    res = _segmented_both(pen, pairs, ckpt_every=32)
    assert all(r is not None for r in res) and res[-1][0] == 0
    assert groups[0][:3] == (128, 2048, 5)
    assert max(k for k, *_ in groups) > 128
    if scores_str == "0,5,8,2,24,1":  # the unrelated pair's band passes k_sub
        assert any(nar for *_, nar in groups)


def test_engine_matches_xla_with_hints_narrow(groups):
    """Hints size the first band past k_sub (narrow replay from the
    start); a low hint costs an escalation; 0,4,6,2 penalties."""
    pen = _pen("0,4,6,2")
    pairs = _pairs(41, 3, 500, 0.05, indel=0.005)
    res = _segmented_both(pen, pairs, hint=[2400, 2400, 20], ckpt_every=128)
    assert all(r is not None for r in res)
    assert groups[0][:3] == (128, 2048, 1) and groups[1][0] > 640 and groups[1][3]
    assert len({k for k, *_ in groups}) >= 2


def test_engine_matches_xla_overflow_rerun_and_failure(monkeypatch, groups):
    """A run buffer too small reruns the pair at the full cap 2L+8; at a
    small k_max the divergent pairs fail (None) in both. The port's run
    bound is patched small too, so its rerun guard is what runs."""
    pen = _pen("0,5,8,2,24,1")
    for cls in (JS.SegmentedDenseAligner, TS.SegmentedDenseAligner):
        monkeypatch.setattr(cls, "_run_cap", lambda self, l_pad: 6)
    monkeypatch.setattr(TS.SegmentedDenseAligner, "_runs_bound", lambda self, *a: 1)
    pairs = _pairs(51, 2, 100, 0.08) + _pairs(52, 1, 100, 0.75, indel=0.1)
    res = _segmented_both(pen, pairs, ckpt_every=64)
    assert all(r is not None for r in res)
    assert (128, 6, 3, False) in groups and any(cap == 2 * 128 + 8 for _, cap, *_ in groups)
    res = _segmented_both(pen, pairs, k_max=128, ckpt_every=64)
    assert res[0] is not None and res[2] is None


def _bound_pairs(seed):
    """Pairs whose walks stress the run bound: an identical pair (match
    stretches past 255 bases across many segment edges), one with 300-
    and 200-base gaps, a near-identical one, one with many short indels,
    and an unrelated one."""
    rng = np.random.RandomState(seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    q = rng.choice(bases, 700)
    gapped = np.concatenate([q[:150], q[450:], rng.choice(bases, 200)])
    near = q.copy()
    near[rng.rand(q.size) < 0.004] = rng.choice(bases, 1)
    out = [(q, q), (q, gapped), (q, near)]
    out += [(p[0], p[1]) for p in
            ((np.frombuffer(a, np.uint8), np.frombuffer(b, np.uint8))
             for a, b in _pairs(seed + 1, 1, 600, 0.05, indel=0.03) + _pairs(seed + 2, 1, 400, 0.75))]
    return out


@pytest.mark.parametrize("scores_str", ["0,5,8,2,24,1", "0,4,6,2"])
def test_runs_bound_holds_for_every_walk(scores_str):
    """For each certified pair, the run bound the engine sizes its run
    buffers from is at least the runs its walk emits: the segmented
    sweep and walk at a band that covers the whole matrix (so every pair
    is certified), C = 64 (many segment edges), the open run's flush
    counted."""
    pen = _pen(scores_str)
    pairs = _bound_pairs(5)
    B, l_pad, C = len(pairs), 1024, 64
    qs = np.zeros((B, l_pad), np.uint8)
    ts = np.zeros((B, l_pad), np.uint8)
    for b, (q, t) in enumerate(pairs):
        qs[b, : q.size], ts[b, : t.size] = q, t
    ql = np.array([q.size for q, _ in pairs], np.int32)
    tl = np.array([t.size for _, t in pairs], np.int32)
    K = int((ql + tl).max()) + 3
    qs_t, ts_t, ql_t, tl_t = map(torch.from_numpy, (qs, ts, ql, tl))
    n_seg = -(-int((ql + tl).max()) // C)
    scores, cert, ckpts = TS.dense_sweep_ckpt(qs_t, ts_t, ql_t, tl_t, pen, K, l_pad, C, n_seg=n_seg)
    assert bool(cert.all())
    k_end, k0, _ = TD.band_geometry(ql_t, tl_t, K)
    walk = TS.new_walk(ql_t + tl_t, (k_end - k0).clamp(0, K - 1), cert)
    bufs = TS.new_bufs(B, 2 * l_pad + 8, "cpu")
    for seg in range(n_seg - 1, -1, -1):
        _, planes = TS.dense_span_ref(qs_t, ts_t, ql_t, tl_t, pen, K, l_pad, seg * C, C, ckpts[:, seg], True)
        TS.traceback_segment_ref(planes, seg * C, walk, bufs)
    assert not bool(bufs[3].any()) and not bool(walk[3].any())
    nrun = bufs[2] + (walk[5] > 0).to(torch.int32)
    eng = TS.SegmentedDenseAligner(pen, device="cpu")
    for b in range(B):
        bound = eng._runs_bound(int(scores[b]), int(ql[b]), int(tl[b]), -(-int(ql[b] + tl[b]) // C))
        assert bound >= int(nrun[b]), (b, bound, int(nrun[b]))


def test_engine_sizes_run_buffers_from_scores(monkeypatch, groups):
    """With _run_cap small in both packages, the port sizes each group's
    run buffers from its certified scores: no group is re-queued at the
    full cap 2L+8 (the reference reruns there), and the results are the
    reference's."""
    pen = _pen("0,5,8,2,24,1")
    for cls in (JS.SegmentedDenseAligner, TS.SegmentedDenseAligner):
        monkeypatch.setattr(cls, "_run_cap", lambda self, l_pad: 6)
    pairs = _pairs(53, 1, 160, 0.08, indel=0.01) + _pairs(54, 1, 120, 0.3)
    pairs.append((pairs[0][0], pairs[0][0]))
    TS.seg_stats.reset()
    res = _segmented_both(pen, pairs, ckpt_every=64)
    assert all(r is not None for r in res)
    assert all(cap == 6 for _, cap, *_ in groups) and TS.seg_stats.overflow_reruns == 0


@pytest.mark.parametrize("scores_str", ["0,5,8,2,24,1", "0,4,6,2"])
def test_c2_span_engine_matches_port(scores_str, monkeypatch):
    """Row #6 by equivalence: the reference's parity-compressed span
    engine (impl="c2", Pallas in interpret mode) gives the port's
    segmented results end to end (mirrors tests/test_pallas_dense.py)."""
    monkeypatch.setenv("ALLWAVE_SPAN_INTERPRET", "1")
    pen = _pen(scores_str)
    pairs = _pairs(61, 2, 420, 0.03, indel=0.01)
    pairs.append((pairs[0][0], pairs[0][0]))
    c2 = JS.SegmentedDenseAligner(pen, JS.SegmentedConfig(ckpt_every=256, impl="c2"))
    port = TS.SegmentedDenseAligner(pen, TS.SegmentedConfig(ckpt_every=256), device="cpu")
    assert _norm(port.align_pairs(pairs)) == _norm(c2.align_pairs(pairs))


@pytest.mark.parametrize("ref_runs", [False, True])
def test_unified_long_route_matches_reference(ref_runs):
    """UnifiedAligner with dense_max_len lowered: the long pairs take the
    segmented engine in both packages; short ones the dense engine.
    Every port result, long or short, is runs; expanded, they equal the
    reference's per-base arrays and, with ref_runs, its runs expanded."""
    pen = _pen("0,5,8,2,24,1")
    pairs = _pairs(71, 2, 150, 0.04) + _pairs(72, 2, 60, 0.04)
    cfg = dict(ckpt_every=64)
    j = JE.UnifiedAligner(pen, dense_max_len=100, dense_config=JE.DenseConfig(impl="xla"),
                          segmented_config=JS.SegmentedConfig(impl="xla", **cfg))
    t = TE.UnifiedAligner(pen, dense_max_len=100, device="cpu",
                          segmented_config=TS.SegmentedConfig(**cfg))
    hint = [60, 60, 20, 20]
    rj, sj = j.align_pairs(pairs, with_stats=True, sigma_hint=hint, as_runs=ref_runs)
    rt, st = t.align_pairs(pairs, with_stats=True, sigma_hint=hint)
    assert _norm(rt) == _norm(rj)
    np.testing.assert_array_equal(st, sj)
    assert all(isinstance(c, tuple) for _, c in rt)


def test_all_pair_aligner_long_route_matches_reference(monkeypatch, tmp_path):
    """AllPairAligner (mash hints, orientation) with the long-pair
    threshold lowered in both packages: identical sorted PAF lines."""
    import allwave_tpu as R
    import allwave_tpu_torch as T
    from allwave_tpu.testing.synth import MutationConfig, make_test_case

    for mod, seg in ((JE, JS), (TE, TS)):
        init = mod.UnifiedAligner.__init__

        def low(self, pen, *a, _init=init, _seg=seg, **kw):
            kw["dense_max_len"] = 200
            kw["segmented_config"] = _seg.SegmentedConfig(ckpt_every=128)
            _init(self, pen, *a, **kw)

        monkeypatch.setattr(mod.UnifiedAligner, "__init__", low)
    path = tmp_path / "long.fa"
    make_test_case(81, 4, 300, MutationConfig(0.03, 0.003, 0.003)).write_fasta(str(path))

    def collect(pkg):
        seqs = pkg.read_fasta(str(path))
        out = []
        pkg.process_alignments_with_callback(
            seqs, pkg.parse_scores("0,5,8,2,24,1"), pkg.NoSparsification(),
            lambda r: out.append(pkg.alignment_to_paf(r, seqs)),
        )
        return sorted(out)

    monkeypatch.setenv("ALLWAVE_PLATFORM", "cpu")
    port = collect(T)
    assert len(port) == 12 and port == collect(R)


def test_cli_long_route_hands_runs_to_the_writer(monkeypatch, tmp_path):
    """The CLI with the long-pair threshold lowered in both packages:
    every long pair reaches the pipeline's emit step as runs, no
    per-base cigar array is built, and the PAF lines equal the
    reference's."""
    import allwave_tpu as R
    from allwave_tpu.testing.synth import MutationConfig, make_test_case
    from allwave_tpu_torch import cli
    from allwave_tpu_torch.engine.pipeline import AllPairAligner

    for mod, seg in ((JE, JS), (TE, TS)):
        init = mod.UnifiedAligner.__init__

        def low(self, pen, *a, _init=init, _seg=seg, **kw):
            kw["dense_max_len"] = 200
            kw["segmented_config"] = _seg.SegmentedConfig(ckpt_every=128)
            _init(self, pen, *a, **kw)

        monkeypatch.setattr(mod.UnifiedAligner, "__init__", low)
    fasta = tmp_path / "long.fa"
    make_test_case(83, 4, 300, MutationConfig(0.03, 0.003, 0.003)).write_fasta(str(fasta))

    emit = AllPairAligner.__dict__["_emit_chunk"].__func__
    kinds = []
    carried = []

    def spy(callback, chunk, revs, aligned, stats):
        kinds.extend(type(r[1]) for r in aligned if r is not None)

        def cb(result):
            carried.append(result.cigar_runs is not None)
            callback(result)

        emit(cb, chunk, revs, aligned, stats)

    monkeypatch.setattr(AllPairAligner, "_emit_chunk", staticmethod(spy))
    monkeypatch.setenv("ALLWAVE_PLATFORM", "cpu")
    paf = tmp_path / "port.paf"
    rc = cli.main(["-i", str(fasta), "-o", str(paf), "-s", "0,5,8,2,24,1", "-p", "none",
                   "--no-progress"])
    # no record failed, and every one reaches the writer carrying runs
    assert rc == 0 and kinds == [tuple] * 12 and carried == [True] * 12

    seqs = R.read_fasta(str(fasta))
    ref = []
    R.process_alignments_with_callback(
        seqs, R.parse_scores("0,5,8,2,24,1"), R.NoSparsification(),
        lambda r: ref.append(R.alignment_to_paf(r, seqs)),
    )
    assert sorted(paf.read_text().splitlines()) == sorted(ref)


# ---------------------------------------------------------------------------
# Rows #3 and #4 of the kernel table, by equivalence to the port's forward
# ---------------------------------------------------------------------------


def _forward_equivalent(forward, layout, scores_str, K, l_pad, div):
    from allwave_tpu.wfa import pallas_dense as JP

    pen = _pen(scores_str)
    ja, ta = _batch(23, 5, (3 * l_pad) // 4, l_pad, div)
    s_p, c_p, p_p = getattr(JP, forward)(*ja, pen, K, l_pad, True, interpret=True)
    s_t, c_t, p_t = TD.dense_forward_ref(*ta, pen, K, l_pad)
    _eq(s_p, s_t)
    _eq(c_p, c_t)
    run_cap = 2 * l_pad + 8
    ref = JD.dense_traceback(p_p, s_p, ja[2], ja[3], pen, run_cap, k_width=K, **layout)
    port = TD.dense_traceback_ref(p_t, s_t, ta[2], ta[3], run_cap)
    for a, b in zip(ref, port):
        _eq(a, b)


@pytest.mark.parametrize(
    "scores_str,K,l_pad,div",
    [("0,5,8,2,24,1", 128, 128, 0.05), ("0,4,6,2", 256, 128, 0.2), ("0,1,1,1", 256, 128, 0.1)],
)
def test_forward_u_matches_port(scores_str, K, l_pad, div):
    """Row #3: the classic-layout Pallas forward at K < 384."""
    _forward_equivalent("_forward_u", {}, scores_str, K, l_pad, div)


@pytest.mark.parametrize(
    "scores_str,K,l_pad,div",
    [("0,5,8,2,24,1", 256, 128, 0.15)],
)
def test_forward_t2_matches_port(scores_str, K, l_pad, div, monkeypatch):
    """Row #4: the opt-in transposed, parity-compressed forward."""
    from allwave_tpu.wfa import pallas_dense as JP

    monkeypatch.setattr(JP, "_T2_DISABLED", False)
    monkeypatch.setattr(JP, "_T_DISABLED", False)
    jax.clear_caches()  # routing is baked into traces
    try:
        _forward_equivalent(
            "_forward_t2", dict(compressed=True, transposed=True), scores_str, K, l_pad, div
        )
    finally:
        jax.clear_caches()


def test_expand_runs_to_cigar_matches_reference():
    from allwave_tpu.wfa.batch import expand_runs_to_cigar

    rng = np.random.RandomState(12)
    ops = rng.choice(np.frombuffer(b"MXID", np.uint8), 9)
    lens = rng.randint(0, 256, 9).astype(np.int64)
    for n in (0, 1, 5, 9):
        np.testing.assert_array_equal(TB.expand_runs_to_cigar(ops, lens, n), expand_runs_to_cigar(ops, lens, n))


@pytest.mark.parametrize("sigma", [0, 900, 16000, 40000])
def test_segmented_band_rules_match_reference(sigma):
    pen = _pen("0,5,8,2,24,1")
    j = JS.SegmentedDenseAligner(pen, JS.SegmentedConfig(impl="xla"))
    t = TS.SegmentedDenseAligner(pen, device="cpu")
    assert t.ladder.rungs == j.K_LADDER and t.ladder.rungs[-1] == t.ladder.k_max == 24576
    assert t.ladder.for_score(sigma, 7) == j._k_for_score(sigma, 7)
    assert t._run_cap(1 << 17) == j._run_cap(1 << 17) == 4096
    for k in (1, 128, 129, 16385, 30000):
        assert t.ladder.round(k) == j._round_k(k)
