"""The schedule of the wavefront span kernel (allwave_tpu_torch/csrc/
wf_span.cu, `wf_span_cluster_kernel`), emulated in plain numpy on the
CPU and held to the JAX reference (allwave_tpu/wfa/wf_segmented.py's XLA
wf_span and the Pallas kernel of allwave_tpu/wfa/pallas_wf.py in
interpret mode) and to the port's plain version `wf_span_ref`.

The kernel itself runs only on the card (tests/test_torch_kernels.py,
chip_smoke.py). What these tests hold is its index algebra: a window of
W lanes split into G blocks of Lb lanes (only the last block short),
each thread holding the lanes tid, tid + nt, ...; each block's ring
slice [plane][lane] with a plane of NULLs for reads below score 0; the
write slot of each component kept incrementally and every read slot one
subtraction and wrap behind it; a block's edge lanes reading the
neighbour block's ring at older slots only (the emulation writes in
place, a block's lane chunks in order and the blocks in alternating
order, so a read of a slot this level writes would show); the warp-
cooperative extension (a lane's own first 8 bases, then the lanes still
matching one at a time by the whole warp, 32 x 8 bases an iteration);
and the sweep's done flag, stamped with its level by the block holding
c_end and read by every block after the level's barrier. The emulation
makes each block's read of a level's flag late, just before the block
runs the next level, so where the owner comes first in a level's order
a block reads the flag after the owner's write of the next level: the
stamp keeps that read from stopping the block a level early.

Every comparison is exact: no tolerance. Inputs come from numpy seeds.
The Pallas route needs a batch that is a multiple of 4 and a band that
is a multiple of 128; the odd windows are held to `wf_span_ref`, which
tests/test_torch_wavefront.py holds to the reference's narrow replay."""

import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from allwave_tpu.core.scores import parse_scores
from allwave_tpu.wfa import pallas_wf as JP
from allwave_tpu.wfa import wf_segmented as JW
from allwave_tpu.wfa.params import resolve_penalties
from allwave_tpu_torch.testing.batches import wavefront_batch
from allwave_tpu_torch.wfa import wf_segmented as TW
from tests.test_torch_wavefront import _ring_rows, _xla_sweep

NULL = TW.NULL
L_PAD, K, C = 512, 256, 32


def _pen(scores_str):
    return resolve_penalties(parse_scores(scores_str))


def _batch(seed, div=0.03):
    """8 pairs (wavefront_batch with 4 mutated ones): then an identical
    pair (done at score 0, a run across the warp's 256 bases to qlen), a
    pair with tlen == l_pad (runs to l_pad), an infeasible one and a
    short one (h_max = -1 on most of its band)."""
    arrays = wavefront_batch(np.random.RandomState(seed), L_PAD, K, div, 4)
    return arrays, tuple(map(jnp.asarray, arrays)), tuple(map(torch.from_numpy, arrays))


# ---------------------------------------------------------------------------
# The emulation
# ---------------------------------------------------------------------------


def _first_stop8(qp, tp, v, p, n):
    """Per element: the index of the first differing byte of q[v..v+8)
    and t[p..p+8) if it is below n, else 8 (qp, tp padded with zeros
    past l_pad, as the kernel's load8 reads them)."""
    r8 = np.arange(8)
    diff = qp[v[:, None] + r8] != tp[p[:, None] + r8]
    i = np.where(diff.any(1), diff.argmax(1), 8)
    return np.where(i < n, i, 8)


def _extend_warp(act, h, hm, k, qp, tp, qlen, tlen, l_pad):
    """`extend_warp` for the 32 lanes of one warp (arrays of 32)."""
    ext = act & (h > NULL) & (h <= hm)
    p = np.clip(h, 0, l_pad - 1)
    hi = np.minimum(tlen, qlen + k)
    pos = np.where(ext, p, h)
    inr = ext & (p >= np.maximum(k, 0)) & (p < hi)
    i = np.full(32, 8)
    j = np.nonzero(inr)[0]
    i[j] = _first_stop8(qp, tp, p[j] - k[j], p[j], np.minimum(hi[j] - p[j], 8))
    pos = np.where(inr & (i < 8), p + i, pos)
    pos = np.where(inr & (i == 8) & (hi - p <= 8), hi, pos)
    lane = np.arange(32)
    for src in np.nonzero(inr & (i == 8) & (hi - p > 8))[0]:
        pp, kk, hh = p[src] + 8, k[src], hi[src]
        found = hh
        while True:
            base = pp + 8 * lane
            ok = base < hh
            ii = np.full(32, 8)
            ii[ok] = _first_stop8(qp, tp, base[ok] - kk, base[ok], np.minimum(hh - base[ok], 8))
            hit = np.nonzero(ii < 8)[0]
            if hit.size:
                found = base[hit[0]] + ii[hit[0]]
                break
            pp += 256
            if pp >= hh:
                break
        pos[src] = found
    return np.where(ext & (pos > hm), hm, pos)


def _back(w, back, d):
    r = w - back
    return r + d if r < 0 else r


def _cluster_span(q, t, qlen, tlen, pen, W, s_lo, n_steps, ring, G, nt, history,
                  done=False, score=-1, col0=0):
    """One pair's cluster over n_steps levels from its (P, K) ring image:
    the sweep's (ckpts (n_steps / C, P, K), done, score), or the history
    planes (n_steps, 5, W) of the window [col0, col0 + W)."""
    offs, deps, P = TW.ring_layout(pen)
    two = pen.two_piece
    Lb = -(-W // G)
    assert -(-W // Lb) == G, "every block holds lanes"
    assert nt % 32 == 0
    lpt = -(-Lb // nt)
    n = [min(Lb, W - r * Lb) for r in range(G)]
    k_end = tlen - qlen
    k0 = min(k_end, 0) - ((K - 1 - abs(k_end)) >> 1)
    c_end = min(max(k_end - k0, 0), K - 1)
    feasible = abs(k_end) <= K - 1
    owner = min(c_end // Lb, G - 1)
    qp = np.concatenate([q.astype(np.int64), np.zeros(16, np.int64)])
    tp = np.concatenate([t.astype(np.int64), np.zeros(16, np.int64)])

    rings = np.full((G, P + 1, Lb), -7, np.int64)  # -7: never read
    ck = None if history else np.full((n_steps // C, P, K), NULL, np.int64)
    for r in range(G):
        cols = col0 + r * Lb + np.arange(n[r])
        rings[r, :P, : n[r]] = ring[:, cols]
        if not two:
            rings[r, offs[3] : P] = NULL
        rings[r, P] = NULL
        if not history:
            ck[0][:, cols] = ring[:, cols]
    hist = None if not history else np.full((n_steps, 5, W), -9, np.int64)
    flag = NULL  # the owner's flag: the level it finished at
    bdone, bscore = [done] * G, [score] * G  # each block's view
    levels = [0] * G  # levels each block ran
    unread = [None] * G  # the level whose flag a block has yet to read
    dm, d1, d2 = deps[0], deps[1], deps[3]
    wm, w1, w2 = (s_lo + 1) % dm, (s_lo + 1) % d1, (s_lo + 1) % d2
    ck_left, ck_slot = C, 0
    o1e1, o2e2 = pen.o1 + pen.e1, pen.o2 + pen.e2

    def read_flag(r):
        # a block's read of the owner's flag after a level's barrier
        if unread[r] is not None and flag == unread[r]:
            bdone[r], bscore[r] = True, unread[r]
        unread[r] = None

    for j in range(n_steps):
        if not history and all(bdone):
            break
        s = s_lo + 1 + j
        ck_now = not history and ck_left == 0
        if ck_now:
            ck_slot, ck_left = ck_slot + 1, C
        pmo1 = offs[0] + _back(wm, o1e1, dm) if s >= o1e1 else P
        pmx = offs[0] + _back(wm, pen.x, dm) if s >= pen.x else P
        pi1 = offs[1] + _back(w1, pen.e1, d1) if s >= pen.e1 else P
        pd1 = offs[2] + _back(w1, pen.e1, d1) if s >= pen.e1 else P
        if two:
            pmo2 = offs[0] + _back(wm, o2e2, dm) if s >= o2e2 else P
            pi2 = offs[3] + _back(w2, pen.e2, d2) if s >= pen.e2 else P
            pd2 = offs[4] + _back(w2, pen.e2, d2) if s >= pen.e2 else P
        order = range(G) if j % 2 == 0 else range(G - 1, -1, -1)
        for r in order:
            read_flag(r)  # late: other blocks may have run this level
            if not history and bdone[r]:
                continue
            levels[r] += 1
            if ck_now:
                ck[ck_slot][:, r * Lb : r * Lb + n[r]] = rings[r, :P, : n[r]]
            kb = k0 + col0 + r * Lb

            def nb(plane, side, c, inn):
                # lane c + side: this block's, the neighbour block's edge
                # lane at a block's ends, NULL past the window
                cc = c + side
                vals = np.full(c.shape, NULL, np.int64)
                here = inn & (cc >= 0) & (cc < n[r])
                vals[here] = rings[r, plane, cc[here]]
                if side < 0 and r > 0:
                    vals[inn & (c == 0)] = rings[r - 1, plane, Lb - 1]
                if side > 0 and r < G - 1:
                    vals[inn & (c == n[r] - 1)] = rings[r + 1, plane, 0]
                return vals

            for it in range(lpt):
                c = it * nt + np.arange(nt)
                inn = c < n[r]
                cs = np.minimum(c, Lb - 1)
                k = kb + c
                hm = np.where(inn & (k >= -qlen) & (k <= tlen), np.minimum(tlen, qlen + k), -1)

                def trim(a):
                    return np.where(a > hm, NULL, a)

                def plus1(a):
                    return np.where(a > NULL, a + 1, NULL)

                i1 = trim(plus1(np.maximum(nb(pmo1, -1, c, inn), nb(pi1, -1, c, inn))))
                d1v = trim(np.maximum(nb(pmo1, 1, c, inn), nb(pd1, 1, c, inn)))
                best = np.maximum(i1, d1v)
                i2 = d2v = np.full(nt, NULL, np.int64)
                if two:
                    i2 = trim(plus1(np.maximum(nb(pmo2, -1, c, inn), nb(pi2, -1, c, inn))))
                    d2v = trim(np.maximum(nb(pmo2, 1, c, inn), nb(pd2, 1, c, inn)))
                    best = np.maximum(best, np.maximum(i2, d2v))
                mis = trim(plus1(np.where(inn, rings[r, pmx, cs], NULL)))
                h = np.where(inn, np.maximum(best, mis), NULL)
                m = np.concatenate([
                    _extend_warp(inn[w : w + 32], h[w : w + 32], hm[w : w + 32], k[w : w + 32],
                                 qp, tp, qlen, tlen, L_PAD)
                    for w in range(0, nt, 32)
                ])
                m = trim(m)
                ci = c[inn]
                rings[r, offs[0] + wm, ci] = m[inn]
                rings[r, offs[1] + w1, ci] = i1[inn]
                rings[r, offs[2] + w1, ci] = d1v[inn]
                if two:
                    rings[r, offs[3] + w2, ci] = i2[inn]
                    rings[r, offs[4] + w2, ci] = d2v[inn]
                if history:
                    hist[j][:, r * Lb + ci] = np.stack([m, i1, d1v, i2, d2v])[:, inn]
                elif feasible and r == owner:
                    at_end = inn & (r * Lb + c == c_end) & (m == tlen)
                    if at_end.any():
                        flag = s
            if not history:
                unread[r] = s  # read after the barrier: see read_flag
        wm = 0 if wm + 1 == dm else wm + 1
        w1 = 0 if w1 + 1 == d1 else w1 + 1
        w2 = 0 if w2 + 1 == d2 else w2 + 1
        ck_left -= 1
    if history:
        return hist
    for r in range(G):
        read_flag(r)
    # all blocks leave at one level, with one view of done and score
    assert len(set(zip(bdone, bscore, levels))) == 1, (bdone, bscore, levels)
    return ck, bdone[0], bscore[0]


def _cluster_sweep(arrays, pen, n_steps, G, nt, seeds, done0, scores0):
    """The emulated sweep over a batch: (ckpts (n_ck, P, B, K), done,
    scores) as numpy arrays."""
    qs, ts, ql, tl = arrays
    out = [
        _cluster_span(qs[b], ts[b], int(ql[b]), int(tl[b]), pen, K, 0, n_steps, seeds[:, b],
                      G, nt, False, bool(done0[b]), int(scores0[b]))
        for b in range(qs.shape[0])
    ]
    return (np.stack([o[0] for o in out], 2), np.array([o[1] for o in out]),
            np.array([o[2] for o in out]))


def _cluster_history(arrays, pen, s_lo, ring, G, nt, W=K, c_lo=None):
    """The emulated history span over a batch: (n_steps, 5, B, W)."""
    qs, ts, ql, tl = arrays
    return np.stack([
        _cluster_span(qs[b], ts[b], int(ql[b]), int(tl[b]), pen, W, s_lo, C, ring[:, b], G, nt,
                      True, col0=0 if c_lo is None else int(min(max(c_lo[b], 0), K - W)))
        for b in range(qs.shape[0])
    ], 2)


# ---------------------------------------------------------------------------
# The pieces: slot counters and the extension
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scores_str", ["0,5,8,2,24,1", "0,4,6,2", "0,1,1,1"])
def test_slot_counters_match_modulo(scores_str):
    """The write slot kept incrementally from (s_lo + 1) % depth, and
    each lookback's read slot one subtraction and wrap behind it, equal
    the ring's s % depth indexing at every level of a long span, and no
    lookback reads the slot its level writes."""
    pen = _pen(scores_str)
    offs, deps, _ = TW.ring_layout(pen)
    looks = {0: [pen.x, pen.o1 + pen.e1] + ([pen.o2 + pen.e2] if pen.two_piece else []),
             1: [pen.e1], 2: [pen.e1]}
    if pen.two_piece:
        looks.update({3: [pen.e2], 4: [pen.e2]})
    for s_lo in (0, 37, 256):
        w = [(s_lo + 1) % d for d in deps]
        for s in range(s_lo + 1, s_lo + 300):
            for ci, lbs in looks.items():
                assert w[ci] == s % deps[ci]
                for lb in lbs:
                    assert 1 <= lb < deps[ci]
                    assert _back(w[ci], lb, deps[ci]) == (s - lb) % deps[ci] != w[ci]
            w = [0 if x + 1 == d else x + 1 for x, d in zip(w, deps)]


def test_warp_extension_matches_extend_bm():
    """The warp-cooperative extension equals _extend_bm (the reference's
    and the port's) on offsets that cover NULL, h > h_max, the h_max = -1
    diagonals, every offset up to l_pad, the tlen == l_pad pair, runs of
    the identical pair across many warp iterations to qlen, and runs of a
    pair with a SNP that end inside a warp iteration, at its first base
    and at its last."""
    arrays, _, _ = _batch(3, div=0.05)
    q = np.random.RandomState(5).choice(np.frombuffer(b"ACGT", np.uint8), 500)
    t = q.copy()
    t[[300, 307]] ^= 2  # two SNPs: 1 of the 4 bases to another
    qs, ts = (np.concatenate([a, np.pad(x, (0, L_PAD - 500))[None]]) for a, x in ((arrays[0], q), (arrays[1], t)))
    ql, tl = (np.append(a, np.int32(500)) for a in arrays[2:])
    arrays = (qs, ts, ql, tl)
    ja, ta = tuple(map(jnp.asarray, arrays)), tuple(map(torch.from_numpy, arrays))
    _, k0_t = TW._band_geometry(ta[2], ta[3], K)
    _, hmax_t = TW._make_masks(ta[2], ta[3], k0_t, K)
    mmw_j, nxw_j = JW.build_mismatch_index(*ja, jnp.asarray(k0_t.numpy()), K)
    mmw_t, nxw_t = TW.build_mismatch_index(*ta, k0_t, K)
    hmax = hmax_t.numpy().astype(np.int64)
    rng = np.random.RandomState(4)
    for trial in range(3):
        h = rng.randint(-3, L_PAD + 3, hmax.shape).astype(np.int64)
        h[rng.rand(*h.shape) < 0.1] = NULL
        h[:, ::7] = hmax[:, ::7]
        h[:, 3::7] = hmax[:, 3::7] + 1
        if trial == 0:
            h[:, 100:140] = 0  # diagonal 0 of the identical pair: a run to qlen
        # diagonal 0 (column 127) of the SNP pair: the run stops at 300
        # inside the warp's second iteration (from 30), at its first base
        # (from 36) or at the first iteration's last base (from 37)
        h[8, 127] = (30, 36, 37)[trial]
        ref_j = np.asarray(JW._extend_bm(jnp.asarray(h.astype(np.int32)), jnp.asarray(hmax_t.numpy()),
                                         mmw_j, nxw_j, L_PAD))
        ref_t = TW._extend_bm(torch.from_numpy(h.astype(np.int32)), hmax_t, mmw_t, nxw_t, L_PAD)
        np.testing.assert_array_equal(ref_j, ref_t.numpy())
        for b in range(qs.shape[0]):
            qp = np.concatenate([qs[b].astype(np.int64), np.zeros(16, np.int64)])
            tp = np.concatenate([ts[b].astype(np.int64), np.zeros(16, np.int64)])
            k = int(k0_t[b]) + np.arange(K)
            got = np.concatenate([
                _extend_warp(np.ones(32, bool), h[b, w : w + 32], hmax[b, w : w + 32],
                             k[w : w + 32], qp, tp, int(ql[b]), int(tl[b]), L_PAD)
                for w in range(0, K, 32)
            ])
            np.testing.assert_array_equal(got, ref_j[b])
    assert (hmax == -1).any() and (hmax == L_PAD).any()


# ---------------------------------------------------------------------------
# The sweep and the history span
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "scores_str,G,nt,pallas",
    [
        ("0,5,8,2,24,1", 3, 32, True),   # Lb 86, a short last block of 84, 3 lanes a thread
        ("0,5,8,2", 2, 64, True),        # one-piece: I2, D2 stay NULL
        ("0,1,1,1", 5, 32, False),       # Lb 52, a short last block of 48
        ("0,5,8,2,24,1", 1, 128, False),  # one block, no neighbours
    ],
)
def test_cluster_sweep_schedule_matches_reference(scores_str, G, nt, pallas):
    """The emulated sweep gives the scores, done and every checkpoint slot
    of wf_span_ref, of the XLA wf_span loop (every slot a pair's sweep
    wrote equals the reference's ring image there, later slots NULL) and,
    where marked, the scores, done and every slot a pair's sweep wrote of
    the Pallas sweep in interpret mode."""
    pen = _pen(scores_str)
    N = 256
    arrays, ja, ta = _batch(7)
    init = TW.wf_init(*ta, pen, K)
    ck_e, d_e, s_e = _cluster_sweep(arrays, pen, N, G, nt, init.seeds.numpy(),
                                    init.done0.numpy(), init.scores0.numpy())
    ck_p, _, d_p, s_p = TW.wf_span_ref(*ta, pen, K, L_PAD, 0, N, init.seeds, False, ckpt_every=C,
                                       done=init.done0, scores=init.scores0)
    np.testing.assert_array_equal(s_e, s_p.numpy())
    np.testing.assert_array_equal(d_e, d_p.numpy())
    np.testing.assert_array_equal(ck_e, ck_p.numpy())
    s_x, d_x, rings, _ = _xla_sweep(ja, pen, K, N, C)
    np.testing.assert_array_equal(s_e, s_x)
    np.testing.assert_array_equal(d_e, d_x)
    assert d_e[4] and s_e[4] == 0 and not d_e[6] and d_e[:6].all()
    last = [max((int(s_x[b]) - 1) // C, 0) if d_x[b] else N // C - 1 for b in range(8)]
    for b in range(8):
        for j in range(N // C):
            if j <= last[b]:
                np.testing.assert_array_equal(ck_e[j, :, b], rings[j][:, b])
            else:
                assert (ck_e[j, :, b] == NULL).all()
    if pallas:
        # the Pallas sweep runs a tile of pairs until all are done, so a
        # pair done early has later slots there too (the engine reads none)
        mmt, hmax_r, cmask_r, feas, seeds, done0, scores0, _, _ = JP.wf_init_rows(*ja, pen, K, JP._WS)
        cks, d_j, s_j = JP.wf_sweep_pallas(mmt, hmax_r, cmask_r, ja[3], feas, seeds, done0, scores0,
                                           pen, K, L_PAD, N, C, interpret=True)
        np.testing.assert_array_equal(s_e, np.asarray(s_j))
        np.testing.assert_array_equal(d_e, np.asarray(d_j) != 0)
        ck_j = TW.rows_to_port(cks, K)
        for b in range(8):
            np.testing.assert_array_equal(ck_e[: last[b] + 1, :, b], ck_j[: last[b] + 1, :, b])


@pytest.mark.parametrize(
    "scores_str,G,nt,pallas",
    [("0,5,8,2,24,1", 2, 64, True), ("0,5,8,2", 3, 32, False), ("0,1,1,1", 5, 32, False)],
)
def test_cluster_history_schedule_matches_reference(scores_str, G, nt, pallas):
    """A full-band history span from the reference's ring image at a
    segment boundary: all five planes of every level equal the XLA
    wf_span's history, wf_span_ref's and, where marked, the Pallas
    history span's in interpret mode."""
    pen = _pen(scores_str)
    arrays, ja, ta = _batch(9, div=0.06)
    _, _, rings, hists = _xla_sweep(ja, pen, K, 3 * C, C, with_history=True)
    seg = 2
    h_e = _cluster_history(arrays, pen, seg * C, rings[seg], G, nt)
    np.testing.assert_array_equal(h_e, hists[seg])
    _, h_p, _, _ = TW.wf_span_ref(*ta, pen, K, L_PAD, seg * C, C, torch.from_numpy(rings[seg]), True)
    np.testing.assert_array_equal(h_e, h_p.numpy())
    if pallas:
        mmt, hmax_r, cmask_r, feas, *_ = JP.wf_init_rows(*ja, pen, K, JP._WS)
        h_j = JP.wf_hist_span_pallas(mmt, hmax_r, cmask_r, ja[3], feas, jnp.int32(seg * C),
                                     _ring_rows(rings[seg], pen), pen, K, L_PAD, C, interpret=True)
        np.testing.assert_array_equal(h_e, np.stack([np.asarray(h_j[c]) for c in TW._COMPS], 1))


@pytest.mark.parametrize("scores_str,G,k_sub", [("0,5,8,2,24,1", 3, 201), ("0,5,8,2", 5, 201),
                                                 ("0,1,1,1", 2, 129)])
def test_cluster_history_sub_band_matches_plain(scores_str, G, k_sub):
    """A history span on an odd sub-band of each pair's band at per-pair
    offsets (0, odd ones and K - k_sub): every plane entry equals wf_span_ref's, whose sub-band
    replay tests/test_torch_wavefront.py holds to the reference's narrow
    replay."""
    pen = _pen(scores_str)
    arrays, _, ta = _batch(11, div=0.05)
    init = TW.wf_init(*ta, pen, K)
    ck, _, _, _ = TW.wf_span_ref(*ta, pen, K, L_PAD, 0, 2 * C, init.seeds, False, ckpt_every=C,
                                 done=init.done0, scores=init.scores0)
    c_lo = np.array([0, 1, 27, K - k_sub, 13, 40, K - k_sub, 3], np.int32)
    seg = 1
    h_e = _cluster_history(arrays, pen, seg * C, ck[seg].numpy(), G, 32, W=k_sub, c_lo=c_lo)
    _, h_p, _, _ = TW.wf_span_ref(*ta, pen, K, L_PAD, seg * C, C, ck[seg], True,
                                  c_lo=torch.from_numpy(c_lo), k_sub=k_sub)
    np.testing.assert_array_equal(h_e, h_p.numpy())


# ---------------------------------------------------------------------------
# The level split's inputs (allwave_tpu_torch/probes/wf_level_split.py)
# ---------------------------------------------------------------------------


def test_level_split_inputs():
    """The tandem-repeat pair is (AC)^n against itself with ~0.25% SNPs
    to G or T on the target, so even diagonals match between SNPs; the
    random pair is of the lengths asked for."""
    from allwave_tpu_torch.probes import wf_level_split as WL

    rng = np.random.RandomState(15)
    q, t = (np.frombuffer(x, np.uint8) for x in WL.repeat_pair(rng, 20_000, 20_100))
    assert len(q) == 20_000 and len(t) == 20_100
    assert (q[::2] == ord("A")).all() and (q[1::2] == ord("C")).all()
    snp = t[:20_000] != q
    assert 20 < snp.sum() < 80 and set(t[:20_000][snp].tolist()) <= {ord("G"), ord("T")}
    assert not np.isin(t[2:20_000][~snp[2:]], [ord("G"), ord("T")]).any()
    qr, tr = WL.random_pair(rng, 300, 301)
    assert len(qr) == 300 and len(tr) == 301 and set(qr) <= set(b"ACGT")


@pytest.mark.parametrize("argv,why", [([], "no CUDA card"), (["--root", "/nonexistent"], "not")])
def test_level_split_refuses(argv, why, monkeypatch):
    """Without a card, or asked for a tree other than the one its package
    was imported from in this process, the level split exits with why."""
    from allwave_tpu_torch.probes import wf_level_split as WL

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "path", list(sys.path))
    with pytest.raises(SystemExit, match=why):
        WL.main(argv)
