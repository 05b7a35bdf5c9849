"""A plain emulation of csrc/wf_batch.cu's ring forward (the block and
cluster designs of `wf_batch_ring_kernel`), for the CPU tests. Not a
test module.

Per pair, the band's K lanes are split into G blocks of Lb = ceil(K / G)
lanes (the last one short). Each block keeps compact rings
[rows][Lb + 2]: M a ring of D = max lookback + 1 rows, I1 and D1 of
e1 + 1, I2 and D2 (two-piece) of e2 + 1, each row its lanes between two
NULL slots, all NULL at the start. Level s writes slot s % depth of each
ring, kept incrementally, and reads the slot `back` levels behind by one
subtraction and wrap; a block's edge lane reads the neighbour block's
edge lane of that slot (the left block's index Lb, the right block's
index 1). The lane holding c_end stamps its block's flag with the level
it reached (tlen, k_end) at; every block reads the flag of that block
before a level and stops on a stamp below it. History rows are written
for the levels run and left unwritten (UNSET) above. The lanes the
kernel skips (a diagonal k != 0 with min open + min extend x |k| above
the level, or off the matrix) are asserted to hold no value.
"""

from __future__ import annotations

import numpy as np

NULL = -(2**30)
UNSET = -7  # a history entry the kernel leaves unwritten
COMPS = ("m", "i1", "d1", "i2", "d2")


def ring_layout(pen):
    """(depths, offsets, rows) of the compact rings, in COMPS order."""
    D = pen.max_lookback + 1
    d1 = pen.e1 + 1
    d2 = pen.e2 + 1 if pen.two_piece else 0
    depths = (D, d1, d1, d2, d2)
    offsets = tuple(int(x) for x in np.cumsum((0,) + depths[:-1]))
    return depths, offsets, sum(depths)


def _extend(q, t, qlen, tlen, k, h, hm):
    """Per lane: h advanced along matching bases, at most to hm."""
    out = h.copy()
    for i in np.nonzero((h > NULL) & (h < hm))[0]:
        hi, n = int(h[i]), int(hm[i] - h[i])
        v = hi - int(k[i])
        eq = q[v : v + n] == t[hi : hi + n]
        out[i] = hi + (n if eq.all() else int(np.argmin(eq)))
    return out


def ring_forward(qs, ts, qlens, tlens, pen, s_cap: int, K: int, G: int, with_history: bool):
    """scores (B,) int32 (-1 unfinished), done (B,) bool and, with
    history, a dict comp -> (s_cap + 1, B, K) int32 (UNSET where the
    kernel writes nothing), as the kernel computes them with G blocks a
    pair (G = 1: the block design)."""
    B = qs.shape[0]
    depths, offs, rows = ring_layout(pen)
    Lb = -(-K // G)
    G = -(-K // Lb)  # blocks, as the dispatch recounts them
    S = Lb + 2
    x, o1e1, e1 = pen.x, pen.o1 + pen.e1, pen.e1
    o2e2, e2 = pen.o2 + pen.e2, pen.e2
    gap0 = min(pen.o1, pen.o2) if pen.two_piece else pen.o1
    gmin = min(pen.e1, pen.e2) if pen.two_piece else pen.e1
    scores = np.full(B, -1, np.int32)
    done = np.zeros(B, bool)
    hist = {c: np.full((s_cap + 1, B, K), UNSET, np.int32) for c in COMPS} if with_history else None
    for b in range(B):
        qlen, tlen = int(qlens[b]), int(tlens[b])
        q, t = qs[b, :qlen], ts[b, :tlen]
        k_end = tlen - qlen
        k0 = min(0, k_end) - (K - 1 - abs(k_end)) // 2
        c_end = min(max(k_end - k0, 0), K - 1)
        feasible = abs(k_end) <= K - 1
        rings = [np.full((rows, S), NULL, np.int64) for _ in range(G)]
        stamps = [2**31 - 1] * G
        owner = min(c_end // Lb, G - 1)
        lanes = []
        for r in range(G):
            n_r = min(Lb, K - r * Lb)
            k = k0 + r * Lb + np.arange(n_r)
            hm = np.where((k >= -qlen) & (k <= tlen), np.minimum(tlen, qlen + k), -1)
            lanes.append((n_r, k, hm))

        def out(r, s, vals):
            n_r = lanes[r][0]
            if with_history:
                for c, v in zip(COMPS, vals):
                    hist[c][s, b, r * Lb : r * Lb + n_r] = v
            end = c_end - r * Lb
            if feasible and 0 <= end < n_r and vals[0][end] == tlen:
                stamps[r] = s

        # score 0
        for r in range(G):
            n_r, k, hm = lanes[r]
            m = _extend(q, t, qlen, tlen, k, np.where(k == 0, 0, NULL), hm)
            m = np.where(m > hm, NULL, m)
            rings[r][offs[0], 1 : n_r + 1] = m
            out(r, 0, [m] + [np.full(n_r, NULL)] * 4)
        w = [0] * 5
        for s in range(1, s_cap + 1):
            if stamps[owner] < s:
                break
            w = [(wi + 1) % d if d else 0 for wi, d in zip(w, depths)]

            def row(comp, back):
                d = depths[comp]
                return offs[comp] + (w[comp] - back) % d

            new = []
            for r in range(G):
                n_r, k, hm = lanes[r]
                ring = rings[r]
                # lane c - 1 at index c, lane c + 1 at index c + 2, the
                # block's edge lanes from the neighbours' rings
                left = ring[:, 0 : n_r].copy()
                right = ring[:, 2 : n_r + 2].copy()
                if r > 0:
                    left[:, 0] = rings[r - 1][:, Lb]
                if r < G - 1:
                    right[:, n_r - 1] = rings[r + 1][:, 1]

                def plus1(a):
                    return np.where(a > NULL, a + 1, NULL)

                def trim(a):
                    return np.where(a > hm, NULL, a)

                i1 = trim(plus1(np.maximum(left[row(0, o1e1)], left[row(1, e1)])))
                d1 = trim(np.maximum(right[row(0, o1e1)], right[row(2, e1)]))
                best = np.maximum(i1, d1)
                i2 = d2 = np.full(n_r, NULL)
                if pen.two_piece:
                    i2 = trim(plus1(np.maximum(left[row(0, o2e2)], left[row(3, e2)])))
                    d2 = trim(np.maximum(right[row(0, o2e2)], right[row(4, e2)]))
                    best = np.maximum(best, np.maximum(i2, d2))
                m = np.maximum(best, trim(plus1(ring[row(0, x), 1 : n_r + 1])))
                m = trim(_extend(q, t, qlen, tlen, k, m, hm))
                # the lanes the kernel skips (off the matrix, or farther
                # from diagonal 0 than s pays for) must hold no value
                dead = (hm < 0) | ((k != 0) & (gap0 + gmin * np.abs(k) > s))
                for v in (m, i1, d1, i2, d2):
                    assert (v[dead] == NULL).all(), (b, r, s)
                new.append((m, i1, d1, i2, d2))
            for r in range(G):
                n_r = lanes[r][0]
                for comp, v in enumerate(new[r]):
                    if depths[comp]:
                        rings[r][offs[comp] + w[comp], 1 : n_r + 1] = v
                out(r, s, new[r])
        if stamps[owner] <= s_cap:
            scores[b] = stamps[owner]
            done[b] = True
    return scores, done, hist
