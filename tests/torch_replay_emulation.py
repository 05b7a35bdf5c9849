"""Plain emulations of the thread-block-cluster schedules of
csrc/dense_span.cu's replay (`replay_clusters`) and of the dense
forward's tier 3, which launches that replay from the origin
(`dense_forward_clusters`): the index algebra of a kernel that runs only
on the card, held on the CPU to the plain versions and to the JAX
package by tests/test_torch_segmented.py and
tests/test_torch_forward_cluster.py."""

import torch

from allwave_tpu_torch.wfa import dense as TD
from allwave_tpu_torch.wfa.dense import INF


def replay_clusters(qs, ts, qlens, tlens, pen, K, l_pad, d_lo, n_steps, state, nw, lpt,
                    c_lo=None, k_sub=None, warp=32, stretch=32):
    """A plain emulation of csrc/dense_span.cu's replay schedule
    (`dense_replay_cluster_kernel`), to hold its index algebra on the CPU:
    the window of W lanes split into G blocks of Lb = nw warps x `warp`
    threads x lpt lanes (only the last block short), thread j of a block
    holding lanes j lpt .. j lpt + lpt - 1 of S, I1, D1, I2, D2 and the
    run band; a register's neighbour in the next thread by shuffle, at a
    warp's ends from a double-buffered halo (a warp's last lane's S, I1,
    I2 and first lane's S, D1, D2 after each step), the left and right
    block's halos at a block's ends, INF past the window; the registers
    of the step's parity M = (d - kb) & 1 inside [lo, hi] move; every
    register's plane entry is computed before any register takes its new
    value; the bases come from tables staged every `stretch` steps (the
    kernel's SW_STRETCH is 4096) and read at (x >> 1) + floor((M - i) / 2)
    and (y >> 1) + floor((M + i) / 2). A narrow `warp` keeps the shapes
    small. A state of None is the origin state (S = 0 at k = 0, every
    other entry INF: the forward's tier 3 from d_lo = 0). Returns
    ((5, B, W) state, (n_steps, B, W) uint16 planes, G)."""
    i64 = torch.int64
    W = K if c_lo is None else k_sub
    B = qs.shape[0]
    T = nw * warp
    Lb = T * lpt
    G = -(-W // Lb)
    two = pen.two_piece
    qlens, tlens = qlens.to(i64), tlens.to(i64)
    k_end = tlens - qlens
    k0 = torch.minimum(k_end, torch.zeros_like(k_end)) - torch.div(K - 1 - k_end.abs(), 2, rounding_mode="floor")
    k0 = k0 - (k0 & 1)
    col0 = torch.zeros_like(k0) if c_lo is None else c_lo.to(i64).clamp(0, K - W)
    r_ = torch.arange(G)[None, :, None]
    t_ = torch.arange(T)[None, None, :]
    i_ = torch.arange(lpt)
    kb = (k0 + col0)[:, None] + torch.arange(G)[None, :] * Lb  # (B, G)
    c0 = r_ * Lb + t_ * lpt  # (1, G, T): the window column of register 0
    kt = kb[:, :, None] + t_ * lpt  # (B, G, T)
    nin = W - c0
    col = c0[..., None] + i_  # (1, G, T, lpt)
    inside = (col < W).expand(B, G, T, lpt)
    col = col.expand(B, G, T, lpt)
    src = (col0[:, None, None, None] + col).clamp(max=K - 1)
    rows = torch.arange(B)[:, None, None, None].expand(B, G, T, lpt)
    if state is None:
        k = kt[..., None] + i_
        regs = [torch.where(inside & (k == 0), 0, INF)] + [torch.full_like(k, INF)] * 4
    else:
        regs = [torch.where(inside, state[band][rows, src].to(i64), INF) for band in range(5)]
    run = torch.zeros((B, G, T, lpt), dtype=i64)
    ql4, tl4 = qlens[:, None, None], tlens[:, None, None]

    def write_halo(buf, halo):
        S, I1, D1, I2, D2 = regs
        last = lambda a: a[:, :, warp - 1::warp, lpt - 1]  # noqa: E731
        first = lambda a: a[:, :, ::warp, 0]  # noqa: E731
        inf = torch.full_like(last(S), INF)
        halo[buf] = torch.stack([last(S), last(I1), last(I2) if two else inf,
                                 first(S), first(D1), first(D2) if two else inf], -1)

    halo = torch.full((2, B, G, nw, 6), -7, dtype=i64)  # -7: never read
    write_halo(0, halo)
    planes = torch.empty((n_steps, B, W), dtype=torch.int64)
    lane0, lane_last = (t_ % warp == 0).expand(B, G, T), (t_ % warp == warp - 1).expand(B, G, T)
    for s in range(n_steps):
        d = d_lo + 1 + s
        if s % stretch == 0:
            tbl = (stretch + Lb) // 2 + 2
            vmin = (d - kb - (Lb - 1)) >> 1
            hmin = (d + kb) >> 1
            ii = torch.arange(tbl)
            qi = (qlens[:, None, None] - (vmin[..., None] + ii)).clamp(0, l_pad - 1)
            qt = torch.gather(qs.long()[:, None, :].expand(B, G, l_pad), 2,
                              (qlens[:, None, None] - 1 - qi).clamp(0, l_pad - 1))
            tt = torch.gather(ts.long()[:, None, :].expand(B, G, l_pad), 2,
                              (hmin[..., None] + ii - 1).clamp(0, l_pad - 1))
        M = (d - kb) & 1
        assert bool((M == M[:, :1]).all()), "Lb even: one parity moves in every block"
        cur = halo[s & 1]
        inf3 = torch.full((B, 1, 3), INF, dtype=i64)
        # a warp's left neighbour: the warp before, or the left block's
        # last warp; its right neighbour: the warp after, or the right
        # block's first warp
        left_h = torch.cat([torch.cat([inf3, cur[:, :-1, nw - 1, 0:3]], 1)[:, :, None],
                            cur[:, :, :-1, 0:3]], 2)  # (B, G, nw, 3)
        right_h = torch.cat([cur[:, :, 1:, 3:6],
                             torch.cat([cur[:, 1:, 0, 3:6], inf3], 1)[:, :, None]], 2)
        wl = (t_ // warp).expand(B, G, T)
        S, I1, D1, I2, D2 = regs

        def from_left(a, x):  # shuffle up a thread, the halo at lane 0
            up = torch.roll(a[..., lpt - 1], 1, dims=2)
            return torch.where(lane0, torch.gather(left_h[..., x], 2, wl), up)

        def from_right(a, x):  # shuffle down a thread, the halo at the warp's last lane
            down = torch.roll(a[..., 0], -1, dims=2)
            return torch.where(lane_last, torch.gather(right_h[..., x], 2, wl), down)

        def left_of(a, x):
            return torch.cat([from_left(a, x)[..., None], a[..., :-1]], -1)

        def right_of(a, x):
            return torch.cat([a[..., 1:], from_right(a, x - 3)[..., None]], -1)

        s_km1, s_kp1 = left_of(S, 0), right_of(S, 3)
        i1e, i1o = left_of(I1, 1) + pen.e1, s_km1 + (pen.o1 + pen.e1)
        d1e, d1o = right_of(D1, 4) + pen.e1, s_kp1 + (pen.o1 + pen.e1)
        i1n, d1n = torch.minimum(i1o, i1e), torch.minimum(d1o, d1e)
        if two:
            i2e, i2o = left_of(I2, 2) + pen.e2, s_km1 + (pen.o2 + pen.e2)
            d2e, d2o = right_of(D2, 5) + pen.e2, s_kp1 + (pen.o2 + pen.e2)
            i2n, d2n = torch.minimum(i2o, i2e), torch.minimum(d2o, d2e)
            bi, bd = torch.minimum(i1n, i2n), torch.minimum(d1n, d2n)
            best = torch.minimum(bi, bd)
            code = torch.where(bi <= bd, torch.where(i1n <= i2n, 2, 3), torch.where(d1n <= d2n, 4, 5))
            i2x, d2x = (i2e <= i2o).long(), (d2e <= d2o).long()
        else:
            best = torch.minimum(i1n, d1n)
            code = torch.where(i1n <= d1n, 2, 4)
            i2x = d2x = 0
        x, y = d - kt, d + kt
        Mr = M[:, :, None, None]
        v = (x >> 1)[..., None] - vmin[:, :, None, None] + torch.div(Mr - i_, 2, rounding_mode="floor")
        h = (y >> 1)[..., None] - hmin[:, :, None, None] + torch.div(Mr + i_, 2, rounding_mode="floor")
        assert int(v.min()) >= 0 and int(h.max()) < tbl, "the tables cover every lane"
        match = torch.gather(qt, 2, v.flatten(2)).view_as(v) == torch.gather(tt, 2, h.flatten(2)).view_as(h)
        lo = torch.maximum(-y, x - 2 * ql4)[..., None]
        hi = torch.minimum(torch.minimum(x, 2 * tl4 - y), nin - 1)[..., None]
        diag_ok = (i_ >= (2 - y)[..., None]) & (i_ <= (x - 2)[..., None])
        diag = torch.where(diag_ok, S + torch.where(match, 0, pen.x), INF)
        sn = torch.minimum(diag, best)
        choice = torch.where((diag <= best) & diag_ok & ~match, 1, torch.where(best == sn, code, 0))
        packed = choice | ((i1e <= i1o).long() << 3) | ((d1e <= d1o).long() << 4) | (i2x << 5) | (d2x << 6)
        newrun = torch.where(choice == 0, run.clamp(max=254) + 1, 0)
        entry = packed | (newrun << 8)
        planes[s, rows[inside], col[inside]] = entry[inside]
        active = ((i_ & 1) == Mr) & (i_ >= lo) & (i_ <= hi)
        new = [sn, i1n, d1n] + ([i2n, d2n] if two else [I2, D2])
        regs = [torch.where(active, n.clamp(max=INF), o) for n, o in zip(new, regs)]
        run = torch.where(active, newrun, run)
        write_halo((s + 1) & 1, halo)
    out = torch.empty((5, B, W), dtype=torch.int32)
    for band in range(5):
        out[band, rows[inside], col[inside]] = regs[band][inside].to(torch.int32)
    return out, planes.to(torch.int32).to(torch.uint16), G


def dense_forward_clusters(qs, ts, qlens, tlens, pen, k_width: int, l_pad: int,
                           nw: int, lpt: int, warp: int = 32, stretch: int = 4096):
    """Plain emulation of the forward's tier 3: csrc/dense_span.cu's
    replay cluster schedule (`replay_clusters`: blocks of nw
    warps of `warp` threads of lpt lanes) over the full band from the
    origin state for 2 l_pad steps, then the epilogue. Returns (scores,
    certificate, planes (2 l_pad, B, K) uint16, G the blocks a pair)."""
    state, planes, G = replay_clusters(qs, ts, qlens, tlens, pen, k_width, l_pad, 0,
                                       2 * l_pad, None, nw, lpt, warp=warp, stretch=stretch)
    scores, cert = TD.forward_finish(state[0], qlens, tlens, pen, k_width, l_pad)
    return scores, cert, planes, G
