"""Plain numpy emulations of the schedules of csrc/probe_forward.cu (x1)
and csrc/probe_ops.cu (x2, x3) (a test helper, not collected).

* `x1_forward`: one warp a pair, 32 threads of LPT = K / 32 adjacent
  lanes of the five bands and the run band, as registers. The bases come
  from two tables a pair of l_pad + K / 2 bytes, filled by a running
  index wrapped by a compare, read at offsets fixed per register from
  two pointers that move one byte a turn (two steps, odd d then even
  d); no division or modulo anywhere. A step updates only the registers
  of its parity, in place, those inside one [lo, hi] range a thread
  (V1: from d and the lengths; V2: from thresholds computed once, and
  no range at all on the turns inside the pair's window where every
  lane moves and has its diagonal term); V1 and V2 compute every lane's
  plane entry from the values before the step and store them as the
  kernel's words; V3 computes only the moving lanes and exchanges only
  the side they read (the other side's neighbour is INF here, and must
  not matter). The bands are clamped to INF when a countdown of turns
  reaches 0.
* `ops_chain`: 256 threads, each holding NSEG segments of E adjacent
  elements of a line (E = `seg_elems`), as a register file and a
  renaming: a roll sends the register holding the segment's last
  element to the next thread of the line (the shuffle) and overwrites
  it with what the thread before sent, so only the names move; at the
  step loop's back edge (every `unroll` steps) the names must come back
  to the registers they started in, and where they do not the moves
  that put them back are counted.
"""

from math import gcd

import numpy as np

INF = 1 << 29
WARP = 32


def fl2(a: int) -> int:
    """floor(a / 2)."""
    return a // 2


def _wrap(v, n):
    while (v < 0).any():
        v = np.where(v < 0, v + n, v)
    while (v >= n).any():
        v = np.where(v >= n, v - n, v)
    return v


def x1_tables(qs, ts, k0, K: int, l_pad: int):
    """The kernel's staged tables, (B, l_pad + K / 2) each: qt[i] = q[(hq0
    + i) mod l_pad], tt[i] = t[(ht0 + i) mod l_pad], filled by each of 32
    threads with a running index wrapped by one compare a turn; and hq0,
    ht0."""
    B = qs.shape[0]
    tbl = l_pad + K // 2
    hq0, ht0 = -((k0 + K) >> 1), (k0 >> 1) - 1
    qt = np.zeros((B, tbl), np.uint8)
    tt = np.zeros((B, tbl), np.uint8)
    rows = np.arange(B)
    for lane in range(WARP):
        vq, vt = _wrap(hq0 + lane, l_pad), _wrap(ht0 + lane, l_pad)
        for i in range(lane, tbl, WARP):
            qt[:, i] = qs[rows, vq]
            tt[:, i] = ts[rows, vt]
            vq, vt = vq + WARP, vt + WARP
            vq = np.where(vq >= l_pad, vq - l_pad, vq)
            vt = np.where(vt >= l_pad, vt - l_pad, vt)
    return qt, tt, hq0, ht0


def x1_forward(variant: str, qs, ts, qlens, tlens, pen, K: int, l_pad: int, d_chunk: int):
    """(scores (B,), certificates (B,) bool, planes (2 l_pad, B, K)
    uint16 or None for V3, fast turns a pair (B,)) as the kernel computes
    them. qs, ts: (B, l_pad) uint8; qlens, tlens: (B,) int; pen: a
    two-piece Penalties."""
    planes_on, opt = variant != "V3", variant != "V1"
    LPT = K // WARP
    i64 = np.int64
    qlens, tlens = np.asarray(qlens, i64), np.asarray(tlens, i64)
    B = len(qlens)
    q2, t2 = (2 * qlens)[:, None], (2 * tlens)[:, None]
    k_end = tlens - qlens
    abs_kend = np.abs(k_end)
    slack = (K - 1 - abs_kend) >> 1
    k0 = np.minimum(0, k_end) - slack
    k0 -= k0 & 1
    width = np.minimum(np.minimum(0, k_end) - k0, (k0 + (K - 1)) - np.maximum(0, k_end))
    lane = np.arange(WARP, dtype=i64)[None, :]
    kb = k0[:, None] + lane * LPT  # (B, 32), even
    qt, tt, hq0, ht0 = x1_tables(qs, ts, k0, K, l_pad)
    qoff0 = -(kb >> 1) - hq0[:, None]
    toff0 = (kb >> 1) - ht0[:, None]
    r = np.arange(LPT)
    # register r's base offsets from the turn's pointers, per parity
    qo = {True: np.array([fl2(-1 - i) for i in r]), False: np.array([fl2(-i) for i in r])}
    to = {True: np.array([fl2(i - 1) for i in r]), False: np.array([fl2(i) for i in r])}

    S = np.where(kb[:, :, None] + r == 0, 0, INF).astype(i64)
    I1, D1, I2, D2 = (np.full((B, WARP, LPT), INF, i64) for _ in range(4))
    R = np.zeros((B, WARP, LPT), i64)
    planes = np.zeros((2 * l_pad, B, K), np.uint16) if planes_on else None
    ea, eb, ec, ed = -kb, kb + q2, kb, t2 - kb
    f_lo = np.maximum(-k0, k0 + K - 1) + 2
    f_hi = np.minimum(k0 + 2 * qlens, 2 * tlens - (k0 + K - 1))
    m_lo = np.minimum(np.maximum(f_lo >> 1, 0), l_pad)
    m_hi = np.minimum(np.maximum(f_hi >> 1, m_lo), l_pad)
    fast_turns = np.zeros(B, i64)
    countdown = d_chunk >> 1
    rows = np.arange(B)[:, None, None]

    def up(a):  # the value at k - 1 from the thread before: INF at lane 0
        out = np.roll(a, 1, axis=1)
        out[:, 0] = INF
        return out

    def down(a):  # the value at k + 1 from the thread after: INF at lane 31
        out = np.roll(a, -1, axis=1)
        out[:, -1] = INF
        return out

    for m in range(l_pad):
        fast = (opt & (m >= m_lo) & (m < m_hi))[:, None]
        fast_turns += fast[:, 0]
        for half in (0, 1):
            odd = half == 0
            d = 2 * m + 1 + half
            mp = 1 if odd else 0
            if opt:
                lo, hi = np.maximum(ea - d, d - eb), np.minimum(d - ec, ed - d)
                dlo, dhi = 2 + ea - d, d - ec - 2
            else:
                x, y = d - kb, d + kb
                lo, hi = np.maximum(-y, x - q2), np.minimum(x, t2 - y)
                dlo, dhi = 2 - y, x - 2
            lo, hi = np.where(fast, 0, lo), np.where(fast, LPT - 1, hi)
            dlo, dhi = np.where(fast, 0, dlo), np.where(fast, LPT - 1, dhi)
            # the exchanged neighbours: both sides with a plane, else the
            # side the moving registers read (odd: k + 1, even: k - 1)
            inf = np.full((B, WARP), INF, i64)
            left = planes_on or not odd
            right = planes_on or odd
            sl, i1l, i2l = ((up(a[:, :, -1]) if left else inf) for a in (S, I1, I2))
            sr, d1r, d2r = ((down(a[:, :, 0]) if right else inf) for a in (S, D1, D2))
            s_km1 = np.concatenate([sl[:, :, None], S[:, :, :-1]], axis=2)
            s_kp1 = np.concatenate([S[:, :, 1:], sr[:, :, None]], axis=2)
            i1e = np.concatenate([i1l[:, :, None], I1[:, :, :-1]], axis=2) + pen.e1
            i2e = np.concatenate([i2l[:, :, None], I2[:, :, :-1]], axis=2) + pen.e2
            d1e = np.concatenate([D1[:, :, 1:], d1r[:, :, None]], axis=2) + pen.e1
            d2e = np.concatenate([D2[:, :, 1:], d2r[:, :, None]], axis=2) + pen.e2
            i1o, d1o = s_km1 + pen.o1 + pen.e1, s_kp1 + pen.o1 + pen.e1
            i2o, d2o = s_km1 + pen.o2 + pen.e2, s_kp1 + pen.o2 + pen.e2
            i1n, d1n = np.minimum(i1o, i1e), np.minimum(d1o, d1e)
            i2n, d2n = np.minimum(i2o, i2e), np.minimum(d2o, d2e)
            bi, bd = np.minimum(i1n, i2n), np.minimum(d1n, d2n)
            best = np.minimum(bi, bd)
            qi = (qoff0 + m)[:, :, None] + qo[odd]
            ti = (toff0 + m)[:, :, None] + to[odd]
            assert qi.min() >= 0 and ti.min() >= 0 and max(qi.max(), ti.max()) < qt.shape[1]
            match = qt[rows, qi] == tt[rows, ti]
            rr = r[None, None, :]
            diag_ok = (rr >= dlo[:, :, None]) & (rr <= dhi[:, :, None])
            diag = np.where(diag_ok, S + np.where(match, 0, pen.x), INF)
            sn = np.minimum(diag, best)
            moving = (r & 1) == mp
            active = moving & (rr >= lo[:, :, None]) & (rr <= hi[:, :, None])
            if planes_on:
                code = np.where(bi <= bd, np.where(i1n <= i2n, 2, 3), np.where(d1n <= d2n, 4, 5))
                choice = np.where((diag <= best) & diag_ok & ~match, 1,
                                  np.where(best == sn, code, 0))
                packed = (choice | ((i1e <= i1o) << 3) | ((d1e <= d1o) << 4)
                          | ((i2e <= i2o) << 5) | ((d2e <= d2o) << 6))
                newrun = np.where(choice == 0, np.minimum(R, 254) + 1, 0)
                entry = (packed | (newrun << 8)).astype(np.uint32)
                words = entry[:, :, 0::2] | (entry[:, :, 1::2] << 16)
                planes[d - 1] = store_words(words, LPT).reshape(B, K)
                R = np.where(active, newrun, R)
            S, I1, D1, I2, D2 = (np.where(active, n, o) for n, o in
                                 zip((sn, i1n, d1n, i2n, d2n), (S, I1, D1, I2, D2)))
        countdown -= 1
        if countdown == 0:
            countdown = d_chunk >> 1
            S, I1, D1, I2, D2 = (np.minimum(a, INF) for a in (S, I1, D1, I2, D2))

    c_end = np.clip(k_end - k0, 0, K - 1)
    s = S.reshape(B, K)[np.arange(B), c_end]
    feasible = (abs_kend <= K - 1) & (qlens + tlens <= 2 * l_pad)
    scores = np.where(feasible, np.minimum(s, INF), INF)
    n = np.maximum(width, 0) + 1
    esc = 2 * np.minimum(pen.o1 + n * pen.e1, pen.o2 + n * pen.e2)
    full_cover = (k0 <= -qlens) & (k0 + (K - 1) >= tlens)
    cert = ((scores < esc) | full_cover) & feasible & (scores < INF)
    return scores.astype(np.int32), cert, planes, fast_turns


def store_words(words, LPT: int):
    """A warp's plane row (B, 32 * LPT) of 16-bit entries from each
    thread's words (B, 32, LPT / 2) (entry r in word r / 2, the odd one
    high), written as the kernel's stores write them: one 16-byte (LPT
    8), 8-byte (4) or 4-byte (2) store a thread; at LPT 6 one 8-byte and
    one 4-byte store, an even lane's 8-byte one first and an odd lane's
    last (so that each is 8-byte aligned at 12 bytes a lane)."""
    B = words.shape[0]
    row = np.zeros((B, WARP * LPT // 2), np.uint32)  # the row as 32-bit words
    for lane in range(WARP):
        w = words[:, lane]
        base = lane * LPT // 2
        if LPT == 6:
            odd = lane & 1
            at64, at32 = (1, 0) if odd else (0, 2)
            row[:, base + at64: base + at64 + 2] = w[:, 1:3] if odd else w[:, 0:2]
            row[:, base + at32] = w[:, 0] if odd else w[:, 2]
        else:
            row[:, base: base + LPT // 2] = w
    return row.view(np.uint16).reshape(B, WARP * LPT)


def seg_elems(rolls: int, unroll: int) -> int:
    """Elements of a line one thread of csrc/probe_ops.cu holds (its
    `seg_elems`): 32 where
    rolls x unroll is a multiple of 32, else 8."""
    n = rolls * unroll
    return 32 if n > 0 and n % 32 == 0 else 8


def renaming_moves(lines: int, rolls: int, unroll: int) -> int:
    """Register moves a thread needs at each back edge of the step loop
    to undo a renaming that is not the identity there: its lines x 128 /
    256 / E segments rotated by rolls x unroll mod E, each cycle of the
    rotation its length plus one moves; 0 where the renaming comes back
    to the identity. (ptxas may unroll the loop further and need fewer.)"""
    e = seg_elems(rolls, unroll)
    k = (rolls * unroll) % e
    return 0 if k == 0 else lines * 128 // 256 // e * (e + gcd(k, e))


def ops_chain(x, n_steps: int, rolls: int, adds: int, sels: int, mins: int, axis: int,
              unroll: int, E: int):
    """(out, moves): x (R, C) int32 after the chain, as one block of the
    kernel computes it, and the register moves a thread makes at each
    back edge of the step loop to put the renamed elements back."""
    assert n_steps % unroll == 0
    lines = x.shape[1 - axis]
    tpl = 128 // E
    nseg = lines * 128 // 256 // E
    lstep = 256 // tpl
    tid = np.arange(256)
    m0, e0, lane = tid // tpl, (tid % tpl) * E, tid & 31
    src = (tid & ~31) | (lane & ~(tpl - 1)) | ((lane + tpl - 1) & (tpl - 1))
    m = m0[:, None, None] + lstep * np.arange(nseg)[None, :, None]  # (256, nseg, 1)
    e = e0[:, None, None] + np.arange(E)[None, None, :]            # (256, 1, E)
    a = x.astype(np.int64)
    reg = a[m, e] if axis == 1 else a[e, m]  # (256, nseg, E): logical = physical
    off = 0  # logical element i lives in register (i + off) mod E
    moves = 0
    for step in range(n_steps):
        for _ in range(rolls):
            sent = reg[:, :, (E - 1 + off) % E]   # the segment's last element
            off -= 1
            reg[:, :, off % E] = sent[src]        # the shuffle overwrites it
        for i in range(adds):
            reg = reg + (i + 1)
        for i in range(sels):
            reg = np.where(reg > 0, reg, i)
        for i in range(mins):
            reg = np.minimum(reg, 2**29 - i)
        reg = (reg + 2**31) % 2**32 - 2**31  # int32 adds wrap
        if (step + 1) % unroll == 0 and off % E:
            k = off % E
            moves += nseg * (E + gcd(k, E))  # each cycle of the rotation: its length + 1
            reg = np.roll(reg, -k, axis=2)
            off = 0
    out = np.empty_like(a)
    logical = reg[:, :, (np.arange(E) + off) % E]
    if axis == 1:
        out[m, e] = logical
    else:
        out[e, m] = logical
    return out.astype(np.int32), moves
