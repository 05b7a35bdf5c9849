"""Plain numpy emulations of csrc/probe_step.cu's two schedules (a test
helper, not collected).

* `smem_v0`: x4 v0's step_smem_kernel. One thread a lane of the moving
  parity; the five bands parity-packed (lane 2j + p at [p][j + 1], INF
  in the end slots) and updated in place; the stream rows doubled and
  parity-packed, read at a moving offset. A step runs its warps one
  after another, in turn forwards and backwards, each reading the bands
  as the warps before it left them: a step whose lanes read what other
  lanes of the step write gives other values than the plain version.
* `regs_launch`: one launch of step_regs_kernel. 256 threads of LPT =
  K / 256 adjacent lanes, the bands (and x6's run band) as registers;
  inside a warp a lane's neighbour comes from the next thread's
  registers (the shuffles), at warp edges from the halo: side L (a
  warp's last lane after odd steps) and side R (its first lane after
  even steps), double-buffered by step pair, INF slots at both ends. A
  step runs its warps one after another in turn forwards and backwards,
  so a warp reads halo slots that warps before it in the step may have
  written: reading the buffer the step writes shows. Only the moving
  parity's recurrence is committed; x6's entries are every lane's, from
  the values before the step. The stream values shift by one lane a
  step, one entering from the skewed rows. The state comes from s_in
  or a (5, TB, K) buffer and goes back to it; the S band goes out every
  chunk and after the last step.
"""

import numpy as np

INF = (1 << 30) - 1
O1E1, E1, O2E2, E2, XP = 10, 2, 25, 1, 5
REG_THREADS = 256


def q2_for(k: int) -> int:
    return 2 * (k * 40)


def terms(s, sl, i1l, i2l, sr, d1r, d2r, qv, tv, diag_ok):
    """kexp6.py step_math at lanes of int32 arrays (adds wrap): (sn, i1n,
    d1n, i2n, d2n, diag, match, (i1x, d1x, i2x, d2x))."""
    i32 = np.int32
    i1e, i1o = i1l + i32(E1), sl + i32(O1E1)
    d1e, d1o = d1r + i32(E1), sr + i32(O1E1)
    i2e, i2o = i2l + i32(E2), sl + i32(O2E2)
    d2e, d2o = d2r + i32(E2), sr + i32(O2E2)
    i1n, d1n = np.minimum(i1o, i1e), np.minimum(d1o, d1e)
    i2n, d2n = np.minimum(i2o, i2e), np.minimum(d2o, d2e)
    best = np.minimum(np.minimum(i1n, d1n), np.minimum(i2n, d2n))
    match = qv == tv
    diag = np.where(diag_ok, s + np.where(match, 0, XP).astype(i32), i32(INF)).astype(i32)
    sn = np.minimum(diag, best)
    return sn, i1n, d1n, i2n, d2n, diag, match, (i1e <= i1o, d1e <= d1o, i2e <= i2o, d2e <= d2o)


def entry(sn, i1n, d1n, i2n, d2n, diag, match, flags, runp):
    """kexp8.py's plane entry (packed | run << 8) and the new run."""
    choice = np.zeros_like(sn)
    for code, v in ((5, d2n), (3, d1n), (4, i2n), (2, i1n)):
        choice = np.where(v == sn, code, choice)
    choice = np.where((diag == sn) & ~match, 1, choice)
    packed = choice
    for bit, f in zip((3, 4, 5, 6), flags):
        packed = packed | (f.astype(np.int32) << bit)
    newrun = np.where(choice == 0, np.minimum(runp, 254) + 1, 0).astype(np.int32)
    return (packed | (newrun << 8)).astype(np.int32), newrun


def stream_rows(qb0, tb0, w: int, fill: int):
    """The query and target stream registers before the first roll."""
    pad = np.full((qb0.shape[0], w), fill, np.int32)
    return (np.concatenate([pad, qb0], 1).astype(np.int32),
            np.concatenate([tb0, pad], 1).astype(np.int32))


def _warp_order(n_warps: int, g: int):
    return range(n_warps) if g % 2 == 0 else range(n_warps - 1, -1, -1)


# ------------------------------------------------------------------ x4 v0


def smem_v0(qb0, tb0, s_in, nsteps: int, w: int, fill: int):
    """x4 v0's S band after nsteps steps, as step_smem_kernel runs them."""
    tb, k = s_in.shape
    L, KH = w + k, (k + 1) // 2
    KP = KH + 2
    band = np.full((tb, 2, KP, 5), INF, np.int32)
    for c in range(k):
        band[:, c & 1, (c >> 1) + 1, 0] = s_in[:, c]
    q, t = stream_rows(qb0, tb0, w, fill)
    qrow = np.empty((tb, 2, L), np.int32)
    trow = np.empty((tb, 2, L), np.int32)
    for x in range(2 * L):
        qrow[:, x & 1, x >> 1] = q[:, x % L]
        trow[:, x & 1, x >> 1] = t[:, x % L]
    q2 = q2_for(k)
    pq, pt = (w - 1) % L, 1 % L
    warps = -(-KH // 32)
    for g in range(nsteps):
        d = g + 2
        P, O = d & 1, (d & 1) ^ 1
        lo, hi = max(d - q2, -d), min(q2 - d, d, k - 1)
        xq, xt = pq + P, pt + P
        for wp in _warp_order(warps, g):
            j = np.arange(wp * 32, wp * 32 + 32)
            c = 2 * j + P
            j = j[(c >= lo) & (c <= hi)]
            if not len(j):
                continue
            c = 2 * j + P
            own, left, right = band[:, P, j + 1], band[:, O, j + P], band[:, O, j + 1 + P]
            sn, i1n, d1n, i2n, d2n, *_ = terms(
                own[..., 0], left[..., 0], left[..., 1], left[..., 3], right[..., 0],
                right[..., 2], right[..., 4], qrow[:, xq & 1, (xq >> 1) + j],
                trow[:, xt & 1, (xt >> 1) + j], (c <= d - 2) & (c >= 2 - d))
            band[:, P, j + 1] = np.stack([sn, i1n, d1n, i2n, d2n], -1)
        pq = pq - 1 if pq else L - 1
        pt = pt + 1 if pt < L - 1 else 0
    c = np.arange(k)
    return band[:, c & 1, (c >> 1) + 1, 0]


# -------------------------------------------------------- register kernel


def _skew(x, lpt: int):
    return x + (x >> 5) if lpt % 2 == 0 else x


def regs_launch(qb0, tb0, s_in, w: int, fill: int, n0: int, n_steps: int, *, copies: int = 1,
                chunk: int = 0, state=None, base: int = 0, sout_every: bool = False,
                sout_last: bool = True, dummy: bool = False, plane: bool = False,
                idle_reads_written_buffer: bool = False):
    """One step_regs_kernel launch: steps n0 .. n0 + n_steps - 1.
    Returns {"sout": (TB, K) or None, "dummy": [(TB, K) uint8 a chunk],
    "plane": (n_steps, TB, K) int32 entries or None}; `state` (5, TB, K)
    int32, when given, is read (n0 > 0) and written back.
    `idle_reads_written_buffer` reads x6's idle halo entries from the
    buffer the step writes (a schedule with one buffer a side)."""
    tb, k = s_in.shape
    lpt = k // REG_THREADS
    assert lpt * REG_THREADS == k
    n_warps = REG_THREADS // 32
    chunk = chunk or n_steps
    L = w + k
    q, t = stream_rows(qb0, tb0, w, fill)
    LS = _skew(2 * L - 1, lpt) + 1
    qrow = np.zeros((tb, LS), np.int32)
    trow = np.zeros((tb, LS), np.int32)
    x = np.arange(2 * L)
    qrow[:, _skew(x, lpt)] = q[:, x % L]
    trow[:, _skew(x, lpt)] = t[:, x % L]

    def regs(a):  # (TB, K) -> (TB, threads, LPT)
        return a.reshape(tb, REG_THREADS, lpt).copy()

    if n0 == 0:
        S = np.stack([regs(s_in + np.int32(cp)) for cp in range(copies)])
        I1, D1, I2, D2 = (np.full_like(S, INF) for _ in range(4))
    else:
        S, I1, D1, I2, D2 = (regs(state[i])[None] for i in range(5))
    R = np.zeros((tb, REG_THREADS, lpt), np.int32)
    # halo[side, buf, cp, TB, slot, 3]: warp w at slot w + 1, INF at 0, warps + 1
    halo = np.full((2, 2, copies, tb, n_warps + 2, 3), INF, np.int32)
    for buf in range(2):
        for wp in range(n_warps):
            last, first = wp * 32 + 31, wp * 32
            halo[0, buf, :, :, wp + 1] = np.stack(
                [S[:, :, last, -1], I1[:, :, last, -1], I2[:, :, last, -1]], -1)
            halo[1, buf, :, :, wp + 1] = np.stack(
                [S[:, :, first, 0], D1[:, :, first, 0], D2[:, :, first, 0]], -1)

    c0 = np.arange(REG_THREADS) * lpt
    lanes = c0[:, None] + np.arange(lpt)[None, :]  # (threads, LPT)
    pq, pt = (w - (n0 + 1)) % L, (n0 + 1) % L
    Q = qrow[:, _skew(pq + lanes, lpt)]
    T = trow[:, _skew(pt + lanes, lpt)]
    q2 = q2_for(k)
    out = {"sout": None, "dummy": [], "plane": None}
    planes = np.zeros((n_steps, tb, k), np.int32) if plane else None
    for g in range(n_steps):
        d = base + n0 + g + 2
        DP, hb = d & 1, (d >> 1) & 1
        lo, hi = max(d - q2, -d), min(q2 - d, d)
        for wp in _warp_order(n_warps, g):
            th = slice(wp * 32, wp * 32 + 32)
            c = lanes[th]
            moving = ((c & 1) == DP) & (c >= lo) & (c <= hi)
            diag_ok = (c <= d - 2) & (c >= 2 - d)
            for cp in range(copies):
                s, i1, d1, i2, d2 = (a[cp][:, th] for a in (S, I1, D1, I2, D2))
                # the shuffles: thread t's left neighbour is thread t - 1's
                # last lane, its right one thread t + 1's first; the halo at
                # the warp's ends
                idle_l = hb if idle_reads_written_buffer else hb ^ 1
                hl = halo[0, hb ^ 1 if DP == 0 else idle_l, cp, :, wp]
                hr = halo[1, hb if DP == 1 else hb ^ 1, cp, :, wp + 2]
                left = [np.concatenate([h[:, None], a[:, :-1, -1]], 1)
                        for h, a in zip(hl.T, (s, i1, i2))]
                right = [np.concatenate([a[:, 1:, 0], h[:, None]], 1)
                         for h, a in zip(hr.T, (s, d1, d2))]
                ext = lambda a, l, r: np.concatenate([l[..., None], a, r[..., None]], 2)
                sx, i1x, i2x = ext(s, left[0], s[..., 0]), ext(i1, left[1], i1[..., 0]), \
                    ext(i2, left[2], i2[..., 0])
                sx2, d1x, d2x = ext(s, s[..., 0], right[0]), ext(d1, d1[..., 0], right[1]), \
                    ext(d2, d2[..., 0], right[2])
                sn, i1n, d1n, i2n, d2n, diag, match, flags = terms(
                    s, sx[..., :-2], i1x[..., :-2], i2x[..., :-2], sx2[..., 2:], d1x[..., 2:],
                    d2x[..., 2:], Q[:, th], T[:, th], diag_ok)
                if plane:
                    ent, newrun = entry(sn, i1n, d1n, i2n, d2n, diag, match, flags, R[:, th])
                    planes[g][:, th.start * lpt:th.stop * lpt] = ent.reshape(tb, -1)
                    R[:, th] = np.where(moving, newrun, R[:, th])
                for a, n in zip((S, I1, D1, I2, D2), (sn, i1n, d1n, i2n, d2n)):
                    a[cp][:, th] = np.where(moving, n, a[cp][:, th])
                if DP == 1:
                    last = wp * 32 + 31
                    halo[0, hb, cp, :, wp + 1] = np.stack(
                        [S[cp][:, last, -1], I1[cp][:, last, -1], I2[cp][:, last, -1]], -1)
                else:
                    first = wp * 32
                    halo[1, hb, cp, :, wp + 1] = np.stack(
                        [S[cp][:, first, 0], D1[cp][:, first, 0], D2[cp][:, first, 0]], -1)
        # the barrier; the stream values of the next step
        pq = pq - 1 if pq else L - 1
        pt = pt + 1 if pt < L - 1 else 0
        Q = np.concatenate([qrow[:, _skew(pq + c0, lpt)][..., None], Q[..., :-1]], 2)
        T = np.concatenate([T[..., 1:], trow[:, _skew(pt + c0 + lpt - 1, lpt)][..., None]], 2)
        if (g + 1) % chunk == 0:
            band = S.sum(0, dtype=np.int32).reshape(tb, k) if copies == 2 else S[0].reshape(tb, k)
            if sout_every:
                out["sout"] = band.copy()
            if dummy:
                out["dummy"].append(band.astype(np.uint8))
    if state is not None:
        for i, a in enumerate((S, I1, D1, I2, D2)):
            state[i] = a[0].reshape(tb, k)
    if sout_last:
        out["sout"] = S.sum(0, dtype=np.int32).reshape(tb, k) if copies == 2 else S[0].reshape(tb, k)
    out["plane"] = planes
    return out
