"""x1: the dense forward sweep with its bands in registers.

Port of scripts/experiments/kexp.py (`_kernel_v1`, `forward_v`; its
pallas_call): the banded two-piece Gotoh forward of
wfa/dense.py `dense_forward` for (qs, ts, qlens, tlens, pen, K, l_pad),
with the band geometry of csrc/dense_forward.cu (k0 even-aligned around
the [0, k_end] hull), returning the scores, the certificate and, with
planes, the (2*l_pad, B, K) uint16 choice plane (low byte S source and
extend bits, high byte match-run length). Variants:

* V1: values carried through the step loop; the activity test per
  step, `(k & 1) == (d & 1) and max(d - 2q, -d) <= k <= min(2t - d, d)`;
* V2: V1 with per-lane enter/leave thresholds (kexp.py:58-65): active
  iff d >= |k| (for k of d's parity) and d <= min(k + 2q, 2t - k), the
  diagonal term iff d >= |k| + 2. The same cells, fewer ops;
* V3: V2 without the plane store (scores and certificate only).

What the experiment computes, and so the port too, differs from
`dense_forward` in three ways that leave the scores, the certificate
and every reachable plane byte as they are (the tests hold the
traceback over either plane to the same bytes):

* the bases come from per-row streams that wrap modulo 2*l_pad
  (pallas_dense.py `_precompute_streams`), so lane k reads
  q[((d - k - 2) mod 2 l_pad) >> 1] and t[((d + k - 2) mod 2 l_pad) >> 1]
  where `dense_forward` clamps;
* the bands are clamped to INF once every d_chunk steps
  (pallas_dense.py `_tiles_for`), not every step;
* all five bands always run: the probe takes two-piece penalties only.

On Hopper (csrc/probe_forward.cu) one warp runs one pair: each thread
keeps K/32 adjacent lanes of the five bands and the run band in
registers, the neighbours at k-1 and k+1 come by warp shuffles, and no
step needs a barrier. csrc/dense_forward.cu, the engine's kernel, keeps
the bands in shared memory double buffers with one barrier a step.
"""

from __future__ import annotations

import numpy as np
import torch

from ..wfa.dense import INF, LaunchCount, _check_cuda, band_geometry
from ..wfa.params import Penalties
from .kexp6 import STEP_OPS as CELL_OPS
from .kexp8 import CHOICE_OPS as PLANE_OPS

VARIANTS = {
    "V1": ("V1 carry (choices)", False, True),
    "V2": ("V2 carry+opt", True, True),
    "V3": ("V3 score-only opt", True, False),
}
LANES = 128  # the TPU's lane width (pallas_dense.py LANES)
PLANE_BYTES_MAX = 1 << 20

#: one launch per call of the forward probe
forward_launches = LaunchCount()


def tiles_for(k_width: int, l_pad: int):
    """(batch_tile, d_chunk, stream_period): a copy of
    allwave_tpu/wfa/pallas_dense.py `_tiles_for`, which sets the
    experiment's clamp interval d_chunk."""
    tb = 64 if k_width <= 256 else (16 if k_width <= 8192 else 8)
    d = PLANE_BYTES_MAX // (tb * k_width)
    d = 1 << max(d.bit_length() - 1, 0)
    d = max(8, min(256, d))
    d = min(d, max(2 * l_pad, 8))
    return tb, d, max(d, LANES)


def check_shape(k_width: int, l_pad: int) -> int:
    """The clamp interval d_chunk; raises where the experiment would
    pad l_pad (it asserts aligned shapes)."""
    _, d_chunk, period = tiles_for(k_width, max(l_pad, 4))
    if max(l_pad, period // 2, d_chunk // 2) != l_pad:
        raise ValueError(f"l_pad {l_pad} is below the experiment's stream period {period} / 2")
    return d_chunk


def _certificate(scores, qlens, tlens, k0, width, pen: Penalties, K: int, D2: int):
    k_end = tlens - qlens
    feasible = (k_end.abs() <= K - 1) & (qlens + tlens <= D2)
    n = width.clamp(min=0) + 1
    esc = 2 * torch.minimum(pen.o1 + n * pen.e1, pen.o2 + n * pen.e2)
    full_cover = (k0 <= -qlens) & (k0 + (K - 1) >= tlens)
    return ((scores < esc) | full_cover) & feasible & (scores < INF)


def forward_ref(variant: str, qs, ts, qlens, tlens, pen: Penalties, K: int, l_pad: int):
    """Plain version of one x1 variant: (scores (B,) int32, certificate
    (B,) bool, planes (2*l_pad, B, K) uint16 or None for V3). V1 and V2
    compute the same function; this is V1's activity test."""
    with_planes = VARIANTS[variant][2]
    d_chunk = check_shape(K, l_pad)
    dev = qs.device
    B = qs.shape[0]
    i32 = torch.int32
    qlens, tlens = qlens.to(i32), tlens.to(i32)
    D2 = 2 * l_pad
    k_end, k0, width = band_geometry(qlens, tlens, K)
    lane = torch.arange(K, dtype=i32, device=dev)[None, :]
    ks = k0[:, None] + lane
    q2, t2 = 2 * qlens[:, None], 2 * tlens[:, None]
    first, last = lane == 0, lane == K - 1
    qs64, ts64 = qs.long(), ts.long()

    s = torch.where(ks == 0, 0, INF).to(i32)
    i1 = d1 = i2 = d2 = torch.full((B, K), INF, dtype=i32, device=dev)
    runl = torch.zeros((B, K), dtype=i32, device=dev)
    planes = torch.empty((D2, B, K), dtype=torch.uint16, device=dev) if with_planes else None
    o1e1, o2e2 = pen.o1 + pen.e1, pen.o2 + pen.e2
    for d in range(1, D2 + 1):
        qb = torch.gather(qs64, 1, (torch.remainder(d - ks - 2, D2) >> 1).long())
        tb = torch.gather(ts64, 1, (torch.remainder(d + ks - 2, D2) >> 1).long())
        lo = torch.maximum(d - q2, torch.full_like(q2, -d))
        hi = torch.minimum(t2 - d, torch.full_like(t2, d))
        active = ((ks & 1) == (d & 1)) & (ks >= lo) & (ks <= hi)
        s_km1 = torch.where(first, INF, torch.roll(s, 1, 1))
        s_kp1 = torch.where(last, INF, torch.roll(s, -1, 1))
        i1e = torch.where(first, INF, torch.roll(i1, 1, 1)) + pen.e1
        i1o = s_km1 + o1e1
        d1e = torch.where(last, INF, torch.roll(d1, -1, 1)) + pen.e1
        d1o = s_kp1 + o1e1
        i2e = torch.where(first, INF, torch.roll(i2, 1, 1)) + pen.e2
        i2o = s_km1 + o2e2
        d2e = torch.where(last, INF, torch.roll(d2, -1, 1)) + pen.e2
        d2o = s_kp1 + o2e2
        i1n, d1n = torch.minimum(i1o, i1e), torch.minimum(d1o, d1e)
        i2n, d2n = torch.minimum(i2o, i2e), torch.minimum(d2o, d2e)
        best = torch.minimum(torch.minimum(i1n, d1n), torch.minimum(i2n, d2n))
        match = qb == tb
        diag_ok = (ks <= d - 2) & (ks >= 2 - d)
        diag = torch.where(diag_ok, s + torch.where(match, 0, pen.x).to(i32), INF)
        sn = torch.minimum(diag, best)
        if with_planes:
            choice = torch.zeros_like(s)
            choice = torch.where(d2n == sn, 5, choice)
            choice = torch.where(d1n == sn, 4, choice)
            choice = torch.where(i2n == sn, 3, choice)
            choice = torch.where(i1n == sn, 2, choice)
            choice = torch.where((diag == sn) & diag_ok & ~match, 1, choice)
            packed = choice
            for bit, ext, opn in ((3, i1e, i1o), (4, d1e, d1o), (5, i2e, i2o), (6, d2e, d2o)):
                packed = packed | ((ext <= opn).to(i32) << bit)
            newrun = torch.where(choice == 0, runl.clamp(max=254) + 1, 0)
            planes[d - 1] = (packed | (newrun << 8)).to(torch.uint16)
            runl = torch.where(active, newrun, runl)
        s, i1, d1, i2, d2 = (torch.where(active, n, o) for n, o in
                             zip((sn, i1n, d1n, i2n, d2n), (s, i1, d1, i2, d2)))
        if d % d_chunk == 0:
            s, i1, d1, i2, d2 = (x.clamp(max=INF) for x in (s, i1, d1, i2, d2))
    c_end = (k_end - k0).clamp(0, K - 1)
    scores = torch.gather(s, 1, c_end[:, None].long())[:, 0]
    feasible = (k_end.abs() <= K - 1) & (qlens + tlens <= D2)
    scores = torch.where(feasible, scores, INF).clamp(max=INF).to(i32)
    return scores, _certificate(scores, qlens, tlens, k0, width, pen, K, D2), planes


def active_cells(qlens, tlens, k0, W: int, d_lo: int, n_steps: int) -> int:
    """DP cells a sweep over anti-diagonals d_lo+1 .. d_lo+n_steps
    updates on the W diagonals k0, k0+1, .. of each pair: the (d, k)
    with d of k's parity and |k| <= d <= min(k + 2 qlen, 2 tlen - k).
    qlens/tlens/k0: (B,) integer arrays. The work the data needs, which
    the bounds in chip_smoke.py and `work` count."""
    q = np.asarray(qlens, np.int64)[:, None]
    t = np.asarray(tlens, np.int64)[:, None]
    k = np.asarray(k0, np.int64)[:, None] + np.arange(W, dtype=np.int64)[None, :]
    lo = np.maximum(np.abs(k), d_lo + 1)
    hi = np.minimum(np.minimum(k + 2 * q, 2 * t - k), d_lo + n_steps)
    lo = lo + ((lo - k) & 1)  # first d of k's parity
    return int(np.maximum((hi - lo) // 2 + 1, 0).sum())


def work(variant: str, qlens, tlens, K: int, l_pad: int):
    """(int32 ops, bytes) one x1 call needs: every active cell once
    (CELL_OPS, and PLANE_OPS with the plane: the step probes' counts,
    kexp6.STEP_OPS and kexp8.CHOICE_OPS), the bases and lengths read
    once, the scores, certificates and (V1, V2) the plane written once."""
    with_planes = VARIANTS[variant][2]
    k0 = band_geometry(torch.as_tensor(qlens), torch.as_tensor(tlens), K)[1]
    cells = active_cells(qlens, tlens, k0, K, 0, 2 * l_pad)
    B = len(qlens)
    nbytes = B * (2 * l_pad + 8 + 5) + (2 * l_pad * B * K * 2 if with_planes else 0)
    return cells * (CELL_OPS + (PLANE_OPS if with_planes else 0)), nbytes


def forward(variant: str, qs, ts, qlens, tlens, pen: Penalties, K: int, l_pad: int):
    """One x1 variant: the plain version for CPU tensors, the
    csrc/probe_forward.cu kernel (one warp a pair) for CUDA tensors.
    Same outputs as `forward_ref`."""
    if not pen.two_piece:
        raise ValueError("the x1 probe runs all five bands: it takes two-piece penalties only")
    if qs.device.type == "cpu":
        return forward_ref(variant, qs, ts, qlens, tlens, pen, K, l_pad)
    from ..wfa import cuda_build

    with_planes = VARIANTS[variant][2]
    d_chunk = check_shape(K, l_pad)
    B = qs.shape[0]
    _check_cuda("qs", qs, torch.uint8, (B, l_pad))
    _check_cuda("ts", ts, torch.uint8, (B, l_pad))
    _check_cuda("qlens", qlens, torch.int32, (B,))
    _check_cuda("tlens", tlens, torch.int32, (B,))
    dev = qs.device
    scores = torch.empty(B, dtype=torch.int32, device=dev)
    cert = torch.empty(B, dtype=torch.uint8, device=dev)
    planes = (torch.empty((2 * l_pad, B, K), dtype=torch.uint16, device=dev)
              if with_planes else None)
    lib = cuda_build.library("probe_forward")
    rc = lib.allwave_probe_forward(
        qs.data_ptr(), ts.data_ptr(), qlens.data_ptr(), tlens.data_ptr(), B, l_pad, K,
        d_chunk, pen.x, pen.o1, pen.e1, pen.o2, pen.e2, int(variant[1]),
        scores.data_ptr(), cert.data_ptr(), None if planes is None else planes.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    cuda_build.check(rc, f"probe_forward {variant} at K {K} (K = 64, 128, 192 or 256)")
    forward_launches.launched((B, K, l_pad, variant))
    return scores, cert.bool(), planes
