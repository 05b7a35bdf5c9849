"""Segmented (checkpoint-replay) dense-band alignment for long pairs, in
PyTorch (reference: allwave_tpu/wfa/segmented.py).

The one-shot dense engine keeps a (2L, B, K) plane; at 100 kb that is
tens of gigabytes a pair. This engine bounds memory instead:

1. SWEEP: one score-only banded pass over the anti-diagonals that
   saves the five DP bands every `ckpt_every` (C) steps into one
   (5, n_seg, B, K) int32 checkpoint tensor;
2. REPLAY, backwards segment by segment: re-run the DP of one C-step
   span from its checkpoint with its choice/run plane, and advance the
   traceback walkers through it. Wide bands replay only a per-pair
   sub-band of k_sub diagonals around the walker (the narrow replay:
   a walker moves at most C diagonals in a segment, and the INF inflow
   at the sub-band's edges reaches one diagonal further per step, so
   every cell the walk reads is exact).

The cell arithmetic and tie-breaks are the one-shot engine's, so scores
and expanded CIGARs are identical to it. The run-length band restarts
at every segment (checkpoints do not carry it), so a match run that
crosses a segment edge comes back as two runs; the expanded per-base
CIGAR is the same.

Each step has a plain version (`dense_span_ref`, `traceback_segment_ref`)
and a hand-written CUDA kernel (csrc/dense_span.cu,
csrc/segment_traceback.cu). The wrappers `dense_span` and
`segment_traceback` pick by the tensors' device, as wfa/dense.py does:
CPU tensors take the plain version, CUDA tensors the kernel and nothing
else. The span kernel has two designs, the sweep's and the replay's,
each a thread-block cluster a pair; the C entry point
`allwave_dense_span_design` says which one a span runs and how it is
spread, and `span_design` reads it. Launches are counted in
`span_launches` (with each shape's design) and
`segment_traceback_launches`; `seg_stats` counts the pairs the engine
re-queued because their run buffer overflowed.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..utils.telemetry import counters, to_host
from . import dense as D
from .batch import walk_runs
from .dense import INF, LaunchCount, band_geometry
from .params import Penalties
from .rounds import BandLadder, SequencePool, next_pow2, pool_pairs

#: span kernel launches, shapes (B, K, k_sub, l_pad, n_steps, with_planes)
#: (k_sub = K on a full-band span), each with its `SpanDesign`
span_launches = LaunchCount()
#: segment-traceback kernel launches, shapes (B, K, l_pad, n_steps,
#: run_cap) with K the width of the plane walked (k_sub on a narrow
#: replay), each with its `WalkDesign`
segment_traceback_launches = LaunchCount()


@dataclass
class SegStats:
    """What the engine did since the last reset: the pairs it re-queued
    at the full run cap because their run buffer overflowed."""

    overflow_reruns: int = 0

    def reset(self) -> None:
        self.overflow_reruns = 0


seg_stats = SegStats()

_I32 = torch.int32
_P_COLS = 128  # the narrow replay's sub-band offsets are multiples of this


def init_state(B: int, K: int, k0: torch.Tensor) -> torch.Tensor:
    """DP band state at d = 0: (5, B, K) int32, the bands S, I1, D1,
    I2, D2 (reference: segmented.init_state)."""
    ks = k0[:, None] + torch.arange(K, dtype=_I32, device=k0.device)[None, :]
    state = torch.full((5, B, K), INF, dtype=_I32, device=k0.device)
    state[0] = torch.where(ks == 0, 0, INF)
    return state


# ---------------------------------------------------------------------------
# The span: n_steps anti-diagonals from a checkpointed state
# ---------------------------------------------------------------------------


def dense_span_ref(
    qs, ts, qlens, tlens, pen: Penalties, k_width: int, l_pad: int,
    d_lo: int, n_steps: int, state, with_planes: bool, c_lo=None, k_sub=None,
):
    """Plain version of the span (reference: segmented.dense_span_xla,
    and pallas_span.dense_span_pallas_sub for a sub-band): run
    anti-diagonals d_lo+1 .. d_lo+n_steps from `state`, the (5, B, K)
    int32 bands at d_lo of a band K = k_width wide.

    With c_lo ((B,) int32) the span covers only the window
    [c_lo, c_lo + k_sub) of each pair's band: origin k0 + c_lo, INF
    inflow at the window's edges. The run-length band starts at 0.

    Returns (state_out (5, B, W) int32, planes (n_steps, B, W) uint16 |
    None) with W = k_sub or K; a plane's low byte is the choice and
    extend bits, its high byte the match-run length."""
    dev = qs.device
    qlens = qlens.to(_I32)
    tlens = tlens.to(_I32)
    B = qs.shape[0]
    _, k0, _ = band_geometry(qlens, tlens, k_width)
    W = k_width
    bands = tuple(state[i] for i in range(5))
    if c_lo is not None:
        W = k_sub
        c_lo = c_lo.to(_I32)
        cols = (c_lo[:, None] + torch.arange(W, dtype=_I32, device=dev)[None, :]).long()
        bands = tuple(torch.gather(b, 1, cols) for b in bands)
        k0 = k0 + c_lo
    ks = k0[:, None] + torch.arange(W, dtype=_I32, device=dev)[None, :]
    rq, qb, tb = D.base_registers(qs, ts, qlens, k0, W, l_pad, d_lo)
    run = torch.zeros((B, W), dtype=_I32, device=dev)
    planes = (
        torch.empty((n_steps, B, W), dtype=torch.uint16, device=dev)
        if with_planes
        else None
    )
    for i in range(n_steps):
        d = d_lo + 1 + i
        qb, tb = D.shift_bases(rq, ts, qb, tb, qlens, k0, W, l_pad, d)
        bands, run, row = D.dp_step(d, ks, qlens, tlens, bands, run, qb, tb, pen, with_planes)
        if with_planes:
            planes[i] = row.to(torch.uint16)
    return torch.stack(bands), planes


class SpanDesign(NamedTuple):
    """What csrc/dense_span.cu runs for a span over W lanes of a band K:
    the fields of the code `allwave_dense_span_design` returns. Both
    designs are a thread-block cluster a pair."""

    code: int
    replay: bool  # the replay kernel (planes), else the sweep's
    blocks_per_pair: int  # G, the cluster
    lanes_per_block: int  # Lb
    lanes_per_thread: int  # the replay's band lanes in each thread's registers


def span_design(K: int, W: int, with_planes: bool, B: int, two_piece: bool) -> SpanDesign:
    """The span kernel's design for B pairs on a window of W lanes of a
    band K, from its C dispatch (the cluster size depends on how many
    of B's clusters the card holds at once). Raises for a window no
    design takes."""
    from . import cuda_build

    code = cuda_build.library("dense_span").allwave_dense_span_design(
        K, W, int(with_planes), B, int(two_piece)
    )
    if code < 0:
        raise ValueError(f"no span design for K={K} k_sub={W} with_planes={with_planes}")
    return SpanDesign(code, bool(code & 1), (code >> 1) & 31, code >> 10, (code >> 6) & 15)


def span_max_clusters(K: int, W: int, with_planes: bool, B: int, two_piece: bool) -> int:
    """cudaOccupancyMaxActiveClusters of the span's design for B pairs
    at (K, W): how many of its clusters the card holds at once."""
    from . import cuda_build

    n = cuda_build.library("dense_span").allwave_dense_span_max_clusters(
        K, W, int(with_planes), B, int(two_piece)
    )
    if n < 0:
        cuda_build.check(-n, "cudaOccupancyMaxActiveClusters")
    return n


def sweep_barriers(B: int, K: int, W: int, n_steps: int, device, full_fence=False) -> torch.Tensor:
    """Launch n_steps bare step barriers in the two-piece sweep's launch
    shape for B pairs at (K, W) (its clusters, threads and shared memory): what
    the sweep's barrier alone costs a step, or with full_fence what
    cooperative groups' cluster.sync() would. Returns the (B * G,) int32
    step count each block reached."""
    from . import cuda_build

    G = span_design(K, W, False, B, True).blocks_per_pair
    out = torch.zeros(B * G, dtype=_I32, device=device)
    rc = cuda_build.library("dense_span").allwave_dense_sweep_barriers(
        K, W, B, n_steps, int(full_fence), out.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream,
    )
    cuda_build.check(rc, "sweep barrier kernel launch")
    return out


def dense_span(
    qs, ts, qlens, tlens, pen: Penalties, k_width: int, l_pad: int,
    d_lo: int, n_steps: int, state, with_planes: bool, c_lo=None,
    k_sub=None, out=None,
):
    """The span: the plain version for CPU tensors, the
    csrc/dense_span.cu kernel for CUDA tensors (same contract as
    `dense_span_ref`): the sweep's cluster kernel without planes, the
    replay's with them (`span_design`). `state` may be a view whose
    (B, K) bands are each contiguous, such as one segment of the
    checkpoint tensor; `out`, if given, is such a (5, B, W) view and
    receives the state out. c_lo must lie in [0, K - k_sub]
    (`narrow_offsets` keeps it there); the kernel clamps it so that no
    read leaves the state."""
    counters.add(dispatches=1)
    if D._device_kind(qs) == "cpu":
        st, planes = dense_span_ref(
            qs, ts, qlens, tlens, pen, k_width, l_pad, d_lo, n_steps, state,
            with_planes, c_lo, k_sub,
        )
        if out is not None:
            out.copy_(st)
            st = out
        return st, planes
    from . import cuda_build

    B = qs.shape[0]
    K = k_width
    W = K if c_lo is None else k_sub
    if W is None or not 1 <= W <= K or l_pad < 1 or n_steps < 1 or d_lo < 0:
        raise ValueError(
            f"bad span: K={K} k_sub={W} l_pad={l_pad} d_lo={d_lo} n_steps={n_steps}"
        )
    D._check_cuda("qs", qs, torch.uint8, (B, l_pad))
    D._check_cuda("ts", ts, torch.uint8, (B, l_pad))
    D._check_cuda("qlens", qlens, _I32, (B,))
    D._check_cuda("tlens", tlens, _I32, (B,))
    if c_lo is not None:
        D._check_cuda("c_lo", c_lo, _I32, (B,))
    _check_bands("state", state, (5, B, K))
    dev = qs.device
    if out is None:
        out = torch.empty((5, B, W), dtype=_I32, device=dev)
    _check_bands("out", out, (5, B, W))
    planes = (
        torch.empty((n_steps, B, W), dtype=torch.uint16, device=dev)
        if with_planes
        else None
    )
    design = span_design(K, W, with_planes, B, pen.two_piece)
    lib = cuda_build.library("dense_span")
    rc = lib.allwave_dense_span(
        qs.data_ptr(), ts.data_ptr(), qlens.data_ptr(), tlens.data_ptr(),
        None if c_lo is None else c_lo.data_ptr(),
        B, l_pad, K, W, d_lo, n_steps, pen.x, pen.o1, pen.e1, pen.o2, pen.e2,
        int(pen.two_piece), int(with_planes), design.code,
        state.data_ptr(), state.stride(0), out.data_ptr(), out.stride(0),
        None if planes is None else planes.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    cuda_build.check(rc, "dense_span kernel launch")
    span_launches.launched((B, K, W, l_pad, n_steps, bool(with_planes)), design)
    return out, planes


def _check_bands(name: str, t: torch.Tensor, shape) -> None:
    """A (5, B, W) int32 CUDA tensor whose (B, W) bands are contiguous
    (the band stride itself is free)."""
    if t.device.type != "cuda" or t.dtype != _I32 or tuple(t.shape) != shape:
        raise ValueError(
            f"{name}: expected a CUDA int32 tensor of shape {shape}, got "
            f"{t.device} {t.dtype} {tuple(t.shape)}"
        )
    if t.stride(2) != 1 or t.stride(1) != shape[2]:
        raise ValueError(f"{name}: each (B, W) band must be contiguous")


def dense_sweep_ckpt(
    qs, ts, qlens, tlens, pen: Penalties, k_width: int, l_pad: int,
    ckpt_every: int, n_seg: Optional[int] = None,
):
    """Score-only sweep with band-state checkpoints (reference:
    segmented.dense_sweep_ckpt).

    Returns (scores (B,) int32, certificate (B,) bool, ckpts
    (5, n_seg, B, K) int32): ckpts[:, seg] is the state at
    d = seg * ckpt_every (seg 0 is the d = 0 init). Each span writes its
    state straight into the next segment's slot.

    n_seg bounds the sweep: every score lives at d = qlen + tlen, so
    segments past ceil(max(q+t)/C) never matter; the default covers the
    padded matrix, 2 * l_pad / C."""
    B = qs.shape[0]
    K = k_width
    C = ckpt_every
    D2 = 2 * l_pad
    assert D2 % C == 0
    n_seg_full = D2 // C
    n_seg = max(n_seg_full if n_seg is None else min(n_seg, n_seg_full), 1)
    qlens = qlens.to(_I32)
    tlens = tlens.to(_I32)
    k_end, k0, slack = band_geometry(qlens, tlens, K)

    ckpts = torch.empty((5, n_seg, B, K), dtype=_I32, device=qs.device)
    ckpts[:, 0] = init_state(B, K, k0)
    for seg in range(n_seg - 1):
        dense_span(
            qs, ts, qlens, tlens, pen, K, l_pad, seg * C, C, ckpts[:, seg],
            False, out=ckpts[:, seg + 1],
        )
    final, _ = dense_span(
        qs, ts, qlens, tlens, pen, K, l_pad, (n_seg - 1) * C, C,
        ckpts[:, n_seg - 1], False,
    )

    c_end = (k_end - k0).clamp(0, K - 1)
    scores = torch.gather(final[0], 1, c_end[:, None].long())[:, 0]
    feasible = (k_end.abs() <= K - 1) & (qlens + tlens <= n_seg * C)
    scores = torch.where(feasible, scores.clamp(max=INF), INF)
    # exit-and-return bound: a band-escaping global path needs >= W+1
    # gap bases out AND >= W+1 back, each side costing >= g(W+1)
    n = slack.clamp(min=0) + 1
    g1 = pen.o1 + n * pen.e1
    esc = 2 * (torch.minimum(g1, pen.o2 + n * pen.e2) if pen.two_piece else g1)
    # a band covering every diagonal of the matrix is the unbanded DP
    full_cover = (k0 <= -qlens) & (k0 + (K - 1) >= tlens)
    cert = ((scores < esc) | full_cover) & feasible & (scores < INF)
    return scores.to(_I32), cert, ckpts


# ---------------------------------------------------------------------------
# The resumable walk over one replayed segment
# ---------------------------------------------------------------------------


def new_walk(d, c, alive) -> torch.Tensor:
    """Walk state (6, B) int32, rows: d, c (band column), component
    (0=S 1=I1 2=D1 3=I2 4=D2), active, open run's op, open run's length."""
    z = torch.zeros_like(d, dtype=_I32)
    return torch.stack([d.to(_I32), c.to(_I32), z, alive.to(_I32), z, z]).contiguous()


def new_bufs(B: int, run_cap: int, device):
    """Run buffers: ops and lens (B, run_cap) uint8 (end to start),
    nrun (B,) int32 (counting runs dropped past run_cap), overflow (B,)
    bool."""
    return (
        torch.zeros((B, run_cap), dtype=torch.uint8, device=device),
        torch.zeros((B, run_cap), dtype=torch.uint8, device=device),
        torch.zeros(B, dtype=_I32, device=device),
        torch.zeros(B, dtype=torch.bool, device=device),
    )


def traceback_segment_ref(planes, d_lo: int, walk, bufs, c_lo=None) -> None:
    """Plain version of the resumable walk (reference:
    segmented._traceback_core over uncompressed planes). Advances the
    walkers through one segment's (n_steps, B, W) uint16 plane, whose
    row r holds anti-diagonal d_lo + r + 1 and whose column is c - c_lo.
    Walkers pause at d <= d_lo and finish at d <= 0; the open run rides
    in the walk state across segments. Updates `walk` and `bufs` in
    place.

    The XLA walk's structure is kept where it shows in the bytes: hops
    run in chunks of 32, at most (2 * n_steps + 8) // 32 + 2 chunks a
    segment, and a walker whose run buffer overflowed stops at the end
    of that chunk."""
    NS, B, W = planes.shape
    dev = planes.device
    ops, lens, nrun, overflow = bufs
    run_cap = ops.shape[1]
    rows = torch.arange(B, device=dev)
    col0 = c_lo.to(_I32) if c_lo is not None else 0
    plane16 = planes.view(torch.int16)
    d, c, comp, active, cur_op, cur_len = (walk[i].clone() for i in range(6))
    active = active != 0
    nr = nrun.clone()

    for _ in range((2 * NS + 8) // D.CHUNK + 2):
        if not bool((active & (d > d_lo)).any()):
            break
        oob = torch.zeros(B, dtype=torch.bool, device=dev)
        for _ in range(D.CHUNK):
            stepping = active & (d > d_lo)
            r = d - d_lo - 1
            cc = c - col0
            ok = (r >= 0) & (r < NS) & (cc >= 0) & (cc < W)
            v = plane16[r.clamp(0, NS - 1).long(), rows, cc.clamp(0, W - 1).long()]
            v = torch.where(ok, v.to(_I32) & 0xFFFF, 0)
            byte = v & 0xFF
            src = byte & 7

            is_s = comp == 0
            is_match_run = is_s & (src == D.S_DIAG_MATCH)
            is_x = is_s & (src == D.S_DIAG_MISMATCH)
            run_i = (v >> 8).clamp(min=1)
            to_gap = torch.where(
                src == D.S_I1, 1,
                torch.where(src == D.S_D1, 2, torch.where(src == D.S_I2, 3, 4)),
            )
            is_i = (comp == 1) | (comp == 3)
            is_d = (comp == 2) | (comp == 4)
            ext_bit = ((byte >> (comp + 2).clamp(min=3)) & 1) == 1

            emit_op = torch.where(
                is_match_run, D._OP_M,
                torch.where(is_x, D._OP_X, torch.where(is_i, D._OP_I, D._OP_D)),
            )
            emit_len = torch.where(is_match_run, run_i, 1)
            do_emit = stepping & (is_match_run | is_x | is_i | is_d)

            # merge into the open run; a completed run is stored
            same = (cur_len > 0) & (cur_op == emit_op) & (cur_len + emit_len <= 255)
            flush = do_emit & (cur_len > 0) & ~same
            keep = flush & (nr < run_cap)
            if bool(keep.any()):
                b = rows[keep]
                ops[b, nr[keep].long()] = cur_op[keep].to(torch.uint8)
                lens[b, nr[keep].long()] = cur_len[keep].to(torch.uint8)
            oob |= flush & (nr >= run_cap)
            nr = nr + flush.to(_I32)
            cur_op = torch.where(do_emit, emit_op, cur_op)
            cur_len = torch.where(
                do_emit, torch.where(same, cur_len + emit_len, emit_len), cur_len
            )

            new_d = torch.where(
                is_s,
                torch.where(is_match_run, d - 2 * run_i, torch.where(is_x, d - 2, d)),
                d - 1,
            )
            new_c = torch.where(is_s, c, torch.where(is_i, c - 1, c + 1))
            new_comp = torch.where(
                is_s,
                torch.where(is_match_run | is_x, 0, to_gap),
                torch.where(ext_bit, comp, 0),
            )
            active = active & ~(stepping & (new_d <= 0))
            d = torch.where(stepping, new_d, d)
            c = torch.where(stepping, new_c, c)
            comp = torch.where(stepping, new_comp, comp)
        overflow |= oob
        active = active & ~oob

    for i, t in enumerate((d, c, comp, active.to(_I32), cur_op, cur_len)):
        walk[i] = t
    nrun.copy_(nr)


class WalkDesign(NamedTuple):
    """What a walk kernel (csrc/segment_traceback.cu, csrc/wf_traceback.cu)
    runs: the fields of the code its C dispatch returns. One block a
    pair: a walker and a producer warp a slot of a ring of tiles in
    shared memory (and, for the wavefront walk, a warp that stages the
    window's head)."""

    code: int
    rows: int  # R, plane rows (score levels) a tile, on a fixed grid
    slots: int  # N, tiles in the ring: the walker's and N - 1 below it
    cols: int  # Wc, window columns every row of a tile covers
    warps: int


def walk_design_of(code: int) -> WalkDesign:
    """Decode a walk kernel's design code: bits 0-3 log2 R, 4-7 log2 N,
    8-15 Wc, 16-19 warps."""
    return WalkDesign(code, 1 << (code & 15), 1 << ((code >> 4) & 15), (code >> 8) & 255,
                      (code >> 16) & 15)


@functools.lru_cache(maxsize=None)
def segment_walk_design(NS: int, W: int) -> WalkDesign:
    """The segment walk's design for an (NS, B, W) plane, from its C
    dispatch (once a shape)."""
    from . import cuda_build

    return walk_design_of(cuda_build.library("segment_traceback").allwave_segment_traceback_design(NS, W))


def traceback_segment_tiles(planes, d_lo: int, walk, bufs, c_lo=None, stats=None, *,
                            design: WalkDesign) -> None:
    """Plain emulation of csrc/segment_traceback.cu's tile schedule, one
    walker at a time: the same contract and bytes as
    `traceback_segment_ref`, read the way the kernel reads. Tile t holds
    plane rows t*R .. t*R + R - 1, each as the 64 entries of the
    16-byte-aligned run that starts (row * B * W + b * W + lo) & 7
    entries before column lo (zeros past the plane's end); it lives in
    slot t % N. On entering tile t the walker asks for the tiles
    t - N + 1 .. t not asked for yet, lo centred on its column and
    clamped into the window; an entry of the walker's tile within
    lo .. lo + Wc - 1 is read from the tile, any other from the full
    plane (a miss). With stats ((2, B) int32) each walker's hops and
    misses of this call are written there."""
    NS, B, W = planes.shape
    R, N, WC = design.rows, design.slots, design.cols
    flat = planes.view(torch.int16).cpu().numpy().view(np.uint16).reshape(-1)
    total = flat.size
    ops, lens, nrun, overflow = bufs
    run_cap = ops.shape[1]
    w = walk.cpu().numpy().copy()
    ops_h, lens_h = ops.cpu().numpy().copy(), lens.cpu().numpy().copy()
    nr_h, ov_h = nrun.cpu().numpy().copy(), overflow.cpu().numpy().copy()
    col0s = c_lo.cpu().numpy() if c_lo is not None else np.zeros(B, np.int64)
    st = np.zeros((2, B), np.int32)

    def stage(b, t, lo):
        tile = np.zeros((R, 64), np.uint16)
        for rr in range(min(R, NS - t * R)):
            at = (((t * R + rr) * B + b) * W + lo) & ~7
            run = flat[at:min(at + 64, total)]
            tile[rr, : run.size] = run
        return tile

    for b in range(B):
        d, c, comp, act, cur_op, cur_len = (int(v) for v in w[:, b])
        active = act != 0
        nr, ovf, col0 = int(nr_h[b]), bool(ov_h[b]), int(col0s[b])
        if not (active and d > d_lo):
            continue
        req_lo, have_t, hops, misses = 1 << 31, -1, 0, 0
        slot_lo, tiles = [0] * N, [None] * N
        for _ in range((2 * NS + 8) // D.CHUNK + 2):
            if not (active and d > d_lo):
                break
            oob = False
            for _ in range(D.CHUNK):
                if not (active and d > d_lo):
                    break
                hops += 1
                r, cc, v = d - d_lo - 1, c - col0, 0
                if 0 <= r < NS and 0 <= cc < W:
                    t = r // R
                    if t != have_t:
                        new_lo = max(t - N + 1, 0)
                        if new_lo < req_lo:
                            lo = min(max(cc - WC // 2, 0), max(W - WC, 0))
                            for u in range(min(req_lo - 1, t), new_lo - 1, -1):
                                slot_lo[u % N] = lo
                                tiles[u % N] = (u, stage(b, u, lo))
                            req_lo = new_lo
                        have_t = t
                    lo = slot_lo[t % N]
                    if 0 <= cc - lo < WC:
                        held, tile = tiles[t % N]
                        assert held == t
                        v = int(tile[r % R, cc - lo + (((r * B + b) * W + lo) & 7)])
                    else:
                        v = int(flat[(r * B + b) * W + cc])
                        misses += 1
                byte, run = v & 0xFF, v >> 8
                src = byte & 7
                is_s = comp == 0
                is_match_run, is_x = is_s and src == D.S_DIAG_MATCH, is_s and src == D.S_DIAG_MISMATCH
                run_i = max(run, 1)
                is_i, is_d = comp in (1, 3), comp in (2, 4)
                if is_match_run or is_x or is_i or is_d:
                    op = D._OP_M if is_match_run else D._OP_X if is_x else D._OP_I if is_i else D._OP_D
                    n = run_i if is_match_run else 1
                    same = cur_len > 0 and cur_op == op and cur_len + n <= 255
                    if cur_len > 0 and not same:
                        if nr < run_cap:
                            ops_h[b, nr], lens_h[b, nr] = cur_op, cur_len
                        else:
                            oob = True
                        nr += 1
                    cur_len = cur_len + n if same else n
                    cur_op = op
                if is_s:
                    d = d - 2 * run_i if is_match_run else d - 2 if is_x else d
                    comp = 0 if is_match_run or is_x else {2: 1, 4: 2, 3: 3}.get(src, 4)
                else:
                    ext = (byte >> (comp + 2)) & 1
                    d, c = d - 1, c - 1 if is_i else c + 1
                    comp = comp if ext else 0
                if d <= 0:
                    active = False
            if oob:
                ovf, active = True, False
        w[:, b] = (d, c, comp, int(active), cur_op, cur_len)
        nr_h[b], ov_h[b] = nr, ovf
        st[:, b] = (hops, misses)
    walk.copy_(torch.from_numpy(w))
    for t, h in zip(bufs, (ops_h, lens_h, nr_h, ov_h)):
        t.copy_(torch.from_numpy(h))
    if stats is not None:
        stats.copy_(torch.from_numpy(st))


def segment_traceback(planes, d_lo: int, walk, bufs, l_pad: int, c_lo=None, stats=None) -> None:
    """The resumable walk over one segment: the plain version for CPU
    tensors, the csrc/segment_traceback.cu kernel for CUDA tensors (same
    contract as `traceback_segment_ref`; updates walk and bufs in place).
    With stats ((2, B) int32, CUDA only), the kernel writes each walker's
    hops and misses (entries read from device memory, not from a tile)
    of this call there. l_pad is recorded with the launch."""
    counters.add(dispatches=1)
    if D._device_kind(planes) == "cpu":
        if stats is not None:
            raise ValueError("stats: hops and misses are the kernel's; the plain walk has none")
        traceback_segment_ref(planes, d_lo, walk, bufs, c_lo)
        return
    from . import cuda_build

    NS, B, W = planes.shape
    ops, lens, nrun, overflow = bufs
    run_cap = ops.shape[1]
    D._check_cuda("planes", planes, torch.uint16, (NS, B, W))
    D._check_cuda("walk", walk, _I32, (6, B))
    D._check_cuda("ops", ops, torch.uint8, (B, run_cap))
    D._check_cuda("lens", lens, torch.uint8, (B, run_cap))
    D._check_cuda("nrun", nrun, _I32, (B,))
    D._check_cuda("overflow", overflow, torch.bool, (B,))
    if c_lo is not None:
        D._check_cuda("c_lo", c_lo, _I32, (B,))
    if stats is not None:
        D._check_cuda("stats", stats, _I32, (2, B))
    if run_cap < 1 or d_lo < 0:
        raise ValueError(f"bad run_cap {run_cap} or d_lo {d_lo}")
    if planes.data_ptr() % 16:
        raise ValueError("planes: the walk's tiles copy 16-byte runs: expected a 16-byte-aligned tensor")
    design = segment_walk_design(NS, W)
    lib = cuda_build.library("segment_traceback")
    rc = lib.allwave_segment_traceback(
        planes.data_ptr(), NS, B, W, d_lo,
        None if c_lo is None else c_lo.data_ptr(),
        walk.data_ptr(), ops.data_ptr(), lens.data_ptr(), nrun.data_ptr(),
        overflow.data_ptr(), run_cap, None if stats is None else stats.data_ptr(),
        design.code, torch.cuda.current_stream(planes.device).cuda_stream,
    )
    cuda_build.check(rc, "segment_traceback kernel launch")
    segment_traceback_launches.launched((B, W, l_pad, NS, run_cap), design)


def narrow_offsets(c: torch.Tensor, K: int, k_sub: int) -> torch.Tensor:
    """Per-pair sub-band origin for the narrow replay: k_sub columns
    centred on the walker's column c, at a multiple of 128, inside the
    band (reference: segmented._replay_tb_block)."""
    lo = torch.div(c - k_sub // 2, _P_COLS, rounding_mode="floor") * _P_COLS
    return lo.clamp(0, K - k_sub).to(_I32)


# ---------------------------------------------------------------------------
# Orchestrator
# ---------------------------------------------------------------------------


@dataclass
class SegmentedConfig:
    k_initial: int = 128
    k_max: int = 24576
    #: anti-diagonal steps per checkpoint segment. The narrow replay's
    #: sub-band width is ~2C, so a smaller C cuts replay work on wide
    #: bands; 2048 balances that against launches and checkpoint memory
    ckpt_every: int = 2048
    #: memory budget for one segment's choice+run planes
    seg_budget_bytes: int = 2 << 30
    max_batch: int = 256


class SegmentedDenseAligner:
    """Long-pair aligner (reference: segmented.SegmentedDenseAligner):
    exact dense banded alignment in O(K * 2L / C) checkpoint memory
    instead of O(2L * K) planes. Runs on the device of its sequence pool,
    the router's when it hands one over."""

    #: the reference's segmented ladder, up to 24576 (differs from the
    #: one-shot engine's)
    K_LADDER = sorted({128 << i for i in range(8)} | {384 << i for i in range(7)})

    def __init__(
        self,
        pen: Penalties,
        config: Optional[SegmentedConfig] = None,
        device=None,
        pool: Optional[SequencePool] = None,
    ):
        self.pen = pen
        self.config = config or SegmentedConfig()
        self.pool = pool if pool is not None else SequencePool(resolve_device(device))
        self.device = self.pool.device
        self.ladder = BandLadder(pen, self.K_LADDER, self.config.k_initial, self.config.k_max)

    def _run_cap(self, l_pad: int) -> int:
        # every <=255-base match stretch is one run; mutations add runs.
        # 2L/64 covers pure-match CIGARs 16x over
        return max(2048, (2 * l_pad) // 64)

    def _runs_bound(self, score: int, qlen: int, tlen: int, n_seg: int) -> int:
        """At least the number of runs the walk emits (the open run's
        final flush included) for a pair certified at `score` whose walk
        crosses n_seg segments.

        The walk emits runs of one op, M, X, I or D, of at most 255
        bases. Cut the alignment into blocks, maximal stretches of one op.

        * Non-match blocks (X, I, D) come one base a step and merge while
          the run stays <= 255; the open run rides across segment edges.
          A block of L bases is ceil(L / 255) runs: its first costs at
          least g = min(x, o1 + e1[, o2 + e2]) (a mismatch or a gap's
          open), and each further one covers 255 more of its bases, each
          costing at least u = min(x, e1[, e2]). So at most
          score // g + score // (255 u) non-match runs.
        * Match blocks number at most the non-match blocks + 1. The walk
          reads a block in pieces of at most 255 bases (the run byte
          saturates) that also break where a segment starts (the run band
          restarts there); pieces merge while the run stays <= 255, so
          a block of L bases is at most ceil(L / 255) runs plus one for
          each segment edge inside it. With at most min(qlen, tlen) match
          bases and n_seg - 1 edges: at most score // g + 1 +
          min(qlen, tlen) // 255 + n_seg - 1 match runs.

        Every op consumes a base, so qlen + tlen bounds the count too."""
        pen = self.pen
        g = min(pen.x, pen.o1 + pen.e1)
        u = min(pen.x, pen.e1)
        if pen.two_piece:
            g = min(g, pen.o2 + pen.e2)
            u = min(u, pen.e2)
        every = qlen + tlen
        if g <= 0 or u <= 0:
            return every
        bound = 2 * (score // g) + score // (255 * u) + min(qlen, tlen) // 255 + n_seg
        return min(bound, every)

    def align_pairs(self, pairs: List[Tuple[bytes, bytes]], sigma_hint=None):
        """[(score, (ops, lens))] in input order (None = failed): each
        cigar as run pairs in start->end order.
        sigma_hint: optional per-pair estimated scores (mash-derived);
        a pair then starts at the band its shaved estimate certifies
        instead of probing narrow and escalating through full sweeps."""
        pool_seqs, qidx, tidx = pool_pairs(pairs)
        return self.align_pairs_indexed(pool_seqs, qidx, tidx, sigma_hint)

    def align_pairs_indexed(self, pool_seqs, qidx, tidx, sigma_hint=None):
        """align_pairs with the pairs as row indices into pool_seqs."""
        n = len(qidx)
        results: List[Optional[Tuple[int, tuple]]] = [None] * n
        if n == 0:
            return results
        with counters.span("engine.plan"):
            qidx = np.asarray(qidx, dtype=np.int64)
            tidx = np.asarray(tidx, dtype=np.int64)
            pool_lens = np.fromiter((len(s) for s in pool_seqs), np.int64, len(pool_seqs))
            ql = pool_lens[qidx]
            tl = pool_lens[tidx]
            l_pad = next_pow2(max(int(max(ql.max(), tl.max())), 4))
            pool = (self.pool.rows(pool_seqs, l_pad), qidx, tidx, ql, tl)
            C = min(self.config.ckpt_every, 2 * l_pad)
            kend = np.abs(tl - ql)
            sums = ql + tl

            ladder = self.ladder
            k0 = max(ladder.round(self.config.k_initial), ladder.round(int(kend.max()) + 2))
            k0 = min(k0, ladder.round(max(int(sums.max()) + 1, 2)))
            cap0 = self._run_cap(l_pad)
            full_cap = 2 * l_pad + 8
            if sigma_hint is None:
                rounds = {(k0, cap0): list(range(n))}
            else:
                rounds = {}
                for i in range(n):
                    # mash hints skew HIGH at the divergences this engine
                    # serves (k-mer Jaccard saturates); shave 25% for the
                    # first band: an under-shave costs one escalation sweep
                    hint = int(sigma_hint[i])
                    ki = max(
                        ladder.for_score(hint - hint // 4, int(kend[i])),
                        ladder.round(self.config.k_initial),
                        ladder.round(int(kend[i]) + 2),
                    )
                    ki = min(ki, ladder.round(int(sums[i]) + 1))
                    rounds.setdefault((ki, cap0), []).append(i)
        while rounds:
            with counters.span("engine.plan"):
                k, cap = min(rounds)
                idxs = rounds.pop((k, cap))
                if k > self.config.k_max:
                    continue
                per_pair = 2 * C * k  # one segment's choices+runs
                bsz = int(max(1, min(self.config.seg_budget_bytes // per_pair, self.config.max_batch)))
                idxs = sorted(idxs, key=lambda i: int(sums[i]))
            for lo in range(0, len(idxs), bsz):
                group = idxs[lo : lo + bsz]
                escalate = self._run_group(pool, group, results, k, l_pad, C, cap, full_cap)
                counters.add(reruns=len(escalate))
                for i, key in escalate:
                    rounds.setdefault(key, []).append(i)
        return results

    def _run_group(self, pool, group, results, k, l_pad, C, run_cap, full_cap):
        """Sweep, escalate, replay and walk one group at band k; fills
        results and returns [(pair index, (next k, next run_cap))]."""
        pool_dev, qidx, tidx, ql_all, tl_all = pool
        dev = self.device
        B = len(group)
        K = k
        with counters.span("engine.launch"):
            gi = np.asarray(group, dtype=np.int64)
            sums = ql_all[gi] + tl_all[gi]
            n_seg = min(max(1, -(-int(sums.max()) // C)), (2 * l_pad) // C)
            qs = pool_dev.index_select(0, torch.from_numpy(qidx[gi]).to(dev))
            ts = pool_dev.index_select(0, torch.from_numpy(tidx[gi]).to(dev))
            qlens = torch.from_numpy(ql_all[gi].astype(np.int32)).to(dev)
            tlens = torch.from_numpy(tl_all[gi].astype(np.int32)).to(dev)

            scores_d, cert_d, ckpts = dense_sweep_ckpt(
                qs, ts, qlens, tlens, self.pen, K, l_pad, C, n_seg=n_seg
            )
        scores, cert = to_host(scores_d, cert_d)

        with counters.span("engine.unpack"):
            escalate = []
            for j, i in enumerate(group):
                if cert[j]:
                    continue
                kend_abs = abs(int(tl_all[i] - ql_all[i]))
                # strict widening = the next LADDER rung, not 2*k: doubling
                # can overshoot k_max and drop a pair the next rung certifies
                nup = self.ladder.round(k + 1)
                if nup <= k:  # already at the widest rung: failed pair
                    continue
                if scores[j] < INF:
                    nk = max(self.ladder.for_score(int(scores[j]), kend_abs), nup)
                else:  # no banded score to size from: jump ~2x, on-ladder
                    nk = max(self.ladder.round(2 * k), nup)
                nk = min(nk, max(self.ladder.round(int(sums[j]) + 1), nup))
                escalate.append((i, (nk, run_cap)))
        if not cert.any():
            return escalate

        with counters.span("engine.launch"):
            # walkers start at the end cell of each certified pair; their run
            # buffers hold every run the certified scores allow, so no pair
            # is re-queued at full_cap to redo its sweep and replay
            k_end, k0, _ = band_geometry(qlens, tlens, K)
            d0 = qlens + tlens
            walk = new_walk(d0, (k_end - k0).clamp(0, K - 1), cert_d & (d0 > 0))
            bounds = [
                self._runs_bound(int(scores[j]), int(ql_all[i]), int(tl_all[i]), -(-int(sums[j]) // C))
                for j, i in enumerate(group) if cert[j]
            ]
            cap = min(max([run_cap] + bounds), full_cap)
            bufs = new_bufs(B, cap, dev)
            # walkers only move to smaller d: segments above every start are
            # never visited, and the bound is known on the host, so the
            # replay loop needs no device->host sync
            top_seg = min(n_seg - 1, max(0, int(sums.max()) - 1) // C)
            k_sub = min(K, -(-(2 * C + 320) // _P_COLS) * _P_COLS)
            for seg in range(top_seg, -1, -1):
                c_lo = narrow_offsets(walk[1], K, k_sub) if K > k_sub else None
                _, planes = dense_span(
                    qs, ts, qlens, tlens, self.pen, K, l_pad, seg * C, C,
                    ckpts[:, seg], True, c_lo=c_lo, k_sub=k_sub,
                )
                segment_traceback(planes, seg * C, walk, bufs, l_pad, c_lo=c_lo)
                del planes
            del ckpts
        counters.add(cells=B * 2 * (n_seg * C) * k)  # sweep + replay

        ops, lens, nrun, overflow, walk_h = to_host(*bufs, walk)
        with counters.span("engine.unpack"):
            ops, lens, nrun, overflow = ops.copy(), lens.copy(), nrun.copy(), overflow.copy()
            overflow |= walk_h[3] != 0  # still active: the hop bound ran out
            # flush the open run of each finished walker
            for j in range(B):
                if walk_h[5, j] > 0 and not overflow[j]:
                    if nrun[j] < cap:
                        ops[j, nrun[j]] = walk_h[4, j]
                        lens[j, nrun[j]] = walk_h[5, j]
                        nrun[j] += 1
                    else:
                        overflow[j] = True
            for j, i in enumerate(group):
                if not cert[j]:
                    continue
                if overflow[j]:
                    # the run buffer or the walk's hop bound ran out: retry
                    # at the full cap, fail there
                    if cap < full_cap:
                        seg_stats.overflow_reruns += 1
                        escalate.append((i, (k, full_cap)))
                    else:
                        results[i] = None
                    continue
                results[i] = (int(scores[j]), walk_runs(ops[j], lens[j], int(nrun[j])))
        return escalate
