"""Dense banded anti-diagonal alignment: the forward DP, the traceback
and the packed per-pair result, in PyTorch.

The function is allwave_tpu/wfa/dense.py's: a banded Gotoh sweep over
anti-diagonals d = 1 .. 2*l_pad in diagonal coordinates k = h - v, a
(2*l_pad, B, K) uint16 plane (low byte: S source in bits 0-2 and the
gap-extend bits 3-6; high byte: the diagonal-match run length,
saturating at 255), then a walk of that plane from (qlen+tlen, c_end)
to the origin. The tie-break contract (docs/TIEBREAK.md) makes every
score, certificate, CIGAR and packed byte unique, so the port is held
to the reference exactly.

Each step has two versions here:

* a plain one (`dense_forward_ref`, `dense_traceback_ref` +
  `pack_alignments`): a literal transcription of the XLA code that runs
  on any torch device, used by the CPU tests and as the reference for
  the kernels on the card;
* a hand-written CUDA kernel (csrc/dense_forward.cu,
  csrc/dense_traceback.cu). The forward has three designs (tiers) by
  band width; the C entry point `allwave_dense_forward_design` says
  which one a (K, l_pad) runs, and `forward_design` reads it. Tier 3
  launches the replay cluster of csrc/dense_span.cu from the origin.
  The traceback is a warp a pair that loads the cells a walk can reach
  next in one round trip; `dense_traceback_groups` emulates it.

The public wrappers `dense_forward` and `dense_traceback` pick by the
device of the tensors they are given: a CPU tensor goes to the plain
version, a CUDA tensor launches the kernel or raises. There is no
fallback from the kernel to the plain version. Each wrapper counts its
kernel launches in `forward_launches` / `traceback_launches`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import torch

from .params import Penalties

INF = 2**29

# choice-plane encoding (bits 0-2: S source; bits 3-6: I1/D1/I2/D2 extend)
S_DIAG_MATCH = 0
S_DIAG_MISMATCH = 1
S_I1 = 2
S_I2 = 3
S_D1 = 4
S_D2 = 5

_OP_M = ord("M")
_OP_X = ord("X")
_OP_I = ord("I")
_OP_D = ord("D")

#: hops per early-exit check of the plain traceback (the XLA walk's
#: chunk length; its hop bound counts whole chunks)
CHUNK = 32


@dataclass
class LaunchCount:
    """Kernel launches through one wrapper, the widest band K any of
    them ran, and the launches at each distinct shape: (B, K, l_pad)
    for the forward, (B, K, l_pad, run_cap) for the traceback; for the
    forward and the spans also the design each shape ran (`ForwardDesign`,
    `segmented.SpanDesign`, `wf_segmented.WfSpanDesign`)."""

    count: int = 0
    widest_k: int = 0
    shapes: dict = field(default_factory=dict)
    designs: dict = field(default_factory=dict)

    def launched(self, shape: tuple, design=None) -> None:
        self.count += 1
        self.widest_k = max(self.widest_k, shape[1])
        self.shapes[shape] = self.shapes.get(shape, 0) + 1
        if design is not None:
            self.designs[shape] = design

    def reset(self) -> None:
        self.count = 0
        self.widest_k = 0
        self.shapes.clear()
        self.designs.clear()


forward_launches = LaunchCount()
traceback_launches = LaunchCount()


def band_geometry(qlens: torch.Tensor, tlens: torch.Tensor, K: int):
    """Band window [k0, k0+K-1] around the [0, k_end] hull (reference:
    allwave_tpu/wfa/dense.py _band_geometry): k0 is even-aligned, and
    the returned width is the true min(left, right) margin between hull
    and band edge — the escape-certificate width."""
    k_end = tlens - qlens
    slack = torch.div(K - 1 - k_end.abs(), 2, rounding_mode="floor")
    k0 = k_end.clamp(max=0) - slack
    k0 = k0 - (k0 & 1)
    w_l = k_end.clamp(max=0) - k0
    w_r = (k0 + (K - 1)) - k_end.clamp(min=0)
    return k_end, k0, torch.minimum(w_l, w_r)


def _shift_up(a: torch.Tensor, fill: int) -> torch.Tensor:
    """out[..., c] = a[..., c+1]"""
    return torch.cat([a[..., 1:], torch.full_like(a[..., :1], fill)], -1)


def _shift_down(a: torch.Tensor, fill: int) -> torch.Tensor:
    """out[..., c] = a[..., c-1]"""
    return torch.cat([torch.full_like(a[..., :1], fill), a[..., :-1]], -1)


def base_registers(qs, ts, qlens, k0, K: int, l_pad: int, d: int):
    """The XLA scan's base shift registers at anti-diagonal d (reference:
    allwave_tpu/wfa/segmented.py _base_registers): the reversed query
    rq[i] = q[qlen-1-i], and per lane k = k0 + c the bases
    qb[k] = rq[qlen - ((d - k) >> 1)] and tb[k] = t[((d + k) >> 1) - 1],
    every index clamped into [0, l_pad)."""
    i32 = torch.int32
    dev = qs.device
    ks = k0[:, None] + torch.arange(K, dtype=i32, device=dev)[None, :]
    idx = torch.arange(l_pad, dtype=i32, device=dev)[None, :]
    rev_idx = (qlens[:, None] - 1 - idx).clamp(0, l_pad - 1)
    rq = torch.gather(qs, 1, rev_idx.long())
    qi = (qlens[:, None] - ((d - ks) >> 1)).clamp(0, l_pad - 1)
    ti = (((d + ks) >> 1) - 1).clamp(0, l_pad - 1)
    return rq, torch.gather(rq, 1, qi.long()), torch.gather(ts, 1, ti.long())


def shift_bases(rq, ts, qb, tb, qlens, k0, K: int, l_pad: int, d: int):
    """Advance the base registers from anti-diagonal d-1 to d: the query
    register shifts down a lane and takes a new head, the target
    register shifts up and takes a new tail."""
    qi_head = (qlens - ((d - k0) >> 1)).clamp(0, l_pad - 1)
    q_head = torch.gather(rq, 1, qi_head[:, None].long())
    ti_tail = (((d + k0 + (K - 1)) >> 1) - 1).clamp(0, l_pad - 1)
    t_tail = torch.gather(ts, 1, ti_tail[:, None].long())
    return (
        torch.cat([q_head, qb[:, :-1]], 1),
        torch.cat([tb[:, 1:], t_tail], 1),
    )


def dp_step(d: int, ks, qlens, tlens, bands, run, qb, tb, pen: Penalties, with_plane: bool):
    """One anti-diagonal step of the banded Gotoh DP (reference: the
    scan step of allwave_tpu/wfa/dense.py dense_forward, identical to
    segmented.dense_span_xla's). bands = (S, I1, D1, I2, D2), each
    (B, K) int32 at d-1; run: (B, K) int32 match-run band; qb/tb: the
    base registers at d. Returns (bands at d, run at d, plane row): the
    row is (B, K) int32 (low byte choice/extend bits, high byte run
    length) when with_plane, else None, and the run band is then
    left as it was."""
    i32 = torch.int32
    s, i1, d1, i2, d2 = bands
    v = (d - ks) >> 1
    h = (d + ks) >> 1
    parity_ok = ((d - ks) & 1) == 0
    in_matrix = (v >= 0) & (v <= qlens[:, None]) & (h >= 0) & (h <= tlens[:, None])
    active = parity_ok & in_matrix

    # gap states read S_{d-1} / gaps_{d-1} at k -+ 1
    s_km1 = _shift_down(s, INF)
    s_kp1 = _shift_up(s, INF)
    i1_ext_v = _shift_down(i1, INF) + pen.e1
    i1_opn_v = s_km1 + (pen.o1 + pen.e1)
    i1_new = torch.minimum(i1_opn_v, i1_ext_v)
    i1_ext = i1_ext_v <= i1_opn_v  # tie -> extend
    d1_ext_v = _shift_up(d1, INF) + pen.e1
    d1_opn_v = s_kp1 + (pen.o1 + pen.e1)
    d1_new = torch.minimum(d1_opn_v, d1_ext_v)
    d1_ext = d1_ext_v <= d1_opn_v
    best_gap = torch.minimum(i1_new, d1_new)
    if pen.two_piece:
        i2_ext_v = _shift_down(i2, INF) + pen.e2
        i2_opn_v = s_km1 + (pen.o2 + pen.e2)
        i2_new = torch.minimum(i2_opn_v, i2_ext_v)
        i2_ext = i2_ext_v <= i2_opn_v
        d2_ext_v = _shift_up(d2, INF) + pen.e2
        d2_opn_v = s_kp1 + (pen.o2 + pen.e2)
        d2_new = torch.minimum(d2_opn_v, d2_ext_v)
        d2_ext = d2_ext_v <= d2_opn_v
        best_gap = torch.minimum(best_gap, torch.minimum(i2_new, d2_new))
    else:
        i2_new, d2_new = i2, d2
        i2_ext = torch.zeros_like(i1_ext)
        d2_ext = torch.zeros_like(d1_ext)

    # diagonal term reads S_{d-2} at k, which is s[k] by parity
    is_match = qb == tb
    diag_ok = (v > 0) & (h > 0)
    diag = torch.where(diag_ok, s + (~is_match).to(i32) * pen.x, INF)
    s_new = torch.minimum(diag, best_gap)

    row = None
    if with_plane:
        # last write wins: D2 < D1 < I2 < I1 < diag-mismatch
        choice = torch.zeros_like(s)
        if pen.two_piece:
            choice = torch.where(d2_new == s_new, S_D2, choice)
        choice = torch.where(d1_new == s_new, S_D1, choice)
        if pen.two_piece:
            choice = torch.where(i2_new == s_new, S_I2, choice)
        choice = torch.where(i1_new == s_new, S_I1, choice)
        choice = torch.where(
            (diag == s_new) & diag_ok & ~is_match, S_DIAG_MISMATCH, choice
        )
        packed = (
            choice
            | (i1_ext.to(i32) << 3)
            | (d1_ext.to(i32) << 4)
            | (i2_ext.to(i32) << 5)
            | (d2_ext.to(i32) << 6)
        )
        new_run = torch.where(choice == S_DIAG_MATCH, run.clamp(max=254) + 1, 0)
        row = packed | (new_run << 8)
        run = torch.where(active, new_run, run)

    new = (s_new, i1_new, d1_new, i2_new, d2_new)
    bands = tuple(
        torch.where(active, n.clamp(max=INF), o) for n, o in zip(new, bands)
    )
    return bands, run, row


def dense_forward_ref(
    qs: torch.Tensor,
    ts: torch.Tensor,
    qlens: torch.Tensor,
    tlens: torch.Tensor,
    pen: Penalties,
    k_width: int,
    l_pad: int,
):
    """Plain version of the forward sweep: a step-by-step transcription
    of allwave_tpu/wfa/dense.py dense_forward (with_choices=True),
    base shift registers included, so its planes equal the reference's
    at every cell.

    qs/ts: (B, l_pad) uint8; qlens/tlens: (B,) int32. Returns (scores
    (B,) int32, >= INF when the end cell is outside the band;
    certificate (B,) bool; planes (2*l_pad, B, K) uint16)."""
    dev = qs.device
    B = qs.shape[0]
    K = k_width
    i32 = torch.int32
    qlens = qlens.to(i32)
    tlens = tlens.to(i32)

    _, k0, _ = band_geometry(qlens, tlens, K)
    ks = k0[:, None] + torch.arange(K, dtype=i32, device=dev)[None, :]
    rq, qb, tb = base_registers(qs, ts, qlens, k0, K, l_pad, 0)

    gap = torch.full((B, K), INF, dtype=i32, device=dev)
    bands = (torch.where(ks == 0, 0, INF).to(i32), gap, gap, gap, gap)
    run = torch.zeros((B, K), dtype=i32, device=dev)  # saturates at 255

    D2 = 2 * l_pad
    planes = torch.empty((D2, B, K), dtype=torch.uint16, device=dev)
    for d in range(1, D2 + 1):
        qb, tb = shift_bases(rq, ts, qb, tb, qlens, k0, K, l_pad, d)
        bands, run, row = dp_step(d, ks, qlens, tlens, bands, run, qb, tb, pen, True)
        planes[d - 1] = row.to(torch.uint16)
    scores, cert = forward_finish(bands[0], qlens, tlens, pen, K, l_pad)
    return scores, cert, planes


def forward_finish(s_band, qlens, tlens, pen: Penalties, K: int, l_pad: int):
    """The forward's scores ((B,) int32, INF where the end cell is
    outside the band or the matrix) and certificates ((B,) bool) from
    the S band (B, K) at d = 2 l_pad (reference: the tail of
    allwave_tpu/wfa/dense.py dense_forward)."""
    qlens = qlens.to(torch.int32)
    tlens = tlens.to(torch.int32)
    k_end, k0, slack = band_geometry(qlens, tlens, K)
    c_end = (k_end - k0).clamp(0, K - 1)
    scores = torch.gather(s_band, 1, c_end[:, None].long())[:, 0]
    feasible = (k_end.abs() <= K - 1) & (qlens + tlens <= 2 * l_pad)
    scores = torch.where(feasible, scores, INF)

    # optimality certificate: a band-escaping global path needs >= W+1
    # gap bases out AND >= W+1 back, each side costing >= g(W+1)
    n = slack.clamp(min=0) + 1
    g1 = pen.o1 + n * pen.e1
    esc = 2 * (torch.minimum(g1, pen.o2 + n * pen.e2) if pen.two_piece else g1)
    # a band covering every diagonal of the matrix is the unbanded DP
    full_cover = (k0 <= -qlens) & (k0 + (K - 1) >= tlens)
    cert = ((scores < esc) | full_cover) & feasible & (scores < INF)
    return scores.to(torch.int32), cert


def dense_traceback_ref(
    planes: torch.Tensor,
    scores: torch.Tensor,
    qlens: torch.Tensor,
    tlens: torch.Tensor,
    run_cap: int,
    trace: Optional[list] = None,
):
    """Plain version of the traceback: allwave_tpu/wfa/dense.py
    dense_traceback over an uncompressed (2*l_pad, B, K) plane.

    Returns (ops (B, run_cap) uint8 — op chars, end-to-start; lens
    (B, run_cap) uint8; nruns (B,) int32 — counting runs dropped past
    run_cap; overflow (B,) bool). Runs on any torch device. A `trace`
    list receives each hop's (d, c, component, active) (B,) tensors,
    the cell it reads, for `dense_traceback_groups`."""
    D2, B, K = planes.shape
    dev = planes.device
    i32 = torch.int32
    qlens = qlens.to(i32)
    tlens = tlens.to(i32)
    k_end, k0, _ = band_geometry(qlens, tlens, K)
    rows = torch.arange(B, device=dev)
    # uint16 has no CUDA indexing kernel: read the same bytes as int16
    plane16 = planes.view(torch.int16)

    d = qlens + tlens
    c = (k_end - k0).clamp(0, K - 1)
    comp = torch.zeros(B, dtype=i32, device=dev)  # 0=S 1=I1 2=D1 3=I2 4=D2
    active = (scores < INF) & (d > 0)
    # one spare column (index run_cap) takes every write that is dropped
    ops = torch.zeros((B, run_cap + 1), dtype=torch.uint8, device=dev)
    lens = torch.zeros((B, run_cap + 1), dtype=torch.uint8, device=dev)
    nrun = torch.zeros(B, dtype=i32, device=dev)
    overflow = torch.zeros(B, dtype=torch.bool, device=dev)
    cur_op = torch.zeros(B, dtype=i32, device=dev)
    cur_len = torch.zeros(B, dtype=i32, device=dev)

    max_hops = ((2 * D2 + 8 + CHUNK - 1) // CHUNK + 1) * CHUNK
    for hop in range(max_hops):
        if hop % CHUNK == 0 and not bool(active.any()):
            break
        if trace is not None:
            trace.append((d, c, comp, active))
        ok = (d >= 1) & (d <= D2) & (c >= 0) & (c < K)
        dd = (d - 1).clamp(0, D2 - 1).long()
        cc = c.clamp(0, K - 1).long()
        v = torch.where(ok, plane16[dd, rows, cc].to(i32) & 0xFFFF, 0)
        byte = v & 0xFF
        run = v >> 8
        src = byte & 7

        is_s = comp == 0
        is_match_run = is_s & (src == S_DIAG_MATCH)
        is_x = is_s & (src == S_DIAG_MISMATCH)
        run_i = run.clamp(min=1)
        to_gap = torch.where(
            src == S_I1,
            1,
            torch.where(src == S_D1, 2, torch.where(src == S_I2, 3, 4)),
        )
        is_i = (comp == 1) | (comp == 3)
        is_d = (comp == 2) | (comp == 4)
        ext_bit = ((byte >> (comp + 2).clamp(min=3)) & 1) == 1

        emit_op = torch.where(
            is_match_run,
            _OP_M,
            torch.where(is_x, _OP_X, torch.where(is_i, _OP_I, _OP_D)),
        )
        emit_len = torch.where(is_match_run, run_i, 1)
        do_emit = active & (is_match_run | is_x | is_i | is_d)

        # merge into the open run; a completed run is stored
        same = (cur_len > 0) & (cur_op == emit_op) & (cur_len + emit_len <= 255)
        flush = do_emit & (cur_len > 0) & ~same
        slot = torch.where(flush & (nrun < run_cap), nrun, run_cap).long()
        ops[rows, slot] = cur_op.to(torch.uint8)
        lens[rows, slot] = cur_len.to(torch.uint8)
        overflow |= flush & (nrun >= run_cap)
        nrun = nrun + flush.to(i32)
        cur_op = torch.where(do_emit, emit_op, cur_op)
        cur_len = torch.where(
            do_emit, torch.where(same, cur_len + emit_len, emit_len), cur_len
        )

        # state transitions
        d_s = torch.where(
            is_match_run, d - 2 * run_i, torch.where(is_x, d - 2, d)
        )
        comp_s = torch.where(is_match_run | is_x, 0, to_gap)
        c_g = torch.where(is_i, c - 1, c + 1)
        comp_g = torch.where(ext_bit, comp, 0)
        new_d = torch.where(is_s, d_s, d - 1)
        new_c = torch.where(is_s, c, c_g)
        new_comp = torch.where(is_s, comp_s, comp_g)

        active = active & ~(new_d <= 0)
        d = torch.where(active, new_d, d)
        c = torch.where(active, new_c, c)
        comp = torch.where(active, new_comp, comp)

    # final flush of the still-open run
    has_cur = cur_len > 0
    fits = has_cur & (nrun < run_cap)
    slot = torch.where(fits, nrun, run_cap).long()
    ops[rows, slot] = cur_op.to(torch.uint8)
    lens[rows, slot] = cur_len.to(torch.uint8)
    nrun = nrun + fits.to(i32)
    overflow = overflow | (has_cur & ~fits) | (nrun > run_cap) | active
    return ops[:, :run_cap], lens[:, :run_cap], nrun, overflow


#: the cells a round trip of csrc/dense_traceback.cu loads, by the
#: pattern of the walker's component (S, I, D) and lane: lane l reads
#: (d - back, c + dc) from the round's first cell (d, c). From an S cell:
#: the cell, its X successor and the first cell of each gap chain (its
#: NCHAIN = 1); from a gap cell: eight cells of its own chain (NGAP).
WALK_CELLS = (
    ((0, 0), (2, 0), (1, -1), (1, 1)),
    tuple((j, -j) for j in range(8)),
    tuple((j, j) for j in range(8)),
)


def dense_traceback_groups(planes, scores, cert, qlens, tlens, run_cap: int):
    """Plain emulation of csrc/dense_traceback.cu's schedule over the
    plain walk's hops: a round trip loads the `WALK_CELLS` of the walker's
    component from the first cell the walk needs, under the walk's guard,
    and the next round starts at the first hop whose cell the round did
    not load. Returns (the packed rows of `pack_alignments`, stats (3, B)
    int32: hops, round trips and modeled sectors a pair, the distinct
    32-byte sectors of the plane that each round's loaded cells lie in;
    the kernel counts the first two), on any device."""
    D2, B, K = planes.shape
    dev = planes.device
    i32 = torch.int32
    trace = []
    ops, lens, nruns, overflow = dense_traceback_ref(planes, scores, qlens, tlens, run_cap, trace)
    # the patterns' cells, padded to one width with cells behind the walk
    # (back -1: never hit, not loaded)
    n = max(len(p) for p in WALK_CELLS)
    padded = [list(p) + [(-1, 0)] * (n - len(p)) for p in WALK_CELLS]
    back_t = torch.tensor([[b for b, _ in p] for p in padded], dtype=i32, device=dev)
    dc_t = torch.tensor([[x for _, x in p] for p in padded], dtype=i32, device=dev)
    rows = torch.arange(B, device=dev)[:, None]
    stats = torch.zeros((3, B), dtype=i32, device=dev)
    pat = torch.full((B,), -1, dtype=i32, device=dev)  # no round loaded yet
    td = torch.zeros(B, dtype=i32, device=dev)
    tc = torch.zeros(B, dtype=i32, device=dev)
    for d, c, comp, active in trace:
        # a lane of the pair's round loaded (d, c), or a round starts there
        p = pat.clamp(min=0).long()
        hit = (back_t[p] == (td - d)[:, None]) & (dc_t[p] == (c - tc)[:, None])
        need = active & ~(hit & (pat >= 0)[:, None]).any(1)
        td = torch.where(need, d, td)
        tc = torch.where(need, c, tc)
        pat = torch.where(need, torch.where(comp == 0, 0, torch.where(comp % 2 == 1, 1, 2)), pat)
        p = pat.clamp(min=0).long()
        fd, fc = td[:, None] - back_t[p], tc[:, None] + dc_t[p]
        inside = (back_t[p] >= 0) & (fd >= 1) & (fd <= D2) & (fc >= 0) & (fc < K)
        sector = ((((fd.long() - 1) * B + rows) * K + fc) * 2) >> 5
        sector = torch.where(inside, sector, -1).sort(1).values
        new = sector >= 0
        new[:, 1:] &= sector[:, 1:] != sector[:, :-1]
        stats[0] += active.to(i32)
        stats[1] += need.to(i32)
        stats[2] += torch.where(need, new.sum(1, dtype=i32), 0)
    return pack_alignments(scores, cert, ops, lens, nruns, overflow), stats


def pack_alignments(scores, cert, ops, lens, nruns, overflow) -> torch.Tensor:
    """Plain version of the packed-result epilogue (reference:
    allwave_tpu/wfa/dense.py dense_align_packed). One row per pair:

        [score, nruns, cert, overflow, M, M+X, M+X+D, M+X+I as 8
         little-endian int32 | ops 2-bit packed, ceil(cap/4) bytes |
         lens, cap bytes]

    with op codes M=0, X=1, I=2, D=3 (an empty slot packs as 3)."""
    B, cap = ops.shape
    i32 = torch.int32
    valid = torch.arange(cap, device=ops.device)[None, :] < nruns[:, None]
    l32 = torch.where(valid, lens.to(i32), 0)
    m_ct = torch.where(ops == _OP_M, l32, 0).sum(1, dtype=i32)
    x_ct = torch.where(ops == _OP_X, l32, 0).sum(1, dtype=i32)
    i_ct = torch.where(ops == _OP_I, l32, 0).sum(1, dtype=i32)
    d_ct = torch.where(ops == _OP_D, l32, 0).sum(1, dtype=i32)
    meta = torch.stack(
        [
            scores.to(i32),
            nruns.to(i32),
            cert.to(i32),
            overflow.to(i32),
            m_ct,  # num_matches
            m_ct + x_ct,  # alignment_length (gaps excluded)
            m_ct + x_ct + d_ct,  # query bases consumed (WFA2 I/D swap)
            m_ct + x_ct + i_ct,  # target bases consumed
        ],
        dim=1,
    )
    meta_u8 = meta.contiguous().view(torch.uint8).reshape(B, 32)
    if cap % 4:
        ops = torch.cat(
            [ops, torch.zeros((B, 4 - cap % 4), dtype=ops.dtype, device=ops.device)],
            1,
        )
    code = torch.where(
        ops == _OP_M,
        0,
        torch.where(ops == _OP_X, 1, torch.where(ops == _OP_I, 2, 3)),
    ).to(torch.uint8)
    ops_packed = (
        code[:, 0::4]
        | (code[:, 1::4] << 2)
        | (code[:, 2::4] << 4)
        | (code[:, 3::4] << 6)
    )
    return torch.cat([meta_u8, ops_packed, lens], dim=1)


class ForwardDesign(NamedTuple):
    """What a forward launch at one (K, l_pad, B) runs: the fields of the
    code `allwave_dense_forward_design` returns (tiers 1-2, in
    csrc/dense_forward.cu) or, for tier 3, of the replay cluster's
    design in csrc/dense_span.cu (`segmented.span_design` over the full
    band) that it launches from the origin."""

    code: int
    tier: int  # 1: a warp a pair; 2: a block a pair, a halo; 3: a cluster a pair
    lanes_per_thread: int
    warps_per_pair: int
    stage_bases: bool  # base tables in shared memory (tier 1; tiers 2-3 always)
    blocks_per_pair: int  # the cluster G (tier 3), else 1
    span_code: int  # tier 3: the code of its span design, else 0


def forward_design(K: int, l_pad: int, B: int, two_piece: bool,
                   stage_bases: Optional[bool] = None) -> ForwardDesign:
    """The forward's design at band K and l_pad for B pairs, from its C
    dispatch; tier 3's cluster from the span's dispatch (the cluster size
    depends on how many of B's clusters the card holds at once).
    `stage_bases` overrides where tier 1 reads the bases. Raises for a
    design that cannot run."""
    from . import cuda_build

    lib = cuda_build.library("dense_forward")
    code = lib.allwave_dense_forward_design(K, l_pad, -1 if stage_bases is None else int(stage_bases))
    if code < 0:
        raise ValueError(f"no forward design for K={K} l_pad={l_pad} stage_bases={stage_bases}")
    if code & 3 != 3:
        return ForwardDesign(code, code & 3, (code >> 2) & 63, (code >> 8) & 255,
                             bool(code >> 16 & 1), 1, 0)
    from .segmented import span_design

    g = span_design(K, K, True, B, two_piece)
    warps = g.blocks_per_pair * g.lanes_per_block // (32 * g.lanes_per_thread)
    return ForwardDesign(code, 3, g.lanes_per_thread, warps, True, g.blocks_per_pair, g.code)


def _check_cuda(name: str, t: torch.Tensor, dtype, shape) -> None:
    if t.device.type != "cuda" or t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(
            f"{name}: expected a CUDA {dtype} tensor of shape {shape}, got "
            f"{t.device} {t.dtype} {tuple(t.shape)}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _device_kind(t: torch.Tensor) -> str:
    kind = t.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return kind


def dense_forward(
    qs, ts, qlens, tlens, pen: Penalties, k_width: int, l_pad: int,
    stage_bases: Optional[bool] = None,
):
    """Forward sweep: the plain version for CPU tensors, the kernels for
    CUDA tensors: tiers 1-2 csrc/dense_forward.cu's, tier 3 the replay
    cluster of csrc/dense_span.cu over the full band from the origin
    state, then the scores and certificates from its end state
    (dense_forward.cu's `dense_forward_finish_kernel`). Same outputs as
    `dense_forward_ref`. `stage_bases` (None: the kernel's choice) is
    for measuring the two ways tier 1 reads the bases."""
    if _device_kind(qs) == "cpu":
        return dense_forward_ref(qs, ts, qlens, tlens, pen, k_width, l_pad)
    from . import cuda_build

    B = qs.shape[0]
    K = k_width
    _check_cuda("qs", qs, torch.uint8, (B, l_pad))
    _check_cuda("ts", ts, torch.uint8, (B, l_pad))
    _check_cuda("qlens", qlens, torch.int32, (B,))
    _check_cuda("tlens", tlens, torch.int32, (B,))
    if K < 1 or l_pad < 1:
        raise ValueError(f"bad band width {K} or l_pad {l_pad}")
    dev = qs.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    scores = torch.empty(B, dtype=torch.int32, device=dev)
    cert = torch.empty(B, dtype=torch.uint8, device=dev)
    planes = torch.empty((2 * l_pad, B, K), dtype=torch.uint16, device=dev)
    design = forward_design(K, l_pad, B, pen.two_piece, stage_bases)
    lib = cuda_build.library("dense_forward")
    if design.tier == 3:
        # the span's replay from d = 0 (a null state_in is the origin
        # state), its plane rows the forward's, then the epilogue
        state = torch.empty((5, B, K), dtype=torch.int32, device=dev)
        rc = cuda_build.library("dense_span").allwave_dense_span(
            qs.data_ptr(), ts.data_ptr(), qlens.data_ptr(), tlens.data_ptr(), None,
            B, l_pad, K, K, 0, 2 * l_pad, pen.x, pen.o1, pen.e1, pen.o2, pen.e2,
            int(pen.two_piece), 1, design.span_code, None, 0,
            state.data_ptr(), state.stride(0), planes.data_ptr(), stream,
        )
        cuda_build.check(rc, "dense_forward tier-3 cluster launch")
        rc = lib.allwave_dense_forward_finish(
            qlens.data_ptr(), tlens.data_ptr(), B, l_pad, K, pen.o1, pen.e1, pen.o2, pen.e2,
            int(pen.two_piece), state.data_ptr(), scores.data_ptr(), cert.data_ptr(), stream,
        )
        cuda_build.check(rc, "dense_forward epilogue launch")
    else:
        rc = lib.allwave_dense_forward(
            qs.data_ptr(), ts.data_ptr(), qlens.data_ptr(), tlens.data_ptr(),
            B, l_pad, K, pen.x, pen.o1, pen.e1, pen.o2, pen.e2,
            int(pen.two_piece), design.code,
            scores.data_ptr(), cert.data_ptr(), planes.data_ptr(), stream,
        )
        cuda_build.check(rc, "dense_forward kernel launch")
    forward_launches.launched((B, K, l_pad), design)
    return scores, cert.bool(), planes


def dense_traceback(planes, scores, cert, qlens, tlens, run_cap: int, stats=None):
    """Traceback + packed result, (B, 32 + ceil(run_cap/4) + run_cap)
    uint8: the plain versions for CPU tensors, the
    csrc/dense_traceback.cu kernel for CUDA tensors. `stats` ((2, B)
    int32, CUDA only) receives each pair's hops and round trips."""
    if _device_kind(planes) == "cpu":
        if stats is not None:
            raise ValueError("stats count a kernel's round trips: CUDA tensors only "
                             "(dense_traceback_groups emulates them)")
        ops, lens, nruns, overflow = dense_traceback_ref(
            planes, scores, qlens, tlens, run_cap
        )
        return pack_alignments(scores, cert, ops, lens, nruns, overflow)
    from . import cuda_build

    D2, B, K = planes.shape
    _check_cuda("planes", planes, torch.uint16, (D2, B, K))
    _check_cuda("scores", scores, torch.int32, (B,))
    _check_cuda("qlens", qlens, torch.int32, (B,))
    _check_cuda("tlens", tlens, torch.int32, (B,))
    cert_u8 = cert.to(torch.uint8).contiguous()
    _check_cuda("cert", cert_u8, torch.uint8, (B,))
    if stats is not None:
        _check_cuda("stats", stats, torch.int32, (2, B))
    if run_cap < 1:
        raise ValueError(f"bad run_cap {run_cap}")
    out = torch.empty(
        (B, 32 + (run_cap + 3) // 4 + run_cap), dtype=torch.uint8, device=planes.device
    )
    lib = cuda_build.library("dense_traceback")
    rc = lib.allwave_dense_traceback(
        planes.data_ptr(), scores.data_ptr(), cert_u8.data_ptr(),
        qlens.data_ptr(), tlens.data_ptr(), B, D2, K, run_cap,
        out.data_ptr(), None if stats is None else stats.data_ptr(),
        torch.cuda.current_stream(planes.device).cuda_stream,
    )
    cuda_build.check(rc, "dense_traceback kernel launch")
    traceback_launches.launched((B, K, D2 // 2, run_cap))
    return out


def dense_align_packed(
    pool, qidx, tidx, qlens, tlens, pen: Penalties, k_width: int, l_pad: int,
    run_cap: int,
) -> torch.Tensor:
    """Fused alignment step (reference: allwave_tpu/wfa/dense.py
    dense_align_packed): gather the batch rows from the sequence pool,
    run the forward sweep, walk the plane and pack the result —
    (B, 32 + ceil(run_cap/4) + run_cap) uint8, see pack_alignments."""
    qs = pool.index_select(0, qidx)
    ts = pool.index_select(0, tidx)
    scores, cert, planes = dense_forward(qs, ts, qlens, tlens, pen, k_width, l_pad)
    return dense_traceback(planes, scores, cert, qlens, tlens, run_cap)
