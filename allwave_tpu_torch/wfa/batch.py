"""Batched wavefront alignment in PyTorch (reference:
allwave_tpu/wfa/batch.py): the device passes of the batched wavefront
engine (wfa/engine.py) and the helpers the wavefront checkpoint-replay
engine (wfa/wf_segmented.py) shares with it.

Conventions are the reference's: pattern = query (v), text = target
(h), diagonal k = h - v, a wavefront stores the offset h per diagonal,
NULL marks a diagonal with no value, CIGAR ops in the WFA2 byte
convention. A batch of B pairs runs at once; per pair the band holds K
diagonals [k0, k0 + K) around 0 and k_end = tlen - qlen.

Two passes, each with two versions:

* `wavefront_forward`: the score sweep. Every score level s computes
  the five components M, I1, D1, I2, D2 of the band from a rolling
  buffer of the last D = pen.max_lookback + 1 levels, extends M greedily
  along its diagonals, and ends when the pair reaches (tlen, k_end) or
  s_cap. With history it also keeps every level's five planes,
  (s_cap + 1, B, K) int32 each.
* `wavefront_traceback`: the walk of those planes from (s*, k_end, M)
  to the origin, emitting (op, run) pairs end -> start into
  (B, run_cap) buffers with the run count and an overflow flag.

`wavefront_forward_ref` and `wavefront_traceback_ref` are the plain
versions, a line-by-line transcription of the reference's XLA loops;
they run on any device, and the CPU tests hold them to the reference.
`wavefront_forward` and `wavefront_traceback` pick by the device of
their tensors: a CPU tensor takes the plain version, a CUDA tensor
launches csrc/wf_batch.cu's hand-written kernel or raises; nothing
falls back. The forward runs the design its shape picks
(`forward_design`: one block a pair with its rings in shared memory,
a cluster of blocks a pair, or the rings in device memory for bands
too wide for a cluster of 16), the walk a warp a pair;
`wavefront_traceback_rounds` emulates the walk's round trips on the
CPU. Each wrapper counts its launches and the design each shape ran
(`forward_launches`, `traceback_launches`).

History rows above a finished pair's score are don't-care. The
reference's loop runs until every pair of the batch is done, so a pair
that finished early gets rows up to the batch's last level and NULL
rows after it; the kernel runs a block a pair and stops each pair at its
own score, leaving the rows above it unwritten. The defined rows are
0..scores[b] of a finished pair and every row of an unfinished one; the
traceback reads nothing above scores[b], so no output depends on the
rest.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ..utils.telemetry import counters
from .dense import LaunchCount, _check_cuda, _device_kind
from .params import Penalties

NULL = -(2**30)

# op codes of the run buffers (the core.types byte values)
_OP_M = ord("M")
_OP_X = ord("X")
_OP_I = ord("I")
_OP_D = ord("D")

# component codes of the traceback's state machine, and the order of
# the history planes
_C_M, _C_I1, _C_D1, _C_I2, _C_D2 = 0, 1, 2, 3, 4
COMPS = ("m", "i1", "d1", "i2", "d2")

#: csrc/wf_batch.cu reads each sequence row 8 bytes at a time: rows of
#: the CUDA forward are a multiple of this many bytes
L_ALIGN = 8

forward_launches = LaunchCount()
traceback_launches = LaunchCount()

#: the forward's designs by their tier code (csrc/wf_batch_tiers.cuh)
TIERS = ("block", "cluster", "global")
#: the walk's rounds (csrc/wf_batch.cu): an M round loads the candidates
#: of WALK_XCH M positions (the state and its X successors) and WALK_NCH
#: cells of each gap chain, a gap round WALK_GAP_CELLS cells of its chain
WALK_XCH = 3
WALK_NCH = 4
WALK_GAP_CELLS = 32


class ForwardDesign(NamedTuple):
    """A design of csrc/wf_batch.cu's forward, decoded from the code of
    its C dispatch (`allwave_wf_batch_forward_design`)."""

    code: int
    tier: str  # "block", "cluster" or "global"
    staged: bool  # the sequence rows in shared memory
    blocks_per_pair: int
    lanes_per_thread: int  # 0 for global
    lanes_per_block: int  # 0 for global
    held: int  # clusters (blocks for one a pair) the card holds at once; 0 for global


def decode_design(code: int, held: int = 0) -> ForwardDesign:
    return ForwardDesign(code, TIERS[code & 3], bool(code >> 2 & 1), (code >> 3) & 31,
                         (code >> 8) & 15, code >> 12, held)


_designs: Dict[tuple, ForwardDesign] = {}


def forward_design(K: int, B: int, l_pad: int, pen: Penalties,
                   tier: Optional[str] = None) -> ForwardDesign:
    """The forward's design for B pairs of rows of l_pad bytes on a band
    of K lanes, from its C dispatch on the current card (memoised per
    device and shape): the tier table of csrc/wf_batch_tiers.cuh on the
    card's shared memory and SM count, a cluster's size by its
    occupancy. tier="global" forces the global design (to time it beside
    the others). Raises for a shape no design takes."""
    import ctypes

    from . import cuda_build

    if tier not in (None, "global"):
        raise ValueError(f"only the global design can be forced, not {tier!r}")
    force = -1 if tier is None else TIERS.index(tier)
    key = (torch.cuda.current_device(), K, B, l_pad, pen, force)  # the C side reads this device
    if key not in _designs:
        held = ctypes.c_int(0)
        code = cuda_build.library("wf_batch").allwave_wf_batch_forward_design(
            K, B, l_pad, pen.max_lookback + 1, pen.e1, pen.e2, int(pen.two_piece), force,
            ctypes.byref(held))
        if held.value < 0:
            cuda_build.check(-held.value, "cudaOccupancyMaxActiveClusters")
        if code < 0:
            raise ValueError(f"no wf_batch forward design for K={K} B={B} {pen}")
        _designs[key] = decode_design(code, held.value)
    return _designs[key]


class ForwardResult(NamedTuple):
    scores: torch.Tensor  # (B,) int32; -1 where not finished within s_cap
    done: torch.Tensor  # (B,) bool


def pack_quads(seqs: torch.Tensor) -> torch.Tensor:
    """(B, L) uint8 -> (B, L) int64 where out[b, i] packs bytes
    seq[b, i..i+4) little-endian, zeros past the end: the reference's
    uint32 words, held in int64 (torch's uint32 lacks the bit ops)."""
    s = seqs.to(torch.int64)
    out = s.clone()
    for j in range(1, min(4, s.shape[1])):
        out[:, :-j] |= s[:, j:] << (8 * j)
    return out


def _shift_right(a: torch.Tensor) -> torch.Tensor:
    """Along the last (diagonal) axis: out[..., c] = a[..., c-1], NULL in."""
    return torch.cat([torch.full_like(a[..., :1], NULL), a[..., :-1]], -1)


def _shift_left(a: torch.Tensor) -> torch.Tensor:
    """out[..., c] = a[..., c+1], NULL in."""
    return torch.cat([a[..., 1:], torch.full_like(a[..., :1], NULL)], -1)


def _extend(h, k, h_max, q4, t4):
    """Greedy match-run extension of offsets `h` (B, K) along their
    diagonals, 4 bases a compare (quad-packed rows q4/t4). The iteration
    bound ceil(L/4) + 2 is the reference's; it never binds."""
    lq, lt = q4.shape[1], t4.shape[1]
    max_iters = min(lq, lt) // 4 + 2
    cont = (h > NULL) & (h < h_max)
    it = 0
    while it < max_iters and bool(cont.any()):
        sv = (h - k).clamp(0, lq - 1).long()
        sh = h.clamp(0, lt - 1).long()
        x = torch.gather(q4, 1, sv) ^ torch.gather(t4, 1, sh)
        n = (
            ((x & 0xFF) == 0).int()
            + ((x & 0xFFFF) == 0).int()
            + ((x & 0xFFFFFF) == 0).int()
            + (x == 0).int()
        )
        allowed = h_max - h
        step = torch.minimum(n, allowed)
        h = h + torch.where(cont & (step > 0), step, 0)
        cont = cont & (n >= 4) & (allowed > 4)
        it += 1
    return h


def _wavefront_step(pen: Penalties, s: int, buf: Dict[str, torch.Tensor], k, h_max, q4, t4):
    """The five components at score s from the rolling buffer `buf`
    (comp -> (D, B, K); buf[comp][s' % D] holds score s')."""
    D = buf["m"].shape[0]

    def src(comp, ds):
        if s < ds:
            return torch.full_like(buf[comp][0], NULL)
        return buf[comp][(s - ds) % D]

    def trim(a):
        return torch.where(a > h_max, NULL, a)

    def plus1(a):
        return torch.where(a > NULL, a + 1, NULL)

    # I1[s][k] = max(M[s-o1-e1][k-1], I1[s-e1][k-1]) + 1
    i1 = trim(plus1(torch.maximum(
        _shift_right(src("m", pen.o1 + pen.e1)), _shift_right(src("i1", pen.e1)))))
    # D1[s][k] = max(M[s-o1-e1][k+1], D1[s-e1][k+1])
    d1 = trim(torch.maximum(
        _shift_left(src("m", pen.o1 + pen.e1)), _shift_left(src("d1", pen.e1))))
    best = torch.maximum(i1, d1)
    if pen.two_piece:
        i2 = trim(plus1(torch.maximum(
            _shift_right(src("m", pen.o2 + pen.e2)), _shift_right(src("i2", pen.e2)))))
        d2 = trim(torch.maximum(
            _shift_left(src("m", pen.o2 + pen.e2)), _shift_left(src("d2", pen.e2))))
        best = torch.maximum(best, torch.maximum(i2, d2))
    else:
        i2 = torch.full_like(i1, NULL)
        d2 = torch.full_like(i1, NULL)
    mis = trim(plus1(src("m", pen.x)))
    m = trim(_extend(torch.maximum(best, mis), k, h_max, q4, t4))
    return m, i1, d1, i2, d2


def _band_geometry(qlens: torch.Tensor, tlens: torch.Tensor, K: int):
    """(k_end, k0): the band covers diagonals [k0, k0+K), always holding
    0 and k_end = tlen - qlen, with the slack split evenly. Unlike the
    dense engine's band_geometry (wfa/dense.py), k0 is not even-aligned."""
    k_end = tlens - qlens
    slack = torch.div(K - 1 - k_end.abs(), 2, rounding_mode="floor")
    return k_end, k_end.clamp(max=0) - slack


def _make_masks(qlens: torch.Tensor, tlens: torch.Tensor, k0: torch.Tensor, K: int):
    """(ks, h_max), both (B, K): each band diagonal's k and the largest
    offset it can hold, min(tlen, qlen + k); -1 on diagonals outside
    [-qlen, tlen]."""
    ks = k0[:, None] + torch.arange(K, dtype=k0.dtype, device=k0.device)[None, :]
    h_max = torch.minimum(tlens[:, None], qlens[:, None] + ks)
    valid = (ks >= -qlens[:, None]) & (ks <= tlens[:, None])
    return ks, torch.where(valid, h_max, -1)


def _history_planes(s_cap: int, B: int, K: int, device, fill: Optional[int]):
    """The five history planes as views of one (5, s_cap+1, B, K) int32
    tensor, NULL-filled when `fill` is given, else uninitialised."""
    shape = (len(COMPS), s_cap + 1, B, K)
    if fill is None:
        hist = torch.empty(shape, dtype=torch.int32, device=device)
    else:
        hist = torch.full(shape, fill, dtype=torch.int32, device=device)
    return dict(zip(COMPS, hist.unbind(0)))


def wavefront_forward_ref(qs, ts, qlens, tlens, pen: Penalties, s_cap: int, k_width: int,
                          with_history: bool = False):
    """Plain version of `wavefront_forward` (reference: batch.py
    wavefront_forward): every level runs for the whole batch until all
    pairs are done or s_cap."""
    B = qs.shape[0]
    K = k_width
    D = pen.max_lookback + 1
    dev = qs.device
    qlens = qlens.to(torch.int32)
    tlens = tlens.to(torch.int32)
    q4 = pack_quads(qs)
    t4 = pack_quads(ts)
    k_end, k0 = _band_geometry(qlens, tlens, K)
    ks, h_max = _make_masks(qlens, tlens, k0, K)
    # pairs whose |len diff| exceeds the band can never finish here
    feasible = k_end.abs() <= K - 1
    c_end = (k_end - k0).clamp(0, K - 1).long()

    buf = {c: torch.full((D, B, K), NULL, dtype=torch.int32, device=dev) for c in COMPS}
    # score 0: M[0] = 0 on diagonal 0 (band index -k0), extended
    lanes = torch.arange(K, dtype=torch.int32, device=dev)[None, :]
    m0 = torch.where(lanes == (-k0)[:, None], 0, NULL).to(torch.int32)
    m0 = _extend(m0, ks, h_max, q4, t4)
    m0 = torch.where(m0 > h_max, NULL, m0)
    buf["m"][0] = m0
    hist = _history_planes(s_cap, B, K, dev, NULL) if with_history else None
    if with_history:
        hist["m"][0] = m0

    done = (m0.gather(1, c_end[:, None])[:, 0] == tlens) & feasible
    scores = torch.where(done, 0, -1).to(torch.int32)
    s = 0
    while s < s_cap and not bool(done.all()):
        s += 1
        planes = _wavefront_step(pen, s, buf, ks, h_max, q4, t4)
        for c, p in zip(COMPS, planes):
            buf[c][s % D] = p
            if with_history:
                hist[c][s] = p
        done_now = (planes[0].gather(1, c_end[:, None])[:, 0] == tlens) & feasible & ~done
        scores = torch.where(done_now, s, scores)
        done = done | done_now
    return scores, done, hist


def wavefront_forward(qs, ts, qlens, tlens, pen: Penalties, s_cap: int, k_width: int,
                      with_history: bool = False, design: Optional[str] = None):
    """Run the batched wavefront DP until every pair terminates or
    s_cap. Returns (scores (B,) int32, -1 where not finished; done (B,)
    bool; history: a dict comp -> (s_cap+1, B, K) int32 plane when
    with_history, else None). qs/ts (B, l_pad) uint8, qlens/tlens (B,)
    int32. CPU tensors take the plain version; CUDA tensors launch
    csrc/wf_batch.cu's forward in the design `forward_design` picks
    (l_pad a multiple of L_ALIGN); design="global" forces the global
    one, which exists to be timed beside the others. On the card the
    rows above a finished pair's score are left unwritten (module
    docstring)."""
    counters.add(dispatches=1)
    if _device_kind(qs) == "cpu":
        if design is not None:
            raise ValueError("the plain version has no designs")
        return wavefront_forward_ref(qs, ts, qlens, tlens, pen, s_cap, k_width, with_history)
    from . import cuda_build

    B, l_pad = qs.shape
    K = k_width
    _check_cuda("qs", qs, torch.uint8, (B, l_pad))
    _check_cuda("ts", ts, torch.uint8, (B, l_pad))
    _check_cuda("qlens", qlens, torch.int32, (B,))
    _check_cuda("tlens", tlens, torch.int32, (B,))
    if K < 1 or s_cap < 0 or l_pad < 1 or l_pad % L_ALIGN:
        raise ValueError(f"bad band width {K}, s_cap {s_cap} or l_pad {l_pad} "
                         f"(a multiple of {L_ALIGN} on the card)")
    if qs.data_ptr() % L_ALIGN or ts.data_ptr() % L_ALIGN:
        raise ValueError(f"qs and ts rows must start {L_ALIGN}-byte aligned")
    dev = qs.device
    D = pen.max_lookback + 1
    scores = torch.empty(B, dtype=torch.int32, device=dev)
    done = torch.empty(B, dtype=torch.uint8, device=dev)
    hist = _history_planes(s_cap, B, K, dev, None) if with_history else None
    with torch.cuda.device(dev):  # the design and the launch read the current device
        g = forward_design(K, B, l_pad, pen, design)
        # the global design's rolling buffer, (B, 5, D, K); the others
        # keep their rings in shared memory
        ring = (torch.empty((B, len(COMPS), D, K), dtype=torch.int32, device=dev)
                if g.tier == "global" else None)
        rc = cuda_build.library("wf_batch").allwave_wf_batch_forward(
            qs.data_ptr(), ts.data_ptr(), qlens.data_ptr(), tlens.data_ptr(),
            B, l_pad, K, s_cap, D, pen.x, pen.o1, pen.e1, pen.o2, pen.e2,
            int(pen.two_piece), int(with_history), g.code,
            None if ring is None else ring.data_ptr(),
            hist["m"].data_ptr() if with_history else None,
            scores.data_ptr(), done.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    cuda_build.check(rc, "wf_batch_forward kernel launch")
    forward_launches.launched((B, K, l_pad, s_cap, bool(with_history)), g)
    return scores, done.bool(), hist


def wavefront_traceback_ref(hist: dict, scores, qlens, tlens, pen: Penalties, run_cap: int):
    """Plain version of `wavefront_traceback` (reference: batch.py
    wavefront_traceback): every lane walks one step an iteration until
    no lane is active or the iteration bound 3 * run_cap + 8."""
    S1, B, K = hist["m"].shape
    dev = scores.device
    i32 = torch.int32
    qlens = qlens.to(i32)
    tlens = tlens.to(i32)
    k_end, k0 = _band_geometry(qlens, tlens, K)
    lanes = torch.arange(B, device=dev)
    flat = {c: hist[c].reshape(-1) for c in COMPS}

    def fetch(comp, s, c):
        """plane[(s, b, c)] per lane b, NULL when s or c is out of range."""
        ok = (s >= 0) & (s < S1) & (c >= 0) & (c < K)
        idx = (s.clamp(0, S1 - 1).long() * B + lanes) * K + c.clamp(0, K - 1).long()
        return torch.where(ok, flat[comp][idx], NULL)

    ops = torch.zeros((B, run_cap), dtype=torch.uint8, device=dev)
    lens = torch.zeros((B, run_cap), dtype=i32, device=dev)
    nrun = torch.zeros(B, dtype=i32, device=dev)

    def emit(nrun, do, op, count):
        """Append a run on the lanes where `do` and count > 0."""
        do = do & (count > 0)
        idx = nrun.clamp(0, run_cap - 1).long()
        ops[lanes, idx] = torch.where(do, op, ops[lanes, idx])
        lens[lanes, idx] = torch.where(do, count, lens[lanes, idx])
        return nrun + do.to(i32)

    s = scores.to(i32)
    c = (k_end - k0).to(i32)
    h = tlens.clone()
    comp = torch.full((B,), _C_M, dtype=i32, device=dev)
    active = scores >= 0
    overflow = torch.zeros(B, dtype=torch.bool, device=dev)
    max_iters = 3 * run_cap + 8
    it = 0
    while it < max_iters and bool(active.any()):
        is_m = comp == _C_M
        at_origin = is_m & (s == 0)
        # M state: tie order X, I1, I2, D1, D2
        mis_v = fetch("m", s - pen.x, c)
        cand_x = torch.where(mis_v > NULL, mis_v + 1, NULL)
        cand = [fetch(k, s, c) for k in ("i1", "d1", "i2", "d2")]
        cand_i1, cand_d1, cand_i2, cand_d2 = cand
        pre = torch.stack([cand_x, *cand]).amax(0)
        choice = torch.where(
            cand_x == pre, _C_M, torch.where(
                cand_i1 == pre, _C_I1, torch.where(
                    cand_i2 == pre, _C_I2, torch.where(cand_d1 == pre, _C_D1, _C_D2))))
        n_match = torch.where(at_origin, h, h - pre)
        # gap states: prefer extend over open
        i1_ext = fetch("i1", s - pen.e1, c - 1)
        i2_ext = fetch("i2", s - pen.e2, c - 1)
        d1_ext = fetch("d1", s - pen.e1, c + 1)
        d2_ext = fetch("d2", s - pen.e2, c + 1)
        ext_ok = torch.where(
            comp == _C_I1, (i1_ext > NULL) & (i1_ext + 1 == h), torch.where(
                comp == _C_I2, (i2_ext > NULL) & (i2_ext + 1 == h), torch.where(
                    comp == _C_D1, (d1_ext > NULL) & (d1_ext == h),
                    (d2_ext > NULL) & (d2_ext == h))))
        is_i = (comp == _C_I1) | (comp == _C_I2)
        is_d = (comp == _C_D1) | (comp == _C_D2)
        piece1 = (comp == _C_I1) | (comp == _C_D1)
        gap_e = torch.where(piece1, pen.e1, pen.e2)
        gap_oe = torch.where(piece1, pen.o1 + pen.e1, pen.o2 + pen.e2)
        # runs
        nrun = emit(nrun, active & is_m, _OP_M, torch.where(is_m, n_match, 0))
        mismatch = active & is_m & ~at_origin & (choice == _C_M)
        nrun = emit(nrun, mismatch, _OP_X, mismatch.to(i32))
        nrun = emit(nrun, active & is_i, _OP_I, (active & is_i).to(i32))
        nrun = emit(nrun, active & is_d, _OP_D, (active & is_d).to(i32))
        # transitions
        new_s = torch.where(is_m, torch.where(choice == _C_M, s - pen.x, s),
                            torch.where(ext_ok, s - gap_e, s - gap_oe))
        new_h = torch.where(is_m, torch.where(choice == _C_M, pre - 1, pre),
                            torch.where(is_i, h - 1, h))
        new_c = torch.where(is_m, c, torch.where(is_i, c - 1, c + 1))
        new_comp = torch.where(is_m, choice, torch.where(ext_ok, comp, _C_M))
        overflow = overflow | (active & (nrun >= run_cap))
        active = active & ~at_origin & ~overflow
        s = torch.where(active, new_s, s).to(i32)
        h = torch.where(active, new_h, h).to(i32)
        c = torch.where(active, new_c, c).to(i32)
        comp = torch.where(active, new_comp, comp).to(i32)
        it += 1
    # lanes still active at the bound hit a logic bug: flag as overflow
    return ops, lens, nrun, overflow | active


def wavefront_traceback(hist: dict, scores, qlens, tlens, pen: Penalties, run_cap: int,
                        stats=None, design: str = "warp"):
    """Walk the history planes (comp -> (S+1, B, K) int32) from each
    finished pair's end to the origin. Returns (ops (B, run_cap) uint8,
    lens (B, run_cap) int32, nruns (B,) int32, overflow (B,) bool); runs
    in REVERSE alignment order (end -> start), nothing for a pair whose
    score is < 0. CPU tensors take the plain version; CUDA tensors
    launch csrc/wf_batch.cu's walk, a warp a pair (`wf_batch_walk_kernel`),
    which fills `stats` ((2, B) int32 on the card: steps and round trips
    a pair) when given. design="thread" runs the first design, a thread a
    pair, which exists to be timed beside it and keeps no stats."""
    counters.add(dispatches=1)
    if _device_kind(scores) == "cpu":
        if stats is not None or design != "warp":
            raise ValueError("the plain walk keeps no stats and has no designs: "
                             "wavefront_traceback_rounds emulates the kernel's")
        return wavefront_traceback_ref(hist, scores, qlens, tlens, pen, run_cap)
    from . import cuda_build

    S1, B, K = hist["m"].shape
    for c in COMPS:
        _check_cuda(f"hist[{c!r}]", hist[c], torch.int32, (S1, B, K))
    _check_cuda("scores", scores, torch.int32, (B,))
    _check_cuda("qlens", qlens, torch.int32, (B,))
    _check_cuda("tlens", tlens, torch.int32, (B,))
    if run_cap < 1:
        raise ValueError(f"bad run_cap {run_cap}")
    if design not in ("warp", "thread") or (design == "thread" and stats is not None):
        raise ValueError(f"bad walk design {design!r} (stats only with 'warp')")
    if stats is not None:
        _check_cuda("stats", stats, torch.int32, (2, B))
    dev = scores.device
    ops = torch.zeros((B, run_cap), dtype=torch.uint8, device=dev)
    lens = torch.zeros((B, run_cap), dtype=torch.int32, device=dev)
    nruns = torch.empty(B, dtype=torch.int32, device=dev)
    overflow = torch.empty(B, dtype=torch.uint8, device=dev)
    rc = cuda_build.library("wf_batch").allwave_wf_batch_traceback(
        *(hist[c].data_ptr() for c in COMPS), scores.data_ptr(),
        qlens.data_ptr(), tlens.data_ptr(), S1, B, K,
        pen.x, pen.o1, pen.e1, pen.o2, pen.e2, run_cap, int(design == "thread"),
        ops.data_ptr(), lens.data_ptr(), nruns.data_ptr(), overflow.data_ptr(),
        None if stats is None else stats.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    cuda_build.check(rc, "wf_batch_traceback kernel launch")
    traceback_launches.launched((B, K, S1 - 1, run_cap), design)
    return ops, lens, nruns, overflow.bool()


def walk_cells(pat: int, s: int, c: int, pen: Penalties):
    """The cells (plane, level, lane) one round of the walk loads from
    (s, c), lane by lane (csrc/wf_batch.cu `walk_cell`): pattern _C_M the
    five candidates of the M state and of its WALK_XCH - 1 X successors
    and WALK_NCH cells of each gap chain; a gap plane (1-4) that chain's
    next WALK_GAP_CELLS cells."""
    def chain(g, n):
        e = pen.e1 if g in (_C_I1, _C_D1) else pen.e2
        d = -1 if g in (_C_I1, _C_I2) else 1
        return [(g, s - j * e, c + d * j) for j in range(1, n + 1)]

    if pat != _C_M:
        return chain(pat, WALK_GAP_CELLS)
    cells = []
    for j in range(WALK_XCH):
        s0 = s - j * pen.x
        cells += [(_C_M, s0 - pen.x, c)] + [(p, s0, c) for p in (_C_I1, _C_D1, _C_I2, _C_D2)]
    for g in (_C_I1, _C_D1, _C_I2, _C_D2):
        cells += chain(g, WALK_NCH)
    return cells


def wavefront_traceback_rounds(hist: dict, scores, qlens, tlens, pen: Penalties, run_cap: int):
    """The warp walk's schedule, emulated pair by pair on the CPU: the
    plain walk's steps, each cell taken from the round that loaded it
    (`walk_cells`) and a cell no round holds starting the next one.
    Returns wavefront_traceback's four outputs (numpy) and stats (2, B):
    steps and round trips a pair, which the kernel's must equal."""
    planes = [hist[c].cpu().numpy() for c in COMPS]  # (S1, B, K) each
    S1, B, K = planes[0].shape
    scores = np.asarray(scores.cpu() if torch.is_tensor(scores) else scores)
    qlens = np.asarray(qlens.cpu() if torch.is_tensor(qlens) else qlens)
    tlens = np.asarray(tlens.cpu() if torch.is_tensor(tlens) else tlens)
    ops = np.zeros((B, run_cap), np.uint8)
    lens = np.zeros((B, run_cap), np.int32)
    nruns = np.zeros(B, np.int32)
    overflow = np.zeros(B, bool)
    stats = np.zeros((2, B), np.int32)
    oe = {_C_I1: pen.o1 + pen.e1, _C_D1: pen.o1 + pen.e1,
          _C_I2: pen.o2 + pen.e2, _C_D2: pen.o2 + pen.e2}
    for b in range(B):
        qlen, tlen = int(qlens[b]), int(tlens[b])
        k_end = tlen - qlen
        k0 = min(0, k_end) - (K - 1 - abs(k_end)) // 2
        s, c, h, comp, nrun = int(scores[b]), k_end - k0, tlen, _C_M, 0
        active, ovf = s >= 0, False
        held, rounds = {}, 0

        def cells(want, pat):
            nonlocal held, rounds
            if not all(w in held for w in want):
                held = {}
                for p, ss, cc in walk_cells(pat, s, c, pen):
                    held.setdefault((p, ss, cc), int(planes[p][ss, b, cc])
                                    if 0 <= ss < S1 and 0 <= cc < K else NULL)
                rounds += 1
            return [held[w] for w in want]

        def emit(op, count):
            nonlocal nrun
            if count > 0:
                idx = min(max(nrun, 0), run_cap - 1)
                ops[b, idx], lens[b, idx] = op, count
                nrun += 1

        it = 0
        while active and it < 3 * run_cap + 8:
            if comp == _C_M:
                at_origin = s == 0
                mv, ci1, cd1, ci2, cd2 = cells(
                    [(_C_M, s - pen.x, c)] + [(p, s, c) for p in (_C_I1, _C_D1, _C_I2, _C_D2)],
                    _C_M)
                cx = mv + 1 if mv > NULL else NULL
                pre = max(cx, ci1, cd1, ci2, cd2)
                choice = (_C_M if cx == pre else _C_I1 if ci1 == pre else _C_I2 if ci2 == pre
                          else _C_D1 if cd1 == pre else _C_D2)
                emit(_OP_M, h if at_origin else h - pre)
                if not at_origin and choice == _C_M:
                    emit(_OP_X, 1)
                ovf = nrun >= run_cap
                active = not at_origin and not ovf
                if active:
                    if choice == _C_M:
                        s, h = s - pen.x, pre - 1
                    else:
                        h = pre
                    comp = choice
            else:
                is_i = comp in (_C_I1, _C_I2)
                e = pen.e1 if comp in (_C_I1, _C_D1) else pen.e2
                nc = c - 1 if is_i else c + 1
                (ext,) = cells([(comp, s - e, nc)], comp)
                ext_ok = ext > NULL and (ext + 1 == h if is_i else ext == h)
                emit(_OP_I if is_i else _OP_D, 1)
                ovf = nrun >= run_cap
                active = not ovf
                if active:
                    s -= e if ext_ok else oe[comp]
                    c = nc
                    h -= 1 if is_i else 0
                    if not ext_ok:
                        comp = _C_M
            it += 1
        nruns[b] = nrun
        overflow[b] = ovf or active
        stats[:, b] = (it, rounds)
    return ops, lens, nruns, overflow, stats


def walk_runs(ops_row: np.ndarray, lens_row: np.ndarray, n: int):
    """The walk's first n end-to-start runs as start-to-end (ops, lens)
    views. Zero-length runs and adjacent runs of one op may remain; the
    PAF writer (`core.cigar.runs_to_cigar_string`) skips the first and
    merges the second."""
    return ops_row[:n][::-1], lens_row[:n][::-1]


def expand_runs(ops, lens) -> np.ndarray:
    """Start-to-end runs as the per-base WFA2-convention cigar byte
    array."""
    return np.repeat(np.asarray(ops, dtype=np.uint8), np.asarray(lens, dtype=np.int64))


def expand_runs_to_cigar(ops_row: np.ndarray, lens_row: np.ndarray, n: int) -> np.ndarray:
    """Reverse the walk's end-to-start runs and expand them to the
    per-base WFA2-convention cigar byte array."""
    return expand_runs(*walk_runs(ops_row, lens_row, n))


def expand_runs_batch(ops, lens, nruns):
    """Batched expand_runs_to_cigar: (B, run_cap) end-to-start run
    buffers into per-pair per-base cigar byte arrays with ONE np.repeat.
    Returns a list of views into one backing buffer."""
    B, cap = ops.shape
    valid = np.arange(cap, dtype=np.int32)[None, :] < np.asarray(nruns)[:, None]
    l64 = lens.astype(np.int64) * valid
    ops_r = ops[:, ::-1]
    lens_r = l64[:, ::-1]
    expanded = np.repeat(ops_r.ravel(), lens_r.ravel())
    offs = np.zeros(B + 1, dtype=np.int64)
    np.cumsum(lens_r.sum(axis=1), out=offs[1:])
    return [expanded[offs[i] : offs[i + 1]] for i in range(B)]


#: op byte -> column of `runs_stats`' per-op sums (4: any other byte)
_STAT_COL = np.full(256, 4, dtype=np.int64)
_STAT_COL[[_OP_M, _OP_X, _OP_I, _OP_D]] = np.arange(4)


def runs_stats(runs) -> np.ndarray:
    """PAF stats of a list of (ops, lens) run pairs (None = failed): one
    (n, 4) int64 array of [num_matches, alignment_length, query_len,
    target_len] rows, as `core.cigar.batch_cigar_stats` gives them for
    the expanded arrays (M and X consume both sequences, I the target,
    D the query; a None row reads zeros), from one weighted bincount
    over the runs instead of a pass over every base."""
    n = len(runs)
    sizes = np.fromiter((0 if r is None else len(r[0]) for r in runs), np.int64, n)
    if not sizes.any():
        return np.zeros((n, 4), dtype=np.int64)
    held = [r for r in runs if r is not None]
    ops = np.concatenate([np.asarray(r[0], dtype=np.uint8) for r in held])
    lens = np.concatenate([np.asarray(r[1], dtype=np.int64) for r in held])
    key = np.repeat(np.arange(0, 5 * n, 5, dtype=np.int64), sizes) + _STAT_COL[ops]
    # float64 weights sum integers exactly below 2**53
    per_op = np.bincount(key, weights=lens, minlength=5 * n).reshape(n, 5).astype(np.int64)
    m, x, i, d = per_op[:, :4].T
    return np.stack([m, m + x, m + x + d, m + x + i], axis=1)
