"""Score-axis checkpoint-replay WAVEFRONT alignment for long pairs, in
PyTorch (reference: allwave_tpu/wfa/wf_segmented.py on its Pallas route,
with the kernel of allwave_tpu/wfa/pallas_wf.py).

The segmented dense engine (wfa/segmented.py) sweeps every anti-diagonal
of the band, O(L*K) cells. At low divergence the wavefront DP does
O(s*K) work instead, s the alignment score: a 100 kb pair at s ~ 1,600
is ~60x fewer cell updates. Memory stays O(s/C) ring images:

1. SWEEP: a score-only wavefront sweep from score 0 that keeps, per
   component, a ring of the last `depth` score planes (`comp_depths`)
   and copies the ring image every C = `ckpt_every` levels into one
   (n_ck, P, B, K) checkpoint tensor;
2. REPLAY backwards: per segment, re-run its C levels from the segment's
   ring image with the five (C, B, W) history planes, and advance the
   traceback walkers through them (walkers pause at the segment floor).
   Bands wider than k_sub replay a per-pair sub-band of k_sub diagonals
   around the walker (the narrow replay; the reference's influence-cone
   argument, wf_segmented.wf_replay_tb_narrow, says why that is exact).

Layouts. A ring image is one (P, B, W) int32 tensor: the components'
planes in the order m, i1, d1, i2, d2, component c's plane for score s
at index off[c] + s % depth[c] (`ring_layout`); P = 36 for the default
two-piece penalties. It is the reference's per-component rows layout
(dep, B*W/128, 128) stacked along the first axis, so a plane keeps its
bytes. History planes are (n_steps, 5, B, W), the reference's packed
(n, 5, B*W/128, 128). `rows_to_port` and `buffer_to_ring` carry the
reference's data over (numpy, no JAX).

Each step has a plain version (`wf_span_ref`, `traceback_window_ref`)
and a hand-written CUDA kernel (csrc/wf_span.cu, csrc/wf_traceback.cu).
The wrappers `wf_span` and `wf_traceback` pick by the tensors' device:
CPU tensors take the plain version, CUDA tensors the kernel and nothing
else. The span kernel is a thread-block cluster a pair; its C function
`allwave_wf_span_design` says how a span is spread, and `wf_span_design`
reads it. Launches are counted by shape in `wf_span_launches` (with
each shape's design) and `wf_traceback_launches`.
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..utils.telemetry import counters, to_host
from . import dense as D_
from .batch import (
    NULL,
    _OP_D,
    _OP_I,
    _OP_M,
    _OP_X,
    _band_geometry,
    _make_masks,
    _shift_left,
    _shift_right,
    walk_runs,
)
from .dense import LaunchCount
from .params import Penalties
from .rounds import BandLadder, SequencePool, next_pow2, pool_pairs
from .segmented import WalkDesign, narrow_offsets, walk_design_of

_C_M, _C_I1, _C_D1, _C_I2, _C_D2 = 0, 1, 2, 3, 4
_COMPS = ("m", "i1", "d1", "i2", "d2")
_I32 = torch.int32

#: TEST-ONLY mutation knob (allwave_tpu_torch/fuzz.py): deliberately flip
#: the walk's X-vs-I1 tie preference to prove the fuzz battery detects a
#: single wrong tie-break bit. Read once, when this module is imported
#: (the reference reads it at trace time): set the env var in a FRESH
#: process. Never set in production. Every walk reads it at call time,
#: the plain one, the tile emulation and the kernel's wrapper, which
#: launches the kernel's FLIP instantiation.
_TB_FLIP = os.environ.get("ALLWAVE_TB_FLIP") == "1"

#: span kernel launches, shapes (B, K, W, l_pad, n_steps, with_history)
#: (W = K on a full-band span; a sweep's n_steps is its score cap), and
#: the design of each shape
wf_span_launches = LaunchCount()
#: window-traceback kernel launches, shapes (B, K, W, n_steps, run_cap),
#: each with its `WalkDesign`
wf_traceback_launches = LaunchCount()


@dataclass
class WfStats:
    """What the engine did since the last reset: its rounds (K, s_cap,
    B), the score levels times band lanes its sweeps and replays ran,
    and the pairs it handed back as DENSE_FALLBACK."""

    rounds: List[Tuple[int, int, int]] = field(default_factory=list)
    sweep_lane_levels: int = 0
    replay_lane_levels: int = 0
    fallbacks: int = 0

    def reset(self) -> None:
        self.rounds.clear()
        self.sweep_lane_levels = 0
        self.replay_lane_levels = 0
        self.fallbacks = 0


wf_stats = WfStats()


def comp_depths(pen: Penalties) -> Dict[str, int]:
    """Ring depth (score planes) each component needs: the largest
    lookback any recurrence reads it at, plus one (reference:
    pallas_wf.comp_depths)."""
    dm = pen.max_lookback + 1
    d1 = pen.e1 + 1
    d2 = (pen.e2 + 1) if pen.two_piece else 1
    return {"m": dm, "i1": d1, "d1": d1, "i2": d2, "d2": d2}


def ring_layout(pen: Penalties) -> Tuple[Tuple[int, ...], Tuple[int, ...], int]:
    """(offsets, depths, P): component c's planes sit at ring indices
    offsets[c] .. offsets[c] + depths[c] - 1, in _COMPS order."""
    deps = tuple(comp_depths(pen)[c] for c in _COMPS)
    offs = tuple(int(x) for x in np.cumsum((0,) + deps[:-1]))
    return offs, deps, sum(deps)


# ---------------------------------------------------------------------------
# Carrying the reference's state over (numpy)
# ---------------------------------------------------------------------------


def rows_to_port(x, k_width: int) -> np.ndarray:
    """The reference's rows-layout data in the port's layout:

    * a dict comp -> (dep, B*R, 128) of ring images -> (P, B, K);
    * a dict comp -> (n_ck, dep, B*R, 128) of stacked checkpoints ->
      (n_ck, P, B, K);
    * a packed (n, 5, B*R, 128) history array -> (n, 5, B, K).

    R = K / 128. Every value keeps its bytes."""
    if isinstance(x, dict):
        parts = [np.asarray(x[c]) for c in _COMPS]
        lead = parts[0].shape[:-3]
        out = np.concatenate(parts, axis=len(lead))
        return out.reshape(out.shape[:-2] + (-1, k_width)).astype(np.int32)
    a = np.asarray(x)
    return a.reshape(a.shape[:-2] + (-1, k_width)).astype(np.int32)


def buffer_to_ring(buf, pen: Penalties, s_lo: int) -> np.ndarray:
    """The reference XLA engine's rolling buffer at score s_lo (a dict
    comp -> (D, B, K), slot s % D) as the ring image (P, B, K) the
    Pallas sweep would hold there: each component keeps its last
    `depth` scores at slot s % depth, NULL for scores below 0."""
    offs, deps, P = ring_layout(pen)
    planes = {c: np.asarray(buf[c]) for c in _COMPS}
    Dd, B, K = planes["m"].shape
    ring = np.full((P, B, K), NULL, np.int32)
    for ci, c in enumerate(_COMPS):
        for lag in range(deps[ci]):
            s = s_lo - lag
            if s >= 0:
                ring[offs[ci] + s % deps[ci]] = planes[c][s % Dd]
    return ring


# ---------------------------------------------------------------------------
# Plain pieces: the mismatch index, the extension, the step, group init
# ---------------------------------------------------------------------------


def build_mismatch_index(qs, ts, qlens, tlens, k0, k_width: int):
    """(mmw, nxw), both (B, K, L/32) int32 (reference:
    wf_segmented.build_mismatch_index): bit h%32 of mmw[b, c, h//32] is
    set iff extension must STOP at offset h on diagonal k0[b] + c
    (mismatch, or q or t exhausted); nxw[b, c, w] is the smallest
    w' >= w with a nonzero word, L/32 where none. Built a few diagonals
    at a time to bound memory."""
    B, L = qs.shape
    K = k_width
    LW = L // 32
    dev = qs.device
    h = torch.arange(L, dtype=_I32, device=dev)
    bitw = torch.ones(32, dtype=_I32, device=dev) << torch.arange(32, dtype=_I32, device=dev)
    qlens = qlens.to(_I32)
    tlens = tlens.to(_I32)
    mmw = torch.empty((B, K, LW), dtype=_I32, device=dev)
    G = max(1, min(K, (1 << 25) // max(B * L, 1)))
    for c0 in range(0, K, G):
        g = min(G, K - c0)
        cs = torch.arange(c0, c0 + g, dtype=_I32, device=dev)
        v = h[None, None, :] - (k0.to(_I32)[:, None, None] + cs[None, :, None])
        qv = torch.gather(qs, 1, v.clamp(0, L - 1).reshape(B, -1).long()).reshape(B, g, L)
        stop = (
            (v < 0)
            | (v >= qlens[:, None, None])
            | (h[None, None, :] >= tlens[:, None, None])
            | (qv != ts[:, None, :])
        )
        # distinct bits never overflow an int32 sum (bit 31 weighs -2^31)
        mmw[:, c0 : c0 + g] = (stop.view(B, g, LW, 32).to(_I32) * bitw).sum(-1, dtype=_I32)
    cand = torch.where(mmw != 0, torch.arange(LW, dtype=_I32, device=dev), LW)
    nxw = torch.cummin(cand.flip(-1), dim=-1).values.flip(-1)
    return mmw, nxw


def _ctz(x: torch.Tensor) -> torch.Tensor:
    """Trailing zeros of each nonzero int32 (garbage for 0, which
    callers mask out)."""
    low = x.to(torch.int64) & 0xFFFFFFFF
    low = low & (-low)
    return torch.log2(torch.where(low == 0, 1, low).to(torch.float64)).round().to(_I32)


def _extend_bm(h, h_max, mmw, nxw, l_pad: int):
    """Greedy match-run extension of the (B, W) offsets h (reference:
    wf_segmented._extend_bm): the first stop at or after
    clip(h, 0, l_pad-1), or l_pad where there is none, capped at h_max.
    Lanes holding NULL or h > h_max pass through unchanged."""
    LW = l_pad // 32
    ok = (h > NULL) & (h <= h_max)
    hc = h.clamp(0, l_pad - 1)
    w0 = hc >> 5
    r = hc & 31
    word0 = torch.gather(mmw, 2, w0[..., None].long())[..., 0]
    m0 = word0 & (torch.full_like(r, -1) << r)
    have0 = m0 != 0
    w1 = torch.gather(nxw, 2, (w0 + 1).clamp(max=LW - 1)[..., None].long())[..., 0]
    w1c = w1.clamp(0, LW - 1)
    word1 = torch.gather(mmw, 2, w1c[..., None].long())[..., 0]
    pos0 = (w0 << 5) + _ctz(m0)
    pos1 = (w1c << 5) + _ctz(word1)
    have1 = (w1 < LW) & (w1 > w0) & (word1 != 0)
    pos = torch.where(have0, pos0, torch.where(have1, pos1, l_pad))
    return torch.where(ok, torch.minimum(pos, h_max), h)


def _wf_step_bm(pen: Penalties, s: int, ring, h_max, mmw, nxw, l_pad: int):
    """The five wavefront components at score s from the ring image
    (P, B, W) (reference: wf_segmented._wf_step_bm): returns (m, i1, d1,
    i2, d2), each (B, W)."""
    offs, deps, _ = ring_layout(pen)

    def src(ci, ds):
        if s < ds:
            return torch.full_like(h_max, NULL)
        return ring[offs[ci] + (s - ds) % deps[ci]]

    def trim(a):
        return torch.where(a > h_max, NULL, a)

    def plus1(a):
        return torch.where(a > NULL, a + 1, NULL)

    o1e1 = pen.o1 + pen.e1
    i1 = trim(plus1(torch.maximum(_shift_right(src(_C_M, o1e1)), _shift_right(src(_C_I1, pen.e1)))))
    d1 = trim(torch.maximum(_shift_left(src(_C_M, o1e1)), _shift_left(src(_C_D1, pen.e1))))
    best = torch.maximum(i1, d1)
    if pen.two_piece:
        o2e2 = pen.o2 + pen.e2
        i2 = trim(plus1(torch.maximum(_shift_right(src(_C_M, o2e2)), _shift_right(src(_C_I2, pen.e2)))))
        d2 = trim(torch.maximum(_shift_left(src(_C_M, o2e2)), _shift_left(src(_C_D2, pen.e2))))
        best = torch.maximum(best, torch.maximum(i2, d2))
    else:
        i2 = torch.full_like(i1, NULL)
        d2 = i2
    mis = trim(plus1(src(_C_M, pen.x)))
    m = trim(_extend_bm(torch.maximum(best, mis), h_max, mmw, nxw, l_pad))
    return m, i1, d1, i2, d2


@dataclass
class WfInit:
    """Score-0 state of a group (see `wf_init`)."""

    k0: torch.Tensor  # (B,) int32 band origin
    h_max: torch.Tensor  # (B, K) int32
    c_end: torch.Tensor  # (B,) int32 band column of k_end
    feasible: torch.Tensor  # (B,) bool
    seeds: torch.Tensor  # (P, B, K) int32 ring image at score 0
    done0: torch.Tensor  # (B,) bool
    scores0: torch.Tensor  # (B,) int32, 0 where done0 else -1


def wf_init(qs, ts, qlens, tlens, pen: Penalties, k_width: int) -> WfInit:
    """Group init (reference: pallas_wf.wf_init_rows and
    wf_segmented.wf_init): band geometry, h_max, c_end and feasibility;
    the seed ring image, whose only value is score 0's M on diagonal 0,
    the LCP of q and t capped by h_max; done/scores after score 0."""
    B, L = qs.shape
    K = k_width
    dev = qs.device
    qlens = qlens.to(_I32)
    tlens = tlens.to(_I32)
    k_end, k0 = _band_geometry(qlens, tlens, K)
    _, h_max = _make_masks(qlens, tlens, k0, K)
    c_end = (k_end - k0).clamp(0, K - 1).to(_I32)
    feasible = k_end.abs() <= K - 1
    i = torch.arange(L, dtype=_I32, device=dev)[None, :]
    stop0 = (i >= qlens[:, None]) | (i >= tlens[:, None]) | (qs != ts)
    lcp = torch.where(stop0, i, L).amin(1)
    # diagonal 0 lies outside an infeasible pair's band: no seed there
    c_zero = (-k0).to(_I32)
    hm_zero = torch.gather(h_max, 1, c_zero.clamp(0, K - 1)[:, None].long())[:, 0]
    m0v = torch.minimum(lcp, hm_zero)
    cols = torch.arange(K, dtype=_I32, device=dev)[None, :]
    m0 = torch.where(cols == c_zero[:, None], m0v[:, None], NULL).to(_I32)
    m0 = torch.where(m0 > h_max, NULL, m0)
    _, _, P = ring_layout(pen)
    seeds = torch.full((P, B, K), NULL, dtype=_I32, device=dev)
    seeds[0] = m0
    at_end0 = torch.gather(m0, 1, c_end[:, None].long())[:, 0]
    done0 = (at_end0 == tlens) & feasible
    scores0 = torch.where(done0, 0, -1).to(_I32)
    return WfInit(k0.to(_I32), h_max.to(_I32), c_end, feasible, seeds, done0, scores0)


# ---------------------------------------------------------------------------
# The span: sweep or history
# ---------------------------------------------------------------------------


def wf_span_ref(
    qs, ts, qlens, tlens, pen: Penalties, k_width: int, l_pad: int, s_lo: int,
    n_steps: int, ring, with_history: bool, ckpt_every: int = 0, done=None,
    scores=None, c_lo=None, k_sub=None,
):
    """Plain version of the span (reference: pallas_wf._call_kernel, and
    the XLA wf_segmented.wf_span it equals). Levels s_lo+1 .. s_lo+n_steps
    from `ring`, the (P, B, K) ring image at s_lo of a band k_width wide.
    Returns (ckpts, hist, done, scores), None where the mode makes none:

    * sweep (with_history False; ckpt_every = C > 0, n_steps a multiple
      of C): done/scores carried from `done`/`scores`; ckpts
      (n_steps/C, P, B, K) holds in slot j the ring at score s_lo + j*C,
      slot 0 the input ring (written even for a pair already done), slot
      j written before level s_lo + j*C + 1 runs. A pair stops at the
      first level after it is done, so its later slots stay NULL.
    * history (with_history True): every level runs, done-tracking off;
      hist (n_steps, 5, B, W) holds m, i1, d1, i2, d2 at score
      s_lo + 1 + j in row j. With c_lo ((B,) int32) the span covers only
      the sub-band [c_lo, c_lo + k_sub) of each pair's band (origin
      k0 + c_lo, NULL inflow at its edges) and W = k_sub; else W = K."""
    qlens = qlens.to(_I32)
    tlens = tlens.to(_I32)
    B = qs.shape[0]
    K = k_width
    dev = qs.device
    k_end, k0 = _band_geometry(qlens, tlens, K)
    W = K
    ring = ring.clone()
    if c_lo is not None:
        W = k_sub
        c_lo = c_lo.to(_I32)
        cols = (c_lo[:, None] + torch.arange(W, dtype=_I32, device=dev)[None, :]).long()
        ring = torch.gather(ring, 2, cols[None].expand(ring.shape[0], B, W))
        k0 = k0 + c_lo
    _, h_max = _make_masks(qlens, tlens, k0, W)
    mmw, nxw = build_mismatch_index(qs, ts, qlens, tlens, k0, W)
    offs, deps, P = ring_layout(pen)

    def step(s):
        planes = _wf_step_bm(pen, s, ring, h_max, mmw, nxw, l_pad)
        for ci, plane in enumerate(planes):
            ring[offs[ci] + s % deps[ci]] = plane
        return planes

    if with_history:
        hist = torch.empty((n_steps, 5, B, W), dtype=_I32, device=dev)
        for j in range(n_steps):
            hist[j] = torch.stack(step(s_lo + 1 + j))
        return None, hist, None, None

    C = ckpt_every
    c_end = (k_end - k0).clamp(0, K - 1)
    feasible = k_end.abs() <= K - 1
    done = done.clone()
    scores = scores.to(_I32).clone()
    ckpts = torch.full((n_steps // C, P, B, K), NULL, dtype=_I32, device=dev)
    ckpts[0] = ring
    for j in range(n_steps):
        if bool(done.all()):
            break
        if j and j % C == 0:
            ckpts[j // C, :, ~done] = ring[:, ~done]
        s = s_lo + 1 + j
        m = step(s)[0]
        at_end = torch.gather(m, 1, c_end[:, None].long())[:, 0]
        done_now = (at_end == tlens) & feasible & ~done
        scores = torch.where(done_now, s, scores)
        done = done | done_now
    return ckpts, None, done, scores


class WfSpanDesign(NamedTuple):
    """What csrc/wf_span.cu runs for a span over W lanes of a band K: the
    fields of the code `allwave_wf_span_design` returns. Both modes are a
    thread-block cluster a pair."""

    code: int
    history: bool  # the history mode, else the sweep
    blocks_per_pair: int  # G, the cluster
    lanes_per_thread: int
    lanes_per_block: int  # Lb
    clusters_held: int  # of this design, by the card at once


#: designs by (device, K, W, history, B, two_piece, P): the C dispatch
#: asks the occupancy API up to six times, so it runs once a shape
_span_designs: Dict[tuple, WfSpanDesign] = {}


def wf_span_design(K: int, W: int, with_history: bool, B: int, pen: Penalties) -> WfSpanDesign:
    """The span kernel's design for B pairs on a window of W lanes of a
    band K, from its C dispatch (the cluster size depends on how many of
    B's clusters the card holds at once, and a block's ring on the
    penalties' P planes), once a shape. Raises for a window no design
    takes."""
    import ctypes

    from . import cuda_build

    P = ring_layout(pen)[2]
    key = (torch.cuda.current_device(), K, W, bool(with_history), B, bool(pen.two_piece), P)
    if key not in _span_designs:
        held = ctypes.c_int(0)
        code = cuda_build.library("wf_span").allwave_wf_span_design(
            K, W, int(with_history), B, int(pen.two_piece), P, ctypes.byref(held)
        )
        if code < 0:
            raise ValueError(f"no wf span design for K={K} W={W} P={P} history={with_history}")
        if held.value < 0:
            cuda_build.check(-held.value, "cudaOccupancyMaxActiveClusters")
        _span_designs[key] = WfSpanDesign(
            code, bool(code & 1), (code >> 1) & 31, (code >> 6) & 15, code >> 10, held.value
        )
    return _span_designs[key]


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def wf_span(
    qs, ts, qlens, tlens, pen: Penalties, k_width: int, l_pad: int, s_lo: int,
    n_steps: int, ring, with_history: bool, ckpt_every: int = 0, done=None,
    scores=None, c_lo=None, k_sub=None,
):
    """The span: the plain version for CPU tensors, the csrc/wf_span.cu
    kernel for CUDA tensors (same contract as `wf_span_ref`), a cluster
    of blocks a pair as `wf_span_design` says. `ring` may be one slot of
    a checkpoint tensor. c_lo must lie in [0, K - k_sub]."""
    counters.add(dispatches=1)
    if D_._device_kind(qs) == "cpu":
        return wf_span_ref(
            qs, ts, qlens, tlens, pen, k_width, l_pad, s_lo, n_steps, ring,
            with_history, ckpt_every, done, scores, c_lo, k_sub,
        )
    from . import cuda_build

    B = qs.shape[0]
    K = k_width
    W = K if c_lo is None else k_sub
    offs, deps, P = ring_layout(pen)
    if (
        W is None or not 1 <= W <= K or l_pad < 32 or l_pad % 32 or n_steps < 1
        or s_lo < 0 or (not with_history and (c_lo is not None or ckpt_every < 1
                                              or n_steps % ckpt_every))
    ):
        raise ValueError(
            f"bad wf span: K={K} W={W} l_pad={l_pad} s_lo={s_lo} n_steps={n_steps} "
            f"ckpt_every={ckpt_every} history={with_history}"
        )
    D_._check_cuda("qs", qs, torch.uint8, (B, l_pad))
    D_._check_cuda("ts", ts, torch.uint8, (B, l_pad))
    D_._check_cuda("qlens", qlens, _I32, (B,))
    D_._check_cuda("tlens", tlens, _I32, (B,))
    D_._check_cuda("ring", ring, _I32, (P, B, K))
    if c_lo is not None:
        D_._check_cuda("c_lo", c_lo, _I32, (B,))
    if qs.data_ptr() % 8 or ts.data_ptr() % 8:
        raise ValueError("qs and ts must be 8-byte aligned (the kernel loads 8 bases at once)")
    dev = qs.device
    ckpts = hist = None
    if with_history:
        hist = torch.empty((n_steps, 5, B, W), dtype=_I32, device=dev)
        done_out = scores_out = None
    else:
        D_._check_cuda("done", done, torch.bool, (B,))
        D_._check_cuda("scores", scores, _I32, (B,))
        # every slot defined: a pair that finishes early leaves NULL
        ckpts = torch.full((n_steps // ckpt_every, P, B, K), NULL, dtype=_I32, device=dev)
        done_out = torch.empty_like(done)
        scores_out = torch.empty_like(scores)
    design = wf_span_design(K, W, with_history, B, pen)
    lib = cuda_build.library("wf_span")
    rc = lib.allwave_wf_span(
        qs.data_ptr(), ts.data_ptr(), qlens.data_ptr(), tlens.data_ptr(), _ptr(c_lo),
        B, l_pad, K, W, s_lo, n_steps, 0 if with_history else ckpt_every,
        pen.x, pen.o1, pen.e1, pen.o2, pen.e2, int(pen.two_piece),
        *offs, *deps, P, design.code,
        ring.data_ptr(), _ptr(ckpts), _ptr(hist), _ptr(done), _ptr(scores),
        _ptr(done_out), _ptr(scores_out),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    cuda_build.check(rc, "wf_span kernel launch")
    wf_span_launches.launched((B, K, W, l_pad, n_steps, bool(with_history)), design)
    return ckpts, hist, done_out, scores_out


# ---------------------------------------------------------------------------
# The window traceback over one replayed segment
# ---------------------------------------------------------------------------


def new_walk(s, c, h, active) -> torch.Tensor:
    """Walk state (5, B) int32, rows: score s, band column c, offset h,
    component (0=m 1=i1 2=d1 3=i2 4=d2), active."""
    z = torch.zeros_like(s, dtype=_I32)
    return torch.stack([s.to(_I32), c.to(_I32), h.to(_I32), z, active.to(_I32)]).contiguous()


def new_bufs(B: int, run_cap: int, device):
    """Run buffers: ops (B, run_cap) uint8 and lens (B, run_cap) int32
    (end to start), nrun (B,) int32 (counting emits dropped past
    run_cap), overflow (B,) bool."""
    return (
        torch.zeros((B, run_cap), dtype=torch.uint8, device=device),
        torch.zeros((B, run_cap), dtype=_I32, device=device),
        torch.zeros(B, dtype=_I32, device=device),
        torch.zeros(B, dtype=torch.bool, device=device),
    )


#: hops per chunk of the walk (the XLA walk's lax.scan length)
CHUNK = 16


def traceback_window_ref(hist, ring, s_lo: int, walk, bufs, pen: Penalties, c_lo=None) -> None:
    """Plain version of the walk over one replayed segment (reference:
    wf_segmented._traceback_window). The window covers scores
    s_lo - D + 1 .. s_lo + n_steps, D = max_lookback + 1: its head comes
    from `ring` (P, B, K), the checkpoint image at s_lo (a slot older than
    its component's depth, or a score below 0, reads NULL, as
    pallas_wf.ckpt_to_buf leaves it), its body from hist (n_steps, 5, B,
    W). On a narrow replay the window column is c - c_lo. Walkers pause
    at s <= s_lo unless s == 0. Updates walk and bufs in place. A walker
    in the M state breaks ties X > I1 > I2 > D1 > D2, or I1 > X > I2 > D1
    > D2 under the test-only `_TB_FLIP`.

    The XLA walk's structure shows in the bytes and is kept: hops in
    chunks of CHUNK, two emit slots per hop (the M-run/I/D emit, then the
    X emit), emits past run_cap dropped while nrun counts on, an
    overflowing walker stops at the end of its chunk, and at most
    (3 * run_cap + 8) // CHUNK + 2 chunks a segment."""
    NS, _, B, W = hist.shape
    K = ring.shape[2]
    dev = hist.device
    Dw = pen.max_lookback + 1
    offs, deps, _ = ring_layout(pen)
    ops, lens, nrun, overflow = bufs
    run_cap = ops.shape[1]
    rows = torch.arange(B, device=dev)
    col0 = c_lo.to(_I32) if c_lo is not None else torch.zeros(B, dtype=_I32, device=dev)

    # the (5, D + n_steps, B, W) window, row r <-> score s_lo - D + 1 + r
    cols = (col0[:, None] + torch.arange(W, dtype=_I32, device=dev)[None, :]).clamp(0, K - 1).long()
    head = torch.full((5, Dw, B, W), NULL, dtype=_I32, device=dev)
    for ci in range(5):
        for r in range(Dw):
            sc = s_lo - Dw + 1 + r
            if sc >= 0 and s_lo - sc < deps[ci]:
                head[ci, r] = torch.gather(ring[offs[ci] + sc % deps[ci]], 1, cols)
    w5 = torch.cat([head, hist.permute(1, 0, 2, 3)], 1)
    n_rows = Dw + NS
    s_base = s_lo - Dw + 1
    fcomp = torch.tensor([0, 1, 2, 3, 4, 1, 3, 2, 4], device=dev)[:, None].expand(9, B)
    rows9 = rows[None, :].expand(9, B)

    def fetch9(s, c):
        fs = torch.stack([s - pen.x, s, s, s, s, s - pen.e1, s - pen.e2, s - pen.e1, s - pen.e2])
        fc = torch.stack([c, c, c, c, c, c - 1, c - 1, c + 1, c + 1]) - col0[None, :]
        r = fs - s_base
        ok = (r >= 0) & (r < n_rows) & (fs >= 0) & (fc >= 0) & (fc < W)
        vals = w5[fcomp, r.clamp(0, n_rows - 1).long(), rows9, fc.clamp(0, W - 1).long()]
        return torch.where(ok, vals, NULL)

    s, c, h, comp, active = (walk[i].clone() for i in range(5))
    active = active != 0
    nr = nrun.clone()
    x_op = torch.full_like(s, _OP_X)
    ones = torch.ones_like(s)

    def stepping_of(s, active):
        return active & ((s > s_lo) | (s == 0))

    for _ in range((3 * run_cap + 8) // CHUNK + 2):
        if not bool(stepping_of(s, active).any()):
            break
        oob = torch.zeros(B, dtype=torch.bool, device=dev)
        for _ in range(CHUNK):
            stepping = stepping_of(s, active)
            is_m = comp == _C_M
            at_origin = is_m & (s == 0)
            mis_v, c_i1, c_d1, c_i2, c_d2, i1_ext, i2_ext, d1_ext, d2_ext = fetch9(s, c)
            c_x = torch.where(mis_v > NULL, mis_v + 1, NULL)
            pre = torch.maximum(torch.maximum(torch.maximum(c_x, c_i1), torch.maximum(c_d1, c_i2)), c_d2)
            rest = torch.where(c_i2 == pre, _C_I2, torch.where(c_d1 == pre, _C_D1, _C_D2))
            if _TB_FLIP:  # test-only: I1 preferred over X (see the knob above)
                choice = torch.where(c_i1 == pre, _C_I1, torch.where(c_x == pre, _C_M, rest))
            else:
                choice = torch.where(c_x == pre, _C_M, torch.where(c_i1 == pre, _C_I1, rest))
            n_match = torch.where(at_origin, h, h - pre)
            is_i = (comp == _C_I1) | (comp == _C_I2)
            piece1 = (comp == _C_I1) | (comp == _C_D1)
            gap_e = torch.where(piece1, pen.e1, pen.e2)
            gap_oe = torch.where(piece1, pen.o1 + pen.e1, pen.o2 + pen.e2)
            ext_ok = torch.where(
                comp == _C_I1, (i1_ext > NULL) & (i1_ext + 1 == h),
                torch.where(comp == _C_I2, (i2_ext > NULL) & (i2_ext + 1 == h),
                            torch.where(comp == _C_D1, (d1_ext > NULL) & (d1_ext == h),
                                        (d2_ext > NULL) & (d2_ext == h))),
            )
            # emit slot 0: M run / I / D; slot 1: X
            e1_op = torch.where(is_m, _OP_M, torch.where(is_i, _OP_I, _OP_D))
            e1_cnt = torch.where(is_m, n_match, 1)
            e1_do = stepping & (e1_cnt > 0)
            e2_do = stepping & is_m & ~at_origin & (choice == _C_M)
            for do, op, cnt in ((e1_do, e1_op, e1_cnt), (e2_do, x_op, ones)):
                keep = do & (nr < run_cap)
                if bool(keep.any()):
                    at = (rows[keep], nr[keep].long())
                    ops[at] = op[keep].to(torch.uint8)
                    lens[at] = cnt[keep].to(_I32)
                oob |= do & (nr >= run_cap)
                nr = nr + do.to(_I32)
            new_s = torch.where(
                is_m, torch.where(choice == _C_M, s - pen.x, s),
                torch.where(ext_ok, s - gap_e, s - gap_oe),
            )
            new_h = torch.where(is_m, torch.where(choice == _C_M, pre - 1, pre), torch.where(is_i, h - 1, h))
            new_c = torch.where(is_m, c, torch.where(is_i, c - 1, c + 1))
            new_comp = torch.where(is_m, choice, torch.where(ext_ok, comp, _C_M))
            active = active & ~(stepping & at_origin)
            moved = stepping & ~at_origin
            s = torch.where(moved, new_s, s)
            h = torch.where(moved, new_h, h)
            c = torch.where(moved, new_c, c)
            comp = torch.where(moved, new_comp, comp)
        overflow |= oob
        active = active & ~oob

    for i, t in enumerate((s, c, h, comp, active.to(_I32))):
        walk[i] = t
    nrun.copy_(nr)


@functools.lru_cache(maxsize=None)
def wf_walk_design(NS: int, W: int) -> WalkDesign:
    """The window walk's design for (NS, 5, B, W) history planes, from
    its C dispatch (once a shape)."""
    from . import cuda_build

    return walk_design_of(cuda_build.library("wf_traceback").allwave_wf_traceback_design(NS, W))


def head_rows(pen: Penalties) -> int:
    """The rows of the window's head a stepping walker can read, the ones
    the walk kernel stages: max(x, e1, e2), at most D. A stepping walker
    has s > s_lo (or s == 0) and reads at s, s - x and s - e."""
    return min(pen.max_lookback + 1, max(pen.x, pen.e1, pen.e2))


def traceback_window_tiles(hist, ring, s_lo: int, walk, bufs, pen: Penalties, c_lo=None,
                           stats=None, *, design: WalkDesign) -> None:
    """Plain emulation of csrc/wf_traceback.cu's tile schedule, one walker
    at a time: the same contract and bytes as `traceback_window_ref`,
    read the way the kernel reads. Tile t holds history levels t*R ..
    t*R + R - 1 (scores s_lo + 1 + t*R ..) of the 5 components at window
    columns lo .. lo + Wc - 1; it lives in slot t % N. On entering tile t
    (the tile of its score's level) the walker asks for the tiles
    t - N + 1 .. t not asked for yet, lo centred on its column and
    clamped into the window. The head rows a walker can read (scores
    s_lo - head_rows + 1 .. s_lo) are staged at the start, centred on
    the entry column, NULL where a slot is older than its component's
    depth or below score 0, each component's slot stepped down from
    s_lo % depth by one subtraction and wrap. A read of a staged entry
    comes from its tile or the head, any other from the full planes or
    the ring (a miss). With stats ((2, B) int32) each walker's hops and
    misses of this call are written there."""
    NS, _, B, W = hist.shape
    K = ring.shape[2]
    R, N, WC = design.rows, design.slots, design.cols
    Dw, DH = pen.max_lookback + 1, head_rows(pen)
    offs, deps, _ = ring_layout(pen)
    m0 = [s_lo % dp for dp in deps]
    h_np, r_np = hist.cpu().numpy(), ring.cpu().numpy()
    ops, lens, nrun, overflow = bufs
    run_cap = ops.shape[1]
    w = walk.cpu().numpy().copy()
    ops_h, lens_h = ops.cpu().numpy().copy(), lens.cpu().numpy().copy()
    nr_h, ov_h = nrun.cpu().numpy().copy(), overflow.cpu().numpy().copy()
    col0s = c_lo.cpu().numpy() if c_lo is not None else np.zeros(B, np.int64)
    st = np.zeros((2, B), np.int32)
    e_of = {1: pen.e1, 2: pen.e1, 3: pen.e2, 4: pen.e2}
    oe_of = {1: pen.o1 + pen.e1, 2: pen.o1 + pen.e1, 3: pen.o2 + pen.e2, 4: pen.o2 + pen.e2}

    for b in range(B):
        s, c, h, comp, act = (int(v) for v in w[:, b])
        active = act != 0
        nr, ovf, col0 = int(nr_h[b]), bool(ov_h[b]), int(col0s[b])
        if not (active and (s > s_lo or s == 0)):
            continue
        hops = misses = 0
        # the head, staged at the start around the entry column
        head_lo = min(max(c - col0 - WC // 2, 0), max(W - WC, 0))
        head = np.zeros((DH, 5, WC), np.int64)
        slot = list(m0)
        for k in range(DH):
            for cp in range(5):
                for x in range(WC):
                    fc = head_lo + x
                    if fc < W:
                        ok = s_lo - k >= 0 and k < deps[cp]
                        head[DH - 1 - k, cp, x] = r_np[offs[cp] + slot[cp], b, col0 + fc] if ok else NULL
                slot[cp] = deps[cp] - 1 if slot[cp] == 0 else slot[cp] - 1
        req_lo, cur_t, slot_lo, tiles = 1 << 31, -1, [0] * N, [None] * N

        def win(cp, fs, fc):
            nonlocal misses
            i = fs - s_lo - 1
            if i >= NS or i < -Dw or fs < 0 or fc < 0 or fc >= W:
                return NULL
            if i >= 0:
                t = i // R
                if t >= req_lo and 0 <= fc - slot_lo[t % N] < WC:
                    held, tile = tiles[t % N]
                    assert held == t
                    return int(tile[i % R, cp, fc - slot_lo[t % N]])
                misses += 1
                return int(h_np[i, cp, b, fc])
            k = -1 - i
            if k >= deps[cp]:
                return NULL
            if k < DH and 0 <= fc - head_lo < WC:
                return int(head[DH - 1 - k, cp, fc - head_lo])
            misses += 1
            return int(r_np[offs[cp] + (m0[cp] - k) % deps[cp], b, col0 + fc])

        def emit(op, cnt):
            nonlocal nr, oob
            if nr < run_cap:
                ops_h[b, nr], lens_h[b, nr] = op, cnt
            else:
                oob = True
            nr += 1

        for _ in range((3 * run_cap + 8) // CHUNK + 2):
            if not (active and (s > s_lo or s == 0)):
                break
            oob = False
            for _ in range(CHUNK):
                if not (active and (s > s_lo or s == 0)):
                    break
                hops += 1
                cc = c - col0
                if s > s_lo and (s - s_lo - 1) // R != cur_t:
                    cur_t = (s - s_lo - 1) // R
                    new_lo = max(cur_t - N + 1, 0)
                    if new_lo < req_lo:
                        lo = min(max(cc - WC // 2, 0), max(W - WC, 0))
                        for u in range(min(req_lo - 1, cur_t), new_lo - 1, -1):
                            slot_lo[u % N] = lo
                            lev = slice(u * R, min(u * R + R, NS))
                            tile = np.zeros((R, 5, WC), np.int64)
                            n = min(WC, W - lo)
                            tile[: lev.stop - lev.start, :, :n] = h_np[lev, :, b, lo : lo + n]
                            tiles[u % N] = (u, tile)
                        req_lo = new_lo
                if comp == _C_M:
                    mis_v = win(0, s - pen.x, cc)
                    cx = mis_v + 1 if mis_v > NULL else NULL
                    ci1, cd1, ci2, cd2 = (win(cp, s, cc) for cp in (1, 2, 3, 4))
                    pre = max(cx, ci1, cd1, ci2, cd2)
                    rest = _C_I2 if ci2 == pre else _C_D1 if cd1 == pre else _C_D2
                    if _TB_FLIP:  # test-only: I1 preferred over X
                        choice = _C_I1 if ci1 == pre else _C_M if cx == pre else rest
                    else:
                        choice = _C_M if cx == pre else _C_I1 if ci1 == pre else rest
                    at_origin = s == 0
                    n_match = h if at_origin else h - pre
                    if n_match > 0:
                        emit(_OP_M, n_match)
                    if at_origin:
                        active = False
                    else:
                        if choice == _C_M:
                            emit(_OP_X, 1)
                            s -= pen.x
                            h = pre - 1
                        else:
                            h = pre
                        comp = choice
                else:
                    is_i = comp in (_C_I1, _C_I2)
                    ev = win(comp, s - e_of[comp], cc - 1 if is_i else cc + 1)
                    ext_ok = ev > NULL and (ev + 1 == h if is_i else ev == h)
                    emit(_OP_I if is_i else _OP_D, 1)
                    s -= e_of[comp] if ext_ok else oe_of[comp]
                    if not ext_ok:
                        comp = _C_M
                    c = c - 1 if is_i else c + 1
                    if is_i:
                        h -= 1
            if oob:
                ovf, active = True, False
        w[:, b] = (s, c, h, comp, int(active))
        nr_h[b], ov_h[b] = nr, ovf
        st[:, b] = (hops, misses)
    walk.copy_(torch.from_numpy(w))
    for t, arr in zip(bufs, (ops_h, lens_h, nr_h, ov_h)):
        t.copy_(torch.from_numpy(arr))
    if stats is not None:
        stats.copy_(torch.from_numpy(st))


def wf_traceback(hist, ring, s_lo: int, walk, bufs, pen: Penalties, c_lo=None, stats=None) -> None:
    """The walk over one replayed segment: the plain version for CPU
    tensors, the csrc/wf_traceback.cu kernel for CUDA tensors (same
    contract as `traceback_window_ref`; updates walk and bufs in place).
    With stats ((2, B) int32, CUDA only), the kernel writes each
    walker's hops and misses (entries read from device memory, not from
    a tile or the staged head) of this call there. Under the test-only
    `_TB_FLIP` it launches the kernel's FLIP instantiation."""
    counters.add(dispatches=1)
    if D_._device_kind(hist) == "cpu":
        if stats is not None:
            raise ValueError("stats: hops and misses are the kernel's; the plain walk has none")
        traceback_window_ref(hist, ring, s_lo, walk, bufs, pen, c_lo)
        return
    from . import cuda_build

    NS, _, B, W = hist.shape
    offs, deps, P = ring_layout(pen)
    K = ring.shape[2]
    ops, lens, nrun, overflow = bufs
    run_cap = ops.shape[1]
    D_._check_cuda("hist", hist, _I32, (NS, 5, B, W))
    D_._check_cuda("ring", ring, _I32, (P, B, K))
    D_._check_cuda("walk", walk, _I32, (5, B))
    D_._check_cuda("ops", ops, torch.uint8, (B, run_cap))
    D_._check_cuda("lens", lens, _I32, (B, run_cap))
    D_._check_cuda("nrun", nrun, _I32, (B,))
    D_._check_cuda("overflow", overflow, torch.bool, (B,))
    if c_lo is not None:
        D_._check_cuda("c_lo", c_lo, _I32, (B,))
    if stats is not None:
        D_._check_cuda("stats", stats, _I32, (2, B))
    if run_cap < 1 or s_lo < 0 or W > K:
        raise ValueError(f"bad walk: run_cap={run_cap} s_lo={s_lo} W={W} K={K}")
    design = wf_walk_design(NS, W)
    lib = cuda_build.library("wf_traceback")
    rc = lib.allwave_wf_traceback(
        hist.data_ptr(), NS, B, W, ring.data_ptr(), K,
        _ptr(c_lo), s_lo,
        pen.x, pen.o1, pen.e1, pen.o2, pen.e2, *offs, *deps, pen.max_lookback + 1,
        walk.data_ptr(), ops.data_ptr(), lens.data_ptr(), nrun.data_ptr(),
        overflow.data_ptr(), run_cap, _ptr(stats), design.code, int(_TB_FLIP),
        torch.cuda.current_stream(hist.device).cuda_stream,
    )
    cuda_build.check(rc, "wf_traceback kernel launch")
    wf_traceback_launches.launched((B, K, W, NS, run_cap), design)


# ---------------------------------------------------------------------------
# Orchestrator
# ---------------------------------------------------------------------------


@dataclass
class WfSegConfig:
    k_initial: int = 128
    #: band ceiling, the reference's (its value came from the TPU's
    #: VMEM; raising it waits for a measurement on the card)
    k_max: int = 6144
    #: score levels per checkpoint segment
    ckpt_every: int = 256
    #: initial score cap when no hint is available
    s_cap_initial: int = 512
    #: growth factor for score-cap escalation
    s_cap_growth: int = 4
    #: absolute score cap: pairs needing more fall back to the dense
    #: segmented engine
    s_cap_max: int = 1 << 14
    #: memory budget for one group's checkpoints, working rings and one
    #: segment's history planes, sized for the H100's 80 GB (batching
    #: changes no byte: every pair is computed on its own)
    budget_bytes: int = 16 << 30
    max_batch: int = 256


class WavefrontSegmentedAligner:
    """Long-pair aligner with O(s*K) compute and O(s/C * P * K) memory
    (reference: wf_segmented.WavefrontSegmentedAligner, Pallas route).

    align_pairs returns [(score, cigar) | None | DENSE_FALLBACK]: the
    sentinel marks pairs whose score cap or band exceeded the configured
    ceilings, or whose run buffer overflowed; the caller
    (UnifiedAligner) reroutes those to the segmented dense engine. Runs
    on the device of its sequence pool, the router's when it hands one
    over."""

    DENSE_FALLBACK = "dense"

    #: the reference's wavefront ladder, up to 16384 (differs from the
    #: segmented engine's)
    K_LADDER = sorted({128 << i for i in range(8)} | {384 << i for i in range(6)})

    def __init__(self, pen: Penalties, config: Optional[WfSegConfig] = None, device=None,
                 pool: Optional[SequencePool] = None):
        self.pen = pen
        self.config = config or WfSegConfig()
        self.pool = pool if pool is not None else SequencePool(resolve_device(device))
        self.device = self.pool.device
        # the same exit-and-return band bound as the dense engines, with
        # no k_max clamp: a band past k_max hands the pair back
        self.ladder = BandLadder(pen, self.K_LADDER, self.config.k_initial)

    @staticmethod
    def _quantize_hint(hint: int) -> int:
        """Round a hint UP to a quarter-pow2 grid point {2^i, 1.25*2^i,
        1.5*2^i, 1.75*2^i}: a pair's (K, s_cap) round key is then a pure
        function of the pair itself."""
        if hint <= 16:
            return 16
        p = 1 << (hint.bit_length() - 1)
        for num in (5, 6, 7, 8):
            v = p * num // 4
            if v >= hint:
                return v
        return 2 * p

    def _s_cap_for_hint(self, hint: int) -> int:
        C = self.config.ckpt_every
        want = max(self.config.s_cap_initial, 2 * hint + C)
        return min(self._round_up_seg(next_pow2(want)), self.config.s_cap_max)

    def _round_up_seg(self, s: int) -> int:
        C = self.config.ckpt_every
        return ((s + C - 1) // C) * C

    @staticmethod
    def _run_cap(scores_h, done_h) -> int:
        """Run-buffer capacity: ~3 runs per scored unit plus the match
        runs between them, rounded up to a power of two."""
        smax = int(scores_h[done_h].max()) if done_h.any() else 0
        want = max(512, 4 * smax + 64)
        return 1 << (want - 1).bit_length()

    def align_pairs(self, pairs: List[Tuple[bytes, bytes]], sigma_hint=None):
        pool_seqs, qidx, tidx = pool_pairs(pairs)
        return self.align_pairs_indexed(pool_seqs, qidx, tidx, sigma_hint)

    def align_pairs_indexed(self, pool_seqs, qidx, tidx, sigma_hint=None):
        """align_pairs with the pairs as row indices into pool_seqs; each
        certified pair's cigar comes back as (ops, lens) run pairs in
        start->end order."""
        n = len(qidx)
        results: List[object] = [None] * n
        if n == 0:
            return results
        cfg = self.config
        with counters.span("engine.plan"):
            qidx = np.asarray(qidx, dtype=np.int64)
            tidx = np.asarray(tidx, dtype=np.int64)
            pool_lens = np.fromiter((len(s) for s in pool_seqs), np.int64, len(pool_seqs))
            ql = pool_lens[qidx]
            tl = pool_lens[tidx]
            l_pad_all = next_pow2(max(int(max(ql.max(), tl.max())), 32))
            pool = (self.pool.rows(pool_seqs, l_pad_all), qidx, tidx, ql, tl)
            rounds: Dict[Tuple[int, int], List[int]] = {}
            for i in range(n):
                kend_abs = int(abs(tl[i] - ql[i]))
                if sigma_hint is not None:
                    hint = int(sigma_hint[i])
                    hq = self._quantize_hint(hint)
                    si = self._s_cap_for_hint(hq)
                    # K from a 1.25x quantized-hint margin (the reference's
                    # Pallas route); certificate failures escalate exactly
                    ki = self.ladder.for_score(hq * 5 // 4, kend_abs)
                    # a hint whose own certificate needs a band above k_max
                    # ends in fallback anyway: skip the sweep
                    if self.ladder.for_score(hint, kend_abs) > cfg.k_max:
                        results[i] = self.DENSE_FALLBACK
                        continue
                else:
                    ki = self.ladder.round(max(cfg.k_initial, kend_abs + 2))
                    si = self._round_up_seg(cfg.s_cap_initial)
                if ki > cfg.k_max or si > cfg.s_cap_max:
                    results[i] = self.DENSE_FALLBACK
                    continue
                rounds.setdefault((ki, si), []).append(i)

            # rounds sharing a band width merge at the largest score cap: the
            # cap changes no byte (the sweep stops per pair, replay depth and
            # run caps derive from scores), while K stays the pair's own
            by_k: Dict[int, Tuple[int, List[int]]] = {}
            for (ki, si), idxs in rounds.items():
                s_prev, lst = by_k.get(ki, (0, []))
                by_k[ki] = (max(s_prev, si), lst + idxs)
            rounds = {(ki, si): idxs for ki, (si, idxs) in by_k.items()}

        _, _, P = ring_layout(self.pen)
        C = cfg.ckpt_every
        k_sub = -(-(2 * C + 320) // 512) * 512
        while rounds:
            with counters.span("engine.plan"):
                k, s_cap = min(rounds)
                idxs = rounds.pop((k, s_cap))
                if k > cfg.k_max or s_cap > cfg.s_cap_max:
                    for i in idxs:
                        results[i] = self.DENSE_FALLBACK
                    continue
                per_pair = 4 * k * (s_cap // C + 1) * P + 4 * min(k, k_sub) * 5 * C
                bsz = int(max(1, min(cfg.budget_bytes // per_pair, cfg.max_batch)))
                idxs = sorted(idxs, key=lambda i: int(ql[i] + tl[i]))
            for lo in range(0, len(idxs), bsz):
                group = idxs[lo : lo + bsz]
                escalate = self._run_group(pool, group, results, k, s_cap, k_sub)
                # escalated pairs run again here, handed-back ones on the
                # segmented engine
                counters.add(reruns=len(escalate))
                for i, key in escalate:
                    if key is None:
                        results[i] = self.DENSE_FALLBACK
                    else:
                        rounds.setdefault(key, []).append(i)
        wf_stats.fallbacks += sum(r is self.DENSE_FALLBACK for r in results)
        return results

    def _run_group(self, pool, group, results, k, s_cap, k_sub):
        """Sweep, certify, replay and walk one group at band k (reference:
        _run_group_pallas); fills results and returns
        [(pair index, (next k, next s_cap) | None)], None meaning
        DENSE_FALLBACK."""
        cfg = self.config
        pen = self.pen
        C = cfg.ckpt_every
        pool_dev, qidx, tidx, ql_all, tl_all = pool
        dev = self.device
        B = len(group)
        with counters.span("engine.launch"):
            gi = np.asarray(group, dtype=np.int64)
            qlens = ql_all[gi].astype(np.int32)
            tlens = tl_all[gi].astype(np.int32)
            l_pad = next_pow2(max(int(max(qlens.max(), tlens.max())), 32))
            rows = pool_dev[:, :l_pad]
            qs = rows.index_select(0, torch.from_numpy(qidx[gi]).to(dev))
            ts = rows.index_select(0, torch.from_numpy(tidx[gi]).to(dev))
            ql_d = torch.from_numpy(qlens).to(dev)
            tl_d = torch.from_numpy(tlens).to(dev)

            init = wf_init(qs, ts, ql_d, tl_d, pen, k)
            ckpts, _, done_d, scores_d = wf_span(
                qs, ts, ql_d, tl_d, pen, k, l_pad, 0, s_cap, init.seeds, False,
                ckpt_every=C, done=init.done0, scores=init.scores0,
            )
        scores_h, done_h = to_host(scores_d, done_d)
        with counters.span("engine.unpack"):
            wf_stats.rounds.append((k, s_cap, B))
            # a pair's sweep stops after the level it finished at
            sweep_ll = int(np.where(done_h, scores_h, s_cap).sum()) * k
            wf_stats.sweep_lane_levels += sweep_ll

            # certificate: the exit-and-return bound of the dense engines
            k_end = tlens.astype(np.int64) - qlens.astype(np.int64)
            slack = (k - 1 - np.abs(k_end)) // 2
            nn = np.maximum(slack, 0) + 1
            g1 = pen.o1 + nn * pen.e1
            esc_bound = 2 * np.minimum(g1, pen.o2 + nn * pen.e2 if pen.two_piece else g1)
            k0_h = np.minimum(0, k_end) - slack
            full_cover = (k0_h <= -qlens) & (k0_h + (k - 1) >= tlens)
            cert = done_h & ((scores_h < esc_bound) | full_cover)

            escalate: List[Tuple[int, Optional[Tuple[int, int]]]] = []
            for j, i in enumerate(group):
                if not done_h[j]:
                    ns = s_cap * cfg.s_cap_growth
                    escalate.append((i, None if ns > cfg.s_cap_max else (k, ns)))
                elif not cert[j]:
                    nk = max(self.ladder.for_score(int(scores_h[j]), int(abs(k_end[j]))), 2 * k)
                    escalate.append((i, None if nk > cfg.k_max else (nk, self._round_up_seg(s_cap))))
        if not cert.any():
            return escalate

        # ---- backward replay + walk ----
        with counters.span("engine.launch"):
            run_cap = self._run_cap(scores_h, cert)
            cert_d = torch.from_numpy(cert).to(dev)
            walk = new_walk(
                torch.from_numpy(np.where(cert, scores_h, -1).astype(np.int32)).to(dev),
                init.c_end, tl_d, cert_d & (tl_d + ql_d > 0),
            )
            bufs = new_bufs(B, run_cap, dev)
            smax = int(scores_h[cert].max())
            # at least one pass from slot 0, even when every pair finished at
            # score 0 (the origin M-run emit happens in a segment walk)
            top = min(max(0, (smax - 1) // C), s_cap // C - 1)
            narrow = k > k_sub
            for seg in range(top, -1, -1):
                ring = ckpts[seg]
                c_lo = narrow_offsets(walk[1], k, k_sub) if narrow else None
                _, hist, _, _ = wf_span(
                    qs, ts, ql_d, tl_d, pen, k, l_pad, seg * C, C, ring, True,
                    c_lo=c_lo, k_sub=k_sub if narrow else None,
                )
                wf_traceback(hist, ring, seg * C, walk, bufs, pen, c_lo=c_lo)
                del hist
            del ckpts
        replay_ll = B * (top + 1) * C * (k_sub if narrow else k)
        wf_stats.replay_lane_levels += replay_ll
        counters.add(cells=sweep_ll + replay_ll)

        ops, lens, nrun, overflow, active = to_host(*bufs, walk[4])
        with counters.span("engine.unpack"):
            overflow = overflow | (active != 0)
            for j, i in enumerate(group):
                if not cert[j]:
                    continue
                if overflow[j]:
                    escalate.append((i, None))
                    continue
                results[i] = (int(scores_h[j]), walk_runs(ops[j], lens[j], int(nrun[j])))
        return escalate
