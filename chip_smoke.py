#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (allwave_tpu_torch).

Run from the repository root on a machine with one NVIDIA Hopper GPU:

    python3 chip_smoke.py

It builds the eleven CUDA kernel libraries from the sources in this
checkout (one nvcc per source, all at once; phase 1 prints every dense
forward, traceback and span kernel's registers and spill bytes from
ptxas, fails if a register-band forward or replay kernel or the
traceback spills, and prints the opcodes of the cluster sweep's and the
cluster replay's loops; for the step probes' 36 instantiations it
prints registers, spills, each one's step loop and its dependent chain
a step, and fails on a spill or a kernel with no chain; for the forward
and op-chain probes' 12 and 17 it prints registers, spills and loops,
and fails on a spill or a division in a loop of the forward's; for the
two walks' production kernels (the wavefront walk's FLIP = false
instantiation) it fails on a spill, a division in a loop or a hop with
no dependent chain), drives the port's three engines and runs the probes:

* the short-pair main path (phases 2-6): the dense forward and
  traceback kernels against their plain PyTorch versions (the forward
  at every band rung of its three tiers, tier 3 -- the replay cluster
  from the origin -- at every cluster size its dispatch takes, bands
  off the ladder, one- and two-piece penalties, edge pairs, both ways
  tier 1 reads the bases, with every plane entry held to the plain
  version's; the traceback's rows, hops and round trips held to the
  emulation of its schedule), the CLI and the AllPairAligner over
  bench.py's headline data (128 x 1 kb at 2% divergence, all 16,256
  directed pairs) and a 12 kb escalation case, then both kernels again
  at every shape those runs launched;
* the segmented long-pair path (phases 7-11): the span and
  segment-traceback kernels of the segmented (checkpoint-replay) dense
  engine against their plain versions, on checkpoints the span kernel
  swept, the sweep (the span without planes) and the replay (with
  planes), each a thread-block cluster a pair, at every cluster size
  their designs take, odd windows and edge pairs (phases 7-8); bench.py's
  config 5_100kb (4 x 100 kb at 2%, 12 directed pairs) through the CLI
  and the AllPairAligner, with a profile, each span shape's design, the
  clusters the card holds at once and the run buffers' sizes (no pair
  re-queued at the full run cap): the router sends all 12 pairs to the
  wavefront engine, whose band ceiling hands every one back to the
  segmented engine (phase 9);
  4 x 24 kb through both the one-shot dense engine (its rungs past 4096
  run tier 3: the designs, launches and device time are printed) and
  the segmented engine, which must agree exactly, then both dense
  kernels against their plain versions at each tier-3 shape the one-shot
  run launched, on its own pairs (phase 10); and both kernels again
  at every shape phase 9 launched (phase 11);
* the wavefront long-pair path (phases 12-15): the wavefront span
  kernel (sweep with ring checkpoints, history replay at full band and
  on the narrow sub-band; a thread-block cluster a pair, at every
  cluster size its design takes) and the window-traceback kernel
  against their plain versions at small shapes, three penalty sets, an
  identical, a tlen == l_pad and an infeasible pair, and run buffers
  that fit and that overflow (phases 12-13; phase 1 prints the span's
  registers and spills and fails on a spill or a division in its
  loops); bench.py's config 5b_100kb_lowdiv (8 x 100 kb at 0.25%, 56
  directed pairs) through the CLI and the AllPairAligner, with a
  profile, and the same 56 pairs through the segmented engine, which
  must give the same bytes (phase 14); and both kernels again at every
  band phase 14 launched, at its widest batch, then the sweep at the
  widest round on 5b, tandem-repeat and random pairs of its shape (the
  extension's share of a level) (phase 15);
* the probes (phase 16, allwave_tpu_torch/probes, the ports of the
  Pallas experiments in scripts/experiments): each probe kernel against
  its plain version at a reduced shape and at the experiment's own
  shape where the plain version is quick, then every variant timed at
  the experiment's shape, as `python -m allwave_tpu_torch.probes` does;
  and the cluster sweep's barrier alone, timed in the sweep's launch
  shape at every design phases 7 and 11 ran; and the latencies the
  walks' and the step probes' chain bounds are made of (a dependent
  shared-memory load, an ALU instruction, a device-memory load that
  misses L2, a shuffle, a block's barrier at each block size the step
  kernels run);
* orientation and MinHash counts on the card (phase 17,
  allwave_tpu_torch/sketch/membership.py: int8 membership rows and one
  `torch._int_mm`): the device decisions equal the NumPy path's and its
  f32 distances agree within 1e-5 relative on the headline's,
  3_giant099's and 4_tree_mixed's sets and a synthetic 1024 x 1 kb,
  the device counts equal the NumPy counts at every n of a ladder up to
  2048, the tree:2:1:0.02 pair list over 2048 x 1 kb is the same on
  both routes, both routes are timed over a ladder of n and their
  one-time set-up in a fresh process: the crossovers the thresholds of
  sketch/membership.py were set from;
* bench.py's configs 3_giant099 (-p giant:0.99) and 4_tree_mixed
  (-p tree:2:1:0.02), 3_giant099 once more with -p none (65,280 pairs)
  and a synthetic 512 x 1 kb with -p none (261,632 pairs), each through
  the CLI in a fresh process, whose routes must be the thresholds'
  (the 512 set's orientation on the device, the others' below their
  thresholds): no failed pair, every record's CIGAR replays; a warm
  pipeline run of each bench config, its results replayed; an oracle
  sample's scores (phase 18);
* pair sharding (phase 19): `parallel.mesh.sharded_dense_step` over
  [cuda:0] x 2 and x 3 at the headline's dispatch shape gives the single
  launch's bytes, two processes joined by a gloo group
  (`parallel.dist.DistributedAllPairAligner`, both on cuda:0) write
  shards whose merged sorted lines equal phase 4's PAF, and
  `align_pair` gives the oracle's score;
* the test-only tie-break mutation and the fuzz (phase 20): the
  wavefront walk's FLIP instantiation (`ALLWAVE_TB_FLIP`: I1 preferred
  over X on a tie) held to the flipped plain walk and its tile emulation
  at a 5b shape and on the mutation check's tie-rich batch (8 x 20 kb),
  whose flipped walk must differ from the production one; then
  allwave_tpu_torch/fuzz.py at 40 + 30 s: at least 150 phase-1 cases
  (the dense engines on random penalty sets against the native oracle,
  at least 50 of them, and the plain engine), at least 24 phase-2 cases
  (the wavefront engine against the segmented one on 10-100 kb pairs),
  no failure, and the mutation check in two fresh processes (clean 0,
  flipped > 0); its artifact goes to the smoke's OUT_DIR, FUZZ_GPU.json;
* the batched wavefront engine (phase 21, allwave_tpu_torch/wfa/engine.py
  and its kernels in csrc/wf_batch.cu, not on the main path: no earlier
  phase may launch them; no ring forward or walk kernel may spill): the
  forward (with and without history) and the walk against their plain
  versions in each forward design, one block a pair (K = 129), a cluster
  a pair (K = 513 on 10 pairs, K = 2049) and the global design (the
  narrowest K the dispatch gives it, short pairs), under edit, affine
  and two-piece penalties, on edge, unfinished, infeasible and empty
  pairs, with a run cap that overflows (the defined history rows
  compared, wfa/batch.py), the walk's steps and round trips equal to
  their emulation and the first walk (a thread a pair) equal too;
  `UnifiedAligner(pen).wavefront.align_pairs` over the headline's 16,256
  oriented pairs, whose scores and CIGARs must equal the dense engine's;
  at its widest history batch the forward timed beside the global design
  (equal outputs, and it must be faster) and its plain version, the
  walk beside the first walk and its plain version, with its longest
  walker's round trips; `discover_scores` over 5b's 56 oriented pairs
  against phase 14's long-path scores, and `align_pairs` over them
  against its CIGARs; at 5b's widest history batch the forward beside
  the global design, equal and faster.

Each wrapper counts its launches by shape; every count is set to 0 just
before a path is driven and read just after. Every kernel is held to its
plain version with tolerance 0: scores, certificates, band states, plane
bytes, walk states and run buffers must be equal, because the tie-break
contract (docs/TIEBREAK.md) leaves no room. Every phase prints its result
and its seconds on its own line, and the smoke's total seconds follow
phase 21; any failure exits non-zero. The last
three lines are the card's name and power limit, a JSON object with one
entry per kernel (its time beside its plain version's and its bound: the
larger of its least int32 operations over the card's int32 rate and its
bytes over HBM's), and the device line `{"ok": true, "device": {...}}`.

Without a CUDA device, or without the rest of the repository beside
it, the script exits non-zero before printing any result. It imports
nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out", "smoke")
SCORES = "0,5,8,2,24,1"
#: the 12 scores of bench.py's config 5_100kb (seed 17) under SCORES:
#: exact scores, so any kernel that changes one is wrong
SCORES_5_100KB = [11819, 11819, 11876, 11876, 11910, 11910, 23365, 23365, 23372, 23372,
                  23445, 23445]
#: its replays: one for each of the 98 segments of its two certified
#: groups of 6 pairs (each group replayed twice while a 4096-run buffer
#: overflowed on every pair and the pair was swept and replayed again)
REPLAYS_5_100KB = 196


class PhaseFailed(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseFailed(what)


def time_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() on the card (CUDA events), after one
    warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_queued_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over reps back-to-back calls (CUDA
    events), after one warm-up call; the card sleeps first long enough
    for the host to queue every launch, so a call shorter than its
    wrapper's host time is timed at the card's pace."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(max(20_000_000, int(2 * host_s * reps * 1.98e9)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_calls_ms(call, entries) -> float:
    """Mean milliseconds of call(*entry) on the card (CUDA events) over
    entries[1:], after a warm-up call on entries[0]; the entries (fresh
    copies of an in-place kernel's inputs) are all made before the
    events, and the card sleeps first long enough for the host to queue
    every launch, so a kernel shorter than its wrapper's host time is
    timed back to back, not at the host's pace."""
    import torch

    call(*entries[0])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)  # ~25 ms
    start.record()
    for e in entries[1:]:
        call(*e)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (len(entries) - 1)


def walk_row(stats_k, stats_e, ms, design) -> dict:
    """A walk's hops and misses, from the kernel's stats held equal to
    its tile schedule's emulation, with its microseconds a hop (over the
    longest walker: the walk's chain) and its tile design."""
    import torch

    check(torch.equal(stats_k.cpu(), stats_e), "the walk's hops or misses differ from its "
          f"tile schedule's emulation: {stats_k.tolist()} vs {stats_e.tolist()}")
    hops = stats_e[0]
    return {"hops_max": int(hops.max()), "hops_sum": int(hops.sum()),
            "misses": int(stats_e[1].sum()), "us_per_hop": 1e3 * ms / max(int(hops.max()), 1),
            "tile_rows": design.rows, "tile_slots": design.slots, "tile_cols": design.cols,
            "warps": design.warps}


def traceback_stats(rows_k, stats_k, emulated, at) -> dict:
    """The dense traceback's hops and round trips, from the kernel's
    stats held equal (with its rows) to the emulation of its schedule;
    and the 32-byte sectors its round trips touch as the emulation
    models them (the distinct sectors of each round's cells; not read
    from the card)."""
    import torch

    rows_e, stats_e = emulated
    check(torch.equal(rows_k, rows_e), f"traceback rows differ from its schedule's emulation at {at}")
    check(torch.equal(stats_k, stats_e[:2]), "traceback hops or round trips differ from its "
          f"schedule's emulation at {at}")
    hops, rounds, sectors = stats_e.cpu()
    check(bool((rounds <= hops).all()), f"a walk took more round trips than hops at {at}")
    return {"traceback_hops_max": int(hops.max()), "traceback_hops_sum": int(hops.sum()),
            "traceback_rounds_max": int(rounds.max()), "traceback_rounds_sum": int(rounds.sum()),
            "traceback_modeled_sectors": int(sectors.sum())}


def timed_once(fn):
    """(fn(), milliseconds of that one call on the card)."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def forward_case(device, scores_str, B, L, K, seed, div, reps, l_pad=None, run_cap=None,
                 batch=None):
    """Both kernels against their plain versions at one shape (on random
    pairs of length ~L, or on `batch`, numpy (qs, ts, qlens, tlens)): the
    forward's scores, certificates and planes, and the packed bytes of
    the traceback kernel over either plane and of the plain walk + pack
    over the plain plane; the traceback's rows, hops and round trips
    equal to the emulation of its schedule (`dense_traceback_groups`).
    The plain forward is timed on the one call that is checked. In tier
    1 the forward also runs with its bases read the other way (staged in
    shared memory or not), which must give the same outputs, and is timed
    so. Returns a result dict."""
    import numpy as np
    import torch

    from allwave_tpu_torch.core.scores import parse_scores
    from allwave_tpu_torch.probes.kexp import active_cells
    from allwave_tpu_torch.testing.batches import random_batch
    from allwave_tpu_torch.wfa import dense as D
    from allwave_tpu_torch.wfa.params import resolve_penalties

    pen = resolve_penalties(parse_scores(scores_str))
    l_pad = l_pad or 1 << max(L - 1, 1).bit_length()
    cap = run_cap or min(max(128, l_pad // 8), 2 * l_pad + 8)
    at = f"B={B} L={L} l_pad={l_pad} K={K} run_cap={cap}"
    if batch is None:
        batch = random_batch(np.random.RandomState(seed), B, L, l_pad, div, min_len=(3 * L) // 4)
    qs, ts, ql, tl = (torch.from_numpy(a).to(device) for a in batch)
    s_k, c_k, p_k = D.dense_forward(qs, ts, ql, tl, pen, K, l_pad)
    (s_p, c_p, p_p), plain_ms = timed_once(
        lambda: D.dense_forward_ref(qs, ts, ql, tl, pen, K, l_pad)
    )
    check(torch.equal(s_k, s_p), f"forward scores differ at {at}")
    check(torch.equal(c_k, c_p), f"forward certs differ at {at}")
    check(torch.equal(p_k, p_p), f"forward planes differ at {at}")
    plane_err = int((p_k.to(torch.int32) - p_p.to(torch.int32)).abs().max())
    tb_stats = torch.zeros((2, B), dtype=torch.int32, device=device)
    t_k = D.dense_traceback(p_k, s_k, c_k, ql, tl, cap, stats=tb_stats)
    t_kp = D.dense_traceback(p_p, s_p, c_p, ql, tl, cap)
    check(torch.equal(t_k, t_kp), f"traceback over the two planes differs at {at}")
    t_p, tb_plain_ms = timed_once(
        lambda: D.pack_alignments(s_p, c_p, *D.dense_traceback_ref(p_p, s_p, ql, tl, cap))
    )
    check(torch.equal(t_k, t_p), f"traceback kernel and plain walk differ at {at}")
    tb = traceback_stats(t_k, tb_stats, D.dense_traceback_groups(p_k, s_k, c_k, ql, tl, cap), at)
    del p_p, t_kp
    design = D.forward_design(K, l_pad, B, pen.two_piece)
    other_ms = None
    if design.tier == 1:
        other = not design.stage_bases
        try:
            D.forward_design(K, l_pad, B, pen.two_piece, other)
        except ValueError:  # the tables do not fit shared memory
            other = None
        if other is not None:
            s_o, c_o, p_o = D.dense_forward(qs, ts, ql, tl, pen, K, l_pad, other)
            check(torch.equal(s_o, s_k) and torch.equal(c_o, c_k) and torch.equal(p_o, p_k),
                  f"forward with stage_bases={other} differs at {at}")
            del s_o, c_o, p_o
            other_ms = time_ms(lambda: D.dense_forward(qs, ts, ql, tl, pen, K, l_pad, other), reps)
    ms = time_ms(lambda: D.dense_forward(qs, ts, ql, tl, pen, K, l_pad), reps)
    # the traceback is shorter than its wrapper's host time: queued behind a sleep
    tb_ms = time_calls_ms(D.dense_traceback, [(p_k, s_k, c_k, ql, tl, cap)] * (reps + 1))
    cells = B * 2 * l_pad * K
    _, k0, _ = D.band_geometry(ql, tl, K)
    active = active_cells(ql.cpu().numpy(), tl.cpu().numpy(), k0.cpu().numpy(), K, 0, 2 * l_pad)
    return {
        "scores": scores_str, "B": B, "L": L, "l_pad": l_pad, "K": K, "run_cap": cap,
        "certified": int(c_k.sum()), "tier": design.tier,
        "lanes_per_thread": design.lanes_per_thread, "warps_per_pair": design.warps_per_pair,
        "stage_bases": design.stage_bases, "blocks_per_pair": design.blocks_per_pair,
        "max_abs_err": max(int((s_k - s_p).abs().max()), plane_err,
                           int((t_k.to(torch.int32) - t_p.to(torch.int32)).abs().max())),
        "tolerance": 0, "ms": ms, "plain_ms": plain_ms, "other_bases_ms": other_ms,
        "gcells_s": cells / (ms * 1e6), "plain_gcells_s": cells / (plain_ms * 1e6),
        "traceback_ms": tb_ms, "traceback_plain_ms": tb_plain_ms,
        "active_cells": active, "runs": int(t_k[:, :32].contiguous().view(torch.int32)[:, 1].sum()),
        "traceback_out_bytes": t_k.numel(), **tb,
    }


def forward_tier_case(device, scores_str, B, K, l_pad, seed, stage_bases=None):
    """The forward kernel against its plain version on the edge pairs of
    testing.batches.edge_batch: scores, certificates and every plane
    entry, tolerance 0. Returns a result dict with the design it ran."""
    import numpy as np
    import torch

    from allwave_tpu_torch.core.scores import parse_scores
    from allwave_tpu_torch.testing.batches import edge_batch
    from allwave_tpu_torch.wfa import dense as D
    from allwave_tpu_torch.wfa.params import resolve_penalties

    pen = resolve_penalties(parse_scores(scores_str))
    batch = edge_batch(np.random.RandomState(seed), B, l_pad, K)
    qs, ts, ql, tl = (torch.from_numpy(a).to(device) for a in batch)
    design = D.forward_design(K, l_pad, B, pen.two_piece, stage_bases)
    D.forward_launches.reset()
    s_k, c_k, p_k = D.dense_forward(qs, ts, ql, tl, pen, K, l_pad, stage_bases)
    check(D.forward_launches.designs == {(B, K, l_pad): design},
          f"the forward at K={K} did not launch its dispatch's design {design}")
    s_p, c_p, p_p = D.dense_forward_ref(qs, ts, ql, tl, pen, K, l_pad)
    at = f"{scores_str} B={B} K={K} l_pad={l_pad} design={design}"
    check(torch.equal(s_k, s_p), f"forward scores differ at {at}")
    check(torch.equal(c_k, c_p), f"forward certs differ at {at}")
    check(torch.equal(p_k, p_p), f"forward planes differ at {at}")
    return {
        "scores": scores_str, "two_piece": pen.two_piece, "B": B, "K": K, "l_pad": l_pad,
        "tier": design.tier, "lanes_per_thread": design.lanes_per_thread,
        "warps_per_pair": design.warps_per_pair, "stage_bases": design.stage_bases,
        "blocks_per_pair": design.blocks_per_pair, "band_edge_pairs": int(((ql - tl).abs() == K - 1).sum()),
        "infeasible": int((s_k >= D.INF).sum()), "certified": int(c_k.sum()),
        "max_abs_err": max(int((s_k - s_p).abs().max()),
                           int((p_k.to(torch.int32) - p_p.to(torch.int32)).abs().max())),
        "tolerance": 0,
    }


def traceback_case(device, B, L, K, seed, div, run_caps, reps):
    """Traceback kernel against the plain walk + pack on one plane."""
    import numpy as np
    import torch

    from allwave_tpu_torch.core.scores import parse_scores
    from allwave_tpu_torch.testing.batches import random_batch
    from allwave_tpu_torch.wfa import dense as D
    from allwave_tpu_torch.wfa.params import resolve_penalties

    pen = resolve_penalties(parse_scores(SCORES))
    l_pad = 1 << max(L - 1, 1).bit_length()
    batch = random_batch(np.random.RandomState(seed), B, L, l_pad, div, min_len=(3 * L) // 4)
    qs, ts, ql, tl = (torch.from_numpy(a).to(device) for a in batch)
    s, c, p = D.dense_forward(qs, ts, ql, tl, pen, K, l_pad)
    out = []
    for cap in run_caps:
        stats = torch.zeros((2, B), dtype=torch.int32, device=device)
        k = D.dense_traceback(p, s, c, ql, tl, cap, stats=stats)
        ref, plain_ms = timed_once(
            lambda: D.pack_alignments(s, c, *D.dense_traceback_ref(p, s, ql, tl, cap))
        )
        check(torch.equal(k, ref), f"traceback bytes differ at run_cap={cap}")
        tb = traceback_stats(k, stats, D.dense_traceback_groups(p, s, c, ql, tl, cap),
                             f"run_cap={cap}")
        overflowed = int(k[:, 12:16].contiguous().view(torch.int32).sum())
        diff = int((k.to(torch.int32) - ref.to(torch.int32)).abs().max())
        ms = time_calls_ms(D.dense_traceback, [(p, s, c, ql, tl, cap)] * (reps + 1))
        out.append({
            "B": B, "L": L, "K": K, "run_cap": cap, "overflowed": overflowed,
            "max_abs_err": diff, "tolerance": 0, "ms": ms, "plain_ms": plain_ms, **tb,
        })
    return out


def span_case(device, B, L, l_pad, K, k_sub, C, seg, seed, div, reps, run_caps=()):
    """The span kernel against its plain version at one shape, then the
    segment-traceback kernel against its plain version over that span's
    planes. The span kernel sweeps the checkpoints of a random batch up
    to segment `seg`; from there one span of C steps runs with planes
    and without, at the full band (k_sub None) or on the narrow replay's
    sub-band around the main diagonal. Walkers enter at the segment's
    top on the main diagonal and walk it at each run_cap (a tiny cap
    overflows): walk state and run buffers equal to the plain walk's,
    hops and misses to the tile schedule's emulation; the kernel is
    timed alone. Returns (span results, traceback results)."""
    import numpy as np
    import torch

    from allwave_tpu_torch.core.scores import parse_scores
    from allwave_tpu_torch.probes.kexp import active_cells
    from allwave_tpu_torch.testing.batches import random_batch
    from allwave_tpu_torch.wfa import segmented as TS
    from allwave_tpu_torch.wfa.dense import band_geometry
    from allwave_tpu_torch.wfa.params import resolve_penalties

    pen = resolve_penalties(parse_scores(SCORES))
    batch = random_batch(np.random.RandomState(seed), B, L, l_pad, div, min_len=(3 * L) // 4)
    qs, ts, ql, tl = (torch.from_numpy(a).to(device) for a in batch)
    _, _, ckpts = TS.dense_sweep_ckpt(qs, ts, ql, tl, pen, K, l_pad, C, n_seg=seg + 1)
    state = ckpts[:, seg]
    d_lo = seg * C
    _, k0, _ = band_geometry(ql, tl, K)
    c = (-k0).clamp(0, K - 1).to(torch.int32)  # the main diagonal, k = 0
    narrow = k_sub is not None and k_sub < K
    c_lo = TS.narrow_offsets(c, K, k_sub) if narrow else None
    W = k_sub if narrow else K
    at = f"B={B} l_pad={l_pad} K={K} k_sub={W} d_lo={d_lo} n_steps={C}"
    args = (qs, ts, ql, tl, pen, K, l_pad, d_lo, C, state)
    spans, tbs, planes_k = [], [], None
    for with_planes in (True, False):
        kw = dict(c_lo=c_lo, k_sub=W if narrow else None)
        st_k, pl_k = TS.dense_span(*args, with_planes, **kw)
        (st_p, pl_p), plain_ms = timed_once(lambda: TS.dense_span_ref(*args, with_planes, **kw))
        check(torch.equal(st_k, st_p), f"span states differ at {at} planes={with_planes}")
        err = int((st_k - st_p).abs().max())
        if with_planes:
            check(torch.equal(pl_k, pl_p), f"span planes differ at {at}")
            err = max(err, int((pl_k.to(torch.int32) - pl_p.to(torch.int32)).abs().max()))
            planes_k = pl_k
        del st_p, pl_p
        ms = time_ms(lambda: TS.dense_span(*args, with_planes, **kw), reps)
        design = TS.span_design(K, W, with_planes, B, pen.two_piece)
        cells = B * C * W
        k_lo = k0 + (c_lo if narrow else 0)
        active = active_cells(ql.cpu().numpy(), tl.cpu().numpy(), k_lo.cpu().numpy(), W, d_lo, C)
        spans.append({
            "B": B, "l_pad": l_pad, "K": K, "k_sub": W, "d_lo": d_lo, "n_steps": C,
            "with_planes": with_planes, "G": design.blocks_per_pair,
            "Lb": design.lanes_per_block, "lpt": design.lanes_per_thread,
            "max_abs_err": err, "tolerance": 0,
            "ms": ms, "plain_ms": plain_ms, "us_per_step": 1e3 * ms / C,
            "gcells_s": cells / (ms * 1e6),
            "plain_gcells_s": cells / (plain_ms * 1e6), "active_cells": active,
        })
    for cap in run_caps:
        walk0 = TS.new_walk(torch.full_like(ql, d_lo + C), c, torch.ones_like(ql, dtype=torch.bool))
        bufs0 = TS.new_bufs(B, cap, device)

        def fresh():
            return walk0.clone(), tuple(b.clone() for b in bufs0)

        walk_k, bufs_k = fresh()
        stats_k = torch.zeros((2, B), dtype=torch.int32, device=device)
        TS.segment_traceback(planes_k, d_lo, walk_k, bufs_k, l_pad, c_lo=c_lo, stats=stats_k)
        walk_p, bufs_p = fresh()
        _, plain_ms = timed_once(
            lambda: TS.traceback_segment_ref(planes_k, d_lo, walk_p, bufs_p, c_lo=c_lo)
        )
        check(torch.equal(walk_k, walk_p), f"walk states differ at {at} run_cap={cap}")
        for a, b in zip(bufs_k, bufs_p):
            check(torch.equal(a, b), f"run buffers differ at {at} run_cap={cap}")
        err = max(int((walk_k - walk_p).abs().max()),
                  *(int((a.to(torch.int32) - b.to(torch.int32)).abs().max())
                    for a, b in zip(bufs_k, bufs_p)))
        # the tile schedule's emulation on the CPU: the kernel's hops and
        # misses must be its
        design = TS.segment_walk_design(C, W)
        walk_e, bufs_e = walk0.cpu(), tuple(b.cpu() for b in bufs0)
        stats_e = torch.zeros((2, B), dtype=torch.int32)
        TS.traceback_segment_tiles(planes_k.cpu(), d_lo, walk_e, bufs_e,
                                   c_lo=None if c_lo is None else c_lo.cpu(), stats=stats_e,
                                   design=design)
        check(torch.equal(walk_e, walk_p.cpu()), f"the emulated walk differs at {at} run_cap={cap}")
        # the kernel alone: every timed call walks its own fresh copy of
        # the entry state, made before the events
        ms = time_calls_ms(lambda w, b: TS.segment_traceback(planes_k, d_lo, w, b, l_pad, c_lo=c_lo),
                           [fresh() for _ in range(reps + 1)])
        tbs.append({
            "B": B, "l_pad": l_pad, "K": K, "k_sub": W, "n_steps": C, "run_cap": cap,
            "runs": int(bufs_k[2].sum()), "overflowed": int(bufs_k[3].sum()),
            "max_abs_err": err, "tolerance": 0, "ms": ms, "plain_ms": plain_ms,
            **walk_row(stats_k, stats_e, ms, design),
        })
    return spans, tbs


def cluster_case(device, scores_str, B, K, k_sub, l_pad, C, seg, seed, edge, reps, planes):
    """The sweep (planes False) or the replay (planes True), each a
    thread-block cluster a pair, against its plain version at one shape,
    tolerance 0: from a checkpoint the kernel swept to segment `seg`, one
    span of C steps at the full band (k_sub None) or on a window of k_sub
    lanes at per-pair offsets (odd ones among them), on random pairs or
    on the edge pairs of testing.batches.edge_batch (lengths 0 and 1,
    |k_end| = K - 1, an infeasible pair): the end state and, for the
    replay, every plane entry. Returns a result dict with the design it
    ran."""
    import numpy as np
    import torch

    from allwave_tpu_torch.core.scores import parse_scores
    from allwave_tpu_torch.testing.batches import edge_batch, random_batch
    from allwave_tpu_torch.wfa import segmented as TS
    from allwave_tpu_torch.wfa.params import resolve_penalties

    pen = resolve_penalties(parse_scores(scores_str))
    rng = np.random.RandomState(seed)
    arrays = (edge_batch(rng, B, l_pad, K) if edge else
              random_batch(rng, B, l_pad - 64, l_pad, 0.02, min_len=(3 * l_pad) // 4))
    qs, ts, ql, tl = (torch.from_numpy(a).to(device) for a in arrays)
    _, _, ckpts = TS.dense_sweep_ckpt(qs, ts, ql, tl, pen, K, l_pad, C, n_seg=seg + 1)
    W = k_sub or K
    c_lo = None
    if k_sub is not None:
        c_lo = torch.tensor([(129 * i) % (K - W + 1) for i in range(B)], dtype=torch.int32,
                            device=device)
    args = (qs, ts, ql, tl, pen, K, l_pad, seg * C, C, ckpts[:, seg], planes)
    kw = dict(c_lo=c_lo, k_sub=k_sub)
    st_k, pl_k = TS.dense_span(*args, **kw)
    (st_p, pl_p), plain_ms = timed_once(lambda: TS.dense_span_ref(*args, **kw))
    mode = "replay" if planes else "sweep"
    at = f"{mode} {scores_str} B={B} K={K} k_sub={W} l_pad={l_pad} edge={edge}"
    check(torch.equal(st_k, st_p), f"states differ at {at}")
    err = int((st_k - st_p).abs().max())
    if planes:
        check(torch.equal(pl_k, pl_p), f"planes differ at {at}")
        err = max(err, int((pl_k.to(torch.int32) - pl_p.to(torch.int32)).abs().max()))
    del st_p, pl_p, pl_k
    design = TS.span_design(K, W, planes, B, pen.two_piece)
    check(design.replay == planes, f"the span did not take its design at {at}")
    ms = time_ms(lambda: TS.dense_span(*args, **kw), reps)
    return {
        "mode": mode, "scores": scores_str, "B": B, "K": K, "k_sub": W, "l_pad": l_pad,
        "d_lo": seg * C, "n_steps": C, "edge": edge, "G": design.blocks_per_pair,
        "Lb": design.lanes_per_block, "lpt": design.lanes_per_thread,
        "max_clusters": TS.span_max_clusters(K, W, planes, B, pen.two_piece),
        "max_abs_err": err, "tolerance": 0, "ms": ms, "plain_ms": plain_ms,
        "us_per_step": 1e3 * ms / C,
    }


def wf_inputs(device, scores_str, l_pad, K, seed, div=0.03):
    """A seeded wavefront edge-case batch on the card (an identical pair,
    a pair with tlen == l_pad, an infeasible one, a short one) and its
    score-0 state."""
    import numpy as np
    import torch

    from allwave_tpu_torch.core.scores import parse_scores
    from allwave_tpu_torch.testing.batches import wavefront_batch
    from allwave_tpu_torch.wfa import wf_segmented as TW
    from allwave_tpu_torch.wfa.params import resolve_penalties

    pen = resolve_penalties(parse_scores(scores_str))
    batch = tuple(torch.from_numpy(a).to(device)
                  for a in wavefront_batch(np.random.RandomState(seed), l_pad, K, div))
    return pen, batch, TW.wf_init(*batch, pen, K)


def wf_sweep_check(pen, batch, init, K, l_pad, C, n_steps, reps, at):
    """The sweep kernel against its plain version over n_steps levels:
    scores, done and every checkpoint slot. Returns (result dict, the
    kernel's (ckpts, done, scores))."""
    import torch

    from allwave_tpu_torch.wfa import wf_segmented as TW

    args = (*batch, pen, K, l_pad, 0, n_steps, init.seeds, False)
    kw = dict(ckpt_every=C, done=init.done0, scores=init.scores0)
    ck_k, _, d_k, s_k = TW.wf_span(*args, **kw)
    (ck_p, _, d_p, s_p), plain_ms = timed_once(lambda: TW.wf_span_ref(*args, **kw))
    check(torch.equal(s_k, s_p) and torch.equal(d_k, d_p), f"sweep scores/done differ at {at}")
    check(torch.equal(ck_k, ck_p), f"sweep checkpoints differ at {at}")
    del ck_p
    ms = time_ms(lambda: TW.wf_span(*args, **kw), reps)
    B = batch[0].shape[0]
    g = TW.wf_span_design(K, K, False, B, pen)
    return {
        "mode": "sweep", "B": B, "K": K, "W": K, "l_pad": l_pad, "n_steps": n_steps,
        "ckpt_every": C, "G": g.blocks_per_pair, "Lb": g.lanes_per_block,
        "lanes_per_thread": g.lanes_per_thread, "done": int(d_k.sum()),
        "max_abs_err": int((s_k - s_p).abs().max()), "tolerance": 0, "ms": ms,
        "plain_ms": plain_ms, "levels_run": int(torch.where(d_k, s_k, n_steps).max()),
        # a pair's sweep stops after the level it finished at
        "lane_levels": int(torch.where(d_k, s_k, n_steps).sum()) * K,
        "ckpt_bytes": ck_k.numel() * ck_k.element_size(),
    }, (ck_k, d_k, s_k)


def wf_hist_check(pen, batch, K, l_pad, C, seg, ring, c_lo, k_sub, reps, at):
    """A history span from a kernel-made checkpoint slot against its
    plain version, at full band (c_lo None) or on the sub-band."""
    import torch

    from allwave_tpu_torch.wfa import wf_segmented as TW

    args = (*batch, pen, K, l_pad, seg * C, C, ring, True)
    kw = dict(c_lo=c_lo, k_sub=k_sub) if c_lo is not None else {}
    _, h_k, _, _ = TW.wf_span(*args, **kw)
    (_, h_p, _, _), plain_ms = timed_once(lambda: TW.wf_span_ref(*args, **kw))
    check(torch.equal(h_k, h_p), f"history planes differ at {at} narrow={c_lo is not None}")
    err = int((h_k.to(torch.int64) - h_p.to(torch.int64)).abs().max())
    ms = time_ms(lambda: TW.wf_span(*args, **kw), reps)
    B, W = batch[0].shape[0], h_k.shape[3]
    g = TW.wf_span_design(K, W, True, B, pen)
    return {
        "mode": "history", "B": B, "K": K, "W": W, "l_pad": l_pad, "s_lo": seg * C,
        "n_steps": C, "G": g.blocks_per_pair, "Lb": g.lanes_per_block,
        "lanes_per_thread": g.lanes_per_thread, "max_abs_err": err, "tolerance": 0, "ms": ms,
        "plain_ms": plain_ms, "lane_levels_per_s": B * C * W / (ms * 1e-3),
        "ring_bytes": TW.ring_layout(pen)[2] * B * W * 4, "plane_bytes": h_k.numel() * 4,
    }, h_k


def wf_walk_chain(device, pen, batch, init, ck, done, scores, K, l_pad, C, k_sub, run_caps,
                  reps, n_seg=None):
    """The window-traceback kernel against its plain version: walkers
    start at each done pair's end cell and walk back segment by segment
    (n_seg segments from the top, or all) over history planes the span
    kernel replays, narrow when K > k_sub; walk state and the four run
    buffers must be equal after every segment, at each run_cap, and each
    segment's hops and misses equal to the tile schedule's emulation. The
    last segment's walk is timed alone. Returns one result dict per
    run_cap, with a digest of the final walk state and run buffers."""
    import hashlib

    import torch

    from allwave_tpu_torch.wfa import segmented as TS
    from allwave_tpu_torch.wfa import wf_segmented as TW

    ql, tl = batch[2], batch[3]
    B = ql.shape[0]
    top = (int(scores[done].max()) - 1) // C
    segs = list(range(top, -1, -1))[: n_seg or None]
    narrow = K > k_sub
    out = []
    for cap in run_caps:
        walk_k = TW.new_walk(torch.where(done, scores, -1), init.c_end, tl, done & (ql + tl > 0))
        walk_p, walk_e = walk_k.clone(), walk_k.cpu()
        bufs_k, bufs_p = TW.new_bufs(B, cap, device), TW.new_bufs(B, cap, device)
        bufs_e = TW.new_bufs(B, cap, "cpu")
        at = f"B={B} K={K} l_pad={l_pad} run_cap={cap}"
        hops = misses = 0
        for seg in segs:
            c_lo = TS.narrow_offsets(walk_k[1], K, k_sub) if narrow else None
            _, hist, _, _ = TW.wf_span(*batch, pen, K, l_pad, seg * C, C, ck[seg], True,
                                       c_lo=c_lo, k_sub=k_sub if narrow else None)
            entry = (walk_k.clone(), tuple(b.clone() for b in bufs_k))
            stats_k = torch.zeros((2, B), dtype=torch.int32, device=device)
            TW.wf_traceback(hist, ck[seg], seg * C, walk_k, bufs_k, pen, c_lo=c_lo, stats=stats_k)
            _, plain_ms = timed_once(
                lambda: TW.traceback_window_ref(hist, ck[seg], seg * C, walk_p, bufs_p, pen, c_lo=c_lo))
            check(torch.equal(walk_k, walk_p), f"walk states differ at {at} segment {seg}")
            for a, b in zip(bufs_k, bufs_p):
                check(torch.equal(a, b), f"run buffers differ at {at} segment {seg}")
            # the tile schedule's emulation on the CPU: the kernel's hops
            # and misses must be its
            design = TW.wf_walk_design(C, hist.shape[3])
            stats_e = torch.zeros((2, B), dtype=torch.int32)
            TW.traceback_window_tiles(hist.cpu(), ck[seg].cpu(), seg * C, walk_e, bufs_e, pen,
                                      c_lo=None if c_lo is None else c_lo.cpu(), stats=stats_e,
                                      design=design)
            check(torch.equal(walk_e, walk_p.cpu()), f"the emulated walk differs at {at} segment {seg}")
            row = walk_row(stats_k, stats_e, 0.0, design)
            hops += row["hops_sum"]
            misses += row["misses"]
        err = max(int((walk_k - walk_p).abs().max()),
                  *(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
                    for a, b in zip(bufs_k, bufs_p)))
        # the kernel alone on the last segment: every timed call walks its
        # own fresh copy of that segment's entry state, made before the
        # events
        ms = time_calls_ms(
            lambda w, b: TW.wf_traceback(hist, ck[seg], seg * C, w, b, pen, c_lo=c_lo),
            [(entry[0].clone(), tuple(b.clone() for b in entry[1])) for _ in range(reps + 1)])
        out.append({
            "B": B, "K": K, "W": k_sub if narrow else K, "l_pad": l_pad, "n_steps": C,
            "run_cap": cap, "segments": len(segs), "runs": int(bufs_k[2].sum()),
            "overflowed": int(bufs_k[3].sum()), "max_abs_err": err, "tolerance": 0,
            "ms": ms, "plain_ms": plain_ms,
            # the last segment's hops, misses and us a hop (the timed walk),
            # and those of all segments
            **walk_row(stats_k, stats_e, ms, design), "chain_hops_sum": hops,
            "chain_misses": misses,
            "digest": hashlib.sha256(b"".join(t.cpu().numpy().tobytes()
                                              for t in (walk_k, *bufs_k))).hexdigest()[:16],
        })
    return out


def _paf_records(path):
    with open(path) as f:
        return [line.rstrip("\n").split("\t") for line in f if line.strip()]


def validate_paf(recs, seqs, chunk=4096) -> int:
    """Replay every PAF record's CIGAR against its (oriented) sequences,
    with core.cigar.validate_cigar's checks: the CIGAR parses, every
    run's count is positive, it consumes the whole query and target,
    and every '='/'M' base matches and every 'X' base does not. NumPy
    replays `chunk` records at a time; the first record at fault raises
    ValueError. Returns the number of records without a CIGAR (failed
    pairs)."""
    import re

    import numpy as np

    from allwave_tpu_torch.orient.orientation import reverse_complement

    fwd = {s.id: s.seq for s in seqs}
    rev = {}
    run_re = re.compile(r"(\d+)([=XMID])")
    todo = [f for f in recs if f[13].startswith("cg:Z:") and f[13] != "cg:Z:"]
    for c0 in range(0, len(todo), chunk):
        part = todo[c0:c0 + chunk]
        qs, ts, counts, ops, n_runs = [], [], [], [], []
        for f in part:
            q = fwd[f[0]]
            if f[4] == "-":
                q = rev[f[0]] if f[0] in rev else rev.setdefault(f[0], reverse_complement(q))
            qs.append(q)
            ts.append(fwd[f[5]])
            runs = run_re.findall(f[13], 5)
            if sum(len(c) + 1 for c, _ in runs) != len(f[13]) - 5:
                raise ValueError(f"{f[0]} {f[5]}: unparsable CIGAR {f[13][:80]}")
            counts.extend(int(c) for c, _ in runs)
            ops.append("".join(o for _, o in runs))
            n_runs.append(len(runs))
        counts = np.array(counts, np.int64)
        op = np.frombuffer("".join(ops).encode(), np.uint8)
        rec = np.repeat(np.arange(len(part)), n_runs)
        both = (op == ord("=")) | (op == ord("X")) | (op == ord("M"))
        cq = (both | (op == ord("I"))) * counts
        ct = (both | (op == ord("D"))) * counts
        q_len = np.array([len(q) for q in qs], np.int64)
        t_len = np.array([len(t) for t in ts], np.int64)
        bad = ((np.bincount(rec, cq, len(part)) != q_len)
               | (np.bincount(rec, ct, len(part)) != t_len))
        bad[rec[counts <= 0]] = True
        if bad.any():
            f = part[int(np.argmax(bad))]
            raise ValueError(f"{f[0]} {f[5]}: CIGAR does not cover the pair or has a zero count")
        # each run's first query and target base in the chunk's buffers
        first_run = np.cumsum(n_runs) - n_runs
        q_at = np.cumsum(cq) - cq
        t_at = np.cumsum(ct) - ct
        q_at += (np.cumsum(q_len) - q_len - q_at[first_run])[rec]
        t_at += (np.cumsum(t_len) - t_len - t_at[first_run])[rec]
        n = counts[both]
        within = np.arange(int(n.sum())) - np.repeat(np.cumsum(n) - n, n)
        eq = (np.frombuffer(b"".join(qs), np.uint8)[np.repeat(q_at[both], n) + within]
              == np.frombuffer(b"".join(ts), np.uint8)[np.repeat(t_at[both], n) + within])
        wrong = eq != np.repeat(op[both] != ord("X"), n)
        if wrong.any():
            f = part[int(rec[both][np.repeat(np.arange(n.size), n)[np.argmax(wrong)]])]
            raise ValueError(f"{f[0]} {f[5]}: CIGAR '=' over mismatching or 'X' over "
                             "matching bases")
    return len(recs) - len(todo)


def check_alignments(seqs, results, pen, n_sample, seed):
    """Every result valid and its CIGAR's score the reported one;
    n_sample pairs oracle-exact (the Python oracle's work grows as s²,
    so the long path samples none). results: list of AlignmentResult.
    Returns the number of failed pairs."""
    import numpy as np

    from allwave_tpu_torch.core.cigar import validate_cigar
    from allwave_tpu_torch.orient.orientation import reverse_complement
    from allwave_tpu_torch.testing.dense import cigar_score
    from allwave_tpu_torch.wfa.reference_impl import wfa_align

    failed = 0
    cigars = []
    for r in results:
        # short pairs come back as runs, long pairs as per-base bytes; a
        # failed pair has neither
        if r.cigar_runs is not None:
            ops, lens = r.cigar_runs
            cig = np.repeat(np.asarray(ops, np.uint8), np.asarray(lens, np.int64))
        else:
            cig = np.asarray(r.cigar_bytes, np.uint8)
        if cig.size == 0:
            failed += 1
            cigars.append(None)
            continue
        q = seqs[r.query_idx].seq
        if r.is_reverse:
            q = reverse_complement(q)
        validate_cigar(cig, q, seqs[r.target_idx].seq)
        check(cigar_score(cig, pen) == r.score,
              f"cigar score {cigar_score(cig, pen)} != reported {r.score}")
        cigars.append(cig)
    rng = np.random.RandomState(seed)
    for j in rng.choice(len(results), size=min(n_sample, len(results)), replace=False):
        r = results[int(j)]
        q = seqs[r.query_idx].seq
        if r.is_reverse:
            q = reverse_complement(q)
        score, cig = wfa_align(q, seqs[r.target_idx].seq, pen)
        check(score == r.score, f"oracle score {score} != {r.score}")
        check(np.array_equal(np.asarray(cig, np.uint8), cigars[int(j)]),
              f"oracle CIGAR differs for pair {r.query_idx},{r.target_idx}")
    return failed


def run_pipeline(seqs, scores_str, sparsification=None):
    """AllPairAligner with mash orientation over the pairs the
    sparsification keeps (all pairs by default); returns (results,
    seconds)."""
    import torch

    from allwave_tpu_torch.core.scores import parse_scores
    from allwave_tpu_torch.engine.pipeline import AllPairAligner

    out = []
    t0 = time.perf_counter()
    aligner = AllPairAligner(
        seqs, parse_scores(scores_str), exclude_self=True, use_mash_orientation=True,
        sparsification=sparsification,
    )
    aligner.for_each_with_callback(out.append)
    if aligner.device.type == "cuda":
        torch.cuda.synchronize(aligner.device)
    return out, time.perf_counter() - t0


def profile_pipeline(seqs, scores_str):
    """One more pipeline run under torch.profiler: device time by kernel
    name, the device's busy time (union of kernel intervals) and its
    idle share of the run's wall time, and the forward kernel's rate
    over the DP cells the engine counted in this run. Returns None if
    the profiler saw no kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from allwave_tpu_torch.utils.telemetry import counters

    torch.cuda.reset_peak_memory_stats()
    counters.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res, _ = run_pipeline(seqs, scores_str)
        wall_ms = 1e3 * (time.perf_counter() - t0)
    cells = counters.snapshot()["cells"]
    spans = [
        (e.time_range.start, e.time_range.end, e.name)
        for e in prof.events()
        if str(getattr(e, "device_type", "")).endswith("CUDA")
    ]
    if not spans:
        return None
    by_name = {}
    for a, b, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e3
    busy_us, end = 0.0, None
    for a, b, _ in sorted(spans):
        if end is None or a > end:
            busy_us += b - a
            end = b
        elif b > end:
            busy_us += b - end
            end = b
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    forward_ms, tier3_ms = forward_device_ms(spans)
    return {
        "pairs": len(res), "wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3,
        "dp_cells": cells, "forward_device_ms": forward_ms, "tier3_device_ms": tier3_ms,
        "traceback_device_ms": sum(v for k, v in by_name.items() if "dense_traceback" in k),
        "forward_gcells_s": cells / (forward_ms * 1e6) if forward_ms else None,
        "device_idle_share": 1.0 - busy_us / 1e3 / wall_ms,
        "peak_device_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "device_ms_by_kernel": {_short(k): v for k, v in top},
    }


def forward_device_ms(spans):
    """(all the dense forward's device ms, its tier 3's) over profiled
    device spans (start us, end us, kernel name): tiers 1-2 and tier 3's
    epilogue by name; tier 3's replay cluster, which the segmented engine
    launches too, where the forward's epilogue is the next span on the
    card (the wrapper launches the two back to back on one stream)."""
    spans = sorted(spans)
    names = [_short(n) for _, _, n in spans]
    forward_us = tier3_us = 0.0
    for i, (a, b, _) in enumerate(spans):
        name = names[i]
        if name.startswith("dense_replay_cluster_kernel"):
            if i + 1 < len(spans) and names[i + 1].startswith("dense_forward_finish_kernel"):
                forward_us += b - a
                tier3_us += b - a
        elif name.startswith("dense_forward"):
            forward_us += b - a
            if name.startswith("dense_forward_finish_kernel"):
                tier3_us += b - a
    return forward_us / 1e3, tier3_us / 1e3


def _short(kernel_name: str) -> str:
    """A kernel's name without its return type, namespace and argument
    list: `dense_sweep_cluster_kernel<true>`, `dense_forward_regs_kernel<(int)6,
    (bool)1, (bool)1, (bool)0>`."""
    name = kernel_name.replace("(anonymous namespace)::", "").replace("<unnamed>::", "")
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for i, ch in enumerate(name):
        depth += {"<": 1, ">": -1}.get(ch, 0)
        if ch == "(" and depth == 0:
            return name[:i][:80]
    return name[:80]


def _wf_span_mode(short_name: str):
    """True for the wavefront span's history instantiation, False for its
    sweep, None for any other kernel (`wf_span_cluster_kernel<HIST,
    TWO_PIECE>`, its template arguments as `true` or `(bool)1`)."""
    if not short_name.startswith("wf_span_cluster_kernel<"):
        return None
    return short_name.split("<", 1)[1].split(",")[0].strip() in ("true", "(bool)1", "1")


def merge_cases(cases):
    """bench.py's _merge_cases: the sequences of several synthetic cases
    with re-keyed ids."""
    from allwave_tpu_torch.core.types import Sequence

    return [Sequence(f"c{ci}_{s.id}", s.seq) for ci, case in enumerate(cases)
            for s in case.sequences]


def bench_sets():
    """bench.py's configs 3_giant099 (256 x 2 kb, seed 13) and
    4_tree_mixed (86 x 800 + 85 x 1800 + 85 x 3000, seeds 14-16), both at
    bench.py's 2% (`cfg2`)."""
    from allwave_tpu_torch.testing.synth import MutationConfig, make_test_case

    cfg2 = MutationConfig(0.02, 0.0005, 0.0005)
    giant = make_test_case(13, 256, 2000, cfg2).sequences
    mixed = merge_cases([make_test_case(14, 86, 800, cfg2), make_test_case(15, 85, 1800, cfg2),
                         make_test_case(16, 85, 3000, cfg2)])
    return giant, mixed


def best_ms(fn, reps):
    """The least host wall time of `reps` calls, each ended by a device
    synchronize (the device paths copy their results to the host)."""
    import torch

    best = None
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        best = ms if best is None else min(best, ms)
    return best


def crossover(rows, setup_ms=0.0):
    """The least n of the ladder from which the device route, with
    `setup_ms` added, is faster than NumPy at every larger n (None if it
    never is)."""
    n = None
    for r in sorted(rows, key=lambda r: -r["n"]):
        if r["device_ms"] + setup_ms >= r["numpy_ms"]:
            break
        n = r["n"]
    return n


#: a fresh process: the device routes' one-time set-up on a device whose
#: context exists (the context itself is paid by any first use), as the
#: first call's time less a warm call's: the counts route (scatter,
#: `torch._int_mm` through cuBLASLt) at n = 32, then orientation at
#: n = 16, whose first call adds its decision and distance kernels
SETUP_WORKER = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
from allwave_tpu_torch.orient.orientation import OrientationIndex
from allwave_tpu_torch.sketch import minhash as MH
from allwave_tpu_torch.testing.synth import MutationConfig, make_test_case

dev = torch.device("cuda", 0)
seqs = make_test_case(21, 32, 1000, MutationConfig(0.02, 0.0005, 0.0005)).sequences
torch.zeros(1, device=dev)
torch.cuda.synchronize()

def ms(fn):
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)

sk = [np.unique(MH.sketch_canonical(s.seq, 15, 1000)) for s in seqs]
sizes = np.array([x.size for x in sk], dtype=np.int64)
counts = lambda: MH._intersection_counts_device(sk, sizes, dev)
cold_c = ms(counts)
warm_c = min(ms(counts) for _ in range(3))
idx = OrientationIndex(seqs[:16], device=dev)
for i in range(16):
    idx._fwd_set(i)
    idx._rev_set(i)
orient = lambda: idx._decision_matrix_device(dev)
cold_o = ms(orient)
warm_o = min(ms(orient) for _ in range(3))
print(json.dumps({"counts_first_ms": cold_c, "counts_warm_ms": warm_c,
                  "orient_first_ms": cold_o, "orient_warm_ms": warm_o,
                  "counts_setup_ms": cold_c - warm_c,
                  "orient_setup_ms": cold_c - warm_c + cold_o - warm_o}))
"""


def synthetic_set():
    """2048 x 1 kb at bench.py's 2% (seed 21): phase 17's ladders and
    1024 set, phase 18's 512 set."""
    from allwave_tpu_torch.testing.synth import MutationConfig, make_test_case

    return make_test_case(21, 2048, 1000, MutationConfig(0.02, 0.0005, 0.0005)).sequences


def phase17(dev, headline, giant, mixed, synth):
    """Orientation decisions and MinHash counts on the card: the device
    routes against the NumPy paths on the headline, 3_giant099's and
    4_tree_mixed's sets and a synthetic 1024 x 1 kb at 2% (decisions and
    counts exact, f32 distances within rtol 1e-5), the tree:2:1:0.02
    pair list over 2048 x 1 kb on both routes, both routes timed over a
    ladder of n, host remap included (sketch sets are built before
    either path is timed), and the routes' one-time set-up in a fresh
    process: the crossovers the thresholds of sketch/membership.py were
    set from (a fresh process's: the set-up added to the device's
    time; and, for comparison, a warm process's)."""
    import numpy as np

    from allwave_tpu_torch.orient.orientation import OrientationIndex
    from allwave_tpu_torch.sketch import membership as MB
    from allwave_tpu_torch.sketch import minhash as MH
    from allwave_tpu_torch.sparsify.knn import extract_tree_pairs

    proc = subprocess.run([sys.executable, "-c", SETUP_WORKER, HERE], capture_output=True,
                          text=True, timeout=300)
    check(proc.returncode == 0, f"phase 17: the set-up worker failed:\n{proc.stderr[-3000:]}")
    setup = json.loads(proc.stdout.strip().splitlines()[-1])
    print("phase 17 set-up: " + json.dumps(setup), flush=True)

    def index(seqs):
        idx = OrientationIndex(seqs, device=dev)
        for i in range(len(seqs)):
            idx._fwd_set(i)
            idx._rev_set(i)
        return idx

    out = {"setup": setup, "sets": [], "orient_ladder": [], "counts_ladder": []}
    index(headline[:32])._decision_matrix_device(dev)  # this process's set-up
    for name, seqs in (("headline", headline), ("3_giant099", giant),
                       ("4_tree_mixed", mixed), ("synthetic_1024", synth[:1024])):
        n = len(seqs)
        idx = index(seqs)
        got = {}
        numpy_ms = best_ms(lambda: got.update(numpy=idx._decision_matrix()), 1)
        dist_np = idx._distances
        device_ms = best_ms(lambda: got.update(device=idx._decision_matrix_device(dev)), 1)
        dist_dev = idx._distances
        check(np.array_equal(got["device"], got["numpy"]),
              f"phase 17 {name}: device decisions differ")
        check(np.allclose(dist_dev, dist_np, rtol=1e-5, atol=1e-7),
              f"phase 17 {name}: device distances differ beyond f32")
        hashes = np.concatenate([idx._fwd_set(i) for i in range(n)]
                                + [idx._rev_set(i) for i in range(n)])
        U = int(np.unique(hashes).size)
        row = {"set": name, "n": n, "U": U, "membership_bytes": 2 * n * (U + 1),
               "reversed": int(got["numpy"].sum()), "numpy_ms": numpy_ms, "device_ms": device_ms,
               "dist_max_rel_err": float(np.max(np.abs(dist_dev - dist_np)
                                                / np.maximum(dist_np, 1e-12)))}
        print("phase 17 orientation: " + json.dumps(row), flush=True)
        out["sets"].append(row)
    check(out["sets"][-1]["membership_bytes"] <= OrientationIndex.DEVICE_MEMBERSHIP_MAX,
          "phase 17: the synthetic 1024 set is over the membership budget")

    for n in (4, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512):
        idx = index(synth[:n])
        reps = 5 if n <= 64 else 3 if n <= 256 else 1
        row = {"n": n, "numpy_ms": best_ms(idx._decision_matrix, reps),
               "device_ms": best_ms(lambda: idx._decision_matrix_device(dev), reps)}
        print("phase 17 orientation ms: " + json.dumps(row), flush=True)
        out["orient_ladder"].append(row)
    out["orient_ladder"].append({k: out["sets"][-1][k] for k in ("n", "numpy_ms", "device_ms")})

    sketches = [np.unique(MH.sketch_canonical(s.seq, 15, 1000)) for s in synth]
    sizes = np.array([sk.size for sk in sketches], dtype=np.int64)
    min_n = MH.COUNT_DEVICE_MIN_N
    try:
        MH.COUNT_DEVICE_MIN_N = 1 << 30  # the NumPy bitmap pass
        for n in (4, 8, 12, 16, 24, 32, 64, 128, 256, 384, 512, 1024, 2048):
            got = {}
            reps = 5 if n <= 64 else 3 if n <= 256 else 1
            row = {"n": n, "numpy_ms": best_ms(
                lambda: got.update(numpy=MH.pairwise_intersection_counts(sketches[:n])), reps),
                "device_ms": best_ms(lambda: got.update(device=MH._intersection_counts_device(
                    sketches[:n], sizes[:n], dev)), reps)}
            check(np.array_equal(got["numpy"], got["device"]),
                  f"phase 17: device intersection counts differ at n = {n}")
            print("phase 17 counts ms: " + json.dumps(row), flush=True)
            out["counts_ladder"].append(row)
        MB.count_routes.reset()
        pairs_np = extract_tree_pairs(synth, 2, 1, 0.02, 15)
    finally:
        MH.COUNT_DEVICE_MIN_N = min_n
    pairs_dev = extract_tree_pairs(synth, 2, 1, 0.02, 15)
    check(MB.count_routes.counts == {"numpy": 1, "device": 1},
          f"phase 17: the tree pair lists took routes {MB.count_routes.counts}")
    check(np.array_equal(pairs_np, pairs_dev), "phase 17: tree:2:1:0.02 pair lists differ")
    out["tree_pairs_2048"] = int(pairs_dev.shape[0])
    out["crossover"] = {
        "orient_fresh_n": crossover(out["orient_ladder"], setup["orient_setup_ms"]),
        "orient_warm_n": crossover(out["orient_ladder"]),
        "orient_threshold": MB.ORIENT_DEVICE_MIN_N,
        "counts_fresh_n": crossover(out["counts_ladder"], setup["counts_setup_ms"]),
        "counts_warm_n": crossover(out["counts_ladder"]),
        "counts_threshold": MB.COUNT_DEVICE_MIN_N,
    }
    print("phase 17 crossover: " + json.dumps(
        {**out["crossover"], "tree_pairs_2048": out["tree_pairs_2048"]}), flush=True)
    return out


#: the CLI in a fresh process, as a user runs it: its exit code, the
#: routes its orientation and MinHash requests took, and its seconds
#: (imports apart; the CUDA context and every one-time set-up included)
CLI_WORKER = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
t0 = time.perf_counter()
from allwave_tpu_torch import cli
from allwave_tpu_torch.sketch import membership as MB
t1 = time.perf_counter()
rc = cli.main(sys.argv[2:])
print(json.dumps({"rc": rc, "import_s": t1 - t0, "cli_s": time.perf_counter() - t1,
                  "orientation": MB.orient_routes.counts, "counts": MB.count_routes.counts}))
"""


def oracle_sample_paf(recs, seqs, pen, n_sample, seed):
    """n_sample PAF records' CIGARs are the oracle's, and so their scores."""
    import numpy as np

    from allwave_tpu_torch.core.cigar import cigar_string_to_bytes
    from allwave_tpu_torch.orient.orientation import reverse_complement
    from allwave_tpu_torch.testing.dense import cigar_score
    from allwave_tpu_torch.wfa.reference_impl import wfa_align

    by_id = {s.id: s.seq for s in seqs}
    rng = np.random.RandomState(seed)
    for j in rng.choice(len(recs), size=min(n_sample, len(recs)), replace=False):
        f = recs[int(j)]
        q = by_id[f[0]] if f[4] == "+" else reverse_complement(by_id[f[0]])
        score, cig = wfa_align(q, by_id[f[5]], pen)
        got = cigar_string_to_bytes(f[13][5:])
        check(cigar_score(got, pen) == score, f"oracle score {score} != {cigar_score(got, pen)}")
        check(np.array_equal(np.asarray(cig, np.uint8), got),
              f"oracle CIGAR differs for pair {f[0]},{f[5]}")


def phase18(pen, giant, mixed, synth512):
    """bench.py's configs 3_giant099 (-p giant:0.99) and 4_tree_mixed
    (-p tree:2:1:0.02), 3_giant099's sequences once more with -p none
    (65,280 pairs), and a synthetic 512 x 1 kb with -p none (261,632
    pairs), each through the CLI in a fresh process: the routes a user's
    run takes (only the 512 set's full orientation matrix is at the
    device threshold; 4_tree_mixed's 256 MinHash sets and 3_giant099's
    256 orientation sets are below theirs), no failed pair, every
    record's CIGAR replays; then a warm pipeline run of each bench
    config (its results replayed, an oracle sample's scores), and an
    oracle sample of the 512 set's records."""
    from allwave_tpu_torch.engine.fasta import write_fasta
    from allwave_tpu_torch.sparsify.pairs import parse_sparsification

    rows = []
    numpy_, native, device = {"numpy": 1}, {"native": 1}, {"device": 1}
    for name, seqs, spec, want in (
            ("3_giant099", giant, "giant:0.99", {"orientation": native, "counts": {}}),
            ("4_tree_mixed", mixed, "tree:2:1:0.02", {"orientation": native, "counts": numpy_}),
            ("3_giant099_none", giant, "none", {"orientation": numpy_, "counts": {}}),
            ("synthetic_512_none", synth512, "none", {"orientation": device, "counts": {}})):
        fasta = os.path.join(OUT_DIR, f"{name}.fa")
        paf = os.path.join(OUT_DIR, f"{name}.paf")
        write_fasta(fasta, seqs)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", CLI_WORKER, HERE, "-i", fasta, "-p", spec, "-s", SCORES,
             "-o", paf, "--no-progress"], capture_output=True, text=True, timeout=600)
        process_s = time.perf_counter() - t0
        check(proc.returncode == 0, f"phase 18 {name}: the CLI process failed:\n"
              f"{proc.stderr[-3000:]}")
        fresh = json.loads(proc.stdout.strip().splitlines()[-1])
        check(fresh["rc"] == 0, f"phase 18 {name}: cli exit code {fresh['rc']}")
        routes = {"orientation": fresh["orientation"], "counts": fresh["counts"]}
        check(routes == want, f"phase 18 {name}: a fresh process took routes {routes}, "
              f"not {want}")
        recs = _paf_records(paf)
        t0 = time.perf_counter()
        empty = validate_paf(recs, seqs)
        check(empty == 0, f"phase 18 {name}: {empty} failed pairs in the CLI output")
        if spec == "none":
            check(len(recs) == len(seqs) * (len(seqs) - 1),
                  f"phase 18 {name}: {len(recs)} records")
            os.remove(paf)  # tens of MB
        row = {"config": name, "p": spec, "n": len(seqs), "pairs": len(recs), "failed": empty,
               "fresh_routes": routes, "fresh_cli_s": fresh["cli_s"],
               "fresh_import_s": fresh["import_s"], "fresh_process_s": process_s}
        if name.startswith("synthetic"):
            oracle_sample_paf(recs, seqs, pen, n_sample=2, seed=18)
        else:
            res, warm_s = run_pipeline(seqs, SCORES, parse_sparsification(spec))
            check(len(res) == len(recs),
                  f"phase 18 {name}: {len(res)} results, {len(recs)} records")
            failed = check_alignments(seqs, res, pen, n_sample=2, seed=18)
            check(failed == 0, f"phase 18 {name}: {failed} failed pairs")
            row.update(warm_s=warm_s, warm_alignments_per_s=len(res) / warm_s)
        row["check_s"] = time.perf_counter() - t0
        print("phase 18 config: " + json.dumps(row), flush=True)
        rows.append(row)
    return rows


DIST_WORKER = r"""
import sys
sys.path.insert(0, sys.argv[6])
init, nproc, rank, fasta, prefix = sys.argv[1:6]

import torch.distributed as dist

from allwave_tpu_torch.core.scores import parse_scores
from allwave_tpu_torch.core.types import NoSparsification
from allwave_tpu_torch.engine.fasta import read_fasta
from allwave_tpu_torch.parallel.dist import DistributedAllPairAligner, init_distributed

init_distributed(init, int(nproc), int(rank))
seqs = read_fasta(fasta)
al = DistributedAllPairAligner(seqs, parse_scores(sys.argv[7]), exclude_self=True,
                               use_mash_orientation=True, sparsification=NoSparsification())
al.run_to_paf_shard(prefix)
print(f"rank {rank}: {al.pair_count()} pairs")
dist.destroy_process_group()
"""


def phase19(dev, pen, headline, headline_fasta, headline_paf):
    """Sharding: sharded_dense_step over [cuda:0] x 2 and x 3 (an uneven
    split) at the headline's dispatch shape gives the single call's
    bytes; two processes joined by a gloo group run
    DistributedAllPairAligner on the headline's FASTA, both on cuda:0,
    and their merged shards' sorted lines equal phase 4's; align_pair on
    one headline pair gives the oracle's score."""
    import socket

    import allwave_tpu_torch as aw
    from allwave_tpu_torch.core.scores import parse_scores
    from allwave_tpu_torch.parallel.check import dispatch_inputs, sharded_matches_single
    from allwave_tpu_torch.parallel.dist import merge_paf_shards
    from allwave_tpu_torch.wfa.reference_impl import wfa_align

    out = {}
    inputs = dispatch_inputs(headline, dev, 4096)
    for nd in (2, 3):
        check(sharded_matches_single([dev] * nd, inputs),
              f"phase 19: sharded bytes over {nd} devices differ")
    out["sharded"] = {"B": int(inputs[1].shape[0]), "K": 192, "l_pad": 1024, "run_cap": 128,
                      "devices": [2, 3], "identical": True}

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    prefix = os.path.join(OUT_DIR, "dist")
    env = dict(os.environ, ALLWAVE_PLATFORM=dev.type)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", DIST_WORKER, f"tcp://127.0.0.1:{port}", "2", str(rank),
         headline_fasta, prefix, HERE, SCORES],
        cwd=HERE, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(2)]
    try:
        for p in procs:
            so, se = p.communicate(timeout=300)
            check(p.returncode == 0, f"phase 19: a gloo worker failed:\n{so}\n{se[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    dist_s = time.perf_counter() - t0
    merged = os.path.join(OUT_DIR, "dist_merged.paf")
    merge_paf_shards(prefix, 2, merged)
    with open(merged) as f:
        merged_lines = sorted(f)
    with open(headline_paf) as f:
        want = sorted(f)
    check(merged_lines == want, "phase 19: the merged gloo shards differ from phase 4's PAF")
    out["gloo"] = {"processes": 2, "lines": len(merged_lines), "seconds": dist_s,
                   "equal_to_phase4": True}

    q, t = headline[0], headline[1]
    res = aw.align_pair(q, t, 0, 1, parse_scores(SCORES))
    qb = aw.reverse_complement(q.seq) if res.is_reverse else q.seq
    oracle, _ = wfa_align(qb, t.seq, pen)
    check(res.score == oracle, f"phase 19: align_pair score {res.score} != oracle {oracle}")
    out["align_pair"] = {"score": res.score, "oracle": oracle}
    print("phase 19 sharding: " + json.dumps(out), flush=True)
    return out


def phase20(dev, pen, shape5b, batch5, C, k_sub):
    """Phase 20: the wavefront walk's FLIP instantiation (the test-only
    tie-break mutation) against the flipped plain walk, then the fuzz
    (allwave_tpu_torch/fuzz.py) at a smoke budget. Returns its report."""
    import numpy as np
    import torch

    from allwave_tpu_torch import fuzz as FZ
    from allwave_tpu_torch.testing.batches import pair_batch
    from allwave_tpu_torch.testing.fuzzgen import tie_rich_batch
    from allwave_tpu_torch.wfa import wf_segmented as TW

    def chain(batch, K, l_pad, s_cap, run_caps, n_seg):
        init = TW.wf_init(*batch, pen, K)
        ck, _, done, scores = TW.wf_span(*batch, pen, K, l_pad, 0, s_cap, init.seeds, False,
                                         ckpt_every=C, done=init.done0, scores=init.scores0)
        check(bool(done.any()), f"no pair of the phase 20 batch finished at K={K}")
        return wf_walk_chain(dev, pen, batch, init, ck, done, scores, K, l_pad, C, k_sub,
                             run_caps, reps=2, n_seg=n_seg)

    # the kernel's FLIP instantiation, held to the flipped plain walk and
    # its tile emulation (wf_walk_chain's checks): two segments at a 5b
    # walk shape (phase 14's pairs), and every segment of the mutation
    # check's tie-rich batch (8 x 20 kb), whose flipped walk must differ
    # from the production instantiation's
    (K5, l5), (B5, cap5) = shape5b
    tie_pairs, _ = tie_rich_batch(np.random.RandomState(1234), 20_000, 8)
    tie = tuple(torch.from_numpy(a).to(dev) for a in pair_batch(tie_pairs, 32768))
    rows = {}
    clean = chain(tie, 2048, 32768, 2048, (4096,), None)
    try:
        TW._TB_FLIP = True
        rows["5b"] = chain(batch5(B5, l5), K5, l5, cap5, (4096,), 2)
        rows["tie_rich"] = chain(tie, 2048, 32768, 2048, (4096,), None)
    finally:
        TW._TB_FLIP = False
    changed = rows["tie_rich"][0]["digest"] != clean[0]["digest"]
    check(changed, "the flipped walk of the tie-rich batch equals the production walk")
    flip = {"max_abs_err": max(r["max_abs_err"] for v in rows.values() for r in v),
            "shapes": {k: [[r[x] for x in ("B", "K", "W", "n_steps", "run_cap", "segments")]
                           for r in v] for k, v in rows.items()},
            "tie_rich_flip_changes_walk": changed}
    print("phase 20 flip kernel: " + json.dumps(flip), flush=True)

    # the fuzz's phases and its mutation check, the artifact in OUT_DIR
    # (never tests/artifacts/): at least 150 phase-1 cases (50 against the
    # oracle) and 24 phase-2 cases, no failure, the flip detected
    rec = FZ.run(seed=20, budget_s=40, wf_budget_s=30, out=os.path.join(OUT_DIR, "FUZZ_GPU.json"),
                 device="cuda", log=lambda m: print("phase 20 fuzz: " + m, flush=True))
    p1, p2, mut = rec["phase1"], rec["phase2"], rec["mutation_check"]
    check(p1["failures"] == 0 and p2["failures"] == 0, "the fuzz counted failures")
    check(p1["cases"] >= 150 and p1["oracle_compared"] >= 50,
          f"phase 1 of the fuzz ran {p1['cases']} cases, {p1['oracle_compared']} against the oracle")
    check(p2["cases"] >= 24, f"phase 2 of the fuzz ran {p2['cases']} cases")
    check(mut["detected"], f"the mutation check did not detect the flip: {mut}")
    return {"flip": flip, "phase1": p1, "phase2": p2, "mutation_check": mut}


def wf_batch_err(a, b, mask=None) -> int:
    """Largest |a - b| over two integer or bool tensors (where `mask`)."""
    import torch

    d = (a.to(torch.int64) - b.to(torch.int64)).abs()
    if mask is not None:
        d = torch.where(mask, d, 0)
    return int(d.max()) if d.numel() else 0


def wf_batch_case(dev, scores_str, batch, K, s_cap, run_caps, tier):
    """Both csrc/wf_batch.cu kernels against their plain versions on one
    batch (numpy qs, ts, qlens, tlens), the forward with and without
    history in the design its shape picks (which must be `tier`): scores,
    done, the defined history rows (0..score of a finished pair, every
    row of an unfinished one); and at each run cap the walk's ops, lens,
    nruns and overflow, its steps and round trips equal to
    `wavefront_traceback_rounds`', and the first walk (a thread a pair)
    equal too. Returns a row with the largest difference (max_abs_err),
    the design and the plain versions' ms."""
    import numpy as np
    import torch

    from allwave_tpu_torch.core.scores import parse_scores
    from allwave_tpu_torch.wfa import batch as WB
    from allwave_tpu_torch.wfa.params import resolve_penalties

    pen = resolve_penalties(parse_scores(scores_str))
    qs, ts, ql, tl = (torch.from_numpy(a).to(dev) for a in batch)
    B, l_pad = qs.shape
    design = WB.forward_design(K, B, l_pad, pen)
    check(design.tier == tier, f"the forward's design at B={B} K={K} is {design}, not {tier}")
    err, plain_ms, rounds = 0, {}, []
    for hist in (False, True):
        sk, dk, hk = WB.wavefront_forward(qs, ts, ql, tl, pen, s_cap, K, hist)
        (sp, dp, hp), plain_ms[f"forward_hist{int(hist)}"] = timed_once(
            lambda: WB.wavefront_forward_ref(qs, ts, ql, tl, pen, s_cap, K, hist))
        err = max(err, wf_batch_err(sk, sp), wf_batch_err(dk, dp))
    err = max(err, wf_batch_hist_err(hk, hp, sp, dp))
    for cap in run_caps:
        stats = torch.zeros((2, B), dtype=torch.int32, device=dev)
        got = WB.wavefront_traceback(hk, sk, ql, tl, pen, cap, stats=stats)
        want, plain_ms[f"traceback_{cap}"] = timed_once(
            lambda: WB.wavefront_traceback_ref(hp, sp, ql, tl, pen, cap))
        thread = WB.wavefront_traceback(hk, sk, ql, tl, pen, cap, design="thread")
        emu = WB.wavefront_traceback_rounds(hp, sp, ql, tl, pen, cap)
        err = max([err] + [wf_batch_err(a, b) for a, b in zip(got, want)]
                  + [wf_batch_err(a, b) for a, b in zip(thread, want)]
                  + [wf_batch_err(stats.cpu(), torch.from_numpy(emu[4]))])
        rounds.append(int(emu[4][1].max()))
    torch.cuda.synchronize()
    row = {"scores": scores_str, "B": B, "K": K, "s_cap": s_cap, "l_pad": l_pad,
           "design": design._asdict(), "run_caps": list(run_caps), "max_abs_err": err,
           "plain_ms": plain_ms, "done": int(dk.sum()), "rounds_max": rounds,
           "overflow_at_last_cap": int(got[3].sum())}
    check(err == 0, f"a wf_batch kernel differs from its plain version: {row}")
    return row


def wf_batch_first_k(pen, B, l_pad, tier) -> int:
    """The narrowest band whose forward design for B pairs is `tier`
    (block, cluster, global: the order they take as K grows), by
    bisection over the dispatch's table."""
    from allwave_tpu_torch.wfa import batch as WB

    def rank(K):
        return WB.TIERS.index(WB.forward_design(K, B, l_pad, pen).tier)

    lo, hi = 1, 1 << 17
    check(rank(lo) < WB.TIERS.index(tier) <= rank(hi), f"no {tier} design below K = {hi}")
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if rank(mid) < WB.TIERS.index(tier) else (lo, mid)
    return hi


def wf_batch_versus(dev, pen, batch, cap, reps):
    """The forward at a history batch in the design its shape picks and in
    the global design, equal (scores, done, the defined history rows) and
    timed in one call, global, new, new, global (card-paced); the new
    design's outputs are returned with the row."""
    import torch

    from allwave_tpu_torch.wfa import batch as WB

    qs, ts, ql, tl = batch
    B, l_pad = qs.shape
    K = 2 * cap + 1
    new = lambda: WB.wavefront_forward(qs, ts, ql, tl, pen, cap, K, True)
    old = lambda: WB.wavefront_forward(qs, ts, ql, tl, pen, cap, K, True, design="global")
    sk, dk, hk = new()
    sg, dg, hg = old()
    err = max(wf_batch_err(sk, sg), wf_batch_err(dk, dg), wf_batch_hist_err(hk, hg, sg, dg))
    del hg
    g0, n0, n1, g1 = (time_queued_ms(f, reps) for f in (old, new, new, old))
    levels = torch.where(dk, sk, cap).to(torch.int64) + 1
    row = {"B": B, "K": K, "s_cap": cap, "l_pad": l_pad,
           "design": WB.forward_design(K, B, l_pad, pen)._asdict(), "ms": [n0, n1],
           "global_ms": [g0, g1], "versus_global_err": err,
           "lane_levels": int(levels.sum()) * K, "hist_bytes": 20 * int(levels.sum()) * K}
    check(err == 0, f"the forward's designs differ at {row}")
    check(max(n0, n1) < min(g0, g1), f"the forward is not faster than the global design at {row}")
    return row, (sk, dk, hk)


def wf_batch_hist_err(hk, hp, scores, done) -> int:
    """wf_batch_err over the defined history rows (wfa/batch.py's
    don't-care rule: rows above a finished pair's score are not compared)."""
    import torch

    S1 = hk["m"].shape[0]
    lim = torch.where(done, scores, S1 - 1)
    rows = (torch.arange(S1, device=scores.device)[:, None] <= lim[None, :])[:, :, None]
    return max(wf_batch_err(hk[c], hp[c], rows) for c in hk)


def phase21(dev, pen, seqs, pool5b, qi5b, ti5b, wf_out):
    """Phase 21: the batched wavefront engine (wfa/engine.py) and its two
    kernels (csrc/wf_batch.cu). No earlier phase launched them (the main
    path does not route here). The kernels against their plain versions
    in every forward design under three penalty sets: one block a pair
    (K = 129), a cluster a pair (K = 513 on 10 pairs, three blocks whose
    edges the wavefronts cross; K = 2049) and the global design (the
    narrowest K the table gives it); the sharded step over [cuda:0] x 2
    against one device; the engine's align_pairs over the headline's
    16,256 oriented pairs against the dense engine's scores and CIGARs;
    at its widest history batch the forward beside the global design and
    its plain version, the walk beside the first walk (a thread a pair),
    its plain version and its round trips; discover_scores over 5b's 56
    oriented pairs against the long path's scores (phase 14), and
    align_pairs over them against its CIGARs; at 5b's widest history
    batch the forward beside the global design. Returns its report."""
    import numpy as np
    import torch

    from allwave_tpu_torch.core.scores import parse_scores
    from allwave_tpu_torch.engine.pipeline import AllPairAligner
    from allwave_tpu_torch.parallel.mesh import sharded_alignment_step
    from allwave_tpu_torch.testing.batches import pair_batch, random_batch, wavefront_batch
    from allwave_tpu_torch.wfa import batch as WB
    from allwave_tpu_torch.wfa import cuda_build
    from allwave_tpu_torch.wfa.dense_engine import UnifiedAligner
    from allwave_tpu_torch.wfa.params import resolve_penalties

    counts = (WB.forward_launches, WB.traceback_launches)
    before = [lc.count for lc in counts]
    check(before == [0, 0], f"an earlier phase launched the wf_batch kernels: {before}")
    # registers and spills of every wf_batch kernel; the ring forward and
    # the walk may not spill
    usage = cuda_build.ptxas_usage("wf_batch")
    print("phase 21 ptxas: " + json.dumps(usage), flush=True)
    check(all(u.get("spill_stores", 1) == 0 and u.get("spill_loads", 1) == 0
              for k, u in usage.items() if "ring_kernel" in k or "walk_kernel" in k),
          "a wf_batch ring forward or walk kernel spills")

    # the kernels against their plain versions: the wavefront engine's
    # edge batch at K = 129 (an identical, a tlen == l_pad, an infeasible,
    # an unfinished and a short pair) with empty pairs, and at K = 513;
    # mutated 1.5 kb pairs at K = 2049; short pairs at the first global
    # K; a run cap that fits and one that overflows
    rng = np.random.RandomState(21)
    empty = pair_batch([(b"", b"ACGTT"), (b"ACG", b""), (b"", b"")], 256)
    small = tuple(np.concatenate(x) for x in zip(wavefront_batch(rng, 256, 129), empty))
    empty1k = pair_batch([(b"", b"ACGTT"), (b"ACG", b""), (b"", b"")], 1024)
    mid = tuple(np.concatenate(x) for x in zip(wavefront_batch(rng, 1024, 513), empty1k))
    bases = np.frombuffer(b"ACGT", np.uint8)
    wide = []
    for _ in range(6):
        q = rng.choice(bases, 1500 + rng.randint(0, 500)).tobytes()
        t = bytearray(q)
        for j in rng.randint(0, len(t), 15):
            t[j] = bases[rng.randint(4)]
        del t[700:703]
        wide.append((q, bytes(t)))
    wide += [(wide[0][0], wide[0][0]), (b"", b""), (b"G" * 2048, b"G" * 2000)]
    short = tuple(np.concatenate(x) for x in zip(random_batch(rng, 4, 120, 256, 0.01, 60), empty))
    cases = []
    for s in ("0,1,1,1", "0,5,8,2", "0,5,8,2,24,1"):
        gk = wf_batch_first_k(resolve_penalties(parse_scores(s)), len(short[0]), 256, "global")
        cases.append(wf_batch_case(dev, s, small, 129, 64, (2 * 64 + 16, 5), "block"))
        cases.append(wf_batch_case(dev, s, mid, 513, 256, (2 * 256 + 16, 5), "cluster"))
        cases.append(wf_batch_case(dev, s, pair_batch(wide, 2048), 2049, 1024, (2 * 1024 + 16, 5),
                                   "cluster"))
        cases.append(wf_batch_case(dev, s, short, gk, 32, (2 * 32 + 16, 5), "global"))
    for r in cases:
        print("phase 21 kernels: " + json.dumps(r), flush=True)
    # the step sharded over [cuda:0] x 2 gives the single device's outputs
    qs, ts, ql, tl = (torch.from_numpy(a).to(dev) for a in small)
    one, two = (sharded_alignment_step(devs, pen, 64, 129)(qs, ts, ql, tl)
                for devs in ([dev], [dev, dev]))
    check(all(torch.equal(a, b) for a, b in zip(one, two)),
          "sharded_alignment_step over two devices differs from one")

    # the engine over the headline's oriented pairs, against the dense engine
    apa = AllPairAligner(seqs, parse_scores(SCORES), exclude_self=True, use_mash_orientation=True)
    pool, qi, ti, _, _ = apa._orient_chunk(apa.get_pairs())
    pairs = [(pool[q], pool[t]) for q, t in zip(qi.tolist(), ti.tolist())]
    ua = UnifiedAligner(pen, device=dev)
    dense = ua.align_pairs(pairs)
    for lc in counts:
        lc.reset()
    t0 = time.perf_counter()
    got = ua.wavefront.align_pairs(pairs)
    torch.cuda.synchronize()
    engine_s = time.perf_counter() - t0
    launches = {"wf_batch_forward": WB.forward_launches.count,
                "wf_batch_traceback": WB.traceback_launches.count}
    fwd_shapes = dict(WB.forward_launches.shapes)
    fwd_designs = {k: v.tier + (" staged" if v.staged else "") + f" {v.blocks_per_pair}x"
                   f"{v.lanes_per_block}" for k, v in WB.forward_launches.designs.items()}
    check(all(v > 0 for v in launches.values()),
          f"the batch engine did not launch both kernels: {launches}")
    check(all(g is not None for g in got), "the batch engine failed pairs of the headline")
    same = [a[0] == b[0] and np.array_equal(a[1], b[1]) for a, b in zip(got, dense)]
    check(all(same), f"the batch engine differs from the dense engine on {same.count(False)} "
          f"of {len(same)} headline pairs")
    rounds = sorted([k[0], k[1], n, fwd_designs[k]] for k, n in fwd_shapes.items() if not k[4])
    hist_batches = sorted([k[0], k[1], n, fwd_designs[k]] for k, n in fwd_shapes.items() if k[4])
    head = {"pairs": len(pairs), "identical_to_dense": sum(same), "engine_s": engine_s,
            "launches": launches, "discovery_B_K_launches_design": rounds,
            "history_B_K_launches_design": hist_batches,
            "max_score": max(g[0] for g in got)}
    print("phase 21 headline: " + json.dumps(head), flush=True)

    # both kernels timed at the widest history batch of the headline run:
    # the forward beside the global design and its plain version, the walk
    # beside the first walk and its plain version, its round trips held
    # to their emulation
    eng = ua.wavefront

    def widest_batch(prs, scores):
        caps = [max(eng.config.s_cap_initial, 1 << (max(int(s), 1) - 1).bit_length())
                for s in scores]
        cap = max(caps)
        bucket = sorted((i for i, c in enumerate(caps) if c == cap),
                        key=lambda i: len(prs[i][0]) + len(prs[i][1]))
        return eng._batch([prs[i] for i in bucket[: eng._history_batch_size(cap)]], True), cap

    (qs, ts, ql, tl), cap = widest_batch(pairs, [g[0] for g in got])
    K = 2 * cap + 1
    timing, (sk, dk, hk) = wf_batch_versus(dev, pen, (qs, ts, ql, tl), cap, 3)
    (sp, dp, hp), fwd_plain_ms = timed_once(
        lambda: WB.wavefront_forward_ref(qs, ts, ql, tl, pen, cap, K, True))
    f_err = max(wf_batch_err(sk, sp), wf_batch_err(dk, dp), wf_batch_hist_err(hk, hp, sp, dp))
    del hp
    run_cap = 2 * cap + 16
    B = qs.shape[0]
    stats = torch.zeros((2, B), dtype=torch.int32, device=dev)
    out_k = WB.wavefront_traceback(hk, sk, ql, tl, pen, run_cap, stats=stats)
    warp = lambda: WB.wavefront_traceback(hk, sk, ql, tl, pen, run_cap)
    thread = lambda: WB.wavefront_traceback(hk, sk, ql, tl, pen, run_cap, design="thread")
    out_t = thread()
    t0_ms, w0_ms, w1_ms, t1_ms = (time_queued_ms(f, 20) for f in (thread, warp, warp, thread))
    out_p, tb_plain_ms = timed_once(
        lambda: WB.wavefront_traceback_ref(hk, sp, ql, tl, pen, run_cap))
    emu = WB.wavefront_traceback_rounds(hk, sp, ql, tl, pen, run_cap)
    t_err = max([wf_batch_err(a, b) for a, b in zip(out_k, out_p)]
                + [wf_batch_err(a, b) for a, b in zip(out_t, out_p)]
                + [wf_batch_err(stats.cpu(), torch.from_numpy(emu[4]))])
    check(f_err == 0 and t_err == 0, f"the wf_batch kernels differ from their plain versions at "
          f"the headline's history batch: forward {f_err}, traceback {t_err}")
    timing.update({
        "forward_plain_ms": fwd_plain_ms, "forward_err": f_err,
        "traceback_ms": [w0_ms, w1_ms], "traceback_thread_ms": [t0_ms, t1_ms],
        "traceback_plain_ms": tb_plain_ms, "traceback_err": t_err, "run_cap": run_cap,
        "runs": int(out_k[2].sum()), "steps_max": int(emu[4][0].max()),
        "rounds_max": int(emu[4][1].max()), "rounds_sum": int(emu[4][1].sum())})
    print("phase 21 headline batch: " + json.dumps(timing), flush=True)
    del hk, out_k, out_p, out_t

    # 5b: discovery over its 56 oriented pairs against the long path's
    # scores, then align_pairs over them against the long path's CIGARs
    pairs5b = [(pool5b[q], pool5b[t]) for q, t in zip(qi5b.tolist(), ti5b.tolist())]
    for lc in counts:
        lc.reset()
    t0 = time.perf_counter()
    found = eng.discover_scores(pairs5b)
    torch.cuda.synchronize()
    disc_s = time.perf_counter() - t0
    disc_rounds = sorted([B, K, n] for (B, K, _, _, _), n in WB.forward_launches.shapes.items())
    check(found.tolist() == [int(r[0]) for r in wf_out],
          "the batch engine's 5b scores differ from the long path's")
    for lc in counts:
        lc.reset()
    t0 = time.perf_counter()
    got5 = eng.align_pairs(pairs5b)
    torch.cuda.synchronize()
    align5_s = time.perf_counter() - t0
    check(all(a is not None and a[0] == b[0] and np.array_equal(a[1], b[1])
              for a, b in zip(got5, wf_out)),
          "the batch engine's 5b alignments differ from the long path's")
    p5 = {"pairs": len(pairs5b), "discovery_s": disc_s, "discovery_B_K_launches": disc_rounds,
          "scores": sorted(int(s) for s in found), "aligned": len(got5), "align_s": align5_s,
          "history_B_K_launches": sorted([B, K, n] for (B, K, _, _, h), n
                                         in WB.forward_launches.shapes.items() if h)}
    print("phase 21 5b: " + json.dumps(p5), flush=True)
    # 5b's widest history batch: the forward beside the global design (the
    # plain version is too slow at this shape)
    batch5, cap5 = widest_batch(pairs5b, found)
    widest5, _ = wf_batch_versus(dev, pen, batch5, cap5, 2)
    print("phase 21 5b widest batch: " + json.dumps(widest5), flush=True)
    return {"kernels": cases, "headline": head, "timing": timing, "5b": p5, "5b_widest": widest5}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("FAIL: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False: this smoke test needs a GPU",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "allwave_tpu_torch")):
        print("FAIL: allwave_tpu_torch/ is not beside chip_smoke.py", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import numpy as np

    os.environ["ALLWAVE_PLATFORM"] = "cuda"
    os.makedirs(OUT_DIR, exist_ok=True)
    dev = torch.device("cuda", 0)
    report = {}
    phase_s = {}
    t_start = time.perf_counter()
    t_last = [t_start]

    def stamp(phase) -> None:
        now = time.perf_counter()
        phase_s[str(phase)] = now - t_last[0]
        t_last[0] = now
        print(f"phase {phase} seconds: {phase_s[str(phase)]:.1f}", flush=True)

    # -- phase 1: environment and kernel build ---------------------------
    from allwave_tpu_torch.wfa import cuda_build
    from allwave_tpu_torch.wfa import dense as D

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    nvcc = subprocess.run(
        [cuda_build._nvcc(), "--version"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[-1]
    t0 = time.perf_counter()
    cuda_build.build_all()
    for name in cuda_build.SIGNATURES:
        cuda_build.library(name)
    build_s = time.perf_counter() - t0
    print(f"phase 1 env: torch {torch.__version__} cuda {torch.version.cuda} | "
          f"{nvcc} | {smi} | kernels built in {build_s:.1f} s "
          f"(nvcc: {cuda_build.build_seconds})", flush=True)
    # registers and spills of every forward kernel (ptxas -v); the
    # register-band kernels of tiers 1-2 must not spill
    usage = cuda_build.ptxas_usage("dense_forward")
    for fn, u in sorted(usage.items()):
        print("phase 1 ptxas: " + json.dumps({"kernel": _short(fn), **u}), flush=True)
    regs = {fn: u for fn, u in usage.items() if "dense_forward_regs_kernel" in fn}
    check(regs and all(u.get("spill_stores", 1) == 0 and u.get("spill_loads", 1) == 0
                       for u in regs.values()),
          f"a register-band forward kernel spills: {regs}")
    report["forward_ptxas"] = {_short(fn): u for fn, u in usage.items()}
    # the traceback: a warp a pair, its walker state and open run in
    # registers; none may spill
    tb_usage = cuda_build.ptxas_usage("dense_traceback")
    for fn, u in sorted(tb_usage.items()):
        print("phase 1 ptxas: " + json.dumps({"kernel": _short(fn), **u}), flush=True)
    check(tb_usage and all(u.get("spill_stores", 1) == 0 for u in tb_usage.values()),
          f"the traceback kernel spills: {tb_usage}")
    report["traceback_ptxas"] = {_short(fn): u for fn, u in tb_usage.items()}
    span_usage = cuda_build.ptxas_usage("dense_span")
    for fn, u in sorted(span_usage.items()):
        print("phase 1 ptxas: " + json.dumps({"kernel": _short(fn), **u}), flush=True)
    report["span_ptxas"] = {_short(fn): u for fn, u in span_usage.items()}
    # the replay keeps its band lanes in registers: none may spill
    replay_regs = {fn: u for fn, u in span_usage.items() if "dense_replay_cluster_kernel" in fn}
    check(len(replay_regs) == 4 and all(u.get("spill_stores", 1) == 0 and u.get("spill_loads", 1) == 0
                                        for u in replay_regs.values()),
          f"a register-band replay kernel spills: {replay_regs}")
    # the cluster sweep's and replay's loops (cuobjdump -sass): the
    # sweep's bands and tables in shared memory move by LDS/STS, the
    # replay's lanes by shuffles (SHFL), its halo and tables by LDS/STS;
    # generic loads only fetch the neighbour blocks' edge lanes (three
    # each side)
    from allwave_tpu_torch.probes import sass as SA

    span_loops = SA.report(["dense_span"])
    loops = {kind: [r for r in span_loops if name in r["function"]] for kind, name in
             (("sweep", "dense_sweep_cluster_kernel"), ("replay", "dense_replay_cluster_kernel"))}
    for kind, rows in loops.items():
        for r in rows:
            print(f"phase 1 {kind} loop: " + json.dumps(r), flush=True)
        generic = max((sum(n for op, n in r["ops"].items() if op == "LD" or op.startswith("LD."))
                       for r in rows), default=0)
        check(any("LDS" in r["ops"] and "STS" in r["ops"] for r in rows) and generic <= 6,
              f"the cluster {kind}'s loops do not keep their bands or halo in shared memory "
              f"({generic} generic loads in a loop)")
    check(any(any(op.startswith("SHFL") for op in r["ops"]) for r in loops["replay"]),
          "the cluster replay's loops move no lane by shuffle")
    # the wavefront span's four instantiations (sweep and history, one-
    # and two-piece): registers and spills, none may spill; their loops
    # keep the rings in shared memory (LDS/STS), extend by warp votes
    # (VOTE) and divide nowhere (no MUFU.RCP, the reciprocal a division
    # by a runtime divisor compiles to)
    wf_usage = {fn: u for fn, u in cuda_build.ptxas_usage("wf_span").items()
                if "wf_span_cluster_kernel" in fn}
    for fn, u in sorted(wf_usage.items()):
        print("phase 1 ptxas: " + json.dumps({"kernel": _short(fn), **u}), flush=True)
    report["wf_span_ptxas"] = {_short(fn): u for fn, u in wf_usage.items()}
    check(len(wf_usage) == 4 and all(u.get("spill_stores", 1) == 0 and u.get("spill_loads", 1) == 0
                                     for u in wf_usage.values()),
          f"a wavefront span kernel spills: {wf_usage}")
    wf_loops = [r for r in SA.report(["wf_span"]) if "wf_span_cluster_kernel" in r["function"]]
    for r in wf_loops:
        print("phase 1 wf span loop: " + json.dumps(r), flush=True)
    check(len({r["function"] for r in wf_loops}) == 4
          and not any(op.startswith("MUFU.RCP") for r in wf_loops for op in r["ops"])
          and any("LDS" in r["ops"] and "STS" in r["ops"] for r in wf_loops)
          and any(op.startswith("VOTE") for r in wf_loops for op in r["ops"]),
          "the wavefront span's loops divide, or keep their rings out of shared memory, "
          "or extend without warp votes")
    # the dense traceback's loops: the walk's hop loop is its longest
    for r in SA.report(["dense_traceback"]):
        print("phase 1 dense_traceback loop: " + json.dumps(r), flush=True)
    hop_chains = {}
    # the two walks: registers and spills (the production kernels spill
    # nothing), and their loops (the walker's hops read tiles from shared
    # memory: LDS; the producers copy them with cp.async: LDGSTS) divide
    # nowhere. The wavefront walk's production kernel is its FLIP = false
    # instantiation; FLIP = true (the test-only tie-break mutation) is
    # printed beside it
    production = {"segment_traceback": "segment_traceback_kernel",
                  "wf_traceback": "wf_traceback_kernel<false>"}
    for name in ("segment_traceback", "wf_traceback"):
        kname = production[name].split("<")[0]
        usage = cuda_build.ptxas_usage(name)
        for fn, u in sorted(usage.items()):
            print("phase 1 ptxas: " + json.dumps({"kernel": _short(fn), **u}), flush=True)
        # ptxas names demangled (`<(bool)0>`) or, without cu++filt, mangled
        prod = [u for fn, u in usage.items() if production[name] in (
            SA.kernel_name(fn, kname), _short(fn).replace("(bool)0", "false"))]
        check(len(prod) == 1 and prod[0].get("spill_stores", 1) == 0
              and prod[0].get("spill_loads", 1) == 0,
              f"the {name} kernel spills, or ptxas reports no {production[name]}: {usage}")
        walk_loops = [r for r in SA.report([name])
                      if SA.kernel_name(r["function"], kname) == production[name]]
        for r in walk_loops:
            print(f"phase 1 {name} loop: " + json.dumps(r), flush=True)
        check(walk_loops and not any(op.startswith("MUFU.RCP") for r in walk_loops for op in r["ops"])
              and any("LDS" in r["ops"] for r in walk_loops)
              and any(op.startswith("LDGSTS") for r in walk_loops for op in r["ops"]),
              f"the {name} loops divide, or read no tile from shared memory, or copy none "
              "with cp.async")
        # the walker's least dependent chain a hop, read off this build's
        # machine code: phase 16's chain bound
        funcs, labels = SA.parse(SA.listing(name))
        kernel = [f for f in funcs if SA.kernel_name(f, kname) == production[name]]
        chain = SA.hop_chain(funcs[kernel[0]], labels[kernel[0]]) if len(kernel) == 1 else None
        check(chain is not None, f"no hop of the {name} walker has a dependent chain through a "
              "shared-memory load in its machine code")
        print(f"phase 1 {name} hop chain: " + json.dumps(chain), flush=True)
        hop_chains[name] = chain
    report["walk_hop_chains"] = hop_chains
    # the step probes (csrc/probe_step.cu): every instantiation's
    # registers and spills (none may spill), its step loop (its longest),
    # and its dependent chain a step read off this build's machine code
    # (`probes.sass.step_chain`: the neighbour exchange, the dependent
    # ALU and DPX instructions, the barrier), phase 16's chain bound;
    # none may lack one
    from allwave_tpu_torch.probes import runner as PR

    step_usage = cuda_build.ptxas_usage("probe_step")
    for fn, u in sorted(step_usage.items()):
        print("phase 1 ptxas: " + json.dumps({"kernel": _short(fn), **u}), flush=True)
    check(len(step_usage) == 36 and all(u.get("spill_stores", 1) == 0 and u.get("spill_loads", 1) == 0
                                        for u in step_usage.values()),
          f"a step probe kernel spills, or the build lacks one of its 36: {step_usage}")
    step_loops = {}
    for r in SA.report(["probe_step"]):
        if r["instructions"] > step_loops.get(r["function"], {"instructions": 0})["instructions"]:
            step_loops[r["function"]] = r
    for r in step_loops.values():
        print("phase 1 probe_step loop: " + json.dumps(r), flush=True)
    step_chains = PR.step_kernel_chains()
    for name, chain in sorted(step_chains.items()):
        print("phase 1 probe_step chain: " + json.dumps({"kernel": name, "chain": chain}), flush=True)
    check(len(step_chains) == 36 and all(c is not None for c in step_chains.values()),
          "a step probe kernel has no step chain in its machine code: "
          f"{sorted(k for k, c in step_chains.items() if c is None)}")
    report["step_chains"] = step_chains
    # the forward and op-chain probes (csrc/probe_forward.cu, 12
    # instantiations; csrc/probe_ops.cu, 17): registers and spills (none
    # may spill) and their loops (x1's divide nowhere: no MUFU.RCP, the
    # reciprocal a division by a runtime divisor compiles to)
    for name, n_inst in (("probe_forward", 12), ("probe_ops", 17)):
        usage = cuda_build.ptxas_usage(name)
        for fn, u in sorted(usage.items()):
            print("phase 1 ptxas: " + json.dumps({"kernel": _short(fn), **u}), flush=True)
        check(len(usage) == n_inst and all(u.get("spill_stores", 1) == 0
                                           and u.get("spill_loads", 1) == 0
                                           for u in usage.values()),
              f"a {name} kernel spills, or the build lacks one of its {n_inst}: {usage}")
        report[f"{name}_ptxas"] = {_short(fn): u for fn, u in usage.items()}
        probe_loops = [r for r in SA.report([name]) if r["instructions"] > 3]
        for r in probe_loops:
            print(f"phase 1 {name} loop: " + json.dumps(r), flush=True)
        check(len({r["function"] for r in probe_loops}) == n_inst,
              f"a {name} kernel has no loop in its machine code")
        if name == "probe_forward":
            check(not any(op.startswith("MUFU.RCP") for r in probe_loops for op in r["ops"]),
                  "a loop of the forward probe (x1) divides")
    stamp(1)

    # -- phase 2: forward kernel against its plain version ---------------
    fwd = []
    for sc in (SCORES, "0,5,8,2", "0,1,1,1"):
        fwd.append(forward_case(dev, sc, B=256, L=1024, K=128, seed=1, div=0.02, reps=5))
    fwd.append(forward_case(dev, SCORES, B=8, L=4096, K=3072, seed=2, div=0.02, reps=2))
    # tier 3, the replay cluster from the origin: the kernel line's shape
    fwd.append(forward_case(dev, SCORES, B=4, L=2048, K=6144, seed=3, div=0.05, reps=2))
    # every rung of the three tiers, bands off the ladder (201 stores its
    # plane a lane at a time; 4500 and the odd 4501 are tier 3's
    # narrowest clusters), one- and two-piece penalties, both ways of
    # reading the bases, on edge pairs (|k_end| = K - 1 where l_pad
    # allows: every band to 1024, and tier 3 at 4500) in batches
    # of 7 (not a multiple of the 4 pairs a tier-1 block runs); and the
    # widest rung at B = 64, more clusters of 16 blocks than the card
    # holds at once, so it spreads over the portable 8
    from allwave_tpu_torch.wfa import segmented as TS
    from allwave_tpu_torch.wfa.dense_engine import DenseBandAligner

    tier_cases = [(SCORES, K, None, 7) for K in DenseBandAligner.K_LADDER]
    tier_cases += [("0,5,8,2", K, None, 7) for K in (100, 192, 201, 1000, 3072, 4500, 4501)]
    tier_cases += [("0,1,1,1", 192, None, 7), (SCORES, 192, False, 7), (SCORES, 384, False, 7),
                   ("0,5,8,2", 256, False, 7), (SCORES, 16384, None, 64)]
    tiers = []
    for i, (sc, K, stage, B2) in enumerate(tier_cases):
        l_pad = 256 if K <= 256 else (K if K <= 1024 else 512)
        if K == 4500:
            l_pad = 4608  # room for |k_end| = K - 1
        if B2 > 7:
            l_pad = 128
        tiers.append(forward_tier_case(dev, sc, B=B2, K=K, l_pad=l_pad, seed=20 + i,
                                       stage_bases=stage))
    check({r["tier"] for r in tiers} == {1, 2, 3}, "phase 2 did not run all three tiers")
    tier3 = [r for r in tiers if r["tier"] == 3]
    check({r["K"] for r in tier3} >= {4500, 6144, 8192, 12288, 16384}
          and all(r["band_edge_pairs"] > 0 for r in tier3 if r["K"] == 4500),
          "phase 2 did not run every tier-3 rung, or no band-edge pair at 4500")
    # every cluster size the span's dispatch chooses for these shapes ran,
    # above the portable 8 and at it
    sizes2 = {r["blocks_per_pair"] for r in tier3}
    chosen2 = {TS.span_design(r["K"], r["K"], True, r["B"], r["two_piece"]).blocks_per_pair
               for r in tier3}
    check(sizes2 == chosen2 and 8 in sizes2 and max(sizes2) > 8,
          f"phase 2 did not run every cluster size of tier 3: ran {sorted(sizes2)}, "
          f"chosen {sorted(chosen2)}")
    fwd += tiers
    for r in fwd:
        print("phase 2 forward: " + json.dumps(r), flush=True)
    report["forward"] = fwd
    stamp(2)

    # -- phase 3: traceback kernel against its plain version -------------
    tb = traceback_case(dev, B=256, L=1024, K=128, seed=4, div=0.02,
                        run_caps=(128, 4), reps=10)
    check(tb[1]["overflowed"] > 0, "run_cap=4 case did not overflow")
    for r in tb:
        print("phase 3 traceback: " + json.dumps(r), flush=True)
    report["traceback"] = tb
    stamp(3)

    # -- phase 4: the main path on bench.py's headline data ---------------
    from allwave_tpu_torch import cli
    from allwave_tpu_torch.core.scores import parse_scores
    from allwave_tpu_torch.testing.synth import MutationConfig, make_test_case
    from allwave_tpu_torch.wfa.params import resolve_penalties

    pen = resolve_penalties(parse_scores(SCORES))
    tc = make_test_case(1234, 128, 1000, MutationConfig(0.02, 0.0005, 0.0005))
    seqs = tc.sequences
    fasta = os.path.join(OUT_DIR, "headline.fa")
    paf = os.path.join(OUT_DIR, "headline.paf")
    tc.write_fasta(fasta)
    D.forward_launches.reset()
    D.traceback_launches.reset()
    t0 = time.perf_counter()
    rc = cli.main(["-i", fasta, "-p", "none", "-o", paf, "--no-progress"])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = {
        "dense_forward": D.forward_launches.count,
        "dense_traceback": D.traceback_launches.count,
    }
    check(rc == 0, f"cli exit code {rc}")
    check(launches["dense_forward"] > 0 and launches["dense_traceback"] > 0,
          f"main path did not launch both kernels: {launches}")
    recs = _paf_records(paf)
    check(len(recs) == 128 * 127, f"{len(recs)} PAF records, expected 16256")
    empty = validate_paf(recs, seqs)
    check(empty == 0, f"{empty} failed pairs in the CLI output")
    res, warm_s = run_pipeline(seqs, SCORES)
    check(len(res) == 128 * 127, f"{len(res)} results from the pipeline")
    failed = check_alignments(seqs, res, pen, n_sample=16, seed=5)
    check(failed == 0, f"{failed} failed pairs in the pipeline")
    designs4 = dict(D.forward_launches.designs)
    check(any(s[1] == 192 for s in designs4)
          and all(g.tier == 1 for s, g in designs4.items() if s[1] == 192),
          f"the headline's K = 192 shapes did not all run tier 1: {designs4}")
    p4 = {
        "pairs": len(res), "failed": failed, "cli_s": cli_s, "warm_s": warm_s,
        "warm_alignments_per_s": len(res) / warm_s, "launches": launches,
        "forward_shapes": sorted(D.forward_launches.shapes),
        "forward_designs": [[*s, g.tier, g.lanes_per_thread, g.warps_per_pair, g.stage_bases]
                            for s, g in sorted(designs4.items())],
        "traceback_shapes": sorted(D.traceback_launches.shapes),
    }
    main_shapes = [(1000, D.forward_launches.shapes.copy(), D.traceback_launches.shapes.copy())]
    print("phase 4 main path: " + json.dumps(p4), flush=True)
    report["main_path"] = p4
    prof = profile_pipeline(seqs, SCORES)
    print("phase 4 profile: " + (json.dumps(prof) if prof else
          "device time not measured (the profiler saw no kernels)"), flush=True)
    report["main_path_profile"] = prof
    stamp(4)

    # -- phase 5: escalation, 8 x 12 kb ----------------------------------
    D.forward_launches.reset()
    D.traceback_launches.reset()
    tc12 = make_test_case(77, 8, 12000, MutationConfig(0.02, 0.0005, 0.0005))
    res12, s12 = run_pipeline(tc12.sequences, SCORES)
    check(len(res12) == 56, f"{len(res12)} results, expected 56")
    failed12 = check_alignments(tc12.sequences, res12, pen, n_sample=2, seed=6)
    check(failed12 == 0, f"{failed12} failed pairs at 12 kb")
    widest = D.forward_launches.widest_k
    check(widest > 2048, f"widest band {widest} <= 2048: no escalation regime")
    designs5 = dict(D.forward_launches.designs)
    check(any(s[1] == 3072 for s in designs5)
          and all(g.tier == 2 for s, g in designs5.items() if s[1] == 3072),
          f"the 12 kb K = 3072 shapes did not all run tier 2: {designs5}")
    p5 = {
        "pairs": len(res12), "failed": failed12, "seconds": s12, "widest_k": widest,
        "forward_shapes": sorted(D.forward_launches.shapes),
        "forward_designs": [[*s, g.tier, g.lanes_per_thread, g.warps_per_pair, g.stage_bases]
                            for s, g in sorted(designs5.items())],
        "traceback_shapes": sorted(D.traceback_launches.shapes),
    }
    main_shapes.append((12000, D.forward_launches.shapes.copy(),
                        D.traceback_launches.shapes.copy()))
    print("phase 5 escalation: " + json.dumps(p5), flush=True)
    stamp(5)

    # -- phase 6: both kernels against their plain versions at every
    # (K, l_pad, run_cap) that phases 4 and 5 launched, at the largest
    # batch each was launched with, on random pairs of the phase's length
    at_shape = []
    for L, fwd_shapes, tb_shapes in main_shapes:
        widest_b = {}
        for B, K, l_pad, cap in tb_shapes:
            widest_b[(K, l_pad, cap)] = max(B, widest_b.get((K, l_pad, cap), 0))
        uncovered = {s[1:] for s in fwd_shapes} - {k[:2] for k in widest_b}
        check(not uncovered, f"forward shapes with no traceback launch: {uncovered}")
        for (K, l_pad, cap), B in sorted(widest_b.items(), key=lambda kv: -kv[1]):
            r = forward_case(dev, SCORES, B=B, L=L, K=K, seed=10 + len(at_shape),
                             div=0.02, reps=2 if l_pad > 4096 else 5,
                             l_pad=l_pad, run_cap=cap)
            print("phase 6 main-path shape: " + json.dumps(r), flush=True)
            at_shape.append(r)
    report["main_path_shapes"] = at_shape
    # the kernel line's times: the headline's widest batch
    head = at_shape[0]
    stamp(6)

    # -- phase 7: span kernel against its plain version at K = 3072 and
    # 6144, at full band and on the narrow replay's sub-band, with planes
    # and without
    from allwave_tpu_torch.wfa import segmented as TS

    C = TS.SegmentedConfig().ckpt_every
    k_sub_c = -(-(2 * C + 320) // 128) * 128
    span7, tb8 = [], []
    for K in (3072, 6144):
        for k_sub in (None, k_sub_c):
            sp, tbr = span_case(dev, B=8, L=14000, l_pad=16384, K=K, k_sub=k_sub, C=C,
                                seg=3, seed=K + (k_sub or 0), div=0.02, reps=3,
                                run_caps=(4096, 4))
            span7 += sp
            tb8 += tbr
    for r in span7:
        print("phase 7 span: " + json.dumps(r), flush=True)
    # the sweep at every cluster size its design takes on the engine's
    # ladder (384: 1 block a pair ... 24576: 16 where the card holds the
    # batch's clusters at once, else 8), an odd band, an odd window at
    # odd offsets, and the edge pairs on an odd cluster
    sweep7 = []
    for i, (sc, K, k_sub, edge, B) in enumerate((
            (SCORES, 384, None, False, 8), (SCORES, 1536, None, False, 8),
            (SCORES, 3072, None, False, 8), ("0,5,8,2", 4096, None, False, 8),
            (SCORES, 6144, None, False, 8), (SCORES, 12288, None, False, 8),
            (SCORES, 24576, None, False, 6), (SCORES, 24576, None, False, 8),
            ("0,1,1,1", 3071, None, False, 8), (SCORES, 6144, 4481, False, 8),
            (SCORES, 1025, None, True, 8), ("0,5,8,2", 8191, None, True, 8))):
        r = cluster_case(dev, sc, B=B, K=K, k_sub=k_sub, l_pad=8192, C=C, seg=2, seed=70 + i,
                         edge=edge, reps=3, planes=False)
        print("phase 7 sweep: " + json.dumps(r), flush=True)
        sweep7.append(r)
    sizes7 = {r["G"] for r in sweep7}
    check(sizes7 >= {1, 2, 3, 4, 5, 6, 8} and max(sizes7) > 8,
          f"phase 7 did not run every cluster size of the sweep: {sorted(sizes7)}")
    # the replay at every cluster size its design takes on the engine's
    # shapes (full bands 384 .. 4096: 1-8 blocks of 4 warps; the narrow
    # window k_sub of a wider band: 9 where the card holds the batch's
    # clusters at once, else 7), the widest band (16 blocks of 4 lanes a
    # thread, or 8 of 8 where the card does not hold 8 such clusters),
    # an odd band, an odd window at odd offsets, and the edge pairs
    replay7 = []
    for i, (sc, K, k_sub, edge, B) in enumerate((
            (SCORES, 384, None, False, 6), (SCORES, 1024, None, False, 6),
            (SCORES, 1536, None, False, 6), (SCORES, 2048, None, False, 6),
            (SCORES, 3072, None, False, 6), ("0,5,8,2", 4096, None, False, 6),
            (SCORES, 24576, k_sub_c, False, 6), (SCORES, 24576, k_sub_c, False, 16),
            (SCORES, 24576, None, False, 6), (SCORES, 24576, None, False, 8),
            ("0,1,1,1", 3071, None, False, 6), (SCORES, 6144, k_sub_c + 1, False, 6),
            (SCORES, 1025, None, True, 7), ("0,5,8,2", 8191, None, True, 7))):
        r = cluster_case(dev, sc, B=B, K=K, k_sub=k_sub, l_pad=8192, C=C, seg=2, seed=90 + i,
                         edge=edge, reps=3, planes=True)
        print("phase 7 replay: " + json.dumps(r), flush=True)
        replay7.append(r)
    sizes7 = {r["G"] for r in replay7}
    check(sizes7 >= {1, 2, 3, 4, 6, 8} and max(sizes7) > 8,
          f"phase 7 did not run every cluster size of the replay: {sorted(sizes7)}")
    # -- phase 8: the segment-traceback kernel on those segments' planes
    check(any(r["overflowed"] > 0 for r in tb8 if r["run_cap"] == 4),
          "run_cap=4 walks did not overflow")
    for r in tb8:
        print("phase 8 segment traceback: " + json.dumps(r), flush=True)
    report["span"], report["segment_traceback"] = span7 + sweep7 + replay7, tb8
    stamp("7-8")  # one helper runs both phases' cases

    # -- phase 9: the long-pair path, bench.py config 5_100kb -------------
    tc100 = make_test_case(17, 4, 100_000, MutationConfig(0.02, 0.0005, 0.0005))
    seqs100 = tc100.sequences
    fasta100 = os.path.join(OUT_DIR, "5_100kb.fa")
    paf100 = os.path.join(OUT_DIR, "5_100kb.paf")
    tc100.write_fasta(fasta100)
    from allwave_tpu_torch.wfa import wf_segmented as TW

    counts = (D.forward_launches, D.traceback_launches, TS.span_launches,
              TS.segment_traceback_launches, TW.wf_span_launches, TW.wf_traceback_launches)
    for lc in counts:
        lc.reset()
    TW.wf_stats.reset()
    TS.seg_stats.reset()
    check("ALLWAVE_WFSEG" not in os.environ, "ALLWAVE_WFSEG is set: the router would be forced")
    t0 = time.perf_counter()
    rc = cli.main(["-i", fasta100, "-p", "none", "-o", paf100, "--no-progress"])
    torch.cuda.synchronize()
    cli100_s = time.perf_counter() - t0
    span_shapes = dict(TS.span_launches.shapes)
    span_designs = dict(TS.span_launches.designs)
    launches_long = {
        "dense_span_sweep": sum(n for sh, n in span_shapes.items() if not sh[5]),
        "dense_span_replay": sum(n for sh, n in span_shapes.items() if sh[5]),
        "segment_traceback": TS.segment_traceback_launches.count,
    }
    tb_shapes = dict(TS.segment_traceback_launches.shapes)
    widest100 = TS.span_launches.widest_k
    check(rc == 0, f"cli exit code {rc} on 5_100kb")
    check(all(v > 0 for v in launches_long.values()),
          f"the long path did not launch both kernels: {launches_long}")
    check(all(g.replay == sh[5] for sh, g in span_designs.items()),
          f"a span did not take its cluster design: {span_designs}")
    span_clusters = {
        f"K={sh[1]} k_sub={sh[2]} planes={sh[5]} G={g.blocks_per_pair} Lb={g.lanes_per_block}":
            TS.span_max_clusters(sh[1], sh[2], sh[5], sh[0], pen.two_piece)
        for sh, g in sorted(span_designs.items())
    }
    # the run buffers hold every run the certified scores allow: no pair
    # is re-queued at the full run cap, so each certified pair is swept
    # and replayed once at its band, and every replay has its walk
    overflow_reruns = TS.seg_stats.overflow_reruns
    check(overflow_reruns == 0, f"{overflow_reruns} pairs re-queued at the full run cap")
    check(launches_long["dense_span_replay"] == launches_long["segment_traceback"]
          == REPLAYS_5_100KB, f"not one replay and walk a segment of each group: {launches_long}")
    # every 5_100kb hint needs a band above the wavefront k_max: all 12
    # pairs go through the router to the wavefront engine and fall back
    fallbacks100 = TW.wf_stats.fallbacks
    check(fallbacks100 == 12, f"{fallbacks100} of 12 pairs fell back from the wavefront engine")
    recs = _paf_records(paf100)
    check(len(recs) == 12, f"{len(recs)} PAF records on 5_100kb, expected 12")
    empty = validate_paf(recs, seqs100)
    check(empty == 0, f"{empty} failed pairs in the 5_100kb CLI output")
    res100, warm100_s = run_pipeline(seqs100, SCORES)
    check(len(res100) == 12, f"{len(res100)} results from the pipeline on 5_100kb")
    failed100 = check_alignments(seqs100, res100, pen, n_sample=0, seed=7)
    check(failed100 == 0, f"{failed100} failed pairs on 5_100kb")
    scores100 = sorted(r.score for r in res100)
    check(scores100 == SCORES_5_100KB, f"5_100kb scores {scores100}, expected {SCORES_5_100KB}")
    p9 = {
        "pairs": len(res100), "failed": failed100, "cli_s": cli100_s, "warm_s": warm100_s,
        "warm_alignments_per_s": len(res100) / warm100_s, "widest_k": widest100,
        "launches": launches_long, "dense_forward_launches": D.forward_launches.count,
        "wavefront_fallbacks": fallbacks100,
        "span_shapes": sorted(span_shapes.items()), "segment_traceback_shapes": sorted(tb_shapes.items()),
        "span_designs": [[*sh, g.replay, g.blocks_per_pair, g.lanes_per_block,
                          g.lanes_per_thread] for sh, g in sorted(span_designs.items())],
        "span_max_clusters": span_clusters, "overflow_reruns": overflow_reruns,
        "scores": scores100,
    }
    print("phase 9 long path: " + json.dumps(p9), flush=True)
    report["long_path"] = p9
    TS.span_launches.reset()
    prof100 = profile_pipeline(seqs100, SCORES)
    if prof100:
        # DP cells the span kernel computed in the profiled run, by mode:
        # the sweep's and the replay's cluster kernels
        by_k = prof100["device_ms_by_kernel"]
        check(any(k.startswith("dense_replay_cluster_kernel<") for k in by_k),
              "the cluster replay did not run in the profiled run")
        for mode, planes, tag in (("sweep", False, "dense_sweep_cluster_kernel<"),
                                  ("replay", True, "dense_replay_cluster_kernel<")):
            cells = sum(n * sh[0] * sh[2] * sh[4] for sh, n in TS.span_launches.shapes.items()
                        if sh[5] == planes)
            ms = sum(v for k, v in by_k.items() if k.startswith(tag))
            prof100[f"{mode}_cells"] = cells
            prof100[f"{mode}_device_ms"] = ms
            prof100[f"{mode}_gcells_s"] = cells / (ms * 1e6) if ms else None
        prof100["walk_device_ms"] = sum(v for k, v in by_k.items()
                                        if k.startswith("segment_traceback_kernel"))
    print("phase 9 profile: " + (json.dumps(prof100) if prof100 else
          "device time not measured (the profiler saw no kernels)"), flush=True)
    report["long_path_profile"] = prof100
    stamp(9)

    # -- phase 10: exactness at length: the one-shot dense engine and the
    # segmented engine on 4 x 24 kb at 2% (12 directed pairs)
    from allwave_tpu_torch.wfa.dense_engine import UnifiedAligner

    tc24 = make_test_case(24, 4, 24_000, MutationConfig(0.02, 0.0005, 0.0005))
    pairs24 = [(a.seq, b.seq) for a in tc24.sequences for b in tc24.sequences if a is not b]
    for lc in counts:
        lc.reset()
    t0 = time.perf_counter()
    one = UnifiedAligner(pen, dense_max_len=32768, device=dev).align_pairs(pairs24, with_stats=True)
    one_s = time.perf_counter() - t0
    one_k, one_spans = D.forward_launches.widest_k, TS.span_launches.count
    # the one-shot forward's designs: its rungs past 4096 run tier 3
    designs10 = dict(D.forward_launches.designs)
    tier3_10 = {s: g for s, g in designs10.items() if g.tier == 3}
    launches_t3 = sum(D.forward_launches.shapes[s] for s in tier3_10)
    check(launches_t3 > 0, f"the one-shot 24 kb run launched no tier-3 forward: {designs10}")
    t0 = time.perf_counter()
    segd = UnifiedAligner(pen, device=dev).align_pairs(pairs24, with_stats=True)
    seg_s = time.perf_counter() - t0
    check(one_spans == 0 and TS.span_launches.count > 0
          and TS.segment_traceback_launches.count > 0,
          "phase 10 did not route 24 kb pairs as intended")
    check(all(r is not None for r in one[0] + segd[0]), "phase 10 has failed pairs")
    same = [a[0] == b[0] and np.array_equal(a[1], b[1]) for a, b in zip(one[0], segd[0])]
    check(all(same), f"one-shot and segmented differ on {same.count(False)} of 12 pairs")
    check(np.array_equal(one[1], segd[1]), "one-shot and segmented stats differ")
    # the one-shot run again under the profiler: tier 3's device time (the
    # replay cluster and its epilogue; no segmented span runs here)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof10:
        UnifiedAligner(pen, dense_max_len=32768, device=dev).align_pairs(pairs24, with_stats=True)
        torch.cuda.synchronize()
    spans10 = [(e.time_range.start, e.time_range.end, e.name) for e in prof10.events()
               if str(getattr(e, "device_type", "")).endswith("CUDA")]
    forward10_ms, tier3_ms = forward_device_ms(spans10)
    # tier 3 against the plain forward at each (K, l_pad) it ran here, at
    # the widest batch it ran with, on this phase's own pairs: planes of
    # gigabytes (byte offsets past 2^31), 2 l_pad steps and every
    # restaging of the base tables
    widest10 = {}
    for (B10, K10, lp10) in tier3_10:
        widest10[(K10, lp10)] = max(B10, widest10.get((K10, lp10), 0))
    t3_len = []
    for (K10, lp10), B10 in sorted(widest10.items()):
        qs10 = np.zeros((B10, lp10), np.uint8)
        ts10 = np.zeros((B10, lp10), np.uint8)
        for b, (q, t) in enumerate(pairs24[:B10]):
            qs10[b, :len(q)] = np.frombuffer(q, np.uint8)
            ts10[b, :len(t)] = np.frombuffer(t, np.uint8)
        lens10 = [np.array([len(p[i]) for p in pairs24[:B10]], np.int32) for i in (0, 1)]
        r = forward_case(dev, SCORES, B=B10, L=24_000, K=K10, seed=0, div=0.02, reps=2,
                         l_pad=lp10, batch=(qs10, ts10, *lens10))
        check(r["tier"] == 3, f"phase 10's shape {(B10, K10, lp10)} did not run tier 3")
        print("phase 10 tier-3 shape: " + json.dumps(r), flush=True)
        t3_len.append(r)
    p10 = {
        "pairs": len(pairs24), "identical": sum(same), "one_shot_s": one_s,
        "one_shot_forward_designs": [[*sh, g.tier, g.blocks_per_pair, g.lanes_per_thread,
                                      g.warps_per_pair] for sh, g in sorted(designs10.items())],
        "tier3_launches": launches_t3, "tier3_device_ms": tier3_ms if spans10 else None,
        "one_shot_forward_device_ms": forward10_ms if spans10 else None,
        "one_shot_widest_k": one_k, "segmented_s": seg_s,
        "segmented_widest_k": TS.span_launches.widest_k,
        "scores": [int(r[0]) for r in segd[0]],
        "tier3_at_length": [{k: r[k] for k in ("B", "K", "l_pad", "blocks_per_pair", "max_abs_err",
                                               "ms", "plain_ms")} for r in t3_len],
    }
    print("phase 10 exactness at length: " + json.dumps(p10), flush=True)
    report["exactness_24kb"] = p10
    stamp(10)

    # -- phase 11: both long-path kernels against their plain versions at
    # every (K, k_sub, l_pad, n_steps) phase 9 launched, at the widest
    # batch of each, on random ~100 kb pairs
    widest_b = {}
    for (B, K, W, l_pad, ns, _), _n in span_shapes.items():
        widest_b[(K, W, l_pad, ns)] = max(B, widest_b.get((K, W, l_pad, ns), 0))
    span11, tb11 = [], []
    for (K, W, l_pad, ns), B in sorted(widest_b.items()):
        caps = sorted({sh[4] for sh in tb_shapes if sh[1:4] == (W, l_pad, ns)})
        sp, tbr = span_case(dev, B=B, L=100_000, l_pad=l_pad, K=K,
                            k_sub=W if W < K else None, C=ns, seg=2,
                            seed=100 + len(span11), div=0.02, reps=2, run_caps=caps)
        for r in sp + tbr:
            print("phase 11 long-path shape: " + json.dumps(r), flush=True)
        span11 += sp
        tb11 += tbr
    check(tb11, "no segment traceback shape of phase 9 was held against its plain version")
    report["long_path_shapes"] = span11 + tb11
    stamp(11)
    # the kernel line's times: the long path's widest full-band sweep
    # span and its widest band's replay walk
    path_shapes = {(K, W, planes) for (_, K, W, _, _, planes) in span_shapes}
    on_path = [r for r in span11 if (r["K"], r["k_sub"], r["with_planes"]) in path_shapes]
    sweep = max((r for r in on_path if not r["with_planes"]), key=lambda r: (r["K"], r["k_sub"]))
    replay = max((r for r in on_path if r["with_planes"]), key=lambda r: (r["K"], r["k_sub"]))
    walk = max(tb11, key=lambda r: (r["K"], -r["run_cap"]))

    # -- phase 12: the wavefront span kernel against its plain version at
    # small shapes: the sweep (scores, done, every checkpoint slot) for
    # three penalty sets, then history spans from a kernel-made
    # checkpoint at full band and on the narrow sub-band; then both modes
    # at every cluster size the design takes (G = ceil(W / 256): bands
    # 512 .. 6144, an odd band and an odd sub-band; above 8 blocks where
    # the card holds the batch's clusters at once)
    from allwave_tpu_torch.wfa.segmented import narrow_offsets

    wf12, chains = [], []
    for sc, K, l_pad, C, N, k_sub in (
            (SCORES, 256, 2048, 64, 1024, None), ("0,5,8,2", 256, 2048, 64, 1024, None),
            ("0,1,1,1", 256, 2048, 64, 1024, None), (SCORES, 2048, 4096, 256, 1024, None),
            (SCORES, 512, 768, 64, 256, 256), ("0,5,8,2", 768, 1024, 64, 256, 512),
            (SCORES, 1001, 1280, 64, 256, 512), ("0,1,1,1", 1280, 1536, 64, 256, 512),
            (SCORES, 1536, 2048, 64, 256, 1023), (SCORES, 3072, 4096, 64, 256, 1280),
            ("0,5,8,2", 4096, 4352, 64, 256, 1024), (SCORES, 6144, 6400, 64, 256, 1024)):
        k_sub = k_sub or -(-(2 * C + 320) // 512) * 512
        pen_c, batch, init = wf_inputs(dev, sc, l_pad, K, seed=K + len(sc), div=0.01)
        at = f"{sc} K={K} l_pad={l_pad}"
        r, (ck, done, scores) = wf_sweep_check(pen_c, batch, init, K, l_pad, C, N, 3, at)
        check(bool(done[3]) and int(scores[3]) == 0 and not bool(done[5]),
              f"the identical and infeasible pairs are not as built at {at}")
        wf12.append({"scores": sc, **r})
        seg = 1
        wf12.append({"scores": sc, **wf_hist_check(pen_c, batch, K, l_pad, C, seg, ck[seg],
                                                    None, None, 3, at)[0]})
        if K > k_sub:
            c_lo = narrow_offsets(init.c_end, K, k_sub)
            wf12.append({"scores": sc, **wf_hist_check(pen_c, batch, K, l_pad, C, seg, ck[seg],
                                                        c_lo, k_sub, 3, at)[0]})
        if sc == SCORES and N == 1024:
            chains.append((pen_c, batch, init, ck, done, scores, K, l_pad, C, k_sub))
    for r in wf12:
        print("phase 12 wf span: " + json.dumps(r), flush=True)
    for mode in ("sweep", "history"):
        sizes12 = {r["G"] for r in wf12 if r["mode"] == mode}
        check(sizes12 >= {1, 2, 3, 4, 5, 6, 8} and max(sizes12) > 8,
              f"phase 12 did not run every cluster size of the {mode}: {sorted(sizes12)}")
    stamp(12)

    # -- phase 13: the window-traceback kernel against its plain version
    # on history planes the span kernel made, end to origin, at a run_cap
    # that fits and one that overflows
    tb13 = []
    for pen_c, batch, init, ck, done, scores, K, l_pad, C, k_sub in chains:
        tb13 += wf_walk_chain(dev, pen_c, batch, init, ck, done, scores, K, l_pad, C, k_sub,
                              (4096, 4), reps=5)
    check(all(r["overflowed"] > 0 for r in tb13 if r["run_cap"] == 4)
          and not any(r["overflowed"] for r in tb13 if r["run_cap"] == 4096),
          "run_cap 4 walks did not all overflow, or run_cap 4096 walks did")
    for r in tb13:
        print("phase 13 wf traceback: " + json.dumps(r), flush=True)
    stamp(13)

    # -- phase 14: bench.py config 5b_100kb_lowdiv (8 x 100 kb at MHC-like
    # divergence, 56 directed pairs) through the CLI and the
    # AllPairAligner: the router sends the hinted long pairs to the
    # wavefront engine
    tc5b = make_test_case(18, 8, 100_000, MutationConfig(0.0025, 0.0001, 0.0001))
    seqs5b = tc5b.sequences
    fasta5b = os.path.join(OUT_DIR, "5b_100kb_lowdiv.fa")
    paf5b = os.path.join(OUT_DIR, "5b_100kb_lowdiv.paf")
    tc5b.write_fasta(fasta5b)
    for lc in counts:
        lc.reset()
    TW.wf_stats.reset()
    t0 = time.perf_counter()
    rc = cli.main(["-i", fasta5b, "-p", "none", "-o", paf5b, "--no-progress"])
    torch.cuda.synchronize()
    cli5b_s = time.perf_counter() - t0
    wf_span_shapes = dict(TW.wf_span_launches.shapes)
    launches_wf = {
        "wf_span_sweep": sum(n for sh, n in wf_span_shapes.items() if not sh[5]),
        "wf_span_history": sum(n for sh, n in wf_span_shapes.items() if sh[5]),
        "wf_traceback": TW.wf_traceback_launches.count,
    }
    wf_span_designs = {str(sh): g._asdict() for sh, g in TW.wf_span_launches.designs.items()}
    wf_tb_shapes = dict(TW.wf_traceback_launches.shapes)
    rounds5b = list(TW.wf_stats.rounds)
    fallbacks5b = TW.wf_stats.fallbacks
    check(rc == 0, f"cli exit code {rc} on 5b_100kb_lowdiv")
    check(all(v > 0 for v in launches_wf.values()),
          f"the wavefront path did not launch both kernels: {launches_wf}")
    recs = _paf_records(paf5b)
    check(len(recs) == 56, f"{len(recs)} PAF records on 5b_100kb_lowdiv, expected 56")
    empty = validate_paf(recs, seqs5b)
    check(empty == 0, f"{empty} failed pairs in the 5b_100kb_lowdiv CLI output")
    res5b, warm5b_s = run_pipeline(seqs5b, SCORES)
    check(len(res5b) == 56, f"{len(res5b)} results from the pipeline on 5b_100kb_lowdiv")
    failed5b = check_alignments(seqs5b, res5b, pen, n_sample=0, seed=8)
    check(failed5b == 0, f"{failed5b} failed pairs on 5b_100kb_lowdiv")
    p14 = {
        "pairs": len(res5b), "failed": failed5b, "dense_fallbacks": fallbacks5b,
        "rounds_K_scap_B": rounds5b, "cli_s": cli5b_s, "warm_s": warm5b_s,
        "warm_alignments_per_s": len(res5b) / warm5b_s, "launches": launches_wf,
        "segmented_span_launches": TS.span_launches.count,
        "dense_forward_launches": D.forward_launches.count,
        "wf_span_shapes": sorted(wf_span_shapes.items()), "wf_span_designs": wf_span_designs,
        "wf_traceback_shapes": sorted(wf_tb_shapes.items()),
        "scores": sorted(r.score for r in res5b),
    }
    print("phase 14 wavefront path: " + json.dumps(p14), flush=True)
    report["wavefront_path"] = p14
    TW.wf_stats.reset()
    prof5b = profile_pipeline(seqs5b, SCORES)
    if prof5b:
        by_k = prof5b["device_ms_by_kernel"]
        for mode, hist, work in (("sweep", False, TW.wf_stats.sweep_lane_levels),
                                 ("replay", True, TW.wf_stats.replay_lane_levels)):
            ms = sum(v for k, v in by_k.items() if _wf_span_mode(k) is hist)
            prof5b[f"{mode}_lane_levels"] = work
            prof5b[f"{mode}_device_ms"] = ms
            prof5b[f"{mode}_lane_levels_per_s"] = work / (ms * 1e-3) if ms else None
        prof5b["walk_device_ms"] = sum(v for k, v in by_k.items() if k.startswith("wf_traceback_kernel"))
    print("phase 14 profile: " + (json.dumps(prof5b) if prof5b else
          "device time not measured (the profiler saw no kernels)"), flush=True)
    report["wavefront_path_profile"] = prof5b

    # the same 56 oriented pairs, with the pipeline's hints, through the
    # wavefront route and through the segmented dense engine
    from allwave_tpu_torch.engine.pipeline import AllPairAligner

    apa = AllPairAligner(seqs5b, parse_scores(SCORES), exclude_self=True, use_mash_orientation=True)
    pairs5b = apa.get_pairs()
    pool5b, qi5b, ti5b, _, hints5b = apa._orient_chunk(pairs5b)
    ua5b = UnifiedAligner(pen, device=dev)
    t0 = time.perf_counter()
    wf_out, wf_st = ua5b.align_pairs_indexed(pool5b, qi5b, ti5b, with_stats=True, sigma_hint=hints5b)
    wf_s = time.perf_counter() - t0
    os.environ["ALLWAVE_WFSEG"] = "0"
    try:
        t0 = time.perf_counter()
        seg_out, seg_st = ua5b.align_pairs_indexed(pool5b, qi5b, ti5b, with_stats=True,
                                                   sigma_hint=hints5b)
        seg5b_s = time.perf_counter() - t0
    finally:
        del os.environ["ALLWAVE_WFSEG"]
    check(all(r is not None for r in wf_out + seg_out), "phase 14 engines have failed pairs")
    same = [a[0] == b[0] and np.array_equal(a[1], b[1]) for a, b in zip(wf_out, seg_out)]
    check(all(same), f"wavefront and segmented engines differ on {same.count(False)} of 56 pairs")
    check(np.array_equal(wf_st, seg_st), "wavefront and segmented stats differ")
    pipe = {(r.query_idx, r.target_idx): r.score for r in res5b}
    check([pipe[(int(i), int(j))] for i, j in pairs5b] == [int(r[0]) for r in wf_out],
          "the pipeline's scores differ from the wavefront route's")
    p14b = {"pairs": len(same), "identical": sum(same), "wavefront_s": wf_s,
            "segmented_s": seg5b_s, "hints": [int(h) for h in hints5b]}
    print("phase 14 wavefront vs segmented: " + json.dumps(p14b), flush=True)
    report["wavefront_vs_segmented"] = p14b
    stamp(14)

    # -- phase 15: both wavefront kernels against their plain versions at
    # every band phase 14 launched, at its widest batch, on the 5b pairs:
    # the sweep at its real score cap (kernel, timed), its first two
    # segments kernel against plain (every slot, scores, done; and the
    # full sweep's first two slots), a narrow history span, and two
    # backward segments of the walk at each run_cap phase 14 used
    from allwave_tpu_torch.probes import wf_level_split as WL

    C5 = TW.WfSegConfig().ckpt_every
    k_sub5 = -(-(2 * C5 + 320) // 512) * 512
    widest5 = {}
    for (B, K, W, l_pad, ns, hist), _n in wf_span_shapes.items():
        B0, cap0 = widest5.get((K, l_pad), (0, 0))  # (batch, sweep score cap)
        widest5[(K, l_pad)] = (max(B, B0), cap0 if hist else max(ns, cap0))
    wf15, tb15 = [], []

    def batch5(B, l_pad, make=None):
        return WL.batch(pool5b, qi5b, ti5b, B, l_pad, make, dev)


    for (K, l_pad), (B, s_cap) in sorted(widest5.items()):
        caps = sorted({sh[4] for sh in wf_tb_shapes if sh[1] == K})
        batch = batch5(B, l_pad)
        init = TW.wf_init(*batch, pen, K)
        at = f"5b B={B} K={K} l_pad={l_pad}"
        (ck_f, _, d_f, s_f), full_ms = timed_once(lambda: TW.wf_span(
            *batch, pen, K, l_pad, 0, s_cap, init.seeds, False, ckpt_every=C5,
            done=init.done0, scores=init.scores0))
        r, (ck2, _, _) = wf_sweep_check(pen, batch, init, K, l_pad, C5, 2 * C5, 2, at)
        check(torch.equal(ck_f[:2], ck2), f"the full sweep's first slots differ at {at}")
        wf15.append({**r, "full_n_steps": s_cap, "full_sweep_ms": full_ms,
                     "full_done": int(d_f.sum()), "full_max_score": int(s_f.max())})
        top = (int(s_f[d_f].max()) - 1) // C5
        narrow = K > k_sub5
        c_lo = narrow_offsets(init.c_end, K, k_sub5) if narrow else None
        wf15.append(wf_hist_check(pen, batch, K, l_pad, C5, top, ck_f[top], c_lo,
                                  k_sub5 if narrow else None, 2, at)[0])
        tb15 += wf_walk_chain(dev, pen, batch, init, ck_f, d_f, s_f, K, l_pad, C5, k_sub5,
                              caps, reps=3, n_seg=2)
        del ck_f, ck2
    check(wf15 and tb15, "no wavefront shape of phase 14 was held against its plain version")
    for r in wf15 + tb15:
        print("phase 15 wavefront shape: " + json.dumps(r), flush=True)
    report["wavefront_shapes"] = wf15 + tb15
    # the sweep at 5b's widest round (B, K, l_pad, its score cap) on three
    # inputs of its shape, each held to the plain version: the 5b pairs;
    # tandem repeats ((AC)^n at the 5b lengths, the target with 0.25%
    # SNPs: every other diagonal matches between SNPs, so every lane the
    # wavefront reaches there extends hundreds of bases); and random
    # pairs (every extension stops within its first 8 bases). The rings,
    # the slots and the barrier are the same work in all three, so the
    # differences in time a level are the extension's
    (Kw, lw), (Bw, capw) = max(widest5.items(), key=lambda kv: (kv[1][0] * kv[0][0], kv[0][0]))
    capw = min(capw, 8 * C5)  # the same levels for all three (the plain sweep is slow)
    split15 = []
    for name, make in WL.INPUTS:
        batch = batch5(Bw, lw, make)
        init = TW.wf_init(*batch, pen, Kw)
        r, _ = wf_sweep_check(pen, batch, init, Kw, lw, C5, capw, 3, f"{name} B={Bw} K={Kw}")
        r = {"input": name, **r, "us_per_level": 1e3 * r["ms"] / max(r["levels_run"], 1),
             # clusters of this design the card holds at once
             "clusters_held": TW.wf_span_design(Kw, Kw, False, Bw, pen).clusters_held}
        print("phase 15 level split: " + json.dumps(r), flush=True)
        split15.append(r)
    report["wavefront_level_split"] = split15
    stamp(15)
    # the kernel line's times: the widest round's two-segment sweep, its
    # narrow history span and its walk at the smallest run_cap
    wf_sweep = max((r for r in wf15 if r["mode"] == "sweep"), key=lambda r: (r["B"] * r["K"]))
    wf_hist = max((r for r in wf15 if r["mode"] == "history"), key=lambda r: (r["B"] * r["K"]))
    wf_walk = max(tb15, key=lambda r: (r["B"] * r["K"], -r["run_cap"]))

    # -- phase 16: the probes of allwave_tpu_torch/probes (the six Pallas
    # experiments of scripts/experiments): every probe kernel against its
    # plain version (tolerance 0) at a reduced shape and at the
    # experiment's own shape where the plain version is quick, then the
    # probes' own path, `python -m allwave_tpu_torch.probes`: every
    # variant timed at the experiment's shape (mean of 5 after a warm-up)
    from allwave_tpu_torch.probes import kexp as P1
    from allwave_tpu_torch.probes import kexp2 as P2
    from allwave_tpu_torch.probes import kexp6 as P6

    ops_s = PR.int32_ops_s(dev)
    # the step probes' chain bounds: phase 1's chains at the latencies
    # this card's dependent shuffles, loads, ALU instructions and block
    # barriers take (csrc/probe_latency.cu)
    chains16 = PR.step_chains(dev, step_chains)
    print("phase 16 step latency: " + json.dumps(chains16.latency), flush=True)
    report["step_latency_ns"] = chains16.latency
    checks16 = PR.check_all(dev)
    for r in checks16:
        print("phase 16 probe: " + json.dumps(r), flush=True)
    probe_counts = (P1.forward_launches, P6.step_launches, P2.ops_launches)
    for lc in probe_counts:
        lc.reset()
    # (x2 and x3 on the filled card only: their one-copy latencies are
    # the entry point's)
    times16 = PR.time_all(dev, ops_s=ops_s, latency=False, chains=chains16)
    torch.cuda.synchronize()
    launches_probe = {"probe_forward": P1.forward_launches.count,
                      "probe_step": P6.step_launches.count, "probe_ops": P2.ops_launches.count}
    check(all(v > 0 for v in launches_probe.values()),
          f"the probes did not launch all three kernels: {launches_probe}")
    for r in times16:
        print("phase 16 probe: " + json.dumps(r), flush=True)
    report["probes"] = {"checks": checks16, "times": times16, "launches": launches_probe,
                        "int32_ops_s": ops_s}
    stamp(16)

    # -- phase 17: orientation and MinHash counts on the card -------------
    giant, mixed = bench_sets()
    synth = synthetic_set()
    report["orientation_counts"] = phase17(dev, seqs, giant, mixed, synth)
    stamp(17)
    # -- phase 18: configs 3_giant099 and 4_tree_mixed end to end ---------
    report["configs_3_4"] = phase18(pen, giant, mixed, synth[:512])
    stamp(18)
    # -- phase 19: pair sharding over devices and processes ---------------
    report["sharding"] = phase19(dev, pen, seqs, fasta, paf)
    stamp(19)
    # -- phase 20: the flip kernel and the fuzz ---------------------------
    shape20 = min(widest5.items())
    report["fuzz"] = phase20(dev, pen, shape20, batch5, C5, k_sub5)
    stamp(20)
    # -- phase 21: the batched wavefront engine and its kernels ----------
    report["wf_batch"] = wfb = phase21(dev, pen, seqs, pool5b, qi5b, ti5b, wf_out)
    stamp(21)
    total_s = time.perf_counter() - t_start
    print(f"smoke total seconds: {total_s:.1f}; phases 17-19: "
          f"{sum(phase_s[k] for k in ('17', '18', '19')):.1f} s", flush=True)

    def pick(rows, **want):
        return next(r for r in rows if all(r.get(k) == v for k, v in want.items()))

    # the kernel line's probe times: x1 V1 at kexp.py's shape, x4 v0 and
    # x2's full-size case on the filled card, each beside the plain
    # version's time on the same inputs (phase 16's full-size checks)
    x1_shape = dict(B=PR.X1_KEXP[0], K=PR.X1_KEXP[3])
    x1_t, x1_c = pick(times16, file="kexp", variant="V1", **x1_shape), pick(
        checks16, file="kexp", variant="V1", **x1_shape)
    x4_t = pick(times16, file="kexp6", variant="v0")
    x4_v1 = pick(times16, file="kexp6", variant="v1")
    x4_c = pick(checks16, file="kexp6", variant="v0", K=P6.K)
    x2_t = max((r for r in times16 if r["variant"] == PR.X2_FULL_CASE),
               key=lambda r: r["copies"])
    # beside them: x1 V2 at the headline's band round with the engine's
    # forward (V0) on the same pairs in the same call, and x3's lane
    # (64,128) 8r u1 on the filled card
    x1_head = {v: pick(times16, file="kexp", variant=v, B=PR.X1_HEADLINE[0], K=PR.X1_HEADLINE[3])
               for v in ("V0", "V2")}
    x3_t = max((r for r in times16 if r["variant"] == PR.X3_ROLL_CASE), key=lambda r: r["copies"])

    def probe_time(r, **extra):
        return {**extra, "ms": r["ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "share_of_bound": r["share_of_bound"]}
    x2_c = pick(checks16, file="kexp2", variant=PR.X2_FULL_CASE, n_steps=P2.STEPS * P2.TILES)

    # each engine kernel's bound, from this run's inputs: the least int32
    # operations its function needs (a DP cell P1.CELL_OPS, its plane byte
    # and run length P1.PLANE_OPS; a wavefront lane-level WF_LEVEL_OPS;
    # a walk WALK_OPS and one plane entry read per CIGAR run it emits)
    # over the card's int32 rate, or its bytes (inputs once, outputs once)
    # over HBM, whichever is larger. Operations are ALU instruction slots, as
    # kexp6.STEP_OPS counts them. A lane-level: I1 and I2 a max and an add
    # each, D1 and D2 a max each, the mismatch term's add, the five-way
    # max in two VIMNMX3 (9); the extension's first 8-byte compare, two
    # LOP3 for the XOR, a find-first-set and the add to the offset (4):
    # 13 instructions, of which the 4 adds can run as IMAD on the FMA
    # pipe, so max(9, 13 / 2) = 9 ALU slots. Band-end caps, like the DP's
    # lane masks, are not counted.
    WF_LEVEL_OPS, WALK_OPS = 9, 8

    def bnd(ops, nbytes):
        ms_b, by = PR.bound(ops, nbytes, ops_s)
        return {"bound_ms": ms_b, "bound_by": by, "library_ms": None}

    def fwd_bound_of(r):  # bases and lengths in; scores, certificates, plane out
        return bnd(r["active_cells"] * (P1.CELL_OPS + P1.PLANE_OPS),
                   r["B"] * (2 * r["l_pad"] + 13) + 2 * r["l_pad"] * r["B"] * r["K"] * 2)

    def span_bound_of(r):  # the state and bases in; the end state or the plane out
        planes = r["with_planes"]
        out = r["n_steps"] * r["B"] * r["k_sub"] * 2 if planes else 5 * r["B"] * r["K"] * 4
        return bnd(r["active_cells"] * (P1.CELL_OPS + (P1.PLANE_OPS if planes else 0)),
                   5 * r["B"] * r["K"] * 4 + r["B"] * r["n_steps"] + out)

    # every forward shape of phase 6 and span shape of phase 11 beside its bound
    for r in at_shape:
        print("phase 16 bound: " + json.dumps({"kernel": "dense_forward", **{
            k: r[k] for k in ("B", "K", "l_pad", "ms")}, **fwd_bound_of(r)}), flush=True)
    for r in span11:
        name = "dense_span_replay" if r["with_planes"] else "dense_span_sweep"
        print("phase 16 bound: " + json.dumps({"kernel": name, **{
            k: r[k] for k in ("B", "K", "k_sub", "l_pad", "n_steps", "G", "Lb", "ms", "us_per_step")},
            **span_bound_of(r)}), flush=True)
    # the cluster sweep's barrier alone: n_steps bare barriers in the
    # sweep's launch shape (clusters, threads, shared memory) at every
    # design phases 7 and 11 ran, beside the sweep's own us a step
    # (phase 11's bound lines)
    barrier16 = []
    for B, K, W in sorted({(r["B"], r["K"], r["k_sub"]) for r in span11 if not r["with_planes"]}
                          | {(r["B"], r["K"], r["k_sub"]) for r in sweep7}):
        n = 2048
        out = TS.sweep_barriers(B, K, W, n, dev)
        torch.cuda.synchronize()
        check(bool((out == n).all()), f"the barrier kernel stopped early at B={B} K={K} W={W}")
        ms = time_ms(lambda: TS.sweep_barriers(B, K, W, n, dev), 5)
        # beside it, cooperative groups' cluster.sync(), whose release
        # arrive fences the whole GPU's memory
        full_ms = time_ms(lambda: TS.sweep_barriers(B, K, W, n, dev, full_fence=True), 5)
        g = TS.span_design(K, W, False, B, True)
        row = {"B": B, "K": K, "k_sub": W, "G": g.blocks_per_pair, "Lb": g.lanes_per_block,
               "n_steps": n, "ms": ms, "us_per_step": 1e3 * ms / n,
               "cluster_sync_us_per_step": 1e3 * full_ms / n}
        print("phase 16 barrier: " + json.dumps(row), flush=True)
        barrier16.append(row)
    report["sweep_barriers"] = barrier16
    fwd_bound = fwd_bound_of(head)
    tb_bound = bnd(head["runs"] * WALK_OPS, 2 * head["runs"] + head["traceback_out_bytes"])
    sweep_bound = span_bound_of(sweep)
    replay_bound = span_bound_of(replay)
    walk_bound = bnd(walk["runs"] * WALK_OPS, 2 * walk["runs"])
    wf_bound = bnd(wf_sweep["lane_levels"] * WF_LEVEL_OPS,
                   wf_sweep["ckpt_bytes"] + 2 * wf_sweep["B"] * wf_sweep["l_pad"])
    # the history span: its ring slice in and its five planes out (20
    # bytes a lane-level) make it bytes-bound; the bases its lanes compare
    # are a window of the rows, not counted
    wf_hist_bound = bnd(wf_hist["B"] * wf_hist["n_steps"] * wf_hist["W"] * WF_LEVEL_OPS,
                        wf_hist["ring_bytes"] + wf_hist["plane_bytes"])
    wf_walk_bound = bnd(wf_walk["runs"] * WALK_OPS, 2 * wf_walk["runs"])
    # a bound a serial walk can be held to: its longest walker's hops, one
    # after another, each at least the hop's dependent chain (phase 1:
    # shared-memory loads and ALU instructions from one hop's tile load
    # to the next, read off this build's machine code by
    # `probes.sass.hop_chain`), at the latencies one thread's dependent
    # chains of each take on this card (csrc/probe_latency.cu)
    from allwave_tpu_torch.probes.latency import dram_ns

    lat16 = {k: chains16.latency[k] for k in ("lds_ns", "alu_ns")}
    # the dense traceback's round trips each wait on a device-memory load
    # that misses L2 (its plane is gigabytes): one thread's dependent
    # chain of such loads
    lat16["dram_ns"] = dram_ns(dev)
    print("phase 16 walk latency: " + json.dumps(lat16), flush=True)
    report["walk_latency_ns"] = lat16
    # the dense traceback at the headline: its longest walker's round
    # trips, one after another, beside the bytes bound; and the sectors
    # its round trips touch, as the emulation models them
    tb_bound.update({
        "chain_bound_ms": head["traceback_rounds_max"] * lat16["dram_ns"] * 1e-6,
        "rounds_max": head["traceback_rounds_max"], "hops_max": head["traceback_hops_max"],
        "rounds_sum": head["traceback_rounds_sum"], "hops_sum": head["traceback_hops_sum"],
        "modeled_sectors": head["traceback_modeled_sectors"],
        "modeled_bytes": 32 * head["traceback_modeled_sectors"],
    })
    # tier 3 at its kernel-line shape (phase 2), beside its own bound;
    # and at the widest shape the main path launched it (phase 10)
    t3 = next(r for r in fwd if r["tier"] == 3 and "ms" in r)
    t3_bound = fwd_bound_of(t3)
    t3_long = max(t3_len, key=lambda r: (r["l_pad"] * r["B"] * r["K"]))
    t3_at_length = {"shape": [t3_long["B"], t3_long["K"], t3_long["l_pad"]],
                    "ms": t3_long["ms"], "plain_ms": t3_long["plain_ms"], **fwd_bound_of(t3_long)}

    def chain_bound(r, chain):
        hop_ns = chain["loads"] * lat16["lds_ns"] + chain["alu"] * lat16["alu_ns"]
        return {"chain_bound_ms": r["hops_max"] * hop_ns * 1e-6}

    walk_bound.update(chain_bound(walk, hop_chains["segment_traceback"]))
    wf_walk_bound.update(chain_bound(wf_walk, hop_chains["wf_traceback"]))

    # the batch engine's kernels at the headline's widest history batch
    # (phase 21): the forward's lane-levels, its bases and lengths in,
    # scores, done flags and the history rows it needs out (20 bytes a
    # lane-level); the walk's runs, each one plane entry read and 5 bytes
    # (op, length) written, with each pair's score, lengths, run count and
    # overflow flag
    wt = wfb["timing"]
    wfb_fwd_bound = bnd(wt["lane_levels"] * WF_LEVEL_OPS,
                        wt["B"] * (2 * wt["l_pad"] + 13) + wt["hist_bytes"])
    wfb_tb_bound = bnd(wt["runs"] * WALK_OPS, 9 * wt["runs"] + 17 * wt["B"])
    # the walk's chain: its longest walker's round trips, one after
    # another, each a device-memory load that misses L2 (the planes are
    # gigabytes)
    wfb_tb_bound.update({"chain_bound_ms": wt["rounds_max"] * lat16["dram_ns"] * 1e-6,
                         "rounds_max": wt["rounds_max"], "steps_max": wt["steps_max"],
                         "rounds_sum": wt["rounds_sum"]})
    w5 = wfb["5b_widest"]

    def design_str(d):
        return f"{d['tier']} {d['blocks_per_pair']}x{d['lanes_per_block']}" + (
            " staged" if d["staged"] else "")

    kernels = [
        {
            "name": "dense_forward", "route": "cuda", "tiers": [1, 2],
            "source": "allwave_tpu_torch/csrc/dense_forward.cu",
            "replaces": "allwave_tpu/wfa/pallas_dense.py:1206 (_forward_t); "
                        "allwave_tpu/wfa/pallas_dense.py:1390 (_forward_c2)",
            "launches": launches["dense_forward"],
            "max_abs_err": max(r["max_abs_err"] for r in fwd + at_shape),
            "ms": head["ms"], "plain_ms": head["plain_ms"], **fwd_bound,
        },
        {
            "name": "dense_forward_tier3", "route": "cuda",
            "source": "allwave_tpu_torch/csrc/dense_span.cu",
            "epilogue": "allwave_tpu_torch/csrc/dense_forward.cu (dense_forward_finish_kernel)",
            "replaces": "allwave_tpu/wfa/pallas_dense.py:1390 (_forward_c2, K > 4096)",
            "launches": launches_t3, "shape": [t3["B"], t3["K"], t3["l_pad"]],
            "blocks_per_pair": t3["blocks_per_pair"],
            "max_abs_err": max(r["max_abs_err"] for r in fwd + t3_len if r["tier"] == 3),
            "ms": t3["ms"], "plain_ms": t3["plain_ms"], **t3_bound,
            "at_length": t3_at_length,
        },
        {
            "name": "dense_traceback", "route": "cuda",
            "source": "allwave_tpu_torch/csrc/dense_traceback.cu",
            "replaces": "allwave_tpu/wfa/dense.py:488 (XLA dense_traceback)",
            "launches": launches["dense_traceback"],
            "max_abs_err": max(r["max_abs_err"] for r in tb + at_shape),
            "ms": head["traceback_ms"], "plain_ms": head["traceback_plain_ms"], **tb_bound,
        },
        {
            "name": "dense_span_sweep", "route": "cuda",
            "source": "allwave_tpu_torch/csrc/dense_span.cu",
            "replaces": "allwave_tpu/wfa/pallas_span.py:208 (_span_call, with_choices=False); "
                        "allwave_tpu/wfa/pallas_span_c2.py:217 (dense_span_pallas_c2)",
            "launches": launches_long["dense_span_sweep"],
            "max_abs_err": max(r["max_abs_err"] for r in span7 + span11 + sweep7
                               if not r.get("with_planes")),
            "ms": sweep["ms"], "plain_ms": sweep["plain_ms"], **sweep_bound,
        },
        {
            "name": "dense_span_replay", "route": "cuda",
            "source": "allwave_tpu_torch/csrc/dense_span.cu",
            "replaces": "allwave_tpu/wfa/pallas_span.py:208 (_span_call, with_choices=True)",
            "launches": launches_long["dense_span_replay"],
            "max_abs_err": max(r["max_abs_err"] for r in span7 + span11 + replay7
                               if r.get("with_planes", True)),
            "ms": replay["ms"], "plain_ms": replay["plain_ms"], **replay_bound,
        },
        {
            "name": "segment_traceback", "route": "cuda",
            "source": "allwave_tpu_torch/csrc/segment_traceback.cu",
            "replaces": "allwave_tpu/wfa/segmented.py:382 (XLA _traceback_core)",
            "launches": launches_long["segment_traceback"],
            "max_abs_err": max(r["max_abs_err"] for r in tb8 + tb11),
            "ms": walk["ms"], "plain_ms": walk["plain_ms"], **walk_bound,
        },
        {
            "name": "wf_span_sweep", "route": "cuda",
            "source": "allwave_tpu_torch/csrc/wf_span.cu",
            "replaces": "allwave_tpu/wfa/pallas_wf.py:717 (_call_kernel, with_history=False)",
            "launches": launches_wf["wf_span_sweep"],
            "max_abs_err": max(r["max_abs_err"] for r in wf12 + wf15 + split15
                               if r["mode"] == "sweep"),
            "ms": wf_sweep["ms"], "plain_ms": wf_sweep["plain_ms"], **wf_bound,
        },
        {
            "name": "wf_span_history", "route": "cuda",
            "source": "allwave_tpu_torch/csrc/wf_span.cu",
            "replaces": "allwave_tpu/wfa/pallas_wf.py:717 (_call_kernel, with_history=True)",
            "launches": launches_wf["wf_span_history"],
            "max_abs_err": max(r["max_abs_err"] for r in wf12 + wf15 if r["mode"] == "history"),
            "ms": wf_hist["ms"], "plain_ms": wf_hist["plain_ms"], **wf_hist_bound,
        },
        {
            "name": "wf_traceback", "route": "cuda",
            "source": "allwave_tpu_torch/csrc/wf_traceback.cu",
            "replaces": "allwave_tpu/wfa/wf_segmented.py:379 (XLA _traceback_window)",
            "launches": launches_wf["wf_traceback"],
            "max_abs_err": max(r["max_abs_err"] for r in tb13 + tb15),
            "ms": wf_walk["ms"], "plain_ms": wf_walk["plain_ms"], **wf_walk_bound,
            "flip_checked": report["fuzz"]["flip"],
        },
        {
            "name": "probe_forward", "route": "cuda",
            "source": "allwave_tpu_torch/csrc/probe_forward.cu",
            "replaces": "scripts/experiments/kexp.py:200 (forward_v)",
            "launches": launches_probe["probe_forward"],
            "max_abs_err": max(r["max_abs_err"] for r in checks16 if r["file"] == "kexp"),
            "ms": x1_t["ms"], "plain_ms": x1_c["plain_ms"],
            "bound_ms": x1_t["bound_ms"], "bound_by": x1_t["bound_by"], "library_ms": None,
            "headline_V2": probe_time(x1_head["V2"], shape=list(PR.X1_HEADLINE[::3]),
                                      V0_ms=x1_head["V0"]["ms"]),
        },
        {
            "name": "probe_step", "route": "cuda",
            "source": "allwave_tpu_torch/csrc/probe_step.cu",
            "replaces": "scripts/experiments/kexp6.py:134 (run); "
                        "scripts/experiments/kexp7.py:54 (make_kernel); "
                        "scripts/experiments/kexp8.py:29 (make_kernel)",
            "launches": launches_probe["probe_step"],
            "max_abs_err": max(r["max_abs_err"] for r in checks16
                               if r["file"] in ("kexp6", "kexp7", "kexp8")),
            "ms": x4_t["ms"], "plain_ms": x4_c["plain_ms"],
            "bound_ms": x4_t["bound_ms"], "bound_by": x4_t["bound_by"], "library_ms": None,
            "chain_bound_ms": x4_t["chain_bound_ms"],
            # v0 (step_smem_kernel) above, v1 (step_regs_kernel) here
            "v1": {"kernel": x4_v1["kernel"], "ms": x4_v1["ms"], "bound_ms": x4_v1["bound_ms"],
                   "bound_by": x4_v1["bound_by"], "chain_bound_ms": x4_v1["chain_bound_ms"]},
        },
        {
            "name": "probe_ops", "route": "cuda",
            "source": "allwave_tpu_torch/csrc/probe_ops.cu",
            "replaces": "scripts/experiments/kexp2.py:22 (make); "
                        "scripts/experiments/kexp3.py:19 (make)",
            "launches": launches_probe["probe_ops"],
            "max_abs_err": max(r["max_abs_err"] for r in checks16
                               if r["file"] in ("kexp2", "kexp3")),
            "ms": x2_t["ms"], "plain_ms": x2_c["plain_ms"],
            "bound_ms": x2_t["bound_ms"], "bound_by": x2_t["bound_by"], "library_ms": None,
            "x3": probe_time(x3_t, case=PR.X3_ROLL_CASE, copies=x3_t["copies"]),
        },
        {
            "name": "wf_batch_forward", "route": "cuda",
            "source": "allwave_tpu_torch/csrc/wf_batch.cu",
            "replaces": "allwave_tpu/wfa/batch.py:201 (XLA wavefront_forward)",
            "launches": wfb["headline"]["launches"]["wf_batch_forward"],
            "max_abs_err": max([r["max_abs_err"] for r in wfb["kernels"]]
                               + [wt["forward_err"], wt["versus_global_err"],
                                  w5["versus_global_err"]]),
            "ms": max(wt["ms"]), "plain_ms": wt["forward_plain_ms"], **wfb_fwd_bound,
            "global_ms": wt["global_ms"], "design": design_str(wt["design"]),
            "shape": [wt["B"], wt["K"], wt["l_pad"], wt["s_cap"]],
            "designs": sorted({design_str(r["design"]) for r in wfb["kernels"]}),
            "at_5b": {"shape": [w5["B"], w5["K"], w5["l_pad"], w5["s_cap"]],
                      "design": design_str(w5["design"]), "ms": max(w5["ms"]),
                      "global_ms": w5["global_ms"]},
        },
        {
            "name": "wf_batch_traceback", "route": "cuda",
            "source": "allwave_tpu_torch/csrc/wf_batch.cu",
            "replaces": "allwave_tpu/wfa/batch.py:299 (XLA wavefront_traceback)",
            "launches": wfb["headline"]["launches"]["wf_batch_traceback"],
            "max_abs_err": max([r["max_abs_err"] for r in wfb["kernels"]] + [wt["traceback_err"]]),
            "ms": max(wt["traceback_ms"]), "plain_ms": wt["traceback_plain_ms"], **wfb_tb_bound,
            "thread_ms": wt["traceback_thread_ms"], "design": "warp a pair",
            "shape": [wt["B"], wt["K"], wt["s_cap"], wt["run_cap"]],
        },
    ]
    with open(os.path.join(OUT_DIR, "report.json"), "w") as f:
        json.dump({"card": smi, **report, "escalation": p5, "phase_seconds": phase_s},
                  f, indent=1, default=str)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseFailed as e:
        print(f"FAIL: {e}", file=sys.stderr)
        sys.exit(1)
