#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (allwave_tpu_torch).

Run from the repository root on a machine with one NVIDIA Hopper GPU:

    python3 chip_smoke.py

It builds the ten CUDA kernel libraries from the sources in this
checkout (one nvcc per source, all at once; phase 1 prints every dense
forward, traceback and span kernel's registers and spill bytes from
ptxas, fails if a register-band forward or replay kernel or the
traceback spills, and prints the opcodes of the cluster sweep's and the
cluster replay's loops; for the step probes' 36 instantiations it
prints registers, spills, each one's step loop and its dependent chain
a step, and fails on a spill or a kernel with no chain; for the forward
and op-chain probes' 12 and 17 it prints registers, spills and loops,
and fails on a spill or a division in a loop of the forward's), drives the
port's three engines and runs the probes:

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
  kernels run).

Each wrapper counts its launches by shape; every count is set to 0 just
before a path is driven and read just after. Every kernel is held to its
plain version with tolerance 0: scores, certificates, band states, plane
bytes, walk states and run buffers must be equal, because the tie-break
contract (docs/TIEBREAK.md) leaves no room. Every phase prints its result
and its seconds on its own line; any failure exits non-zero. The last
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
    run_cap."""
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
        })
    return out


def _paf_records(path):
    with open(path) as f:
        return [line.rstrip("\n").split("\t") for line in f if line.strip()]


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


def run_pipeline(seqs, scores_str):
    """AllPairAligner with mash orientation over all pairs; returns
    (results, seconds)."""
    import torch

    from allwave_tpu_torch.core.scores import parse_scores
    from allwave_tpu_torch.engine.pipeline import AllPairAligner

    out = []
    t0 = time.perf_counter()
    aligner = AllPairAligner(
        seqs, parse_scores(scores_str), exclude_self=True, use_mash_orientation=True
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
    t_last = [time.perf_counter()]

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
    # the two walks: registers and spills, and their loops (the walker's
    # hops read tiles from shared memory: LDS; the producers copy them
    # with cp.async: LDGSTS) divide nowhere
    for name in ("segment_traceback", "wf_traceback"):
        for fn, u in sorted(cuda_build.ptxas_usage(name).items()):
            print("phase 1 ptxas: " + json.dumps({"kernel": _short(fn), **u}), flush=True)
        walk_loops = [r for r in SA.report([name]) if "_traceback_kernel" in r["function"]]
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
        kernel = [f for f in funcs if "_traceback_kernel" in f]
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
    from allwave_tpu_torch.core.cigar import cigar_string_to_bytes, validate_cigar
    from allwave_tpu_torch.core.scores import parse_scores
    from allwave_tpu_torch.orient.orientation import reverse_complement
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
    by_id = {s.id: s.seq for s in seqs}
    empty = 0
    for f in recs:
        if not f[13].startswith("cg:Z:") or f[13] == "cg:Z:":
            empty += 1
            continue
        q = by_id[f[0]]
        if f[4] == "-":
            q = reverse_complement(q)
        validate_cigar(cigar_string_to_bytes(f[13][5:]), q, by_id[f[5]])
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
    by_id = {sq.id: sq.seq for sq in seqs100}
    empty = 0
    for f in recs:
        if not f[13].startswith("cg:Z:") or f[13] == "cg:Z:":
            empty += 1
            continue
        q = by_id[f[0]]
        if f[4] == "-":
            q = reverse_complement(q)
        validate_cigar(cigar_string_to_bytes(f[13][5:]), q, by_id[f[5]])
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
    by_id = {sq.id: sq.seq for sq in seqs5b}
    empty = 0
    for f in recs:
        if not f[13].startswith("cg:Z:") or f[13] == "cg:Z:":
            empty += 1
            continue
        q = by_id[f[0]]
        if f[4] == "-":
            q = reverse_complement(q)
        validate_cigar(cigar_string_to_bytes(f[13][5:]), q, by_id[f[5]])
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
