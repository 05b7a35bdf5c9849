#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (allwave_tpu_torch).

Run from the repository root on a machine with one NVIDIA Hopper GPU:

    python3 chip_smoke.py

It builds the two CUDA kernels of the short-pair main path from the
sources in this checkout, holds each against its plain PyTorch version
on the card, then drives the port's main path (the CLI and the
AllPairAligner) over bench.py's headline data, 128 x 1 kb at 2%
divergence, all 16,256 directed pairs, and over a 12 kb escalation case.
Each wrapper records the shapes it launched at; the last phase holds
both kernels against their plain versions again at every shape the
main path used. Every kernel is held to its plain version with
tolerance 0: scores,
certificates and packed bytes must be equal, because the tie-break
contract (docs/TIEBREAK.md) leaves no room. Every phase prints its
result on its own line; any failure exits non-zero. The last two lines are a JSON object with one entry per kernel
and the device line `{"ok": true, "device": {...}}`.

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


def forward_case(device, scores_str, B, L, K, seed, div, reps, l_pad=None, run_cap=None):
    """Both kernels against their plain versions at one shape: the
    forward's scores, certificates and planes, and the packed bytes of
    the traceback kernel over either plane and of the plain walk + pack
    over the plain plane. The plain forward is timed on the one call
    that is checked. Returns a result dict."""
    import numpy as np
    import torch

    from allwave_tpu_torch.core.scores import parse_scores
    from allwave_tpu_torch.testing.batches import random_batch
    from allwave_tpu_torch.wfa import dense as D
    from allwave_tpu_torch.wfa.params import resolve_penalties

    pen = resolve_penalties(parse_scores(scores_str))
    l_pad = l_pad or 1 << max(L - 1, 1).bit_length()
    cap = run_cap or min(max(128, l_pad // 8), 2 * l_pad + 8)
    at = f"B={B} L={L} l_pad={l_pad} K={K} run_cap={cap}"
    batch = random_batch(np.random.RandomState(seed), B, L, l_pad, div, min_len=(3 * L) // 4)
    qs, ts, ql, tl = (torch.from_numpy(a).to(device) for a in batch)
    s_k, c_k, p_k = D.dense_forward(qs, ts, ql, tl, pen, K, l_pad)
    (s_p, c_p, p_p), plain_ms = timed_once(
        lambda: D.dense_forward_ref(qs, ts, ql, tl, pen, K, l_pad)
    )
    check(torch.equal(s_k, s_p), f"forward scores differ at {at}")
    check(torch.equal(c_k, c_p), f"forward certs differ at {at}")
    planes_equal = bool(torch.equal(p_k, p_p))
    t_k = D.dense_traceback(p_k, s_k, c_k, ql, tl, cap)
    t_kp = D.dense_traceback(p_p, s_p, c_p, ql, tl, cap)
    check(torch.equal(t_k, t_kp), f"traceback over the two planes differs at {at}")
    t_p, tb_plain_ms = timed_once(
        lambda: D.pack_alignments(s_p, c_p, *D.dense_traceback_ref(p_p, s_p, ql, tl, cap))
    )
    check(torch.equal(t_k, t_p), f"traceback kernel and plain walk differ at {at}")
    del p_p, t_kp
    ms = time_ms(lambda: D.dense_forward(qs, ts, ql, tl, pen, K, l_pad), reps)
    tb_ms = time_ms(lambda: D.dense_traceback(p_k, s_k, c_k, ql, tl, cap), reps)
    cells = B * 2 * l_pad * K
    return {
        "scores": scores_str, "B": B, "L": L, "l_pad": l_pad, "K": K, "run_cap": cap,
        "certified": int(c_k.sum()), "planes_equal": planes_equal,
        "max_abs_err": max(int((s_k - s_p).abs().max()),
                           int((t_k.to(torch.int32) - t_p.to(torch.int32)).abs().max())),
        "tolerance": 0, "ms": ms, "plain_ms": plain_ms,
        "gcells_s": cells / (ms * 1e6), "plain_gcells_s": cells / (plain_ms * 1e6),
        "traceback_ms": tb_ms, "traceback_plain_ms": tb_plain_ms,
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
        k = D.dense_traceback(p, s, c, ql, tl, cap)
        ref, plain_ms = timed_once(
            lambda: D.pack_alignments(s, c, *D.dense_traceback_ref(p, s, ql, tl, cap))
        )
        check(torch.equal(k, ref), f"traceback bytes differ at run_cap={cap}")
        overflowed = int(k[:, 12:16].contiguous().view(torch.int32).sum())
        diff = int((k.to(torch.int32) - ref.to(torch.int32)).abs().max())
        ms = time_ms(lambda: D.dense_traceback(p, s, c, ql, tl, cap), reps)
        out.append({
            "B": B, "L": L, "K": K, "run_cap": cap, "overflowed": overflowed,
            "max_abs_err": diff, "tolerance": 0, "ms": ms, "plain_ms": plain_ms,
        })
    return out


def _paf_records(path):
    with open(path) as f:
        return [line.rstrip("\n").split("\t") for line in f if line.strip()]


def check_alignments(seqs, results, pen, n_sample, seed):
    """Every result certified and valid; sampled pairs oracle-exact.
    results: list of AlignmentResult. Returns the number of failed."""
    import numpy as np

    from allwave_tpu_torch.core.cigar import validate_cigar
    from allwave_tpu_torch.orient.orientation import reverse_complement
    from allwave_tpu_torch.testing.dense import cigar_score
    from allwave_tpu_torch.wfa.reference_impl import wfa_align

    failed = 0
    cigars = []
    for r in results:
        if r.cigar_runs is None:  # the pipeline returns runs for every success
            failed += 1
            cigars.append(None)
            continue
        ops, lens = r.cigar_runs
        cig = np.repeat(np.asarray(ops, np.uint8), np.asarray(lens, np.int64))
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
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    forward_ms = sum(v for k, v in by_name.items() if "dense_forward_kernel" in k)
    return {
        "pairs": len(res), "wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3,
        "dp_cells": cells, "forward_device_ms": forward_ms,
        "forward_gcells_s": cells / (forward_ms * 1e6) if forward_ms else None,
        "device_idle_share": 1.0 - busy_us / 1e3 / wall_ms,
        "peak_device_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "device_ms_by_kernel": {k[:60]: v for k, v in top},
    }


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
    os.environ["ALLWAVE_PLATFORM"] = "cuda"
    os.makedirs(OUT_DIR, exist_ok=True)
    dev = torch.device("cuda", 0)
    report = {}

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
    cuda_build.library("dense_forward")
    cuda_build.library("dense_traceback")
    build_s = time.perf_counter() - t0
    print(f"phase 1 env: torch {torch.__version__} cuda {torch.version.cuda} | "
          f"{nvcc} | {smi} | kernels built in {build_s:.1f} s "
          f"(nvcc: {cuda_build.build_seconds})", flush=True)

    # -- phase 2: forward kernel against its plain version ---------------
    fwd = []
    for sc in (SCORES, "0,5,8,2", "0,1,1,1"):
        fwd.append(forward_case(dev, sc, B=256, L=1024, K=128, seed=1, div=0.02, reps=5))
    fwd.append(forward_case(dev, SCORES, B=8, L=4096, K=3072, seed=2, div=0.02, reps=2))
    # wider than SMEM_MAX_K: the bands live in the global scratch
    fwd.append(forward_case(dev, SCORES, B=4, L=2048, K=6144, seed=3, div=0.05, reps=2))
    for r in fwd:
        print("phase 2 forward: " + json.dumps(r), flush=True)
    report["forward"] = fwd

    # -- phase 3: traceback kernel against its plain version -------------
    tb = traceback_case(dev, B=256, L=1024, K=128, seed=4, div=0.02,
                        run_caps=(128, 4), reps=10)
    check(tb[1]["overflowed"] > 0, "run_cap=4 case did not overflow")
    for r in tb:
        print("phase 3 traceback: " + json.dumps(r), flush=True)
    report["traceback"] = tb

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
    p4 = {
        "pairs": len(res), "failed": failed, "cli_s": cli_s, "warm_s": warm_s,
        "warm_alignments_per_s": len(res) / warm_s, "launches": launches,
        "forward_shapes": sorted(D.forward_launches.shapes),
        "traceback_shapes": sorted(D.traceback_launches.shapes),
    }
    main_shapes = [(1000, D.forward_launches.shapes.copy(), D.traceback_launches.shapes.copy())]
    print("phase 4 main path: " + json.dumps(p4), flush=True)
    report["main_path"] = p4
    prof = profile_pipeline(seqs, SCORES)
    print("phase 4 profile: " + (json.dumps(prof) if prof else
          "device time not measured (the profiler saw no kernels)"), flush=True)
    report["main_path_profile"] = prof

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
    p5 = {
        "pairs": len(res12), "failed": failed12, "seconds": s12, "widest_k": widest,
        "forward_shapes": sorted(D.forward_launches.shapes),
        "traceback_shapes": sorted(D.traceback_launches.shapes),
    }
    main_shapes.append((12000, D.forward_launches.shapes.copy(),
                        D.traceback_launches.shapes.copy()))
    print("phase 5 escalation: " + json.dumps(p5), flush=True)

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

    kernels = [
        {
            "name": "dense_forward", "route": "cuda",
            "source": "allwave_tpu_torch/csrc/dense_forward.cu",
            "replaces": "allwave_tpu/wfa/pallas_dense.py:1206 (_forward_t); "
                        "allwave_tpu/wfa/pallas_dense.py:1390 (_forward_c2)",
            "launches": launches["dense_forward"],
            "max_abs_err": max(r["max_abs_err"] for r in fwd + at_shape),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
        },
        {
            "name": "dense_traceback", "route": "cuda",
            "source": "allwave_tpu_torch/csrc/dense_traceback.cu",
            "replaces": "allwave_tpu/wfa/dense.py:488 (XLA dense_traceback)",
            "launches": launches["dense_traceback"],
            "max_abs_err": max(r["max_abs_err"] for r in tb + at_shape),
            "ms": head["traceback_ms"], "plain_ms": head["traceback_plain_ms"],
        },
    ]
    with open(os.path.join(OUT_DIR, "report.json"), "w") as f:
        json.dump({"card": smi, **report, "escalation": p5}, f, indent=1)
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
