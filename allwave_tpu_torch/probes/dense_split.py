"""The dense engine's traceback and the forward's tier 3, each timed alone.

* `dense_traceback` (csrc/dense_traceback.cu) at the headline's shape:
  the first B = 4096 of bench.py's headline pairs (128 x 1 kb at 2%
  divergence, seed 1234) as the pipeline orients them, band K = 192,
  l_pad = 1024, run_cap 128, over the plane the forward made;
* `dense_forward` tier 3 (K > 4096) at B = 4 random pairs of ~2 kb at 5%
  substitutions (seed 3), l_pad = 2048, K = 6144: chip_smoke.py phase
  2's shape;
* the one-shot dense engine on chip_smoke.py phase 10's pairs (4 x 24 kb
  at 2%, seed 24, 12 directed pairs; its rungs past 4096 run tier 3):
  the wall seconds of a warm `UnifiedAligner.align_pairs`, best of 3.

The traceback is also timed on random 1 kb pairs at 2% substitutions
(seed 10, chip_smoke.py phase 6's kind); and, where the tree's wrapper
counts round trips, on the first 132 and 1056 of the headline's pairs,
for the time a round trip takes with one warp an SM and with eight.

Each kernel is timed over `--reps` calls after a warm-up (CUDA events),
the calls queued while the card sleeps, so they run back to back. Prints
one JSON object a line: the card's name and power limit, then one line a
kernel with its mean ms, its mean device ms as the profiler reads it
(CUPTI), the traceback's hops and round trips (where the tree's wrapper
counts them) and a digest of the outputs (two trees that agree give one
digest).

    python allwave_tpu_torch/probes/dense_split.py [--root DIR]

`--root DIR` imports the package from DIR instead of this tree, for
example from an older commit unpacked with `git archive`, so that two
versions of the kernels can be timed on one card in one call. It needs a
CUDA card; the kernels are built at first use.
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import os
import subprocess
import sys
import time

SCORES = "0,5,8,2,24,1"
#: the card's sleep before a timed run of launches: ~25 ms, far longer
#: than the host takes to queue them
SLEEP_CYCLES = 50_000_000


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def _digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _time(fn, reps: int):
    """(mean ms over reps back-to-back calls by CUDA events, mean device
    ms of one call by the profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev_us = sum(e.time_range.end - e.time_range.start for e in prof.events()
                 if str(getattr(e, "device_type", "")).endswith("CUDA")
                 and "dense_" in e.name)
    return start.elapsed_time(end) / reps, dev_us / 1e3 / reps


def headline_batch(B: int, l_pad: int, dev):
    """The first B of the headline's directed pairs as the pipeline
    orients them, on the card."""
    import numpy as np
    import torch

    from allwave_tpu_torch.core.scores import parse_scores
    from allwave_tpu_torch.engine.pipeline import AllPairAligner
    from allwave_tpu_torch.testing.synth import MutationConfig, make_test_case

    seqs = make_test_case(1234, 128, 1000, MutationConfig(0.02, 0.0005, 0.0005)).sequences
    apa = AllPairAligner(seqs, parse_scores(SCORES), exclude_self=True, use_mash_orientation=True)
    pool, qi, ti, _, _ = apa._orient_chunk(apa.get_pairs())
    qs = np.zeros((B, l_pad), np.uint8)
    ts = np.zeros((B, l_pad), np.uint8)
    ql = np.zeros(B, np.int32)
    tl = np.zeros(B, np.int32)
    for b in range(B):
        q, t = pool[qi[b]], pool[ti[b]]
        qs[b, : len(q)] = np.frombuffer(q, np.uint8)
        ts[b, : len(t)] = np.frombuffer(t, np.uint8)
        ql[b], tl[b] = len(q), len(t)
    return tuple(torch.from_numpy(a).to(dev) for a in (qs, ts, ql, tl))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None, help="import the package from this tree")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root or os.path.join(os.path.dirname(__file__), "..", ".."))
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import allwave_tpu_torch
    from allwave_tpu_torch.core.scores import parse_scores
    from allwave_tpu_torch.testing.batches import random_batch
    from allwave_tpu_torch.wfa import dense as D
    from allwave_tpu_torch.wfa.params import resolve_penalties

    if not os.path.abspath(allwave_tpu_torch.__file__).startswith(root + os.sep):
        raise SystemExit(f"the package came from {allwave_tpu_torch.__file__}, not {root}")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the kernels run on the card only")
    dev = torch.device("cuda", 0)
    pen = resolve_penalties(parse_scores(SCORES))
    print(json.dumps({"card": _card(), "root": root}), flush=True)

    B, l_pad, K, cap = 4096, 1024, 192, 128
    random_pairs = random_batch(np.random.RandomState(10), B, 1000, l_pad, 0.02, min_len=750)
    for pairs, (qs, ts, ql, tl) in (
            ("headline", headline_batch(B, l_pad, dev)),
            ("random", tuple(torch.from_numpy(a).to(dev) for a in random_pairs))):
        s, c, p = D.dense_forward(qs, ts, ql, tl, pen, K, l_pad)
        row = {"kernel": "dense_traceback", "pairs": pairs, "B": B, "K": K, "l_pad": l_pad,
               "run_cap": cap}
        if "stats" in inspect.signature(D.dense_traceback).parameters:
            stats = torch.zeros((2, B), dtype=torch.int32, device=dev)
            D.dense_traceback(p, s, c, ql, tl, cap, stats=stats)
            hops, rounds = stats.cpu()
            row.update(hops_max=int(hops.max()), hops_sum=int(hops.sum()),
                       rounds_max=int(rounds.max()), rounds_sum=int(rounds.sum()))
        out = D.dense_traceback(p, s, c, ql, tl, cap)
        ms, row_dev_ms = _time(lambda: D.dense_traceback(p, s, c, ql, tl, cap), args.reps)
        print(json.dumps({**row, "ms": ms, "device_ms": row_dev_ms, "digest": _digest(out)}),
              flush=True)
        if pairs == "headline" and "rounds_max" in row:
            for b in (132, 1056):
                sub = (p[:, :b].contiguous(), s[:b], c[:b], ql[:b], tl[:b])
                stats = torch.zeros((2, b), dtype=torch.int32, device=dev)
                D.dense_traceback(*sub, cap, stats=stats)
                ms, dev_ms = _time(lambda: D.dense_traceback(*sub, cap), args.reps)
                rounds = int(stats[1].max())
                print(json.dumps({"kernel": "dense_traceback", "pairs": "headline", "B": b,
                                  "ms": ms, "device_ms": dev_ms, "rounds_max": rounds,
                                  "us_per_round_trip": 1e3 * dev_ms / rounds}), flush=True)
            print(json.dumps({"kernel": "dense_traceback", "pairs": "headline", "B": B,
                              "us_per_round_trip": 1e3 * row_dev_ms / row["rounds_max"]}),
                  flush=True)
        del p, out

    B, L, l_pad, K = 4, 2048, 2048, 6144
    batch = random_batch(np.random.RandomState(3), B, L, l_pad, 0.05, min_len=(3 * L) // 4)
    qs, ts, ql, tl = (torch.from_numpy(a).to(dev) for a in batch)
    s, c, p = D.dense_forward(qs, ts, ql, tl, pen, K, l_pad)
    ms, dev_ms = _time(lambda: D.dense_forward(qs, ts, ql, tl, pen, K, l_pad), max(args.reps // 5, 2))
    print(json.dumps({"kernel": "dense_forward_tier3", "B": B, "K": K, "l_pad": l_pad, "ms": ms,
                      "device_ms": dev_ms, "us_per_step": 1e3 * ms / (2 * l_pad),
                      "digest": _digest(s, c, p)}), flush=True)
    del p

    from allwave_tpu_torch.testing.synth import MutationConfig, make_test_case
    from allwave_tpu_torch.wfa.batch import expand_runs
    from allwave_tpu_torch.wfa.dense_engine import UnifiedAligner

    seqs = make_test_case(24, 4, 24_000, MutationConfig(0.02, 0.0005, 0.0005)).sequences
    pairs = [(a.seq, b.seq) for a in seqs for b in seqs if a is not b]
    walls = []
    for _ in range(4):  # the first builds and warms
        t0 = time.perf_counter()
        res = UnifiedAligner(pen, dense_max_len=32768, device=dev).align_pairs(pairs)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    print(json.dumps({"run": "one_shot_24kb", "pairs": len(pairs), "warm_s": min(walls[1:]),
                      "digest": hashlib.sha256(repr([(r[0], bytes(expand_runs(*r[1]))) for r in res])
                                               .encode()).hexdigest()[:16]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
