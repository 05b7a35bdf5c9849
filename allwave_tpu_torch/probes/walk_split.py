"""The two long-path walk kernels, each timed alone at its path's shape.

* `segment_traceback` (csrc/segment_traceback.cu) at bench config
  5_100kb's replay shape: B = 6 of its pairs as the pipeline orients
  them (4 x 100 kb at 2% divergence, seed 17), band K = 24576, the
  narrow replay's window of 4480 lanes, a segment of 2048 anti-diagonals
  (the third), walkers entering at its top on the main diagonal;
* `wf_traceback` (csrc/wf_traceback.cu) at bench config
  5b_100kb_lowdiv's widest round: B = 36 of its pairs (8 x 100 kb at
  0.25%, seed 18), shortest first, repeated to fill B, band K = 4096,
  the narrow replay's window of 1024 lanes, walkers from each pair's end
  cell through the top segment of 256 levels.

Each walk is timed over `--reps` calls after a warm-up (CUDA events),
every call on its own fresh copy of the entry state made before the
events, and the calls queued while the card sleeps, so they run back to
back and only the kernel is timed. Prints one JSON object a line: the
card's name and power limit, then one line a walk with its mean ms and
its mean device ms as the profiler reads it (CUPTI), the
hops of its longest walker, all hops and the misses (where the tree's
wrapper counts them) and a digest of the walk state and run buffers
after one call (two trees that agree give one digest).

    python allwave_tpu_torch/probes/walk_split.py [--root DIR]

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

SCORES = "0,5,8,2,24,1"
#: the card's sleep before a timed run of launches: ~25 ms, far longer
#: than the host takes to queue them
SLEEP_CYCLES = 50_000_000


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def oriented_pairs(seed: int, n: int, div: float, indel: float):
    """A bench config's pairs as the pipeline orients them: (pool, qidx,
    tidx)."""
    from allwave_tpu_torch.core.scores import parse_scores
    from allwave_tpu_torch.engine.pipeline import AllPairAligner
    from allwave_tpu_torch.testing.synth import MutationConfig, make_test_case

    seqs = make_test_case(seed, n, 100_000, MutationConfig(div, indel, indel)).sequences
    apa = AllPairAligner(seqs, parse_scores(SCORES), exclude_self=True, use_mash_orientation=True)
    pool, qi, ti, _, _ = apa._orient_chunk(apa.get_pairs())
    return pool, qi, ti


def batch(pool, qi, ti, B: int, l_pad: int, dev):
    """B of the pairs (pool[qi[j]], pool[ti[j]]) on the card, shortest
    first, repeated to fill B."""
    import numpy as np
    import torch

    order = np.argsort([len(pool[q]) + len(pool[t]) for q, t in zip(qi, ti)], kind="stable")
    qs = torch.zeros((B, l_pad), dtype=torch.uint8)
    ts = torch.zeros((B, l_pad), dtype=torch.uint8)
    lens = []
    for b in range(B):
        j = int(order[b % len(order)])
        q, t = pool[qi[j]], pool[ti[j]]
        qs[b, : len(q)] = torch.frombuffer(bytearray(q), dtype=torch.uint8)
        ts[b, : len(t)] = torch.frombuffer(bytearray(t), dtype=torch.uint8)
        lens.append((len(q), len(t)))
    ql, tl = (torch.tensor(x, dtype=torch.int32) for x in zip(*lens))
    return tuple(x.to(dev) for x in (qs, ts, ql, tl))


def time_walk(walk_fn, entry, reps: int, with_stats: bool):
    """{ms: mean of walk_fn over reps fresh copies of entry, digest, and
    with_stats the hops and misses}. The card first sleeps long enough
    for the host to queue every launch, so the launches run back to back
    and the time is the kernel's, not the host's."""
    import torch

    def fresh():
        return entry[0].clone(), tuple(b.clone() for b in entry[1])

    walk, bufs = fresh()
    stats = None
    if with_stats:
        stats = torch.zeros((2, walk.shape[1]), dtype=torch.int32, device=walk.device)
        walk_fn(walk, bufs, stats=stats)
        stats = stats.cpu()
    else:
        walk_fn(walk, bufs)
    digest = hashlib.sha256()
    for x in (walk, *bufs):
        digest.update(x.cpu().numpy().tobytes())
    copies = [fresh() for _ in range(reps)]
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for w, b in copies:
        walk_fn(w, b)
    end.record()
    torch.cuda.synchronize()
    out = {"ms": start.elapsed_time(end) / reps, "digest": digest.hexdigest()[:16],
           "device_ms": device_ms(walk_fn, [fresh() for _ in range(reps)])}
    if stats is not None:
        out.update(hops_max=int(stats[0].max()), hops_sum=int(stats[0].sum()),
                   misses=int(stats[1].sum()))
    return out


def device_ms(walk_fn, copies) -> float:
    """The walk kernel's mean device time over one call on each copy, as
    the profiler reads it from the card (CUPTI): the kernel's own time,
    whatever the host does between launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for w, b in copies:
            walk_fn(w, b)
        torch.cuda.synchronize()
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if "traceback_kernel" in e.name and str(getattr(e, "device_type", "")).endswith("CUDA")]
    return sum(spans) / len(spans) / 1e3 if spans else float("nan")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=None, help="import the package from this tree")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root or os.path.join(os.path.dirname(__file__), "..", ".."))
    sys.path.insert(0, root)

    import torch

    import allwave_tpu_torch

    if not os.path.abspath(allwave_tpu_torch.__file__).startswith(root + os.sep):
        raise SystemExit(f"the package came from {allwave_tpu_torch.__file__}, not {root}: "
                         "run this file by its path to time another tree")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    from allwave_tpu_torch.core.scores import parse_scores
    from allwave_tpu_torch.wfa import segmented as TS
    from allwave_tpu_torch.wfa import wf_segmented as TW
    from allwave_tpu_torch.wfa.dense import band_geometry
    from allwave_tpu_torch.wfa.params import resolve_penalties

    dev = torch.device("cuda", 0)
    pen = resolve_penalties(parse_scores(SCORES))
    print(json.dumps({"card": _card(), "root": root}), flush=True)

    # the segmented walk at 5_100kb's replay shape
    B, K, W, C, seg, l_pad, cap = 6, 24576, 4480, 2048, 2, 131072, 5300
    pairs = batch(*oriented_pairs(17, 4, 0.02, 0.0005), B, l_pad, dev)
    _, _, ckpts = TS.dense_sweep_ckpt(*pairs, pen, K, l_pad, C, n_seg=seg + 1)
    _, k0, _ = band_geometry(pairs[2], pairs[3], K)
    c = (-k0).clamp(0, K - 1).to(torch.int32)
    c_lo = TS.narrow_offsets(c, K, W)
    _, planes = TS.dense_span(*pairs, pen, K, l_pad, seg * C, C, ckpts[:, seg], True,
                              c_lo=c_lo, k_sub=W)
    del ckpts
    entry = (TS.new_walk(torch.full_like(pairs[2], (seg + 1) * C), c,
                         torch.ones_like(pairs[2], dtype=torch.bool)), TS.new_bufs(B, cap, dev))
    stats = "stats" in inspect.signature(TS.segment_traceback).parameters
    r = time_walk(lambda w, b, **kw: TS.segment_traceback(planes, seg * C, w, b, l_pad, c_lo=c_lo,
                                                          **kw), entry, args.reps, stats)
    print(json.dumps({"walk": "segment_traceback", "B": B, "K": K, "k_sub": W, "n_steps": C,
                      "run_cap": cap, "reps": args.reps, **r}), flush=True)
    del planes

    # the wavefront walk at 5b's widest round
    B, K, W, C, l_pad, cap, s_cap = 36, 4096, 1024, 256, 131072, 2048, 4096
    pairs = batch(*oriented_pairs(18, 8, 0.0025, 0.0001), B, l_pad, dev)
    init = TW.wf_init(*pairs, pen, K)
    ck, _, done, scores = TW.wf_span(*pairs, pen, K, l_pad, 0, s_cap, init.seeds, False,
                                     ckpt_every=C, done=init.done0, scores=init.scores0)
    top = (int(scores[done].max()) - 1) // C
    walk = TW.new_walk(torch.where(done, scores, -1), init.c_end, pairs[3], done)
    c_lo = TS.narrow_offsets(walk[1], K, W)
    _, hist, _, _ = TW.wf_span(*pairs, pen, K, l_pad, top * C, C, ck[top], True, c_lo=c_lo, k_sub=W)
    entry = (walk, TW.new_bufs(B, cap, dev))
    stats = "stats" in inspect.signature(TW.wf_traceback).parameters
    r = time_walk(lambda w, b, **kw: TW.wf_traceback(hist, ck[top], top * C, w, b, pen, c_lo=c_lo,
                                                     **kw), entry, args.reps, stats)
    print(json.dumps({"walk": "wf_traceback", "B": B, "K": K, "k_sub": W, "n_steps": C,
                      "s_lo": top * C, "done": int(done.sum()), "run_cap": cap,
                      "reps": args.reps, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
