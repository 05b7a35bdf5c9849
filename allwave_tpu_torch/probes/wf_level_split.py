"""The wavefront sweep's time a level on three inputs of one shape.

The sweep kernel (csrc/wf_span.cu) at bench config 5b_100kb_lowdiv's
widest round (B = 36 pairs, band K = 4096, l_pad = 131072, a checkpoint
every 256 levels, 2048 levels) on three inputs of that shape:

* `5b`: the 5b pairs as the pipeline orients them (8 x 100 kb at 0.25%
  divergence, seed 18), shortest first, repeated to fill B;
* `tandem_repeat`: (AC)^n at the same lengths, the target with 0.25%
  SNPs, so every lane the wavefront reaches on an even diagonal extends
  to the next SNP, hundreds of bases, at every level;
* `random`: random pairs of the same lengths, where every extension
  stops within its first 8 bases.

The rings, the slots and the barrier are the same work on all three, so
the differences in time a level are the extension's. Prints one JSON
object a line: the card's name and power limit, then one line an input
with its mean ms over `--reps` calls after a warm-up (CUDA events), the
levels run, the µs a level, and a digest of its scores, done and every
checkpoint slot (two trees that agree give one digest).

    python allwave_tpu_torch/probes/wf_level_split.py [--root DIR]

`--root DIR` imports the package from DIR instead of this tree, for
example from an older commit unpacked with `git archive`, so that two
versions of the kernel can be timed on one card in one call. It needs a
CUDA card; the kernel is built at first use.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

SCORES = "0,5,8,2,24,1"


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def pairs_5b():
    """The 5b pairs as the pipeline orients them: (pool, qidx, tidx)."""
    from allwave_tpu_torch.core.scores import parse_scores
    from allwave_tpu_torch.engine.pipeline import AllPairAligner
    from allwave_tpu_torch.testing.synth import MutationConfig, make_test_case

    seqs = make_test_case(18, 8, 100_000, MutationConfig(0.0025, 0.0001, 0.0001)).sequences
    apa = AllPairAligner(seqs, parse_scores(SCORES), exclude_self=True, use_mash_orientation=True)
    pool, qi, ti, _, _ = apa._orient_chunk(apa.get_pairs())
    return pool, qi, ti


def batch(pool, qi, ti, B: int, l_pad: int, make, dev):
    """B of the pairs (pool[qi[j]], pool[ti[j]]) (shortest first,
    repeated to fill B) on the card, or, with make(rng, qlen, tlen) ->
    (q, t), pairs of their lengths made from a seed."""
    import numpy as np
    import torch

    order = np.argsort([len(pool[q]) + len(pool[t]) for q, t in zip(qi, ti)], kind="stable")
    rows = [int(order[j % len(order)]) for j in range(B)]
    lens = [(len(pool[qi[j]]), len(pool[ti[j]])) for j in rows]
    qs = torch.zeros((B, l_pad), dtype=torch.uint8)
    ts = torch.zeros((B, l_pad), dtype=torch.uint8)
    rng = np.random.RandomState(15)
    for b, (j, (lq, lt)) in enumerate(zip(rows, lens)):
        q, t = (pool[qi[j]], pool[ti[j]]) if make is None else make(rng, lq, lt)
        qs[b, :lq] = torch.frombuffer(bytearray(q), dtype=torch.uint8)
        ts[b, :lt] = torch.frombuffer(bytearray(t), dtype=torch.uint8)
    ql, tl = (torch.tensor(x, dtype=torch.int32) for x in zip(*lens))
    return tuple(x.to(dev) for x in (qs, ts, ql, tl))


def repeat_pair(rng, lq, lt):
    """(AC)^n at lengths lq and lt, the target with 0.25% SNPs to G or T:
    every other diagonal matches between SNPs."""
    import numpy as np

    q = np.resize(np.frombuffer(b"AC", dtype=np.uint8), lq)
    t = np.resize(np.frombuffer(b"AC", dtype=np.uint8), lt).copy()
    snp = rng.rand(lt) < 0.0025
    t[snp] = rng.choice(np.frombuffer(b"GT", dtype=np.uint8), int(snp.sum()))
    return q.tobytes(), t.tobytes()


def random_pair(rng, lq, lt):
    """Random bases at lengths lq and lt: no run longer than a few bases."""
    import numpy as np

    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    return rng.choice(bases, lq).tobytes(), rng.choice(bases, lt).tobytes()


#: the split's inputs: name, and how a pair of given lengths is made
#: (None: the 5b pairs themselves)
INPUTS = (("5b", None), ("tandem_repeat", repeat_pair), ("random", random_pair))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=None, help="import the package from this tree")
    ap.add_argument("--B", type=int, default=36)
    ap.add_argument("--K", type=int, default=4096)
    ap.add_argument("--l-pad", type=int, default=131072)
    ap.add_argument("--levels", type=int, default=2048)
    ap.add_argument("--ckpt-every", type=int, default=256)
    ap.add_argument("--reps", type=int, default=3)
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
    from allwave_tpu_torch.wfa import wf_segmented as TW
    from allwave_tpu_torch.wfa.params import resolve_penalties

    dev = torch.device("cuda", 0)
    pen = resolve_penalties(parse_scores(SCORES))
    print(json.dumps({"card": _card(), "root": root}), flush=True)
    pool, qi, ti = pairs_5b()
    for name, make in INPUTS:
        pairs = batch(pool, qi, ti, args.B, args.l_pad, make, dev)
        init = TW.wf_init(*pairs, pen, args.K)

        def sweep():
            return TW.wf_span(*pairs, pen, args.K, args.l_pad, 0, args.levels, init.seeds, False,
                              ckpt_every=args.ckpt_every, done=init.done0, scores=init.scores0)

        ck, _, done, scores = sweep()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            sweep()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / args.reps
        levels = int(torch.where(done, scores, args.levels).max())
        digest = hashlib.sha256()
        for x in (scores, done, ck):
            digest.update(x.cpu().numpy().tobytes())
        print(json.dumps({
            "input": name, "B": args.B, "K": args.K, "l_pad": args.l_pad,
            "n_steps": args.levels, "ckpt_every": args.ckpt_every, "reps": args.reps,
            "ms": ms, "levels_run": levels, "us_per_level": 1e3 * ms / max(levels, 1),
            "done": int(done.sum()), "digest": digest.hexdigest()[:16],
        }), flush=True)
        del ck
    return 0


if __name__ == "__main__":
    sys.exit(main())
