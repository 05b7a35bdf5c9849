"""The step probes (x4-x6, csrc/probe_step.cu), every variant timed
alone at its experiment's own shape.

* x4 (kexp6 v0-v4): TB = 8, K = 1536, W = 256, 4096 steps;
* x5 (kexp7 g0-g10): TB = 16, K = 1536, W = 256, 4096 steps in 1-128
  launches;
* x6 (kexp8 p0-p3): TB = 16, K = 2048, W = 128, 4096 steps.

Each variant is timed over `--reps` calls after a warm-up (CUDA
events), the calls queued while the card sleeps, so they run back to
back and only the card is timed (x5's launches a chunk included).
Prints one JSON object a line: the card's name and power limit, then
one line a variant with its mean ms, ns a step, the kernel it launched
(where the tree's launch count records it) and a digest of its outputs
after one call (the S band, x5's dummy, x6's planes: two trees that
agree give one digest).

    python allwave_tpu_torch/probes/step_split.py [--root DIR] [--reps N]

`--root DIR` imports the package from DIR instead of this tree, for
example from an older commit unpacked with `git archive`, so that two
versions of the kernels can be timed on one card in one call (parent,
change, change, parent). It needs a CUDA card; the kernels are built at
first use.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

#: the card's sleep before a timed run of launches, in clock cycles
#: (~25 ms at least), and at least this many times the host's time to
#: queue them (x5 queues 128 launches a call) at the H100's top SM
#: clock (a slower clock sleeps longer)
SLEEP_CYCLES = 50_000_000
SLEEP_OVER_HOST = 2.0
CLOCK_HZ = 1.98e9


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def _digest(outs) -> str:
    h = hashlib.sha256()
    for t in outs:
        if t is not None:
            h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _time(fn, reps: int) -> float:
    """Mean ms of fn() over reps back-to-back calls (CUDA events), after
    one call; the card sleeps while the host queues them."""
    import time

    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(max(SLEEP_CYCLES, int(SLEEP_OVER_HOST * host_s * reps * CLOCK_HZ)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _flat(out):
    """An x4 (tensor), x5 (S, dummy) or x6 (S, planes) output as a list
    of tensors."""
    if not isinstance(out, tuple):
        return [out]
    s, rest = out
    return [s] + (list(rest) if isinstance(rest, tuple) else [rest])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=None, help="import the package from this tree")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root or os.path.join(os.path.dirname(__file__), "..", ".."))
    sys.path.insert(0, root)

    import numpy as np
    import torch

    import allwave_tpu_torch

    if not os.path.abspath(allwave_tpu_torch.__file__).startswith(root + os.sep):
        raise SystemExit(f"the package came from {allwave_tpu_torch.__file__}, not {root}: "
                         "run this file by its path to time another tree")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    from allwave_tpu_torch.probes import kexp6 as K6
    from allwave_tpu_torch.probes import kexp7 as K7
    from allwave_tpu_torch.probes import kexp8 as K8

    dev = torch.device("cuda", 0)
    print(json.dumps({"card": _card(), "root": root}), flush=True)
    probes = (
        ("x4", K6, list(K6.VARIANTS), lambda v, a: K6.sweep(v, *a, K6.NSTEPS, K6.W)),
        ("x5", K7, list(K7.VARIANTS), lambda v, a: K7.run(v, *a, K7.NSTEPS, K7.W)),
        ("x6", K8, list(K8.MODES), lambda v, a: K8.run(v, *a, K8.NSTEPS, K8.W)),
    )
    for row, mod, variants, call in probes:
        inputs = tuple(torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                       for x in K6.inputs(mod.TB, mod.K))
        for v in variants:
            K6.step_launches.reset()
            digest = _digest(_flat(call(v, inputs)))
            designs = getattr(K6.step_launches, "designs", {})
            kernel = next(iter(designs.values()), None)
            ms = _time(lambda: call(v, inputs), args.reps)
            print(json.dumps({"probe": row, "variant": v, "TB": mod.TB, "K": mod.K, "W": mod.W,
                              "n_steps": mod.NSTEPS, "reps": args.reps, "ms": ms,
                              "ns_per_step": ms * 1e6 / mod.NSTEPS, "kernel": kernel,
                              "digest": digest}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
