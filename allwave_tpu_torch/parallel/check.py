"""Check the multi-GPU dispatch on this host:

    python -m allwave_tpu_torch.parallel.check

On bench.py's headline data (128 x 1 kb at 2%, seed 1234, scores
0,5,8,2,24,1) it holds `mesh.sharded_dense_step` over every visible GPU
to one launch on the first, at the headline's dispatch shape (B 4093,
an uneven split on most hosts; K 192, l_pad 1024, run cap 128), and the
pipeline with its dispatches fanned over them to the same run with
ALLWAVE_SINGLE_DEVICE=1 (sorted PAF lines), each pipeline run timed
warm. Prints one JSON line, then the cards' names and power limits;
exits non-zero without a GPU or on any difference.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from ..core.scores import parse_scores
from ..testing.synth import MutationConfig, make_test_case
from ..wfa import dense as D_
from ..wfa.params import resolve_penalties
from .mesh import local_devices, sharded_dense_step

SCORES = "0,5,8,2,24,1"


def headline():
    return make_test_case(1234, 128, 1000, MutationConfig(0.02, 0.0005, 0.0005)).sequences


def dispatch_inputs(seqs, device, B: int, l_pad: int = 1024):
    """The pool of `seqs` and their first B ordered pairs (i != j), as
    one dense dispatch takes them, on `device`."""
    n = len(seqs)
    pool = np.zeros((n, l_pad), np.uint8)
    lens = np.zeros(n, np.int32)
    for i, s in enumerate(seqs):
        pool[i, : len(s.seq)] = np.frombuffer(s.seq, np.uint8)
        lens[i] = len(s.seq)
    pairs = np.array([(i, j) for i in range(n) for j in range(n) if i != j][:B])
    return [
        torch.from_numpy(a).to(device)
        for a in (pool, pairs[:, 0], pairs[:, 1], lens[pairs[:, 0]], lens[pairs[:, 1]])
    ]


def sharded_matches_single(devices, inputs, K: int = 192, l_pad: int = 1024, cap: int = 128):
    """True iff the sharded step over `devices` gives one launch's bytes."""
    pen = resolve_penalties(parse_scores(SCORES))
    single = D_.dense_align_packed(*inputs, pen, K, l_pad, cap)
    got = sharded_dense_step(devices, pen, K, l_pad, cap)(*inputs)
    if devices[0].type == "cuda":
        torch.cuda.synchronize()
    return torch.equal(got, single)


def _pipeline_lines(seqs):
    from ..core.paf import alignment_to_paf
    from ..engine.pipeline import AllPairAligner

    out = []
    al = AllPairAligner(seqs, parse_scores(SCORES), use_mash_orientation=True)
    t0 = time.perf_counter()
    al.for_each_with_callback(out.append)
    torch.cuda.synchronize()
    return sorted(alignment_to_paf(r, seqs) for r in out), time.perf_counter() - t0


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 2
    os.environ["ALLWAVE_PLATFORM"] = "cuda"
    devices = local_devices("cuda")
    seqs = headline()
    same = sharded_matches_single(devices, dispatch_inputs(seqs, devices[0], 4093))
    _pipeline_lines(seqs)  # the kernels' and orientation's first use
    runs = {}
    for mode in ("mesh", "single", "single", "mesh"):
        os.environ["ALLWAVE_SINGLE_DEVICE"] = "1" if mode == "single" else "0"
        lines, seconds = _pipeline_lines(seqs)
        runs.setdefault(mode, []).append((lines, seconds))
    equal = all(r[0] == runs["single"][0][0] for rs in runs.values() for r in rs)
    print(json.dumps({
        "gpus": len(devices), "sharded_identical": same, "paf_equal": equal,
        "lines": len(runs["single"][0][0]),
        "mesh_s": [r[1] for r in runs["mesh"]], "single_s": [r[1] for r in runs["single"]],
    }))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip())
    return 0 if same and equal else 1


if __name__ == "__main__":
    sys.exit(main())
