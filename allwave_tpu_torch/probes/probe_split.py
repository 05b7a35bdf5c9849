"""The forward and op-chain probes (x1-x3: csrc/probe_forward.cu,
csrc/probe_ops.cu), every variant and case timed alone.

* x1 (kexp V1-V3, and V0, the engine's forward csrc/dense_forward.cu on
  the same pairs): at kexp.py's own shape (B = 2048 pairs of 500-1000
  bases, l_pad = 1024, K = 128) and the headline's band round (B = 4096,
  K = 192), `runner.X1_KEXP` and `runner.X1_HEADLINE`;
* x2 (kexp2, nine cases) and x3 (kexp3, nine cases): 65,536 steps of
  the chain on the filled card (`runner.FILL_PER_SM` blocks an SM).

Each is timed over `--reps` calls after a warm-up (CUDA events), the
calls queued while the card sleeps, so they run back to back and only
the card is timed. Prints one JSON object a line: the card's name and
power limit, then one line a variant with its mean ms, its bound (the
larger of its int32 operations over the card's int32 rate and its
bytes over HBM's, `runner.bound`), its share of the bound and a digest
of its outputs after one call (scores, certificates and the plane's
sums over the batch; every copy of a chain): two trees that agree give
one digest.

    python allwave_tpu_torch/probes/probe_split.py [--root DIR] [--reps N]

`--root DIR` imports the package from DIR instead of this tree, for
example from an older commit unpacked with `git archive`, so that two
versions of the kernels can be timed on one card in one call (parent,
change, change, parent). It needs a CUDA card; the kernels are built at
first use.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=None, help="import the package from this tree")
    ap.add_argument("--reps", type=int, default=10)
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
    from allwave_tpu_torch.probes import kexp as K1
    from allwave_tpu_torch.probes import kexp2 as K2
    from allwave_tpu_torch.probes import kexp3 as K3
    from allwave_tpu_torch.probes import runner as PR
    from allwave_tpu_torch.probes.step_split import _card, _digest, _time
    from allwave_tpu_torch.wfa import dense as D

    def x1_digest(out):
        """Scores, certificates and, for a plane (2 l_pad, B, K), its
        sums over the batch at each step and lane (summed on the card)."""
        s, c, p = out
        sums = None if p is None else p.view(torch.int16).sum(dim=1, dtype=torch.int32)
        return _digest([s, c.to(torch.uint8), sums])

    dev = torch.device("cuda", 0)
    ops_s = PR.int32_ops_s(dev)
    print(json.dumps({"card": _card(), "root": root}), flush=True)

    def emit(row, variant, shape, call, digest, work):
        d = digest(call())
        ms = _time(call, args.reps)
        b_ms, by = PR.bound(*work, ops_s)
        print(json.dumps({"probe": row, "variant": variant, **shape, "reps": args.reps, "ms": ms,
                          "bound_ms": b_ms, "bound_by": by, "share_of_bound": b_ms / ms,
                          "digest": d}), flush=True)

    pen = PR._pen()
    for B, L, l_pad, K in (PR.X1_KEXP, PR.X1_HEADLINE):
        qs, ts, ql, tl = PR._x1_inputs(dev, B, L, l_pad)
        shape = {"B": B, "l_pad": l_pad, "K": K}
        qc, tc = ql.cpu(), tl.cpu()
        emit("x1", "V0", shape, lambda: D.dense_forward(qs, ts, ql, tl, pen, K, l_pad),
             x1_digest, K1.work("V1", qc, tc, K, l_pad))
        for v in K1.VARIANTS:
            emit("x1", v, shape, lambda: K1.forward(v, qs, ts, ql, tl, pen, K, l_pad),
                 x1_digest, K1.work(v, qc, tc, K, l_pad))
        del qs, ts
        torch.cuda.empty_cache()
    steps = K2.STEPS * K2.TILES
    copies = PR.FILL_PER_SM * torch.cuda.get_device_properties(dev).multi_processor_count
    x = PR._t(K2.inputs(), dev)
    for name, r, a, s, m in K2.CASES:
        emit("x2", name, {"shape": list(x.shape), "copies": copies, "n_steps": steps},
             lambda: K2.chain(x, steps, r, a, s, m, copies=copies), lambda o: _digest([o]),
             K2.work(x.shape, steps, r, a, s, m, copies))
    xs = {n: PR._t(v, dev) for n, v in K3.inputs().items()}
    for name, shape, axis, r, a, u in K3.CASES:
        emit("x3", name, {"shape": list(shape), "copies": copies, "n_steps": steps},
             lambda: K2.chain(xs[name], steps, r, a, 0, 0, axis=axis, unroll=u,
                              copies=copies),
             lambda o: _digest([o]), K3.work(name, steps, copies))
    return 0


if __name__ == "__main__":
    sys.exit(main())
