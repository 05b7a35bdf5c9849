"""Hopper probes of the dense engines' anti-diagonal step.

Ports of the TPU timing experiments in scripts/experiments (each a
function that reaches `pl.pallas_call`) as hand-written CUDA kernels,
each beside its plain PyTorch version:

* `kexp6` (x4): the score-only 5-band two-piece Gotoh step over 4096
  anti-diagonals, bands in shared memory (v0) or in registers with
  warp shuffles (v1-v3, unroll 2/4/8), or two problems interleaved
  (v4). The step itself is defined here once and shared by x5 and x6.
* `kexp7` (x5): the same step split into chunks, one launch a chunk,
  the state round-tripping through device memory (g0-g9), or one
  launch looping over the chunks (g10).
* `kexp8` (x6): the step with choices and match-run lengths, storing
  the traceback plane in four formats (p0-p3).
* `kexp2` (x2) and `kexp3` (x3): an op chain (rolls, adds, selects,
  mins) applied to one int32 tile, for the cost of one op of each kind.
* `kexp` (x1): the dense forward sweep with its bands in registers
  (V1), with per-lane enter/leave thresholds (V2), and without the
  plane store (V3).

No production path runs these kernels. `python -m
allwave_tpu_torch.probes` (`runner.py`) checks each against its plain
version and times it at the experiment's own size on the card, beside
its bound. Like the engines' wrappers, each probe's wrapper runs the
plain version for CPU tensors and launches the kernel (or raises) for
CUDA tensors, and counts its launches.

`wf_level_split` is no experiment's port: it times the wavefront sweep
kernel of csrc/wf_span.cu a level on three inputs of one shape, from
this tree or another (a before and after on one card).
"""
