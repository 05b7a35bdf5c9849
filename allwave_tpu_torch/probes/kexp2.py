"""x2: the cost of one roll, add, select and min.

Port of scripts/experiments/kexp2.py (`make`; its pallas_call): an op
chain applied STEPS times per grid step to a (TB, K) = (64, 128) int32
tile, over TILES grid steps. The TPU grid runs in order and carries the
tile in scratch from one grid step to the next, so the function is the
chain applied TILES * STEPS times. One step is, in order:

    n_rolls x  a = roll(a, 1, axis)         (a cyclic rotation by one)
    n_adds  x  a = a + (i + 1)              for i = 0 .. n_adds - 1
    n_sels  x  a = where(a > 0, a, i)       for i = 0 .. n_sels - 1
    n_mins  x  a = min(a, 2**29 - i)        for i = 0 .. n_mins - 1

On Hopper (csrc/probe_ops.cu) the tile's lines along the roll axis are
128 elements, E adjacent ones a thread (its `seg_elems`: 32 where
rolls x unroll is a multiple of 32, else 8), so a line spans 128 / E
threads of a warp and a roll is one `__shfl_sync` for each segment a
thread holds, its other elements renamed. The renaming is free where it
comes back to the identity at the step loop's back edge; elsewhere
(x2's 4r case) registers are moved there. Every roll still moves data. The ops are volatile inline PTX, so the compiler can drop none of
them nor fold a chain of selects or mins; ptxas still merges two
constant adds into one three-input IADD3. `copies` blocks each run the
whole chain on their own copy of the tile (copies = 1 gives the latency
of the chain, copies = 132 k fills the card); every copy equals the
plain output. This module also holds the launcher kexp3 (x3) uses.
"""

from __future__ import annotations

import torch

from ..wfa.dense import LaunchCount

TB, K, STEPS, TILES = 64, 128, 2048, 32

#: kexp2.py:59-69: (name, rolls, adds, selects, mins)
CASES = [
    ("0r 8a 0s 0m", 0, 8, 0, 0),
    ("0r 16a 0s 0m", 0, 16, 0, 0),
    ("0r 32a 0s 0m", 0, 32, 0, 0),
    ("8r 0a 0s 0m", 8, 0, 0, 0),
    ("4r 0a 0s 0m", 4, 0, 0, 0),
    ("8r 8a 8s 8m", 8, 8, 8, 8),
    ("0r 8a 8s 8m", 0, 8, 8, 8),
    ("0r 0a 16s 0m", 0, 0, 16, 0),
    ("0r 0a 0s 16m", 0, 0, 0, 16),
]

LINE = 128

#: one launch per chain call (x2, x3)
ops_launches = LaunchCount()


def inputs(shape=(TB, K), seed: int = 0, rng=None):
    """kexp2.py's input: a (TB, K) int32 tile of 1..99."""
    import numpy as np

    rng = rng or np.random.RandomState(seed)
    return rng.randint(1, 100, shape).astype(np.int32)


def chain_ref(x, n_steps: int, rolls: int, adds: int, sels: int, mins: int, axis: int = 1):
    """Plain version: the chain applied n_steps times to x (R, C) int32."""
    a = x.clone()
    for _ in range(n_steps):
        for _ in range(rolls):
            a = torch.roll(a, 1, axis)
        for i in range(adds):
            a = a + (i + 1)
        for i in range(sels):
            a = torch.where(a > 0, a, i)
        for i in range(mins):
            a = a.clamp(max=2**29 - i)
    return a


def ops_per_step(rolls: int, adds: int, sels: int, mins: int) -> float:
    """int32 instruction slots of the ALU pipe (the int32 rate's 64 lanes an
    SM) one element needs a step at least. A select is two instructions
    (ISETP, SEL) and a min one (VIMNMX), on the ALU pipe only. An add can
    go to the ALU pipe, two at a time as one three-input IADD3, or to the
    FMA pipe as an IMAD, one at a time: with x IADD3 and adds - 2x IMAD
    the least is max(alu + x, adds - 2x), at its best max(alu, (2 alu +
    adds) / 3). A roll moves data and does no arithmetic. (ptxas emits
    this chain's adds as IADD3 only, two adds each, and no IMAD: see
    `python -m allwave_tpu_torch.probes.sass`.)"""
    alu = 2 * sels + mins
    return max(alu, (2 * alu + adds) / 3)


def work(x_shape, n_steps: int, rolls: int, adds: int, sels: int, mins: int, copies: int = 1):
    """(int32 ops, bytes) one call needs: every copy's chain, the tile
    read once and every copy written once."""
    n = x_shape[0] * x_shape[1]
    return copies * n * n_steps * ops_per_step(rolls, adds, sels, mins), 4 * n * (1 + copies)


def chain(x, n_steps: int, rolls: int, adds: int, sels: int, mins: int, axis: int = 1,
          unroll: int = 1, copies: int = 1):
    """The chain applied n_steps times to x (R, C) int32, for `copies`
    copies: (copies, R, C). The plain version for a CPU tensor, the
    csrc/probe_ops.cu kernel (one block a copy) for a CUDA tensor."""
    if x.device.type == "cpu":
        out = chain_ref(x, n_steps, rolls, adds, sels, mins, axis)
        return out[None].expand(copies, *out.shape).clone()
    from ..wfa import cuda_build

    if x.dtype != torch.int32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"x: expected a contiguous 2-d int32 tensor, got {x.dtype} {tuple(x.shape)}")
    if x.shape[axis] != LINE:
        raise ValueError(f"the roll axis must be {LINE} long, got {tuple(x.shape)} axis {axis}")
    lines = x.shape[1 - axis]
    key = (lines, rolls, adds, sels, mins, unroll)
    if n_steps % unroll:
        raise ValueError(f"n_steps {n_steps} is not a multiple of unroll {unroll}")
    out = torch.empty((copies, *x.shape), dtype=torch.int32, device=x.device)
    lib = cuda_build.library("probe_ops")
    rc = lib.allwave_probe_ops(
        x.data_ptr(), out.data_ptr(), copies, lines, rolls, adds, sels, mins, unroll, axis,
        x.shape[1], n_steps // unroll, torch.cuda.current_stream(x.device).cuda_stream,
    )
    cuda_build.check(rc, f"probe_ops chain (lines, rolls, adds, selects, mins, unroll) {key}"
                         " (csrc/probe_ops.cu instantiates kexp2's and kexp3's cases)")
    ops_launches.launched((copies, lines, n_steps, key))
    return out


def run(case: str, x, steps: int = STEPS, tiles: int = TILES, copies: int = 1):
    """One kexp2 case: its chain applied tiles * steps times."""
    _, r, a, s, m = next(c for c in CASES if c[0] == case)
    return chain(x, steps * tiles, r, a, s, m, copies=copies)
