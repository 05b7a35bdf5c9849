"""x3: rolls along either axis, and the unroll factor.

Port of scripts/experiments/kexp3.py (`make`; its pallas_call): kexp2's
op chain (here n rolls then n adds a step) on tiles of (64, 128),
(128, 64) and (128, 128) int32, rolled along axis 1 (the TPU's lanes)
or axis 0 (its sublanes), with the step loop unrolled 1, 4 or 8 times.
The function is the chain applied TILES * STEPS times, whatever the
unroll. On Hopper (csrc/probe_ops.cu, see kexp2) the tile is laid out
so that the lines along the roll axis are what a warp holds, so a roll
along axis 0 costs what one along axis 1 does: one shuffle for each
segment of a line a thread holds (8 elements, or 32 where 8 x unroll
is a multiple of 32).
"""

from __future__ import annotations

from . import kexp2

STEPS, TILES = 2048, 32

#: kexp3.py:56-67: (name, shape, axis, rolls, adds, unroll)
CASES = [
    ("lane  (64,128) 8r u1", (64, 128), 1, 8, 8, 1),
    ("subl  (128,64) 8r u1", (128, 64), 0, 8, 8, 1),
    ("subl (128,128) 8r u1", (128, 128), 0, 8, 8, 1),
    ("lane  (64,128) 8r u4", (64, 128), 1, 8, 8, 4),
    ("subl (128,128) 8r u4", (128, 128), 0, 8, 8, 4),
    ("subl (128,128) 8r u8", (128, 128), 0, 8, 8, 8),
    ("lane  (64,128) 0r u4", (64, 128), 1, 0, 8, 4),
    ("lane  (64,128) 0r u8", (64, 128), 1, 0, 8, 8),
    ("subl (128,128) 0r u1", (128, 128), 0, 0, 8, 1),
]


def case(name: str):
    return next(c for c in CASES if c[0] == name)


def inputs(seed: int = 0):
    """kexp3.py's inputs: one tile of 1..99 per case, in case order
    from one RandomState(seed), as its main() draws them."""
    import numpy as np

    rng = np.random.RandomState(seed)
    return {name: kexp2.inputs(shape, rng=rng) for name, shape, *_ in CASES}


def work(name: str, n_steps: int, copies: int = 1):
    _, shape, _, r, a, _ = case(name)
    return kexp2.work(shape, n_steps, r, a, 0, 0, copies)


def run(name: str, x, steps: int = STEPS, tiles: int = TILES, copies: int = 1):
    """One kexp3 case: (copies, *shape) int32."""
    _, shape, axis, r, a, u = case(name)
    return kexp2.chain(x, steps * tiles, r, a, 0, 0, axis=axis, unroll=u, copies=copies)
