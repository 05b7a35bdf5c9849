"""The fuzz's generator (reference: scripts/fuzz_tpu.py), draw for draw.

Each function takes a numpy RandomState and makes the same draws, in the
same order, as the reference's script does at the place named, so one
seed gives the same cases in both:

* `phase1_case`: a random penalty set (`rand_params`: edit distance,
  single-piece or two-piece affine) and 1-5 pairs of 12-2200 bases in
  four styles: identical, SNPs with `ACGTacgtNn` noise and indels,
  unrelated, tandem repeats (`fuzz_tpu.py:26-52`);
* `phase2_batch`: four long pairs (10-100 kb) at 0.1-1% divergence, a
  third of them tandem repeats with homopolymer runs, and their score
  hints (`fuzz_tpu.py:113-145`);
* `tie_rich_batch`: the mutation check's pairs, tandem repeats and
  homopolymers at 0.4% with small indels, and their hints
  (`fuzz_tpu.py:186-230`).

One difference, in the values and not in the draws: the reference builds
its edit-distance and single-piece sets as `AlignmentParams(0, x, x, x)`
and `AlignmentParams(0, x, go, ge)`, which keep the dataclass's default
second piece (24, 1), so every set it draws is two-piece. Here those two
modes build the sets they name (no second piece).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..core.types import AlignmentParams

#: names this generator's draws and values; an artifact's case counts add
#: up only over runs of one seed and one revision
GENERATOR_REV = "fuzz_tpu.py/port-1"

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
NOISY = np.frombuffer(b"ACGTacgtNn", dtype=np.uint8)

#: phase 2's penalty sets (`fuzz_tpu.py:93-97`): the production scores,
#: another two-piece set and a single-piece one
WF_PARAMS = (
    AlignmentParams(0, 5, 8, 2, 24, 1),
    AlignmentParams(0, 4, 6, 2, 18, 1),
    AlignmentParams(0, 5, 8, 2, None, None),
)
#: phase 2's pair lengths
WF_LENGTHS = (10_000, 25_000, 60_000, 100_000)


def rand_params(rng) -> AlignmentParams:
    """An edit-distance, single-piece or two-piece set (`fuzz_tpu.py:27-33`)."""
    mode = rng.randint(3)
    x = int(rng.randint(1, 9))
    if mode == 0:
        return AlignmentParams(0, x, x, x, None, None)
    if mode == 1:
        return AlignmentParams(0, x, int(rng.randint(1, 30)), int(rng.randint(1, 6)), None, None)
    go, ge = int(rng.randint(1, 30)), int(rng.randint(1, 6))
    return AlignmentParams(0, x, go, ge, int(rng.randint(go, 60)), max(1, ge - rng.randint(0, ge)))


def _indel(rng, t, max_len: int):
    """Delete or insert (random bases) a run of 1 .. max_len - 1 at a
    random place."""
    p = rng.randint(0, max(1, len(t)))
    ln = rng.randint(1, max_len)
    if rng.rand() < 0.5:
        return np.concatenate([t[:p], t[p + ln:]])
    return np.concatenate([t[:p], rng.choice(ACGT, ln), t[p:]])


def _homopolymers(rng, q, n: int):
    """q with n runs of 5-39 copies of one of its bases inserted."""
    for _ in range(n):
        p = rng.randint(0, len(q))
        q = np.concatenate([q[:p], np.full(rng.randint(5, 40), q[p % len(q)], np.uint8), q[p:]])
    return q


def phase1_case(rng) -> Tuple[AlignmentParams, List[Tuple[bytes, bytes]]]:
    """One iteration of phase 1: a penalty set and its 1-5 pairs
    (`fuzz_tpu.py:26-52`)."""
    params = rand_params(rng)
    pairs = []
    for _ in range(int(rng.randint(1, 6))):
        L = int(rng.choice([12, 60, 300, 900, 2200]))
        q = rng.choice(ACGT, L)
        st = rng.randint(4)
        if st == 0:
            t = q.copy()
        elif st == 1:
            t = q.copy()
            mut = rng.rand(L) < rng.choice([0.01, 0.06, 0.25])
            t[mut] = rng.choice(NOISY, mut.sum())
            for _ in range(rng.randint(0, 4)):
                t = _indel(rng, t, 25)
        elif st == 2:
            t = rng.choice(ACGT, int(rng.randint(1, L + 30)))
        else:
            unit = rng.choice(ACGT, rng.randint(1, 6))
            t = np.tile(unit, L // len(unit) + 1)[:L]
            q = np.tile(unit, (L + 15) // len(unit) + 1)[: L + rng.randint(-8, 15)]
        pairs.append((q.tobytes(), t.tobytes()))
    return params, pairs


def phase2_batch(rng, x: int, lengths=WF_LENGTHS):
    """Phase 2's batch: four pairs of one length drawn from `lengths` and
    their score hints for mismatch penalty x (`fuzz_tpu.py:113-145`).
    Returns (L, pairs, hints)."""
    L = int(rng.choice(list(lengths)))
    pairs, hints = [], []
    for _ in range(4):
        if rng.randint(3) == 2:  # tie stress: tandem repeats + homopolymer stretches
            unit = rng.choice(ACGT, rng.randint(1, 7))
            q = np.tile(unit, L // len(unit) + 1)[:L]
            q = _homopolymers(rng, q, rng.randint(0, 4))
        else:
            q = rng.choice(ACGT, L)
        div = float(rng.choice([0.001, 0.0025, 0.005, 0.01]))
        t = q.copy()
        mut = rng.rand(len(t)) < div
        t[mut] = rng.choice(ACGT, mut.sum())
        for _ in range(rng.randint(0, 4)):
            t = _indel(rng, t, 20)
        pairs.append((q.tobytes(), t.tobytes()))
        hints.append(int(div * len(q) * x * 1.5 + 64))
    return L, pairs, hints


def tie_rich_batch(rng, L: int = 20_000, n: int = 8):
    """The mutation check's pairs: tandem repeats of a 2-6 base unit with
    three homopolymer runs, the target at 0.4% SNPs and three small
    indels, and their hints (`fuzz_tpu.py:204-227`). X-vs-I1 ties in the
    walk need repeat structure: plain-SNP pairs showed no flipped
    mismatch on the reference's TPU runs. Returns (pairs, hints)."""
    pairs, hints = [], []
    for _ in range(n):
        unit = rng.choice(ACGT, rng.randint(2, 7))
        q = np.tile(unit, L // len(unit) + 1)[:L]
        q = _homopolymers(rng, q, 3)
        t = q.copy()
        mut = rng.rand(len(t)) < 0.004
        t[mut] = rng.choice(ACGT, mut.sum())
        for _ in range(3):
            t = _indel(rng, t, 20)
        pairs.append((q.tobytes(), t.tobytes()))
        hints.append(int(0.004 * len(q) * 5 * 1.5 + 256))
    return pairs, hints
