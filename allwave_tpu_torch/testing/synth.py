"""Seeded synthetic test-data generator.

Same capability surface as the reference's test scaffolding
(/root/reference/src/test_framework.rs:78-317): random DNA with a target
GC content plus a mutation engine producing SNPs, small indels (<=10 bp),
microsatellite expansions/contractions, and large CNV-scale duplications
or deletions, all with recorded ground truth. Fresh implementation on
numpy's seeded RandomState (the reference's StdRng streams are not part
of its observable behavior).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..core.types import Sequence

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


@dataclass
class Mutation:
    kind: str  # snp | insertion | deletion | microsat | cnv_dup | cnv_del
    position: int  # position in the ORIGINAL sequence
    length: int
    detail: str = ""


def random_dna(rng: np.random.RandomState, length: int, gc: float = 0.5) -> bytes:
    """Random sequence with expected GC fraction ``gc``."""
    p_gc = gc / 2.0
    p_at = (1.0 - gc) / 2.0
    return rng.choice(_BASES, size=length, p=[p_at, p_gc, p_gc, p_at]).tobytes()


@dataclass
class MutationConfig:
    snp_rate: float = 0.0
    insertion_rate: float = 0.0
    deletion_rate: float = 0.0
    max_indel: int = 10
    n_microsatellites: int = 0
    n_cnvs: int = 0
    cnv_dup_copies: Tuple[int, int] = (2, 5)
    cnv_del_len: Tuple[int, int] = (1000, 5000)


def mutate(
    rng: np.random.RandomState, seq: bytes, cfg: MutationConfig
) -> Tuple[bytes, List[Mutation]]:
    """Apply the configured mutations; returns (mutated, ground truth).

    Point mutations are applied first (positions in original coords),
    then indels/microsatellites/CNVs right-to-left so earlier positions
    stay valid — mirroring the reference's offset-tracking approach.
    """
    muts: List[Mutation] = []
    s = bytearray(seq)
    n = len(s)

    # SNPs
    n_snp = int(round(cfg.snp_rate * n))
    if n_snp:
        for pos in sorted(rng.choice(n, size=min(n_snp, n), replace=False).tolist()):
            old = s[pos]
            choices = [b for b in b"ACGT" if b != old]
            s[pos] = choices[rng.randint(0, len(choices))]
            muts.append(Mutation("snp", pos, 1))

    # structural events collected then applied right-to-left
    events: List[Tuple[int, str, dict]] = []
    n_ins = int(round(cfg.insertion_rate * n))
    for _ in range(n_ins):
        events.append(
            (
                int(rng.randint(0, n + 1)),
                "insertion",
                {"ins": random_dna(rng, int(rng.randint(1, cfg.max_indel + 1)))},
            )
        )
    n_del = int(round(cfg.deletion_rate * n))
    for _ in range(n_del):
        length = int(rng.randint(1, cfg.max_indel + 1))
        pos = int(rng.randint(0, max(n - length, 1)))
        events.append((pos, "deletion", {"len": length}))

    for _ in range(cfg.n_microsatellites):
        unit_len = int(rng.randint(1, 7))
        repeats = int(rng.randint(5, 21))
        unit = random_dna(rng, unit_len)
        pos = int(rng.randint(0, n + 1))
        if rng.randint(0, 2) == 0:  # expansion
            events.append((pos, "microsat", {"ins": unit * repeats}))
        else:  # insert a contracted copy (net indel either way)
            events.append((pos, "microsat", {"ins": unit * max(repeats // 2, 1)}))

    for _ in range(cfg.n_cnvs):
        if rng.randint(0, 2) == 0:  # duplication
            seg_len = int(rng.randint(500, 2001))
            pos = int(rng.randint(0, max(n - seg_len, 1)))
            copies = int(rng.randint(cfg.cnv_dup_copies[0], cfg.cnv_dup_copies[1] + 1))
            events.append((pos, "cnv_dup", {"seg": seg_len, "copies": copies}))
        else:  # deletion
            length = int(rng.randint(cfg.cnv_del_len[0], cfg.cnv_del_len[1] + 1))
            pos = int(rng.randint(0, max(n - length, 1)))
            events.append((pos, "cnv_del", {"len": length}))

    for pos, kind, info in sorted(events, key=lambda e: e[0], reverse=True):
        if kind in ("insertion", "microsat"):
            ins = info["ins"]
            s[pos:pos] = ins
            muts.append(Mutation(kind, pos, len(ins)))
        elif kind == "deletion":
            del s[pos : pos + info["len"]]
            muts.append(Mutation(kind, pos, info["len"]))
        elif kind == "cnv_dup":
            seg = bytes(s[pos : pos + info["seg"]])
            extra = seg * (info["copies"] - 1)
            s[pos + info["seg"] : pos + info["seg"]] = extra
            muts.append(Mutation(kind, pos, len(extra), f"copies={info['copies']}"))
        elif kind == "cnv_del":
            del s[pos : pos + info["len"]]
            muts.append(Mutation(kind, pos, info["len"]))

    return bytes(s), muts


@dataclass
class TestCase:
    """A reference sequence plus mutated derivatives with ground truth."""

    sequences: List[Sequence]
    mutations: dict  # id -> List[Mutation]

    def write_fasta(self, path: str) -> None:
        from ..engine.fasta import write_fasta

        write_fasta(path, self.sequences)


def make_test_case(
    seed: int,
    n_sequences: int,
    length: int,
    cfg: Optional[MutationConfig] = None,
    gc: float = 0.5,
    id_prefix: str = "seq",
) -> TestCase:
    """A base sequence + (n-1) mutated copies, deterministically seeded."""
    rng = np.random.RandomState(seed)
    base = random_dna(rng, length, gc)
    seqs = [Sequence(f"{id_prefix}0", base)]
    mutations = {f"{id_prefix}0": []}
    cfg = cfg or MutationConfig(snp_rate=0.01, insertion_rate=0.001, deletion_rate=0.001)
    for i in range(1, n_sequences):
        mutated, muts = mutate(rng, base, cfg)
        sid = f"{id_prefix}{i}"
        seqs.append(Sequence(sid, mutated))
        mutations[sid] = muts
    return TestCase(seqs, mutations)
