"""The traffic generator: one job's sequences from (seed, job index) and
the job's parameters (a configuration's file with its traffic mix on
top). Every job has its own ancestor; each sequence is then
reverse-complemented with probability `reverse_fraction`. The ids are
fixed (`<id_prefix><i>`), so a hash-filtered pair set is the same in
every job and every seed: seeds change the bases, not the amount of
work."""

from __future__ import annotations

from typing import List

import numpy as np

from .synth import MutationConfig, Sequence, make_test_case

_COMP = bytes.maketrans(b"ACGTacgt", b"TGCAtgca")


def job_seed(seed: int, job: int, stream: int) -> int:
    """A 32-bit seed for one random stream of one job; any whole seed,
    of any size or sign, maps to a fixed one."""
    ss = np.random.SeedSequence([seed % (1 << 64), job, stream])
    return int(ss.generate_state(1)[0])


def make_job(params: dict, seed: int, job: int) -> List[Sequence]:
    mut = MutationConfig(
        snp_rate=float(params["snp_rate"]),
        insertion_rate=float(params["insertion_rate"]),
        deletion_rate=float(params["deletion_rate"]),
        max_indel=int(params.get("max_indel", 10)),
    )
    case = make_test_case(
        job_seed(seed, job, 0),
        int(params["n_sequences"]),
        int(params["length"]),
        mut,
        id_prefix=params["id_prefix"],
    )
    flip = np.random.RandomState(job_seed(seed, job, 1)).random_sample(len(case.sequences))
    out = []
    for s, u in zip(case.sequences, flip.tolist()):
        seq = s.seq.translate(_COMP)[::-1] if u < float(params["reverse_fraction"]) else s.seq
        out.append(Sequence(s.id, seq))
    return out


def write_fasta(path: str, seqs: List[Sequence], width: int = 80) -> None:
    with open(path, "wb") as f:
        for s in seqs:
            f.write(b">" + s.id.encode() + b"\n")
            for i in range(0, len(s.seq), width):
                f.write(s.seq[i : i + width] + b"\n")


def read_fasta(path: str) -> List[Sequence]:
    seqs, name, chunks = [], None, []
    with open(path, "rb") as f:
        for raw in f:
            line = raw.rstrip(b"\r\n")
            if line.startswith(b">"):
                if name is not None:
                    seqs.append(Sequence(name, b"".join(chunks)))
                name, chunks = line[1:].split()[0].decode(), []
            elif line:
                chunks.append(line)
    if name is not None:
        seqs.append(Sequence(name, b"".join(chunks)))
    return seqs
