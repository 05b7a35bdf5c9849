"""The traffic generator: deterministic per (seed, job), distinct jobs,
the strand mix, and the same work (lengths, ids) for every seed."""

import numpy as np
import pytest

from gpubench import jobs, spec

PARAMS = {"n_sequences": 40, "length": 600, "snp_rate": 0.02, "insertion_rate": 0.0005,
          "deletion_rate": 0.0005, "max_indel": 10, "reverse_fraction": 0.5, "id_prefix": "g"}


@pytest.mark.parametrize("seed", [0, 1234, 2**31 + 17, 2**63 + 5, -3])
def test_same_seed_and_job_same_sequences(seed):
    assert jobs.make_job(PARAMS, seed, 3) == jobs.make_job(PARAMS, seed, 3)


def test_jobs_and_seeds_differ():
    seqs = {tuple(s.seq for s in jobs.make_job(PARAMS, seed, j)) for seed in (5, 6) for j in range(4)}
    assert len(seqs) == 8


def test_each_job_has_its_own_ancestor():
    a = jobs.make_job({**PARAMS, "reverse_fraction": 0.0}, 9, 0)
    b = jobs.make_job({**PARAMS, "reverse_fraction": 0.0}, 9, 1)
    same = np.mean(np.frombuffer(a[0].seq, np.uint8) == np.frombuffer(b[0].seq, np.uint8))
    assert same < 0.5  # unrelated sequences agree at ~1/4 of positions


def test_ids_and_work_fixed_across_seeds():
    for seed in (1, 2**40):
        seqs = jobs.make_job(PARAMS, seed, 0)
        assert [s.id for s in seqs] == [f"g{i}" for i in range(40)]
        assert all(abs(len(s.seq) - 600) <= 20 for s in seqs)


def test_strand_mix():
    fwd = jobs.make_job({**PARAMS, "reverse_fraction": 0.0}, 11, 2)
    mix = jobs.make_job(PARAMS, 11, 2)
    rc = bytes.maketrans(b"ACGT", b"TGCA")
    flipped = [m.seq != f.seq for f, m in zip(fwd, mix)]
    for f, m, fl in zip(fwd, mix, flipped):
        assert m.seq == (f.seq.translate(rc)[::-1] if fl else f.seq)
    assert 10 <= sum(flipped) <= 30
    allrev = jobs.make_job({**PARAMS, "reverse_fraction": 1.0}, 11, 2)
    assert all(a.seq == f.seq.translate(rc)[::-1] for f, a in zip(fwd, allrev))


def test_fasta_round_trip(tmp_path):
    seqs = jobs.make_job(PARAMS, 4, 0)
    path = str(tmp_path / "x.fa")
    jobs.write_fasta(path, seqs)
    assert jobs.read_fasta(path) == seqs


def test_every_cell_generates(tmp_path):
    bench = spec.load_benchmark()
    for w in bench["workloads"]:
        p = spec.Cell(bench, w["name"]).params
        small = {**p, "n_sequences": 3, "length": 300}
        seqs = jobs.make_job(small, 1, 0)
        assert len(seqs) == 3 and set(b"".join(s.seq for s in seqs)) <= set(b"ACGT")
