"""allwave's config 3 (`gpubench/configs/giant500_2kb.json`: 500 x 2 kb,
`-s 0,5,8,2,24,1`, `-p giant:0.99`, mash orientation) on the port, held
to the benchmark's plain reference (`gpubench/reference/`) on the CPU:
a job cut to 16 x 600 bp through the CLI with every pair judged, the
pair set and the strands at the configuration's own size."""

import numpy as np
import pytest

from allwave_tpu_torch import cli
from allwave_tpu_torch.core.types import Sequence as PortSequence
from allwave_tpu_torch.orient.orientation import OrientationIndex
from allwave_tpu_torch.sparsify.pairs import build_pairs, parse_sparsification
from gpubench import jobs, judge, spec
from gpubench.reference import orient as ref_orient
from gpubench.reference import pairs as ref_pairs

SEEDS = [2147483659, 31]


def _params():
    return spec.Cell(spec.load_benchmark(), "giant500_2kb.giant").params


def _port_seqs(seqs):
    return [PortSequence(s.id, s.seq) for s in seqs]


@pytest.mark.parametrize("seed", SEEDS)
def test_cut_job_through_the_cli_matches_the_reference(tmp_path, seed):
    p = {**_params(), "n_sequences": 16, "length": 600}
    seqs = jobs.make_job(p, seed, 0)
    fa, paf = str(tmp_path / "job.fa"), str(tmp_path / "job.paf")
    jobs.write_fasta(fa, seqs)
    rc = cli.main(["-i", fa, "-o", paf, "-s", p["scores"], "-p", p["sparsification"],
                   "--no-progress"])
    assert rc == 0
    rng = np.random.RandomState(jobs.job_seed(seed, 0, 7))
    every = len(ref_pairs.select_pairs([s.id for s in seqs], p["sparsification"]))
    jc = judge.JobCheck(seqs, p, every, rng, judge.read_paf(paf))
    assert len(jc.sample) == every > 0
    counts = jc.counts(jc.align("cpu", 64))
    assert counts == {k: 0 for k in counts}, counts


def test_pairs_equal_the_reference_at_500():
    p = _params()
    ids = [f"{p['id_prefix']}{i}" for i in range(p["n_sequences"])]
    seqs = [PortSequence(sid, b"ACGT") for sid in ids]
    got = build_pairs(seqs, parse_sparsification(p["sparsification"]), True)
    want = ref_pairs.select_pairs(ids, p["sparsification"])
    assert want.shape == (5395, 2)
    np.testing.assert_array_equal(np.asarray(got, dtype=np.int64), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_orientation_equals_the_reference_at_500_x_2kb(seed):
    p = _params()
    seqs = jobs.make_job(p, seed, 0)
    assert len(seqs) == 500 and all(len(s.seq) >= 1900 for s in seqs)
    pairs = ref_pairs.select_pairs([s.id for s in seqs], p["sparsification"])
    got = OrientationIndex(_port_seqs(seqs), device="cpu").orient_batch(pairs)
    want = ref_orient.strands([s.seq for s in seqs], pairs)
    assert 0 < want.sum() < want.size
    np.testing.assert_array_equal(np.asarray(got, dtype=bool), want)


def test_the_configuration_keeps_its_published_shape():
    p = _params()
    assert (p["n_sequences"], p["length"], p["scores"], p["sparsification"]) == (
        500, 2000, "0,5,8,2,24,1", "giant:0.99")
