"""End-to-end parity of the port (allwave_tpu_torch, plain PyTorch
versions on the CPU) with the JAX reference (allwave_tpu): the sorted
PAF lines of both CLIs are identical, byte for byte."""

import io
import os
import subprocess
import sys
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest

from allwave_tpu import cli as ref_cli
from allwave_tpu.core.types import Sequence
from allwave_tpu.engine.fasta import write_fasta
from allwave_tpu.orient.orientation import reverse_complement
from allwave_tpu.testing.synth import MutationConfig, make_test_case, mutate, random_dna
from allwave_tpu_torch import cli as port_cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(mod, args):
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = mod.main([str(a) for a in args])
    assert rc == 0, err.getvalue()
    return sorted(out.getvalue().splitlines())


def _assert_same_paf(fasta, args):
    ref = _run(ref_cli, ["-i", fasta, "--no-progress", *args])
    port = _run(port_cli, ["-i", fasta, "--no-progress", *args])
    assert ref and port == ref
    return port


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    path = tmp_path_factory.mktemp("pipe") / "in.fa"
    make_test_case(41, 6, 400, MutationConfig(0.03, 0.003, 0.003)).write_fasta(str(path))
    return str(path)


@pytest.fixture(scope="module")
def stranded_fasta(tmp_path_factory):
    """Some queries are reverse complements of their targets."""
    rng = np.random.RandomState(43)
    base = random_dna(rng, 350)
    cfg = MutationConfig(0.02, 0.002, 0.002)
    seqs = [Sequence("t0", base)]
    for i in range(1, 5):
        m, _ = mutate(rng, base, cfg)
        seqs.append(Sequence(f"s{i}", reverse_complement(m) if i % 2 else m))
    path = tmp_path_factory.mktemp("strand") / "rc.fa"
    write_fasta(str(path), seqs)
    return str(path)


def _edge_sequences():
    """Lengths from 1 to 300 (bands escalate to full cover), a 40-base
    deletion, lowercase and N runs, IUPAC codes, a reversed copy."""
    rng = np.random.RandomState(3)
    a = rng.choice(list(b"ACGT"), 300).astype(np.uint8).tobytes()
    return [
        Sequence("a", a),
        Sequence("b", a[:100] + a[140:]),
        Sequence("c", a[:5]),
        Sequence("d", a.lower()[:200] + b"NNNNN" + a[205:]),
        Sequence("e", b"ACGTRYKM" * 10),
        Sequence("f", a[::-1]),
        Sequence("g", b"A"),
        Sequence("h", a),
    ]


@pytest.fixture(scope="module")
def edge_fasta(tmp_path_factory):
    path = tmp_path_factory.mktemp("edge") / "edge.fa"
    write_fasta(str(path), _edge_sequences())
    return str(path)


@pytest.mark.parametrize("scores", ["0,5,8,2,24,1", "0,1,1,1"])
def test_cli_edge_cases_match_reference(edge_fasta, scores):
    _assert_same_paf(edge_fasta, ["-p", "none", "-s", scores])


@pytest.mark.parametrize(
    "args",
    [
        ["-p", "none"],
        ["-p", "giant:0.99"],
        ["-p", "none", "-s", "0,1,1,1"],
        ["-p", "none", "-s", "0,5,8,2"],
        ["-p", "tree:2:1:0.2"],
        ["-p", "none", "-k", "seq1,seq2,seq3"],
    ],
)
def test_cli_paf_matches_reference(fasta, args):
    _assert_same_paf(fasta, args)


def test_cli_reverse_strand_matches_reference(stranded_fasta):
    lines = _assert_same_paf(stranded_fasta, ["-p", "none"])
    assert any(line.split("\t")[4] == "-" for line in lines)


def test_cli_wfa_orientation_matches_reference(stranded_fasta):
    lines = _assert_same_paf(stranded_fasta, ["-p", "none", "--wfa-orientation"])
    assert any(line.split("\t")[4] == "-" for line in lines)


def test_iter_and_callback_build_the_same_results(stranded_fasta):
    """`__iter__` and `for_each_with_callback` build their results in one function:
    on the stranded fixture under -p none and WFA orientation, in chunks
    of 7 pairs, they give the same AlignmentResults in the same order,
    every one carrying runs whose stats are its PAF fields."""
    from allwave_tpu_torch.core.scores import parse_scores
    from allwave_tpu_torch.core.types import NoSparsification
    from allwave_tpu_torch.engine.fasta import read_fasta
    from allwave_tpu_torch.engine.pipeline import AllPairAligner
    from allwave_tpu_torch.wfa.batch import expand_runs, runs_stats

    seqs = read_fasta(stranded_fasta)

    def aligner():
        return AllPairAligner(seqs, parse_scores("0,5,8,2,24,1"), use_mash_orientation=False,
                              sparsification=NoSparsification(), chunk_size=7)

    pulled = list(aligner())
    pushed = []
    aligner().for_each_with_callback(pushed.append)

    def fields(r):
        return (r.query_idx, r.target_idx, r.query_start, r.query_end, r.target_start,
                r.target_end, r.is_reverse, r.score, r.num_matches, r.alignment_length,
                expand_runs(*r.cigar_runs).tobytes())

    assert len(pulled) == 20 and any(r.is_reverse for r in pulled)
    assert all(r.cigar_runs is not None for r in pulled + pushed)
    assert [fields(r) for r in pulled] == [fields(r) for r in pushed]
    paf = [[r.num_matches, r.alignment_length, r.query_end, r.target_end] for r in pulled]
    np.testing.assert_array_equal(runs_stats([r.cigar_runs for r in pulled]), paf)


def test_mash_matrix_matches_reference(fasta):
    assert _run(port_cli, ["-i", fasta, "--mash-matrix"]) == _run(
        ref_cli, ["-i", fasta, "--mash-matrix"]
    )


def test_facade_matches_reference(fasta):
    import allwave_tpu as R
    import allwave_tpu_torch as T

    def collect(pkg):
        seqs = pkg.read_fasta(fasta)
        out = []
        pkg.process_alignments_with_callback(
            seqs,
            pkg.parse_scores("0,5,8,2,24,1"),
            pkg.NoSparsification(),
            lambda r: out.append(pkg.alignment_to_paf(r, seqs)),
        )
        return sorted(out)

    assert collect(T) == collect(R)


def test_cli_runs_with_jax_blocked(fasta, tmp_path):
    """The port's entry point, as a user calls it, in a process where
    jax cannot be imported."""
    out = tmp_path / "o.paf"
    code = (
        "import sys, runpy; sys.modules['jax'] = None; "
        f"sys.argv = ['allwave-tpu-torch', '-i', {fasta!r}, '-p', 'none', "
        f"'--no-progress', '-o', {str(out)!r}]; "
        "runpy.run_module('allwave_tpu_torch.cli', run_name='__main__')"
    )
    env = dict(os.environ, ALLWAVE_PLATFORM="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    ref = _run(ref_cli, ["-i", fasta, "--no-progress", "-p", "none"])
    assert sorted(out.read_text().splitlines()) == ref


def test_cuda_without_gpu_raises(monkeypatch):
    import torch

    from allwave_tpu_torch.core.scores import parse_scores
    from allwave_tpu_torch.core.types import Sequence as TSeq
    from allwave_tpu_torch.engine.pipeline import AllPairAligner

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    seqs = [TSeq("a", b"ACGTACGTAC"), TSeq("b", b"ACGTTCGTAC")]
    with pytest.raises(RuntimeError, match="CUDA"):
        AllPairAligner(seqs, parse_scores("0,5,8,2,24,1"), device="cuda")
    # the knob: anything but ALLWAVE_PLATFORM=cpu means the GPU
    monkeypatch.setenv("ALLWAVE_PLATFORM", "tpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        AllPairAligner(seqs, parse_scores("0,5,8,2,24,1"))
    monkeypatch.setenv("ALLWAVE_PLATFORM", "cpu")
    assert AllPairAligner(seqs, parse_scores("0,5,8,2,24,1")).device.type == "cpu"
