"""The port's fuzz (allwave_tpu_torch/fuzz.py, generator
allwave_tpu_torch/testing/fuzzgen.py) on the CPU, and the port twin of
tests/test_fuzz_cross_engine.py.

On the CPU the engines run the kernels' plain versions; the fuzz's
CPU run stops at a fixed case count, 4 a phase: phase 1 after its first
iteration (seed 198, whose first two iterations hold pairs of at most
312 bases, so the plain engines take seconds), phase 2 after one batch,
of 2 kb pairs in place of the card's 10-100 kb (`fuzzgen.WF_LENGTHS`
patched), and the mutation check at 8 tie-rich pairs of 2 kb
(`fuzz.MUTATION_BATCH` patched), the smallest length at which the flip
shows on the CPU engines (1 of 8 pairs; at 1 kb none). The card runs the
fuzz at its own sizes (chip_smoke.py phase 20,
tests/artifacts/FUZZ_GPU.json)."""

import ast
import hashlib
import json
import os

import numpy as np
import pytest

from allwave_tpu_torch import fuzz
from allwave_tpu_torch import native
from allwave_tpu_torch.testing import fuzzgen
from tests.test_fuzz_cross_engine import _rand_pair, _rand_params
from tests.test_torch_fuzz_battery import _dense_round


def _draws(seed):
    rng = np.random.RandomState(seed)
    p1 = [fuzzgen.phase1_case(rng) for _ in range(3)]
    L, pairs, hints = fuzzgen.phase2_batch(rng, 5, (2000, 3000))
    return p1, (L, pairs, hints), fuzzgen.tie_rich_batch(rng, 500, 3)


def test_generator_is_deterministic_by_seed():
    """One seed draws the same cases, another seed others; phase 1's
    sets cover the three modes the reference's script names, and the
    pairs carry noise bytes."""
    assert _draws(5) == _draws(5)
    assert _draws(5) != _draws(6)
    rng = np.random.RandomState(0)
    cases = [fuzzgen.phase1_case(rng) for _ in range(60)]
    modes = {(p.gap2_open is None, p.gap_open == p.gap_extend == p.mismatch_penalty)
             for p, _ in cases}
    assert modes == {(True, True), (True, False), (False, False)}
    assert any(set(t) & set(b"acgtNn") for _, pairs in cases for _, t in pairs)


def test_fuzz_runs_on_the_cpu(monkeypatch, tmp_path):
    """A CPU run at a fixed case count: no failure, the flip detected
    (clean 0, flipped > 0), an artifact with the seed, the generator's
    revision, both budgets and one run in its ledger, no live file left.
    The ledger keeps one entry a run and counts a (seed, revision) once."""
    monkeypatch.setattr(fuzzgen, "WF_LENGTHS", (2000,))
    monkeypatch.setattr(fuzz, "MUTATION_BATCH", (2000, 8))
    out = str(tmp_path / "FUZZ_GPU.json")
    rec = fuzz.run(seed=198, budget_s=600, wf_budget_s=300, out=out, device="cpu", max_cases=4,
                   log=lambda m: None)
    assert rec["ok"] and rec["failures"] == 0
    p1 = rec["phase1"]
    assert p1["iterations"] == 1 and p1["cases"] >= 4 and p1["oracle_compared"] == p1["cases"]
    assert rec["phase1"]["plain_engine"] == "the engine itself (device cpu)"
    assert rec["phase2"]["cases"] == 4 and rec["phase2"]["compared"] == 4
    mut = rec["mutation_check"]
    assert mut["clean_mismatches"] == 0 and mut["flipped_mismatches"] > 0
    assert rec["mutation_check_tb_flip_detected"] is True
    with open(out) as f:
        art = json.load(f)
    assert (art["seed"], art["generator_rev"]) == (198, fuzzgen.GENERATOR_REV)
    assert (art["budget_s"], art["wf_budget_s"]) == (600, 300)
    assert len(art["runs"]) == 1 and art["cumulative"]["phase1_cases"] == p1["cases"]
    assert not any(name.endswith("_live.json") for name in os.listdir(tmp_path))
    fuzz.write_artifact(out, {k: v for k, v in rec.items() if k not in ("runs", "cumulative")})
    again = fuzz.write_artifact(out, {**rec, "seed": 199})
    assert len(again["runs"]) == 3
    assert again["cumulative"]["phase1_cases"] == 2 * p1["cases"]
    assert again["cumulative"]["phase2_cases"] == 8
    assert again["cumulative"]["distinct_seed_revisions"] == 2


def _artifact_rec(seed, failures, phase1=10, rev=fuzzgen.GENERATOR_REV):
    return {"seed": seed, "generator_rev": rev, "git": "x", "date": "d", "device": "cpu",
            "phase1": {"cases": phase1}, "phase2": {"cases": 4}, "failures": failures}


def test_artifact_counts_failures_once_per_seed_and_revision(tmp_path):
    """A rerun of a seed draws the same cases, so its failures are the same
    failures: the ledger counts each (seed, revision)'s failures once, from
    its largest run, as it counts its cases."""
    out = str(tmp_path / "FUZZ_GPU.json")
    fuzz.write_artifact(out, _artifact_rec(7, 2))
    fuzz.write_artifact(out, _artifact_rec(7, 2, phase1=12))
    fuzz.write_artifact(out, _artifact_rec(8, 1))
    rec = fuzz.write_artifact(out, _artifact_rec(7, 3, rev="other"))
    assert len(rec["runs"]) == 4
    assert rec["cumulative"] == {"distinct_seed_revisions": 3, "phase1_cases": 32,
                                 "phase2_cases": 12, "failures": 6}


#: the digest of testing/fuzzgen.py's drawing code at each of its
#: revisions (`_drawing_digest`): a change to the code without a new
#: GENERATOR_REV would merge two case streams under one name in the
#: artifact's ledger
GENERATOR_DIGESTS = {"fuzz_tpu.py/port-1": "81fccb5f288a89d5"}


def _drawing_digest(src: str) -> str:
    """sha256 (16 hex digits) of a module's syntax tree without its
    docstrings and its GENERATOR_REV assignment: the code that draws the
    cases, whatever its comments, docstrings and layout."""
    tree = ast.parse(src)
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(node, (ast.Module, ast.FunctionDef, ast.ClassDef)) and body
                and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:]
    tree.body = [n for n in tree.body if not (isinstance(n, ast.Assign) and any(
        isinstance(t, ast.Name) and t.id == "GENERATOR_REV" for t in n.targets))]
    return hashlib.sha256(ast.dump(tree).encode()).hexdigest()[:16]


def test_generator_revision_names_its_code():
    """GENERATOR_REV is the revision whose recorded digest the generator's
    drawing code has; a change to a draw changes the digest, a change to a
    docstring, comment or the revision's name does not."""
    with open(fuzzgen.__file__) as f:
        src = f.read()
    digest = _drawing_digest(src)
    assert GENERATOR_DIGESTS.get(fuzzgen.GENERATOR_REV) == digest, (
        f"testing/fuzzgen.py's drawing code (digest {digest}) is not the code of revision "
        f"{fuzzgen.GENERATOR_REV!r}: give the generator a new GENERATOR_REV and record its "
        "digest in GENERATOR_DIGESTS")
    assert len(set(GENERATOR_DIGESTS.values())) == len(GENERATOR_DIGESTS)
    assert _drawing_digest(src.replace("rng.randint(1, 9)", "rng.randint(1, 10)")) != digest
    assert _drawing_digest(src.replace('"""An edit-distance', '"""An edit distance')) == digest
    assert _drawing_digest(src.replace(fuzzgen.GENERATOR_REV, "renamed")) == digest


def test_fuzz_exits_non_zero_without_the_oracle(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "available", lambda: False)
    out = tmp_path / "FUZZ_GPU.json"
    assert fuzz.main(["1", "5", "5", "--device", "cpu", "--out", str(out)]) != 0
    assert not out.exists()


def test_fuzz_exits_non_zero_on_a_phase_with_no_case(tmp_path):
    out = tmp_path / "FUZZ_GPU.json"
    assert fuzz.main(["1", "0", "5", "--device", "cpu", "--out", str(out)]) != 0
    with pytest.raises(fuzz.FuzzError, match="phase 2 .* compared no case"):
        fuzz.run(seed=198, budget_s=600, wf_budget_s=0, out=str(out), device="cpu", max_cases=1,
                 log=lambda m: None)
    assert not out.exists()
    live = json.loads((tmp_path / "FUZZ_GPU_live.json").read_text())
    assert live["in_progress"] is True  # a cut run leaves its live file


def test_phase1_counts_a_wrong_answer(monkeypatch):
    """An oracle that disagrees by one is counted as a failure."""
    real = native.wfa_align_native

    def off_by_one(q, t, pen):
        score, cigar = real(q, t, pen)
        return score + 1, cigar

    monkeypatch.setattr(native, "wfa_align_native", off_by_one)
    logged = []
    n = fuzz.phase1(198, 600, "cpu", max_cases=1, log=logged.append)
    assert n["failures"] == n["oracle_compared"] > 0
    assert all("ORACLE MISMATCH" in m for m in logged)


@pytest.mark.parametrize("seed", [pytest.param(3, marks=pytest.mark.slow), 17,
                                  pytest.param(41, marks=pytest.mark.slow)])
def test_fuzz_engines_vs_oracle(seed):
    """Twin of tests/test_fuzz_cross_engine.py: the same generated sets
    and pairs through the port's dense engine on the CPU, the
    reference's XLA dense engine and the native oracle; scores and
    CIGARs byte-equal, every CIGAR replays."""
    assert native.available()
    rng = np.random.RandomState(seed)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    noisy = np.frombuffer(b"ACGTacgtNn", dtype=np.uint8)
    for _ in range(4):
        params = _rand_params(rng)
        _dense_round(params, [_rand_pair(rng, acgt, noisy) for _ in range(3)])
