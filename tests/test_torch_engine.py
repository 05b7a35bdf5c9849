"""Parity of the port's DenseBandAligner and UnifiedAligner
(allwave_tpu_torch/wfa/dense_engine.py, on the CPU with the plain
versions of the kernels) with the JAX reference's (impl="xla"): the same
scores, CIGARs, PAF stats and failed pairs, through escalation rounds,
the overflow rerun, failure at k_max and mash-hint rounds."""

import numpy as np
import pytest

from allwave_tpu.core.scores import parse_scores
from allwave_tpu.wfa import dense_engine as JE
from allwave_tpu.wfa.params import resolve_penalties
from allwave_tpu_torch.wfa import batch as TB
from allwave_tpu_torch.wfa import dense as TD
from allwave_tpu_torch.wfa import dense_engine as TE


@pytest.fixture(autouse=True)
def _single_device(monkeypatch):
    # the reference's shard_map over 8 virtual CPU devices gives the same
    # bytes; one device keeps its compile short
    monkeypatch.setenv("ALLWAVE_SINGLE_DEVICE", "1")


@pytest.fixture
def launched(monkeypatch):
    """The (band K, run_cap, n_pairs) of every group the port launches."""
    seen = []
    orig = TE.DenseBandAligner._launch_group

    def spy(self, group, k, run_cap, l_pad, pool):
        seen.append((k, run_cap, len(group)))
        return orig(self, group, k, run_cap, l_pad, pool)

    monkeypatch.setattr(TE.DenseBandAligner, "_launch_group", spy)
    return seen


def _pairs(seed, n, L, div, indel=0.0, len_jitter=0):
    rng = np.random.RandomState(seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    out = []
    for _ in range(n):
        q = rng.choice(bases, L + rng.randint(0, len_jitter + 1))
        t = q.copy()
        mut = rng.rand(t.size) < div
        t[mut] = rng.choice(bases, mut.sum())
        if indel:
            keep = rng.rand(t.size) >= indel
            t = t[keep]
        out.append((q.tobytes(), t.tobytes()))
    return out


def _norm(results):
    """(score, per-base cigar bytes) of each result, runs expanded."""
    out = []
    for r in results:
        if r is None:
            out.append(None)
            continue
        score, cig = r
        if isinstance(cig, tuple):
            cig = TB.expand_runs(*cig)
        out.append((int(score), np.asarray(cig, np.uint8).tobytes()))
    return out


def _align_both(pen, pairs, jcfg, tcfg, unified=False, ref_runs=False, **kw):
    """The port's results (runs) against the reference's, in per-base
    form or, with ref_runs, as its runs; both expanded."""
    if unified:
        j = JE.UnifiedAligner(pen, dense_config=jcfg)
        t = TE.UnifiedAligner(pen, dense_config=tcfg, device="cpu")
    else:
        j = JE.DenseBandAligner(pen, jcfg)
        t = TE.DenseBandAligner(pen, tcfg, device="cpu")
    rj, sj = j.align_pairs(pairs, with_stats=True, as_runs=ref_runs, **kw)
    rt, st = t.align_pairs(pairs, with_stats=True, **kw)
    assert all(r is None or isinstance(r[1], tuple) for r in rt)
    assert _norm(rj) == _norm(rt)
    np.testing.assert_array_equal(sj, st)
    return rt, st


@pytest.mark.parametrize("ref_runs", [False, True])
def test_escalation_matches_reference(ref_runs, launched):
    """15%-divergent pairs miss the K=128 certificate and escalate to the
    band their banded score certifies; 1% pairs certify at once."""
    pen = resolve_penalties(parse_scores("0,5,8,2,24,1"))
    pairs = _pairs(1, 4, 240, 0.15, indel=0.02) + _pairs(2, 3, 240, 0.01)
    TD.forward_launches.reset()
    res, _ = _align_both(
        pen, pairs, JE.DenseConfig(impl="xla"), TE.DenseConfig(), ref_runs=ref_runs
    )
    assert all(r is not None for r in res)
    assert launched[0] == (128, 128, 7) and max(k for k, _, _ in launched) > 128
    # CPU tensors run the plain versions: no kernel launch is counted
    assert TD.forward_launches.count == 0


def test_overflow_rerun_matches_reference(launched):
    """A run buffer too small for a divergent pair's CIGAR overflows
    and the pair reruns at the full 2L+8 cap."""
    pen = resolve_penalties(parse_scores("0,4,6,2"))
    pairs = _pairs(3, 4, 200, 0.3)
    res, _ = _align_both(
        pen,
        pairs,
        JE.DenseConfig(impl="xla", run_cap_initial=4, k_initial=512),
        TE.DenseConfig(run_cap_initial=4, k_initial=512),
    )
    assert all(r is not None for r in res)
    # 0.3 divergence over 200 bases: far more runs than cap0 = l_pad//8
    # = 32, so the pairs rerun at the full cap 2*256+8
    assert launched[0][1] == 32 and (512, 520, 4) in launched


def test_failure_at_k_max_matches_reference():
    """Pairs that cannot certify within k_max fail (None) in both."""
    pen = resolve_penalties(parse_scores("0,5,8,2,24,1"))
    pairs = _pairs(4, 3, 200, 0.25, indel=0.05) + _pairs(5, 2, 200, 0.0)
    res, st = _align_both(
        pen, pairs, JE.DenseConfig(impl="xla", k_max=128), TE.DenseConfig(k_max=128)
    )
    assert res[3] is not None and res[4] is not None
    assert any(r is None for r in res[:3])
    assert all((st[i] == 0).all() for i, r in enumerate(res) if r is None)


def test_hint_rounds_match_reference(launched):
    """Mash-style score hints split the pairs into band rounds (small
    ones coalesce); wrong hints only cost an escalation."""
    pen = resolve_penalties(parse_scores("0,5,8,2,24,1"))
    pairs = _pairs(6, 10, 200, 0.05) + _pairs(7, 4, 200, 0.2)
    hint = [30, 60, 90, 400, 600, 10, 2000, 50, 50, 50, 5, 900, 100, 100]
    _align_both(
        pen,
        pairs,
        JE.DenseConfig(impl="xla"),
        TE.DenseConfig(),
        sigma_hint=hint,
        ref_runs=True,
    )
    # every hint round is under 512 pairs, so they all coalesce into the
    # widest hinted band: one first launch carrying all 14 pairs
    assert launched[0][2] == 14 and launched[0][0] > 128


def test_unified_length_buckets_match_reference():
    """Mixed lengths go to several padded-length buckets (tiny buckets
    coalesce upward)."""
    pen = resolve_penalties(parse_scores("0,1,1,1"))
    pairs = (
        _pairs(8, 3, 40, 0.1)
        + _pairs(9, 3, 150, 0.1, len_jitter=20)
        + _pairs(10, 2, 300, 0.05, indel=0.01)
    )
    _align_both(
        pen, pairs, JE.DenseConfig(impl="xla"), TE.DenseConfig(), unified=True
    )


def test_unified_long_pairs_match_reference():
    """Pairs above dense_max_len take the segmented engine in both
    packages: same results and stats, no pair length raises."""
    from allwave_tpu.wfa.segmented import SegmentedConfig as JSC
    from allwave_tpu_torch.wfa.segmented import SegmentedConfig as TSC

    pen = resolve_penalties(parse_scores("0,5,8,2,24,1"))
    pairs = _pairs(11, 2, 150, 0.01) + _pairs(12, 1, 60, 0.05)
    j = JE.UnifiedAligner(pen, dense_max_len=100, dense_config=JE.DenseConfig(impl="xla"),
                          segmented_config=JSC(ckpt_every=64, impl="xla"))
    t = TE.UnifiedAligner(pen, dense_max_len=100, device="cpu",
                          segmented_config=TSC(ckpt_every=64))
    rj, sj = j.align_pairs(pairs, with_stats=True)
    rt, st = t.align_pairs(pairs, with_stats=True)
    assert _norm(rt) == _norm(rj) and all(r is not None for r in rt)
    np.testing.assert_array_equal(st, sj)


def test_ops_unpack_lut_matches_reference():
    np.testing.assert_array_equal(TE._OPS_UNPACK_LUT, JE._OPS_UNPACK_LUT)


def test_expand_runs_batch_matches_reference():
    from allwave_tpu.wfa.batch import expand_runs_batch

    rng = np.random.RandomState(12)
    ops = rng.choice(np.frombuffer(b"MXID", np.uint8), (5, 9))
    lens = rng.randint(0, 256, (5, 9)).astype(np.uint8)
    nruns = np.array([0, 3, 9, 12, 1])
    for a, b in zip(expand_runs_batch(ops, lens, nruns), TB.expand_runs_batch(ops, lens, nruns)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("sigma", [0, 37, 210, 900, 5000])
def test_band_rules_match_reference(sigma):
    pen = resolve_penalties(parse_scores("0,5,8,2,24,1"))
    j = JE.DenseBandAligner(pen, JE.DenseConfig(impl="xla"))
    ladder = TE.DenseBandAligner(pen, device="cpu").ladder
    assert ladder.rungs == j._ladder() and ladder.k_max == 1 << 14
    assert ladder.for_score(sigma, 7) == j._k_for_score(sigma, 7)
    sig = np.array([sigma, sigma // 2, sigma * 2], np.int64)
    ke = np.array([0, 5, 40], np.int64)
    np.testing.assert_array_equal(ladder.for_scores(sig, ke), j._k_for_scores(sig, ke))
    ks = (1, 128, 129, 200, 321, 3000, 20000)
    for k in ks:
        assert ladder.round(k) == j._round_k(k)
    np.testing.assert_array_equal(ladder.round_many(np.array(ks)), j._round_ks(np.array(ks)))


@pytest.mark.parametrize("module", ["segmented", "wf_segmented"])
def test_long_engines_do_not_import_the_router(module):
    """The long engines sit below the router (dense_engine.py): neither
    imports it, at module level or inside a function, and neither builds
    another engine; what they share with the dense engine lives in
    wfa/rounds.py."""
    import ast
    import os

    from allwave_tpu_torch import wfa

    path = os.path.join(os.path.dirname(wfa.__file__), module + ".py")
    tree = ast.parse(open(path).read())
    imported = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            imported.add(node.module or "")
            imported |= {f"{node.module or ''}.{a.name}" for a in node.names}
    assert not any(name.split(".")[-1] == "dense_engine" for name in imported), imported
    called = {n.func.id for n in ast.walk(tree)
              if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)}
    others = {"DenseBandAligner", "UnifiedAligner", "SegmentedDenseAligner",
              "WavefrontSegmentedAligner"}
    assert not called & others
