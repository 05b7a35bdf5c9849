"""The port's device routes of orientation and MinHash counts
(allwave_tpu_torch/sketch/membership.py, `torch._int_mm` on the CPU)
against the reference's `_decision_matrix_device` and
`_intersection_counts_device` on JAX's CPU backend and against the
NumPy paths: decisions and counts exact, f32 distances within
rtol=1e-6 of the reference's f32 and of the NumPy path's f64. Also the
gates: over budget the index takes the native per-pair route without
reaching the device body, and on the CPU the gates never open."""

import numpy as np
import pytest
import torch

from allwave_tpu.core.types import Sequence as RSeq
from allwave_tpu.orient.orientation import OrientationIndex as RIdx
from allwave_tpu.sketch import minhash as RM
from allwave_tpu_torch.core.types import Sequence as TSeq
from allwave_tpu_torch.orient import orientation as TO
from allwave_tpu_torch.sketch import membership
from allwave_tpu_torch.sketch import minhash as TM
from allwave_tpu_torch.testing.batches import host_stranded_sets
from allwave_tpu_torch.testing.synth import MutationConfig, make_test_case


def _rc_set():
    """tests/test_orientation.py's 40 x 600 set: seed 3, every third
    sequence reverse-complemented."""
    rng = np.random.RandomState(3)
    bases = np.frombuffer(b"ACGT", np.uint8)
    comp = np.full(256, ord("N"), np.uint8)
    for s_, d_ in zip(b"ATCGN", b"TAGCN"):
        comp[s_] = d_
    root = rng.choice(bases, 600)
    seqs = []
    for i in range(40):
        t = root.copy()
        mut = rng.rand(600) < rng.uniform(0.01, 0.4)
        t[mut] = bases[rng.randint(0, 4, mut.sum())]
        if i % 3 == 0:
            t = comp[t][::-1]
        seqs.append(t.tobytes())
    return seqs


def _headline64():
    """The first 64 of bench.py's headline sequences (128 x 1 kb at 2%,
    seed 1234)."""
    tc = make_test_case(1234, 128, 1000, MutationConfig(0.02, 0.0005, 0.0005))
    return [s.seq for s in tc.sequences[:64]]


@pytest.fixture(autouse=True)
def _reset_routes():
    membership.orient_routes.reset()
    membership.count_routes.reset()


@pytest.mark.parametrize("make", [_rc_set, _headline64], ids=["rc40x600", "headline64"])
def test_decision_matrix_device_matches_reference_and_numpy(make):
    seqs = make()
    ref = RIdx([RSeq(f"s{i}", s) for i, s in enumerate(seqs)])
    ref_dec = ref._decision_matrix_device()
    port = TO.OrientationIndex([TSeq(f"s{i}", s) for i, s in enumerate(seqs)], device="cpu")
    dec = port._decision_matrix_device(torch.device("cpu"))
    dist = port._distances
    assert membership.orient_routes.counts == {"device": 1}
    np_idx = TO.OrientationIndex([TSeq(f"s{i}", s) for i, s in enumerate(seqs)], device="cpu")
    np_dec = np_idx._decision_matrix()

    np.testing.assert_array_equal(dec, ref_dec)
    np.testing.assert_array_equal(dec, np_dec)
    np.testing.assert_allclose(dist, ref._distances, rtol=1e-6)
    np.testing.assert_allclose(dist, np_idx._distances, rtol=1e-6)


def test_intersection_counts_device_matches_reference_and_numpy():
    """tests/test_sketch.py's case: seed 5, 9 sketches of 400 bases."""
    rng = np.random.RandomState(5)
    bases = np.frombuffer(b"ACGT", np.uint8)
    root = rng.choice(bases, 400)
    sketches = []
    for _ in range(9):
        t = root.copy()
        mut = rng.rand(400) < rng.uniform(0.0, 0.6)
        t[mut] = bases[rng.randint(0, 4, mut.sum())]
        sketches.append(np.unique(TM.sketch_canonical(t.tobytes(), 15, 1000)))
    sizes = np.array([s.size for s in sketches], dtype=np.int64)
    got = TM._intersection_counts_device(sketches, sizes, torch.device("cpu"))
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, RM._intersection_counts_device(sketches, sizes, force=True))
    np.testing.assert_array_equal(got, TM.pairwise_intersection_counts(sketches))
    assert membership.count_routes.counts == {"device": 1, "numpy": 1}


@pytest.mark.parametrize("R,n_cols", [(3, 3), (17, 9), (40, 20)])
def test_membership_counts_equal_an_int32_product(R, n_cols):
    """Padding for `torch._int_mm` (rows, columns, U) and the dropped
    sentinel column change no count."""
    rng = np.random.RandomState(R)
    U = 150
    sets = [np.unique(rng.randint(0, U, rng.randint(0, 60))) for _ in range(R)]
    S = max(max(s.size for s in sets), 1)
    codes = np.full((R, S), U, dtype=np.int32)
    dense = np.zeros((R, U), dtype=np.int32)
    for r, s in enumerate(sets):
        codes[r, : s.size] = s
        dense[r, s] = 1
    got = membership.membership_counts(codes, U, n_cols, torch.device("cpu"))
    assert got.dtype == torch.int32 and tuple(got.shape) == (R, n_cols)
    np.testing.assert_array_equal(got.numpy(), dense @ dense[:n_cols].T)


def test_over_budget_takes_the_native_route(monkeypatch):
    """With the budget cut below the set, the gate (opened here by a
    CUDA device type: nothing is allocated before the host check
    raises) serves the request per pair natively, with the NumPy
    path's decisions, and never reaches the device body."""
    from allwave_tpu_torch import native

    assert native.available() and hasattr(native.get_lib(), "orient_pairs")
    seqs = [TSeq(f"s{i}", s) for i, s in enumerate(_rc_set()[:12])]
    want = TO.OrientationIndex(seqs, device="cpu")._decision_matrix()
    membership.orient_routes.reset()

    def unreachable(*a, **k):
        raise AssertionError("the device body ran")

    monkeypatch.setattr(TO, "_decide_device", unreachable)
    # a CUDA index builds its sets with the sketch kernel: here the
    # host's sets instead
    monkeypatch.setattr(TO, "stranded_sets", lambda *a: host_stranded_sets(*a[:-1]))
    monkeypatch.setattr(TO, "ORIENT_DEVICE_MIN_N", 2)
    monkeypatch.setattr(TO.OrientationIndex, "DEVICE_MEMBERSHIP_MAX", 64)
    idx = TO.OrientationIndex(seqs, device="cpu")
    idx.device = torch.device("cuda")
    pairs = [(i, j) for i in range(12) for j in range(12) if i != j]
    got = idx.orient_batch(pairs)
    np.testing.assert_array_equal(got, want[tuple(np.array(pairs).T)])
    assert membership.orient_routes.counts == {"native": 1}


def test_gates_stay_shut_on_the_cpu(monkeypatch):
    """Above both thresholds, a CPU run takes the NumPy routes, as the
    reference's `jax.default_backend() != "cpu"` keeps its gates shut;
    the pipeline hands its own device to the index."""
    from allwave_tpu_torch.core.scores import parse_scores
    from allwave_tpu_torch.engine.pipeline import AllPairAligner

    def unreachable(*a, **k):
        raise AssertionError("a device route ran on the CPU")

    monkeypatch.setattr(TO, "_decide_device", unreachable)
    monkeypatch.setattr(TM, "_intersection_counts_device", unreachable)
    monkeypatch.setattr(TO, "ORIENT_DEVICE_MIN_N", 2)
    monkeypatch.setattr(TM, "COUNT_DEVICE_MIN_N", 2)
    seqs = [TSeq(f"s{i}", s) for i, s in enumerate(_rc_set()[:10])]
    al = AllPairAligner(seqs, parse_scores("0,5,8,2,24,1"), use_mash_orientation=True)
    assert al.device == torch.device("cpu") and al._orient.device == al.device
    al._orient.orient_batch(al.pairs)
    assert membership.orient_routes.counts == {"numpy": 1}
    TM.compute_distance_matrix(seqs)
    assert membership.count_routes.counts == {"numpy": 1}


@pytest.mark.parametrize("n,route", [(9, "numpy"), (10, "device")])
def test_gates_open_at_their_thresholds_on_cuda(monkeypatch, n, route):
    """On a CUDA device each gate opens at its threshold, whatever ran
    before in the process. The device type is CUDA's while the device
    bodies run on the CPU (the host's sets stand in for the sketch
    kernel's), so the routes give the NumPy paths' decisions and
    counts."""
    decide, counts = TO._decide_device, TM.membership_counts
    cpu = torch.device("cpu")
    monkeypatch.setattr(TO, "_decide_device", lambda *a: decide(*a[:-1], cpu))
    monkeypatch.setattr(TO, "stranded_sets", lambda *a: host_stranded_sets(*a[:-1]))
    monkeypatch.setattr(TM, "membership_counts", lambda *a: counts(*a[:-1], cpu))
    monkeypatch.setattr(TM, "resolve_device", lambda: torch.device("cuda"))
    monkeypatch.setattr(TO, "ORIENT_DEVICE_MIN_N", 10)
    monkeypatch.setattr(TM, "COUNT_DEVICE_MIN_N", 10)
    seqs = [TSeq(f"s{i}", s) for i, s in enumerate(_rc_set()[:n])]
    want = TO.OrientationIndex(seqs, device="cpu")._decision_matrix()
    sketches = [np.unique(TM.sketch_canonical(s.seq, 15, 1000)) for s in seqs]
    sizes = np.array([x.size for x in sketches], dtype=np.int64)
    want_counts = TM._intersection_counts_device(sketches, sizes, cpu)
    for _ in range(2):
        membership.orient_routes.reset()
        membership.count_routes.reset()
        idx = TO.OrientationIndex(seqs, device="cpu")
        idx.device = torch.device("cuda")
        pairs = [(i, j) for i in range(n) for j in range(n) if i != j]
        np.testing.assert_array_equal(idx.orient_batch(pairs), want[tuple(np.array(pairs).T)])
        np.testing.assert_array_equal(TM.pairwise_intersection_counts(sketches), want_counts)
        assert membership.orient_routes.counts == {route: 1}
        assert membership.count_routes.counts == {route: 1}
