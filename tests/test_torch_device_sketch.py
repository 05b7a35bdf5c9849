"""Orientation's stranded MinHash sets built on the card
(allwave_tpu_torch/sketch/device_sketch.py, csrc/minhash_sketch.cu).

On the CPU: the launch plan, a NumPy emulation of the kernel's schedule
(its short and long paths, the radix select of the cut, the gather and
the deduplication) against the host's sets on a batch built to break
them, the wrapper's refusal of a device other than CUDA's, and the
routes of a CPU index, which build host sets and count none as the
card's. On the card (`-m cuda`, skipped without one): the kernel's sets
against the host's in one launch, and an index on the card against one
on the CPU on every route.

This file imports no JAX, so its card tests also run on a machine that
has none (from the repository root):

    ALLWAVE_TEST_TPU=1 python -m pytest tests/test_torch_device_sketch.py -m cuda
"""

import numpy as np
import pytest
import torch

from allwave_tpu_torch.core.types import Sequence
from allwave_tpu_torch.hashing.siphash import hash_kmers
from allwave_tpu_torch.orient.orientation import OrientationIndex, reverse_complement
from allwave_tpu_torch.sketch import device_sketch as DS
from allwave_tpu_torch.sketch import membership
from allwave_tpu_torch.sketch.minhash import _IS_DNA
from allwave_tpu_torch.testing.batches import host_stranded_sets, sketch_strands
from allwave_tpu_torch.utils.telemetry import counters

ACGT = np.frombuffer(b"ACGT", np.uint8)


def _random(rng, n):
    return rng.choice(ACGT, n).tobytes()


def _jobs(n):
    """Both strands of n sequences."""
    seq_idx = np.concatenate([np.arange(n), np.arange(n)])
    return seq_idx, np.arange(2 * n) >= n


def _select(vals, rank):
    """The kernel's radix select: the rank-th smallest of vals
    (duplicates counted), 8 bits a pass from the top."""
    prefix, hi_mask = np.uint64(0), np.uint64(0)
    for shift in range(56, -8, -8):
        cand = vals[(vals & hi_mask) == prefix]
        hist = np.bincount(((cand >> np.uint64(shift)) & np.uint64(0xFF)).astype(np.int64),
                           minlength=256)
        incl = np.cumsum(hist)
        d = int(np.searchsorted(incl, rank))  # the first bin whose count reaches rank
        rank -= int(incl[d] - hist[d])
        prefix |= np.uint64(d) << np.uint64(shift)
        hi_mask |= np.uint64(0xFF) << np.uint64(shift)
    return prefix


def _emulate(seqs, seq_idx, reverse, k, S, seed=0):
    """The kernel's schedule on the CPU: the launch plan picks each
    strand's path; the valid hashes are appended in no set order (a
    shuffle stands in for the warps' atomics); a short strand sorts them
    all and deduplicates the first min(S, count); a long one keeps them
    all where there are at most S, else selects T and gathers the hashes
    below it and T once."""
    rng = np.random.RandomState(seed)
    lens = np.array([len(seqs[i]) for i in seq_idx], dtype=np.int64)
    lay = DS.plan(lens, k, S)
    out, paths = [], set()
    for j, (i, r) in enumerate(zip(seq_idx, reverse)):
        strand = np.frombuffer(reverse_complement(seqs[i]) if r else seqs[i], np.uint8)
        if lay.windows[j] == 0:
            vals = np.zeros(0, np.uint64)
        else:
            bad = np.concatenate(([0], np.cumsum(~_IS_DNA[strand])))
            vals = hash_kmers(strand, k)[(bad[k:] - bad[:-k]) == 0]
        vals = vals[rng.permutation(vals.size)]
        if lay.windows[j] <= lay.cap:
            paths.add("short")
            buf = np.sort(vals)[: min(S, vals.size)]
        elif vals.size <= S:
            paths.add("long, all")
            buf = np.sort(vals)
        else:
            paths.add("long, select")
            T = _select(vals, S)
            buf = np.sort(np.concatenate([vals[vals < T], [T]]))
            assert buf.size <= S
        out.append(buf[np.concatenate(([True], buf[1:] != buf[:-1]))] if buf.size else buf)
    return out, paths


@pytest.mark.parametrize("k,S", [(15, 1000), (15, 64), (15, 1), (21, 1000), (5, 200)])
def test_emulated_schedule_gives_the_host_sets(k, S):
    """On `testing.batches.sketch_strands`, the batch built to break a
    wrong set, both strands."""
    seqs = sketch_strands(k)
    seq_idx, reverse = _jobs(len(seqs))
    got, paths = _emulate(seqs, seq_idx, reverse, k, S)
    want = host_stranded_sets(seqs, seq_idx, reverse, k, S)
    assert len(got) == len(want)
    for j, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype == np.uint64 and np.array_equal(g, w), j
    assert paths == {"short", "long, all", "long, select"}


def test_select_counts_duplicates():
    vals = np.array([9, 3, 3, 3, 7, 1, 3], dtype=np.uint64)
    assert [int(_select(vals, r)) for r in range(1, 8)] == [1, 3, 3, 3, 3, 7, 9]
    big = np.array([2**64 - 1, 2**63, 2**64 - 1, 5], dtype=np.uint64)
    assert [int(_select(big, r)) for r in range(1, 5)] == [5, 2**63, 2**64 - 1, 2**64 - 1]


def test_plan_lays_out_short_and_long_strands():
    lens = np.array([0, 14, 15, 2000, 5000, 8206, 8207, 100_000, 30], dtype=np.int64)
    lay = DS.plan(lens, 15, 1000)
    assert lay.windows.tolist() == [0, 0, 1, 1986, 4986, 8192, 8193, 99_986, 16]
    assert lay.cap == 8192
    long_ = lay.windows > lay.cap
    assert long_.tolist() == [False] * 6 + [True, True, False]
    assert lay.scratch_off[long_].tolist() == [0, 8193]
    assert lay.scratch_len == 8193 + 99_986
    # short strands of 2 kb need no more than the sketch's power of two
    assert DS.plan(np.full(3, 2000), 15, 1000).cap == 2048
    assert DS.plan(np.full(3, 300), 15, 1000).cap == 1024
    only_long = DS.plan(np.full(2, 100_000), 15, 1000)
    assert only_long.cap == 1024 and only_long.scratch_off.tolist() == [0, 99_986]
    assert DS.plan(np.zeros(0, np.int64), 15, 1000).scratch_len == 0


def test_wrapper_refuses_a_device_that_is_not_cuda():
    """The kernel is the only path of `stranded_sets`: on the CPU it
    raises, launches nothing and counts no dispatch."""
    counters.reset()
    DS.sketch_launches.reset()
    with pytest.raises(ValueError, match="CUDA"):
        DS.stranded_sets([b"ACGT" * 10], [0], [False], 15, 1000, torch.device("cpu"))
    assert DS.sketch_launches.count == 0 and counters.snapshot()["dispatches"] == 0


def _orient_seqs(n, length=400, seed=5):
    """n sequences from one ancestor at 2%, every other one reverse
    complemented."""
    rng = np.random.RandomState(seed)
    base = np.frombuffer(_random(rng, length), np.uint8)
    out = []
    for i in range(n):
        a = base.copy()
        mut = rng.rand(a.size) < 0.02
        a[mut] = rng.choice(ACGT, int(mut.sum()))
        s = a.tobytes()
        out.append(Sequence(f"s{i}", reverse_complement(s) if i % 2 else s))
    return out


#: route -> (sequences, pairs; None: every ordered pair)
ROUTES = {
    "numpy": (8, None),
    "submatrix": (8, [(0, 2), (0, 3), (1, 2), (1, 3)]),
    "native": (12, [(i, (i + 1) % 12) for i in range(10)]),
}


def _pairs(n, pairs):
    if pairs is None:
        return np.array([(i, j) for i in range(n) for j in range(n) if i != j], dtype=np.int64)
    return np.array(pairs, dtype=np.int64)


def _route(idx, pairs):
    counters.reset()
    membership.orient_routes.reset()
    dec = idx.orient_batch(pairs)
    dist = idx.distance_batch(pairs)
    return dec, dist, counters.snapshot()


@pytest.mark.parametrize("threads", [1, 2])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_cpu_route_builds_host_sets(route, threads):
    """A CPU index builds its sets on the host: `sketches_card` reads 0,
    the kernel is never launched, and `sketches` counts the sets the
    route reads (forward sets of every row and reverse sets of the
    queries; both strands of every row with threads > 1)."""
    n, pairs = ROUTES[route]
    pairs = _pairs(n, pairs)
    idx = OrientationIndex(_orient_seqs(n), threads=threads, device="cpu")
    DS.sketch_launches.reset()
    _, _, snap = _route(idx, pairs)
    assert membership.orient_routes.counts == {route: 1}
    rows, queries = np.unique(pairs), np.unique(pairs[:, 0])
    assert snap["sketches"] == rows.size + (rows.size if threads > 1 else queries.size)
    assert snap["sketches_card"] == 0 and DS.sketch_launches.count == 0


# -- on the card ---------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sketch kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("k,S", [(15, 1000), (15, 64), (15, 1), (21, 1000), (5, 200)])
def test_kernel_sets_equal_the_host_sets(cuda_device, k, S):
    """Both strands of the adversarial batch in one launch: every set
    equal to `np.unique(sketch_stranded(...))`."""
    seqs = sketch_strands(k)
    seq_idx, reverse = _jobs(len(seqs))
    DS.sketch_launches.reset()
    got = DS.stranded_sets(seqs, seq_idx, reverse, k, S, cuda_device)
    assert DS.sketch_launches.count == 1
    want = host_stranded_sets(seqs, seq_idx, reverse, k, S)
    for j, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == np.uint64 and np.array_equal(g, w), (j, g.size, w.size)


def _card_and_cpu(n, threads, length=400):
    seqs = _orient_seqs(n, length)
    return (OrientationIndex(seqs, threads=threads, device="cuda"),
            OrientationIndex(seqs, threads=threads, device="cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("threads", [1, 2])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_card_index_equals_cpu_index(cuda_device, route, threads):
    """Equal decisions and distance hints on each host decision route;
    the card builds every set the route reads in one launch, counted in
    `sketches_card`, and the sets equal the CPU index's."""
    n, pairs = ROUTES[route]
    pairs = _pairs(n, pairs)
    card, cpu = _card_and_cpu(n, threads)
    want_dec, want_dist, want = _route(cpu, pairs)
    DS.sketch_launches.reset()
    dec, dist, snap = _route(card, pairs)
    assert membership.orient_routes.counts == {route: 1}
    assert np.array_equal(dec, want_dec) and np.array_equal(dist, want_dist)
    assert DS.sketch_launches.count == 1
    assert snap["sketches"] == snap["sketches_card"] == want["sketches"] > 0
    for a, b in ((card._fwd_sets, cpu._fwd_sets), (card._rev_sets, cpu._rev_sets)):
        assert [s is None for s in a] == [s is None for s in b]
        assert all(x is None or np.array_equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
def test_card_sets_on_the_device_matrix_route(cuda_device):
    """n = 512, every pair: the device decision matrix, fed the kernel's
    sets, gives exactly what it gives on sets the host built, and the
    CPU index's decisions."""
    n = membership.ORIENT_DEVICE_MIN_N
    pairs = _pairs(n, None)
    card, cpu = _card_and_cpu(n, 1, length=1000)
    host_fed = OrientationIndex(card.sequences, device="cuda")
    for i in range(n):
        host_fed._fwd_set(i)
        host_fed._rev_set(i)
    DS.sketch_launches.reset()
    dec, dist, snap = _route(card, pairs)
    assert membership.orient_routes.counts == {"device": 1}
    assert DS.sketch_launches.count == 1 and snap["sketches_card"] == snap["sketches"] == 2 * n
    dec_h, dist_h, snap_h = _route(host_fed, pairs)
    assert snap_h["sketches"] == 0 and DS.sketch_launches.count == 1
    assert np.array_equal(dec, dec_h) and np.array_equal(dist, dist_h)
    assert np.array_equal(dec, cpu.orient_batch(pairs))
