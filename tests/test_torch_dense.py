"""Parity of the port's dense forward, traceback and packed result
(allwave_tpu_torch/wfa/dense.py) with the JAX reference
(allwave_tpu/wfa/dense.py and the Pallas kernels in interpret mode).

Every comparison is exact: the tie-break contract (docs/TIEBREAK.md)
leaves no tolerance. Inputs are made from numpy seeds and handed to
both packages. The kernels themselves are held against these plain
versions on the card by tests/test_torch_kernels.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from allwave_tpu.core.scores import parse_scores
from allwave_tpu.wfa import dense as JD
from allwave_tpu.wfa import pallas_dense as JP
from allwave_tpu.wfa.params import resolve_penalties
from allwave_tpu_torch.testing.batches import random_batch
from allwave_tpu_torch.wfa import dense as TD

SCORE_SETS = ["0,5,8,2,24,1", "0,4,6,2", "0,1,1,1"]


def _both(arrays):
    return tuple(map(jnp.asarray, arrays)), tuple(map(torch.from_numpy, arrays))


def _eq(jax_arr, torch_t):
    np.testing.assert_array_equal(np.asarray(jax_arr), torch_t.numpy())


@pytest.mark.parametrize(
    "scores_str,K,l_pad,div",
    [(s, 128, 128, 0.05) for s in SCORE_SETS]
    + [("0,5,8,2,24,1", 384, 256, 0.15), ("0,5,8,2,24,1", 512, 128, 0.2)],
)
def test_forward_ref_matches_xla(scores_str, K, l_pad, div):
    """Scores, certificates and the FULL plane (every byte, reachable
    or not) equal the XLA scan's; K=384 is a wide band, K=512 covers
    the whole matrix."""
    pen = resolve_penalties(parse_scores(scores_str))
    batch = random_batch(np.random.RandomState(11), 5, (3 * l_pad) // 4, l_pad, div)
    ja, ta = _both(batch)
    s_j, c_j, p_j = JD.dense_forward(*ja, pen, K, l_pad, True)
    s_t, c_t, p_t = TD.dense_forward_ref(*ta, pen, K, l_pad)
    _eq(s_j, s_t)
    _eq(c_j, c_t)
    assert p_t.dtype == torch.uint16 and tuple(p_t.shape) == (2 * l_pad, 5, K)
    _eq(p_j, p_t)
    assert bool(c_t.all())


def test_forward_ref_uncertified_and_infeasible():
    """A band too narrow for the length difference gives INF and no
    certificate; a divergent pair gives a banded score without one."""
    pen = resolve_penalties(parse_scores("0,5,8,2,24,1"))
    rng = np.random.RandomState(5)
    l_pad, K = 256, 128
    qs = np.zeros((3, l_pad), np.uint8)
    ts = np.zeros((3, l_pad), np.uint8)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    qs[0, :200] = rng.choice(bases, 200)
    ts[0, :40] = rng.choice(bases, 40)  # |k_end| = 160 > K-1: infeasible
    qs[1, :200] = rng.choice(bases, 200)
    ts[1, :200] = rng.choice(bases, 200)  # unrelated: no certificate
    qs[2, :10] = rng.choice(bases, 10)
    ts[2, :12] = qs[2, :12]
    batch = (qs, ts, np.array([200, 200, 10], np.int32), np.array([40, 200, 12], np.int32))
    ja, ta = _both(batch)
    s_j, c_j, p_j = JD.dense_forward(*ja, pen, K, l_pad, True)
    s_t, c_t, p_t = TD.dense_forward_ref(*ta, pen, K, l_pad)
    _eq(s_j, s_t)
    _eq(c_j, c_t)
    _eq(p_j, p_t)
    assert int(s_t[0]) >= TD.INF and not bool(c_t[0]) and not bool(c_t[1])


@pytest.mark.parametrize("K,l_pad", [(128, 128), (320, 256), (512, 128)])
def test_band_geometry_matches_reference(K, l_pad):
    rng = np.random.RandomState(K)
    ql = rng.randint(0, l_pad + 1, 64).astype(np.int32)
    tl = rng.randint(0, l_pad + 1, 64).astype(np.int32)
    ref = JD._band_geometry(jnp.asarray(ql), jnp.asarray(tl), K)
    port = TD.band_geometry(torch.from_numpy(ql), torch.from_numpy(tl), K)
    for a, b in zip(ref, port):
        _eq(a, b)


@pytest.mark.parametrize("scores_str", SCORE_SETS)
def test_forward_ref_matches_pallas_t(scores_str):
    """Against the Pallas kernel that runs every first dispatch
    (_forward_t, transposed planes), in interpret mode, through the
    traceback: the planes' layouts differ, the walks must not."""
    pen = resolve_penalties(parse_scores(scores_str))
    l_pad = K = 128
    batch = random_batch(np.random.RandomState(11), 5, 96, l_pad)
    ja, ta = _both(batch)
    s_p, c_p, p_p = JP._forward_t(*ja, pen, K, l_pad, True, interpret=True)
    s_t, c_t, p_t = TD.dense_forward_ref(*ta, pen, K, l_pad)
    _eq(s_p, s_t)
    _eq(c_p, c_t)
    run_cap = 2 * l_pad + 8
    ref = JD.dense_traceback(
        p_p, s_p, ja[2], ja[3], pen, run_cap, k_width=K, transposed=True
    )
    port = TD.dense_traceback_ref(p_t, s_t, ta[2], ta[3], run_cap)
    for a, b in zip(ref, port):
        _eq(a, b)


@pytest.mark.parametrize("K,l_pad,div", [(384, 256, 0.15), (512, 128, 0.2)])
def test_forward_ref_matches_pallas_c2(K, l_pad, div):
    """Against the parity-compressed Pallas kernel of the escalation
    bands (_forward_c2), in interpret mode, through the traceback."""
    pen = resolve_penalties(parse_scores("0,5,8,2,24,1"))
    batch = random_batch(np.random.RandomState(17), 5, (3 * l_pad) // 4, l_pad, div)
    ja, ta = _both(batch)
    s_p, c_p, p_p = JP._forward_c2(*ja, pen, K, l_pad, True, interpret=True)
    s_t, c_t, p_t = TD.dense_forward_ref(*ta, pen, K, l_pad)
    _eq(s_p, s_t)
    _eq(c_p, c_t)
    run_cap = 2 * l_pad + 8
    ref = JD.dense_traceback(
        p_p, s_p, ja[2], ja[3], pen, run_cap, k_width=K, compressed=True
    )
    port = TD.dense_traceback_ref(p_t, s_t, ta[2], ta[3], run_cap)
    for a, b in zip(ref, port):
        _eq(a, b)


@pytest.mark.parametrize(
    "scores_str,K,l_pad,div,run_cap",
    [
        ("0,5,8,2,24,1", 128, 128, 0.05, 264),
        ("0,5,8,2,24,1", 128, 128, 0.05, 5),  # overflows: drops, nrun counts
        ("0,4,6,2", 128, 256, 0.1, 32),
        ("0,1,1,1", 256, 128, 0.15, 7),
        ("0,5,8,2,24,1", 384, 256, 0.15, 3),
    ],
)
def test_traceback_and_packed_match_reference(scores_str, K, l_pad, div, run_cap):
    """dense_traceback_ref equals the XLA walk (ops, lens, nruns,
    overflow) and dense_align_packed's bytes equal the reference's,
    run-cap overflow included."""
    pen = resolve_penalties(parse_scores(scores_str))
    rng = np.random.RandomState(run_cap)
    qs, ts, ql, tl = random_batch(rng, 6, (3 * l_pad) // 4, l_pad, div)
    ja, ta = _both((qs, ts, ql, tl))
    s_j, c_j, p_j = JD.dense_forward(*ja, pen, K, l_pad, True)
    s_t, c_t, p_t = TD.dense_forward_ref(*ta, pen, K, l_pad)
    ref = JD.dense_traceback(p_j, s_j, ja[2], ja[3], pen, run_cap)
    port = TD.dense_traceback_ref(p_t, s_t, ta[2], ta[3], run_cap)
    for a, b in zip(ref, port):
        _eq(a, b)
    if run_cap < 8:
        assert bool(port[3].any())

    # pooled form: pairs gather their rows from one pool, some rows shared
    pool = np.concatenate([qs, ts])
    qi = np.array([0, 1, 2, 3, 4, 5, 6], np.int32)
    ti = np.array([6, 7, 8, 9, 10, 11, 0], np.int32)
    lens = np.concatenate([ql, tl])
    qln, tln = lens[qi], lens[ti]
    packed_j = JD.dense_align_packed(
        *map(jnp.asarray, (pool, qi, ti, qln, tln)), pen, K, l_pad, run_cap
    )
    packed_t = TD.dense_align_packed(
        torch.from_numpy(pool),
        torch.from_numpy(qi).long(),
        torch.from_numpy(ti).long(),
        torch.from_numpy(qln),
        torch.from_numpy(tln),
        pen,
        K,
        l_pad,
        run_cap,
    )
    assert packed_t.dtype == torch.uint8
    assert tuple(packed_t.shape) == (7, 32 + (run_cap + 3) // 4 + run_cap)
    _eq(packed_j, packed_t)


def test_cpu_wrappers_use_plain_versions_and_do_not_count():
    """On CPU tensors the wrappers run the plain versions: the results
    equal them, and no kernel launch is counted."""
    pen = resolve_penalties(parse_scores("0,5,8,2,24,1"))
    qs, ts, ql, tl = map(
        torch.from_numpy, random_batch(np.random.RandomState(2), 3, 60, 64)
    )
    before = (TD.forward_launches.count, TD.traceback_launches.count)
    s, c, p = TD.dense_forward(qs, ts, ql, tl, pen, 128, 64)
    s2, c2, p2 = TD.dense_forward_ref(qs, ts, ql, tl, pen, 128, 64)
    assert torch.equal(s, s2) and torch.equal(c, c2) and torch.equal(p, p2)
    out = TD.dense_traceback(p, s, c, ql, tl, 16)
    ref = TD.pack_alignments(s, c, *TD.dense_traceback_ref(p, s, ql, tl, 16))
    assert torch.equal(out, ref)
    assert (TD.forward_launches.count, TD.traceback_launches.count) == before


def test_cuda_wrappers_reject_bad_inputs_without_fallback():
    """A tensor on a device the kernels do not serve raises."""
    pen = resolve_penalties(parse_scores("0,5,8,2,24,1"))
    meta = torch.zeros((2, 64), dtype=torch.uint8, device="meta")
    lens = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        TD.dense_forward(meta, meta, lens, lens, pen, 128, 64)
