"""Parity of the port's wavefront checkpoint-replay engine
(allwave_tpu_torch/wfa/wf_segmented.py, plain versions on the CPU) with
the JAX reference (allwave_tpu/wfa/wf_segmented.py: the XLA wavefront,
which tests/test_pallas_wf.py holds equal to the Pallas kernel, and the
Pallas route in interpret mode where a case needs it).

Every comparison is exact: no tolerance. Inputs come from numpy seeds
and go to both packages as numpy arrays; the reference's ring images,
checkpoints and history planes come over through `rows_to_port` and
`buffer_to_ring`. Shapes are small (L <= 768, K 256, C = 32). The
kernels are held against these plain versions on the card by
tests/test_torch_kernels.py and chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from allwave_tpu.core.scores import parse_scores
from allwave_tpu.wfa import batch as JB
from allwave_tpu.wfa import pallas_wf as P
from allwave_tpu.wfa import wf_segmented as W
from allwave_tpu.wfa.params import resolve_penalties
from allwave_tpu_torch.testing.batches import mutate, wavefront_batch
from allwave_tpu_torch.wfa import batch as TB
from allwave_tpu_torch.wfa import wf_segmented as TW
from allwave_tpu_torch.wfa.segmented import narrow_offsets

SCORE_SETS = ["0,5,8,2,24,1", "0,5,8,2", "0,1,1,1"]
_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def _pen(scores_str):
    return resolve_penalties(parse_scores(scores_str))


def _batch(seed, l_pad, K, div=0.03, n_rand=3):
    """wavefront_batch: n_rand mutated pairs, then pairs 3 (identical),
    4 (tlen == l_pad), 5 (infeasible) and 6 (short, h_max = -1)."""
    return wavefront_batch(np.random.RandomState(seed), l_pad, K, div, n_rand)


def _both(arrays):
    return tuple(map(jnp.asarray, arrays)), tuple(map(torch.from_numpy, arrays))


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# batch.py helpers, the mismatch index, the extension, init
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("K", [128, 256])
def test_band_helpers_match_reference(K):
    arrays = _batch(1, 512, K)
    ja, ta = _both(arrays)
    ke_j, k0_j = JB._band_geometry(ja[2], ja[3], K)
    ke_t, k0_t = TB._band_geometry(ta[2], ta[3], K)
    _eq(ke_j, ke_t)
    _eq(k0_j, k0_t)
    for a, b in zip(JB._make_masks(ja[2], ja[3], k0_j, K), TB._make_masks(ta[2], ta[3], k0_t, K)):
        _eq(a, b)
    x = np.random.RandomState(2).randint(-5, 5, (3, 7)).astype(np.int32)
    _eq(JB._shift_left(jnp.asarray(x)), TB._shift_left(torch.from_numpy(x)))
    _eq(JB._shift_right(jnp.asarray(x)), TB._shift_right(torch.from_numpy(x)))
    assert TB.NULL == JB.NULL and (TB._OP_M, TB._OP_X, TB._OP_I, TB._OP_D) == (
        JB._OP_M, JB._OP_X, JB._OP_I, JB._OP_D)


def test_mismatch_index_and_extension_match_reference():
    """The index equals build_mismatch_index bit for bit; the extension
    equals _extend_bm on offsets that cover NULL, h > h_max, the h_max =
    -1 diagonals outside [-qlen, tlen], every offset up to l_pad and the
    tlen == l_pad pair."""
    l_pad, K = 512, 256
    arrays = _batch(3, l_pad, K, div=0.05)
    ja, ta = _both(arrays)
    _, k0_j = JB._band_geometry(ja[2], ja[3], K)
    _, k0_t = TB._band_geometry(ta[2], ta[3], K)
    mmw_j, nxw_j = W.build_mismatch_index(*ja, k0_j, K)
    mmw_t, nxw_t = TW.build_mismatch_index(*ta, k0_t, K)
    _eq(np.asarray(mmw_j).view(np.int32), mmw_t)
    _eq(nxw_j, nxw_t)
    _, hmax_j = JB._make_masks(ja[2], ja[3], k0_j, K)
    hmax = np.array(hmax_j)
    assert (hmax == -1).any() and (hmax == l_pad).any()
    rng = np.random.RandomState(4)
    for _ in range(3):
        h = rng.randint(-3, l_pad + 3, hmax.shape).astype(np.int32)
        h[rng.rand(*h.shape) < 0.1] = TB.NULL
        h[:, ::7] = hmax[:, ::7]
        h[:, 3::7] = hmax[:, 3::7] + 1
        out_j = W._extend_bm(jnp.asarray(h), hmax_j, mmw_j, nxw_j, l_pad)
        out_t = TW._extend_bm(torch.from_numpy(h), torch.from_numpy(hmax), mmw_t, nxw_t, l_pad)
        _eq(out_j, out_t)


@pytest.mark.parametrize("scores_str", SCORE_SETS)
def test_init_matches_reference(scores_str):
    """Seeds, h_max, c_end, feasibility and done/scores after score 0
    equal pallas_wf.wf_init_rows and wf_segmented.wf_init."""
    pen = _pen(scores_str)
    l_pad, K = 512, 256
    ja, ta = _both(_batch(5, l_pad, K))
    mmt, hmax_r, cmask_r, feas, seeds, done0, scores0, c_end, k0 = P.wf_init_rows(*ja, pen, K, P._WS)
    init = TW.wf_init(*ta, pen, K)
    _eq(TW.rows_to_port(seeds, K), init.seeds)
    _eq(TW.rows_to_port(hmax_r, K), init.h_max)
    for a, b in ((feas, init.feasible), (done0, init.done0), (scores0, init.scores0),
                 (c_end, init.c_end), (k0, init.k0)):
        _eq(a, b)
    *_, buf, done_x, scores_x = W.wf_init(*ja, pen, K)
    _eq(TW.buffer_to_ring(buf, pen, 0), init.seeds)
    _eq(done_x, init.done0)
    _eq(scores_x, init.scores0)
    assert bool(init.done0[3]) and not bool(init.feasible[5])


@pytest.mark.parametrize("scores_str", ["0,5,8,2,24,1", "0,1,1,1"])
def test_state_carried_from_reference_layouts(scores_str):
    """rows_to_port takes the reference's rows-layout ring images,
    stacked checkpoints and packed history to the port's layouts value
    for value; a ring image expanded by pallas_wf.ckpt_to_buf comes back
    unchanged through buffer_to_ring."""
    pen = _pen(scores_str)
    offs, deps, P_ = TW.ring_layout(pen)
    rng = np.random.RandomState(6)
    B, K, n = 3, 256, 4
    ck = rng.randint(-9, 99, (n, P_, B, K)).astype(np.int32)
    stacked = {c: P._rows(jnp.asarray(ck[:, o : o + d])) for c, o, d in zip(TW._COMPS, offs, deps)}
    _eq(TW.rows_to_port(stacked, K), ck)
    _eq(TW.rows_to_port({c: v[1] for c, v in stacked.items()}, K), ck[1])
    hist = rng.randint(-9, 99, (n, 5, B, K)).astype(np.int32)
    _eq(TW.rows_to_port(P._rows(jnp.asarray(hist)), K), hist)
    s_lo = 3 * pen.max_lookback
    buf = P.ckpt_to_buf(_ring_rows(ck[2], pen), jnp.int32(s_lo), pen, K, pen.max_lookback + 1)
    _eq(TW.buffer_to_ring(buf, pen, s_lo), ck[2])


# ---------------------------------------------------------------------------
# The span: sweep and history
# ---------------------------------------------------------------------------


def _xla_sweep(ja, pen, K, n_steps, C, with_history=False):
    """The reference XLA sweep in C-level spans: (scores, done, rings,
    hists), rings[j] the ring image at score j*C."""
    mmw, nxw, ks, h_max, c_end, feas, buf, done, scores = W.wf_init(*ja, pen, K)
    rings, hists = [TW.buffer_to_ring(buf, pen, 0)], []
    for seg in range(n_steps // C):
        buf, done, scores, hist = W.wf_span(
            mmw, nxw, ks, h_max, c_end, ja[3], feas, jnp.int32(seg * C), buf, done,
            scores, pen=pen, n_steps=C, with_history=with_history,
        )
        rings.append(TW.buffer_to_ring(buf, pen, (seg + 1) * C))
        if with_history:
            hists.append(np.stack([np.asarray(hist[c]) for c in TW._COMPS], 1))
    return np.asarray(scores), np.asarray(done), rings, hists


@pytest.mark.parametrize("scores_str", SCORE_SETS)
def test_sweep_matches_xla(scores_str):
    """Scores, done and checkpoints of the plain sweep against a wf_span
    loop: every slot a pair's sweep wrote (all slots of pairs not done,
    slot 0 and the slots <= (score-1)//C of done pairs) equals the
    reference's ring image there; the slots after a pair finished stay
    NULL."""
    pen = _pen(scores_str)
    l_pad, K, C, N = 512, 256, 32, 256
    ja, ta = _both(_batch(7, l_pad, K))
    s_x, d_x, rings, _ = _xla_sweep(ja, pen, K, N, C)
    init = TW.wf_init(*ta, pen, K)
    ckpts, hist, done, scores = TW.wf_span_ref(
        *ta, pen, K, l_pad, 0, N, init.seeds, False, ckpt_every=C,
        done=init.done0, scores=init.scores0,
    )
    assert hist is None and tuple(ckpts.shape) == (N // C, 36 if scores_str == SCORE_SETS[0] else ckpts.shape[1], 7, K)
    _eq(s_x, scores)
    _eq(d_x, done)
    assert d_x[:5].all() and d_x[6] and not d_x[5] and s_x[3] == 0
    for b in range(ta[0].shape[0]):
        last = max((int(s_x[b]) - 1) // C, 0) if d_x[b] else N // C - 1
        for j in range(N // C):
            if j <= last:
                _eq(rings[j][:, b], ckpts[j, :, b])
            else:
                assert bool((ckpts[j, :, b] == TW.NULL).all())


@pytest.mark.parametrize("scores_str", SCORE_SETS)
def test_history_span_matches_xla(scores_str):
    """A full-band history span started from a JAX-made checkpoint
    equals wf_span(with_history=True) on all five planes of every
    level."""
    pen = _pen(scores_str)
    l_pad, K, C = 512, 256, 32
    ja, ta = _both(_batch(9, l_pad, K, div=0.06))
    _, _, rings, hists = _xla_sweep(ja, pen, K, 3 * C, C, with_history=True)
    for seg in (0, 2):
        _, hist, _, _ = TW.wf_span_ref(
            *ta, pen, K, l_pad, seg * C, C, torch.from_numpy(rings[seg]), True
        )
        _eq(hists[seg], hist)


# ---------------------------------------------------------------------------
# The walk
# ---------------------------------------------------------------------------


def _ring_rows(ring, pen):
    """A port ring image (P, B, K) as the reference's per-component
    rows-layout dict."""
    offs, deps, _ = TW.ring_layout(pen)
    return {c: P._rows(jnp.asarray(ring[o : o + d])) for c, o, d in zip(TW._COMPS, offs, deps)}


def _walk_j(walk_t, bufs_t):
    w = walk_t.numpy()
    walk = tuple(jnp.asarray(w[i]) for i in range(4)) + (jnp.asarray(w[4] != 0),)
    return walk, tuple(jnp.asarray(b.numpy()) for b in bufs_t)


def _assert_walk_equal(walk_j, bufs_j, walk_t, bufs_t):
    for i, a in enumerate(walk_j):
        np.testing.assert_array_equal(np.asarray(a).astype(np.int64), walk_t[i].numpy().astype(np.int64))
    for a, b in zip(bufs_j, bufs_t):
        _eq(a, b)


@pytest.mark.parametrize("scores_str,run_cap", [("0,5,8,2,24,1", 512), ("0,5,8,2,24,1", 6),
                                                ("0,5,8,2", 64), ("0,1,1,1", 512)])
def test_walk_matches_xla(scores_str, run_cap):
    """Segment by segment from the end to the origin: the walk state and
    run buffers equal wf_traceback_hist's after every segment, on an
    identical pair and with a run_cap small enough to overflow."""
    pen = _pen(scores_str)
    l_pad, K, C = 512, 256, 32
    arrays = _batch(11, l_pad, K)
    ja, ta = _both(arrays)
    s_x, d_x, rings, _ = _xla_sweep(ja, pen, K, 512, C)
    mmw, nxw, ks, h_max, c_end, feas, *_ = W.wf_init(*ja, pen, K)
    cert = d_x
    walk_t = TW.new_walk(torch.from_numpy(np.where(cert, s_x, -1).astype(np.int32)),
                         torch.from_numpy(np.array(c_end)), ta[3], torch.from_numpy(cert))
    bufs_t = TW.new_bufs(len(cert), run_cap, "cpu")
    walk_j, bufs_j = _walk_j(walk_t, bufs_t)
    top = (int(s_x[cert].max()) - 1) // C
    for seg in range(top, -1, -1):
        ring = rings[seg]
        buf = P.ckpt_to_buf(_ring_rows(ring, pen), jnp.int32(seg * C), pen, K, pen.max_lookback + 1)
        _, hist_t, _, _ = TW.wf_span_ref(*ta, pen, K, l_pad, seg * C, C, torch.from_numpy(ring), True)
        hist_j = {c: jnp.asarray(hist_t[:, i].numpy()) for i, c in enumerate(TW._COMPS)}
        walk_j, bufs_j = W.wf_traceback_hist(hist_j, buf, jnp.int32(seg * C), walk_j, bufs_j,
                                             pen=pen, n_steps=C, run_cap=run_cap)
        TW.traceback_window_ref(hist_t, torch.from_numpy(ring), seg * C, walk_t, bufs_t, pen)
        _assert_walk_equal(walk_j, bufs_j, walk_t, bufs_t)
    assert bool(bufs_t[3].any()) == (run_cap < 64)
    assert not bool(walk_t[4].any())


def test_narrow_replay_and_walk_match_pallas():
    """Two backward segments at K = 1024 > k_sub = 512 with B = 2: the
    port's sub-band history span plus walk at per-pair c_lo equal
    wf_replay_tb_narrow (the Pallas span in interpret mode and the XLA
    walk) on the walk state and run buffers."""
    pen = _pen("0,5,8,2,24,1")
    l_pad, K, C, run_cap = 512, 1024, 32, 512
    k_sub = -(-(2 * C + 320) // 512) * 512
    assert k_sub == 512
    arrays = tuple(a[:2].copy() for a in _batch(13, l_pad, 256, div=0.05))
    ja, ta = _both(arrays)
    s_x, d_x, rings, _ = _xla_sweep(ja, pen, K, 256, C)
    assert d_x.all()
    mmt, hmax_r, cmask_r, *_, c_end, _ = P.wf_init_rows(*ja, pen, K, P._WS)
    walk_t = TW.new_walk(torch.from_numpy(s_x.astype(np.int32)), torch.from_numpy(np.array(c_end)),
                         ta[3], torch.ones(2, dtype=torch.bool))
    bufs_t = TW.new_bufs(2, run_cap, "cpu")
    walk_j, bufs_j = _walk_j(walk_t, bufs_t)
    top = (int(s_x.max()) - 1) // C
    for seg in (top, top - 1):
        walk_j, bufs_j = W.wf_replay_tb_narrow(
            mmt, hmax_r, cmask_r, ja[3], _ring_rows(rings[seg], pen), jnp.int32(seg * C),
            walk_j, bufs_j, pen=pen, k_width=K, k_sub=k_sub, l_pad=l_pad, n_steps=C,
            run_cap=run_cap, interpret=True,
        )
        ring = torch.from_numpy(rings[seg])
        c_lo = narrow_offsets(walk_t[1], K, k_sub)
        _, hist, _, _ = TW.wf_span_ref(*ta, pen, K, l_pad, seg * C, C, ring, True, c_lo=c_lo, k_sub=k_sub)
        assert tuple(hist.shape) == (C, 5, 2, k_sub)
        TW.traceback_window_ref(hist, ring, seg * C, walk_t, bufs_t, pen, c_lo=c_lo)
        _assert_walk_equal(walk_j, bufs_j, walk_t, bufs_t)
    assert int(bufs_t[2].max()) > 0


# ---------------------------------------------------------------------------
# The engine, the router and the pipeline
# ---------------------------------------------------------------------------


def _pairs(seed, specs):
    """[(query, target)] bytes, one per (length, divergence, indels)."""
    rng = np.random.RandomState(seed)
    out = []
    for L, div, n_indel in specs:
        q = rng.choice(_BASES, L)
        out.append((q.tobytes(), mutate(rng, q, div, n_indel).tobytes()))
    return out


def _norm(results):
    """(score, per-base cigar bytes) of each result, runs expanded; None
    and the fallback sentinel as they are."""
    return [r if r is None or isinstance(r, str) else
            (int(r[0]), np.asarray(TB.expand_runs(*r[1]) if isinstance(r[1], tuple) else r[1],
                                   np.uint8).tobytes())
            for r in results]


def test_engine_matches_pallas_route(monkeypatch):
    """WavefrontSegmentedAligner against the reference's Pallas route
    (interpret mode): low hints leave the first score cap short and the
    pairs escalate it; a hint past k_max and a certificate past it come
    back as equal DENSE_FALLBACK sentinels; an identical pair walks only
    the origin emit."""
    monkeypatch.setenv("ALLWAVE_WF_INTERPRET", "1")
    pen = _pen("0,5,8,2,24,1")
    pairs = _pairs(17, [(200, 0.03, 2), (180, 0.05, 1), (200, 0.02, 0)])
    q = np.frombuffer(pairs[2][0], np.uint8)
    pairs.append((q.tobytes(), np.delete(q, np.arange(50, 150)).tobytes()))  # a 100-base gap
    pairs.append((pairs[0][0], pairs[0][0]))
    hints = [4, 4, 5000, 4, 4]
    cfg = dict(ckpt_every=32, s_cap_initial=64, k_max=128)
    ref = W.WavefrontSegmentedAligner(pen, W.WfSegConfig(**cfg), impl="pallas")
    TW.wf_stats.reset()
    port = TW.WavefrontSegmentedAligner(pen, TW.WfSegConfig(**cfg), device="cpu")
    res = port.align_pairs(pairs, sigma_hint=hints)
    assert _norm(res) == _norm(ref.align_pairs(pairs, sigma_hint=hints))
    dense = TW.WavefrontSegmentedAligner.DENSE_FALLBACK
    assert res[2] == dense and res[3] == dense and res[4][0] == 0
    assert all(isinstance(r, tuple) for r in (res[0], res[1], res[4]))
    assert [(k, s) for k, s, _ in TW.wf_stats.rounds] == [(128, 64), (128, 256)]
    assert TW.wf_stats.fallbacks == 2


@pytest.mark.parametrize("hint_lo,hint_hi,step", [(0, 600, 1), (600, 40000, 37)])
def test_band_and_cap_rules_match_reference(hint_lo, hint_hi, step):
    pen = _pen("0,5,8,2,24,1")
    ref = W.WavefrontSegmentedAligner(pen, impl="xla")
    port = TW.WavefrontSegmentedAligner(pen, device="cpu")
    assert port.ladder.rungs == ref.K_LADDER and port.ladder.k_max is None
    for hint in range(hint_lo, hint_hi, step):
        assert port._quantize_hint(hint) == ref._quantize_hint(hint)
        assert port._s_cap_for_hint(hint) == ref._s_cap_for_hint(hint)
        assert port.ladder.for_score(hint, hint % 97) == ref._k_for_score(hint, hint % 97)
        assert port.ladder.round(hint) == ref._round_k(hint)
    scores = np.array([3, 900, 2700, 17])
    done = np.array([True, False, True, True])
    assert port._run_cap(scores, done) == ref._run_cap(scores, done) == 16384


def _reference_unified(pen, dense_max_len, wf_cfg):
    from allwave_tpu.wfa import dense_engine as JE
    from allwave_tpu.wfa import segmented as JS

    ua = JE.UnifiedAligner(pen, dense_max_len=dense_max_len, dense_config=JE.DenseConfig(impl="xla"),
                           segmented_config=JS.SegmentedConfig(impl="xla", ckpt_every=64))
    ua.wf_segmented = W.WavefrontSegmentedAligner(pen, W.WfSegConfig(**wf_cfg))
    return ua


def _wfseg_env(monkeypatch):
    for k, v in (("ALLWAVE_WFSEG", "1"), ("ALLWAVE_WF_IMPL", "pallas"), ("ALLWAVE_WF_INTERPRET", "1")):
        monkeypatch.setenv(k, v)


@pytest.mark.parametrize("ref_runs", [False, True])
def test_unified_wavefront_route_matches_reference(monkeypatch, ref_runs):
    """UnifiedAligner with ALLWAVE_WFSEG=1 and dense_max_len lowered:
    the long pairs go to the wavefront engine, those past its k_max fall
    back to the segmented engine, short ones take the dense engine; the
    results and stats equal the reference's (Pallas route, interpret
    mode): the port's runs, expanded, against the reference's per-base
    arrays and, with ref_runs, its runs expanded."""
    from allwave_tpu_torch.wfa import dense_engine as TE
    from allwave_tpu_torch.wfa import segmented as TS

    _wfseg_env(monkeypatch)
    pen = _pen("0,5,8,2,24,1")
    pairs = _pairs(19, [(260, 0.03, 1), (240, 0.2, 3), (60, 0.04, 1), (300, 0.01, 1)])
    hint = [60, 400, 20, 30]
    wf_cfg = dict(ckpt_every=32, k_max=128)
    rj, sj = _reference_unified(pen, 100, wf_cfg).align_pairs(
        pairs, with_stats=True, sigma_hint=hint, as_runs=ref_runs)
    TW.wf_stats.reset()
    ua = TE.UnifiedAligner(pen, dense_max_len=100, device="cpu",
                           segmented_config=TS.SegmentedConfig(ckpt_every=64))
    ua.wf_segmented = TW.WavefrontSegmentedAligner(pen, TW.WfSegConfig(**wf_cfg), pool=ua.pool)
    rt, st = ua.align_pairs(pairs, with_stats=True, sigma_hint=hint)
    assert all(isinstance(c, tuple) for _, c in rt)
    assert _norm(rt) == _norm(rj)
    np.testing.assert_array_equal(st, sj)
    assert TW.wf_stats.fallbacks == 1 and len(TW.wf_stats.rounds) >= 1


def test_router_engines_share_one_pool(monkeypatch):
    """A UnifiedAligner's three engines hold its one sequence pool, and a
    call mixing short and long pairs, some handed back by the wavefront
    engine to the segmented engine at the same l_pad, uploads each
    (pool list, l_pad) once; a second call on the same pool list
    uploads nothing."""
    from allwave_tpu_torch.wfa import dense_engine as TE
    from allwave_tpu_torch.wfa import rounds as TR

    ua = TE.UnifiedAligner(_pen("0,5,8,2,24,1"), dense_max_len=100, device="cpu")
    assert ua.dense.pool is ua.pool and ua.segmented.pool is ua.pool
    assert ua.wf_segmented.pool is ua.pool and ua.pool.device == ua.device
    uploads = []
    upload = TR.SequencePool._upload

    def spy(self, pool_seqs, l_pad):
        uploads.append((id(pool_seqs), l_pad))
        return upload(self, pool_seqs, l_pad)

    monkeypatch.setattr(TR.SequencePool, "_upload", spy)
    monkeypatch.setenv("ALLWAVE_WFSEG", "1")
    ua.wf_segmented = TW.WavefrontSegmentedAligner(
        ua.pen, TW.WfSegConfig(ckpt_every=32, k_max=128), pool=ua.pool)
    # long pairs of 257-512 bases: both long engines pad them to 512
    pairs = _pairs(19, [(280, 0.03, 1), (300, 0.2, 3), (60, 0.04, 1), (290, 0.01, 1)])
    pool_seqs, qidx, tidx = TR.pool_pairs(pairs)
    hint = [60, 400, 20, 30]
    TW.wf_stats.reset()
    first = ua.align_pairs_indexed(pool_seqs, qidx, tidx, sigma_hint=hint)
    assert TW.wf_stats.fallbacks == 1 and len(TW.wf_stats.rounds) >= 1
    assert sorted(uploads) == [(id(pool_seqs), 64), (id(pool_seqs), 512)]
    again = ua.align_pairs_indexed(pool_seqs, qidx, tidx, sigma_hint=hint)
    assert len(uploads) == 2 and _norm(again) == _norm(first)


def test_all_pair_aligner_wavefront_route_matches_reference(monkeypatch, tmp_path):
    """AllPairAligner (mash hints, orientation) with ALLWAVE_WFSEG=1 and
    the long-pair threshold lowered in both packages: identical sorted
    PAF lines, some pairs through the wavefront engine and some falling
    back."""
    import allwave_tpu as R
    import allwave_tpu_torch as T
    from allwave_tpu.testing.synth import MutationConfig, make_test_case
    from allwave_tpu.wfa import dense_engine as JE
    from allwave_tpu_torch.wfa import dense_engine as TE

    wf_cfg = dict(ckpt_every=32, k_max=128)
    init_j, init_t = JE.UnifiedAligner.__init__, TE.UnifiedAligner.__init__

    def low_j(self, pen, *a, **kw):
        kw["dense_max_len"] = 200
        init_j(self, pen, *a, **kw)
        self.wf_segmented = W.WavefrontSegmentedAligner(pen, W.WfSegConfig(**wf_cfg))

    def low_t(self, pen, *a, **kw):
        kw["dense_max_len"] = 200
        init_t(self, pen, *a, **kw)
        self.wf_segmented = TW.WavefrontSegmentedAligner(pen, TW.WfSegConfig(**wf_cfg), pool=self.pool)

    monkeypatch.setattr(JE.UnifiedAligner, "__init__", low_j)
    monkeypatch.setattr(TE.UnifiedAligner, "__init__", low_t)
    _wfseg_env(monkeypatch)
    path = tmp_path / "long.fa"
    make_test_case(23, 4, 260, MutationConfig(0.05, 0.004, 0.004)).write_fasta(str(path))

    def collect(pkg):
        seqs = pkg.read_fasta(str(path))
        out = []
        pkg.process_alignments_with_callback(
            seqs, pkg.parse_scores("0,5,8,2,24,1"), pkg.NoSparsification(),
            lambda r: out.append(pkg.alignment_to_paf(r, seqs)),
        )
        return sorted(out)

    monkeypatch.setenv("ALLWAVE_PLATFORM", "cpu")
    TW.wf_stats.reset()
    port = collect(T)
    assert len(port) == 12 and port == collect(R)
    assert 0 < TW.wf_stats.fallbacks < 12
