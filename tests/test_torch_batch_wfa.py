"""Parity of the port's batched wavefront engine (allwave_tpu_torch/wfa/
batch.py, engine.py, parallel/mesh.py sharded_alignment_step) and of its
facade with the reference (allwave_tpu/wfa/batch.py, engine.py), on the
CPU: the plain versions of csrc/wf_batch.cu's kernels against the XLA
loops on JAX's CPU backend, on the same numpy inputs, with tolerance 0
(int32 and bytes). History planes are compared on their defined rows
(wfa/batch.py: rows above a finished pair's score are don't-care). The
kernels are held to these plain versions on the card by
tests/test_torch_kernels.py."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from allwave_tpu.core.scores import parse_scores
from allwave_tpu.wfa import batch as RB
from allwave_tpu.wfa import engine as RE
from allwave_tpu.wfa.params import resolve_penalties
from allwave_tpu_torch.wfa import batch as TB
from allwave_tpu_torch.wfa import engine as TE

from test_batch_wfa import _mutate, _pairs_suite, _random_dna

PENS = {s: resolve_penalties(parse_scores(s)) for s in ("0,1,1,1", "0,5,8,2", "0,5,8,2,24,1")}
PEN_IDS = {"0,1,1,1": "edit", "0,5,8,2": "affine", "0,5,8,2,24,1": "2p"}


def _suite_batch(pairs):
    """The reference engine's batch for `pairs`: padded to a power of two
    with empty pairs, rows to a power of two; numpy arrays."""
    b_pad = RE.BatchWavefrontAligner._next_pow2(len(pairs))
    pairs = pairs + [(b"", b"")] * (b_pad - len(pairs))
    longest = max(max(len(q), len(t)) for q, t in pairs)
    l_pad = max(RE.BatchWavefrontAligner._next_pow2(max(longest, 4)), TB.L_ALIGN)
    qs = RE.BatchWavefrontAligner._pad_batch([q for q, _ in pairs], l_pad)
    ts = RE.BatchWavefrontAligner._pad_batch([t for _, t in pairs], l_pad)
    qlens = np.array([len(q) for q, _ in pairs], np.int32)
    tlens = np.array([len(t) for _, t in pairs], np.int32)
    return qs, ts, qlens, tlens


def _defined_rows(scores, done, S1):
    """(S1, B, 1) bool: the history rows the port defines."""
    lim = np.where(done, scores, S1 - 1)
    return (np.arange(S1)[:, None] <= lim[None, :])[:, :, None]


def _assert_hist_equal(t_hist, r_hist, scores, done):
    rows = _defined_rows(scores, done, t_hist["m"].shape[0])
    for c in TB.COMPS:
        t, r = t_hist[c].numpy(), np.asarray(r_hist[c])
        assert t.shape == r.shape, c
        np.testing.assert_array_equal(np.where(rows, t, 0), np.where(rows, r, 0), err_msg=c)


@pytest.mark.parametrize("L", [4, 5, 16, 33])
def test_pack_quads_matches_reference(L):
    seqs = np.random.RandomState(L).randint(0, 256, size=(3, L)).astype(np.uint8)
    np.testing.assert_array_equal(
        TB.pack_quads(torch.from_numpy(seqs)).numpy(), np.asarray(RB.pack_quads(jnp.asarray(seqs)))
    )


@pytest.mark.parametrize("with_history", [False, True], ids=["scores", "history"])
@pytest.mark.parametrize("scores_str", list(PENS), ids=list(PEN_IDS.values()))
def test_forward_matches_reference(scores_str, with_history):
    """The suite with empty, padded, unfinished (s_cap 40) and infeasible
    (|k_end| > K - 1 at K = 33) pairs: scores, done and the defined
    history rows."""
    pen = PENS[scores_str]
    batch = _suite_batch(_pairs_suite())
    s_cap, K = 40, 33
    t_sc, t_done, t_hist = TB.wavefront_forward(
        *(torch.from_numpy(a) for a in batch), pen, s_cap, K, with_history
    )
    r_sc, r_done, r_hist = RB.wavefront_forward(
        *(jnp.asarray(a) for a in batch), pen, s_cap, K, with_history
    )
    np.testing.assert_array_equal(t_sc.numpy(), np.asarray(r_sc))
    np.testing.assert_array_equal(t_done.numpy(), np.asarray(r_done))
    assert not t_done.all() and t_done.any()
    if with_history:
        _assert_hist_equal(t_hist, r_hist, t_sc.numpy(), t_done.numpy())
    else:
        assert t_hist is None


@pytest.mark.parametrize("run_cap", [2 * 64 + 16, 4], ids=["fits", "overflows"])
@pytest.mark.parametrize("scores_str", list(PENS), ids=list(PEN_IDS.values()))
def test_traceback_matches_reference(scores_str, run_cap):
    """ops, lens, nruns and overflow of each package's walk over its own
    history, with a run cap that fits and one that overflows."""
    pen = PENS[scores_str]
    batch = _suite_batch(_pairs_suite())
    t_in = [torch.from_numpy(a) for a in batch]
    r_in = [jnp.asarray(a) for a in batch]
    t_sc, _, t_hist = TB.wavefront_forward(*t_in, pen, 64, 129, True)
    r_sc, _, r_hist = RB.wavefront_forward(*r_in, pen, 64, 129, True)
    got = TB.wavefront_traceback(t_hist, t_sc, t_in[2], t_in[3], pen, run_cap)
    want = RB.wavefront_traceback(r_hist, r_sc, r_in[2], r_in[3], pen, run_cap)
    for g, w, name in zip(got, want, ("ops", "lens", "nruns", "overflow")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert bool(got[3].any()) == (run_cap == 4)


def _same_results(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            assert g is not None and g[0] == w[0]
            assert g[1].tobytes() == w[1].tobytes()


@pytest.mark.parametrize("scores_str", list(PENS), ids=list(PEN_IDS.values()))
def test_align_pairs_matches_reference(scores_str):
    pen = PENS[scores_str]
    pairs = _pairs_suite()
    _same_results(TE.BatchWavefrontAligner(pen, device="cpu").align_pairs(pairs),
                  RE.BatchWavefrontAligner(pen).align_pairs(pairs))


def test_discover_scores_matches_reference():
    pen = PENS["0,5,8,2,24,1"]
    pairs = _pairs_suite(3)
    got = TE.BatchWavefrontAligner(pen, device="cpu").discover_scores(pairs)
    np.testing.assert_array_equal(got, RE.BatchWavefrontAligner(pen).discover_scores(pairs))


def test_escalation_matches_reference():
    """A pair past the initial cap of 16 escalates by 4x (the reference
    test's case)."""
    rng = np.random.RandomState(11)
    q = _random_dna(rng, 400)
    t = _mutate(rng, q, n_snp=40, n_ins=3, n_del=3)
    pen = PENS["0,5,8,2,24,1"]
    got = TE.BatchWavefrontAligner(pen, TE.EngineConfig(s_cap_initial=16, s_cap_growth=4),
                                   device="cpu").align_pairs([(q, t)])
    want = RE.BatchWavefrontAligner(pen, RE.EngineConfig(s_cap_initial=16, s_cap_growth=4)
                                    ).align_pairs([(q, t)])
    _same_results(got, want)
    assert got[0][0] > 64


def test_past_s_cap_max_fails_as_reference():
    """A pair needing more than s_cap_max scores -1 and aligns to None,
    beside one that fits."""
    rng = np.random.RandomState(5)
    q = _random_dna(rng, 120)
    pairs = [(q, _mutate(rng, q, n_snp=30)), (q, q)]
    pen = PENS["0,5,8,2"]
    kw = dict(s_cap_initial=16, s_cap_growth=2, s_cap_max=32)
    t = TE.BatchWavefrontAligner(pen, TE.EngineConfig(**kw), device="cpu")
    r = RE.BatchWavefrontAligner(pen, RE.EngineConfig(**kw))
    scores = t.discover_scores(pairs)
    np.testing.assert_array_equal(scores, r.discover_scores(pairs))
    assert scores.tolist() == [-1, 0]
    got = t.align_pairs(pairs)
    _same_results(got, r.align_pairs(pairs))
    assert got[0] is None


def test_longer_sequences_smoke_matches_reference():
    """The reference test's 2,000-base two-piece pair."""
    rng = np.random.RandomState(21)
    q = _random_dna(rng, 2000)
    t = _mutate(rng, q, n_snp=20, n_ins=3, n_del=3)
    pen = PENS["0,5,8,2,24,1"]
    _same_results(TE.BatchWavefrontAligner(pen, device="cpu").align_pairs([(q, t)]),
                  RE.BatchWavefrontAligner(pen).align_pairs([(q, t)]))


def test_expand_runs_batch_matches_reference():
    rng = np.random.RandomState(2)
    ops = rng.choice(np.frombuffer(b"MXID", np.uint8), size=(5, 12))
    lens = rng.randint(0, 4, size=(5, 12)).astype(np.int32)
    nruns = np.array([0, 12, 5, 1, 7], np.int32)
    for g, w in zip(TB.expand_runs_batch(ops, lens, nruns), RB.expand_runs_batch(ops, lens, nruns)):
        np.testing.assert_array_equal(g, w)
    for j in range(5):
        np.testing.assert_array_equal(TB.expand_runs_to_cigar(ops[j], lens[j], int(nruns[j])),
                                      RB.expand_runs_to_cigar(ops[j], lens[j], int(nruns[j])))


def test_sharded_alignment_step_matches_one_device():
    """Three CPU devices (a batch of 9, padded to 12) give the single
    device's outputs, and those are the reference's forward + walk."""
    from allwave_tpu_torch.parallel.mesh import sharded_alignment_step

    pen = PENS["0,5,8,2,24,1"]
    qs, ts, ql, tl = _suite_batch(_pairs_suite(7))
    batch = [torch.from_numpy(a[:9]) for a in (qs, ts, ql, tl)]
    one = sharded_alignment_step(["cpu"], pen, 64, 129)(*batch)
    three = sharded_alignment_step(["cpu"] * 3, pen, 64, 129)(*batch)
    for a, b in zip(one, three):
        assert torch.equal(a, b)
    r_in = [jnp.asarray(a.numpy()) for a in batch]
    r_sc, _, r_hist = RB.wavefront_forward(*r_in, pen, 64, 129, True)
    want = (r_sc, *RB.wavefront_traceback(r_hist, r_sc, r_in[2], r_in[3], pen, 2 * 64 + 16))
    for g, w in zip(one, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# -- the facade ------------------------------------------------------------


def _params(fn):
    return list(inspect.signature(fn).parameters.values())


@pytest.mark.parametrize("cls", ["AllPairAligner", "UnifiedAligner"])
def test_facade_parameters_follow_reference(cls):
    """The reference's parameters in its order; the port's own ones after
    them, keyword-only."""
    if cls == "AllPairAligner":
        from allwave_tpu.engine.pipeline import AllPairAligner as R
        from allwave_tpu_torch.engine.pipeline import AllPairAligner as T
    else:
        from allwave_tpu.wfa.dense_engine import UnifiedAligner as R
        from allwave_tpu_torch.wfa.dense_engine import UnifiedAligner as T
    ref, port = _params(R.__init__), _params(T.__init__)
    assert [p.name for p in port[: len(ref)]] == [p.name for p in ref]
    assert all(p.kind == inspect.Parameter.KEYWORD_ONLY for p in port[len(ref):])
    assert "device" in [p.name for p in port[len(ref):]]


def test_engine_config_reaches_the_wavefront_engine(monkeypatch):
    """AllPairAligner's engine_config is every UnifiedAligner's
    wavefront config: the streaming, iterating and WFA-orientation paths."""
    from allwave_tpu_torch.core.scores import parse_scores as tparse
    from allwave_tpu_torch.core.types import Sequence as TSeq
    from allwave_tpu_torch.engine import pipeline as TP
    from allwave_tpu_torch.wfa.dense_engine import UnifiedAligner

    made = []

    class Recorded(UnifiedAligner):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(TP, "UnifiedAligner", Recorded)
    cfg = TE.EngineConfig(s_cap_initial=16)
    seqs = [TSeq("a", b"ACGTACGTACGGT"), TSeq("b", b"ACGTTCGTACGT"), TSeq("c", b"ACGAACGTAGGT")]
    al = TP.AllPairAligner(seqs, tparse("0,5,8,2,24,1"), engine_config=cfg)
    al.for_each_with_callback(lambda r: None)
    list(al)
    al._orient_wfa(al.get_pairs()[:2])
    assert len(made) == 3
    assert all(u.wavefront.config is cfg and u.wavefront.device == u.device for u in made)
    u = UnifiedAligner(PENS["0,1,1,1"], 100, None, cfg, device="cpu")
    assert u.wavefront.config is cfg and u.dense_max_len == 100


def test_reference_positional_call_gives_reference_paf(tmp_path):
    """The reference's nine AllPairAligner parameters by position, the
    7th an EngineConfig, in both packages: the same PAF lines."""
    import allwave_tpu as R
    import allwave_tpu_torch as T
    from allwave_tpu.testing.synth import MutationConfig, make_test_case

    path = tmp_path / "x.fa"
    make_test_case(16, 3, 300, MutationConfig(0.03, 0.003, 0.003)).write_fasta(str(path))

    def collect(pkg, engine_config):
        seqs = pkg.read_fasta(str(path))
        params = pkg.parse_scores("0,5,8,2,24,1")
        al = pkg.AllPairAligner(seqs, params, True, True, pkg.NoSparsification(),
                                pkg.AlignmentParams.edit_distance(), engine_config, 4, 1)
        out = []
        al.for_each_with_callback(lambda r: out.append(pkg.alignment_to_paf(r, seqs)))
        return sorted(out)

    got = collect(T, TE.EngineConfig(s_cap_initial=16))
    assert got == collect(R, RE.EngineConfig(s_cap_initial=16))
    assert len(got) == 6
