"""The hand-written CUDA kernels against their plain PyTorch versions
(allwave_tpu_torch/wfa/dense.py, segmented.py and wf_segmented.py, and
the probes of allwave_tpu_torch/probes), on the card. The plain versions
are held to the JAX reference on the CPU by tests/test_torch_dense.py,
test_torch_segmented.py, test_torch_wavefront.py and
test_torch_probes.py.

Every test here needs a CUDA device, is marked `cuda` and skips without
one. This file imports no JAX, so it also runs on a machine that has
none (from the repository root):

    ALLWAVE_TEST_TPU=1 python -m pytest tests/test_torch_kernels.py -m cuda
"""

import numpy as np
import pytest
import torch

from allwave_tpu_torch.core.scores import parse_scores
from allwave_tpu_torch.testing.batches import random_batch
from allwave_tpu_torch.wfa import dense as TD
from allwave_tpu_torch.wfa.params import resolve_penalties

SCORE_SETS = ["0,5,8,2,24,1", "0,4,6,2", "0,1,1,1"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "scores_str,K,l_pad,div",
    [(s, 128, 256, 0.05) for s in SCORE_SETS]
    + [("0,5,8,2,24,1", 3072, 1024, 0.1), ("0,5,8,2,24,1", 6144, 512, 0.2)],
)
def test_forward_kernel_matches_plain(cuda_device, scores_str, K, l_pad, div):
    pen = resolve_penalties(parse_scores(scores_str))
    qs, ts, ql, tl = (
        torch.from_numpy(a).to(cuda_device)
        for a in random_batch(np.random.RandomState(K), 8, (3 * l_pad) // 4, l_pad, div)
    )
    n0 = TD.forward_launches.count
    s_k, c_k, p_k = TD.dense_forward(qs, ts, ql, tl, pen, K, l_pad)
    torch.cuda.synchronize()
    assert TD.forward_launches.count == n0 + 1
    s_p, c_p, p_p = TD.dense_forward_ref(qs, ts, ql, tl, pen, K, l_pad)
    assert torch.equal(s_k, s_p) and torch.equal(c_k, c_p)
    assert torch.equal(p_k, p_p)


@pytest.mark.cuda
@pytest.mark.parametrize("run_cap", [264, 4])
def test_traceback_kernel_matches_plain(cuda_device, run_cap):
    pen = resolve_penalties(parse_scores("0,5,8,2,24,1"))
    qs, ts, ql, tl = (
        torch.from_numpy(a).to(cuda_device)
        for a in random_batch(np.random.RandomState(9), 16, 96, 128, 0.1)
    )
    s, c, p = TD.dense_forward(qs, ts, ql, tl, pen, 128, 128)
    out = TD.dense_traceback(p, s, c, ql, tl, run_cap)
    torch.cuda.synchronize()
    ref = TD.pack_alignments(s, c, *TD.dense_traceback_ref(p, s, ql, tl, run_cap))
    assert torch.equal(out, ref)


@pytest.mark.cuda
def test_main_path_launches_kernels_and_matches_cpu(cuda_device):
    """The engine on the card runs both kernels and gives the same
    results as on the CPU, escalation included."""
    from allwave_tpu_torch.wfa.dense_engine import UnifiedAligner

    pen = resolve_penalties(parse_scores("0,5,8,2,24,1"))
    rng = np.random.RandomState(21)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    pairs = []
    for div in (0.01, 0.02, 0.2, 0.3):
        q = rng.choice(bases, 300)
        t = q.copy()
        mut = rng.rand(t.size) < div
        t[mut] = rng.choice(bases, mut.sum())
        pairs.append((q.tobytes(), t.tobytes()))
    TD.forward_launches.reset()
    TD.traceback_launches.reset()
    gpu = UnifiedAligner(pen, device=cuda_device).align_pairs(pairs, with_stats=True)
    assert TD.forward_launches.count > 1 and TD.traceback_launches.count > 1
    assert TD.forward_launches.widest_k > 128
    cpu = UnifiedAligner(pen, device="cpu").align_pairs(pairs, with_stats=True)
    assert [(r[0], bytes(r[1])) for r in gpu[0]] == [(r[0], bytes(r[1])) for r in cpu[0]]
    np.testing.assert_array_equal(gpu[1], cpu[1])


@pytest.mark.cuda
def test_edge_pairs_match_cpu(cuda_device):
    """Lengths from 1 to 300 (bands up to full cover), N runs, IUPAC
    codes: the kernels give the CPU results."""
    from allwave_tpu_torch.wfa.dense_engine import UnifiedAligner

    rng = np.random.RandomState(3)
    a = rng.choice(list(b"ACGT"), 300).astype(np.uint8).tobytes()
    seqs = [a, a[:100] + a[140:], a[:5], a.lower()[:200] + b"NNNNN" + a[205:],
            b"ACGTRYKM" * 10, a[::-1], b"A"]
    pairs = [(q, t) for q in seqs for t in seqs if q is not t]
    for scores in ("0,5,8,2,24,1", "0,1,1,1"):
        pen = resolve_penalties(parse_scores(scores))
        gpu = UnifiedAligner(pen, device=cuda_device).align_pairs(pairs, with_stats=True)
        cpu = UnifiedAligner(pen, device="cpu").align_pairs(pairs, with_stats=True)
        assert [(r[0], bytes(r[1])) for r in gpu[0]] == [
            (r[0], bytes(r[1])) for r in cpu[0]
        ]
        np.testing.assert_array_equal(gpu[1], cpu[1])


def _segment_inputs(device, scores_str, B, l_pad, K, C, seed, div):
    """A random batch and its kernel-made checkpoints."""
    from allwave_tpu_torch.wfa import segmented as TS

    pen = resolve_penalties(parse_scores(scores_str))
    qs, ts, ql, tl = (
        torch.from_numpy(a).to(device)
        for a in random_batch(np.random.RandomState(seed), B, (7 * l_pad) // 8, l_pad, div,
                              min_len=(3 * l_pad) // 4)
    )
    _, cert, ckpts = TS.dense_sweep_ckpt(qs, ts, ql, tl, pen, K, l_pad, C)
    return pen, (qs, ts, ql, tl), cert, ckpts


@pytest.mark.cuda
@pytest.mark.parametrize(
    "scores_str,K,k_sub", [("0,5,8,2,24,1", 1024, None), ("0,5,8,2,24,1", 1024, 640),
                           ("0,1,1,1", 512, None), ("0,5,8,2,24,1", 6144, 896)],
)
def test_span_kernel_matches_plain(cuda_device, scores_str, K, k_sub):
    """States and planes of one span at d_lo > 0, with and without
    planes, at full band and on a sub-band (K = 6144 keeps the bands in
    the global scratch)."""
    from allwave_tpu_torch.wfa import segmented as TS

    l_pad, C = 1024, 128
    pen, batch, _, ckpts = _segment_inputs(cuda_device, scores_str, 4, l_pad, K, C, K, 0.05)
    seg = 5
    c_lo = None
    if k_sub is not None:
        c_lo = torch.tensor([0, 128, 256, K - k_sub], dtype=torch.int32, device=cuda_device)
    n0 = TS.span_launches.count
    for planes in (True, False):
        st_k, pl_k = TS.dense_span(*batch, pen, K, l_pad, seg * C, C, ckpts[:, seg], planes,
                                   c_lo=c_lo, k_sub=k_sub)
        st_p, pl_p = TS.dense_span_ref(*batch, pen, K, l_pad, seg * C, C, ckpts[:, seg], planes,
                                       c_lo=c_lo, k_sub=k_sub)
        torch.cuda.synchronize()
        assert torch.equal(st_k, st_p)
        assert (pl_k is None and pl_p is None) or torch.equal(pl_k, pl_p)
    assert TS.span_launches.count == n0 + 2


@pytest.mark.cuda
@pytest.mark.parametrize("run_cap,k_sub", [(512, None), (3, None), (512, 640)])
def test_segment_traceback_kernel_matches_plain(cuda_device, run_cap, k_sub):
    """Walk state and run buffers after every segment, from the end cell
    to the origin, over the kernel's planes; run_cap 3 overflows."""
    from allwave_tpu_torch.wfa import segmented as TS
    from allwave_tpu_torch.wfa.dense import band_geometry

    l_pad, K, C, B = 1024, 1024, 128, 6
    pen, batch, cert, ckpts = _segment_inputs(cuda_device, "0,5,8,2,24,1", B, l_pad, K, C, 5, 0.08)
    ql, tl = batch[2], batch[3]
    k_end, k0, _ = band_geometry(ql, tl, K)
    d0 = ql + tl
    walks = [TS.new_walk(d0, (k_end - k0).clamp(0, K - 1), cert & (d0 > 0)) for _ in range(2)]
    bufs = [TS.new_bufs(B, run_cap, cuda_device) for _ in range(2)]
    for seg in range(int(d0.max() - 1) // C, -1, -1):
        c_lo = TS.narrow_offsets(walks[0][1], K, k_sub) if k_sub else None
        _, planes = TS.dense_span(*batch, pen, K, l_pad, seg * C, C, ckpts[:, seg], True,
                                  c_lo=c_lo, k_sub=k_sub)
        TS.segment_traceback(planes, seg * C, walks[0], bufs[0], l_pad, c_lo=c_lo)
        TS.traceback_segment_ref(planes, seg * C, walks[1], bufs[1], c_lo=c_lo)
        torch.cuda.synchronize()
        assert torch.equal(walks[0], walks[1])
        for a, b in zip(bufs[0], bufs[1]):
            assert torch.equal(a, b)
    assert bool(bufs[0][3].any()) == (run_cap < 8)


@pytest.mark.cuda
def test_long_route_launches_kernels_and_matches_cpu(cuda_device):
    """UnifiedAligner's long route on the card runs both segmented
    kernels, the narrow replay included, and gives the CPU results."""
    from allwave_tpu_torch.wfa import segmented as TS
    from allwave_tpu_torch.wfa.dense_engine import UnifiedAligner

    pen = resolve_penalties(parse_scores("0,5,8,2,24,1"))
    rng = np.random.RandomState(22)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    pairs = []
    for div in (0.01, 0.05, 0.3):
        q = rng.choice(bases, 600)
        t = q.copy()
        mut = rng.rand(t.size) < div
        t[mut] = rng.choice(bases, mut.sum())
        pairs.append((q.tobytes(), t.tobytes()))
    cfg = TS.SegmentedConfig(ckpt_every=64)
    TS.span_launches.reset()
    TS.segment_traceback_launches.reset()
    gpu = UnifiedAligner(pen, dense_max_len=100, device=cuda_device,
                         segmented_config=cfg).align_pairs(pairs, with_stats=True)
    assert TS.span_launches.count > 0 and TS.segment_traceback_launches.count > 0
    assert any(s[2] < s[1] for s in TS.span_launches.shapes)  # narrow replay ran
    cpu = UnifiedAligner(pen, dense_max_len=100, device="cpu",
                         segmented_config=cfg).align_pairs(pairs, with_stats=True)
    assert [(r[0], bytes(r[1])) for r in gpu[0]] == [(r[0], bytes(r[1])) for r in cpu[0]]
    np.testing.assert_array_equal(gpu[1], cpu[1])


def _wf_inputs(device, scores_str, l_pad, K, seed, div=0.03):
    """A wavefront edge-case batch on the card and its score-0 state."""
    from allwave_tpu_torch.testing.batches import wavefront_batch
    from allwave_tpu_torch.wfa import wf_segmented as TW

    pen = resolve_penalties(parse_scores(scores_str))
    batch = tuple(torch.from_numpy(a).to(device)
                  for a in wavefront_batch(np.random.RandomState(seed), l_pad, K, div))
    return pen, batch, TW.wf_init(*batch, pen, K)


@pytest.mark.cuda
@pytest.mark.parametrize("scores_str,K", [(s, 256) for s in SCORE_SETS] + [("0,5,8,2,24,1", 2048)])
def test_wf_span_kernel_matches_plain(cuda_device, scores_str, K):
    """The sweep's scores, done and every checkpoint slot; then history
    spans from a kernel-made checkpoint at full band and on a sub-band
    at per-pair c_lo (K = 2048 keeps the sweep's ring in the global
    scratch)."""
    from allwave_tpu_torch.wfa import wf_segmented as TW

    l_pad, C, N = K + 256, 32, 256
    pen, batch, init = _wf_inputs(cuda_device, scores_str, l_pad, K, K + len(scores_str))
    args = (*batch, pen, K, l_pad)
    kw = dict(ckpt_every=C, done=init.done0, scores=init.scores0)
    n0 = TW.wf_span_launches.count
    ck_k, _, d_k, s_k = TW.wf_span(*args, 0, N, init.seeds, False, **kw)
    ck_p, _, d_p, s_p = TW.wf_span_ref(*args, 0, N, init.seeds, False, **kw)
    torch.cuda.synchronize()
    assert torch.equal(s_k, s_p) and torch.equal(d_k, d_p) and torch.equal(ck_k, ck_p)
    assert bool(d_k[3]) and not bool(d_k[5])
    seg = 2
    c_lo = torch.tensor([0, 128, 0, 256, 384, 0, 512], dtype=torch.int32, device=cuda_device)
    for narrow in (False, True):
        sub = dict(c_lo=c_lo.clamp(max=K - 512), k_sub=512) if narrow and K > 512 else {}
        _, h_k, _, _ = TW.wf_span(*args, seg * C, C, ck_k[seg], True, **sub)
        _, h_p, _, _ = TW.wf_span_ref(*args, seg * C, C, ck_k[seg], True, **sub)
        torch.cuda.synchronize()
        assert torch.equal(h_k, h_p)
    assert TW.wf_span_launches.count == n0 + 3


@pytest.mark.cuda
@pytest.mark.parametrize("run_cap,K", [(512, 256), (6, 256), (512, 2048)])
def test_wf_traceback_kernel_matches_plain(cuda_device, run_cap, K):
    """Walk state and the four run buffers after every segment, from
    the end to the origin, over the span kernel's history planes
    (narrow at K = 2048); run_cap 6 overflows."""
    from allwave_tpu_torch.wfa import segmented as TS
    from allwave_tpu_torch.wfa import wf_segmented as TW

    l_pad, C, N = K + 256, 32, 512
    pen, batch, init = _wf_inputs(cuda_device, "0,5,8,2,24,1", l_pad, K, 7, div=0.01)
    ql, tl = batch[2], batch[3]
    ck, _, done, scores = TW.wf_span(*batch, pen, K, l_pad, 0, N, init.seeds, False,
                                     ckpt_every=C, done=init.done0, scores=init.scores0)
    walks = [TW.new_walk(torch.where(done, scores, -1), init.c_end, tl, done) for _ in range(2)]
    bufs = [TW.new_bufs(len(ql), run_cap, cuda_device) for _ in range(2)]
    narrow = K > 512
    for seg in range((int(scores[done].max()) - 1) // C, -1, -1):
        c_lo = TS.narrow_offsets(walks[0][1], K, 512) if narrow else None
        _, hist, _, _ = TW.wf_span(*batch, pen, K, l_pad, seg * C, C, ck[seg], True,
                                   c_lo=c_lo, k_sub=512 if narrow else None)
        TW.wf_traceback(hist, ck[seg], seg * C, walks[0], bufs[0], pen, c_lo=c_lo)
        TW.traceback_window_ref(hist, ck[seg], seg * C, walks[1], bufs[1], pen, c_lo=c_lo)
        torch.cuda.synchronize()
        assert torch.equal(walks[0], walks[1])
        for a, b in zip(bufs[0], bufs[1]):
            assert torch.equal(a, b)
    assert bool(bufs[0][3].any()) == (run_cap < 64)


@pytest.mark.cuda
def test_wavefront_route_launches_kernels_and_matches_cpu(cuda_device, monkeypatch):
    """UnifiedAligner's long route on the card sends hinted pairs to the
    wavefront engine (both wavefront kernels launch, one pair falls
    back to the segmented engine) and gives the results of the same
    route forced on the CPU."""
    from allwave_tpu_torch.testing.batches import mutate
    from allwave_tpu_torch.wfa import wf_segmented as TW
    from allwave_tpu_torch.wfa.dense_engine import UnifiedAligner

    pen = resolve_penalties(parse_scores("0,5,8,2,24,1"))
    rng = np.random.RandomState(23)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    pairs = []
    for div in (0.005, 0.02, 0.3):
        q = rng.choice(bases, 3000)
        pairs.append((q.tobytes(), mutate(rng, q, div, 3).tobytes()))
    hint = [100, 400, 9000]

    def aligner(device):
        ua = UnifiedAligner(pen, dense_max_len=1000, device=device)
        ua.wf_segmented = TW.WavefrontSegmentedAligner(pen, TW.WfSegConfig(ckpt_every=64), dense=ua.dense)
        return ua

    TW.wf_span_launches.reset()
    TW.wf_traceback_launches.reset()
    TW.wf_stats.reset()
    gpu = aligner(cuda_device).align_pairs(pairs, with_stats=True, sigma_hint=hint)
    assert TW.wf_span_launches.count > 0 and TW.wf_traceback_launches.count > 0
    assert TW.wf_stats.fallbacks == 1
    monkeypatch.setenv("ALLWAVE_WFSEG", "1")
    cpu = aligner("cpu").align_pairs(pairs, with_stats=True, sigma_hint=hint)
    assert [(r[0], bytes(r[1])) for r in gpu[0]] == [(r[0], bytes(r[1])) for r in cpu[0]]
    np.testing.assert_array_equal(gpu[1], cpu[1])


@pytest.mark.cuda
@pytest.mark.parametrize("probe", ["kexp", "kexp2", "kexp3", "kexp6", "kexp7", "kexp8"])
def test_probe_kernel_matches_plain(cuda_device, probe):
    """Each probe kernel of allwave_tpu_torch/probes against its plain
    version at the reduced shapes, every variant (x1 also against the
    engine's forward and its traceback)."""
    from allwave_tpu_torch.probes import runner
    from allwave_tpu_torch.probes import kexp as P1
    from allwave_tpu_torch.probes import kexp2 as P2
    from allwave_tpu_torch.probes import kexp6 as P6

    count = {"kexp": P1.forward_launches, "kexp2": P2.ops_launches, "kexp3": P2.ops_launches,
             "kexp6": P6.step_launches, "kexp7": P6.step_launches, "kexp8": P6.step_launches}[probe]
    n0 = count.count
    out = runner.check_all(cuda_device, (probe,), full=False)
    torch.cuda.synchronize()
    assert out and all(r["max_abs_err"] == 0 for r in out)
    assert count.count > n0


@pytest.mark.cuda
def test_probe_forward_at_headline_band(cuda_device):
    """x1 at K = 192 (the headline's band round, its own template
    instance) against its plain version, the engine's forward and its
    traceback, every variant."""
    from allwave_tpu_torch.probes import runner

    out = []
    runner.check_x1(cuda_device, 64, 200, 256, 192, out)
    assert len(out) == 3 and all(r["max_abs_err"] == 0 for r in out)
