"""The hand-written CUDA kernels against their plain PyTorch versions
(allwave_tpu_torch/wfa/dense.py, segmented.py, wf_segmented.py and
batch.py, and the probes of allwave_tpu_torch/probes), on the card. The
plain versions are held to the JAX reference on the CPU by
tests/test_torch_dense.py, test_torch_segmented.py,
test_torch_wavefront.py, test_torch_batch_wfa.py and
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
from allwave_tpu_torch.testing.batches import edge_batch, pair_batch, random_batch
from allwave_tpu_torch.wfa import dense as TD
from allwave_tpu_torch.wfa.params import resolve_penalties

SCORE_SETS = ["0,5,8,2,24,1", "0,4,6,2", "0,1,1,1"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


#: (K, tier) for every band rung of the engine up to a tier-3 one, and
#: bands off the ladder (201: odd, a lane a store; 4500: tier 3's
#: narrowest cluster)
FORWARD_BANDS = [(128, 1), (192, 1), (256, 1), (320, 1), (384, 1), (512, 2), (768, 2),
                 (1024, 2), (1536, 2), (2048, 2), (3072, 2), (4096, 2), (6144, 3),
                 (100, 1), (200, 1), (201, 1), (1000, 2), (4500, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "scores_str,K,l_pad,div",
    [(s, 128, 256, 0.05) for s in SCORE_SETS]
    + [("0,5,8,2,24,1", 3072, 1024, 0.1), ("0,5,8,2,24,1", 6144, 512, 0.2)]
    + [("0,5,8,2,24,1", K, 512, 0.05) for K, _ in FORWARD_BANDS]
    + [("0,5,8,2", K, 256, 0.05) for K in (192, 1000)],
)
def test_forward_kernel_matches_plain(cuda_device, scores_str, K, l_pad, div):
    """Scores, certificates and every plane entry of random pairs and
    of the edge pairs (length 0 and 1, |k_end| = K - 1, infeasible) in
    a batch of 9, not a multiple of the 4 pairs a tier-1 block runs."""
    pen = resolve_penalties(parse_scores(scores_str))
    rng = np.random.RandomState(K)
    rand = random_batch(rng, 4, (3 * l_pad) // 4, l_pad, div)
    edge = edge_batch(rng, 5 if l_pad < K else 7, l_pad, K, div)
    qs, ts, ql, tl = (
        torch.from_numpy(np.concatenate([a, b])[:9]).to(cuda_device) for a, b in zip(edge, rand)
    )
    n0 = TD.forward_launches.count
    s_k, c_k, p_k = TD.dense_forward(qs, ts, ql, tl, pen, K, l_pad)
    torch.cuda.synchronize()
    assert TD.forward_launches.count == n0 + 1
    s_p, c_p, p_p = TD.dense_forward_ref(qs, ts, ql, tl, pen, K, l_pad)
    assert torch.equal(s_k, s_p) and torch.equal(c_k, c_p)
    assert torch.equal(p_k, p_p)


@pytest.mark.cuda
@pytest.mark.parametrize("K,tier", FORWARD_BANDS)
def test_forward_design(cuda_device, K, tier):
    """The C dispatch's tier for each band, recorded beside the launch's
    shape; tier 1 reads its bases both ways with the same outputs, tiers
    2 and 3 only from staged tables; K = 192 runs a warp a pair; tier 3
    runs the span's replay cluster over the full band (its design from
    the span's dispatch), with no band in device memory."""
    from allwave_tpu_torch.wfa import segmented as TS

    l_pad = 128
    design = TD.forward_design(K, l_pad, 6, True)
    assert design.tier == tier and (tier == 1 or design.stage_bases)
    assert (design.warps_per_pair == 1) == (tier == 1)
    if tier == 3:
        span = TS.span_design(K, K, True, 6, True)
        assert design.span_code == span.code and design.blocks_per_pair == span.blocks_per_pair > 1
        assert design.lanes_per_thread == span.lanes_per_thread
        assert design.warps_per_pair * 32 * span.lanes_per_thread >= K
    else:
        assert design.blocks_per_pair == 1 and design.span_code == 0
    if K == 192:
        assert (design.lanes_per_thread, design.warps_per_pair) == (6, 1)
    pen = resolve_penalties(parse_scores("0,5,8,2,24,1"))
    qs, ts, ql, tl = (
        torch.from_numpy(a).to(cuda_device)
        for a in edge_batch(np.random.RandomState(K), 6, l_pad, K)
    )
    TD.forward_launches.reset()
    out = TD.dense_forward(qs, ts, ql, tl, pen, K, l_pad)
    assert TD.forward_launches.designs == {(6, K, l_pad): design}
    for stage in (False, True):
        if tier > 1 and not stage:
            with pytest.raises(ValueError):
                TD.forward_design(K, l_pad, 6, True, stage)
            continue
        other = TD.dense_forward(qs, ts, ql, tl, pen, K, l_pad, stage_bases=stage)
        assert all(torch.equal(a, b) for a, b in zip(out, other))


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


#: tier 3 at every cluster size its dispatch takes on an H100: (K, B,
#: l_pad, scores, edge pairs). 4500 (off the ladder) and 4501 (odd) the
#: narrowest clusters, with |k_end| = K - 1 where l_pad allows; the rungs
#: 6144 .. 16384 at B = 7; 16384 at B = 64, more clusters of 16 blocks
#: than the card holds at once: 8 blocks of 8 lanes a thread
TIER3_CASES = [(4500, 7, 4608, "0,5,8,2,24,1", True), (4501, 7, 256, "0,4,6,2", False),
               (6144, 7, 256, "0,5,8,2,24,1", True), (8192, 7, 256, "0,5,8,2", False),
               (12288, 7, 256, "0,5,8,2,24,1", False), (16384, 7, 256, "0,5,8,2,24,1", True),
               (16384, 64, 128, "0,5,8,2,24,1", False)]


@pytest.mark.cuda
@pytest.mark.parametrize("K,B,l_pad,scores_str,edge", TIER3_CASES)
def test_forward_tier3_clusters_match_plain(cuda_device, K, B, l_pad, scores_str, edge):
    """Tier 3 (the replay cluster from the origin, then the epilogue):
    scores, certificates and every plane entry equal the plain
    forward's, at the cluster the span's dispatch takes for B pairs."""
    from allwave_tpu_torch.wfa import segmented as TS

    pen = resolve_penalties(parse_scores(scores_str))
    rng = np.random.RandomState(K + B)
    if edge:
        batch = edge_batch(rng, B, l_pad, K, 0.05)
    else:
        batch = random_batch(rng, B, (3 * l_pad) // 4, l_pad, 0.1)
    qs, ts, ql, tl = (torch.from_numpy(a).to(cuda_device) for a in batch)
    TD.forward_launches.reset()
    s_k, c_k, p_k = TD.dense_forward(qs, ts, ql, tl, pen, K, l_pad)
    torch.cuda.synchronize()
    design = TD.forward_launches.designs[(B, K, l_pad)]
    span = TS.span_design(K, K, True, B, pen.two_piece)
    assert design.tier == 3 and design.blocks_per_pair == span.blocks_per_pair
    if B == 64:
        assert (design.blocks_per_pair, design.lanes_per_thread) == (8, 8)
    s_p, c_p, p_p = TD.dense_forward_ref(qs, ts, ql, tl, pen, K, l_pad)
    assert torch.equal(s_k, s_p) and torch.equal(c_k, c_p)
    assert torch.equal(p_k, p_p)
    if edge and l_pad >= K:
        assert bool((ql - tl).abs().eq(K - 1).any())


@pytest.mark.cuda
@pytest.mark.parametrize("run_cap", [128, 48, 37, 4, 190000])
def test_traceback_stats_match_group_emulation(cuda_device, run_cap):
    """The kernel's rows, hops and round trips equal the emulation of its
    schedule (dense_traceback_groups) on the same plane: rows written out
    16, 4 or 1 bytes a lane (caps 128, 48, 37), an overflow (4), and rows
    too large for shared memory written in place (190000)."""
    pen = resolve_penalties(parse_scores("0,5,8,2,24,1"))
    rng = np.random.RandomState(run_cap)
    edge = edge_batch(rng, 7, 256, 192, 0.03)
    rand = random_batch(rng, 6, 240, 256, 0.03)
    qs, ts, ql, tl = (torch.from_numpy(np.concatenate([a, b])).to(cuda_device)
                      for a, b in zip(edge, rand))
    s, c, p = TD.dense_forward(qs, ts, ql, tl, pen, 192, 256)
    stats = torch.zeros((2, 13), dtype=torch.int32, device=cuda_device)
    out = TD.dense_traceback(p, s, c, ql, tl, run_cap, stats=stats)
    torch.cuda.synchronize()
    rows, emul = TD.dense_traceback_groups(p, s, c, ql, tl, run_cap)
    assert torch.equal(out, rows)
    assert torch.equal(stats, emul[:2])
    assert bool((stats[1] <= stats[0]).all()) and int(stats[1].sum()) < int(stats[0].sum())


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
    planes, at full band and on a sub-band (K = 6144: a window of 896
    lanes, two replay blocks a pair)."""
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


#: (scores, K, k_sub, G): the sweep's cluster design for 4 pairs at the
#: engine's bands 384, 3072, 6144, 8192, 12288 and 16384 (clusters above
#: 8 blocks where an H100 holds the 4 clusters at once), an odd full band
#: (a short odd last block) and an odd window at per-pair offsets
SWEEP_CASES = [("0,5,8,2,24,1", 384, None, 1), ("0,5,8,2,24,1", 3072, None, 3),
               ("0,4,6,2", 6144, None, 6), ("0,5,8,2,24,1", 8192, None, 8),
               ("0,5,8,2,24,1", 12288, None, 12), ("0,5,8,2,24,1", 16384, None, 16),
               ("0,1,1,1", 3071, None, 3), ("0,5,8,2,24,1", 6144, 4481, 5)]


@pytest.mark.cuda
@pytest.mark.parametrize("scores_str,K,k_sub,G", SWEEP_CASES)
def test_sweep_kernel_matches_plain(cuda_device, scores_str, K, k_sub, G):
    """The sweep (a span without planes) runs the cluster kernel at the
    design's G and gives dense_span_ref's end state exactly, over an
    even and an odd number of steps from a kernel-made checkpoint; the
    launch records its design."""
    from allwave_tpu_torch.wfa import segmented as TS

    l_pad, C, seg = 1024, 128, 5
    W = k_sub or K
    pen, batch, _, ckpts = _segment_inputs(cuda_device, scores_str, 4, l_pad, K, C, K, 0.05)
    design = TS.span_design(K, W, False, 4, pen.two_piece)
    assert not design.replay and design.blocks_per_pair == G and design.lanes_per_thread == 0
    assert design.lanes_per_block % 2 == 0 and -(-W // design.lanes_per_block) == G
    c_lo = None
    if k_sub is not None:
        c_lo = torch.tensor([0, 1, 640, K - k_sub], dtype=torch.int32, device=cuda_device)
    for n_steps in (C, 67):
        TS.span_launches.reset()
        st_k, pl_k = TS.dense_span(*batch, pen, K, l_pad, seg * C, n_steps, ckpts[:, seg], False,
                                   c_lo=c_lo, k_sub=k_sub)
        st_p, _ = TS.dense_span_ref(*batch, pen, K, l_pad, seg * C, n_steps, ckpts[:, seg], False,
                                    c_lo=c_lo, k_sub=k_sub)
        torch.cuda.synchronize()
        assert pl_k is None and torch.equal(st_k, st_p)
        assert TS.span_launches.designs == {(4, K, W, l_pad, n_steps, False): design}


#: (scores, B, K, k_sub, G, lanes a thread): the replay's cluster design
#: at the engine's full bands 384 .. 4096 and its narrow window k_sub =
#: 4480 of a wider band (9 blocks where an H100 holds the batch's
#: clusters at once), an odd full band (a short odd last block), an odd
#: window at per-pair offsets, the widest band at 4 and 8 pairs (G = 16
#: of 4 lanes a thread where the card holds the batch's clusters at
#: once, else 8 of 8 lanes a thread)
REPLAY_CASES = [("0,5,8,2,24,1", 4, 384, None, 1, 4), ("0,5,8,2,24,1", 4, 1024, None, 2, 4),
                ("0,4,6,2", 4, 1536, None, 3, 4), ("0,5,8,2,24,1", 4, 2048, None, 4, 4),
                ("0,5,8,2,24,1", 4, 3072, None, 6, 4), ("0,5,8,2,24,1", 4, 4096, None, 8, 4),
                ("0,5,8,2,24,1", 6, 6144, 4480, 9, 4), ("0,1,1,1", 4, 3071, None, 6, 4),
                ("0,5,8,2,24,1", 4, 6144, 4481, 9, 4), ("0,5,8,2,24,1", 4, 24576, None, 16, 4),
                ("0,5,8,2,24,1", 8, 24576, None, 16, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("scores_str,B,K,k_sub,G,lpt", REPLAY_CASES)
def test_replay_kernel_matches_plain(cuda_device, scores_str, B, K, k_sub, G, lpt):
    """The replay (a span with planes) runs the cluster kernel at the
    design's G and lanes a thread and gives dense_span_ref's end state
    and every plane entry exactly, over an even and an odd number of
    steps from a kernel-made checkpoint; the launch records its design.
    Where the card holds fewer of the widest clusters than the batch, the
    design takes at most 8 blocks a pair instead."""
    from allwave_tpu_torch.wfa import segmented as TS

    l_pad, C, seg = 1024, 128, 5
    W = k_sub or K
    pen, batch, _, ckpts = _segment_inputs(cuda_device, scores_str, B, l_pad, K, C, K + B, 0.05)
    design = TS.span_design(K, W, True, B, pen.two_piece)
    assert design.replay and -(-W // design.lanes_per_block) == design.blocks_per_pair
    assert design.lanes_per_block % (32 * design.lanes_per_thread) == 0
    assert design.lanes_per_block <= 12 * 32 * design.lanes_per_thread
    # a single cluster of the widest design always fits
    if G > 8 and TS.span_max_clusters(K, W, True, 1, pen.two_piece) < B:
        assert design.blocks_per_pair <= 8
    else:
        assert (design.blocks_per_pair, design.lanes_per_thread) == (G, lpt)
    c_lo = None
    if k_sub is not None:
        c_lo = torch.tensor([(0, 1, 640, K - k_sub)[b % 4] for b in range(B)], dtype=torch.int32,
                            device=cuda_device)
    for n_steps in (C, 67):
        TS.span_launches.reset()
        st_k, pl_k = TS.dense_span(*batch, pen, K, l_pad, seg * C, n_steps, ckpts[:, seg], True,
                                   c_lo=c_lo, k_sub=k_sub)
        st_p, pl_p = TS.dense_span_ref(*batch, pen, K, l_pad, seg * C, n_steps, ckpts[:, seg], True,
                                       c_lo=c_lo, k_sub=k_sub)
        torch.cuda.synchronize()
        assert torch.equal(st_k, st_p) and torch.equal(pl_k, pl_p)
        assert TS.span_launches.designs == {(B, K, W, l_pad, n_steps, True): design}


@pytest.mark.cuda
@pytest.mark.parametrize("scores_str,K,l_pad", [("0,5,8,2,24,1", 384, 512), ("0,4,6,2", 1025, 1024)])
def test_replay_kernel_edge_pairs_match_plain(cuda_device, scores_str, K, l_pad):
    """The replay of every segment of the edge pairs (lengths 0 and 1,
    |k_end| = K - 1 where the band clips, an infeasible pair) from d = 0,
    on checkpoints the kernel swept: every state and plane entry equals
    the plain version's (K = 1025: three blocks, the last one odd)."""
    from allwave_tpu_torch.wfa import segmented as TS

    pen = resolve_penalties(parse_scores(scores_str))
    arrays = edge_batch(np.random.RandomState(K + 1), 7, l_pad, K, 0.05)
    batch = tuple(torch.from_numpy(a).to(cuda_device) for a in arrays)
    C = 128
    _, _, ckpts = TS.dense_sweep_ckpt(*batch, pen, K, l_pad, C)
    for seg in range(ckpts.shape[1]):
        st_k, pl_k = TS.dense_span(*batch, pen, K, l_pad, seg * C, C, ckpts[:, seg], True)
        st_p, pl_p = TS.dense_span_ref(*batch, pen, K, l_pad, seg * C, C, ckpts[:, seg], True)
        torch.cuda.synchronize()
        assert torch.equal(st_k, st_p) and torch.equal(pl_k, pl_p)


@pytest.mark.cuda
@pytest.mark.parametrize("scores_str,K,l_pad", [("0,5,8,2,24,1", 384, 512), ("0,4,6,2", 1025, 1024)])
def test_sweep_kernel_edge_pairs_match_cpu(cuda_device, scores_str, K, l_pad):
    """The whole checkpoint sweep of the edge pairs (lengths 0 and 1,
    |k_end| = K - 1 where the band clips, an infeasible pair) on the
    card equals the plain sweep on the CPU: scores, certificates and
    every checkpoint (K = 1025: two blocks, the last one odd)."""
    from allwave_tpu_torch.wfa import segmented as TS

    pen = resolve_penalties(parse_scores(scores_str))
    arrays = edge_batch(np.random.RandomState(K), 7, l_pad, K, 0.05)
    gpu = TS.dense_sweep_ckpt(*(torch.from_numpy(a).to(cuda_device) for a in arrays),
                              pen, K, l_pad, 128)
    cpu = TS.dense_sweep_ckpt(*map(torch.from_numpy, arrays), pen, K, l_pad, 128)
    for a, b in zip(gpu, cpu):
        assert torch.equal(a.cpu(), b)


#: (run_cap, k_sub, pairs, C): random pairs or pairs with a 40-base
#: indel (their walkers drift out of a tile's columns: misses), segments
#: of C = 128 or 64 anti-diagonals (the dispatch's tiles of 32 or 16
#: rows: long match runs jump whole tiles), the full band or a narrow
#: window; run_cap 3 and 4 overflow
SEGMENT_WALK_CASES = [(512, None, "random", 128), (3, None, "random", 128),
                      (512, 640, "random", 128), (512, None, "indel", 128),
                      (512, None, "indel", 64), (4, None, "indel", 64), (512, 640, "indel", 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("run_cap,k_sub,pairs,C", SEGMENT_WALK_CASES)
def test_segment_traceback_kernel_matches_plain(cuda_device, run_cap, k_sub, pairs, C):
    """Walk state and run buffers after every segment, from the end cell
    to the origin, over the kernel's planes, equal the plain walk's; each
    walker's hops and misses equal the tile schedule's emulation
    (`traceback_segment_tiles`) at the C dispatch's design (tiles of a
    quarter of the segment, 4 slots), and the walkers crossing a 40-base
    gap miss. The launch records that design."""
    from allwave_tpu_torch.testing.batches import long_indel_batch
    from allwave_tpu_torch.wfa import segmented as TS
    from allwave_tpu_torch.wfa.dense import band_geometry

    l_pad, K, B = 1024, 1024, 6
    if pairs == "random":
        pen, batch, cert, ckpts = _segment_inputs(cuda_device, "0,5,8,2,24,1", B, l_pad, K, C, 5,
                                                  0.08)
    else:
        pen = resolve_penalties(parse_scores("0,5,8,2,24,1"))
        batch = tuple(torch.from_numpy(a).to(cuda_device)
                      for a in long_indel_batch(np.random.RandomState(6), B, 900, l_pad, 40))
        _, cert, ckpts = TS.dense_sweep_ckpt(*batch, pen, K, l_pad, C)
    design = TS.segment_walk_design(C, k_sub or K)
    assert (design.rows, design.slots, design.cols, design.warps) == (C // 4, 4, 56, 5)
    ql, tl = batch[2], batch[3]
    k_end, k0, _ = band_geometry(ql, tl, K)
    d0 = ql + tl
    walks = [TS.new_walk(d0, (k_end - k0).clamp(0, K - 1), cert & (d0 > 0)) for _ in range(3)]
    bufs = [TS.new_bufs(B, run_cap, cuda_device) for _ in range(2)]
    bufs.append(tuple(b.to("cpu", copy=True) for b in bufs[1]))
    walks[2] = walks[2].cpu()
    misses = torch.zeros(B, dtype=torch.int32)
    TS.segment_traceback_launches.reset()
    for seg in range(int(d0.max() - 1) // C, -1, -1):
        c_lo = TS.narrow_offsets(walks[0][1], K, k_sub) if k_sub else None
        _, planes = TS.dense_span(*batch, pen, K, l_pad, seg * C, C, ckpts[:, seg], True,
                                  c_lo=c_lo, k_sub=k_sub)
        stats = torch.zeros((2, B), dtype=torch.int32, device=cuda_device)
        TS.segment_traceback(planes, seg * C, walks[0], bufs[0], l_pad, c_lo=c_lo, stats=stats)
        TS.traceback_segment_ref(planes, seg * C, walks[1], bufs[1], c_lo=c_lo)
        emu = torch.zeros((2, B), dtype=torch.int32)
        TS.traceback_segment_tiles(planes.cpu(), seg * C, walks[2], bufs[2],
                                   c_lo=None if c_lo is None else c_lo.cpu(), stats=emu,
                                   design=design)
        torch.cuda.synchronize()
        assert torch.equal(walks[0], walks[1]) and torch.equal(walks[0].cpu(), walks[2])
        for a, b in zip(bufs[0], bufs[1]):
            assert torch.equal(a, b)
        assert torch.equal(stats.cpu(), emu)
        misses += emu[1]
    assert bool(bufs[0][3].any()) == (run_cap < 8)
    if pairs == "indel" and run_cap > 8:
        assert int(misses.sum()) > 0
    assert set(TS.segment_traceback_launches.designs.values()) == {design}


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


def _wf_inputs(device, scores_str, l_pad, K, seed, div=0.03, n_rand=3):
    """A wavefront edge-case batch on the card (n_rand mutated pairs, then
    an identical, a tlen == l_pad, an infeasible and a short pair) and its
    score-0 state."""
    from allwave_tpu_torch.testing.batches import wavefront_batch
    from allwave_tpu_torch.wfa import wf_segmented as TW

    pen = resolve_penalties(parse_scores(scores_str))
    batch = tuple(torch.from_numpy(a).to(device)
                  for a in wavefront_batch(np.random.RandomState(seed), l_pad, K, div, n_rand))
    return pen, batch, TW.wf_init(*batch, pen, K)


#: (scores, B, K, k_sub, G): the span's cluster design for the sweep at
#: full band K (G = ceil(K / 256) blocks a pair, 1 lane a thread, where
#: the card holds the batch's clusters at once), an odd band (a short
#: last block), the three penalty sets, the engine's bands 2048 .. 6144
#: with their history sub-band (and an odd one), and 5b's widest round
#: (16 or 8 blocks a pair, and as many lanes a thread as let the most of
#: its 36 clusters run at once)
WF_SPAN_CASES = [("0,5,8,2,24,1", 7, 256, None, 1), ("0,5,8,2", 7, 256, None, 1),
                 ("0,1,1,1", 7, 256, None, 1), ("0,5,8,2,24,1", 7, 512, None, 2),
                 ("0,4,6,2", 7, 768, None, 3), ("0,5,8,2,24,1", 7, 1001, None, 4),
                 ("0,1,1,1", 7, 1280, None, 5), ("0,5,8,2,24,1", 7, 1536, None, 6),
                 ("0,5,8,2,24,1", 7, 2048, 512, 8), ("0,5,8,2,24,1", 7, 3072, 1023, 12),
                 ("0,5,8,2", 7, 4096, 1024, 16), ("0,5,8,2,24,1", 7, 6144, 1024, 16),
                 ("0,5,8,2,24,1", 36, 4096, 1024, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("scores_str,B,K,k_sub,G", WF_SPAN_CASES)
def test_wf_span_kernel_matches_plain(cuda_device, scores_str, B, K, k_sub, G):
    """The sweep runs the cluster kernel at the design's G (8 where the
    card holds fewer than B of the widest clusters) and gives the plain
    version's scores, done and every checkpoint slot; then history spans
    from a kernel-made checkpoint at full band and on a sub-band at
    per-pair c_lo give every plane entry; each launch records its
    design."""
    from allwave_tpu_torch.wfa import wf_segmented as TW

    l_pad, C, N = -(-(K + 256) // 32) * 32, 32, 256
    pen, batch, init = _wf_inputs(cuda_device, scores_str, l_pad, K, K + len(scores_str),
                                  n_rand=B - 4)
    design = TW.wf_span_design(K, K, False, B, pen)
    assert not design.history and -(-K // design.lanes_per_block) == design.blocks_per_pair
    assert design.lanes_per_thread in (1, 2, 4) and design.lanes_per_block <= 512
    if B < 16:
        assert (design.blocks_per_pair, design.lanes_per_thread) == (G, 1)
        assert design.clusters_held >= B
    else:
        assert design.blocks_per_pair in (8, 16)
    args = (*batch, pen, K, l_pad)
    kw = dict(ckpt_every=C, done=init.done0, scores=init.scores0)
    TW.wf_span_launches.reset()
    ck_k, _, d_k, s_k = TW.wf_span(*args, 0, N, init.seeds, False, **kw)
    ck_p, _, d_p, s_p = TW.wf_span_ref(*args, 0, N, init.seeds, False, **kw)
    torch.cuda.synchronize()
    assert torch.equal(s_k, s_p) and torch.equal(d_k, d_p) and torch.equal(ck_k, ck_p)
    assert bool(d_k[B - 4]) and not bool(d_k[B - 2])
    assert TW.wf_span_launches.designs == {(B, K, K, l_pad, N, False): design}
    seg = 2
    c_lo = torch.tensor([(0, 128, 0, 256, 384, 0, 511)[b % 7] for b in range(B)],
                        dtype=torch.int32, device=cuda_device)
    for W in (K, k_sub):
        if W is None:
            continue
        sub = dict(c_lo=c_lo.clamp(max=K - W), k_sub=W) if W < K else {}
        _, h_k, _, _ = TW.wf_span(*args, seg * C, C, ck_k[seg], True, **sub)
        _, h_p, _, _ = TW.wf_span_ref(*args, seg * C, C, ck_k[seg], True, **sub)
        torch.cuda.synchronize()
        assert torch.equal(h_k, h_p)
        hd = TW.wf_span_design(K, W, True, B, pen)
        assert hd.history and -(-W // hd.lanes_per_block) == hd.blocks_per_pair
        assert TW.wf_span_launches.designs[(B, K, W, l_pad, C, True)] == hd
    assert TW.wf_span_launches.count == 2 + (k_sub is not None)


#: (run_cap, K, pairs, C): the wavefront edge batch or pairs with a
#: 40-base indel (their walkers drift out of a tile's columns: misses),
#: segments of C = 128, 64 or 32 levels (the dispatch's tiles of 32, 16
#: or 8 levels: long match runs jump whole tiles), narrow at K = 2048;
#: run_cap 4 and 6 overflow
WF_WALK_CASES = [(512, 256, "edge", 128), (6, 256, "edge", 32), (512, 2048, "edge", 64),
                 (512, 256, "indel", 128), (512, 256, "indel", 32), (4, 256, "indel", 32),
                 (512, 2048, "indel", 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("run_cap,K,pairs,C", WF_WALK_CASES)
def test_wf_traceback_kernel_matches_plain(cuda_device, run_cap, K, pairs, C):
    """Walk state and the four run buffers after every segment, from the
    end to the origin, over the span kernel's history planes (narrow at
    K = 2048), equal the plain walk's; each walker's hops and misses equal
    the tile schedule's emulation (`traceback_window_tiles`) at the C
    dispatch's design (tiles of a quarter of the segment, 4 slots), and
    the walkers crossing a 40-base gap miss. The launch records that
    design."""
    from allwave_tpu_torch.testing.batches import long_indel_batch
    from allwave_tpu_torch.wfa import segmented as TS
    from allwave_tpu_torch.wfa import wf_segmented as TW

    l_pad, N = K + 256, 512
    if pairs == "edge":
        pen, batch, init = _wf_inputs(cuda_device, "0,5,8,2,24,1", l_pad, K, 7, div=0.01)
    else:
        pen = resolve_penalties(parse_scores("0,5,8,2,24,1"))
        batch = tuple(torch.from_numpy(a).to(cuda_device)
                      for a in long_indel_batch(np.random.RandomState(8), 6, K, l_pad, 40, 0.01))
        init = TW.wf_init(*batch, pen, K)
    ql, tl = batch[2], batch[3]
    ck, _, done, scores = TW.wf_span(*batch, pen, K, l_pad, 0, N, init.seeds, False,
                                     ckpt_every=C, done=init.done0, scores=init.scores0)
    design = TW.wf_walk_design(C, 512 if K > 512 else K)
    assert (design.rows, design.slots, design.cols, design.warps) == (C // 4, 4, 32, 6)
    walks = [TW.new_walk(torch.where(done, scores, -1), init.c_end, tl, done) for _ in range(3)]
    bufs = [TW.new_bufs(len(ql), run_cap, cuda_device) for _ in range(2)]
    bufs.append(tuple(b.to("cpu", copy=True) for b in bufs[1]))
    walks[2] = walks[2].cpu()
    misses = torch.zeros(len(ql), dtype=torch.int32)
    narrow = K > 512
    TW.wf_traceback_launches.reset()
    for seg in range((int(scores[done].max()) - 1) // C, -1, -1):
        c_lo = TS.narrow_offsets(walks[0][1], K, 512) if narrow else None
        _, hist, _, _ = TW.wf_span(*batch, pen, K, l_pad, seg * C, C, ck[seg], True,
                                   c_lo=c_lo, k_sub=512 if narrow else None)
        stats = torch.zeros((2, len(ql)), dtype=torch.int32, device=cuda_device)
        TW.wf_traceback(hist, ck[seg], seg * C, walks[0], bufs[0], pen, c_lo=c_lo, stats=stats)
        TW.traceback_window_ref(hist, ck[seg], seg * C, walks[1], bufs[1], pen, c_lo=c_lo)
        emu = torch.zeros((2, len(ql)), dtype=torch.int32)
        TW.traceback_window_tiles(hist.cpu(), ck[seg].cpu(), seg * C, walks[2], bufs[2], pen,
                                  c_lo=None if c_lo is None else c_lo.cpu(), stats=emu,
                                  design=design)
        torch.cuda.synchronize()
        assert torch.equal(walks[0], walks[1]) and torch.equal(walks[0].cpu(), walks[2])
        for a, b in zip(bufs[0], bufs[1]):
            assert torch.equal(a, b)
        assert torch.equal(stats.cpu(), emu)
        misses += emu[1]
    assert bool(bufs[0][3].any()) == (run_cap < 64)
    if pairs == "indel" and run_cap > 64:
        assert int(misses.sum()) > 0
    assert set(TW.wf_traceback_launches.designs.values()) == {design}


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2, 10])
def test_wf_traceback_flip_kernel_matches_flipped_plain(cuda_device, monkeypatch, seed):
    """The test-only tie-break mutation (`_TB_FLIP`: I1 preferred over X)
    on tie-rich pairs (tandem repeats with homopolymer runs, seeds whose
    flipped walks differ, tests/test_torch_tb_flip.py): the kernel's FLIP
    instantiation gives the flipped plain walk's state and buffers after
    every segment, and the tile emulation's hops and misses; its walk
    differs from the production instantiation's, launched first on the
    same planes (segments of 128 levels: each instantiation sets its own
    shared-memory size above 48 KB)."""
    from allwave_tpu_torch.testing.batches import pair_batch
    from allwave_tpu_torch.testing.fuzzgen import tie_rich_batch
    from allwave_tpu_torch.wfa import wf_segmented as TW

    pen = resolve_penalties(parse_scores("0,5,8,2,24,1"))
    K, l_pad, C = 256, 512, 128
    pairs, _ = tie_rich_batch(np.random.RandomState(seed), 320, 4)
    batch = tuple(torch.from_numpy(a).to(cuda_device) for a in pair_batch(pairs, l_pad))
    init = TW.wf_init(*batch, pen, K)
    ck, _, done, scores = TW.wf_span(*batch, pen, K, l_pad, 0, 1024, init.seeds, False,
                                     ckpt_every=C, done=init.done0, scores=init.scores0)
    assert bool(done.all())
    design = TW.wf_walk_design(C, K)
    walks = [TW.new_walk(scores, init.c_end, batch[3], done) for _ in range(4)]
    walks[3] = walks[3].cpu()
    bufs = [TW.new_bufs(4, 512, cuda_device) for _ in range(3)] + [TW.new_bufs(4, 512, "cpu")]
    for seg in range((int(scores.max()) - 1) // C, -1, -1):
        _, hist, _, _ = TW.wf_span(*batch, pen, K, l_pad, seg * C, C, ck[seg], True)
        monkeypatch.setattr(TW, "_TB_FLIP", False)
        TW.wf_traceback(hist, ck[seg], seg * C, walks[0], bufs[0], pen)
        monkeypatch.setattr(TW, "_TB_FLIP", True)
        stats = torch.zeros((2, 4), dtype=torch.int32, device=cuda_device)
        TW.wf_traceback(hist, ck[seg], seg * C, walks[1], bufs[1], pen, stats=stats)
        TW.traceback_window_ref(hist, ck[seg], seg * C, walks[2], bufs[2], pen)
        emu = torch.zeros((2, 4), dtype=torch.int32)
        TW.traceback_window_tiles(hist.cpu(), ck[seg].cpu(), seg * C, walks[3], bufs[3], pen,
                                  stats=emu, design=design)
        torch.cuda.synchronize()
        assert torch.equal(walks[1], walks[2]) and torch.equal(walks[1].cpu(), walks[3])
        for a, b, e in zip(bufs[1], bufs[2], bufs[3]):
            assert torch.equal(a, b) and torch.equal(a.cpu(), e)
        assert torch.equal(stats.cpu(), emu)
    assert not (torch.equal(walks[0], walks[1])
                and all(torch.equal(a, b) for a, b in zip(bufs[0], bufs[1])))


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
def test_wavefront_engine_runs_expand_to_its_cigars(cuda_device):
    """The wavefront engine on the card, on 20-40 kb pairs: with
    as_runs=True each pair's start-to-end runs expand to the per-base
    cigar it gives under as_runs=False, and their stats are that
    cigar's."""
    from allwave_tpu_torch.core.cigar import batch_cigar_stats
    from allwave_tpu_torch.testing.batches import mutate
    from allwave_tpu_torch.wfa import wf_segmented as TW
    from allwave_tpu_torch.wfa.batch import runs_stats

    pen = resolve_penalties(parse_scores("0,5,8,2,24,1"))
    rng = np.random.RandomState(24)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    pairs, hint = [], []
    for L, div in ((20000, 0.002), (30000, 0.005), (40000, 0.003), (35000, 0.0)):
        q = rng.choice(bases, L)
        pairs.append((q.tobytes(), mutate(rng, q, div, 3).tobytes()))
        hint.append(int(6 * div * L) + 64)
    eng = TW.WavefrontSegmentedAligner(pen, device=cuda_device)
    runs = eng.align_pairs(pairs, sigma_hint=hint, as_runs=True)
    per_base = eng.align_pairs(pairs, sigma_hint=hint)
    assert all(isinstance(r, tuple) and isinstance(r[1], tuple) for r in runs)
    expanded = [np.repeat(ops, lens.astype(np.int64)) for _, (ops, lens) in runs]
    assert [(s, c.tobytes()) for (s, _), c in zip(runs, expanded)] == [
        (s, np.asarray(c, np.uint8).tobytes()) for s, c in per_base
    ]
    np.testing.assert_array_equal(runs_stats([r[1] for r in runs]), batch_cigar_stats(expanded))


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


@pytest.mark.cuda
@pytest.mark.parametrize("K", [64, 128, 192, 256])
def test_probe_forward_wrapping_pairs(cuda_device, K):
    """csrc/probe_forward.cu at every K it takes, on pairs whose stream
    indices wrap at both ends (qlen = tlen = l_pad; |k_end| = K - 1 both
    ways) and an infeasible pair (|k_end| = K), at l_pad = K and 2K,
    every variant against its plain version, the engine's forward and
    the traceback over the engine's plane."""
    from allwave_tpu_torch.probes import runner

    for l_pad in (K, 2 * K):
        out = []
        runner.check_x1(cuda_device, 16, l_pad, l_pad, K, out, edge=True)
        assert len(out) == 3 and all(r["max_abs_err"] == 0 for r in out), out


@pytest.mark.cuda
def test_probe_ops_every_instance(cuda_device):
    """Every chain csrc/probe_ops.cu instantiates (kexp2's and kexp3's
    cases) at 2 copies against chain_ref, at step counts that are and
    are not multiples of E / rolls."""
    from allwave_tpu_torch.probes import kexp2 as P2
    from allwave_tpu_torch.probes import kexp3 as P3

    cases = [((P2.TB, P2.K), 1, r, a, s, m, 1) for _, r, a, s, m in P2.CASES]
    cases += [(shape, axis, r, a, 0, 0, u) for _, shape, axis, r, a, u in P3.CASES]
    for shape, axis, r, a, s, m, u in cases:
        x = torch.from_numpy(P2.inputs(shape, seed=r + a + u)).to(cuda_device)
        for n in (u, 3 * u, 5 * u):
            ref = P2.chain_ref(x, n, r, a, s, m, axis)
            got = P2.chain(x, n, r, a, s, m, axis=axis, unroll=u, copies=2)
            assert all(torch.equal(c, ref) for c in got), (shape, axis, r, a, s, m, u, n)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [256, 512, 1024, 1536, 2048])
def test_step_kernels_at_every_register_band(cuda_device, k):
    """csrc/probe_step.cu at every K its register kernel takes (LPT = K /
    256 = 1, 2, 4, 6, 8): x4 v0-v4, x5's chunked launches (the state
    through device memory, the dummy, the device base) and x6's four
    plane formats against their plain versions, each launch recording
    the kernel it ran."""
    from allwave_tpu_torch.probes import kexp6 as P6
    from allwave_tpu_torch.probes import kexp7 as P7
    from allwave_tpu_torch.probes import kexp8 as P8

    tb, w, n = 2, 128, 256
    args = tuple(torch.from_numpy(a).to(cuda_device) for a in P6.inputs(tb, k))
    x4 = {"v0": P6.run_ref("v0", *args, n, w), **P6.carried_refs(*args, n, w)}
    x5, x6 = P7.refs(*args, n, w), P8.refs(*args, n, w)
    P6.step_launches.reset()
    for v, ref in x4.items():
        assert torch.equal(P6.sweep(v, *args, n, w), ref), v
        assert P6.step_launches.designs[(tb, k, w, n, v)] == P6.kernel_for(v, k)
    for v in ("g0", "g3", "g6", "g7", "g10"):
        s, dummy = P7.run(v, *args, n, w)
        assert torch.equal(s, x5[v][0]) and (dummy is None or torch.equal(dummy, x5[v][1])), v
        shape = (tb, k, w, n // P7.VARIANTS[v].nd if not P7.VARIANTS[v].one_launch else n, v)
        assert P6.step_launches.designs[shape] == P7.kernel_for(v, k) == P6.regs_kernel(k)
    for m in P8.MODES:
        s, planes = P8.run(m, *args, n, w)
        assert torch.equal(s, x6[m][0]) and all(torch.equal(a, b) for a, b in zip(planes, x6[m][1]))
        assert P6.step_launches.designs[(tb, k, w, n, m)] == P8.kernel_for(m, k)
    torch.cuda.synchronize()


def _wf_batch_case(K, l_pad, seed):
    """numpy (qs, ts, qlens, tlens) for the batched wavefront kernels:
    at K = 129 the wavefront engine's edge batch (identical, tlen ==
    l_pad, infeasible, short pairs), else mutated pairs; then empty
    pairs."""
    from allwave_tpu_torch.testing.batches import pair_batch, wavefront_batch

    rng = np.random.RandomState(seed)
    if l_pad > K + 60:
        main = wavefront_batch(rng, l_pad, K)
    else:
        main = random_batch(rng, 6, (3 * l_pad) // 4, l_pad, 0.02)
    empty = pair_batch([(b"", b"ACGTT"), (b"ACG", b""), (b"", b"")], l_pad)
    return tuple(np.concatenate(x) for x in zip(main, empty))


def _wf_batch_check(qs, ts, ql, tl, pen, s_cap, K, design=None):
    """csrc/wf_batch.cu's forward (with and without history, in the
    design its shape picks, or the one forced) and walk against their
    plain versions: scores, done, the defined history rows (wfa/batch.py's
    don't-care rule), and the walk's ops, lens, nruns and overflow at a
    run cap that fits and one that overflows, its steps and round trips
    equal to `wavefront_traceback_rounds`'. Returns the forward's design."""
    from allwave_tpu_torch.wfa import batch as WB

    dev = qs.device
    B = qs.shape[0]
    WB.forward_launches.reset()
    WB.traceback_launches.reset()
    for hist in (False, True):
        sk, dk, hk = WB.wavefront_forward(qs, ts, ql, tl, pen, s_cap, K, hist, design=design)
        sp, dp, hp = WB.wavefront_forward_ref(qs, ts, ql, tl, pen, s_cap, K, hist)
        assert torch.equal(sk, sp) and torch.equal(dk, dp), hist
    lim = torch.where(dp, sp, s_cap)
    rows = (torch.arange(s_cap + 1, device=dev)[:, None] <= lim[None, :])[:, :, None]
    for c in WB.COMPS:
        assert torch.equal(torch.where(rows, hk[c], 0), torch.where(rows, hp[c], 0)), c
    for run_cap in (2 * s_cap + 16, 5):
        stats = torch.zeros((2, B), dtype=torch.int32, device=dev)
        got = WB.wavefront_traceback(hk, sk, ql, tl, pen, run_cap, stats=stats)
        want = WB.wavefront_traceback_ref(hp, sp, ql, tl, pen, run_cap)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), run_cap
        emu = WB.wavefront_traceback_rounds(hp, sp, ql, tl, pen, run_cap)
        assert np.array_equal(stats.cpu().numpy(), emu[4]), run_cap
        thread = WB.wavefront_traceback(hk, sk, ql, tl, pen, run_cap, design="thread")
        assert all(torch.equal(a, b) for a, b in zip(thread, want)), run_cap
    assert WB.forward_launches.count == 2 and WB.traceback_launches.count == 4
    torch.cuda.synchronize()
    (design_ran,) = set(WB.forward_launches.designs.values())
    return design_ran


@pytest.mark.cuda
@pytest.mark.parametrize("scores_str", SCORE_SETS)
@pytest.mark.parametrize("K,s_cap,l_pad", [(129, 64, 256), (513, 256, 1024), (2049, 1024, 2048)])
def test_wf_batch_kernels_match_plain(cuda_device, scores_str, K, s_cap, l_pad):
    """The kernels on the edge batch at K = 129 (one block a pair), 513
    (a cluster of 3 blocks a pair whose block edges the wavefront
    crosses) and 2049 (a cluster of 8), and in the global design at the
    same shapes."""
    from allwave_tpu_torch.wfa import batch as WB

    pen = resolve_penalties(parse_scores(scores_str))
    qs, ts, ql, tl = (torch.from_numpy(a).to(cuda_device) for a in _wf_batch_case(K, l_pad, K))
    g = _wf_batch_check(qs, ts, ql, tl, pen, s_cap, K)
    assert g == WB.forward_design(K, qs.shape[0], l_pad, pen)
    assert g.tier == ("block" if K == 129 else "cluster")
    assert g.blocks_per_pair == {129: 1, 513: 3}.get(K, g.blocks_per_pair) >= 1
    assert _wf_batch_check(qs, ts, ql, tl, pen, s_cap, K, "global").tier == "global"


def _tier_edge(pen, B, l_pad, upper):
    """The widest K whose design for B pairs the card's dispatch puts
    before tier `upper` (block, cluster, global: the order they take as K
    grows), by bisection over the C table."""
    from allwave_tpu_torch.wfa import batch as WB

    def rank(K):
        return WB.TIERS.index(WB.forward_design(K, B, l_pad, pen).tier)

    lo, hi = 1, 1 << 17
    assert rank(lo) < WB.TIERS.index(upper) <= rank(hi)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if rank(mid) < WB.TIERS.index(upper):
            lo = mid
        else:
            hi = mid
    return lo


@pytest.mark.cuda
@pytest.mark.parametrize("scores_str", SCORE_SETS)
@pytest.mark.parametrize("edge", ["spread", "fit", "global", "batch"])
def test_wf_batch_forward_tier_edges(cuda_device, scores_str, edge):
    """The forward at the K on each side of every edge of its tier table,
    as the card's dispatch gives it: a band wider than 256 lanes spreads a
    pair under the SM count over a cluster (B = 1); a full batch (B = the
    SM count) keeps one block a pair up to the widest band whose rings fit
    it; 16 blocks hold the widest cluster band, the next K runs the global
    design (B = 1); at K = 513 a batch one pair under the SM count runs a
    cluster and one at it a block. Random pairs of up to 384 bases and
    empty ones, s_cap 16."""
    from allwave_tpu_torch.wfa import batch as WB

    pen = resolve_penalties(parse_scores(scores_str))
    n_sm = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    if edge == "batch":
        sides = [(513, n_sm - 1, "cluster"), (513, n_sm, "block")]
    else:
        B, lower, upper = {"spread": (1, "block", "cluster"), "fit": (n_sm, "block", "cluster"),
                           "global": (1, "cluster", "global")}[edge]
        K = _tier_edge(pen, B, 512, upper)
        if edge == "spread":
            assert K == 256
        sides = [(K, B, lower), (K + 1, B, upper)]
    rng = np.random.RandomState(len(edge))
    for K, B, tier in sides:
        rand = random_batch(rng, max(B - 3, 1), 384, 512, 0.03)
        empty = pair_batch([(b"", b"ACGTT"), (b"ACG", b""), (b"", b"")], 512)
        arrays = [np.concatenate(x)[:B] for x in zip(rand, empty)]
        qs, ts, ql, tl = (torch.from_numpy(a).to(cuda_device) for a in arrays)
        assert _wf_batch_check(qs, ts, ql, tl, pen, 16, K).tier == tier, (K, B)


@pytest.mark.cuda
@pytest.mark.parametrize("K,tier", [(129, "block"), (2049, "cluster"), (40000, "cluster"),
                                    (70000, "global")])
def test_wf_batch_single_pair(cuda_device, K, tier):
    """One pair (B = 1) in each design: a mutated 300-base pair."""
    pen = resolve_penalties(parse_scores("0,1,1,1"))
    arrays = random_batch(np.random.RandomState(K), 1, 300, 512, 0.03)
    qs, ts, ql, tl = (torch.from_numpy(a).to(cuda_device) for a in arrays)
    assert _wf_batch_check(qs, ts, ql, tl, pen, 32, K).tier == tier


@pytest.mark.cuda
def test_wf_batch_engine_matches_cpu(cuda_device):
    """BatchWavefrontAligner on the card (its discovery ladder and history
    batches) gives the CPU's scores and CIGARs, and launches both
    kernels."""
    from allwave_tpu_torch.wfa import batch as WB
    from allwave_tpu_torch.wfa.engine import BatchWavefrontAligner, EngineConfig

    pen = resolve_penalties(parse_scores("0,5,8,2,24,1"))
    qs, ts, ql, tl = _wf_batch_case(2049, 2048, 3)
    pairs = [(q[:a].tobytes(), t[:b].tobytes()) for q, t, a, b in zip(qs, ts, ql, tl)]
    cfg = EngineConfig(s_cap_initial=16, max_batch=3)
    WB.forward_launches.reset()
    gpu = BatchWavefrontAligner(pen, cfg, device=cuda_device).align_pairs(pairs)
    assert WB.forward_launches.count > 0 and WB.traceback_launches.count > 0
    cpu = BatchWavefrontAligner(pen, cfg, device="cpu").align_pairs(pairs)
    for g, c in zip(gpu, cpu):
        assert g[0] == c[0] and np.array_equal(g[1], c[1])
