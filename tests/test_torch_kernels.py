"""The hand-written CUDA kernels against their plain PyTorch versions
(allwave_tpu_torch/wfa/dense.py), on the card. The plain versions are
held to the JAX reference on the CPU by tests/test_torch_dense.py.

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
