"""The dense forward's tier 3 (a thread-block cluster a pair: the replay
cluster of csrc/dense_span.cu run over the full band from the origin
state, then the scores and certificates from its end state), emulated
on the CPU by tests/torch_replay_emulation.py `dense_forward_clusters`,
against the plain forward, the JAX reference's XLA `dense_forward` and
its Pallas `_forward_c2` in interpret mode.

Every comparison is exact: scores, certificates and every plane entry,
reachable or not. Inputs come from numpy seeds and go to both packages
as numpy arrays. Narrow warps keep the shapes small while the band
spreads over 2 to 4 blocks. The kernel itself is held to the plain
forward on the card by tests/test_torch_kernels.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from allwave_tpu.core.scores import parse_scores
from allwave_tpu.wfa import dense as JD
from allwave_tpu.wfa import pallas_dense as JP
from allwave_tpu.wfa.params import resolve_penalties
from allwave_tpu_torch.testing.batches import edge_batch, random_batch
from allwave_tpu_torch.wfa import dense as TD
from torch_replay_emulation import dense_forward_clusters


def _eq(jax_arr, torch_t):
    np.testing.assert_array_equal(np.asarray(jax_arr), torch_t.numpy())


@pytest.mark.parametrize(
    "scores_str,K,l_pad,nw,lpt,warp,stretch,edge,G",
    [
        ("0,5,8,2,24,1", 384, 128, 3, 4, 16, 4096, False, 2),  # two blocks
        ("0,5,8,2,24,1", 384, 128, 2, 4, 16, 64, False, 3),  # three, tables restaged
        ("0,4,6,2", 201, 128, 1, 8, 8, 4096, False, 4),  # one-piece, odd K, a short last block
        ("0,1,1,1", 129, 128, 2, 4, 8, 32, True, 3),  # edge pairs: |k_end| = K - 1, lengths 0, 1
        ("0,5,8,2,24,1", 127, 128, 1, 4, 16, 4096, True, 2),  # edge pairs, an infeasible pair
    ],
)
def test_cluster_forward_matches_plain_and_xla(scores_str, K, l_pad, nw, lpt, warp, stretch,
                                               edge, G):
    """The emulated tier-3 schedule from the origin gives the plain
    forward's and the XLA scan's scores, certificates and full plane."""
    pen = resolve_penalties(parse_scores(scores_str))
    rng = np.random.RandomState(K + nw)
    if edge:
        batch = edge_batch(rng, 7, l_pad, K, 0.05)
    else:
        batch = random_batch(rng, 5, (3 * l_pad) // 4, l_pad, 0.1)
    ta = tuple(map(torch.from_numpy, batch))
    s_e, c_e, p_e, g = dense_forward_clusters(*ta, pen, K, l_pad, nw, lpt, warp=warp,
                                                 stretch=stretch)
    assert g == G
    s_p, c_p, p_p = TD.dense_forward_ref(*ta, pen, K, l_pad)
    assert torch.equal(s_e, s_p) and torch.equal(c_e, c_p) and torch.equal(p_e, p_p)
    s_j, c_j, p_j = JD.dense_forward(*map(jnp.asarray, batch), pen, K, l_pad, True)
    _eq(s_j, s_e)
    _eq(c_j, c_e)
    _eq(p_j, p_e)
    if edge:
        assert int(s_e[0]) == 0 and bool(c_e[0])
    if K == 127:
        assert bool((s_e >= TD.INF).any())


@pytest.mark.parametrize("K,nw,G", [(384, 3, 2), (384, 2, 3)])
def test_cluster_forward_matches_pallas_c2(K, nw, G):
    """Against the Pallas kernel of the escalation bands (_forward_c2,
    parity-compressed planes) in interpret mode: its scores and
    certificates, and through the traceback its walks."""
    pen = resolve_penalties(parse_scores("0,5,8,2,24,1"))
    l_pad = 128
    batch = random_batch(np.random.RandomState(K + nw), 5, 96, l_pad, 0.15)
    ja, ta = tuple(map(jnp.asarray, batch)), tuple(map(torch.from_numpy, batch))
    s_e, c_e, p_e, g = dense_forward_clusters(*ta, pen, K, l_pad, nw, 4, warp=16)
    assert g == G
    s_c, c_c, p_c = JP._forward_c2(*ja, pen, K, l_pad, True, interpret=True)
    _eq(s_c, s_e)
    _eq(c_c, c_e)
    run_cap = 2 * l_pad + 8
    ref = JD.dense_traceback(p_c, s_c, ja[2], ja[3], pen, run_cap, k_width=K, compressed=True)
    port = TD.dense_traceback_ref(p_e, s_e, ta[2], ta[3], run_cap)
    for a, b in zip(ref, port):
        _eq(a, b)
