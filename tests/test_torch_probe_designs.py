"""The schedules of csrc/probe_forward.cu (x1) and csrc/probe_ops.cu (x2,
x3), emulated on the CPU (tests/torch_probe_emulation.py), against the
probes' plain versions (allwave_tpu_torch/probes/kexp.py `forward_ref`,
kexp2.py `chain_ref`) with tolerance 0: x1's wrap-extended base tables
read at fixed offsets, its per-thread activity ranges, V2's window
without tests and the clamp's countdown, at every K the kernel takes,
on pairs whose stream indices wrap at both ends and an infeasible one;
x2's and x3's segments of a line a thread and their renaming, for
every case the kernel instantiates. The kernels themselves run on the
card (tests/test_torch_kernels.py, marker `cuda`).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from allwave_tpu_torch.probes import kexp as K1
from allwave_tpu_torch.probes import kexp2 as K2
from allwave_tpu_torch.probes import kexp3 as K3
from allwave_tpu_torch.probes.runner import SCORES
from allwave_tpu_torch.testing.batches import edge_batch
from torch_probe_emulation import ops_chain, renaming_moves, seg_elems, x1_forward, x1_tables

CSRC = Path(__file__).resolve().parents[1] / "allwave_tpu_torch" / "csrc"


def _pen():
    from allwave_tpu_torch.core.scores import parse_scores
    from allwave_tpu_torch.wfa.params import resolve_penalties

    return resolve_penalties(parse_scores(SCORES))


# ---------------------------------------------------------------------- x1

#: (K, l_pad): every K the kernel takes (LPT = 2, 4, 6, 8), each at an
#: l_pad that holds the band's edge pairs |k_end| = K - 1 and an
#: infeasible one (|k_end| = K)
X1_SHAPES = [(64, 64), (128, 128), (192, 192), (256, 256)]


def _x1_batch(K, l_pad, B=8, seed=5):
    """testing.batches.edge_batch: (0, 0), (1, 1), (0, 3), (l_pad, l_pad),
    (l_pad, l_pad - K + 1), (l_pad - K + 1, l_pad), (l_pad, l_pad - K),
    then random pairs of lengths up to l_pad."""
    return edge_batch(np.random.RandomState(seed + K), B, l_pad, K, 0.08)


@pytest.mark.parametrize("K,l_pad", X1_SHAPES)
def test_x1_schedule_matches_plain(K, l_pad):
    """V1, V2 and V3 as the kernel computes them: scores, certificates
    and every plane entry, reachable or not, equal forward_ref's."""
    pen = _pen()
    qs, ts, ql, tl = _x1_batch(K, l_pad)
    d_chunk = K1.check_shape(K, l_pad)
    ref = K1.forward_ref("V1", *(torch.from_numpy(a) for a in (qs, ts, ql, tl)), pen, K, l_pad)
    assert not ref[1][6] and ref[0][6] == K1.INF  # the infeasible pair
    for v in K1.VARIANTS:
        s, c, p, fast = x1_forward(v, qs, ts, ql, tl, pen, K, l_pad, d_chunk)
        np.testing.assert_array_equal(s, ref[0].numpy(), err_msg=v)
        np.testing.assert_array_equal(c, ref[1].numpy(), err_msg=v)
        if v == "V3":
            assert p is None
        else:
            np.testing.assert_array_equal(p, ref[2].numpy(), err_msg=v)
        # V2 and V3 take the window without tests on the long pairs only
        assert (fast > 0).any() == (v != "V1"), v


def test_x1_tables_hold_every_wrapped_base():
    """The staged tables, filled with no division, are the streams'
    bases q[(d - k - 2 mod 2 l_pad) >> 1] and t[(d + k - 2 mod 2 l_pad) >>
    1] for every step and lane of the band, read at the kernel's turn
    pointer and fixed offset; including k0 far from 0 (an infeasible
    pair) and l_pad below K / 2."""
    rng = np.random.RandomState(3)
    for K, l_pad, B in ((256, 64, 4), (192, 192, 8), (64, 64, 8)):
        qs = rng.randint(0, 4, (B, l_pad)).astype(np.uint8)
        ts = rng.randint(0, 4, (B, l_pad)).astype(np.uint8)
        k0 = np.array([-K, 0, -2 * l_pad, 2 * l_pad - 2] + [0] * (B - 4), np.int64)
        k0 -= k0 & 1
        qt, tt, hq0, ht0 = x1_tables(qs, ts, k0, K, l_pad)
        lpt = K // 32
        for b in range(B):
            for d in range(1, 2 * l_pad + 1):
                m, odd = (d - 1) // 2, d % 2 == 1
                c = np.arange(K)
                r = c % lpt
                k, kb = k0[b] + c, k0[b] + c - r
                qi = m - (kb >> 1) - hq0[b] + np.where(odd, (-1 - r) // 2, -r // 2)
                ti = m + (kb >> 1) - ht0[b] + np.where(odd, (r - 1) // 2, r // 2)
                np.testing.assert_array_equal(qt[b, qi], qs[b, ((d - k - 2) % (2 * l_pad)) >> 1])
                np.testing.assert_array_equal(tt[b, ti], ts[b, ((d + k - 2) % (2 * l_pad)) >> 1])


# --------------------------------------------------------------- x2 and x3

#: every case of x2 and x3: (lines, rolls, adds, selects, mins, unroll,
#: axis, shape)
OPS_CASES = ([(64, r, a, s, m, 1, 1, (K2.TB, K2.K)) for _, r, a, s, m in K2.CASES]
             + [(shape[1 - axis], r, a, 0, 0, u, axis, shape)
                for _, shape, axis, r, a, u in K3.CASES])


def test_ops_cases_are_the_kernels_instances():
    """kexp2's nine and kexp3's nine cases run the 17 chains
    csrc/probe_ops.cu instantiates (AW_CASES), with nothing left over
    (kexp3's lane (64,128) and subl (128,64) 8r u1 share one), each
    with the segment width `seg_elems` gives the emulation."""
    src = (CSRC / "probe_ops.cu").read_text()
    rule = re.search(r"constexpr int seg_elems\(int rolls, int unroll\) \{\s*"
                     r"return ([^;?]*) \? (\d+) : (\d+);", src)
    assert rule, "csrc/probe_ops.cu's seg_elems is no longer one conditional"
    cond, wide, narrow = rule.group(1).replace("&&", "and"), int(rule.group(2)), int(rule.group(3))
    table = src[src.index("#define AW_CASES"): src.index("}  // namespace")]
    inst = [tuple(int(v) for v in t) for t in
            re.findall(r"X\((\d+), (\d+), (\d+), (\d+), (\d+), (\d+)\)", table)]
    assert len(inst) == 17 and len(OPS_CASES) == 18
    assert sorted(inst) == sorted({c[:6] for c in OPS_CASES})
    for _, r, _, _, _, u in inst:
        assert seg_elems(r, u) == (wide if eval(cond, {"rolls": r, "unroll": u}) else narrow)


@pytest.mark.parametrize("case", OPS_CASES, ids=lambda c: "x".join(map(str, c[:7])))
def test_ops_segments_match_plain(case):
    """The segment layout and the renaming against chain_ref, at step
    counts that are and are not multiples of E / rolls, and the moves
    the renaming leaves at the loop's back edge: none where rolls x
    unroll is a multiple of E."""
    lines, r, a, s, m, u, axis, shape = case
    E = seg_elems(r, u)
    assert E >= 8 and 128 % E == 0
    x = K2.inputs(shape, seed=lines + r + a + s + m + u)
    for n in sorted({u, 3 * u, 5 * u}):
        want = K2.chain_ref(torch.from_numpy(x), n, r, a, s, m, axis).numpy()
        got, moves = ops_chain(x, n, r, a, s, m, axis, u, E)
        np.testing.assert_array_equal(got, want, err_msg=f"{n} steps")
        turns = n // u
        assert moves == (0 if (r * u) % E == 0 else turns * renaming_moves(lines, r, u))


def test_ops_renaming_moves():
    """Only x2's 4r case leaves its renaming short of the identity at
    the back edge: a rotation by 4 of 8 registers, 12 moves a segment,
    4 segments a thread."""
    short = [c for c in OPS_CASES if (c[1] * c[5]) % seg_elems(c[1], c[5])]
    assert [c[:6] for c in short] == [(64, 4, 0, 0, 0, 1)]
    assert renaming_moves(64, 4, 1) == 48
