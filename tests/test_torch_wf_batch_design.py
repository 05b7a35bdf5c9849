"""The designs of csrc/wf_batch.cu on the CPU: a plain emulation of the
ring forward's schedule (compact rings of each component's own depth,
the band split over G blocks with halo reads; tests/
torch_wf_batch_emulation.py) and the port's emulation of the warp
walk's round trips (wfa/batch.py `wavefront_traceback_rounds`), each
held to the reference's XLA loops on JAX's CPU backend with tolerance 0;
and the forward's tier table (csrc/wf_batch_tiers.cuh), compiled by the
host's C++ compiler and read through ctypes, at the edges of its tiers.
The kernels are held to the same emulations on the card by
tests/test_torch_kernels.py."""

import ctypes
import os
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from allwave_tpu.wfa import batch as RB
from allwave_tpu_torch.wfa import batch as TB

from test_batch_wfa import _pairs_suite
from test_torch_batch_wfa import PEN_IDS, PENS, _defined_rows, _suite_batch
from test_torch_step_probe import _c_entry_points
from torch_wf_batch_emulation import UNSET, ring_forward, ring_layout

TIERS_SRC = os.path.join(os.path.dirname(TB.__file__), "..", "csrc", "wf_batch_tiers.cuh")
#: an H100's shared memory a block (opt-in) and SM count
H100_SMEM, H100_SMS = 232448, 132


@pytest.mark.parametrize("G", [1, 2, 3, 5])
@pytest.mark.parametrize("scores_str", list(PENS), ids=list(PEN_IDS.values()))
def test_ring_schedule_matches_reference(scores_str, G):
    """The compact-ring schedule at K = 33 in G blocks (Lb 33, 17, 11,
    7 lanes): scores, done and the defined history rows equal the XLA
    forward's; the rows above a finished pair's score stay unwritten."""
    pen = PENS[scores_str]
    batch = _suite_batch(_pairs_suite())
    s_cap, K = 40, 33
    sc, done, hist = ring_forward(*batch, pen, s_cap, K, G, True)
    r_sc, r_done, r_hist = RB.wavefront_forward(*(jnp.asarray(a) for a in batch), pen, s_cap, K,
                                                True)
    np.testing.assert_array_equal(sc, np.asarray(r_sc))
    np.testing.assert_array_equal(done, np.asarray(r_done))
    assert done.any() and not done.all()
    rows = _defined_rows(sc, done, s_cap + 1)
    for c in TB.COMPS:
        np.testing.assert_array_equal(np.where(rows, hist[c], 0),
                                      np.where(rows, np.asarray(r_hist[c]), 0), err_msg=c)
        assert (hist[c][~np.broadcast_to(rows, hist[c].shape)] == UNSET).all(), c


def test_ring_depths_are_the_lookbacks():
    """Each ring is as deep as its component is read back, plus the slot
    a level writes: 36 rows for the headline's penalties, not 5 D = 130."""
    depths, offs, rows = ring_layout(PENS["0,5,8,2,24,1"])
    assert depths == (26, 3, 3, 2, 2) and offs == (0, 26, 29, 32, 34) and rows == 36
    assert ring_layout(PENS["0,5,8,2"])[0] == (11, 3, 3, 0, 0)
    assert ring_layout(PENS["0,1,1,1"])[2] == 7


@pytest.mark.parametrize("run_cap", [2 * 64 + 16, 4], ids=["fits", "overflows"])
@pytest.mark.parametrize("scores_str", list(PENS), ids=list(PEN_IDS.values()))
def test_walk_rounds_match_reference(scores_str, run_cap):
    """The warp walk's emulation over the plain history: ops, lens, nruns
    and overflow equal the XLA walk's; a walked pair takes at least one
    round trip and at most one a step, a pair that does not walk none."""
    pen = PENS[scores_str]
    batch = _suite_batch(_pairs_suite())
    t_in = [torch.from_numpy(a) for a in batch]
    sc, _, hist = TB.wavefront_forward(*t_in, pen, 64, 129, True)
    ops, lens, nruns, ovf, stats = TB.wavefront_traceback_rounds(hist, sc, *t_in[2:], pen,
                                                                 run_cap)
    r_in = [jnp.asarray(a) for a in batch]
    r_sc, _, r_hist = RB.wavefront_forward(*r_in, pen, 64, 129, True)
    want = RB.wavefront_traceback(r_hist, r_sc, r_in[2], r_in[3], pen, run_cap)
    for g, w, name in zip((ops, lens, nruns, ovf), want, ("ops", "lens", "nruns", "overflow")):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)
    steps, rounds = stats
    walked = sc.numpy() >= 0
    assert ((rounds >= 1) & (rounds <= steps))[walked].all()
    assert (rounds[~walked] == 0).all() and (steps[~walked] == 0).all()
    assert rounds[walked].sum() < steps[walked].sum()


def test_walk_rounds_cover_an_edit_and_a_gap_run():
    """Round trips on pairs of known edits: an identical pair takes one (its
    end cell), a mismatch and a 4-base gap one each after it, a 40-base
    gap two more (WALK_NCH, then 32 a round)."""
    pen = PENS["0,5,8,2,24,1"]
    rng = np.random.RandomState(3)
    q = rng.choice(np.frombuffer(b"ACGT", np.uint8), 200)
    snp = q.copy()
    snp[100] = (snp[100] + 1) % 4 + 65
    pairs = [(q, q), (q, snp), (q, np.delete(q, range(100, 104))), (q, np.delete(q, range(60, 100)))]
    B, l_pad = len(pairs), 256
    qs, ts = np.zeros((B, l_pad), np.uint8), np.zeros((B, l_pad), np.uint8)
    for b, (a, c) in enumerate(pairs):
        qs[b, : a.size], ts[b, : c.size] = a, c
    ql = torch.tensor([a.size for a, _ in pairs], dtype=torch.int32)
    tl = torch.tensor([c.size for _, c in pairs], dtype=torch.int32)
    sc, done, hist = TB.wavefront_forward(torch.from_numpy(qs), torch.from_numpy(ts), ql, tl, pen,
                                          128, 257, True)
    assert done.all()
    *_, stats = TB.wavefront_traceback_rounds(hist, sc, ql, tl, pen, 64)
    assert stats[1].tolist() == [1, 1, 2, 4]


def _tier_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.fail("no host C++ compiler: the tier table cannot be read on the CPU")
    out = str(tmp_path_factory.mktemp("tiers") / "libtiers.so")
    subprocess.run([cxx, "-x", "c++", "-std=c++17", "-O1", "-shared", "-fPIC", "-o", out,
                    TIERS_SRC], check=True)
    lib = ctypes.CDLL(out)
    lib.allwave_wf_batch_tier.argtypes = [ctypes.c_int] * 9
    lib.allwave_wf_batch_tier.restype = ctypes.c_int
    return lib


@pytest.fixture(scope="module")
def tier_lib(tmp_path_factory):
    return _tier_lib(tmp_path_factory)


def _tier(lib, K, B, l_pad, pen) -> int:
    """The tier table's code on an H100's numbers."""
    return lib.allwave_wf_batch_tier(K, B, l_pad, pen.max_lookback + 1, pen.e1, pen.e2,
                                     int(pen.two_piece), H100_SMEM, H100_SMS)


def _widest_block(rows: int) -> int:
    """The most lanes whose rings (rows x (lanes + 2) int32 and a 16-byte
    stamp) fit an H100 block, at most 4096."""
    return min(4096, (H100_SMEM - 16) // (4 * rows) - 2)


@pytest.mark.parametrize("scores_str", list(PENS), ids=list(PEN_IDS.values()))
def test_tier_table_at_its_edges(tier_lib, scores_str):
    """On an H100's numbers: a full batch keeps one block a pair up to the
    widest band whose rings fit it, then the least cluster that holds the
    band, up to 16 blocks, then the global design; a batch of fewer pairs
    than SMs spreads bands wider than 256 lanes over ceil(K / 256) blocks
    (at most 16)."""
    pen = PENS[scores_str]
    rows = ring_layout(pen)[2]

    def tier(K, B, l_pad=0):
        d = TB.decode_design(_tier(tier_lib, K, B, l_pad, pen))
        return d.tier, d.blocks_per_pair, d.lanes_per_block, d.lanes_per_thread

    blk = _widest_block(rows)
    assert tier(blk, 512) == ("block", 1, blk, -(-blk // 1024))
    G2 = -(-(blk + 1) // 2)
    assert tier(blk + 1, 512) == ("cluster", 2, G2, -(-G2 // 1024))
    assert tier(16 * blk, 512) == ("cluster", 16, blk, -(-blk // 1024))
    assert tier(16 * blk + 1, 512)[0] == tier(16 * blk + 1, 1)[0] == "global"
    assert tier(256, 1) == ("block", 1, 256, 1)
    assert tier(257, 1) == ("cluster", 2, 129, 1)
    assert tier(513, H100_SMS - 1) == ("cluster", 3, 171, 1)
    assert tier(513, H100_SMS) == ("block", 1, 513, 1)
    assert tier(8193, 6)[:3] == ("cluster", 16, 513)
    assert tier(1, 1) == ("block", 1, 1, 1)
    assert _tier(tier_lib, 0, 1, 0, pen) == -1
    # the tier does not depend on the rows' length; staging them does
    assert tier(blk, 512, 1 << 20) == tier(blk, 512)


def test_tier_table_headline_shapes(tier_lib):
    """The headline's penalties: its history batches (K = 513, B = 512) and
    discovery (K = 129) one block a pair, 5b's widest history batch (K =
    8193, B = 6) 16 blocks of 513 lanes, K = 16385 16 of 1025, and only
    K = 32769 the global design."""
    def code(K, B, l_pad):
        return TB.decode_design(_tier(tier_lib, K, B, l_pad, PENS["0,5,8,2,24,1"]))

    assert code(513, 512, 1024)[1:6] == ("block", True, 1, 1, 513)
    assert code(129, 16384, 2048)[1:6] == ("block", True, 1, 1, 129)
    assert code(8193, 6, 131072)[1:6] == ("cluster", False, 16, 1, 513)
    assert code(16385, 14, 131072)[1:6] == ("cluster", False, 16, 2, 1025)
    assert code(32769, 1, 131072)[1:3] == ("global", False)
    assert code(1612, 512, 1024)[1:3] == ("block", False)  # no room for the rows
    assert code(1613, 512, 1024)[1:3] == ("cluster", True)


def test_designs_are_cuda_only():
    """The plain versions take no design and keep no stats."""
    pen = PENS["0,1,1,1"]
    batch = [torch.from_numpy(a) for a in _suite_batch(_pairs_suite())]
    with pytest.raises(ValueError, match="no designs"):
        TB.wavefront_forward(*batch, pen, 8, 17, True, design="global")
    sc, _, hist = TB.wavefront_forward(*batch, pen, 8, 17, True)
    with pytest.raises(ValueError, match="no stats"):
        TB.wavefront_traceback(hist, sc, batch[2], batch[3], pen, 8,
                               stats=torch.zeros((2, len(sc)), dtype=torch.int32))
    with pytest.raises(ValueError, match="no designs"):
        TB.wavefront_traceback(hist, sc, batch[2], batch[3], pen, 8, design="thread")
    assert TB.decode_design(2 | 1 << 3) == TB.ForwardDesign(10, "global", False, 1, 0, 0, 0)


def test_signatures_match_the_c_entry_points():
    """ctypes passes each argument of the wf_batch library's C functions
    (csrc/wf_batch.cu and the tier table's csrc/wf_batch_tiers.cuh) as
    cuda_build.SIGNATURES declares it."""
    from allwave_tpu_torch.wfa import cuda_build

    kind = {ctypes.c_void_p: "P", ctypes.c_int: "I", ctypes.c_longlong: "L"}
    want = {fn: [kind[a] for a in args]
            for fn, (args, _) in cuda_build.SIGNATURES["wf_batch"].items()}
    got = {**_c_entry_points(os.path.join(cuda_build.CSRC, "wf_batch.cu")),
           **_c_entry_points(TIERS_SRC)}
    assert got == want
