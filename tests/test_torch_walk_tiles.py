"""The tile schedules of the two long-path walk kernels
(allwave_tpu_torch/csrc/segment_traceback.cu and wf_traceback.cu),
emulated in plain numpy on the CPU (`segmented.traceback_segment_tiles`,
`wf_segmented.traceback_window_tiles`) and held to the port's plain walks
(`traceback_segment_ref`, `traceback_window_ref`) and to the JAX
reference's XLA walks (allwave_tpu/wfa/segmented.py `traceback_segment`,
allwave_tpu/wfa/wf_segmented.py `wf_traceback_hist`).

The kernels themselves run only on the card (tests/test_torch_kernels.py,
chip_smoke.py), where their hop and miss counts are held to these
emulations. What these tests hold is the schedule's index algebra: tiles
of R rows on a fixed grid in slot t % N; the tiles t - N + 1 .. t asked
for when the walker enters tile t, centred on its column then; the
16-byte-aligned runs of the segmented plane's rows; the wavefront
window's head staged at the start with its ring slots stepped down by
one subtraction and wrap; and every entry outside a tile's columns read
from the full planes (a miss).

The cases: walkers that drift out of a tile's columns (a 40-base
insertion or deletion inside a segment), match runs that jump whole
tiles (R = 16 rows or 8 levels), narrow windows at odd and edge c_lo,
walkers inactive at entry (an uncertified pair), walks that finish at
d <= 0 or s == 0, and overflow at run_cap 4. Every comparison is exact:
no tolerance. Inputs come from numpy seeds."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from allwave_tpu.core.scores import parse_scores
from allwave_tpu.wfa import pallas_wf as JP
from allwave_tpu.wfa import segmented as JS
from allwave_tpu.wfa import wf_segmented as JW
from allwave_tpu.wfa.params import resolve_penalties
from allwave_tpu_torch.testing.batches import long_indel_batch, wavefront_batch
from allwave_tpu_torch.wfa import segmented as TS
from allwave_tpu_torch.wfa import wf_segmented as TW
from allwave_tpu_torch.wfa.dense import band_geometry
from tests.test_torch_segmented import _assert_walk_equal, _state, _walk_from
from tests.test_torch_wavefront import _ring_rows, _walk_j, _xla_sweep
from tests.test_torch_wavefront import _assert_walk_equal as _assert_wf_walk_equal


@pytest.fixture(autouse=True)
def _single_device(monkeypatch):
    monkeypatch.setenv("ALLWAVE_SINGLE_DEVICE", "1")


def _pen(scores_str):
    return resolve_penalties(parse_scores(scores_str))


def _both(arrays):
    return tuple(map(jnp.asarray, arrays)), tuple(map(torch.from_numpy, arrays))


#: the window columns a tile row covers in each kernel (csrc `kWc`): the
#: segmented walk's 64-entry rows less the 8 a 16-byte run may start
#: before a column, the wavefront walk's one lane a column
SEG_COLS, WF_COLS = 56, 32


def _design(rows, slots, cols, extra_warps):
    """The design of R = rows and N = slots tiles as its C dispatch
    encodes it: bits 0-3 log2 R, 4-7 log2 N, 8-15 Wc, 16-19 the warps
    (N producers and `extra_warps`)."""
    code = ((rows.bit_length() - 1) | ((slots.bit_length() - 1) << 4) | (cols << 8)
            | ((slots + extra_warps) << 16))
    return TS.walk_design_of(code)


@pytest.mark.parametrize("rows,slots,cols,extra", [(16, 2, SEG_COLS, 1), (128, 4, SEG_COLS, 1),
                                                   (1, 8, WF_COLS, 2), (32, 4, WF_COLS, 2)])
def test_design_codes_round_trip(rows, slots, cols, extra):
    """A design code carries R, N, Wc and the block's warps."""
    g = _design(rows, slots, cols, extra)
    assert (g.rows, g.slots, g.cols, g.warps) == (rows, slots, cols, slots + extra)


# ---------------------------------------------------------------------------
# The segmented walk
# ---------------------------------------------------------------------------


def _segment_batch(seed, gap):
    """Six 440-base pairs with 2% SNPs, a `gap`-base deletion, insertion
    or neither each, and a seventh the band cannot hold (|k_end| > K):
    its walker is inactive from the start."""
    arrays = long_indel_batch(np.random.RandomState(seed), 6, 440, 512, gap)
    rng = np.random.RandomState(seed + 1)
    q = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), 100)
    extra = (np.zeros((1, 512), np.uint8), np.zeros((1, 512), np.uint8),
             np.array([100], np.int32), np.array([500], np.int32))
    extra[0][0, :100] = q
    extra[1][0, :500] = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), 500)
    return tuple(np.concatenate([a, b]) for a, b in zip(arrays, extra))


@pytest.mark.parametrize(
    "scores_str,rows,slots,run_cap,k_sub,drifts",
    [("0,5,8,2,24,1", 16, 2, 512, None, True), ("0,5,8,2,24,1", 256, 4, 512, None, True),
     ("0,4,6,2", 16, 4, 4, None, True), ("0,1,1,1", 32, 1, 512, None, True),
     ("0,5,8,2,24,1", 16, 4, 512, 201, True), ("0,5,8,2,24,1", 64, 2, 512, 128, False)],
)
def test_segment_tiles_match_plain_and_xla(scores_str, rows, slots, run_cap, k_sub, drifts):
    """Segment by segment from the end cell to the origin: the emulated
    tile schedule gives the walk state and run buffers of the plain walk
    and of traceback_segment, after every segment. On a narrow window
    (k_sub) the offsets are the engine's plus odd ones and the band's
    edges, and the XLA walk reads the same window planes at window
    columns. Misses happen on the walkers that cross a gap and only
    there (`drifts`: some do, where the lookahead lets the gap carry a
    walker past a tile's columns); at R = 16 long match runs jump whole
    tiles."""
    pen = _pen(scores_str)
    l_pad, K, C = 512, 256, 64
    arrays = _segment_batch(3 + rows, 40)
    ja, ta = _both(arrays)
    B = len(arrays[2])
    s_j, c_j, ck_j = JS.dense_sweep_ckpt(*ja, pen, K, l_pad, C, impl="xla")
    cert = torch.from_numpy(np.array(c_j))
    assert not bool(cert[B - 1]) and bool(cert[: B - 1].all())
    k_end, k0, _ = band_geometry(ta[2], ta[3], K)
    d0 = ta[2] + ta[3]
    design = _design(rows, slots, SEG_COLS, 1)
    walks = [TS.new_walk(d0, (k_end - k0).clamp(0, K - 1), cert & (d0 > 0)) for _ in range(2)]
    bufs = [TS.new_bufs(B, run_cap, "cpu") for _ in range(2)]
    # copies: jnp.asarray may share a numpy array's memory on the CPU
    walk_j, bufs_j = _walk_from(walks[0].clone(), tuple(b.clone() for b in bufs[0]))
    hops = misses = 0
    jumped = False
    for i, seg in enumerate(range(int(d0[cert].max() - 1) // C, -1, -1)):
        c_lo = None
        if k_sub is not None:
            c_lo = TS.narrow_offsets(walks[0][1], K, k_sub)
            # odd offsets, and the band's two edges, for some pairs
            c_lo = torch.where(torch.arange(B) % 3 == 1, c_lo + 1 + 2 * i, c_lo)
            c_lo[2], c_lo[4] = 0, K - k_sub
            c_lo = c_lo.clamp(0, K - k_sub).to(torch.int32)
        _, planes = TS.dense_span_ref(*ta, pen, K, l_pad, seg * C, C, _state(ck_j, seg), True,
                                      c_lo=c_lo, k_sub=k_sub)
        d_in = walks[1][0].clone()
        TS.traceback_segment_ref(planes, seg * C, walks[0], bufs[0], c_lo=c_lo)
        stats = torch.zeros((2, B), dtype=torch.int32)
        TS.traceback_segment_tiles(planes, seg * C, walks[1], bufs[1], c_lo=c_lo, stats=stats,
                                   design=design)
        assert torch.equal(walks[0], walks[1])
        for a, b in zip(bufs[0], bufs[1]):
            assert torch.equal(a, b)
        # the XLA walk over the same planes (its choices and run lengths
        # apart), at window columns
        pl = planes.numpy()
        split = (jnp.asarray((pl & 0xFF).astype(np.uint8)), jnp.asarray((pl >> 8).astype(np.uint8)))
        col = walk_j[1] - (0 if c_lo is None else jnp.asarray(c_lo.numpy()))
        walk_j, bufs_j = JS.traceback_segment(
            split, jnp.int32(seg * C), (walk_j[0], col) + walk_j[2:], bufs_j,
            ja[2], ja[3], pen, run_cap)
        if c_lo is not None:
            walk_j = (walk_j[0], walk_j[1] + jnp.asarray(c_lo.numpy())) + walk_j[2:]
        _assert_walk_equal(walk_j, bufs_j, walks[1], bufs[1])
        hops += int(stats[0].sum())
        misses += stats[1]
        # a walker descending more than 2R rows a hop on average took a
        # hop over a whole tile
        down = d_in - torch.maximum(walks[1][0], torch.tensor(seg * C))
        jumped |= bool((down // (2 * rows) > stats[0]).any())
        assert int(stats[0][B - 1]) == 0
    gap = torch.arange(B - 1) % 3 != 2
    assert hops > 0 and int(misses[: B - 1][~gap].sum()) == 0  # no gap, no drift
    assert (int(misses[: B - 1][gap].sum()) > 0) == drifts
    assert jumped or rows > 16
    assert bool(bufs[1][3].any()) == (run_cap < 8)
    assert not bool(walks[1][3][: B - 1].any()) or run_cap < 8 or k_sub is not None


# ---------------------------------------------------------------------------
# The wavefront walk
# ---------------------------------------------------------------------------


def _narrow_buf(buf, c_lo, W):
    """The reference's window head (comp -> (D, B, K)) cut to each pair's
    window of W columns at c_lo."""
    cols = c_lo[:, None] + np.arange(W)[None, :]
    return {k: jnp.asarray(np.take_along_axis(np.asarray(v), cols[None], 2)) for k, v in buf.items()}


@pytest.mark.parametrize(
    "scores_str,rows,slots,run_cap,k_sub,drifts",
    [("0,5,8,2,24,1", 8, 2, 512, None, True), ("0,5,8,2,24,1", 32, 4, 512, None, True),
     ("0,5,8,2", 8, 4, 4, None, False), ("0,1,1,1", 4, 1, 512, None, True),
     ("0,5,8,2,24,1", 8, 2, 512, 129, True), ("0,1,1,1", 16, 4, 512, 128, False)],
)
def test_window_tiles_match_plain_and_xla(scores_str, rows, slots, run_cap, k_sub, drifts):
    """Segment by segment from the end to the origin: the emulated tile
    schedule gives the walk state and run buffers of the plain walk and
    of wf_traceback_hist, after every segment, on pairs with a 40-base
    indel, an identical pair (done at score 0: its walk is the origin
    emit), an infeasible one (inactive) and the edge pairs of
    wavefront_batch. On a narrow window (k_sub) at odd and edge offsets,
    the XLA walk reads the window's planes and head at window columns.
    Misses happen on the walkers that cross a gap only (`drifts`: some
    do), except with one slot, where a read at s - x or s - e in the tile
    below the walker's is a miss."""
    pen = _pen(scores_str)
    l_pad, K, C = 512, 256, 32
    arrays = tuple(np.concatenate([a, b]) for a, b in zip(
        long_indel_batch(np.random.RandomState(4 + rows), 6, 440, l_pad, 40),
        wavefront_batch(np.random.RandomState(5), l_pad, K, 0.03, 1)))
    ja, ta = _both(arrays)
    B = len(arrays[2])
    s_x, d_x, rings, _ = _xla_sweep(ja, pen, K, 512, C)
    *_, c_end, _, _, _, _ = JW.wf_init(*ja, pen, K)
    assert d_x[7] and s_x[7] == 0 and not d_x[9]
    design = _design(rows, slots, WF_COLS, 2)
    s0 = torch.from_numpy(np.where(d_x, s_x, -1).astype(np.int32))
    walks = [TW.new_walk(s0, torch.from_numpy(np.array(c_end)), ta[3], torch.from_numpy(d_x.copy()))
             for _ in range(2)]
    bufs = [TW.new_bufs(B, run_cap, "cpu") for _ in range(2)]
    walk_j, bufs_j = _walk_j(walks[0].clone(), tuple(b.clone() for b in bufs[0]))
    misses = torch.zeros(B, dtype=torch.int32)
    hops = 0
    for i, seg in enumerate(range((int(s_x[d_x].max()) - 1) // C, -1, -1)):
        ring = torch.from_numpy(rings[seg])
        c_lo = None
        if k_sub is not None:
            c_lo = TS.narrow_offsets(walks[0][1], K, k_sub)
            c_lo = torch.where(torch.arange(B) % 3 == 1, c_lo + 1 + 2 * i, c_lo)
            c_lo[2], c_lo[4] = 0, K - k_sub
            c_lo = c_lo.clamp(0, K - k_sub).to(torch.int32)
        _, hist, _, _ = TW.wf_span_ref(*ta, pen, K, l_pad, seg * C, C, ring, True,
                                       c_lo=c_lo, k_sub=k_sub)
        TW.traceback_window_ref(hist, ring, seg * C, walks[0], bufs[0], pen, c_lo=c_lo)
        stats = torch.zeros((2, B), dtype=torch.int32)
        TW.traceback_window_tiles(hist, ring, seg * C, walks[1], bufs[1], pen, c_lo=c_lo,
                                  stats=stats, design=design)
        assert torch.equal(walks[0], walks[1])
        for a, b in zip(bufs[0], bufs[1]):
            assert torch.equal(a, b)
        buf = JP.ckpt_to_buf(_ring_rows(rings[seg], pen), jnp.int32(seg * C), pen, K,
                             pen.max_lookback + 1)
        hist_j = {c: jnp.asarray(hist[:, k].numpy()) for k, c in enumerate(TW._COMPS)}
        col = walk_j[1]
        if c_lo is not None:
            buf = _narrow_buf(buf, c_lo.numpy(), k_sub)
            col = col - jnp.asarray(c_lo.numpy())
        walk_j, bufs_j = JW.wf_traceback_hist(hist_j, buf, jnp.int32(seg * C),
                                              (walk_j[0], col) + walk_j[2:], bufs_j,
                                              pen=pen, n_steps=C, run_cap=run_cap)
        if c_lo is not None:
            walk_j = (walk_j[0], walk_j[1] + jnp.asarray(c_lo.numpy())) + walk_j[2:]
        _assert_wf_walk_equal(walk_j, bufs_j, walks[1], bufs[1])
        misses += stats[1]
        hops += int(stats[0].sum())
        assert int(stats[0][9]) == 0
    gap = torch.arange(B) % 3 != 2
    gap[6:] = False
    assert hops > 0 and (slots == 1 or int(misses[~gap].sum()) == 0)
    assert (int(misses[gap].sum()) > 0) == drifts
    assert bool(bufs[1][3].any()) == (run_cap < 8)
    if run_cap >= 8 and k_sub is None:
        assert not bool(walks[1][4].any())  # every walk reached the origin


@pytest.mark.parametrize("walk", ["segment", "window"])
def test_walk_wrappers_count_no_hops_on_the_cpu(walk):
    """Hops and misses are the kernels' counts: on CPU tensors a wrapper
    runs the plain walk, which has none, and refuses to be asked for
    them."""
    pen = _pen("0,5,8,2,24,1")
    stats = torch.zeros((2, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="stats"):
        if walk == "segment":
            TS.segment_traceback(torch.zeros((4, 1, 8), dtype=torch.int16), 0,
                                 TS.new_walk(torch.tensor([4]), torch.tensor([0]), torch.tensor([True])),
                                 TS.new_bufs(1, 8, "cpu"), 8, stats=stats)
        else:
            TW.wf_traceback(torch.zeros((4, 5, 1, 8), dtype=torch.int32),
                            torch.zeros((pen.max_lookback + 1, 1, 8), dtype=torch.int32), 0,
                            TW.new_walk(torch.tensor([4]), torch.tensor([0]), torch.tensor([4]),
                                        torch.tensor([True])),
                            TW.new_bufs(1, 8, "cpu"), pen, stats=stats)


@pytest.mark.parametrize("argv,why", [([], "no CUDA card"), (["--root", "/nonexistent"], "not")])
def test_walk_split_refuses(argv, why, monkeypatch):
    """Without a card, or asked for a tree other than the one its package
    was imported from in this process, the walk split exits with why."""
    import sys

    from allwave_tpu_torch.probes import walk_split as WS

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "path", list(sys.path))
    with pytest.raises(SystemExit, match=why):
        WS.main(argv)
