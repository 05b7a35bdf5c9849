"""The test-only tie-break mutation of the wavefront walk,
`ALLWAVE_TB_FLIP` (allwave_tpu_torch/wfa/wf_segmented.py `_TB_FLIP`;
reference: allwave_tpu/wfa/wf_segmented.py:63 and :465): with it a
walker in the M state prefers I1 over X on a tie.

The flag is read once, when the module is imported. The walk-level
tests set the module attribute with monkeypatch instead (each walk reads
it at call time, and the reference's un-jitted `_traceback_window`
reads its own when it traces its hop); the last test sets the env var in
a fresh process. Inputs are tie-rich: tandem repeats with homopolymer
runs (`testing.fuzzgen.tie_rich_batch`), at seeds whose flipped walks
differ from the clean ones (at L = 320 about one seed in three has a
tie the flip decides otherwise), so each test can fail. Every comparison is exact.
The kernel's FLIP instantiation is held to the flipped plain walk on the
card (tests/test_torch_kernels.py, chip_smoke.py phase 20)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from allwave_tpu.core.scores import parse_scores
from allwave_tpu.wfa import pallas_wf as JP
from allwave_tpu.wfa import wf_segmented as JW
from allwave_tpu.wfa.params import resolve_penalties
from allwave_tpu_torch.testing.batches import pair_batch
from allwave_tpu_torch.testing.fuzzgen import tie_rich_batch
from allwave_tpu_torch.wfa import segmented as TS
from allwave_tpu_torch.wfa import wf_segmented as TW
from tests.test_torch_wavefront import _assert_walk_equal, _ring_rows, _walk_j

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L_PAD, K, C = 512, 256, 32


def _tie_batch(seed, n=4, L=320):
    """n tie-rich pairs of ~L bases as wavefront batch arrays."""
    pairs, _ = tie_rich_batch(np.random.RandomState(seed), L, n)
    return tuple(torch.from_numpy(a) for a in pair_batch(pairs, L_PAD))


def _swept(pen, batch):
    """The plain sweep's checkpoints and each pair's score, all certified."""
    init = TW.wf_init(*batch, pen, K)
    ck, _, done, scores = TW.wf_span_ref(*batch, pen, K, L_PAD, 0, 1024, init.seeds, False,
                                         ckpt_every=C, done=init.done0, scores=init.scores0)
    assert bool(done.all())
    return init, ck, scores


def _walk(pen, batch, init, ck, scores, run_cap, each=None):
    """The plain walk end to origin; `each(seg, hist, ring, walk, bufs)`
    after every segment. Returns the final walk state and buffers."""
    B = len(scores)
    walk = TW.new_walk(scores, init.c_end, batch[3], torch.ones(B, dtype=torch.bool))
    bufs = TW.new_bufs(B, run_cap, "cpu")
    for seg in range((int(scores.max()) - 1) // C, -1, -1):
        _, hist, _, _ = TW.wf_span_ref(*batch, pen, K, L_PAD, seg * C, C, ck[seg], True)
        entry = (walk.clone(), tuple(b.clone() for b in bufs))
        TW.traceback_window_ref(hist, ck[seg], seg * C, walk, bufs, pen)
        if each is not None:
            each(seg, hist, ck[seg], entry, (walk, bufs))
    assert not bool(walk[4].any())  # every walk reached the origin
    return walk, bufs


def _differ(a, b):
    return not (torch.equal(a[0], b[0]) and all(torch.equal(x, y) for x, y in zip(a[1], b[1])))


@pytest.mark.parametrize("scores_str,seed", [("0,5,8,2,24,1", 2), ("0,5,8,2", 6)])
def test_flipped_walk_matches_reference(monkeypatch, scores_str, seed):
    """Segment by segment: the port's flipped plain walk equals the
    reference's `_traceback_window` with its `_TB_FLIP` set, and both
    differ from the clean walk."""
    pen = resolve_penalties(parse_scores(scores_str))
    batch = _tie_batch(seed)
    init, ck, scores = _swept(pen, batch)
    run_cap = 512
    clean = _walk(pen, batch, init, ck, scores, run_cap)
    monkeypatch.setattr(TW, "_TB_FLIP", True)
    monkeypatch.setattr(JW, "_TB_FLIP", True)

    def reference(seg, hist, ring, entry, out):
        walk_j, bufs_j = _walk_j(*entry)
        buf = JP.ckpt_to_buf(_ring_rows(ring.numpy(), pen), jnp.int32(seg * C), pen, K,
                             pen.max_lookback + 1)
        hist_j = {c: jnp.asarray(hist[:, i].numpy()) for i, c in enumerate(TW._COMPS)}
        walk_j, bufs_j = JW._traceback_window(hist_j, buf, jnp.int32(seg * C), walk_j, bufs_j,
                                              pen=pen, n_steps=C, run_cap=run_cap)
        _assert_walk_equal(walk_j, bufs_j, *out)

    flipped = _walk(pen, batch, init, ck, scores, run_cap, reference)
    assert _differ(clean, flipped)


def test_flipped_tiles_match_flipped_plain_walk(monkeypatch):
    """Under the flip the tile schedule's emulation gives the plain walk's
    state and buffers after every segment, at the design the kernel
    takes for these planes (R = 8, N = 4) and with one slot, whose
    walkers miss; the flipped walk differs from the clean one."""
    pen = resolve_penalties(parse_scores("0,5,8,2,24,1"))
    batch = _tie_batch(10)
    init, ck, scores = _swept(pen, batch)
    clean = _walk(pen, batch, init, ck, scores, 512)
    monkeypatch.setattr(TW, "_TB_FLIP", True)
    small = TS.walk_design_of(3 | (0 << 4) | (32 << 8) | (3 << 16))
    misses = {}
    for design in (TS.walk_design_of(3 | (2 << 4) | (32 << 8) | (6 << 16)), small):
        B = len(scores)
        emu = [TW.new_walk(scores, init.c_end, batch[3], torch.ones(B, dtype=torch.bool)),
               TW.new_bufs(B, 512, "cpu")]
        hops = torch.zeros(B, dtype=torch.int32)

        def emulate(seg, hist, ring, entry, out):
            stats = torch.zeros((2, B), dtype=torch.int32)
            TW.traceback_window_tiles(hist, ring, seg * C, emu[0], emu[1], pen, stats=stats,
                                      design=design)
            assert not _differ(out, emu)
            hops.add_(stats[0])
            misses[design] = misses.get(design, 0) + int(stats[1].sum())

        flipped = _walk(pen, batch, init, ck, scores, 512, emulate)
        assert _differ(clean, flipped) and bool((hops > 0).all())
    assert misses[small] > 0  # with one slot, a read in the tile below is a miss


@pytest.mark.parametrize("value,expected", [("1", True), (None, False), ("0", False)])
def test_flag_is_read_at_import_in_a_fresh_process(value, expected):
    """`ALLWAVE_TB_FLIP=1` in the environment of a fresh process, with jax
    blocked, sets `_TB_FLIP`; unset or any other value leaves it off."""
    env = {k: v for k, v in os.environ.items() if k != "ALLWAVE_TB_FLIP"}
    if value is not None:
        env["ALLWAVE_TB_FLIP"] = value
    code = ("import sys; sys.modules['jax'] = None\n"
            "from allwave_tpu_torch.wfa import wf_segmented as W\n"
            "print(W._TB_FLIP)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == str(expected)
