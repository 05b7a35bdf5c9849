"""Port twin of tests/test_fuzz_battery.py: the same seeded shards, the
same generated penalty sets and pairs (the reference test's own
generator), through the port's engines on the CPU (plain versions), the
reference's XLA engines and the native oracle. Scores and CIGARs must be
byte-equal and every CIGAR must replay.

The fast shard (dense engines only) runs in tier 1; the 8 slow shards
add one round through both long-pair engines each, as the reference's
do, and carry the reference's `slow` mark. (Its own file, beside
tests/test_torch_fuzz.py: the reference's XLA engines compile for most
of the fast shard's ~40 s on one worker.)"""

import numpy as np
import pytest

from allwave_tpu.wfa.dense_engine import DenseBandAligner as RefDense
from allwave_tpu.wfa.dense_engine import DenseConfig as RefDenseConfig
from allwave_tpu.wfa.params import resolve_penalties as ref_resolve
from allwave_tpu.wfa.segmented import SegmentedConfig as RefSegConfig
from allwave_tpu.wfa.segmented import SegmentedDenseAligner as RefSeg
from allwave_tpu.wfa.wf_segmented import WavefrontSegmentedAligner as RefWf
from allwave_tpu.wfa.wf_segmented import WfSegConfig as RefWfConfig
from allwave_tpu_torch import native
from allwave_tpu_torch.core.cigar import validate_cigar
from allwave_tpu_torch.core.types import AlignmentParams
from allwave_tpu_torch.wfa.batch import expand_runs
from allwave_tpu_torch.wfa.dense_engine import DenseBandAligner
from allwave_tpu_torch.wfa.params import resolve_penalties
from allwave_tpu_torch.wfa.segmented import SegmentedConfig, SegmentedDenseAligner
from allwave_tpu_torch.wfa.wf_segmented import WavefrontSegmentedAligner, WfSegConfig
from tests.test_fuzz_battery import _rand_pair, _rand_params


@pytest.fixture(autouse=True)
def _single_device(monkeypatch):
    # the reference's shards dispatch on one device (its 8-device mesh
    # multiplies every compile here)
    monkeypatch.setenv("ALLWAVE_SINGLE_DEVICE", "1")


def _same(a, b):
    assert a[0] == b[0]
    np.testing.assert_array_equal(np.asarray(a[1]), np.asarray(b[1]))


def _per_base(results):
    """The port's results with their runs expanded to per-base cigars;
    None and the wavefront engine's fallback sentinel as they are."""
    return [r if r is None or isinstance(r, str) else (r[0], expand_runs(*r[1])) for r in results]


def _dense_round(params, pairs):
    """The port's and the reference's dense engines and the oracle on
    one round; returns the port's results."""
    pen = resolve_penalties(AlignmentParams(*params.key()))
    port = _per_base(DenseBandAligner(pen, device="cpu").align_pairs(pairs))
    ref = RefDense(ref_resolve(params), RefDenseConfig(impl="xla")).align_pairs(pairs)
    for i, (q, t) in enumerate(pairs):
        assert port[i] is not None, (params, i)
        validate_cigar(port[i][1], q, t)
        _same(ref[i], port[i])
        o = native.wfa_align_native(q, t, pen)
        assert o is not None, "the native oracle has no single-pair WFA"
        _same(o, port[i])
    return pen, port


def _run_shard(seed, n_rounds, pairs_per_round, with_segmented=True, fast=False):
    """The reference's `_run_shard`: n_rounds random sets through the
    dense engines and the oracle, then one round through both long-pair
    engines as well (the wavefront engine at k_max 1024, s_cap_max 2048,
    C = 128; pairs past its caps come back as its fallback sentinel)."""
    assert native.available(), "the native oracle library is unavailable"
    rng = np.random.RandomState(seed)
    n_checked = 0
    for _ in range(n_rounds):
        params = _rand_params(rng)
        _dense_round(params, [_rand_pair(rng, fast) for _ in range(pairs_per_round)])
        n_checked += pairs_per_round
    if with_segmented:
        params = _rand_params(rng)
        pairs = [_rand_pair(rng, fast) for _ in range(pairs_per_round)]
        pen, dense = _dense_round(params, pairs)
        ref_pen = ref_resolve(params)
        wf_cfg = dict(k_max=1024, s_cap_max=2048, ckpt_every=128)
        seg = SegmentedDenseAligner(pen, SegmentedConfig(ckpt_every=512), device="cpu")
        wf = WavefrontSegmentedAligner(pen, WfSegConfig(**wf_cfg), device="cpu")
        ref_seg = RefSeg(ref_pen, RefSegConfig(impl="xla", ckpt_every=512))
        ref_wf = RefWf(ref_pen, RefWfConfig(**wf_cfg), impl="xla")
        for res in (_per_base(seg.align_pairs(pairs)), ref_seg.align_pairs(pairs)):
            for r, d in zip(res, dense):
                _same(r, d)
        port_w, ref_w = _per_base(wf.align_pairs(pairs)), ref_wf.align_pairs(pairs)
        for pw, rw, d in zip(port_w, ref_w, dense):
            assert isinstance(pw, tuple) == isinstance(rw, tuple), (params, pw, rw)
            if isinstance(pw, tuple):  # within the wavefront engine's caps
                _same(pw, d)
                _same(rw, d)
        n_checked += pairs_per_round
    return n_checked


def test_fuzz_battery_fast_shard():
    assert _run_shard(1000, 6, 6, with_segmented=False, fast=True) == 36


@pytest.mark.slow
@pytest.mark.parametrize("seed", [1001 + i for i in range(8)])
def test_fuzz_battery_slow_shard(seed):
    assert _run_shard(seed, 15, 8) == 128
