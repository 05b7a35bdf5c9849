"""The arithmetic of a traced run on fixed inputs: the busy union, idle
gaps and their labels, the idle share, and the percentile."""

import statistics

import numpy as np
import pytest

from gpubench import spec, trace


def test_busy_union():
    assert trace.busy_union([]) == 0
    assert trace.busy_union([(0, 10), (5, 15), (20, 30)]) == 25
    assert trace.busy_union([(20, 30), (0, 10), (2, 3), (10, 12)]) == 22


def test_idle_gaps():
    ivals = [(2, 4), (3, 6), (8, 9)]
    assert trace.idle_gaps(ivals, 0, 10) == [(0, 2), (6, 8), (9, 10)]
    assert trace.idle_gaps([], 0, 5) == [(0, 5)]
    assert trace.idle_gaps([(0, 5)], 0, 5) == []


def test_labels_take_the_innermost_span():
    spans = [(0, 100, "cli"), (10, 20, "pairs"), (30, 90, "pipeline"), (200, 300, "cli")]
    lab = trace.Labeller(spans)
    assert [lab(t) for t in (5, 15, 50, 95, 150, 250)] == [
        "cli", "pairs", "pipeline", "cli", "harness", "cli"]


def test_labels_reach_the_spans_inside_the_pipeline():
    spans = [(0, 100, "cli"), (10, 90, "pipeline"), (12, 30, "orient"), (40, 50, "emit"),
             (60, 70, "emit")]
    lab = trace.Labeller(spans)
    assert [lab(t) for t in (5, 20, 35, 45, 65, 80)] == [
        "cli", "orient", "pipeline", "emit", "emit", "pipeline"]


@pytest.mark.parametrize("name,span", [("cli.ms_per_job", None), ("pairs.ms_per_job", "pairs"),
                                       ("pipeline.ms_per_job", "pipeline"),
                                       ("orient.ms_per_job", "orient"), ("emit.ms_per_job", "emit")])
def test_span_readers(name, span):
    secs = {"cli": 10.0, "pairs": 0.5, "pipeline": 8.0, "orient": 3.0, "emit": 2.0}
    read = spec.load_reader(name)
    want = 1e3 * (secs[span] if span else 10.0 - 0.5 - 8.0) / 4
    assert read({"jobs": 4, "span_s": secs}) == pytest.approx(want)
    assert read({"jobs": 0, "span_s": secs}) is None


def test_spans_wrap_a_static_method():
    """The traced run's spans wrap `AllPairAligner` methods, the static
    `_emit_chunk` too: the wrapped function still emits."""
    from allwave_tpu_torch.engine.pipeline import AllPairAligner

    before = {attr: AllPairAligner.__dict__[attr] for _, attr in trace.WRAPPED}
    assert isinstance(before["_emit_chunk"], staticmethod)
    spans = trace.Spans()
    emit = spans.wrap("emit", before["_emit_chunk"].__func__)
    got = []
    emit(got.append, np.array([[0, 1]]), np.array([False]), [None], np.zeros((1, 4), np.int64))
    assert len(got) == 1 and got[0].query_idx == 0 and spans.seconds["emit"] > 0


def test_idle_share_reader():
    read = spec.load_reader("device.idle_share")
    assert read({"busy_s": 2.5, "window_s": 10.0}) == pytest.approx(0.75)
    assert read({"busy_s": 0.0, "window_s": 10.0}) is None


def test_percentile():
    vals = [float(v) for v in range(1, 101)]
    assert trace.percentile(vals, 90) == pytest.approx(90.1)
    assert trace.percentile(vals, 90) == statistics.quantiles(vals, n=10, method="inclusive")[8]
    assert trace.percentile([3.0], 90) == 3.0


@pytest.mark.parametrize("name,short", [
    ("void dense_forward_kernel<2, true>(int const*, int)", "dense_forward_kernel"),
    ("dense_sweep_cluster_kernel", "dense_sweep_cluster_kernel"),
    ("void (anonymous namespace)::dense_forward_kernel<2, true>(int const*, int)",
     "dense_forward_kernel"),
    ("(anonymous namespace)::segment_traceback_kernel(unsigned short const*, int)",
     "segment_traceback_kernel"),
    ("void at::native::(anonymous namespace)::indexSelectSmallIndex<unsigned char, long>(int)",
     "indexSelectSmallIndex"),
    ("Memcpy DtoH (Device -> Pageable)", "Memcpy DtoH (Device -> Pageable)"),
])
def test_short_names(name, short):
    assert trace.short_name(name) == short


class _Ev:
    def __init__(self, name, dev, a, b):
        self._n, self._d, self._a, self._b = name, dev, a, b

    def name(self):
        return self._n

    def device_type(self):
        return "DeviceType." + self._d

    def start_ns(self):
        return self._a * 1000

    def end_ns(self):
        return self._b * 1000


def test_reduce_profile_leaves_out_the_spans_mirrors():
    """A host span's mirror on the device timeline is no device work."""
    import types

    evs = [_Ev("gpubench.cli", "CPU", 0, 100), _Ev("gpubench.pipeline", "CPU", 10, 90),
           _Ev("gpubench.pipeline", "CUDA", 10, 90), _Ev("void k<1>(int)", "CUDA", 20, 30),
           _Ev("void k<1>(int)", "CUDA", 25, 40), _Ev("Memcpy DtoH (Device -> Pageable)", "CUDA", 60, 70)]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: evs)))
    red = trace.reduce_profile(prof)
    assert red["busy_s"] == pytest.approx(30e-6)
    assert red["window_s"] == pytest.approx(100e-6)
    assert dict(red["device_ops"]) == pytest.approx({"k": 25e-6, "Memcpy DtoH (Device -> Pageable)": 10e-6})
    assert red["idle_gaps"][0] == ("pipeline", pytest.approx(30e-6))
    assert red["idle_by_label"] == pytest.approx({"cli": 20e-6, "pipeline": 50e-6})
