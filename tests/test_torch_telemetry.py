"""The port's recorder (`allwave_tpu_torch/utils/telemetry.py`): span
totals, parents and the span log on the profiler's clock; the engines'
spans and counts on a CPU run; orientation's spans and sketch count on
each route; the CLI's end-of-run stats line."""

import functools
import io
import re
import threading
import time
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from allwave_tpu_torch import cli
from allwave_tpu_torch.core.scores import parse_scores
from allwave_tpu_torch.core.types import Sequence
from allwave_tpu_torch.engine import pipeline
from allwave_tpu_torch.engine.pipeline import AllPairAligner
from allwave_tpu_torch.orient import orientation
from allwave_tpu_torch.sketch import membership
from allwave_tpu_torch.utils.telemetry import EngineCounters, counters, to_host
from allwave_tpu_torch.wfa.dense_engine import DenseBandAligner, DenseConfig, UnifiedAligner
from allwave_tpu_torch.wfa.params import resolve_penalties
from allwave_tpu_torch.wfa.segmented import SegmentedConfig

ENGINE_SPANS = ("engine.plan", "engine.launch", "engine.wait", "engine.unpack")


def _seq(rng, n):
    return bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), n))


def _mutate(rng, s, div):
    a = np.frombuffer(s, np.uint8).copy()
    mut = rng.rand(a.size) < div
    a[mut] = rng.choice(np.frombuffer(b"ACGT", np.uint8), int(mut.sum()))
    return a.tobytes()


def _profiled_events(prof):
    return [(e.name(), e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()]


def test_span_totals_parents_and_reset_over_two_threads():
    c = EngineCounters()
    n = 200
    start = threading.Barrier(2)

    def work():
        start.wait()
        for _ in range(n):
            with c.span("outer"):
                with c.span("inner"):
                    with c.span("inner"):  # the same name joins the open span
                        pass
            c.add(syncs=1, reruns=2)

    threads = [threading.Thread(target=work) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    snap = c.snapshot()
    assert snap["spans"]["outer"]["count"] == snap["spans"]["inner"]["count"] == 2 * n
    assert snap["syncs"] == 2 * n and snap["reruns"] == 4 * n
    for tot in snap["spans"].values():
        assert tot["wall_s"] > 0 and tot["cpu_s"] >= 0
    assert snap["spans"]["outer"]["wall_s"] >= snap["spans"]["inner"]["wall_s"]
    # the parent is the span open on the same thread, not the other's
    opened, done = threading.Event(), threading.Event()

    def hold_outer():
        with c.span("outer"):
            opened.set()
            done.wait(timeout=30)

    with profile(activities=[ProfilerActivity.CPU]):
        with c.span("outer"):
            with c.span("inner"):
                pass
        other = threading.Thread(target=hold_outer)
        other.start()
        assert opened.wait(timeout=30)
        with c.span("inner"):
            pass
        done.set()
        other.join(timeout=30)
    assert not other.is_alive()
    log = c.span_log()
    assert [(r.name, r.parent) for r in log] == [("inner", "outer"), ("outer", None), ("inner", None)]
    c.reset()
    snap = c.snapshot()
    assert snap["spans"] == {} and c.span_log() == []
    assert (snap["cells"], snap["dispatches"], snap["syncs"], snap["reruns"]) == (0, 0, 0, 0)


def test_paf_batch_counters_count_and_reset():
    """`paf_batches` counts the writer's batch passes, `paf_batched` the
    records they formatted; both go back to 0 with the rest."""
    c = EngineCounters()
    c.add(paf_batches=1, paf_batched=512)
    c.add(paf_batches=1, paf_batched=7)
    snap = c.snapshot()
    assert (snap["paf_batches"], snap["paf_batched"]) == (2, 519)
    c.reset()
    snap = c.snapshot()
    assert (snap["paf_batches"], snap["paf_batched"]) == (0, 0)
    # the global counters, through the batch pass itself
    from allwave_tpu_torch.core.types import AlignmentResult
    from allwave_tpu_torch.engine.paf_text import cigar_texts

    counters.reset()
    runs = (np.array([77, 88], np.uint8), np.array([255, 1], np.uint8))
    cigar_texts([AlignmentResult(0, 1, 0, 256, 0, 256, False, cigar_runs=runs)] * 3)
    cigar_texts([AlignmentResult.failed(0, 1, False)])
    snap = counters.snapshot()
    assert (snap["paf_batches"], snap["paf_batched"]) == (2, 4)
    counters.reset()
    snap = counters.snapshot()
    assert (snap["paf_batches"], snap["paf_batched"]) == (0, 0)


def test_log_only_under_a_profiler():
    c = EngineCounters()
    with c.span("engine.plan"):
        pass
    assert c.span_log() == [] and c.snapshot()["spans"]["engine.plan"]["count"] == 1
    c.begin_run()
    c.chunk = 3
    with profile(activities=[ProfilerActivity.CPU]):
        with c.span("engine.launch"):
            pass
    with c.span("engine.wait"):
        pass
    (rec,) = c.span_log()
    assert (rec.name, rec.parent, rec.run, rec.chunk) == ("engine.launch", None, 1, 3)
    assert rec.thread == threading.get_ident() and rec.end_ns >= rec.start_ns


def test_log_lies_on_the_profilers_clock():
    c = EngineCounters()
    c.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with record_function("probe"):
                time.sleep(0.002)
                with c.span("engine.launch"):
                    time.sleep(0.002)
                time.sleep(0.002)
    probes = sorted((a, b) for name, a, b in _profiled_events(prof) if name == "probe")
    spans = sorted((r.start_ns, r.end_ns) for r in c.span_log())
    assert len(probes) == len(spans) == 3
    for (pa, pb), (sa, sb) in zip(probes, spans):
        assert pa - 1_000_000 <= sa <= sb <= pb + 1_000_000
        # and well inside: the 2 ms on each side are resolved
        assert sa > pa and sb < pb


def test_no_profiler_event_carries_a_program_span_name():
    pen = resolve_penalties(parse_scores("0,5,8,2,24,1"))
    rng = np.random.RandomState(5)
    pairs = [(q, _mutate(rng, q, 0.05)) for q in (_seq(rng, 60) for _ in range(4))]
    counters.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        UnifiedAligner(pen, device="cpu").align_pairs(pairs)
    names = {r.name for r in counters.span_log()}
    assert names >= {"engine.plan", "engine.launch", "engine.wait", "engine.unpack"}
    assert not names & {name for name, _, _ in _profiled_events(prof)}


def test_engines_record_spans_and_counts_on_a_cpu_run(monkeypatch):
    """Short pairs through the dense engine, pairs over dense_max_len
    through the segmented engine: every engine span, syncs and
    dispatches, and the spans' sum inside the call's wall time."""
    monkeypatch.setattr(
        pipeline, "UnifiedAligner",
        functools.partial(UnifiedAligner, dense_max_len=100,
                          segmented_config=SegmentedConfig(ckpt_every=64)),
    )
    rng = np.random.RandomState(7)
    short, long_ = _seq(rng, 60), _seq(rng, 150)
    seqs = [Sequence("s0", short), Sequence("s1", _mutate(rng, short, 0.03)),
            Sequence("l0", long_), Sequence("l1", _mutate(rng, long_, 0.01))]
    params = parse_scores("0,5,8,2,24,1")
    aligner = AllPairAligner(seqs, params, use_mash_orientation=True, device="cpu")
    got = []
    counters.reset()
    t0 = time.perf_counter()
    aligner.for_each_with_callback(got.append)
    wall = time.perf_counter() - t0
    assert len(got) == 12 and all(r.cigar_bytes is not None or r.cigar_runs is not None for r in got)
    snap = counters.snapshot()
    spans = snap["spans"]
    assert set(ENGINE_SPANS) | {"pipeline.emit_wait"} <= set(spans)
    assert snap["syncs"] > 0 and snap["dispatches"] > 0 and snap["cells"] > 0
    assert sum(spans[n]["wall_s"] for n in ENGINE_SPANS) <= wall


def test_to_host_and_reruns_are_counted():
    counters.reset()
    a, b = to_host(torch.arange(3), torch.zeros(2))
    assert a.tolist() == [0, 1, 2] and b.shape == (2,)
    snap = counters.snapshot()
    assert snap["syncs"] == 2 and snap["spans"]["engine.wait"]["count"] == 1
    # run buffers of 8 runs: pairs with more runs rerun at the full cap
    pen = resolve_penalties(parse_scores("0,5,8,2,24,1"))
    rng = np.random.RandomState(3)
    pairs = [(q, _mutate(rng, q, 0.1)) for q in (_seq(rng, 60) for _ in range(6))]
    counters.reset()
    res = DenseBandAligner(pen, DenseConfig(run_cap_initial=1), device="cpu").align_pairs(pairs)
    assert all(r is not None for r in res)
    snap = counters.snapshot()
    assert snap["reruns"] > 0
    # one copy a group: the first round's and the rerun round's; the
    # copy thread's start and join are waits with no copy of their own
    assert snap["syncs"] == 2 and snap["spans"]["engine.wait"]["count"] == 2 + 2 * 2


def _orient_set(n):
    """n 400 bp sequences from one ancestor at 2%, every other one
    reverse complemented."""
    rng = np.random.RandomState(5)
    base = _seq(rng, 400)
    out = []
    for i in range(n):
        s = _mutate(rng, base, 0.02)
        out.append(Sequence(f"s{i}", orientation.reverse_complement(s) if i % 2 else s))
    return out


#: route -> (sequences, the run's pairs; None: every pair)
ORIENT_ROUTES = {
    "numpy": (8, None),
    "submatrix": (8, [(0, 2), (0, 3), (1, 2), (1, 3)]),
    "native": (12, [(i, (i + 1) % 12) for i in range(10)]),
}


def _orient_all(n, pairs, threads, device):
    """`_orient_all` of an aligner over `_orient_set(n)`, inside a span
    of the test's own named `orient` (the benchmark's span around the
    same call) and under a CPU profiler, so that the spans are logged
    with their parents."""
    al = AllPairAligner(_orient_set(n), parse_scores("0,5,8,2,24,1"), use_mash_orientation=True,
                        threads=threads, device=device)
    if pairs is not None:
        al.pairs = np.array(pairs, dtype=al.pairs.dtype)
    counters.reset()
    membership.orient_routes.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        with counters.span("orient"):
            al._orient_all()
    return al, counters.snapshot(), counters.span_log()


def _assert_orient_spans(al, snap, log):
    spans = snap["spans"]
    inner = [r for r in log if r.name.startswith("orient.")]
    assert sorted(r.name for r in inner) == ["orient.decide", "orient.sketch"]
    assert all(r.parent == "orient" for r in inner)
    assert spans["orient.sketch"]["wall_s"] + spans["orient.decide"]["wall_s"] <= (
        spans["orient"]["wall_s"])
    idx = al._orient
    built = sum(s is not None for s in idx._fwd_sets + idx._rev_sets)
    assert snap["sketches"] == built > 0


@pytest.mark.parametrize("threads", [1, 2])
@pytest.mark.parametrize("route", sorted(ORIENT_ROUTES))
def test_orientation_spans_and_sketches_on_each_host_route(route, threads):
    """Each host route builds its sets in one `orient.sketch` span and
    decides in one `orient.decide` span, both inside `_orient_all`; the
    `sketches` counter is the stranded sets the index holds after it
    (forward sets of every row and reverse sets of the queries, or both
    strands of every row with threads > 1)."""
    n, pairs = ORIENT_ROUTES[route]
    al, snap, log = _orient_all(n, pairs, threads, "cpu")
    assert membership.orient_routes.counts == {route: 1}
    _assert_orient_spans(al, snap, log)
    rows = np.unique(al.pairs)
    queries = np.unique(al.pairs[:, 0])
    assert snap["sketches"] == rows.size + (rows.size if threads > 1 else queries.size)


@pytest.mark.cuda
def test_orientation_spans_and_sketches_on_the_device_route(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the device route's gate opens only on one")
    monkeypatch.setattr(orientation, "ORIENT_DEVICE_MIN_N", 8)
    al, snap, log = _orient_all(8, None, 1, "cuda")
    assert membership.orient_routes.counts == {"device": 1}
    _assert_orient_spans(al, snap, log)
    assert snap["sketches"] == 16


@pytest.mark.parametrize("progress", [True, False])
def test_cli_stats_line(tmp_path, progress):
    rng = np.random.RandomState(9)
    base = _seq(rng, 120)
    fa = tmp_path / "in.fa"
    fa.write_text("".join(f">s{i}\n{_mutate(rng, base, 0.02).decode()}\n" for i in range(3)))
    out, err = io.StringIO(), io.StringIO()
    argv = ["-i", str(fa), "-o", str(tmp_path / "out.paf")] + ([] if progress else ["--no-progress"])
    with redirect_stdout(out), redirect_stderr(err):
        assert cli.main(argv) == 0
    lines = [ln for ln in err.getvalue().splitlines() if ln.startswith("engine:")]
    if not progress:
        assert lines == []
        return
    (line,) = lines
    assert "Gcells/s" not in line
    assert re.fullmatch(
        r"engine: \d+\.\d\d G DP cells, [1-9]\d* dispatches, [1-9]\d* syncs, \d+ reruns on cpu; "
        r"host s: plan \d+\.\d{3}, launch \d+\.\d{3}, wait \d+\.\d{3}, unpack \d+\.\d{3}", line)
    snap = {"cells": 2_500_000_000, "dispatches": 7, "syncs": 3, "reruns": 1,
            "spans": {"engine.plan": {"wall_s": 0.0125}, "engine.wait": {"wall_s": 2.0}}}
    assert cli.engine_stats(snap, "cuda:0") == (
        "engine: 2.50 G DP cells, 7 dispatches, 3 syncs, 1 reruns on cuda:0; "
        "host s: plan 0.013, launch 0.000, wait 2.000, unpack 0.000")
