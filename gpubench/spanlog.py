"""What the program records about itself, read after a window: the
totals of its host spans and counters
(`allwave_tpu_torch.utils.telemetry.counters`, reset at the window's
start), per job for the per-layer readers; and, for a traced window,
its span log laid over the device's idle gaps (`split_idle`). A program
that keeps no spans reads None."""

from __future__ import annotations

import bisect
import statistics
import time
from typing import Dict, Optional

from . import trace

#: the engines' phases, leaves on the pipeline's thread
ENGINE = ("engine.plan", "engine.launch", "engine.wait", "engine.unpack")
#: the program's spans on the pipeline's thread besides the engines'
PIPELINE = ("pipeline.emit_wait",)


def totals() -> Optional[dict]:
    """The program's `counters.snapshot()`, or None where it has no spans."""
    from allwave_tpu_torch.utils.telemetry import counters

    snap = counters.snapshot()
    return snap if "spans" in snap else None


def _wall(snap: dict, name: str) -> float:
    return snap["spans"].get(name, {}).get("wall_s", 0.0)


def span_ms_per_job(ctx: dict, name: str) -> Optional[float]:
    """A program span's wall ms a job (0 where it never opened)."""
    snap = totals()
    if not ctx["jobs"] or snap is None:
        return None
    return 1e3 * _wall(snap, name) / ctx["jobs"]


def count_per_job(ctx: dict, key: str) -> Optional[float]:
    snap = totals()
    if not ctx["jobs"] or snap is None or key not in snap:
        return None
    return snap[key] / ctx["jobs"]


def untraced_ms_per_job(ctx: dict) -> Optional[float]:
    """The harness's pipeline span less its orientation span, the
    engines' spans and the emit waits: what no span names, a job."""
    snap = totals()
    if not ctx["jobs"] or snap is None:
        return None
    s = ctx["span_s"]
    named = sum(_wall(snap, n) for n in ENGINE + PIPELINE)
    return 1e3 * (s["pipeline"] - s["orient"] - named) / ctx["jobs"]


def _overlaps(gaps, spans) -> Dict[str, float]:
    """Seconds of each span name's intervals that the gaps cover; both
    lists sorted, each of disjoint intervals (us)."""
    out: Dict[str, float] = {}
    j = 0
    for a, b, name in spans:
        while j < len(gaps) and gaps[j][1] <= a:
            j += 1
        k = j
        while k < len(gaps) and gaps[k][0] < b:
            out[name] = out.get(name, 0.0) + (min(b, gaps[k][1]) - max(a, gaps[k][0])) / 1e6
            k += 1
    return out


def split_idle(prof, log) -> dict:
    """The traced window's idle gaps (between the harness's `cli` ranges'
    first start and last end, as `trace.reduce_profile` takes them) split
    over the program spans open on the pipeline's thread during each: a
    gap's seconds go to the span whose interval covers them, the rest to
    `unnamed`. Also each span's seconds with the device busy, and the
    clock's agreement: how far any logged span lies outside the `cli`
    range around it, and the gap from the last span of a job (`cli.drain`)
    to its range's end."""
    dev, host = trace.profile_events(prof)
    clis = sorted((a, b) for a, b, n in host if n == "cli")
    if not clis or not log:
        return {}
    w0, w1 = clis[0][0], max(b for _, b in clis)
    ivals = [(max(a, w0), min(b, w1)) for a, b, _ in dev if b > w0 and a < w1]
    gaps = trace.idle_gaps(ivals, w0, w1)
    idle = sum(b - a for a, b in gaps) / 1e6
    by_thread: Dict[int, int] = {}
    for r in log:
        by_thread[r.thread] = by_thread.get(r.thread, 0) + 1
    main = max(by_thread, key=by_thread.get)
    spans = sorted((r.start_ns / 1e3, r.end_ns / 1e3, r.name) for r in log if r.thread == main)
    idle_by = _overlaps(gaps, spans)
    span_s: Dict[str, float] = {}
    for a, b, name in spans:
        span_s[name] = span_s.get(name, 0.0) + (b - a) / 1e6
    starts = [a for a, _ in clis]
    outside, drain_gap = 0.0, []
    for r in log:
        a, b = r.start_ns / 1e3, r.end_ns / 1e3
        i = bisect.bisect_right(starts, a)
        # the range that starts at or before the span, or the next one
        out, cb = min((max(ca - a, b - cb, 0.0), cb) for ca, cb in clis[max(i - 1, 0) : i + 1])
        outside = max(outside, out)
        if r.name == "cli.drain":
            drain_gap.append(cb - b)
    names = {r.name for r in log}
    mirrored = sum(1 for e in prof.profiler.kineto_results.events() if e.name() in names)
    return {
        "window_s": (w1 - w0) / 1e6,
        "idle_s": idle,
        "idle_by_span": {**idle_by, "unnamed": idle - sum(idle_by.values())},
        "busy_in_span": {n: span_s[n] - idle_by.get(n, 0.0) for n in span_s},
        "span_s": span_s,
        "spans_logged": len(log),
        "max_outside_cli_us": outside,
        "drain_to_cli_end_us": [min(drain_gap), statistics.median(drain_gap)] if drain_gap else None,
        "events_with_span_names": mirrored,
    }


def span_cost(n: int = 200_000) -> dict:
    """ns a span, log off and under a CPU profiler (log on), on a
    counter of its own."""
    from torch.profiler import ProfilerActivity, profile

    from allwave_tpu_torch.utils.telemetry import EngineCounters

    out = {}
    for mode in ("off", "on"):
        c = EngineCounters()
        ctx = profile(activities=[ProfilerActivity.CPU]) if mode == "on" else None
        if ctx is not None:
            ctx.__enter__()
        try:
            t0 = time.perf_counter_ns()
            for _ in range(n):
                with c.span("engine.plan"):
                    pass
            out[f"ns_per_span_log_{mode}"] = (time.perf_counter_ns() - t0) / n
        finally:
            if ctx is not None:
                ctx.__exit__(None, None, None)
    t0 = time.perf_counter_ns()
    for _ in range(n):
        pass
    out["ns_per_empty_loop"] = (time.perf_counter_ns() - t0) / n
    return out
