"""What a traced run reads: host spans the harness opens around its calls
into the program's layers, and the device's intervals from
`torch.profiler`, reduced to busy time (the union of every device
interval, as `chip_smoke.py`'s `profile_pipeline` computes it), device
time by kernel, and the idle gaps, each labelled by the innermost host
span open when it began."""

from __future__ import annotations

import bisect
import functools
import statistics
import time
from typing import Dict, List, Tuple

#: host span names, from the outermost: `cli` is the harness's call of
#: `cli.main`, the others wrap the `AllPairAligner` methods of WRAPPED
SPANS = ("cli", "pairs", "pipeline", "orient", "emit")
#: (span, method): pair selection in the constructor; the whole pipeline;
#: inside it, the run-wide orientation (mash mode), and the emit of each
#: chunk's records, which runs on the pipeline's worker thread beside the
#: next chunk's launches and waits
WRAPPED = (("pairs", "__init__"), ("pipeline", "for_each_with_callback"),
           ("orient", "_orient_all"), ("emit", "_emit_chunk"))


def busy_union(intervals: List[Tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    busy, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy


def idle_gaps(intervals: List[Tuple[float, float]], start: float, stop: float) -> List[Tuple[float, float]]:
    """The stretches of [start, stop) that no interval covers."""
    gaps, cur = [], start
    for a, b in sorted(intervals):
        if a > cur:
            gaps.append((cur, min(a, stop)))
        cur = max(cur, b)
        if cur >= stop:
            break
    if cur < stop:
        gaps.append((cur, stop))
    return [(a, b) for a, b in gaps if b > a]


class Labeller:
    """The innermost host span open at a time ('harness' if none)."""

    def __init__(self, spans: List[Tuple[float, float, str]]):
        self.by_name = []
        for name in reversed(SPANS):  # innermost first
            rows = sorted((a, b) for a, b, n in spans if n == name)
            self.by_name.append((name, [a for a, _ in rows], [b for _, b in rows]))

    def __call__(self, t: float) -> str:
        for name, starts, ends in self.by_name:
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t < ends[i]:
                return name
        return "harness"


def percentile(values: List[float], q: int) -> float:
    """The q-th percentile, interpolated between order statistics
    (`statistics.quantiles`, inclusive method)."""
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


def short_name(kernel: str) -> str:
    """A kernel's name without its return type, namespaces, template
    arguments or parameter list; copies and fills keep their names."""
    if kernel.startswith(("Memcpy", "Memset")):
        return kernel
    name = kernel.replace("(anonymous namespace)::", "")
    depth, out = 0, []
    for ch in name:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    name = "".join(out).split("(")[0].strip()
    return name.split(" ")[-1].split("::")[-1] or kernel[:64]


class Spans:
    """Host spans by name: total seconds, plus a `record_function` range
    each, so that the profiler's timeline has them on the device's
    clock."""

    def __init__(self):
        self.seconds: Dict[str, float] = {n: 0.0 for n in SPANS}

    def wrap(self, name: str, fn):
        import torch

        @functools.wraps(fn)
        def inner(*a, **kw):
            with torch.profiler.record_function("gpubench." + name):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    self.seconds[name] += time.perf_counter() - t0

        return inner


def profile_events(prof):
    """(device intervals with names, host spans) in microseconds, from
    the profiler's raw events (building its event tree would take
    minutes on a long window). The host spans' mirrors on the device's
    timeline (user annotations) are no device work and are left out."""
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        a, b = e.start_ns() / 1e3, e.end_ns() / 1e3
        if name.startswith("gpubench."):
            if not str(e.device_type()).endswith("CUDA"):
                host.append((a, b, name[len("gpubench."):]))
        elif str(e.device_type()).endswith("CUDA"):
            dev.append((a, b, name))
    return dev, host


def reduce_profile(prof) -> dict:
    """busy seconds, window seconds, device seconds by kernel and the
    longest labelled idle gaps, from a finished `torch.profiler.profile`.
    The window runs from the first job's start to the last one's end."""
    dev, host = profile_events(prof)
    outer = [(a, b) for a, b, n in host if n == SPANS[0]]
    w0, w1 = (min(a for a, _ in outer), max(b for _, b in outer)) if outer else (0.0, 0.0)
    ivals = [(max(a, w0), min(b, w1)) for a, b, _ in dev if b > w0 and a < w1]
    by_name: Dict[str, float] = {}
    for a, b, name in dev:
        if b > w0 and a < w1:
            k = short_name(name)
            by_name[k] = by_name.get(k, 0.0) + (min(b, w1) - max(a, w0)) / 1e6
    gaps = idle_gaps(ivals, w0, w1)
    label = Labeller(host)
    labelled = sorted(((label(a), (b - a) / 1e6) for a, b in gaps), key=lambda g: -g[1])
    idle_by_label: Dict[str, float] = {}
    for name, sec in labelled:
        idle_by_label[name] = idle_by_label.get(name, 0.0) + sec
    return {
        "busy_s": busy_union(ivals) / 1e6,
        "window_s": (w1 - w0) / 1e6,
        "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1]),
        "idle_gaps": labelled,
        "idle_by_label": idle_by_label,
        "n_device_events": len(dev),
    }
