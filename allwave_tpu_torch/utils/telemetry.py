"""Process-wide engine counters and host spans.

Counters, added where the work happens:

* `cells`: banded DP cells swept (from launch shapes);
* `dispatches`: kernel wrapper calls, one each;
* `syncs`: host waits on the device, one per device-to-host copy
  (each small tensor's `.cpu()` is its own round trip) or copy-future
  wait;
* `reruns`: pairs queued to be aligned again (band, run-cap or score-cap
  escalations, and the wavefront engine's hand-backs to the segmented
  engine);
* `expansions`: pairs whose per-base CIGAR byte array the port builds
  from its runs (a caller that asks for runs, as the pipeline does,
  builds none);
* `sketches`: stranded MinHash sets orientation builds (a sequence's
  forward set and its reverse complement's are two);
* `paf_batches`: the CLI writer's batch passes over its queued records'
  CIGAR text (`engine/paf_text.py`), one each;
* `paf_batched`: the records whose CIGAR text a batch pass made.

Spans (`counters.span(name)`) time the host's phases by name: count,
wall seconds (`perf_counter_ns`) and the thread's CPU seconds
(`thread_time_ns`); wall minus CPU is time the thread did not run,
blocked on the device, a copy or the interpreter lock (a CUDA
synchronisation that spins counts as CPU). They are always on. A
span entered while a span of the same name is open on the same thread
joins it; a span entered inside another records that one as its parent.

While a `torch.profiler` session is active on its thread, each span is
also logged (`span_log()`) with its parent, the run and chunk it
belongs to, its thread, and its start and end on the profiler's clock
(the Unix epoch clock, in ns). The log is plain host memory: no
profiler event, NVTX range or file, so the device timeline holds only
device work.
"""

from __future__ import annotations

import threading
from time import perf_counter_ns, thread_time_ns, time_ns
from typing import Dict, List, NamedTuple, Optional

from torch.autograd import _profiler_enabled


class SpanRecord(NamedTuple):
    name: str
    parent: Optional[str]
    run: int
    chunk: Optional[int]
    thread: int
    start_ns: int
    end_ns: int


class _Open(threading.local):
    """The names of the spans open on this thread, innermost last."""

    def __init__(self):
        self.names: List[str] = []


class _Span:
    __slots__ = ("_c", "_name", "_parent", "_joined", "_logged", "_t0", "_c0")

    def __init__(self, counters: "EngineCounters", name: str):
        self._c = counters
        self._name = name

    def __enter__(self):
        names = self._c._open.names
        self._parent = names[-1] if names else None
        self._joined = self._parent == self._name
        if self._joined:
            return self
        names.append(self._name)
        self._logged = _profiler_enabled()
        self._c0 = thread_time_ns()
        self._t0 = perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self._joined:
            return False
        t1 = perf_counter_ns()
        c1 = thread_time_ns()
        c = self._c
        c._open.names.pop()
        with c._lock:
            tot = c._spans.get(self._name)
            if tot is None:
                tot = c._spans[self._name] = [0, 0, 0]
            tot[0] += 1
            tot[1] += t1 - self._t0
            tot[2] += c1 - self._c0
            if self._logged:
                if c._offset_ns is None:
                    c._offset_ns = _clock_offset()
                off = c._offset_ns
                c._log.append(SpanRecord(self._name, self._parent, c.run, c.chunk,
                                         threading.get_ident(), self._t0 + off, t1 + off))
        return False


def _clock_offset() -> int:
    """The profiler's clock (`time_ns`) less `perf_counter_ns`, read
    between two `perf_counter_ns` samples."""
    a = perf_counter_ns()
    w = time_ns()
    b = perf_counter_ns()
    return w - (a + b) // 2


class EngineCounters:
    def __init__(self):
        self._lock = threading.Lock()
        self._open = _Open()
        self.cells = 0
        self.dispatches = 0
        self.syncs = 0
        self.reruns = 0
        self.expansions = 0
        self.sketches = 0
        self.paf_batches = 0
        self.paf_batched = 0
        self._spans: Dict[str, List[int]] = {}
        self._log: List[SpanRecord] = []
        self._offset_ns: Optional[int] = None
        #: the pipeline run (one per `for_each_with_callback` call) and
        #: the chunk the pipeline's thread works on, stamped on each
        #: logged span
        self.run = 0
        self.chunk: Optional[int] = None

    def add(self, cells: int = 0, dispatches: int = 0, syncs: int = 0, reruns: int = 0,
            expansions: int = 0, sketches: int = 0, paf_batches: int = 0,
            paf_batched: int = 0) -> None:
        with self._lock:
            self.cells += cells
            self.dispatches += dispatches
            self.syncs += syncs
            self.reruns += reruns
            self.expansions += expansions
            self.sketches += sketches
            self.paf_batches += paf_batches
            self.paf_batched += paf_batched

    def span(self, name: str) -> _Span:
        """`with counters.span(name): ...` times the block."""
        return _Span(self, name)

    def begin_run(self) -> None:
        """A new run id for the spans that follow; no chunk yet."""
        with self._lock:
            self.run += 1
            self.chunk = None

    def span_log(self) -> List[SpanRecord]:
        """The spans logged while a profiler was active, in the order
        they ended."""
        with self._lock:
            return list(self._log)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "cells": self.cells,
                "dispatches": self.dispatches,
                "syncs": self.syncs,
                "reruns": self.reruns,
                "expansions": self.expansions,
                "sketches": self.sketches,
                "paf_batches": self.paf_batches,
                "paf_batched": self.paf_batched,
                "spans": {
                    name: {"count": n, "wall_s": wall / 1e9, "cpu_s": cpu / 1e9}
                    for name, (n, wall, cpu) in self._spans.items()
                },
            }

    def reset(self) -> None:
        with self._lock:
            self.cells = 0
            self.dispatches = 0
            self.syncs = 0
            self.reruns = 0
            self.expansions = 0
            self.sketches = 0
            self.paf_batches = 0
            self.paf_batched = 0
            self._spans.clear()
            self._log.clear()
            self._offset_ns = _clock_offset()


#: process-wide counters of the engines, the pipeline and the CLI
counters = EngineCounters()


def to_host(*tensors) -> list:
    """Each tensor as a NumPy array, inside an `engine.wait` span; each
    copy is one sync."""
    with counters.span("engine.wait"):
        out = [t.cpu().numpy() for t in tensors]
    counters.add(syncs=len(tensors))
    return out
