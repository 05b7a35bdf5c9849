"""Process-wide engine counters (SURVEY §5: the reference only reports
alignments/sec; the rebuild adds DP-cell throughput observability).

Engines call `add(...)` after each device dispatch; callers read
`snapshot()` — e.g. bench.py's `wavefront_cells_per_sec` and the CLI's
final stats line. Thread-safe via a simple lock (the CLI writer thread
and the pipeline both touch results concurrently)."""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field


@dataclass
class EngineCounters:
    pairs: int = 0
    cells: int = 0  # banded DP cells swept (B * steps * K per dispatch)
    dispatches: int = 0
    device_seconds: float = 0.0
    _lock: threading.Lock = field(
        default_factory=threading.Lock, repr=False, compare=False
    )

    def add(
        self,
        pairs: int = 0,
        cells: int = 0,
        dispatches: int = 1,
        device_seconds: float = 0.0,
    ) -> None:
        with self._lock:
            self.pairs += pairs
            self.cells += cells
            self.dispatches += dispatches
            self.device_seconds += device_seconds

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "pairs": self.pairs,
                "cells": self.cells,
                "dispatches": self.dispatches,
                "device_seconds": round(self.device_seconds, 3),
                "cells_per_sec": (
                    round(self.cells / self.device_seconds)
                    if self.device_seconds > 0
                    else 0
                ),
            }

    def reset(self) -> None:
        with self._lock:
            self.pairs = 0
            self.cells = 0
            self.dispatches = 0
            self.device_seconds = 0.0


#: process-wide counters for the dense/segmented engines
counters = EngineCounters()


class timed_dispatch:
    """Context manager: `with timed_dispatch(pairs, cells): ...` around
    a blocking device round trip."""

    def __init__(self, pairs: int, cells: int):
        self.pairs = pairs
        self.cells = cells

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        counters.add(
            pairs=self.pairs,
            cells=self.cells,
            device_seconds=time.perf_counter() - self._t0,
        )
        return False
