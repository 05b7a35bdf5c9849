"""The readers of the program's own spans and counters, on a fake
context and primed counters, and the split of idle gaps over the
program's span log."""

import pytest

from allwave_tpu_torch.utils.telemetry import SpanRecord, counters
from gpubench import spanlog, spec

SPANS = {"engine.plan": 0.4, "engine.launch": 1.2, "engine.wait": 2.0, "engine.unpack": 0.8,
         "pipeline.emit_wait": 0.1, "cli.drain": 3.0}
SNAP = {"cells": 10, "dispatches": 30, "syncs": 12, "reruns": 5,
        "spans": {n: {"count": 3, "wall_s": s, "cpu_s": s / 2} for n, s in SPANS.items()}}
CTX = {"jobs": 4, "span_s": {"cli": 20.0, "pairs": 0.1, "pipeline": 9.0, "orient": 1.5, "emit": 0.3}}


@pytest.fixture
def primed(monkeypatch):
    monkeypatch.setattr(counters, "snapshot", lambda: SNAP)


@pytest.mark.parametrize("name,want", [
    ("engine.plan_ms_per_job", 1e3 * 0.4 / 4),
    ("engine.launch_ms_per_job", 1e3 * 1.2 / 4),
    ("engine.wait_ms_per_job", 1e3 * 2.0 / 4),
    ("engine.unpack_ms_per_job", 1e3 * 0.8 / 4),
    ("engine.syncs_per_job", 12 / 4),
    ("engine.reruns_per_job", 5 / 4),
    ("cli.drain_ms_per_job", 1e3 * 3.0 / 4),
    # the pipeline less orientation, the four engine spans and the emit waits
    ("pipeline.untraced_ms_per_job", 1e3 * (9.0 - 1.5 - (0.4 + 1.2 + 2.0 + 0.8) - 0.1) / 4),
])
def test_readers(primed, name, want):
    read = spec.load_reader(name)
    assert read(CTX) == pytest.approx(want)
    assert read({**CTX, "jobs": 0}) is None


@pytest.mark.parametrize("name", ["engine.plan_ms_per_job", "engine.syncs_per_job",
                                  "pipeline.untraced_ms_per_job", "cli.drain_ms_per_job"])
def test_a_program_without_spans_reads_none(monkeypatch, name):
    monkeypatch.setattr(counters, "snapshot", lambda: {"pairs": 3, "cells": 10, "dispatches": 2,
                                                       "device_seconds": 0.1, "cells_per_sec": 100})
    assert spec.load_reader(name)(CTX) is None


def test_readers_on_live_counters():
    counters.reset()
    with counters.span("engine.wait"):
        pass
    counters.add(syncs=3)
    snap = counters.snapshot()
    assert spec.load_reader("engine.wait_ms_per_job")(CTX) == pytest.approx(
        1e3 * snap["spans"]["engine.wait"]["wall_s"] / 4)
    assert spec.load_reader("engine.syncs_per_job")(CTX) == 0.75
    assert spec.load_reader("engine.plan_ms_per_job")(CTX) == 0.0  # never opened
    counters.reset()


def test_overlaps():
    gaps = [(0, 10), (20, 30), (40, 50)]
    spans = [(5, 25, "a"), (26, 27, "b"), (45, 60, "a"), (60, 70, "c")]
    got = spanlog._overlaps(gaps, spans)
    assert got == {"a": pytest.approx((5 + 5 + 5) / 1e6), "b": pytest.approx(1 / 1e6)}


class _Event:
    def __init__(self, name, a, b, cuda):
        self._n, self._a, self._b, self._cuda = name, a, b, cuda

    def name(self):
        return self._n

    def start_ns(self):
        return self._a

    def end_ns(self):
        return self._b

    def device_type(self):
        return "DeviceType.CUDA" if self._cuda else "DeviceType.CPU"


class _Prof:
    def __init__(self, events):
        ev = events
        self.profiler = type("P", (), {"kineto_results": type("K", (), {"events": lambda self: ev})()})()


def test_split_idle():
    us = 1000  # ns
    events = [_Event("gpubench.cli", 0, 100 * us, False), _Event("gpubench.cli", 200 * us, 300 * us, False),
              _Event("kernel", 10 * us, 30 * us, True), _Event("kernel", 210 * us, 290 * us, True)]
    log = [SpanRecord("engine.launch", None, 1, 0, 7, 5 * us, 20 * us),
           SpanRecord("engine.wait", None, 1, 0, 7, 20 * us, 40 * us),
           SpanRecord("cli.drain", None, 1, 0, 7, 60 * us, 95 * us),
           SpanRecord("engine.wait", None, 2, 0, 7, 205 * us, 299 * us)]
    got = spanlog.split_idle(_Prof(events), log)
    # window 0..300 us, busy 20 + 80: idle 200 us
    assert got["window_s"] == pytest.approx(300e-6) and got["idle_s"] == pytest.approx(200e-6)
    assert got["idle_by_span"]["engine.launch"] == pytest.approx(5e-6)
    assert got["idle_by_span"]["engine.wait"] == pytest.approx(10e-6 + 5e-6 + 9e-6)
    assert got["idle_by_span"]["cli.drain"] == pytest.approx(35e-6)
    assert sum(got["idle_by_span"].values()) == pytest.approx(200e-6)
    assert got["busy_in_span"]["engine.wait"] == pytest.approx(10e-6 + 80e-6)
    assert got["max_outside_cli_us"] == 0.0 and got["drain_to_cli_end_us"] == [5.0, 5.0]
    assert got["events_with_span_names"] == 0
    late = log + [SpanRecord("engine.plan", None, 2, 0, 7, 190 * us, 201 * us)]
    assert spanlog.split_idle(_Prof(events), late)["max_outside_cli_us"] == pytest.approx(10.0)


def test_span_cost():
    got = spanlog.span_cost(2000)
    assert got["ns_per_span_log_off"] > 0 and got["ns_per_span_log_on"] > 0
