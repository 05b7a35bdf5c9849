"""The latencies a walk's hop and a step probe's step are made of, on
the card.

`walk_latency_ns` times csrc/probe_latency.cu: one thread's chain of n
and 2n dependent shared-memory loads, then of dependent integer adds and
xors in turn, each with CUDA events; the difference of the two lengths
over n is the latency of one operation without the launch. `dram_ns`
times one thread's chain of n and 2n dependent device-memory loads that
miss L2 the same way. `step_latency_ns` times a warp's chain of
dependent shuffles and a block's barriers, one after another, at each
block size asked for. chip_smoke.py phase 16 and the probes' entry point
multiply them into the walks' and the step probes' chain bounds. All
need a CUDA card; the kernel is built at first use.
"""

from __future__ import annotations

import torch


def _card(device) -> torch.device:
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the latency probes time a CUDA card, not {device}")
    return device


def _chain_ns(lib, device, kind: int, n: int, threads: int, per: int) -> float:
    """One operation of a latency kind, in ns: chains of n and 2n timed
    (3 launches each, after one), their difference over per * n."""
    from ..wfa import cuda_build

    sink = torch.zeros(1, dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(device)
    ms = []
    for m in (n, 2 * n):
        cuda_build.check(lib.allwave_probe_latency(kind, m, threads, sink.data_ptr(),
                                                   stream.cuda_stream), "latency probe launch")
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record(stream)
        for _ in range(3):
            lib.allwave_probe_latency(kind, m, threads, sink.data_ptr(), stream.cuda_stream)
        end.record(stream)
        end.synchronize()
        ms.append(start.elapsed_time(end) / 3)
    return 1e6 * (ms[1] - ms[0]) / (per * n)


def walk_latency_ns(device, n: int = 1 << 16) -> dict:
    """{"lds_ns", "alu_ns"}: one dependent shared-memory load and one
    dependent integer add or xor on one thread of `device`."""
    from ..wfa import cuda_build

    device = _card(device)
    lib = cuda_build.library("probe_latency")
    return {"lds_ns": _chain_ns(lib, device, 0, n, 1, 1),
            "alu_ns": _chain_ns(lib, device, 1, n, 1, 2)}


def step_latency_ns(device, block_sizes, n: int = 1 << 16) -> dict:
    """{"shfl_ns", "bar_ns": {threads: ns}}: one dependent shuffle on a
    warp, and one barrier of a block of each size in `block_sizes` (a
    multiple of 32 up to 1024), on `device`."""
    from ..wfa import cuda_build

    device = _card(device)
    lib = cuda_build.library("probe_latency")
    return {"shfl_ns": _chain_ns(lib, device, 2, n, 32, 1),
            "bar_ns": {int(t): _chain_ns(lib, device, 3, n, int(t), 1)
                       for t in sorted(set(block_sizes))}}


def dram_ns(device, n: int = 8192, words: int = 1 << 26, stride: int = 1031,
            reps: int = 3) -> float:
    """One dependent device-memory load that misses L2 (and L1), in ns,
    on one thread of `device`: a pointer chase through a buffer of
    `words` int32 (256 MB, five times the L2) where entry i holds
    (i + stride) mod words, so a chain of 2n loads never reads a 32-byte
    sector twice; L2 is flushed (128 MB written) before each timed
    chain. The mean over `reps` chains of n and of 2n loads, their
    difference over n."""
    from ..wfa import cuda_build

    device = _card(device)
    if 2 * n * stride >= words:
        raise ValueError(f"a chain of {2 * n} loads at stride {stride} wraps a buffer of {words}")
    lib = cuda_build.library("probe_latency")
    buf = torch.arange(stride, words + stride, dtype=torch.int32, device=device)
    buf = torch.where(buf >= words, buf - words, buf)
    flush = torch.empty(1 << 25, dtype=torch.int32, device=device)
    sink = torch.zeros(1, dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(device)
    ms = []
    for m in (n, 2 * n):
        total = 0.0
        for r in range(reps + 1):  # the first call warms up the launch
            flush.zero_()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record(stream)
            cuda_build.check(lib.allwave_probe_dram(buf.data_ptr(), r * (words // (reps + 1)), m,
                                                    sink.data_ptr(), stream.cuda_stream),
                             "dram latency probe launch")
            end.record(stream)
            end.synchronize()
            if r:
                total += start.elapsed_time(end)
        ms.append(total / reps)
    return 1e6 * (ms[1] - ms[0]) / n
