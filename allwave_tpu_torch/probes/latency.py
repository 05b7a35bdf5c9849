"""The latencies a long-path walk's hop is made of, on the card.

`walk_latency_ns` times csrc/probe_latency.cu: one thread's chain of n
and 2n dependent shared-memory loads, then of dependent integer adds and
xors in turn, each with CUDA events; the difference of the two lengths
over n is the latency of one operation without the launch. chip_smoke.py
phase 16 multiplies them into the walks' chain bounds. It needs a CUDA
card; the kernel is built at first use.
"""

from __future__ import annotations

import torch


def walk_latency_ns(device, n: int = 1 << 16) -> dict:
    """{"lds_ns", "alu_ns"}: one dependent shared-memory load and one
    dependent integer add or xor on one thread of `device`."""
    from ..wfa import cuda_build

    lib = cuda_build.library("probe_latency")
    sink = torch.zeros(1, dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(device)
    out = {}
    for kind, key, per in ((0, "lds_ns", 1), (1, "alu_ns", 2)):
        ms = []
        for m in (n, 2 * n):
            cuda_build.check(lib.allwave_probe_latency(kind, m, sink.data_ptr(), stream.cuda_stream),
                             "latency probe launch")
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record(stream)
            for _ in range(3):
                lib.allwave_probe_latency(kind, m, sink.data_ptr(), stream.cuda_stream)
            end.record(stream)
            end.synchronize()
            ms.append(start.elapsed_time(end) / 3)
        out[key] = 1e6 * (ms[1] - ms[0]) / (per * n)
    return out
