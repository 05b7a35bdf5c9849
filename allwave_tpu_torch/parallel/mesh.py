"""Data-parallel fan-out of the dense engine over the local devices
(reference: allwave_tpu/parallel/mesh.py).

The reference's production parallelism plan (SURVEY.md §2.4): the
unique-sequence pool is REPLICATED on every device and the pair-index
stream is SHARDED, so each device runs the fused forward + traceback on
its own pair shard with no traffic between devices in the hot loop.
Here a shard is a contiguous block of the batch, the layout of the
reference's `P("data")`, launched on its own device; the packed rows
come back in shard order.

Not ported: the reference's "diag" mesh axis. It serves only
`sharded_alignment_step`, which shards the XLA `batch.wavefront_forward`,
and that engine is not part of the port (ROADMAP Queue 1, "Do not
port").
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import List

import torch

from ..wfa import dense as D_


def local_devices(device) -> List[torch.device]:
    """The devices a dispatch on `device` fans out over: every visible
    CUDA device for a CUDA device, else `device` alone."""
    device = torch.device(device)
    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [device]


def sharded_dense_step(devices, pen, k_width: int, l_pad: int, run_cap: int):
    """fn(pool, qidx, tidx, qlens, tlens) -> the packed
    (B, 32 + ceil(run_cap/4) + run_cap) uint8 rows of one
    `wfa.dense.dense_align_packed` call, on the pool's device.

    The pool is copied once to each device and kept for as long as the
    caller hands the same pool tensor (the engine caches its device
    pool per run). The batch need not divide the device count: the
    index and length arrays are padded to a multiple of it (padded rows
    point at pool row 0 with length 0, the standard padding contract)
    and the rows are cut back to the true batch size."""
    devices = [torch.device(d) for d in devices]
    nd = len(devices)
    cache = {}  # id(pool) -> (pool, its copy on each device)

    def replicas(pool):
        hit = cache.get(id(pool))
        if hit is None or hit[0] is not pool:
            cache.clear()
            hit = cache[id(pool)] = (pool, [pool.to(dev) for dev in devices])
        return hit[1]

    def step(pool, qidx, tidx, qlens, tlens):
        b0 = qidx.shape[0]
        pad = (-b0) % nd
        arrays = [qidx, tidx, qlens, tlens]
        if pad:
            arrays = [
                torch.cat([a, torch.zeros(pad, dtype=a.dtype, device=a.device)])
                for a in arrays
            ]
        per = (b0 + pad) // nd
        outs = []
        for d, (dev, pool_d) in enumerate(zip(devices, replicas(pool))):
            shard = [a[d * per : (d + 1) * per].to(dev) for a in arrays]
            # the kernels launch on the current CUDA device's context
            with torch.cuda.device(dev) if dev.type == "cuda" else nullcontext():
                outs.append(D_.dense_align_packed(
                    pool_d, *shard, pen, k_width, l_pad, run_cap
                ))
        return torch.cat([o.to(pool.device) for o in outs])[:b0]

    return step
