"""Data-parallel fan-out of the dense engine over the local devices
(reference: allwave_tpu/parallel/mesh.py).

The reference's production parallelism plan (SURVEY.md §2.4): the
unique-sequence pool is REPLICATED on every device and the pair-index
stream is SHARDED, so each device runs the fused forward + traceback on
its own pair shard with no traffic between devices in the hot loop.
Here a shard is a contiguous block of the batch, the layout of the
reference's `P("data")`, launched on its own device; the packed rows
come back in shard order.

The batched wavefront engine's step (`sharded_alignment_step`) is
sharded the same way: one contiguous block of the batch a device, each
pair's whole band on one card. The reference's "diag" mesh axis, which
splits the band across chips by GSPMD with halo exchanges for the
k +- 1 shifts, is a TPU layout that changes no output; the port does
not split a band.
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import List

import torch

from ..wfa import batch as B_
from ..wfa import dense as D_


def local_devices(device) -> List[torch.device]:
    """The devices a dispatch on `device` fans out over: every visible
    CUDA device for a CUDA device, else `device` alone."""
    device = torch.device(device)
    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [device]


def _shard_rows(arrays, devices):
    """Pad the leading (pair) axis of `arrays` with zero rows to a
    multiple of the device count and cut it into one contiguous block a
    device, each copied to its device. Returns (blocks, true size)."""
    nd = len(devices)
    b0 = arrays[0].shape[0]
    pad = (-b0) % nd
    if pad:
        arrays = [
            torch.cat([a, torch.zeros((pad, *a.shape[1:]), dtype=a.dtype, device=a.device)])
            for a in arrays
        ]
    per = (b0 + pad) // nd
    return [[a[d * per : (d + 1) * per].to(dev) for a in arrays]
            for d, dev in enumerate(devices)], b0


def _on(dev):
    """The kernels launch on the current CUDA device's context."""
    return torch.cuda.device(dev) if dev.type == "cuda" else nullcontext()


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
    cache = {}  # id(pool) -> (pool, its copy on each device)

    def replicas(pool):
        hit = cache.get(id(pool))
        if hit is None or hit[0] is not pool:
            cache.clear()
            hit = cache[id(pool)] = (pool, [pool.to(dev) for dev in devices])
        return hit[1]

    def step(pool, qidx, tidx, qlens, tlens):
        shards, b0 = _shard_rows([qidx, tidx, qlens, tlens], devices)
        outs = []
        for dev, pool_d, shard in zip(devices, replicas(pool), shards):
            with _on(dev):
                outs.append(D_.dense_align_packed(
                    pool_d, *shard, pen, k_width, l_pad, run_cap
                ))
        return torch.cat([o.to(pool.device) for o in outs])[:b0]

    return step


def sharded_alignment_step(devices, pen, s_cap: int, k_width: int):
    """fn(qs, ts, qlens, tlens) -> (scores, ops, lens, nruns, overflow):
    the batched wavefront engine's full alignment step (history forward
    + traceback at run_cap = 2 s_cap + 16, wfa/batch.py) with the batch
    cut into one contiguous block a device, on the inputs' device and
    equal to one device's result. The batch need not divide the device
    count: it is padded with empty pairs (length 0, done at score 0)
    and the outputs are cut back to the true batch size."""
    devices = [torch.device(d) for d in devices]
    run_cap = 2 * s_cap + 16

    def step(qs, ts, qlens, tlens):
        shards, b0 = _shard_rows([qs, ts, qlens, tlens], devices)
        outs = []
        for dev, (q, t, ql, tl) in zip(devices, shards):
            with _on(dev):
                scores, _, hist = B_.wavefront_forward(q, t, ql, tl, pen, s_cap, k_width, True)
                ops, lens, nruns, overflow = B_.wavefront_traceback(
                    hist, scores, ql, tl, pen, run_cap
                )
                outs.append((scores, ops, lens, nruns, overflow))
        return tuple(torch.cat([o[i].to(qs.device) for o in outs])[:b0] for i in range(5))

    return step
