"""Multi-process distribution: pair-shard scheduling + PAF shard merging
(reference: allwave_tpu/parallel/dist.py, on `torch.distributed`).

The reference is a single-process tool (rayon threads + one mpsc
channel, main.rs:347-380). The scale-out:

* every process loads the same FASTA (sequences replicated);
* the SPARSIFIED pair list is deterministic (SipHash-driven), so each
  process takes a strided slice of it with no coordination;
* each process runs the normal batched pipeline on its shard and streams
  its own PAF file; shards concatenate into the full output (record
  order is unspecified, exactly like the reference at t>1).

The process group only tells each process its rank and the world size:
no tensor is exchanged, so it uses the `gloo` backend, and two processes
may share one GPU. Within a process the dense engine still fans its
dispatches over every local GPU (parallel.mesh).
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Sequence as PySequence

import numpy as np
import torch.distributed as dist

from ..core.types import AlignmentParams, Sequence, SparsificationStrategy


def init_distributed(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
) -> None:
    """Initialize the torch.distributed process group (gloo) for a
    multi-process run. No-op when the arguments are absent and torch's
    own environment (MASTER_ADDR / MASTER_PORT, WORLD_SIZE, RANK, as
    `torchrun` sets them) is not set."""
    if init_method is None and os.environ.get("MASTER_ADDR"):
        init_method = "env://"
    if world_size is None and os.environ.get("WORLD_SIZE"):
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None and os.environ.get("RANK"):
        rank = int(os.environ["RANK"])
    if init_method is None and world_size is None:
        return  # single-process run
    dist.init_process_group(
        "gloo", init_method=init_method, world_size=world_size, rank=rank
    )


def process_topology():
    """(rank, world_size) of this process; (0, 1) without an initialized
    process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def shard_pairs(
    pairs: np.ndarray, proc: Optional[int] = None, nprocs: Optional[int] = None
) -> np.ndarray:
    """Strided slice of the (n_pairs, 2) pair list for this process.
    Strided (not blocked) so processes see similar length mixes."""
    if proc is None or nprocs is None:
        proc, nprocs = process_topology()
    return pairs[proc::nprocs]


class DistributedAllPairAligner:
    """Per-process view of an all-pairs run: the same constructor surface
    as engine.pipeline.AllPairAligner, but for_each_with_callback only
    visits this process's pair shard."""

    def __init__(
        self,
        sequences: PySequence[Sequence],
        params: AlignmentParams,
        exclude_self: bool = True,
        use_mash_orientation: bool = True,
        sparsification: SparsificationStrategy = None,
        **kw,
    ):
        from ..engine.pipeline import AllPairAligner

        self._inner = AllPairAligner(
            sequences,
            params,
            exclude_self=exclude_self,
            use_mash_orientation=use_mash_orientation,
            sparsification=sparsification,
            **kw,
        )
        self.proc, self.nprocs = process_topology()
        self._inner.pairs = shard_pairs(
            self._inner.pairs, self.proc, self.nprocs
        )

    def pair_count(self) -> int:
        return self._inner.pair_count()

    def for_each_with_callback(self, callback: Callable) -> None:
        self._inner.for_each_with_callback(callback)

    def shard_path(self, output_prefix: str) -> str:
        return f"{output_prefix}.shard{self.proc:05d}.paf"

    def run_to_paf_shard(self, output_prefix: str) -> str:
        """Align this process's shard and stream it to its own PAF file."""
        from ..core.paf import alignment_to_paf

        path = self.shard_path(output_prefix)
        seqs = self._inner.sequences
        with open(path, "w") as out:
            self._inner.for_each_with_callback(
                lambda r: out.write(alignment_to_paf(r, seqs) + "\n")
            )
        return path


def merge_paf_shards(output_prefix: str, n_shards: int, dest: str) -> None:
    """Concatenate per-process shards (order-insensitive output contract)."""
    with open(dest, "w") as out:
        for p in range(n_shards):
            with open(f"{output_prefix}.shard{p:05d}.paf") as f:
                for line in f:
                    out.write(line)
