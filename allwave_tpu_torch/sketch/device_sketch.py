"""Orientation's stranded MinHash sets on the card: every set a route of
`OrientationIndex` reads, built in one launch of csrc/minhash_sketch.cu.

`stranded_sets(seqs, seq_idx, reverse, k, sketch_size, device)` gives,
for each job (a sequence of `seqs` and a strand), the set the index
keeps for it: `np.unique(sketch_stranded(strand, k, sketch_size))`,
ascending uint64, the reverse strand being orientation's
`reverse_complement` of the sequence. One launch builds every set and
one copy brings them back. It runs only on a CUDA device and raises on
any other: the plain version is the index's own host loop
(`OrientationIndex._fwd_set` / `_rev_set`), which a CPU index takes.
The sets are bit-identical either way, so one index may hold sets from
both.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from ..utils.telemetry import counters
from ..wfa.dense import LaunchCount
from ..wfa.rounds import next_pow2

#: the most windows a strand may have and keep its hashes in a block's
#: shared memory (64 KB); a longer strand hashes into its slice of a
#: device scratch and finds its cut by radix select
SHORT_MAX = 8192
#: the kernel's limits: k (its staging buffer) and sketch_size (a
#: block's shared memory holds the next power of two of entries, 8 bytes
#: each, and an H100 block may have 227 KB)
MAX_K = 256
MAX_SKETCH = 16384
#: the kernel counts a strand's windows in int32
MAX_WINDOWS = 1 << 30

#: the least int32 operations of one window's hash: five SipRounds (the
#: length prefix's is the same for every window) of 24 each with 64-bit
#: adds, xors and rotations emulated (a rotation by 32 is a renaming),
#: 8 for the two message words' xors, 1 for the finalisation's and 6
#: for the closing xor of the four words
HASH_OPS_PER_WINDOW = 5 * 24 + 8 + 1 + 6

#: kernel launches, by (sets, k, sketch_size, cap)
sketch_launches = LaunchCount()


class SketchPlan(NamedTuple):
    """A launch's layout over its jobs' strands."""

    #: (J,) windows of each strand (0 where it is shorter than k)
    windows: np.ndarray
    #: shared-memory entries of a block: the next power of two of
    #: sketch_size and of the windows of the longest strand of at most
    #: SHORT_MAX; a strand with more windows than cap is long
    cap: int
    #: (J,) each long strand's offset into the scratch (0 for the others)
    scratch_off: np.ndarray
    #: the scratch's entries: every long strand's windows
    scratch_len: int


def plan(lens: np.ndarray, k: int, sketch_size: int) -> SketchPlan:
    """The layout of a launch over strands of these lengths."""
    windows = np.maximum(np.asarray(lens, dtype=np.int64) - k + 1, 0)
    short = windows[windows <= SHORT_MAX]
    cap = next_pow2(max(sketch_size, int(short.max()) if short.size else 0))
    long_windows = np.where(windows > cap, windows, 0)
    ends = np.cumsum(long_windows)
    return SketchPlan(windows, cap, ends - long_windows, int(ends[-1]) if ends.size else 0)


def stranded_sets(seqs, seq_idx, reverse, k: int, sketch_size: int,
                  device: torch.device) -> List[np.ndarray]:
    """The stranded set of each job (`seqs[seq_idx[j]]`, reverse
    complemented where `reverse[j]`), in job order."""
    seq_idx = np.asarray(seq_idx, dtype=np.int64)
    reverse = np.asarray(reverse, dtype=bool)
    if seq_idx.shape != reverse.shape or seq_idx.ndim != 1:
        raise ValueError("seq_idx and reverse must be 1-D and of one length")
    if device.type != "cuda":
        raise ValueError(f"the sketch kernel runs on a CUDA device, not {device}")
    if seq_idx.size == 0:
        return []
    counters.add(dispatches=1)
    job = upload(seqs, seq_idx, reverse, k, sketch_size, device)
    return collect(job, launch(job))


class SketchJob(NamedTuple):
    """A launch's inputs on the card."""

    data: torch.Tensor  # the jobs' sequences, concatenated (uint8)
    meta: torch.Tensor  # int64: offsets (n + 1), then per job sequence, strand, scratch offset
    n_offs: int
    k: int
    sketch_size: int
    plan: SketchPlan


def upload(seqs, seq_idx: np.ndarray, reverse: np.ndarray, k: int, sketch_size: int,
           device: torch.device) -> SketchJob:
    """The jobs' bytes and tables on the card: each sequence a job
    reads once, its forward strand only; one pinned, non-blocking copy
    each of the bytes and of the int64 tables."""
    if not 1 <= k <= MAX_K or not 1 <= sketch_size <= MAX_SKETCH:
        raise ValueError(f"k {k} or sketch_size {sketch_size} outside the kernel's "
                         f"1..{MAX_K} and 1..{MAX_SKETCH}")
    used, local = np.unique(seq_idx, return_inverse=True)
    data = b"".join(seqs[i] for i in used.tolist())
    offs = np.zeros(used.size + 1, dtype=np.int64)
    np.cumsum([len(seqs[i]) for i in used.tolist()], out=offs[1:])
    lay = plan(offs[1:][local] - offs[:-1][local], k, sketch_size)
    if lay.windows.max() > MAX_WINDOWS:
        raise ValueError(f"a strand of {int(lay.windows.max())} windows: the kernel takes "
                         f"at most {MAX_WINDOWS}")
    J, n_offs = seq_idx.size, offs.size
    host_data = torch.empty(max(len(data), 1), dtype=torch.uint8, pin_memory=True)
    host_data.numpy()[: len(data)] = np.frombuffer(data, dtype=np.uint8)
    host_meta = torch.empty(n_offs + 3 * J, dtype=torch.int64, pin_memory=True)
    meta = host_meta.numpy()
    meta[:n_offs] = offs
    meta[n_offs : n_offs + J] = local
    meta[n_offs + J : n_offs + 2 * J] = reverse
    meta[n_offs + 2 * J :] = lay.scratch_off
    return SketchJob(host_data.to(device, non_blocking=True),
                     host_meta.to(device, non_blocking=True), n_offs, k, sketch_size, lay)


def launch(job: SketchJob) -> torch.Tensor:
    """One launch over every job: (J * sketch_size + J,) int64 on the
    card, each job's set in its row of sketch_size (uint64 bits,
    ascending, distinct), then each set's size."""
    from ..wfa import cuda_build

    J, S, o = job.plan.windows.size, job.sketch_size, job.n_offs
    device = job.meta.device
    scratch = torch.empty(max(job.plan.scratch_len, 1), dtype=torch.int64, device=device)
    res = torch.empty(J * S + J, dtype=torch.int64, device=device)
    rc = cuda_build.library("minhash_sketch").allwave_minhash_sketch(
        job.data.data_ptr(), job.meta.data_ptr(), job.meta[o:].data_ptr(),
        job.meta[o + J :].data_ptr(), job.meta[o + 2 * J :].data_ptr(), scratch.data_ptr(),
        J, job.k, S, job.plan.cap, res.data_ptr(), res[J * S :].data_ptr(),
        torch.cuda.current_stream(device).cuda_stream,
    )
    cuda_build.check(rc, "minhash_sketch kernel launch")
    sketch_launches.launched((J, job.k, S, job.plan.cap))
    return res


def collect(job: SketchJob, res: torch.Tensor) -> List[np.ndarray]:
    """The sets, from one pinned copy of the launch's output: each a
    uint64 view of its row, cut to its size."""
    J, S = job.plan.windows.size, job.sketch_size
    host = torch.empty(res.shape, dtype=torch.int64, pin_memory=True)
    host.copy_(res, non_blocking=True)
    torch.cuda.current_stream(res.device).synchronize()
    flat = host.numpy()
    sizes = flat[J * S :]
    rows = flat[: J * S].view(np.uint64).reshape(J, S)
    return [rows[j, : sizes[j]] for j in range(J)]
