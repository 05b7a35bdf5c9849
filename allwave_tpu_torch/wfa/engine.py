"""Host orchestration of the batched wavefront engine (reference:
allwave_tpu/wfa/engine.py).

The production alignment path is the dense banded engine
(dense_engine.py, segmented.py, wf_segmented.py). This score-sweep
(WFA-style) engine is a second, independent engine for score-only
discovery workloads and a cross-check in the parity suites; it runs on
its own kernels (csrc/wf_batch.cu), none of which the other engines
use.

Pairs are aligned in two device passes (see batch.py):

1. score discovery with escalating score caps (64, 256, 1024, ...):
   a rolling score-only pass; unfinished pairs escalate to a 4x larger
   cap.
2. pairs bucketed by their exact score s*; each bucket runs the
   full-history pass + traceback, in batches sized so that the history
   fits the memory budget.

A discovery batch is padded to a power of two with empty pairs, as the
reference pads every batch to reuse its XLA compiles; a history batch
runs at its own size, so that no history tensor exceeds
`history_budget_bytes` unless one pair alone does. Sequence rows are
padded to a power of two of at least `batch.L_ALIGN` bytes. Padding
changes no output.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..utils.telemetry import to_host
from . import batch as B_
from .params import Penalties
from .rounds import next_pow2


@dataclass
class EngineConfig:
    #: device-memory budget for the history planes of one in-flight batch
    history_budget_bytes: int = 4 << 30
    #: number of pairs per score-discovery chunk (lanes = B * K)
    prepass_lane_budget: int = 1 << 22
    #: initial score cap for discovery
    s_cap_initial: int = 64
    #: escalation factor between discovery rounds
    s_cap_growth: int = 4
    #: absolute cap: pairs needing more fail (score -1, result None)
    s_cap_max: int = 1 << 15
    #: max pairs per history batch regardless of memory
    max_batch: int = 512


class BatchWavefrontAligner:
    """Aligns many (query, target) byte-string pairs on one device: the
    csrc/wf_batch.cu kernels on a GPU, their plain versions on the CPU.
    Building one stores its configuration and allocates nothing."""

    def __init__(self, pen: Penalties, config: Optional[EngineConfig] = None, device=None):
        self.pen = pen
        self.config = config or EngineConfig()
        self.device = resolve_device(device)

    # -- helpers ----------------------------------------------------------

    @staticmethod
    def _pad_batch(seqs: List[bytes], pad_to: int) -> np.ndarray:
        out = np.zeros((len(seqs), pad_to), dtype=np.uint8)
        for i, s in enumerate(seqs):
            out[i, : len(s)] = np.frombuffer(s, dtype=np.uint8)
        return out

    def _batch(self, pairs: List[Tuple[bytes, bytes]], with_history: bool):
        """(qs, ts, qlens, tlens) on the device for one forward: the
        batch padded to a power of two with empty pairs unless it keeps
        history, the rows to a power of two of at least L_ALIGN bytes."""
        if not with_history:
            pairs = pairs + [(b"", b"")] * (next_pow2(len(pairs)) - len(pairs))
        qlens = np.array([len(q) for q, _ in pairs], dtype=np.int32)
        tlens = np.array([len(t) for _, t in pairs], dtype=np.int32)
        longest = int(max(qlens.max(), tlens.max(), 1))
        l_pad = max(next_pow2(max(longest, 4)), B_.L_ALIGN)
        arrays = (
            self._pad_batch([q for q, _ in pairs], l_pad),
            self._pad_batch([t for _, t in pairs], l_pad),
            qlens,
            tlens,
        )
        return tuple(torch.from_numpy(a).to(self.device) for a in arrays)

    def _run_forward(self, pairs: List[Tuple[bytes, bytes]], s_cap: int, with_history: bool):
        """One device invocation over a fixed batch at band K = 2 s_cap + 1.
        Returns (scores, done, hist, (qlens, tlens) as device int32
        tensors, n_real)."""
        qs, ts, qlens, tlens = self._batch(pairs, with_history)
        scores, done, hist = B_.wavefront_forward(
            qs, ts, qlens, tlens, self.pen, s_cap, 2 * s_cap + 1, with_history
        )
        return scores, done, hist, (qlens, tlens), len(pairs)

    # -- pass 1: score discovery ------------------------------------------

    def discover_scores(self, pairs: List[Tuple[bytes, bytes]]) -> np.ndarray:
        """Exact score per pair (int64 array; -1 = exceeded s_cap_max).

        Pairs that exceed s_cap_max are reported as failures (-1); the
        pipeline turns them into the reference's zeroed PAF records."""
        n = len(pairs)
        scores = np.full(n, -1, dtype=np.int64)
        pending = list(range(n))
        s_cap = self.config.s_cap_initial
        while pending:
            if s_cap > self.config.s_cap_max:
                break  # remaining pairs stay at -1 (failed)
            K = 2 * s_cap + 1
            chunk = max(1, self.config.prepass_lane_budget // K)
            still = []
            for lo in range(0, len(pending), chunk):
                idxs = pending[lo : lo + chunk]
                sc, done, _, _, _ = self._run_forward(
                    [pairs[i] for i in idxs], s_cap, with_history=False
                )
                sc, done_np = to_host(sc, done)
                for j, i in enumerate(idxs):
                    if done_np[j]:
                        scores[i] = int(sc[j])
                    else:
                        still.append(i)
            pending = still
            s_cap *= self.config.s_cap_growth
        return scores

    # -- pass 2: history + traceback --------------------------------------

    def _history_batch_size(self, s_cap: int) -> int:
        K = 2 * s_cap + 1
        bytes_per_pair = 5 * 4 * (s_cap + 1) * K
        b = self.config.history_budget_bytes // max(bytes_per_pair, 1)
        return int(max(1, min(b, self.config.max_batch)))

    def align_pairs(
        self, pairs: List[Tuple[bytes, bytes]]
    ) -> List[Optional[Tuple[int, np.ndarray]]]:
        """Returns [(score, cigar_bytes uint8)] in input order; None for
        pairs that failed (exceeded the score cap, or overflowed)."""
        n = len(pairs)
        results: List[Optional[Tuple[int, np.ndarray]]] = [None] * n
        scores = self.discover_scores(pairs)

        # bucket by power-of-two score cap
        buckets: dict = {}
        for i in range(n):
            s = int(scores[i])
            if s < 0:
                continue  # failed pair -> None result
            cap = max(self.config.s_cap_initial, 1 << (max(s, 1) - 1).bit_length())
            buckets.setdefault(cap, []).append(i)

        for cap, idxs in sorted(buckets.items()):
            bsz = self._history_batch_size(cap)
            # batch similar-length pairs together to minimize padding
            idxs = sorted(idxs, key=lambda i: len(pairs[i][0]) + len(pairs[i][1]))
            for lo in range(0, len(idxs), bsz):
                group = idxs[lo : lo + bsz]
                sc, _, hist, (qlens, tlens), _ = self._run_forward(
                    [pairs[i] for i in group], cap, with_history=True
                )
                ops, lens, nruns, overflow = B_.wavefront_traceback(
                    hist, sc, qlens, tlens, self.pen, 2 * cap + 16
                )
                del hist
                ops, lens, nruns, overflow, sc = to_host(ops, lens, nruns, overflow, sc)
                for j, i in enumerate(group):
                    if overflow[j] or sc[j] < 0:
                        continue  # failed -> zeroed PAF upstream
                    cigar = B_.expand_runs_to_cigar(ops[j], lens[j], int(nruns[j]))
                    results[i] = (int(sc[j]), cigar)
        return results
