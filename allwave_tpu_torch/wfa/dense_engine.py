"""Host orchestration of the dense banded engine, and the length-routed
aligner (reference: allwave_tpu/wfa/dense_engine.py).

DenseBandAligner is TRACE-FIRST: one fused forward + traceback launch
pair per batch at the initial band width; pairs whose banded score
carries the optimality certificate are done, the rest escalate to a
wider band computed directly from their banded score (banded >= true
score, so the jump is conservative). Pairs whose run buffer overflowed
rerun at the full cap 2L+8; pairs that cannot certify at `k_max` fail
(result None, the failed-pair contract).

Every round runs on the device the aligner was given: the CUDA kernels
on a GPU, their plain PyTorch versions on the CPU. UnifiedAligner sends
pairs longer than `dense_max_len` to the wavefront checkpoint-replay
engine (wfa/wf_segmented.py) or the segmented dense engine
(wfa/segmented.py).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..utils.telemetry import counters
from . import dense as D_
from .batch import expand_runs_batch
from .engine import BatchWavefrontAligner, EngineConfig
from .params import Penalties


@dataclass
class DenseConfig:
    k_initial: int = 128
    k_max: int = 1 << 14
    #: memory budget for the (2L, B, K) uint16 planes of one batch
    choices_budget_bytes: int = 4 << 30
    max_batch: int = 4096
    #: run buffer width fetched per pair; overflowing pairs (rare — more
    #: mutation events than this) rerun with the full 2L+8 cap
    run_cap_initial: int = 128


#: byte -> 4 WFA2 op chars, inverting the 2-bit op packing of
#: dense.pack_alignments (code 0=M, 1=X, 2=I, 3=D; little-endian in the byte)
_OPS_UNPACK_LUT = np.empty((256, 4), np.uint8)
for _b in range(256):
    for _j in range(4):
        _OPS_UNPACK_LUT[_b, _j] = b"MXID"[(_b >> (2 * _j)) & 3]


class _AsyncResult:
    """Handle for an in-flight align call: the initial rounds are
    already launched; .finish() waits for their results, runs any
    escalation rounds, and returns the results. Call finish() once."""

    __slots__ = ("_fn",)

    def __init__(self, fn):
        self._fn = fn

    def finish(self):
        return self._fn()


class _ReadyResult:
    """Degenerate handle for results that are already complete."""

    __slots__ = ("_res",)

    def __init__(self, res):
        self._res = res

    def finish(self):
        return self._res


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 1).bit_length() if n > 2 else max(n, 1)


class DenseBandAligner:
    #: accepted band widths: a {1, 1.5} x pow2 ladder from 128 plus the
    #: 192 and 320 rungs (the kernel takes any K; a finer ladder cuts
    #: the band overshoot of hint-sized rounds)
    K_LADDER = sorted(
        {128 << i for i in range(8)} | {384 << i for i in range(6)} | {192, 320}
    )

    def __init__(
        self,
        pen: Penalties,
        config: Optional[DenseConfig] = None,
        device=None,
    ):
        self.pen = pen
        self.config = config or DenseConfig()
        self.device = resolve_device(device)
        #: (id(pool_seqs), l_pad) -> (pool_seqs, device pool); the
        #: pipeline hands the same pool list to every chunk and length
        #: bucket, so it is uploaded once per run. The strong list ref
        #: keeps the id() from being recycled.
        self._pool_cache: Dict[Tuple[int, int], Tuple[object, torch.Tensor]] = {}
        #: (k, run_cap, l_pad) -> parallel.mesh.sharded_dense_step
        self._sharded_steps: Dict[Tuple[int, int, int], object] = {}

    def _use_mesh(self) -> bool:
        """Fan each dispatch over every local GPU (reference:
        allwave_tpu/wfa/dense_engine.py _use_mesh): more than one local
        device, unless ALLWAVE_SINGLE_DEVICE=1."""
        if os.environ.get("ALLWAVE_SINGLE_DEVICE") == "1":
            return False
        from ..parallel.mesh import local_devices

        return len(local_devices(self.device)) > 1

    def _sharded_fn(self, k: int, run_cap: int, l_pad: int):
        key = (k, run_cap, l_pad)
        fn = self._sharded_steps.get(key)
        if fn is None:
            from ..parallel.mesh import local_devices, sharded_dense_step

            fn = sharded_dense_step(
                local_devices(self.device), self.pen, k, l_pad, run_cap
            )
            self._sharded_steps[key] = fn
        return fn

    def _round_k(self, k: int) -> int:
        """Smallest accepted band width >= k."""
        for v in self.K_LADDER:
            if v >= k:
                return v
        return self.K_LADDER[-1]

    def _k_for_score(self, sigma: int, kend_abs: int) -> int:
        """Smallest accepted band width whose exit-and-return
        certificate holds for a banded score sigma: the bound is
        2*g(W+1) with g(n) = min(o1+n*e1, o2+n*e2), so we need the
        minimal n with g(n) >= sigma//2 + 1 on BOTH pieces."""
        t = sigma // 2 + 1
        n = max(1, -(-(t - self.pen.o1) // self.pen.e1))
        if self.pen.two_piece:
            n = max(n, -(-(t - self.pen.o2) // self.pen.e2))
        w = n - 1
        k = kend_abs + 2 * max(w, 0) + 3
        return min(
            self._round_k(max(k, self.config.k_initial)), self.config.k_max
        )

    def _round_ks(self, k: np.ndarray) -> np.ndarray:
        """Vectorized _round_k over an int64 array."""
        ladder = np.asarray(self.K_LADDER, dtype=np.int64)
        idx = np.searchsorted(ladder, k).clip(0, ladder.size - 1)
        return ladder[idx]

    def _k_for_scores(self, sigma: np.ndarray, kend_abs: np.ndarray) -> np.ndarray:
        """Vectorized _k_for_score (same formula element-for-element)."""
        t = sigma // 2 + 1
        n1 = np.maximum(1, -(-(t - self.pen.o1) // self.pen.e1))
        if self.pen.two_piece:
            n1 = np.maximum(n1, -(-(t - self.pen.o2) // self.pen.e2))
        w = n1 - 1
        k = kend_abs + 2 * np.maximum(w, 0) + 3
        return np.minimum(
            self._round_ks(np.maximum(k, self.config.k_initial)),
            self.config.k_max,
        )

    def _device_pool(self, pool_seqs, l_pad: int) -> torch.Tensor:
        """ONE device-resident (n_seqs, l_pad) uint8 sequence pool per
        (pool list, l_pad); batches gather their rows from it by index,
        so all-pairs workloads upload each sequence once."""
        key = (id(pool_seqs), l_pad)
        hit = self._pool_cache.get(key)
        if hit is not None and hit[0] is pool_seqs:
            return hit[1]
        with counters.span("engine.plan"):
            pool = np.zeros((max(len(pool_seqs), 1), l_pad), dtype=np.uint8)
            for r, sq in enumerate(pool_seqs):
                if len(sq) <= l_pad:
                    pool[r, : len(sq)] = np.frombuffer(sq, dtype=np.uint8)
            pool_dev = torch.from_numpy(pool).to(self.device)
        if len(self._pool_cache) > 4:
            self._pool_cache.clear()
        self._pool_cache[key] = (pool_seqs, pool_dev)
        return pool_dev

    def align_pairs(
        self,
        pairs: List[Tuple[bytes, bytes]],
        with_stats: bool = False,
        sigma_hint=None,
        as_runs: bool = False,
    ):
        """[(score, cigar)] in input order (None = failed). With
        with_stats=True also returns an (n, 4) int64 array of
        [num_matches, alignment_length, query_len, target_len] (zeros
        for failed rows).

        as_runs=True: each cigar comes back as (ops, lens) run pairs in
        start->end order instead of a per-base byte array.

        sigma_hint: optional per-pair estimated alignment scores (e.g.
        from mash distances) — each pair starts at the band width its
        estimate certifies. Wrong hints only cost an escalation round;
        results stay exact."""
        pool_seqs, qidx, tidx = _pool_pairs(pairs)
        return self.align_pairs_indexed(
            pool_seqs, qidx, tidx, with_stats, sigma_hint, as_runs
        )

    def align_pairs_indexed(
        self,
        pool_seqs,
        qidx: np.ndarray,
        tidx: np.ndarray,
        with_stats: bool = False,
        sigma_hint=None,
        as_runs: bool = False,
    ):
        """align_pairs with the pair list in pooled-index form:
        pool_seqs is a list of byte strings and qidx/tidx are per-pair
        row indices into it."""
        return self.align_pairs_indexed_async(
            pool_seqs, qidx, tidx, with_stats, sigma_hint, as_runs
        ).finish()

    def align_pairs_indexed_async(
        self,
        pool_seqs,
        qidx: np.ndarray,
        tidx: np.ndarray,
        with_stats: bool = False,
        sigma_hint=None,
        as_runs: bool = False,
    ):
        """Non-blocking align_pairs_indexed: the initial rounds are
        LAUNCHED before this returns (the device computes while the
        caller orients or emits other chunks); the handle's .finish()
        waits for their results, runs any escalation rounds and returns
        the same results as the blocking call."""
        n = len(qidx)
        results: List[Optional[Tuple[int, np.ndarray]]] = [None] * n
        stats = np.zeros((n, 4), dtype=np.int64)
        if n == 0:
            return _ReadyResult((results, stats) if with_stats else results)

        with counters.span("engine.plan"):
            pool_lens = np.fromiter(
                (len(b) for b in pool_seqs), dtype=np.int64, count=len(pool_seqs)
            )
            qlens_all = pool_lens[qidx]
            tlens_all = pool_lens[tidx]
            lens = (qlens_all, tlens_all)
            sum_lens = qlens_all + tlens_all
            kend_abs_all = np.abs(tlens_all - qlens_all)
            max_len = int(max(qlens_all.max(), tlens_all.max()))
            l_pad = _next_pow2(max(max_len, 4))

            k0 = max(
                self._round_k(self.config.k_initial),
                self._round_k(int(kend_abs_all.max()) + 2),
            )
            # a band of k_full diagonals covers the whole matrix — widening
            # past it is pointless (the full-cover certificate always fires)
            k_full = self._round_k(max(int(sum_lens.max()) + 1, 2))
            k0 = min(k0, k_full)
            # run buffers scale with length: a pure-match CIGAR already
            # needs L/255 runs, and event counts grow with L
            cap0 = min(
                max(self.config.run_cap_initial, l_pad // 8), 2 * l_pad + 8
            )
            # rounds keyed by (band, run_cap): trace-first at (k0, cap0);
            # certificate failures jump straight to the band their banded
            # score certifies; run-buffer overflows rerun at the full cap
            if sigma_hint is None:
                rounds: Dict[Tuple[int, int], List[int]] = {
                    (k0, cap0): list(range(n))
                }
            else:
                # The mash-derived hint is an upper-ish estimate (sketch
                # noise + fixed margin, see pipeline._orient_chunk); shave
                # 12.5% for rung selection — pairs whose true score exceeds
                # the narrower band's certificate escalate and stay exact.
                sig = np.asarray(sigma_hint, dtype=np.int64)
                ks = self._k_for_scores(sig - (sig >> 3), kend_abs_all)
                ks = np.maximum(ks, self._round_k(self.config.k_initial))
                ks = np.maximum(ks, self._round_ks(kend_abs_all + 2))
                ks = np.minimum(ks, self._round_ks(sum_lens + 1))
                rounds = {}
                order = np.argsort(ks, kind="stable")
                uniq_ks = np.unique(ks)
                bounds = np.searchsorted(ks[order], uniq_ks)
                for b, kv in enumerate(uniq_ks):
                    hi = bounds[b + 1] if b + 1 < len(bounds) else n
                    rounds[(int(kv), cap0)] = order[bounds[b] : hi].tolist()
            pool = (
                self._device_pool(pool_seqs, l_pad),
                np.asarray(qidx, dtype=np.int64),
                np.asarray(tidx, dtype=np.int64),
                qlens_all.astype(np.int32),
                tlens_all.astype(np.int32),
            )

            # coalesce small hint-rounds into the next wider band (wider
            # bands are always exact; certificates only get easier). A
            # small TOP round merges DOWN into the widest sibling below it:
            # its pairs were sized from extreme hint noise, and any that
            # need the wider band fail the narrower certificate and escalate.
            if len(rounds) > 1:
                for key in sorted(rounds):
                    if key not in rounds or len(rounds) == 1:
                        continue
                    if len(rounds[key]) >= 512:
                        continue
                    siblings = [kk for kk in rounds if kk[1] == key[1] and kk != key]
                    larger = [kk for kk in siblings if kk[0] > key[0]]
                    if larger:
                        rounds[min(larger)].extend(rounds.pop(key))
                    elif siblings:
                        rounds[max(siblings)].extend(rounds.pop(key))

        # launch ALL known rounds first, then drain: the device works
        # through every launched group while the host collects the
        # first. inflight item = (group, device buffer, k, cap).
        inflight: List[tuple] = []

        def drain_all():
            from concurrent.futures import ThreadPoolExecutor

            items = list(inflight)
            inflight.clear()
            # a 1-worker thread copies the next buffer to the host while
            # the main thread unpacks the current one; starting and
            # joining it count as waiting on the copies
            with counters.span("engine.wait"):
                ex = ThreadPoolExecutor(1)
                futs = [ex.submit(_to_numpy, it[1]) for it in items]
            try:
                for (group, _, kk, cc), fut in zip(items, futs):
                    with counters.span("engine.wait"):
                        flat = fut.result()
                    with counters.span("engine.unpack"):
                        escalate = self._collect_group(
                            group, flat, results, stats, kk, cc, l_pad, lens, as_runs
                        )
                        for i, key in escalate:
                            rounds.setdefault(key, []).append(i)
                        counters.add(
                            cells=len(group) * 2 * l_pad * kk, syncs=1, reruns=len(escalate)
                        )
            finally:
                with counters.span("engine.wait"):
                    ex.shutdown(wait=True)

        def dispatch_pending():
            """Pop every pending round and launch its groups; returns
            with `rounds` empty and the device busy."""
            while rounds:
                with counters.span("engine.plan"):
                    k, cap = min(rounds)
                    idxs = rounds.pop((k, cap))
                    if k > self.config.k_max:
                        continue  # left as None: the failed-pair contract
                    # plane budget: (2L, B, K) uint16 per batch
                    per_pair = 2 * (2 * max(l_pad, 128) * k)
                    bsz = int(
                        max(
                            1,
                            min(
                                self.config.choices_budget_bytes // per_pair,
                                self.config.max_batch,
                            ),
                        )
                    )
                    bsz = 1 << (bsz.bit_length() - 1)
                    ia = np.asarray(idxs, dtype=np.int64)
                    ia = ia[np.argsort(sum_lens[ia], kind="stable")]
                with counters.span("engine.launch"):
                    for lo in range(0, ia.size, bsz):
                        group = ia[lo : lo + bsz]
                        inflight.append(
                            (group.tolist(), self._launch_group(group, k, cap, l_pad, pool), k, cap)
                        )

        def finish():
            while rounds or inflight:
                drain_all()
                dispatch_pending()
            return (results, stats) if with_stats else results

        dispatch_pending()
        return _AsyncResult(finish)

    def _launch_group(self, group: np.ndarray, k, run_cap, l_pad, pool):
        """Launch one fused forward + traceback on the device; returns
        the (B, 32 + ceil(cap/4) + cap) uint8 result buffer, not yet
        copied to the host."""
        pool_dev, qidx, tidx, qlens, tlens = pool
        dev = self.device
        args = (
            pool_dev,
            torch.from_numpy(qidx[group]).to(dev),
            torch.from_numpy(tidx[group]).to(dev),
            torch.from_numpy(qlens[group]).to(dev),
            torch.from_numpy(tlens[group]).to(dev),
        )
        if self._use_mesh():
            # fan the pair shard over every local GPU (pool replicated,
            # indices sharded; no traffic between GPUs in the hot loop)
            return self._sharded_fn(k, run_cap, l_pad)(*args)
        return D_.dense_align_packed(*args, self.pen, k, l_pad, run_cap)

    def _collect_group(
        self, group, packed, results, stats, k, run_cap, l_pad,
        pair_lens, as_runs,
    ) -> List[Tuple[int, Tuple[int, int]]]:
        """Host-side unpack of one group's packed result rows; fills
        certified results and returns [(pair_idx, (next_k, next_cap))]
        for the pairs that escalate."""
        meta = packed[:, :32].copy().view(np.int32).reshape(-1, 8)
        scores, nruns, cert, overflow = (meta[:, c] for c in range(4))
        cap4 = (run_cap + 3) // 4
        B_rows = packed.shape[0]
        ops = _OPS_UNPACK_LUT[packed[:, 32 : 32 + cap4]].reshape(
            B_rows, 4 * cap4
        )[:, :run_cap]
        lens = packed[:, 32 + cap4 :]
        good = (cert == 1) & (overflow == 0)
        full_cap = 2 * l_pad + 8

        if not as_runs:
            cigars = expand_runs_batch(ops, lens, nruns)
        good_rows = np.flatnonzero(good)
        stats_block = meta[good_rows, 4:8].astype(np.int64)
        escalate: List[Tuple[int, Tuple[int, int]]] = []
        scores_l = scores.tolist()
        nruns_l = nruns.tolist()
        for row, j in enumerate(good_rows.tolist()):
            i = group[j]
            if as_runs:
                nr = nruns_l[j]
                if nr > 0:
                    runs = (ops[j, nr - 1 :: -1], lens[j, nr - 1 :: -1])
                else:
                    runs = (np.zeros(0, np.uint8), np.zeros(0, np.uint8))
                results[i] = (scores_l[j], runs)
            else:
                results[i] = (scores_l[j], cigars[j])
            stats[i] = stats_block[row]
        for j in np.flatnonzero(~good).tolist():
            i = group[j]
            if cert[j] == 1:  # certified score, run buffer too small
                if run_cap < full_cap:
                    escalate.append((i, (k, full_cap)))
                # else: already at the full cap — re-queueing would
                # loop; left as None (failed-pair contract)
            else:
                kend_abs = abs(int(pair_lens[1][i] - pair_lens[0][i]))
                # strict widening = the next ladder rung; at the top
                # rung the pair fails for good
                nup = self._round_k(k + 1)
                if nup <= k:
                    continue
                if scores[j] < D_.INF:
                    nk = max(self._k_for_score(int(scores[j]), kend_abs), nup)
                else:
                    # no banded score to size from: jump ~2x, on-ladder
                    nk = max(self._round_k(2 * k), nup)
                k_full = self._round_k(
                    int(pair_lens[0][i] + pair_lens[1][i]) + 1
                )
                nk = min(nk, max(k_full, nup))
                escalate.append((i, (nk, run_cap)))
        return escalate


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _pool_pairs(pairs):
    """(pool_seqs, qidx, tidx) for a list of (query, target) byte pairs:
    each distinct sequence appears once in the pool."""
    n = len(pairs)
    pool_map: Dict[bytes, int] = {}
    for q, t in pairs:
        for sq in (q, t):
            if sq not in pool_map:
                pool_map[sq] = len(pool_map)
    qidx = np.fromiter((pool_map[q] for q, _ in pairs), dtype=np.int64, count=n)
    tidx = np.fromiter((pool_map[t] for _, t in pairs), dtype=np.int64, count=n)
    return list(pool_map), qidx, tidx


class UnifiedAligner:
    """Length-routed dispatcher. Pairs of at most `dense_max_len`
    bases go to the one-shot dense banded engine, bucketed by padded
    length. Longer pairs take the reference's accelerator route
    (`_align_long`): on a CUDA device hinted pairs go to the wavefront
    checkpoint-replay engine, which hands back per pair (DENSE_FALLBACK)
    what its band or score ceilings cannot take; those, the hintless
    pairs and every long pair on the CPU go to the segmented dense engine
    with their hints. All three engines share the dense engine's device
    and sequence pool. The batched wavefront engine stays available as
    `wavefront` for score-only discovery workloads and as a cross-check
    (wfa/engine.py); building it allocates nothing."""

    def __init__(
        self,
        pen: Penalties,
        dense_max_len: int = 16384,
        dense_config: Optional[DenseConfig] = None,
        wavefront_config: Optional[EngineConfig] = None,
        segmented_config=None,
        *,
        device=None,
    ):
        from .segmented import SegmentedDenseAligner
        from .wf_segmented import WavefrontSegmentedAligner

        self.pen = pen
        self.dense_max_len = dense_max_len
        self.dense = DenseBandAligner(pen, dense_config, device)
        self.device = self.dense.device
        self.segmented = SegmentedDenseAligner(pen, segmented_config, dense=self.dense)
        self.wf_segmented = WavefrontSegmentedAligner(pen, dense=self.dense)
        self.wavefront = BatchWavefrontAligner(pen, wavefront_config, device=self.device)

    def align_pairs(
        self,
        pairs: List[Tuple[bytes, bytes]],
        with_stats: bool = False,
        sigma_hint=None,
        as_runs: bool = False,
    ):
        pool_seqs, qidx, tidx = _pool_pairs(pairs)
        return self.align_pairs_indexed(
            pool_seqs, qidx, tidx, with_stats, sigma_hint, as_runs
        )

    def align_pairs_indexed(
        self,
        pool_seqs,
        qidx: np.ndarray,
        tidx: np.ndarray,
        with_stats: bool = False,
        sigma_hint=None,
        as_runs: bool = False,
    ):
        """align_pairs in pooled-index form (see
        DenseBandAligner.align_pairs_indexed)."""
        return self.align_pairs_indexed_async(
            pool_seqs, qidx, tidx, with_stats, sigma_hint, as_runs
        ).finish()

    def align_pairs_indexed_async(
        self,
        pool_seqs,
        qidx: np.ndarray,
        tidx: np.ndarray,
        with_stats: bool = False,
        sigma_hint=None,
        as_runs: bool = False,
    ):
        """Non-blocking align_pairs_indexed: every length bucket is
        LAUNCHED before this returns; the handle's .finish() collects
        them and returns the same results as the blocking call."""
        n = len(qidx)
        results: List[Optional[Tuple[int, np.ndarray]]] = [None] * n
        stats = np.zeros((n, 4), dtype=np.int64)
        if n == 0:
            return _ReadyResult((results, stats) if with_stats else results)
        with counters.span("engine.plan"):
            pool_lens = np.fromiter(
                (len(b) for b in pool_seqs), dtype=np.int64, count=len(pool_seqs)
            )
            max_lens = np.maximum(pool_lens[qidx], pool_lens[tidx])
            sigma_arr = (
                np.asarray(sigma_hint, dtype=np.int64)
                if sigma_hint is not None
                else None
            )
            short_mask = max_lens <= self.dense_max_len
            long_idx = np.flatnonzero(~short_mask).tolist()
            short_idx = np.flatnonzero(short_mask)
            # group by padded length (pow2 buckets) to keep sweeps tight
            ml = np.maximum(max_lens[short_idx], 4)
            pads = 1 << np.frexp((ml - 1).astype(np.float64))[1]
            by_pad: Dict[int, List[int]] = {}
            for pad in np.unique(pads).tolist():
                by_pad[int(pad)] = short_idx[pads == pad].tolist()
            # coalesce tiny length-buckets into the next larger one: a
            # <256-pair bucket costs a full launch chain but only ~2x the
            # per-pair sweep when merged upward (the dense engine re-derives
            # l_pad from its own batch)
            if len(by_pad) > 1:
                for pad in sorted(by_pad):
                    if len(by_pad) == 1 or len(by_pad[pad]) >= 256:
                        continue
                    larger = [p for p in by_pad if p > pad]
                    if larger:
                        by_pad[min(larger)].extend(by_pad.pop(pad))
        handles: List[Tuple[np.ndarray, object]] = []
        for pad, idxs in sorted(by_pad.items()):
            ia = np.asarray(idxs, dtype=np.int64)
            hint = sigma_arr[ia] if sigma_arr is not None else None
            handles.append(
                (
                    ia,
                    self.dense.align_pairs_indexed_async(
                        pool_seqs,
                        qidx[ia],
                        tidx[ia],
                        with_stats=True,
                        sigma_hint=hint,
                        as_runs=as_runs,
                    ),
                )
            )

        def finish():
            for ia, h in handles:
                out, st = h.finish()
                with counters.span("engine.unpack"):
                    for i, r in zip(ia.tolist(), out):
                        results[i] = r
                    stats[ia] = st
            if long_idx:
                self._align_long(pool_seqs, qidx, tidx, long_idx, sigma_arr, results, stats,
                                 as_runs)
            return (results, stats) if with_stats else results

        return _AsyncResult(finish)

    def _align_long(self, pool_seqs, qidx, tidx, long_idx, sigma_arr, results, stats,
                    as_runs):
        """Long-pair leg (reference: UnifiedAligner._align_long). On a
        CUDA device hinted pairs go to the wavefront engine first, as the
        reference sends them to its Pallas engine on the TPU; on the CPU
        they stay on the segmented dense engine, as the reference keeps
        them off a non-TPU backend. Hintless pairs stay there too (the
        wavefront engine would probe its band and score cap by
        escalation). ALLWAVE_WFSEG=0 or 1 forces the route. Pairs the
        wavefront engine hands back go to the segmented engine with
        their hints. Both engines hand back their walks' runs, and the
        stats are taken from them; with as_runs=False each is then
        expanded to its per-base cigar array. Fills results and stats
        in place."""
        from .batch import expand_runs, runs_stats
        from .wf_segmented import WavefrontSegmentedAligner as _W

        with counters.span("engine.plan"):
            ia = np.asarray(long_idx, dtype=np.int64)
            qi = np.asarray(qidx)[ia]
            ti = np.asarray(tidx)[ia]
            hint = sigma_arr[ia].tolist() if sigma_arr is not None else None
            wfseg = os.environ.get("ALLWAVE_WFSEG")
            if wfseg is None:
                use_wf = self.device.type == "cuda" and hint is not None
            else:
                use_wf = wfseg == "1"
        if use_wf:
            out = self.wf_segmented.align_pairs_indexed(
                pool_seqs, qi, ti, sigma_hint=hint, as_runs=True
            )
            fb = [j for j, r in enumerate(out) if r is None or r is _W.DENSE_FALLBACK]
            if fb:
                dense_out = self.segmented.align_pairs_indexed(
                    pool_seqs, qi[fb], ti[fb],
                    sigma_hint=[hint[j] for j in fb] if hint is not None else None,
                    as_runs=True,
                )
                for j, r in zip(fb, dense_out):
                    out[j] = r
        else:
            out = self.segmented.align_pairs_indexed(
                pool_seqs, qi, ti, sigma_hint=hint, as_runs=True
            )
        with counters.span("engine.unpack"):
            st = runs_stats([r[1] if r is not None else None for r in out])
            for row, (i, r) in enumerate(zip(long_idx, out)):
                if r is not None and not as_runs:
                    r = (r[0], expand_runs(*r[1]))
                results[i] = r
                stats[i] = st[row]
