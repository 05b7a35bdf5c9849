"""End-to-end streaming pipeline.

sequences -> pair selection (sparsify) -> orientation (mash | WFA) ->
batched device alignment -> AlignmentResult callbacks -> PAF.

This is the PyTorch port of allwave_tpu/engine/pipeline.py, the batched
replacement for the reference's per-pair rayon fan-out
(iterator.rs:208-252): the unit of work is a batch of pairs aligned by
one forward and one traceback kernel launch. Results stream to the
callback chunk by chunk, preserving the reference's streaming contract
(records appear as they complete; order is unspecified, as at t>1 in
the reference).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence as PySequence

import os

import numpy as np

from ..core.cigar import count_cigar_operations, parse_cigar_lengths
from ..core.types import (
    AlignmentParams,
    AlignmentResult,
    Sequence,
    SparsificationStrategy,
)
from ..orient.orientation import OrientationIndex
from ..sparsify.pairs import build_pairs
from ..device import resolve_device
from ..utils.telemetry import counters
from ..wfa.batch import expand_runs
from ..wfa.dense_engine import DenseConfig, UnifiedAligner
from ..wfa.engine import EngineConfig
from ..wfa.params import resolve_penalties

#: pairs per streaming chunk. One chunk = one launch group at the
#: engine's max batch, so the chunk-level pipeline (orient/launch
#: chunk i+1 while chunk i copies back/unpacks/emits) overlaps host and
#: device work. ALLWAVE_CHUNK overrides.
DEFAULT_CHUNK = int(os.environ.get("ALLWAVE_CHUNK", "4096"))


def _result_from_cigar(
    i: int,
    j: int,
    is_rev: bool,
    score: int,
    cigar,
    stats=None,
) -> AlignmentResult:
    """cigar: per-base uint8 array OR an (ops, lens) runs tuple — runs
    pass through to the result unexpanded (the PAF serializer consumes
    runs directly)."""
    is_runs = isinstance(cigar, tuple)
    if stats is not None:
        num_matches, alignment_length, query_end, target_end = stats
    else:
        arr = cigar if not is_runs else None
        if arr is None:
            arr = expand_runs(*cigar)
            cigar = arr
            is_runs = False
        num_matches, alignment_length = count_cigar_operations(arr)
        query_end, target_end = parse_cigar_lengths(arr)
    return AlignmentResult(
        query_idx=i,
        target_idx=j,
        query_start=0,
        query_end=query_end,
        target_start=0,
        target_end=target_end,
        is_reverse=is_rev,
        cigar_bytes=None if is_runs else cigar,
        score=score,
        num_matches=num_matches,
        alignment_length=alignment_length,
        cigar_runs=cigar if is_runs else None,
    )


class AllPairAligner:
    """Batched equivalent of the reference's AllPairIterator
    (iterator.rs:12-149)."""

    def __init__(
        self,
        sequences: PySequence[Sequence],
        params: AlignmentParams,
        exclude_self: bool = True,
        use_mash_orientation: bool = False,
        sparsification: SparsificationStrategy = None,
        orientation_params: Optional[AlignmentParams] = None,
        engine_config: Optional[EngineConfig] = None,
        chunk_size: int = DEFAULT_CHUNK,
        threads: int = 1,
        *,
        dense_config: Optional[DenseConfig] = None,
        device=None,
    ):
        from ..core.types import NoSparsification

        self.sequences = sequences
        self.params = params
        self.use_mash_orientation = use_mash_orientation
        self.sparsification = (
            sparsification if sparsification is not None else NoSparsification()
        )
        self.orientation_params = (
            orientation_params
            if orientation_params is not None
            else AlignmentParams.edit_distance()
        )
        self.chunk_size = chunk_size
        self.engine_config = engine_config
        self.dense_config = dense_config
        self.device = resolve_device(device)
        self.pairs = build_pairs(sequences, self.sparsification, exclude_self)
        self._orient = OrientationIndex(
            sequences, threads=max(int(threads), 1), device=self.device
        )
        self._orient_eng: Optional["UnifiedAligner"] = None

    @classmethod
    def with_options(
        cls,
        sequences,
        params,
        exclude_self: bool = True,
        use_mash_orientation: bool = False,
        sparsification=None,
        **kw,
    ) -> "AllPairAligner":
        """Constructor parity with the reference
        (iterator.rs:30-92)."""
        return cls(
            sequences,
            params,
            exclude_self=exclude_self,
            use_mash_orientation=use_mash_orientation,
            sparsification=sparsification,
            **kw,
        )

    def with_orientation_params(self, params: AlignmentParams) -> "AllPairAligner":
        """Reference: iterator.rs:95-98."""
        self.orientation_params = params
        return self

    def pair_count(self) -> int:
        return int(self.pairs.shape[0])

    def skip_done_pairs(self, done) -> int:
        """Drop pairs whose (query_id, target_id) is in `done` — the
        resume mechanism for interrupted multi-hour runs (the streaming
        PAF output is the reference's only crash tolerance, SURVEY §5;
        here a partial output file doubles as the done-pair record).
        Returns the number of pairs skipped."""
        if not done:
            return 0
        id_to_idx = {s.id: k for k, s in enumerate(self.sequences)}
        n = len(self.sequences)
        done_keys = np.array(
            [
                id_to_idx[q] * n + id_to_idx[t]
                for q, t in done
                if q in id_to_idx and t in id_to_idx
            ],
            dtype=np.int64,
        )
        keys = self.pairs[:, 0].astype(np.int64) * n + self.pairs[:, 1]
        keep = ~np.isin(keys, done_keys)
        skipped = int((~keep).sum())
        self.pairs = self.pairs[keep]
        return skipped

    def get_pairs(self) -> np.ndarray:
        return self.pairs

    # -- orientation -------------------------------------------------------

    def _orient_chunk(self, chunk: np.ndarray):
        """Pooled-index form of the oriented chunk: (pool_seqs, qidx,
        tidx, is_reverse bool array, sigma_hint). The pool is the run's
        sequences plus reverse-complement rows for the queries this
        chunk flips — the engine materializes only referenced rows, so
        nothing is hashed or copied per pair. sigma_hint is the per-pair
        estimated alignment score from the mash distances (None for the
        WFA-orientation mode), used as band-width hints."""
        n = len(self.sequences)
        if not hasattr(self, "_seq_lens"):
            self._seq_lens = np.fromiter(
                (len(s.seq) for s in self.sequences), np.int64, n
            )
        sigma_hint = None
        if self.use_mash_orientation:
            rev_arr = np.asarray(self._orient.orient_batch(chunk), dtype=bool)
            dists = self._orient.distance_batch(chunk)
            lens = np.maximum(
                self._seq_lens[chunk[:, 0]], self._seq_lens[chunk[:, 1]]
            ).astype(np.float64)
            # expected score ~ divergence * length * mismatch penalty
            # (+32 for sketch noise / small indels). A low estimate only
            # costs one escalation round; results stay exact either way.
            x = float(self.params.mismatch_penalty)
            sigma_hint = (dists * lens * x + 32).astype(np.int64)
        else:
            rev_arr = np.asarray(self._orient_wfa(chunk), dtype=bool)
        qi = chunk[:, 0].astype(np.int64)
        ti = chunk[:, 1].astype(np.int64)
        pool_seqs = [s.seq for s in self.sequences]
        rc_ids = np.unique(qi[rev_arr]) if rev_arr.any() else []
        rc_row = np.zeros(n, dtype=np.int64)
        for pos, i in enumerate(np.asarray(rc_ids).tolist()):
            rc_row[i] = len(pool_seqs)
            pool_seqs.append(self._orient.rc(int(i)))
        qidx = np.where(rev_arr, rc_row[qi], qi)
        return pool_seqs, qidx, ti, rev_arr, sigma_hint

    def _orient_wfa(self, chunk: np.ndarray) -> List[bool]:
        """WFA-edit-distance orientation (reference: alignment.rs:157-175):
        align both orientations globally with the orientation params and
        compare X+I+D op counts; ties go forward."""
        if self._orient_eng is None:
            pen = resolve_penalties(self.orientation_params)
            self._orient_eng = UnifiedAligner(
                pen, dense_config=self.dense_config,
                wavefront_config=self.engine_config, device=self.device,
            )
        eng = self._orient_eng
        fwd_pairs = []
        rev_pairs = []
        for i, j in chunk:
            fwd_pairs.append(
                (self.sequences[int(i)].seq, self.sequences[int(j)].seq)
            )
            rev_pairs.append((self._orient.rc(int(i)), self.sequences[int(j)].seq))
        fwd = eng.align_pairs(fwd_pairs)
        rev = eng.align_pairs(rev_pairs)
        out = []
        for f, r in zip(fwd, rev):
            fd = int(np.count_nonzero(f[1] != ord("M"))) if f is not None else 2**62
            rd = int(np.count_nonzero(r[1] != ord("M"))) if r is not None else 2**62
            out.append(not (fd <= rd))
        return out

    def _orient_all(self):
        """Orientation for the ENTIRE run in one shot (mash mode): one
        decision-matrix pass, ONE sequence pool shared by every chunk —
        the engine's device-pool cache then uploads it once per run
        instead of once per chunk. Falls back to per-chunk work for the
        WFA-orientation mode (its both-strand alignments would
        materialize every CIGAR at once)."""
        return self._orient_chunk(self.pairs)

    # -- main loop ----------------------------------------------------------

    def for_each_with_callback(
        self, callback: Callable[[AlignmentResult], None]
    ) -> None:
        counters.begin_run()
        pen = resolve_penalties(self.params)
        eng = UnifiedAligner(
            pen, dense_config=self.dense_config,
            wavefront_config=self.engine_config, device=self.device,
        )
        pairs = self.pairs
        run_wide = self.use_mash_orientation and pairs.shape[0] > 0
        if run_wide:
            pool_seqs_all, qidx_all, tidx_all, revs_all, sigma_all = (
                self._orient_all()
            )

        # the emit loop is pure host Python; running it on a worker
        # thread overlaps it with the NEXT chunk's launches and copy
        # waits (which release the GIL). At most one chunk's emit is in
        # flight; errors re-raise in the main thread.
        from concurrent.futures import ThreadPoolExecutor

        emit_fut = None

        def _emit(*args):
            """Wait for the previous chunk's emit, then hand this one
            (none: only wait) to the emit thread."""
            nonlocal emit_fut
            with counters.span("pipeline.emit_wait"):
                if emit_fut is not None:
                    f, emit_fut = emit_fut, None
                    f.result()
                if args:
                    emit_fut = ex.submit(self._emit_chunk, callback, *args)

        # chunk-level software pipeline: chunk i+1 is ORIENTED and
        # LAUNCHED (device busy) before chunk i's results are
        # collected, so the host-side orient/unpack/emit of one chunk
        # overlaps the device compute and copies of its neighbours. At
        # most one chunk is awaiting collection and one is being
        # emitted at any time — memory stays O(chunk).
        ex = ThreadPoolExecutor(1)
        pending = None  # (handle, chunk, revs, chunk index) awaiting .finish()
        try:
            for ci, lo in enumerate(range(0, pairs.shape[0], self.chunk_size)):
                counters.chunk = ci
                chunk = pairs[lo : lo + self.chunk_size]
                if run_wide:
                    sl = slice(lo, lo + chunk.shape[0])
                    pool_seqs, qidx, tidx, revs, sigma_hint = (
                        pool_seqs_all,
                        qidx_all[sl],
                        tidx_all[sl],
                        revs_all[sl],
                        sigma_all[sl] if sigma_all is not None else None,
                    )
                else:
                    pool_seqs, qidx, tidx, revs, sigma_hint = (
                        self._orient_chunk(chunk)
                    )
                handle = eng.align_pairs_indexed_async(
                    pool_seqs,
                    qidx,
                    tidx,
                    with_stats=True,
                    sigma_hint=sigma_hint,
                    as_runs=True,
                )
                if pending is not None:
                    p_handle, p_chunk, p_revs, p_ci = pending
                    counters.chunk = p_ci
                    aligned, stats = p_handle.finish()
                    _emit(p_chunk, p_revs, aligned, stats)
                pending = (handle, chunk, revs, ci)
            if pending is not None:
                p_handle, p_chunk, p_revs, p_ci = pending
                counters.chunk = p_ci
                aligned, stats = p_handle.finish()
                _emit(p_chunk, p_revs, aligned, stats)
            _emit()
        finally:
            with counters.span("pipeline.emit_wait"):
                ex.shutdown(wait=True)

    @staticmethod
    def _emit_chunk(callback, chunk, revs, aligned, stats) -> None:
        # one C-level conversion for the whole chunk instead of
        # 6 scalar int() calls per record; AlignmentResult is built
        # inline via __new__ + slot stores, skipping the
        # _result_from_cigar call overhead per record
        chunk_l = chunk.tolist()
        stats_l = stats.tolist()
        revs_l = revs.tolist()
        AR = AlignmentResult
        new = AR.__new__
        for (i, j), is_rev, res, st in zip(chunk_l, revs_l, aligned, stats_l):
            if res is None:
                result = AR.failed(i, j, is_rev)
            else:
                r = new(AR)
                r.query_idx = i
                r.target_idx = j
                r.query_start = 0
                r.target_start = 0
                r.is_reverse = is_rev
                r.score = res[0]
                cigar = res[1]
                (
                    r.num_matches,
                    r.alignment_length,
                    r.query_end,
                    r.target_end,
                ) = st
                if type(cigar) is tuple:
                    r._cigar_bytes = None
                    r._cigar_runs = cigar
                else:
                    r._cigar_bytes = cigar
                    r._cigar_runs = None
                result = r
            callback(result)

    def __iter__(self):
        """Sequential pull-based iteration (reference: iterator.rs:151-171).
        Still batched under the hood, chunk by chunk."""
        pen = resolve_penalties(self.params)
        eng = UnifiedAligner(
            pen, dense_config=self.dense_config,
            wavefront_config=self.engine_config, device=self.device,
        )
        pairs = self.pairs
        for lo in range(0, pairs.shape[0], self.chunk_size):
            chunk = pairs[lo : lo + self.chunk_size]
            pool_seqs, qidx, tidx, revs, sigma_hint = self._orient_chunk(chunk)
            aligned, stats = eng.align_pairs_indexed(
                pool_seqs,
                qidx,
                tidx,
                with_stats=True,
                sigma_hint=sigma_hint,
                as_runs=True,
            )
            for (i, j), is_rev, res, st in zip(
                chunk.tolist(), revs.tolist(), aligned, stats.tolist()
            ):
                if res is None:
                    yield AlignmentResult.failed(i, j, is_rev)
                else:
                    score, cigar = res
                    yield _result_from_cigar(i, j, is_rev, score, cigar, st)


def process_alignments_with_callback(
    sequences: PySequence[Sequence],
    params: AlignmentParams,
    sparsification: SparsificationStrategy,
    callback: Callable[[AlignmentResult], None],
) -> None:
    """Reference: lib.rs:57-68 — exclude_self=True, mash orientation."""
    aligner = AllPairAligner(
        sequences,
        params,
        exclude_self=True,
        use_mash_orientation=True,
        sparsification=sparsification,
    )
    aligner.for_each_with_callback(callback)
