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

import numpy as np

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
from ..wfa.dense_engine import DenseConfig, UnifiedAligner
from ..wfa.engine import EngineConfig
from ..wfa.params import resolve_penalties

#: pairs per streaming chunk. One chunk = one launch group at the
#: engine's max batch, so the chunk-level pipeline (orient/launch
#: chunk i+1 while chunk i copies back/unpacks/emits) overlaps host and
#: device work.
DEFAULT_CHUNK = 4096


def _results(chunk, revs, aligned, stats):
    """The chunk's AlignmentResults in pair order, from the engine's
    (score, runs) results and (n, 4) stats: failed pairs as
    `AlignmentResult.failed`, the rest built by __new__ and slot stores
    (no __init__ call a record, one C-level conversion a chunk), their
    runs passed through unexpanded (the PAF writer consumes runs)."""
    AR = AlignmentResult
    new = AR.__new__
    for (i, j), is_rev, res, st in zip(chunk.tolist(), revs.tolist(), aligned, stats.tolist()):
        if res is None:
            yield AR.failed(i, j, is_rev)
            continue
        r = new(AR)
        r.query_idx = i
        r.target_idx = j
        r.query_start = 0
        r.target_start = 0
        r.is_reverse = is_rev
        r.score = res[0]
        r.num_matches, r.alignment_length, r.query_end, r.target_end = st
        r._cigar_bytes = None
        r._cigar_runs = res[1]
        yield r


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

    def _engine(self, params: AlignmentParams) -> "UnifiedAligner":
        return UnifiedAligner(
            resolve_penalties(params), dense_config=self.dense_config,
            wavefront_config=self.engine_config, device=self.device,
        )

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
        compare X+I+D op counts, the summed lengths of the runs whose op
        is not M; ties go forward."""
        if self._orient_eng is None:
            self._orient_eng = self._engine(self.orientation_params)
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

        def edits(res):
            if res is None:
                return 2**62
            ops, lens = res[1]
            return int(np.asarray(lens, np.int64)[np.asarray(ops) != ord("M")].sum())

        return [not (edits(f) <= edits(r)) for f, r in zip(fwd, rev)]

    def _orient_all(self):
        """Orientation for the ENTIRE run in one shot, in mash mode only:
        one decision-matrix pass, ONE sequence pool shared by every
        chunk, which the engine's device pool then uploads once per run
        instead of once per chunk. The WFA-orientation mode orients a
        chunk at a time (`_oriented_chunks`)."""
        return self._orient_chunk(self.pairs)

    def _oriented_chunks(self, run_wide: bool):
        """(chunk index, chunk, is_reverse, (pool_seqs, qidx, tidx),
        sigma_hint) for each chunk of the pairs, in order: sliced from one
        run-wide orientation, or oriented a chunk at a time. Sets
        `counters.chunk` before each chunk's orientation."""
        pairs = self.pairs
        if run_wide:
            pool_all, qidx_all, tidx_all, revs_all, sigma_all = self._orient_all()
        for ci, lo in enumerate(range(0, pairs.shape[0], self.chunk_size)):
            counters.chunk = ci
            chunk = pairs[lo : lo + self.chunk_size]
            if run_wide:
                sl = slice(lo, lo + chunk.shape[0])
                yield (ci, chunk, revs_all[sl], (pool_all, qidx_all[sl], tidx_all[sl]),
                       sigma_all[sl] if sigma_all is not None else None)
            else:
                pool_seqs, qidx, tidx, revs, sigma_hint = self._orient_chunk(chunk)
                yield ci, chunk, revs, (pool_seqs, qidx, tidx), sigma_hint

    # -- main loop ----------------------------------------------------------

    def for_each_with_callback(
        self, callback: Callable[[AlignmentResult], None]
    ) -> None:
        counters.begin_run()
        eng = self._engine(self.params)
        run_wide = self.use_mash_orientation and self.pairs.shape[0] > 0

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
            for ci, chunk, revs, indexed, sigma_hint in self._oriented_chunks(run_wide):
                handle = eng.align_pairs_indexed_async(
                    *indexed, with_stats=True, sigma_hint=sigma_hint
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
        for result in _results(chunk, revs, aligned, stats):
            callback(result)

    def __iter__(self):
        """Sequential pull-based iteration (reference: iterator.rs:151-171).
        Still batched under the hood, chunk by chunk, each oriented and
        aligned when the one before it is used up."""
        eng = self._engine(self.params)
        for _, chunk, revs, indexed, sigma_hint in self._oriented_chunks(False):
            aligned, stats = eng.align_pairs_indexed(
                *indexed, with_stats=True, sigma_hint=sigma_hint
            )
            yield from _results(chunk, revs, aligned, stats)


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
