"""Strand-orientation detection.

Two methods, matching the reference:

* mash (default): strand-specific MinHash sketches of target, query, and
  revcomp(query); pick the orientation with the higher Jaccard; ties go
  forward (reference: alignment.rs:69-94, k=15, sketch_size=1000).
* WFA edit distance: align both orientations globally with the
  edit-distance params and count X/I/D ops; ties go forward
  (reference: alignment.rs:157-175).

The reference re-sketches the target for every pair; we precompute one
stranded sketch per sequence and one per revcomp'd sequence (identical
results, O(n) instead of O(pairs) sketching).

Each route of `orient_batch` and `distance_batch` first builds every
stranded set it reads in one `orient.sketch` span (counted in the
`sketches` counter; on a CUDA device in one launch of
csrc/minhash_sketch.cu, sketch/device_sketch.py, counted in
`sketches_card` too), then runs its decisions and distance hints in one
`orient.decide` span (utils.telemetry).
"""

from __future__ import annotations

from typing import Sequence as PySequence

import numpy as np
import torch

from ..core.types import Sequence
from ..device import resolve_device
from ..sketch.device_sketch import stranded_sets
from ..sketch.membership import (
    ORIENT_DEVICE_MIN_N,
    OverBudget,
    membership_counts,
    orient_routes,
)
from ..sketch.minhash import jaccard, sketch_stranded
from ..utils.telemetry import counters

ORIENTATION_KMER_SIZE = 15  # reference: alignment.rs:70
ORIENTATION_SKETCH_SIZE = 1000  # reference: alignment.rs:75

# Whole-sequence reverse complement (reference: alignment.rs:178-190):
# uppercase complement; N stays N; any other byte becomes 'N'.
_SEQ_COMP = np.full(256, ord("N"), dtype=np.uint8)
for _src, _dst in zip(b"AaTtCcGgNn", b"TTAAGGCCNN"):
    _SEQ_COMP[_src] = _dst


def reverse_complement(seq: bytes) -> bytes:
    """Reverse complement with non-ACGTN mapped to 'N'
    (reference: alignment.rs:178-190)."""
    arr = np.frombuffer(seq, dtype=np.uint8)
    return _SEQ_COMP[arr][::-1].tobytes()


class OrientationIndex:
    """Per-sequence cache of stranded sketches and reverse complements.

    ``orient(i, j)`` answers: should query i be reverse-complemented before
    aligning to target j? Deterministic and identical to the reference's
    per-pair computation.
    """

    def __init__(
        self,
        sequences: PySequence[Sequence],
        k: int = ORIENTATION_KMER_SIZE,
        sketch_size: int = ORIENTATION_SKETCH_SIZE,
        threads: int = 1,
        device=None,
    ):
        self.sequences = sequences
        self.device = resolve_device(device)
        self.k = k
        self.sketch_size = sketch_size
        self.threads = threads
        self._fwd: list = [None] * len(sequences)
        self._rev: list = [None] * len(sequences)
        self._fwd_sets: list = [None] * len(sequences)
        self._rev_sets: list = [None] * len(sequences)
        self._rc_seq: list = [None] * len(sequences)

    def rc(self, i: int) -> bytes:
        if self._rc_seq[i] is None:
            self._rc_seq[i] = reverse_complement(self.sequences[i].seq)
        return self._rc_seq[i]

    def _fwd_set(self, i: int) -> np.ndarray:
        if self._fwd_sets[i] is None:
            sk = sketch_stranded(self.sequences[i].seq, self.k, self.sketch_size)
            self._fwd_sets[i] = np.unique(sk)
        return self._fwd_sets[i]

    def _rev_set(self, i: int) -> np.ndarray:
        if self._rev_sets[i] is None:
            sk = sketch_stranded(self.rc(i), self.k, self.sketch_size)
            self._rev_sets[i] = np.unique(sk)
        return self._rev_sets[i]

    def _ensure_sets(self, idx) -> None:
        """Build any missing stranded sketch sets for these sequence
        indices, fanning the NumPy hashing/sorting across a host thread
        pool when threads > 1 (the CLI's -t; reference: the rayon pool,
        main.rs:130-133). Each worker writes distinct cache slots."""
        missing = [
            int(i)
            for i in dict.fromkeys(int(i) for i in idx)
            if self._fwd_sets[int(i)] is None or self._rev_sets[int(i)] is None
        ]
        if self.threads > 1 and len(missing) > 1:
            from concurrent.futures import ThreadPoolExecutor

            def build(i):
                self._fwd_set(i)
                self._rev_set(i)

            with ThreadPoolExecutor(min(self.threads, len(missing))) as ex:
                list(ex.map(build, missing))

    def _route(self, q_idx=None, t_idx=None):
        """The `orient.decide` span for a route over these query and
        target rows (every row where None), opened once every stranded
        set the route reads is built, in one `orient.sketch` span: the
        forward sets of all the rows and the reverse sets of the queries
        (of all the rows with threads > 1, as `_ensure_sets` builds
        them). On a CUDA device one kernel launch builds them all
        (`stranded_sets`, counted in `sketches_card`), so `_ensure_sets`
        then finds none missing; on the CPU the host builds them one at
        a time."""
        every = np.arange(len(self.sequences), dtype=np.int64)
        q = every if q_idx is None else np.unique(np.asarray(q_idx, dtype=np.int64))
        rows = every if t_idx is None else np.union1d(q, np.asarray(t_idx, dtype=np.int64))
        fwd = [i for i in rows.tolist() if self._fwd_sets[i] is None]
        rev = [i for i in (rows if self.threads > 1 else q).tolist() if self._rev_sets[i] is None]
        if fwd or rev:
            with counters.span("orient.sketch"):
                if self.device.type == "cuda":
                    sets = stranded_sets([s.seq for s in self.sequences], fwd + rev,
                                         [False] * len(fwd) + [True] * len(rev),
                                         self.k, self.sketch_size, self.device)
                    for i, s in zip(fwd, sets):
                        self._fwd_sets[i] = s
                    for i, s in zip(rev, sets[len(fwd):]):
                        self._rev_sets[i] = s
                    counters.add(sketches_card=len(fwd) + len(rev))
                else:
                    if self.threads > 1:
                        self._ensure_sets(rows)
                    for i in fwd:
                        self._fwd_set(i)
                    for i in rev:
                        self._rev_set(i)
            counters.add(sketches=len(fwd) + len(rev))
        return counters.span("orient.decide")

    def orient(self, query_idx: int, target_idx: int) -> bool:
        """True iff the query should be reverse-complemented
        (reference: alignment.rs:69-94; ties -> forward)."""
        t = self._fwd_set(target_idx)
        fwd_j = _jaccard_sets(self._fwd_set(query_idx), t)
        rev_j = _jaccard_sets(self._rev_set(query_idx), t)
        return not (fwd_j >= rev_j)

    def oriented_query(self, query_idx: int, target_idx: int):
        """(query_bytes, is_reverse) after orientation."""
        is_rev = self.orient(query_idx, target_idx)
        if is_rev:
            return self.rc(query_idx), True
        return self.sequences[query_idx].seq, False

    #: targets per bitmap block in _decision_matrix — bounds the
    #: value->target bitmap at ~(block*sketch) rows x block/8 bytes
    DECISION_BLOCK = 1024

    def _decision_matrix(self) -> np.ndarray:
        """(n, n) bool: [qi, tj] = should query qi be RC'd against
        target tj (the full-matrix case of _decision_submatrix)."""
        n = len(self.sequences)
        idx = np.arange(n, dtype=np.int64)
        orient_routes.took("numpy")
        decisions, dist = self._decision_submatrix(idx, idx)
        self._distances = dist
        return decisions

    def _decision_submatrix(self, q_idx: np.ndarray, t_idx: np.ndarray):
        """(dec, dist) over the requested query rows x target rows.
        Computed with a value->target bitmap per TARGET BLOCK: dense ids
        over the block's sketch hashes, packed membership bits, then
        each query's intersection counts against the whole block are a
        searchsorted + row-take + unpackbits column sum — no per-pair
        set ops, memory bounded for large n, and O(|Q|*|T|) work instead
        of O(n^2) when sparsification requests few pairs. Bit-identical
        decisions to orient(): same float64 Jaccard, same tie -> forward
        rule."""
        nq, nt = len(q_idx), len(t_idx)
        self._ensure_sets(np.concatenate([np.asarray(q_idx), np.asarray(t_idx)]))
        fsets = [self._fwd_set(int(i)) for i in q_idx]
        rsets = [self._rev_set(int(i)) for i in q_idx]
        tsets_all = [self._fwd_set(int(j)) for j in t_idx]
        sizes_f = np.array([s.size for s in fsets], dtype=np.int64)
        sizes_r = np.array([s.size for s in rsets], dtype=np.int64)
        sizes_t = np.array([s.size for s in tsets_all], dtype=np.int64)

        decisions = np.zeros((nq, nt), dtype=bool)
        best_j = np.zeros((nq, nt), dtype=np.float64)
        blk = self.DECISION_BLOCK
        for t_lo in range(0, nt, blk):
            t_hi = min(t_lo + blk, nt)
            nb = t_hi - t_lo
            tsets = tsets_all[t_lo:t_hi]
            t_sizes = sizes_t[t_lo:t_hi]
            cat = (
                np.concatenate(tsets)
                if nb and sum(x.size for x in tsets)
                else np.zeros(0, dtype=np.uint64)
            )
            uniq, inv = np.unique(cat, return_inverse=True)
            t_offs = np.zeros(nb + 1, dtype=np.int64)
            np.cumsum(t_sizes, out=t_offs[1:])
            nbytes = (nb + 7) // 8
            bitmap = np.zeros((uniq.size + 1, nbytes), dtype=np.uint8)
            for j in range(nb):
                rows = inv[t_offs[j] : t_offs[j + 1]]
                np.bitwise_or.at(
                    bitmap[:, j >> 3], rows, np.uint8(1 << (j & 7))
                )

            # intersection counts for ALL query sets vs this target block
            # in one vectorized pass (the per-query Python loop cost
            # ~230 ms at n=128 on a 1-core host): concatenate every
            # fwd+rev set, one searchsorted, one bitmap row-take, then a
            # reduceat over per-set segments. Queries are chunked so the
            # unpacked bit plane stays <~128 MB.
            q_all = fsets + rsets
            q_sizes = np.fromiter(
                (s.size for s in q_all), dtype=np.int64, count=2 * nq
            )
            counts2 = np.zeros((2 * nq, nb), dtype=np.int64)
            if uniq.size:
                # unpack the whole block bitmap once (row U = all-zero
                # sentinel), pad every set's uniq-row list to S with the
                # sentinel, then ONE (2nq, S, nb) fancy-index + sum.
                # Chunked over queries to bound the unpacked plane.
                bitsU = np.unpackbits(
                    bitmap, axis=1, count=nb, bitorder="little"
                )
                S = max(int(q_sizes.max()), 1)
                rows_pad = np.full((2 * nq, S), uniq.size, dtype=np.int64)
                for qi, qset in enumerate(q_all):
                    if qset.size == 0:
                        continue
                    pos = np.searchsorted(uniq, qset).clip(0, uniq.size - 1)
                    np.place(pos, uniq[pos] != qset, uniq.size)
                    rows_pad[qi, : qset.size] = pos
                qblk = max(1, (256 << 20) // max(S * nb, 1))
                for q_lo in range(0, 2 * nq, qblk):
                    q_hi = min(q_lo + qblk, 2 * nq)
                    # uint16 accumulator: counts <= S <= sketch_size
                    # (int64 accumulation measured 10x slower here)
                    counts2[q_lo:q_hi] = bitsU[rows_pad[q_lo:q_hi]].sum(
                        axis=1, dtype=np.uint16
                    )
            fi2 = counts2[:nq]
            ri2 = counts2[nq:]
            fu2 = sizes_f[:, None] + t_sizes[None, :] - fi2
            ru2 = sizes_r[:, None] + t_sizes[None, :] - ri2
            fwd_j = np.where(fu2 > 0, fi2 / np.maximum(fu2, 1), 0.0)
            rev_j = np.where(ru2 > 0, ri2 / np.maximum(ru2, 1), 0.0)
            decisions[:, t_lo:t_hi] = ~(fwd_j >= rev_j)
            best_j[:, t_lo:t_hi] = np.maximum(fwd_j, rev_j)
        # mash distance of the chosen orientation (reference formula,
        # mash.rs:59-74) — used downstream as a band-width hint
        with np.errstate(divide="ignore"):
            dist = np.where(
                best_j > 0,
                -np.log(np.maximum(2 * best_j / (1 + best_j), 1e-300))
                / self.k,
                1.0,
            )
        return decisions, np.minimum(dist, 1.0)

    #: ceiling for the device membership matrix (2n x U) int8 bytes;
    #: larger inputs fall back to the blocked-bitmap NumPy path
    DEVICE_MEMBERSHIP_MAX = 2 << 30

    def _decision_matrix_device(self, device) -> np.ndarray:
        """Device twin of _decision_matrix: sketch hashes remap to
        dense int32 codes (host), membership rows build on the device by
        scatter, and ALL intersection counts come from ONE int8 product
        (2n x U) @ (U x n) (sketch.membership). Decisions use exact
        integer cross-comparison fi*max(ru,1) >= ri*max(fu,1), which
        provably equals the NumPy path's float64 Jaccard compare: with
        counts <= sketch_size the candidate rationals are spaced >=
        1/(4*sketch_size^2), ~9 orders of magnitude wider than one f64
        ulp, so rounding can never flip the comparison. Distances (band
        hints only) are f32. Raises OverBudget, before anything is
        allocated on the device, when the membership matrix would
        exceed DEVICE_MEMBERSHIP_MAX."""
        n = len(self.sequences)
        self._ensure_sets(range(n))
        fsets = [self._fwd_set(i) for i in range(n)]
        rsets = [self._rev_set(i) for i in range(n)]
        sizes_f = np.array([s.size for s in fsets], dtype=np.int32)
        sizes_r = np.array([s.size for s in rsets], dtype=np.int32)

        cat = np.concatenate(fsets + rsets)
        # pre-check on a conservative U estimate (hash sets rarely
        # overlap by more than 8x) — skips the multi-second np.unique
        # over tens of millions of hashes when the exact check below
        # would raise anyway. A wrong guess only changes the path
        # taken, never a decision.
        if 2 * n * (cat.size // 8 + 1) > 4 * self.DEVICE_MEMBERSHIP_MAX:
            raise OverBudget("membership matrix over device budget")
        uniq, inv = np.unique(cat, return_inverse=True)
        U = int(uniq.size)
        if 2 * n * (U + 1) > self.DEVICE_MEMBERSHIP_MAX:
            raise OverBudget("membership matrix over device budget")
        S = max(int(max(sizes_f.max(), sizes_r.max())) if n else 1, 1)
        codes = np.full((2 * n, S), U, dtype=np.int32)  # U = sentinel col
        offs = np.concatenate(
            ([0], np.cumsum([s.size for s in fsets + rsets]))
        )
        for r in range(2 * n):
            codes[r, : offs[r + 1] - offs[r]] = inv[offs[r] : offs[r + 1]]
        orient_routes.took("device")
        dec, dist = _decide_device(codes, sizes_f, sizes_r, U, self.k, device)
        self._distances = dist.cpu().numpy().astype(np.float64)
        return dec.cpu().numpy()

    def _sub_lookup(self, idx: np.ndarray):
        """Positions of idx pairs inside the cached submatrix, or None
        if any pair falls outside it."""
        sub = getattr(self, "_sub", None)
        if sub is None:
            return None
        q_idx, t_idx, dec, dist = sub
        qp = np.searchsorted(q_idx, idx[:, 0]).clip(0, q_idx.size - 1)
        tp = np.searchsorted(t_idx, idx[:, 1]).clip(0, t_idx.size - 1)
        if np.all(q_idx[qp] == idx[:, 0]) and np.all(t_idx[tp] == idx[:, 1]):
            return dec[qp, tp], dist[qp, tp]
        return None

    def _pair_lookup(self, idx: np.ndarray):
        """(dec, dist) from the one-slot per-pair-request cache (filled
        by the native pair path), or None. orient_batch and
        distance_batch are called back-to-back with the same pair list
        by the pipeline, so one slot suffices."""
        pc = getattr(self, "_pair_req", None)
        if pc is not None and np.array_equal(pc[0], idx):
            return pc[1], pc[2]
        return None

    def _orient_pairs_native(self, idx: np.ndarray):
        """Per-pair decisions + distances via csrc/orient_pairs.cpp
        (sorted-set two-pointer intersections, ~10 us/pair): the escape
        hatch for sparse pair sets at large n, where the (n, n) matrix
        paths are O(n^2) and the device membership matmul is over
        budget. Decisions are bit-identical to orient() (integer
        cross-compare, see _decision_matrix_device's proof); distances
        are the same float64 mash formula. Returns (dec, dist) or None
        if the native library is unavailable."""
        from .. import native

        lib = native.get_lib()
        if lib is None or not hasattr(lib, "orient_pairs"):
            return None
        # CSR over the REFERENCED rows only (compacted via searchsorted
        # remap): a per-chunk request must not concatenate all n sets.
        # Reverse sets are built only for rows used as a query — a
        # target-only row's rev CSR slot is never read by the kernel.
        uniq = np.unique(idx)
        q_uniq = np.unique(idx[:, 0])
        if self.threads > 1:
            self._ensure_sets(uniq)  # thread fan-out (builds both strands)
        empty = np.zeros(0, dtype=np.uint64)
        qset = set(q_uniq.tolist())
        fl = [self._fwd_set(int(i)) for i in uniq.tolist()]
        rl = [
            self._rev_set(int(i)) if int(i) in qset else empty
            for i in uniq.tolist()
        ]
        nu = uniq.size
        foff = np.zeros(nu + 1, dtype=np.int64)
        np.cumsum([a.size for a in fl], out=foff[1:])
        roff = np.zeros(nu + 1, dtype=np.int64)
        np.cumsum([a.size for a in rl], out=roff[1:])
        fcat = np.concatenate(fl) if nu else empty
        rcat = np.concatenate(rl) if nu else empty
        res = native.orient_pairs_native(
            fcat,
            foff,
            rcat,
            roff,
            np.searchsorted(uniq, idx[:, 0]),
            np.searchsorted(uniq, idx[:, 1]),
            self.k,
        )
        if res is None:
            return None
        self._pair_req = (idx.copy(), res[0], res[1])
        orient_routes.took("native")
        return res

    def orient_batch(self, idx_pairs) -> np.ndarray:
        """Vectorized ``orient`` over a list of (query_idx, target_idx)
        pairs via the cached all-pairs decision matrix (MXU matmul path
        on accelerators, blocked-bitmap NumPy otherwise). Sparse pair
        sets (<< n^2, e.g. tree sparsification at large n) compute only
        the requested query-row x target-row submatrix instead of the
        full (n, n) planes; at large n where even that is over budget,
        the native per-pair set-intersection path serves the request
        directly."""
        idx = np.asarray(idx_pairs, dtype=np.int64).reshape(-1, 2)
        n = len(self.sequences)
        if getattr(self, "_decisions", None) is None:
            hit = self._sub_lookup(idx)
            if hit is not None:
                return hit[0]
            pc = self._pair_lookup(idx)
            if pc is not None:
                return pc[0]
            q_idx = np.unique(idx[:, 0])
            t_idx = np.unique(idx[:, 1])
            # sparse request: most submatrix cells would never be read.
            # The native per-pair path costs ~10 us/pair vs ~1.4 us per
            # submatrix CELL (blocked-bitmap path, measured at n=10k),
            # so it wins once fewer than ~1/8 of the cells are
            # requested — e.g. the streaming pipeline's per-chunk
            # orientation at large n (2 s -> ~30 ms per 2k-pair chunk)
            if idx.shape[0] * 8 < q_idx.size * t_idx.size:
                with self._route(q_idx, t_idx):
                    res = self._orient_pairs_native(idx)
                if res is not None:
                    return res[0]
            if q_idx.size * t_idx.size * 4 < n * n:
                orient_routes.took("submatrix")
                with self._route(q_idx, t_idx):
                    dec, dist = self._decision_submatrix(q_idx, t_idx)
                self._sub = (q_idx, t_idx, dec, dist)
                return self._sub_lookup(idx)[0]
            # the device path pays a fixed launch and transfer cost (and
            # once a process, its set-up); the NumPy path grows ~n^2. The
            # threshold is the measured crossover on the card
            # (sketch.membership).
            use_device = self.device.type == "cuda" and n >= ORIENT_DEVICE_MIN_N
            if use_device:
                try:
                    with self._route():
                        self._decisions = self._decision_matrix_device(self.device)
                except OverBudget:
                    # membership matrix over the device budget (U ~ 2e7
                    # hashes at n=10k). The request is usually sparse
                    # there — serve it per-pair natively before
                    # resorting to the O(n^2) NumPy matrix.
                    with self._route(q_idx, t_idx):
                        res = self._orient_pairs_native(idx)
                    if res is not None:
                        return res[0]
                    with self._route():
                        self._decisions = self._decision_matrix()
            else:
                if n >= 2048 and idx.shape[0] * 16 < n * n:
                    with self._route(q_idx, t_idx):
                        res = self._orient_pairs_native(idx)
                    if res is not None:
                        return res[0]
                with self._route():
                    self._decisions = self._decision_matrix()
        return self._decisions[idx[:, 0], idx[:, 1]]

    def distance_batch(self, idx_pairs) -> np.ndarray:
        """Mash distance estimates for (query_idx, target_idx) pairs in
        the chosen orientation — a free by-product of orient_batch, used
        to pick each pair's initial band width."""
        idx = np.asarray(idx_pairs, dtype=np.int64).reshape(-1, 2)
        n = len(self.sequences)
        if getattr(self, "_decisions", None) is None:
            hit = self._sub_lookup(idx)
            if hit is not None:
                return hit[1]
            pc = self._pair_lookup(idx)
            if pc is not None:
                return pc[1]
            # mirror orient_batch's sparse routing: a sparse request at
            # large n must never fall through to the O(n^2) NumPy
            # matrix (at n=10k that is an ~800 MB distance matrix and
            # minutes of work the native per-pair path avoids)
            q_idx = np.unique(idx[:, 0])
            t_idx = np.unique(idx[:, 1])
            if idx.shape[0] * 8 < q_idx.size * t_idx.size:
                with self._route(q_idx, t_idx):
                    res = self._orient_pairs_native(idx)
                if res is not None:
                    return res[1]
            if q_idx.size * t_idx.size * 4 < n * n:
                orient_routes.took("submatrix")
                with self._route(q_idx, t_idx):
                    dec, dist = self._decision_submatrix(q_idx, t_idx)
                self._sub = (q_idx, t_idx, dec, dist)
                return self._sub_lookup(idx)[1]
            if n >= 2048 and idx.shape[0] * 16 < n * n:
                with self._route(q_idx, t_idx):
                    res = self._orient_pairs_native(idx)
                if res is not None:
                    return res[1]
            with self._route():
                self._decisions = self._decision_matrix()
        return self._distances[idx[:, 0], idx[:, 1]]


def _jaccard_sets(s1: np.ndarray, s2: np.ndarray) -> float:
    inter = np.intersect1d(s1, s2, assume_unique=True).size
    union = s1.size + s2.size - inter
    return inter / union if union > 0 else 0.0


def determine_orientation_mash(query: bytes, target: bytes):
    """One-shot mash orientation (reference: alignment.rs:69-94).

    Returns (oriented_query_bytes, is_reverse).
    """
    t_sketch = sketch_stranded(target, ORIENTATION_KMER_SIZE, ORIENTATION_SKETCH_SIZE)
    f_sketch = sketch_stranded(query, ORIENTATION_KMER_SIZE, ORIENTATION_SKETCH_SIZE)
    rc = reverse_complement(query)
    r_sketch = sketch_stranded(rc, ORIENTATION_KMER_SIZE, ORIENTATION_SKETCH_SIZE)
    fwd_j = jaccard(f_sketch, t_sketch)
    rev_j = jaccard(r_sketch, t_sketch)
    if fwd_j >= rev_j:
        return query, False
    return rc, True


def _decide_device(codes, szf, szr, U, k, device):
    """Device body of OrientationIndex._decision_matrix_device: (n, n)
    bool decisions and f32 distances on `device`, from the (2n, S) code
    rows (fwd sets, then rev sets) and the set sizes."""
    n = szf.size
    counts = membership_counts(codes, U, n, device).long()
    # (2n, n): [i, j] = |set_i  ∩  fwd_j|
    fi, ri = counts[:n], counts[n:]
    szf = torch.from_numpy(szf).to(device).long()
    szr = torch.from_numpy(szr).to(device).long()
    fu = szf[:, None] + szf[None, :] - fi
    ru = szr[:, None] + szf[None, :] - ri
    dec = torch.logical_not(fi * ru.clamp(min=1) >= ri * fu.clamp(min=1))
    fwd_j = fi.float() / fu.clamp(min=1)
    rev_j = ri.float() / ru.clamp(min=1)
    best_j = torch.maximum(fwd_j, rev_j)
    dist = torch.where(
        best_j > 0,
        -torch.log(torch.clamp(2 * best_j / (1 + best_j), min=1e-30)) / k,
        1.0,
    )
    return dec, dist.clamp(max=1.0)
