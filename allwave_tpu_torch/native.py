"""ctypes loader for the native C++ components (csrc/).

The shared library is built on demand with `make -C csrc` the first time
it is needed. Every native entry point has a pure-NumPy fallback, so the
framework works (slower) even without a compiler.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_REPO, "csrc")
_LIB_PATH = os.path.join(_CSRC, "liballwave_native.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    try:
        subprocess.run(
            ["make", "-C", _CSRC],
            capture_output=True,
            check=True,
            timeout=300,
        )
        return True
    except Exception:
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    """The native library, building it if necessary; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        srcs = [
            os.path.join(_CSRC, f)
            for f in ("wfa_oracle.cpp", "siphash13.cpp", "orient_pairs.cpp")
        ]
        have_srcs = all(os.path.exists(s) for s in srcs)
        stale = have_srcs and (
            not os.path.exists(_LIB_PATH)
            or os.path.getmtime(_LIB_PATH)
            < max(os.path.getmtime(s) for s in srcs)
        )
        if stale and not _build():
            if not os.path.exists(_LIB_PATH):
                return None
        if not os.path.exists(_LIB_PATH):
            return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            return None

        _register(lib)
        if not hasattr(lib, "siphash13_raw"):
            # not our library at all — fall back to pure NumPy
            return None
        _lib = lib
        return _lib


def _register(lib: ctypes.CDLL) -> None:
    """Set prototypes for every entry point PRESENT in the binary.
    Each symbol is guarded individually so a stale .so that predates a
    newer entry point (and cannot be rebuilt — no compiler, or sources
    absent) keeps its existing fast paths; call sites hasattr-check
    before use and fall back per-path."""
    if hasattr(lib, "siphash13_raw"):
        lib.siphash13_raw.restype = ctypes.c_uint64
        lib.siphash13_raw.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    if hasattr(lib, "siphash13_kmers"):
        lib.siphash13_kmers.restype = None
        lib.siphash13_kmers.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint64),
        ]
    if hasattr(lib, "orient_pairs"):
        lib.orient_pairs.restype = None
        lib.orient_pairs.argtypes = [
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_double),
        ]
    if hasattr(lib, "siphash13_pair_filter"):
        lib.siphash13_pair_filter.restype = None
        lib.siphash13_pair_filter.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
            ctypes.c_double,
            ctypes.POINTER(ctypes.c_uint8),
        ]
    if hasattr(lib, "wfa_align_batch_rle"):
        lib.wfa_align_batch_rle.restype = ctypes.c_int
        lib.wfa_align_batch_rle.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),   # pool
            ctypes.POINTER(ctypes.c_int64),   # qoff
            ctypes.POINTER(ctypes.c_int32),   # qlen
            ctypes.POINTER(ctypes.c_int64),   # toff
            ctypes.POINTER(ctypes.c_int32),   # tlen
            ctypes.c_int32,                   # n
            ctypes.c_int32,                   # x
            ctypes.c_int32,                   # o1
            ctypes.c_int32,                   # e1
            ctypes.c_int32,                   # o2
            ctypes.c_int32,                   # e2
            ctypes.c_int32,                   # two_piece
            ctypes.c_int32,                   # s_cap
            ctypes.POINTER(ctypes.c_uint8),   # run_ops
            ctypes.POINTER(ctypes.c_int32),   # run_lens
            ctypes.c_int64,                   # run_cap
            ctypes.POINTER(ctypes.c_int64),   # run_offsets
            ctypes.POINTER(ctypes.c_int32),   # scores
            ctypes.POINTER(ctypes.c_int64),   # stats
        ]
    if hasattr(lib, "wfa_align_single"):
        lib.wfa_align_single.restype = ctypes.c_int
        lib.wfa_align_single.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
        ]


def available() -> bool:
    return get_lib() is not None


def hash_kmers_native(seq: np.ndarray, k: int) -> Optional[np.ndarray]:
    """Native batch k-mer hashing; None if the library is unavailable."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "siphash13_kmers"):
        return None
    seq = np.ascontiguousarray(seq, dtype=np.uint8)
    n = seq.size - k + 1
    if n <= 0:
        return np.zeros(0, dtype=np.uint64)
    out = np.empty(n, dtype=np.uint64)
    lib.siphash13_kmers(
        seq.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(seq.size),
        ctypes.c_int32(k),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
    )
    return out


def orient_pairs_native(
    fcat: np.ndarray,
    foff: np.ndarray,
    rcat: np.ndarray,
    roff: np.ndarray,
    qi: np.ndarray,
    ti: np.ndarray,
    kmer: int,
):
    """Per-pair mash orientation decisions + distances over CSR-packed
    stranded sketch sets (csrc/orient_pairs.cpp). Decisions are
    bit-identical to OrientationIndex.orient (integer cross-compare);
    distances are the reference mash formula in float64 (band hints
    only). Returns (is_reverse bool[m], dist f64[m]) or None."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "orient_pairs"):
        return None
    fcat = np.ascontiguousarray(fcat, dtype=np.uint64)
    foff = np.ascontiguousarray(foff, dtype=np.int64)
    rcat = np.ascontiguousarray(rcat, dtype=np.uint64)
    roff = np.ascontiguousarray(roff, dtype=np.int64)
    qi = np.ascontiguousarray(qi, dtype=np.int64)
    ti = np.ascontiguousarray(ti, dtype=np.int64)
    m = qi.shape[0]
    if m == 0:
        return np.zeros(0, dtype=bool), np.zeros(0, dtype=np.float64)
    dec = np.empty(m, dtype=np.uint8)
    dist = np.empty(m, dtype=np.float64)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.orient_pairs(
        fcat.ctypes.data_as(u64p),
        foff.ctypes.data_as(i64p),
        rcat.ctypes.data_as(u64p),
        roff.ctypes.data_as(i64p),
        qi.ctypes.data_as(i64p),
        ti.ctypes.data_as(i64p),
        ctypes.c_int64(m),
        ctypes.c_int32(kmer),
        dec.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        dist.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    return dec.astype(bool), dist


def pair_filter_native(
    idmat: np.ndarray,
    lens: np.ndarray,
    qi: np.ndarray,
    ti: np.ndarray,
    keep_fraction: float,
) -> Optional[np.ndarray]:
    """Native sparsification keep-mask over pooled-index pairs
    (reference: iterator.rs:256-284). Bit-identical decisions to
    hashing.siphash.pair_keep_mask_pooled; None if the library is
    unavailable."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "siphash13_pair_filter"):
        return None
    idmat = np.ascontiguousarray(idmat, dtype=np.uint8)
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    qi = np.ascontiguousarray(qi, dtype=np.int64)
    ti = np.ascontiguousarray(ti, dtype=np.int64)
    m = qi.shape[0]
    if m == 0:
        return np.zeros(0, dtype=bool)
    out = np.empty(m, dtype=np.uint8)
    lib.siphash13_pair_filter(
        idmat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(idmat.shape[0]),
        ctypes.c_int64(idmat.shape[1]),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        qi.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ti.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(m),
        ctypes.c_double(keep_fraction),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out.astype(bool)


def wfa_align_batch_rle_native(
    pool_seqs, qidx: np.ndarray, tidx: np.ndarray, pen, s_cap: int = 1 << 20
):
    """Batch exact WFA over pooled-index pairs with run-length CIGAR
    output (csrc wfa_align_batch_rle): ONE ctypes call for the whole
    workload, wavefront buffers reused across pairs in C++ — ~2x the
    per-pair wfa_align_native throughput on short pairs (which is
    dominated by per-call allocation + FFI overhead). Returns
    (scores int32[n], run_ops uint8, run_lens int32, run_offsets
    int64[n+1], stats int64[n, 4] = #M/#X/#I/#D) or None if the library
    (or this entry point) is unavailable. scores[i] < 0 marks a failed
    pair (empty runs). Bit-identical alignments to wfa_align_native."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "wfa_align_batch_rle"):
        return None
    n = len(qidx)
    if n == 0:
        return (
            np.zeros(0, np.int32),
            np.zeros(0, np.uint8),
            np.zeros(0, np.int32),
            np.zeros(1, np.int64),
            np.zeros((0, 4), np.int64),
        )
    offs = np.zeros(len(pool_seqs) + 1, dtype=np.int64)
    np.cumsum([len(b) for b in pool_seqs], out=offs[1:])
    pool = np.frombuffer(b"".join(pool_seqs), dtype=np.uint8)
    if pool.size == 0:
        pool = np.zeros(1, np.uint8)
    qidx = np.asarray(qidx, dtype=np.int64)
    tidx = np.asarray(tidx, dtype=np.int64)
    qoff = np.ascontiguousarray(offs[qidx])
    toff = np.ascontiguousarray(offs[tidx])
    qlen = np.ascontiguousarray(
        (offs[qidx + 1] - offs[qidx]).astype(np.int32)
    )
    tlen = np.ascontiguousarray(
        (offs[tidx + 1] - offs[tidx]).astype(np.int32)
    )
    run_cap = int((qlen.astype(np.int64) + tlen.astype(np.int64)).sum()) + 2 * n
    run_ops = np.empty(run_cap, dtype=np.uint8)
    run_lens = np.empty(run_cap, dtype=np.int32)
    run_offsets = np.zeros(n + 1, dtype=np.int64)
    scores = np.empty(n, dtype=np.int32)
    stats = np.empty((n, 4), dtype=np.int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    rc = lib.wfa_align_batch_rle(
        pool.ctypes.data_as(u8p),
        qoff.ctypes.data_as(i64p),
        qlen.ctypes.data_as(i32p),
        toff.ctypes.data_as(i64p),
        tlen.ctypes.data_as(i32p),
        ctypes.c_int32(n),
        ctypes.c_int32(pen.x),
        ctypes.c_int32(pen.o1),
        ctypes.c_int32(pen.e1),
        ctypes.c_int32(pen.o2),
        ctypes.c_int32(pen.e2),
        ctypes.c_int32(1 if pen.two_piece else 0),
        ctypes.c_int32(s_cap),
        run_ops.ctypes.data_as(u8p),
        run_lens.ctypes.data_as(i32p),
        ctypes.c_int64(run_cap),
        run_offsets.ctypes.data_as(i64p),
        scores.ctypes.data_as(i32p),
        stats.ctypes.data_as(i64p),
    )
    if rc != 0:
        raise RuntimeError(f"native batch WFA error {rc}")
    return scores, run_ops, run_lens, run_offsets, stats


def wfa_align_native(
    query: bytes, target: bytes, pen, s_cap: int = 1 << 20
) -> Optional[Tuple[int, np.ndarray]]:
    """Native exact WFA; returns (score, cigar_bytes) or None if the
    library is unavailable. Raises RuntimeError if s_cap was exceeded."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "wfa_align_single"):
        return None
    q = np.frombuffer(query, dtype=np.uint8)
    t = np.frombuffer(target, dtype=np.uint8)
    cap = q.size + t.size + 16
    cigar = np.empty(cap, dtype=np.uint8)
    clen = ctypes.c_int64(0)
    score = lib.wfa_align_single(
        q.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int32(q.size),
        t.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int32(t.size),
        ctypes.c_int32(pen.x),
        ctypes.c_int32(pen.o1),
        ctypes.c_int32(pen.e1),
        ctypes.c_int32(pen.o2),
        ctypes.c_int32(pen.e2),
        ctypes.c_int32(1 if pen.two_piece else 0),
        ctypes.c_int32(s_cap),
        cigar.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(cap),
        ctypes.byref(clen),
    )
    if score == -1:
        raise RuntimeError(f"native WFA exceeded s_cap={s_cap}")
    if score < 0:
        raise RuntimeError(f"native WFA error {score}")
    return int(score), cigar[: clen.value].copy()
