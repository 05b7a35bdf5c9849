"""Bit-exact replication of Rust's ``std::collections::hash_map::DefaultHasher``.

The reference derives *all* of its deterministic randomness from Rust's
DefaultHasher — SipHash-1-3 with zero keys:

* k-mer hashes for MinHash sketching (reference: mash.rs:110-114,
  alignment.rs:142-149): ``kmer.hash(&mut hasher)`` where ``kmer: &[u8]``.
  Rust's ``Hash for [u8]`` writes a usize length prefix (8 bytes LE) and then
  the bytes.
* pair-sparsification decisions (reference: iterator.rs:256-284,
  knn_graph.rs:161-174): ``format!("{id_i}:{id_j}").hash(&mut hasher)``.
  Rust's ``Hash for str`` writes the bytes followed by a single 0xFF
  terminator byte (no length prefix).

Sparsified pair sets, MinHash sketches, orientation calls — and therefore
PAF equality — all depend on reproducing these hashes bit-for-bit, so this
module implements SipHash-1-3 (1 compression round, 3 finalization rounds,
keys k0=k1=0) exactly, both scalar and vectorized over all k-mer windows of
a sequence. A C++ fast path lives in csrc/siphash13.cpp; this NumPy version
is the always-available fallback and the test oracle.
"""

from __future__ import annotations

import numpy as np

_U64 = np.uint64

# SipHash initial state constants ("somepseudorandomlygeneratedbytes"),
# XORed with k0/k1 which are zero for DefaultHasher.
_V0 = 0x736F6D6570736575
_V1 = 0x646F72616E646F6D
_V2 = 0x6C7967656E657261
_V3 = 0x7465646279746573

_MASK = (1 << 64) - 1


def _rotl(x: int, b: int) -> int:
    return ((x << b) | (x >> (64 - b))) & _MASK


def _sipround(v0: int, v1: int, v2: int, v3: int):
    v0 = (v0 + v1) & _MASK
    v1 = _rotl(v1, 13)
    v1 ^= v0
    v0 = _rotl(v0, 32)
    v2 = (v2 + v3) & _MASK
    v3 = _rotl(v3, 16)
    v3 ^= v2
    v0 = (v0 + v3) & _MASK
    v3 = _rotl(v3, 21)
    v3 ^= v0
    v2 = (v2 + v1) & _MASK
    v1 = _rotl(v1, 17)
    v1 ^= v2
    v2 = _rotl(v2, 32)
    return v0, v1, v2, v3


def siphash13(data: bytes) -> int:
    """Scalar SipHash-1-3 with zero keys over a raw byte stream.

    Equivalent to feeding ``data`` to Rust's DefaultHasher via
    ``Hasher::write`` and calling ``finish()``.
    """
    v0, v1, v2, v3 = _V0, _V1, _V2, _V3
    n = len(data)
    nwords = n // 8
    for w in range(nwords):
        m = int.from_bytes(data[w * 8 : w * 8 + 8], "little")
        v3 ^= m
        v0, v1, v2, v3 = _sipround(v0, v1, v2, v3)
        v0 ^= m
    tail = data[nwords * 8 :]
    b = ((n & 0xFF) << 56) | int.from_bytes(tail, "little")
    v3 ^= b
    v0, v1, v2, v3 = _sipround(v0, v1, v2, v3)
    v0 ^= b
    v2 ^= 0xFF
    for _ in range(3):
        v0, v1, v2, v3 = _sipround(v0, v1, v2, v3)
    return (v0 ^ v1 ^ v2 ^ v3) & _MASK


def hash_bytes_rust(data: bytes) -> int:
    """Rust ``<[u8] as Hash>::hash`` through DefaultHasher:
    usize length prefix (8 bytes LE) + the bytes."""
    return siphash13(len(data).to_bytes(8, "little") + data)


def hash_str_rust(s: str) -> int:
    """Rust ``<str as Hash>::hash`` through DefaultHasher:
    the UTF-8 bytes + a 0xFF terminator (no length prefix)."""
    return siphash13(s.encode("utf-8") + b"\xff")


def pair_hash(id_i: str, id_j: str) -> int:
    """Directed pair hash used for sparsification decisions
    (reference: iterator.rs:269-276): hash of the string "{id_i}:{id_j}"."""
    return hash_str_rust(f"{id_i}:{id_j}")


def pair_keep_mask(
    ids_i: list, ids_j: list, keep_fraction: float
) -> np.ndarray:
    """Vectorized sparsification filter (reference: iterator.rs:256-284).

    Keeps pair (i, j) iff hash("{id_i}:{id_j}") / u64::MAX < keep_fraction.
    """
    msgs = [f"{a}:{b}".encode("utf-8") + b"\xff" for a, b in zip(ids_i, ids_j)]
    hashes = siphash13_batch(msgs)
    # The reference computes (hash as f64) / (u64::MAX as f64) < fraction.
    normalized = hashes.astype(np.float64) / float(_MASK)
    return normalized < keep_fraction


# --------------------------------------------------------------------------
# Vectorized implementations (NumPy uint64, wrapping arithmetic)
# --------------------------------------------------------------------------


def _rotl_v(x: np.ndarray, b: int) -> np.ndarray:
    b_ = _U64(b)
    inv = _U64(64 - b)
    return (x << b_) | (x >> inv)


def _sipround_v(v0, v1, v2, v3):
    v0 = v0 + v1
    v1 = _rotl_v(v1, 13)
    v1 = v1 ^ v0
    v0 = _rotl_v(v0, 32)
    v2 = v2 + v3
    v3 = _rotl_v(v3, 16)
    v3 = v3 ^ v2
    v0 = v0 + v3
    v3 = _rotl_v(v3, 21)
    v3 = v3 ^ v0
    v2 = v2 + v1
    v1 = _rotl_v(v1, 17)
    v1 = v1 ^ v2
    v2 = _rotl_v(v2, 32)
    return v0, v1, v2, v3


def _siphash13_words(words: np.ndarray, total_len: int) -> np.ndarray:
    """SipHash-1-3 over N parallel messages of identical length.

    ``words``: (N, W) uint64 — the full 8-byte LE words of each message,
    with the final word already holding the tail bytes OR'd with
    ``(total_len & 0xff) << 56`` iff the message length is not a multiple of
    8; if it IS a multiple of 8, the caller must append the standalone
    length word ``(total_len & 0xff) << 56`` as the last column.
    """
    n = words.shape[0]
    v0 = np.full(n, _V0, dtype=_U64)
    v1 = np.full(n, _V1, dtype=_U64)
    v2 = np.full(n, _V2, dtype=_U64)
    v3 = np.full(n, _V3, dtype=_U64)
    for w in range(words.shape[1]):
        m = words[:, w]
        v3 = v3 ^ m
        v0, v1, v2, v3 = _sipround_v(v0, v1, v2, v3)
        v0 = v0 ^ m
    v2 = v2 ^ _U64(0xFF)
    for _ in range(3):
        v0, v1, v2, v3 = _sipround_v(v0, v1, v2, v3)
    return v0 ^ v1 ^ v2 ^ v3


def _pack_words(byte_matrix: np.ndarray, msg_len: int) -> np.ndarray:
    """Pack an (N, msg_len) uint8 matrix into SipHash message words,
    including the final length/tail word."""
    n = byte_matrix.shape[0]
    n_full = msg_len // 8
    tail_len = msg_len % 8
    n_words = n_full + 1  # tail word always present (possibly bytes-empty)
    padded = np.zeros((n, n_words * 8), dtype=np.uint8)
    padded[:, :msg_len] = byte_matrix
    words = padded.view("<u8").reshape(n, n_words).copy()
    len_word = _U64((msg_len & 0xFF) << 56)
    if tail_len == 0:
        words[:, -1] = len_word
    else:
        words[:, -1] |= len_word
    return words


def pair_keep_mask_pooled(
    id_bytes: list, qi: np.ndarray, ti: np.ndarray, keep_fraction: float,
    chunk: int = 1 << 22,
) -> np.ndarray:
    """pair_keep_mask with the pair list in pooled-index form: id_bytes
    is the per-sequence encoded id list; qi/ti index into it. Fully
    vectorized (the per-pair f-string + per-row matrix fill of the list
    path cost ~4 us/pair — 392 s for the n=10k giant:0.99 build), with
    pairs grouped by (len_i, len_j) and processed in bounded chunks.
    Bit-identical decisions to pair_keep_mask."""
    n = len(id_bytes)
    lens = np.fromiter((len(b) for b in id_bytes), np.int64, n)
    lmax = int(lens.max()) if n else 0
    idmat = np.zeros((n, lmax), dtype=np.uint8)
    for r, b in enumerate(id_bytes):
        idmat[r, : len(b)] = np.frombuffer(b, dtype=np.uint8)
    from .. import native

    keep = native.pair_filter_native(idmat, lens, qi, ti, float(keep_fraction))
    if keep is not None:  # ~60 ns/pair vs ~600 ns for the NumPy path
        return keep
    m = qi.shape[0]
    out = np.zeros(m, dtype=bool)
    la_all = lens[qi]
    lb_all = lens[ti]
    key = la_all * (lmax + 1) + lb_all
    order = np.argsort(key, kind="stable")
    bounds = np.flatnonzero(np.diff(key[order])) + 1
    frac = float(keep_fraction)
    for grp in np.split(order, bounds):
        la = int(la_all[grp[0]])
        lb = int(lb_all[grp[0]])
        width = la + lb + 2  # ':' separator + 0xff terminator
        for lo in range(0, grp.size, chunk):
            g = grp[lo : lo + chunk]
            mat = np.empty((g.size, width), dtype=np.uint8)
            mat[:, :la] = idmat[qi[g], :la]
            mat[:, la] = ord(":")
            mat[:, la + 1 : la + 1 + lb] = idmat[ti[g], :lb]
            mat[:, -1] = 0xFF
            words = _pack_words(mat, width)
            h = _siphash13_words(words, width)
            out[g] = (h.astype(np.float64) / float(_MASK)) < frac
    return out


def siphash13_batch(messages) -> np.ndarray:
    """Hash a list of arbitrary-length byte strings (grouped by length)."""
    out = np.zeros(len(messages), dtype=_U64)
    by_len: dict = {}
    for idx, m in enumerate(messages):
        by_len.setdefault(len(m), []).append(idx)
    for length, idxs in by_len.items():
        mat = np.zeros((len(idxs), length), dtype=np.uint8)
        for row, idx in enumerate(idxs):
            mat[row, :] = np.frombuffer(messages[idx], dtype=np.uint8)
        words = _pack_words(mat, length)
        out[np.asarray(idxs)] = _siphash13_words(words, length)
    return out


def hash_kmers(seq: np.ndarray, k: int) -> np.ndarray:
    """Hash every k-mer window of ``seq`` (uint8 array) exactly as the
    reference's ``hash_kmer`` does (reference: mash.rs:110-114):
    DefaultHasher over (usize length prefix || k bytes).

    Returns a uint64 array of length ``len(seq) - k + 1`` (empty if the
    sequence is shorter than k). Validity filtering (non-ACGT) is the
    caller's job — every window is hashed here.
    """
    seq = np.ascontiguousarray(seq, dtype=np.uint8)
    n = seq.size - k + 1
    if n <= 0:
        return np.zeros(0, dtype=_U64)
    # native C++ path when built (csrc/siphash13.cpp, bit-identical;
    # ~25x the vectorized-NumPy throughput on long sequences)
    from .. import native

    nat = native.hash_kmers_native(seq, k)
    if nat is not None:
        return nat
    msg_len = 8 + k
    # Build the (n, msg_len) byte matrix: 8-byte LE length prefix + window.
    mat = np.zeros((n, msg_len), dtype=np.uint8)
    prefix = np.frombuffer(int(k).to_bytes(8, "little"), dtype=np.uint8)
    mat[:, :8] = prefix
    windows = np.lib.stride_tricks.sliding_window_view(seq, k)
    mat[:, 8:] = windows
    words = _pack_words(mat, msg_len)
    return _siphash13_words(words, msg_len)
