"""SipHash-1-3 with zero keys, as Rust's DefaultHasher computes it,
vectorized in NumPy: the hashes behind MinHash sketches and the
hash-filtered pair selection. A frozen copy of the NumPy paths of
`allwave_tpu_torch/hashing/siphash.py` (the program's native C++ path
is left out), so the reference shares no code with the program."""

from __future__ import annotations

import numpy as np

_U64 = np.uint64
_MASK = (1 << 64) - 1
_V0 = 0x736F6D6570736575
_V1 = 0x646F72616E646F6D
_V2 = 0x6C7967656E657261
_V3 = 0x7465646279746573


def _rotl(x: np.ndarray, b: int) -> np.ndarray:
    return (x << _U64(b)) | (x >> _U64(64 - b))


def _sipround(v0, v1, v2, v3):
    v0 = v0 + v1
    v1 = _rotl(v1, 13) ^ v0
    v0 = _rotl(v0, 32)
    v2 = v2 + v3
    v3 = _rotl(v3, 16) ^ v2
    v0 = v0 + v3
    v3 = _rotl(v3, 21) ^ v0
    v2 = v2 + v1
    v1 = _rotl(v1, 17) ^ v2
    v2 = _rotl(v2, 32)
    return v0, v1, v2, v3


def _pack_words(byte_matrix: np.ndarray, msg_len: int) -> np.ndarray:
    """(N, msg_len) uint8 messages -> (N, W) little-endian words with
    SipHash's final length/tail word."""
    n = byte_matrix.shape[0]
    n_words = msg_len // 8 + 1
    padded = np.zeros((n, n_words * 8), dtype=np.uint8)
    padded[:, :msg_len] = byte_matrix
    words = padded.view("<u8").reshape(n, n_words).copy()
    words[:, -1] |= _U64((msg_len & 0xFF) << 56)
    return words


def siphash13_rows(byte_matrix: np.ndarray) -> np.ndarray:
    """SipHash-1-3 of every row of an (N, L) uint8 matrix."""
    words = _pack_words(byte_matrix, byte_matrix.shape[1])
    with np.errstate(over="ignore"):
        n = words.shape[0]
        v0 = np.full(n, _V0, dtype=_U64)
        v1 = np.full(n, _V1, dtype=_U64)
        v2 = np.full(n, _V2, dtype=_U64)
        v3 = np.full(n, _V3, dtype=_U64)
        for w in range(words.shape[1]):
            m = words[:, w]
            v3 = v3 ^ m
            v0, v1, v2, v3 = _sipround(v0, v1, v2, v3)
            v0 = v0 ^ m
        v2 = v2 ^ _U64(0xFF)
        for _ in range(3):
            v0, v1, v2, v3 = _sipround(v0, v1, v2, v3)
    return v0 ^ v1 ^ v2 ^ v3


def hash_kmers(seq: np.ndarray, k: int) -> np.ndarray:
    """Rust's `<[u8] as Hash>` of every k-mer window: an 8-byte length
    prefix, then the k bytes."""
    n = seq.size - k + 1
    if n <= 0:
        return np.zeros(0, dtype=_U64)
    mat = np.empty((n, 8 + k), dtype=np.uint8)
    mat[:, :8] = np.frombuffer(int(k).to_bytes(8, "little"), dtype=np.uint8)
    mat[:, 8:] = np.lib.stride_tricks.sliding_window_view(seq, k)
    return siphash13_rows(mat)


def pair_keep_mask(ids: list, qi: np.ndarray, ti: np.ndarray, fraction: float) -> np.ndarray:
    """Keep directed pair (i, j) iff Rust's `<str as Hash>` of
    "{id_i}:{id_j}" (the bytes, then 0xFF) over u64::MAX is below
    `fraction`."""
    out = np.zeros(qi.size, dtype=bool)
    msgs = [f"{ids[a]}:{ids[b]}".encode() + b"\xff" for a, b in zip(qi.tolist(), ti.tolist())]
    by_len: dict = {}
    for r, m in enumerate(msgs):
        by_len.setdefault(len(m), []).append(r)
    for length, rows in by_len.items():
        mat = np.frombuffer(b"".join(msgs[r] for r in rows), dtype=np.uint8).reshape(-1, length)
        h = siphash13_rows(mat)
        out[np.asarray(rows)] = h.astype(np.float64) / float(_MASK) < fraction
    return out
