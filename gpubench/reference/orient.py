"""Strand of each query against its target by allwave's mash rule
(alignment.rs:69-122): stranded bottom-1000 MinHash sketches of 15-mers
of the target, the query and the query's reverse complement; the
reverse complement is taken when its Jaccard is strictly higher."""

from __future__ import annotations

import numpy as np

from .siphash import hash_kmers

K = 15
SKETCH = 1000

_COMP = np.full(256, ord("N"), dtype=np.uint8)
for _a, _b in zip(b"AaTtCcGgNn", b"TTAAGGCCNN"):
    _COMP[_a] = _b
_DNA = np.zeros(256, dtype=bool)
_DNA[np.frombuffer(b"ACGTacgt", dtype=np.uint8)] = True


def reverse_complement(seq: bytes) -> bytes:
    return _COMP[np.frombuffer(seq, dtype=np.uint8)][::-1].tobytes()


def sketch_set(seq: bytes) -> np.ndarray:
    """The distinct hashes of the stranded sketch: the 1000 smallest
    window hashes (duplicates kept) of the windows that are all ACGT."""
    arr = np.frombuffer(seq, dtype=np.uint8)
    if arr.size < K:
        return np.zeros(0, dtype=np.uint64)
    bad = np.concatenate(([0], np.cumsum(~_DNA[arr])))
    valid = (bad[K:] - bad[:-K]) == 0
    h = np.sort(hash_kmers(arr, K)[valid])[:SKETCH]
    return np.unique(h)


def _jaccard(a: np.ndarray, b: np.ndarray) -> float:
    inter = np.intersect1d(a, b, assume_unique=True).size
    union = a.size + b.size - inter
    return inter / union if union > 0 else 0.0


def strands(seqs: list, pairs: np.ndarray) -> np.ndarray:
    """bool per pair: True where the query is reverse-complemented."""
    fwd = {}
    rev = {}
    for i in np.unique(pairs).tolist():
        fwd[i] = sketch_set(seqs[i])
    for i in np.unique(pairs[:, 0]).tolist():
        rev[i] = sketch_set(reverse_complement(seqs[i]))
    out = np.zeros(pairs.shape[0], dtype=bool)
    for r, (q, t) in enumerate(pairs.tolist()):
        out[r] = not (_jaccard(fwd[q], fwd[t]) >= _jaccard(rev[q], fwd[t]))
    return out
