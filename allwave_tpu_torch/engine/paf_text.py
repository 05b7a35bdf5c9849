"""PAF text for the CLI's writer, a batch of records at a time.

`cigar_texts(results)` makes the run-length CIGAR strings of a batch of
AlignmentResults in one NumPy pass: the records' runs are concatenated
(a per-base CIGAR enters as runs of one), zero-length runs dropped,
adjacent same-op runs of a record merged (the device run buffers cap a
run at 255, so a 300-base match arrives as 255 + 45), and each merged
count's decimal digits and its op character, after the WFA2 I/D swap,
laid out in one buffer that is decoded once and split per record. The
strings are byte for byte those of `core/cigar.py`'s
`runs_to_cigar_string` and `cigar_bytes_to_string`, which loop in
Python over every run.

`alignment_to_paf(result, sequences)` makes one record's line, that of
`core/paf.py`. The CLI keeps it as its per-record call (one call a
record, two positional arguments), so it cannot take the batch's text as
an argument: the writer runs it inside `prepared(batch)`, which holds the
batch's strings for the calling thread, keyed by the result. A result
outside any prepared batch gets its CIGAR from `core/cigar.py`.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import List, Optional, Sequence as PySequence

import numpy as np

from ..core.cigar import cigar_bytes_to_string, runs_to_cigar_string
from ..core.types import OP_D, OP_I, OP_M, OP_X, AlignmentResult, Sequence
from ..utils.telemetry import counters

#: op byte -> CIGAR character after the WFA2 I/D swap; any other byte
#: (and, clipped to 256, any op outside 0..255) prints '?', as in
#: core/cigar.py
_OP_CHARS = np.full(257, ord("?"), dtype=np.uint8)
for _op, _ch in ((OP_M, "="), (OP_X, "X"), (OP_I, "D"), (OP_D, "I")):
    _OP_CHARS[_op] = ord(_ch)
#: the three decimal digits of 0..999, with the leading zeros as NULs
#: (`_pad`: a count's leading group) or as '0' (`_full`: a group below it)
_v = np.arange(1000)
_full = (np.stack([_v // 100, _v // 10, _v], axis=1) % 10 + ord("0")).astype(np.uint8)
_pad = np.where(_v[:, None] >= [100, 10, 1], _full, 0).astype(np.uint8)


def _words(digits, tail):
    """Words of 3 digit bytes and a tail byte, 1,024 a tail byte, each a
    uint32 made from its bytes (so in either byte order)."""
    head = np.zeros((1024, 4), dtype=np.uint8)
    head[:1000, :3] = digits
    ends = np.zeros((len(tail), 4), dtype=np.uint8)
    ends[:, 3] = tail
    return (ends.view(np.uint32) | head.view(np.uint32)[:, 0]).reshape(-1)


#: a merged run's last word, at [op << 10 | count % 1000]: the count's
#: last three digits and the op's character; `_TAIL_PAD` where they are
#: the count's leading digits, `_TAIL_FULL` where more lie above
_TAIL_PAD = _words(_pad, _OP_CHARS)
_TAIL_FULL = _words(_full, _OP_CHARS)
#: a group of three digits above the last, and a NUL
_GROUP_PAD = _words(_pad, [0])
_GROUP_FULL = _words(_full, [0])
#: the bytes of a run whose count is 0..999: its digits and the op
_WIDTH = (2 + (_v >= 10) + (_v >= 100)).astype(np.uint8)
del _op, _ch, _v, _full, _pad


def _runs(result: AlignmentResult):
    """(ops, lens) of a result; a per-base CIGAR as runs of one."""
    runs = result.cigar_runs
    if runs is not None:
        return np.asarray(runs[0]), np.asarray(runs[1])
    ops = np.asarray(result.cigar_bytes, dtype=np.uint8)
    return ops, np.ones(ops.size, dtype=np.uint8)


def cigar_texts(results: PySequence[AlignmentResult]) -> List[str]:
    """The CIGAR string of each result, in one pass over the batch.

    Each merged run becomes a row of uint32 words: its count's digits,
    three to a word with NULs ahead of the first, the op's character in
    the last word. The rows' bytes with the NULs deleted are the
    records' strings end to end. Where no merged count reaches 1,000,
    as in nearly every batch of the device's runs (each at most 255),
    a run is one word and one table look-up."""
    n = len(results)
    counters.add(paf_batches=1, paf_batched=n)
    ops_l, lens_l = zip(*map(_runs, results)) if n else ((), ())
    offs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.fromiter((o.size for o in ops_l), np.int64, n), out=offs[1:])
    if not offs[-1]:
        return [""] * n
    ops = np.concatenate(ops_l)
    lens = np.concatenate(lens_l)
    keep = lens != 0
    if not keep.all():
        ops, lens = ops[keep], lens[keep]
        offs = np.concatenate(([0], np.cumsum(keep)))[offs]
        if not ops.size:
            return [""] * n
    size = ops.size
    # a merged run starts at a record's first run or where the op changes
    head = np.empty(size, dtype=bool)
    head[0] = True
    np.not_equal(ops[1:], ops[:-1], out=head[1:])
    head[offs[:-1][offs[:-1] < size]] = True
    first = np.flatnonzero(head)
    if first.size == size:
        counts, mops = lens, ops
    else:
        total = np.cumsum(lens, dtype=np.int64)[np.append(first[1:], size) - 1]
        counts, mops = np.diff(total, prepend=0), ops[first]
    if mops.dtype != np.uint8:
        mops = np.clip(mops, 0, 256)
    key = mops.astype(np.uint32) << 10
    top = int(counts.max())
    if top < 1000:
        key |= counts.astype(np.uint32)
        text = _TAIL_PAD.take(key).tobytes()
        width = _WIDTH.take(counts)
    else:
        # three digits a word, from the last group up
        digits = len(str(top))
        groups = (digits + 2) // 3
        counts = counts.astype(np.int64)
        key |= (counts % 1000).astype(np.uint32)
        rest = counts // 1000
        rows = np.empty((first.size, groups), dtype=np.uint32)
        rows[:, -1] = np.where(rest > 0, _TAIL_FULL.take(key), _TAIL_PAD.take(key))
        for g in range(groups - 2, -1, -1):
            low = rest % 1000
            rest //= 1000
            rows[:, g] = np.where(rest > 0, _GROUP_FULL.take(low), _GROUP_PAD.take(low))
        text = rows.tobytes()
        width = np.full(first.size, 2, dtype=np.uint8)
        for k in range(1, digits):
            width += counts >= 10**k
    text = text.translate(None, b"\0").decode("ascii")
    # each record's bytes: the widths of its merged runs summed
    at = np.searchsorted(first, offs)
    filled = at[1:] > at[:-1]
    sizes = np.zeros(n, dtype=np.int64)
    sizes[filled] = np.add.reduceat(width, at[:-1][filled], dtype=np.int64)
    bounds = np.concatenate(([0], np.cumsum(sizes))).tolist()
    return [text[a:b] for a, b in zip(bounds[:-1], bounds[1:])]


class _Held(threading.local):
    """The CIGAR strings of the batch the thread is writing, by result."""

    texts: Optional[dict] = None


_held = _Held()


@contextmanager
def prepared(results: PySequence[AlignmentResult]):
    """Inside the block, `alignment_to_paf` on this thread takes each of
    `results`' CIGAR text from one `cigar_texts` pass."""
    _held.texts = dict(zip(results, cigar_texts(results)))
    try:
        yield
    finally:
        _held.texts = None


def alignment_to_paf(result: AlignmentResult, sequences: PySequence[Sequence]) -> str:
    """The record's PAF line, as `core/paf.py`'s `alignment_to_paf`."""
    texts = _held.texts
    cigar = texts.get(result) if texts is not None else None
    if cigar is None:
        runs = result.cigar_runs
        if runs is not None:
            cigar = runs_to_cigar_string(*runs)
        else:
            cigar = cigar_bytes_to_string(result.cigar_bytes)
    query = sequences[result.query_idx]
    target = sequences[result.target_idx]
    block_len = max(result.target_end - result.target_start,
                    result.query_end - result.query_start)
    if result.alignment_length > 0:
        identity = result.num_matches / result.alignment_length
    else:
        identity = 0.0
    strand = "-" if result.is_reverse else "+"
    return (
        f"{query.id}\t{len(query.seq)}\t{result.query_start}\t{result.query_end}\t"
        f"{strand}\t{target.id}\t{len(target.seq)}\t{result.target_start}\t"
        f"{result.target_end}\t{result.num_matches}\t{block_len}\t60\t"
        f"gi:f:{identity:.6f}\tcg:Z:{cigar}"
    )
