"""FASTA IO.

Reference behavior (main.rs:205-234): ".gz"-suffixed inputs are read as
bgzip; others as plain FASTA. bgzf is a conformant gzip stream, so
Python's gzip module reads both bgzip and plain gzip transparently.
Record id = text up to the first whitespace in the header (both the
reference's readers behave this way); sequence bytes are preserved
verbatim (case included).
"""

from __future__ import annotations

import gzip
import io
from typing import Iterator, List, Sequence as PySequence

from ..core.types import Sequence


def _open(path: str):
    if str(path).endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


def iter_fasta(path: str) -> Iterator[Sequence]:
    """Stream records from a FASTA file (plain or gzipped)."""
    seq_id = None
    chunks: List[bytes] = []
    with _open(path) as f:
        for raw in f:
            line = raw.rstrip(b"\r\n")
            if line.startswith(b">"):
                if seq_id is not None:
                    yield Sequence(seq_id, b"".join(chunks))
                header = line[1:].strip()
                seq_id = header.split()[0].decode("utf-8") if header else ""
                chunks = []
            elif line:
                if seq_id is None:
                    raise ValueError("FASTA record data before header")
                chunks.append(line)
        if seq_id is not None:
            yield Sequence(seq_id, b"".join(chunks))


def read_fasta(path: str) -> List[Sequence]:
    return list(iter_fasta(path))


def write_fasta(path: str, sequences: PySequence[Sequence], width: int = 80) -> None:
    with open(path, "wb") as f:
        for s in sequences:
            f.write(b">" + s.id.encode("utf-8") + b"\n")
            for i in range(0, len(s.seq), width):
                f.write(s.seq[i : i + width] + b"\n")
