"""The comparison that decides `correct`: a job's PAF as the program
wrote it, against the plain reference worked out again from the job's
FASTA. Every record of a checked job is held to the reference's pair
set and strands, and its CIGAR to the two sequences (it must walk both
end to end, = on equal bases and X on different ones) and to the
record's other fields; a sample of its pairs, drawn from the seed and
holding the job's highest-scoring record, is held to the reference's
score, CIGAR and whole PAF line. Each number is a count of
disagreements and its limit is 0: the answer is exact
(docs/TIEBREAK.md)."""

from __future__ import annotations

import copy
import re
from typing import Dict, List, Optional

import numpy as np

from .leastwork import cigar_score
from .reference import orient, pairs as ref_pairs, wfa

#: the numbers compared, each with its limit
LIMITS = {
    "jobs_failed": 0,
    "pairs_missing": 0,
    "pairs_extra": 0,
    "strand_diff": 0,
    "records_invalid": 0,
    "score_diff": 0,
    "cigar_diff": 0,
    "line_diff": 0,
}

_RUN = re.compile(r"(\d+)([=XID])")
_STD = {wfa.OP_M: "=", wfa.OP_X: "X", wfa.OP_I: "D", wfa.OP_D: "I"}


def paf_record(qid: str, qlen: int, tid: str, tlen: int, reverse: bool, cigar: str) -> str:
    """allwave's PAF record of a global alignment (alignment.rs:347-376)
    from its standard CIGAR (I consumes the query, D the target)."""
    n = {op: 0 for op in "=XID"}
    for ln, op in _RUN.findall(cigar):
        n[op] += int(ln)
    qend = n["="] + n["X"] + n["I"]
    tend = n["="] + n["X"] + n["D"]
    aln = n["="] + n["X"]
    ident = n["="] / aln if aln > 0 else 0.0
    return (f"{qid}\t{qlen}\t0\t{qend}\t{'-' if reverse else '+'}\t{tid}\t{tlen}\t0\t"
            f"{tend}\t{n['=']}\t{max(qend, tend)}\t60\tgi:f:{ident:.6f}\tcg:Z:{cigar}")


def paf_line(qid: str, qlen: int, tid: str, tlen: int, reverse: bool, runs) -> str:
    """The record of the reference's runs: the WFA's I and D swapped back
    to the standard sense."""
    cigar = "".join(f"{ln}{_STD[op]}" for op, ln in runs)
    return paf_record(qid, qlen, tid, tlen, reverse, cigar)


def replays(cigar: str, query: bytes, target: bytes) -> bool:
    """Whether a PAF CIGAR walks both sequences end to end, = on equal
    bases and X on different ones."""
    runs = _RUN.findall(cigar)
    if not runs or "".join(f"{n}{op}" for n, op in runs) != cigar:
        return False
    lens = np.array([int(n) for n, _ in runs], dtype=np.int64)
    ops = np.frombuffer("".join(op for _, op in runs).encode(), dtype=np.uint8)
    if lens.min() <= 0:
        return False
    step_q = np.isin(ops, np.frombuffer(b"=XI", np.uint8))
    step_t = np.isin(ops, np.frombuffer(b"=XD", np.uint8))
    if int(lens[step_q].sum()) != len(query) or int(lens[step_t].sum()) != len(target):
        return False
    op = np.repeat(ops, lens)
    q_at = np.cumsum(np.repeat(step_q, lens)) - 1
    t_at = np.cumsum(np.repeat(step_t, lens)) - 1
    diag = (op == ord("=")) | (op == ord("X"))
    a = np.frombuffer(query, dtype=np.uint8)[q_at[diag]]
    b = np.frombuffer(target, dtype=np.uint8)[t_at[diag]]
    return bool(np.array_equal(a == b, op[diag] == ord("=")))


def read_paf(path: str) -> List[List[str]]:
    """A PAF file's records split on tabs; none where it was never
    written."""
    try:
        with open(path) as f:
            return [line.rstrip("\n").split("\t") for line in f if line.strip()]
    except FileNotFoundError:
        return []


class JobCheck:
    """The reference's view of one job: its pairs and strands, and the
    sampled pairs' alignments once `align` has run."""

    def __init__(self, seqs, params: dict, n_sample: int, rng: np.random.RandomState,
                 records: List[List[str]]):
        self.seqs = seqs
        self.ids = [s.id for s in seqs]
        self.index = {sid: i for i, sid in enumerate(self.ids)}
        self.pen = wfa.penalties(params["scores"])
        self.pairs = ref_pairs.select_pairs(self.ids, params["sparsification"])
        self.strands = orient.strands([s.seq for s in seqs], self.pairs)
        self._index_records(records)
        self.sample = self._sample(n_sample, rng)

    def _index_records(self, records: List[List[str]]) -> None:
        self.records = records
        self._invalid: Optional[int] = None
        self.by_pair: Dict[tuple, List[str]] = {}
        self.duplicates = 0
        for r in records:
            key = (r[0], r[5])
            if key in self.by_pair:
                self.duplicates += 1
            self.by_pair[key] = r

    def with_records(self, records: List[List[str]]) -> "JobCheck":
        """The same job, pairs, strands and sample, judging other records."""
        other = copy.copy(self)
        other._index_records(records)
        return other

    def _sample(self, n: int, rng) -> List[int]:
        """Rows of the reference's pair list: the program's
        highest-scoring record's pair, then pairs drawn from the seed."""
        rows = []
        row_of = {(self.ids[q], self.ids[t]): r for r, (q, t) in enumerate(self.pairs.tolist())}
        scored = [(cigar_score(r[-1][5:], self.pen), (r[0], r[5])) for r in self.records
                  if r[-1].startswith("cg:Z:") and (r[0], r[5]) in row_of]
        if scored:
            rows.append(row_of[max(scored)[1]])
        order = rng.permutation(self.pairs.shape[0]).tolist()
        for r in order:
            if len(rows) >= min(n, self.pairs.shape[0]):
                break
            if r not in rows:
                rows.append(r)
        return rows

    def oriented(self, row: int):
        q, t = self.pairs[row].tolist()
        qs = self.seqs[q].seq
        if self.strands[row]:
            qs = orient.reverse_complement(qs)
        return qs, self.seqs[t].seq

    def align(self, device, batch: int, band: Optional[int] = None,
              order=wfa.TIEBREAK_M) -> Dict[tuple, tuple]:
        """(score, PAF line) of every sampled pair by the reference (by
        a control where a band or another tie order is given)."""
        return self.align_orders(device, batch, (order,), band)[0]

    def align_orders(self, device, batch: int, orders,
                     band: Optional[int] = None) -> List[Dict[tuple, tuple]]:
        """`align` under each tie order, from one forward a batch."""
        out = [{} for _ in orders]
        for lo in range(0, len(self.sample), batch):
            rows = self.sample[lo : lo + batch]
            res = wfa.align_batch([self.oriented(r) for r in rows], self.pen, device, band,
                                  orders=tuple(orders))
            for r, (score, walks) in zip(rows, res):
                q, t = self.pairs[r].tolist()
                for i, runs in enumerate(walks):
                    line = paf_line(self.ids[q], len(self.seqs[q].seq), self.ids[t],
                                    len(self.seqs[t].seq), bool(self.strands[r]), runs)
                    out[i][(self.ids[q], self.ids[t])] = (score, line)
        return out

    def valid(self, rec: List[str]) -> bool:
        """Whether a record's CIGAR walks its two sequences, on the
        record's own strand, and its other fields are the ones that
        CIGAR gives."""
        q, t = self.index.get(rec[0]), self.index.get(rec[5])
        if q is None or t is None or len(rec) != 14 or not rec[-1].startswith("cg:Z:"):
            return False
        cigar = rec[-1][5:]
        qs = self.seqs[q].seq
        if rec[4] == "-":
            qs = orient.reverse_complement(qs)
        line = paf_record(rec[0], len(qs), rec[5], len(self.seqs[t].seq), rec[4] == "-", cigar)
        return line == "\t".join(rec) and replays(cigar, qs, self.seqs[t].seq)

    def counts(self, expected: Dict[tuple, tuple],
               lines: Optional[Dict[tuple, str]] = None) -> Dict[str, int]:
        """The disagreements of the program's records (or of `lines` in
        their place for the sampled pairs) with the reference."""
        ref_keys = {(self.ids[q], self.ids[t]): r for r, (q, t) in enumerate(self.pairs.tolist())}
        got = set(self.by_pair)
        c = {
            "pairs_missing": len(set(ref_keys) - got),
            "pairs_extra": len(got - set(ref_keys)) + self.duplicates,
            "strand_diff": 0,
            "records_invalid": 0,
            "score_diff": 0,
            "cigar_diff": 0,
            "line_diff": 0,
        }
        for key, row in ref_keys.items():
            rec = self.by_pair.get(key)
            if rec is not None and rec[4] != ("-" if self.strands[row] else "+"):
                c["strand_diff"] += 1
        if self._invalid is None:
            self._invalid = sum(not self.valid(rec) for rec in self.records)
        c["records_invalid"] = self._invalid
        for key, (score, ref_line) in expected.items():
            line = lines[key] if lines is not None else None
            if line is None:
                rec = self.by_pair.get(key)
                line = "\t".join(rec) if rec is not None else ""
            fields = line.split("\t")
            cigar = fields[-1][5:] if fields[-1].startswith("cg:Z:") else ""
            q, t = self.index[key[0]], self.index[key[1]]
            qs = self.seqs[q].seq
            if len(fields) > 4 and fields[4] == "-":
                qs = orient.reverse_complement(qs)
            ok = bool(cigar) and replays(cigar, qs, self.seqs[t].seq)
            if not ok or cigar_score(cigar, self.pen) != score:
                c["score_diff"] += 1
            if cigar != ref_line.split("\t")[-1][5:]:
                c["cigar_diff"] += 1
            if line != ref_line:
                c["line_diff"] += 1
        return c
