"""The CLI writer's batch pass (`allwave_tpu_torch/engine/paf_text.py`):
each record's CIGAR text byte for byte that of `core/cigar.py`'s
per-record functions, and the CLI's PAF file that of `core/paf.py`,
record by record, with `cli.alignment_to_paf` called once a record."""

import functools
import io
import time
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest

from allwave_tpu_torch import cli
from allwave_tpu_torch.core import paf as core_paf
from allwave_tpu_torch.core.cigar import cigar_bytes_to_string, runs_to_cigar_string
from allwave_tpu_torch.core.types import OP_D, OP_I, OP_M, OP_X, AlignmentResult, Sequence
from allwave_tpu_torch.engine import paf_text
from allwave_tpu_torch.engine.fasta import read_fasta
from allwave_tpu_torch.engine.pipeline import AllPairAligner
from allwave_tpu_torch.utils.telemetry import counters


def _runs(ops, lens, lens_dtype=np.int64):
    return AlignmentResult(0, 1, 0, 0, 0, 0, False,
                           cigar_runs=(np.asarray(ops, np.uint8), np.asarray(lens, lens_dtype)))


def _bytes(cigar: bytes):
    return AlignmentResult(0, 1, 0, 0, 0, 0, False,
                           cigar_bytes=np.frombuffer(cigar, np.uint8).copy())


def _random_runs(rng, length, div, lens_dtype=np.uint8):
    """Run lists as the device run buffers hand them over: single
    mismatches, 1-10 base gaps, matches between them, every run capped
    at 255 bases (a longer one split into 255s and the rest)."""
    ops, lens, done = [], [], 0
    while done < length:
        if rng.rand() < div:
            op = int(rng.choice([OP_X, OP_I, OP_D]))
            n = 1 if op == OP_X else int(rng.randint(1, 11))
        else:
            op, n = OP_M, int(rng.geometric(div))
        done += n
        while n > 255:
            ops.append(op)
            lens.append(255)
            n -= 255
        ops.append(op)
        lens.append(n)
    return _runs(ops, lens, lens_dtype)


def _expected(result):
    runs = result.cigar_runs
    if runs is not None:
        return runs_to_cigar_string(*runs)
    return cigar_bytes_to_string(result.cigar_bytes)


def _batch(case):
    rng = np.random.RandomState(7)
    if case == "empty_and_failed":
        return [AlignmentResult.failed(0, 1, False), _runs([], []), _bytes(b""),
                AlignmentResult.failed(1, 0, True)]
    if case == "zero_length_runs":
        return [_runs([OP_M, OP_X, OP_M], [5, 0, 3]), _runs([OP_X, OP_M], [0, 4]),
                _runs([OP_M, OP_I], [6, 0]), _runs([OP_D, OP_D], [0, 0]),
                _runs([OP_M, OP_X, OP_I, OP_M], [2, 0, 0, 9])]
    if case == "capped_splits":
        return [_runs([OP_M, OP_M], [255, 45]), _runs([OP_M] * 4 + [OP_X], [255, 255, 255, 1, 1]),
                _runs([OP_I, OP_I, OP_M, OP_M, OP_D], [255, 7, 255, 255, 3])]
    if case == "uint8_lens":
        return [_random_runs(rng, 5_000, 0.04, np.uint8) for _ in range(6)]
    if case == "int64_lens":
        return [_random_runs(rng, 5_000, 0.04, np.int64) for _ in range(6)]
    if case == "per_base_bytes":
        return [_bytes(b"MMMXXIIDDM"), _bytes(b"M" * 300 + b"X" + b"M" * 1000),
                _bytes(b"D"), _bytes(b"IIMMDDXX" * 40)]
    if case == "mixed":
        return (_batch("empty_and_failed")[:2] + _batch("zero_length_runs")[:2]
                + _batch("capped_splits") + _batch("per_base_bytes")[:2]
                + [_random_runs(rng, 2_000, 0.04, np.int64), _random_runs(rng, 2_000, 0.04)]
                + _batch("six_and_seven_digits"))
    if case == "one_record":
        return [_random_runs(rng, 5_000, 0.04)]
    if case == "six_and_seven_digits":
        return [_runs([OP_M], [100_000]), _runs([OP_M, OP_X, OP_M], [999_999, 1, 1_000_000]),
                _runs([OP_M] * 40, [255] * 40), _runs([OP_M, OP_M], [9_999, 1]),
                _runs([OP_I, OP_M], [10_000, 12_345_678])]
    if case == "unknown_ops":
        return [AlignmentResult(0, 1, 0, 0, 0, 0, False,
                                cigar_runs=(np.array([OP_M, 300, 300, -1, 0]),
                                            np.array([5, 1, 2, 2, 1]))),
                _runs([1, OP_M, 1], [2, 3, 4])]
    raise KeyError(case)


CASES = ["empty_and_failed", "zero_length_runs", "capped_splits", "uint8_lens", "int64_lens",
         "per_base_bytes", "mixed", "one_record", "six_and_seven_digits", "unknown_ops"]


@pytest.mark.parametrize("case", CASES)
def test_batch_matches_the_per_record_functions(case):
    batch = _batch(case)
    assert paf_text.cigar_texts(batch) == [_expected(r) for r in batch]


@pytest.mark.parametrize("length,div,n", [(2_000, 0.04, 64), (5_000, 0.04, 64),
                                          (100_000, 0.005, 6)])
@pytest.mark.parametrize("seed", [0, 2_147_483_711])
def test_seeded_random_runs(length, div, n, seed):
    rng = np.random.RandomState(seed % 2**32)
    batch = [_random_runs(rng, length, div, rng.choice([np.uint8, np.int32, np.int64]))
             for _ in range(n)]
    got = paf_text.cigar_texts(batch)
    assert got == [_expected(r) for r in batch]
    assert all(t.endswith(("=", "X", "I", "D")) for t in got)


def test_no_records():
    assert paf_text.cigar_texts([]) == []


def test_counters_count_batches_and_records():
    counters.reset()
    paf_text.cigar_texts(_batch("mixed"))
    paf_text.cigar_texts(_batch("one_record"))
    snap = counters.snapshot()
    assert (snap["paf_batches"], snap["paf_batched"]) == (2, len(_batch("mixed")) + 1)


def _sequences(n=6, length=40):
    rng = np.random.RandomState(3)
    return [Sequence(f"s{i}", bytes(rng.choice(list(b"ACGT"), length + i).astype(np.uint8)))
            for i in range(n)]


def test_line_is_core_paf_line_inside_and_outside_a_batch():
    seqs = _sequences()
    batch = _batch("mixed")
    for k, r in enumerate(batch):
        r.query_idx, r.target_idx = k % 6, (k + 1) % 6
        r.is_reverse = bool(k % 2)
        r.query_end, r.target_end = 30 + k, 33 - k % 5
        r.num_matches, r.alignment_length = 20 + k, (25 + 2 * k) * (k % 3 != 0)
    want = [core_paf.alignment_to_paf(r, seqs) for r in batch]
    assert [paf_text.alignment_to_paf(r, seqs) for r in batch] == want
    counters.reset()
    with paf_text.prepared(batch):
        assert [paf_text.alignment_to_paf(r, seqs) for r in batch] == want
    assert counters.snapshot()["paf_batched"] == len(batch)
    # the batch's text is dropped when the block ends
    assert paf_text._held.texts is None


# -- the CLI's writer ---------------------------------------------------------


def _mutate(rng, s, div):
    a = np.frombuffer(s, np.uint8).copy()
    mut = rng.rand(a.size) < div
    a[mut] = rng.choice(np.frombuffer(b"ACGT", np.uint8), int(mut.sum()))
    return a.tobytes()


def _write_fasta(path, n, length):
    """n sequences of `length` bp at 0.5% from one ancestor, every other
    one reverse complemented: match runs past the run buffers' cap of
    255, and both strands."""
    from allwave_tpu_torch.orient.orientation import reverse_complement

    rng = np.random.RandomState(11)
    base = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), length))
    with open(path, "w") as f:
        for i in range(n):
            s = _mutate(rng, base, 0.005)
            s = reverse_complement(s) if i % 2 else s
            f.write(f">s{i}\n{s.decode()}\n")
    return str(path)


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    """7 x 600 bp: 42 directed pairs."""
    return _write_fasta(tmp_path_factory.mktemp("paf_text") / "in.fa", 7, 600)


@pytest.fixture(scope="module")
def small_fasta(tmp_path_factory):
    """5 x 300 bp: 20 directed pairs, for --wfa-orientation, which
    aligns both strands of every pair on the CPU."""
    return _write_fasta(tmp_path_factory.mktemp("paf_text") / "small.fa", 5, 300)


def _per_base_every_third(monkeypatch):
    """Every third record reaches the writer with a per-base CIGAR in
    place of its runs, planted around `_emit_chunk` as the benchmark
    harness plants its faults."""
    emit = AllPairAligner.__dict__["_emit_chunk"]

    def planted(callback, chunk, revs, aligned, stats):
        seen = [0]

        def cb(result):
            seen[0] += 1
            if seen[0] % 3 == 0:
                result.cigar_bytes = result.cigar_bytes  # expands the runs
            callback(result)

        emit.__func__(cb, chunk, revs, aligned, stats)

    monkeypatch.setattr(AllPairAligner, "_emit_chunk", staticmethod(planted))


def _counted_cli(monkeypatch, chunk_size):
    """`cli.alignment_to_paf` wrapped as the benchmark harness wraps it;
    the aligner's chunks cut to `chunk_size` pairs. Returns the results
    the wrapper saw, in call order."""
    monkeypatch.setattr(cli, "AllPairAligner", functools.partial(AllPairAligner,
                                                                 chunk_size=chunk_size))
    to_paf = cli.alignment_to_paf
    state = {"t_end": float("inf"), "records": 0, "seen": []}

    def counted(result, sequences):
        line = to_paf(result, sequences)
        if time.perf_counter() <= state["t_end"]:
            state["records"] += 1
        state["seen"].append(result)
        return line

    monkeypatch.setattr(cli, "alignment_to_paf", counted)
    return state


@pytest.mark.parametrize("route", ["mash", "wfa", "per_base"])
def test_cli_file_is_core_paf_record_by_record(fasta, small_fasta, tmp_path, monkeypatch, route):
    """A job of several chunks: the file is `core/paf.py`'s lines of the
    records the writer handed to `cli.alignment_to_paf`, in its order,
    one call a record."""
    state = _counted_cli(monkeypatch, chunk_size=9)
    fa, flags = (small_fasta, ["--wfa-orientation"]) if route == "wfa" else (fasta, [])
    if route == "per_base":
        _per_base_every_third(monkeypatch)
    out = tmp_path / "out.paf"
    counters.reset()
    with redirect_stderr(io.StringIO()):
        assert cli.main(["-i", fa, "-o", str(out), "-p", "none", "--no-progress", *flags]) == 0
    seqs = read_fasta(fa)
    lines = out.read_text().splitlines(keepends=True)
    assert len(lines) == len(seqs) * (len(seqs) - 1)  # at least three chunks
    assert state["records"] == len(state["seen"]) == len(lines)
    assert len({id(r) for r in state["seen"]}) == len(lines)
    assert lines == [core_paf.alignment_to_paf(r, seqs) + "\n" for r in state["seen"]]
    assert any(ln.split("\t")[4] == "-" for ln in lines)
    runs = [r.cigar_runs for r in state["seen"]]
    per_base = sum(x is None for x in runs)
    assert per_base == (len(lines) // 3 if route == "per_base" else 0)
    # 255-capped runs that the pass merged
    assert any((x[0][:-1] == x[0][1:]).any() for x in runs if x is not None)
    snap = counters.snapshot()
    assert snap["paf_batched"] == len(lines)
    assert 1 <= snap["paf_batches"] <= len(lines)


class _BrokenOut(io.StringIO):
    def write(self, s):
        raise OSError("no space left on device")


@pytest.mark.parametrize("chunk_size", [4, 4096])
def test_writer_error_surfaces_from_main(fasta, monkeypatch, chunk_size):
    state = _counted_cli(monkeypatch, chunk_size)
    with redirect_stdout(_BrokenOut()), redirect_stderr(io.StringIO()):
        with pytest.raises(OSError, match="no space left"):
            cli.main(["-i", fasta, "-p", "none", "--no-progress"])
    assert state["seen"]  # the writer made lines before the write failed
