"""A whole run at a tiny size on the CPU, past the look for a card:
sound, it comes out correct; with the timed path broken underneath, or
with either control in the program's place, `correct` comes out false."""

import io
import json
import os
import time
import types

import pytest

os.environ.setdefault("ALLWAVE_PLATFORM", "cpu")

from gpubench import harness, spec  # noqa: E402

BENCH = spec.load_benchmark()


def _cell(**over):
    params = {"n_sequences": 5, "length": 300, "scores": "0,5,8,2", "orientation": "mash",
              "sparsification": "none", "snp_rate": 0.02, "insertion_rate": 0.01,
              "deletion_rate": 0.01, "max_indel": 10, "reverse_fraction": 0.5, "id_prefix": "s",
              "pool_jobs": 2, "check": {"jobs": 1, "pairs": 20, "batch": 20}}
    params.update(over)
    return types.SimpleNamespace(name="tiny", chips=1, params=params,
                                 end_to_end=BENCH["end_to_end"], per_layer=BENCH["per_layer"])


def _run(cell, **kw):
    out, log = io.StringIO(), io.StringIO()
    r = harness.execute(cell, 2**31 + 99, 0.5, False, time.perf_counter(), device="cpu",
                        out=out, log=log, **kw)
    lines = out.getvalue().strip().splitlines()
    assert json.loads(lines[-1]) == r
    assert list(r)[-1] == "checks"
    assert log.getvalue().strip().splitlines()[-1].startswith("check line_diff ")
    return r


def test_sound_run_is_correct():
    r = _run(_cell())
    assert r["correct"] is True and r["failed"] == 0
    assert set(r["metrics"]) == {"aln_per_s", "setup_s"}
    assert all(v["value"] == 0 for v in r["checks"].values())


def test_window_counts_the_records_written_before_it_closes():
    """Every record of a job that ended inside the window counts, and of
    the job running at its close only those written before it."""
    out, log = io.StringIO(), io.StringIO()
    cell = _cell()
    harness.execute(cell, 2**31 + 7, 3.0, False, time.perf_counter(), device="cpu", out=out, log=log)
    first = json.loads(out.getvalue().splitlines()[0])
    per_job = 5 * 4
    done = first["jobs_completed"]
    assert done >= 1 and first["jobs_run"] == done + 1
    assert per_job * done <= first["records_in_window"] <= per_job * (done + 1)


@pytest.mark.parametrize("fault,number", [
    ("drop_half", "pairs_missing"),   # half of each batch left out
    ("alter", "cigar_diff"),          # an answer altered where it is produced
    ("alter", "records_invalid"),     # ... and its CIGAR no longer walks the bases
    ("strand", "strand_diff"),        # a strand flipped where it is produced
    ("no_output", "pairs_missing"),   # a job that returns with nothing done
    ("duplicate", "pairs_extra"),     # a record written twice
    ("crash", "jobs_failed"),         # a job that dies
])
def test_fault_comes_out_incorrect(fault, number):
    r = _run(_cell(), fault=fault)
    assert r["correct"] is False
    assert r["checks"][number]["value"] > 0


@pytest.mark.parametrize("control,number", [
    ("band", "score_diff"),      # a fixed band: paths that leave it score worse
    ("tiebreak", "cigar_diff"),  # the tie order flipped: optimal, not canonical
])
def test_control_comes_out_incorrect(control, number):
    """A control, the reference with one guarantee broken, in the
    program's place."""
    r = _run(_cell(n_sequences=6, length=600, insertion_rate=0.02, deletion_rate=0.02,
                   check={"jobs": 1, "pairs": 30, "batch": 30}), control=control)
    assert r["correct"] is False
    assert r["checks"][number]["value"] > 0
    assert r["checks"]["pairs_missing"]["value"] == r["checks"]["strand_diff"]["value"] == 0
    assert r["checks"]["records_invalid"]["value"] == 0
    if control == "tiebreak":
        assert r["checks"]["score_diff"]["value"] == 0


@pytest.mark.parametrize("form", ["runs", "bytes"])
def test_alter_reaches_both_cigar_forms(form):
    """The dense engine hands back CIGAR runs, the long-pair engines
    per-base bytes: the planted alteration changes either."""
    import numpy as np

    from allwave_tpu_torch.core.paf import alignment_to_paf
    from allwave_tpu_torch.core.types import AlignmentResult, Sequence

    ops = np.array([ord("M"), ord("X"), ord("M")], np.uint8)
    lens = np.array([3, 1, 5], np.int64)
    kw = {"cigar_runs": (ops, lens)} if form == "runs" else {"cigar_bytes": np.repeat(ops, lens)}
    res = AlignmentResult(query_idx=0, target_idx=1, query_start=0, query_end=9, target_start=0,
                          target_end=9, is_reverse=False, score=5, num_matches=8,
                          alignment_length=9, **kw)
    seqs = [Sequence("a", b"A" * 9), Sequence("b", b"A" * 9)]
    before = alignment_to_paf(res, seqs)
    harness._alter(res)
    after = alignment_to_paf(res, seqs)
    assert before.endswith("cg:Z:3=1X5=") and after.endswith("cg:Z:3=1X4=1X")


def test_readings_hold_the_program_and_the_controls_apart():
    """The readings the limits are set from: the program reads 0 on
    every number, each control and a planted fault read above it."""
    out, log = io.StringIO(), io.StringIO()
    cell = _cell(n_sequences=6, length=600, insertion_rate=0.02, deletion_rate=0.02,
                 check={"jobs": 1, "pairs": 30, "batch": 30})
    line = harness.readings(cell, 2**31 + 99, time.perf_counter(), device="cpu",
                            faults=["drop_half"], out=out, log=log)
    got = line["readings"]
    assert json.loads(out.getvalue().splitlines()[-1]) == line
    assert not any(got["program"].values())
    assert got["control_band"]["score_diff"] > 0
    assert got["control_tiebreak"]["cigar_diff"] > 0 and got["control_tiebreak"]["score_diff"] == 0
    assert got["drop_half"]["pairs_missing"] > 0
