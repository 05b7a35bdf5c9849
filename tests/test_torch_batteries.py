"""Port twins of two batteries of the reference's tests:

* tests/test_cli_prefix_battery.py: the port's CLI (`cli.main`,
  in-process, on the CPU) with the same fixtures, flag spellings (long
  and short), record counts, whitespace trimming of prefix lists and
  stderr contract ("Kept/Excluded sequences with prefixes: N -> M", "No
  sequences match...", "All sequences were excluded...");
* tests/test_orientation_battery.py: the port's MinHash and WFA
  orientation on its 8 constructed cases, which must agree with each
  other and with the construction.
"""

import io
import os
from contextlib import redirect_stderr, redirect_stdout
from types import SimpleNamespace

import pytest

from allwave_tpu_torch import cli
from allwave_tpu_torch.core.types import AlignmentParams
from allwave_tpu_torch.orient.orientation import determine_orientation_mash
from allwave_tpu_torch.wfa.simple import _determine_orientation_wfa
from tests.test_cli_prefix_battery import EIGHT, SIX, _ids, _write
from tests.test_orientation_battery import _cases


def run_cli(args, check=True):
    """The port's cli.main in-process on the CPU: returncode, stdout, stderr."""
    out, err = io.StringIO(), io.StringIO()
    old = os.environ.get("ALLWAVE_PLATFORM")
    os.environ["ALLWAVE_PLATFORM"] = "cpu"
    try:
        with redirect_stdout(out), redirect_stderr(err):
            try:
                rc = cli.main([str(a) for a in args])
            except SystemExit as e:
                rc = e.code if isinstance(e.code, int) else (0 if e.code is None else 1)
    finally:
        if old is None:
            os.environ.pop("ALLWAVE_PLATFORM", None)
        else:
            os.environ["ALLWAVE_PLATFORM"] = old
    proc = SimpleNamespace(returncode=rc, stdout=out.getvalue(), stderr=err.getvalue())
    if check:
        assert rc == 0, f"CLI failed rc={rc}\nstderr:\n{proc.stderr}"
    return proc


class TestKeepPrefixes:
    def test_single_prefix_long_form(self, tmp_path):
        fa = _write(tmp_path, SIX)
        pairs = _ids(run_cli(["--input", fa, "--keep-prefixes", "human", "-p", "none"]).stdout)
        assert len(pairs) == 2  # human_seq1<->human_seq2, both directions
        assert all(q.startswith("human") and t.startswith("human") for q, t in pairs)

    def test_multiple_prefixes_short_form(self, tmp_path):
        fa = _write(tmp_path, SIX)
        pairs = _ids(run_cli(["--input", fa, "-k", "human,mouse", "-p", "none"]).stdout)
        assert len(pairs) == 12  # 4 seqs x 3 others, directed
        ok = ("human", "mouse")
        assert all(q.startswith(ok) and t.startswith(ok) for q, t in pairs)

    def test_non_matching_prefix_fails(self, tmp_path):
        fa = _write(tmp_path, SIX)
        proc = run_cli(["--input", fa, "-k", "virus", "-p", "none"], check=False)
        assert proc.returncode != 0
        assert "No sequences match the specified keep prefixes" in proc.stderr

    def test_whitespace_trimmed(self, tmp_path):
        fa = _write(tmp_path, SIX)
        proc = run_cli(["--input", fa, "--keep-prefixes", " human , mouse ", "-p", "none"])
        assert len(_ids(proc.stdout)) == 12


class TestExcludePrefixes:
    def test_exclude_single(self, tmp_path):
        fa = _write(tmp_path, SIX)
        pairs = _ids(run_cli(["--input", fa, "--exclude-prefixes", "human", "-p", "none"]).stdout)
        assert len(pairs) == 12  # 4 remaining seqs, directed
        assert all(not q.startswith("human") and not t.startswith("human") for q, t in pairs)

    def test_exclude_multiple_short_form(self, tmp_path):
        fa = _write(tmp_path, SIX)
        pairs = _ids(run_cli(["--input", fa, "-e", "human,mouse", "-p", "none"]).stdout)
        assert len(pairs) == 2  # plant_seq1 <-> bacteria_seq
        ok = ("plant", "bacteria")
        assert all(q.startswith(ok) and t.startswith(ok) for q, t in pairs)

    def test_exclude_all_fails(self, tmp_path):
        fa = _write(tmp_path, SIX)
        proc = run_cli(["--input", fa, "-e", "human,mouse,plant,bacteria", "-p", "none"],
                       check=False)
        assert proc.returncode != 0
        assert "All sequences were excluded" in proc.stderr

    def test_exclude_whitespace_trimmed(self, tmp_path):
        fa = _write(tmp_path, SIX)
        proc = run_cli(["--input", fa, "--exclude-prefixes", " human , mouse ", "-p", "none"])
        assert len(_ids(proc.stdout)) == 2


class TestWithSparsification:
    def test_keep_with_giant(self, tmp_path):
        fa = _write(tmp_path, EIGHT)
        proc = run_cli(["--input", fa, "-k", "group_A", "-p", "giant:0.99"])
        assert "Kept sequences with prefixes: 8 -> 3" in proc.stderr
        pairs = _ids(proc.stdout)
        assert pairs
        assert all(q.startswith("group_A") and t.startswith("group_A") for q, t in pairs)

    def test_exclude_with_giant(self, tmp_path):
        fa = _write(tmp_path, EIGHT)
        proc = run_cli(["--input", fa, "--exclude-prefixes", "group_B,other", "-p", "giant:0.99"])
        assert "Excluded sequences with prefixes: 8 -> 3" in proc.stderr
        pairs = _ids(proc.stdout)
        assert pairs
        assert all(q.startswith("group_A") and t.startswith("group_A") for q, t in pairs)


@pytest.mark.parametrize("name,reference,query,expected_reverse", _cases(),
                         ids=[c[0] for c in _cases()])
def test_orientation_detection_comparison(name, reference, query, expected_reverse):
    _, mash_rev = determine_orientation_mash(query, reference)
    _, wfa_rev = _determine_orientation_wfa(query, reference, AlignmentParams.edit_distance())
    assert mash_rev == wfa_rev, f"methods disagree for {name}"
    assert mash_rev == expected_reverse, f"mash wrong for {name}"
    assert wfa_rev == expected_reverse, f"wfa wrong for {name}"
