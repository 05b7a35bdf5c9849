"""One short run of each cell through the command line, on the card.
Marked `cuda`: it skips without one (run with `-m cuda` on a machine
that has one)."""

import json
import subprocess
import sys

import pytest

from gpubench import spec

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run([sys.executable, "gpubench/run.py", "--workload", cell, "--seed", "2147483711",
                          "--seconds", "3", "--trace", "0"], cwd=spec.ROOT, capture_output=True,
                         text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"
