"""The PyTorch port carries its own copies of the reference's JAX-free
modules: importing anything under allwave_tpu runs allwave_tpu/__init__.py,
which imports orient/orientation.py and with it jax, and the machine
with the GPU has no jax. These tests keep the copies byte-identical to
their reference files, so they cannot drift, and check that the port
imports with jax blocked."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

COPIES = [
    "core/__init__.py",
    "core/types.py",
    "core/cigar.py",
    "core/paf.py",
    "core/scores.py",
    "hashing/__init__.py",
    "hashing/siphash.py",
    "engine/__init__.py",
    "engine/fasta.py",
    "engine/progress.py",
    "native.py",
    "utils/__init__.py",
    "utils/telemetry.py",
    "wfa/__init__.py",
    "wfa/params.py",
    "wfa/reference_impl.py",
    "sparsify/__init__.py",
    "sparsify/pairs.py",
    "sparsify/knn.py",
    "sparsify/nj.py",
    "testing/__init__.py",
    "testing/synth.py",
    "testing/dense.py",
    "orient/__init__.py",
    "sketch/__init__.py",
]


@pytest.mark.parametrize("rel", COPIES)
def test_copy_is_byte_identical(rel):
    with open(os.path.join(REPO, "allwave_tpu", rel), "rb") as f:
        ref = f.read()
    with open(os.path.join(REPO, "allwave_tpu_torch", rel), "rb") as f:
        port = f.read()
    assert port == ref, f"allwave_tpu_torch/{rel} drifted from allwave_tpu/{rel}"


def test_native_resolves_to_repo_csrc():
    from allwave_tpu import native as ref
    from allwave_tpu_torch import native as port

    assert port._CSRC == ref._CSRC == os.path.join(REPO, "csrc")


def test_minhash_is_the_reference_minus_device_code():
    """sketch/minhash.py: every line of the port's copy outside its
    docstring appears in the reference, and the host functions agree."""
    import numpy as np

    from allwave_tpu.core.types import Sequence as RSeq
    from allwave_tpu.sketch import minhash as R
    from allwave_tpu_torch.core.types import Sequence as TSeq
    from allwave_tpu_torch.sketch import minhash as T

    with open(os.path.join(REPO, "allwave_tpu", "sketch", "minhash.py")) as f:
        ref_lines = set(f.read().splitlines())
    with open(os.path.join(REPO, "allwave_tpu_torch", "sketch", "minhash.py")) as f:
        port_src = f.read()
    body = port_src.split('"""', 2)[2]
    assert all(line in ref_lines for line in body.splitlines())
    assert "jax" not in body

    rng = np.random.RandomState(3)
    seqs = [rng.choice(list(b"ACGT"), 300).astype(np.uint8).tobytes() for _ in range(6)]
    rm = R.compute_distance_matrix_with_params([RSeq(f"s{i}", s) for i, s in enumerate(seqs)])
    tm = T.compute_distance_matrix_with_params([TSeq(f"s{i}", s) for i, s in enumerate(seqs)])
    np.testing.assert_array_equal(rm, tm)


def test_imports_with_jax_blocked():
    """Every module of the port imports in a process where jax cannot
    be imported, and pulls in nothing of the JAX package."""
    modules = [
        "allwave_tpu_torch",
        "allwave_tpu_torch.cli",
        "allwave_tpu_torch.engine.pipeline",
        "allwave_tpu_torch.wfa.dense_engine",
        "allwave_tpu_torch.wfa.cuda_build",
        "allwave_tpu_torch.sparsify.knn",
        "allwave_tpu_torch.testing.dense",
    ]
    code = (
        "import sys; sys.modules['jax'] = None\n"
        + "".join(f"import {m}\n" for m in modules)
        + "assert not any(m == 'jax' or m.startswith('jax.') or "
        "m.startswith('allwave_tpu.') for m in sys.modules if sys.modules[m])\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr


def test_no_jax_import_in_port_sources():
    for root, _, files in os.walk(os.path.join(REPO, "allwave_tpu_torch")):
        for name in files:
            if not name.endswith(".py"):
                continue
            with open(os.path.join(root, name)) as f:
                for line in f:
                    s = line.strip()
                    assert not s.startswith(("import jax", "from jax")), (name, s)
