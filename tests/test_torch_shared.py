"""The PyTorch port carries its own copies of the reference's JAX-free
modules: importing anything under allwave_tpu runs allwave_tpu/__init__.py,
which imports orient/orientation.py and with it jax, and the machine
with the GPU has no jax. These tests keep the copies byte-identical to
their reference files, so they cannot drift, and check that the port
imports with jax blocked."""

import ast
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
    "parallel/__init__.py",
    "wfa/simple.py",
    "validation.py",
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


def _port_only_lines(src: str, device_defs):
    """Line numbers of the port's own code in a copy of a reference
    module: the module docstring; imports of torch and of the port's
    `device`, `device_sketch`, `membership` and `telemetry` modules; the
    functions named in `device_defs`; the gate (the assignments to
    `device` and `use_device`, and of the `if use_device:` statement
    its header and its body, not
    its `else` branch, which is the reference's host routing); route
    counts (`*_routes.took(...)`); the `device` argument and
    `self.device` attribute; and the header of each `with` over the
    port's spans (`counters.span(...)`, `self._route(...)`). A run of
    comment lines directly above one of these belongs to it. Also, by
    line number, the indentation such a `with` adds to its body, which
    is the reference's code."""
    tree = ast.parse(src)
    spans = []
    dedent = {}
    body = tree.body
    if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
        spans.append((body[0].lineno, body[0].end_lineno))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import) and [a.name for a in node.names] == ["torch"]:
            spans.append((node.lineno, node.end_lineno))
        elif isinstance(node, ast.ImportFrom) and (node.module or "").split(".")[-1] in (
            "device", "device_sketch", "membership", "telemetry"
        ):
            spans.append((node.lineno, node.end_lineno))
        elif isinstance(node, ast.FunctionDef) and node.name in device_defs:
            spans.append((node.lineno, node.end_lineno))
        elif isinstance(node, ast.Assign) and any(
            (isinstance(t, ast.Name) and t.id in ("use_device", "device"))
            or (isinstance(t, ast.Attribute) and t.attr == "device")
            for t in node.targets
        ):
            spans.append((node.lineno, node.end_lineno))
        elif isinstance(node, ast.If) and isinstance(node.test, ast.Name) and (
            node.test.id == "use_device"
        ):
            spans.append((node.lineno, node.body[-1].end_lineno))
        elif (
            isinstance(node, ast.Expr)
            and isinstance(node.value, ast.Call)
            and isinstance(node.value.func, ast.Attribute)
            and node.value.func.attr == "took"
            and isinstance(node.value.func.value, ast.Name)
            and node.value.func.value.id.endswith("_routes")
        ):
            spans.append((node.lineno, node.end_lineno))
        elif isinstance(node, ast.arg) and node.arg == "device":
            spans.append((node.lineno, node.end_lineno))
        elif isinstance(node, ast.With) and all(
            isinstance(it.context_expr, ast.Call)
            and isinstance(it.context_expr.func, ast.Attribute)
            and it.context_expr.func.attr in ("span", "_route")
            for it in node.items
        ):
            spans.append((node.lineno, node.body[0].lineno - 1))
            for no in range(node.body[0].lineno, node.end_lineno + 1):
                dedent[no] = dedent.get(no, 0) + node.body[0].col_offset - node.col_offset
    lines = src.splitlines()
    out = set()
    for first, last in spans:
        while first > 1 and lines[first - 2].strip().startswith("#"):
            first -= 1
        out.update(range(first, last + 1))
    return out, dedent


def _assert_reference_minus_device_code(rel: str, device_defs) -> str:
    with open(os.path.join(REPO, "allwave_tpu", rel)) as f:
        ref_lines = set(f.read().splitlines())
    with open(os.path.join(REPO, "allwave_tpu_torch", rel)) as f:
        port_src = f.read()
    skip, dedent = _port_only_lines(port_src, device_defs)
    for name in device_defs:
        assert f"def {name}(" in port_src, name
    host = []
    for no, line in enumerate(port_src.splitlines(), 1):
        if no in skip:
            continue
        w = dedent.get(no, 0)
        assert not line[:w].strip(), (no, line)
        host.append((no, line[w:]))
    stray = [(no, line) for no, line in host if line not in ref_lines]
    assert not stray, f"allwave_tpu_torch/{rel}: lines not in the reference: {stray}"
    assert "jax" not in port_src.split('"""', 2)[2]
    return port_src


def test_minhash_is_the_reference_minus_device_code():
    """sketch/minhash.py: every line of the port's copy outside its
    docstring and its torch device code (`_intersection_counts_device`
    and the gate in `pairwise_intersection_counts`) appears in the
    reference, and the host functions agree."""
    import numpy as np

    from allwave_tpu.core.types import Sequence as RSeq
    from allwave_tpu.sketch import minhash as R
    from allwave_tpu_torch.core.types import Sequence as TSeq
    from allwave_tpu_torch.sketch import minhash as T

    _assert_reference_minus_device_code(
        "sketch/minhash.py", ("_intersection_counts_device",)
    )

    rng = np.random.RandomState(3)
    seqs = [rng.choice(list(b"ACGT"), 300).astype(np.uint8).tobytes() for _ in range(6)]
    rm = R.compute_distance_matrix_with_params([RSeq(f"s{i}", s) for i, s in enumerate(seqs)])
    tm = T.compute_distance_matrix_with_params([TSeq(f"s{i}", s) for i, s in enumerate(seqs)])
    np.testing.assert_array_equal(rm, tm)


def test_orientation_is_the_reference_minus_device_code():
    """orient/orientation.py: every line of the port's copy outside its
    torch device code (`_decision_matrix_device`, `_decide_device`, the
    gate in `orient_batch`, the route counts and the index's device) and
    its spans (`_route` and the `with` headers that open them, their
    bodies read at the reference's indentation) appears in the
    reference, and the host paths agree."""
    import numpy as np

    from allwave_tpu.core.types import Sequence as RSeq
    from allwave_tpu.orient.orientation import OrientationIndex as RIdx
    from allwave_tpu_torch.core.types import Sequence as TSeq
    from allwave_tpu_torch.orient.orientation import OrientationIndex as TIdx

    _assert_reference_minus_device_code(
        "orient/orientation.py", ("_decision_matrix_device", "_decide_device", "_route")
    )

    rng = np.random.RandomState(4)
    seqs = [rng.choice(list(b"ACGT"), 300).astype(np.uint8).tobytes() for _ in range(7)]
    seqs[2] = seqs[1][::-1]
    r = RIdx([RSeq(f"s{i}", s) for i, s in enumerate(seqs)])
    t = TIdx([TSeq(f"s{i}", s) for i, s in enumerate(seqs)], device="cpu")
    np.testing.assert_array_equal(r._decision_matrix(), t._decision_matrix())
    np.testing.assert_array_equal(r._distances, t._distances)
    idx = [(0, 3), (5, 1), (2, 6)]
    np.testing.assert_array_equal(r.orient_batch(idx), t.orient_batch(idx))


def test_imports_with_jax_blocked():
    """Every module of the port imports in a process where jax cannot
    be imported, and pulls in nothing of the JAX package."""
    modules = [
        "allwave_tpu_torch",
        "allwave_tpu_torch.cli",
        "allwave_tpu_torch.engine.pipeline",
        "allwave_tpu_torch.wfa.dense_engine",
        "allwave_tpu_torch.wfa.engine",
        "allwave_tpu_torch.wfa.rounds",
        "allwave_tpu_torch.wfa.batch",
        "allwave_tpu_torch.wfa.cuda_build",
        "allwave_tpu_torch.wfa.wf_segmented",
        "allwave_tpu_torch.testing.batches",
        "allwave_tpu_torch.sparsify.knn",
        "allwave_tpu_torch.testing.dense",
        "allwave_tpu_torch.wfa.simple",
        "allwave_tpu_torch.validation",
        "allwave_tpu_torch.sketch.membership",
        "allwave_tpu_torch.parallel.mesh",
        "allwave_tpu_torch.parallel.dist",
        "allwave_tpu_torch.parallel.check",
        "allwave_tpu_torch.orient.orientation",
        "allwave_tpu_torch.fuzz",
        "allwave_tpu_torch.testing.fuzzgen",
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
