"""Nothing the benchmark runs imports JAX or the JAX package. Modules are
compared by their whole top-level name: `allwave_tpu_torch` begins with
`allwave_tpu` and is the program under test."""

import ast
import os
import subprocess
import sys

import pytest

from gpubench import harness, spec

FORBIDDEN = {"jax", "jaxlib", "flax", "allwave_tpu"}


@pytest.mark.parametrize("mods,bad", [
    (["jax"], ["jax"]),
    (["jax.numpy", "numpy"], ["jax.numpy"]),
    (["jaxlib.xla_client"], ["jaxlib.xla_client"]),
    (["flax.linen"], ["flax.linen"]),
    (["allwave_tpu"], ["allwave_tpu"]),
    (["allwave_tpu.wfa.dense"], ["allwave_tpu.wfa.dense"]),
    (["allwave_tpu_torch", "allwave_tpu_torch.cli", "jaxtyping", "flaxen"], []),
])
def test_check_compares_whole_top_level_names(mods, bad):
    assert harness.forbidden_modules(mods) == bad


def _sources():
    for dirpath, _, files in os.walk(spec.HERE):
        if os.sep + "tests" in dirpath[len(spec.HERE):]:
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, spec.HERE))
def test_no_source_imports_jax(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names = [node.module]
        for n in names:
            assert n.split(".")[0] not in FORBIDDEN, (path, n)


def test_reference_imports_nothing_of_the_program():
    """The plain reference uses NumPy, PyTorch and its own modules only."""
    allowed = {"__future__", "dataclasses", "math", "typing", "numpy", "torch"}
    ref = os.path.join(spec.HERE, "reference")
    for f in sorted(os.listdir(ref)):
        if not f.endswith(".py"):
            continue
        with open(os.path.join(ref, f)) as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                assert {a.name.split(".")[0] for a in node.names} <= allowed, (f, ast.dump(node))
            elif isinstance(node, ast.ImportFrom):
                assert node.level == 1 or node.module.split(".")[0] in allowed, (f, node.module)


def test_harness_loads_no_jax(tmp_path):
    """Importing the harness and the program, with jax unimportable."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'allwave_tpu'):\n"
        "            raise ImportError('blocked ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "from gpubench import harness, judge, leastwork, trace\n"
        "import allwave_tpu_torch.cli\n"
        "print(harness.forbidden_modules())\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
