"""What a run imports: no JAX and no JAX package anywhere in the
benchmark, and nothing of the program in its reference."""

import ast
import os
import subprocess
import sys

from portbench import manifest
from portbench.run import FORBIDDEN

HERE = manifest.HERE


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def _sources(sub=""):
    for d, _, files in os.walk(os.path.join(HERE, sub)):
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def test_no_jax_in_sources():
    for path in _sources():
        assert not set(_imports(path)) & set(FORBIDDEN), path


def test_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        assert "deepblast_torch" not in set(_imports(path)), path


def test_every_cell_imports_no_jax():
    """Every module a run of each cell loads, in a fresh process."""
    code = """
import sys
from portbench import manifest, run, calibrate
bench = manifest.load()
for w in bench["workloads"]:
    manifest.load_module("drivers", manifest.mix(w["traffic"])["entry"])
for m in bench["per_layer"]:
    manifest.load_module("metrics", m["name"])
import deepblast_torch.train.trainer, deepblast_torch.ops.dp
bad = {m.split(".")[0] for m in sys.modules} & set(run.FORBIDDEN)
print(sorted(bad))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=manifest.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
