"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference imports nothing of the program.  Module names are compared by
their top-level name (before the first dot) as a whole: the port's name
begins with the JAX package's."""

from __future__ import annotations

import ast
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "tpu3dtk"}
SOURCES = sorted((ROOT / "slambench").rglob("*.py"))


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_source_imports_jax_or_the_jax_package():
    found = {(p.name, m) for p in SOURCES for m in _imports(p) if m in FORBIDDEN}
    assert not found


def test_reference_imports_nothing_of_the_program():
    ref = [p for p in SOURCES if p.parent.name == "reference"]
    assert ref and not {(p.name, m) for p in ref for m in _imports(p) if m in FORBIDDEN | {"tpu3dtk_torch"}}


def test_a_run_loads_neither():
    code = (
        "import sys, time; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
        "from conftest import tiny_cell\n"
        "from slambench import harness\n"
        "harness.run_cell(tiny_cell('city-seq'), 3, 0.1, False, 'cpu', time.perf_counter(), log=lambda *a: None)\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
    ) % (str(ROOT), str(ROOT / "slambench" / "tests"))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    top = set(eval(p.stdout.strip().splitlines()[-1]))
    assert "tpu3dtk_torch" in top and not top & FORBIDDEN
