"""No module the benchmark runs imports JAX, the JAX package (top-level
names compared whole: ``repro_torch`` begins with ``repro``) or networkx,
and the reference imports nothing of the program."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

from spgemm_bench.tests.conftest import ROOT

BENCH = ROOT / "spgemm_bench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "networkx"}
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


def _imports(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not _imports(path) & FORBIDDEN


@pytest.mark.parametrize("name", ["reference.py", "roofline.py", "instance.py"])
def test_the_yardstick_imports_nothing_of_the_program(name):
    assert _imports(BENCH / name) <= {"__future__", "dataclasses", "numpy", "scipy"}


def test_a_run_loads_no_module_of_jax_or_the_jax_package():
    code = (
        "import sys, time, torch\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from spgemm_bench.spec import Spec, add_program_path\n"
        "add_program_path()\n"
        "from spgemm_bench.harness import run_cell\n"
        "from spgemm_bench.tests.conftest import tiny\n"
        "spec = Spec()\n"
        "for w in spec.data['workloads']:\n"
        "    run_cell(w['name'], 3, 0.2, True, torch.device('cpu'), time.perf_counter(),\n"
        "             spec, tiny(spec, w['name']))\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    loaded = set(eval(proc.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in loaded
    assert not loaded & FORBIDDEN
