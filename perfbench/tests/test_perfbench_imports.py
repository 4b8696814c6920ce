"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole: ``repro_torch`` is not ``repro``), and the plain
references import nothing of the program either."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
MODULES = sorted(BENCH.rglob("*.py"))


def _imports(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", MODULES,
                         ids=[str(p.relative_to(BENCH)) for p in MODULES])
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not _imports(path) & FORBIDDEN


@pytest.mark.parametrize(
    "path", [p for p in MODULES if "reference" in p.parts],
    ids=[str(p.relative_to(BENCH)) for p in MODULES
         if "reference" in p.parts])
def test_the_references_import_nothing_of_the_program(path):
    tops = _imports(path)
    assert "repro_torch" not in tops
    assert tops <= {"__future__", "contextlib", "dataclasses", "math",
                    "time", "typing", "numpy", "torch", "perfbench"}


def test_the_whole_scan_covers_the_harness_and_the_readers():
    names = {str(p.relative_to(BENCH)) for p in MODULES}
    assert {"run.py", "harness.py", "reference/granite.py",
            "metrics/encode_mfu.py"} <= names
