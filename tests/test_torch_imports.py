"""The port stands alone: no module of ``src/repro_torch`` and nothing in
``chip_smoke.py`` imports JAX or the reference package ``repro``.

Every ``.py`` file is parsed with ``ast`` and every ``import`` /
``from ... import`` statement checked, wherever it sits (module level or
inside a function), so a lazy import cannot slip past a grep of the first
column.
"""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro") or top.startswith("jax")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


def test_the_scan_sees_the_port():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert "src/repro_torch/labelstream/router.py" in names
    assert "src/repro_torch/obs/export.py" in names
    for mod in ("grid/engine.py", "grid/__main__.py", "core/clamshell.py",
                "core/events.py", "core/lifeguard.py", "core/maintenance.py",
                "core/workers.py", "learning/compat.py",
                "serving/scheduler.py", "distributed/elastic.py"):
        assert f"src/repro_torch/{mod}" in names, mod
    assert "chip_smoke.py" in names
    assert len(FILES) > 50


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_reference_import(path):
    bad = [f"{path.relative_to(ROOT)}:{line} imports {mod}"
           for line, mod in _imports(path) if _forbidden(mod)]
    assert not bad, bad


def test_the_rule_catches_what_it_should():
    for mod in ("jax", "jax.numpy", "jaxlib.xla_client", "repro",
                "repro.obs.trace", "repro.labelstream"):
        assert _forbidden(mod), mod
    for mod in ("repro_torch", "repro_torch.obs", "torch", "numpy"):
        assert not _forbidden(mod), mod


def _modules(pkg: str) -> set:
    base = ROOT / "src" / pkg
    return {p.relative_to(base).as_posix() for p in base.rglob("*.py")}


def test_the_port_mirrors_the_reference_module_for_module():
    """The port's module files are the reference's, save the one with no
    torch meaning (``launch/hlo_analysis.py`` parses XLA HLO text) and the
    port's own additions: package ``__init__.py`` files, ``device.py``,
    the kernel build module ``kernels/_build.py`` and the in-order sum
    kernel's wrapper ``kernels/ordered_sum.py`` (it replaces no TPU kernel:
    the reference leaves those sums to XLA)."""
    ref, port = _modules("repro"), _modules("repro_torch")
    inits = lambda mods: {m for m in mods if m.endswith("__init__.py")}
    assert ref - inits(ref) - {"launch/hlo_analysis.py"} == \
        port - inits(port) - {"device.py", "kernels/_build.py",
                              "kernels/ordered_sum.py"}
    assert "launch/dryrun.py" in port and "configs/xlstm_125m.py" in port
