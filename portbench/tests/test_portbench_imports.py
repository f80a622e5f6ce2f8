"""No module of the benchmark imports JAX, the JAX package ``repro`` or
the JAX package's harness ``benchmarks``, comparing each import's
top-level name whole (``repro_torch`` begins with ``repro`` and is not
it); the plain references also import nothing of the program."""
from __future__ import annotations

import ast
from pathlib import Path

import pytest

from portbench.harness.card import FORBIDDEN_MODULES

HERE = Path(__file__).resolve().parents[1]
FILES = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)


def imported_tops(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".", 1)[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".", 1)[0]


def test_files_found():
    assert len(FILES) > 20


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(
    HERE)))
def test_no_jax_nor_the_jax_package(path):
    bad = set(imported_tops(path)) & set(FORBIDDEN_MODULES)
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    tops = set(imported_tops(path))
    assert tops <= {"__future__", "math", "torch", "numpy"}, tops


def test_top_level_names_compared_whole():
    import sys
    import types
    from portbench.harness.card import forbidden_modules
    sys.modules["repro_torch_probe"] = types.ModuleType("repro_torch_probe")
    try:
        assert forbidden_modules() == []
        sys.modules["repro.probe"] = types.ModuleType("repro.probe")
        assert forbidden_modules() == ["repro"]
    finally:
        sys.modules.pop("repro_torch_probe", None)
        sys.modules.pop("repro.probe", None)
