"""Nothing the benchmark runs imports JAX or the JAX package (top-level
names compared whole: ``repro_torch`` is not ``repro``), and the
reference imports nothing of the program."""
import ast
import sys

import pytest

import run
from conftest import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def top_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_anywhere(path):
    assert not set(top_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "repro_torch" not in set(top_imports(path))


def test_the_module_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_fake", object())
    assert "repro" not in run.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert run.loaded_forbidden() == ["repro"]
