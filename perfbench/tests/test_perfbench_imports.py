"""Nothing of the benchmark imports JAX or the JAX package, and nothing of
its reference imports the program; top-level module names are compared
whole (the port's name begins with the JAX package's)."""

import ast

import pytest

from perfbench import harness

FILES = sorted(p for p in harness.HERE.rglob("*.py") if "__pycache__" not in p.parts)


def _imported(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(harness.HERE)))
def test_no_jax(path):
    assert not _imported(path) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((harness.HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "controllable_agent_torch" not in _imported(path)
