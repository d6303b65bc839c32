"""Nothing under portbench/ imports JAX or the JAX package (top-level names
compared whole: vtpu_torch is the program, vtpu is not), and the
reference imports nothing of the program."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "vtpu"}


def _imports(path: Path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")), ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_and_no_jax_package(path):
    assert not _imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert _imports(path) <= {"__future__", "contextlib", "math", "torch"}


def test_the_forbidden_names_are_compared_whole():
    from portbench.harness import forbidden_loaded

    import vtpu_torch  # noqa: F401  (begins with "vtpu" and is allowed)

    assert "vtpu" not in forbidden_loaded()
