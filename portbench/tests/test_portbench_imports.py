"""Nothing the benchmark runs imports JAX or the JAX package (top-level
names compared whole: ``sutro_tpu_torch`` is not ``sutro_tpu``), and the
reference imports nothing of the program."""

import ast
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parent.parent
SOURCES = sorted(p for p in PKG.rglob("*.py") if "tests" not in p.parts)
BANNED = {"jax", "jaxlib", "flax", "sutro_tpu"}


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax_and_no_jax_package(path):
    assert not top_level_imports(path) & BANNED


@pytest.mark.parametrize("path", sorted((PKG / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    text = path.read_text()
    assert "sutro_tpu_torch" not in top_level_imports(path)
    assert "importlib" not in text and "portbench.program" not in text


def test_the_name_check_is_by_whole_names():
    assert "sutro_tpu_torch".split(".")[0] not in BANNED
