"""Nothing the benchmark runs imports JAX or the JAX package, and its
yardstick imports nothing of the program."""
from __future__ import annotations

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
# the yardstick: neither JAX nor anything of the program
PLAIN = ("reference.py", "synth.py", "roofline.py", "profiling.py",
         "control.py", "spread.py")


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(p for p in BENCH.rglob("*.py")
                 if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(
    BENCH)))
def test_no_jax_and_no_jax_package(path):
    found = top_level_imports(path) & FORBIDDEN
    assert not found, f"{path} imports {found}"


@pytest.mark.parametrize("name", PLAIN)
def test_yardstick_imports_nothing_of_the_program(name):
    found = top_level_imports(BENCH / name)
    assert "repro_torch" not in found and not found & FORBIDDEN


def test_the_check_compares_whole_top_level_names():
    from portbench import harness
    assert set(harness.FORBIDDEN) == FORBIDDEN
    assert "repro_torch".split(".")[0] not in harness.FORBIDDEN
