"""Nothing under benchmark/ imports JAX or the JAX package, and the
reference imports nothing of the port. Top-level module names are compared
whole: ``balatro_gym_tpu_torch`` is not ``balatro_gym_tpu``."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
JAX = {"jax", "jaxlib", "flax", "balatro_gym_tpu"}


def imported(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                names.add(str(node.args[0].value).split(".")[0])
    return names


FILES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not imported(path) & JAX


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_stands_alone(path):
    assert imported(path) <= {"__future__", "dataclasses", "enum", "itertools", "numpy",
                              "torch"}


def test_whole_names():
    assert "balatro_gym_tpu_torch" not in JAX
    assert imported(BENCH / "drivers" / "ppo_update.py") & {"balatro_gym_tpu_torch"}
