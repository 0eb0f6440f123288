"""Nothing of the benchmark loads JAX, the JAX package or the old
benchmarks, and the reference loads nothing of the program."""
import ast
from pathlib import Path

import pytest

from annbench import harness

HERE = Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text(), filename=str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


FILES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=[str(p.relative_to(HERE))
                                              for p in FILES])
def test_no_jax_or_jax_package(path):
    assert not _imports(path) & BANNED


def test_reference_and_judge_import_nothing_of_the_program():
    for name in ("reference.py", "judge.py", "stats.py", "corpus.py"):
        assert "repro_torch" not in _imports(HERE / name), name


def test_forbidden_modules_compares_whole_top_level_names():
    assert harness.forbidden_modules(["repro_torch", "repro_torch.api",
                                      "jaxtyping", "numpy"]) == []
    assert harness.forbidden_modules(["repro.api", "jax.numpy", "flax",
                                      "jaxlib.xla_client"]) == [
        "flax", "jax", "jaxlib", "repro"]
