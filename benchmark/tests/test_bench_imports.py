"""Nothing under benchmark/ imports JAX or the JAX package (top-level module
names compared whole: ``mimic_tpu_torch`` is not ``mimic_tpu``), the
reference imports nothing of the program, and nothing reads the JAX
benchmark's files."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_bench_no_jax(path):
    assert not {"jax", "jaxlib", "flax", "mimic_tpu"} & set(top_level_imports(path))


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_bench_reference_imports_nothing_of_the_program(path):
    assert "mimic_tpu_torch" not in set(top_level_imports(path))
    text = path.read_text()
    assert "mimic_tpu_torch" not in text.replace("``mimic_tpu_torch``", "")


def test_bench_reads_no_jax_benchmark_file():
    names = ("bench.py", "BASELINE.json", "BENCH_r", "MULTICHIP_r")
    for path in [*SOURCES, *BENCH.rglob("*.json")]:
        if path.name.startswith("test_bench_imports"):
            continue
        text = path.read_text()
        assert not [n for n in names if n in text], path
