"""Nothing the benchmark runs loads JAX or the JAX package, by whole
top-level module names; the reference loads nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

from benchmark import harness

BENCH = Path(harness.HERE)
PORT = "instacart_next_order_recommendation_tpu_torch"


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_names_compare_whole():
    mods = {"jax.numpy": 1, PORT: 1, f"{PORT}.ops": 1, "instacart_next_order_recommendation_tpu": 1}
    assert harness.forbidden_loaded(mods) == ["instacart_next_order_recommendation_tpu", "jax"]
    assert harness.forbidden_loaded({PORT: 1, "jaxtyping": 1}) == []


def test_no_source_of_the_benchmark_imports_jax():
    for path in BENCH.rglob("*.py"):
        assert not top_level_imports(path) & set(harness.FORBIDDEN_MODULES), path


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        names = top_level_imports(path)
        assert PORT not in names and names <= {"__future__", "math", "torch", "unicodedata",
                                                "benchmark"}, (path, names)
        text = path.read_text()
        assert "benchmark.drivers" not in text and "benchmark.port" not in text


def test_a_run_loads_no_jax():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from benchmark.tests import tiny\n"
        "from benchmark import harness\n"
        "import benchmark.reference.bert, benchmark.reference.train, benchmark.reference.tokenizer\n"
        "assert not any(m.split('.')[0] == %r for m in sys.modules), 'reference loaded the port'\n"
        "for cell in tiny.cells():\n"
        "    tiny.run_tiny(cell, seconds=0.5)\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & set(harness.FORBIDDEN_MODULES)))\n"
    ) % (str(harness.ROOT), PORT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env={"PATH": "/usr/bin:/bin", "HOME": "/tmp"})
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
