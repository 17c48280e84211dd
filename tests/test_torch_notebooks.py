"""The port's notebooks (``notebooks/torch_*.ipynb``) stay executable and
stay on the port.

Tier 1: every code cell of each compiles, and none imports JAX or the JAX
package; the four run in pipeline order (prep -> train -> serve ->
baselines, one workspace) on the CPU with the MiniLM-L6 preset cut to a
tiny width. Marked slow, as ``tests/test_notebooks.py`` is: the four run as
they are, at MiniLM-L6's full width. Each runs in a subprocess, its cells
executed in order in one namespace (as a kernel runs them) with ``DEVICE``
preset to ``"cpu"``: the notebooks name the GPU in one cell and keep a
preset value.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
NB_DIR = REPO / "notebooks"
PKG = "instacart_next_order_recommendation_tpu_torch"

ORDER = [
    "torch_prepare_data.ipynb",
    "torch_train_two_tower.ipynb",
    "torch_serve_recommendations.ipynb",
    "torch_run_baselines.ipynb",
]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "instacart_next_order_recommendation_tpu"}

RUNNER = """
import json, os, sys
path, cwd, tiny = sys.argv[1], sys.argv[2], sys.argv[3] == "1"
os.chdir(cwd)
import torch
torch.set_num_threads(2)
if tiny:
    import dataclasses, functools
    from instacart_next_order_recommendation_tpu_torch.baselines import content_based
    from instacart_next_order_recommendation_tpu_torch.train import trainer
    TINY = dataclasses.replace(
        trainer._PRESETS["minilm-l6"], hidden_size=32, num_layers=2, num_heads=2,
        intermediate_size=64, max_position=128, compute_dtype="float32",
    )
    trainer._PRESETS["minilm-l6"] = TINY
    content_based.untrained_encoder = functools.partial(
        content_based.untrained_encoder, preset=TINY
    )
nb = json.loads(open(path).read())
ns = {"__name__": "__main__", "DEVICE": "cpu"}
for i, cell in enumerate(nb["cells"]):
    if cell["cell_type"] != "code":
        continue
    try:
        exec(compile("".join(cell["source"]), f"cell {i}", "exec"), ns)
    except Exception as exc:
        print(f"CELL_FAILED {i}: {type(exc).__name__}: {exc}", flush=True)
        raise
assert ns.get("DEVICE") == "cpu", ns.get("DEVICE")
bad = [m for m in sys.modules if m.split(".")[0] in FORBIDDEN]
assert not bad, bad
print("NOTEBOOK_OK")
"""


def code_cells(name: str) -> list[str]:
    nb = json.loads((NB_DIR / name).read_text())
    return ["".join(c["source"]) for c in nb["cells"] if c["cell_type"] == "code"]


@pytest.mark.parametrize("name", ORDER)
def test_notebook_cells_compile_and_stay_on_the_port(name):
    cells = code_cells(name)
    assert cells
    imported = set()
    for i, src in enumerate(cells):
        tree = ast.parse(compile(src, f"{name} cell {i}", "exec", ast.PyCF_ONLY_AST))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                imported |= {a.name for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.module:
                imported.add(node.module)
    roots = {m.split(".")[0] for m in imported}
    assert not roots & FORBIDDEN, sorted(roots & FORBIDDEN)
    text = "\n".join(cells)
    # The device is named once, as the GPU, and a preset one is kept.
    if name != "torch_prepare_data.ipynb":
        assert text.count('DEVICE = "cuda"') == 1 and 'if "DEVICE" not in globals()' in text
        assert "torch.cuda.is_available" not in text
    assert PKG in text


@pytest.fixture(scope="module")
def nb_cwd(tmp_path_factory):
    """A stand-in repo root, so the notebooks write torch_nb_workspace/ into a
    temporary directory."""
    cwd = tmp_path_factory.mktemp("torch_nbrun")
    (cwd / PKG).mkdir()  # the root marker the bootstrap cell looks for
    return cwd


def run_notebook(name: str, cwd: Path, tiny: bool, timeout: int) -> None:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", RUNNER.replace("FORBIDDEN", repr(sorted(FORBIDDEN))), str(NB_DIR / name),
         str(cwd), "1" if tiny else "0"],
        env=env, capture_output=True, text=True, timeout=timeout,
    )
    assert proc.returncode == 0 and "NOTEBOOK_OK" in proc.stdout, (
        proc.stdout[-2500:] + proc.stderr[-2500:]
    )


@pytest.mark.parametrize("name", ORDER)
def test_notebook_runs_at_a_tiny_width(name, nb_cwd):
    run_notebook(name, nb_cwd, tiny=True, timeout=300)
    if name == "torch_run_baselines.ipynb":
        ws = nb_cwd / "torch_nb_workspace"
        assert (ws / "model" / "final" / "params.msgpack").exists()
        assert json.loads((ws / "model" / "best.json").read_text())["best_epoch"] in (1, 2)


@pytest.fixture(scope="module")
def nb_cwd_full(tmp_path_factory):
    cwd = tmp_path_factory.mktemp("torch_nbrun_full")
    (cwd / PKG).mkdir()
    return cwd


@pytest.mark.slow
@pytest.mark.parametrize("name", ORDER)
def test_notebook_runs(name, nb_cwd_full):
    run_notebook(name, nb_cwd_full, tiny=False, timeout=1800)
