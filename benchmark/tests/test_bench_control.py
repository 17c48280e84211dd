"""The control, kept at a size a test run holds: the reference in the
program's place at float8 (one precision below the bf16 the configurations
state) comes out not correct by each cell's limits, where the program's own
run at the same size comes out correct."""

import pytest
import torch

from benchmark import control, harness
from benchmark.tests import tiny


@pytest.mark.parametrize("cell", tiny.cells())
def test_the_control_fails_where_the_program_passes(cell):
    spec, entry, config, traffic, limits = tiny.cell_files(cell)
    limits = {**limits, **tiny.TINY_LIMITS.get(traffic["kind"], {})}
    config, traffic = tiny.tiny(config, traffic)
    ctx = harness.Ctx(entry, config, traffic, limits, tiny.SEED, 1.0, False,
                      torch.device("cpu"), None)
    numbers = control.train_control(ctx) if traffic["kind"] == "train" else \
        control.serve_control(ctx)
    over = [k for k, v in numbers.items() if k in limits and v > limits[k]]
    assert over, numbers
    assert tiny.run_tiny(cell, seconds=1.5)["correct"]
