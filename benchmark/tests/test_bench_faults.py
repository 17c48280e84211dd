"""Each cell's comparison, driven through a whole run at a size the CPU
holds (the look for a card skipped), passes the sound program and fails it
with the timed path broken underneath: a step or call that returns its
state unchanged, half of each batch left out, a token or an answer altered
where it is produced. (One card: no exchange between chips to leave out.)"""

import pytest

from benchmark.tests import tiny

SERVE_FAULTS = ("unchanged", "half", "token", "answer")
TRAIN_FAULTS = ("unchanged", "half", "answer")


def cases():
    out = []
    for cell in tiny.cells():
        kind = tiny.cell_files(cell)[3]["kind"]
        for fault in (None,) + (TRAIN_FAULTS if kind == "train" else SERVE_FAULTS):
            out.append((cell, fault))
    return out


@pytest.mark.parametrize("cell,fault", cases())
def test_correct_only_when_sound(cell, fault):
    res = tiny.run_tiny(cell, fault=fault, seconds=1.0)
    assert res["correct"] is (fault is None), res["checks"]
    assert list(res)[-1] == "checks"  # the numbers compared come last in the line
