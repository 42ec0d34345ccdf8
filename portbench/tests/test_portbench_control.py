"""The control on the card: the plain reference computed with TF32
products, put in the program's place, fails the cell's limits, and the
program passes them, at each cell's own size with a pool of 3 batches
(the benchmark's own runs do not run it; `python3 -m portbench.calibrate
--control tf32` reads it over many seeds). On the card:
`python3 -m pytest portbench/tests -q -m cuda`."""

import pytest
import torch

from portbench import harness

pytestmark = pytest.mark.cuda

POOL = dict(pool=3)


@pytest.mark.parametrize("cell_name", ["skirt-reconstruct", "skirt-train-posed",
                                       "skirt-train-canonical"])
def test_tf32_control_fails_a_limit(card, cell_name):
    import importlib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = harness.load_cell(cell_name, overrides=POOL)
    path = importlib.import_module(f"portbench.paths.{cell.workload['path']}")
    job = path.Job(cell, 2 ** 31 + 5, card)
    job.warmup()
    job.release()
    numbers, control = job.check(control="tf32")
    assert all(numbers[k] <= v for k, v in cell.limits.items()), numbers
    assert any(control[k] > v for k, v in cell.limits.items()), control
