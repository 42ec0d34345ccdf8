"""The comparison that decides `correct`, shown to fail: a run driven on
the CPU at a small size (the harness's look for a card skipped, the
plain torch versions of the port's ops underneath), with the timed path
broken in each way the cell can be, against the cell's committed limits.
A sound run at the same size passes them."""

import pytest
import torch

from portbench import harness

SMALL = dict(batch=2, frames=3, points=1100, pool=3, checked=1)
SMALL_CONFIG = dict(template={"num_rings": 8, "ring_size": 8}, body_vertices=500)
FAULTS = {"skirt-reconstruct": ("half_batch", "altered", "one_frame"),
          "skirt-train-posed": ("unchanged", "half_batch"),
          "skirt-train-canonical": ("unchanged", "half_batch")}
# at B=2 the canonical stage's train-mode BatchNorm over two rows makes its
# later steps' gradients chaotic (a 1e-6 change of the weights moves some
# leaves' gradients by 20%), so a sound run there is no test of the limits
SOUND = ("skirt-reconstruct", "skirt-train-posed")


def run(cell_name, fault):
    torch.manual_seed(0)
    cell = harness.load_cell(cell_name, overrides=SMALL, config_overrides=SMALL_CONFIG)
    result, _ = harness.run(cell, 2 ** 31 + 17, 0.5, False, device="cpu", fault=fault)
    return result


@pytest.mark.parametrize("cell,fault", [(c, f) for c, fs in FAULTS.items() for f in fs])
def test_a_broken_path_is_not_correct(cell, fault):
    result = run(cell, fault)
    assert result["correct"] is False, result["compared"]
    assert list(result)[-1] == "compared"


@pytest.mark.parametrize("cell", SOUND)
def test_a_sound_run_is_correct(cell):
    result = run(cell, None)
    assert result["correct"] is True, result["compared"]
    assert result["failed"] == 0 and result["attempted"] >= 1
