"""The control: the reference in the precision below the configuration's,
put in the program's place, read at the same states, has to come out not
correct under each cell's limits; the program, on the same seeds, correct.

On the CPU at the tiny preset for the int8 configuration (int4 products);
on the card at each cell's own size, three seeds each (marked cuda)."""

import pytest
import torch
from conftest import tiny
from harness import spec

CELLS = ["amass_leg3_int8.b256", "amass_leg3_f32.b64"]


def test_int4_control_fails_at_the_tiny_preset(bench, few_threads):
    cell = tiny(spec.cell("amass_leg3_int8.b256", bench))
    limit = cell["limits"]["step_gap"]
    for r in spec.driver(cell["config"]).readings(cell, [5, 2**31 + 6], torch.device("cpu")):
        assert r["control_step_gap"] > limit >= r["step_gap"], r


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_at_the_cells_size(bench, card, workload):
    cell = spec.cell(workload, bench)
    limits = cell["limits"]
    for r in spec.driver(cell["config"]).readings(cell, [2**31 + 101, 2**31 + 202, 2**31 + 303], card):
        assert r["start_gap"] <= limits["start_gap"] and r["link_gap"] <= limits["link_gap"], r
        assert r["step_gap"] <= limits["step_gap"], r
        assert r["control_step_gap"] > limits["step_gap"], r
