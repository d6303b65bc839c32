"""The control: the reference with every matmul in float8 put in the
program's place. On the CPU at a tiny size its gaps exceed the bf16
program's on the same served tokens; on the card (``-m cuda``) it is read
at each cell's own size and load and has to fail the cell's limit while
the program keeps to it (``portbench/control.py`` reads it on more seeds).
"""

import time

import pytest

from portbench import catalog, harness
from tiny import tiny_cell


def test_control_reads_wider_than_the_program():
    r = harness.run_cell(tiny_cell("dense", "open"), 3_000_000_029, 1.5, False,
                         time.monotonic_ns(), device="cpu", log=lambda msg: None, control=True)
    c = r["checks"]
    assert c["control_max_logit_gap"]["value"] > 3 * c["max_logit_gap"]["value"]
    assert c["control_mean_logit_gap"]["value"] > 3 * c["mean_logit_gap"]["value"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in catalog.benchmark()["workloads"]])
def test_control_fails_the_cells_limit(workload):
    cell = catalog.cell(workload)
    r = harness.run_cell(cell, 3_000_000_041, 12.0, False, time.monotonic_ns(), control=True)
    for name, limit in cell["params"]["limits"].items():
        assert r["checks"][name]["value"] <= limit
    assert any(r["checks"][f"control_{name}"]["value"] > limit
               for name, limit in cell["params"]["limits"].items())
