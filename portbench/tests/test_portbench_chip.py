"""On a card: each cell at its own sizes, on three seeds, with a short
window.  The program's widest served gap stays under the cell's limit and
the float8 control's, read on the same sample, goes over it."""

from __future__ import annotations

import time

import pytest

from conftest import CELLS

SEEDS = (71, 72, 73)


@pytest.mark.chip
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_limit_that_the_program_passes(name, cuda):
    from portbench import models, run, spec

    cell = spec.cell(name)
    mix = cell.traffic
    sizes = models.sizes(cell.config, mix["bucket"] + mix["generate_tokens"])
    for seed in SEEDS:
        ctx = run.Context(cell=cell, sizes=sizes, seed=seed, seconds=4.0,
                          trace=False, device=cuda,
                          process_start=time.perf_counter(), control=True)
        out = spec.driver(mix["driver"]).run(ctx)
        gap, limit = out["checks"]["max_gap"]
        assert gap <= limit < out["control_gaps"], (
            seed, out["checks"], out["control_gaps"])
