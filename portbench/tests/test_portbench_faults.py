"""A run with the timed path broken underneath comes out not correct.

The faults are planted in the engine's decode step (the step every slot
row goes through), at the cells' published widths cut to two layers, on
the CPU; the sound run beside them is correct."""

from __future__ import annotations

import pytest
import torch

from conftest import CELLS, shallow_cell


def _unchanged_state(inner):
    """The step computes but hands its cache back unadvanced."""
    def step(params, cache, tokens, config, **kw):
        length = cache["length"].clone()
        logits, cache = inner(params, cache, tokens, config, **kw)
        cache["length"] = length
        return logits, cache
    return step


def _half_batch(inner):
    """Each half of the rows gets the other half's logits (so a request
    goes wrong in whichever row it sits, however few rows are busy)."""
    def step(params, cache, tokens, config, **kw):
        logits, cache = inner(params, cache, tokens, config, **kw)
        return logits.roll(logits.shape[0] // 2, dims=0), cache
    return step


def _token_altered(inner):
    """Each row's token is the next id after the one it would be."""
    def step(params, cache, tokens, config, **kw):
        logits, cache = inner(params, cache, tokens, config, **kw)
        return logits.roll(1, dims=-1), cache
    return step


FAULTS = {"unchanged_state": _unchanged_state, "half_batch": _half_batch,
          "token_altered": _token_altered}


def _run(name, monkeypatch, fault=None):
    from kube_sqs_autoscaler_tpu_torch.workloads.continuous import (
        ContinuousBatcher,
    )
    from portbench import run

    if fault is not None:
        init = ContinuousBatcher.__init__

        def broken(self, *args, **kwargs):
            init(self, *args, **kwargs)
            self._step_fn = FAULTS[fault](self._step_fn)

        monkeypatch.setattr(ContinuousBatcher, "__init__", broken)
    cell, sizes = shallow_cell(name)
    return run.execute(cell, 20261018, 6.0, False, torch.device("cpu"),
                       sizes=sizes)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", [None, *FAULTS])
def test_a_broken_step_is_not_correct(name, fault, monkeypatch):
    out = _run(name, monkeypatch, fault)
    assert out["correct"] == (fault is None), out["checks"]
