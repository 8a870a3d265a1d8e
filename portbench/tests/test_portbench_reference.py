"""Each family's plain reference against the port's own forward, both in
float32 on the CPU at a tiny width, on the same seeded weights."""

from __future__ import annotations

import pytest
import torch

from conftest import CELLS, tiny_cell


@pytest.mark.parametrize("name", ["mistral-7b.rag-backlog",
                                  "gpt2-xl.chat-backlog"])
def test_reference_matches_the_port_in_float32(name):
    from kube_sqs_autoscaler_tpu_torch.workloads import llama, model
    from portbench import correct, models

    cell, sizes = tiny_cell(name)
    cpu = torch.device("cpu")
    stacked = models.stacked_weights(sizes, 7, cpu, dtype=torch.float32)
    params = models.port_params(stacked)
    config = models.port_config(sizes)
    import dataclasses

    config = dataclasses.replace(config, dtype=torch.float32)
    generator = torch.Generator().manual_seed(3)
    # longer than the window, so the window's mask is exercised
    n = 36 if sizes.family == "llama" else 40
    tokens = torch.randint(0, sizes.vocab, (n,), generator=generator)
    forward = llama.llama_forward if sizes.family == "llama" else model.forward
    program = forward(params, tokens[None], config)[0]
    rows = torch.arange(n)
    ref = correct.reference(sizes.family)(stacked, sizes, [tokens], [rows])[0]
    torch.testing.assert_close(ref, program, rtol=0, atol=2e-5)


def test_a_changed_weight_moves_the_reference():
    from portbench import correct, models

    _, sizes = tiny_cell("mistral-7b.rag-backlog")
    cpu = torch.device("cpu")
    stacked = models.stacked_weights(sizes, 7, cpu, dtype=torch.float32)
    tokens = [torch.arange(20) % sizes.vocab]
    rows = [torch.arange(20)]
    before = correct.reference("llama")(stacked, sizes, tokens, rows)[0]
    stacked["wkv"][1] *= 1.5
    after = correct.reference("llama")(stacked, sizes, tokens, rows)[0]
    assert (before - after).abs().max() > 1e-3


@pytest.mark.parametrize("name", CELLS)
def test_control_departs_where_float32_does_not(name):
    """The float8 control picks tokens the float32 reference ranks lower;
    the float32 reference's own picks read a gap of exactly 0."""
    from portbench import correct, models

    _, sizes = tiny_cell(name)
    cpu = torch.device("cpu")
    stacked = models.stacked_weights(sizes, 11, cpu)
    generator = torch.Generator().manual_seed(5)
    seqs = [torch.randint(0, sizes.vocab, (30,), generator=generator)
            for _ in range(3)]
    rows = [torch.arange(30)] * 3
    exact = correct.reference(sizes.family)(stacked, sizes, seqs, rows)
    own = correct.served_gaps(exact, [lg.argmax(-1) for lg in exact])
    assert float(own.max()) == 0.0
    assert float(correct.control_gaps(stacked, sizes, seqs, rows).max()) > 0
