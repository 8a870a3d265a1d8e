"""The benchmark's own tests.  CPU tests run anywhere; tests marked
``chip`` need a CUDA card and skip without one (decided in a fixture, not
at import)."""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; run on the chip with "
        "`python -m pytest portbench/tests -m chip`")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def tiny_sizes(sizes, cache_positions: int):
    """The family's block at a width the CPU runs in a second."""
    llama = sizes.family == "llama"
    return dataclasses.replace(
        sizes, vocab=256, d_model=64, n_heads=4, n_kv_heads=2 if llama else 4,
        n_layers=2, d_ff=128,
        max_seq_len=cache_positions if llama else 64,
        window=16 if llama else None)


# the open-loop mix has no cell in BENCHMARK.json yet (PERF.md, Open
# questions); its tests run it as this cell
RATE_CELL = "mistral-7b.chat-rate"


def cell_of(name: str):
    """Cell ``name`` of ``BENCHMARK.json``, or the open-loop mix's."""
    from portbench import spec

    if name != RATE_CELL:
        return spec.cell(name)
    return spec.Cell(
        name=name, chips=1,
        config=spec.load_json(spec.HERE / "configs" / "mistral-7b.json"),
        traffic=spec.load_json(spec.HERE / "traffic" / "chat-rate.json"),
        limits={"max_gap": {"limit": 1.0}},
        end_to_end=[{"name": "reply_p95_ms", "unit": "ms"},
                    {"name": "setup_s", "unit": "s"}],
        per_layer=[])


def tiny_cell(name: str):
    """Cell ``name`` with its mix cut to a CPU's size: 4 slots, a 32-token
    bucket, 8 generated tokens; and the tiny sizes for it."""
    from portbench import models

    cell = cell_of(name)
    mix = dict(cell.traffic)
    mix.update(slots=4, bucket=32, generate_tokens=8, decode_block=4,
               check_tokens=48)
    mix["prompt"] = dict(mix["prompt"], median=16, min=4, max=32)
    if mix["arrivals"] == "backlog":
        mix.update(backlog_depth=8, stagger=2, warmup_answers=4)
    else:
        mix["rate"] = dict(mix["rate"], per_s=2.0, period_s=2)
        mix["tail_s"] = 60
    sizes = tiny_sizes(models.sizes(cell.config, 40), 40)
    return dataclasses.replace(cell, traffic=mix), sizes


CELLS = ("mistral-7b.rag-backlog", "gpt2-xl.chat-backlog")


def shallow_cell(name: str, layers: int = 2):
    """Cell ``name`` at its published widths but ``layers`` deep, its mix
    cut as :func:`tiny_cell` cuts it: the logits keep the cell's scale, so
    its limit applies."""
    import dataclasses

    from portbench import models

    cell, _ = tiny_cell(name)
    full = models.sizes(cell.config, 40)
    return cell, dataclasses.replace(full, n_layers=layers)
