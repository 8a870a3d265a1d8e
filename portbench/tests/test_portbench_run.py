"""A whole run of each cell on the CPU at a tiny size: the loop, the
result line, and what it loads."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from conftest import CELLS, RATE_CELL, ROOT, tiny_cell


@pytest.mark.parametrize("name", CELLS + (RATE_CELL,))
def test_tiny_run_is_correct_and_reports_every_metric(name):
    from portbench import run

    cell, sizes = tiny_cell(name)
    out = run.execute(cell, 2 ** 31 + 11, 4.0, False, torch.device("cpu"),
                      sizes=sizes)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(m["value"] > 0 for m in out["metrics"].values())
    assert list(out)[-1] == "checks"
    json.dumps(out, allow_nan=False)


def test_nothing_of_jax_is_loaded_by_a_run():
    """Every module a run loads, by whole top-level name: not ``jax``,
    ``jaxlib``, ``flax``, ``orbax`` nor the JAX package (the port's own
    name begins with the JAX package's, and passes)."""
    code = (
        "import sys, torch\n"
        "sys.path.insert(0, 'portbench/tests')\n"
        "from conftest import tiny_cell\n"
        "from portbench import run\n"
        "from portbench.reference import gpt, llama\n"
        "cell, sizes = tiny_cell('mistral-7b.rag-backlog')\n"
        "run.execute(cell, 5, 1.0, False, torch.device('cpu'), sizes=sizes)\n"
        "assert 'kube_sqs_autoscaler_tpu_torch' in sys.modules\n"
        "print(run.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_compared_whole(monkeypatch):
    from portbench import run

    monkeypatch.setitem(sys.modules, "jaxlib_like_name", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "flax.core", sys)
    assert run.forbidden_modules() == ["flax"]


def test_reference_imports_nothing_of_the_program():
    import ast

    for path in (ROOT / "portbench" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        names = [alias.name for node in ast.walk(tree)
                 if isinstance(node, ast.Import) for alias in node.names]
        names += [node.module or "" for node in ast.walk(tree)
                  if isinstance(node, ast.ImportFrom)]
        tops = {n.split(".")[0] for n in names}
        assert not tops & {"kube_sqs_autoscaler_tpu_torch",
                           "kube_sqs_autoscaler_tpu", "jax", "portbench"}, path


def test_no_card_exits_nonzero_with_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "-m", "portbench", "--workload",
         "gpt2-xl.chat-backlog", "--seed", "1", "--seconds", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
