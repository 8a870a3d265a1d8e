"""The port's pipeline on the 4-axis mesh (pp x dp x sp x tp), its
zig-zag stages and its MoE stages, held against the JAX package's
``pipeline.py`` on its virtual 8-device CPU mesh (the reference's
``test_pipeline_4axis.py``).  Everything is fp32; tolerances as in
``test_torch_pipeline.py``.

The MoE stages under tp are held to the reference without tp (``ref_tp=1``
on the same pipe and data axes), the function the reference defines:
the reference's own MoE x pp x tp gradients move off that truth (by up to
1.3e-3 on ``embed`` at these shapes, while its loss agrees), and the
port's stay within 3e-8 of it.
"""

import numpy as np
import pytest
import torch

from .test_torch_pipeline import assert_params_close
from .torch_pipeline_ref import Runs, assert_trees_close, spec

torch.set_num_threads(1)

STEP = dict(learning_rate=1e-2, grad_clip_norm=0.5)
RUNS = Runs({
    "gpt-4axis-gpipe-steps": spec(8, "gpt", 2, 2, "gpipe", kind="steps",
                                  tp=2, sp=2, rows=4, steps=2, train=STEP),
    "gpt-4axis-1f1b-steps": spec(8, "gpt", 2, 2, "1f1b", kind="steps",
                                 tp=2, sp=2, rows=4, steps=2, train=STEP),
    "llama-4axis-1f1b-steps": spec(8, "llama", 2, 2, "1f1b", kind="steps",
                                   tp=2, sp=2, rows=4, steps=2, train=STEP),
    "llama-4axis-1f1b": spec(8, "llama", 2, 2, "1f1b", tp=2, sp=2, rows=4),
    "gpt-zigzag-gpipe": spec(4, "gpt", 2, 4, "gpipe", sp=2, rows=4,
                             zigzag=True),
    "gpt-zigzag-1f1b": spec(4, "gpt", 2, 4, "1f1b", sp=2, rows=4,
                            zigzag=True),
    "llama-zigzag-1f1b": spec(4, "llama", 2, 4, "1f1b", sp=2, rows=4,
                              zigzag=True),
    "gpt-moe-pp2-tp2-gpipe": spec(4, "gpt", 2, 2, "gpipe", tp=2, rows=4,
                                  routed=True, ref_tp=1),
    "gpt-moe-pp2-tp2-1f1b": spec(4, "gpt", 2, 2, "1f1b", tp=2, rows=4,
                                 routed=True, ref_tp=1),
    "llama-moe-pp2-dp2-1f1b": spec(4, "llama", 2, 2, "1f1b", rows=4,
                                   routed=True),
    "gpt-moe-pp2-dp2-gpipe-steps": spec(4, "gpt", 2, 2, "gpipe",
                                        kind="steps", rows=4, steps=2,
                                        routed=True, train=STEP),
})
GRADS = [n for n, r in RUNS.runs.items() if r["kind"] == "grads"]
STEPS = [n for n, r in RUNS.runs.items() if r["kind"] == "steps"]


@pytest.mark.parametrize("name", GRADS)
def test_pipeline_loss_and_grads_match_the_reference(name):
    got = RUNS.port(name)
    want_loss, want_grads = RUNS.reference(name)
    assert got["loss"] == pytest.approx(want_loss, rel=1e-5)
    assert_trees_close(got["grads"], want_grads, atol=2e-6)


@pytest.mark.parametrize("name", STEPS)
def test_pipeline_train_steps_match_the_reference(name):
    got = RUNS.port(name)
    want_losses, want_params = RUNS.reference(name)
    np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-5)
    assert_params_close(got["params"], want_params)


SHAPES = [(2, 2, 2), (2, 2, 1), (2, 1, 2), (4, 1, 1), (2, 1, 1)]


def test_4axis_mesh_places_ranks_as_the_reference_places_devices():
    """``("pipe", "data", "seq", "model")`` over 8 ranks: rank ``r`` sits
    where the reference's ``make_pipeline_mesh`` puts device ``r``; the
    node-major mesh is the same on one node; each axis group holds the
    ranks that differ only along it; only the groups the pipeline reduces
    over exist."""
    import jax

    from kube_sqs_autoscaler_tpu.workloads import pipeline as jax_pipeline
    from .torch_mesh_ranks import run_ranks

    ranks = run_ranks("pipe_mesh", 8, {"shapes": SHAPES}, timeout=200)
    assert ranks[0]["refused"] == ("8 devices not divisible by "
                                   "pipe_parallel=3 x model_parallel=1 x "
                                   "seq_parallel=1")
    for i, (pipe, tp, sp) in enumerate(SHAPES):
        ref = jax_pipeline.make_pipeline_mesh(
            jax.devices(), pipe_parallel=pipe, model_parallel=tp,
            seq_parallel=sp)
        ids = np.vectorize(lambda d: d.id)(ref.devices)
        names = ref.axis_names
        for topo in (0, 1):
            for rank, result in enumerate(ranks):
                got = result["meshes"][2 * i + topo]
                assert got["shape"] == {"pipe": pipe, "data": 8 // (
                    pipe * tp * sp), "seq": sp, "model": tp}
                where = np.argwhere(ids == rank)[0]
                coords = dict(zip(names, where))
                for axis in ("pipe", "data", "seq", "model"):
                    assert got["coords"][axis] == coords.get(axis, 0)
                # the pipe group: this rank's coordinates, every stage
                index = [slice(None) if n == "pipe" else coords[n]
                         for n in names]
                assert got["groups"]["pipe"] == list(ids[tuple(index)])
                assert sorted(got["groups"]) == sorted(
                    ["pipe", "data", "seq", "model", "data+seq",
                     "model+pipe", "data+model+seq", "data+pipe+seq"])


def test_trainer_binary_4axis():
    """pp 2 x dp 2 x sp 2 x tp 2 through the binary over 8 ranks (1F1B,
    the llama with its window): the losses fall, every rank reports them,
    and the first equals one process's (bf16, 1e-3 relative)."""
    from kube_sqs_autoscaler_tpu_torch.workloads import trainer
    from .torch_mesh_ranks import run_ranks

    argv = ["--device", "cpu", "--family", "llama", "--vocab-size", "256",
            "--d-model", "64", "--n-heads", "4", "--n-kv-heads", "2",
            "--n-layers", "2", "--d-ff", "96", "--seq-len", "32",
            "--sliding-window", "12", "--batch-size", "8", "--log-every",
            "1", "--learning-rate", "3e-3", "--overfit", "--steps", "3"]
    mesh = ["--pipe-parallel", "2", "--model-parallel", "2",
            "--seq-parallel", "2", "--pipe-schedule", "1f1b",
            "--pipe-microbatches", "2"]
    ranks = run_ranks("trainer", 8, {"argv": argv + mesh}, timeout=300)
    losses = ranks[0]["losses"]
    assert all(r["losses"] == losses for r in ranks)
    assert losses[-1] < losses[0]
    one = trainer.main([*argv[:-1], "1"])
    assert losses[0] == pytest.approx(one["losses"][0], rel=1e-3)
