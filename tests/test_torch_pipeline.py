"""The port's pipeline (``workloads/pipeline.py``, GPT family) held
against the JAX package's ``pipeline.py`` on its virtual 8-device CPU mesh.

The port runs as 2, 4 or 8 gloo ranks (``torch_mesh_ranks.py``); both
packages start from the reference's stage-stacked ``init_params``
(``convert.params_from_jax``) and see the same ``[M, B_m, S]``
microbatches.  Everything is fp32.  Tolerances: losses within 1e-5
relative; gradients within 1e-4 relative and 2e-6 absolute; parameters
after AdamW steps all but 0.1% within 1e-5 and every one within 1e-4
(``test_torch_mesh_train.py`` holds the flat mesh to 2e-6 and 2e-5): AdamW
divides by the root of the second moment, so a gradient near zero whose
fp32 sum runs in another order (over microbatches and stages, and under
pp x sp x tp over three groups) moves its parameter by up to ``lr`` times
its relative error.
"""

import numpy as np
import pytest
import torch

from kube_sqs_autoscaler_tpu.workloads import pipeline as jax_pipeline
from kube_sqs_autoscaler_tpu_torch.workloads import model, pipeline, train
from kube_sqs_autoscaler_tpu_torch.workloads.convert import params_from_jax
from .torch_pipeline_ref import (
    Runs, assert_trees_close, family, named, spec,
)

torch.set_num_threads(1)

STEP = dict(learning_rate=1e-2, grad_clip_norm=0.5, warmup_steps=1,
            decay_steps=4)
RUNS = Runs({
    "pp2-gpipe": spec(2, "gpt", 2, 4, "gpipe", rows=4),
    "pp2-1f1b": spec(2, "gpt", 2, 4, "1f1b", rows=4),
    "pp4-1f1b-m2": spec(4, "gpt", 4, 2, "1f1b", rows=4),
    "pp4-gpipe-m8": spec(4, "gpt", 4, 8, "gpipe", rows=8),
    "pp2-dp2-gpipe": spec(4, "gpt", 2, 4, "gpipe", rows=8),
    "pp2-tp2-gpipe": spec(4, "gpt", 2, 4, "gpipe", tp=2, rows=4),
    "pp2-tp2-1f1b": spec(4, "gpt", 2, 4, "1f1b", tp=2, rows=4),
    "pp2-sp2-gpipe": spec(4, "gpt", 2, 4, "gpipe", sp=2, rows=4),
    "pp2-sp2-1f1b": spec(4, "gpt", 2, 4, "1f1b", sp=2, rows=4),
    "pp2-dp2-tp2-1f1b-steps": spec(8, "gpt", 2, 2, "1f1b", kind="steps",
                                   tp=2, rows=8, steps=2,
                                   train=dict(STEP, grad_accum=2)),
    "pp2-dp2-sp2-gpipe-steps": spec(8, "gpt", 2, 4, "gpipe", kind="steps",
                                    sp=2, rows=8, steps=2, train=STEP),
})
GRADS = [n for n, r in RUNS.runs.items() if r["kind"] == "grads"]
STEPS = [n for n, r in RUNS.runs.items() if r["kind"] == "steps"]


@pytest.mark.parametrize("name", GRADS)
def test_pipeline_loss_and_grads_match_the_reference(name):
    got = RUNS.port(name)
    want_loss, want_grads = RUNS.reference(name)
    assert got["loss"] == pytest.approx(want_loss, rel=1e-5)
    # the forward slots alone (the trainer's eval) give the same loss
    assert got["eval"] == pytest.approx(want_loss, rel=1e-5)
    assert_trees_close(got["grads"], want_grads, atol=2e-6)


def assert_params_close(got, want):
    got, want = named(got), named(want)
    assert sorted(got) == sorted(want)
    g = np.concatenate([got[k].ravel() for k in sorted(got)])
    w = np.concatenate([want[k].ravel() for k in sorted(want)])
    np.testing.assert_allclose(g, w, atol=1e-4, rtol=0)
    assert np.mean(np.abs(g - w) > 1e-5) < 1e-3


@pytest.mark.parametrize("name", STEPS)
def test_pipeline_train_steps_match_the_reference(name):
    got = RUNS.port(name)
    want_losses, want_params = RUNS.reference(name)
    np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-5)
    assert got["step"] == len(want_losses)
    assert_params_close(got["params"], want_params)


def test_tied_embedding_sums_the_lookup_and_readout_terms():
    # stage 0 holds the embedding's lookup gradient, the last stage its
    # readout gradient; each alone is wrong, their sum over pipe is the
    # reference's
    got = RUNS.port("pp2-gpipe")
    _, want = RUNS.reference("pp2-gpipe")
    parts = dict(got["embed_parts"])
    want_embed = np.asarray(want["embed"], np.float32)
    for part in parts.values():
        assert np.abs(part.numpy()).max() > 1e-3
        assert np.abs(part.numpy() - want_embed).max() > 1e-3
    np.testing.assert_allclose((parts[0] + parts[1]).numpy(), want_embed,
                               atol=2e-6, rtol=1e-4)


@pytest.mark.parametrize(
    "n_stages,n_micro",
    [(4, 2), (4, 4), (4, 8), (2, 1), (2, 6), (8, 3)],
    ids=["M<P", "M=P", "M>P", "m1", "p2m6", "p8m3"],
)
def test_1f1b_schedule_tables_equal_the_references(n_stages, n_micro):
    fwd, bwd = pipeline.one_f_one_b_schedule(n_stages, n_micro)
    want_fwd, want_bwd = jax_pipeline.one_f_one_b_schedule(n_stages,
                                                           n_micro)
    np.testing.assert_array_equal(fwd, want_fwd)
    np.testing.assert_array_equal(bwd, want_bwd)
    # every microbatch runs once forward and once backward on every stage,
    # and a stage keeps at most min(M, P) of them in flight
    for s in range(n_stages):
        assert sorted(fwd[:, s][fwd[:, s] >= 0]) == list(range(n_micro))
        assert sorted(bwd[:, s][bwd[:, s] >= 0]) == list(range(n_micro))
        live = np.cumsum(fwd[:, s] >= 0) - np.cumsum(bwd[:, s] >= 0)
        assert live.max() <= min(n_micro, n_stages)


@pytest.mark.parametrize("n_stages,n_micro", [(2, 4), (4, 8), (3, 1)])
def test_gpipe_tables_run_every_forward_before_any_backward(n_stages,
                                                            n_micro):
    fwd, bwd = pipeline.gpipe_schedule(n_stages, n_micro)
    span = n_micro + n_stages - 1
    assert (bwd[:span] < 0).all() and (fwd[span:] < 0).all()
    for s in range(n_stages):
        # stage s forwards microbatch m at slot m + s, after stage s - 1
        assert list(fwd[:, s][fwd[:, s] >= 0]) == list(range(n_micro))
        assert list(np.nonzero(fwd[:, s] >= 0)[0]) == [
            m + s for m in range(n_micro)]
        # and differentiates it after stage s + 1 did
        slots = np.nonzero(bwd[:, s] >= 0)[0]
        assert list(slots) == [span + m + n_stages - 1 - s
                               for m in range(n_micro)]
    fwd_only, bwd_none = pipeline.gpipe_schedule(n_stages, n_micro,
                                                 backward=False)
    assert fwd_only.shape[0] == span and (bwd_none < 0).all()


def _fake_mesh(pipe, pipe_index, tp=1, tp_index=0):
    from kube_sqs_autoscaler_tpu_torch.workloads import distributed

    axes = {"pipe": (pipe, pipe_index), "data": (1, 0), "seq": (1, 0),
            "model": (tp, tp_index)}
    return distributed.Mesh(
        shape={n: size for n, (size, _) in axes.items()}, rank=0,
        device=torch.device("cpu"), transport=None,
        groups={frozenset((n,)): distributed.Axis(n, size, index,
                                                  list(range(size)))
                for n, (size, index) in axes.items()})


def test_stage_assignment_is_contiguous_layer_order():
    _, npp, cfg = family("gpt")
    params = params_from_jax(npp, cfg, "cpu")
    for stage in range(4):
        part = pipeline.shard_pipeline_params(params, _fake_mesh(4, stage))
        for name, t in params["stages"].items():
            assert torch.equal(part["stages"][name], t[stage:stage + 1])
        # the embedding, positions and final norm stay whole
        for name in ("embed", "pos_embed", "final_ln_scale"):
            assert torch.equal(part[name], params[name])
    # under tp a stage's column-parallel projections keep their heads and
    # the row-parallel ones their rows; the layer norms stay whole
    part = pipeline.shard_pipeline_params(params, _fake_mesh(2, 1, 2, 1))
    wq = params["stages"]["wq"]
    assert torch.equal(part["stages"]["wq"], wq[2:, :, 16:])
    assert torch.equal(part["stages"]["wo"], params["stages"]["wo"][2:, 16:])
    assert torch.equal(part["stages"]["ln1_scale"],
                       params["stages"]["ln1_scale"][2:])


def test_stack_unstack_round_trip_splits_the_fused_projection():
    _, npp, cfg = family("gpt")
    staged = params_from_jax(npp, cfg, "cpu")
    flat = pipeline.unstack_layers(staged)
    assert len(flat["layers"]) == cfg.n_layers
    assert "wqkv" in flat["layers"][0] and "stages" not in flat
    again = pipeline.as_pipeline_params(flat)
    assert sorted(again["stages"]) == sorted(staged["stages"])
    for name, t in staged["stages"].items():
        assert torch.equal(again["stages"][name], t)
    # the port's unstacking equals the reference's on the same weights
    jflat = jax_pipeline.unstack_layers(npp)
    for layer, jlayer in zip(flat["layers"], jflat["layers"]):
        for name in jlayer:
            np.testing.assert_array_equal(layer[name].numpy(),
                                          np.asarray(jlayer[name]))


def test_layers_and_microbatches_are_checked():
    cfg = model.ModelConfig(vocab_size=64, d_model=32, n_heads=4,
                            n_layers=3, d_ff=64, max_seq_len=16,
                            dtype=torch.float32)
    with pytest.raises(ValueError, match="n_layers=3 not divisible by "
                       "n_stages=2"):
        pipeline.init_pipeline_params(cfg, torch.Generator().manual_seed(0),
                                      2, "cpu")
    with pytest.raises(ValueError, match="schedule must be"):
        pipeline.PipelineConfig(schedule="interleaved")
    _, npp, cfg = family("gpt")
    mesh = pipeline.make_pipeline_mesh(1, device="cpu")
    state = pipeline.place_pipeline_state(mesh, train.train_state(
        params_from_jax(npp, cfg, "cpu"), train.TrainConfig()))
    vag = pipeline.pipeline_value_and_grad(cfg, pipeline.PipelineConfig(4),
                                           mesh)
    with pytest.raises(ValueError, match="tokens have 2 microbatches, "
                       "config says 4"):
        vag(state["params"], torch.zeros((2, 2, 16), dtype=torch.long))
    with pytest.raises(ValueError, match="not divisible by n_microbatches"):
        pipeline.pipeline_rows(np.zeros((6, 16)), mesh, 4)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_one_stage_pipeline_equals_the_flat_objective(schedule):
    # one stage is the flat model: the same loss and gradients as the
    # one-device objective on the same rows, microbatch by microbatch
    _, npp, cfg = family("gpt")
    staged = params_from_jax(npp, cfg, "cpu")
    mesh = pipeline.make_pipeline_mesh(1, device="cpu")
    state = pipeline.place_pipeline_state(mesh, train.train_state(
        staged, train.TrainConfig()))
    batch = np.random.default_rng(0).integers(0, 64, (8, 16))
    vag = pipeline.pipeline_value_and_grad(
        cfg, pipeline.PipelineConfig(4, schedule), mesh)
    loss, grads = vag(state["params"], torch.from_numpy(
        pipeline.pipeline_rows(batch, mesh, 4).copy()))
    flat = train.train_state(pipeline.unstack_layers(staged),
                             train.TrainConfig())
    want_loss, want = train.value_and_grad(
        lambda p, t: train.loss_fn(p, t, cfg), flat["params"],
        torch.from_numpy(batch))
    assert loss.item() == pytest.approx(want_loss.item(), rel=1e-6)
    assert_trees_close(grads, pipeline.as_pipeline_params(want), atol=1e-7)


BINARY = ["--device", "cpu", "--vocab-size", "256", "--d-model", "64",
          "--n-heads", "4", "--n-layers", "4", "--d-ff", "128", "--seq-len",
          "32", "--batch-size", "8", "--log-every", "1", "--learning-rate",
          "3e-3", "--overfit"]
PP_TP = ["--pipe-parallel", "2", "--model-parallel", "2", "--pipe-schedule",
         "1f1b", "--pipe-microbatches", "4"]


def test_trainer_pipeline_checkpoint_serves_and_resumes(tmp_path):
    """The trainer binary over 4 ranks (pp 2 x tp 2, 1F1B): its losses
    equal one process's; its checkpoint is the reference's ``pipeline``
    layout, which the single-card worker serves as it serves the gathered
    weights; ``--resume`` under the same stage count continues the run bit
    for bit, and under another stage count is refused by the manifest."""
    from kube_sqs_autoscaler_tpu_torch.workloads import __main__ as worker
    from kube_sqs_autoscaler_tpu_torch.workloads import trainer
    from kube_sqs_autoscaler_tpu_torch.workloads.checkpoint import (
        load_model_layout, load_model_manifest,
    )
    from .torch_mesh_ranks import run_ranks

    ckpt = tmp_path / "ckpt"
    first = run_ranks("trainer", 4, {"argv": [
        *BINARY, *PP_TP, "--steps", "3", "--checkpoint-dir", str(ckpt),
        "--checkpoint-every", "2", "--eval-every", "3", "--eval-batches",
        "1"]}, timeout=300)
    second = run_ranks("trainer", 4, {"argv": [
        *BINARY, *PP_TP, "--steps", "2", "--checkpoint-dir", str(ckpt),
        "--resume"]}, timeout=300)
    whole = run_ranks("trainer", 4, {"argv": [*BINARY, *PP_TP, "--steps",
                                              "5"]}, timeout=300)
    assert first[0]["losses"] + second[0]["losses"] == whole[0]["losses"]
    assert second[0]["final_step"] == 5
    one = trainer.main([*BINARY, "--steps", "5"])
    np.testing.assert_allclose(whole[0]["losses"], one["losses"], rtol=2e-3)
    assert load_model_layout(ckpt) == {"kind": "pipeline", "n_stages": 2}
    steps = sorted(p.name for p in ckpt.glob("step_*"))
    assert steps == ["step_00000002", "step_00000003", "step_00000005"]
    refused = run_ranks("trainer", 4, {"argv": [
        *BINARY, "--pipe-parallel", "4", "--steps", "1", "--checkpoint-dir",
        str(ckpt), "--resume"]}, timeout=300)
    assert "layout={'kind': 'pipeline', 'n_stages': 2}" in refused[0]["exit"]
    assert "'n_stages': 4" in refused[0]["exit"]
    args = ["--device", "cpu", "--demo", "4", "--seq-len", "16",
            "--generate-tokens", "4", "--result-queue-url",
            "demo://replies"]
    served = worker.main([*args, "--checkpoint-dir", str(ckpt)])
    _, config = load_model_manifest(ckpt)
    direct = worker.run_demo(
        4, second[0]["params"], config,
        worker.ServiceConfig(queue_url="", batch_size=8, seq_len=16,
                             generate_tokens=4,
                             result_queue_url="demo://replies"),
        torch.device("cpu"))
    assert served["replies"] == direct["replies"]
    assert len(served["replies"]) == 4


@pytest.mark.parametrize("extra", [
    ["--pipe-parallel", "2", "--seq-parallel", "2", "--pipe-schedule",
     "1f1b"],
    ["--pipe-parallel", "4", "--pipe-microbatches", "8", "--batch-size",
     "8"],
    ["--pipe-parallel", "2", "--seq-parallel", "2", "--zigzag",
     "--pipe-schedule", "1f1b"],
    ["--pipe-parallel", "2", "--pipe-microbatches", "2", "--grad-accum",
     "2", "--topology-mesh"],
], ids=["pp2-sp2-1f1b", "pp4-m8", "pp2-zigzag-1f1b", "pp2-dp2-accum-topo"])
def test_trainer_pipelines_learn_as_one_process(extra):
    """The pipeline layouts through the binary over 4 ranks: the losses
    fall and the first equals one process's (bf16, 1e-3 relative)."""
    from kube_sqs_autoscaler_tpu_torch.workloads import trainer
    from .torch_mesh_ranks import run_ranks

    argv = [*BINARY, "--steps", "3", *extra]
    ranks = run_ranks("trainer", 4, {"argv": argv}, timeout=300)
    losses = ranks[0]["losses"]
    assert all(r["losses"] == losses for r in ranks)
    assert len(losses) == 3 and losses[-1] < losses[0]
    one = trainer.main([*BINARY, "--steps", "1"])
    assert losses[0] == pytest.approx(one["losses"][0], rel=1e-3)


def test_trainer_pipeline_usage_refusals(monkeypatch, capsys):
    """The reference's checks of the pipeline flags, each a usage error
    (exit 2) before any rank joins the group."""
    from kube_sqs_autoscaler_tpu_torch.workloads import trainer

    monkeypatch.setenv("WORLD_SIZE", "4")
    for argv, message in (
            (["--pipe-parallel", "2", "--zigzag"],
             "--zigzag with --pipe-parallel needs --seq-parallel >= 2"),
            (["--pipe-parallel", "2", "--zigzag", "--seq-parallel", "2",
              "--moe"], "--zigzag with --pipe-parallel does not combine "
             "with --moe"),
            (["--pipe-parallel", "2", "--zigzag", "--seq-parallel", "2",
              "--lora-rank", "4"], "does not combine with --lora-rank"),
            (["--pipe-parallel", "2", "--pipe-microbatches", "3"],
             "--batch-size 8 not divisible by --pipe-microbatches 3"),
            (["--pipe-parallel", "2", "--seq-parallel", "2", "--moe"],
             "--moe with --pipe-parallel does not combine with "
             "--seq-parallel"),
            (["--pipe-parallel", "3"], "4 devices not divisible by "
             "pipe_parallel=3 x model_parallel=1 x seq_parallel=1")):
        with pytest.raises(SystemExit) as exit_:
            trainer.main([*BINARY, "--steps", "1", *argv])
        assert exit_.value.code == 2
        assert message in capsys.readouterr().err


def test_pipeline_state_shardings_moments_follow_their_parameter():
    _, npp, cfg = family("gpt")
    state = train.train_state(params_from_jax(npp, cfg, "cpu"),
                              train.TrainConfig())
    specs = pipeline.pipeline_state_shardings(_fake_mesh(2, 0, 2, 0), state)
    assert specs["step"] is None and specs["optimizer"]["count"] is None
    assert specs["optimizer"]["mu"] == specs["optimizer"]["nu"]
    assert len(specs["optimizer"]["mu"]) == len(train.param_leaves(
        state["params"]))
    params = specs["params"]
    # the replicated leaves lie whole on every rank; the stage stacks
    # split their layers over pipe, and their heads or rows over model
    assert params["embed"] is None and params["pos_embed"] is None
    assert params["stages"]["ln1_scale"] == {"pipe": (0, 1, 2)}
    assert params["stages"]["wq"] == {"pipe": (0, 1, 2),
                                      "model": (2, 1, 2)}
    assert params["stages"]["wo"] == {"pipe": (0, 1, 2),
                                      "model": (1, 1, 2)}
