"""The port's pipeline on the llama family (RoPE, GQA, RMSNorm, SwiGLU,
the sliding window, an untied ``lm_head``) held against the JAX package's
``pipeline.py`` on its virtual 8-device CPU mesh (the reference's
``test_pipeline_llama.py``).  Everything is fp32; tolerances as in
``test_torch_pipeline.py``.
"""

import numpy as np
import pytest
import torch

from kube_sqs_autoscaler_tpu.workloads import pipeline as jax_pipeline
from kube_sqs_autoscaler_tpu_torch.workloads import llama, pipeline, train
from kube_sqs_autoscaler_tpu_torch.workloads.convert import params_from_jax
from .test_torch_pipeline import assert_params_close
from .torch_pipeline_ref import Runs, assert_trees_close, family, spec

torch.set_num_threads(1)

STEP = dict(learning_rate=1e-2, grad_clip_norm=0.5, warmup_steps=1,
            decay_steps=4)
RUNS = Runs({
    "pp2-gpipe": spec(2, "llama", 2, 4, "gpipe", rows=4),
    "window5-pp2-gpipe": spec(2, "llama", 2, 4, "gpipe", rows=4, window=5),
    "untied-pp2-1f1b": spec(2, "llama", 2, 4, "1f1b", rows=4, untied=True),
    "pp4-1f1b": spec(4, "llama", 4, 4, "1f1b", rows=4),
    "pp2-tp2-1f1b": spec(4, "llama", 2, 4, "1f1b", tp=2, rows=4),
    "pp2-sp2-gpipe": spec(4, "llama", 2, 4, "gpipe", sp=2, rows=4),
    "window5-pp2-sp2-1f1b": spec(4, "llama", 2, 4, "1f1b", sp=2, rows=4,
                                 window=5),
    "pp2-dp2-1f1b-accum-steps": spec(4, "llama", 2, 2, "1f1b", kind="steps",
                                     rows=8, steps=2,
                                     train=dict(STEP, grad_accum=2)),
    "untied-pp2-tp2-gpipe-steps": spec(4, "llama", 2, 2, "gpipe",
                                       kind="steps", tp=2, rows=4, steps=2,
                                       untied=True, train=STEP),
})
GRADS = [n for n, r in RUNS.runs.items() if r["kind"] == "grads"]
STEPS = [n for n, r in RUNS.runs.items() if r["kind"] == "steps"]


@pytest.mark.parametrize("name", GRADS)
def test_llama_pipeline_loss_and_grads_match_the_reference(name):
    got = RUNS.port(name)
    want_loss, want_grads = RUNS.reference(name)
    assert got["loss"] == pytest.approx(want_loss, rel=1e-5)
    assert got["eval"] == pytest.approx(want_loss, rel=1e-5)
    assert_trees_close(got["grads"], want_grads, atol=2e-6)


@pytest.mark.parametrize("name", STEPS)
def test_llama_pipeline_train_steps_match_the_reference(name):
    got = RUNS.port(name)
    want_losses, want_params = RUNS.reference(name)
    np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-5)
    assert_params_close(got["params"], want_params)


def test_untied_readout_takes_its_own_gradient():
    # an HF import's lm_head gets the readout gradient; the embedding only
    # its lookup gradient (the reference's _llama_embed_head)
    got = RUNS.port("untied-pp2-1f1b")
    assert "lm_head" in got["grads"]
    parts = dict(got["embed_parts"])
    # the last stage never reads the embedding when the readout is untied
    assert not parts[1].any() and parts[0].abs().max() > 0


def test_stack_unstack_round_trip_and_split_projections():
    _, npp, cfg = family("llama")
    staged = params_from_jax(npp, cfg, "cpu")
    # the stage stack splits wkv into wk / wv and w_gate_up into
    # w_gate / w_up, as the reference's
    assert sorted(staged["stages"]) == sorted(npp["stages"])
    assert {"wk", "wv", "w_gate", "w_up"} <= set(staged["stages"])
    flat = pipeline.unstack_llama_layers(staged)
    assert {"wkv", "w_gate_up"} <= set(flat["layers"][0])
    jflat = jax_pipeline.unstack_llama_layers(npp)
    for layer, jlayer in zip(flat["layers"], jflat["layers"]):
        assert sorted(layer) == sorted(jlayer)
        for name in jlayer:
            np.testing.assert_array_equal(layer[name].numpy(),
                                          np.asarray(jlayer[name]))
    again = pipeline.as_llama_pipeline_params(flat)
    for name, t in staged["stages"].items():
        assert torch.equal(again["stages"][name], t)
    with pytest.raises(ValueError, match="n_layers=4 not divisible by "
                       "n_stages=3"):
        pipeline.init_llama_pipeline_params(
            cfg, torch.Generator().manual_seed(0), 3, "cpu")


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_one_stage_llama_pipeline_equals_the_flat_objective(schedule):
    _, npp, cfg = family("llama", window=5)
    staged = params_from_jax(npp, cfg, "cpu")
    mesh = pipeline.make_pipeline_mesh(1, device="cpu")
    state = pipeline.place_pipeline_state(mesh, train.train_state(
        staged, train.TrainConfig()))
    batch = np.random.default_rng(1).integers(0, 64, (4, 16))
    vag = pipeline.pipeline_value_and_grad(
        cfg, pipeline.PipelineConfig(2, schedule), mesh, llama=True)
    loss, grads = vag(state["params"], torch.from_numpy(
        pipeline.pipeline_rows(batch, mesh, 2).copy()))
    flat = train.train_state(pipeline.unstack_llama_layers(staged),
                             train.TrainConfig())
    want_loss, want = train.value_and_grad(
        lambda p, t: llama.llama_loss_fn(
            p, t, cfg, llama.llama_attention_fn_for(cfg, 16, "cpu")),
        flat["params"], torch.from_numpy(batch))
    assert loss.item() == pytest.approx(want_loss.item(), rel=1e-6)
    assert_trees_close(grads, pipeline.as_llama_pipeline_params(want),
                       atol=1e-7)


def test_pipeline_grad_accum_requires_divisible_batch():
    _, npp, cfg = family("llama")
    mesh = pipeline.make_pipeline_mesh(1, device="cpu")
    tcfg = train.TrainConfig(grad_accum=3)
    state = pipeline.place_pipeline_state(mesh, train.train_state(
        params_from_jax(npp, cfg, "cpu"), tcfg))
    step_fn = pipeline.make_pipeline_train_step(
        mesh, cfg, pipeline.PipelineConfig(2), tcfg, llama=True)
    with pytest.raises(ValueError, match="batch axis 1 \\(size 4\\) not "
                       "divisible by grad_accum=3"):
        step_fn(state, torch.zeros((2, 4, 16), dtype=torch.long))


def test_hf_checkpoint_trains_through_the_pipeline_and_serves(tmp_path):
    """An imported HF llama (untied ``lm_head``) fine-tuned through the
    pipeline over 2 ranks, then served flat by the single-card worker,
    the readout included."""
    pytest.importorskip("transformers")
    from transformers import LlamaConfig as HFConfig, LlamaForCausalLM

    from kube_sqs_autoscaler_tpu_torch.workloads import __main__ as worker
    from kube_sqs_autoscaler_tpu_torch.workloads.checkpoint import (
        TrainCheckpointer, load_model_layout, load_model_manifest,
    )
    from .torch_mesh_ranks import run_ranks

    torch.manual_seed(0)
    hf = LlamaForCausalLM(HFConfig(
        vocab_size=128, hidden_size=64, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, tie_word_embeddings=False,
        attn_implementation="eager",
    ))
    hf_dir, ckpt = tmp_path / "hf", tmp_path / "trained"
    hf.save_pretrained(hf_dir)
    ranks = run_ranks("trainer", 2, {"argv": [
        "--device", "cpu", "--hf-checkpoint", str(hf_dir),
        "--pipe-parallel", "2", "--pipe-microbatches", "2",
        "--pipe-schedule", "1f1b", "--steps", "4", "--batch-size", "8",
        "--seq-len", "16", "--learning-rate", "1e-2", "--log-every", "1",
        "--overfit", "--checkpoint-dir", str(ckpt), "--checkpoint-every",
        "0"]}, timeout=300)
    losses = ranks[0]["losses"]
    assert ranks[0]["final_step"] == 4
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    family_name, config = load_model_manifest(ckpt)
    assert load_model_layout(ckpt) == {"kind": "pipeline", "n_stages": 2}
    served = TrainCheckpointer(ckpt).restore_params(
        family_name, config, layout=load_model_layout(ckpt), device="cpu")
    assert served["lm_head"].shape == (config.vocab_size, config.d_model)
    for a, b in zip(train.param_leaves(served),
                    train.param_leaves(ranks[0]["params"])):
        assert torch.equal(a, b)
    out = worker.main(["--device", "cpu", "--checkpoint-dir", str(ckpt),
                       "--demo", "2", "--batch-size", "1", "--seq-len", "8",
                       "--generate-tokens", "3", "--result-queue-url",
                       "demo://replies"])
    assert len(out["replies"]) == 2
    with pytest.raises(SystemExit, match="HF model has n_layers=2, not "
                       "divisible by --pipe-parallel 4"):
        from kube_sqs_autoscaler_tpu_torch.workloads import trainer

        trainer.stage_stacked(trainer.build_parser().parse_args(
            ["--pipe-parallel", "4", "--family", "llama"]), config, {}, True)
