"""LoRA through the port's pipeline (``lora.py``'s pipeline functions)
held against the JAX package's on its virtual 8-device CPU mesh (the
reference's ``test_lora_pipeline.py``).  Both packages start from the
reference's stage-stacked base and the same adapters (the reference's
``init_pipeline_lora_params`` with ``b`` moved off zero, so both factors
get a gradient), converted by ``convert.params_from_jax`` and
``convert.adapters_from_jax``.  Everything is fp32; tolerances as in
``test_torch_pipeline.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kube_sqs_autoscaler_tpu.workloads import lora as jax_lora
from kube_sqs_autoscaler_tpu.workloads import moe as jax_moe
from kube_sqs_autoscaler_tpu.workloads import pipeline as jax_pipeline
from kube_sqs_autoscaler_tpu.workloads import train as jax_train
from kube_sqs_autoscaler_tpu_torch.workloads import (
    lora, moe, pipeline, train,
)
from kube_sqs_autoscaler_tpu_torch.workloads.convert import (
    adapters_from_jax, params_from_jax,
)
from .torch_mesh_ranks import run_ranks
from .torch_pipeline_ref import MOE, assert_trees_close, batches, family

torch.set_num_threads(1)

RANK = 4
STEP = dict(learning_rate=1e-2, grad_clip_norm=0.5)
# name: (world, family, pipe, tp, micro, schedule, routed, train)
RUNS = {
    "gpt-pp2-gpipe": (2, "gpt", 2, 1, 4, "gpipe", False, STEP),
    "gpt-pp2-1f1b-accum": (2, "gpt", 2, 1, 2, "1f1b", False,
                           dict(STEP, grad_accum=2)),
    "llama-pp2-tp2-1f1b": (4, "llama", 2, 2, 4, "1f1b", False, STEP),
    "gpt-moe-pp2-dp2-1f1b": (4, "gpt", 2, 1, 2, "1f1b", True, STEP),
}
_done: dict = {}


def adapters_for(name):
    """The reference's adapters on the run's base, ``b`` moved off zero."""
    _, fam, *_, routed, _ = RUNS[name]
    _, npp, _ = family(fam, routed=routed)
    adapters = jax_lora.init_pipeline_lora_params(
        jax.random.key(1), npp, jax_lora.LoraConfig(rank=RANK))
    adapters = jax.tree.map(
        lambda x: x + 0.01 * jax.random.normal(jax.random.key(2), x.shape),
        adapters)
    return jax.tree.map(np.asarray, adapters)


def port(name):
    world = RUNS[name][0]
    if name not in _done:
        names = [n for n, r in RUNS.items() if r[0] == world]
        payload = []
        for n in names:
            _, fam, pipe, tp, micro, schedule, routed, options = RUNS[n]
            _, npp, cfg = family(fam, routed=routed)
            payload.append(dict(
                family=fam, config=cfg, pipe=pipe, tp=tp, micro=micro,
                schedule=schedule, train=options, lora=RANK, kind="lora",
                moe=moe.MoeConfig(**MOE) if routed else None,
                params=params_from_jax(npp, cfg, "cpu"),
                adapters=adapters_from_jax(adapters_for(n), "cpu"),
                batches=batches(2, 8)))
        results = run_ranks("pipeline", world, {"runs": payload},
                            timeout=400)
        for i, n in enumerate(names):
            assert all(r[i]["losses"] == results[0][i]["losses"]
                       for r in results)
            _done[n] = results[0][i]
    return _done[name]


def reference(name):
    world, fam, pipe, tp, micro, schedule, routed, options = RUNS[name]
    jcfg, npp, _ = family(fam, routed=routed)
    mesh = jax_pipeline.make_pipeline_mesh(
        jax.devices()[:world], pipe_parallel=pipe, model_parallel=tp)
    lcfg = jax_lora.LoraConfig(rank=RANK)
    pcfg = jax_pipeline.PipelineConfig(n_microbatches=micro,
                                       schedule=schedule)
    base = jax.tree.map(jnp.asarray, npp)
    frozen = jax.device_put(
        base, jax_pipeline.pipeline_param_shardings(mesh, base))
    adapters = jax.tree.map(jnp.asarray, adapters_for(name))
    moe_cfg = jax_moe.MoeConfig(**MOE) if routed else None
    shard = jax_pipeline.pipeline_batch_sharding(mesh)
    toks = [jax.device_put(b.reshape(micro, -1, b.shape[1]), shard)
            for b in batches(2, 8)]
    _, grads = jax.jit(jax_lora.lora_pipeline_value_and_grad(
        mesh, jcfg, pcfg, frozen, lcfg, llama=fam == "llama",
        moe=moe_cfg))(adapters, toks[0])
    tcfg = jax_train.TrainConfig(**options)
    state = jax_lora.init_pipeline_lora_train_state(jax.random.key(1),
                                                    frozen, lcfg, tcfg)
    state = dict(state, adapters=adapters,
                 opt_state=jax_train.make_optimizer(tcfg).init(adapters))
    step_fn = jax_lora.make_lora_pipeline_train_step(
        mesh, jcfg, pcfg, tcfg, frozen, state, lcfg, llama=fam == "llama",
        moe=moe_cfg)
    losses = []
    for t in toks:
        state, loss = step_fn(state, t)
        losses.append(float(loss))
    return losses, grads, state["adapters"]


@pytest.mark.parametrize("name", list(RUNS))
def test_adapter_grads_and_steps_match_the_reference(name):
    got = port(name)
    want_losses, want_grads, want_adapters = reference(name)
    np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-5)
    assert_trees_close(got["grads"], want_grads, atol=2e-6)
    assert_trees_close(got["adapters"], want_adapters, atol=1e-5,
                       rtol=1e-3)


def _stacked_base(name="gpt", routed=False):
    _, npp, cfg = family(name, routed=routed)
    return params_from_jax(npp, cfg, "cpu"), cfg


def test_zero_init_is_identity():
    base, _ = _stacked_base()
    lcfg = lora.LoraConfig(rank=RANK)
    adapters = lora.init_pipeline_lora_params(
        torch.Generator().manual_seed(1), base, lcfg)
    adapted = lora.apply_pipeline_lora(base, adapters, lcfg)
    for a, b in zip(train.param_leaves(base), train.param_leaves(adapted)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name,routed,want", [
    ("gpt", False, ["w_down", "w_up", "wk", "wo", "wq", "wv"]),
    ("llama", False, ["w_down", "w_gate", "w_up", "wk", "wo", "wq", "wv"]),
    ("llama", True, ["w_down_experts", "w_gate_experts", "w_up_experts",
                     "wk", "wo", "wq", "wv"]),
])
def test_adapters_cover_every_stacked_matmul(name, routed, want):
    # the split projections adapt one by one, as the reference's
    base, _ = _stacked_base(name, routed)
    adapters = lora.init_pipeline_lora_params(
        torch.Generator().manual_seed(1), base, lora.LoraConfig(rank=RANK))
    assert sorted(adapters["stages"]) == want
    jadapters = jax_lora.init_pipeline_lora_params(
        jax.random.key(1), family(name, routed=routed)[1],
        jax_lora.LoraConfig(rank=RANK))
    for key, ab in adapters["stages"].items():
        w = base["stages"][key]
        assert ab["a"].shape == (*w.shape[:-1], RANK)
        assert ab["b"].shape == (*w.shape[:-2], RANK, w.shape[-1])
        assert ab["a"].shape == jadapters["stages"][key]["a"].shape


def test_merged_unstacked_equals_the_adapted_pipeline():
    # the checkpoint's merged flat weights and the adapted stage stacks
    # are one model: the flat objective of one equals the one-stage
    # pipeline objective of the other
    base, cfg = _stacked_base()
    lcfg = lora.LoraConfig(rank=RANK)
    adapters = adapters_from_jax(adapters_for("gpt-pp2-gpipe"), "cpu")
    mesh = pipeline.make_pipeline_mesh(1, device="cpu")
    batch = np.random.default_rng(2).integers(0, 64, (8, 16))
    pcfg = pipeline.PipelineConfig(4)
    piped = pipeline.pipeline_loss(
        lora.apply_pipeline_lora(base, adapters, lcfg),
        torch.from_numpy(pipeline.pipeline_rows(batch, mesh, 4).copy()), cfg,
        pcfg, mesh)
    saved = lora.lora_pipeline_checkpoint_state(
        base, {"adapters": adapters, "optimizer": None, "step": 3}, lcfg)
    assert saved["step"] == 3 and "layers" in saved["params"]
    flat = train.loss_fn(saved["params"], torch.from_numpy(batch), cfg)
    assert piped.item() == pytest.approx(flat.item(), rel=1e-6)


TRAINER = ["--device", "cpu", "--vocab-size", "256", "--d-model", "64",
           "--n-heads", "4", "--n-layers", "4", "--d-ff", "128",
           "--seq-len", "32", "--batch-size", "8", "--learning-rate", "1e-2",
           "--log-every", "1", "--lora-rank", "4", "--pipe-parallel", "2",
           "--pipe-microbatches", "2"]


def test_trainer_resume_equals_uninterrupted(tmp_path):
    """The LoRA lifecycle through the pipeline over 2 ranks: interrupt and
    resume replays exactly (the stage-stacked adapters and the step from
    the checkpoint, the frozen stacks rebuilt from the seed), and the
    merged weights on disk are flat (kind ``lora``), so the worker's
    restore needs no unstacking."""
    from kube_sqs_autoscaler_tpu_torch.workloads.checkpoint import (
        TrainCheckpointer, load_model_layout, load_model_manifest,
    )

    full_dir, split_dir = str(tmp_path / "full"), str(tmp_path / "split")
    full = run_ranks("trainer", 2, {"argv": TRAINER + [
        "--steps", "6", "--checkpoint-dir", full_dir]}, timeout=300)
    run_ranks("trainer", 2, {"argv": TRAINER + [
        "--steps", "4", "--checkpoint-dir", split_dir, "--checkpoint-every",
        "2"]}, timeout=300)
    resumed = run_ranks("trainer", 2, {"argv": TRAINER + [
        "--steps", "2", "--checkpoint-dir", split_dir, "--resume"]},
        timeout=300)
    assert resumed[0]["final_step"] == 6
    assert resumed[0]["losses"] == full[0]["losses"][4:]
    assert load_model_layout(full_dir) == {
        "kind": "lora", "rank": 4, "seed": 0, "base": "",
        "pipeline_stages": 2}
    family_name, config = load_model_manifest(full_dir)
    a = TrainCheckpointer(full_dir).restore_params(
        family_name, config, layout=load_model_layout(full_dir),
        device="cpu")
    b = TrainCheckpointer(split_dir).restore_params(
        family_name, config, layout=load_model_layout(split_dir),
        device="cpu")
    for x, y in zip(train.param_leaves(a), train.param_leaves(b)):
        assert torch.equal(x, y)
    for x, y in zip(train.param_leaves(a),
                    train.param_leaves(full[0]["params"])):
        assert torch.equal(x, y)


@pytest.mark.parametrize("extra", [
    ["--family", "llama", "--n-kv-heads", "2", "--batch-size", "16",
     "--grad-accum", "2", "--eval-every", "4", "--eval-batches", "2"],
    ["--pipe-schedule", "1f1b"],
    ["--moe", "--moe-experts", "4", "--n-layers", "2"],
], ids=["llama-accum-eval", "1f1b", "moe"])
def test_trainer_pipeline_lora_learns(extra):
    ranks = run_ranks("trainer", 2, {"argv": TRAINER + [
        "--steps", "4", "--overfit", *extra]}, timeout=300)
    losses = ranks[0]["losses"]
    assert ranks[0]["final_step"] == 4
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
