"""Shared pieces of the port's pipeline parity tests: the tiny fp32
configurations, the weights both packages get (the reference's stage-stacked
``init_*_params``, converted by ``convert.params_from_jax``), the port's
runs on gloo ranks (``torch_mesh_ranks.py``'s ``pipeline`` case, one spawn
per rank count holding every run of that count that a test file asks
for) and the reference's loss, gradients and train steps on its virtual
8-device CPU mesh of the same shape.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from kube_sqs_autoscaler_tpu.workloads import llama as jax_llama
from kube_sqs_autoscaler_tpu.workloads import model as jax_model
from kube_sqs_autoscaler_tpu.workloads import moe as jax_moe
from kube_sqs_autoscaler_tpu.workloads import pipeline as jax_pipeline
from kube_sqs_autoscaler_tpu.workloads import train as jax_train
from kube_sqs_autoscaler_tpu_torch.workloads import llama, model, moe
from kube_sqs_autoscaler_tpu_torch.workloads.convert import params_from_jax
from .torch_mesh_ranks import run_ranks

GPT = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=4, d_ff=64,
           max_seq_len=16)
LLAMA = dict(vocab_size=64, d_model=32, n_heads=4, n_kv_heads=2,
             n_layers=4, d_ff=48, max_seq_len=16)
MOE = dict(n_experts=4, top_k=2, capacity_factor=4.0)


def family(name: str, window=None, routed: bool = False,
           untied: bool = False):
    """``(jax config, numpy stage-stacked params, port config)``;
    ``untied`` gives the llama an ``lm_head`` of its own (an HF import's
    readout)."""
    if name == "gpt":
        jcfg = jax_model.ModelConfig(**GPT, dtype=jnp.float32)
        cfg = model.ModelConfig(**GPT, dtype=torch.float32)
        if routed:
            params = jax_moe.init_moe_params(jax.random.key(0), jcfg,
                                             jax_moe.MoeConfig(**MOE))
        else:
            params = jax_model.init_params(jax.random.key(0), jcfg)
        stacked = jax_pipeline.as_pipeline_params(params)
    else:
        jcfg = jax_llama.LlamaConfig(**LLAMA, sliding_window=window,
                                     dtype=jnp.float32)
        cfg = llama.LlamaConfig(**LLAMA, sliding_window=window,
                                dtype=torch.float32)
        if routed:
            params = jax_moe.init_llama_moe_params(
                jax.random.key(1), jcfg, jax_moe.MoeConfig(**MOE))
        else:
            params = jax_llama.init_llama_params(jax.random.key(1), jcfg)
        if untied:
            params = dict(params, lm_head=jax.random.normal(
                jax.random.key(7), params["embed"].shape, jnp.float32)
                * 0.02)
        stacked = jax_pipeline.as_llama_pipeline_params(params)
    return jcfg, jax.tree.map(np.asarray, stacked), cfg


def batches(n: int, rows: int, seq: int = 16, seed: int = 3) -> list:
    """``n`` global ``[rows, seq]`` int32 batches."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, GPT["vocab_size"], (rows, seq), dtype=np.int32)
            for _ in range(n)]


def spec(world, fam, pipe, micro, schedule, kind="grads", tp=1, sp=1,
         window=None, rows=8, steps=1, train=None, zigzag=False,
         routed=False, untied=False, ref_tp=None):
    """One run: ``world`` ranks of ``pipe`` x ``data`` x ``sp`` x ``tp``,
    ``micro`` microbatches of a global ``[rows, 16]`` batch.  ``ref_tp``
    runs the reference with that ``model_parallel`` instead (its MoE
    stages under tp are held to its own no-tp truth, see
    ``test_torch_pipeline_4axis.py``)."""
    return dict(world=world, family=fam, pipe=pipe, tp=tp, sp=sp,
                micro=micro, schedule=schedule, kind=kind, window=window,
                rows=rows, steps=steps, train=train or {}, zigzag=zigzag,
                routed=routed, untied=untied, ref_tp=ref_tp)


class Runs:
    """A test file's runs ``{name: spec}``: the port's, one spawn per rank
    count holding every run of it, and the reference's, one at a time."""

    def __init__(self, runs: dict):
        self.runs = runs
        self.done: dict = {}

    def port(self, name: str) -> dict:
        world = self.runs[name]["world"]
        if name not in self.done:
            names = [n for n, r in self.runs.items() if r["world"] == world
                     and n not in self.done]
            payload = []
            for n in names:
                r = self.runs[n]
                _, npp, cfg = family(r["family"], r["window"],
                                     r["routed"], r["untied"])
                payload.append(dict(
                    family=r["family"], config=cfg, pipe=r["pipe"],
                    tp=r["tp"], sp=r["sp"], micro=r["micro"],
                    schedule=r["schedule"], kind=r["kind"],
                    train=r["train"], zigzag=r["zigzag"],
                    moe=moe.MoeConfig(**MOE) if r["routed"] else None,
                    params=params_from_jax(npp, cfg, "cpu"),
                    batches=batches(r["steps"], r["rows"])))
            results = run_ranks("pipeline", world, {"runs": payload},
                                timeout=400)
            for i, n in enumerate(names):
                first = dict(results[0][i])
                if "losses" in first:
                    assert all(res[i]["losses"] == first["losses"]
                               for res in results)
                if "embed_part" in first:
                    first["embed_parts"] = [
                        (res[i]["pipe_index"], res[i]["embed_part"])
                        for res in results]
                self.done[n] = first
        return self.done[name]

    def reference(self, name: str):
        """The reference's ``(loss, grads)`` or ``(losses, params)``."""
        r = self.runs[name]
        jcfg, npp, _ = family(r["family"], r["window"], r["routed"],
                              r["untied"])
        tp = r["tp"] if r["ref_tp"] is None else r["ref_tp"]
        mesh = jax_pipeline.make_pipeline_mesh(
            jax.devices()[:r["world"] // r["tp"] * tp],
            pipe_parallel=r["pipe"], model_parallel=tp, seq_parallel=r["sp"])
        pcfg = jax_pipeline.PipelineConfig(n_microbatches=r["micro"],
                                           schedule=r["schedule"])
        shard = jax_pipeline.pipeline_batch_sharding(mesh)
        toks = [jax.device_put(b.reshape(r["micro"], -1, b.shape[1]), shard)
                for b in batches(r["steps"], r["rows"])]
        params = jax.tree.map(jnp.asarray, npp)
        is_llama = r["family"] == "llama"
        moe_cfg = jax_moe.MoeConfig(**MOE) if r["routed"] else None
        if r["kind"] == "grads":
            vag = reference_vag(r, jcfg, pcfg, mesh, is_llama, moe_cfg)
            loss, grads = jax.jit(vag)(params, toks[0])
            return float(loss), grads
        tcfg = jax_train.TrainConfig(**r["train"])
        state = jax_pipeline.place_pipeline_state(mesh, {
            "params": params,
            "opt_state": jax_train.make_optimizer(tcfg).init(params),
            "step": jnp.zeros((), jnp.int32)})
        if r["zigzag"]:
            step_fn = jax_pipeline.make_zigzag_pipeline_train_step(
                mesh, jcfg, pcfg, tcfg, state, llama=is_llama)
        elif moe_cfg is not None:
            step_fn = jax_pipeline.make_moe_pipeline_train_step(
                mesh, jcfg, moe_cfg, pcfg, tcfg, state, llama=is_llama)
        elif is_llama:
            step_fn = jax_pipeline.make_llama_pipeline_train_step(
                mesh, jcfg, pcfg, tcfg, state)
        else:
            step_fn = jax_pipeline.make_pipeline_train_step(
                mesh, jcfg, pcfg, tcfg, state)
        losses = []
        for t in toks:
            state, loss = step_fn(state, t)
            losses.append(float(loss))
        return losses, state["params"]


def reference_vag(r, jcfg, pcfg, mesh, is_llama, moe_cfg):
    """The reference's value-and-grad of the run's objective and
    schedule."""
    p = jax_pipeline
    if r["zigzag"]:
        if r["schedule"] == "1f1b":
            return lambda a, t: p.zigzag_one_f_one_b_value_and_grad(
                a, t, jcfg, pcfg, mesh, llama=is_llama)
        return jax.value_and_grad(lambda a, t: p.zigzag_pipeline_loss_fn(
            a, t, jcfg, pcfg, mesh, llama=is_llama))
    if moe_cfg is not None:
        if r["schedule"] == "1f1b":
            return lambda a, t: p.moe_one_f_one_b_value_and_grad(
                a, t, jcfg, moe_cfg, pcfg, mesh, llama=is_llama)
        return jax.value_and_grad(lambda a, t: p.moe_pipeline_loss_fn(
            a, t, jcfg, moe_cfg, pcfg, mesh, llama=is_llama))
    if r["schedule"] == "1f1b":
        fn = (p.llama_one_f_one_b_value_and_grad if is_llama
              else p.one_f_one_b_value_and_grad)
        return lambda a, t: fn(a, t, jcfg, pcfg, mesh)
    fn = p.llama_pipeline_loss_fn if is_llama else p.pipeline_loss_fn
    return jax.value_and_grad(lambda a, t: fn(a, t, jcfg, pcfg, mesh))


def named(tree, prefix: str = "") -> dict:
    """``{"stages.wq": array, ...}`` of a nested dict of jax arrays or
    torch tensors, fp32 numpy."""
    out = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            out.update(named(value, path + "."))
        elif isinstance(value, torch.Tensor):
            out[path] = value.detach().float().numpy()
        else:
            out[path] = np.asarray(value, np.float32)
    return out


def assert_trees_close(got, want, atol: float, rtol: float = 1e-4) -> None:
    got, want = named(got), named(want)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=atol, rtol=rtol,
                                   err_msg=key)
