"""The port's LoRA held against the JAX package's, on the CPU.

The reference's ``tests/test_lora.py`` cases that need no mesh, in the
port (zero-init identity, adapter size, adapter-only training, merge
semantics, resume, accumulation, the MoE expert stacks, the refusals),
then parity: adapters from the reference's ``init_lora_params`` reach the
port through ``convert.adapters_from_jax``, and the adapted loss, its
adapter gradients and three adapter-only steps are held against the
reference's.  fp32, with ``tests/test_torch_train.py``'s tolerances
(losses rtol 1e-5, gradients atol 1e-5, parameters after Adam steps all
but 0.1% within 2e-6 and every entry within 2e-5).
"""

import itertools
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kube_sqs_autoscaler_tpu.workloads import data as jax_data
from kube_sqs_autoscaler_tpu.workloads import llama as jax_llama
from kube_sqs_autoscaler_tpu.workloads import lora as jax_lora
from kube_sqs_autoscaler_tpu.workloads import model as jax_model
from kube_sqs_autoscaler_tpu.workloads import moe as jax_moe
from kube_sqs_autoscaler_tpu.workloads import train as jax_train
from kube_sqs_autoscaler_tpu_torch.workloads import (
    llama, lora, model, moe, train, trainer,
)
from kube_sqs_autoscaler_tpu_torch.workloads.checkpoint import (
    TrainCheckpointer, load_model_layout, load_model_manifest,
)
from kube_sqs_autoscaler_tpu_torch.workloads.convert import (
    adapters_from_jax, params_from_jax,
)

from .test_torch_llama_train import (
    assert_grads_close, assert_params_close, port_leaves, tree_leaves,
)

torch.set_num_threads(1)

GPT = dict(vocab_size=256, d_model=64, n_heads=4, n_layers=2, d_ff=128,
           max_seq_len=64)
LLAMA = dict(vocab_size=256, d_model=64, n_heads=4, n_kv_heads=2,
             n_layers=2, d_ff=96, max_seq_len=64)
FLAGS = ["--device", "cpu", "--vocab-size", "256", "--d-model", "64",
         "--n-heads", "4", "--n-layers", "2", "--d-ff", "128", "--seq-len",
         "32", "--batch-size", "8", "--learning-rate", "1e-2",
         "--log-every", "1", "--lora-rank", "4"]


def tokens(batch=8, seq=32, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (batch, seq)).astype(np.int32)


def gpt_base(dtype=torch.float32, seed=0):
    config = model.ModelConfig(**GPT, dtype=dtype)
    return config, model.init_params(config, torch.Generator().manual_seed(
        seed), "cpu")


def reference_case(name, rank=4, seed=0):
    """(reference config, loss, params, adapters with B moved off zero;
    the port's config, loss, params, adapters), all fp32, the adapters
    carried across."""
    jlora = jax_lora.LoraConfig(rank=rank)
    if name == "gpt":
        jcfg = jax_model.ModelConfig(**GPT, dtype=jnp.float32)
        tcfg = model.ModelConfig(**GPT, dtype=torch.float32)
        jp = jax_model.init_params(jax.random.key(seed), jcfg)
        losses = (partial(jax_train.loss_fn, config=jcfg),
                  partial(train.loss_fn, config=tcfg))
    elif name == "llama":
        jcfg = jax_llama.LlamaConfig(**LLAMA, sliding_window=8,
                                     dtype=jnp.float32)
        tcfg = llama.LlamaConfig(**LLAMA, sliding_window=8,
                                 dtype=torch.float32)
        jp = jax_llama.init_llama_params(jax.random.key(seed), jcfg)
        losses = (partial(jax_llama.llama_loss_fn, config=jcfg),
                  partial(llama.llama_loss_fn, config=tcfg))
    else:
        jcfg = jax_model.ModelConfig(**GPT, dtype=jnp.float32)
        tcfg = model.ModelConfig(**GPT, dtype=torch.float32)
        jmoe = jax_moe.MoeConfig(n_experts=4, top_k=2)
        jp = jax_moe.init_moe_params(jax.random.key(seed), jcfg, jmoe)
        tmoe = moe.MoeConfig(n_experts=4, top_k=2)
        losses = (partial(jax_moe.moe_loss_fn, config=jcfg, moe=jmoe),
                  partial(moe.moe_loss_fn, config=tcfg, moe=tmoe))
    npp = jax.tree.map(np.asarray, jp)
    adapters = jax_lora.init_lora_params(jax.random.key(seed + 1), jp, jlora)
    # move B off zero, so the delta (and the gradient to A) is live
    rng = np.random.default_rng(seed + 2)
    adapters = jax.tree.map(
        lambda x: np.asarray(x) + (rng.standard_normal(x.shape) * 0.01)
        .astype(np.float32), adapters)
    return ((jcfg, losses[0], npp, adapters, jlora),
            (tcfg, losses[1], params_from_jax(npp, tcfg, "cpu"),
             adapters_from_jax(adapters, "cpu"), lora.LoraConfig(rank=rank)))


def test_zero_init_is_identity_and_targets():
    _, base = gpt_base()
    config = lora.LoraConfig(rank=4)
    adapters = lora.init_lora_params(torch.Generator().manual_seed(1), base,
                                     config)
    adapted = lora.apply_lora(base, adapters, config)
    for a, b in zip(train.param_leaves(base), train.param_leaves(adapted)):
        assert torch.equal(a, b)
    assert set(adapters["layers"][0]) == {"wqkv", "wo", "w_up", "w_down"}
    assert lora.lora_param_count(adapters) < 0.25 * model.param_count(base)
    assert adapters["layers"][0]["wqkv"]["a"].shape == (64, 4)
    assert adapters["layers"][0]["wqkv"]["b"].shape == (4, 192)
    lcfg = llama.LlamaConfig(**LLAMA)
    lparams = llama.init_llama_params(lcfg, torch.Generator().manual_seed(0),
                                      "cpu")
    assert set(lora.init_lora_params(torch.Generator(), lparams, config)[
        "layers"][0]) == {"wq", "wkv", "wo", "w_gate_up", "w_down"}
    with pytest.raises(ValueError, match="rank"):
        lora.LoraConfig(rank=0)
    with pytest.raises(ValueError, match="no targeted weights"):
        lora.init_lora_params(torch.Generator(), base,
                              lora.LoraConfig(targets=("nope",)))
    assert lora.DEFAULT_TARGETS == jax_lora.DEFAULT_TARGETS


def test_lora_training_moves_loss_and_only_adapters():
    tcfg, base = gpt_base()
    frozen = [t.clone() for t in train.param_leaves(base)]
    config = lora.LoraConfig(rank=4)
    tc = train.TrainConfig(learning_rate=3e-2)
    state = lora.init_lora_train_state(torch.Generator().manual_seed(2),
                                       base, config, tc)
    step = lora.make_lora_train_step(tcfg, tc, base, config, "cpu")
    ids = torch.from_numpy(tokens())
    base_loss = train.loss_fn(base, ids, tcfg).item()
    losses = [step(state, ids)[1].item() for _ in range(5)]
    # step 0's loss is the frozen model's (B = 0 start)
    assert losses[0] == pytest.approx(base_loss, abs=1e-5)
    assert losses[-1] < losses[0]
    for a, b in zip(frozen, train.param_leaves(base)):
        assert torch.equal(a, b)
    assert state["adapters"]["layers"][0]["wqkv"]["b"].abs().max() > 0
    assert state["step"] == 5


def test_merge_equals_adapted_forward():
    tcfg, base = gpt_base()
    config = lora.LoraConfig(rank=4)
    adapters = lora.init_lora_params(torch.Generator().manual_seed(3), base,
                                     config)
    for layer in adapters["layers"]:
        for ab in layer.values():
            ab["b"] += 0.01
    ids = torch.from_numpy(tokens(2, 16))
    adapted = train.loss_fn(lora.apply_lora(base, adapters, config), ids,
                            tcfg).item()
    merged = lora.merge_lora(base, adapters, config)
    assert not any(t.requires_grad for t in train.param_leaves(merged))
    assert train.loss_fn(merged, ids, tcfg).item() == pytest.approx(
        adapted, rel=1e-6)
    assert adapted != pytest.approx(train.loss_fn(base, ids, tcfg).item(),
                                    abs=1e-4)


@pytest.mark.parametrize("name", ["gpt", "llama", "moe"])
def test_adapted_loss_and_adapter_grads_match_reference(name):
    (jcfg, jloss, npp, jad, jlora), (tcfg, tloss, tp, tad, tlora) = \
        reference_case(name)
    ids = tokens(2, 32, seed=5)
    jp = jax.tree.map(jnp.asarray, npp)

    def ref(adapters):
        return jloss(jax_lora.apply_lora(jp, adapters, jlora),
                     jnp.asarray(ids))

    want, want_grads = jax.jit(jax.value_and_grad(ref))(
        jax.tree.map(jnp.asarray, jad))
    leaves = [t.requires_grad_(True) for t in train.param_leaves(tad)]
    value = tloss(lora.apply_lora(tp, tad, tlora), torch.from_numpy(ids))
    grads = train._unflatten(tad, torch.autograd.grad(value, leaves))
    np.testing.assert_allclose(value.item(), float(want), rtol=1e-5)
    assert_grads_close(grads, want_grads)
    # the merged weights are the reference's
    merged = jax_lora.merge_lora(jp, jax.tree.map(jnp.asarray, jad), jlora)
    got = lora.merge_lora(tp, tad, tlora)
    for g, w in zip(port_leaves(got), tree_leaves(merged)):
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=0)


@pytest.mark.parametrize("name", ["gpt", "llama"])
def test_three_adapter_steps_match_the_reference_step(name):
    (jcfg, jloss, npp, jad, jlora), (tcfg, tloss, tp, tad, tlora) = \
        reference_case(name, seed=3)
    config = jax_train.TrainConfig(learning_rate=1e-3, grad_accum=2)
    mesh = jax_train.make_mesh(jax.devices()[:1], model_parallel=1)
    jad = jax.tree.map(jnp.asarray, jad)
    jstate = {"adapters": jad,
              "opt_state": jax_train.make_optimizer(config).init(jad),
              "step": jnp.zeros((), jnp.int32)}
    loss = None if name == "gpt" else jax_llama.llama_mesh_loss(jcfg, config)
    jstep = jax_lora.make_lora_train_step(
        mesh, jcfg, config, jax.tree.map(jnp.asarray, npp), jstate, jlora,
        loss=loss)
    port_config = train.TrainConfig(learning_rate=1e-3, grad_accum=2)
    leaves = [t.requires_grad_(True) for t in train.param_leaves(tad)]
    adapters = train._unflatten(tad, leaves)
    state = {"adapters": adapters,
             "optimizer": train.make_optimizer(port_config, adapters),
             "step": 0}
    ploss = None if name == "gpt" else llama.llama_mesh_loss(tcfg,
                                                             port_config)
    step = lora.make_lora_train_step(tcfg, port_config, tp, tlora, "cpu",
                                     loss=ploss)
    stream = jax_data.synthetic_token_stream(256, 4, 32, seed=9)
    for batch in itertools.islice(stream, 3):
        jstate, jl = jstep(jstate, jnp.asarray(batch))
        state, tl = step(state, torch.from_numpy(batch))
        np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    assert_params_close(port_leaves(state["adapters"]),
                        tree_leaves(jstate["adapters"]))


def test_lora_grad_accum_matches_single_pass():
    tcfg, base = gpt_base()
    config = lora.LoraConfig(rank=4)
    adapters = lora.init_lora_params(torch.Generator().manual_seed(2), base,
                                     config)
    adapters = train._unflatten(adapters, [
        t.requires_grad_(True) for t in train.param_leaves(adapters)])
    ids = torch.from_numpy(tokens())

    def adapter_loss(ad, t):
        return train.loss_fn(lora.apply_lora(base, ad, config), t, tcfg)

    def vag(ad, t):
        return train.value_and_grad(adapter_loss, ad, t)

    loss1, grads1 = vag(adapters, ids)
    loss2, grads2 = train.accumulate_value_and_grad(vag, 2)(adapters, ids)
    assert loss2.item() == pytest.approx(loss1.item(), rel=1e-5)
    for a, b in zip(port_leaves(grads1), port_leaves(grads2)):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-6)


def test_lora_moe_adapters_cover_expert_stacks():
    tcfg = model.ModelConfig(**GPT)
    params = moe.init_moe_params(tcfg, moe.MoeConfig(n_experts=4, top_k=2),
                                 torch.Generator().manual_seed(0), "cpu")
    config = lora.LoraConfig(rank=4)
    adapters = lora.init_lora_params(torch.Generator().manual_seed(1),
                                     params, config)
    layer0 = adapters["layers"][0]
    assert "router" not in layer0
    assert layer0["w_up_experts"]["a"].shape == (4, 64, 4)
    assert layer0["w_up_experts"]["b"].shape == (4, 4, 128)
    assert layer0["w_down_experts"]["a"].shape == (4, 128, 4)
    adapted = lora.apply_lora(params, adapters, config)
    for a, b in zip(train.param_leaves(params), train.param_leaves(adapted)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("extra", [
    ["--grad-accum", "2"],
    ["--moe", "--moe-experts", "4", "--eval-every", "4", "--eval-batches",
     "2"],
    ["--moe", "--moe-experts", "4", "--family", "llama"],
    ["--family", "llama", "--sliding-window", "8", "--eval-every", "2"],
], ids=["accum", "moe-eval", "llama-moe", "llama-window-eval"])
def test_lora_trainer_learns(extra):
    result = trainer.main(FLAGS + ["--steps", "4", "--overfit", *extra])
    assert result["final_step"] == 4
    losses = result["losses"]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


@pytest.mark.parametrize("extra", [[], ["--moe", "--moe-experts", "4"]],
                         ids=["dense", "moe"])
def test_lora_trainer_resume_equals_uninterrupted(tmp_path, extra):
    full_dir, split_dir = str(tmp_path / "full"), str(tmp_path / "split")
    base = FLAGS + extra
    full = trainer.main(base + ["--steps", "6", "--checkpoint-dir",
                                full_dir])
    first = trainer.main(base + ["--steps", "4", "--checkpoint-dir",
                                 split_dir, "--checkpoint-every", "2"])
    resumed = trainer.main(base + ["--steps", "2", "--checkpoint-dir",
                                   split_dir, "--resume"])
    assert resumed["final_step"] == 6
    assert first["losses"] + resumed["losses"] == full["losses"]
    family, config = load_model_manifest(full_dir)
    layout = load_model_layout(full_dir)
    if not extra:
        assert layout == {"kind": "lora", "rank": 4, "seed": 0, "base": ""}
        a = TrainCheckpointer(full_dir).restore_params(family, config,
                                                       layout=layout,
                                                       device="cpu")
        b = TrainCheckpointer(split_dir).restore_params(family, config,
                                                        layout=layout,
                                                        device="cpu")
        for x, y in zip(train.param_leaves(a), train.param_leaves(b)):
            assert torch.equal(x, y)
    else:
        assert layout == {"kind": "moe", "n_experts": 4, "top_k": 2,
                          "lora_rank": 4, "seed": 0}
    # another seed would rebuild another base: the layout record refuses
    with pytest.raises(SystemExit, match="layout"):
        trainer.main(base + ["--steps", "1", "--checkpoint-dir", split_dir,
                             "--resume", "--seed", "1"])
    # a dense resume of a lora directory fails loudly
    with pytest.raises(SystemExit, match="layout"):
        trainer.main(FLAGS[:-2] + extra + ["--steps", "1", "--checkpoint-dir",
                                           full_dir, "--resume"])


def test_restore_lora_refuses_a_checkpoint_without_adapters(tmp_path):
    tcfg, base = gpt_base()
    TrainCheckpointer(tmp_path).save(train.train_state(base,
                                                       train.TrainConfig()))
    state = lora.init_lora_train_state(torch.Generator(), base,
                                       lora.LoraConfig(), train.TrainConfig())
    with pytest.raises(ValueError, match="'lora' adapter subtree"):
        TrainCheckpointer(tmp_path).restore_lora(state)


def test_trainer_rejects_lora_with_incompatible_flags():
    args = trainer.build_parser().parse_args(
        ["--lora-rank", "4", "--moe", "--seq-parallel", "2", "--zigzag",
         "--steps", "1", "--device", "cpu"])
    with pytest.raises(SystemExit, match="zigzag"):
        trainer.train(args)


# ---------------------------------------------------------------------------
# LoRA on the mesh: the port's ranks (gloo, spawned; torch_mesh_ranks.py)
# against the reference's mesh step.  Each rank adds its slice of A @ B to
# its slice of the frozen base; the replicated adapters' gradients sum over
# every axis.
# ---------------------------------------------------------------------------

MESH_RUNS = {
    # name: (family, tp, sp, zigzag)
    "gpt-tp2-sp2": ("gpt", 2, 2, False),
    "llama-dp2-sp2": ("llama", 1, 2, False),
    "gpt-zigzag-dp2-sp2": ("gpt", 1, 2, True),
}
MESH_BATCHES = list(itertools.islice(
    jax_data.synthetic_token_stream(256, 4, 32, seed=17), 2))
_mesh_done = {}


def mesh_case(name):
    fam = MESH_RUNS[name][0]
    (jcfg, _, npp, jad, jlora), (tcfg, _, tp, tad, _) = reference_case(
        fam, seed=11)
    if fam == "llama":  # the ring over sp with no window: plain causal
        jcfg = jax_llama.LlamaConfig(**LLAMA, dtype=jnp.float32)
        tcfg = llama.LlamaConfig(**LLAMA, dtype=torch.float32)
    return jcfg, npp, jad, jlora, tcfg, tp, tad


def mesh_port(name):
    if not _mesh_done:
        from .torch_mesh_ranks import run_ranks

        runs = []
        for n, (fam, tp_, sp, zz) in MESH_RUNS.items():
            _, _, _, _, tcfg, tp, tad = mesh_case(n)
            runs.append(dict(family=fam, config=tcfg, tp=tp_, sp=sp,
                             zigzag=zz, lora=4, params=tp, adapters=tad,
                             train=dict(learning_rate=1e-3),
                             batches=[torch.from_numpy(b)
                                      for b in MESH_BATCHES]))
        results = run_ranks("train", 4, {"runs": runs}, timeout=300)
        _mesh_done.update({n: results[0][i]
                           for i, n in enumerate(MESH_RUNS)})
    return _mesh_done[name]


@pytest.mark.parametrize("name", list(MESH_RUNS))
def test_mesh_adapter_steps_match_the_reference(name):
    fam, tp_, sp, zz = MESH_RUNS[name]
    jcfg, npp, jad, jlora, _, _, _ = mesh_case(name)
    config = jax_train.TrainConfig(learning_rate=1e-3)
    mesh = jax_train.make_mesh(jax.devices()[:4], model_parallel=tp_,
                               seq_parallel=sp)
    frozen = jax.device_put(jax.tree.map(jnp.asarray, npp),
                            jax_train.param_shardings(mesh, npp))
    jad = jax.tree.map(jnp.asarray, jad)
    jstate = {"adapters": jad,
              "opt_state": jax_train.make_optimizer(config).init(jad),
              "step": jnp.zeros((), jnp.int32)}
    loss = None
    if zz:
        from kube_sqs_autoscaler_tpu.workloads.zigzag import make_zigzag_loss

        loss = make_zigzag_loss(mesh, jcfg)
    elif fam == "llama":
        loss = jax_llama.llama_mesh_loss(jcfg, config)
    jstep = jax_lora.make_lora_train_step(mesh, jcfg, config, frozen,
                                          jstate, jlora, loss=loss)
    want = []
    for batch in MESH_BATCHES:
        jstate, jl = jstep(jstate, jnp.asarray(batch))
        want.append(float(jl))
    got = mesh_port(name)
    np.testing.assert_allclose(got["losses"], want, rtol=1e-5)
    assert_params_close([t.numpy() for t in got["params"]],
                        tree_leaves(jstate["adapters"]))
