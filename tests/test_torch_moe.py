"""The port's Mixture-of-Experts MLP held against the JAX package's.

The reference's ``tests/test_moe.py`` cases that need no mesh, in the
port: a single expert reduces to the dense MLP (both families), the
routing invariants and capacity overflow, invariance to a batch reshape,
an explicit group, the aux term and the remat refusal.  Then parity: the
routing, the routed MLPs and both MoE objectives (value and gradients)
against the reference's on the reference's own weights
(``convert.params_from_jax`` carries the expert stacks and the fp32
router), and three optimizer steps against the reference's step on a
one-device mesh.  fp32, with ``tests/test_torch_train.py``'s tolerances
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
from kube_sqs_autoscaler_tpu.workloads import model as jax_model
from kube_sqs_autoscaler_tpu.workloads import moe as jax_moe
from kube_sqs_autoscaler_tpu.workloads import train as jax_train
from kube_sqs_autoscaler_tpu_torch.workloads import (
    llama, model, moe, train, trainer,
)
from kube_sqs_autoscaler_tpu_torch.workloads.convert import params_from_jax

from .test_torch_llama_train import (
    assert_grads_close, assert_params_close, port_leaves, tree_leaves,
)

torch.set_num_threads(1)

GPT = dict(vocab_size=256, d_model=64, n_heads=4, n_layers=2, d_ff=128,
           max_seq_len=64)
LLAMA = dict(vocab_size=256, d_model=64, n_heads=4, n_kv_heads=2,
             n_layers=2, d_ff=96, max_seq_len=64)
TINY = ["--device", "cpu", "--vocab-size", "256", "--d-model", "64",
        "--n-heads", "4", "--n-layers", "2", "--d-ff", "64", "--seq-len",
        "32", "--batch-size", "8", "--learning-rate", "1e-2",
        "--log-every", "1"]


def family(name, **overrides):
    """(reference config, port config, reference init, loss pair)."""
    if name == "gpt":
        dims = {**GPT, **overrides}
        return (jax_model.ModelConfig(**dims, dtype=jnp.float32),
                model.ModelConfig(**dims, dtype=torch.float32),
                jax_moe.init_moe_params,
                (jax_moe.moe_loss_fn, moe.moe_loss_fn))
    dims = {**LLAMA, **overrides}
    return (jax_llama.LlamaConfig(**dims, dtype=jnp.float32),
            llama.LlamaConfig(**dims, dtype=torch.float32),
            jax_moe.init_llama_moe_params,
            (jax_moe.llama_moe_loss_fn, moe.llama_moe_loss_fn))


def weights(name, jmoe, seed=0, **overrides):
    jcfg, tcfg, init, losses = family(name, **overrides)
    npp = jax.tree.map(np.asarray, init(jax.random.key(seed), jcfg, jmoe))
    return jcfg, tcfg, npp, params_from_jax(npp, tcfg, "cpu"), losses


def tokens(batch, seq, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (batch, seq)).astype(np.int32)


def normal(seed, shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def softmax(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


@pytest.mark.parametrize("name", ["gpt", "llama"])
def test_single_expert_equals_the_dense_mlp(name):
    # E = 1, top_k = 1, ample capacity: one choice with gate 1
    x = torch.from_numpy(normal(2, (2, 16, 64)))
    config = moe.MoeConfig(n_experts=1, top_k=1, capacity_factor=4.0)
    router = torch.zeros((64, 1))
    if name == "gpt":
        w_up, w_down = (torch.from_numpy(normal(s, shape, 0.1)) for s, shape
                        in ((0, (64, 128)), (1, (128, 64))))
        dense = model._mlp(x, {"w_up": w_up, "w_down": w_down})
        sparse, aux = moe.moe_mlp(x, {
            "router": router, "w_up_experts": w_up[None],
            "w_down_experts": w_down[None]}, config)
    else:
        w_gate_up, w_down = (torch.from_numpy(normal(s, shape, 0.1))
                             for s, shape in ((0, (64, 256)),
                                              (1, (128, 64))))
        dense = llama._swiglu(x, {"w_gate_up": w_gate_up, "w_down": w_down})
        sparse, aux = moe.llama_moe_mlp(x, {
            "router": router, "w_gate_up_experts": w_gate_up[None],
            "w_down_experts": w_down[None]}, config)
    np.testing.assert_allclose(dense.numpy(), sparse.numpy(), rtol=1e-6,
                               atol=1e-6)
    assert aux.item() == pytest.approx(1.0)  # balanced by definition


def test_top_k_must_not_exceed_n_experts():
    with pytest.raises(ValueError, match="top_k"):
        moe.MoeConfig(n_experts=2, top_k=3)
    with pytest.raises(ValueError, match="top_k"):
        moe.MoeConfig(n_experts=4, top_k=0)
    with pytest.raises(ValueError, match="group_size"):
        moe.MoeConfig(group_size=0)
    assert moe.MoeConfig(n_experts=8, top_k=2).capacity(4096) == 1280
    assert moe.DEFAULT_GROUP_TOKENS == jax_moe.DEFAULT_GROUP_TOKENS
    for tokens_ in (16384, 4096, 3000, 7):
        assert moe._default_group(tokens_) == jax_moe._default_group(tokens_)


@pytest.mark.parametrize("n_experts,top_k,factor,shape", [
    (4, 2, 8.0, (2, 16, 4)), (2, 2, 1e-6, (1, 16, 2)),
    (8, 2, 1.25, (3, 40, 8)), (4, 1, 1.0, (2, 32, 4)),
], ids=["ample", "overflow", "flagship-factor", "top1"])
def test_routing_matches_the_reference(n_experts, top_k, factor, shape):
    config = moe.MoeConfig(n_experts=n_experts, top_k=top_k,
                           capacity_factor=factor)
    jconfig = jax_moe.MoeConfig(n_experts=n_experts, top_k=top_k,
                                capacity_factor=factor)
    probs = softmax(normal(3, shape))
    capacity = config.capacity(shape[1])
    want = jax_moe._top_k_routing(jnp.asarray(probs), jconfig, capacity)
    got = moe._top_k_routing(torch.from_numpy(probs), config, capacity)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-6, atol=1e-7)
    assert got[2].item() == pytest.approx(float(want[2]), rel=1e-6)
    d, c = got[0].numpy(), got[1].numpy()
    if factor >= 8.0:
        # every token in exactly top_k slots, gates renormalized to 1
        np.testing.assert_array_equal(d.sum(axis=(2, 3)), top_k)
        np.testing.assert_allclose(c.sum(axis=(2, 3)), 1.0, rtol=1e-6)
        assert got[2].item() >= 1.0 - 1e-6  # the Switch lower bound
    # no expert slot is double-booked within a group
    assert d.sum(axis=1).max() <= 1.0 + 1e-6
    if factor < 1e-3:
        assert capacity == 1 and d.sum() <= 2.0 + 1e-6
        assert np.isfinite(c).all()


@pytest.mark.parametrize("name", ["gpt", "llama"])
def test_routed_mlp_matches_the_reference(name):
    jmoe = jax_moe.MoeConfig(n_experts=4, top_k=2, capacity_factor=1.0)
    _, _, npp, tp, _ = weights(name, jmoe, seed=3)
    x = normal(4, (2, 32, 64))
    ref = jax_moe.moe_mlp if name == "gpt" else jax_moe.llama_moe_mlp
    ours = moe.moe_mlp if name == "gpt" else moe.llama_moe_mlp
    layer = jax.tree.map(jnp.asarray, npp["layers"][0])
    want, want_aux = ref(jnp.asarray(x), layer, jmoe)
    got, aux = ours(torch.from_numpy(x), tp["layers"][0],
                    moe.MoeConfig(n_experts=4, top_k=2, capacity_factor=1.0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    assert aux.item() == pytest.approx(float(want_aux), rel=1e-6)
    assert tp["layers"][0]["router"].dtype == torch.float32


def test_routing_invariant_to_batch_reshape():
    config = moe.MoeConfig(n_experts=4, top_k=2, capacity_factor=1.0)
    tcfg = model.ModelConfig(vocab_size=128, d_model=32, n_heads=4,
                             n_layers=1, d_ff=64, max_seq_len=32,
                             dtype=torch.float32)
    layer = moe.init_moe_params(tcfg, config, torch.Generator().manual_seed(0),
                                "cpu")["layers"][0]
    x = torch.from_numpy(normal(1, (4, 16, 32)))
    out_a, aux_a = moe.moe_mlp(x, layer, config)
    out_b, aux_b = moe.moe_mlp(x.reshape(8, 8, 32), layer, config)
    np.testing.assert_allclose(out_a.reshape(-1, 32).numpy(),
                               out_b.reshape(-1, 32).numpy(), rtol=1e-6,
                               atol=1e-6)
    assert aux_a.item() == pytest.approx(aux_b.item())


def test_explicit_group_size_routes_per_group():
    config = moe.MoeConfig(n_experts=4, top_k=1, capacity_factor=1.0,
                           group_size=16)
    tcfg = model.ModelConfig(vocab_size=128, d_model=32, n_heads=4,
                             n_layers=1, d_ff=64, max_seq_len=32,
                             dtype=torch.float32)
    layer = moe.init_moe_params(tcfg, config, torch.Generator().manual_seed(0),
                                "cpu")["layers"][0]
    x = torch.from_numpy(normal(2, (2, 16, 32)))
    out, _ = moe.moe_mlp(x, layer, config)
    assert out.shape == (2, 16, 32) and torch.isfinite(out).all()
    with pytest.raises(ValueError, match="divisible"):
        moe.moe_mlp(x[:, :10], layer, moe.MoeConfig(n_experts=4,
                                                    group_size=16))


@pytest.mark.parametrize("name", ["gpt", "llama"])
def test_forward_shapes_and_the_aux_term(name):
    jmoe = jax_moe.MoeConfig(n_experts=4, top_k=2, aux_loss_weight=1.0)
    _, tcfg, _, tp, (_, loss_fn) = weights(name, jmoe)
    ids = torch.from_numpy(tokens(2, 32))
    on = moe.MoeConfig(n_experts=4, top_k=2, aux_loss_weight=1.0)
    off = moe.MoeConfig(n_experts=4, top_k=2, aux_loss_weight=0.0)
    forward = moe.moe_forward if name == "gpt" else moe.llama_moe_forward
    logits, aux = forward(tp, ids, tcfg, on)
    assert logits.shape == (2, 32, 256) and logits.dtype == torch.float32
    assert torch.isfinite(logits).all() and np.isfinite(aux.item())
    with_aux = loss_fn(tp, ids, tcfg, on).item()
    without = loss_fn(tp, ids, tcfg, off).item()
    assert with_aux == pytest.approx(without + aux.item(), rel=1e-5)
    layer = tp["layers"][0]
    assert "w_up" not in layer and "w_gate_up" not in layer
    up = "w_up_experts" if name == "gpt" else "w_gate_up_experts"
    width = tcfg.d_ff if name == "gpt" else 2 * tcfg.d_ff
    assert layer[up].shape == (4, 64, width)


@pytest.mark.parametrize("name,window", [
    ("gpt", None), ("llama", None), ("llama", 6),
], ids=["gpt", "llama", "llama-window6"])
def test_moe_loss_and_grads_match_reference(name, window):
    overrides = {} if window is None else {"sliding_window": window}
    jmoe = jax_moe.MoeConfig(n_experts=4, top_k=2, capacity_factor=1.0,
                             aux_loss_weight=0.1)
    jcfg, tcfg, npp, tp, (ref_loss, loss_fn) = weights(name, jmoe, seed=5,
                                                       **overrides)
    ids = tokens(2, 32, seed=6)
    want, want_grads = jax.jit(jax.value_and_grad(partial(
        ref_loss, config=jcfg, moe=jmoe)))(jax.tree.map(jnp.asarray, npp),
                                            jnp.asarray(ids))
    config = moe.MoeConfig(n_experts=4, top_k=2, capacity_factor=1.0,
                           aux_loss_weight=0.1)
    state = train.train_state(tp, train.TrainConfig())
    value, grads = train.value_and_grad(
        lambda p, t: loss_fn(p, t, tcfg, config), state["params"],
        torch.from_numpy(ids))
    np.testing.assert_allclose(value.item(), float(want), rtol=1e-5)
    assert_grads_close(grads, want_grads)


@pytest.mark.parametrize("name", ["gpt", "llama"])
def test_three_moe_train_steps_match_the_reference_step(name):
    jmoe = jax_moe.MoeConfig(n_experts=4, top_k=2)
    jcfg, tcfg, npp, tp, _ = weights(name, jmoe, seed=7)
    config = jax_train.TrainConfig(learning_rate=1e-3, grad_clip_norm=0.5)
    mesh = jax_train.make_mesh(jax.devices()[:1], model_parallel=1)
    jstate = jax_train.place_state(mesh, {
        "params": jax.tree.map(jnp.asarray, npp),
        "opt_state": jax_train.make_optimizer(config).init(
            jax.tree.map(jnp.asarray, npp)),
        "step": jnp.zeros((), jnp.int32),
    })
    make_ref = (jax_moe.make_moe_train_step if name == "gpt"
                else jax_moe.make_llama_moe_train_step)
    jstep = make_ref(mesh, jcfg, jmoe, config, jstate)
    port_config = train.TrainConfig(learning_rate=1e-3, grad_clip_norm=0.5)
    make = (moe.make_moe_train_step if name == "gpt"
            else moe.make_llama_moe_train_step)
    step_fn = make(tcfg, moe.MoeConfig(n_experts=4, top_k=2), port_config,
                   "cpu")
    state = train.train_state(tp, port_config)
    stream = jax_data.synthetic_token_stream(256, 4, 32, seed=9)
    for batch in itertools.islice(stream, 3):
        jstate, jloss = jstep(jstate, jnp.asarray(batch))
        state, loss = step_fn(state, torch.from_numpy(batch))
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert_params_close(port_leaves(state["params"]),
                        tree_leaves(jstate["params"]))


def test_moe_train_step_rejects_remat():
    tcfg = family("gpt")[1]
    with pytest.raises(ValueError, match="remat"):
        moe.make_moe_train_step(tcfg, moe.MoeConfig(n_experts=4, top_k=1),
                                train.TrainConfig(remat=True), "cpu")
    with pytest.raises(ValueError, match="remat"):
        trainer.main([*TINY, "--steps", "1", "--moe", "--remat"])


def test_init_draws_fp32_routers_and_model_dtype_experts():
    config = moe.MoeConfig(n_experts=4)
    tcfg = model.ModelConfig(**GPT)  # bf16
    params = moe.init_moe_params(tcfg, config,
                                 torch.Generator().manual_seed(0), "cpu")
    layer = params["layers"][0]
    assert layer["router"].dtype == torch.float32
    assert layer["w_up_experts"].dtype == torch.bfloat16
    assert layer["w_down_experts"].shape == (4, 128, 64)
    again = moe.init_moe_params(tcfg, config,
                                torch.Generator().manual_seed(0), "cpu")
    assert all(torch.equal(a, b) for a, b in zip(
        train.param_leaves(params), train.param_leaves(again)))


@pytest.mark.parametrize("extra", [
    [], ["--family", "llama"], ["--family", "llama", "--sliding-window", "8",
                                "--eval-every", "2", "--eval-batches", "2"],
], ids=["gpt", "llama", "llama-window-eval"])
def test_trainer_moe_learns(extra):
    result = trainer.main([*TINY, "--steps", "4", "--moe", "--moe-experts",
                           "4", "--moe-top-k", "2", "--overfit", *extra])
    assert result["final_step"] == 4
    losses = result["losses"]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


# ---------------------------------------------------------------------------
# MoE on the mesh: the port's ranks (gloo, spawned; torch_mesh_ranks.py)
# against the reference's mesh steps on its virtual CPU devices.  Experts
# split over data (an all-to-all each way), routing over the global token
# stream; small routing groups and the default capacity, so tokens are
# dropped and the capacity order counts.
# ---------------------------------------------------------------------------

MESH_RUNS = {
    # name: (family, tp, sp, zigzag, MoeConfig keywords)
    "gpt-dp2-sp2": ("gpt", 1, 2, False, dict(group_size=64)),
    "gpt-dp2-tp2": ("gpt", 2, 1, False, {}),
    "llama-dp4": ("llama", 1, 1, False, dict(group_size=32)),
    "gpt-zigzag-tp2-sp2": ("gpt", 2, 2, True, {}),
    "llama-zigzag-sp4": ("llama", 1, 4, True, dict(group_size=64)),
}
MESH_BATCHES = list(itertools.islice(
    jax_data.synthetic_token_stream(256, 4, 32, seed=13), 2))
_mesh_done = {}


def mesh_port(name):
    if not _mesh_done:
        from .torch_mesh_ranks import run_ranks

        runs = []
        for fam, tp, sp, zz, kw in MESH_RUNS.values():
            jmoe = jax_moe.MoeConfig(n_experts=4, top_k=2, **kw)
            _, tcfg, _, tparams, _ = weights(fam, jmoe, seed=5)
            runs.append(dict(
                family=fam, config=tcfg, tp=tp, sp=sp, zigzag=zz,
                moe=moe.MoeConfig(n_experts=4, top_k=2, **kw),
                params=tparams, train=dict(learning_rate=1e-3,
                                           grad_clip_norm=0.5),
                batches=[torch.from_numpy(b) for b in MESH_BATCHES]))
        results = run_ranks("train", 4, {"runs": runs}, timeout=300)
        _mesh_done.update({n: results[0][i]
                           for i, n in enumerate(MESH_RUNS)})
    return _mesh_done[name]


@pytest.mark.parametrize("name", list(MESH_RUNS))
def test_mesh_moe_train_steps_match_the_reference(name):
    fam, tp, sp, zz, kw = MESH_RUNS[name]
    jmoe = jax_moe.MoeConfig(n_experts=4, top_k=2, **kw)
    jcfg, _, npp, _, _ = weights(fam, jmoe, seed=5)
    config = jax_train.TrainConfig(learning_rate=1e-3, grad_clip_norm=0.5)
    mesh = jax_train.make_mesh(jax.devices()[:4], model_parallel=tp,
                               seq_parallel=sp)
    params = jax.tree.map(jnp.asarray, npp)
    jstate = jax_train.place_state(mesh, {
        "params": params,
        "opt_state": jax_train.make_optimizer(config).init(params),
        "step": jnp.zeros((), jnp.int32)})
    if zz:
        jstep = jax_moe.make_zigzag_moe_train_step(
            mesh, jcfg, jmoe, config, jstate, llama=fam == "llama")
    else:
        make_ref = (jax_moe.make_moe_train_step if fam == "gpt"
                    else jax_moe.make_llama_moe_train_step)
        jstep = make_ref(mesh, jcfg, jmoe, config, jstate)
    want = []
    for batch in MESH_BATCHES:
        jstate, jloss = jstep(jstate, jnp.asarray(batch))
        want.append(float(jloss))
    got = mesh_port(name)
    np.testing.assert_allclose(got["losses"], want, rtol=1e-5)
    assert_params_close([t.numpy() for t in got["params"]],
                        tree_leaves(jstate["params"]))


def test_mesh_moe_refuses_experts_the_data_axis_cannot_split():
    from kube_sqs_autoscaler_tpu_torch.workloads import distributed

    mesh = distributed.make_mesh(model_parallel=1, seq_parallel=1,
                                 device="cpu")
    mesh.shape["data"] = 3  # as a three-rank data axis would be
    with pytest.raises(ValueError, match="n_experts=4 not divisible by "
                                         "the data axis"):
        moe.make_mesh_moe_train_step(mesh, family("gpt")[1],
                                     moe.MoeConfig(n_experts=4),
                                     train.TrainConfig())


@pytest.mark.parametrize("name", ["gpt", "llama"])
def test_moe_pipeline_equals_flat_moe_loss_and_learns(name):
    """MoE x pp over 2 gloo ranks (GPipe; the reference's
    ``test_moe.py:370``): with ample capacity the pipelined routed loss
    equals the flat MoE loss within 2e-4 (the aux term is averaged per
    microbatch), and the steps learn."""
    from kube_sqs_autoscaler_tpu_torch.workloads import pipeline

    from .torch_mesh_ranks import run_ranks

    jmoe = jax_moe.MoeConfig(n_experts=4, top_k=2, capacity_factor=4.0)
    tmoe = moe.MoeConfig(n_experts=4, top_k=2, capacity_factor=4.0)
    _, tcfg, _, params, losses = weights(name, jmoe, max_seq_len=16)
    batch = tokens(8, 16)
    plain = float(losses[1](params, torch.from_numpy(batch), tcfg, tmoe))
    stack = (pipeline.as_llama_pipeline_params if name == "llama"
             else pipeline.as_pipeline_params)
    ranks = run_ranks("pipeline", 2, {"runs": [dict(
        family=name, config=tcfg, pipe=2, micro=2, schedule="gpipe",
        kind="steps", train=dict(learning_rate=1e-2), moe=tmoe,
        params=stack(params), batches=[batch] * 4)]}, timeout=300)
    piped = ranks[0][0]["losses"]
    assert piped[0] == pytest.approx(plain, rel=2e-4)
    assert piped[-1] < piped[0]
