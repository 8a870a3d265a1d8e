"""The port's trainer held against the JAX package's, on the CPU.

Weights come from the reference's ``init_params`` and reach the port
through ``convert.params_from_jax``; tokens, gradients and inputs come from
numpy seeds.  Everything is fp32: bf16 AdamW moments round at different
points in the two frameworks, so parity is an fp32 statement.

Tolerances, each for the same fp32 arithmetic summed in another order:
- losses: rtol 1e-5;
- gradients: atol 1e-5 against O(1e-2) largest entries;
- parameters after Adam steps: all but 0.1% of entries within 2e-6, and
  every entry within 2e-5.  Adam's step lr * m / (sqrt(v) + eps) is
  ill-conditioned where a gradient entry is tiny: there, the ~1e-9
  summation-order noise of an fp32 gradient can move the step by a sizable
  fraction of lr (1e-3 here), so a rare entry differs by a few 1e-6.
"""

import itertools
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kube_sqs_autoscaler_tpu.workloads import data as jax_data
from kube_sqs_autoscaler_tpu.workloads import flash as jax_flash
from kube_sqs_autoscaler_tpu.workloads import model as jax_model
from kube_sqs_autoscaler_tpu.workloads import perf as jax_perf
from kube_sqs_autoscaler_tpu.workloads import train as jax_train
from kube_sqs_autoscaler_tpu_torch.workloads import (
    data, flash, model, perf, train, trainer,
)
from kube_sqs_autoscaler_tpu_torch.workloads.convert import params_from_jax

# tiny tests; the suite runs in several pytest workers that share the CPU
torch.set_num_threads(1)

DIMS = dict(vocab_size=256, d_model=64, n_heads=4, n_layers=2, d_ff=128,
            max_seq_len=64)


def configs():
    return (jax_model.ModelConfig(**DIMS, dtype=jnp.float32),
            model.ModelConfig(**DIMS, dtype=torch.float32))


def numpy_params(jcfg, seed=0):
    return jax.tree.map(np.asarray,
                        jax_model.init_params(jax.random.key(seed), jcfg))


def tokens(batch, seq, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, DIMS["vocab_size"], (batch, seq)).astype(np.int32)


def port_leaves(params):
    return [t.detach().numpy() for t in train.param_leaves(params)]


def jax_leaves(params):
    # the same order as train.param_leaves: top level by name, then layers
    top = [np.asarray(params[n]) for n in sorted(params) if n != "layers"]
    return top + [np.asarray(layer[n]) for layer in params["layers"]
                  for n in sorted(layer)]


def assert_params_close(got_leaves, want_leaves):
    got = np.concatenate([g.ravel() for g in got_leaves])
    want = np.concatenate([w.ravel() for w in want_leaves])
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    assert np.mean(np.abs(got - want) > 2e-6) < 1e-3


def test_fused_nll_value_and_grads_match_reference():
    rng = np.random.default_rng(0)
    embed = (rng.standard_normal((256, 64)) * 0.5).astype(np.float32)
    x = rng.standard_normal((2, 16, 64)).astype(np.float32)
    ids = tokens(2, 16)
    want, (want_de, want_dx) = jax.value_and_grad(
        jax_train.fused_next_token_nll, argnums=(0, 1))(
            jnp.asarray(embed), jnp.asarray(x), jnp.asarray(ids))
    te, tx = (torch.from_numpy(a).requires_grad_() for a in (embed, x))
    loss = train.fused_next_token_nll(te, tx, torch.from_numpy(ids))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_dx),
                               atol=1e-5, rtol=0)
    assert not tx.grad[:, -1].any()  # the last position predicts nothing
    np.testing.assert_allclose(te.grad.numpy(), np.asarray(want_de),
                               atol=1e-5, rtol=0)
    # the fused objective equals the plain composition
    plain = train.next_token_nll(model.unembed(tx, te), torch.from_numpy(ids))
    np.testing.assert_allclose(plain.item(), loss.item(), rtol=1e-6)


@pytest.mark.parametrize("options", [
    dict(),
    dict(warmup_steps=2, decay_steps=3, grad_clip_norm=0.05),
    dict(warmup_steps=3),
])
def test_optimizer_matches_optax_step_by_step(options):
    config = jax_train.TrainConfig(learning_rate=1e-2, **options)
    port_config = train.TrainConfig(learning_rate=1e-2, **options)
    jcfg, tcfg = configs()
    npp = numpy_params(jcfg)
    tx = jax_train.make_optimizer(config)
    jparams = jax.tree.map(jnp.asarray, npp)
    opt_state = tx.init(jparams)
    state = train.train_state(params_from_jax(npp, tcfg, "cpu"), port_config)
    rng = np.random.default_rng(5)
    jax_lr = config.schedule()  # a float when the schedule is constant
    for count in range(6):
        want_lr = float(jax_lr(count)) if callable(jax_lr) else jax_lr
        assert port_config.schedule()(count) == pytest.approx(
            want_lr, rel=1e-6, abs=1e-12)
        grads = jax.tree.map(
            lambda p: (rng.standard_normal(p.shape) * 0.05).astype(np.float32),
            npp)
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, grads),
                                       opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        state["optimizer"].update(
            [torch.from_numpy(g) for g in jax_leaves(grads)], count)
        assert_params_close(port_leaves(state["params"]),
                            jax_leaves(jparams))


def test_clip_by_global_norm_matches_optax():
    rng = np.random.default_rng(6)
    grads = [rng.standard_normal(s).astype(np.float32)
             for s in ((3, 4), (5,), (2, 2, 2))]
    norm = float(np.sqrt(sum((g ** 2).sum() for g in grads)))
    for max_norm in (norm / 3, norm * 2):
        clip = optax.clip_by_global_norm(max_norm)
        want, _ = clip.update([jnp.asarray(g) for g in grads],
                              clip.init(None))
        got = train.clip_by_global_norm([torch.from_numpy(g) for g in grads],
                                        max_norm)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-7)


def test_synthetic_token_stream_is_byte_identical():
    for seed in (0, 7):
        want = jax_data.synthetic_token_stream(300, 3, 17, seed=seed)
        got = data.synthetic_token_stream(300, 3, 17, seed=seed)
        for a, b in itertools.islice(zip(want, got), 3):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_prefetch_to_device_keeps_order_and_depth():
    batches = [np.full((2, 3), i, np.int32) for i in range(5)]
    for depth in (0, 2):
        out = list(data.prefetch_to_device(iter(batches), "cpu", depth))
        assert [int(t[0, 0]) for t in out] == list(range(5))
        assert all(t.dtype == torch.int32 for t in out)
    with pytest.raises(ValueError):
        next(data.prefetch_to_device(iter(batches), "cpu", -1))


def test_flops_match_reference_and_cpu_has_no_peak():
    jcfg, tcfg = configs()
    flagship = dict(vocab_size=8192, d_model=1024, n_heads=16, n_layers=8,
                    d_ff=4096, max_seq_len=2048)
    for jc, tc, b, s in ((jcfg, tcfg, 2, 64),
                         (jax_model.ModelConfig(**flagship),
                          model.ModelConfig(**flagship), 8, 2048)):
        assert perf.forward_flops(tc, b, s) == jax_perf.forward_flops(jc, b, s)
        assert perf.train_step_flops(tc, b, s) == \
            jax_perf.train_step_flops(jc, b, s)
    assert perf.peak_flops("cpu") is None
    assert perf.mfu(1e12, 1.0, "cpu") is None


def test_loss_fn_value_and_grad_through_flash_matches_reference():
    jcfg, tcfg = configs()
    npp = numpy_params(jcfg, seed=2)
    ids = tokens(2, 64, seed=3)
    flash_interp = partial(jax_flash.flash_attention, interpret=True)
    want, want_grads = jax.value_and_grad(jax_train.loss_fn)(
        jax.tree.map(jnp.asarray, npp), jnp.asarray(ids), jcfg,
        attention_fn=flash_interp)
    state = train.train_state(params_from_jax(npp, tcfg, "cpu"),
                              train.TrainConfig())
    loss = partial(train.loss_fn, config=tcfg,
                   attention_fn=flash.flash_attention)
    value, grads = train.value_and_grad(loss, state["params"],
                                        torch.from_numpy(ids))
    np.testing.assert_allclose(value.item(), float(want), rtol=1e-5)
    for got, exp in zip(port_leaves(grads), jax_leaves(want_grads)):
        np.testing.assert_allclose(got, exp, atol=1e-5, rtol=0)


@pytest.mark.parametrize("options", [
    dict(),
    dict(grad_accum=2, remat=True, grad_clip_norm=0.5, warmup_steps=1,
         decay_steps=4),
])
def test_three_train_steps_match_the_reference_step(options):
    jcfg, tcfg = configs()
    npp = numpy_params(jcfg, seed=4)
    config = jax_train.TrainConfig(learning_rate=1e-3, **options)
    mesh = jax_train.make_mesh(jax.devices()[:1], model_parallel=1)
    jstate = jax_train.place_state(mesh, {
        "params": jax.tree.map(jnp.asarray, npp),
        "opt_state": jax_train.make_optimizer(config).init(
            jax.tree.map(jnp.asarray, npp)),
        "step": jnp.zeros((), jnp.int32),
    })
    jstep = jax_train.make_train_step(mesh, jcfg, config, jstate)
    port_config = train.TrainConfig(learning_rate=1e-3, **options)
    state = train.train_state(params_from_jax(npp, tcfg, "cpu"), port_config)
    step_fn = train.make_train_step(tcfg, port_config, "cpu")
    stream = jax_data.synthetic_token_stream(DIMS["vocab_size"], 4, 64, seed=9)
    for batch in itertools.islice(stream, 3):
        jstate, jloss = jstep(jstate, jnp.asarray(batch))
        state, loss = step_fn(state, torch.from_numpy(batch))
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert state["step"] == int(jstate["step"]) == 3
    assert_params_close(port_leaves(state["params"]),
                        jax_leaves(jstate["params"]))


def test_remat_gives_the_same_grads():
    _, tcfg = configs()
    params = model.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    state = train.train_state(params, train.TrainConfig())
    ids = torch.from_numpy(tokens(2, 32, seed=8))
    got = [train.value_and_grad(
        partial(train.loss_fn, config=tcfg, remat=remat), state["params"],
        ids) for remat in (False, True)]
    assert got[0][0].item() == got[1][0].item()
    for a, b in zip(port_leaves(got[0][1]), port_leaves(got[1][1])):
        np.testing.assert_allclose(a, b, atol=1e-7, rtol=0)


def test_trainer_binary_overfits_on_the_cpu():
    out = trainer.main([
        "--device", "cpu", "--vocab-size", "256", "--d-model", "64",
        "--n-heads", "4", "--n-layers", "2", "--d-ff", "128", "--seq-len",
        "32", "--batch-size", "4", "--steps", "12", "--log-every", "4",
        "--learning-rate", "3e-3", "--overfit", "--eval-every", "6",
        "--eval-batches", "1",
    ])
    assert out["final_step"] == 12
    losses = out["losses"]
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert losses[-1] < losses[0] - 0.5
    assert out["tokens_per_s"] > 0 and out["mfu"] is None


def test_trainer_rejects_unported_choices():
    # the llama family and --data-dir are ported (test_torch_llama_train,
    # test_torch_native), the mesh flags (test_torch_mesh_train) and the
    # pipeline flags (test_torch_pipeline_train): in one process that no
    # launcher started, two stages need ranks the launch does not have
    with pytest.raises(SystemExit, match="1 devices not divisible by "
                       "pipe_parallel=2 x model_parallel=1 x "
                       "seq_parallel=1"):
        trainer.train(trainer.build_parser().parse_args(
            ["--device", "cpu", "--family", "llama", "--pipe-parallel",
             "2"]))
    with pytest.raises(SystemExit, match="meta.json"):
        trainer.main(["--device", "cpu", "--data-dir", "x"])
    with pytest.raises(SystemExit, match="eval-batches"):
        trainer.main(["--device", "cpu", "--eval-every", "1",
                      "--eval-batches", "0"])
    with pytest.raises(ValueError, match="grad_accum"):
        train.TrainConfig(grad_accum=0)
