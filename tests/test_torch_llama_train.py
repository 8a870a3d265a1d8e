"""The port's llama trainer held against the JAX package's, on the CPU.

Weights come from the reference's ``init_llama_params`` and reach the port
through ``convert.params_from_jax``; tokens come from numpy seeds.  Both
sides run in fp32 through dense attention (the flash kernels' GQA and
windowed backward are held against their plain versions on the card by
``chip_smoke.py``).  Tolerances are ``tests/test_torch_train.py``'s: losses
rtol 1e-5, gradients atol 1e-5, parameters after Adam steps all but 0.1%
of entries within 2e-6 and every entry within 2e-5.  The trainer binary's
flags are checked against the reference's parser; the mesh flags and
``--pipe-parallel`` exit 2 in a process that no launcher started, and the
other pipeline flags are accepted there, unused.
"""

import itertools
import threading
import time
import urllib.request
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kube_sqs_autoscaler_tpu.workloads import data as jax_data
from kube_sqs_autoscaler_tpu.workloads import llama as jax_llama
from kube_sqs_autoscaler_tpu.workloads import perf as jax_perf
from kube_sqs_autoscaler_tpu.workloads import train as jax_train
from kube_sqs_autoscaler_tpu.workloads import trainer as jax_trainer
from kube_sqs_autoscaler_tpu_torch.workloads import (
    flash, llama, perf, train, trainer,
)
from kube_sqs_autoscaler_tpu_torch.workloads.convert import params_from_jax

torch.set_num_threads(1)

DIMS = dict(vocab_size=256, d_model=64, n_heads=4, n_kv_heads=2,
            n_layers=2, d_ff=96, max_seq_len=64)
TINY = ["--device", "cpu", "--vocab-size", "256", "--d-model", "64",
        "--n-heads", "4", "--n-layers", "2", "--d-ff", "128", "--seq-len",
        "32", "--batch-size", "4", "--learning-rate", "1e-2",
        "--log-every", "1"]


def configs(**overrides):
    dims = {**DIMS, **overrides}
    return (jax_llama.LlamaConfig(**dims, dtype=jnp.float32),
            llama.LlamaConfig(**dims, dtype=torch.float32))


def numpy_params(jcfg, seed=0):
    return jax.tree.map(np.asarray,
                        jax_llama.init_llama_params(jax.random.key(seed),
                                                    jcfg))


def tokens(batch, seq, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, DIMS["vocab_size"], (batch, seq)).astype(np.int32)


def tree_leaves(tree):
    """The reference tree's arrays in :func:`train.param_leaves` order."""
    if isinstance(tree, dict):
        keys = sorted(k for k in tree if k != "layers") + (
            ["layers"] if "layers" in tree else [])
        return [leaf for key in keys for leaf in tree_leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in tree_leaves(item)]
    return [np.asarray(tree)]


def port_leaves(tree):
    return [t.detach().numpy() for t in train.param_leaves(tree)]


def assert_grads_close(got, want):
    got, want = port_leaves(got), tree_leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)


def assert_params_close(got_leaves, want_leaves):
    got = np.concatenate([g.ravel() for g in got_leaves])
    want = np.concatenate([w.ravel() for w in want_leaves])
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    assert np.mean(np.abs(got - want) > 2e-6) < 1e-3


@pytest.mark.parametrize("window,remat,attention", [
    (None, False, "dense"), (6, False, "dense"), (None, True, "dense"),
    (6, True, "flash"),
], ids=["gqa", "gqa-window6", "gqa-remat", "gqa-window6-remat-flash-pick"])
def test_llama_loss_and_grads_match_reference(window, remat, attention):
    # the flash pick is the kernel wrapper, which on a CPU tensor runs its
    # plain version: the same values as dense, through the seam the card
    # takes
    jcfg, tcfg = configs(sliding_window=window)
    npp = numpy_params(jcfg, seed=2)
    ids = tokens(2, 32, seed=3)
    want, want_grads = jax.jit(jax.value_and_grad(partial(
        jax_llama.llama_loss_fn, config=jcfg, remat=remat)))(
            jax.tree.map(jnp.asarray, npp), jnp.asarray(ids))
    state = train.train_state(params_from_jax(npp, tcfg, "cpu"),
                              train.TrainConfig(remat=remat))
    attend = (flash.windowed(flash.flash_attention, window)
              if attention == "flash" else None)
    loss = llama.llama_mesh_loss(tcfg, train.TrainConfig(remat=remat))
    value, grads = train.value_and_grad(
        lambda p, t: loss(p, t, attend), state["params"],
        torch.from_numpy(ids))
    np.testing.assert_allclose(value.item(), float(want), rtol=1e-5)
    assert_grads_close(grads, want_grads)


@pytest.mark.parametrize("options", [
    dict(),
    dict(window=6, grad_accum=2, remat=True, grad_clip_norm=0.5,
         warmup_steps=1, decay_steps=4),
], ids=["causal", "window-accum-remat-clip"])
def test_three_llama_train_steps_match_the_reference_step(options):
    options = dict(options)
    window = options.pop("window", None)
    jcfg, tcfg = configs(sliding_window=window)
    npp = numpy_params(jcfg, seed=4)
    config = jax_train.TrainConfig(learning_rate=1e-3, **options)
    mesh = jax_train.make_mesh(jax.devices()[:1], model_parallel=1)
    jstate = jax_train.place_state(mesh, {
        "params": jax.tree.map(jnp.asarray, npp),
        "opt_state": jax_train.make_optimizer(config).init(
            jax.tree.map(jnp.asarray, npp)),
        "step": jnp.zeros((), jnp.int32),
    })
    jstep = jax_llama.make_llama_train_step(mesh, jcfg, config, jstate)
    port_config = train.TrainConfig(learning_rate=1e-3, **options)
    state = train.train_state(params_from_jax(npp, tcfg, "cpu"), port_config)
    step_fn = llama.make_llama_train_step(tcfg, port_config, "cpu")
    stream = jax_data.synthetic_token_stream(DIMS["vocab_size"], 4, 32,
                                             seed=9)
    for batch in itertools.islice(stream, 3):
        jstate, jloss = jstep(jstate, jnp.asarray(batch))
        state, loss = step_fn(state, torch.from_numpy(batch))
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert state["step"] == int(jstate["step"]) == 3
    assert_params_close(port_leaves(state["params"]),
                        tree_leaves(jstate["params"]))


def test_init_llama_train_state_and_flops():
    _, tcfg = configs()
    state = llama.init_llama_train_state(torch.Generator().manual_seed(0),
                                         tcfg, train.TrainConfig(), "cpu")
    assert state["step"] == 0
    assert all(t.requires_grad for t in train.param_leaves(state["params"]))
    assert set(state["params"]["layers"][0]) == {
        "attn_norm", "wq", "wkv", "wo", "mlp_norm", "w_gate_up", "w_down"}
    flagship = dict(vocab_size=8192, d_model=1024, n_heads=16, n_kv_heads=4,
                    n_layers=8, d_ff=2816, max_seq_len=2048)
    assert perf.train_step_flops(llama.LlamaConfig(**flagship), 8, 2048) == \
        jax_perf.train_step_flops(jax_llama.LlamaConfig(**flagship), 8, 2048)


@pytest.mark.parametrize("extra", [
    [], ["--sliding-window", "8", "--n-kv-heads", "1"],
    ["--remat", "--grad-accum", "2", "--eval-every", "3",
     "--eval-batches", "1"],
], ids=["llama", "llama-window8-mqa", "llama-remat-accum-eval"])
def test_trainer_llama_family_learns(extra):
    out = trainer.main([*TINY, "--family", "llama", "--steps", "6",
                        "--overfit", *extra])
    assert out["final_step"] == 6
    losses = out["losses"]
    assert len(losses) == 6 and all(np.isfinite(losses))
    assert losses[-1] < losses[0] - 0.5
    # the family's d_ff default is the serving binary's
    args = trainer.build_parser().parse_args(["--family", "llama"])
    assert args.d_ff is None and jax_trainer.build_parser().parse_args(
        ["--family", "llama"]).d_ff is None


def test_trainer_accepts_every_reference_flag_with_its_default():
    def options(parser):
        return {opt: action for action in parser._actions
                for opt in action.option_strings}

    ours, theirs = options(trainer.build_parser()), options(
        jax_trainer.build_parser())
    assert set(theirs) <= set(ours)
    assert set(ours) - set(theirs) == {"--device"}
    for opt, action in theirs.items():
        assert ours[opt].default == action.default, opt
        assert ours[opt].choices == action.choices, opt


@pytest.mark.parametrize("flag", [
    ["--model-parallel", "2"], ["--seq-parallel", "2"], ["--zigzag"],
    ["--pipe-parallel", "2"], ["--pipe-schedule", "1f1b"],
    ["--pipe-microbatches", "2"], ["--topology-mesh", "--seq-parallel", "2"],
], ids=lambda f: f[0].lstrip("-"))
def test_trainer_mesh_flags_exit_2_naming_item_5(flag, capsys):
    # the mesh and pipeline flags are ported (test_torch_mesh_train,
    # test_torch_pipeline_train).  In one process that no launcher
    # started, a mesh or two stages exit 2 with the reference's mesh
    # arithmetic (or zig-zag) message; the schedule and the microbatch
    # count without stages are accepted and unused, as the reference
    # reads them only under --pipe-parallel > 1
    if flag[0] in ("--pipe-schedule", "--pipe-microbatches"):
        out = trainer.main([*TINY, "--steps", "1", *flag])
        assert out["final_step"] == 1
        return
    with pytest.raises(SystemExit) as exit_info:
        trainer.main([*TINY, "--steps", "1", *flag])
    assert exit_info.value.code == 2
    err = capsys.readouterr().err
    assert flag[0] in err
    if flag[0] == "--pipe-parallel":
        assert ("1 devices not divisible by pipe_parallel=2 x "
                "model_parallel=1 x seq_parallel=1") in err
        assert "torch.distributed.run" in err
    elif flag[0] == "--zigzag":
        assert "nontrivial seq axis" in err
    else:
        assert "1 devices not divisible by" in err
        assert "torch.distributed.run" in err


@pytest.mark.parametrize("argv,match", [
    (["--sliding-window", "4"], "llama-family knob"),
    (["--family", "llama", "--sliding-window", "-1"], "must be >= 0"),
    (["--hf-export", "x"], "does not combine with --family gpt"),
    (["--family", "llama", "--moe", "--hf-export", "x"],
     "does not combine with --moe"),
    (["--hf-checkpoint", "x", "--moe"], "does not combine with --moe"),
    (["--hf-checkpoint", "x", "--family", "llama", "--sliding-window", "4"],
     "does not combine with --hf-checkpoint"),
    (["--eval-every", "1", "--eval-batches", "0"], "eval-batches"),
], ids=["window-gpt", "window-negative", "export-gpt", "export-moe",
        "hf-moe", "hf-window", "eval-batches"])
def test_trainer_refuses_what_the_reference_refuses(argv, match):
    with pytest.raises(SystemExit, match=match):
        trainer.main([*TINY, "--steps", "1", *argv])
    with pytest.raises(SystemExit, match=match):
        jax_trainer.main([*TINY[2:], "--steps", "1", *argv])


def test_trainer_profile_dir_writes_a_trace(tmp_path):
    out = trainer.main([*TINY, "--family", "llama", "--steps", "2",
                        "--profile-dir", str(tmp_path)])
    assert out["final_step"] == 2
    traces = list(tmp_path.glob("trace-*.json"))
    assert len(traces) == 1 and "ProfilerStep" not in traces[0].name
    assert "aten::" in traces[0].read_text()


def test_trainer_metrics_port_serves_the_train_gauges():
    with __import__("socket").socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    result = {}
    runner = threading.Thread(target=lambda: result.update(trainer.main([
        *TINY, "--steps", "400", "--metrics-port", str(port)])))
    runner.start()
    body, deadline = "", time.time() + 60
    gauges = ("train_tokens_per_sec", "train_steps_per_sec", "train_loss",
              "train_step")
    while runner.is_alive() and time.time() < deadline:
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/metrics", timeout=2) as r:
                body = r.read().decode()
        except OSError:
            pass
        if all(g in body for g in gauges):
            break
        time.sleep(0.05)
    runner.join()
    assert all(g in body for g in gauges), body[:500]
    assert "train_mfu" not in body  # no peak is known for the CPU
    assert result["final_step"] == 400
