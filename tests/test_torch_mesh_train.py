"""The port's training mesh (``workloads/train.py``'s mesh functions, the
llama's mesh objective and the trainer over ranks) held against the JAX
package's train steps on its virtual 8-device CPU mesh.

The port runs as 4 or 8 gloo ranks in spawned processes
(``torch_mesh_ranks.py``): every rank builds the same full weights
(converted from the reference's ``init_params`` by
``convert.params_from_jax``), keeps its slices (``place_state``) and
trains on its batch rows; rank 0 gathers the parameters back.  The
reference's ``make_train_step`` runs on a mesh of the same
``(data, seq, model)`` shape.  Everything is fp32.

Tolerances, as ``test_torch_train.py`` holds one device: losses within
1e-5 relative (1e-4 where the sliding window's ring hops merge); every
parameter after AdamW steps within 2e-5, all but 0.1% within 2e-6.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kube_sqs_autoscaler_tpu.workloads import data as jax_data
from kube_sqs_autoscaler_tpu.workloads import llama as jax_llama
from kube_sqs_autoscaler_tpu.workloads import model as jax_model
from kube_sqs_autoscaler_tpu.workloads import train as jax_train
from kube_sqs_autoscaler_tpu_torch.workloads import (
    distributed, llama, model, train, trainer,
)
from kube_sqs_autoscaler_tpu_torch.workloads.convert import params_from_jax
from .torch_mesh_ranks import run_ranks

torch.set_num_threads(1)

GPT = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
           max_seq_len=32)
LLAMA = dict(vocab_size=64, d_model=32, n_heads=4, n_kv_heads=2,
             n_layers=2, d_ff=48, max_seq_len=32)
BATCHES = list(itertools.islice(
    jax_data.synthetic_token_stream(64, 8, 32, seed=5), 3))
OPTIONS = dict(learning_rate=1e-2, grad_clip_norm=0.5, warmup_steps=1,
               decay_steps=4, grad_accum=2)


def family(name, window=None):
    """``(jax config, numpy params, port config)`` of a family."""
    if name == "gpt":
        jcfg = jax_model.ModelConfig(**GPT, dtype=jnp.float32)
        params = jax_model.init_params(jax.random.key(0), jcfg)
        return (jcfg, jax.tree.map(np.asarray, params),
                model.ModelConfig(**GPT, dtype=torch.float32))
    jcfg = jax_llama.LlamaConfig(**LLAMA, sliding_window=window,
                                 dtype=jnp.float32)
    params = jax_llama.init_llama_params(jax.random.key(1), jcfg)
    return (jcfg, jax.tree.map(np.asarray, params),
            llama.LlamaConfig(**LLAMA, sliding_window=window,
                              dtype=torch.float32))


# every run by id: (world, family, window, tp, sp, train options)
RUNS = {
    "gpt-dp2-sp2-tp2": (8, "gpt", None, 2, 2, OPTIONS),
    "llama-dp2-sp2-tp2": (8, "llama", None, 2, 2, OPTIONS),
    "gpt-tp4": (4, "gpt", None, 4, 1, dict(learning_rate=1e-2,
                                           grad_clip_norm=0.5)),
    "gpt-dp4": (4, "gpt", None, 1, 1, dict(learning_rate=1e-2)),
    "llama-window8-dp2-sp2": (4, "llama", 8, 1, 2,
                              dict(learning_rate=1e-2)),
    "llama-window8-tp2-sp2": (4, "llama", 8, 2, 2,
                              dict(learning_rate=1e-2)),
}
_done: dict = {}


def port(name):
    """Run ``name``'s world once with every run of it; rank 0's
    result."""
    world = RUNS[name][0]
    if world not in _done:
        names = [n for n, r in RUNS.items() if r[0] == world]
        runs = []
        for n in names:
            _, fam, window, tp, sp, options = RUNS[n]
            _, npp, cfg = family(fam, window)
            runs.append(dict(family=fam, config=cfg, tp=tp, sp=sp,
                             train=options,
                             params=params_from_jax(npp, cfg, "cpu"),
                             batches=[torch.from_numpy(b) for b in BATCHES]))
        results = run_ranks("train", world, {"runs": runs}, timeout=300)
        for i, n in enumerate(names):
            _done[n] = results[0][i]
            assert all(r[i]["losses"] == results[0][i]["losses"]
                       for r in results)
    return _done[name]


def reference(name):
    world, fam, window, tp, sp, options = RUNS[name]
    jcfg, npp, _ = family(fam, window)
    config = jax_train.TrainConfig(**options)
    mesh = jax_train.make_mesh(jax.devices()[:world], model_parallel=tp,
                               seq_parallel=sp)
    params = jax.tree.map(jnp.asarray, npp)
    state = jax_train.place_state(mesh, {
        "params": params,
        "opt_state": jax_train.make_optimizer(config).init(params),
        "step": jnp.zeros((), jnp.int32)})
    if fam == "llama":
        step_fn = jax_llama.make_llama_train_step(mesh, jcfg, config, state)
    else:
        step_fn = jax_train.make_train_step(mesh, jcfg, config, state)
    losses = []
    for batch in BATCHES:
        state, loss = step_fn(state, jnp.asarray(batch))
        losses.append(float(loss))
    return losses, state["params"]


def jax_leaves(params):
    top = [np.asarray(params[n]) for n in sorted(params) if n != "layers"]
    return top + [np.asarray(layer[n]) for layer in params["layers"]
                  for n in sorted(layer)]


def assert_params_close(got_leaves, want_leaves):
    got = np.concatenate([g.numpy().ravel() for g in got_leaves])
    want = np.concatenate([w.ravel() for w in want_leaves])
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    assert np.mean(np.abs(got - want) > 2e-6) < 1e-3


@pytest.mark.parametrize("name", list(RUNS))
def test_mesh_train_steps_match_the_reference(name):
    got = port(name)
    want_losses, want_params = reference(name)
    rtol = 1e-4 if RUNS[name][2] else 1e-5
    np.testing.assert_allclose(got["losses"], want_losses, rtol=rtol)
    assert got["step"] == len(BATCHES)
    assert_params_close(got["params"], jax_leaves(want_params))


def test_param_slices_round_trip_and_split_fused_projections_by_head():
    _, npp, cfg = family("gpt")
    params = params_from_jax(npp, cfg, "cpu")
    wqkv = params["layers"][0]["wqkv"]
    d = cfg.d_model
    pieces = [train.slice_param(wqkv, train.param_spec("wqkv"), 2, i)
              for i in range(2)]
    # rank i holds heads [i * H/2, (i + 1) * H/2) of q, of k and of v
    for i, piece in enumerate(pieces):
        for j in range(3):
            np.testing.assert_array_equal(
                piece[:, j * d // 2:(j + 1) * d // 2].numpy(),
                wqkv[:, j * d + i * d // 2:j * d + (i + 1) * d // 2].numpy())
    assert torch.equal(train.join_param(pieces, train.param_spec("wqkv")),
                       wqkv)
    # row-parallel wo slices its input axis; norms and positions replicate
    assert train.param_spec("wo") == (0, 1)
    assert train.param_spec("embed") == (0, 1)
    assert train.param_spec("w_gate_up") == (1, 2)
    assert train.param_spec("wkv") == (1, 2)
    for name in ("pos_embed", "ln1_scale", "final_norm", "attn_norm"):
        assert train.param_spec(name) is None
    with pytest.raises(ValueError, match="does not split"):
        train.slice_param(torch.zeros(4, 6), (1, 3), 4, 0)


def test_state_shardings_moments_follow_their_parameter():
    _, npp, cfg = family("llama")
    mesh = distributed.make_mesh(model_parallel=1, seq_parallel=1,
                                 device="cpu")
    state = train.train_state(params_from_jax(npp, cfg, "cpu"),
                              train.TrainConfig())
    specs = train.state_shardings(mesh, state)
    assert specs["step"] is None and specs["optimizer"]["count"] is None
    assert specs["optimizer"]["mu"] == specs["optimizer"]["nu"]
    # a one-rank model axis slices nothing
    assert specs["optimizer"]["mu"] == [None] * len(
        train.param_leaves(state["params"]))


def test_single_rank_mesh_step_equals_the_one_device_step():
    # a trivial mesh (one rank, no process group) runs the mesh objective:
    # the same losses and parameters as the one-device step
    _, npp, cfg = family("gpt")
    tcfg = train.TrainConfig(learning_rate=1e-2)
    mesh = distributed.make_mesh(model_parallel=1, seq_parallel=1,
                                 device="cpu")
    meshed = train.place_state(
        mesh, train.train_state(params_from_jax(npp, cfg, "cpu"), tcfg))
    plain = train.train_state(params_from_jax(npp, cfg, "cpu"), tcfg)
    mesh_step = train.make_train_step(cfg, tcfg, "cpu", mesh=mesh)
    one_step = train.make_train_step(cfg, tcfg, "cpu")
    for batch in BATCHES[:2]:
        meshed, a = mesh_step(meshed, torch.from_numpy(batch))
        plain, b = one_step(plain, torch.from_numpy(batch))
        assert a.item() == pytest.approx(b.item(), rel=1e-6)
    for x, y in zip(train.param_leaves(meshed["params"]),
                    train.param_leaves(plain["params"])):
        np.testing.assert_allclose(x.detach().numpy(), y.detach().numpy(),
                                   atol=1e-6, rtol=0)


BINARY = ["--device", "cpu", "--vocab-size", "256", "--d-model", "64",
          "--n-heads", "4", "--n-layers", "2", "--d-ff", "128", "--seq-len",
          "32", "--batch-size", "4", "--log-every", "1", "--learning-rate",
          "3e-3", "--overfit"]


def test_trainer_over_ranks_checkpoints_serves_and_resumes(tmp_path):
    """The trainer binary over 4 ranks (tp 2 x sp 2): its losses equal
    one process's; its checkpoint holds the full tensors, which the
    single-card worker serves as it serves the gathered parameters; a
    mesh ``--resume`` slices them again and continues the run."""
    from kube_sqs_autoscaler_tpu_torch.workloads import __main__ as worker
    from kube_sqs_autoscaler_tpu_torch.workloads.checkpoint import (
        load_model_manifest,
    )

    ckpt = tmp_path / "ckpt"
    mesh = ["--model-parallel", "2", "--seq-parallel", "2"]
    first = run_ranks("trainer", 4, {"argv": [
        *BINARY, *mesh, "--steps", "3", "--checkpoint-dir", str(ckpt),
        "--checkpoint-every", "2", "--eval-every", "3", "--eval-batches",
        "1"]}, timeout=300)
    second = run_ranks("trainer", 4, {"argv": [
        *BINARY, *mesh, "--steps", "2", "--checkpoint-dir", str(ckpt),
        "--resume"]}, timeout=300)
    whole = trainer.main([*BINARY, "--steps", "5"])
    got = first[0]["losses"] + second[0]["losses"]
    np.testing.assert_allclose(got, whole["losses"], rtol=2e-3)
    assert second[0]["final_step"] == 5
    assert all(r["losses"] == first[0]["losses"] for r in first)
    steps = sorted(p.name for p in ckpt.glob("step_*"))
    assert steps == ["step_00000002", "step_00000003", "step_00000005"]
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


def test_trainer_mesh_refusals():
    parse = trainer.build_parser().parse_args
    for argv, match in (
            (["--pipe-parallel", "2"],
             "1 devices not divisible by pipe_parallel=2"),
            (["--pipe-parallel", "2", "--batch-size", "6",
              "--pipe-schedule", "1f1b"],
             "--batch-size 6 not divisible by --pipe-microbatches 4"),
            (["--zigzag"], "nontrivial seq axis"),
            (["--zigzag", "--seq-parallel", "2", "--family", "llama",
              "--sliding-window", "8"], "does not compose with the zig-zag"),
            (["--seq-parallel", "3", "--seq-len", "32"], "not divisible"),
            (["--seq-parallel", "2", "--seq-len", "32"],
             "1 devices not divisible by model_parallel=1 x "
             "seq_parallel=2"),
            (["--model-parallel", "3", "--seq-len", "32"],
             "1 devices not divisible by model_parallel=3")):
        with pytest.raises(SystemExit, match=match):
            trainer.train(parse(["--device", "cpu", *argv]))
    with pytest.raises(SystemExit) as exit_:
        trainer.main(["--device", "cpu", "--pipe-parallel", "2"])
    assert exit_.value.code == 2


def test_trainer_mesh_flags_over_ranks_refuse_an_indivisible_shape(
        monkeypatch, capsys):
    # as every rank of a 4-rank launch sees it: a usage error (exit 2)
    # with the reference's message, before any rank joins the group
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(SystemExit) as exit_:
        trainer.main([*BINARY, "--model-parallel", "3", "--steps", "1"])
    assert exit_.value.code == 2
    assert ("--model-parallel 3 over 4 rank(s): 4 devices not divisible by "
            "model_parallel=3 x seq_parallel=1") in capsys.readouterr().err


@pytest.mark.parametrize("extra", [
    ["--moe", "--moe-experts", "4", "--seq-parallel", "2", "--zigzag"],
    ["--family", "llama", "--n-kv-heads", "2", "--sliding-window", "8",
     "--lora-rank", "4", "--seq-parallel", "2"],
], ids=["moe-zigzag", "lora-windowed-llama"])
def test_trainer_over_ranks_routes_and_adapts(extra):
    """MoE (experts over data, zig-zag) and LoRA (windowed ring) through
    the binary over 4 ranks: the losses fall, with eval, and the first
    equals one process's (bf16, 1e-3 relative)."""
    argv = [*BINARY, "--steps", "4", "--eval-every", "4",
            "--eval-batches", "1", *extra]
    ranks = run_ranks("trainer", 4, {"argv": argv}, timeout=300)
    losses = ranks[0]["losses"]
    assert all(r["losses"] == losses for r in ranks)
    assert len(losses) == 4 and losses[-1] < losses[0]
    one = [a for a in argv if a not in ("--zigzag",)]
    one = one[:one.index("--seq-parallel")] + one[one.index(
        "--seq-parallel") + 2:]
    assert losses[0] == pytest.approx(trainer.main(one)["losses"][0],
                                      rel=1e-3)
