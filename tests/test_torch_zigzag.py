"""The port's zig-zag ring attention and losses (``workloads/zigzag.py``)
held against the JAX package's on its virtual 8-device CPU mesh.

The port runs as 2, 4 or 8 gloo ranks in spawned processes
(``torch_mesh_ranks.py``); each rank takes its contiguous shard of the
zig-zag-ordered inputs.  The reference runs ``make_zigzag_ring_attention``
(its einsum body) under ``jax.vjp`` on the same permuted inputs over a
mesh of the same ``(data, seq, model)`` shape; its losses and train step
run on the same numpy weights, converted by ``convert.params_from_jax``.

Tolerances: attention outputs and gradients within 1e-5 in f32, 2e-2 in
bf16; losses within 1e-5 relative; parameters after AdamW steps as
``test_torch_train.py`` holds them (every entry within 2e-5, all but
0.1% within 2e-6).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax  # noqa: F401  (the reference's optimizer, imported by train)
import pytest
import torch

from kube_sqs_autoscaler_tpu.workloads import llama as jax_llama
from kube_sqs_autoscaler_tpu.workloads import model as jax_model
from kube_sqs_autoscaler_tpu.workloads import train as jax_train
from kube_sqs_autoscaler_tpu.workloads import zigzag as jax_zigzag
from kube_sqs_autoscaler_tpu_torch.workloads import distributed, ring, zigzag
from kube_sqs_autoscaler_tpu_torch.workloads.convert import params_from_jax
from kube_sqs_autoscaler_tpu_torch.workloads.llama import LlamaConfig
from kube_sqs_autoscaler_tpu_torch.workloads.model import (
    ModelConfig, _dense_attention,
)
from .torch_mesh_ranks import AttentionSpawns, run_ranks

torch.set_num_threads(1)

F32, BF16 = 1e-5, 2e-2


def case(tp=1, sp=4, shape=(4, 4, 4, 32, 8), seed=0, bf16=False):
    rng = np.random.default_rng(seed)
    batch, heads, kv_heads, seq, dim = shape
    arrays = [rng.standard_normal(s).astype(np.float32) for s in (
        (batch, heads, seq, dim), (batch, kv_heads, seq, dim),
        (batch, kv_heads, seq, dim), (batch, heads, seq, dim))]
    dtype = torch.bfloat16 if bf16 else torch.float32
    return dict(kind="zigzag", tp=tp, sp=sp, window=None, bf16=bf16,
                **{n: torch.from_numpy(a).to(dtype)
                   for n, a in zip(("q", "k", "v", "cot"), arrays)})


CASES = {
    "sp2": (2, case(sp=2)),
    "sp4": (4, case()),
    "tp2-sp2": (4, case(tp=2, sp=2, seed=3)),
    "tp2-sp2-gqa": (4, case(tp=2, sp=2, shape=(2, 4, 2, 32, 8), seed=9)),
    "sp4-bf16": (4, case(bf16=True, seed=7)),
    "sp4-gqa": (4, case(shape=(2, 4, 2, 32, 8), seed=5)),
    "sp8": (8, case(sp=8)),
    "dp2-sp2-tp2": (8, case(tp=2, sp=2, seed=3)),
}
SPAWNS = AttentionSpawns(CASES)


def reference(name):
    """The JAX package's zig-zag attention and its vjp on the permuted
    inputs, over a mesh of the same shape."""
    world, c = CASES[name]
    mesh = jax_train.make_mesh(jax.devices()[:world], model_parallel=c["tp"],
                               seq_parallel=c["sp"])
    perm = jax_zigzag.zigzag_permutation(c["q"].shape[2], c["sp"])
    dtype = jnp.bfloat16 if c["bf16"] else jnp.float32
    q, k, v, cot = (jnp.asarray(c[n].float().numpy()[:, :, perm], dtype)
                    for n in ("q", "k", "v", "cot"))
    fn = jax_zigzag.make_zigzag_ring_attention(mesh)

    @jax.jit
    def forward_and_vjp(q, k, v, cot):
        out, vjp = jax.vjp(fn, q, k, v)
        return (out, *vjp(cot))

    return {key: np.asarray(val, np.float32) for key, val in zip(
        ("out", "dq", "dk", "dv"), forward_and_vjp(q, k, v, cot))}


def assert_matches(name, grads=True):
    got, want = SPAWNS.result(name), reference(name)
    tol = BF16 if CASES[name][1]["bf16"] else F32
    for key in ("out", "dq", "dk", "dv") if grads else ("out",):
        np.testing.assert_allclose(got[key], want[key], atol=tol, rtol=0,
                                   err_msg=f"{name}: {key}")


def test_permutation_is_a_bijection_with_device_chunks():
    for seq, n in ((32, 4), (32, 2), (64, 8), (12, 3)):
        perm = zigzag.zigzag_permutation(seq, n)
        np.testing.assert_array_equal(
            perm, jax_zigzag.zigzag_permutation(seq, n))
        assert sorted(perm.tolist()) == list(range(seq))
        inv = zigzag.inverse_permutation(perm)
        np.testing.assert_array_equal(perm[inv], np.arange(seq))
    np.testing.assert_array_equal(zigzag.zigzag_permutation(32, 4)[:8],
                                  [0, 1, 2, 3, 28, 29, 30, 31])


def test_permutation_requires_divisibility():
    with pytest.raises(ValueError, match="divisible") as err:
        zigzag.zigzag_permutation(30, 4)
    with pytest.raises(ValueError) as want:
        jax_zigzag.zigzag_permutation(30, 4)
    assert str(err.value) == str(want.value)


def test_permute_batch_matches_reference():
    tokens = np.random.default_rng(2).integers(0, 50, (3, 32))
    for got, want in zip(zigzag.permute_batch(tokens, 4),
                         jax_zigzag.permute_batch(tokens, 4)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["sp2", "sp4", "sp8"])
def test_zigzag_matches_reference(name):
    # three hop shapes, each a rectangular call of the kernels' plain
    # versions: the diagonal's causal [c, c] and shifted [c, 2c], an
    # earlier rank's [2c, c], a later rank's [c, 2c]
    assert_matches(name)


@pytest.mark.parametrize("name", ["tp2-sp2", "dp2-sp2-tp2"])
def test_zigzag_with_tp_and_dp_axes(name):
    assert_matches(name)


def test_zigzag_is_causal():
    # an oracle independent of the reference: the port's dense causal
    # attention of the whole sequence, in zig-zag order
    c = CASES["sp4"][1]
    perm = zigzag.zigzag_permutation(32, 4)
    want = _dense_attention(c["q"], c["k"], c["v"]).numpy()[:, :, perm]
    np.testing.assert_allclose(SPAWNS.result("sp4")["out"], want, atol=F32,
                               rtol=0)


def test_zigzag_requires_nontrivial_seq_axis():
    mesh = distributed.make_mesh(model_parallel=1, seq_parallel=1,
                                 device="cpu")
    with pytest.raises(ValueError, match="nontrivial seq axis"):
        zigzag.make_zigzag_ring_attention(mesh)


def test_zigzag_loss_rejects_natural_order_attention():
    mesh = distributed.make_mesh(model_parallel=1, seq_parallel=1,
                                 device="cpu")
    with pytest.raises(ValueError, match="zig-zag loss requires"):
        zigzag._require_zigzag_attention(ring.make_ring_attention(mesh),
                                         mesh)
    marked = lambda q, k, v: q  # noqa: E731
    marked._zigzag = True
    assert zigzag._require_zigzag_attention(marked, mesh) is marked


def test_zigzag_loss_refuses_a_windowed_config():
    mesh = distributed.make_mesh(model_parallel=1, seq_parallel=1,
                                 device="cpu")
    config = LlamaConfig(vocab_size=64, d_model=32, n_heads=4, n_kv_heads=2,
                         n_layers=1, d_ff=32, max_seq_len=32,
                         sliding_window=4, dtype=torch.float32)
    with pytest.raises(ValueError, match="does not compose with the zig-zag"):
        zigzag.make_zigzag_loss(mesh, config)


@pytest.mark.parametrize("name", ["tp2-sp2-gqa", "sp4-gqa"])
def test_zigzag_gqa_matches_reference(name):
    assert_matches(name)


def test_zigzag_matches_reference_bf16():
    assert_matches("sp4-bf16", grads=False)


# ---------------------------------------------------------------------------
# the zig-zag objective and train step
# ---------------------------------------------------------------------------

GPT = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
           max_seq_len=32)
LLAMA = dict(vocab_size=64, d_model=32, n_heads=4, n_kv_heads=2,
             n_layers=2, d_ff=48, max_seq_len=32)
BATCHES = [np.random.default_rng(s).integers(0, 64, (4, 32)).astype(np.int32)
           for s in (21, 22)]
_train = {}


def gpt_params(seed=0):
    jcfg = jax_model.ModelConfig(**GPT, dtype=jnp.float32)
    return jcfg, jax.tree.map(np.asarray,
                              jax_model.init_params(jax.random.key(seed),
                                                    jcfg))


def llama_params(seed=1):
    jcfg = jax_llama.LlamaConfig(**LLAMA, dtype=jnp.float32)
    return jcfg, jax.tree.map(
        np.asarray, jax_llama.init_llama_params(jax.random.key(seed), jcfg))


def train_runs():
    """One 4-rank spawn of every zig-zag train run these tests read."""
    if not _train:
        cfg = ModelConfig(**GPT, dtype=torch.float32)
        lcfg = LlamaConfig(**LLAMA, dtype=torch.float32)
        _, npp = gpt_params()
        _, nlp = llama_params()
        batches = [torch.from_numpy(b) for b in BATCHES]
        base = dict(family="gpt", config=cfg,
                    params=params_from_jax(npp, cfg, "cpu"), zigzag=True,
                    batches=batches)
        runs = {
            "sp4": dict(base, tp=1, sp=4, train=dict(learning_rate=1e-2)),
            "sp4-remat": dict(base, tp=1, sp=4,
                              train=dict(learning_rate=1e-2, remat=True)),
            "tp2-sp2": dict(base, tp=2, sp=2,
                            train=dict(learning_rate=1e-2,
                                       grad_clip_norm=0.5)),
            "llama-tp2-sp2": dict(family="llama", config=lcfg,
                                  params=params_from_jax(nlp, lcfg, "cpu"),
                                  zigzag=True, batches=batches[:1], tp=2,
                                  sp=2, train=dict(learning_rate=0.0)),
        }
        results = run_ranks("train", 4, {"runs": list(runs.values())},
                            timeout=240)
        _train.update({name: results[0][i] for i, name in enumerate(runs)})
    return _train


def jax_leaves(params):
    top = [np.asarray(params[n]) for n in sorted(params) if n != "layers"]
    return top + [np.asarray(layer[n]) for layer in params["layers"]
                  for n in sorted(layer)]


def assert_params_close(got_leaves, want_leaves):
    got = np.concatenate([g.numpy().ravel() for g in got_leaves])
    want = np.concatenate([w.ravel() for w in want_leaves])
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    assert np.mean(np.abs(got - want) > 2e-6) < 1e-3


def test_zigzag_loss_matches_natural_order_loss():
    jcfg, npp = gpt_params()
    params = jax.tree.map(jnp.asarray, npp)
    tokens = jnp.asarray(BATCHES[0])
    natural = float(jax.jit(partial(jax_train.loss_fn, config=jcfg))(
        params, tokens))
    got = train_runs()["sp4"]["losses"][0]
    assert got == pytest.approx(natural, rel=1e-5)


def test_zigzag_remat_is_bit_identical():
    runs = train_runs()
    assert runs["sp4"]["losses"] == runs["sp4-remat"]["losses"]
    for a, b in zip(runs["sp4"]["params"], runs["sp4-remat"]["params"]):
        assert torch.equal(a, b)


def test_zigzag_train_step_matches_reference():
    jcfg, npp = gpt_params()
    config = jax_train.TrainConfig(learning_rate=1e-2, grad_clip_norm=0.5)
    mesh = jax_train.make_mesh(jax.devices()[:4], model_parallel=2,
                               seq_parallel=2)
    params = jax.tree.map(jnp.asarray, npp)
    state = jax_train.place_state(mesh, {
        "params": params,
        "opt_state": jax_train.make_optimizer(config).init(params),
        "step": jnp.zeros((), jnp.int32)})
    step_fn = jax_zigzag.make_zigzag_train_step(mesh, jcfg, config, state)
    want = []
    for batch in BATCHES:
        state, loss = step_fn(state, jnp.asarray(batch))
        want.append(float(loss))
    got = train_runs()["tp2-sp2"]
    np.testing.assert_allclose(got["losses"], want, rtol=1e-5)
    assert_params_close(got["params"], jax_leaves(state["params"]))


def test_llama_zigzag_loss_matches_reference():
    jcfg, nlp = llama_params()
    mesh = jax_train.make_mesh(jax.devices()[:4], model_parallel=2,
                               seq_parallel=2)
    params = jax.tree.map(jnp.asarray, nlp)
    tokens = jnp.asarray(BATCHES[0])
    zz = float(jax.jit(partial(
        jax_zigzag.zigzag_loss_fn, config=jcfg, mesh=mesh,
        forward_fn=jax_llama.llama_forward))(params, tokens))
    dense = float(jax.jit(partial(jax_llama.llama_loss_fn, config=jcfg))(
        params, tokens))
    got = train_runs()["llama-tp2-sp2"]["losses"][0]
    assert got == pytest.approx(zz, rel=1e-5)
    assert got == pytest.approx(dense, rel=1e-5)
