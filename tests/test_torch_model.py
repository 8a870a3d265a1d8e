"""The PyTorch port's GPT forward held against the JAX reference model.

Weights come from the reference's ``init_params`` and reach the port
through ``convert.params_from_jax``; inputs come from numpy seeds.  Both
sides run on the CPU.  f32 logits agree to 1e-4 (the same math, summed in
another order); bf16 logits agree to 1e-4 with the reference's jitted
program, whose rounding the port follows (eager JAX rounds elsewhere).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from kube_sqs_autoscaler_tpu.workloads import flash as jax_flash
from kube_sqs_autoscaler_tpu.workloads import model as jax_model
from kube_sqs_autoscaler_tpu_torch.workloads import flash, model
from kube_sqs_autoscaler_tpu_torch.workloads.convert import params_from_jax

# these tests are tiny, and the suite runs in several pytest workers that
# share the CPU: one intra-op thread each keeps torch from oversubscribing it
torch.set_num_threads(1)

# tiny sizes for the CPU: 2 layers, d_model 64, head_dim 32
DIMS = dict(vocab_size=96, d_model=64, n_heads=2, n_layers=2, d_ff=128,
            max_seq_len=96)
BOOST = 8.0  # widen the weights so logits spread and layers mix tokens


def configs(dtype: str = "float32"):
    """(reference config, port config) of the same dimensions."""
    return (
        jax_model.ModelConfig(**DIMS, dtype=getattr(jnp, dtype)),
        model.ModelConfig(**DIMS, dtype=getattr(torch, dtype)),
    )


def numpy_params(jcfg, seed: int = 0) -> dict:
    """The reference's init as numpy, every matrix scaled by ``BOOST``
    (at the init's 0.02 std a 2-layer model's logits are near-flat and
    it copies its input)."""
    def boost(leaf):
        if leaf.ndim != 2:
            return leaf
        return (leaf.astype(np.float32) * BOOST).astype(leaf.dtype)

    return jax.tree.map(
        lambda leaf: boost(np.asarray(leaf)),
        jax_model.init_params(jax.random.key(seed), jcfg),
    )


def both_params(dtype: str = "float32", seed: int = 0):
    """(reference config, reference params, port config, port params)."""
    jcfg, tcfg = configs(dtype)
    npp = numpy_params(jcfg, seed)
    return (
        jcfg, jax.tree.map(jnp.asarray, npp),
        tcfg, params_from_jax(npp, tcfg, "cpu"),
    )


def tokens(batch: int, seq: int, seed: int = 1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, DIMS["vocab_size"], (batch, seq)).astype(np.int32)


def as_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


# bf16 against the jitted reference (the serving paths' programs): the
# port rounds where XLA's compiled program does, so what is left is the
# fp32 readout's noise (about 6e-7 at these seeds; eager JAX rounds
# elsewhere and differs from its own compiled program by ~0.08)
@pytest.mark.parametrize("dtype,atol", [("float32", 1e-4), ("bfloat16", 1e-4)])
def test_forward_matches_reference_dense(dtype, atol):
    jcfg, jp, tcfg, tp = both_params(dtype)
    ids = tokens(2, 48)
    forward = jax.jit(jax_model.forward, static_argnames="config")
    want = np.asarray(forward(jp, jnp.asarray(ids), config=jcfg),
                      np.float32)
    got = as_numpy(model.forward(tp, torch.from_numpy(ids), tcfg))
    assert got.shape == (2, 48, DIMS["vocab_size"])
    # the logits must not be near-constant, or the comparison says little
    assert want.std() > 0.5
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def test_forward_matches_reference_through_flash_seam():
    jcfg, jp, tcfg, tp = both_params()
    ids = tokens(2, 64, seed=3)

    def jax_attend(q, k, v):
        return jax_flash.flash_attention(q, k, v, interpret=True)

    want = np.asarray(jax_model.forward(jp, jnp.asarray(ids), jcfg,
                                        attention_fn=jax_attend))
    got = as_numpy(model.forward(tp, torch.from_numpy(ids), tcfg,
                                 attention_fn=flash.flash_attention))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_split_projection_layout_matches_fused():
    _, _, tcfg, tp = both_params()
    split = {**tp, "layers": []}
    for layer in tp["layers"]:
        wq, wk, wv = torch.chunk(layer["wqkv"], 3, dim=-1)
        rest = {n: t for n, t in layer.items() if n != "wqkv"}
        split["layers"].append({**rest, "wq": wq, "wk": wk, "wv": wv})
    ids = torch.from_numpy(tokens(2, 16))
    torch.testing.assert_close(
        model.forward(split, ids, tcfg), model.forward(tp, ids, tcfg),
        atol=1e-6, rtol=0,
    )


def test_gpt_module_holds_reference_names_and_runs_forward():
    jcfg, jp, tcfg, tp = both_params()
    gpt = model.GPT(tcfg, tp)
    names = dict(gpt.named_parameters())
    assert {"embed", "pos_embed", "final_ln_scale", "final_ln_bias",
            "layers.0.wqkv", "layers.1.w_down"} <= set(names)
    assert model.param_count(gpt.params()) == jax_model.param_count(jp)
    ids = torch.from_numpy(tokens(1, 16))
    assert torch.equal(gpt(ids), model.forward(tp, ids, tcfg))


def test_init_params_is_seeded_and_shaped_like_reference():
    _, tcfg = configs("bfloat16")
    a = model.init_params(tcfg, torch.Generator().manual_seed(5), "cpu")
    b = model.init_params(tcfg, torch.Generator().manual_seed(5), "cpu")
    ref = jax_model.init_params(jax.random.key(0), configs("bfloat16")[0])
    assert torch.equal(a["embed"], b["embed"])
    assert a["embed"].dtype == torch.bfloat16
    for name, leaf in ref["layers"][0].items():
        assert tuple(a["layers"][0][name].shape) == leaf.shape, name
    assert tuple(a["pos_embed"].shape) == ref["pos_embed"].shape


def test_mlp_gelu_is_the_tanh_approximation():
    x = torch.tensor([[-2.0, -0.5, 0.0, 1.0, 3.0]])
    eye = torch.eye(5)
    got = model._mlp(x, {"w_up": eye, "w_down": eye})
    want = np.asarray(jax.nn.gelu(jnp.asarray(x.numpy())))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    assert abs(float(got[0, 3]) - 0.841192) < 1e-5
    # the exact (erf) form differs at x = 1: 0.841345
    assert abs(float(F.gelu(torch.tensor(1.0))) - float(got[0, 3])) > 1e-4


def test_layer_norm_matches_reference():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 7, 64)).astype(np.float32) * 3 + 1
    scale = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    want = np.asarray(jax_model._layer_norm(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias)))
    got = model._layer_norm(torch.from_numpy(x), torch.from_numpy(scale),
                            torch.from_numpy(bias)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def test_embedding_wraps_and_clamps_untrusted_ids_like_jax():
    vocab = DIMS["vocab_size"]
    ids = np.array([[vocab, vocab + 5, -1, -vocab - 2, 3]], np.int32)
    table = np.arange(vocab * 2, dtype=np.float32).reshape(vocab, 2)
    want = np.asarray(jnp.asarray(table)[jnp.asarray(ids)])
    got = model.embed_tokens(torch.from_numpy(table),
                             torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        model.safe_ids(torch.from_numpy(ids), vocab).numpy(),
        [[vocab - 1, vocab - 1, vocab - 1, 0, 3]],
    )
    # and through the whole forward
    jcfg, jp, tcfg, tp = both_params()
    want = np.asarray(jax_model.forward(jp, jnp.asarray(ids), jcfg))
    got = as_numpy(model.forward(tp, torch.from_numpy(ids), tcfg))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_forward_rejects_sequences_past_max_seq_len():
    _, _, tcfg, tp = both_params()
    with pytest.raises(ValueError, match="max_seq_len"):
        model.forward(tp, torch.zeros((1, DIMS["max_seq_len"] + 1),
                                      dtype=torch.int32), tcfg)
