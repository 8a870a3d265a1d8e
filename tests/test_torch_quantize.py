"""The port's int8 weights held against the JAX package's.

Weights come from the reference's init (the GPT's of
``test_torch_model``, the llama's of ``test_torch_llama``: 2 layers,
d_model 64, the llama at 4 query heads over 2 kv heads) and reach the port
through ``convert.params_from_jax``; an int8 tree goes across as the
reference quantized it, codes and scales exact.  Codes and scales of the
same fp32 input are bitwise the reference's.  f32 logits agree to 1e-5 of
``max(1, max|ref|)``.  bf16 greedy tokens are compared up to the first
position where the reference's top-two margin is below the family's
guard, 1e-4 for both families: each port rounds bf16 where the
reference's compiled program does.

The helpers here (both sides' weights, int8 or not, the jitted reference
entry points and the near-tie comparison) serve ``test_torch_int8_cache``
and ``test_torch_prefix`` too.
"""

import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kube_sqs_autoscaler_tpu.workloads import decode as jax_decode
from kube_sqs_autoscaler_tpu.workloads import llama as jax_llama
from kube_sqs_autoscaler_tpu.workloads import model as jax_model
from kube_sqs_autoscaler_tpu.workloads import quantize as jax_quantize
from kube_sqs_autoscaler_tpu_torch.workloads import model, quantize
from kube_sqs_autoscaler_tpu_torch.workloads.convert import params_from_jax
from kube_sqs_autoscaler_tpu_torch.workloads.family import family_of

from .test_torch_decode import top2_margin
from .test_torch_llama import both_params as llama_both
from .test_torch_model import both_params as gpt_both

torch.set_num_threads(1)

F32_TOL = 1e-5
# the greedy comparisons' near-tie guard, by family (see module docstring)
BF16_GUARD = {"gpt": 1e-4, "llama": 1e-4}
MARGIN = 1e-4
VOCAB = {"gpt": 96, "llama": 128}


@functools.lru_cache(maxsize=None)
def weights(family: str, dtype: str = "float32", window=None,
            int8: bool = False):
    """(reference config, reference params, port config, port params) of
    ``family``; ``int8`` quantizes the reference's tree and converts it.
    Cached: callers share them and change neither."""
    if family == "gpt":
        jcfg, jp, tcfg, tp = gpt_both(dtype)
    else:
        jcfg, jp, tcfg, tp = llama_both(dtype, sliding_window=window)
    if int8:
        jp = jax_quantize.quantize_params(jp, family)
        tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jcfg, jp, tcfg, tp


# the reference's entry points, by family, each jitted once
JAX_NAMES = {
    "forward": ("forward", "llama_forward"),
    "generate": ("generate", "llama_generate"),
    "prefill": ("prefill", "llama_prefill"),
    "quantized_prefill": ("quantized_prefill", "llama_quantized_prefill"),
    "decode_step": ("decode_step", "llama_decode_step"),
    "quantized_decode_step": ("quantized_decode_step",
                              "llama_quantized_decode_step"),
    "chunk_decode": ("chunk_decode", "llama_chunk_decode"),
    "quantized_chunk_decode": ("quantized_chunk_decode",
                               "llama_quantized_chunk_decode"),
    "prefill_prefix": ("prefill_prefix", "llama_prefill_prefix"),
    "quantized_prefill_prefix": ("quantized_prefill_prefix",
                                 "llama_quantized_prefill_prefix"),
    "prefill_with_prefix": ("prefill_with_prefix",
                            "llama_prefill_with_prefix"),
    "quantized_prefill_with_prefix": ("quantized_prefill_with_prefix",
                                      "llama_quantized_prefill_with_prefix"),
}
STATIC = ("config", "num_tokens", "quantized_cache", "eos_id")


@functools.lru_cache(maxsize=None)
def ref(family: str, name: str):
    gpt_name, llama_name = JAX_NAMES[name]
    if family == "llama":
        fn = getattr(jax_llama, llama_name)
    elif name == "forward":
        fn = jax_model.forward
    else:
        fn = getattr(jax_decode, gpt_name)
    takes = inspect.signature(fn).parameters
    return jax.jit(fn, static_argnames=[n for n in STATIC if n in takes])


def as_numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t, np.float32)


def assert_close(got, want, tol=F32_TOL):
    want = as_numpy(want)
    np.testing.assert_allclose(
        as_numpy(got), want, rtol=0,
        atol=tol * max(1.0, float(np.abs(want).max())))


def tokens(family: str, batch: int, seq: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, VOCAB[family], (batch, seq)).astype(np.int32)


def reference_rollout(start, step, steps):
    """The reference's greedy tokens ``[B, steps]`` along its own
    trajectory (``start() -> (logits, cache)``, ``step(cache, token) ->
    (logits, cache)``) and each token's top-two margin ``[B, steps]``."""
    logits, cache = start()
    out, margins = [], []
    for i in range(steps):
        logits = np.asarray(logits, np.float32)
        margins.append(top2_margin(logits))
        token = logits.argmax(-1)
        out.append(token)
        if i < steps - 1:
            logits, cache = step(cache, jnp.asarray(token, jnp.int32))
    return np.stack(out, axis=1), np.stack(margins, axis=1)


def assert_tokens_upto_ties(got, want, margins, guard):
    """Each row's tokens equal up to its first position whose reference
    margin is below ``guard``; at least a position a row on average must
    be compared."""
    got = np.asarray(got)
    compared = 0
    for row in range(want.shape[0]):
        low = np.flatnonzero(margins[row] < guard)
        upto = int(low[0]) if low.size else want.shape[1]
        np.testing.assert_array_equal(got[row, :upto], want[row, :upto],
                                      err_msg=f"row {row}")
        compared += upto
    assert compared >= want.shape[0], (compared, want.size)


# ---------------------------------------------------------------------------
# Codes and scales
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_arrays_bitwise_equal_to_reference(dtype):
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((48, 40)) * 0.05).astype(np.float32)
    w[:, 3] = 0.0  # an all-zero column takes the floor scale
    w[5, 7] = 0.5 * w[:, 7].max()  # values at the rounding boundaries
    w[:, 9] = np.linspace(-1.27, 1.27, 48)
    jw = jnp.asarray(w, getattr(jnp, dtype))
    want_codes, want_scale = jax_quantize._quantize_arrays(jw)
    got_codes, got_scale = quantize._quantize_arrays(
        torch.from_numpy(np.array(jw, np.float32)).to(getattr(torch, dtype)))
    assert got_codes.dtype == torch.int8 and got_scale.dtype == torch.float32
    assert np.array_equal(got_codes.numpy(), np.asarray(want_codes))
    assert np.array_equal(got_scale.numpy(), np.asarray(want_scale))
    assert float(got_scale[3]) == pytest.approx(1e-12)


@pytest.mark.parametrize("family", ["gpt", "llama"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_params_bitwise_and_bytes_match_reference(family, dtype):
    jcfg, jp, tcfg, tp = weights(family, dtype)
    want = jax_quantize.quantize_params(jp, family)
    got = quantize.quantize_params(tp, family)
    names = (quantize._LLAMA_WEIGHTS if family == "llama"
             else quantize._GPT_WEIGHTS)
    assert names == (jax_quantize._LLAMA_WEIGHTS if family == "llama"
                     else jax_quantize._GPT_WEIGHTS)
    for got_layer, want_layer, plain in zip(got["layers"], want["layers"],
                                            tp["layers"]):
        assert sorted(got_layer) == sorted(want_layer)
        for name, leaf in got_layer.items():
            if name in names:
                assert isinstance(leaf, quantize.QuantizedTensor)
                assert leaf.dtype == getattr(torch, dtype)
                w = want_layer[name]
                assert np.array_equal(leaf.codes.numpy(), np.asarray(w.codes))
                assert np.array_equal(leaf.scale.numpy(), np.asarray(w.scale))
            else:  # norms stay, as the same tensors
                assert leaf is plain[name]
    assert got["embed"] is tp["embed"]
    assert quantize.quantized_bytes(got) == jax_quantize.quantized_bytes(want)
    assert quantize.quantized_bytes(tp) == jax_quantize.quantized_bytes(jp)
    # what the reference quantized crosses over bit for bit
    converted = params_from_jax(jax.tree.map(np.asarray, want), tcfg, "cpu")
    for a, b in zip(quantize.param_leaves(converted),
                    quantize.param_leaves(got)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_quantized_tensor_is_a_drop_in_weight():
    _, _, tcfg, tp = weights("gpt")
    w = tp["layers"][0]["wqkv"]
    q = quantize._quantize_weight(w)
    h = torch.randn(3, 5, w.shape[0],
                    generator=torch.Generator().manual_seed(1))
    # h @ q falls through Tensor.__matmul__ to QuantizedTensor.__rmatmul__
    assert torch.equal(h @ q, h @ q.dequantize())
    g = torch.randn(w.shape[1], 4, generator=torch.Generator().manual_seed(2))
    assert torch.equal(q @ g, q.dequantize() @ g)
    assert q.shape == w.shape and q.numel() == w.numel()
    moved = q.to("cpu")
    assert torch.equal(moved.codes, q.codes) and moved.dtype == q.dtype
    assert (q.dequantize() - w).abs().max() <= q.scale.max() / 2 + 1e-7
    qp = quantize.quantize_params(tp, "gpt")
    assert model.param_count(qp) == model.param_count(tp)
    assert quantize.quantized_bytes(qp) < quantize.quantized_bytes(tp)


# ---------------------------------------------------------------------------
# The forward with int8 weights
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family,window", [("gpt", None), ("llama", None),
                                           ("llama", 6)],
                         ids=["gpt", "llama", "llama-window"])
def test_int8_forward_matches_reference_f32(family, window):
    jcfg, jp, tcfg, tp = weights(family, "float32", window, int8=True)
    ids = tokens(family, 3, 20, seed=3)
    want = ref(family, "forward")(jp, jnp.asarray(ids), config=jcfg)
    got = family_of(tcfg).forward(tp, torch.from_numpy(ids), tcfg, None)
    assert got.dtype == torch.float32
    assert float(np.asarray(want).std()) > 0.5
    assert_close(got, want)
    # int8 moves the logits: the comparison is not the bf16 one's
    plain = family_of(tcfg).forward(weights(family, "float32", window)[3],
                                    torch.from_numpy(ids), tcfg, None)
    assert not torch.allclose(plain, got, atol=1e-4)


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_int8_forward_bf16_greedy_tokens_match_reference(family):
    jcfg, jp, tcfg, tp = weights(family, "bfloat16", int8=True)
    ids = tokens(family, 3, 20, seed=4)
    want = np.asarray(ref(family, "forward")(jp, jnp.asarray(ids),
                                              config=jcfg), np.float32)
    got = as_numpy(family_of(tcfg).forward(tp, torch.from_numpy(ids), tcfg,
                                           None))
    margins = top2_margin(want).reshape(-1)
    keep = margins > BF16_GUARD[family]
    assert keep.mean() > 0.5
    np.testing.assert_array_equal(got.argmax(-1).reshape(-1)[keep],
                                  want.argmax(-1).reshape(-1)[keep])
    if family == "llama":  # rounded where the reference rounds
        assert_close(got, want, 2e-2)


@pytest.mark.parametrize("family,dtype", [("gpt", "float32"),
                                          ("llama", "float32"),
                                          ("gpt", "bfloat16"),
                                          ("llama", "bfloat16")])
def test_int8_weights_generate_matches_reference(family, dtype):
    jcfg, jp, tcfg, tp = weights(family, dtype, int8=True)
    ids = tokens(family, 3, 12, seed=5)
    lengths = np.array([12, 5, 9], np.int32)
    steps = 8
    want = np.asarray(ref(family, "generate")(
        jp, jnp.asarray(ids), num_tokens=steps, config=jcfg,
        lengths=jnp.asarray(lengths)))
    _, margins = reference_rollout(
        lambda: ref(family, "prefill")(jp, jnp.asarray(ids), config=jcfg,
                                       lengths=jnp.asarray(lengths)),
        lambda cache, token: ref(family, "decode_step")(jp, cache, token,
                                                        config=jcfg),
        steps)
    got = family_of(tcfg).generate(tp, torch.from_numpy(ids), steps, tcfg,
                                   None, lengths=torch.from_numpy(lengths))
    guard = MARGIN if dtype == "float32" else BF16_GUARD[family]
    assert_tokens_upto_ties(got.numpy(), want, margins, guard)
