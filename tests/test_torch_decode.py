"""The port's KV-cache decode held against the JAX reference decode.

Same weights (the reference's init, converted) and numpy inputs on both
sides, f32 on the CPU.  Logits agree to 1e-4; greedy tokens must be
identical, and every greedy comparison first checks that the reference's
top-two logit margin exceeds 1e-4, so a flipped token is a real bug and
not a near-tie.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kube_sqs_autoscaler_tpu.workloads import decode as jax_decode
from kube_sqs_autoscaler_tpu.workloads import flash as jax_flash
from kube_sqs_autoscaler_tpu_torch.workloads import decode, flash

from .test_torch_model import DIMS, as_numpy, both_params, tokens

MARGIN = 1e-4
LENGTHS = np.array([24, 9, 17], np.int32)  # ragged right-padded prompts


def top2_margin(logits: np.ndarray) -> np.ndarray:
    top = np.sort(logits, axis=-1)
    return top[..., -1] - top[..., -2]


def reference_greedy_margins(jcfg, jp, prompt, lengths, num_tokens, eos_id):
    """The smallest top-two margin over the reference's own greedy
    trajectory (rows already finished at ``eos_id`` excluded)."""
    logits, cache = jax_decode.prefill(jp, prompt, jcfg, lengths=lengths)
    margins = []
    done = np.zeros(prompt.shape[0], bool)
    for _ in range(num_tokens):
        logits = np.asarray(logits)
        margins.append(top2_margin(logits)[~done])
        token = logits.argmax(-1)
        if eos_id is not None:
            token = np.where(done, eos_id, token)
            done = done | (token == eos_id)
        logits, cache = jax_decode.decode_step(
            jp, cache, jnp.asarray(token, jnp.int32), jcfg)
    return float(np.concatenate(margins).min())


def test_prefill_logits_and_cache_match_reference():
    jcfg, jp, tcfg, tp = both_params()
    ids = tokens(3, 24, seed=5)
    want_logits, want_cache = jax_decode.prefill(
        jp, jnp.asarray(ids), jcfg, lengths=jnp.asarray(LENGTHS))
    got_logits, got_cache = decode.prefill(
        tp, torch.from_numpy(ids), tcfg, lengths=torch.from_numpy(LENGTHS))
    np.testing.assert_allclose(as_numpy(got_logits), np.asarray(want_logits),
                               atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got_cache["length"].numpy(), LENGTHS)
    for want, got in zip(want_cache["layers"], got_cache["layers"]):
        for name in ("k", "v"):
            np.testing.assert_allclose(as_numpy(got[name]),
                                       np.asarray(want[name]),
                                       atol=1e-4, rtol=0)


def test_prefill_through_flash_seam_matches_reference_kernel():
    jcfg, jp, tcfg, tp = both_params()
    ids = tokens(2, 64, seed=6)

    def jax_attend(q, k, v):
        return jax_flash.flash_attention(q, k, v, interpret=True)

    want, _ = jax_decode.prefill(jp, jnp.asarray(ids), jcfg,
                                 attention_fn=jax_attend)
    got, _ = decode.prefill(tp, torch.from_numpy(ids), tcfg,
                            attention_fn=flash.flash_attention)
    np.testing.assert_allclose(as_numpy(got), np.asarray(want), atol=1e-4,
                               rtol=0)


def test_decode_steps_match_reference():
    jcfg, jp, tcfg, tp = both_params()
    ids = tokens(3, 24, seed=7)
    _, jcache = jax_decode.prefill(jp, jnp.asarray(ids), jcfg,
                                   lengths=jnp.asarray(LENGTHS))
    _, tcache = decode.prefill(tp, torch.from_numpy(ids), tcfg,
                               lengths=torch.from_numpy(LENGTHS))
    rng = np.random.default_rng(8)
    for _ in range(3):
        step = rng.integers(0, DIMS["vocab_size"], 3).astype(np.int32)
        want, jcache = jax_decode.decode_step(jp, jcache, jnp.asarray(step),
                                              jcfg)
        got, tcache = decode.decode_step(tp, tcache, torch.from_numpy(step),
                                         tcfg)
        np.testing.assert_allclose(as_numpy(got), np.asarray(want),
                                   atol=1e-4, rtol=0)
    np.testing.assert_array_equal(tcache["length"].numpy(), LENGTHS + 3)


@pytest.mark.parametrize("use_eos", [False, True])
def test_greedy_generate_tokens_identical_to_reference(use_eos):
    jcfg, jp, tcfg, tp = both_params()
    ids = tokens(3, 24, seed=9)
    steps = 12
    plain = np.asarray(jax_decode.generate_jit(
        jp, jnp.asarray(ids), steps, jcfg, lengths=jnp.asarray(LENGTHS)))
    # an eos that row 0 emits mid-run, so the pinning path is exercised
    eos_id = int(plain[0, 3]) if use_eos else None
    margin = reference_greedy_margins(jcfg, jp, jnp.asarray(ids),
                                      jnp.asarray(LENGTHS), steps, eos_id)
    assert margin > MARGIN
    want = np.asarray(jax_decode.generate_jit(
        jp, jnp.asarray(ids), steps, jcfg, lengths=jnp.asarray(LENGTHS),
        eos_id=eos_id))
    got = decode.generate(tp, torch.from_numpy(ids), steps, tcfg,
                          lengths=torch.from_numpy(LENGTHS), eos_id=eos_id)
    np.testing.assert_array_equal(got.numpy(), want)
    # the run is not degenerate: rows produce more than one distinct token
    assert len(set(want[1].tolist())) > 1
    if use_eos:
        first = list(want[0]).index(eos_id)
        assert (want[0, first:] == eos_id).all()


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (0.7, 0, 1.0), (1.3, 5, 1.0), (1.0, 0, 0.6), (0.5, 7, 0.8),
])
def test_warp_logits_matches_reference_exactly(temperature, top_k, top_p):
    rng = np.random.default_rng(10)
    logits = (rng.standard_normal((4, DIMS["vocab_size"])) * 3).astype(
        np.float32)
    want = np.asarray(jax_decode.warp_logits(
        jnp.asarray(logits), temperature, top_k, top_p))
    got = decode.warp_logits(torch.from_numpy(logits), temperature, top_k,
                             top_p).numpy()
    np.testing.assert_array_equal(got, want)


def test_sampled_generate_is_reproducible_and_top_k_1_is_greedy():
    _, _, tcfg, tp = both_params()
    ids = torch.from_numpy(tokens(3, 16, seed=11))

    def sample(seed, **kw):
        generator = torch.Generator().manual_seed(seed)
        return decode.generate(tp, ids, 8, tcfg, temperature=1.0,
                               generator=generator, **kw)

    assert torch.equal(sample(3), sample(3))
    assert not torch.equal(sample(3), sample(4))
    greedy = decode.generate(tp, ids, 8, tcfg)
    assert torch.equal(sample(5, top_k=1), greedy)


def test_generate_validates_its_budget_and_sampling_arguments():
    _, _, tcfg, tp = both_params()
    ids = torch.zeros((1, 16), dtype=torch.int32)
    with pytest.raises(ValueError, match="max_seq_len"):
        decode.generate(tp, ids, DIMS["max_seq_len"], tcfg)
    with pytest.raises(ValueError, match="generator"):
        decode.generate(tp, ids, 2, tcfg, temperature=1.0)
    with pytest.raises(ValueError, match="num_tokens"):
        decode.generate(tp, ids, 0, tcfg)
    with pytest.raises(ValueError, match="top_p"):
        decode._pick(torch.zeros((1, 4)), None, 1.0, top_p=0.0)
