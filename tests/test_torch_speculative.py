"""The port's speculative decoding held against the JAX package's.

Both families' 2-layer test models (``test_torch_model``'s GPT,
``test_torch_llama``'s llama) with the early-exit self-draft of their
first layer (``draft_layers=1``), weights from the reference's init
through ``convert.params_from_jax``.  Greedy speculative output equals the
reference's speculative output and the port's own greedy ``generate`` up
to the first position where the reference's top-two margin along its
greedy trajectory is below the guard (1e-4 in f32, the families' bf16
guard in bf16): the verify chunk sums in another order than a decode
step, so only near-ties may resolve apart.  Sampled speculative matches
only in distribution (JAX's PRNG is not torch's): the acceptance rule's
marginal is measured over 10^5 rows, as the reference's test does.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kube_sqs_autoscaler_tpu.workloads import speculative as jax_spec
from kube_sqs_autoscaler_tpu.workloads import model as jax_model
from kube_sqs_autoscaler_tpu_torch.workloads import decode, speculative
from kube_sqs_autoscaler_tpu_torch.workloads.convert import params_from_jax
from kube_sqs_autoscaler_tpu_torch.workloads.family import family_of
from kube_sqs_autoscaler_tpu_torch.workloads.model import (
    ModelConfig, init_params,
)

from .test_torch_llama import both_params as llama_both
from .test_torch_prefix import both_prefixes, name
from .test_torch_quantize import (
    BF16_GUARD, MARGIN, assert_tokens_upto_ties, ref, reference_rollout,
    tokens, weights,
)

torch.set_num_threads(1)

LENGTHS = np.array([16, 9, 12], np.int32)  # ragged right-padded prompts
STEPS = 10
K = 3


def jax_self_draft(jp, jcfg, n_layers=1):
    return (dict(jp, layers=jp["layers"][:n_layers]),
            dataclasses.replace(jcfg, n_layers=n_layers))


def jax_speculative(jp, jcfg, ids, steps, **kw):
    dp, dcfg = jax_self_draft(jp, jcfg)
    return jax_spec.speculative_generate_jit(
        jp, jcfg, dp, dcfg, jnp.asarray(ids), steps, K, **kw)


def port_speculative(tp, tcfg, ids, steps, **kw):
    dp, dcfg = speculative.self_draft(tp, tcfg, 1)
    return speculative.speculative_generate(
        tp, tcfg, dp, dcfg, torch.from_numpy(ids), steps, draft_tokens=K,
        **kw)


def greedy_margins(family, jcfg, jp, ids, lengths, steps, quantized=False,
                   prefix=None):
    """The reference's greedy tokens and top-two margins along its own
    trajectory."""
    if prefix is None:
        start = lambda: ref(family, name("prefill", quantized))(  # noqa: E731
            jp, jnp.asarray(ids), config=jcfg, lengths=jnp.asarray(lengths))
    else:
        start = lambda: ref(  # noqa: E731
            family, name("prefill_with_prefix", quantized))(
            jp, prefix, jnp.asarray(ids), config=jcfg,
            lengths=jnp.asarray(lengths))
    step = ref(family, name("decode_step", quantized))
    return reference_rollout(
        start, lambda cache, t: step(jp, cache, t, config=jcfg), steps)


CASES = [(f, d) for f in ("gpt", "llama") for d in ("float32", "bfloat16")]


@pytest.mark.parametrize("family,dtype", CASES,
                         ids=[f"{f}-{d}" for f, d in CASES])
def test_greedy_speculative_matches_reference_and_generate(family, dtype):
    """Ragged prompts, both families, f32 and bf16; in f32 also with an
    eos that row 0 emits mid-run (rows freeze at different rounds) and
    the per-row stats, which equal the reference's."""
    jcfg, jp, tcfg, tp = weights(family, dtype)
    ids = tokens(family, 3, 16, seed=5)
    greedy, margins = greedy_margins(family, jcfg, jp, ids, LENGTHS, STEPS)
    f32 = dtype == "float32"
    guard = MARGIN if f32 else BF16_GUARD[family]
    kw = dict(eos_id=int(greedy[0, 3]), return_stats=True) if f32 else {}
    want = jax_speculative(jp, jcfg, ids, STEPS,
                           lengths=jnp.asarray(LENGTHS), **kw)
    got = port_speculative(tp, tcfg, ids, STEPS,
                           lengths=torch.from_numpy(LENGTHS), **kw)
    if f32:
        (want, want_stats), (got, stats) = want, got
        assert margins.min() > MARGIN
        np.testing.assert_array_equal(stats["rounds"].numpy(),
                                      np.asarray(want_stats["rounds"]))
        np.testing.assert_allclose(
            stats["acceptance_rate"].numpy(),
            np.asarray(want_stats["acceptance_rate"]), rtol=0, atol=1e-6)
        eos_id = kw["eos_id"]
        first = list(got[0].numpy()).index(eos_id)
        assert (got[0, first:] == eos_id).all() and first < STEPS - 1
    want = np.asarray(want)
    assert got.shape == (3, STEPS) and got.dtype == torch.long
    assert_tokens_upto_ties(got.numpy(), want, margins, guard)
    plain = family_of(tcfg).generate(
        tp, torch.from_numpy(ids), STEPS, tcfg, None,
        lengths=torch.from_numpy(LENGTHS), eos_id=kw.get("eos_id"))
    assert_tokens_upto_ties(got.numpy(), plain.numpy(), margins, guard)


@pytest.mark.parametrize("family,quantized,prefixed", [
    ("gpt", True, False), ("llama", True, False),
    ("gpt", False, True), ("llama", True, True),
], ids=["gpt-int8", "llama-int8", "gpt-prefix", "llama-int8-prefix"])
def test_int8_and_prefix_speculative_match_reference(family, quantized,
                                                     prefixed):
    jcfg, jp, tcfg, tp = weights(family)
    ids = tokens(family, 3, 12, seed=7)
    lengths = np.array([12, 5, 9], np.int32)
    jprefix = tprefix = None
    kw, tkw = {}, {}
    if prefixed:
        jprefix, tprefix = both_prefixes(family, quantized)
        kw = dict(prefix_cache=jprefix,
                  draft_prefix_cache=jax_spec.draft_prefix_from_target(
                      jprefix, 1))
        tkw = dict(prefix_cache=tprefix,
                   draft_prefix_cache=speculative.draft_prefix_from_target(
                       tprefix, 1))
    want = np.asarray(jax_speculative(
        jp, jcfg, ids, STEPS, lengths=jnp.asarray(lengths),
        quantized_cache=quantized, **kw))
    _, margins = greedy_margins(family, jcfg, jp, ids, lengths, STEPS,
                                quantized, jprefix)
    got = port_speculative(tp, tcfg, ids, STEPS,
                           lengths=torch.from_numpy(lengths),
                           quantized_cache=quantized, **tkw)
    assert_tokens_upto_ties(got.numpy(), want, margins, MARGIN)
    plain = family_of(tcfg).generate(
        tp, torch.from_numpy(ids), STEPS, tcfg, None,
        lengths=torch.from_numpy(lengths), quantized_cache=quantized,
        prefix_cache=tprefix)
    assert_tokens_upto_ties(got.numpy(), plain.numpy(), margins, MARGIN)


def test_self_draft_shares_the_targets_tensors():
    _, _, tcfg, tp = weights("llama", int8=True)
    dp, dcfg = speculative.self_draft(tp, tcfg, 1)
    assert dcfg.n_layers == 1 and tcfg.n_layers == 2
    assert dp["layers"][0] is tp["layers"][0]
    assert dp["embed"] is tp["embed"]
    assert dp["final_norm"] is tp["final_norm"]
    prefix = {"layers": [object(), object()], "length": torch.tensor([3])}
    sliced = speculative.draft_prefix_from_target(prefix, 1)
    assert sliced["layers"] == prefix["layers"][:1]
    assert sliced["length"] is prefix["length"]


@pytest.mark.parametrize("k", [1, 3, 5])
def test_independent_draft_equals_greedy(k):
    """Any draft model leaves the greedy output unchanged: a 1-layer GPT
    of another seed drafts for the 2-layer target."""
    _, _, tcfg, tp = weights("gpt")
    dcfg = ModelConfig(vocab_size=tcfg.vocab_size, d_model=32, n_heads=2,
                       n_layers=1, d_ff=64, max_seq_len=tcfg.max_seq_len,
                       dtype=torch.float32)
    dp = init_params(dcfg, torch.Generator().manual_seed(9), "cpu")
    ids = torch.from_numpy(tokens("gpt", 3, 16, seed=8))
    lengths = torch.from_numpy(LENGTHS)
    want = decode.generate(tp, ids, 12, tcfg, lengths=lengths)
    got = speculative.speculative_generate(
        tp, tcfg, dp, dcfg, ids, 12, draft_tokens=k, lengths=lengths)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_untied_readout_llama():
    """A llama with its own ``lm_head``: the self-draft and the verify
    chunk read it, not the tied embedding."""
    jcfg, jp, tcfg, tp = llama_both(lm_head=True)
    assert "lm_head" in tp
    ids = tokens("llama", 2, 8, seed=9)
    lengths = np.array([8, 8], np.int32)
    greedy, margins = greedy_margins("llama", jcfg, jp, ids, lengths, 12)
    want = np.asarray(jax_speculative(jp, jcfg, ids, 12))
    got = port_speculative(tp, tcfg, ids, 12)
    assert_tokens_upto_ties(got.numpy(), want, margins, MARGIN)
    assert_tokens_upto_ties(got.numpy(), greedy, margins, MARGIN)


def test_windowed_llama_runs_the_full_cache_with_the_window():
    jcfg, jp, tcfg, tp = weights("llama", window=6)
    ids = tokens("llama", 3, 16, seed=10)
    want = np.asarray(jax_speculative(jp, jcfg, ids, STEPS,
                                      lengths=jnp.asarray(LENGTHS)))
    _, margins = greedy_margins("llama", jcfg, jp, ids, LENGTHS, STEPS)
    got = port_speculative(tp, tcfg, ids, STEPS,
                           lengths=torch.from_numpy(LENGTHS))
    assert_tokens_upto_ties(got.numpy(), want, margins, MARGIN)


def test_tight_budget_with_uneven_acceptance():
    """Rows that finish early freeze: with a 16-token vocabulary (uneven
    acceptance across rows) and max_seq_len exactly the validated budget,
    every row still equals greedy decoding and the reference's."""
    vocab, num, k, prompt_len = 16, 20, 4, 4
    tight = prompt_len + num + 2 * k
    dims = dict(vocab_size=vocab, d_model=32, n_heads=2, n_layers=2,
                d_ff=64, max_seq_len=tight)
    jcfg = jax_model.ModelConfig(**dims)
    tcfg = ModelConfig(**dims)
    npp = jax.tree.map(np.asarray, jax_model.init_params(
        jax.random.key(21), jcfg))
    jp, tp = jax.tree.map(jnp.asarray, npp), params_from_jax(npp, tcfg, "cpu")
    ids = np.random.default_rng(23).integers(0, vocab, (4, prompt_len))
    ids = ids.astype(np.int32)
    dp, dcfg = jax_self_draft(jp, jcfg)
    want = np.asarray(jax_spec.speculative_generate_jit(
        jp, jcfg, dp, dcfg, jnp.asarray(ids), num, k))
    tdp, tdcfg = speculative.self_draft(tp, tcfg, 1)
    got, stats = speculative.speculative_generate(
        tp, tcfg, tdp, tdcfg, torch.from_numpy(ids), num, draft_tokens=k,
        return_stats=True)
    plain = decode.generate(tp, torch.from_numpy(ids), num, tcfg)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    np.testing.assert_array_equal(got.numpy(), want)
    # acceptance was uneven: the rows took different numbers of rounds
    assert len(set(stats["rounds"].tolist())) > 1
    with pytest.raises(ValueError, match="max_seq_len"):
        speculative.speculative_generate(
            tp, tcfg, tdp, tdcfg, torch.from_numpy(ids), num + 1,
            draft_tokens=k)


def test_rejection_rule_marginal_is_the_warped_target_distribution():
    """Over 10^5 rows the emitted position's distribution is the warped
    target softmax, whatever the draft: ``min(p, q) + (1 - sum min) *
    (q - p)+ / Z == q``, measured (the reference test's bound)."""
    rows, k, vocab = 100_000, 1, 5
    draft_logits = torch.tensor([0.1, 1.0, -0.4, 0.7, 0.2])
    target_logits = torch.tensor([0.9, -0.2, 0.5, 0.0, -1.0])
    draft_w = speculative._warp(draft_logits, 0.8, 0, 1.0).expand(
        rows, k, vocab)
    target_w = speculative._warp(target_logits, 0.8, 0, 1.0).expand(
        rows, k + 1, vocab)
    generator = torch.Generator().manual_seed(0)
    drafts = speculative._sample(draft_w[:, 0], generator)[:, None]
    n, fixup = speculative._accept_and_fixup(generator, drafts, draft_w,
                                             target_w)
    emitted = torch.where(n >= 1, drafts[:, 0], fixup)
    empirical = np.bincount(emitted.numpy(), minlength=vocab) / rows
    expected = np.asarray(jax.nn.softmax(jax_spec._warp(
        jnp.asarray(target_logits.numpy()), 0.8, 0, 1.0)))
    np.testing.assert_allclose(empirical, expected, atol=0.012)
    # a draft equal to the target is always accepted
    n_same, _ = speculative._accept_and_fixup(
        generator, drafts, target_w[:, :k], target_w)
    assert bool((n_same == 1).all())


def test_sampled_speculative_is_reproducible_and_in_vocab():
    _, _, tcfg, tp = weights("gpt")
    ids = tokens("gpt", 3, 16, seed=11)

    def run(seed):
        return port_speculative(
            tp, tcfg, ids, 12, temperature=0.9, top_k=8,
            generator=torch.Generator().manual_seed(seed))

    a, b, c = run(7), run(7), run(8)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert a.shape == (3, 12)
    assert 0 <= int(a.min()) and int(a.max()) < tcfg.vocab_size
    assert not np.array_equal(a.numpy(), c.numpy())
    with pytest.raises(ValueError, match="generator"):
        port_speculative(tp, tcfg, ids, 4, temperature=0.5)


def refusal(fn):
    with pytest.raises(ValueError) as err:
        fn()
    return str(err.value)


def test_refusals_match_reference():
    jcfg, jp, tcfg, tp = weights("gpt")
    ids = tokens("gpt", 3, 16, seed=12)
    jd, jdcfg = jax_self_draft(jp, jcfg)
    td, tdcfg = speculative.self_draft(tp, tcfg, 1)
    narrow = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=1, d_ff=64,
                  max_seq_len=96)
    cases = [
        (dict(config_draft=jax_model.ModelConfig(**narrow)),
         dict(config_draft=ModelConfig(**narrow))),
        (dict(draft_tokens=0), dict(draft_tokens=0)),
        (dict(num_tokens=0), dict(num_tokens=0)),
        (dict(num_tokens=96), dict(num_tokens=96)),
        (dict(num_tokens=75), dict(num_tokens=75)),
        (dict(prefix_cache={}), dict(prefix_cache={})),
    ]
    for jkw, tkw in cases:
        jargs = {**dict(params_target=jp, config_target=jcfg,
                        params_draft=jd, config_draft=jdcfg,
                        prompt=jnp.asarray(ids), num_tokens=4,
                        draft_tokens=4), **jkw}
        targs = {**dict(params_target=tp, config_target=tcfg,
                        params_draft=td, config_draft=tdcfg,
                        prompt=torch.from_numpy(ids), num_tokens=4,
                        draft_tokens=4), **tkw}
        want = refusal(lambda: jax_spec.speculative_generate(**jargs))
        assert refusal(lambda: speculative.speculative_generate(**targs)) \
            == want
