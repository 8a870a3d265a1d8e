"""The port's beam search held against the JAX package's.

Both families' 2-layer test models, weights from the reference's init
through ``convert.params_from_jax``.  Beam sequences equal the
reference's, beams in the same order: in f32 and bf16, ragged prompts,
``eos_id`` with a length penalty, the int8 cache and the shared prefix.
Scores agree to 1e-4 in f32.  In bf16 they agree to 1e-2: the port rounds
where the compiled reference does, but its fp32 sums run in another order,
and now and then that moves a bf16 activation to the neighbouring value,
which moves a log-probability by up to about 1e-2 (a few percent of
random decode rows, for both families).  Ties resolve as
``jax.lax.top_k`` and the stable ``jnp.argsort`` do, to the lowest index,
which crafted ties pin.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kube_sqs_autoscaler_tpu.workloads import beam as jax_beam
from kube_sqs_autoscaler_tpu_torch.workloads import beam, flash
from kube_sqs_autoscaler_tpu_torch.workloads.family import family_of

from .test_torch_prefix import both_prefixes
from .test_torch_quantize import tokens, weights

torch.set_num_threads(1)

LENGTHS = np.array([16, 9, 12], np.int32)  # ragged right-padded prompts
STEPS = 8
WIDTH = 3


def both_searches(family, dtype="float32", ids=None, lengths=LENGTHS,
                  steps=STEPS, prefix=False, **kw):
    """The reference's and the port's ``return_all`` beam search of the
    same prompts: ``((seqs, scores), (seqs, scores))`` as numpy."""
    jcfg, jp, tcfg, tp = weights(family, dtype)
    if ids is None:
        ids = tokens(family, 3, 16, seed=30)
    jkw, tkw = dict(kw), dict(kw)
    if prefix:
        jkw["prefix_cache"], tkw["prefix_cache"] = both_prefixes(
            family, kw.get("quantized_cache", False))
    want = jax_beam.beam_search_jit(
        jp, jcfg, jnp.asarray(ids), steps, WIDTH,
        lengths=jnp.asarray(lengths), return_all=True, **jkw)
    got = beam.beam_search(
        tp, tcfg, torch.from_numpy(ids), steps, beams=WIDTH,
        lengths=torch.from_numpy(lengths), return_all=True, **tkw)
    return ((np.asarray(want[0]), np.asarray(want[1])),
            (got[0].numpy(), got[1].numpy()))


def assert_same_beams(want, got, dtype="float32"):
    np.testing.assert_array_equal(got[0], want[0])
    atol = 1e-4 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=atol)


CASES = [(f, d) for f in ("gpt", "llama") for d in ("float32", "bfloat16")]


@pytest.mark.parametrize("family,dtype", CASES,
                         ids=[f"{f}-{d}" for f, d in CASES])
def test_beam_search_matches_reference(family, dtype):
    want, got = both_searches(family, dtype)
    assert got[0].shape == (3, WIDTH, STEPS)
    assert (got[1][:, :-1] >= got[1][:, 1:]).all()  # best first
    assert_same_beams(want, got, dtype)
    # the beams differ from each other: the search is not degenerate
    assert len({tuple(b) for b in got[0][1]}) == WIDTH


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_eos_and_length_penalty_match_reference(family):
    _, _, tcfg, tp = weights(family)
    ids = tokens(family, 3, 16, seed=31)
    greedy = family_of(tcfg).generate(tp, torch.from_numpy(ids), STEPS,
                                      tcfg, None)
    eos = int(greedy[0, 2])  # an id the model emits
    want, got = both_searches(family, ids=ids, eos_id=eos,
                              length_penalty=0.6)
    assert_same_beams(want, got)
    assert (got[0] == eos).any()
    for row in got[0].reshape(-1, STEPS).tolist():
        if eos in row:
            assert all(x == eos for x in row[row.index(eos):])


@pytest.mark.parametrize("family,quantized,prefix", [
    ("gpt", True, False), ("llama", True, False),
    ("gpt", False, True), ("llama", True, True),
], ids=["gpt-int8", "llama-int8", "gpt-prefix", "llama-int8-prefix"])
def test_int8_and_prefix_beams_match_reference(family, quantized, prefix):
    ids = tokens(family, 3, 12, seed=32)
    want, got = both_searches(family, ids=ids,
                              lengths=np.array([12, 5, 9], np.int32),
                              quantized_cache=quantized, prefix=prefix)
    assert_same_beams(want, got)


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_single_beam_is_greedy_and_wider_beams_score_no_worse(family):
    _, _, tcfg, tp = weights(family)
    model = family_of(tcfg)
    ids = torch.from_numpy(tokens(family, 3, 16, seed=33))
    lengths = torch.from_numpy(LENGTHS)
    greedy = model.generate(tp, ids, STEPS, tcfg, None, lengths=lengths)
    one = beam.beam_search(tp, tcfg, ids, STEPS, beams=1, lengths=lengths)
    np.testing.assert_array_equal(one.numpy(), greedy.numpy())
    wide = beam.beam_search(tp, tcfg, ids, STEPS, beams=4, lengths=lengths)

    def logprob(continuation):
        """Teacher-forced joint log-probability, row by row."""
        total = []
        for b in range(3):
            n = int(lengths[b])
            full = torch.cat([ids[b, :n], continuation[b]])[None]
            logp = torch.log_softmax(model.forward(tp, full, tcfg, None), -1)
            total.append(sum(float(logp[0, n - 1 + t, full[0, n + t]])
                             for t in range(STEPS)))
        return np.asarray(total)

    assert (logprob(wide) >= logprob(greedy) - 1e-3).all()


def test_top_k_ties_resolve_like_jax_lax_top_k():
    rng = np.random.default_rng(34)
    # few distinct values over many positions: ties everywhere
    x = rng.integers(0, 4, (6, 40)).astype(np.float32)
    x[0] = 1.0  # a row of equal values
    x[1, [3, 17, 29]] = 9.0  # the top value three times
    x[2, :] = -np.inf
    x[2, [5, 6]] = 0.0
    for k in (1, 3, 7, 40):
        want_v, want_i = jax.lax.top_k(jnp.asarray(x), k)
        got_v, got_i = beam.top_k_lowest_first(torch.from_numpy(x), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_beam_expansion_and_ranking_ties_resolve_like_the_reference():
    """Crafted exact ties in the ``W * V`` expansion (every beam the same
    score and the same next-token distribution) and among the final
    scores: the parents, tokens and order are the reference's, lowest
    flat index first."""
    width, vocab = 3, 8
    logp = np.log(np.full((2, width, vocab), 1.0 / vocab, np.float32))
    logp[1, :, [2, 5]] = np.log(0.25)
    scores = np.zeros((2, width), np.float32)
    alive = np.ones((2, width), bool)
    alive[1, 1] = False
    for eos in (None, 5):
        total = scores[..., None] + logp
        if eos is not None:
            frozen = np.full_like(logp, -np.inf)
            frozen[..., eos] = 0.0
            total = np.where(alive[..., None], total, frozen)
        want_s, want_idx = jax.lax.top_k(
            jnp.asarray(total.reshape(2, -1)), width)
        got_s, parent, token = beam.expand_beams(
            torch.from_numpy(logp), torch.from_numpy(scores),
            torch.from_numpy(alive), eos)
        want_idx = np.asarray(want_idx)
        np.testing.assert_array_equal(parent.numpy(), want_idx // vocab)
        np.testing.assert_array_equal(token.numpy(), want_idx % vocab)
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    tied = np.array([[-1.0, -2.0, -1.0, -2.0], [-3.0, -3.0, -3.0, -3.0]],
                    np.float32)
    emitted = np.array([[4, 2, 4, 2], [1, 2, 1, 2]], np.int64)
    for penalty in (0.0, 0.6):
        ranked = jnp.asarray(tied)
        if penalty > 0:
            ranked = ranked / (((5.0 + jnp.asarray(emitted, jnp.float32))
                                / 6.0) ** penalty)
        order = np.asarray(jnp.argsort(-ranked, axis=1))
        got_ranked, got_order = beam.rank_beams(
            torch.from_numpy(tied), torch.from_numpy(emitted), penalty)
        np.testing.assert_array_equal(got_order.numpy(), order)
        np.testing.assert_allclose(
            got_ranked.numpy(), np.take_along_axis(np.asarray(ranked), order,
                                                   1), rtol=1e-6)


def test_row_gather_reuses_two_buffer_sets():
    _, _, tcfg, _ = weights("gpt")
    cache = family_of(tcfg).layout(False).init_cache(tcfg, 4, "cpu")
    cache["layers"][0]["k"][:, 0, 0, 0] = torch.arange(4.0)
    gather = beam.RowGather(cache)
    ptrs = {cache["layers"][0]["k"].data_ptr(),
            gather.spare["layers"][0]["k"].data_ptr()}
    out = cache
    for index in ([3, 3, 0, 1], [1, 0, 2, 2], [0, 1, 2, 3]):
        before = out["layers"][0]["k"][:, 0, 0, 0].clone()
        out = gather(out, torch.tensor(index))
        np.testing.assert_array_equal(out["layers"][0]["k"][:, 0, 0, 0],
                                      before[index])
        assert out["layers"][0]["k"].data_ptr() in ptrs


def refusal(fn):
    with pytest.raises(ValueError) as err:
        fn()
    return str(err.value)


def test_refusals_match_reference():
    jcfg, jp, tcfg, tp = weights("gpt")
    ids = tokens("gpt", 3, 16, seed=35)
    jprefix, tprefix = both_prefixes("gpt", False)
    qprefix = both_prefixes("gpt", True)
    cases = [
        dict(beams=0), dict(num_tokens=0), dict(num_tokens=96),
        dict(prefix=(jprefix, tprefix), attention_fn=True),
        dict(prefix=qprefix, quantized_cache=False),
    ]
    for case in cases:
        case = dict(case)
        prefix = case.pop("prefix", (None, None))
        attend = case.pop("attention_fn", None)
        num = case.pop("num_tokens", 4)
        want = refusal(lambda: jax_beam.beam_search(
            jp, jcfg, jnp.asarray(ids), num, prefix_cache=prefix[0],
            attention_fn=(lambda q, k, v: q) if attend else None, **case))
        got = refusal(lambda: beam.beam_search(
            tp, tcfg, torch.from_numpy(ids), num, prefix_cache=prefix[1],
            attention_fn=flash.flash_attention if attend else None, **case))
        assert got == want
