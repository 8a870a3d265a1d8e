"""Speculative and beam slots in the port's continuous batcher, the worker
and the binary, held against the port's standalone functions and the JAX
package's batcher.

Both families' 2-layer test models in f32, the self-draft of their first
layer.  Requests arrive while other slots decode (refills mid-stream);
each request's result equals :func:`speculative.speculative_generate` or
:func:`beam.beam_search` of its prompt alone, in the bf16 and the int8
cache and behind a shared prefix.  Against the reference's batcher on the
same traffic the results, the kept-token and TTFT counts and the dispatch
and transfer counters agree after every step.
"""

import numpy as np
import pytest
import torch

from kube_sqs_autoscaler_tpu.workloads import __main__ as jax_binary
from kube_sqs_autoscaler_tpu.workloads import continuous as jax_continuous
from kube_sqs_autoscaler_tpu_torch.metrics.fake import FakeMessageQueue
from kube_sqs_autoscaler_tpu_torch.workloads import (
    beam, continuous, speculative,
)
from kube_sqs_autoscaler_tpu_torch.workloads.__main__ import main as binary
from kube_sqs_autoscaler_tpu_torch.workloads.service import ServiceConfig
from kube_sqs_autoscaler_tpu_torch.workloads.shard_plane import (
    ShardedBatcher,
)

from .test_torch_prefix import both_prefixes
from .test_torch_quantize import tokens, weights

torch.set_num_threads(1)

PROMPT = 12
TOKENS = 6


def requests_of(family, n, seed):
    rng = np.random.default_rng(seed)
    return [tokens(family, 1, int(rng.integers(2, PROMPT + 1)),
                   seed=seed + i)[0] for i in range(n)]


def drain(batcher, requests, schedule=None):
    """Submit ``requests`` as slots free (two at a time, every other step,
    unless ``schedule`` says otherwise), stepping until all finished;
    returns ``{index: tokens}``."""
    waiting, got = list(enumerate(requests)), {}
    for step in range(400):
        free = len(batcher.free_slots)
        if waiting and free and (schedule or (lambda s: s % 2 == 0))(step):
            take = min(free, 2)
            batcher.submit_many([(ids, i) for i, ids in waiting[:take]])
            waiting = waiting[take:]
        got.update({i: np.asarray(t) for i, t in batcher.step()})
        if not waiting and batcher.active == 0:
            return got
    raise AssertionError("the batcher did not drain")


def alone(prompt, fn):
    """``fn(tokens [1, PROMPT], lengths [1])`` for one right-padded
    prompt."""
    ids = torch.zeros((1, PROMPT), dtype=torch.long)
    ids[0, :len(prompt)] = torch.from_numpy(prompt)
    return fn(ids, torch.tensor([len(prompt)]))[0].numpy()


LAYOUTS = [("gpt", False, False), ("llama", False, False),
           ("gpt", True, True), ("llama", True, False)]
LAYOUT_IDS = ["gpt", "llama", "gpt-int8-prefix", "llama-int8"]


def layout_kw(family, quantized, prefixed):
    """(batcher keywords, standalone keywords) of a cache layout."""
    prefix = both_prefixes(family, quantized)[1] if prefixed else None
    return (dict(quantized_kv=quantized, prefix_cache=prefix),
            dict(quantized_cache=quantized, prefix_cache=prefix))


@pytest.mark.parametrize("family,quantized,prefixed", LAYOUTS,
                         ids=LAYOUT_IDS)
def test_speculative_slots_equal_standalone_speculative(family, quantized,
                                                        prefixed):
    _, _, tcfg, tp = weights(family)
    requests = requests_of(family, 5, seed=80)
    batcher_kw, kw = layout_kw(family, quantized, prefixed)
    batcher = continuous.ContinuousBatcher(
        tp, tcfg, batch_size=2, prompt_len=PROMPT, generate_tokens=TOKENS,
        draft_layers=1, draft_tokens=3, device="cpu", **batcher_kw)
    got = drain(batcher, requests)
    dp, dcfg = speculative.self_draft(tp, tcfg, 1)
    if prefixed:
        kw["draft_prefix_cache"] = speculative.draft_prefix_from_target(
            kw["prefix_cache"], 1)
    for i, prompt in enumerate(requests):
        want = alone(prompt, lambda ids, n: speculative.speculative_generate(
            tp, tcfg, dp, dcfg, ids, TOKENS, draft_tokens=3, lengths=n,
            **kw))
        np.testing.assert_array_equal(got[i], want, err_msg=f"request {i}")
    assert batcher.spec_rounds > 0
    assert 0 < batcher.spec_accepted <= 3 * batcher.spec_rounds
    assert batcher.tokens_emitted == len(requests) * TOKENS


@pytest.mark.parametrize("family,quantized,prefixed", LAYOUTS,
                         ids=LAYOUT_IDS)
def test_beam_slots_equal_standalone_beam_search(family, quantized,
                                                 prefixed):
    _, _, tcfg, tp = weights(family)
    requests = requests_of(family, 5, seed=81)
    batcher_kw, kw = layout_kw(family, quantized, prefixed)
    plain = alone(requests[0], lambda ids, n: beam.beam_search(
        tp, tcfg, ids, TOKENS, beams=3, lengths=n, **kw))
    eos = int(plain[2])  # an id the model emits
    for extra in ({}, dict(eos_id=eos, length_penalty=0.8)):
        batcher = continuous.ContinuousBatcher(
            tp, tcfg, batch_size=2, prompt_len=PROMPT,
            generate_tokens=TOKENS, beams=3, device="cpu", **batcher_kw,
            **extra)
        got = drain(batcher, requests)
        for i, prompt in enumerate(requests):
            want = alone(prompt, lambda ids, n: beam.beam_search(
                tp, tcfg, ids, TOKENS, beams=3, lengths=n, **kw, **extra))
            np.testing.assert_array_equal(got[i], want,
                                          err_msg=f"request {i} {extra}")


@pytest.mark.parametrize("mode", ["speculative", "beams"])
def test_slots_match_the_reference_batcher_after_every_step(mode):
    """The same traffic through the port's and the reference's batchers
    (GPT, f32, eos set): equal results, kept tokens, TTFT counts and
    dispatch and transfer counters after every step."""
    jcfg, jp, tcfg, tp = weights("gpt")
    requests = requests_of("gpt", 6, seed=82)
    eos = int(alone(requests[1], lambda ids, n: beam.beam_search(
        tp, tcfg, ids, TOKENS, beams=1, lengths=n))[2])
    knobs = dict(batch_size=2, prompt_len=PROMPT, generate_tokens=TOKENS,
                 eos_id=eos)
    knobs.update(dict(draft_layers=1, draft_tokens=2) if mode ==
                 "speculative" else dict(beams=3, length_penalty=0.6))
    port = continuous.ContinuousBatcher(tp, tcfg, device="cpu", **knobs)
    reference = jax_continuous.ContinuousBatcher(jp, jcfg, **knobs)
    names = ("insert_dispatches", "decode_dispatches", "host_transfers",
             "tokens_emitted", "ttft_count", "spec_rounds", "spec_accepted")
    waiting, finished = list(enumerate(requests)), 0
    for step in range(200):
        free = len(port.free_slots)
        assert free == len(reference.free_slots)
        if waiting and free and step % 2 == 0:
            take = min(free, 2)
            for batcher in (port, reference):
                batcher.submit_many([(ids, i) for i, ids in waiting[:take]])
            waiting = waiting[take:]
        done = {i: np.asarray(t).tolist() for i, t in port.step()}
        assert done == {i: np.asarray(t).tolist()
                        for i, t in reference.step()}, f"step {step}"
        finished += len(done)
        assert ([getattr(port, n) for n in names]
                == [getattr(reference, n) for n in names]), f"step {step}"
        if not waiting and port.active == 0:
            break
    assert finished == len(requests) and port.ttft_count == len(requests)
    # some request ended at its eos: fewer kept tokens than the budgets
    assert port.tokens_emitted < len(requests) * TOKENS


def test_speculative_second_rounds_overlap_and_toggle():
    """Deep budgets make a row's next round certain before the first is
    read: the second round is dispatched ahead, with the same results as
    with the overlap off (``set_speculative``) and as the standalone."""
    _, _, tcfg, tp = weights("llama")
    requests = requests_of("llama", 4, seed=83)
    results = []
    for overlap in (True, False):
        batcher = continuous.ContinuousBatcher(
            tp, tcfg, batch_size=2, prompt_len=PROMPT, generate_tokens=12,
            draft_layers=1, draft_tokens=2, device="cpu")
        batcher.set_speculative(overlap)
        results.append(drain(batcher, requests))
        assert (batcher.spec_second_rounds > 0) == overlap
        # on the CPU every copy lands at once: nothing still runs
        assert batcher.spec_overlapped == 0
    assert {i: r.tolist() for i, r in results[0].items()} == \
        {i: r.tolist() for i, r in results[1].items()}
    dp, dcfg = speculative.self_draft(tp, tcfg, 1)
    for i, prompt in enumerate(requests):
        want = alone(prompt, lambda ids, n: speculative.speculative_generate(
            tp, tcfg, dp, dcfg, ids, 12, draft_tokens=2, lengths=n))
        np.testing.assert_array_equal(results[0][i], want)


def test_sampled_speculative_slots_terminate_in_vocab():
    _, _, tcfg, tp = weights("gpt")
    requests = requests_of("gpt", 5, seed=84)
    batcher = continuous.ContinuousBatcher(
        tp, tcfg, batch_size=2, prompt_len=PROMPT, generate_tokens=TOKENS,
        draft_layers=1, draft_tokens=3, temperature=0.8, top_k=20,
        sample_seed=3, device="cpu")
    got = drain(batcher, requests)
    assert sorted(got) == list(range(5))
    for tokens_ in got.values():
        assert tokens_.shape == (TOKENS,)
        assert 0 <= tokens_.min() and tokens_.max() < tcfg.vocab_size


REFUSALS = [
    dict(draft_layers=2), dict(draft_layers=-1),
    dict(draft_layers=1, draft_tokens=0),
    dict(draft_layers=1, draft_tokens=40),
    dict(draft_layers=1, decode_block=2), dict(beams=2, decode_block=2),
    dict(beams=2, draft_layers=1), dict(beams=2, temperature=0.5),
    dict(beams=0),
]


@pytest.mark.parametrize("knobs", REFUSALS,
                         ids=lambda k: "-".join(f"{n}{v}"
                                                for n, v in k.items()))
def test_batcher_refusals_match_reference(knobs):
    jcfg, jp, tcfg, tp = weights("gpt")
    base = dict(batch_size=2, prompt_len=PROMPT, generate_tokens=TOKENS)
    with pytest.raises(ValueError) as want:
        jax_continuous.ContinuousBatcher(jp, jcfg, **base, **knobs)
    with pytest.raises(ValueError) as got:
        continuous.ContinuousBatcher(tp, tcfg, device="cpu", **base,
                                     **knobs)
    assert str(got.value) == str(want.value)


def test_spec_and_beam_engines_keep_to_the_plain_paths_seams():
    _, _, tcfg, tp = weights("gpt")
    base = dict(batch_size=2, prompt_len=PROMPT, generate_tokens=TOKENS,
                device="cpu")
    plain = continuous.ContinuousBatcher(tp, tcfg, **base)
    spec = continuous.ContinuousBatcher(tp, tcfg, draft_layers=1, **base)
    beams = continuous.ContinuousBatcher(tp, tcfg, beams=2, **base)
    assert len({b._engine_key() for b in (plain, spec, beams)}) == 3
    for engine in (spec, beams):
        with pytest.raises(ValueError, match="plain decode path only"):
            continuous.ContinuousBatcher(tp, tcfg, **base).adopt_engine(
                engine)
        with pytest.raises(ValueError, match="plain decode path only"):
            engine.submit_resume([])
    with pytest.raises(ValueError, match="draft_layers > 0"):
        plain.set_speculative(False)
    assert beams.cache["layers"][0]["k"].shape[0] == 4
    assert spec.draft_cache["layers"][0]["k"].shape[0] == 2
    assert len(spec.draft_cache["layers"]) == 1
    for knobs in (dict(draft_layers=1), dict(beams=2)):
        with pytest.raises(ValueError, match="plain continuous decode"):
            ShardedBatcher(tp, tcfg, shards=2, shard_slots=2,
                           prompt_len=PROMPT, generate_tokens=TOKENS,
                           device="cpu", **knobs)
    service = ServiceConfig(queue_url="q", batch_size=2, seq_len=PROMPT,
                            generate_tokens=TOKENS, shards=2)
    # speculative shards run on the decode plane
    worker = continuous.ContinuousWorker(FakeMessageQueue(), tp, tcfg,
                                         service, draft_layers=1,
                                         device="cpu")
    assert type(worker.batcher).__name__ == "DecodePlaneBatcher"
    assert worker.batcher.shards == 2 and worker.batcher.spec_layers == 1


BINARY = ["--device", "cpu", "--demo", "4", "--seq-len", "16",
          "--generate-tokens", "5", "--batch-size", "2",
          "--result-queue-url", "demo://replies"]


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_binary_serves_both_modes_in_batch_and_continuous(family):
    """Each mode through the batch worker's ``generate_fn`` and the
    continuous worker: every message answered, and the bf16 replies of
    the two workers identical; the int8 cache and the prefix compose."""
    for mode in (["--speculative-draft-layers", "2",
                  "--speculative-draft-tokens", "3"],
                 ["--beams", "3", "--length-penalty", "0.6"]):
        replies = []
        for extra in ([], ["--continuous"],
                      ["--continuous", "--quantize-kv", "--prefix-ids",
                       "3,1,4"]):
            summary = binary([*BINARY, "--family", family, *mode, *extra])
            assert summary["processed"] == 4
            assert len(summary["replies"]) == 4
            replies.append(summary["replies"])
        assert replies[0] == replies[1], mode
    # the speculative budget widens the built-in context by 2k
    summary = binary([*BINARY, "--speculative-draft-layers", "1",
                      "--speculative-draft-tokens", "24", "--continuous"])
    assert summary["spec_rounds"] > 0


@pytest.mark.parametrize("args,message", [
    (["--beams", "0"], "--beams 0 must be >= 1"),
    (["--beams", "2", "--temperature", "0.5"], "deterministic"),
    (["--beams", "2", "--speculative-draft-layers", "1"],
     "--beams does not support --speculative-draft-layers"),
    (["--beams", "2", "--generate-tokens", "0"],
     "--generate-tokens >= 1 required"),
    (["--length-penalty", "0.6"], "--length-penalty requires --beams > 1"),
    (["--beams", "2", "--length-penalty", "-1"], ">= 0"),
    (["--beams", "2", "--continuous", "--decode-block", "2"],
     "--decode-block applies to the plain continuous decode path"),
    (["--speculative-draft-layers", "1", "--continuous", "--decode-block",
      "2"], "--decode-block applies to the plain continuous decode path"),
    (["--beams", "2", "--continuous", "--shards", "2"],
     r"--shards applies to the plain continuous decode path \(not --beams"),
    (["--beams", "2", "--continuous", "--fleet-max-replicas", "2"],
     "--fleet-max-replicas applies to the plain continuous"),
    (["--speculative-draft-layers", "1", "--continuous",
      "--fleet-max-replicas", "2"],
     "--fleet-max-replicas applies to the plain continuous"),
], ids=["beams-0", "beams-temperature", "beams-spec", "beams-no-generate",
        "penalty-alone", "penalty-negative", "beams-block",
        "spec-block", "beams-shards", "beams-fleet", "spec-fleet"])
def test_binary_flag_checks_fail_as_the_reference(args, message):
    argv = ["--demo", "4", "--generate-tokens", "4", *args]
    for main, extra in ((jax_binary.main, []), (binary, ["--device", "cpu"])):
        with pytest.raises(SystemExit, match=message):
            main([*argv, *extra])


@pytest.mark.parametrize("args,message", [
    (["--speculative-draft-layers", "99"], "n_layers"),
    (["--speculative-draft-layers", "-1"], "n_layers"),
    (["--speculative-draft-layers", "1", "--speculative-draft-tokens", "0"],
     "--speculative-draft-tokens 0 must be >= 1"),
    (["--speculative-draft-layers", "1", "--generate-tokens", "0"],
     "--speculative-draft-layers requires --generate-tokens >= 1"),
    (["--speculative-draft-layers", "1", "--continuous", "--shards", "2",
      "--model-parallel", "2"], "single-chip decode plane"),
], ids=["too-deep", "negative", "no-proposals", "no-generate", "shards"])
def test_binary_speculative_start_up_checks(args, message):
    with pytest.raises(SystemExit, match=message):
        binary(["--device", "cpu", "--demo", "4", "--generate-tokens", "4",
                *args])
