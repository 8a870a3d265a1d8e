"""The port's shared prefix cache held against the JAX package's.

A prefix of 7 tokens is prefilled once (``prefill_prefix`` and its int8
and llama twins) and per-request suffixes continue from it through the
chunk decoder (``prefill_with_prefix``), on the CPU with the reference's
weights, for both families and both cache layouts.  f32 logits agree to
1e-5 of ``max(1, max|ref|)``; generated tokens equal the reference's (and,
in f32, the reference's ``generate`` over prefix and suffix concatenated)
up to the first near-tie.  The continuous batcher and a 2-shard plane run
slots that start past the prefix against the reference's, and the batch
worker, the fleet pools and the binary serve it (``--prefix-ids``,
``--quantize int8``, ``--quantize-kv``), each flag's argument checks
failing as the reference binary's do.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kube_sqs_autoscaler_tpu.metrics.fake import FakeMessageQueue as JaxQueue
from kube_sqs_autoscaler_tpu.workloads import __main__ as jax_binary
from kube_sqs_autoscaler_tpu.workloads import continuous as jax_continuous
from kube_sqs_autoscaler_tpu.workloads import decode as jax_decode
from kube_sqs_autoscaler_tpu.workloads import llama as jax_llama
from kube_sqs_autoscaler_tpu.workloads import service as jax_service
from kube_sqs_autoscaler_tpu.workloads import shard_plane as jax_plane
from kube_sqs_autoscaler_tpu_torch.core import FakeClock
from kube_sqs_autoscaler_tpu_torch.fleet import (
    FleetDriver, ShardedWorkerPool, WorkerPool,
)
from kube_sqs_autoscaler_tpu_torch.metrics.fake import FakeMessageQueue
from kube_sqs_autoscaler_tpu_torch.workloads import (
    continuous, decode, llama, service, shard_plane,
)
from kube_sqs_autoscaler_tpu_torch.workloads.__main__ import main as binary
from kube_sqs_autoscaler_tpu_torch.workloads.family import family_of

from .test_torch_quantize import (
    BF16_GUARD, MARGIN, assert_close, assert_tokens_upto_ties, ref,
    reference_rollout, tokens, weights,
)
from .test_torch_shard_plane import step_both

LENGTHS = np.array([12, 5, 9], np.int32)
PREFIX = 7
LAYOUTS = [("gpt", False), ("gpt", True), ("llama", False), ("llama", True)]
LAYOUT_IDS = ["gpt", "gpt-int8", "llama", "llama-int8"]
URL, REPLIES = "fake://jobs", "fake://replies"


def prefix_ids(family: str) -> np.ndarray:
    return tokens(family, 1, PREFIX, seed=60)[0]


def name(kind: str, quantized: bool) -> str:
    return f"quantized_{kind}" if quantized else kind


def both_prefixes(family, quantized, dtype="float32", window=None):
    """The reference's and the port's prefix caches of :func:`prefix_ids`."""
    jcfg, jp, tcfg, tp = weights(family, dtype, window)
    ids = prefix_ids(family)
    want = ref(family, name("prefill_prefix", quantized))(
        jp, jnp.asarray(ids), config=jcfg)
    got = family_of(tcfg).layout(quantized).prefill_prefix(
        tp, torch.from_numpy(ids), tcfg, None)
    return want, got


@pytest.mark.parametrize("family,quantized", LAYOUTS, ids=LAYOUT_IDS)
def test_prefix_prefill_and_suffix_continuation_match_reference(
        family, quantized):
    jcfg, jp, tcfg, tp = weights(family)
    jprefix, tprefix = both_prefixes(family, quantized)
    assert int(tprefix["length"][0]) == PREFIX
    assert tprefix["layers"][0].keys() == jprefix["layers"][0].keys()
    for g, w in zip(tprefix["layers"], jprefix["layers"]):
        for leaf in g:
            if leaf.endswith("codes"):  # one step at a rounding boundary
                diff = (g[leaf].float().numpy()
                        - np.asarray(w[leaf], np.float32))
                assert np.abs(diff).max() <= 1 and (diff != 0).mean() < 1e-3
            else:
                assert_close(g[leaf], w[leaf])
    ids = tokens(family, 3, 12, seed=61)
    want, jcache = ref(family, name("prefill_with_prefix", quantized))(
        jp, jprefix, jnp.asarray(ids), config=jcfg,
        lengths=jnp.asarray(LENGTHS))
    layout = family_of(tcfg).layout(quantized)
    got, tcache = layout.prefill_with_prefix(
        tp, tprefix, torch.from_numpy(ids), tcfg,
        lengths=torch.from_numpy(LENGTHS))
    assert_close(got, want)
    np.testing.assert_array_equal(tcache["length"].numpy(),
                                  PREFIX + LENGTHS)
    # the shared prefix itself is never written
    again = layout.prefill_prefix(tp, torch.from_numpy(prefix_ids(family)),
                                  tcfg, None)
    for g, w in zip(tprefix["layers"], again["layers"]):
        assert all(torch.equal(g[leaf], w[leaf]) for leaf in g)


@pytest.mark.parametrize("family,quantized", LAYOUTS, ids=LAYOUT_IDS)
def test_prefix_generate_matches_reference_and_the_concatenated_prompt(
        family, quantized):
    jcfg, jp, tcfg, tp = weights(family)
    jprefix, tprefix = both_prefixes(family, quantized)
    ids = tokens(family, 3, 12, seed=62)
    steps = 6
    want = np.asarray(ref(family, "generate")(
        jp, jnp.asarray(ids), num_tokens=steps, config=jcfg,
        lengths=jnp.asarray(LENGTHS), quantized_cache=quantized,
        prefix_cache=jprefix))
    _, margins = reference_rollout(
        lambda: ref(family, name("prefill_with_prefix", quantized))(
            jp, jprefix, jnp.asarray(ids), config=jcfg,
            lengths=jnp.asarray(LENGTHS)),
        lambda cache, token: ref(family, name("decode_step", quantized))(
            jp, cache, token, config=jcfg),
        steps)
    got = family_of(tcfg).generate(
        tp, torch.from_numpy(ids), steps, tcfg, None,
        lengths=torch.from_numpy(LENGTHS), quantized_cache=quantized,
        prefix_cache=tprefix)
    assert_tokens_upto_ties(got.numpy(), want, margins, MARGIN)
    if quantized:
        # the int8 route attends quantized prefix keys where a prefill of
        # the joined prompt attends them in full precision: equal only up
        # to int8 rounding, so it is compared with itself above
        return
    # the same generations as prefix + suffix prefilled together
    joined = np.concatenate(
        [np.repeat(prefix_ids(family)[None], 3, 0), ids], axis=1)
    whole = np.asarray(ref(family, "generate")(
        jp, jnp.asarray(joined), num_tokens=steps, config=jcfg,
        lengths=jnp.asarray(PREFIX + LENGTHS), quantized_cache=quantized))
    assert_tokens_upto_ties(got.numpy(), whole, margins, MARGIN)


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_prefix_generate_bf16_greedy_tokens_match_reference(family):
    jcfg, jp, tcfg, tp = weights(family, "bfloat16")
    jprefix, tprefix = both_prefixes(family, True, "bfloat16")
    ids = tokens(family, 3, 12, seed=63)
    steps = 6
    want = np.asarray(ref(family, "generate")(
        jp, jnp.asarray(ids), num_tokens=steps, config=jcfg,
        lengths=jnp.asarray(LENGTHS), quantized_cache=True,
        prefix_cache=jprefix))
    _, margins = reference_rollout(
        lambda: ref(family, "quantized_prefill_with_prefix")(
            jp, jprefix, jnp.asarray(ids), config=jcfg,
            lengths=jnp.asarray(LENGTHS)),
        lambda cache, token: ref(family, "quantized_decode_step")(
            jp, cache, token, config=jcfg),
        steps)
    got = family_of(tcfg).generate(
        tp, torch.from_numpy(ids), steps, tcfg, None,
        lengths=torch.from_numpy(LENGTHS), quantized_cache=True,
        prefix_cache=tprefix)
    assert_tokens_upto_ties(got.numpy(), want, margins, BF16_GUARD[family])


@pytest.mark.parametrize("case,match", [
    ("layout", "layout mismatch"),
    ("attention", "does not apply with prefix_cache"),
    ("budget", "exceeds max_seq_len"),
    ("rolling", "rolling-buffer cache"),
])
def test_prefix_refusals_match_reference(case, match):
    family = "gpt" if case in ("layout", "attention") else "llama"
    jcfg, jp, tcfg, tp = weights(family, window=6 if case == "rolling"
                                 else None)
    jprefix, tprefix = both_prefixes(family, False,
                                     window=6 if case == "rolling" else None)
    ids = tokens(family, 2, 12, seed=64)
    kw = {"layout": dict(quantized_cache=True),
          "attention": dict(attention_fn=decode._dense_attention),
          "budget": dict(num_tokens=tcfg.max_seq_len),
          "rolling": dict(rolling=True)}[case]
    steps = kw.pop("num_tokens", 2)
    port_fn = decode.generate if family == "gpt" else llama.llama_generate
    jax_fn = (jax_decode.generate if family == "gpt"
              else jax_llama.llama_generate)
    with pytest.raises(ValueError, match=match):
        jax_fn(jp, jnp.asarray(ids), steps, jcfg, prefix_cache=jprefix, **kw)
    with pytest.raises(ValueError, match=match):
        port_fn(tp, torch.from_numpy(ids), steps, tcfg,
                prefix_cache=tprefix, **kw)


# ---------------------------------------------------------------------------
# Slots that start past the prefix
# ---------------------------------------------------------------------------


def counters(batcher) -> tuple[int, int, int]:
    return (batcher.insert_dispatches, batcher.decode_dispatches,
            batcher.host_transfers)


def suffixes(family, n, seed):
    rng = np.random.default_rng(seed)
    return [tokens(family, 1, int(rng.integers(2, 13)), seed=seed + i)[0]
            for i in range(n)]


def reference_greedy(family, quantized, requests, steps=5):
    """The reference's greedy tokens for each suffix alone behind the
    prefix (rows of one right-padded batch), its margins checked."""
    jcfg, jp, _, _ = weights(family)
    jprefix, _ = both_prefixes(family, quantized)
    ids = np.zeros((len(requests), 12), np.int32)
    for row, prompt in enumerate(requests):
        ids[row, :len(prompt)] = prompt
    lengths = jnp.asarray([len(p) for p in requests], jnp.int32)
    want, margins = reference_rollout(
        lambda: ref(family, name("prefill_with_prefix", quantized))(
            jp, jprefix, jnp.asarray(ids), config=jcfg, lengths=lengths),
        lambda cache, token: ref(family, name("decode_step", quantized))(
            jp, cache, token, config=jcfg),
        steps)
    assert margins.min() > MARGIN
    return want


@pytest.mark.parametrize("family,quantized,decode_block", [
    ("gpt", True, 3), ("llama", False, 1),
], ids=["gpt-int8-b3", "llama-b1"])
def test_prefix_batcher_matches_the_reference_batcher(
        family, quantized, decode_block):
    jcfg, jp, tcfg, tp = weights(family)
    jprefix, tprefix = both_prefixes(family, quantized)
    requests = suffixes(family, 7, seed=70)
    knobs = dict(batch_size=3, prompt_len=12, generate_tokens=5,
                 decode_block=decode_block, family=family,
                 quantized_kv=quantized)
    port = continuous.ContinuousBatcher(tp, tcfg, prefix_cache=tprefix,
                                        device="cpu", **knobs)
    reference = jax_continuous.ContinuousBatcher(jp, jcfg,
                                                 prefix_cache=jprefix,
                                                 **knobs)
    assert port.prefix_len == reference.prefix_len == PREFIX
    assert port._engine_key() != continuous.ContinuousBatcher(
        tp, tcfg, device="cpu", **knobs)._engine_key()
    waiting, got = list(enumerate(requests)), {}
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
                        for i, t in reference.step()}
        got.update(done)
        assert counters(port) == counters(reference), f"step {step}"
        if not waiting and port.active == 0:
            break
    assert sorted(got) == list(range(7))
    want = reference_greedy(family, quantized, requests)
    for i in range(7):
        np.testing.assert_array_equal(got[i], want[i], err_msg=f"{i}")
    # decode never wrote the prefix region of any slot
    for layer, pre in zip(port.cache["layers"], tprefix["layers"]):
        for leaf, buf in layer.items():
            assert torch.equal(buf[:, :, :PREFIX],
                               pre[leaf].expand_as(buf)[:, :, :PREFIX])


@pytest.mark.parametrize("family,quantized", [("gpt", True)],
                         ids=["gpt-int8"])
def test_prefix_plane_matches_the_reference_plane(family, quantized):
    jcfg, jp, tcfg, tp = weights(family)
    jprefix, tprefix = both_prefixes(family, quantized)
    knobs = dict(shards=2, shard_slots=2, prompt_len=12, generate_tokens=5,
                 decode_block=2, family=family, quantized_kv=quantized)
    port = shard_plane.ShardedBatcher(tp, tcfg, prefix_cache=tprefix,
                                      device="cpu", **knobs)
    reference = jax_plane.ShardedBatcher(jp, jcfg, prefix_cache=jprefix,
                                         **knobs)
    requests = suffixes(family, 7, seed=80)
    waiting, results = list(enumerate(requests)), {}
    for step in range(60):
        free = len(port.free_slots)
        assert free == len(reference.free_slots)
        take = min(free, 3 if step % 3 == 0 else 0)
        if waiting and take:
            batch = [(ids, i) for i, ids in waiting[:take]]
            waiting = waiting[take:]
            assert port.submit_many(batch) == reference.submit_many(batch)
        step_both(port, reference, results)
        if not waiting and port.active == 0:
            break
    assert sorted(results) == list(range(7))
    want = reference_greedy(family, quantized, requests)
    for i in range(7):
        np.testing.assert_array_equal(results[i], want[i], err_msg=f"{i}")


def test_batcher_refuses_a_prefix_of_the_other_layout_or_too_long():
    _, _, tcfg, tp = weights("gpt")
    _, full = both_prefixes("gpt", False)
    with pytest.raises(ValueError, match="layout mismatch"):
        continuous.ContinuousBatcher(tp, tcfg, 2, 12, 5, quantized_kv=True,
                                     prefix_cache=full, device="cpu")
    with pytest.raises(ValueError, match="exceeds max_seq_len"):
        continuous.ContinuousBatcher(tp, tcfg, 2, 12,
                                     tcfg.max_seq_len - 12 - PREFIX + 1,
                                     prefix_cache=full, device="cpu")
    donor = continuous.ContinuousBatcher(tp, tcfg, 2, 12, 5, device="cpu",
                                         prefix_cache=full)
    other = continuous.ContinuousBatcher(
        tp, tcfg, 2, 12, 5, device="cpu",
        prefix_cache=both_prefixes("gpt", False)[1])
    with pytest.raises(ValueError, match="prefix"):
        other.adopt_engine(donor)


# ---------------------------------------------------------------------------
# The workers, the pools and the binary
# ---------------------------------------------------------------------------


def traffic(family) -> list[str]:
    bodies = [json.dumps(ids.tolist()) for ids in suffixes(family, 5, 90)]
    bodies.insert(2, "not json at all")
    return bodies


def serve_batch(module, queue_cls, params, config, quantized, **worker_kw):
    jobs, replies = queue_cls(), queue_cls()
    for body in traffic("gpt"):
        jobs.send_message(URL, body)
    svc = module.ServiceConfig(queue_url=URL, batch_size=3, seq_len=12,
                               generate_tokens=5, result_queue_url=REPLIES,
                               quantized_kv=quantized)
    worker = module.QueueWorker(jobs, params, config, svc,
                                result_queue=replies, **worker_kw)
    while worker.run_once():
        pass
    return {json.loads(m["Body"])["request_id"]: m["Body"]
            for m in replies.receive_messages(REPLIES, max_messages=100)}


@pytest.mark.parametrize("quantized", [False, True], ids=["full", "int8"])
def test_queue_worker_with_int8_weights_and_prefix_matches_reference(
        quantized):
    # the reference binary wires the batch worker's prefix generate as a
    # generate_fn seam; the port's worker takes the prefix cache itself
    jcfg, jp, tcfg, tp = weights("gpt", int8=True)
    ids = prefix_ids("gpt")
    jprefix = ref("gpt", name("prefill_prefix", quantized))(
        jp, jnp.asarray(ids), config=jcfg)
    tprefix = family_of(tcfg).layout(quantized).prefill_prefix(
        tp, torch.from_numpy(ids), tcfg, None)

    def jax_generate(params, tokens_, n, lengths):
        return ref("gpt", "generate")(
            params, tokens_, num_tokens=n, config=jcfg, lengths=lengths,
            quantized_cache=quantized, prefix_cache=jprefix)

    want = serve_batch(jax_service, JaxQueue, jp, jcfg, quantized,
                       generate_fn=jax_generate)
    got = serve_batch(service, FakeMessageQueue, tp, tcfg, quantized,
                      device="cpu", prefix_cache=tprefix)
    assert len(want) == 6 and got == want


@pytest.mark.parametrize("kind", ["worker-pool", "sharded-pool"])
def test_fleet_pools_serve_int8_params_and_the_prefix(kind):
    _, _, tcfg, tp = weights("gpt", int8=True)
    tprefix = family_of(tcfg).layout(True).prefill_prefix(
        tp, torch.from_numpy(prefix_ids("gpt")), tcfg, None)
    requests = suffixes("gpt", 6, seed=95)
    svc = service.ServiceConfig(queue_url=URL, batch_size=2, seq_len=12,
                                generate_tokens=4, decode_block=2,
                                result_queue_url=REPLIES, quantized_kv=True)
    jobs, replies = FakeMessageQueue(), FakeMessageQueue()
    for ids in requests:
        jobs.send_message(URL, json.dumps(ids.tolist()))
    make = WorkerPool if kind == "worker-pool" else ShardedWorkerPool
    pool = make.serving(jobs, tp, tcfg, svc, result_queue=replies,
                        device="cpu", prefix_cache=tprefix,
                        clock=FakeClock(), min=2, max=2)
    FleetDriver(pool, cycle_dt=0.1).run(until_processed=len(requests),
                                        max_cycles=400)
    batchers = ([r.worker.batcher for r in pool.members]
                if kind == "worker-pool" else [pool.worker.batcher])
    assert all(b.params is tp and b._prefix_cache is tprefix
               and b.quantized_kv for b in batchers)
    got = {json.loads(m["Body"])["request_id"]: json.loads(m["Body"])
           for m in replies.receive_messages(REPLIES, max_messages=100)}
    assert len(got) == len(requests)
    alone = family_of(tcfg).generate(
        tp, torch.from_numpy(np.stack([np.pad(r, (0, 12 - len(r)))
                                       for r in requests])), 4, tcfg, None,
        lengths=torch.tensor([len(r) for r in requests]),
        quantized_cache=True, prefix_cache=tprefix).numpy()
    replies_in_order = [got[f"msg-{i + 1}"]["tokens"]
                        for i in range(len(requests))]
    assert replies_in_order == alone.tolist()


BINARY = ["--device", "cpu", "--demo", "4", "--seq-len", "16",
          "--generate-tokens", "4", "--batch-size", "2",
          "--result-queue-url", "demo://replies", "--quantize", "int8",
          "--quantize-kv", "--prefix-ids", "3,1,4,1,5,9,2"]


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_binary_demo_serves_the_three_flags_in_every_mode(family):
    replies = {}
    for mode, extra in (("batch", []),
                        ("block-2", ["--continuous", "--decode-block", "2"]),
                        ("shards-2", ["--continuous", "--decode-block", "2",
                                      "--shards", "2"])):
        summary = binary([*BINARY, "--family", family, *extra])
        assert summary["processed"] == 4 and len(summary["replies"]) == 4
        before, after = summary["weight_bytes"]
        assert after < before
        replies[mode] = summary["replies"]
    assert replies["block-2"] == replies["batch"] == replies["shards-2"]


@pytest.mark.parametrize("args,message", [
    (["--generate-tokens", "0", "--quantize-kv"],
     "--quantize-kv requires --generate-tokens >= 1"),
    (["--prefix-ids", "1,x"], "--prefix-ids must be integers"),
    (["--prefix-ids", " , "], "--prefix-ids is empty"),
    (["--prefix-ids", "1,2"], "--prefix-ids requires --generate-tokens"),
], ids=["quantize-kv", "not-integers", "empty", "needs-generate"])
def test_binary_flag_checks_fail_as_the_reference(args, message):
    argv = ["--demo", "4", *args]
    for main, extra in ((jax_binary.main, []), (binary, ["--device", "cpu"])):
        with pytest.raises(SystemExit, match=message):
            main([*argv, *extra])
    with pytest.raises(SystemExit):  # argparse refuses another scheme
        binary(["--demo", "4", "--device", "cpu", "--quantize", "int4"])


def test_binary_refuses_prefix_ids_outside_the_vocabulary():
    with pytest.raises(SystemExit, match=r"--prefix-ids \[8192\] out of "
                                         "range for vocab_size=8192"):
        binary(["--device", "cpu", "--demo", "1", "--seq-len", "16",
                "--generate-tokens", "2", "--prefix-ids", "1,8192"])


def test_binary_context_grows_by_the_prefix():
    from kube_sqs_autoscaler_tpu_torch.workloads.__main__ import (
        builtin_config, builtin_llama_config,
    )

    assert builtin_config(512, 32).max_seq_len == 544
    assert builtin_config(512, 32, 37).max_seq_len == 581
    assert builtin_llama_config(16, 4, 7).max_seq_len == 64
