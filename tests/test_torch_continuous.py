"""The port's continuous batcher and worker held against the JAX reference.

The same weights (the reference's ``init_params``, converted) and the same
numpy prompts go through ``kube_sqs_autoscaler_tpu.workloads.continuous``
and the port, f32 and greedy on the CPU.  Every request's tokens must
equal the reference batcher's and the reference ``generate``'s for that
prompt alone (each comparison first checks that the reference's top-two
logit margin exceeds 1e-4, so a flipped token is a bug, not a near-tie),
and the worker's reply JSON must be byte-identical to the reference
worker's for the same traffic.
"""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kube_sqs_autoscaler_tpu.metrics.fake import FakeMessageQueue as JaxQueue
from kube_sqs_autoscaler_tpu.workloads import continuous as jax_continuous
from kube_sqs_autoscaler_tpu.workloads import decode as jax_decode
from kube_sqs_autoscaler_tpu.workloads import service as jax_service
from kube_sqs_autoscaler_tpu_torch.metrics.fake import FakeMessageQueue
from kube_sqs_autoscaler_tpu_torch.workloads import continuous, decode, service
from kube_sqs_autoscaler_tpu_torch.workloads.__main__ import main as binary
from kube_sqs_autoscaler_tpu_torch.workloads.tenancy import TenancyConfig

from .test_torch_decode import MARGIN, top2_margin
from .test_torch_model import DIMS, as_numpy, both_params

URL = "fake://jobs"
REPLIES = "fake://replies"
PROMPT_LEN = 12


def prompts(n: int, seed: int = 0, max_len: int = PROMPT_LEN) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(1, DIMS["vocab_size"], rng.integers(2, max_len + 1))
            .astype(np.int32) for _ in range(n)]


def drain(batcher, requests) -> dict:
    """Admit as slots free (one ``submit_many`` per refill) and step until
    every request finished; returns the tokens by request index."""
    waiting = list(enumerate(requests))
    results = {}
    for _ in range(500):
        free = len(batcher.free_slots)
        if waiting and free:
            take, waiting = waiting[:free], waiting[free:]
            batcher.submit_many([(ids, i) for i, ids in take])
        for i, tokens in batcher.step():
            results[i] = np.asarray(tokens)
        if not waiting and batcher.active == 0:
            break
    assert len(results) == len(requests)
    return results


_prefill = jax.jit(jax_decode.prefill, static_argnames=("config",))
_decode_step = jax.jit(jax_decode.decode_step, static_argnames=("config",))


def reference_greedy(jcfg, jp, requests, n_tokens, eos_id=None,
                     width=PROMPT_LEN) -> np.ndarray:
    """The reference's greedy tokens ``[R, n_tokens]``, eos-padded like its
    ``generate``, for each request alone: the prompts run as rows of one
    right-padded ragged batch, and rows never interact.  Checks first that
    the trajectory's top-two margin exceeds :data:`MARGIN`."""
    ids = np.zeros((len(requests), width), np.int32)
    for row, prompt in enumerate(requests):
        ids[row, :len(prompt)] = prompt
    lengths = jnp.asarray([len(p) for p in requests], jnp.int32)
    logits, cache = _prefill(jp, jnp.asarray(ids), config=jcfg,
                             lengths=lengths)
    done = np.zeros(len(requests), bool)
    out, margins = [], []
    for step in range(n_tokens):
        logits = np.asarray(logits)
        margins.append(top2_margin(logits)[~done])
        token = logits.argmax(-1)
        if eos_id is not None:
            token = np.where(done, eos_id, token)
            done = done | (token == eos_id)
        out.append(token)
        if step < n_tokens - 1:
            logits, cache = _decode_step(jp, cache,
                                         jnp.asarray(token, jnp.int32),
                                         config=jcfg)
    margin = float(np.concatenate(margins).min())
    assert margin > MARGIN, f"near-tie in the reference ({margin:.2e})"
    return np.stack(out, axis=1)


def port_batcher(tp, tcfg, **kw):
    kw.setdefault("prompt_len", PROMPT_LEN)
    return continuous.ContinuousBatcher(tp, tcfg, device="cpu", **kw)


@pytest.mark.parametrize("decode_block,generate_tokens,with_eos", [
    (1, 5, True), (3, 5, True), (1, 1, False), (3, 1, False),
], ids=["block1-eos", "block3-eos", "block1-budget1", "block3-budget1"])
def test_batcher_matches_reference_batcher_and_generate(
        decode_block, generate_tokens, with_eos):
    # 7 ragged requests through 3 slots: slots are reused mid-flight
    jcfg, jp, tcfg, tp = both_params()
    requests = prompts(7)
    eos_id = None
    if with_eos:  # a token request 0 emits second: fires early there
        eos_id = int(reference_greedy(jcfg, jp, requests[:1], 2)[0, 1])
    knobs = dict(batch_size=3, prompt_len=PROMPT_LEN,
                 generate_tokens=generate_tokens, eos_id=eos_id,
                 decode_block=decode_block)
    want = drain(jax_continuous.ContinuousBatcher(jp, jcfg, **knobs),
                 requests)
    got = drain(port_batcher(tp, tcfg, **knobs), requests)
    reference = reference_greedy(jcfg, jp, requests, generate_tokens, eos_id)
    if decode_block == 1:  # the oracle is the reference's own generate
        ids = np.zeros((len(requests), PROMPT_LEN), np.int32)
        for row, prompt in enumerate(requests):
            ids[row, :len(prompt)] = prompt
        generated = jax_decode.generate(
            jp, jnp.asarray(ids), generate_tokens, jcfg, eos_id=eos_id,
            lengths=jnp.asarray([len(p) for p in requests], jnp.int32))
        np.testing.assert_array_equal(reference, np.asarray(generated))
    for i in range(len(requests)):
        np.testing.assert_array_equal(want[i], reference[i],
                                      err_msg=f"reference batcher, {i}")
        np.testing.assert_array_equal(got[i], reference[i],
                                      err_msg=f"port, {i}")
    if with_eos:
        assert any((tokens == eos_id).sum() > 1 for tokens in got.values())


def test_block_eos_at_every_offset_matches_single_step():
    _, _, tcfg, tp = both_params()
    ids = prompts(1, seed=31, max_len=8)[0]
    prompt = torch.from_numpy(ids.astype(np.int64))[None]
    plain = decode.generate(tp, prompt, 6, tcfg)[0]
    for offset in range(6):
        eos = int(plain[offset])
        want = decode.generate(tp, prompt, 6, tcfg, eos_id=eos)[0].numpy()
        engines = [port_batcher(tp, tcfg, batch_size=2, prompt_len=8,
                                generate_tokens=6, eos_id=eos,
                                decode_block=block) for block in (4, 1)]
        for engine in engines:
            np.testing.assert_array_equal(drain(engine, [ids])[0], want,
                                          err_msg=f"offset {offset}")
            assert engine.active == 0
        assert engines[0].tokens_emitted == engines[1].tokens_emitted


def state(batcher) -> list[torch.Tensor]:
    tensors = [batcher._current, batcher._done, batcher._remaining,
               batcher.cache["length"]]
    return tensors + [buf for layer in batcher.cache["layers"]
                      for buf in layer.values()]


@pytest.mark.parametrize("decode_block", [1, 3])
def test_submit_many_equals_sequential_submits(decode_block):
    _, _, tcfg, tp = both_params()
    requests = prompts(3, seed=4)
    batched, sequential = (
        port_batcher(tp, tcfg, batch_size=4, generate_tokens=5,
                     decode_block=decode_block) for _ in range(2))
    assert batched.submit_many([(ids, i) for i, ids in enumerate(requests)]) \
        == [0, 1, 2]
    assert [sequential.submit(ids, i) for i, ids in enumerate(requests)] \
        == [0, 1, 2]
    for a, b in zip(state(batched), state(sequential)):
        assert torch.equal(a, b)
    assert (batched.insert_dispatches, sequential.insert_dispatches) == (1, 3)
    outputs = []
    for engine in (batched, sequential):
        results = {}
        while engine.active:
            results.update(engine.step())
        outputs.append(results)
    assert outputs[0].keys() == {0, 1, 2}
    for i in range(3):
        np.testing.assert_array_equal(outputs[0][i], outputs[1][i])


def test_submit_many_past_the_free_slots_raises():
    _, _, tcfg, tp = both_params()
    batcher = port_batcher(tp, tcfg, batch_size=2, generate_tokens=3)
    with pytest.raises(RuntimeError, match="no free slot"):
        batcher.submit_many([(ids, i) for i, ids in enumerate(prompts(3))])
    assert batcher.active == 0 and batcher.insert_dispatches == 0
    assert batcher.submit_many([]) == []


@pytest.mark.parametrize("decode_block", [2, 3])
def test_admission_and_block_cycles_pin_dispatches_and_transfers(
        decode_block):
    _, _, tcfg, tp = both_params()
    batcher = port_batcher(tp, tcfg, batch_size=4, generate_tokens=7,
                           decode_block=decode_block)
    batcher.submit_many([(ids, i) for i, ids in enumerate(prompts(4))])
    assert (batcher.insert_dispatches, batcher.host_transfers) == (1, 0)
    finished, cycles = [], 0
    while batcher.active:
        before = (batcher.decode_dispatches, batcher.host_transfers)
        finished += batcher.step()
        cycles += 1
        assert batcher.decode_dispatches - before[0] <= 1
        assert batcher.host_transfers - before[1] <= 1
    assert len(finished) == 4
    assert batcher.host_transfers <= cycles
    assert batcher.tokens_emitted == 4 * 7
    assert 0 < batcher.block_tokens <= batcher.block_capacity
    assert batcher.block_settles == batcher.decode_dispatches - 1


def test_idle_slot_stepped_past_max_seq_len_keeps_reference_outputs():
    # requests go one at a time into slot 0; slot 1 idles and steps every
    # cycle, so its length runs past max_seq_len (96) after 96 steps
    jcfg, jp, tcfg, tp = both_params()
    distinct = prompts(3, seed=9, max_len=8)
    requests = [distinct[i % 3] for i in range(22)]
    knobs = dict(batch_size=2, prompt_len=8, generate_tokens=6)
    engines = [jax_continuous.ContinuousBatcher(jp, jcfg, **knobs),
               port_batcher(tp, tcfg, **knobs)]
    outputs = [[], []]
    for ids in requests:
        for engine, out in zip(engines, outputs):
            engine.submit(ids, None)
            while engine.active:
                out += [tokens for _, tokens in engine.step()]
    assert int(engines[1].cache["length"][1]) > DIMS["max_seq_len"]
    want = reference_greedy(jcfg, jp, distinct, 6, width=8)
    for i, (ref, got) in enumerate(zip(*outputs)):
        np.testing.assert_array_equal(got, ref, err_msg=f"request {i}")
        np.testing.assert_array_equal(got, want[i % 3])


def test_decode_step_past_max_seq_len_writes_nothing_like_the_reference():
    jcfg, jp, tcfg, tp = both_params()
    rng = np.random.default_rng(3)
    shape = (2, DIMS["n_heads"], DIMS["max_seq_len"],
             DIMS["d_model"] // DIMS["n_heads"])
    layers = [{name: rng.standard_normal(shape).astype(np.float32)
               for name in ("k", "v")} for _ in range(DIMS["n_layers"])]
    length = np.array([DIMS["max_seq_len"], 10], np.int32)
    tokens = np.array([5, 7], np.int32)
    want_logits, want_cache = jax_decode.decode_step(
        jp, {"layers": [{k: jnp.asarray(v) for k, v in layer.items()}
                        for layer in layers], "length": jnp.asarray(length)},
        jnp.asarray(tokens), jcfg)
    cache = {"layers": [{k: torch.from_numpy(v.copy()) for k, v in
                         layer.items()} for layer in layers],
             "length": torch.from_numpy(length.astype(np.int64))}
    got_logits, got_cache = decode.decode_step(
        tp, cache, torch.from_numpy(tokens.astype(np.int64)), tcfg)
    np.testing.assert_allclose(as_numpy(got_logits), np.asarray(want_logits),
                               atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got_cache["length"].numpy(),
                                  np.asarray(want_cache["length"]))
    for before, want, got in zip(layers, want_cache["layers"],
                                 got_cache["layers"]):
        for name in ("k", "v"):
            np.testing.assert_array_equal(got[name][0].numpy(),
                                          before[name][0])
            np.testing.assert_allclose(got[name].numpy(),
                                       np.asarray(want[name]), atol=1e-5,
                                       rtol=0)


def test_block_decode_matches_reference_block_decode():
    # ragged lengths, a frozen row (done), a row that runs out of budget
    # mid-block and eos: tokens, counts and the state must all agree
    jcfg, jp, tcfg, tp = both_params()
    ids = np.zeros((4, 10), np.int32)
    lengths = np.array([10, 4, 7, 9], np.int32)
    rng = np.random.default_rng(8)
    for row, n in enumerate(lengths):
        ids[row, :n] = rng.integers(1, DIMS["vocab_size"], n)
    logits, jcache = jax_decode.prefill(jp, jnp.asarray(ids), jcfg,
                                        lengths=jnp.asarray(lengths))
    current = np.asarray(logits).argmax(-1).astype(np.int32)
    done = np.array([False, True, False, False])
    remaining = np.array([5, 5, 2, 5], np.int32)
    eos = int(reference_greedy(jcfg, jp, [ids[row, :n] for row, n in
                                          enumerate(lengths)], 3,
                               width=10)[3, 2])
    want = jax_decode.block_decode(
        jp, jcache, jnp.asarray(current), jnp.asarray(done),
        jnp.asarray(remaining), jnp.zeros((4, 2), jnp.uint32), jcfg,
        eos_id=eos)
    _, tcache = decode.prefill(tp, torch.from_numpy(ids), tcfg,
                               lengths=torch.from_numpy(lengths))
    got = decode.block_decode(
        tp, tcache, torch.from_numpy(current.astype(np.int64)),
        torch.from_numpy(done), torch.from_numpy(remaining.astype(np.int64)),
        [None] * 4, tcfg, eos_id=eos)
    for name, w, g in zip(("current", "done", "remaining", "tokens",
                           "counts"), want[1:], got[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    np.testing.assert_array_equal(got[0]["length"].numpy(),
                                  np.asarray(want[0]["length"]))
    counts = got[5].tolist()
    assert counts[1] == 0 and counts[2] <= 2 and counts[3] <= 2


def traffic() -> list[str]:
    """Ragged bodies (longer than the bucket too), a malformed body and a
    body with out-of-range ids: more messages than the worker has slots."""
    rng = np.random.default_rng(12)
    vocab = DIMS["vocab_size"]
    bodies = [json.dumps(rng.integers(0, vocab, n).tolist())
              for n in (3, 10, 20, 32, 40, 7, 16)]
    bodies.insert(2, "not json at all")
    bodies.insert(5, json.dumps([vocab + 3, -1, 5, -vocab - 4]))
    return bodies


def serve(module, svc_module, queue_cls, params, config, eos_id,
          decode_block, **kw):
    """Drain ``traffic()`` through one worker; returns (raw reply JSON by
    request id, queue attributes after the run)."""
    jobs, replies = queue_cls(), queue_cls()
    for body in traffic():
        jobs.send_message(URL, body)
    svc = svc_module.ServiceConfig(
        queue_url=URL, batch_size=3, seq_len=32, generate_tokens=6,
        eos_id=eos_id, decode_block=decode_block, result_queue_url=REPLIES,
    )
    worker = module.ContinuousWorker(jobs, params, config, svc,
                                     result_queue=replies, **kw)
    worker.drain(total=len(traffic()))
    raw = {}
    for message in replies.receive_messages(REPLIES, max_messages=100):
        raw[json.loads(message["Body"])["request_id"]] = message["Body"]
    return raw, jobs.get_queue_attributes(URL, ())


@pytest.mark.parametrize("decode_block", [1, 3])
def test_worker_replies_byte_identical_to_reference_worker(decode_block):
    jcfg, jp, tcfg, tp = both_params()
    first = json.loads(traffic()[0])
    eos_id = int(reference_greedy(jcfg, jp, [np.asarray(first)], 3,
                                  width=32)[0, 2])
    want, _ = serve(jax_continuous, jax_service, JaxQueue, jp, jcfg, eos_id,
                    decode_block)
    got, attrs = serve(continuous, service, FakeMessageQueue, tp, tcfg,
                       eos_id, decode_block, device="cpu")
    assert len(got) == len(traffic())
    assert got == want
    assert attrs["ApproximateNumberOfMessages"] == "0"
    assert attrs["ApproximateNumberOfMessagesNotVisible"] == "0"
    assert json.loads(got["msg-3"]) == {"error": "malformed body",
                                        "request_id": "msg-3"}
    assert len(json.loads(got["msg-1"])["tokens"]) < 6  # trimmed at eos


def test_ttl_shed_replies_expired_and_deletes():
    clock = [1000.0]
    jcfg, jp, tcfg, tp = both_params()
    outputs = []
    for module, svc_module, queue_cls, params, config, kw in (
            (jax_continuous, jax_service, JaxQueue, jp, jcfg, {}),
            (continuous, service, FakeMessageQueue, tp, tcfg,
             {"device": "cpu"})):
        clock[0] = 1000.0
        jobs, replies = (queue_cls(now_fn=lambda: clock[0]), queue_cls())
        jobs.send_message(URL, json.dumps([1, 2, 3]))
        clock[0] += 10.0
        jobs.send_message(URL, json.dumps([4, 5]))
        svc = svc_module.ServiceConfig(
            queue_url=URL, batch_size=2, seq_len=8, generate_tokens=2,
            request_ttl_s=5.0, result_queue_url=REPLIES)
        worker = module.ContinuousWorker(jobs, params, config, svc,
                                         result_queue=replies,
                                         now_fn=lambda: clock[0], **kw)
        worker.drain(total=2)
        assert worker.shed_by_reason["ttl"] == 1
        assert worker.processed == 1
        attrs = jobs.get_queue_attributes(URL, ())
        assert attrs["ApproximateNumberOfMessages"] == "0"
        assert attrs["ApproximateNumberOfMessagesNotVisible"] == "0"
        outputs.append(sorted(m["Body"] for m in replies.receive_messages(
            REPLIES, max_messages=10)))
    assert outputs[0] == outputs[1]
    assert '{"error": "expired", "request_id": "msg-1"}' in outputs[1]


class CountingQueue(FakeMessageQueue):
    receives = 0

    def receive_messages(self, *args, **kwargs):
        self.receives += 1
        return super().receive_messages(*args, **kwargs)


def test_poll_backoff_throttles_receives_while_decoding():
    _, _, tcfg, tp = both_params()
    jobs = CountingQueue()
    jobs.send_message(URL, json.dumps([1, 2, 3]))
    worker = continuous.ContinuousWorker(
        jobs, tp, tcfg,
        service.ServiceConfig(queue_url=URL, batch_size=2, seq_len=16,
                              generate_tokens=30),
        device="cpu")
    for _ in range(20):
        worker.run_once()
    # cycle 1 admits, cycle 2 finds the queue empty and backs off 16
    # cycles, cycle 19 polls again and backs off again
    assert jobs.receives == 3
    assert worker.refill_cycles == 20 and worker.batcher.active == 1


@pytest.mark.parametrize("decode_block", [1, 3])
def test_sampled_run_terminates_in_vocab_and_reproduces(decode_block):
    _, _, tcfg, tp = both_params()
    requests = prompts(5, seed=6)
    runs = [drain(port_batcher(tp, tcfg, batch_size=2, generate_tokens=6,
                               temperature=1.0, top_k=8, top_p=0.9,
                               sample_seed=3, decode_block=decode_block),
                  requests) for _ in range(2)]
    for i in range(5):
        assert runs[0][i].shape == (6,)
        assert ((0 <= runs[0][i]) & (runs[0][i] < DIMS["vocab_size"])).all()
        np.testing.assert_array_equal(runs[0][i], runs[1][i])


@pytest.mark.parametrize("knobs,match", [
    (dict(family="llama"), "serves a LlamaConfig"),
    # a mesh is ported: what is left to refuse is the reference's own
    # checks, a seq axis and a batch the data axis does not divide
    (dict(mesh=SimpleNamespace(shape={"data": 1, "seq": 2, "model": 1})),
     r"serving uses a \(data, model\) mesh"),
    # int8 slots and the shared prefix are ported (test_torch_int8_cache,
    # test_torch_prefix): what is left to refuse is a prefix of the other
    # layout, and a budget that only the prefix pushes past the context
    (dict(quantized_kv=True, prefix_cache="full"), "layout mismatch"),
    (dict(prefix_cache="full", generate_tokens=80), "exceeds max_seq_len"),
    # speculative and beam slots are ported (test_torch_spec_beam_serving),
    # and tenancy (test_torch_tenant_serving), on a mesh too
    # (test_torch_serve_mesh): what is left to refuse is slots the mesh's
    # data axis does not divide, beams with tenancy, and a prefix pool with
    # fewer entries than the slots
    (dict(draft_layers=1,
          mesh=SimpleNamespace(shape={"data": 4, "seq": 1, "model": 1})),
     "not divisible by the mesh's data axis"),
    (dict(beams=2, tenancy=TenancyConfig(tenants=("a",))),
     "plain continuous decode path"),
    (dict(tenancy=TenancyConfig(tenants=("a",), prefix_pool=1,
                                prefix_len=4)),
     "must be >= the per-shard slot count"),
    (dict(family="moe"), "unknown family"),
    (dict(beams=0), "beams"),
    (dict(decode_block=0), "decode_block"),
    (dict(top_k=-1), "top_k"),
    (dict(top_p=0.0), "top_p"),
    (dict(generate_tokens=90), "exceeds max_seq_len"),
], ids=lambda v: next(iter(v)) if isinstance(v, dict) else None)
def test_unported_and_invalid_knobs_raise(knobs, match):
    _, _, tcfg, tp = both_params()
    kw = dict(batch_size=2, generate_tokens=4)
    kw.update(knobs)
    if kw.get("prefix_cache") == "full":
        kw["prefix_cache"] = decode.prefill_prefix(tp, torch.arange(7), tcfg)
    with pytest.raises(ValueError, match=match):
        port_batcher(tp, tcfg, **kw)


def test_family_llama_builds_the_gqa_engine():
    # the llama family is served: its config, compact cache and step
    from kube_sqs_autoscaler_tpu_torch.workloads import llama

    config = llama.LlamaConfig(vocab_size=64, d_model=32, n_heads=4,
                               n_kv_heads=2, n_layers=1, d_ff=48,
                               max_seq_len=24, dtype=torch.float32)
    params = llama.init_llama_params(config, torch.Generator().manual_seed(0),
                                     "cpu")
    batcher = port_batcher(params, config, batch_size=2, generate_tokens=4,
                           family="llama", decode_block=2)
    assert batcher.family == "llama"
    assert port_batcher(params, config, batch_size=2,
                        generate_tokens=4).family == "llama"
    assert batcher.cache["layers"][0]["k"].shape == (2, 2, 24, 8)
    assert batcher._step_fn is llama.llama_decode_step
    got = drain(batcher, prompts(3, seed=4, max_len=8))
    for i, ids in enumerate(prompts(3, seed=4, max_len=8)):
        want = llama.llama_generate(params, torch.from_numpy(ids)[None], 4,
                                    config)
        np.testing.assert_array_equal(got[i], want[0].numpy())


def test_service_config_checks_the_continuous_knobs():
    with pytest.raises(ValueError, match="decode_block"):
        service.ServiceConfig(queue_url=URL, decode_block=0)
    with pytest.raises(ValueError, match="request_ttl_s"):
        service.ServiceConfig(queue_url=URL, request_ttl_s=-1.0)
    with pytest.raises(ValueError, match="generate_tokens >= 1"):
        continuous.ContinuousWorker(
            FakeMessageQueue(), None, None,
            service.ServiceConfig(queue_url=URL), device="cpu")


def test_batcher_and_worker_on_cuda_without_a_card_raise():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    _, _, tcfg, tp = both_params()
    with pytest.raises(RuntimeError, match="no usable CUDA card"):
        continuous.ContinuousBatcher(tp, tcfg, 2, 8, 4)
    with pytest.raises(RuntimeError, match="no usable CUDA card"):
        continuous.ContinuousWorker(
            FakeMessageQueue(), tp, tcfg,
            service.ServiceConfig(queue_url=URL, seq_len=8,
                                  generate_tokens=4))


@pytest.mark.parametrize("args,message", [
    (["--decode-block", "2"], "--decode-block requires --continuous"),
    (["--request-ttl", "1"], "--request-ttl requires --continuous"),
    (["--continuous"], "--continuous requires --generate-tokens >= 1"),
    (["--continuous", "--generate-tokens", "2", "--decode-block", "0"],
     "must be >= 1"),
])
def test_binary_rejects_continuous_flags_without_their_mode(args, message):
    with pytest.raises(SystemExit, match=message):
        binary(["--demo", "4", "--device", "cpu", *args])


def test_binary_continuous_demo_on_cpu_exits_zero():
    out = subprocess.run(
        [sys.executable, "-m", "kube_sqs_autoscaler_tpu_torch.workloads",
         "--demo", "4", "--seq-len", "16", "--generate-tokens", "3",
         "--continuous", "--decode-block", "2", "--device", "cpu",
         "--result-queue-url", "demo://replies"],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"},
    )
    assert out.returncode == 0, out.stderr
    assert "Processed 4 messages" in out.stderr and "continuous" in out.stderr
    assert '\\"tokens\\"' in out.stderr
