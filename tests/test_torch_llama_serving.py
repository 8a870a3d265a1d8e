"""The port's llama family through every serving entry point, held
against the JAX package's.

The llama weights of ``tests/test_torch_llama.py`` (the reference's
``init_llama_params``, converted) and numpy prompts go, f32 and greedy on
the CPU, through:

- ``QueueWorker`` with its defaults for a llama config, and with explicit
  llama ``forward_fn`` / ``generate_fn``, against the reference worker
  with its llama seams: reply bytes equal;
- ``ContinuousBatcher(family="llama")`` at decode blocks 1 and 3 with
  refills mid-stream, against the reference's llama batcher after every
  step (outputs, insert and decode dispatches, host transfers) and against
  the reference's greedy rollout of each prompt alone;
- the sharded plane at two shards against the reference's plane;
- ``WorkerPool.serving(family="llama")`` and
  ``ShardedWorkerPool.serving(family="llama")`` under a ``FakeClock``;
- the worker binary's built-in llama with ``--device cpu --family llama``
  in batch, ``--continuous``, ``--shards 2`` and fleet mode.

Every greedy comparison first checks that the reference's top-two logit
margin exceeds 1e-4 along its own trajectory.
"""

import json

import numpy as np
import pytest
import torch

from kube_sqs_autoscaler_tpu.metrics.fake import FakeMessageQueue as JaxQueue
from kube_sqs_autoscaler_tpu.workloads import continuous as jax_continuous
from kube_sqs_autoscaler_tpu.workloads import service as jax_service
from kube_sqs_autoscaler_tpu.workloads import shard_plane as jax_plane
from kube_sqs_autoscaler_tpu_torch.core import FakeClock
from kube_sqs_autoscaler_tpu_torch.fleet import (
    FleetDriver, ShardedWorkerPool, WorkerPool,
)
from kube_sqs_autoscaler_tpu_torch.metrics.fake import FakeMessageQueue
from kube_sqs_autoscaler_tpu_torch.workloads import (
    continuous, llama, service, shard_plane,
)
from kube_sqs_autoscaler_tpu_torch.workloads import __main__ as binary
from kube_sqs_autoscaler_tpu_torch.workloads.family import family_of
from kube_sqs_autoscaler_tpu_torch.workloads.model import (
    ModelConfig, init_params,
)

from .test_torch_continuous import prompts
from .test_torch_llama import DIMS, REF, both_params, reference_rollout
from .test_torch_shard_plane import snapshot, step_both

PROMPT, TOKENS = 12, 5
URL, REPLIES = "fake://jobs", "fake://replies"


@pytest.fixture(scope="module")
def weights():
    return both_params()


def reference_greedy(weights, requests, eos_id=None) -> np.ndarray:
    """The reference's greedy tokens ``[R, TOKENS]`` for each prompt alone
    (rows of one right-padded batch; rows never interact), its margins
    checked."""
    jcfg, jp, _, _ = weights
    ids = np.zeros((len(requests), PROMPT), np.int32)
    for row, prompt in enumerate(requests):
        ids[row, :len(prompt)] = prompt
    lengths = np.array([len(p) for p in requests], np.int32)
    tokens, margin = reference_rollout(jcfg, jp, ids, lengths, TOKENS,
                                       eos_id)
    assert margin > 1e-4, f"near-tie in the reference ({margin:.2e})"
    return tokens


def llama_prompts(n: int, seed: int) -> list:
    return prompts(n, seed=seed, max_len=PROMPT)


# ---------------------------------------------------------------------------
# The batch worker's seams
# ---------------------------------------------------------------------------


def traffic() -> list[str]:
    rng = np.random.default_rng(21)
    vocab = DIMS["vocab_size"]
    bodies = [json.dumps(rng.integers(0, vocab, n).tolist())
              for n in (3, 10, 20, 7)]
    bodies.insert(2, "not json at all")
    bodies.insert(4, json.dumps([vocab + 3, -1, 5, -vocab - 4]))
    return bodies


def serve(module, queue_cls, params, config, generate_tokens, **worker_kw):
    jobs, replies = queue_cls(), queue_cls()
    for body in traffic():
        jobs.send_message(URL, body)
    svc = module.ServiceConfig(queue_url=URL, batch_size=3, seq_len=24,
                               generate_tokens=generate_tokens,
                               result_queue_url=REPLIES)
    worker = module.QueueWorker(jobs, params, config, svc,
                                result_queue=replies, **worker_kw)
    while worker.run_once():
        pass
    return {json.loads(m["Body"])["request_id"]: m["Body"]
            for m in replies.receive_messages(REPLIES, max_messages=100)}


@pytest.mark.parametrize("generate_tokens", [0, 6],
                         ids=["classify", "generate"])
def test_queue_worker_llama_seams_match_the_reference_worker(
        weights, generate_tokens):
    jcfg, jp, tcfg, tp = weights
    want = serve(
        jax_service, JaxQueue, jp, jcfg, generate_tokens,
        forward_fn=lambda p, t: REF["forward"](p, t, jcfg),
        generate_fn=lambda p, t, n, lengths: REF["generate"](
            p, t, n, jcfg, lengths=lengths))
    got = serve(service, FakeMessageQueue, tp, tcfg, generate_tokens,
                device="cpu")
    assert len(got) == len(traffic()) and got == want
    assert json.loads(got["msg-3"])["error"] == "malformed body"


def test_queue_worker_takes_explicit_llama_seams(weights):
    jcfg, jp, tcfg, tp = weights
    want = serve(
        jax_service, JaxQueue, jp, jcfg, 6,
        generate_fn=lambda p, t, n, lengths: REF["generate"](
            p, t, n, jcfg, lengths=lengths))
    got = serve(
        service, FakeMessageQueue, tp, tcfg, 6, device="cpu",
        generate_fn=lambda p, t, n, lengths: llama.llama_generate(
            p, t, n, tcfg, lengths=lengths))
    assert got == want


# ---------------------------------------------------------------------------
# The continuous batcher and the sharded plane
# ---------------------------------------------------------------------------


def counters(batcher) -> tuple[int, int, int]:
    return (batcher.insert_dispatches, batcher.decode_dispatches,
            batcher.host_transfers)


@pytest.mark.parametrize("decode_block,with_eos", [(1, False), (3, True)],
                         ids=["block1", "block3-eos"])
def test_batcher_matches_the_reference_llama_batcher(
        weights, decode_block, with_eos):
    jcfg, jp, tcfg, tp = weights
    requests = llama_prompts(7, seed=22)
    eos_id = None
    if with_eos:  # a token request 0 emits second: its slot frees early
        eos_id = int(reference_greedy(weights, requests[:1])[0, 1])
    knobs = dict(batch_size=3, prompt_len=PROMPT, generate_tokens=TOKENS,
                 decode_block=decode_block, eos_id=eos_id, family="llama")
    port = continuous.ContinuousBatcher(tp, tcfg, device="cpu", **knobs)
    ref = jax_continuous.ContinuousBatcher(jp, jcfg, **knobs)
    assert port.cache["layers"][0]["k"].shape == (3, 2, 48, 16)
    waiting, got, refills = list(enumerate(requests)), {}, 0
    for step in range(200):
        free = len(port.free_slots)
        assert free == len(ref.free_slots)
        if waiting and free and step % 2 == 0:
            take = min(free, 2)  # refills of 1-2 while other slots decode
            for batcher in (port, ref):
                batcher.submit_many([(ids, i) for i, ids in waiting[:take]])
            waiting = waiting[take:]
            refills += port.active > take
        done = {i: np.asarray(t).tolist() for i, t in port.step()}
        assert done == {i: np.asarray(t).tolist() for i, t in ref.step()}
        got.update(done)
        assert counters(port) == counters(ref), f"step {step}"
        if not waiting and port.active == 0:
            break
    assert refills > 0 and sorted(got) == list(range(7))
    want = reference_greedy(weights, requests, eos_id)
    for i in range(7):
        np.testing.assert_array_equal(got[i], want[i], err_msg=f"{i}")
    if with_eos:
        assert any(tokens.count(eos_id) > 1 for tokens in got.values())


def test_windowed_batcher_samples_past_an_idle_slots_end():
    # block 1 steps every row: an idle slot's position runs on past
    # max_seq_len + window while another slot serves one request after
    # another, and its logits must stay finite for the sampler
    _, _, tcfg, tp = both_params(sliding_window=4)
    batcher = continuous.ContinuousBatcher(
        tp, tcfg, batch_size=2, prompt_len=PROMPT, generate_tokens=TOKENS,
        temperature=0.8, top_k=20, sample_seed=3, decode_block=1,
        device="cpu")
    step_fn, sampled = batcher._decode, []

    def checked_step(*args):
        logits, cache = step_fn(*args)
        sampled.append(bool(torch.isfinite(logits).all()))
        return logits, cache

    batcher._decode = checked_step
    done = []
    for ids in llama_prompts(20, seed=25):
        batcher.submit_many([(ids, len(done))])
        while batcher.active:
            done += [i for i, _ in batcher.step()]
    assert done == list(range(20)) and all(sampled)
    idle = int(batcher.cache["length"][1])
    assert idle > tcfg.max_seq_len + 4 and len(sampled) >= idle


def test_sharded_plane_matches_the_reference_llama_plane(weights):
    jcfg, jp, tcfg, tp = weights
    knobs = dict(shards=2, shard_slots=2, prompt_len=PROMPT,
                 generate_tokens=TOKENS, decode_block=2, family="llama")
    port = shard_plane.ShardedBatcher(tp, tcfg, device="cpu", **knobs)
    ref = jax_plane.ShardedBatcher(jp, jcfg, **knobs)
    requests = llama_prompts(7, seed=23)
    waiting, results = list(enumerate(requests)), {}
    for step in range(60):
        free = len(port.free_slots)
        assert free == len(ref.free_slots)
        take = min(free, 3 if step % 3 == 0 else 0)
        if waiting and take:
            batch = [(ids, i) for i, ids in waiting[:take]]
            waiting = waiting[take:]
            assert port.submit_many(batch) == ref.submit_many(batch)
        step_both(port, ref, results)
        if not waiting and port.active == 0:
            break
    assert sorted(results) == list(range(7))
    want = reference_greedy(weights, requests)
    for i in range(7):
        np.testing.assert_array_equal(results[i], want[i], err_msg=f"{i}")
    assert port.decode_dispatches == port.gang_cycles > 0
    assert snapshot(port)["insert_dispatches"] >= 3


def test_llama_batcher_refuses_a_gpt_donor_and_a_gpt_config(weights):
    _, _, tcfg, tp = weights
    gpt = ModelConfig(vocab_size=128, d_model=64, n_heads=4, n_layers=2,
                      d_ff=96, max_seq_len=48, dtype=torch.float32)
    gpt_params = init_params(gpt, torch.Generator().manual_seed(0), "cpu")
    knobs = dict(batch_size=2, prompt_len=PROMPT, generate_tokens=TOKENS,
                 decode_block=2, device="cpu")
    donor = continuous.ContinuousBatcher(gpt_params, gpt, **knobs)
    replica = continuous.ContinuousBatcher(tp, tcfg, family="llama", **knobs)
    assert replica._engine_key() != donor._engine_key()
    with pytest.raises(ValueError, match="engine mismatch"):
        replica.adopt_engine(donor)
    with pytest.raises(ValueError, match="engine mismatch"):
        donor.adopt_engine(replica)
    with pytest.raises(ValueError, match="serves a LlamaConfig"):
        continuous.ContinuousBatcher(gpt_params, gpt, family="llama",
                                     **knobs)
    with pytest.raises(ValueError, match="serves a ModelConfig"):
        continuous.ContinuousBatcher(tp, tcfg, family="gpt", **knobs)
    # without a family the config's class picks it
    assert continuous.ContinuousBatcher(tp, tcfg, **knobs).family == "llama"
    # the same family adopts: the engine, the llama step included
    twin = continuous.ContinuousBatcher(tp, tcfg, family="llama", **knobs)
    twin.adopt_engine(replica)
    assert twin._step_fn is llama.llama_decode_step
    assert twin._block_fn is replica._block_fn


# ---------------------------------------------------------------------------
# The fleet pools
# ---------------------------------------------------------------------------


def fleet_run(weights, make_pool, requests):
    _, _, tcfg, tp = weights
    clock = FakeClock()
    queue = FakeMessageQueue(now_fn=clock.now)
    results = FakeMessageQueue(now_fn=clock.now)
    for ids in requests:
        queue.send_message(URL, json.dumps(np.asarray(ids).tolist()))
    config = service.ServiceConfig(queue_url=URL, batch_size=2,
                                   seq_len=PROMPT, generate_tokens=TOKENS,
                                   decode_block=2, result_queue_url=REPLIES)
    pool = make_pool(queue, tp, tcfg, config, results, clock)
    stats = FleetDriver(pool, cycle_dt=0.5).run(
        until_processed=len(requests))
    replies, duplicates = service.collect_replies(results, REPLIES)
    return stats, replies, duplicates, pool


@pytest.mark.parametrize("kind", ["replicas", "sharded"])
def test_fleet_pools_serve_the_llama_family(weights, kind):
    requests = llama_prompts(6, seed=24)

    def make_pool(queue, params, config, svc, results, clock):
        kw = dict(family="llama", result_queue=results, clock=clock,
                  device="cpu")
        if kind == "replicas":
            return WorkerPool.serving(queue, params, config, svc, min=2,
                                      max=2, **kw)
        return ShardedWorkerPool.serving(queue, params, config, svc, min=2,
                                         max=2, shards=2, **kw)

    stats, replies, duplicates, pool = fleet_run(weights, make_pool,
                                                 requests)
    assert stats["processed"] == 6 and duplicates == 0
    want = reference_greedy(weights, requests)
    for i in range(6):
        assert replies[f"msg-{i + 1}"]["tokens"] == want[i].tolist()
    workers = ([r.worker for r in pool.members] if kind == "replicas"
               else [pool.worker])
    assert all(w.batcher.family == "llama" for w in workers)


# ---------------------------------------------------------------------------
# The worker binary
# ---------------------------------------------------------------------------

BINARY = ["--device", "cpu", "--family", "llama", "--demo", "4", "--seq-len",
          "16", "--generate-tokens", "4", "--result-queue-url",
          "demo://replies"]


@pytest.fixture(scope="module")
def batch_replies():
    return binary.main(BINARY)


@pytest.mark.parametrize("mode", [
    ["--continuous"],
    ["--continuous", "--decode-block", "2", "--shards", "2"],
    ["--continuous", "--decode-block", "2", "--fleet-max-replicas", "2"],
], ids=["continuous", "shards", "fleet"])
def test_binary_serves_the_builtin_llama_in_every_mode(batch_replies, mode):
    summary = binary.main([*BINARY, *mode])
    assert batch_replies["processed"] == summary["processed"] == 4
    assert len(summary["replies"]) == 4 and summary["duplicate_replies"] == 0
    assert summary["replies"] == batch_replies["replies"]
    assert all(len(r["tokens"]) == 4 and all(0 <= t < 8192 for t in
                                             r["tokens"])
               for r in summary["replies"].values())


def test_builtin_llama_is_the_reference_binarys():
    config = binary.builtin_llama_config(512, 32)
    assert config == llama.LlamaConfig(max_seq_len=544)
    assert family_of(config).name == "llama"
    assert binary.builtin_llama_config(16, 0).max_seq_len == 64
    built, params = binary.builtin_model("llama", 16, 0, "cpu")
    assert built == llama.LlamaConfig(max_seq_len=64)
    assert sum(t.numel() for t in params["layers"][0].values()) * 4 + sum(
        params[name].numel() for name in ("embed", "final_norm")) == (
        15_471_104)
    # 8 slots of the compact cache: 2 kv heads where the GPT holds 8
    cache = llama.init_llama_cache(config, 8, "cpu")
    size = sum(t.numel() * t.element_size()
               for layer in cache["layers"] for t in layer.values())
    assert size == 8.5 * 2 ** 20
    with pytest.raises(SystemExit):
        binary.main(["--family", "moe", "--demo", "1", "--device", "cpu"])
