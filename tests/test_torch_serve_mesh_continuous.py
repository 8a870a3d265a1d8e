"""The port's continuous engine, sharded plane and worker binary over a
``(data, model)`` mesh, held against the JAX package's on its virtual
8-device CPU mesh.

4 gloo ranks (``torch_mesh_ranks.py``, the ``batcher`` and ``worker`` jobs
of ``torch_serve_ranks.py``) at dp 2 x tp 2 unless a case says otherwise,
f32 weights of the reference's init.  Each request's greedy tokens equal
the reference's batcher's on a mesh of the same shape (plain slots,
blocks, beams, speculative slots, the shared prefix, the sharded plane); a
sampled engine equals the port's one-process engine of the same seed;
the worker binary (both serving the reference binary's built-in bf16
weights) answers every body once, by rank 0, with the reference binary's
replies on its mesh and the port's one-process binary's, byte for byte.
"""

import functools
import json

import jax
import numpy as np
import pytest
import torch

from kube_sqs_autoscaler_tpu.metrics.fake import FakeMessageQueue as JaxQueue
from kube_sqs_autoscaler_tpu.workloads import __main__ as jax_binary
from kube_sqs_autoscaler_tpu.workloads import continuous as jax_continuous
from kube_sqs_autoscaler_tpu.workloads import model as jax_model
from kube_sqs_autoscaler_tpu.workloads import shard_plane as jax_plane
from kube_sqs_autoscaler_tpu.workloads import tenancy as jax_tenancy
from kube_sqs_autoscaler_tpu.workloads.service import (
    ServiceConfig as jax_service,
)
from kube_sqs_autoscaler_tpu_torch.workloads import continuous, tenancy
from kube_sqs_autoscaler_tpu_torch.workloads.__main__ import (
    builtin_config, main as binary,
)
from kube_sqs_autoscaler_tpu_torch.workloads.convert import params_from_jax

from .conftest import drain_batcher
from .test_torch_quantize import tokens, weights
from .test_torch_serve_mesh import jax_mesh, jax_prefix, port_prefix
from .torch_mesh_ranks import run_ranks
from .torch_serve_ranks import drain, worker_summary

torch.set_num_threads(1)

PROMPT = 10
TOKENS = 5


def requests_of(family: str, n: int = 6, seed: int = 3) -> list:
    rng = np.random.default_rng(seed)
    return [tokens(family, 1, int(rng.integers(2, PROMPT + 1)),
                   seed=seed + i)[0] for i in range(n)]


# engine name -> (family, knobs, slots, shards)
ENGINES = {
    "plain": ("gpt", dict(), 4, 0),
    "block": ("gpt", dict(decode_block=3), 4, 0),
    "llama-block": ("llama", dict(decode_block=2), 4, 0),
    "beams": ("gpt", dict(beams=2), 2, 0),
    "speculative": ("gpt", dict(draft_layers=1, draft_tokens=2), 4, 0),
    "prefix-int8": ("gpt", dict(decode_block=2, quantized_kv=True,
                                prefix=True), 4, 0),
    "plane": ("gpt", dict(decode_block=2), 2, 2),
    "llama-plane": ("llama", dict(decode_block=2), 2, 4),
}
# sampled engines, held to the port's one-process engine of the seed
SAMPLED = {
    "sampled-block": ("gpt", dict(decode_block=2, temperature=0.9,
                                  sample_seed=7), 4, 0),
    "sampled-speculative": ("gpt", dict(draft_layers=1, draft_tokens=2,
                                        temperature=0.9, sample_seed=5),
                            4, 0),
}
POOL = dict(tenants=("a", "b"), prefix_pool=4, prefix_len=4)
WORKER_ARGS = ["--model-parallel", "2", "--demo", "6", "--seq-len", "8",
               "--generate-tokens", "3", "--batch-size", "4",
               "--result-queue-url", "demo://replies"]
WORKERS = {
    "batch": [],
    "continuous": ["--continuous", "--decode-block", "2"],
}
# the worker over 2 ranks with /metrics on
METRICS_WORKER = ["--continuous", "--decode-block", "2"]
# the binary's other modes over the mesh, held to the port's one-process
# binary on the same flags, both serving the built-in models in f32 (their
# own seeded weights; the reference's binary draws others)
MODES = {
    "int8-weights-and-cache": ["--continuous", "--quantize", "int8",
                               "--quantize-kv", "--family", "llama"],
    "tenants-prefix-pool": ["--continuous", "--decode-block", "2",
                            "--tenants", "a,b", "--prefix-pool", "4"],
    "beams": ["--beams", "2"],
    "speculative": ["--speculative-draft-layers", "2",
                    "--speculative-draft-tokens", "2", "--prefix-ids",
                    "1,2,3"],
    "classify": ["--generate-tokens", "0"],
    "shards": ["--continuous", "--decode-block", "2", "--shards", "2"],
}
TRAIN = ["--device", "cpu", "--d-model", "64", "--n-heads", "4",
         "--n-layers", "2", "--d-ff", "128", "--vocab-size", "256",
         "--seq-len", "32", "--batch-size", "4", "--steps", "2",
         "--log-every", "1"]


def _knobs(family, knobs):
    knobs = dict(knobs, prompt_len=PROMPT, generate_tokens=TOKENS)
    if knobs.pop("prefix", False):
        knobs["prefix_cache"] = port_prefix(family,
                                            knobs.get("quantized_kv", False))
    return knobs


def pool_prefixes(n: int) -> list:
    rng = np.random.default_rng(9)
    return [(("a", "b")[i % 2],
             rng.integers(1, 90, POOL["prefix_len"]).astype(np.int32))
            for i in range(n)]


_tmp: list = []


@functools.lru_cache(maxsize=None)
def checkpoints() -> dict:
    """A checkpoint of each family that the port's trainer wrote (two
    steps of a small model), by family."""
    import tempfile

    from kube_sqs_autoscaler_tpu_torch.workloads import trainer

    _tmp.append(tempfile.TemporaryDirectory(prefix="serve-mesh-ckpt-"))
    out = {}
    for family in ("gpt", "llama"):
        path = f"{_tmp[0].name}/{family}"
        trainer.main([*TRAIN, "--family", family, "--checkpoint-dir", path])
        out[family] = path
    return out


@functools.lru_cache(maxsize=None)
def builtin_weights():
    """The reference binary's built-in weights at the workers' flags (its
    ``init_params(key(0))``, bf16), as the port's tree: both binaries
    serve the same model."""
    jcfg = jax_model.ModelConfig(vocab_size=8192, d_model=512, n_heads=8,
                                 n_layers=4, d_ff=2048, max_seq_len=64)
    params = jax.tree.map(np.asarray, jax_model.init_params(
        jax.random.key(0), jcfg))
    return params_from_jax(params, builtin_config(8, 3), "cpu")


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _engine_job(family, knobs, slots, shards) -> dict:
    _, _, tcfg, tp = weights(family)
    return dict(kind="batcher", tp=2, family=family, config=tcfg, params=tp,
                slots=slots, shards=shards, knobs=_knobs(family, knobs),
                requests=requests_of(family))


def _pool_job() -> dict:
    _, _, tcfg, tp = weights("gpt")
    return dict(kind="batcher", tp=2, family="gpt", config=tcfg, params=tp,
                slots=4, shards=0,
                knobs=dict(prompt_len=PROMPT, generate_tokens=TOKENS,
                           decode_block=2, tenancy=POOL),
                requests=requests_of("gpt"), prefixes=pool_prefixes(6))


_done: dict = {}


def port(name: str):
    """Every rank's result of job ``name`` (one rank call for all)."""
    if not _done:
        jobs, names = [], []
        for table in (ENGINES, SAMPLED):
            for engine, spec in table.items():
                jobs.append(_engine_job(*spec))
                names.append(engine)
        jobs.append(_pool_job())
        names.append("pool")
        for worker, extra in WORKERS.items():
            jobs.append(dict(kind="worker", params=builtin_weights(),
                             argv=["--device", "cpu", *WORKER_ARGS, *extra]))
            names.append(f"worker-{worker}")
        for mode, extra in MODES.items():
            jobs.append(dict(kind="worker", f32=True,
                             argv=["--device", "cpu", *WORKER_ARGS, *extra]))
            names.append(f"mode-{mode}")
        for family, ckpt in checkpoints().items():
            jobs.append(dict(kind="worker", argv=[
                "--device", "cpu", *WORKER_ARGS, "--checkpoint-dir", ckpt]))
            names.append(f"checkpoint-{family}")
        _, _, tcfg, tp = weights("gpt")
        jobs.append(dict(kind="refused_pools", config=tcfg, params=tp))
        names.append("refused-pools")
        results = run_ranks("serve", 4, {"jobs": jobs}, timeout=500)
        _done.update({key: [r[i] for r in results]
                      for i, key in enumerate(names)})
    return _done[name]


_done_two: dict = {}


def port_two(name: str):
    """Every rank's result of engine ``name`` over 2 ranks (tp 2, no data
    axis): the plane's gang step and the pooled insert, which the
    reference holds byte-identical across mesh sizes."""
    if not _done_two:
        jobs = [_engine_job(*ENGINES["plane"]), _pool_job(),
                dict(kind="worker", f32=True, argv=[
                    "--device", "cpu", *WORKER_ARGS, *METRICS_WORKER,
                    "--metrics-port", str(free_port())])]
        results = run_ranks("serve", 2, {"jobs": jobs}, timeout=300)
        _done_two.update({key: [r[i] for r in results] for i, key in
                          enumerate(("plane", "pool", "metrics"))})
    return _done_two[name]


def tokens_on_every_rank(results):
    first = results[0]["tokens"]
    for r in results[1:]:
        for a, b in zip(first, r["tokens"]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    return [np.asarray(t) for t in first]


def reference_engine(family, knobs, slots, shards):
    jcfg, jp, _, _ = weights(family)
    knobs = dict(knobs, prompt_len=PROMPT, generate_tokens=TOKENS)
    if knobs.pop("prefix", False):
        knobs["prefix_cache"] = jax_prefix(family,
                                           knobs.get("quantized_kv", False))
    if shards:
        batcher = jax_plane.ShardedBatcher(
            jp, jcfg, shards=shards, shard_slots=slots, family=family,
            mesh=jax_mesh(2), **knobs)
    else:
        batcher = jax_continuous.ContinuousBatcher(
            jp, jcfg, batch_size=slots, family=family, mesh=jax_mesh(2),
            **knobs)
    return drain_batcher(batcher, requests_of(family))


@pytest.mark.parametrize("name", list(ENGINES))
def test_mesh_engine_matches_the_reference_mesh_engine(name):
    family, knobs, slots, shards = ENGINES[name]
    results = port(name)
    got = tokens_on_every_rank(results)
    want = reference_engine(family, knobs, slots, shards)
    for i, tokens_i in enumerate(got):
        np.testing.assert_array_equal(tokens_i, np.asarray(want[i]))
    # the rank's cache (the reference's cache_shardings): its slots' rows
    # over data 2, its heads over model 2, every slot's length
    tcfg = weights(family)[2]
    rows = slots * max(shards, 1) * knobs.get("beams", 1)
    heads = tcfg.n_kv_heads if family == "llama" else tcfg.n_heads
    for r in results:
        assert (r["cache_rows"], r["lengths"]) == (rows // 2, rows)
        assert r["cache_heads"] == heads // 2


@pytest.mark.parametrize("name", list(SAMPLED))
def test_sampled_mesh_engine_draws_what_one_process_draws(name):
    family, knobs, slots, _ = SAMPLED[name]
    _, _, tcfg, tp = weights(family)
    one = continuous.ContinuousBatcher(tp, tcfg, batch_size=slots,
                                       device="cpu", **_knobs(family, knobs))
    want = drain(one, requests_of(family))
    got = tokens_on_every_rank(port(name))
    for i, tokens_i in enumerate(got):
        np.testing.assert_array_equal(tokens_i, np.asarray(want[i]))


def test_mesh_prefix_pool_matches_one_process_and_the_reference():
    _, _, tcfg, tp = weights("gpt")
    knobs = dict(prompt_len=PROMPT, generate_tokens=TOKENS, decode_block=2)
    one = continuous.ContinuousBatcher(
        tp, tcfg, batch_size=4, device="cpu",
        tenancy=tenancy.TenancyConfig(**POOL), **knobs)
    prefixes = pool_prefixes(6)
    want = drain(one, requests_of("gpt"), prefixes)
    got = tokens_on_every_rank(port("pool"))
    for i, tokens_i in enumerate(got):
        np.testing.assert_array_equal(tokens_i, np.asarray(want[i]))
    # the reference's pool on its mesh: each request alone, its prefix
    # joined to its prompt
    jcfg, jp, _, _ = weights("gpt")
    ref = jax_continuous.ContinuousBatcher(
        jp, jcfg, batch_size=4, family="gpt", mesh=jax_mesh(2),
        tenancy=jax_tenancy.TenancyConfig(**POOL), **knobs)
    rows = ref.submit_many_prefixed([
        (tenant, prefix, ids, i)
        for i, ((tenant, prefix), ids) in enumerate(
            zip(prefixes[:4], requests_of("gpt")[:4]))])
    assert len(rows) == 4
    results = {}
    for _ in range(50):
        results.update(dict(ref.step()))
        if ref.active == 0:
            break
    for i in range(4):
        np.testing.assert_array_equal(got[i], np.asarray(results[i]))


def capture_reference_replies(monkeypatch) -> list:
    """The reference binary's replies, in the order it sends them."""
    sent = []
    original = JaxQueue.send_message

    def send(self, url, body):
        if url == "demo://replies":
            sent.append(json.loads(body))
        return original(self, url, body)

    monkeypatch.setattr(JaxQueue, "send_message", send)
    return sent


@pytest.mark.parametrize("worker", list(WORKERS))
def test_mesh_worker_binary_serves_the_references_replies(worker,
                                                          monkeypatch):
    results = port(f"worker-{worker}")
    lead = results[0]
    assert lead["mesh"] == {"data": 2, "seq": 1, "model": 2}
    assert all(r["processed"] == 6 for r in results)
    # rank 0 alone answered, each body once
    assert len(lead["replies"]) == 6 and lead["duplicate_replies"] == 0
    assert all(r["replies"] == {} for r in results[1:])
    one = worker_summary(["--device", "cpu", *WORKER_ARGS[2:],
                          *WORKERS[worker]], builtin_weights())
    assert lead["replies"] == one["replies"]
    sent = capture_reference_replies(monkeypatch)
    jax.clear_caches()
    jax_binary.main([*WORKER_ARGS, *WORKERS[worker]])
    want = {reply["request_id"]: reply for reply in sent}
    assert lead["replies"] == want


def test_lone_process_model_parallel_is_a_usage_error(capsys):
    with pytest.raises(SystemExit) as err:
        binary(["--device", "cpu", "--demo", "2", "--model-parallel", "2"])
    assert err.value.code == 2
    assert ("--model-parallel 2 over 1 rank(s): 1 devices not divisible by "
            "model_parallel=2" in capsys.readouterr().err)


@pytest.mark.parametrize("extra", [[], ["--continuous"]],
                         ids=["batch", "continuous"])
def test_lone_process_model_parallel_one_serves_as_one_device(extra):
    # a one-rank mesh without a launcher: no process group, the same
    # replies as no mesh
    argv = [*WORKER_ARGS[2:], *extra]
    mesh = worker_summary(["--device", "cpu", "--model-parallel", "1",
                           *argv], None, True)
    assert mesh["mesh"] == {"data": 1, "seq": 1, "model": 1}
    assert mesh["replies"] == one_process_replies(argv, f32=True)


@pytest.mark.parametrize("make", ["WorkerPool", "ShardedWorkerPool"])
def test_fleet_pools_refuse_a_mesh_naming_their_item(make):
    # the pools serve over a mesh now (tests/test_torch_fleet_mesh.py);
    # what the mesh's engines refuse they refuse, in the reference's
    # words: slots, or the plane's shards, that do not divide over the
    # data axis
    got = port("refused-pools")[0][make]
    from kube_sqs_autoscaler_tpu.fleet import ShardedWorkerPool, WorkerPool

    jcfg, jp, _, _ = weights("gpt")
    service = jax_service(queue_url="q", batch_size=3, seq_len=4,
                          generate_tokens=2)
    with pytest.raises(ValueError) as want:
        if make == "WorkerPool":
            WorkerPool.serving(JaxQueue(), jp, jcfg, service, min=1, max=2,
                               mesh=jax_mesh(1))
        else:
            service.batch_size = 2
            ShardedWorkerPool.serving(JaxQueue(), jp, jcfg, service, min=1,
                                      max=3, shards=3, mesh=jax_mesh(1))
    assert got == str(want.value)


def one_process_replies(argv: list[str], f32: bool = False) -> dict:
    return worker_summary(["--device", "cpu", *argv], None, f32)["replies"]


@pytest.mark.parametrize("mode", list(MODES))
def test_mesh_worker_modes_serve_one_process_replies(mode):
    results = port(f"mode-{mode}")
    lead = results[0]
    assert all(r["processed"] == 6 for r in results)
    assert len(lead["replies"]) == 6 and lead["duplicate_replies"] == 0
    assert all(r["replies"] == {} for r in results[1:])
    assert lead["replies"] == one_process_replies(
        [*WORKER_ARGS[2:], *MODES[mode]], f32=True)


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_mesh_worker_serves_a_trained_checkpoint(family):
    # the trainer's checkpoint, restored whole on every rank and sliced:
    # the replies of one process serving it
    results = port(f"checkpoint-{family}")
    lead = results[0]
    assert len(lead["replies"]) == 6 and lead["duplicate_replies"] == 0
    assert lead["replies"] == one_process_replies(
        [*WORKER_ARGS[2:], "--checkpoint-dir", checkpoints()[family]])


def test_mesh_worker_serves_metrics_from_rank_zero_alone():
    # every rank is given the same --metrics-port: rank 0 alone binds it,
    # and the mesh serves one process's replies
    lead, other = port_two("metrics")
    assert (lead["metrics_served"], other["metrics_served"]) == (True, False)
    assert lead["processed"] == other["processed"] == 6
    assert lead["replies"] == one_process_replies(
        [*WORKER_ARGS[2:], *METRICS_WORKER], f32=True)


@pytest.mark.parametrize("name", ["plane", "pool"])
def test_gang_step_and_pooled_insert_byte_identical_across_mesh_sizes(name):
    # the reference's test_mesh_parity: the same tokens at dp 1 x tp 2
    # (2 ranks) and dp 2 x tp 2 (4 ranks)
    two = tokens_on_every_rank(port_two(name))
    four = tokens_on_every_rank(port(name))
    for a, b in zip(two, four):
        np.testing.assert_array_equal(a, b)
