"""The port's queue worker held against the JAX reference worker.

The same queue traffic goes through the reference ``QueueWorker`` and the
port's, in classify and in generate mode, f32 and greedy on the CPU: the
reply JSON must be byte-identical per request id and every input must be
deleted.  The traffic has short bodies (several length buckets), a
malformed body and a body with out-of-range ids.
"""

import json
import os
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kube_sqs_autoscaler_tpu.metrics.fake import FakeMessageQueue as JaxQueue
from kube_sqs_autoscaler_tpu.workloads import service as jax_service
from kube_sqs_autoscaler_tpu.workloads import worker as jax_worker
from kube_sqs_autoscaler_tpu_torch.metrics.fake import FakeMessageQueue
from kube_sqs_autoscaler_tpu_torch.workloads import service, worker
from kube_sqs_autoscaler_tpu_torch.workloads.__main__ import builtin_config
from kube_sqs_autoscaler_tpu_torch.workloads.model import ModelConfig

from .test_torch_model import DIMS, both_params, tokens

URL = "fake://jobs"
REPLIES = "fake://replies"


def traffic() -> list[str]:
    rng = np.random.default_rng(12)
    vocab = DIMS["vocab_size"]
    bodies = [
        json.dumps(rng.integers(0, vocab, n).tolist())
        for n in (3, 10, 20, 32, 40, 7, 16)
    ]
    bodies.insert(2, "not json at all")
    bodies.insert(5, json.dumps([vocab + 3, -1, 5, -vocab - 4]))
    return bodies


def serve(module, queue_cls, params, config, generate_tokens, **worker_kw):
    """Run ``traffic()`` through one worker; returns (replies by id as
    raw JSON strings, queue attributes after the run)."""
    jobs, replies = queue_cls(), queue_cls()
    for body in traffic():
        jobs.send_message(URL, body)
    svc = module.ServiceConfig(
        queue_url=URL, batch_size=4, seq_len=32,
        generate_tokens=generate_tokens, result_queue_url=REPLIES,
    )
    w = module.QueueWorker(jobs, params, config, svc, result_queue=replies,
                           **worker_kw)
    while w.run_once():
        pass
    raw = {}
    for message in replies.receive_messages(REPLIES, max_messages=100):
        raw[json.loads(message["Body"])["request_id"]] = message["Body"]
    return raw, jobs.get_queue_attributes(URL, ())


@pytest.mark.parametrize("generate_tokens", [0, 6])
def test_reply_bytes_identical_to_reference_worker(generate_tokens):
    jcfg, jp, tcfg, tp = both_params()
    want, _ = serve(jax_service, JaxQueue, jp, jcfg, generate_tokens)
    got, attrs = serve(service, FakeMessageQueue, tp, tcfg, generate_tokens,
                       device="cpu")
    assert len(got) == len(traffic())
    assert got == want
    assert attrs["ApproximateNumberOfMessages"] == "0"
    assert attrs["ApproximateNumberOfMessagesNotVisible"] == "0"
    assert json.loads(got["msg-3"]) == {"error": "malformed body",
                                        "request_id": "msg-3"}


def test_collect_replies_dedups_and_deletes():
    queue = FakeMessageQueue()
    for body in ('{"request_id": "a", "x": 1}', '{"request_id": "a"}',
                 "garbage", '{"request_id": "b"}'):
        queue.send_message(REPLIES, body)
    replies, duplicates = service.collect_replies(queue, REPLIES,
                                                  max_messages=2)
    assert set(replies) == {"a", "b"} and replies["a"]["x"] == 1
    assert duplicates == 1
    attrs = queue.get_queue_attributes(REPLIES, ())
    assert attrs["ApproximateNumberOfMessagesNotVisible"] == "0"


def test_host_helpers_match_reference():
    for body in ('[1, 2, 3]', 'nope', '"abc"', '[[1], [2]]', '7'):
        want = jax_service.parse_request_body(body)
        got = service.parse_request_body(body)
        assert (want is None) == (got is None)
        if want is not None:
            np.testing.assert_array_equal(got, want)
    assert service.build_token_reply([4, 9, 2, 9], 9) == \
        jax_service.build_token_reply([4, 9, 2, 9], 9)
    message = {"ReceiptHandle": "rh", "Attributes": {"SentTimestamp": "1500"}}
    assert service.request_id(message) == "rh"
    assert service.sent_epoch(message) == jax_service.sent_epoch(message)
    a, b = (next(service.sampling_keys(5, "cpu")) for _ in range(2))
    assert torch.equal(torch.rand(3, generator=a), torch.rand(3, generator=b))


def test_unported_options_raise_at_construction():
    with pytest.raises(ValueError, match="not yet ported"):
        service.ServiceConfig(queue_url=URL, quantized_kv=True)
    with pytest.raises(ValueError, match="not yet ported"):
        service.ServiceConfig(queue_url=URL, profile_dir="/tmp/trace")
    with pytest.raises(ValueError, match="top_k"):
        service.ServiceConfig(queue_url=URL, top_k=-1)


def test_worker_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    _, _, tcfg, tp = both_params()
    with pytest.raises(RuntimeError, match="no usable CUDA card"):
        service.QueueWorker(FakeMessageQueue(), tp, tcfg,
                            service.ServiceConfig(queue_url=URL))


class _Deployment:
    def __init__(self):
        self.replicas = 0

    def get(self, name):
        return self


def test_elastic_pool_follows_replicas_and_drains_the_queue():
    _, _, tcfg, tp = both_params()
    jobs = FakeMessageQueue()
    for ids in tokens(12, 16, seed=13):
        jobs.send_message(URL, json.dumps(ids.tolist()))
    api = _Deployment()
    pool = service.ElasticWorkerPool(api, "workers", lambda: service.QueueWorker(
        jobs, tp, tcfg,
        service.ServiceConfig(queue_url=URL, batch_size=4, seq_len=16,
                              idle_sleep_s=0.01),
        device="cpu",
    ))
    api.replicas = 2
    assert pool.reconcile() == 2
    try:
        for _ in range(500):
            if pool.processed >= 12:
                break
            time.sleep(0.01)
    finally:
        api.replicas = 0
        pool.reconcile()
        pool.stop_all()
    assert pool.processed == 12
    assert pool.workers == []
    attrs = jobs.get_queue_attributes(URL, ())
    assert attrs["ApproximateNumberOfMessages"] == "0"


def test_inference_worker_pool_matches_reference_worker():
    jcfg, jp, tcfg, tp = both_params()
    ids = tokens(2, 32, seed=14)
    want = jax_worker.InferenceWorker(jp, jcfg).process(
        jax_worker.WorkItem(jnp.asarray(ids)))
    pool = worker.WorkerPool(
        lambda: worker.InferenceWorker(tp, tcfg, device="cpu"), size=2)
    pool.start()
    try:
        pool.submit(worker.WorkItem(torch.from_numpy(ids), id=7))
        got = pool.results.get(timeout=60)
    finally:
        pool.stop()
    assert got.id == 7
    np.testing.assert_array_equal(got.next_tokens.numpy(),
                                  np.asarray(want.next_tokens))


def run_binary(*args):
    return subprocess.run(
        [sys.executable, "-m", "kube_sqs_autoscaler_tpu_torch.workloads",
         *args],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"},
    )


def test_binary_demo_on_cpu_exits_zero():
    out = run_binary("--demo", "4", "--seq-len", "16", "--device", "cpu",
                     "--result-queue-url", "demo://replies")
    assert out.returncode == 0, out.stderr
    assert "Processed 4 messages" in out.stderr
    assert "next_token" in out.stderr


def test_binary_defaults_to_cuda_and_never_runs_on_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = run_binary("--demo", "4", "--seq-len", "16")
    assert out.returncode != 0
    assert "no usable CUDA card" in out.stderr
    assert "Processed" not in out.stderr


def test_binary_builtin_config_matches_reference():
    assert builtin_config(512, 32) == ModelConfig(max_seq_len=544)
    assert builtin_config(16, 0).max_seq_len == 64
