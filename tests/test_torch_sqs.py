"""The port's worker on a real queue protocol, held against the JAX package.

- SigV4 signing equals the reference's on fixed inputs;
- the wire checks of ``tests/test_sqs_client.py``, repeated for the port's
  ``AwsSqsService`` and ``QueueMetricSource`` against the local HTTP double
  (no network): attributes, message operations with ``SentTimestamp``,
  errors, region resolution and the credential chain;
- the worker binary with ``--device cpu --sqs-queue-url`` drains a local SQS
  emulator (the JSON protocol over the port's ``FakeMessageQueue``), its
  ``/metrics`` scrapes, and its reply JSON is byte-identical to the JAX
  ``ContinuousWorker``'s on the same traffic and weights;
- ``WorkloadMetrics.render()`` equals the reference registry's text for the
  same call sequence;
- ``maybe_trace`` (and the batch worker's ``profile_dir``) writes a trace.
"""

import json
import socket
import threading
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kube_sqs_autoscaler_tpu.metrics.fake import FakeMessageQueue as JaxQueue
from kube_sqs_autoscaler_tpu.obs.prometheus import (
    WorkloadMetrics as JaxWorkloadMetrics,
)
from kube_sqs_autoscaler_tpu.utils import profiling as jax_profiling
from kube_sqs_autoscaler_tpu.utils import sigv4 as jax_sigv4
from kube_sqs_autoscaler_tpu.workloads import continuous as jax_continuous
from kube_sqs_autoscaler_tpu.workloads import model as jax_model
from kube_sqs_autoscaler_tpu.workloads import service as jax_service
from kube_sqs_autoscaler_tpu_torch.core.types import MetricError
from kube_sqs_autoscaler_tpu_torch.metrics.fake import FakeMessageQueue
from kube_sqs_autoscaler_tpu_torch.metrics.queue import QueueMetricSource
from kube_sqs_autoscaler_tpu_torch.metrics.sqs_aws import (
    AwsError,
    AwsSqsService,
    CredentialsError,
    region_from_queue_url,
    resolve_credentials,
)
from kube_sqs_autoscaler_tpu_torch.obs.prometheus import WorkloadMetrics
from kube_sqs_autoscaler_tpu_torch.utils import profiling, sigv4
from kube_sqs_autoscaler_tpu_torch.utils.sigv4 import Credentials
from kube_sqs_autoscaler_tpu_torch.workloads import __main__ as binary
from kube_sqs_autoscaler_tpu_torch.workloads import continuous, service
from kube_sqs_autoscaler_tpu_torch.workloads.model import init_params

from .httptestserver import LocalHttpServer, Reply

CREDS = Credentials("AKIDTEST", "secret")


# ---------------------------------------------------------------------------
# SigV4
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("url,token", [
    ("https://sqs.us-east-1.amazonaws.com/", None),
    ("https://sqs.eu-west-2.amazonaws.com/1/q?b=2&a=x+y%2F", "tok"),
])
def test_sign_request_equals_the_reference(url, token):
    body = b'{"QueueUrl": "q", "AttributeNames": ["A"]}'
    headers = {"Content-Type": "application/x-amz-json-1.0",
               "X-Amz-Target": "AmazonSQS.GetQueueAttributes"}
    signed = [
        module.sign_request(
            module.SignableRequest("POST", url, dict(headers), body),
            module.Credentials("AKIDTEST", "s3cret", token),
            "us-east-1", "sqs", "20260729T120000Z",
        )
        for module in (sigv4, jax_sigv4)
    ]
    assert signed[0].headers == signed[1].headers
    assert (signed[0].url, signed[0].body) == (signed[1].url, signed[1].body)
    assert "Signature=" in signed[0].headers["Authorization"]


# ---------------------------------------------------------------------------
# The wire checks of tests/test_sqs_client.py, on the port's client
# ---------------------------------------------------------------------------


def test_get_queue_attributes_roundtrip():
    def handler(exchange):
        body = json.loads(exchange.body)
        assert body["QueueUrl"].endswith("/123/my-queue")
        assert body["AttributeNames"] == ["ApproximateNumberOfMessages"]
        return Reply.json({"Attributes": {"ApproximateNumberOfMessages": "42"}})

    with LocalHttpServer(handler) as server:
        client = AwsSqsService(
            region="us-east-1", credentials=CREDS, endpoint=server.url
        )
        attributes = client.get_queue_attributes(
            f"{server.url}/123/my-queue", ["ApproximateNumberOfMessages"]
        )
    assert attributes == {"ApproximateNumberOfMessages": "42"}
    exchange = server.exchanges[0]
    assert exchange.method == "POST"
    assert exchange.headers["X-Amz-Target"] == "AmazonSQS.GetQueueAttributes"
    assert exchange.headers["Content-Type"] == "application/x-amz-json-1.0"
    auth = exchange.headers["Authorization"]
    assert auth.startswith("AWS4-HMAC-SHA256 Credential=AKIDTEST/")
    assert "/us-east-1/sqs/aws4_request" in auth
    assert "x-amz-date" in auth


@pytest.mark.parametrize("status,want", [(200, 30), (400, None)],
                         ids=["sums", "service-error"])
def test_metric_source_over_http(status, want):
    # QueueMetricSource -> AwsSqsService -> HTTP -> the sum, or a service
    # error surfacing as MetricError
    def handler(exchange):
        if status != 200:
            return Reply.json(
                {"__type": "com.amazonaws.sqs#QueueDoesNotExist"},
                status=status,
            )
        return Reply.json({"Attributes": {
            "ApproximateNumberOfMessages": "10",
            "ApproximateNumberOfMessagesDelayed": "10",
            "ApproximateNumberOfMessagesNotVisible": "10",
        }})

    with LocalHttpServer(handler) as server:
        source = QueueMetricSource(
            client=AwsSqsService(
                region="us-east-1", credentials=CREDS, endpoint=server.url
            ),
            queue_url=f"{server.url}/123/q",
        )
        if want is None:
            with pytest.raises(MetricError,
                               match="Failed to get messages in SQS"):
                source.num_messages()
        else:
            assert source.num_messages() == want


def test_message_operations_roundtrip():
    state = {"deleted": [], "visibility": []}

    def handler(exchange):
        target = exchange.headers["X-Amz-Target"]
        body = json.loads(exchange.body)
        if target == "AmazonSQS.SendMessage":
            assert body["MessageBody"] == "[1, 2, 3]"
            return Reply.json({"MessageId": "m-1"})
        if target == "AmazonSQS.ReceiveMessage":
            assert 1 <= body["MaxNumberOfMessages"] <= 10  # SQS hard limit
            assert body["AttributeNames"] == ["SentTimestamp"]
            return Reply.json({"Messages": [
                {"ReceiptHandle": "rh-1", "Body": "[1, 2, 3]",
                 "Attributes": {"SentTimestamp": "1700000000000"}},
                {"ReceiptHandle": "rh-2", "Body": "[4]"},
            ]})
        if target == "AmazonSQS.DeleteMessage":
            state["deleted"].append(body["ReceiptHandle"])
            return Reply.json({})
        if target == "AmazonSQS.ChangeMessageVisibility":
            state["visibility"].append(
                (body["ReceiptHandle"], body["VisibilityTimeout"])
            )
            return Reply.json({})
        raise AssertionError(f"unexpected target {target}")

    with LocalHttpServer(handler) as server:
        client = AwsSqsService(
            region="us-east-1", credentials=CREDS, endpoint=server.url
        )
        url = f"{server.url}/123/q"
        assert client.send_message(url, "[1, 2, 3]") == "m-1"
        messages = client.receive_messages(url, max_messages=16)  # clamped
        assert messages == [
            {"MessageId": "", "ReceiptHandle": "rh-1", "Body": "[1, 2, 3]",
             "Attributes": {"SentTimestamp": "1700000000000"}},
            {"MessageId": "", "ReceiptHandle": "rh-2", "Body": "[4]"},
        ]
        assert service.sent_epoch(messages[0]) == 1700000000.0
        client.delete_message(url, "rh-1")
        client.change_message_visibility(url, "rh-2", 0)
    assert state["deleted"] == ["rh-1"]
    assert state["visibility"] == [("rh-2", 0)]
    for exchange in server.exchanges:
        assert exchange.headers["Authorization"].startswith("AWS4-HMAC-SHA256")


def test_transport_error_is_aws_error():
    client = AwsSqsService(
        region="us-east-1", credentials=CREDS, endpoint="http://127.0.0.1:1",
        timeout=0.5,
    )
    with pytest.raises(AwsError, match="request failed"):
        client.get_queue_attributes("http://127.0.0.1:1/q", ["A"])


def test_region_resolution(monkeypatch):
    assert region_from_queue_url(
        "https://sqs.eu-west-2.amazonaws.com/1/q") == "eu-west-2"
    assert region_from_queue_url("http://127.0.0.1:999/1/q") is None
    monkeypatch.setenv("AWS_REGION", "ap-south-1")
    assert AwsSqsService(credentials=CREDS)._resolve_region(
        "http://host/q") == "ap-south-1"
    monkeypatch.delenv("AWS_REGION")
    monkeypatch.delenv("AWS_DEFAULT_REGION", raising=False)
    assert AwsSqsService(credentials=CREDS)._resolve_region(
        "https://sqs.us-west-2.amazonaws.com/1/q") == "us-west-2"
    with pytest.raises(AwsError, match="Cannot determine AWS region"):
        AwsSqsService(credentials=CREDS)._resolve_region("http://host/q")


def test_credential_chain(monkeypatch, tmp_path):
    monkeypatch.setenv("AWS_ACCESS_KEY_ID", "AKIDENV")
    monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", "s3cret")
    monkeypatch.setenv("AWS_SESSION_TOKEN", "tok")
    assert resolve_credentials(allow_imds=False) == Credentials(
        "AKIDENV", "s3cret", "tok")
    monkeypatch.delenv("AWS_ACCESS_KEY_ID")
    monkeypatch.delenv("AWS_SECRET_ACCESS_KEY")
    creds_file = tmp_path / "credentials"
    creds_file.write_text(
        "[default]\naws_access_key_id = AKIDFILE\n"
        "aws_secret_access_key = filesecret\n\n"
        "[other]\naws_access_key_id = AKIDOTHER\n"
        "aws_secret_access_key = othersecret\n"
    )
    monkeypatch.setenv("AWS_SHARED_CREDENTIALS_FILE", str(creds_file))
    monkeypatch.delenv("AWS_PROFILE", raising=False)
    assert resolve_credentials(allow_imds=False).access_key_id == "AKIDFILE"
    monkeypatch.setenv("AWS_PROFILE", "other")
    assert resolve_credentials(allow_imds=False).access_key_id == "AKIDOTHER"
    monkeypatch.setenv("AWS_SHARED_CREDENTIALS_FILE", str(tmp_path / "none"))
    with pytest.raises(CredentialsError):
        resolve_credentials(allow_imds=False)


# ---------------------------------------------------------------------------
# The worker binary against a local SQS emulator
# ---------------------------------------------------------------------------


class SqsEmulator:
    """The SQS JSON protocol over the port's ``FakeMessageQueue``, one
    queue per ``QueueUrl``; a receive returns up to
    ``MaxNumberOfMessages`` and ignores ``WaitTimeSeconds``."""

    def __init__(self):
        self.queues: dict[str, FakeMessageQueue] = {}

    def queue(self, url: str) -> FakeMessageQueue:
        return self.queues.setdefault(url, FakeMessageQueue())

    def __call__(self, exchange):
        action = exchange.headers["X-Amz-Target"].removeprefix("AmazonSQS.")
        body = json.loads(exchange.body)
        queue = self.queue(body["QueueUrl"])
        url = body["QueueUrl"]
        if action == "SendMessage":
            return Reply.json(
                {"MessageId": queue.send_message(url, body["MessageBody"])})
        if action == "ReceiveMessage":
            return Reply.json({"Messages": queue.receive_messages(
                url, max_messages=body["MaxNumberOfMessages"])})
        if action == "DeleteMessage":
            queue.delete_message(url, body["ReceiptHandle"])
        elif action == "ChangeMessageVisibility":
            queue.change_message_visibility(
                url, body["ReceiptHandle"], body["VisibilityTimeout"])
        elif action == "GetQueueAttributes":
            return Reply.json({"Attributes": queue.get_queue_attributes(
                url, body["AttributeNames"])})
        else:
            return Reply.json({"__type": "InvalidAction"}, status=400)
        return Reply.json({})


def sqs_traffic() -> list[str]:
    rng = np.random.default_rng(21)
    bodies = [json.dumps(rng.integers(0, 8192, n).tolist())
              for n in (3, 8, 12, 5, 1)]
    bodies.insert(2, "not json at all")
    return bodies


def f32_builtin_config(seq_len, generate_tokens):
    # the binary's built-in GPT in f32, so the comparison with the JAX
    # worker is exact up to summation order (bf16 rounds at different
    # places in the two frameworks)
    return binary.ModelConfig(
        vocab_size=8192, d_model=512, n_heads=8, n_layers=4, d_ff=2048,
        max_seq_len=max(64, seq_len + generate_tokens), dtype=torch.float32,
    )


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


SVC = dict(batch_size=2, seq_len=8, generate_tokens=3, decode_block=2)


def reference_replies(params: dict) -> dict:
    """The JAX ContinuousWorker's raw reply JSON by request id, on the
    same traffic and weights."""
    jcfg = jax_model.ModelConfig(**{
        k: getattr(f32_builtin_config(8, 3), k) for k in (
            "vocab_size", "d_model", "n_heads", "n_layers", "d_ff",
            "max_seq_len")}, dtype=jnp.float32)
    jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), params)
    jobs, replies = JaxQueue(), JaxQueue()
    for body in sqs_traffic():
        jobs.send_message("q", body)
    worker = jax_continuous.ContinuousWorker(
        jobs, jp, jcfg,
        jax_service.ServiceConfig(queue_url="q", result_queue_url="r", **SVC),
        result_queue=replies)
    worker.drain(total=len(sqs_traffic()))
    return {json.loads(m["Body"])["request_id"]: m["Body"]
            for m in replies.receive_messages("r", max_messages=100)}


def test_binary_drains_sqs_and_replies_like_the_reference(monkeypatch):
    monkeypatch.setenv("AWS_ACCESS_KEY_ID", "AKIDTEST")
    monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", "secret")
    monkeypatch.setattr(binary, "builtin_config", f32_builtin_config)
    started = []

    class Recorded(continuous.ContinuousWorker):
        def run_forever(self):
            started.append(self)
            super().run_forever()

    monkeypatch.setattr(binary, "ContinuousWorker", Recorded)
    emulator = SqsEmulator()
    port = free_port()
    with LocalHttpServer(emulator) as server:
        jobs_url = f"{server.url}/000000000000/q"
        replies_url = f"{server.url}/000000000000/replies"
        jobs, replies = emulator.queue(jobs_url), emulator.queue(replies_url)
        for body in sqs_traffic():
            jobs.send_message(jobs_url, body)
        thread = threading.Thread(target=binary.main, args=([
            "--sqs-queue-url", jobs_url, "--aws-region", "us-east-1",
            "--continuous", "--batch-size", "2", "--seq-len", "8",
            "--generate-tokens", "3", "--decode-block", "2",
            "--result-queue-url", replies_url, "--metrics-port", str(port),
            "--device", "cpu"],), daemon=True)
        thread.start()
        try:
            deadline = time.monotonic() + 120
            while time.monotonic() < deadline:
                attrs = jobs.get_queue_attributes(jobs_url, ())
                if (attrs["ApproximateNumberOfMessages"] == "0"
                        and attrs["ApproximateNumberOfMessagesNotVisible"]
                        == "0" and started):
                    break
                time.sleep(0.05)
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/metrics", timeout=10) as resp:
                scrape = resp.read().decode()
        finally:
            for worker in started:
                worker.stop()
            thread.join(timeout=30)
        assert not thread.is_alive()
        got = {json.loads(m["Body"])["request_id"]: m["Body"]
               for m in replies.receive_messages(replies_url,
                                                 max_messages=100)}
    assert attrs["ApproximateNumberOfMessages"] == "0"
    assert attrs["ApproximateNumberOfMessagesNotVisible"] == "0"
    assert len(got) == len(sqs_traffic())
    params = init_params(f32_builtin_config(8, 3),
                         torch.Generator().manual_seed(0), "cpu")
    assert got == reference_replies(params)
    assert json.loads(got["msg-3"]) == {"error": "malformed body",
                                        "request_id": "msg-3"}
    for family in ("tokens_per_second", "time_to_first_token_seconds",
                   "active_slots", 'ttft_seconds_bucket{le="+Inf"} 5',
                   "worker_cycle_seconds_count"):
        assert f"kube_sqs_autoscaler_workload_{family}" in scrape


# ---------------------------------------------------------------------------
# The registry and the profiler
# ---------------------------------------------------------------------------


class _Ticks:
    """A monotonic clock that advances 1 ms, 3 ms, 5 ms ... per read."""

    def __init__(self):
        self.now, self.step = 0.0, 0.001

    def monotonic(self):
        self.now += self.step
        self.step += 0.002
        return self.now


def test_workload_metrics_render_equals_the_reference():
    texts = []
    for registry_cls, timer_cls in (
            (WorkloadMetrics, profiling.SpanTimer),
            (JaxWorkloadMetrics, jax_profiling.SpanTimer)):
        metrics = registry_cls()
        assert not metrics.ready
        timer = timer_cls(clock=_Ticks())
        for _ in range(5):
            with timer.span("cycle"):
                pass
        metrics.attach_timer("worker", timer)
        metrics.set_serving_gauges(
            tokens_per_second=123.5, time_to_first_token_seconds=0.0125,
            active_slots=3, decode_block_utilization=0.75)
        metrics.set_gauge("requests_shed_total", 2, "shed\nhelp\\",
                          kind="counter")
        metrics.set_gauge("requests_shed_total", 2, "shed\nhelp\\",
                          labels=(("reason", "ttl"),), kind="counter")
        for replica in ("1", "0"):
            metrics.set_gauge("fleet_replica_state", 1, "state",
                              labels=(("replica", replica),))
        for seconds in (0.0004, 0.02, 0.3, 7.0, 100.0):
            metrics.observe_histogram("ttft_seconds", seconds, "ttft")
        metrics.observe_histogram("phase_seconds", 0.5, "phase",
                                  labels=(("phase", 'a"b'),),
                                  buckets=(0.1, 1.0))
        metrics.set_build_info("0.6", knobs="none", scheduler=0)
        assert metrics.ready
        texts.append((metrics.render(),
                      [metrics.histogram_quantile("ttft_seconds", q)
                       for q in (0.5, 0.99)]))
    assert texts[0] == texts[1]
    assert texts[0][1] == [0.025, 60.0]


def test_maybe_trace_and_profile_dir_write_traces(tmp_path):
    with profiling.maybe_trace(None):  # off: a no-op
        pass
    with profiling.maybe_trace(str(tmp_path / "direct"), "cpu"):
        torch.ones(4).add_(1)
    (trace,) = (tmp_path / "direct").glob("trace-*.json")
    assert "traceEvents" in json.loads(trace.read_text())
    # the batch worker traces its first profile_cycles cycles
    tcfg = binary.ModelConfig(vocab_size=64, d_model=32, n_heads=2,
                              n_layers=1, d_ff=64, max_seq_len=16,
                              dtype=torch.float32)
    tp = init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    jobs = FakeMessageQueue()
    for _ in range(3):
        jobs.send_message("q", json.dumps([1, 2, 3]))
    worker = service.QueueWorker(
        jobs, tp, tcfg,
        service.ServiceConfig(queue_url="q", batch_size=1, seq_len=8,
                              idle_sleep_s=0.01,
                              profile_dir=str(tmp_path / "worker"),
                              profile_cycles=2),
        device="cpu")
    thread = threading.Thread(target=worker.run_forever, daemon=True)
    thread.start()
    try:
        deadline = time.monotonic() + 60
        while worker.processed < 3 and time.monotonic() < deadline:
            time.sleep(0.02)
    finally:
        worker.stop()
        thread.join(timeout=30)
    assert worker.processed == 3 and not thread.is_alive()
    (trace,) = (tmp_path / "worker").glob("trace-*.json")
    names = {e.get("name", "") for e in
             json.loads(trace.read_text())["traceEvents"]}
    assert any(name.startswith("aten::") for name in names)
