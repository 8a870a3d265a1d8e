"""The port's controller binary closing the loop on port workers, end to
end on the CPU.

``python -m kube_sqs_autoscaler_tpu_torch`` runs as a child process
against the apiserver double of ``tests/test_kube_client.py`` (through a
JSON kubeconfig) and the SQS emulator of ``tests/test_torch_sqs.py``; in
this process an ``ElasticWorkerPool`` of CPU ``QueueWorker`` s at a tiny
width reconciles to the Deployment's replicas over the same wire.  The
first boot scales up and is killed with SIGKILL; the second boot, the same
command with ``--state-path``, answers ``/healthz`` 503 "rehydrating"
before its first tick and 200 after; the workers start, drain the queue,
and the controller scales back down to one replica.  Every message is
answered once.  The whole episode has its own 30 s budget.  A second test
runs the predictive and the learned controller against the same doubles,
30 s for both.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import torch

from kube_sqs_autoscaler_tpu_torch.metrics.sqs_aws import AwsSqsService
from kube_sqs_autoscaler_tpu_torch.obs.journal import read_journal_episodes
from kube_sqs_autoscaler_tpu_torch.scale.kube import (
    ClusterConfig,
    KubeDeploymentAPI,
)
from kube_sqs_autoscaler_tpu_torch.utils.sigv4 import Credentials
from kube_sqs_autoscaler_tpu_torch.workloads.model import (
    ModelConfig,
    init_params,
)
from kube_sqs_autoscaler_tpu_torch.workloads.service import (
    ElasticWorkerPool,
    QueueWorker,
    ServiceConfig,
)

from .httptestserver import LocalHttpServer
from .test_kube_client import FakeApiServer, deployment_body
from .test_torch_sqs import SqsEmulator, free_port

ROOT = Path(__file__).resolve().parents[1]
BUDGET_S = 30.0
BODIES = 60
ENV = {"AWS_ACCESS_KEY_ID": "AKIDTEST", "AWS_SECRET_ACCESS_KEY": "secret",
       "OMP_NUM_THREADS": "1"}


def status(url: str) -> tuple[int, str] | None:
    try:
        with urllib.request.urlopen(url, timeout=2) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as err:
        return err.code, err.read().decode()
    except OSError:
        return None  # not listening yet


def test_controller_scales_port_workers_through_a_restart(tmp_path):
    deadline = time.monotonic() + BUDGET_S

    def wait(predicate, every=0.01):
        while time.monotonic() < deadline:
            if predicate():
                return True
            time.sleep(every)
        return False

    api_double = FakeApiServer({"workers": deployment_body(
        name="workers", namespace="default", replicas=1)})
    emulator = SqsEmulator()
    children = []
    with LocalHttpServer(api_double) as apiserver, \
            LocalHttpServer(emulator) as sqs:
        jobs_url = f"{sqs.url}/000000000000/jobs"
        replies_url = f"{sqs.url}/000000000000/replies"
        jobs, replies = emulator.queue(jobs_url), emulator.queue(replies_url)
        sent = [jobs.send_message(jobs_url, json.dumps([i % 60, 3, 5, 7]))
                for i in range(BODIES)]
        kubeconfig = tmp_path / "kubeconfig.json"
        kubeconfig.write_text(json.dumps({
            "current-context": "c",
            "contexts": [{"name": "c",
                          "context": {"cluster": "d", "user": "u"}}],
            "clusters": [{"name": "d",
                          "cluster": {"server": apiserver.url}}],
            "users": [{"name": "u", "user": {"token": "t"}}]}))
        port = free_port()
        journal, state = tmp_path / "j.jsonl", tmp_path / "s.json"
        argv = [sys.executable, "-m", "kube_sqs_autoscaler_tpu_torch",
                # the first scale-up waits for the second tick, so the
                # first boot has snapshotted once before it is killed
                "--poll-period=1s", "--scale-up-cool-down=2s",
                "--scale-down-cool-down=1500ms", "--scale-up-messages=20",
                "--scale-down-messages=2", "--max-pods=3", "--min-pods=1",
                "--attribute-names=ApproximateNumberOfMessages",
                "--sqs-queue-url", jobs_url, "--aws-region", "us-east-1",
                "--kubernetes-deployment", "workers",
                "--kubernetes-namespace", "default",
                "--metrics-port", str(port), "--journal-path", str(journal),
                "--state-path", str(state)]
        env = {**os.environ, **ENV, "KUBE_CONFIG_PATH": str(kubeconfig)}

        def boot():
            child = subprocess.Popen(argv, cwd=ROOT, env=env,
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)
            children.append(child)
            return child

        def replicas():
            return api_double.deployments["workers"]["spec"]["replicas"]

        cfg = ModelConfig(vocab_size=64, d_model=64, n_heads=2, n_layers=2,
                          d_ff=128, max_seq_len=16, dtype=torch.float32)
        params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        creds = Credentials(ENV["AWS_ACCESS_KEY_ID"],
                            ENV["AWS_SECRET_ACCESS_KEY"])

        def worker():
            client = AwsSqsService(region="us-east-1", credentials=creds)
            return QueueWorker(client, params, cfg, ServiceConfig(
                queue_url=jobs_url, batch_size=4, seq_len=8,
                generate_tokens=3, result_queue_url=replies_url,
                idle_sleep_s=0.02), result_queue=client, device="cpu")

        pool = ElasticWorkerPool(KubeDeploymentAPI(
            "default", config=ClusterConfig(server=apiserver.url)),
            "workers", worker)
        seen, done = [], threading.Event()

        def kubelet():
            while not done.is_set():
                seen.append(pool.reconcile())
                done.wait(0.1)

        health = []
        try:
            first = boot()
            assert wait(lambda: replicas() >= 2), first.stdout
            first.kill()  # SIGKILL: nothing runs after this instant
            assert first.wait(10) == -9
            second = boot()

            def probe():
                answer = status(f"http://127.0.0.1:{port}/healthz")
                if answer is not None:
                    health.append(answer)
                return answer is not None and answer[0] == 200

            assert wait(probe)
            metrics = status(f"http://127.0.0.1:{port}/metrics")[1]
            thread = threading.Thread(target=kubelet, daemon=True)
            thread.start()
            assert wait(lambda: int(replies.get_queue_attributes(
                replies_url, ())["ApproximateNumberOfMessages"]) == BODIES
                and replicas() == 1 and seen[-1:] == [1], every=0.05), (
                replicas(), seen)
            done.set()
            thread.join(5)
            second.terminate()
            assert second.wait(10) == 0
        finally:
            done.set()
            for child in children:
                if child.poll() is None:
                    child.kill()
                child.wait(10)
            pool.stop_all()
        got = {}
        for message in replies.receive_messages(replies_url,
                                                max_messages=1000):
            rid = json.loads(message["Body"])["request_id"]
            got[rid] = got.get(rid, 0) + 1
        attrs = jobs.get_queue_attributes(jobs_url, ())

    assert time.monotonic() < deadline
    assert sorted(got) == sorted(sent) and set(got.values()) == {1}
    assert attrs["ApproximateNumberOfMessages"] == "0"
    assert attrs["ApproximateNumberOfMessagesNotVisible"] == "0"
    # the second boot answers before its first tick, a poll period later
    assert health[0][0] == 503 and health[0][1].startswith(
        "rehydrating"), health[:3]
    assert health[-1] == (200, "ok\n")
    assert "kube_sqs_autoscaler_controller_restarts_total 1\n" in metrics
    assert max(seen) >= 2 and seen[-1] == 1
    episodes = read_journal_episodes(str(journal))
    assert len(episodes) == 2 and "restart" in episodes[1][0]
    # the kill may land between the scale-up and its journal line; the
    # double saw the scale-up either way
    assert episodes[0][1]
    assert any(r.scaled("down") for r in episodes[1][1])


def test_predictive_and_learned_controllers_close_the_loop(tmp_path):
    """``--policy predictive --forecaster holt`` and ``--policy learned``
    with the repo's ``LEARNED_POLICY.json``, each a child on the CPU
    (``--device cpu``) against the same doubles: the predictive one
    forecasts past its warm-up and scales up, the learned one thresholds
    on its network's hold/up/down depths; both journal their policy
    block, label ``build_info`` with it and snapshot their durable
    section."""
    from kube_sqs_autoscaler_tpu_torch.learn import load_checkpoint

    deadline = time.monotonic() + BUDGET_S
    learned = load_checkpoint(str(ROOT / "LEARNED_POLICY.json"),
                              device="cpu")
    for policy, extra, section, label in (
            ("predictive", ["--forecaster", "holt",
                            "--forecast-horizon", "5s"],
             "forecast-history", 'policy="predictive"'),
            ("learned", ["--policy-checkpoint",
                         str(ROOT / "LEARNED_POLICY.json")],
             "learned-mirror", f'policy="learned@{learned.hash}"')):
        api_double = FakeApiServer({"workers": deployment_body(
            name="workers", namespace="default", replicas=1)})
        emulator = SqsEmulator()
        with LocalHttpServer(api_double) as apiserver, \
                LocalHttpServer(emulator) as sqs:
            jobs_url = f"{sqs.url}/000000000000/jobs"
            jobs = emulator.queue(jobs_url)
            for i in range(BODIES):
                jobs.send_message(jobs_url, json.dumps([i % 60, 3, 5, 7]))
            kubeconfig = tmp_path / f"{policy}.kubeconfig.json"
            kubeconfig.write_text(json.dumps({
                "current-context": "c",
                "contexts": [{"name": "c",
                              "context": {"cluster": "d", "user": "u"}}],
                "clusters": [{"name": "d",
                              "cluster": {"server": apiserver.url}}],
                "users": [{"name": "u", "user": {"token": "t"}}]}))
            port = free_port()
            journal = tmp_path / f"{policy}.jsonl"
            state = tmp_path / f"{policy}.state.json"
            child = subprocess.Popen(
                [sys.executable, "-m", "kube_sqs_autoscaler_tpu_torch",
                 "--poll-period=500ms", "--scale-up-cool-down=1s",
                 "--scale-down-cool-down=1s", "--scale-up-messages=20",
                 "--scale-down-messages=2", "--max-pods=3",
                 "--attribute-names=ApproximateNumberOfMessages",
                 "--sqs-queue-url", jobs_url, "--aws-region", "us-east-1",
                 "--kubernetes-deployment", "workers",
                 "--metrics-port", str(port), "--journal-path",
                 str(journal), "--state-path", str(state),
                 "--policy", policy, *extra, "--device", "cpu"],
                cwd=ROOT, env={**os.environ, **ENV,
                               "KUBE_CONFIG_PATH": str(kubeconfig)},
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            try:
                while time.monotonic() < deadline:
                    episodes = (read_journal_episodes(str(journal))
                                if journal.exists() else [])
                    ticks = episodes[0][1] if episodes else []
                    if len(ticks) >= 6:
                        break
                    time.sleep(0.05)
                metrics = status(f"http://127.0.0.1:{port}/metrics")[1]
                child.terminate()
                assert child.wait(10) == 0, child.stdout.read()
            finally:
                if child.poll() is None:
                    child.kill()
                child.wait(10)
        meta = episodes[0][0]
        assert meta["policy"] == policy and label in metrics
        assert section in json.loads(state.read_text())["sections"]
        replicas = api_double.deployments["workers"]["spec"]["replicas"]
        if policy == "predictive":
            assert meta["forecast"]["forecaster"] == "holt"
            assert any(r.predicted_messages is not None for r in ticks)
            assert replicas >= 2  # the backlog of 60 > 20 scaled it up
        else:
            assert meta["learn"]["checkpoint_hash"] == learned.hash
            warm = [r.decision_messages for r in ticks[3:]]
            assert set(warm) <= {20, 2, 11}  # up, down, hold depths
    assert time.monotonic() < deadline
