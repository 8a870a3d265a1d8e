"""The port's ``scale/`` package, held against the JAX package's.

- ``PodAutoScaler`` over ``FakeDeploymentAPI``: the same replica
  sequences, errors and call counts for the same operations;
- ``KubeDeploymentAPI`` against the local apiserver double of
  ``tests/test_kube_client.py``: the same requests on the wire and the
  same answers, kubeconfig resolution (YAML, and JSON where PyYAML is
  absent), the in-cluster path and the reference's panic message;
- ``tests/test_actuator_contract.py``'s contract for the port's
  ``PodAutoScaler``, ``WorkerPool`` and ``ShardedWorkerPool``, through the
  port's ``ControlLoop``, identical to the reference's ``PodAutoScaler``
  through the reference's loop.
"""

from __future__ import annotations

import json
import sys

import pytest

from kube_sqs_autoscaler_tpu.core.clock import FakeClock as RefClock
from kube_sqs_autoscaler_tpu.core.loop import ControlLoop as RefLoop
from kube_sqs_autoscaler_tpu.core.loop import LoopConfig as RefLoopConfig
from kube_sqs_autoscaler_tpu.core.policy import PolicyConfig as RefPolicy
from kube_sqs_autoscaler_tpu.scale import actuator as ref_actuator
from kube_sqs_autoscaler_tpu.scale import fake as ref_fake
from kube_sqs_autoscaler_tpu.scale import kube as ref_kube
from kube_sqs_autoscaler_tpu.scale import objects as ref_objects
from kube_sqs_autoscaler_tpu_torch.core.clock import FakeClock
from kube_sqs_autoscaler_tpu_torch.core.loop import ControlLoop, LoopConfig
from kube_sqs_autoscaler_tpu_torch.core.policy import Gate, PolicyConfig
from kube_sqs_autoscaler_tpu_torch.core.types import ScaleError, Scaler
from kube_sqs_autoscaler_tpu_torch.fleet import ShardedWorkerPool, WorkerPool
from kube_sqs_autoscaler_tpu_torch.scale import actuator, fake, kube, objects

from .httptestserver import LocalHttpServer
from .test_kube_client import FakeApiServer, deployment_body
from .test_torch_fleet import _Scripted, _StubShardedWorker, _StubWorker

PAIRS = {"ref": (ref_actuator, ref_fake, ref_objects, ref_kube),
         "port": (actuator, fake, objects, kube)}

# (operation, ...) scripts over a scaler of (max, min, initial, up, down)
SCRIPTS = {
    "up-to-max": ((5, 1, 3, 1, 1), ["up", "up", "up"]),
    "up-step-clamps": ((10, 1, 3, 5, 5), ["up", "up", "up"]),
    "down-to-min": ((5, 1, 3, 1, 1), ["down", "down", "down"]),
    "down-step-clamps": ((10, 1, 8, 5, 5), ["down", "down"]),
    "above-max": ((5, 1, 9, 1, 1), ["up", "down", "down"]),
    "below-min": ((5, 3, 1, 1, 1), ["down", "up"]),
    "get-fails": ((5, 1, 3, 1, 1), ["fail-get", "up", "fail-get", "down"]),
    "update-fails": ((5, 1, 3, 1, 1), ["fail-update", "up", "up"]),
    "ghost": ((5, 1, 3, 1, 1), ["ghost-up", "ghost-down"]),
}


def run_script(pair, name):
    act, fk, _, _ = pair
    (max_, min_, init, up, down), ops = SCRIPTS[name]
    api = fk.FakeDeploymentAPI.with_deployments("ns", init, "deploy",
                                                "control")
    trace = []
    for op in ops:
        target = "ghost" if op.startswith("ghost") else "deploy"
        scaler = act.PodAutoScaler(client=api, max=max_, min=min_,
                                   scale_up_pods=up, scale_down_pods=down,
                                   deployment=target, namespace="ns")
        if op == "fail-get":
            api.fail_next_get = ConnectionError("apiserver down")
            op = "up"
        elif op == "fail-update":
            api.fail_next_update = ConnectionError("conflict")
            op = "up"
        try:
            getattr(scaler, f"scale_{op.removeprefix('ghost-')}")()
            outcome = "ok"
        except Exception as err:
            outcome = (type(err).__name__, str(err), str(err.__cause__))
        trace.append((outcome, api.replicas("deploy"),
                      api.replicas("control"), api.get_calls,
                      api.update_calls))
    return trace


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_actuator_matches_reference(name):
    assert run_script(PAIRS["port"], name) == run_script(PAIRS["ref"], name)


def test_port_scale_errors_are_the_ports():
    api = fake.FakeDeploymentAPI.with_deployments("ns", 1, "d")
    scaler = actuator.PodAutoScaler(client=api, max=3, min=1,
                                    scale_up_pods=1, scale_down_pods=1,
                                    deployment="x", namespace="ns")
    with pytest.raises(ScaleError, match="no scale up occurred"):
        scaler.scale_up()
    assert isinstance(scaler, Scaler)


def test_objects_and_fake_match_reference():
    raw = deployment_body(replicas=4)
    out = []
    for _, fk, obj, _ in PAIRS.values():
        d = obj.Deployment.from_raw(raw)
        moved = d.with_replicas(6)
        clone = d.clone()
        clone.raw["spec"]["replicas"] = 99
        api = fk.FakeDeploymentAPI("prod", [d])
        got = api.get("workers")
        got.raw["metadata"]["x"] = 1  # copies out: the store is untouched
        api.update(moved)
        out.append((d.name, d.namespace, d.replicas, moved.raw, d.raw,
                    api.replicas("workers"), api.get("workers").raw))
        with pytest.raises(fk.NotFoundError):
            api.get("ghost")
    assert out[0] == out[1]
    assert objects.Deployment.from_raw({}).replicas == 1


def test_recording_api_matches_reference():
    out = []
    for (_, fk, _, _), clock in zip(PAIRS.values(), (RefClock(), FakeClock())):
        api = fk.RecordingDeploymentAPI(
            fk.FakeDeploymentAPI.with_deployments("ns", 1, "d"), clock)
        d = api.get("d")
        clock.advance(2.0)
        api.update(d.with_replicas(2))
        api.fail = True
        clock.advance(1.0)
        with pytest.raises(RuntimeError):
            api.update(d.with_replicas(3))
        out.append((api.scale_times, api.update_attempts))
    assert out[0] == out[1] == ([(2.0, 2)], [2.0, 3.0])


# ---------------------------------------------------------------------------
# KubeDeploymentAPI on the wire
# ---------------------------------------------------------------------------


def wire_session(module):
    """One scripted session against the apiserver double: requests seen
    and answers (or errors) returned."""
    fake_server = FakeApiServer({"workers": deployment_body(replicas=3)})
    answers = []
    with LocalHttpServer(fake_server) as server:
        api = module.KubeDeploymentAPI(
            namespace="prod",
            config=module.ClusterConfig(server=server.url, token="tok-abc"))
        scaler = (ref_actuator if module is ref_kube else actuator) \
            .PodAutoScaler(client=api, max=5, min=1, scale_up_pods=1,
                           scale_down_pods=1, deployment="workers",
                           namespace="prod")
        for op in ("up", "up", "up", "down"):
            getattr(scaler, f"scale_{op}")()
            answers.append(api.get("workers").replicas)
        try:
            api.get("ghost")
        except module.KubeApiError as err:
            answers.append((err.status, str(err).replace(server.url, "URL")))
    exchanges = [(e.method, e.path, e.headers.get("Authorization"),
                  json.loads(e.body) if e.body else None)
                 for e in server.exchanges]
    return answers, exchanges, fake_server.deployments


def test_kube_client_on_the_wire_matches_reference():
    ref, port = wire_session(ref_kube), wire_session(kube)
    assert port == ref
    answers, exchanges, store = port
    assert answers[:4] == [4, 5, 5, 4]
    assert answers[4][0] == 404
    assert [m for m, *_ in exchanges].count("PUT") == 3
    assert all(auth == "Bearer tok-abc" for _, _, auth, _ in exchanges)
    assert store["workers"]["metadata"]["resourceVersion"] == "100"


def test_transport_error_is_a_kube_api_error():
    api = kube.KubeDeploymentAPI(
        namespace="prod", config=kube.ClusterConfig(server="http://127.0.0.1:1"),
        timeout=0.5)
    with pytest.raises(kube.KubeApiError, match="failed"):
        api.get("workers")


KUBECONFIG = {
    "apiVersion": "v1", "kind": "Config", "current-context": "prod-ctx",
    "contexts": [
        {"name": "prod-ctx",
         "context": {"cluster": "prod-cluster", "user": "prod-user"}},
        {"name": "other", "context": {"cluster": "o", "user": "o"}}],
    "clusters": [
        {"name": "prod-cluster",
         "cluster": {"server": "https://10.0.0.1:6443/",
                     "insecure-skip-tls-verify": True}},
        {"name": "o", "cluster": {"server": "https://10.9.9.9:6443"}}],
    "users": [{"name": "prod-user", "user": {"token": "sekrit"}},
              {"name": "o", "user": {}}],
}


@pytest.mark.parametrize("yaml_present", [True, False],
                         ids=["yaml", "json-fallback"])
def test_kubeconfig_matches_reference(tmp_path, monkeypatch, yaml_present):
    path = tmp_path / "kubeconfig"
    path.write_text(json.dumps(KUBECONFIG))
    if not yaml_present:
        monkeypatch.setitem(sys.modules, "yaml", None)
    got = [vars(module.load_kubeconfig(path)) for module in (ref_kube, kube)]
    assert got[0] == got[1]
    assert got[1]["server"] == "https://10.0.0.1:6443"
    assert got[1]["token"] == "sekrit" and got[1]["skip_tls_verify"]


@pytest.mark.parametrize("text", ["not: [valid", "[1, 2]", "{}"])
def test_bad_kubeconfig_panics_like_reference(tmp_path, monkeypatch, text):
    path = tmp_path / "kubeconfig"
    path.write_text(text)
    for module in (ref_kube, kube):
        with pytest.raises(module.KubeConfigError,
                           match="Failed to configure incluster or local "
                                 "config"):
            module.load_kubeconfig(path)


def test_config_resolution_matches_reference(tmp_path, monkeypatch):
    path = tmp_path / "kubeconfig"
    path.write_text(json.dumps(KUBECONFIG))
    monkeypatch.setenv("KUBE_CONFIG_PATH", str(path))
    assert vars(kube.load_config()) == vars(ref_kube.load_config())
    monkeypatch.setenv("KUBE_CONFIG_PATH", "/does/not/exist")
    with pytest.raises(kube.KubeConfigError,
                       match="Failed to configure incluster or local config"):
        kube.load_config()
    monkeypatch.delenv("KUBE_CONFIG_PATH")
    monkeypatch.delenv("KUBERNETES_SERVICE_HOST", raising=False)
    with pytest.raises(kube.KubeConfigError,
                       match="Failed to configure incluster or local config"):
        kube.KubeDeploymentAPI(namespace="default")
    # in-cluster: the service account's token (re-read per request) and CA
    account = tmp_path / "sa"
    account.mkdir()
    (account / "token").write_text("tok-1\n")
    monkeypatch.setattr(kube, "SERVICE_ACCOUNT_DIR", account)
    monkeypatch.setenv("KUBERNETES_SERVICE_HOST", "10.1.2.3")
    config = kube.load_config()
    assert config.server == "https://10.1.2.3:443"
    (account / "token").write_text("tok-2\n")
    assert config.bearer_token() == "tok-2" and config.ca_cert_path is None


# ---------------------------------------------------------------------------
# The Scaler contract (tests/test_actuator_contract.py) for the port's
# three actuators
# ---------------------------------------------------------------------------


def make_pod(initial, min_, max_, up=1, down=1):
    api = fake.FakeDeploymentAPI.with_deployments("ns", initial, "deploy")
    scaler = actuator.PodAutoScaler(
        client=api, max=max_, min=min_, scale_up_pods=up,
        scale_down_pods=down, deployment="deploy", namespace="ns")

    def fail_next_up(err):
        api.fail_next_get = err

    return scaler, (lambda: api.replicas("deploy")), fail_next_up


def make_pool(initial, min_, max_, up=1, down=1):
    pool = WorkerPool(lambda p: _StubWorker(), min=min_, max=max_,
                      scale_up_pods=up, scale_down_pods=down, initial=initial)

    def fail_next_up(err):
        pool.fail_next_up = err

    return pool, (lambda: pool.replicas), fail_next_up


def make_shards(initial, min_, max_, up=1, down=1):
    pool = ShardedWorkerPool(lambda p: _StubShardedWorker(max_), min=min_,
                             max=max_, scale_up_pods=up,
                             scale_down_pods=down, initial=initial)

    def fail_next_up(err):
        pool.fail_next_up = err

    return pool, (lambda: pool.replicas), fail_next_up


MAKERS = {"pod": make_pod, "pool": make_pool, "shards": make_shards}


@pytest.mark.parametrize("make", list(MAKERS))
def test_scaler_protocol(make):
    scaler, _, _ = MAKERS[make](3, 1, 5)
    assert isinstance(scaler, Scaler)


@pytest.mark.parametrize("make", list(MAKERS))
@pytest.mark.parametrize("case", [
    ((3, 1, 5, 1, 1), "up", [4, 5, 5]),
    ((3, 1, 10, 5, 1), "up", [8, 10]),
    ((3, 1, 5, 1, 1), "down", [2, 1, 1]),
    ((8, 1, 10, 1, 5), "down", [3, 1]),
], ids=["up-clamps-max", "up-step", "down-clamps-min", "down-step"])
def test_steps_and_clamps(make, case):
    (initial, min_, max_, up, down), direction, want = case
    scaler, replicas, _ = MAKERS[make](initial, min_, max_, up, down)
    got = []
    for _ in want:
        getattr(scaler, f"scale_{direction}")()  # boundary no-op succeeds
        got.append(replicas())
    assert got == want


@pytest.mark.parametrize("make", list(MAKERS))
def test_failure_raises_scale_error_and_changes_nothing(make):
    scaler, replicas, fail_next_up = MAKERS[make](3, 1, 5)
    fail_next_up(ConnectionError("backend down"))
    with pytest.raises(ScaleError):
        scaler.scale_up()
    assert replicas() == 3
    scaler.scale_up()
    assert replicas() == 4


SCRIPT = [150, 150, 150, 150, 150, 150, 5, 5, 5, 5, 5, 5, 5, 150, 150]


def drive(loop_cls, config_cls, policy_cls, clock_cls, scaler, replicas,
          fail_next_up, fail_up_at):
    rows = []

    class Recorder:
        def on_tick(self, record):
            rows.append((record.to_dict(), replicas()))

    loop = loop_cls(scaler, _Scripted(SCRIPT), config_cls(
        poll_interval=5.0, policy=policy_cls(
            scale_up_messages=100, scale_down_messages=10,
            scale_up_cooldown=10.0, scale_down_cooldown=20.0)),
        clock=clock_cls(), observer=Recorder())
    if fail_up_at is not None:
        original = loop.tick

        def tick(state):
            if len(rows) == fail_up_at:
                fail_next_up(ConnectionError("injected"))
            return original(state)

        loop.tick = tick
    loop.run(max_ticks=len(SCRIPT))
    return rows


@pytest.mark.parametrize("fail_up_at", [None, 2], ids=["clean", "fails"])
@pytest.mark.parametrize("make", list(MAKERS))
def test_identical_to_the_reference_through_the_loop(make, fail_up_at):
    api = ref_fake.FakeDeploymentAPI.with_deployments("ns", 2, "deploy")
    ref_scaler = ref_actuator.PodAutoScaler(
        client=api, max=5, min=1, scale_up_pods=1, scale_down_pods=1,
        deployment="deploy", namespace="ns")
    want = drive(RefLoop, RefLoopConfig, RefPolicy, RefClock, ref_scaler,
                 lambda: api.replicas("deploy"),
                 lambda err: setattr(api, "fail_next_get", err), fail_up_at)
    scaler, replicas, fail_next_up = MAKERS[make](2, 1, 5)
    got = drive(ControlLoop, LoopConfig, PolicyConfig, FakeClock, scaler,
                replicas, fail_next_up, fail_up_at)
    strip = (lambda rows: [({k: v for k, v in r.items()
                             if k not in ("up_error", "down_error")},
                            n, "up_error" in r) for r, n in rows])
    assert strip(got) == strip(want)
    ups = [r["up"] for r, _ in got]
    assert Gate.FIRE.value in ups and Gate.COOLING.value in ups
