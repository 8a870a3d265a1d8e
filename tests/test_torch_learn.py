"""The port's learned policy (``learn/``) held against the JAX package's.

The oracle is ``kube_sqs_autoscaler_tpu.learn.network``, ``.policy`` and
``.checkpoint``, imported directly (not ``learn.rollout`` or ``train``,
which need ``jax.experimental.enable_x64``).  Mirrors the checkpoint,
network, policy and controller-startup cases of ``tests/test_learn.py``
and the knob-head cases of ``tests/test_sched.py``, on the port with
``device="cpu"``:

- the reference's own checkpoints (``LEARNED_POLICY.json``,
  ``SERVING_POLICY.json``) load with the reference's hashes, and every
  loader error is the reference's, word for word;
- ``policy_logits`` agree within 1e-5 on seeded features, and
  ``learned_decision`` / ``knob_delta_decision`` take the same decisions;
- a ``LearnedPolicy`` episode on the real ``ControlLoop`` takes the
  reference's decisions, knob deltas and replica trajectory;
- the controller exits 2 with the reference's message for a serving-twin
  checkpoint, and a ``LearnedKnobPolicy`` ladder walk (with ``rebind``)
  is the reference's.
"""

from __future__ import annotations

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kube_sqs_autoscaler_tpu import cli as ref_cli
from kube_sqs_autoscaler_tpu.core.clock import FakeClock as RefClock
from kube_sqs_autoscaler_tpu.core.loop import ControlLoop as RefLoop
from kube_sqs_autoscaler_tpu.core.loop import LoopConfig as RefLoopConfig
from kube_sqs_autoscaler_tpu.core.policy import PolicyConfig as RefPolicy
from kube_sqs_autoscaler_tpu.forecast.forecasters import (
    _center_times as ref_center,
)
from kube_sqs_autoscaler_tpu.learn import checkpoint as ref_ck
from kube_sqs_autoscaler_tpu.learn import network as ref_net
from kube_sqs_autoscaler_tpu.learn import policy as ref_policy
from kube_sqs_autoscaler_tpu.metrics import FakeQueueService as RefQueue
from kube_sqs_autoscaler_tpu.metrics import QueueMetricSource as RefSource
from kube_sqs_autoscaler_tpu.scale import FakeDeploymentAPI as RefAPI
from kube_sqs_autoscaler_tpu.scale import PodAutoScaler as RefScaler
from kube_sqs_autoscaler_tpu.sched import knobs as ref_knobs
from kube_sqs_autoscaler_tpu_torch import cli, learn
from kube_sqs_autoscaler_tpu_torch.core.clock import FakeClock
from kube_sqs_autoscaler_tpu_torch.core.events import TickRecord
from kube_sqs_autoscaler_tpu_torch.core.loop import ControlLoop, LoopConfig
from kube_sqs_autoscaler_tpu_torch.core.policy import Gate, PolicyConfig
from kube_sqs_autoscaler_tpu_torch.learn.checkpoint import (
    KIND,
    SCHEMA_VERSION,
    CheckpointError,
    PolicyCheckpoint,
    checkpoint_hash,
    checkpoint_history,
    load_checkpoint,
    require_no_knob_head,
    save_checkpoint,
)
from kube_sqs_autoscaler_tpu_torch.learn.network import (
    DEFAULT_HIDDEN,
    N_ACTIONS,
    N_FEATURES,
    N_KNOB_ACTIONS,
    hold_depth,
    init_params,
    knob_delta_decision,
    learned_decision,
    param_count,
    params_from_numpy,
    policy_features,
    policy_logits,
)
from kube_sqs_autoscaler_tpu_torch.learn.policy import LearnedPolicy
from kube_sqs_autoscaler_tpu_torch.metrics.fake import (
    FakeMessageQueue,
    FakeQueueService,
)
from kube_sqs_autoscaler_tpu_torch.metrics.queue import QueueMetricSource
from kube_sqs_autoscaler_tpu_torch.scale.actuator import PodAutoScaler
from kube_sqs_autoscaler_tpu_torch.scale.fake import FakeDeploymentAPI
from kube_sqs_autoscaler_tpu_torch.sched.knobs import (
    KNOB_DECODE_BLOCK,
    KnobActuator,
    KnobError,
    LearnedKnobPolicy,
)
from kube_sqs_autoscaler_tpu_torch.workloads.continuous import (
    ContinuousWorker,
)
from kube_sqs_autoscaler_tpu_torch.workloads.service import ServiceConfig

from .test_torch_quantize import weights

ROOT = Path(__file__).resolve().parents[1]
CHECKPOINTS = ("LEARNED_POLICY.json", "SERVING_POLICY.json")
LOGIT_TOL = 1e-5


def make_checkpoint(seed: int = 0, hidden: int = 16, **meta):
    return PolicyCheckpoint(
        theta=init_params(seed, hidden), hidden=hidden,
        meta={"forecast_history": 32, "min_samples": 3, **meta})


def make_policy(checkpoint, **overrides) -> LearnedPolicy:
    kwargs = dict(policy=PolicyConfig(), poll_interval=5.0, max_pods=20,
                  min_pods=1, initial_replicas=1, min_samples=3)
    kwargs.update(overrides)
    return LearnedPolicy(checkpoint, **kwargs)


# --- the reference's checkpoints ----------------------------------------


@pytest.mark.parametrize("name", CHECKPOINTS)
def test_repo_checkpoints_load_with_the_references_hash(name):
    path = str(ROOT / name)
    ours = load_checkpoint(path, device="cpu")
    theirs = ref_ck.load_checkpoint(path)
    assert ours.hash == theirs.hash == checkpoint_hash(ours)
    assert ours.theta.dtype == torch.float32
    assert ours.theta.device.type == "cpu"
    np.testing.assert_array_equal(ours.theta.numpy(), theirs.theta)
    assert (ours.hidden, ours.knob_head, ours.meta) == (
        theirs.hidden, theirs.knob_head, theirs.meta)
    assert checkpoint_history(ours) == ref_ck.checkpoint_history(theirs)
    assert ours.to_dict() == theirs.to_dict()


def test_checkpoints_load_onto_the_card_unless_asked():
    # the default device is cuda: no card here is an error, raised after
    # the file was validated (a bad file is still a CheckpointError)
    with pytest.raises(RuntimeError, match="no usable CUDA card"):
        load_checkpoint(str(ROOT / CHECKPOINTS[0]))
    with pytest.raises(CheckpointError, match="does not exist"):
        load_checkpoint(str(ROOT / "missing.json"))


def test_params_from_numpy_carries_the_references_init():
    for seed, hidden, knob_head in ((0, 16, False), (3, 8, True)):
        theirs = ref_net.init_params(seed, hidden, knob_head)
        ours = params_from_numpy(theirs, "cpu")
        assert ours.dtype == torch.float32
        np.testing.assert_array_equal(ours.numpy(), theirs)
        np.testing.assert_array_equal(init_params(seed, hidden, knob_head),
                                      theirs)
        assert param_count(hidden, knob_head) == ref_net.param_count(
            hidden, knob_head)


# --- checkpoint contract (test_learn.py) --------------------------------


def test_checkpoint_round_trip_is_bitwise(tmp_path):
    checkpoint = make_checkpoint(seed=5)
    path = str(tmp_path / "ck.json")
    returned_hash = save_checkpoint(path, checkpoint)
    loaded = load_checkpoint(path, device="cpu")
    assert torch.equal(loaded.theta, checkpoint.theta)
    assert loaded.theta.dtype == torch.float32
    assert loaded.hidden == checkpoint.hidden
    assert loaded.hash == checkpoint.hash == returned_hash
    assert loaded.meta == checkpoint.meta
    # the file is the reference's, byte for byte
    other = str(tmp_path / "ref.json")
    ref_ck.save_checkpoint(other, ref_ck.PolicyCheckpoint(
        theta=ref_net.init_params(5), hidden=16,
        meta={"forecast_history": 32, "min_samples": 3}))
    assert Path(path).read_bytes() == Path(other).read_bytes()


def test_checkpoint_round_trip_decisions_are_bitwise(tmp_path):
    checkpoint = make_checkpoint(seed=6)
    path = str(tmp_path / "ck.json")
    save_checkpoint(path, checkpoint)
    loaded = load_checkpoint(path, device="cpu")
    depths = [0, 40, 90, 160, 300, 250, 120, 60, 30, 10, 5, 0]
    decisions = []
    for candidate in (checkpoint, loaded):
        policy = make_policy(candidate)
        episode = []
        for i, depth in enumerate(depths):
            t = 5.0 * (i + 1)
            episode.append(policy.effective_messages(t, depth))
            policy.history.observe(t, float(depth))
        decisions.append(episode)
    assert decisions[0] == decisions[1]


def test_checkpoint_schema_version_is_pinned(tmp_path):
    assert SCHEMA_VERSION == ref_ck.SCHEMA_VERSION == 1
    assert KIND == ref_ck.KIND
    path = str(tmp_path / "ck.json")
    save_checkpoint(path, make_checkpoint())
    data = json.loads(Path(path).read_text())
    assert (data["schema"], data["kind"], data["n_features"]) == (
        1, KIND, N_FEATURES)


def loader_errors(path: str) -> tuple[str, str]:
    """The port's and the reference's loader message for one file."""
    messages = []
    for load, error in ((lambda p: load_checkpoint(p, device="cpu"),
                         CheckpointError),
                        (ref_ck.load_checkpoint, ref_ck.CheckpointError)):
        with pytest.raises(error) as err:
            load(path)
        messages.append(str(err.value))
    return messages[0], messages[1]


@pytest.mark.parametrize("mutate, match", [
    (lambda d: d.__setitem__("kind", "something/else"), "kind"),
    (lambda d: d.__setitem__("theta", [1.0, 2.0]), "parameters"),
    (lambda d: d.__setitem__("n_features", 4), "features"),
    (lambda d: d.__setitem__("hidden", "wide"), "hidden"),
    (lambda d: d.__setitem__("theta", ["a"]), "finite"),
    (lambda d: d.__setitem__("meta", [1]), "meta"),
    (lambda d: d.__setitem__("schema", 0), "schema"),
    (lambda d: d.__setitem__("schema", SCHEMA_VERSION + 1), "newer than"),
    (lambda d: d.__setitem__("knob_head", "yes"), "knob_head"),
    (lambda d: d["meta"].__setitem__("twin", "quantum"), "twin"),
    (lambda d: d["meta"].__setitem__("forecast_history", 0),
     "forecast_history"),
])
def test_checkpoint_rejects_corrupt_fields(tmp_path, mutate, match):
    path = str(tmp_path / "ck.json")
    save_checkpoint(path, make_checkpoint())
    data = json.loads(Path(path).read_text())
    mutate(data)
    Path(path).write_text(json.dumps(data))
    ours, theirs = loader_errors(path)
    assert match in ours
    assert ours == theirs


def test_checkpoint_rejects_missing_and_torn_files(tmp_path):
    ours, theirs = loader_errors(str(tmp_path / "missing.json"))
    assert "does not exist" in ours and ours == theirs
    torn = tmp_path / "torn.json"
    torn.write_text('{"kind": "kube-sqs')
    ours, theirs = loader_errors(str(torn))
    assert "corrupt" in ours and ours == theirs
    not_object = tmp_path / "list.json"
    not_object.write_text("[1, 2]")
    assert loader_errors(str(not_object))[0] == loader_errors(
        str(not_object))[1]


def test_checkpoint_hash_tracks_decisions_not_provenance():
    a = make_checkpoint(seed=1, note="first")
    b = make_checkpoint(seed=1, note="second, different meta")
    c = make_checkpoint(seed=2)
    d = make_checkpoint(seed=1, forecast_history=128)
    assert a.hash == b.hash
    assert a.hash != c.hash
    assert a.hash != d.hash
    assert checkpoint_hash(a) == a.hash
    assert a.hash == ref_ck.PolicyCheckpoint(
        theta=ref_net.init_params(1), hidden=16,
        meta={"forecast_history": 32, "min_samples": 3}).hash


def test_checkpoint_validates_geometry():
    cases = [
        (dict(theta=np.zeros(7, np.float32), hidden=16), "needs exactly"),
        (dict(theta=np.full(param_count(16), np.nan, np.float32),
              hidden=16), "non-finite"),
        (dict(theta=np.zeros(1, np.float32), hidden=0), "hidden"),
    ]
    for kwargs, match in cases:
        with pytest.raises(CheckpointError, match=match) as ours:
            PolicyCheckpoint(**kwargs)
        with pytest.raises(ref_ck.CheckpointError) as theirs:
            ref_ck.PolicyCheckpoint(**kwargs)
        assert str(ours.value) == str(theirs.value)


def test_checkpoint_validates_feature_window_pins(tmp_path):
    for bad in (None, "abc", 64.5, 0, True):
        with pytest.raises(CheckpointError, match="forecast_history"):
            PolicyCheckpoint(theta=init_params(0),
                             meta={"forecast_history": bad})
    with pytest.raises(CheckpointError, match="min_samples"):
        PolicyCheckpoint(theta=init_params(0), meta={"min_samples": -1})
    path = tmp_path / "badmeta.json"
    data = make_checkpoint().to_dict()
    data["meta"]["forecast_history"] = None
    path.write_text(json.dumps(data))
    ours, theirs = loader_errors(str(path))
    assert "badmeta" in ours and ours == theirs


def test_checkpoint_history_reads_meta():
    assert checkpoint_history(make_checkpoint()) == (32, 3)
    assert checkpoint_history(PolicyCheckpoint(theta=init_params(0))) == (
        64, 3)


# --- network ------------------------------------------------------------


def test_hold_depth_sits_strictly_between_open_thresholds():
    assert 10 < hold_depth(100, 10) < 100
    assert hold_depth(11, 10) == 11
    assert hold_depth(5, 10) == 11
    for up, down in ((100, 10), (11, 10), (5, 10), (2, 1), (300, 0)):
        assert hold_depth(up, down) == ref_net.hold_depth(up, down)


def test_init_params_is_seeded_and_sized():
    assert init_params(3).shape == (param_count(16),)
    assert np.array_equal(init_params(3), init_params(3))
    assert not np.array_equal(init_params(3), init_params(4))
    assert init_params(3).dtype == np.float32


def seeded_inputs(seed: int):
    """A seeded history and state: the reference's arguments and the
    port's."""
    rng = np.random.default_rng(seed)
    hidden = int(rng.choice([4, 8, 16]))
    knob_head = bool(rng.integers(0, 2))
    theta = ref_net.init_params(int(rng.integers(0, 1000)), hidden,
                                knob_head)
    cap = 64
    n = int(rng.integers(0, cap + 1))
    times = np.sort(rng.uniform(0, 300, cap)) + float(rng.choice([0, 2.7e8]))
    depths = np.round(np.abs(rng.normal(100, 80, cap)))
    t32 = ref_center(times, n).astype(np.float32)
    d32 = depths.astype(np.float32)
    state = dict(observed=int(rng.integers(0, 400)),
                 replicas=int(rng.integers(1, 6)),
                 frac_up=np.float32(rng.uniform()),
                 frac_down=np.float32(rng.uniform()))
    return hidden, knob_head, theta, t32, d32, n, state


@pytest.mark.parametrize("seed", range(12))
def test_policy_logits_and_decisions_match_the_reference(seed):
    hidden, knob_head, theta, t32, d32, n, s = seeded_inputs(seed)
    i32, f32 = jnp.int32, jnp.float32
    ref_features = ref_net.policy_features(
        jnp.asarray(t32), jnp.asarray(d32), i32(n), i32(s["observed"]),
        i32(s["replicas"]), f32(s["frac_up"]), f32(s["frac_down"]),
        i32(100), i32(5), f32(5.0), f32(0.3), i32(12))
    features = policy_features(
        torch.as_tensor(t32), torch.as_tensor(d32), n, s["observed"],
        s["replicas"], float(s["frac_up"]), float(s["frac_down"]), 100, 5,
        5.0, 0.3, 12)
    np.testing.assert_allclose(features.numpy(), np.asarray(ref_features),
                               rtol=1e-6, atol=1e-6)
    logits = policy_logits(params_from_numpy(theta, "cpu"), features,
                           hidden, knob_head)
    ref_logits = ref_net.policy_logits(jnp.asarray(theta), ref_features,
                                       hidden, knob_head)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                               rtol=0, atol=LOGIT_TOL)
    for min_samples in (3, n + 1):
        common = (s["observed"], s["replicas"], s["frac_up"],
                  s["frac_down"], 100)
        ref_args = [jnp.asarray(theta), jnp.asarray(t32), jnp.asarray(d32),
                    i32(n), *map(i32, common[:2]), *map(f32, common[2:4]),
                    i32(100)]
        ours = learned_decision(
            params_from_numpy(theta, "cpu"), torch.as_tensor(t32),
            torch.as_tensor(d32), n, *common, 10, 55, min_samples, 5, 5.0,
            0.3, 12, hidden=hidden, knob_head=knob_head)
        theirs = ref_net.learned_decision(
            *ref_args, i32(10), i32(55), i32(min_samples), i32(5),
            f32(5.0), f32(0.3), i32(12), hidden=hidden,
            knob_head=knob_head)
        assert ours == int(theirs)
        if knob_head:
            ours = knob_delta_decision(
                params_from_numpy(theta, "cpu"), torch.as_tensor(t32),
                torch.as_tensor(d32), n, *common, min_samples, 5, 5.0, 0.3,
                12, hidden=hidden)
            theirs = ref_net.knob_delta_decision(
                *ref_args, i32(min_samples), i32(5), f32(5.0), f32(0.3),
                i32(12), hidden=hidden)
            assert ours == int(theirs)


def test_cooldown_fraction_matches_the_reference():
    from kube_sqs_autoscaler_tpu_torch.learn.network import (
        cooldown_fraction,
    )

    for last, cooldown, now in ((0.0, 10.0, 4.0), (2.7e8, 30.0, 2.7e8 + 7),
                                (5.0, 0.0, 5.0), (0.0, 10.0, 20.0)):
        assert cooldown_fraction(last, cooldown, now) == \
            ref_net.cooldown_fraction(last, cooldown, now)


# --- the policy on the loop ----------------------------------------------


def test_policy_warms_up_reactive_below_min_samples():
    policy = make_policy(make_checkpoint(), min_samples=3)
    assert policy.effective_messages(5.0, 123) == 123
    policy.history.observe(5.0, 123.0)
    assert policy.effective_messages(10.0, 77) == 77


def test_policy_mirrors_replicas_and_cooldowns():
    policy = make_policy(make_checkpoint(), max_pods=3, initial_replicas=2)
    record = TickRecord(start=10.0, num_messages=500)
    record.up = Gate.FIRE
    policy.on_tick(record)
    assert policy.replicas == 3 and policy._last_up == 10.0
    policy.on_tick(record)
    assert policy.replicas == 3
    failed = TickRecord(start=20.0, num_messages=500)
    failed.up = Gate.FIRE
    failed.up_error = "boom"
    policy.on_tick(failed)
    assert policy._last_up == 10.0
    down = TickRecord(start=30.0, num_messages=0)
    down.down = Gate.FIRE
    policy.on_tick(down)
    assert policy.replicas == 2 and policy._last_down == 30.0


def test_policy_refuses_a_serving_twin_checkpoint_as_the_reference():
    path = str(ROOT / "SERVING_POLICY.json")
    with pytest.raises(CheckpointError) as ours:
        make_policy(load_checkpoint(path, device="cpu"))
    with pytest.raises(ref_ck.CheckpointError) as theirs:
        ref_policy.LearnedPolicy(ref_ck.load_checkpoint(path),
                                 policy=RefPolicy(), poll_interval=5.0,
                                 max_pods=20)
    assert str(ours.value) == str(theirs.value)


def episode(port: bool, checkpoint_path: str, depths, knob_head=False):
    """One learned episode over a queue-depth trace on the real loop of
    either package: every tick's decision and knob delta, the replicas."""
    if port:
        mods = (FakeDeploymentAPI, PodAutoScaler, FakeQueueService,
                QueueMetricSource, FakeClock, ControlLoop, LoopConfig,
                PolicyConfig)
        ck = (load_checkpoint(checkpoint_path, device="cpu")
              if checkpoint_path else PolicyCheckpoint(
                  theta=init_params(9, 8, True), hidden=8, knob_head=True))
        policy_cls = LearnedPolicy
    else:
        mods = (RefAPI, RefScaler, RefQueue, RefSource, RefClock, RefLoop,
                RefLoopConfig, RefPolicy)
        ck = (ref_ck.load_checkpoint(checkpoint_path) if checkpoint_path
              else ref_ck.PolicyCheckpoint(
                  theta=ref_net.init_params(9, 8, True), hidden=8,
                  knob_head=True))
        policy_cls = ref_policy.LearnedPolicy
    api_cls, scaler_cls, queue_cls, source, clock_cls, loop_cls, \
        config_cls, gate_cls = mods
    api = api_cls.with_deployments("ns", 1, "deploy")
    scaler = scaler_cls(client=api, max=8, min=1, scale_up_pods=1,
                        scale_down_pods=1, deployment="deploy",
                        namespace="ns")
    queue = queue_cls.with_depths(depths[0])
    clock = clock_cls(2.7e8)
    gates = gate_cls(scale_up_messages=100, scale_down_messages=10,
                     scale_up_cooldown=10.0, scale_down_cooldown=30.0)
    history, min_samples = ref_ck.checkpoint_history(ck) if not port \
        else checkpoint_history(ck)
    from kube_sqs_autoscaler_tpu.forecast import DepthHistory as RefHistory
    from kube_sqs_autoscaler_tpu_torch.forecast import DepthHistory

    policy = policy_cls(ck, policy=gates, poll_interval=5.0, max_pods=8,
                        min_pods=1, initial_replicas=1,
                        history=(DepthHistory if port else RefHistory)(
                            history), min_samples=min_samples)
    loop = loop_cls(scaler, source(client=queue, queue_url="q"),
                    config_cls(poll_interval=5.0, policy=gates), clock=clock,
                    observer=policy, depth_policy=policy)
    for i, depth in enumerate(depths):
        clock.at(2.7e8 + i * 5.0, lambda d=depth: queue.set_depths(d))
    out = []
    original_tick = loop.tick

    def tick(state):
        new_state = original_tick(state)
        out.append((policy.last_prediction, policy.take_knob_delta(),
                    api.replicas("deploy")))
        return new_state

    loop.tick = tick
    loop.run(max_ticks=len(depths))
    return out, policy.export_state()


DEPTHS = ([20 * i for i in range(15)] + [300] * 8
          + [max(0, 300 - 25 * i) for i in range(16)] + [0] * 6)


@pytest.mark.parametrize("checkpoint", ["LEARNED_POLICY.json", "knob-head"])
def test_learned_episode_equals_the_reference(checkpoint):
    path = str(ROOT / checkpoint) if checkpoint.endswith(".json") else ""
    ours, our_state = episode(True, path, DEPTHS)
    theirs, their_state = episode(False, path, DEPTHS)
    assert ours == theirs
    assert our_state == their_state
    assert len({r for _, _, r in ours}) > 1  # the fleet moved
    if not path:
        assert {d for _, d, _ in ours} - {None, 0}  # the knob head spoke


def test_policy_state_round_trips_and_refuses_other_weights():
    ours, state = episode(True, str(ROOT / "LEARNED_POLICY.json"), DEPTHS[:20])
    ck = load_checkpoint(str(ROOT / "LEARNED_POLICY.json"), device="cpu")
    fresh = make_policy(ck, max_pods=8)
    ref_fresh = ref_policy.LearnedPolicy(
        ref_ck.load_checkpoint(str(ROOT / "LEARNED_POLICY.json")),
        policy=RefPolicy(), poll_interval=5.0, max_pods=8, min_samples=3)
    kwargs = dict(rebase=-2.7e8, now=200.0, max_age_s=3600.0)
    assert fresh.import_state(state, **kwargs) == ref_fresh.import_state(
        state, **kwargs)
    assert fresh.export_state() == ref_fresh.export_state()
    other = make_policy(make_checkpoint(seed=1))
    assert other.import_state(state) == 0  # another checkpoint's mirror
    fresh.reconcile_observed(99)
    assert fresh.replicas == 8


# --- the controller's startup checks ------------------------------------


def startup_error(main, argv, capsys) -> tuple[int, str]:
    with pytest.raises(SystemExit) as info:
        main(argv)
    return info.value.code, capsys.readouterr().err.strip().splitlines()[-1]


@pytest.mark.parametrize("case", ["serving-twin", "missing", "corrupt",
                                  "future", "wrong-kind"])
def test_controller_refuses_bad_checkpoints_as_the_reference(
        case, tmp_path, capsys):
    path = {"serving-twin": str(ROOT / "SERVING_POLICY.json"),
            "missing": str(tmp_path / "missing.json")}.get(
        case, str(tmp_path / f"{case}.json"))
    if case in ("corrupt", "future", "wrong-kind"):
        data = make_checkpoint().to_dict()
        if case == "future":
            data["schema"] = SCHEMA_VERSION + 1
        if case == "wrong-kind":
            data["kind"] = "kube-sqs-autoscaler-tpu/journal"
        text = json.dumps(data)
        Path(path).write_text(text[:20] if case == "corrupt" else text)
    argv = ["--policy=learned", f"--policy-checkpoint={path}"]
    ours = startup_error(cli.main, [*argv, "--device", "cpu"], capsys)
    theirs = startup_error(ref_cli.main, argv, capsys)
    assert ours[0] == theirs[0] == 2
    assert ours[1].split(" error: ", 1)[1] == theirs[1].split(" error: ",
                                                              1)[1]


def test_controller_learned_meta_records_checkpoint_hash(tmp_path):
    path = str(tmp_path / "ck.json")
    checkpoint = make_checkpoint(seed=21)
    save_checkpoint(path, checkpoint)
    parser = cli.build_parser()
    args = parser.parse_args(["--policy", "learned", "--policy-checkpoint",
                              path, "--device", "cpu"])
    cli.validate_flag_interactions(parser, args)
    loaded = cli.load_learned_checkpoint(parser, args)
    meta = cli._journal_meta(args, loaded)
    assert meta["policy"] == "learned"
    assert meta["learn"] == {"checkpoint_hash": checkpoint.hash,
                             "checkpoint_path": path, "hidden": 16,
                             "history": 32, "min_samples": 3}
    assert cli._journal_meta(parser.parse_args([]), None)["learn"] == {}


# --- the knob head (test_sched.py) ---------------------------------------


def test_knob_head_param_count_and_init():
    hidden = DEFAULT_HIDDEN
    assert param_count(hidden, knob_head=True) == (
        param_count(hidden) + N_KNOB_ACTIONS * hidden + N_KNOB_ACTIONS)
    theta = init_params(3, hidden, knob_head=True)
    assert theta.shape == (param_count(hidden, knob_head=True),)


def test_knob_head_replica_logits_spliced_parity():
    hidden = 8
    rng = np.random.default_rng(0)
    theta = init_params(7, hidden)
    cut = hidden * N_FEATURES + hidden
    w2 = theta[cut: cut + N_ACTIONS * hidden].reshape(N_ACTIONS, hidden)
    b2 = theta[cut + N_ACTIONS * hidden:]
    knob_w = rng.standard_normal((N_KNOB_ACTIONS, hidden)).astype(np.float32)
    knob_b = rng.standard_normal(N_KNOB_ACTIONS).astype(np.float32)
    spliced = np.concatenate([
        theta[:cut], np.concatenate([w2, knob_w]).reshape(-1),
        np.concatenate([b2, knob_b])]).astype(np.float32)
    features = torch.as_tensor(rng.standard_normal(N_FEATURES),
                               dtype=torch.float32)
    plain = policy_logits(torch.as_tensor(theta), features, hidden)
    headed = policy_logits(torch.as_tensor(spliced), features, hidden,
                           knob_head=True)
    assert headed.shape == (N_ACTIONS + N_KNOB_ACTIONS,)
    assert torch.equal(plain, headed[:N_ACTIONS])


def test_knob_delta_decision_warmup_and_range():
    hidden = 8
    theta = torch.as_tensor(init_params(1, hidden, knob_head=True))
    times = torch.zeros(16)
    depths = torch.zeros(16)
    kwargs = dict(observed=50, replicas=2, frac_up32=0.0, frac_down32=0.0,
                  scale_up_messages=100, min_samples=3, max_pods=5,
                  poll32=5.0, alpha32=0.3, window=12)
    assert knob_delta_decision(theta, times, depths, 1, hidden=hidden,
                               **kwargs) == 0
    assert knob_delta_decision(theta, times, depths, 8, hidden=hidden,
                               **kwargs) in (-1, 0, 1)


def test_knob_head_checkpoint_roundtrip_and_seam_rejection(tmp_path):
    theta = init_params(2, 8, knob_head=True)
    checkpoint = PolicyCheckpoint(theta=theta, hidden=8, knob_head=True)
    headless = PolicyCheckpoint(theta=init_params(2, 8), hidden=8)
    assert checkpoint.hash != headless.hash
    assert checkpoint.hash == ref_ck.PolicyCheckpoint(
        theta=theta, hidden=8, knob_head=True).hash
    path = tmp_path / "knobhead.json"
    save_checkpoint(str(path), checkpoint)
    loaded = load_checkpoint(str(path), device="cpu")
    assert loaded.knob_head is True and loaded.hash == checkpoint.hash
    assert torch.equal(loaded.theta, checkpoint.theta)
    with pytest.raises(CheckpointError, match="knob_head"):
        PolicyCheckpoint(theta=init_params(2, 8), hidden=8, knob_head=True)
    # a headless-only seam refuses the wider layout, in the reference's
    # words
    with pytest.raises(CheckpointError) as ours:
        require_no_knob_head(checkpoint, "the fluid rollout")
    with pytest.raises(ref_ck.CheckpointError) as theirs:
        ref_ck.require_no_knob_head(ref_ck.PolicyCheckpoint(
            theta=theta, hidden=8, knob_head=True), "the fluid rollout")
    assert str(ours.value) == str(theirs.value)


def test_learned_policy_take_knob_delta_semantics():
    checkpoint = PolicyCheckpoint(theta=init_params(4, 8, knob_head=True),
                                  hidden=8, knob_head=True)
    policy = LearnedPolicy(checkpoint, policy=PolicyConfig(),
                           poll_interval=5.0, max_pods=5)
    policy.last_knob_delta = 1
    assert policy.take_knob_delta() == 1
    assert policy.take_knob_delta() is None


class Brain:
    """The knob-head contract: a delta per decided tick, consumed once."""

    def __init__(self, deltas):
        self.deltas = list(deltas)
        self.last_knob_delta = None

    def take_knob_delta(self):
        return self.deltas.pop(0) if self.deltas else None


@pytest.fixture(scope="module")
def model():
    _, _, tcfg, tp = weights("gpt")
    return tcfg, tp


def test_learned_knob_policy_consumes_delta_once(model):
    config, params = model
    service = ServiceConfig(queue_url="k://q", batch_size=2, seq_len=4,
                            generate_tokens=6, decode_block=4,
                            result_queue_url="k://r")
    worker = ContinuousWorker(FakeMessageQueue(), params, config, service,
                              result_queue=FakeMessageQueue(), device="cpu")
    actuator = KnobActuator(worker, armed=(KNOB_DECODE_BLOCK,))
    policy = LearnedKnobPolicy(actuator, Brain([1]), ladder=(2, 4, 8))
    policy.evaluate()
    actuator.apply()
    assert worker.batcher.decode_block == 8
    policy.evaluate()  # no new decision: no step
    actuator.apply()
    assert worker.batcher.decode_block == 8
    policy.rebind(Brain([-1]))
    policy.evaluate()
    actuator.apply()
    assert worker.batcher.decode_block == 4


class LadderActuator:
    """The slice of the actuator the knob policy touches: the live block
    and the staged value."""

    def __init__(self, block):
        self.block = block
        self.staged = []

    def _read(self, knob):
        return self.block

    def set(self, knob, value):
        self.staged.append((knob, value))
        self.block = value
        return True


def test_learned_knob_policy_ladder_walk_equals_the_reference():
    # the same deltas (holds, consumed Nones, walks past both ends, an
    # off-ladder start, a rebind to a fresh brain) stage the same blocks
    deltas = [1, 1, None, 1, 1, 0, -1, -1, -1, -1, -1, 1, None, 1]
    ladder = (1, 2, 4, 8, 16)
    staged = []
    for policy_cls in (LearnedKnobPolicy, ref_knobs.LearnedKnobPolicy):
        actuator = LadderActuator(block=3)
        policy = policy_cls(actuator, Brain(deltas[:7]), ladder=ladder)
        for _ in range(7):
            policy.evaluate()
        policy.rebind(Brain(deltas[7:]))
        for _ in range(8):
            policy.evaluate()
        staged.append((actuator.staged, policy.decisions))
    assert staged[0] == staged[1]
    assert [v for _, v in staged[0][0]][:3] == [4, 8, 16]
    for ladder in ((), (4, 2)):
        with pytest.raises(KnobError):
            LearnedKnobPolicy(None, None, ladder=ladder)


def test_learned_package_exports_only_what_is_ported():
    assert set(learn.__all__) <= {
        "LearnedPolicy", "PolicyCheckpoint", "CheckpointError",
        "SCHEMA_VERSION", "load_checkpoint", "save_checkpoint",
        "checkpoint_hash", "checkpoint_twin", "require_twin", "init_params",
        "param_count", "params_from_numpy"}
    assert learn.LearnedPolicy is LearnedPolicy
    with pytest.raises(AttributeError):
        learn.train  # noqa: B018  (ROADMAP Queue 1 item 6c)
