"""The port's fluid twin (``sim/compiled.py``) on the CPU.

- ``verify_fidelity``: the compiled episodes equal the port's own
  ``Simulation`` tick for tick (0 divergences) over the default battery ×
  {reactive, ewma, holt, lstsq, ``LEARNED_POLICY.json``};
- the compiled trajectories equal the reference's compiled twin (run in a
  child process, ``torch_sim_ref.py``): observed depth, decision, both
  gate codes and the replica counts exactly, the float64 world to 1e-9;
- ``run_episodes`` keeps the reference's grouping and its ``ValueError``
  messages; the device rule (cuda by default, raising without a card).
"""

from __future__ import annotations

from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest

from kube_sqs_autoscaler_tpu_torch.core.loop import LoopConfig
from kube_sqs_autoscaler_tpu_torch.core.policy import PolicyConfig
from kube_sqs_autoscaler_tpu_torch.learn.checkpoint import (
    CheckpointError,
    PolicyCheckpoint,
    load_checkpoint,
)
from kube_sqs_autoscaler_tpu_torch.learn.network import init_params
from kube_sqs_autoscaler_tpu_torch.learn.rollout import learned_config
from kube_sqs_autoscaler_tpu_torch.sim import compiled
from kube_sqs_autoscaler_tpu_torch.sim.evaluate import default_battery
from kube_sqs_autoscaler_tpu_torch.sim.scenarios import StepArrival
from kube_sqs_autoscaler_tpu_torch.sim.simulator import SimConfig, Simulation

from .torch_sim_ref import RefChild

ROOT = Path(__file__).resolve().parents[1]
LEARNED = str(ROOT / "LEARNED_POLICY.json")
FIELDS = ("observed", "decision", "up", "down", "replicas_before",
          "replicas_after")


@pytest.fixture(scope="module")
def ref():
    child = RefChild()
    yield child
    child.close()


def battery_episodes():
    scenarios = default_battery()
    episodes = compiled._fidelity_configs(scenarios, ("ewma", "holt",
                                                      "lstsq"))
    checkpoint = load_checkpoint(LEARNED, device="cpu")
    episodes += [(f"{s.name}/learned", learned_config(s, checkpoint))
                 for s in scenarios]
    return episodes


@pytest.fixture(scope="module")
def ours():
    episodes = battery_episodes()
    runs = compiled.run_episodes_grouped([c for _, c in episodes],
                                         device="cpu")
    return dict(zip([label for label, _ in episodes], runs))


@pytest.fixture(scope="module")
def theirs(ref):
    return {e["label"]: e for e in ref("fluid_battery", learned_path=LEARNED)}


def test_fidelity_over_the_battery_and_the_learned_policy():
    scenarios = default_battery()
    checkpoint = load_checkpoint(LEARNED, device="cpu")
    report = compiled.verify_fidelity(
        scenarios, extra_episodes=[
            (f"{s.name}/learned", learned_config(s, checkpoint))
            for s in scenarios], device="cpu")
    assert report.episodes == 5 * len(scenarios)
    assert report.ticks == sum(
        compiled.episode_ticks(c) for _, c in battery_episodes())
    assert report.ok, report.format_divergences()


@pytest.mark.parametrize("label", [label for label, _ in battery_episodes()])
def test_compiled_trajectories_equal_the_reference(label, ours, theirs):
    mine, want = ours[label], theirs[label]
    np.testing.assert_array_equal(mine.times, want["times"])
    for name, got in zip(FIELDS, (mine.observed, mine.decision,
                                  mine.up_codes, mine.down_codes,
                                  mine.replicas_before,
                                  mine.replicas_after)):
        np.testing.assert_array_equal(got, want[name], err_msg=name)
    assert mine.result.final_replicas == want["final_replicas"]
    np.testing.assert_allclose(mine.result.max_depth, want["max_depth"],
                               rtol=1e-9, atol=1e-6)
    np.testing.assert_allclose(mine.result.final_depth, want["final_depth"],
                               rtol=1e-9, atol=1e-6)


def test_compiled_result_is_a_sim_result_like_the_python_run():
    config = SimConfig(arrival_rate=StepArrival(before=20.0, after=90.0,
                                                at=60.0),
                       duration=300.0, max_pods=12)
    got = compiled.run_compiled_one(config, device="cpu")
    want = Simulation(config).run()
    assert got.timeline == want.timeline
    assert (got.final_replicas, got.ticks) == (want.final_replicas,
                                              want.ticks)
    assert got.replica_changes == want.replica_changes
    assert got.time_over(300.0) == want.time_over(300.0)


def test_seed_constant_rate_style_is_bit_exact():
    # the seed's plain-float arrival rate uses its own depth expression
    config = SimConfig(arrival_rate=37.5, duration=400.0,
                       service_rate_per_replica=7.0, max_pods=9)
    episode = compiled.run_episodes([config], device="cpu")[0]
    want = Simulation(config).run()
    assert episode.result.timeline == want.timeline
    assert episode.result.max_depth == want.max_depth
    assert episode.result.final_depth == want.final_depth


def test_run_episodes_refuses_mixed_shapes_with_the_reference_messages():
    a = SimConfig(duration=100.0)
    with pytest.raises(ValueError, match="share a tick count, got \\[20, 40\\]"
                       "; group by duration/poll first"):
        compiled.run_episodes([a, replace(a, duration=200.0)], device="cpu")
    with pytest.raises(ValueError, match="must share forecast_history, got "
                       "\\[16, 128\\]; group by capacity first"):
        compiled.run_episodes([a, replace(a, forecast_history=16)],
                              device="cpu")
    ck8 = PolicyCheckpoint(theta=init_params(0, 8), hidden=8)
    ck4 = PolicyCheckpoint(theta=init_params(0, 4), hidden=4)
    learned = replace(a, policy="learned", forecast_history=64)
    with pytest.raises(ValueError, match="share a hidden width \\(a compiled"
                       " shape\\), got \\[4, 8\\]; group by hidden first"):
        compiled.run_episodes([replace(learned, learned_checkpoint=ck8),
                               replace(learned, learned_checkpoint=ck4)],
                              device="cpu")
    with pytest.raises(ValueError, match="forecast_history must be >= 2"):
        compiled.run_episodes([replace(a, policy="predictive",
                                       forecast_history=1)], device="cpu")
    assert compiled.run_episodes([], device="cpu") == []


def test_grouped_runs_scatter_back_in_input_order():
    configs = [SimConfig(duration=d, arrival_rate=r)
               for d, r in ((100.0, 30.0), (200.0, 60.0), (100.0, 90.0))]
    grouped = compiled.run_episodes_grouped(configs, device="cpu")
    for config, episode in zip(configs, grouped):
        assert episode.result.timeline == Simulation(config).run().timeline


def test_encode_config_rejects_foreign_checkpoints():
    knob = PolicyCheckpoint(theta=init_params(2, 8, knob_head=True),
                            hidden=8, knob_head=True)
    with pytest.raises(CheckpointError, match="knob-action head"):
        compiled.encode_config(SimConfig(policy="learned",
                                         learned_checkpoint=knob))
    serving = PolicyCheckpoint(theta=init_params(2, 8), hidden=8,
                               meta={"twin": "serving"})
    with pytest.raises(CheckpointError, match="'serving' twin"):
        compiled.encode_config(SimConfig(policy="learned",
                                         learned_checkpoint=serving))
    with pytest.raises(ValueError, match="unknown forecaster"):
        compiled.encode_config(SimConfig(policy="predictive",
                                         forecaster="arima"))


def test_the_device_defaults_to_the_card():
    config = SimConfig(duration=50.0)
    with pytest.raises(RuntimeError, match="no usable CUDA card"):
        compiled.run_episodes([config])
    with pytest.raises(RuntimeError, match="no usable CUDA card"):
        compiled.verify_fidelity(
            [default_battery()[0]], forecasters=())


def test_episode_guard_wraps_each_batch_once(monkeypatch):
    entered = []

    class Guard:
        def __enter__(self):
            entered.append(1)

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(compiled, "episode_guard", Guard)
    configs = [SimConfig(duration=d) for d in (100.0, 200.0)]
    compiled.run_episodes_grouped(configs, device="cpu")
    assert len(entered) == 2


def test_summaries_match_the_trajectory_scorer():
    # the in-loop accumulators (rollout's only readback) equal the host
    # scorer's forms over the same episode
    scenario = default_battery()[1]
    config = SimConfig(arrival_rate=scenario.arrival,
                       duration=scenario.duration, max_pods=scenario.max_pods,
                       loop=LoopConfig(policy=PolicyConfig()))
    row = compiled.encode_config(config, slo_depth=scenario.slo_depth)
    ticks = compiled.episode_ticks(config)
    out = compiled.run_batch(compiled.stack_rows([row]), ticks, 128, False,
                             trajectory=False, device="cpu")
    result = Simulation(config).run()
    assert int(out["replica_changes"][0]) == result.replica_changes
    assert float(out["time_over_slo"][0]) == result.time_over(
        scenario.slo_depth)
    assert int(out["final_replicas"][0]) == result.final_replicas
