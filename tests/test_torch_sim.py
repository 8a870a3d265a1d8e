"""The port's closed-loop simulator (``sim/simulator.py``) and its
battery scoring (``sim/evaluate.py``, ``sim/costmodel.py``) against the
reference's.

The reference's Python ``Simulation`` needs no ``enable_x64``, so it runs
in process: reactive timelines are equal tuple for tuple, and the
predictive (each forecaster) and learned (``LEARNED_POLICY.json``)
episodes on the default battery take the reference's decisions — the
same replica trajectory and the same depth the gates saw, tick for tick.
The port computes its forecasts and network on the CPU here
(``device="cpu"``; the default is the card).
"""

from __future__ import annotations

from pathlib import Path

import pytest

from kube_sqs_autoscaler_tpu.core.loop import LoopConfig as RefLoopConfig
from kube_sqs_autoscaler_tpu.core.policy import PolicyConfig as RefPolicy
from kube_sqs_autoscaler_tpu.learn.checkpoint import (
    load_checkpoint as ref_load,
)
from kube_sqs_autoscaler_tpu.sim import costmodel as ref_costmodel
from kube_sqs_autoscaler_tpu.sim import evaluate as ref_evaluate
from kube_sqs_autoscaler_tpu.sim import simulator as ref_sim
from kube_sqs_autoscaler_tpu_torch.core.loop import LoopConfig
from kube_sqs_autoscaler_tpu_torch.core.policy import PolicyConfig
from kube_sqs_autoscaler_tpu_torch.learn.checkpoint import load_checkpoint
from kube_sqs_autoscaler_tpu_torch.sim import costmodel, evaluate
from kube_sqs_autoscaler_tpu_torch.sim.simulator import SimConfig, Simulation

ROOT = Path(__file__).resolve().parents[1]
LEARNED = str(ROOT / "LEARNED_POLICY.json")
BATTERY = [s.name for s in evaluate.default_battery()]


class Recorder:
    def __init__(self):
        self.records = []

    def on_tick(self, record):
        self.records.append(record)


def fast(module_loop, module_policy, up_cool=10.0, down_cool=30.0):
    return module_loop(poll_interval=5.0, policy=module_policy(
        scale_up_messages=100, scale_down_messages=10,
        scale_up_cooldown=up_cool, scale_down_cooldown=down_cool))


WORLDS = {
    "overloaded": dict(arrival_rate=50.0, service_rate_per_replica=10.0,
                       duration=600.0, initial_replicas=1, max_pods=8),
    "idle": dict(arrival_rate=0.0, duration=600.0, initial_replicas=6,
                 max_pods=8, min_pods=1),
    "burst-drain": dict(arrival_rate=8.0, duration=1200.0,
                        initial_depth=5000.0, max_pods=10),
    "cooldown-bound": dict(arrival_rate=1000.0, service_rate_per_replica=1.0,
                           duration=60.0, max_pods=50),
}


@pytest.mark.parametrize("name", list(WORLDS))
def test_seed_worlds_equal_the_reference(name):
    mine = Simulation(SimConfig(**WORLDS[name], loop=fast(
        LoopConfig, PolicyConfig))).run()
    want = ref_sim.Simulation(ref_sim.SimConfig(**WORLDS[name], loop=fast(
        RefLoopConfig, RefPolicy))).run()
    assert mine.timeline == want.timeline
    assert (mine.final_replicas, mine.final_depth, mine.max_depth,
            mine.ticks) == (want.final_replicas, want.final_depth,
                            want.max_depth, want.ticks)
    assert mine.replica_changes == want.replica_changes
    assert mine.time_over(300.0) == want.time_over(300.0)


def scenario_pair(name):
    mine = {s.name: s for s in evaluate.default_battery()}[name]
    want = {s.name: s for s in ref_evaluate.default_battery()}[name]
    return mine, want


def run_both(name, **policy):
    mine_s, want_s = scenario_pair(name)
    rec, ref_rec = Recorder(), Recorder()
    common = lambda s: dict(  # noqa: E731
        arrival_rate=s.arrival, service_rate_per_replica=(
            s.service_rate_per_replica), duration=s.duration,
        initial_replicas=s.initial_replicas, min_pods=s.min_pods,
        max_pods=s.max_pods, forecast_horizon=s.horizon)
    mine_policy = dict(policy)
    ref_policy = dict(policy)
    if policy.get("policy") == "learned":
        mine_policy["learned_checkpoint"] = load_checkpoint(LEARNED,
                                                            device="cpu")
        ref_policy["learned_checkpoint"] = ref_load(LEARNED)
        mine_policy["forecast_history"] = ref_policy["forecast_history"] = 64
    mine = Simulation(SimConfig(**common(mine_s), loop=mine_s.loop,
                                **mine_policy),
                      extra_observers=(rec,), device="cpu").run()
    want = ref_sim.Simulation(ref_sim.SimConfig(**common(want_s),
                                                loop=want_s.loop,
                                                **ref_policy),
                              extra_observers=(ref_rec,)).run()
    return mine, want, rec.records, ref_rec.records


@pytest.mark.parametrize("name", BATTERY)
def test_reactive_battery_timelines_equal_the_reference(name):
    mine, want, records, ref_records = run_both(name)
    assert mine.timeline == want.timeline
    assert mine.max_depth == want.max_depth
    assert [(r.up.value, r.down.value) for r in records] == \
        [(r.up.value, r.down.value) for r in ref_records]


@pytest.mark.parametrize("forecaster", ["ewma", "holt", "lstsq"])
@pytest.mark.parametrize("name", BATTERY)
def test_predictive_battery_takes_the_references_decisions(name,
                                                           forecaster):
    mine, want, records, ref_records = run_both(
        name, policy="predictive", forecaster=forecaster)
    assert [r for _, _, r in mine.timeline] == \
        [r for _, _, r in want.timeline]
    assert [r.decision_messages for r in records] == \
        [r.decision_messages for r in ref_records]


@pytest.mark.parametrize("name", BATTERY)
def test_learned_battery_takes_the_references_decisions(name):
    mine, want, records, ref_records = run_both(name, policy="learned")
    assert [r for _, _, r in mine.timeline] == \
        [r for _, _, r in want.timeline]
    assert [r.decision_messages for r in records] == \
        [r.decision_messages for r in ref_records]
    assert mine.final_replicas == want.final_replicas


def test_replica_changes_is_cached():
    result = Simulation(SimConfig(**WORLDS["overloaded"],
                                  loop=fast(LoopConfig, PolicyConfig))).run()
    recount = sum(1 for (_, _, a), (_, _, b)
                  in zip(result.timeline, result.timeline[1:]) if a != b)
    assert result.replica_changes == recount > 0
    result.timeline = []
    assert result.replica_changes == recount


@pytest.mark.parametrize("name", BATTERY)
def test_run_episode_rows_equal_the_reference(name):
    mine_s, want_s = scenario_pair(name)
    assert evaluate.run_episode(mine_s) == ref_evaluate.run_episode(want_s)
    assert evaluate.run_episode(mine_s, policy="predictive",
                                forecaster="lstsq", device="cpu") == \
        ref_evaluate.run_episode(want_s, policy="predictive",
                                 forecaster="lstsq")


@pytest.mark.parametrize("index", range(5))
def test_chaos_rows_equal_the_reference(index):
    mine = evaluate.chaos_battery()[index]
    want = ref_evaluate.chaos_battery()[index]
    assert mine.name == want.name
    for resilience in (None, "default"):
        got = evaluate.run_chaos_episode(
            mine, None if resilience is None
            else evaluate.default_resilience())
        expect = ref_evaluate.run_chaos_episode(
            want, None if resilience is None
            else ref_evaluate.default_resilience())
        assert got == expect


def test_chaos_summary_equals_the_reference():
    mine = evaluate.evaluate_chaos()
    want = ref_evaluate.evaluate_chaos()
    assert mine == want
    assert evaluate.summarize_chaos(mine) == ref_evaluate.summarize_chaos(
        want)


def test_cost_model_prices_like_the_reference():
    for module in (costmodel, ref_costmodel):
        model = module.CostModel(decode_cost_s=0.003)
        bill = (model.compute_cost_s(decode_dispatches=7,
                                     insert_dispatches=3),
                model.transfer_cost([{}, {}, {}]),
                model.episode_cost_s(decode_dispatches=2,
                                     insert_dispatches=1,
                                     transfer_ops=[{}]))
        if module is costmodel:
            mine = bill
        else:
            assert mine == bill
    assert (costmodel.DECODE_COST_S, costmodel.INSERT_COST_S,
            costmodel.TRANSFER_COST_S) == (
        ref_costmodel.DECODE_COST_S, ref_costmodel.INSERT_COST_S,
        ref_costmodel.TRANSFER_COST_S)


def test_device_rule():
    # a reactive episode touches no device; a predictive or learned one
    # computes on the card unless asked for the CPU
    Simulation(SimConfig(duration=30.0)).run()
    with pytest.raises(RuntimeError, match="no usable CUDA card"):
        Simulation(SimConfig(duration=60.0, policy="predictive",
                             forecaster="ewma")).run()
    with pytest.raises(RuntimeError, match="no usable CUDA card"):
        Simulation(SimConfig(duration=60.0, policy="learned",
                             learned_checkpoint=load_checkpoint(
                                 LEARNED, device="cpu")))
    with pytest.raises(ValueError, match="requires SimConfig.learned"):
        Simulation(SimConfig(policy="learned"), device="cpu")
    with pytest.raises(ValueError, match="'reactive', 'predictive' or"):
        Simulation(SimConfig(policy="oracle"), device="cpu")


def test_sim_package_exports_and_imports_no_torch():
    import subprocess
    import sys

    import kube_sqs_autoscaler_tpu.sim as ref_pkg
    import kube_sqs_autoscaler_tpu_torch.sim as pkg

    assert set(ref_pkg.__all__) <= set(pkg.__all__)
    code = ("import sys\n"
            "before = set(sys.modules)\n"
            "import kube_sqs_autoscaler_tpu_torch.sim as s\n"
            "s.Blackout, s.SimConfig, s.FleetFaultPlan\n"
            "print(sorted(m for m in set(sys.modules) - before\n"
            "             if m.split('.')[0] in ('torch', 'numpy')))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
