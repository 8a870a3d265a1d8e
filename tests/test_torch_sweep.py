"""The port's sweep runner (``sim/sweep.py``) over its compiled twins.

The grid, sampling, labels and Pareto arithmetic are the reference's
host code; every scored row of a fluid and a serving sweep equals the
reference's (a child process, ``torch_sim_ref.py``, since the reference's
sweep runs its compiled twins).  The reference's full-grid sweep is
mirrored in the ``slow`` tier.
"""

from __future__ import annotations

from dataclasses import asdict, replace

import pytest

from kube_sqs_autoscaler_tpu_torch.core.loop import LoopConfig
from kube_sqs_autoscaler_tpu_torch.core.policy import PolicyConfig
from kube_sqs_autoscaler_tpu_torch.sim.evaluate import Scenario, default_battery
from kube_sqs_autoscaler_tpu_torch.sim.scenarios import RampArrival, StepArrival
from kube_sqs_autoscaler_tpu_torch.sim.sweep import (
    SweepPoint,
    SweepReport,
    SweepSpec,
    pareto_front,
    run_sweep,
)
from kube_sqs_autoscaler_tpu_torch.sim.twin import default_twin_battery

from .torch_sim_ref import RefChild


@pytest.fixture(scope="module")
def ref():
    child = RefChild()
    yield child
    child.close()


def tiny_spec():
    return SweepSpec(
        scale_up_messages=(50, 100), scale_down_messages=(10,),
        scale_up_cooldown=(10.0,), scale_down_cooldown=(30.0,),
        scale_up_pods=(1,), policies=("reactive", "holt", "lstsq"),
        horizons=(30.0,), histories=(64,),
    )


def tiny_scenarios():
    loop = LoopConfig(poll_interval=5.0, policy=PolicyConfig())
    return (
        Scenario(name="mini-step",
                 arrival=StepArrival(before=20.0, after=120.0, at=60.0),
                 duration=200.0, max_pods=15, loop=loop),
        Scenario(name="mini-ramp",
                 arrival=RampArrival(start_rate=10.0, end_rate=120.0,
                                     t_start=30.0, t_end=180.0),
                 duration=200.0, max_pods=15, loop=loop),
    )


def test_grid_sample_and_labels_are_the_references():
    from kube_sqs_autoscaler_tpu.sim import sweep as ref_sweep

    spec = SweepSpec()
    ref_spec = ref_sweep.SweepSpec()
    assert [asdict(p) for p in spec.grid()] == [
        asdict(p) for p in ref_spec.grid()]
    assert [p.label() for p in spec.sample(12, seed=3)] == [
        p.label() for p in ref_spec.sample(12, seed=3)]


def test_run_sweep_rows_equal_the_reference(ref):
    points = tiny_spec().grid()
    report = run_sweep(points, default_battery(), device="cpu")
    want = ref("sweep", recipe="battery", points=[asdict(p) for p in points])
    assert [(r["scenario"], r["label"], r["score"]) for r in report.rows] \
        == [tuple(w) for w in want]
    assert report.points == len(points) * len(default_battery())


def test_serving_sweep_rows_equal_the_reference(ref):
    points = [SweepPoint(scale_up_messages=up, scale_down_messages=down,
                         scale_up_cooldown=0.5, scale_down_cooldown=1.5)
              for up, down in ((4, 1), (8, 2), (6, 0))]
    points.append(SweepPoint(policy="holt"))  # skipped: no serving analogue
    report = run_sweep(points, default_twin_battery(cycles=48),
                       device="cpu")
    want = ref("sweep", recipe="", points=[asdict(p) for p in points],
               serving_cycles=48)
    assert [(r["scenario"], r["label"], r["score"]) for r in report.rows] \
        == [tuple(w) for w in want]
    assert report.points == 3 * 6


def test_summary_has_best_and_pareto_per_scenario():
    report = run_sweep(tiny_spec(), tiny_scenarios(), device="cpu")
    summary = report.summary()
    assert summary["points"] == report.points == 2 * 6
    assert set(summary["best"]) == {"mini-step", "mini-ramp"}
    for name, front in summary["pareto"].items():
        assert summary["best"][name]["config"] in {
            row["config"] for row in front}


def test_best_ranking_and_pareto_front():
    rows = [
        {"scenario": "s", "label": "deep", "point": {},
         "score": {"max_depth": 500.0, "replica_changes": 1,
                   "time_over_slo_s": 0.0}},
        {"scenario": "s", "label": "calm", "point": {},
         "score": {"max_depth": 100.0, "replica_changes": 9,
                   "time_over_slo_s": 0.0}},
        {"scenario": "s", "label": "churny", "point": {},
         "score": {"max_depth": 100.0, "replica_changes": 30,
                   "time_over_slo_s": 0.0}},
    ]
    assert SweepReport(rows=rows).best_per_scenario()["s"]["label"] == "calm"
    points = [(r["score"]["max_depth"], r["score"]["replica_changes"])
              for r in rows]
    assert pareto_front(points) == [0, 1]
    assert pareto_front([(1.0, 2.0), (1.0, 2.0), (3.0, 0.0)]) == [0, 1, 2]


def test_sweep_groups_shapes_and_refuses_bad_input():
    points = [SweepPoint(policy="holt", history=32),
              SweepPoint(policy="holt", history=64),
              SweepPoint(policy="reactive")]
    report = run_sweep(points, tiny_scenarios()[:1], device="cpu")
    assert report.points == 3
    with pytest.raises(ValueError):
        run_sweep([], tiny_scenarios(), device="cpu")
    with pytest.raises(ValueError, match="not a mix"):
        run_sweep([SweepPoint()], (tiny_scenarios()[0],
                                   default_twin_battery(cycles=8)[0]),
                  device="cpu")
    with pytest.raises(ValueError, match="at least one reactive point"):
        run_sweep([SweepPoint(policy="ewma")],
                  default_twin_battery(cycles=8)[:1], device="cpu")
    with pytest.raises(RuntimeError, match="no usable CUDA card"):
        run_sweep([SweepPoint()], tiny_scenarios())


def test_point_to_config_wires_gates_and_forecast():
    scenario = replace(tiny_scenarios()[0], horizon=45.0)
    config = SweepPoint(scale_up_messages=70, scale_down_messages=5,
                        scale_up_cooldown=20.0, scale_down_cooldown=40.0,
                        scale_up_pods=2, policy="lstsq", horizon=60.0,
                        history=32).to_config(scenario)
    assert config.loop.policy.scale_up_messages == 70
    assert config.scale_up_pods == 2
    assert (config.policy, config.forecaster, config.forecast_horizon,
            config.forecast_history) == ("predictive", "lstsq", 60.0, 32)


@pytest.mark.slow
def test_default_grid_full_battery_sweep():
    report = run_sweep(SweepSpec(), device="cpu")
    assert report.points >= 100
    summary = report.summary()
    assert set(summary["best"]) == {"step", "ramp", "diurnal", "burst"}
    for name, front in summary["pareto"].items():
        assert summary["best"][name]["config"] in {
            row["config"] for row in front}
